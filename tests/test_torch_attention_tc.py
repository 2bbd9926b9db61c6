"""The arithmetic the port's attention kernels choose, emulated in torch
on the CPU and held against the JAX package's kernels (Pallas in
interpret mode, as tests/test_kernels.py runs them) on numpy inputs from
a seed, plus the wrappers' planning helpers.

- ``tc_attention``: csrc/flash_attention_tc.cu's tiling and numerics for
  bf16 inputs -- the kernel's own tiles (``tc_tiles``) whatever S, f32 scores of bf16 products scaled by scale * log2(e) and
  exponentiated with exp2, the ragged edge and the causal diagonal
  masked with -1e30, P rounded to bf16 only as the operand of P.V while
  l sums the f32 P, one rounding of the output to bf16.
- ``split_decode``: csrc/flash_decode.cu's arithmetic -- the live cache
  cut into the spans of ``plan_split``, each span cut into warp tiles,
  each lane group's rows of a tile taken with one online-softmax update
  (int8 scales applied to the dot product and folded into P), the lane
  groups', warps' and spans' partials merged with weights exp(m - max m),
  the result rounded once to q's dtype.

Tolerances: f32 2e-5 (summation order), bf16 / int8 2e-2 (bf16 rounding
of P and of the output), those of tests/test_kernels.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_decode import ops as jfd_ops
from repro.models.layers import quantize_kv as jquantize_kv
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.tiling import fit_block
from repro_torch.models.layers import quantize_kv

from _torch_parity import both, j2n, t2n

NEG = -1e30
LOG2E = 1.4426950408889634


def tc_attention(q, k, v, causal=True):
    """q/k/v: (B, S, H, hd) bf16 -> (B, S, H, hd) bf16, tile by tile as the
    tensor-core kernel computes it."""
    B, S, H, hd = q.shape
    bq, bkv = fa_ops.tc_tiles(hd)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B,H,S,hd)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    out = torch.empty_like(qf)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, q0 + bq)
        qt = torch.zeros(B, H, bq, hd)
        qt[:, :, :min(bq, S - q0)] = qf[:, :, q0:q0 + bq]
        m = torch.full((B, H, bq, 1), NEG)
        l = torch.zeros(B, H, bq, 1)
        acc = torch.zeros(B, H, bq, hd)
        kv_end = min(S, q0 + bq) if causal else S
        for k0 in range(0, kv_end, bkv):
            cols = torch.arange(k0, k0 + bkv)
            kt = torch.zeros(B, H, bkv, hd)
            vt = torch.zeros(B, H, bkv, hd)
            kt[:, :, :min(bkv, S - k0)] = kf[:, :, k0:k0 + bkv]
            vt[:, :, :min(bkv, S - k0)] = vf[:, :, k0:k0 + bkv]
            x = (qt @ kt.transpose(-1, -2)) * scale_log2
            dead = cols[None, :] >= S
            if causal:
                dead = dead | (cols[None, :] > rows[:, None])
            x = torch.where(dead, torch.tensor(NEG), x)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            p = torch.exp2(x - m_new)
            c = torch.exp2(m - m_new)
            l = l * c + p.sum(-1, keepdim=True)
            acc = acc * c + p.to(torch.bfloat16).float() @ vt
            m = m_new
        o = acc / torch.clamp(l, min=1e-20)
        out[:, :, q0:q0 + bq] = o[:, :, :min(bq, S - q0)]
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("S", [1, 96, 257, 300])
@pytest.mark.parametrize("hd", [64, 112, 192])
def test_tc_attention_emulation_matches_reference(S, hd):
    """The kernel's arithmetic at its own tiles against the reference's
    Pallas kernel at the knob's fitted tiles (257 and 300 are ragged for
    64-row tiles; 257 is prime, so the reference fits its tiles to 1)."""
    B, H = 1, 2
    rng = np.random.RandomState(S * hd)
    arrs = [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = [both(a, "bfloat16") for a in arrs]
    for causal in (True, False):
        got = tc_attention(tq, tk, tv, causal=causal)
        assert got.dtype == torch.bfloat16 and got.shape == tq.shape
        want = jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=128, block_kv=128)
        np.testing.assert_allclose(t2n(got), j2n(want), atol=2e-2,
                                   rtol=2e-2)


def test_tc_attention_tiles_do_not_follow_the_knob():
    """At a prime S the reference's tiles fit to 1 row; the kernel's are
    its own -- 64 x 64 to hd 64, 128 x 32 to hd 128, 64 x 32 above -- and
    its shared memory is the formula of its own tiles."""
    assert fit_block(128, 919) == 1
    assert [fa_ops.tc_tiles(hd) for hd in (16, 64, 80, 112, 128, 144, 256)] \
        == [(64, 64), (64, 64), (128, 32), (128, 32), (128, 32), (64, 32),
            (64, 32)]
    for hd in fa_ops.HEAD_DIMS:
        bq, bkv = fa_ops.tc_tiles(hd)
        assert fa_ops.smem_bytes(hd, torch.bfloat16) == \
            (bq + 2 * 2 * bkv) * (hd + 8) * 2


def test_tc_smem_fits_at_every_head_dim():
    """Nothing is refused in bf16 any more: the largest ask is hd 256's."""
    need = {hd: fa_ops.smem_bytes(hd, torch.bfloat16)
            for hd in fa_ops.HEAD_DIMS}
    assert max(need.values()) == need[256] == 101_376
    assert need[64] == 46_080 and need[112] == 61_440
    assert all(n <= fa_ops.SMEM_LIMIT for n in need.values())


def _merge(parts):
    """Partials (m, l, acc) merged with weights exp(m - max m)."""
    ms = torch.stack([p[0] for p in parts])
    w = torch.exp(ms - ms.amax(0))
    return (ms.amax(0), (torch.stack([p[1] for p in parts]) * w).sum(0),
            (torch.stack([p[2] for p in parts]) * w[..., None]).sum(0))


def split_decode(q, kc, vc, length, ks, vs, plan):
    """q (B,1,H,hd); caches (B,S,Hkv,hd) [+ scales]; the kernel's split,
    warp tiles, lane groups and merges.  Returns (B,1,H,hd) in q's
    dtype."""
    B, _, H, hd = q.shape
    Hkv = kc.shape[2]
    n_rep = H // Hkv
    chunks = hd * kc.element_size() // 16
    # rows per lane group per tile
    steps = 4 if chunks > 32 or kc.element_size() == 1 else 8
    groups = fd_ops.lane_groups(hd, kc.element_size())   # rows at a time
    tile = steps * groups                    # rows per warp tile
    qf = q.float()[:, 0] / math.sqrt(hd)                   # (B,H,hd)
    group = torch.arange(H) // n_rep
    kf, vf = kc.float()[:, :, group], vc.float()[:, :, group]  # (B,S,H,hd)
    if ks is not None:
        ksc, vsc = ks[:, :, group, 0], vs[:, :, group, 0]    # (B,S,H)
    spans = []
    for s0 in range(0, length, plan.span):
        end = min(length, s0 + plan.span)
        state = {}
        for t, j0 in enumerate(range(s0, end, tile)):
            for g in range(groups):
                rows = torch.arange(j0 + g, j0 + tile, groups)
                live = rows < end
                rows = torch.where(live, rows, s0)
                x = torch.einsum("bhd,bthd->bht", qf, kf[:, rows])
                vt = vf[:, rows] * live[None, :, None, None]
                if ks is not None:
                    x = x * ksc[:, rows].transpose(1, 2)
                x = torch.where(live, x, torch.tensor(NEG))
                m, l, acc = state.get((t % 4, g), (
                    torch.full((B, H), NEG), torch.zeros(B, H),
                    torch.zeros(B, H, hd)))
                m_new = torch.maximum(m, x.amax(-1))
                p = torch.exp(x - m_new[..., None])
                c = torch.exp(m - m_new)
                l = l * c + p.sum(-1)
                if ks is not None:
                    p = p * (vsc[:, rows] * live[:, None]).transpose(1, 2)
                acc = acc * c[..., None] + torch.einsum("bht,bthd->bhd", p,
                                                        vt)
                state[(t % 4, g)] = (m_new, l, acc)
        spans.append(_merge(list(state.values())))
    _, l, acc = spans[0] if len(spans) == 1 else _merge(spans)
    if len(spans) == 1:
        o = acc / torch.clamp(l, min=1e-20)[..., None]
    else:
        o = acc * (1.0 / torch.clamp(l, min=1e-20))[..., None]
    return o[:, None].to(q.dtype)


@pytest.mark.parametrize("geometry", [
    (2, 256, 6, 2, 64, 200),     # GQA 3: one block of 4 slots per group
    (2, 96, 4, 4, 112, 77),      # n_rep 1, hd 112 (zamba2-7b's)
    (1, 160, 2, 2, 32, 130),     # n_rep 1, hd 32: 64-row warp tiles
    (1, 192, 16, 2, 32, 150),    # GQA 8: two blocks per group
])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("span", [32, 64, 96, None])
def test_split_decode_emulation_matches_reference(geometry, kv_dtype, span):
    """The kernel's split and merge at several spans (None: the whole live
    cache in one span, no merge) against the reference's Pallas kernel."""
    B, S, H, Hkv, hd, length = geometry
    rng = np.random.RandomState(S + H + hd)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    qdtype = "float32" if kv_dtype == "float32" else "bfloat16"
    jq, tq = both(q, qdtype)
    jkq, jks = jquantize_kv(jnp.asarray(kc), kv_dtype)
    jvq, jvs = jquantize_kv(jnp.asarray(vc), kv_dtype)
    tkq, tks = quantize_kv(torch.from_numpy(kc), kv_dtype)
    tvq, tvs = quantize_kv(torch.from_numpy(vc), kv_dtype)
    slots = fd_ops.head_slots(H // Hkv)
    plan = fd_ops.Split(slots, span or length, -(-length // (span or length)),
                        4, 2)
    got = split_decode(tq, tkq, tvq, length, tks, tvs, plan)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jfd_ops.flash_decode(jq, jkq, jvq, length, jks, jvs,
                                block_kv=128)
    t = 2e-5 if kv_dtype == "float32" else 2e-2
    np.testing.assert_allclose(t2n(got), j2n(want), atol=t, rtol=t)


@pytest.mark.parametrize("n_rep,slots", [(1, 1), (2, 4), (3, 4), (4, 4),
                                         (7, 4), (12, 4), (16, 4)])
def test_head_slots(n_rep, slots):
    assert fd_ops.head_slots(n_rep) == slots


@pytest.mark.parametrize("geometry,block_kv,n_sm,want", [
    # zamba2-7b decode at length 1056: 128 (batch, KV head) blocks give
    # every SM about one, so the live cache is one span and nothing merges
    ((4, 32, 1, 112, 1056), 128, 132, (1, 1152, 1)),
    # smollm-135m: 12 blocks of 3 query heads (4 slots), one tile a span
    ((4, 3, 3, 64, 1056), 128, 132, (4, 128, 9)),
    # glm4-9b at length 20001: 4 blocks of 4 query heads per KV head, 10
    # tiles a span for at most two blocks per SM
    ((2, 2, 16, 128, 20001), 128, 132, (4, 1280, 16)),
    # a short cache: one span, no merge
    ((1, 1, 1, 64, 100), 128, 132, (1, 128, 1)),
    # hd 256, 4 slots: the merge bound allows at most 16 spans
    ((1, 1, 4, 256, 8192), 64, 1000, (4, 512, 16)),
])
def test_plan_split(geometry, block_kv, n_sm, want):
    B, Hkv, n_rep, hd, length = geometry
    got = fd_ops.plan_split(B, Hkv, n_rep, hd, length, block_kv, n_sm)
    assert got[:3] == want
    blocks = B * Hkv * -(-n_rep // got.slots) * got.n_split
    assert got.warps == (8 if blocks <= n_sm else 4)
    assert got.span % block_kv == 0
    assert (got.n_split - 1) * got.span < length <= got.n_split * got.span
    assert got.n_split == 1 or \
        got.n_split * got.slots * hd <= fd_ops.MERGE_FLOATS


@pytest.mark.parametrize("length", [1, 33, 1000, 4096, 20001])
@pytest.mark.parametrize("block_kv", [1, 128, 512])
def test_plan_split_invariants(length, block_kv):
    for B, Hkv, n_rep, hd, kvb in ((4, 32, 1, 112, 2), (2, 2, 16, 128, 2),
                                   (2, 8, 12, 192, 1), (1, 1, 1, 16, 4),
                                   (4, 3, 3, 64, 1)):
        p = fd_ops.plan_split(B, Hkv, n_rep, hd, length, block_kv, 132, kvb)
        blocks = B * Hkv * -(-n_rep // p.slots)
        assert p.span % block_kv == 0
        assert (p.n_split - 1) * p.span < length <= p.n_split * p.span
        if 2 * blocks >= 132:      # the blocks fill the card: one span
            assert p.n_split == 1
        else:
            assert p.n_split == 1 or \
                p.n_split * p.slots * hd <= fd_ops.MERGE_FLOATS
            # spans longer than one tile only for the fill or the merge
            if p.span > block_kv:
                assert (p.n_split - 1) * blocks < \
                    fd_ops.BLOCKS_PER_SM * 132 or \
                    p.n_split * p.slots * hd * 2 > fd_ops.MERGE_FLOATS


def test_ticket_buffers_per_stream(monkeypatch):
    """Calls on two streams never share merge tickets; one stream keeps
    its zeroed buffer and replaces it only when a call needs more."""
    monkeypatch.setattr(fd_ops, "_tickets", {})
    cpu = torch.device("cpu")
    a = fd_ops._ticket_buffer(cpu, 1, 8)
    assert fd_ops._ticket_buffer(cpu, 1, 100) is a
    b = fd_ops._ticket_buffer(cpu, 2, 8)
    assert b is not a and b.data_ptr() != a.data_ptr()
    big = fd_ops._ticket_buffer(cpu, 1, 5000)
    assert big.numel() >= 5000 and big.dtype == torch.int32
    assert not big.any() and fd_ops._ticket_buffer(cpu, 2, 8) is b


@pytest.mark.parametrize("hd,kv_bytes,rows", [
    (16, 1, 128), (64, 2, 32), (112, 2, 16), (112, 1, 16), (128, 4, 8),
    (256, 2, 8), (256, 4, 4)])
def test_ring_stages(hd, kv_bytes, rows):
    """A warp tile is 8 steps of 32/L rows (4 steps with two chunks a lane
    or with int8 rows); a warp's ring holds as many stages of K, V and
    scales as WARP_RING_BYTES does, between 2 and 4."""
    assert fd_ops.warp_tile_rows(hd, kv_bytes) == rows
    stage = 2 * rows * (hd * kv_bytes + 16 + 4)
    want = max(2, min(4, fd_ops.WARP_RING_BYTES // stage))
    assert fd_ops.ring_stages(hd, kv_bytes) == want
    assert fd_ops.plan_split(1, 1, 1, hd, 100, 128, 132,
                             kv_bytes).stages == want


@pytest.mark.parametrize("hd,kv_bytes,slots", [
    (112, 2, 1), (112, 1, 1), (112, 4, 1), (64, 2, 4), (64, 1, 4),
    (16, 1, 1), (16, 2, 4), (128, 2, 4), (192, 2, 4), (256, 4, 4)])
def test_decode_warps_fit_shared_memory(hd, kv_bytes, slots):
    """A plan that fits in one wave takes 8 warps only where their rings
    fit a block's shared memory, else 4; every plan fits."""
    p = fd_ops.plan_split(1, 1, 1 if slots == 1 else 4, hd, 100, 128, 132,
                          kv_bytes)
    eight = fd_ops.smem_bytes(hd, kv_bytes, p.slots, 8, p.stages)
    assert p.warps == (8 if eight <= fd_ops.SMEM_LIMIT else 4)
    assert fd_ops.smem_bytes(hd, kv_bytes, p.slots, p.warps, p.stages) \
        <= fd_ops.SMEM_LIMIT
