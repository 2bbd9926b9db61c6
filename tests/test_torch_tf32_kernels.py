"""The arithmetic of the port's two TF32 tensor-core kernels, emulated in
torch on the CPU and held against the JAX package's kernels (Pallas in
interpret mode, as tests/test_kernels.py runs them) and oracles on numpy
inputs from a seed.

- ``tf32_ssd``: csrc/ssm_scan.cu -- chunks of the kernel's own 64 rows at
  every S, the ragged last chunk masked; the cumulative sum of la taken
  and differenced in f64; G = C.B^T and the within-chunk term S X of the
  decayed scores as TF32 products (bf16 X) or as three TF32 products of
  split operands (f32 X); the state path -- the state update X^T (w B)
  and the carried term C h^T -- split at both X dtypes (bf16 X is exact
  in TF32, so its low part is zero); the state passed from chunk to chunk
  in f32; one rounding of Y to X's dtype.
- ``tf32_attention``: csrc/flash_attention_f32.cu -- the kernel's own
  tiles (``f32_tiles``) at every S, Q.K^T and P.V as three TF32 products
  of split operands, scores scaled by scale * log2(e) and exponentiated
  with exp2, the ragged edge and the causal diagonal masked with -1e30,
  the denominator clamped at 1e-20.

Tolerances: ssm_scan 1e-4 (f32 X) and 5e-2 (bf16 X), f32 attention 2e-5,
those of tests/test_kernels.py; the scan's final state is f32 at both X
dtypes and is held at 1e-4.  The reference runs its fitted tiles, so
the prime lengths stay small (37, 61): at a prime S its tiles are 1 row.
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.ssm_scan import ops as jssm_ops, ref as jssm_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.tiling import fit_block

from _torch_parity import both, j2n, t2n

NEG = -1e30
LOG2E = 1.4426950408889634


def tf32(x):
    """x cut to TF32, as the kernels cut an operand: its 13 low mantissa
    bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def mm(a, b, three):
    """a @ b as the kernels' mma computes it: TF32 operands, f32 sums; with
    ``three``, lo.hi + hi.lo + hi.hi of split operands."""
    if not three:
        return tf32(a) @ tf32(b)
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def tf32_ssd(X, Bm, Cm, dt, la, Q=ssm_ops.KERNEL_CHUNK, split_state=True):
    """X (B,S,H,P) f32/bf16; Bm/Cm (B,S,N); dt/la (B,S,H) -> (Y in X's
    dtype, h (B,H,P,N) f32), chunk by chunk as the kernel computes it.
    ``split_state=False`` runs the state path on single TF32 products at
    bf16 X, the precision the kernel does not use there."""
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    three = X.dtype == torch.float32
    three_state = three or split_state
    Xf = X.float().permute(0, 2, 1, 3)                  # (B,H,S,P)
    Bf, Cf = Bm.float(), Cm.float()
    dtf, laf = dt.float().transpose(1, 2), la.float().transpose(1, 2)
    h = torch.zeros(B, H, P, N)
    Y = torch.empty(B, H, S, P)
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        # the ragged last chunk: rows past S are zeros with dt = la = 0
        pad = lambda t: torch.cat(
            [t, t.new_zeros(t.shape[:-2] + (Q - q,) + t.shape[-1:])], -2)
        Xc = pad(Xf[:, :, c0:c0 + q])                   # (B,H,Q,P)
        Bc, Cc = pad(Bf[:, c0:c0 + q]), pad(Cf[:, c0:c0 + q])   # (B,Q,N)
        dtc = pad(dtf[:, :, c0:c0 + q, None])[..., 0]   # (B,H,Q)
        cum = torch.cumsum(pad(laf[:, :, c0:c0 + q, None])[..., 0].double(),
                           -1)
        G = mm(Cc, Bc.transpose(1, 2), three)           # (B,Q,Q)
        rows = torch.arange(Q)
        live = (rows[None, :] <= rows[:, None]) & (rows[:, None] < q)
        decay = torch.exp((cum[..., :, None] - cum[..., None, :]).float())
        Sc = torch.where(live, G[:, None] * decay * dtc[:, :, None, :],
                         torch.zeros(()))
        w = dtc * torch.exp((cum[..., -1:] - cum).float())     # (B,H,Q)
        St = mm(Xc.transpose(-1, -2), w[..., None] * Bc[:, None],
                three_state)
        y = mm(Cc[:, None], h.transpose(-1, -2), three_state) \
            * torch.exp(cum.float())[..., None] if c0 else 0.
        y = y + mm(Sc, Xc, three)
        Y[:, :, c0:c0 + q] = y[:, :, :q]
        h = torch.exp(cum[..., -1].float())[..., None, None] * h + St
    return Y.permute(0, 2, 1, 3).to(X.dtype), h


def tf32_attention(q, k, v, causal=True):
    """q/k/v: (B, S, H, hd) f32 -> (B, S, H, hd) f32, tile by tile as the
    f32 kernel computes it."""
    B, S, H, hd = q.shape
    bq, bkv = fa_ops.f32_tiles(hd)
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
            s = mm(qt, kt.transpose(-1, -2), True)
            dead = cols[None, :] >= S
            if causal:
                dead = dead | (cols[None, :] > rows[:, None])
            s = torch.where(dead, torch.tensor(NEG), s)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
            p = torch.exp2(s * scale_log2 - m_new)
            c = torch.exp2(m - m_new)
            l = l * c + p.sum(-1, keepdim=True)
            acc = acc * c + mm(p, vt, True)
            m = m_new
        o = acc / torch.clamp(l, min=1e-20)
        out[:, :, q0:q0 + bq] = o[:, :, :min(bq, S - q0)]
    return out.transpose(1, 2)


def ssm_inputs(B, S, H, P, N, seed):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    la = (-dt * np.exp(rng.standard_normal(H) * 0.2)[None, None]
          ).astype(np.float32)
    return X, Bm, Cm, dt, la


def ssm_tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=1e-4)


H_TOL = ssm_tol("float32")   # h_final is f32 at both X dtypes


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 37, 2, 16, 8),        # prime: the reference's chunk fits to 1
    (1, 61, 3, 32, 16),       # prime, zamba2-7b-reduced's P and N
    (2, 130, 2, 8, 8),        # ragged last chunk (2 rows); chunk fits to 26
    (1, 128, 2, 64, 64)])     # dividing S, zamba2-7b's P and N
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tf32_ssd_emulation_matches_reference(B, S, H, P, N, dtype):
    """The kernel's chunking and roundings against the reference's Pallas
    kernel at its fitted chunk and against its per-token oracle."""
    X, Bm, Cm, dt, la = ssm_inputs(B, S, H, P, N, S * P)
    (jX, tX), (jB, tB), (jC, tC) = (both(a, dtype) for a in (X, Bm, Cm))
    (jdt, tdt), (jla, tla) = both(dt), both(la)
    Y, h = tf32_ssd(tX, tB, tC, tdt, tla)
    assert Y.dtype == tX.dtype and h.dtype == torch.float32
    chunk = 32
    jY, jh = jssm_ops.ssm_scan(jX, jB, jC, jdt, jla, chunk=chunk)
    jYr, jhr = jssm_ref.ssm_scan_ref(jX, jB, jC, jdt, jla)
    for want, got in ((jY, Y), (jYr, Y)):
        np.testing.assert_allclose(t2n(got), j2n(want), **ssm_tol(dtype))
    for want in (jh, jhr):
        np.testing.assert_allclose(t2n(h), j2n(want), **H_TOL)
    # the port's plain version runs the kernel's chunk too
    pY, ph = ssm_ops.ssm_scan(tX, tB, tC, tdt, tla, chunk=chunk)
    np.testing.assert_allclose(t2n(pY), j2n(jYr), **ssm_tol(dtype))
    np.testing.assert_allclose(t2n(ph), j2n(jhr), **H_TOL)


def test_ssd_chunk_is_the_kernels_own():
    """At a prime S the reference's chunk fits to 1 row; the kernel and
    the plain version run chunks of 64 whatever the knob, and the knob's
    chunk changes nothing in the result."""
    assert fit_block(256, 919) == 1 and fit_block(256, 746) == 2
    assert ssm_ops.KERNEL_CHUNK == 64   # kQ in csrc/ssm_scan.cu
    ins = [torch.from_numpy(a) for a in ssm_inputs(1, 67, 2, 8, 8, 0)]
    runs = [ssm_ops.ssm_scan(*ins, chunk=c) for c in (1, 2, 67, 256)]
    for Y, h in runs[1:]:
        assert torch.equal(Y, runs[0][0]) and torch.equal(h, runs[0][1])


@pytest.mark.parametrize("B,S,H,P,N", [(1, 61, 3, 32, 16),
                                       (1, 128, 2, 64, 64)])
def test_ssd_state_needs_split_products_at_bf16_x(B, S, H, P, N):
    """Why the kernel splits the state path's operands at bf16 X as well:
    the final state is f32 and held at 1e-4; a state path of single TF32
    products misses that by about 10x, the split one holds it."""
    X, Bm, Cm, dt, la = ssm_inputs(B, S, H, P, N, S * P)
    (jX, tX), (jB, tB), (jC, tC) = (both(a, "bfloat16") for a in (X, Bm, Cm))
    (jdt, tdt), (jla, tla) = both(dt), both(la)
    jh = j2n(jssm_ref.ssm_scan_ref(jX, jB, jC, jdt, jla)[1])
    _, h = tf32_ssd(tX, tB, tC, tdt, tla)
    np.testing.assert_allclose(t2n(h), jh, **H_TOL)
    _, h1 = tf32_ssd(tX, tB, tC, tdt, tla, split_state=False)
    excess = np.abs(t2n(h1) - jh) - H_TOL["rtol"] * np.abs(jh)
    assert excess.max() > 5 * H_TOL["atol"]


def test_single_tf32_does_not_hold_f32_tolerance():
    """Why the f32 paths split their operands: one TF32 product per f32
    product misses 1e-4 on the scan's C.B^T and 2e-5 on attention's
    scores, three TF32 products hold both, and so do the emulated kernels
    end to end."""
    over = lambda got, want, tol: float(
        ((got.double() - want).abs() - tol * want.abs()).max()) > tol
    X, Bm, Cm, dt, la = (torch.from_numpy(a)
                         for a in ssm_inputs(1, 128, 2, 64, 64, 1))
    G = Cm[0].double() @ Bm[0].double().T
    assert over(mm(Cm[0], Bm[0].T, False), G, 1e-4)
    assert not over(mm(Cm[0], Bm[0].T, True), G, 1e-4)
    Yr, hr = ssm_ops.ssm_scan(X, Bm, Cm, dt, la)
    Y, h = tf32_ssd(X, Bm, Cm, dt, la)
    assert not over(Y, Yr.double(), 1e-4) and not over(h, hr.double(), 1e-4)

    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 112))
                                .astype(np.float32)) for _ in range(3))
    s = q.double() @ k.double().transpose(-1, -2)
    assert over(mm(q, k.transpose(-1, -2), False), s, 2e-5)
    assert not over(mm(q, k.transpose(-1, -2), True), s, 2e-5)
    want = torch.softmax(s / math.sqrt(112), -1) @ v.double()
    got = tf32_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                         causal=False).transpose(1, 2)
    assert not over(got, want, 2e-5)


@pytest.mark.parametrize("S", [37, 61, 128])
@pytest.mark.parametrize("hd", [64, 112])
def test_tf32_attention_emulation_matches_reference(S, hd):
    """The f32 kernel's tiles and three-TF32 arithmetic against the
    reference's Pallas kernel at the knob's fitted tiles (37 and 61 are
    prime: the reference's tiles fit to 1 row, the kernel's are 64 x 64
    or 64 x 32 with the edge masked)."""
    B, H = 1, 2
    rng = np.random.RandomState(S * hd + 1)
    arrs = [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = [both(a) for a in arrs]
    for causal in (True, False):
        got = tf32_attention(tq, tk, tv, causal=causal)
        assert got.dtype == torch.float32 and got.shape == tq.shape
        want = jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=128, block_kv=128)
        np.testing.assert_allclose(t2n(got), j2n(want), atol=2e-5,
                                   rtol=2e-5)


def test_f32_tiles_do_not_follow_the_knob():
    """The f32 kernel's tiles are its own -- 64 x 64 to hd 64, 64 x 32
    above, whatever the knob -- and it fits at every head dim (199,680
    bytes at hd 256)."""
    assert [fa_ops.f32_tiles(hd) for hd in (16, 64, 80, 112, 256)] == \
        [(64, 64), (64, 64), (64, 32), (64, 32), (64, 32)]
    need = {hd: fa_ops.smem_bytes(hd, torch.float32)
            for hd in fa_ops.HEAD_DIMS}
    assert max(need.values()) == need[256] == 199_680
    assert all(n <= fa_ops.SMEM_LIMIT for n in need.values())
