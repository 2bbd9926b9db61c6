"""The port's plain versions of the four kernels against the reference's
``ops`` wrappers (Pallas in interpret mode on the CPU) and ``ref.py``
oracles, on the same numpy inputs.  Tolerances are those of
tests/test_kernels.py: f32 2e-5 (summation order), bf16 / int8 2e-2
(one bf16 rounding of the output); ssm_scan 1e-4 f32, 5e-2 bf16.  On
the CPU the port's wrappers use their plain versions; the CUDA kernels
are held against the same plain versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro.kernels.flash_decode import ops as jfd_ops, ref as jfd_ref
from repro.kernels.rmsnorm import ops as jrms_ops, ref as jrms_ref
from repro.kernels.ssm_scan import ops as jssm_ops, ref as jssm_ref
from repro.kernels.tiling import fit_block as jfit_block
from repro.models.layers import quantize_kv as jquantize_kv
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fd_ops, ref as fd_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops, ref as ssm_ref
from repro_torch.kernels.tiling import fit_block
from repro_torch.models.layers import quantize_kv

from _torch_parity import both, j2n, t2n



def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("block,n", [(128, 256), (512, 256), (128, 192),
                                     (128, 97), (64, 97), (0, 64),
                                     (256, 300), (128, 1), (512, 4096)])
def test_fit_block_parity(block, n):
    assert fit_block(block, n) == jfit_block(block, n)


@pytest.mark.parametrize("shape", [(8, 64), (3, 37, 512), (2, 4, 16, 128),
                                   (111, 64), (5, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_parity(shape, dtype):
    rng = np.random.RandomState(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    jx, tx = both(x, dtype)
    js, ts = both(s, "float32")      # the model passes the f32 scale uncast
    out = rms_ops.rmsnorm(tx, ts)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    np.testing.assert_allclose(t2n(out), j2n(jrms_ops.rmsnorm(jx, js)),
                               **tol(dtype))
    np.testing.assert_allclose(t2n(rms_ref.rmsnorm_ref(tx, ts)),
                               j2n(jrms_ref.rmsnorm_ref(jx, js)),
                               **tol(dtype))


@pytest.mark.parametrize("B,H,S,hd,blocks,causal", [
    (1, 1, 128, 64, (64, 64), True),
    (2, 3, 256, 64, (128, 128), True),
    (2, 1, 128, 32, (64, 128), True),
    (1, 2, 96, 64, (128, 128), True),        # ragged: tile fits to 96
    (1, 2, 300, 64, (256, 64), True),        # ragged: tiles 150 / 60
    (1, 2, 128, 64, (64, 64), False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_parity(B, H, S, hd, blocks, causal, dtype):
    rng = np.random.RandomState(S + hd)
    arrs = [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = [both(a, dtype) for a in arrs]
    out = fa_ops.flash_attention(tq, tk, tv, causal=causal,
                                 block_q=blocks[0], block_kv=blocks[1])
    assert out.dtype == tq.dtype and out.shape == tq.shape
    jout = jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                   block_q=blocks[0], block_kv=blocks[1])
    np.testing.assert_allclose(t2n(out), j2n(jout), **tol(dtype))
    tr = lambda t: t.transpose(0, 2, 1, 3)
    jref = tr(jfa_ref.attention_ref(tr(jq), tr(jk), tr(jv), causal=causal))
    tref = fa_ref.attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2),
                                causal=causal).transpose(1, 2)
    np.testing.assert_allclose(t2n(tref), j2n(jref), **tol(dtype))


@pytest.mark.parametrize("B,H,Hkv,S,hd,length", [
    (1, 4, 4, 128, 64, 128), (2, 8, 2, 256, 64, 200),
    (1, 4, 2, 192, 64, 150),                 # ragged cache: tile fits to 96
    (2, 6, 3, 64, 32, 1)])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "float32"])
def test_flash_decode_parity(B, H, Hkv, S, hd, length, kv_dtype):
    rng = np.random.RandomState(S + H)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    jkq, jks = jquantize_kv(jnp.asarray(kc), kv_dtype)
    jvq, jvs = jquantize_kv(jnp.asarray(vc), kv_dtype)
    tkq, tks = quantize_kv(torch.from_numpy(kc), kv_dtype)
    tvq, tvs = quantize_kv(torch.from_numpy(vc), kv_dtype)
    # both sides store the same cache, bit for bit
    np.testing.assert_array_equal(t2n(tkq), j2n(jkq))
    if kv_dtype == "int8":
        np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    out = fd_ops.flash_decode(torch.from_numpy(q), tkq, tvq, length, tks, tvs,
                              block_kv=128)
    jout = jfd_ops.flash_decode(jnp.asarray(q), jkq, jvq, length, jks, jvs,
                                block_kv=128)
    t = tol("float32") if kv_dtype == "float32" else tol("bfloat16")
    np.testing.assert_allclose(t2n(out), j2n(jout), **t)
    tr = lambda x: None if x is None else x.transpose(0, 2, 1, 3)
    jref = tr(jfd_ref.decode_ref(tr(jnp.asarray(q)), tr(jkq), tr(jvq),
                                 tr(jks), tr(jvs), jnp.array([length])))
    np.testing.assert_allclose(t2n(out), j2n(jref), **t)
    tt = lambda x: None if x is None else x.transpose(1, 2)
    tref = fd_ref.decode_ref(tt(torch.from_numpy(q)), tt(tkq), tt(tvq),
                             tt(tks), tt(tvs), length).transpose(1, 2)
    assert tref.dtype == torch.float32
    np.testing.assert_allclose(t2n(tref), j2n(jref), **t)


def test_wrappers_take_plain_version_only_on_cpu():
    """The dispatch is by the tensor's device alone: a CPU tensor takes
    the plain version and counts no launch."""
    mods = (rms_ops, fa_ops, fd_ops, ssm_ops)
    before = [m.launches for m in mods]
    x = torch.randn(2, 3, 64)
    rms_ops.rmsnorm(x, torch.ones(64))
    q = torch.randn(1, 16, 2, 32)
    fa_ops.flash_attention(q, q, q)
    fd_ops.flash_decode(q[:, :1], q, q, 5)
    b = torch.randn(1, 16, 8)
    ssm_ops.ssm_scan(q, b, b, q[..., 0], -q[..., 0].abs(), chunk=8)
    assert before == [m.launches for m in mods]


@pytest.mark.parametrize("block_kv,hd,dtype,fits", [
    (128, 64, torch.bfloat16, True), (512, 64, torch.bfloat16, True),
    (256, 128, torch.bfloat16, True), (512, 128, torch.bfloat16, True),
    (256, 64, torch.float32, True), (512, 64, torch.float32, True),
    (128, 128, torch.float32, True), (256, 128, torch.float32, True),
    (512, 32, torch.float32, True),
    # hd 112 (zamba2-7b, kimi-k2) and 192 (nemotron-4-340b)
    (512, 112, torch.bfloat16, True), (256, 112, torch.float32, True),
    (512, 112, torch.float32, True), (256, 192, torch.bfloat16, True),
    (512, 192, torch.bfloat16, True), (128, 192, torch.float32, True),
    (256, 192, torch.float32, True)])
def test_flash_attention_smem_table(block_kv, hd, dtype, fits):
    """Both kernels ask for their own Q rows and two stages of K and V,
    whatever the knob's block_kv.  bf16: 64 x 64 to hd 64, 128 x 32 to hd
    128, 64 x 32 above, rows padded by 8 elements.  f32: 64 x 64 to hd 64,
    64 x 32 above, rows padded by 4 floats.  Both fit at every head dim."""
    need = fa_ops.smem_bytes(hd, dtype)
    if dtype == torch.bfloat16:
        bq, bkv = (64, 64) if hd <= 64 else (128, 32) if hd <= 128 \
            else (64, 32)
        assert need == (bq + 2 * 2 * bkv) * (hd + 8) * 2
    else:
        bkv = 64 if hd <= 64 else 32
        assert need == (64 + 2 * 2 * bkv) * (hd + 4) * 4
    assert (need <= fa_ops.SMEM_LIMIT) == fits


def test_head_dims_cover_every_config():
    """Both attention wrappers take every multiple of 16 up to 256, which
    covers the head dim of every config that has attention (112:
    zamba2-7b, kimi-k2; 192: nemotron-4-340b; xlstm has none)."""
    from repro_torch.configs import get_config, list_archs
    want = tuple(range(16, 257, 16))
    assert fa_ops.HEAD_DIMS == fd_ops.HEAD_DIMS == want
    hds = {get_config(a).hd for a in list_archs()
           if get_config(a).family != "ssm"}
    assert {112, 192} <= hds and hds <= set(want)


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


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 256, 1, 64, 64, 64),
    (1, 96, 2, 8, 8, 64),                    # ragged: chunk fits to 48
    (1, 130, 2, 8, 8, 32)])                  # ragged: chunk fits to 26
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_parity(B, S, H, P, N, chunk, dtype):
    X, Bm, Cm, dt, la = ssm_inputs(B, S, H, P, N, S * H)
    (jX, tX), (jB, tB), (jC, tC) = (both(a, dtype) for a in (X, Bm, Cm))
    (jdt, tdt), (jla, tla) = both(dt), both(la)
    t = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=1e-4)
    Y, h = ssm_ops.ssm_scan(tX, tB, tC, tdt, tla, chunk=chunk)
    assert Y.dtype == tX.dtype and Y.shape == tX.shape
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    jY, jh = jssm_ops.ssm_scan(jX, jB, jC, jdt, jla, chunk=chunk)
    np.testing.assert_allclose(t2n(Y), j2n(jY), **t)
    np.testing.assert_allclose(t2n(h), j2n(jh), **t)
    # the exact per-token oracles of both packages, and the chunked
    # version against the oracle
    tYr, thr = ssm_ref.ssm_scan_ref(tX, tB, tC, tdt, tla)
    jYr, jhr = jssm_ref.ssm_scan_ref(jX, jB, jC, jdt, jla)
    np.testing.assert_allclose(t2n(tYr), j2n(jYr), **t)
    np.testing.assert_allclose(t2n(thr), j2n(jhr), **t)
    np.testing.assert_allclose(t2n(Y), j2n(jYr), **t)
    np.testing.assert_allclose(t2n(h), j2n(jhr), **t)


def test_ssm_scan_chunked_takes_any_dividing_chunk():
    """The plain chunked version is right for every chunk that divides S,
    down to 1 (a prime S fits the chunk to 1), and refuses one that does
    not divide S (the wrapper fits it first)."""
    X, Bm, Cm, dt, la = (torch.from_numpy(a)
                         for a in ssm_inputs(1, 37, 2, 8, 4, 0))
    Yr, hr = ssm_ref.ssm_scan_ref(X, Bm, Cm, dt, la)
    assert fit_block(32, 37) == 1
    for chunk in (1, 37):
        Y, h = ssm_ref.ssm_scan_chunked(X, Bm, Cm, dt, la, chunk)
        np.testing.assert_allclose(Y.numpy(), Yr.numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=1e-4,
                                   rtol=1e-4)
    with pytest.raises(ValueError):
        ssm_ref.ssm_scan_chunked(X, Bm, Cm, dt, la, 5)
