"""Mamba2 blocks and the hybrid model's cache handling in the PyTorch port
against the reference, on zamba2-7b's reduced config: the same weights
(``from_jax_params``) with Mamba2's ``dt_bias``, ``A_log`` and ``D`` drawn
random and non-zero (the initialiser leaves them 0, 0, 1, where rounding
them would not show), the same numpy inputs.  The whole model is held
against the reference in tests/test_torch_hybrid_model.py.

Tolerances as in tests/test_torch_model.py: f32 compute 1e-4 relative to
the tensor's scale (the SSM state 2e-4: it sums a whole prompt); bf16
compute 5e-2 in the relative Frobenius norm, on outputs and states."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core.params import default_config as jdefault
from repro.models import mamba2 as jm2
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core.params import default_config
from repro_torch.models import layers as TL, mamba2 as tm2
from repro_torch.models.model import build_model

from _torch_parity import both, fro_close, j2n, rel_close, t2n

B, S, MAX_SEQ, STEPS = 2, 40, 48, 2
# reduced: 4 Mamba2 blocks, the shared block after every 2nd (no
# remainder); rem: 5 blocks, 2 groups + 1; one: 1 block + 1 shared block
VARIANTS = {"reduced": {}, "rem": {"n_layers": 5, "attn_every": 2},
            "one": {"n_layers": 1, "attn_every": 1}}


def cfgs(variant):
    return (jget_reduced("zamba2-7b").replace(**VARIANTS[variant]),
            get_reduced("zamba2-7b").replace(**VARIANTS[variant]))


def vary_ssm_params(tree, rng):
    """Random, non-zero dt_bias, A_log and D in every Mamba2 block."""
    if isinstance(tree, dict):
        return {k: (vary_ssm_params(v, rng) if isinstance(v, dict) else
                    _draw(k, v, rng)) for k, v in tree.items()}
    return tree


def _draw(name, arr, rng):
    arr = np.asarray(arr)
    if name in ("dt_bias", "A_log"):
        return (rng.standard_normal(arr.shape) * 0.5).astype(arr.dtype)
    if name == "D":
        return (1.0 + rng.standard_normal(arr.shape) * 0.3).astype(arr.dtype)
    return arr


@functools.lru_cache(maxsize=None)
def weights(variant):
    """(reference params, port params) with the same numbers."""
    jcfg, _ = cfgs(variant)
    host = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    host = vary_ssm_params(host, np.random.RandomState(3))
    return jax.tree.map(jnp.asarray, host), from_jax_params(host)


def block_params(variant="reduced"):
    """One Mamba2 block's parameters (group 0, block 1) of both packages."""
    jp, tp = weights(variant)
    pick = lambda t: t[0, 1]
    return (jax.tree.map(pick, jp["groups"]),
            {k: pick(v) for k, v in tp["groups"].items()})


# ----------------------------------------------------------- mamba2 pieces
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    st = rng.standard_normal((2, 3, 8)).astype(np.float32)
    (jx, tx), (jw, tw), (js, ts) = both(x), both(w), both(st)
    jy, jst = jm2._causal_conv(jx, jw, js if with_state else None)
    ty, tst = tm2._causal_conv(tx, tw, ts if with_state else None)
    np.testing.assert_allclose(t2n(ty), j2n(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(t2n(tst), j2n(jst))


@pytest.mark.parametrize("S_,chunk", [(64, 16), (40, 16), (7, 32)])
def test_ssd_chunked_pads_ragged_sequences(S_, chunk):
    """The eager path pads S to a multiple of the chunk, as the
    reference's ``ssd_chunked`` does (40 and 7 are ragged)."""
    from test_torch_kernels import ssm_inputs
    X, Bm, Cm, dt, la = ssm_inputs(2, S_, 3, 8, 4, S_)
    h0 = np.random.RandomState(2).standard_normal((2, 3, 8, 4)).astype(
        np.float32)
    pairs = [both(a) for a in (X, Bm, Cm, dt, la, h0)]
    jY, jh = jm2.ssd_chunked(*[p[0] for p in pairs[:5]], chunk,
                             h0=pairs[5][0])
    tY, th = tm2.ssd_chunked(*[p[1] for p in pairs[:5]], chunk,
                             h0=pairs[5][1])
    rel_close(tY, jY, 1e-4)
    rel_close(th, jh, 1e-4)


def _mamba_inputs(d, seed=5, seq=S):
    x = np.random.RandomState(seed).standard_normal((B, seq, d))
    return both(x.astype(np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_block(impl, compute):
    jcfg, tcfg = cfgs("reduced")
    jp, tp = block_params()
    kw = dict(compute_dtype=compute, attn_impl=impl)
    jrt, trt = jdefault(**kw), default_config(**kw)
    tpc = TL.cast_params(tp, tm2.mamba_spec(tcfg), trt)   # as serving does
    (jx, tx) = _mamba_inputs(tcfg.d_model)
    jx, tx = jx.astype(jrt_dtype(compute)), tx.to(TL.dt(trt))
    jout, jst = jm2.mamba_block(jp, jx, jcfg, jrt, None, want_state=True)
    with torch.no_grad():
        tout, tst = tm2.mamba_block(tpc, tx, tcfg, trt, None, want_state=True)
    assert tout.dtype == tx.dtype and tst["ssm"].dtype == torch.float32
    if compute == "float32":
        rel_close(tout, jout, 1e-4)
        rel_close(tst["ssm"], jst["ssm"], 2e-4)
        rel_close(tst["conv"], jst["conv"], 1e-4)
    else:
        for t, j in ((tout, jout), (tst["ssm"], jst["ssm"]),
                     (tst["conv"], jst["conv"])):
            fro_close(t, j, 5e-2)


def jrt_dtype(compute):
    return jnp.float32 if compute == "float32" else jnp.bfloat16


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_decode_block(compute):
    jcfg, tcfg = cfgs("reduced")
    jp, tp = block_params()
    jrt, trt = jdefault(compute_dtype=compute), default_config(
        compute_dtype=compute)
    tpc = TL.cast_params(tp, tm2.mamba_spec(tcfg), trt)
    rng = np.random.RandomState(9)
    H = tcfg.ssm_expand * tcfg.d_model // tcfg.ssm_head_dim
    cache = {"ssm": rng.standard_normal((B, H, tcfg.ssm_head_dim,
                                         tcfg.ssm_state)).astype(np.float32),
             "conv": rng.standard_normal(
                 (B, 3, tcfg.ssm_expand * tcfg.d_model)).astype(np.float32)}
    jc = {k: both(v)[0] for k, v in cache.items()}
    tc = {k: both(v)[1] for k, v in cache.items()}
    jx, tx = _mamba_inputs(tcfg.d_model, seed=6, seq=1)
    jx, tx = jx.astype(jrt_dtype(compute)), tx.to(TL.dt(trt))
    jout, jst = jm2.mamba_decode_block(jp, jx, jc, jcfg, jrt, None)
    before = {k: v.clone() for k, v in tc.items()}
    with torch.no_grad():
        tout, tst = tm2.mamba_decode_block(tpc, tx, tc, tcfg, trt, None)
    assert all(torch.equal(tc[k], before[k]) for k in tc)   # not modified
    assert tst["ssm"].dtype == tst["conv"].dtype == torch.float32
    if compute == "float32":
        rel_close(tout, jout, 1e-4)
        rel_close(tst["ssm"], jst["ssm"], 1e-4)
        rel_close(tst["conv"], jst["conv"], 1e-6)
    else:
        fro_close(tout, jout, 5e-2)
        fro_close(tst["ssm"], jst["ssm"], 5e-2)
        fro_close(tst["conv"], jst["conv"], 5e-2)


def test_cast_params_keeps_dt_bias_and_a_log_in_f32():
    """The reference reads dt_bias and A_log uncast (mamba2._gates); cast
    to bf16 they would move dt and the decay by up to one bf16 step (2e-3
    relative).  On an input of zeros the projections vanish and the gates
    are those two parameters alone: they must agree to f32 rounding."""
    jcfg, tcfg = cfgs("reduced")
    jp, tp = block_params()
    rt = default_config(compute_dtype="bfloat16")
    tpc = TL.cast_params(tp, tm2.mamba_spec(tcfg), rt)
    assert tpc["dt_bias"].dtype == tpc["A_log"].dtype == torch.float32
    assert torch.equal(tpc["dt_bias"], tp["dt_bias"])
    assert tpc["wdt"].dtype == tpc["conv"].dtype == torch.bfloat16
    assert tpc["D"].dtype == torch.float32          # a "ones" spec
    x = np.zeros((B, 3, tcfg.d_model), np.float32)
    jg = jm2._gates(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                    jdefault(compute_dtype="bfloat16"))
    with torch.no_grad():
        tg = tm2._gates(tpc, torch.from_numpy(x).to(torch.bfloat16), tcfg, rt)
    for i in (4, 5):                                  # dt, log decay
        np.testing.assert_allclose(t2n(tg[i]), j2n(jg[i]), rtol=1e-6,
                                   atol=1e-7)


def _clone(cache):
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v) for k, v in cache.items()}


def test_donate_buffers_in_place_or_copy():
    """donate_buffers=True updates the given cache's SSM, conv and KV
    tensors in place; False leaves them as they were.  Same results."""
    _, tcfg = cfgs("rem")
    m = build_model(tcfg)
    p = m.init(0, device="cpu")
    toks = torch.randint(0, tcfg.vocab, (2, 6), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    res = {}
    for donate in (True, False):
        rt = default_config(donate_buffers=donate)
        with torch.no_grad():
            logits, cache = m.prefill_fn(p, {"tokens": toks}, rt, max_seq=10)
            before = _clone(cache)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            l2, new = m.decode_fn(p, cache, tok, rt)
        for part, name in (("groups", "ssm"), ("groups", "conv"), ("kv", "k"),
                           ("rem", "ssm"), ("rem", "conv")):
            assert (new[part][name] is cache[part][name]) == donate
            assert torch.equal(cache[part][name],
                               before[part][name]) == (not donate)
        assert cache["pos"] == 6 and new["pos"] == 7
        res[donate] = (l2, new["groups"]["ssm"], new["kv"]["v"])
    for a, b in zip(res[True], res[False]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("save", ["float32", "bfloat16"])
def test_forward_carries_the_residual_in_the_save_dtype(save):
    """``zamba.forward`` (the layer stack the training slice will use)
    against the reference's on the variant with a remainder: f32 compute,
    the residual between groups carried in ``remat_save_dtype`` (a bf16
    carry rounds it: 2e-2, as tests/test_torch_model.py holds the dense
    carry)."""
    from repro.models import zamba as jz
    from repro_torch.models import zamba as tz
    jcfg, tcfg = cfgs("rem")
    jp, tp = weights("rem")
    kw = dict(compute_dtype="float32", remat_policy="dots",
              remat_save_dtype=save)
    (jx, tx) = _mamba_inputs(tcfg.d_model, seed=8, seq=12)
    pos = np.broadcast_to(np.arange(12), (B, 12))
    jout = jz.forward(jp, jx, jnp.asarray(pos), jcfg, jdefault(**kw), None)
    with torch.no_grad():
        tout = tz.forward(tp, tx, torch.from_numpy(pos.copy()), tcfg,
                          default_config(**kw), None)
    assert tout.dtype == torch.float32
    rel_close(tout, jout, 1e-4 if save == "float32" else 2e-2)


def test_loss_fn_names_the_training_queue():
    """The hybrid loss is ported (tests/test_torch_hybrid_train.py holds
    it against the reference; on a mesh, tests/test_torch_spmd_families.py);
    what the hybrid family cannot do yet, serving on a mesh of several
    devices, raises naming its queue."""
    _, tcfg = cfgs("reduced")
    _, tp = weights("reduced")
    toks = torch.zeros((1, 9), dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        loss, parts = build_model(tcfg).loss_fn(tp, batch, default_config())
    assert parts == {} and bool(torch.isfinite(loss))
    import types
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import stepfn
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(4, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        stepfn.build_prefill_step(tcfg, ShapeConfig("p", 8, 1, "prefill"),
                                  default_config(), mesh)
