"""models/layers.py of the PyTorch port against the reference, function
by function, on the same numpy inputs and the same weights (carried over
with ``from_jax_params``).  f32 tolerances are 1e-5 (single functions
differ by summation order and by the libraries' sin/cos/exp only); bf16
2e-2 (one or two bf16 roundings of O(1) values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core.params import default_config as jdefault
from repro.models import layers as JL
from repro_torch.configs import get_reduced
from repro_torch.core.params import default_config
from repro_torch.models import layers as TL

from _torch_parity import both, j2n, shared_params, t2n

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def cfgs(arch="glm4-9b"):
    return jget_reduced(arch), get_reduced(arch)


@pytest.mark.parametrize("hd,theta", [(32, 10000.0), (64, 500000.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(hd, theta, dtype):
    rng = np.random.RandomState(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 5, (2, 9)).copy()
    jx, tx = both(x, dtype)
    out = TL.rope(tx, torch.from_numpy(pos), theta)
    ref = JL.rope(jx, jnp.asarray(pos), theta)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(t2n(out), j2n(ref),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_exact(seed):
    """int8 values and f32 scales equal the reference's bit for bit:
    both round half to even, clip at +-127 and floor the scale at 1e-6."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32) * (seed + 0.5)
    x[0, 0, 0] = 0.0                       # scale floor
    x[0, 1, 0, :4] = [0.5, 1.5, 2.5, 127]  # ties, and a scale of exactly 1
    jq, js = JL.quantize_kv(jnp.asarray(x), "int8")
    tq, ts = TL.quantize_kv(torch.from_numpy(x), "int8")
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TL.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(JL.dequantize_kv(jq, js, jnp.float32)))
    tb, none = TL.quantize_kv(torch.from_numpy(x), "bfloat16")
    assert none is None and tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t2n(tb), j2n(JL.quantize_kv(jnp.asarray(x), "bfloat16")[0]))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block(impl, dtype):
    jcfg, tcfg = cfgs()                                  # n_rep = 2
    jp, tp = shared_params(JL.init_params(JL.attn_spec(jcfg),
                                          jax.random.PRNGKey(0)))
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jx, tx = both(x, dtype)
    kw = dict(compute_dtype=dtype, attn_impl=impl)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    ref = JL.attention_block(jp, jx, cfg=jcfg, rt=jdefault(**kw), rules=None,
                             positions=jnp.asarray(pos))
    out = TL.attention_block(tp, tx, cfg=tcfg, rt=default_config(**kw),
                             rules=None, positions=torch.from_numpy(pos))
    assert out.dtype == tx.dtype
    # outputs here reach |30| (unit-variance input, four chained
    # products), so the bound is relative to the output's scale
    scale = float(np.abs(j2n(ref)).max())
    np.testing.assert_allclose(t2n(out) / scale, j2n(ref) / scale,
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_decode_attention_block(impl, kv):
    jcfg, tcfg = cfgs()
    jp, tp = shared_params(JL.init_params(JL.attn_spec(jcfg),
                                          jax.random.PRNGKey(1)))
    rng = np.random.RandomState(4)
    B, Smax, pos = 2, 16, 9
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, jcfg.n_kv_heads, jcfg.hd)) \
        .astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    kc[:, pos:] = 0
    vc[:, pos:] = 0
    kw = dict(compute_dtype="float32", kv_cache_dtype=kv, attn_impl=impl)
    jcache, tcache = {}, {}
    for name, arr in (("k", kc), ("v", vc)):
        jq, js = JL.quantize_kv(jnp.asarray(arr), kv)
        tq, ts = TL.quantize_kv(torch.from_numpy(arr), kv)
        jcache[name], tcache[name] = jq, tq
        if js is not None:
            jcache[name + "_scale"], tcache[name + "_scale"] = js, ts
    ref, jnew = JL.decode_attention_block(jp, jnp.asarray(x), jcache, pos,
                                          cfg=jcfg, rt=jdefault(**kw),
                                          rules=None)
    out, tnew = TL.decode_attention_block(tp, torch.from_numpy(x), tcache,
                                          pos, cfg=tcfg,
                                          rt=default_config(**kw), rules=None)
    # f32 cache: summation order only; bf16 / int8 caches store rounded
    # K/V, and a value on a rounding boundary may land one step apart
    t = F32 if kv == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(t2n(out), j2n(ref), **t)
    assert tnew is tcache                   # written in place
    for name in jnew:
        a, b = t2n(tnew[name]), j2n(jnew[name])
        assert a.shape == b.shape
        if kv == "int8" and not name.endswith("_scale"):
            assert np.abs(a - b).max() <= 1
        else:
            np.testing.assert_allclose(a, b, **t)


@pytest.mark.parametrize("act", ["silu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block(act, dtype):
    jcfg, tcfg = cfgs("smollm-135m")
    jcfg, tcfg = jcfg.replace(mlp_act=act), tcfg.replace(mlp_act=act)
    jp, tp = shared_params(JL.init_params(JL.mlp_spec(jcfg),
                                          jax.random.PRNGKey(2)))
    assert set(tp) == set(TL.mlp_spec(tcfg))
    x = np.random.RandomState(5).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    jx, tx = both(x, dtype)
    kw = dict(compute_dtype=dtype)
    ref = JL.mlp_block(jp, jx, cfg=jcfg, rt=jdefault(**kw), rules=None)
    out = TL.mlp_block(tp, tx, cfg=tcfg, rt=default_config(**kw), rules=None)
    np.testing.assert_allclose(t2n(out), j2n(ref),
                               **(F32 if dtype == "float32"
                                  else dict(atol=5e-2, rtol=5e-2)))


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_unembed(tied, dtype):
    jcfg, tcfg = cfgs("smollm-135m")
    jcfg = jcfg.replace(tie_embeddings=tied, vocab=500)    # pads to 512
    tcfg = tcfg.replace(tie_embeddings=tied, vocab=500)
    assert TL.padded_vocab(tcfg) == JL.padded_vocab(jcfg) == 512
    jp, tp = shared_params(JL.init_params(JL.embed_spec(jcfg),
                                          jax.random.PRNGKey(3)))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: s.shape for k, s in TL.embed_spec(tcfg).items()}
    toks = np.random.RandomState(6).randint(0, 500, (2, 7)).astype(np.int32)
    kw = dict(compute_dtype=dtype)
    je = JL.embed(jp, jnp.asarray(toks), jdefault(**kw))
    te = TL.embed(tp, torch.from_numpy(toks), default_config(**kw))
    np.testing.assert_array_equal(t2n(te), j2n(je))
    jl = JL.unembed(jp, je, jcfg, jdefault(**kw), None)
    tl = TL.unembed(tp, te, tcfg, default_config(**kw), None)
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    # f32 accumulation and f32 output on both sides, from the same
    # (possibly bf16-rounded) operands
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


def test_init_params_shapes_and_stats():
    _, tcfg = cfgs("smollm-135m")
    from repro_torch.models import transformer
    spec = transformer.spec(tcfg)
    gen = torch.Generator().manual_seed(0)
    params = TL.init_params(spec, gen)
    shapes = TL.param_shapes(spec)
    flat = lambda t: [t] if not isinstance(t, dict) else \
        [x for v in t.values() for x in flat(v)]
    for p, s in zip(flat(params), flat(shapes)):
        assert tuple(p.shape) == s.shape and p.dtype == s.dtype
    assert torch.all(params["final_norm"] == 1)
    emb = params["embed"]["embedding"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    wq = params["blocks"]["attn"]["wq"]
    assert wq.shape[0] == tcfg.n_layers
    again = TL.init_params(spec, torch.Generator().manual_seed(0))
    assert torch.equal(again["blocks"]["mlp"]["wd"], params["blocks"]["mlp"]["wd"])
