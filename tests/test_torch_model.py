"""The dense serving path of the PyTorch port against the reference, on
the two reduced dense configs (smollm-135m: n_rep 1, hd 32; glm4-9b:
n_rep 2): prefill last-token logits, every cache tensor, four decode
steps — same weights (``from_jax_params``), same numpy prompt.

Tolerances.  f32 compute: 1e-4 on logits and cache, relative to the
tensor's scale — every layer sums in another order than XLA and the
difference grows mildly with depth; greedy tokens must be equal.  int8
cache under f32: stored values may differ by one step where a value sits
on a rounding boundary.  bf16 compute: logits only, 5e-2 in the relative
Frobenius norm ||a-b||/||b|| — the two frameworks round to bf16 at
different places and each layer amplifies that; a single logit of a
single step can be off by more (a near-tie in a softmax), which a
max-norm bound would have to swallow for every element."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core.params import default_config as jdefault
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_reduced
from repro_torch.core.params import default_config
from repro_torch.models.model import build_model

from _torch_parity import fro_close, j2n, rel_close, shared_params, t2n

B, S, MAX_SEQ, STEPS = 2, 12, 24, 4


def run_both(arch, **kw):
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp, tp = shared_params(jm.init(jax.random.PRNGKey(0)))
    jrt, trt = jdefault(**kw), default_config(**kw)
    toks = np.random.RandomState(7).randint(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    jlog, jcache = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jrt,
                                 max_seq=MAX_SEQ)
    with torch.no_grad():
        tlog, tcache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)},
                                     trt, max_seq=MAX_SEQ)
    out = {"prefill": (jlog, tlog),
           "cache0": (jcache, {k: v.clone()
                               for k, v in tcache["layers"].items()},
                      tcache["pos"]),
           "steps": []}
    jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    for _ in range(STEPS):
        # both sides are fed the reference's token, so one flipped
        # argmax in bf16 cannot send the two sequences apart
        jl, jcache = jm.decode_fn(jp, jcache, jtok, jrt)
        with torch.no_grad():
            tl, tcache = tm.decode_fn(tp, tcache,
                                      torch.from_numpy(np.array(jtok)), trt)
        out["steps"].append((jl, tl))
        jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    out["cache"] = (jcache, tcache)
    return out


def check_cache(jlayers, tlayers, kv, tol):
    assert set(jlayers) == set(tlayers)
    for name in jlayers:
        a, b = t2n(tlayers[name]), j2n(jlayers[name])
        assert a.shape == b.shape, name
        if kv == "int8" and not name.endswith("_scale"):
            assert tlayers[name].dtype == torch.int8
            assert np.abs(a - b).max() <= 1, name
            assert (a != b).mean() < 1e-3, name
        else:
            rel_close(tlayers[name], jlayers[name], tol)


@pytest.mark.parametrize("arch", ["smollm-135m", "glm4-9b"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_f32_prefill_cache_decode(arch, impl, kv):
    out = run_both(arch, compute_dtype="float32", kv_cache_dtype=kv,
                   attn_impl=impl)
    jlog, tlog = out["prefill"]
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    rel_close(tlog, jlog, 1e-4)
    jc0, tlayers0, tpos0 = out["cache0"]
    assert tpos0 == int(jc0["pos"]) == S
    # a bf16 cache stores rounded values: one bf16 step on a boundary
    ctol = 1e-4 if kv != "bfloat16" else 1e-2
    check_cache(jc0["layers"], tlayers0, kv, ctol)
    for jl, tl in out["steps"]:
        rel_close(tl, jl, 1e-4 if kv == "float32" else 2e-3)
        if kv == "float32":     # greedy tokens equal
            np.testing.assert_array_equal(
                tl[:, -1].argmax(-1).numpy(),
                np.asarray(jnp.argmax(jl[:, -1], -1)))
    jc, tc = out["cache"]
    assert tc["pos"] == int(jc["pos"]) == S + STEPS
    check_cache(jc["layers"], tc["layers"], kv, ctol)
    np.testing.assert_array_equal(
        tlog[:, -1].argmax(-1).numpy(), np.asarray(jnp.argmax(jlog[:, -1], -1)))


@pytest.mark.parametrize("arch", ["smollm-135m", "glm4-9b"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_bf16_logits(arch, impl, kv):
    out = run_both(arch, compute_dtype="bfloat16", kv_cache_dtype=kv,
                   attn_impl=impl)
    jlog, tlog = out["prefill"]
    assert tlog.dtype == torch.float32
    fro_close(tlog, jlog, 5e-2)
    for jl, tl in out["steps"]:
        fro_close(tl, jl, 5e-2)
    assert set(out["cache"][1]["layers"]) == set(out["cache"][0]["layers"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_save_dtype_narrows_the_carry(impl):
    """remat_save_dtype=bfloat16 under f32 compute rounds the residual to
    bf16 between layers; the result depends on it and both packages
    agree (2e-2: bf16 carry)."""
    kw = dict(compute_dtype="float32", kv_cache_dtype="float32",
              attn_impl=impl, remat_policy="dots")
    wide = run_both("smollm-135m", remat_save_dtype="float32", **kw)
    narrow = run_both("smollm-135m", remat_save_dtype="bfloat16", **kw)
    jlog, tlog = narrow["prefill"]
    rel_close(tlog, jlog, 2e-2)
    assert not np.allclose(t2n(tlog), t2n(wide["prefill"][1]), atol=1e-6)
    from repro.runtime import remat as jremat
    from repro_torch.runtime import remat as tremat
    for pol in ("none", "dots", "full"):
        for save in ("float32", "bfloat16"):
            for comp in ("float32", "bfloat16"):
                k = dict(remat_policy=pol, remat_save_dtype=save,
                         compute_dtype=comp)
                assert str(tremat.carry_dtype(default_config(**k))) == \
                    "torch." + jnp.dtype(jremat.carry_dtype(jdefault(**k))).name


def test_donate_buffers_in_place_or_copy():
    cfg = get_reduced("smollm-135m")
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 6), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    res = {}
    for donate in (True, False):
        rt = default_config(donate_buffers=donate)
        with torch.no_grad():
            logits, cache = m.prefill_fn(p, {"tokens": toks}, rt, max_seq=10)
            before = cache["layers"]["k"].clone()
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            l2, new = m.decode_fn(p, cache, tok, rt)
        same = new["layers"]["k"] is cache["layers"]["k"]
        assert same == donate
        # the given cache is consumed when donated, untouched when not
        assert torch.equal(cache["layers"]["k"], before) == (not donate)
        assert cache["pos"] == 6 and new["pos"] == 7
        res[donate] = (l2, new["layers"]["k"])
    assert torch.equal(res[True][0], res[False][0])
    assert torch.equal(res[True][1], res[False][1])


def test_model_api_and_specs():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import input_specs, synth_inputs
    jcfg, cfg = jget_reduced("glm4-9b"), get_reduced("glm4-9b")
    jm, m = jbuild(jcfg), build_model(cfg)
    jshapes = jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name),
                           jm.param_shapes())
    tshapes = m.param_shapes()
    flat = lambda t: {k: (flat(v) if isinstance(v, dict) else v)
                      for k, v in t.items()}
    def cmp(j, t):
        assert set(j) == set(t)
        for k in j:
            if isinstance(t[k], dict):
                cmp(j[k], t[k])
            else:
                assert j[k] == (t[k].shape, str(t[k].dtype)[6:]), k
    cmp(jshapes, tshapes)
    assert m.logical() == jm.logical()
    rt = default_config(kv_cache_dtype="int8")
    jshp, jlg = jm.cache_shapes(2, 16, jdefault(kv_cache_dtype="int8"))
    tshp, tlg = m.cache_shapes(2, 16, rt)
    assert tlg == jlg
    for k, s in jshp["layers"].items():
        assert tshp["layers"][k].shape == s.shape
        assert str(tshp["layers"][k].dtype)[6:] == jnp.dtype(s.dtype).name
    cache = m.init_cache(2, 16, rt, device="cpu")
    assert cache["pos"] == 0 and cache["layers"]["k"].dtype == torch.int8
    shape = ShapeConfig("t", 8, 3, "prefill")
    gen = torch.Generator().manual_seed(0)
    batch = synth_inputs(cfg, shape, rt, gen)
    assert set(batch) == set(input_specs(cfg, shape, rt)) == {"tokens"}
    assert batch["tokens"].shape == (3, 8)
    assert int(batch["tokens"].max()) < cfg.vocab
    assert set(input_specs(cfg, ShapeConfig("t", 8, 3, "train"), rt)) == \
        {"tokens", "labels"}
    assert input_specs(cfg, ShapeConfig("t", 8, 3, "decode"),
                       rt)["tokens"].shape == (3, 1)
