"""The encdec family (the Seamless-M4T backbone) of the PyTorch port
against the reference, on the CPU, on the reduced seamless-m4t-medium
config (2 encoder and 2 decoder layers, d 128, 4 heads of 32): the spec
tree, ``layernorm``, cross-attention alone, the encoder, prefill and
decode with the self and cross caches (f32, bf16, an int8 self cache),
the loss, its gradients and one AdamW step, the inputs (``frames``), the
scheduler's tokens and zero frames, the prefill's double ``ln1``, and
the step and serve cells.  Same weights (``from_jax_params``), same
numpy inputs; frames standard normal, as ``synth_inputs`` draws them.

Tolerances: single functions at f32's 2e-5 relative to the output's
scale; a whole model's logits and caches at 1e-4 (f32); bf16 logits in
the relative Frobenius norm at 5e-2 (tests/test_torch_model.py's
whole-model bf16 tolerance) or, where the reference's own bf16 logits
lie further than 2.5e-2 from its f32 ones, at twice that distance, as
tests/test_torch_hybrid_bf16.py holds them (here: 7 % at the prefill,
16-27 % at the decode steps, where the port lies 1-8 % from the
reference); gradients, their norm and the optimizer step at 1e-4 or
five times the port's one-rounding-unit floor (``ulp_floor``).  At the
reference's initialisation (the attention projections take their
fan-in from the head axis) the encoder's non-causal softmax is nearly
one-hot: one rounding unit of its input moves its output ~4e-5 of its
scale at 45 frames and its gradients ~5e-3 at 6, the prompts' frames
here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.params import default_config as jdefault
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models import encdec as je
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.models.model import build_model as jbuild
from repro.serving import scheduler as JS
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import campaign, trial
from repro_torch.core import kernel_cell as kc
from repro_torch.core.params import default_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import encdec as te
from repro_torch.models import layers as L
from repro_torch.models import model as tmodel
from repro_torch.models.model import build_model
from repro_torch.runtime.loops import tree_leaves
from repro_torch.serving import evaluator as port_eval
from repro_torch.serving import scheduler as TS, traffic as TT

from _torch_parity import (fro_close, fro_close_floor, j2n, leaf_pairs,
                           port_grads, port_train_step, rel_close,
                           shared_params, step_outputs, train_step_both,
                           ulp_floor)

ARCH = "seamless-m4t-medium"
TOL, MODEL_TOL = 2e-5, {"float32": 1e-4, "bfloat16": 5e-2}
B, S, MAX_SEQ, STEPS = 2, 24, 32, 3       # S // 4 = 6 frames


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp, tp = shared_params(jm.init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jm, tm, jp, tp


def _batch(jcfg, dtype="float32", labels=False, seed=7, zero=False):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, S // jcfg.enc_seq_ratio,
                                  jcfg.d_model)).astype(np.float32)
    npb = {"tokens": toks[:, :-1].copy(),
           "frames": np.zeros_like(frames) if zero else frames}
    if labels:
        npb["labels"] = toks[:, 1:].copy()
    jb = {k: jnp.asarray(v) for k, v in npb.items()}
    tb = {k: torch.from_numpy(v) for k, v in npb.items()}
    jb["frames"] = jb["frames"].astype(jnp.dtype(dtype))
    tb["frames"] = tb["frames"].to(L.torch_dtype(dtype))
    return jb, tb


# ------------------------------------------------------------ spec tree
@pytest.mark.parametrize("full", [False, True])
def test_spec_tree_and_shapes_match_reference(full):
    jcfg = jget_config(ARCH) if full else jget_reduced(ARCH)
    tcfg = get_config(ARCH) if full else get_reduced(ARCH)
    jshapes = jbuild(jcfg).param_shapes()
    tshapes = build_model(tcfg).param_shapes()
    for t, j in leaf_pairs(tshapes, jshapes):
        assert tuple(t.shape) == j.shape
    assert len(tree_leaves(tshapes)) == len(jax.tree.leaves(jshapes))
    assert build_model(tcfg).logical() == jbuild(jcfg).logical()
    if full:   # 12 + 12 layers, d 1024, vocab 256,206 (padded 256,512)
        n = sum(int(np.prod(s.shape)) for s in tree_leaves(tshapes))
        assert 0.87e9 < n < 0.89e9
        assert tuple(tshapes["dec_blocks"]["xattn"]["wk"].shape) == (
            12, 1024, 16, 64)


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """The reference's layernorm, ported for completeness: no model of
    either package calls it (every norm is rmsnorm)."""
    rng = np.random.RandomState(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    sc = rng.standard_normal(64).astype(np.float32)
    bi = rng.standard_normal(64).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = JL.layernorm(jnp.asarray(x).astype(jdt), jnp.asarray(sc),
                        jnp.asarray(bi))
    got = L.layernorm(torch.from_numpy(x).to(L.torch_dtype(dtype)),
                      torch.from_numpy(sc), torch.from_numpy(bi))
    assert got.dtype == L.torch_dtype(dtype)
    rel_close(got, want, TOL if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_cross_attention_matches_reference(setup, impl):
    """attention_block with ``kv_x``: K and V from the encoder output, no
    RoPE, no causal mask (the eager path under either impl)."""
    jcfg, tcfg, _, _, jp, tp = setup
    rng = np.random.RandomState(2)
    x = rng.standard_normal((B, 9, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 5, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (B, 9))
    jx = jax.tree.map(lambda a: a[1], jp["dec_blocks"]["xattn"])
    tx = {k: v[1] for k, v in tp["dec_blocks"]["xattn"].items()}
    want = JL.attention_block(jx, jnp.asarray(x), cfg=jcfg,
                              rt=jdefault(attn_impl=impl), rules=None,
                              positions=jnp.asarray(pos),
                              kv_x=jnp.asarray(enc))
    got = L.attention_block(tx, torch.from_numpy(x), cfg=tcfg,
                            rt=default_config(attn_impl=impl), rules=None,
                            positions=torch.from_numpy(pos.copy()),
                            kv_x=torch.from_numpy(enc))
    rel_close(got, want, TOL)
    # every query sees every key: the last encoder row moves the first
    # query's output
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    moved = L.attention_block(tx, torch.from_numpy(x), cfg=tcfg,
                              rt=default_config(attn_impl=impl), rules=None,
                              positions=torch.from_numpy(pos.copy()),
                              kv_x=torch.from_numpy(enc2))
    assert not torch.allclose(moved[:, 0], got[:, 0])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encode_matches_reference(setup, impl):
    jcfg, tcfg, _, _, jp, tp = setup
    jb, tb = _batch(jcfg)
    want = je.encode(jp, jb["frames"], jcfg, jdefault(attn_impl=impl), None)
    with torch.no_grad():
        got = te.encode(tp, tb["frames"], tcfg,
                        default_config(attn_impl=impl), None)
    rel_close(got, want, MODEL_TOL["float32"])


# ------------------------------------------------------------ serving
def _serve(jm, tm, jp, tp, kw, dtype="float32", zero=False, cast=False):
    jb, tb = _batch(jm.cfg, dtype, zero=zero)
    jrt, trt = jdefault(**kw), default_config(**kw)
    if cast:
        tp = tm.cast_params(tp, trt)
    jlog, jc = jm.prefill_fn(jp, jb, jrt, max_seq=MAX_SEQ)
    with torch.no_grad():
        tlog, tc = tm.prefill_fn(tp, tb, trt, max_seq=MAX_SEQ)
    # decode writes the port's self cache in place (donate_buffers)
    out = {"prefill": (jlog, tlog), "steps": [],
           "cache0": (jc, dict(tc, self={k: v.clone()
                                         for k, v in tc["self"].items()}))}
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    for _ in range(STEPS):
        jl, jc = jm.decode_fn(jp, jc, tok, jrt)
        with torch.no_grad():
            tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(np.array(tok)),
                                  trt)
        out["steps"].append((jl, tl))
        tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    out["cache"] = (jc, tc)
    return out


def _cache_close(tc, jc, tol):
    assert set(tc) == set(jc) and tc["pos"] == int(jc["pos"])
    assert set(tc["self"]) == set(jc["self"])
    for k, j in jc["self"].items():
        assert tc["self"][k].shape[2] == MAX_SEQ
        rel_close(tc["self"][k], j, tol)
    for k in ("cross_k", "cross_v"):
        assert tuple(tc[k].shape) == jc[k].shape == (
            2, B, S // 4, 4, 32)
        rel_close(tc[k], jc[k], tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_f32_prefill_cache_decode(setup, impl):
    _, _, jm, tm, jp, tp = setup
    out = _serve(jm, tm, jp, tp, dict(compute_dtype="float32",
                                      kv_cache_dtype="float32",
                                      attn_impl=impl))
    rel_close(out["prefill"][1], out["prefill"][0], MODEL_TOL["float32"])
    _cache_close(out["cache0"][1], out["cache0"][0], MODEL_TOL["float32"])
    for jl, tl in out["steps"]:
        rel_close(tl, jl, MODEL_TOL["float32"])
    _cache_close(out["cache"][1], out["cache"][0], MODEL_TOL["float32"])
    assert out["cache"][1]["pos"] == S + STEPS


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_bf16_prefill_decode(setup, impl, kv):
    _, _, jm, tm, jp, tp = setup
    kw = dict(compute_dtype="bfloat16", kv_cache_dtype=kv, attn_impl=impl)
    out = _serve(jm, tm, jp, tp, kw, "bfloat16", cast=True)
    # the reference's own f32 logits on the same prompt and tokens
    jb, _ = _batch(jm.cfg)
    rt32 = jdefault(compute_dtype="float32", kv_cache_dtype="float32",
                    attn_impl=impl)
    jlog, jc = jm.prefill_fn(jp, jb, rt32, max_seq=MAX_SEQ)
    ref32 = [jlog]
    tok = jnp.argmax(out["prefill"][0][:, -1], -1)[:, None].astype(jnp.int32)
    for jl, _ in out["steps"]:
        l32, jc = jm.decode_fn(jp, jc, tok, rt32)
        ref32.append(l32)
        tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    for (jl, tl), j32 in zip([out["prefill"]] + out["steps"], ref32):
        drift = float(np.linalg.norm(j2n(jl) - j2n(j32))
                      / np.linalg.norm(j2n(j32)))
        fro_close(tl, jl, max(MODEL_TOL["bfloat16"], 2 * drift))
    tc = out["cache"][1]
    assert tc["self"]["k"].dtype == L.torch_dtype(kv)
    assert tc["cross_k"].dtype == torch.bfloat16
    assert ("k_scale" in tc["self"]) == (kv == "int8")


def test_cache_shapes_init_and_donation(setup):
    """cache_shapes and init_cache are the reference's; donate_buffers
    False leaves the self cache as it was and never writes the cross
    cache, True writes the self cache in place."""
    jcfg, tcfg, jm, tm, jp, tp = setup
    for kv in ("float32", "int8"):
        jshp, jlg = je.cache_shapes(jcfg, B, MAX_SEQ,
                                    jdefault(kv_cache_dtype=kv))
        tshp, tlg = te.cache_shapes(tcfg, B, MAX_SEQ,
                                    default_config(kv_cache_dtype=kv))
        assert tlg == jlg
        for t, j in leaf_pairs(tshp, jshp):
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).replace("torch.", "") == \
                jnp.dtype(j.dtype).name
    rt = default_config(compute_dtype="float32", kv_cache_dtype="float32")
    _, tb = _batch(jcfg)
    with torch.no_grad():
        _, cache = tm.prefill_fn(tp, tb, rt, max_seq=MAX_SEQ)
        before = {k: v.clone() for k, v in cache["self"].items()}
        tok = torch.full((B, 1), 3, dtype=torch.int32)
        l1, c1 = tm.decode_fn(tp, cache, tok,
                              rt.replace(donate_buffers=False))
        for k, v in cache["self"].items():
            assert torch.equal(v, before[k])
        assert c1["cross_k"] is cache["cross_k"]
        l2, c2 = tm.decode_fn(tp, cache, tok, rt.replace(donate_buffers=True))
    assert torch.equal(l1, l2)
    assert c2["self"]["k"] is cache["self"]["k"]
    assert not torch.equal(cache["self"]["k"], before["k"])
    zero = tm.init_cache(B, MAX_SEQ, rt, device="cpu")
    assert zero["pos"] == 0 and not any(bool(t.any())
                                        for t in tree_leaves(zero["self"]))
    assert tuple(zero["cross_k"].shape) == (2, B, MAX_SEQ // 4, 4, 32)


# ------------------------------------------------------------ inputs
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_specs_and_synth_inputs_have_frames(kind, dtype):
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    want = jmodel.input_specs(jcfg, JShape("t", 48, 2, kind),
                              jdefault(compute_dtype=dtype))
    got = tmodel.input_specs(tcfg, ShapeConfig("t", 48, 2, kind),
                             default_config(compute_dtype=dtype))
    assert {k: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for k, s in got.items()} == \
        {k: (s.shape, jnp.dtype(s.dtype).name) for k, s in want.items()}
    batch = tmodel.synth_inputs(tcfg, ShapeConfig("t", 48, 2, kind),
                                default_config(compute_dtype=dtype),
                                torch.Generator().manual_seed(0))
    for name, s in got.items():
        assert tuple(batch[name].shape) == s.shape
        assert batch[name].dtype == s.dtype
    if kind != "decode":
        assert tuple(batch["frames"].shape) == (2, 12, 128)
        assert 0.5 < float(batch["frames"].float().std()) < 1.5


def test_pipeline_frames_are_the_reference():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    want = JSyntheticLM(jcfg, JShape("t", 32, 2, "train"), jdefault(),
                        make_host_mesh(), seed=1).batch_at(3)
    got = SyntheticLM(tcfg, ShapeConfig("t", 32, 2, "train"),
                      default_config(), "cpu", seed=1).batch_at(3)
    assert set(got) == set(want) == {"tokens", "labels", "frames"}
    for k in got:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())


# ------------------------------------------------------------ training
def test_loss_grads_and_train_step_match_reference(setup):
    jcfg, tcfg, jm, tm, jp, tp = setup
    jb, tb = _batch(jcfg, labels=True)
    kw = dict(compute_dtype="float32", remat_policy="dots")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, jdefault(**kw))[0]))(jp)
    tl, _ = tm.loss_fn(tp, tb, default_config(**kw))
    rel_close(tl.detach(), jl, TOL)
    grads = port_grads(tm, tb, default_config(**kw))
    floor = ulp_floor(grads, tp)
    for g, (_, j), f in zip(grads(tp), leaf_pairs(tp, jg), floor):
        fro_close_floor(g, j, MODEL_TOL["float32"], f)
    (jn, jo, jmet), (tn, to, tmet) = train_step_both(
        jcfg, tcfg, jp, tp, jb, tb, **kw)
    rel_close(tmet["loss"], jmet["loss"], TOL)
    norm = lambda p: [torch.sqrt(sum(torch.sum(g * g) for g in grads(p)))]
    fro_close_floor(tmet["grad_norm"], jmet["grad_norm"],
                    MODEL_TOL["float32"], ulp_floor(norm, tp)[0])
    step = port_train_step(tcfg, B, S, **kw)
    floor = ulp_floor(lambda p: step_outputs(p, *step(p, tb)[:2]), tp)
    want = step_outputs(from_jax_params(jax.tree.map(np.asarray, jp)),
                        from_jax_params(jn), from_jax_params(jo))
    for t, j, f in zip(step_outputs(tp, tn, to), want, floor):
        fro_close_floor(t, j, MODEL_TOL["float32"], f)


# ------------------------------------------ behaviours held as they are
def test_zero_frames_make_cross_attention_add_zero(setup):
    """The scheduler feeds the reference's zero frames: the encoder's
    output is exactly 0 in both packages, so are the cross K/V, and the
    cross-attention weights do not move the logits."""
    jcfg, tcfg, jm, tm, jp, tp = setup
    jb, tb = _batch(jcfg, zero=True)
    rt, jrt = default_config(), jdefault()
    assert not bool(jnp.any(je.encode(jp, jb["frames"], jcfg, jrt, None)))
    with torch.no_grad():
        assert not bool(te.encode(tp, tb["frames"], tcfg, rt, None).any())
        log, cache = tm.prefill_fn(tp, tb, rt, max_seq=MAX_SEQ)
        other = dict(tp, dec_blocks=dict(tp["dec_blocks"], xattn={
            k: v * 3.0 + 1.0 for k, v in tp["dec_blocks"]["xattn"].items()}))
        log2, _ = tm.prefill_fn(other, tb, rt, max_seq=MAX_SEQ)
    assert not bool(cache["cross_k"].any()) and not bool(
        cache["cross_v"].any())
    assert torch.equal(log, log2)
    jlog, jc = jm.prefill_fn(jp, jb, jrt, max_seq=MAX_SEQ)
    assert not bool(jnp.any(jc["cross_k"]))
    rel_close(log, jlog, MODEL_TOL["float32"])


def test_prefill_norms_ln1_twice_a_block(setup, monkeypatch):
    """As the reference's prefill (and ``transformer.prefill_fn``): each
    decoder block norms ``ln1`` once for the cached K/V and once inside
    the block, so a prefill norms 4 L + 2 E + 2 times (ln1 twice, lnx,
    ln2; the encoder's ln1, ln2; the two final norms), a decode step
    3 L + 1 times: chip_smoke.launches_per_unit counts the kernels so."""
    _, tcfg, _, tm, _, tp = setup
    calls = []
    real = L.rmsnorm
    monkeypatch.setattr(L, "rmsnorm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tb = _batch(tm.cfg)
    rt = default_config(attn_impl="pallas")
    with torch.no_grad():
        log, cache = tm.prefill_fn(tp, tb, rt, max_seq=MAX_SEQ)
        n_prefill = len(calls)
        tm.decode_fn(tp, cache, torch.argmax(log[:, -1], -1)[:, None], rt)
    Ld, E = tcfg.n_layers, tcfg.enc_layers
    assert n_prefill == 4 * Ld + 2 * E + 2
    assert len(calls) - n_prefill == 3 * Ld + 1


def test_scheduler_tokens_match_reference(setup):
    """poisson_tiny through both BatchSchedulers in f32 (zero frames, as
    the reference's scheduler builds them): the same greedy tokens."""
    jcfg, tcfg, _, _, jp, tp = setup
    kw = dict(wave_size=3, max_seq=32)
    js = JS.BatchScheduler(jcfg, jdefault(attn_impl="pallas"), jp, **kw)
    ts = TS.BatchScheduler(tcfg, default_config(attn_impl="pallas"), tp,
                           device="cpu", **kw)
    trace = TT.get_trace("poisson_tiny")
    for mod, sched in ((JS, js), (TS, ts)):
        for r in trace.requests:
            sched.submit(mod.Request(rid=r.rid, tokens=TT.request_tokens(r),
                                     max_new_tokens=r.max_new_tokens,
                                     t_submit=0.0))
    jdone, tdone = js.run_until_drained(), ts.run_until_drained()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(tdone, jdone):
        assert a.generated == b.generated
    assert (ts.metrics.decode_tokens, ts.metrics.prefill_tokens) == \
        (js.metrics.decode_tokens, js.metrics.prefill_tokens)


# ------------------------------------------------------------ cells
def test_prefill_step_cell_runs_a_measured_trial(monkeypatch, tmp_path):
    """A seamless-m4t-medium prefill step cell runs a measured trial
    through the campaign's dispatch evaluator: the reduced config at a
    CPU-sized stand-in of the card's prefill shape."""
    monkeypatch.setattr(trial, "get_config", get_reduced)
    monkeypatch.setattr(trial, "get_shape", lambda s: ShapeConfig(
        "prefill_card", 64, 2, "prefill"))
    monkeypatch.setattr(kc, "STEP_MIN_SAMPLE_S", 0.0)
    (spec,) = campaign.parse_cells(f"{ARCH}:prefill_card")
    res = kc.DispatchEvaluator(device="cpu", cache_dir=tmp_path)(
        spec.workload(), default_config(attn_impl="pallas"))
    assert not res.crashed, res.error
    assert 0 < res.cost_s < float("inf")


def test_serve_cell_replays_the_reduced_config():
    wl = port_eval.serve_cell(ARCH, "bursty_tiny").workload()
    assert wl.cfg == get_reduced(ARCH)
    stats = port_eval.ServeEvaluator(device="cpu").replay(
        wl, default_config(attn_impl="pallas", kv_cache_dtype="int8"))
    assert stats["served"] == len(TT.get_trace("bursty_tiny").requests)
    assert 0 < stats["wall_s"] < float("inf")
