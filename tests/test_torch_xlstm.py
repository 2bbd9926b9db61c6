"""The ssm family (xLSTM) of the PyTorch port against the reference, on
the CPU, on the reduced xlstm-1.3b config (2 groups of one mLSTM and one
sLSTM block, d 128, 4 heads of 32, chunk 32): the spec tree, the
chunkwise mLSTM (ragged S, a carried state), its gradient past f32's exp
range, the sLSTM step and block, both blocks in decode, prefill and
decode of the whole model with its state, the serving cast of the
sLSTM's recurrent weights, the loss, its gradients and one AdamW step,
the scheduler's tokens and the step and serve cells.  Same weights
(``from_jax_params``), same numpy inputs.

Tolerances: the blocks and the chunked form at f32's 2e-5 relative to
the output's scale; a whole model's logits and states at 1e-4 (f32);
bf16 logits in the relative Frobenius norm at 2e-2 for the prefill and
for a decode step from the reference's own state, and at 5e-2 (the bf16
whole-model tolerance of tests/test_torch_model.py) for decode steps
from the port's own state: the sLSTM's recurrence carries the two
frameworks' bf16 rounding of the prompt into the state (1-2 % apart
after 45 tokens) and the decode logits then lie 2-3.3 % apart, where
the reference's own bf16 logits lie 1-4.8 % from its f32 ones;
gradients and the optimizer step at 1e-4 or five times the port's
one-rounding-unit floor (``ulp_floor``), as tests/test_torch_vlm.py
holds them."""
TOL, MODEL_TOL = 2e-5, {"float32": 1e-4, "bfloat16": 2e-2}
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core.params import default_config as jdefault
from repro.models import xlstm as jx
from repro.models.model import build_model as jbuild
from repro.serving import scheduler as JS
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import campaign, trial
from repro_torch.core import kernel_cell as kc
from repro_torch.core.params import default_config
from repro_torch.models import xlstm as tx
from repro_torch.models.model import build_model, input_specs
from repro_torch.runtime.loops import tree_leaves
from repro_torch.serving import evaluator as port_eval
from repro_torch.serving import scheduler as TS, traffic as TT

from _torch_parity import (fro_close, fro_close_floor, j2n, leaf_pairs,
                           port_grads, port_train_step, rel_close,
                           step_outputs, t2n, train_step_both, ulp_floor)

ARCH = "xlstm-1.3b"
TOL, MODEL_TOL = 2e-5, {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_BF16 = 5e-2
B, S, STEPS = 2, 45, 3          # S: a ragged last chunk of the 32


def vary_recurrent(tree, rng):
    """Random, non-zero sLSTM recurrent weights ri, rf, rz, ro (the
    reference initialises them to 0, which hides a cast of them)."""
    if isinstance(tree, dict):
        return {k: vary_recurrent(v, rng) if isinstance(v, dict) else
                ((rng.standard_normal(np.shape(v)) * 0.5).astype(
                    np.asarray(v).dtype) if k in ("ri", "rf", "rz", "ro")
                 else np.asarray(v)) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    host = vary_recurrent(jax.tree.map(np.asarray,
                                       jm.init(jax.random.PRNGKey(0))),
                          np.random.RandomState(5))
    jp, tp = jax.tree.map(jnp.asarray, host), from_jax_params(host)
    return jcfg, tcfg, jm, tm, jp, tp


def _batch(jcfg, seq=S, labels=False, seed=7):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, jcfg.vocab, (B, seq + 1)).astype(np.int32)
    npb = {"tokens": toks[:, :-1].copy()}
    if labels:
        npb["labels"] = toks[:, 1:].copy()
    return ({k: jnp.asarray(v) for k, v in npb.items()},
            {k: torch.from_numpy(v) for k, v in npb.items()})


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mlstm_inputs(seed, Bn, Sn, H, hd, lf_shift=0.0):
    rng = np.random.RandomState(seed)
    q, k, v = (_normal(rng, Bn, Sn, H, hd) for _ in range(3))
    ig = 1 / (1 + np.exp(-_normal(rng, Bn, Sn, H)))
    z = _normal(rng, Bn, Sn, H) + lf_shift
    lf = -np.logaddexp(0, -z)                      # log_sigmoid(z)
    return [x.astype(np.float32) for x in (q, k, v, ig, lf)]


def _tt(arrs):
    return [torch.from_numpy(a) for a in arrs]


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
    if full:   # 48 blocks (6 groups of 7 mLSTM + 1 sLSTM), d 2048
        n = sum(int(np.prod(s.shape)) for s in tree_leaves(tshapes))
        assert 1.2e9 < n < 1.22e9
        assert tuple(tshapes["mblocks"]["wq"].shape) == (6, 7, 2048, 4, 512)


# ------------------------------------------------------------ mLSTM
@pytest.mark.parametrize("Sn", [32, 45, 100])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunked_matches_reference(Sn, carried):
    """A whole chunk, a ragged last chunk (no-op padding) and several
    chunks, from a zero or a carried state."""
    H, hd, chunk = 2, 8, 16
    arrs = _mlstm_inputs(1, 2, Sn, H, hd)
    rng = np.random.RandomState(2)
    state = (_normal(rng, 2, H, hd, hd), _normal(rng, 2, H, hd)) \
        if carried else None
    jy, (jh, jn) = jx._mlstm_chunked(
        *map(jnp.asarray, arrs), chunk,
        None if state is None else tuple(map(jnp.asarray, state)))
    ty, (th, tn) = tx._mlstm_chunked(
        *_tt(arrs), chunk, None if state is None else tuple(_tt(state)))
    assert tuple(ty.shape) == jy.shape == (2, Sn, H, hd)
    rel_close(ty, jy, TOL)
    rel_close(th, jh, TOL)
    rel_close(tn, jn, TOL)


def test_mlstm_gradient_is_finite_past_the_exp_range():
    """Once a chunk's log forget gates sum below -88 (about -200 at
    xlstm-1.3b's own chunk of 256 and unit-scale gates), the reference's
    exp(cum_i - cum_j) overflows above the diagonal and is masked after:
    its gradient is NaN.  The port masks before the exp: its gradient is
    finite and its forward the reference's, at the chunk of 256 and at a
    chunk of 32 whose gates are forced negative; where no chunk
    overflows its gradient is the reference's."""
    H, hd = 2, 8

    def jgrad(arrs, R, chunk):
        def f(*ins):
            y, (h, n) = jx._mlstm_chunked(*ins, chunk)
            return jnp.sum(y * R) + jnp.sum(h) + jnp.sum(n)
        return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
            *map(jnp.asarray, arrs))

    def tgrad(arrs, R, chunk):
        ins = [t.requires_grad_() for t in _tt(arrs)]
        y, (h, n) = tx._mlstm_chunked(*ins, chunk)
        (torch.sum(y * torch.from_numpy(R)) + torch.sum(h)
         + torch.sum(n)).backward()
        return y.detach(), [t.grad for t in ins]

    for Sn, chunk, shift in ((256, 256, 0.0), (64, 32, -3.0)):
        arrs = _mlstm_inputs(3, 1, Sn, H, hd, lf_shift=shift)
        R = _normal(np.random.RandomState(4), 1, Sn, H, hd)
        sums = arrs[4].reshape(1, Sn // chunk, chunk, H).sum(axis=2)
        assert float(sums.max()) < -88              # exp(88) ~ f32 max
        assert any(bool(jnp.isnan(g).any()) for g in jgrad(arrs, R, chunk))
        ty, tg = tgrad(arrs, R, chunk)
        assert all(bool(torch.isfinite(g).all()) for g in tg)
        jy, _ = jx._mlstm_chunked(*map(jnp.asarray, arrs), chunk)
        rel_close(ty, jy, TOL)
    arrs = _mlstm_inputs(3, 1, 64, H, hd)
    R = _normal(np.random.RandomState(4), 1, 64, H, hd)
    assert float(arrs[4].reshape(1, 2, 32, H).sum(axis=2).min()) > -88
    _, tg = tgrad(arrs, R, 32)
    for t, j in zip(tg, jgrad(arrs, R, 32)):
        assert bool(jnp.isfinite(j).all())
        rel_close(t, j, MODEL_TOL["float32"])


def _block(tree, name, g=0, i=0):
    """Group g's block i (mblocks) or group g's sLSTM block."""
    if name == "mblocks":
        return {k: v[g, i] for k, v in tree["mblocks"].items()}
    return {k: v[g] for k, v in tree["sblocks"].items()}


@pytest.mark.parametrize("kind", ["mblocks", "sblocks"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_block_prefill_and_decode_match_reference(setup, kind, impl):
    """One block over a prompt (with its state), then three decode steps
    from that state, in f32."""
    jcfg, tcfg, _, _, jp, tp = setup
    jfn = jx.mlstm_block if kind == "mblocks" else jx.slstm_block
    tfn = tx.mlstm_block if kind == "mblocks" else tx.slstm_block
    jb, tb = _block(jax.tree.map(lambda a: a, jp), kind), _block(tp, kind)
    rng = np.random.RandomState(8)
    x = _normal(rng, B, S, jcfg.d_model)
    jrt, trt = jdefault(attn_impl=impl), default_config(attn_impl=impl)
    jo, jst = jfn(jb, jnp.asarray(x), jcfg, jrt, None, want_state=True)
    with torch.no_grad():
        to, tst = tfn(tb, torch.from_numpy(x), tcfg, trt, None,
                      want_state=True)
    rel_close(to, jo, TOL)
    for t, j in zip(tst, jst):
        rel_close(t, j, TOL)
    for step in range(STEPS):
        xd = _normal(rng, B, 1, jcfg.d_model)
        jo, jst = jfn(jb, jnp.asarray(xd), jcfg, jrt, None, state=jst,
                      decode=True)
        with torch.no_grad():
            to, tst = tfn(tb, torch.from_numpy(xd), tcfg, trt, None,
                          state=tst, decode=True)
        rel_close(to, jo, TOL)
        for t, j in zip(tst, jst):
            rel_close(t, j, TOL)


def test_slstm_step_matches_reference(setup):
    jcfg, _, _, _, jp, tp = setup
    d = jcfg.d_model
    rng = np.random.RandomState(9)
    pj = {k: jp["sblocks"][k][1] for k in ("ri", "rf", "rz", "ro")}
    pt = {k: tp["sblocks"][k][1] for k in ("ri", "rf", "rz", "ro")}
    carry = [_normal(rng, B, d) for _ in range(4)]
    carry[1] = np.abs(carry[1]) + 0.5               # n > 0
    zs = [_normal(rng, B, d) for _ in range(4)]
    jout = jx._slstm_step(pj, tuple(map(jnp.asarray, carry)),
                          *map(jnp.asarray, zs))
    tout = tx._slstm_step(pt, tuple(_tt(carry)), *_tt(zs))
    for t, j in zip(tout, jout):
        rel_close(t, j, TOL)
    # the first step, from the -1e30 stabiliser of a fresh state
    z = tx.init_slstm_state(B, d, "cpu")
    jz = (jnp.zeros((B, d)),) * 2 + (jnp.full((B, d), -1e30),
                                     jnp.zeros((B, d)))
    for t, j in zip(tx._slstm_step(pt, z, *_tt(zs)),
                    jx._slstm_step(pj, jz, *map(jnp.asarray, zs))):
        rel_close(t, j, TOL)


# ------------------------------------------------------------ the model
def _serve(jm, tm, jp, tp, kw, steps=STEPS, cast=False):
    jb, tb = _batch(jm.cfg)
    jrt, trt = jdefault(**kw), default_config(**kw)
    if cast:
        tp = tm.cast_params(tp, trt)
    jlog, jc = jm.prefill_fn(jp, jb, jrt)
    with torch.no_grad():
        tlog, tc = tm.prefill_fn(tp, tb, trt)
    # decode updates the port's state in place (donate_buffers): copy it
    out = {"prefill": (jlog, tlog), "steps": [],
           "cache0": (jc, dict(tc, m_h=tc["m_h"].clone(),
                               m_n=tc["m_n"].clone(),
                               s=tuple(t.clone() for t in tc["s"])))}
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    for _ in range(steps):
        jl, jc = jm.decode_fn(jp, jc, tok, jrt)
        with torch.no_grad():
            tl, tc = tm.decode_fn(tp, tc, torch.from_numpy(np.array(tok)),
                                  trt)
        out["steps"].append((jl, tl))
        tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    out["cache"] = (jc, tc)
    return out


def _state_close(tc, jc, tol):
    assert tc["pos"] == int(jc["pos"])
    rel_close(tc["m_h"], jc["m_h"], tol)
    rel_close(tc["m_n"], jc["m_n"], tol)
    assert isinstance(tc["s"], tuple) and len(tc["s"]) == 4
    for t, j in zip(tc["s"], jc["s"]):
        rel_close(t, j, tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_f32_prefill_state_decode(setup, impl):
    _, _, jm, tm, jp, tp = setup
    out = _serve(jm, tm, jp, tp, dict(compute_dtype="float32",
                                      attn_impl=impl))
    rel_close(out["prefill"][1], out["prefill"][0], MODEL_TOL["float32"])
    _state_close(out["cache0"][1], out["cache0"][0], MODEL_TOL["float32"])
    for jl, tl in out["steps"]:
        rel_close(tl, jl, MODEL_TOL["float32"])
    _state_close(out["cache"][1], out["cache"][0], MODEL_TOL["float32"])
    assert out["cache"][1]["pos"] == S + STEPS


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_prefill_decode_keeps_recurrent_weights_f32(setup, impl):
    """bf16 serving through ``cast_params``, as the entry points serve:
    the sLSTM's recurrent weights stay f32 (the reference reads them in
    f32 from its master weights), and the logits agree at 2e-2."""
    _, _, jm, tm, jp, tp = setup
    kw = dict(compute_dtype="bfloat16", attn_impl=impl)
    cast = tm.cast_params(tp, default_config(**kw))
    for name in ("ri", "rf", "rz", "ro"):
        assert cast["sblocks"][name].dtype == torch.float32
        assert torch.equal(cast["sblocks"][name], tp["sblocks"][name])
        assert bool((cast["sblocks"][name] != 0).any())
    assert cast["sblocks"]["wi"].dtype == torch.bfloat16
    out = _serve(jm, tm, jp, tp, kw, cast=True)
    fro_close(out["prefill"][1], out["prefill"][0], MODEL_TOL["bfloat16"])
    for jl, tl in out["steps"]:
        fro_close(tl, jl, DECODE_BF16)
    # one decode step from the reference's own state
    jlog, jc = out["prefill"][0], out["cache0"][0]
    tc = from_jax_params(jax.tree.map(np.asarray, jc))
    tc["pos"] = int(tc["pos"])
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    jl, _ = jm.decode_fn(jp, jc, tok, jdefault(**kw))
    with torch.no_grad():
        tl, _ = tm.decode_fn(cast, tc, torch.from_numpy(np.array(tok)),
                             default_config(**kw))
    fro_close(tl, jl, MODEL_TOL["bfloat16"])


def test_init_cache_and_decode_donation(setup):
    """init_cache is the reference's (the sLSTM m-state at -1e30); a
    decode step from it agrees with the reference's; donate_buffers=False
    leaves the given state as it was, True updates it in place."""
    jcfg, tcfg, jm, tm, jp, tp = setup
    rt = default_config(compute_dtype="float32")
    jc = jm.init_cache(B, 64, jdefault(compute_dtype="float32"))
    tc = tm.init_cache(B, 64, rt, device="cpu")
    assert tc["pos"] == 0 and set(tc) == set(jc)
    state = lambda c: {k: c[k] for k in ("m_h", "m_n", "s")}
    for t, j in zip(tree_leaves(state(tc)), jax.tree.leaves(state(jc))):
        np.testing.assert_array_equal(t2n(t), j2n(j))
    tok = np.full((B, 1), 3, np.int32)
    jl, jc2 = jm.decode_fn(jp, jc, jnp.asarray(tok),
                           jdefault(compute_dtype="float32"))
    before = [t.clone() for t in tree_leaves(state(tc))]
    with torch.no_grad():
        tl, tc2 = tm.decode_fn(tp, tc, torch.from_numpy(tok),
                               rt.replace(donate_buffers=False))
        for a, b in zip(before, tree_leaves(state(tc))):
            assert torch.equal(a, b)
        tl3, tc3 = tm.decode_fn(tp, tc, torch.from_numpy(tok),
                                rt.replace(donate_buffers=True))
    rel_close(tl, jl, MODEL_TOL["float32"])
    assert torch.equal(tl, tl3)
    assert tc3["m_h"] is tc["m_h"] and tc3["s"][2] is tc["s"][2]
    _state_close(tc3, jc2, MODEL_TOL["float32"])


def test_reference_state_carries_into_the_port(setup):
    """A reference prefill's state (nested tuples) carried across with
    ``from_jax_params`` decodes in the port as in the reference."""
    _, _, jm, tm, jp, tp = setup
    jb, _ = _batch(jm.cfg)
    jrt = jdefault(compute_dtype="float32")
    jlog, jc = jm.prefill_fn(jp, jb, jrt)
    tc = from_jax_params(jax.tree.map(np.asarray, jc))
    assert isinstance(tc["s"], tuple)
    tc["pos"] = int(tc["pos"])
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    jl, _ = jm.decode_fn(jp, jc, tok, jrt)
    with torch.no_grad():
        tl, _ = tm.decode_fn(tp, tc, torch.from_numpy(np.array(tok)),
                             default_config(compute_dtype="float32"))
    rel_close(tl, jl, MODEL_TOL["float32"])


# ------------------------------------------------------------ training
def test_loss_grads_and_train_step_match_reference(setup):
    jcfg, tcfg, jm, tm, jp, tp = setup
    jb, tb = _batch(jcfg, seq=40, labels=True)
    kw = dict(compute_dtype="float32", remat_policy="dots")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, jdefault(**kw))[0]))(jp)
    tl, _ = tm.loss_fn(tp, tb, default_config(**kw))
    rel_close(tl.detach(), jl, TOL)
    grads = port_grads(tm, tb, default_config(**kw))
    floor = ulp_floor(grads, tp)
    for g, (_, j), f in zip(grads(tp), leaf_pairs(tp, jg), floor):
        assert bool(torch.isfinite(g).all())
        fro_close_floor(g, j, MODEL_TOL["float32"], f)
    (jn, jo, jmet), (tn, to, tmet) = train_step_both(
        jcfg, tcfg, jp, tp, jb, tb, **kw)
    rel_close(tmet["loss"], jmet["loss"], TOL)
    rel_close(tmet["grad_norm"], jmet["grad_norm"], MODEL_TOL["float32"])
    step = port_train_step(tcfg, B, 40, **kw)
    floor = ulp_floor(lambda p: step_outputs(p, *step(p, tb)[:2]), tp)
    want = step_outputs(from_jax_params(jax.tree.map(np.asarray, jp)),
                        from_jax_params(jn), from_jax_params(jo))
    for t, j, f in zip(step_outputs(tp, tn, to), want, floor):
        fro_close_floor(t, j, MODEL_TOL["float32"], f)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_are_tokens_only(kind):
    rt = default_config()
    got = input_specs(get_reduced(ARCH), ShapeConfig("t", 48, 2, kind), rt)
    assert set(got) == ({"tokens", "labels"} if kind == "train"
                        else {"tokens"})


# ------------------------------------------------------------ serving
def test_scheduler_tokens_match_reference(setup):
    """poisson_tiny through both BatchSchedulers in f32: the same greedy
    tokens and counters."""
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


SMALL_LONG = ShapeConfig("long_500k", 64, 1, "decode")


def test_long_500k_step_cell_runs_a_measured_trial(monkeypatch, tmp_path):
    """``xlstm-1.3b:long_500k`` (decode, one stream) runs a measured
    trial through the campaign's dispatch evaluator: the reduced config
    at a CPU-sized stand-in of the shape."""
    monkeypatch.setattr(trial, "get_config", get_reduced)
    monkeypatch.setattr(trial, "get_shape", lambda s: SMALL_LONG)
    monkeypatch.setattr(kc, "STEP_MIN_SAMPLE_S", 0.0)
    (spec,) = campaign.parse_cells("xlstm-1.3b:long_500k")
    disp = kc.DispatchEvaluator(device="cpu", cache_dir=tmp_path)
    res = disp(spec.workload(), default_config())
    assert not res.crashed, res.error
    assert 0 < res.cost_s < float("inf")


def test_serve_cell_replays_the_reduced_config():
    """serve:xlstm-1.3b:poisson_tiny replays the reduced config, as the
    reference's serve cell means it."""
    from repro.serving import evaluator as ref_eval
    wl = port_eval.serve_cell(ARCH, "poisson_tiny").workload()
    assert wl.cfg == get_reduced(ARCH)
    assert wl.cfg.d_model == ref_eval.serve_cell(
        ARCH, "poisson_tiny").workload().cfg.d_model
    stats = port_eval.ServeEvaluator(device="cpu").replay(
        wl, default_config(attn_impl="pallas"))
    assert stats["served"] == len(TT.get_trace("poisson_tiny").requests)
    assert 0 < stats["wall_s"] < float("inf")
