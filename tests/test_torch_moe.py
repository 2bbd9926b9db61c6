"""The MoE family of the PyTorch port against the reference, on the CPU,
on the reduced olmoe-1b-7b and kimi-k2-1t-a32b configs (8 experts, top
2; kimi's master weights bf16): the router (gate values, indices, aux),
its ties, the MoE FFN in f32 and bf16, the prefill / decode path and its
cache, the loss with its ``xent`` and ``aux``, the gradients and one
AdamW step.  Same weights (``from_jax_params``), same numpy inputs.

Tolerances.  The router and the MoE FFN alone: f32 2e-5 and bf16 2e-2,
as tests/test_kernels.py uses, relative to the tensor's scale.  A whole
model (logits, cache, gradients, one step) is held as
tests/test_torch_model.py and tests/test_torch_train.py hold the dense
family: f32 1e-4, as every layer sums in another order than XLA (the
reference's own dense gradients lie 2.6e-5 from the port's on reduced
smollm-135m; kimi's third decode step 4.7e-5), and bf16 logits 5e-2 in
the relative Frobenius norm, as the two frameworks round to bf16 at
different places (reduced glm4-9b, dense: 3.8e-2 at one decode step);
a gradient, an update or a moment at 1e-4 or at five times the port's
own floor under one rounding unit of the parameters, where that lies
above (``_torch_parity.ulp_floor``).  A routing comparison has a near-tie margin:
where the reference's k-th and (k+1)-th gates lie closer than
``MARGIN`` times the k-th gate, the two frameworks may pick differently
(their router products round differently, by one unit of f32 or of
bf16: 2^-8 of a logit, which moves a gate by that fraction of the logit,
and these logits lie well within 1), and such tokens are left out of the comparison of indices and
outputs; a tie that is exact is no near-tie and must pick the lower
index, as ``jax.lax.top_k`` does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core.params import default_config as jdefault
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.core.params import default_config
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.runtime.loops import tree_map
from repro_torch.runtime.stepfn import MOE_ONE_DEVICE_NO_OPS, build_step

from _torch_parity import (both, fro_close, fro_close_floor, j2n,
                           leaf_pairs, port_grads, port_train_step,
                           rel_close, serve_both, shared_params,
                           step_outputs, t2n, train_step_both, ulp_floor)

ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MARGIN = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
B, S, MAX_SEQ, STEPS = 2, 12, 20, 3


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = jget_reduced(request.param), get_reduced(request.param)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp, tp = shared_params(jm.init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jm, tm, jp, tp


def _layer0(tree):
    return tree_map(lambda t: t[0], tree)


def _near_ties(jgates, k, margin):
    """Rows whose k-th and (k+1)-th reference gates lie within ``margin``
    of the k-th (relative), and are not exactly equal."""
    g = -np.sort(-j2n(jgates), axis=-1)
    gap = g[:, k - 1] - g[:, k]
    return (gap < margin * g[:, k - 1]) & (gap > 0)


def _ref_gates(xt, router, dtype):
    return jax.nn.softmax((xt @ router.astype(xt.dtype)).astype(jnp.float32),
                          axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(setup, dtype):
    jcfg, tcfg, _, _, jp, tp = setup
    jr, tr = _layer0(jp["blocks"])["moe"]["router"], \
        _layer0(tp["blocks"])["moe"]["router"]
    jx, tx = both(np.random.RandomState(1).standard_normal(
        (96, jcfg.d_model)), dtype)
    jgv, jgi, jaux = jmoe._route(jx, jr.astype(jx.dtype), jcfg)
    tgv, tgi, taux = moe._route(tx, tr.to(tx.dtype), tcfg)
    assert tgv.dtype == tx.dtype and tuple(tgi.shape) == jgi.shape
    near = _near_ties(_ref_gates(jx, jr, dtype), jcfg.top_k, MARGIN[dtype])
    assert near.mean() < 0.1
    np.testing.assert_array_equal(tgi.numpy()[~near], np.asarray(jgi)[~near])
    rel_close(tgv[torch.from_numpy(~near)], jgv[~near], TOL[dtype])
    rel_close(taux, jaux, TOL[dtype])


def test_top_k_ties_pick_the_lower_index(setup):
    """bf16 router logits with exact ties at the k-th place: each token is
    a one-hot row, so its logits are one row of a router whose entries
    take five values; both packages pick the lower index among equal
    gates, which is a stable descending sort's order."""
    jcfg, tcfg = setup[:2]
    rng = np.random.RandomState(2)
    d, E, k = jcfg.d_model, jcfg.n_experts, jcfg.top_k
    router = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], size=(d, E))
    xt = np.eye(d)
    jx, tx = both(xt, "bfloat16")
    jr, tr = both(router, "bfloat16")
    jgv, jgi, jaux = jmoe._route(jx, jr, jcfg)
    tgv, tgi, taux = moe._route(tx, tr, tcfg)
    gates = j2n(_ref_gates(jx, jr, "bfloat16"))
    g = -np.sort(-gates, axis=-1)
    tied = g[:, k - 1] == g[:, k]
    assert tied.sum() >= d // 4          # ties at the k-th place are common
    stable = np.argsort(-gates, axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(jgi), stable)
    np.testing.assert_array_equal(tgi.numpy(), stable)
    rel_close(tgv, jgv, TOL["bfloat16"])
    rel_close(taux, jaux, TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_reference(setup, dtype):
    jcfg, tcfg, _, _, jp, tp = setup
    jmp, tmp = _layer0(jp["blocks"])["moe"], _layer0(tp["blocks"])["moe"]
    kw = dict(compute_dtype=dtype)
    x = np.random.RandomState(3).standard_normal((B, 32, jcfg.d_model))
    jx, tx = both(x, dtype)
    jy, jaux = jmoe.moe_mlp(jmp, jx, jcfg, jdefault(**kw), None)
    with torch.no_grad():
        ty, taux = moe.moe_mlp(tmp, tx, tcfg, default_config(**kw), None)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == jy.shape
    near = _near_ties(_ref_gates(jx.reshape(-1, jcfg.d_model),
                                 jmp["router"], dtype),
                      jcfg.top_k, MARGIN[dtype])
    assert near.mean() < 0.1
    keep = ~near
    rel_close(ty.reshape(-1, jcfg.d_model)[torch.from_numpy(keep)],
              jy.reshape(-1, jcfg.d_model)[keep], TOL[dtype])
    rel_close(taux, jaux, TOL[dtype])


def test_moe_mlp_is_the_expert_by_expert_sum(setup):
    """The sorted computation against the definition, written out token
    by token and slot by slot in float64 on the same routing:
    sum_j gate_j * FFN_{e_j}(x)."""
    jcfg, tcfg, _, _, _, tp = setup
    mp = tree_map(lambda t: t.float(), _layer0(tp["blocks"])["moe"])
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (1, 24, tcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, _ = moe.moe_mlp(mp, x, tcfg, default_config(), None)
        gv, gi, _ = moe._route(x[0], mp["router"], tcfg)
    w = tree_map(lambda t: t.double(), mp)
    want = torch.zeros(x.shape[1:], dtype=torch.float64)
    for t in range(x.shape[1]):
        xt = x[0, t].double()
        for j in range(tcfg.top_k):
            e = int(gi[t, j])
            h = torch.nn.functional.silu(xt @ w["wg"][e]) * (xt @ w["wu"][e])
            want[t] += float(gv[t, j]) * (h @ w["wd"][e])
    rel_close(y[0], want.numpy(), TOL["float32"])


class _Sizes(TorchDispatchMode):
    """The shape of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if torch.is_tensor(t):
                self.shapes.append(tuple(t.shape))
        return out


def test_prefill_forms_no_per_token_expert_weights():
    """The reference gathers each token's expert weights, (T, d, ff) per
    weight and slot; no tensor the port's prefill allocates is that
    large, and none but the stacked weights has an expert weight's
    trailing (d, ff) or (ff, d)."""
    cfg = get_reduced("olmoe-1b-7b")
    model = build_model(cfg)
    rt = default_config(compute_dtype="bfloat16", attn_impl="pallas")
    params = model.cast_params(model.init(0, device="cpu"), rt)
    # S 48: no activation's trailing dims look like a weight's (d, ff)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab, (4, 48)).astype(np.int32))
    T, d, ff = 4 * 48, cfg.d_model, cfg.d_ff
    with torch.no_grad(), _Sizes() as sizes:
        model.prefill_fn(params, {"tokens": toks}, rt, max_seq=64)
    assert sizes.shapes
    assert max(int(np.prod(s)) for s in sizes.shapes) < T * d * ff
    weight_like = [s for s in sizes.shapes
                   if s[-2:] in ((d, ff), (ff, d)) and len(s) > 2
                   and s[-3] != cfg.n_experts]
    assert not weight_like, weight_like


def _inputs(jcfg, seed=7):
    toks = np.random.RandomState(seed).randint(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _check_cache(jlayers, tlayers, kv, tol):
    assert set(jlayers) == set(tlayers)
    for name in jlayers:
        if kv == "int8" and not name.endswith("_scale"):
            a, b = t2n(tlayers[name]), j2n(jlayers[name])
            assert tlayers[name].dtype == torch.int8
            assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3, name
        else:
            rel_close(tlayers[name], jlayers[name], tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_f32_prefill_cache_decode(setup, impl, kv):
    jcfg, tcfg, jm, tm, jp, tp = setup
    kw = dict(compute_dtype="float32", kv_cache_dtype=kv, attn_impl=impl)
    out = serve_both(jm, tm, jp, tp, *_inputs(jcfg), jdefault(**kw),
                     default_config(**kw), MAX_SEQ, STEPS)
    jlog, tlog = out["prefill"]
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    rel_close(tlog, jlog, MODEL_TOL["float32"])
    _check_cache(out["cache0"][0]["layers"], out["cache0"][1], kv,
                 MODEL_TOL["float32"])
    for jl, tl in out["steps"]:
        rel_close(tl, jl, MODEL_TOL["float32"])
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jl[:, -1], -1)))
    jc, tc = out["cache"]
    assert tc["pos"] == int(jc["pos"]) == S + STEPS
    _check_cache(jc["layers"], tc["layers"], kv, MODEL_TOL["float32"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_prefill_decode(setup, impl):
    jcfg, tcfg, jm, tm, jp, tp = setup
    kw = dict(compute_dtype="bfloat16", kv_cache_dtype="bfloat16",
              attn_impl=impl)
    out = serve_both(jm, tm, jp, tp, *_inputs(jcfg), jdefault(**kw),
                     default_config(**kw), MAX_SEQ, STEPS)
    fro_close(out["prefill"][1], out["prefill"][0], MODEL_TOL["bfloat16"])
    for jl, tl in out["steps"]:
        fro_close(tl, jl, MODEL_TOL["bfloat16"])
    jc, tc = out["cache"]
    for name in jc["layers"]:
        fro_close(tc["layers"][name], jc["layers"][name], MODEL_TOL["bfloat16"])


def _train_batch(jcfg, seed=9):
    toks = np.random.RandomState(seed).randint(
        0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    npb = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in npb.items()},
            {k: torch.from_numpy(v) for k, v in npb.items()})


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_xent_aux_and_grads(setup, remat):
    """The loss, its ``xent`` and ``aux`` at 2e-5; each gradient at 1e-4,
    or five times the port's own one-rounding-unit floor where that lies
    above it (``ulp_floor``)."""
    jcfg, tcfg, jm, tm, jp, tp = setup
    kw = dict(compute_dtype="float32", remat_policy=remat)
    jb, tb = _train_batch(jcfg)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp32 = tree_map(lambda t: t.float(), tp)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, jdefault(**kw)), has_aux=True)(jp32)
    with torch.no_grad():
        tl, tparts = tm.loss_fn(tp32, tb, default_config(**kw))
    assert float(tparts["aux"]) > 0
    rel_close(tl, jl, TOL["float32"])
    rel_close(tparts["xent"], jparts["xent"], TOL["float32"])
    rel_close(tparts["aux"], jparts["aux"], TOL["float32"])
    grads = port_grads(tm, tb, default_config(**kw))
    floor = ulp_floor(grads, tp32)
    for g, (_, j), f in zip(grads(tp32), leaf_pairs(tp32, jg), floor):
        fro_close_floor(g, j, MODEL_TOL["float32"], f)


def test_train_step_matches_reference(setup):
    """One AdamW step: the loss at 2e-5, the gradient norm at 1e-4, the
    update and the moments at 1e-4 or five times the port's floor; kimi's
    bf16 masters and the moments built from their bf16 gradients, where
    a one-unit difference of rounding is bf16's, at bf16's 2e-2."""
    jcfg, tcfg, _, _, jp, tp = setup
    jb, tb = _train_batch(jcfg)
    kw = dict(compute_dtype="float32", remat_policy="none")
    (jn, jo, jmet), (tn, to, tmet) = train_step_both(
        jcfg, tcfg, jp, tp, jb, tb, **kw)
    rel_close(tmet["loss"], jmet["loss"], TOL["float32"])
    rel_close(tmet["grad_norm"], jmet["grad_norm"], MODEL_TOL["float32"])
    got = step_outputs(tp, tn, to)
    want = step_outputs(from_jax_params(jp), from_jax_params(jn),
                        from_jax_params(jo))
    if jcfg.param_dtype == "bfloat16":
        for (t, j) in leaf_pairs(tn, jn):
            assert t.dtype == torch.bfloat16
            rel_close(t, j, TOL["bfloat16"])
        for t, j in zip(got, want):
            if t.dtype == torch.float32:
                fro_close(t, j, TOL["bfloat16"])
        return
    step = port_train_step(tcfg, B, S, **kw)
    floor = ulp_floor(lambda p: step_outputs(p, *step(p, tb)[:2]), tp)
    for t, j, f in zip(got, want, floor):
        fro_close_floor(t, j, MODEL_TOL["float32"], f)


def test_params_carry_across_packages(setup):
    jcfg, tcfg, jm, tm, jp, tp = setup
    shapes = tm.param_shapes()
    n = 0
    for t, j in leaf_pairs(tp, jp):
        assert tuple(t.shape) == j.shape and t2n(t).tobytes() \
            == j2n(j).tobytes()
        n += 1
    assert n == len(jax.tree.leaves(jp))
    L_, E, d, ff = jcfg.n_layers, jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    moe_p = tp["blocks"]["moe"]
    assert {k: tuple(v.shape) for k, v in moe_p.items()} == {
        "router": (L_, d, E), "wg": (L_, E, d, ff), "wu": (L_, E, d, ff),
        "wd": (L_, E, ff, d)}
    assert tuple(shapes["blocks"]["moe"]["wg"].shape) == (L_, E, d, ff)
    assert "mlp" not in tp["blocks"]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_build_and_train(arch):
    cfg = get_config(arch)
    model = build_model(cfg)
    spec = model.param_shapes()
    assert tuple(spec["blocks"]["moe"]["wg"].shape) == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        spec, is_leaf=lambda s: isinstance(s, L.ShapeDtype)))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jbuild(jget_config(arch)).param_shapes()))
    rt = default_config()
    notes = build_step(cfg, ShapeConfig("t", 64, 2, "train"), rt).notes
    assert notes["moe_one_device_no_ops"] == {
        "comm_codec": rt.comm_codec, "capacity_factor": cfg.capacity_factor}
    assert tuple(notes["moe_one_device_no_ops"]) == MOE_ONE_DEVICE_NO_OPS
    prefill = build_step(cfg, ShapeConfig("p", 64, 2, "prefill"), rt).notes
    assert "moe_one_device_no_ops" in prefill


def test_expert_parallel_paths_raise_naming_their_slice():
    """The expert-parallel paths are ported (slice 7; on gloo ranks in
    tests/test_torch_spmd_families.py), chosen where the reference
    chooses them; what they still cannot do, the gradient of
    ep_gather's combine, raises naming its slice."""
    from repro.runtime.sharding import ShardingRules as JRules
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.runtime.sharding import ShardingRules
    from test_sharding_rules import fake_mesh
    cfg = get_reduced("olmoe-1b-7b")
    for shape in ((1, 1), (2, 4), (8, 1), (1, 8), (2, 3)):
        axes = ("data", "model")
        t = ShardingRules(AbstractMesh(shape, axes), "tp")
        j = JRules(mesh=fake_mesh(shape, axes), strategy="tp")
        for S in (1, 6, 32):
            assert moe._ep_paths_applicable(cfg, t, S) == \
                jmoe._ep_paths_applicable(cfg, j, S)
    assert moe._ep_paths_applicable(cfg, None, 32) is None
    with pytest.raises(NotImplementedError, match="slice 7b"):
        moe._GatherNoGrad.backward(None, torch.zeros(2))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_tiny_trace_same_tokens_through_both_schedulers(setup, impl):
    """A registered tiny trace through both packages' BatchScheduler in
    f32: the same greedy tokens for every request (the reduced olmoe and
    kimi at f32 keep every routing decision)."""
    from repro.serving import scheduler as JS
    from repro.serving import traffic as JT
    from repro_torch.serving import scheduler as TS
    from repro_torch.serving import traffic as TT
    jcfg, tcfg, _, _, jp, tp = setup
    kw = dict(wave_size=3, max_seq=32)
    js = JS.BatchScheduler(jcfg, jdefault(attn_impl=impl), jp, **kw)
    ts = TS.BatchScheduler(tcfg, default_config(attn_impl=impl), tp,
                           device="cpu", **kw)
    trace = TT.get_trace("poisson_tiny")
    assert trace.to_json() == JT.get_trace("poisson_tiny").to_json()
    for mod, sched in ((JS, js), (TS, ts)):
        for r in trace.requests:
            sched.submit(mod.Request(rid=r.rid, tokens=TT.request_tokens(r),
                                     max_new_tokens=r.max_new_tokens,
                                     t_submit=0.0))
    jdone, tdone = js.run_until_drained(), ts.run_until_drained()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(tdone, jdone):
        assert a.generated == b.generated
        assert len(a.generated) == a.max_new_tokens


@pytest.mark.parametrize("argv", [
    ["--kv-dtype", "bfloat16"], ["--kv-dtype", "int8", "--attn-impl", "xla"]])
def test_serve_cli_on_cpu(argv, capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--reduced",
                     "--batch", "2", "--prompt-len", "8", "--gen-tokens", "3",
                     *argv])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b-reduced" in out and "decode:" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llava-next-34b",
                                  "zamba2-7b"])
def test_train_cli_on_cpu(arch, tmp_path, capsys):
    """``launch/train.py --reduced`` trains each newly trainable family a
    few steps and checkpoints (the vlm batch carries its frontend
    embeddings)."""
    from repro_torch.launch import train
    seq = 24 if arch != "llava-next-34b" else 16 + 8
    assert train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", str(seq),
                       "--ckpt-interval", "2", "--log-interval", "1",
                       "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "done." in out
