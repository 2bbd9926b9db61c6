"""Training the hybrid family (zamba2-7b: Mamba2 blocks and one shared
attention block) in the PyTorch port against the reference, on the CPU,
on the reduced config and on a variant with a remainder block: the loss,
its gradients at every remat policy, and one AdamW step; the train step
runs the eager scan (``ssd_chunked``), never the forward-only kernel;
and the scan's gradient stays finite where f32's ``exp`` overflows.
Same weights (``from_jax_params``, Mamba2's ``dt_bias``, ``A_log`` and
``D`` drawn random and non-zero), same numpy tokens.

Tolerances: ssm 1e-4 (f32) and 5e-2 (bf16), as tests/test_kernels.py
holds the scan; a gradient, an update or a moment at 1e-4 or at five
times the port's own floor under one rounding unit of the parameters,
where that lies above (``_torch_parity.ulp_floor``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.params import default_config as jdefault
from repro.models import mamba2 as jm2
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.core.params import default_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import mamba2 as tm2
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.runtime.loops import tree_map
from repro_torch.runtime.stepfn import build_train_step

from _torch_parity import (both, fro_close_floor, leaf_pairs, port_grads,
                           port_train_step, rel_close, step_outputs,
                           train_step_both, ulp_floor)
from test_torch_hybrid import cfgs, weights

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 24


def _batch(vocab, seed=3):
    toks = np.random.RandomState(seed).randint(
        0, vocab, (B, S + 1)).astype(np.int32)
    npb = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in npb.items()},
            {k: torch.from_numpy(v) for k, v in npb.items()})


@pytest.mark.parametrize("variant", ["reduced", "rem"])
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_grads_match_reference(variant, remat):
    jcfg, tcfg = cfgs(variant)
    jp, tp = weights(variant)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jb, tb = _batch(jcfg.vocab)
    kw = dict(compute_dtype="float32", remat_policy=remat)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, jdefault(**kw)), has_aux=True)(jp)
    with torch.no_grad():
        tl, tparts = tm.loss_fn(tp, tb, default_config(**kw))
    assert tparts == jparts == {}
    rel_close(tl, jl, TOL["float32"])
    grads = port_grads(tm, tb, default_config(**kw))
    floor = ulp_floor(grads, tp)
    for g, (_, j), f in zip(grads(tp), leaf_pairs(tp, jg), floor):
        assert bool(torch.isfinite(g).all())
        fro_close_floor(g, j, TOL["float32"], f)


@pytest.mark.parametrize("variant", ["reduced", "rem"])
def test_bf16_loss_within_5e2(variant):
    jcfg, tcfg = cfgs(variant)
    jp, tp = weights(variant)
    jb, tb = _batch(jcfg.vocab)
    kw = dict(compute_dtype="bfloat16", remat_policy="none")
    jl, _ = jbuild(jcfg).loss_fn(jp, jb, jdefault(**kw))
    with torch.no_grad():
        tl, _ = build_model(tcfg).loss_fn(tp, tb, default_config(**kw))
    assert tl.dtype == torch.float32
    rel_close(tl, jl, TOL["bfloat16"])


@pytest.mark.parametrize("variant", ["reduced", "rem"])
def test_train_step_matches_reference(variant):
    jcfg, tcfg = cfgs(variant)
    jp, tp = weights(variant)
    jb, tb = _batch(jcfg.vocab)
    kw = dict(compute_dtype="float32", remat_policy="dots")
    (jn, jo, jmet), (tn, to, tmet) = train_step_both(
        jcfg, tcfg, jp, tp, jb, tb, **kw)
    rel_close(tmet["loss"], jmet["loss"], TOL["float32"])
    step = port_train_step(tcfg, B, S, **kw)

    def outputs(p, new, opt, met):       # the gradient norm among them
        return step_outputs(p, new, opt) + [
            torch.tensor([float(met["grad_norm"])])]
    floor = ulp_floor(lambda p: outputs(p, *step(p, tb)), tp)
    want = outputs(from_jax_params(jp), from_jax_params(jn),
                   from_jax_params(jo), jmet)
    for t, j, f in zip(outputs(tp, tn, to, tmet), want, floor):
        fro_close_floor(t, j, TOL["float32"], f)


def test_train_step_runs_the_eager_scan(monkeypatch):
    """Under attn_impl="pallas" the train step takes the eager ops: every
    Mamba2 block scans with ``ssd_chunked``, and no kernel wrapper is
    called."""
    tcfg = cfgs("rem")[1]
    _, tp = weights("rem")
    calls = []
    eager = tm2.ssd_chunked

    def counted(*a, **k):
        calls.append(a[0].shape)
        return eager(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called in a train step")
    monkeypatch.setattr(tm2, "ssd_chunked", counted)
    for mod, name in ((ssm_ops, "ssm_scan"), (fa_ops, "flash_attention"),
                      (rms_ops, "rmsnorm")):
        monkeypatch.setattr(mod, name, refuse)
    # S a whole number of chunks and no recompute: one scan per block
    seq = tcfg.ssm_chunk
    bundle = build_train_step(tcfg, ShapeConfig("t", seq, B, "train"),
                              default_config(attn_impl="pallas",
                                             remat_policy="none"))
    assert bundle.notes["attn_impl"].startswith("xla")
    params = tree_map(lambda t: t.clone(), tp)
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, tcfg.vocab, (B, seq + 1)).astype(np.int32))
    tb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, _, met = bundle.fn(params, make_optimizer("adamw").init(params), tb)
    assert bool(torch.isfinite(met["loss"]))
    assert len(calls) == tcfg.n_layers


def test_kernel_wrappers_refuse_a_gradient():
    """The hybrid loss with the kernels (attn_impl="pallas") on parameters
    that need a gradient fails loudly: the kernels are forward-only."""
    tcfg = cfgs("reduced")[1]
    _, tp = weights("reduced")
    work = tree_map(lambda t: t.clone().requires_grad_(), tp)
    _, tb = _batch(tcfg.vocab)
    with pytest.raises(RuntimeError, match="forward-only"):
        build_model(tcfg).loss_fn(work, tb, default_config(attn_impl="pallas"))


def test_scan_gradient_is_finite_past_the_exp_range():
    """A chunk whose decays sum past f32's exp range (88): the reference's
    within-chunk ``exp`` then mask gives 0 * inf = NaN in its gradient;
    the port masks before the exp.  Its gradient at a chunk of 64 equals
    the reference's at a chunk of 8 (the scan's result does not depend on
    the chunk) within ssm's 1e-4."""
    rng = np.random.RandomState(11)
    Bz, L_, H, P, N = 1, 64, 2, 4, 4
    X = rng.standard_normal((Bz, L_, H, P))
    Bm, Cm = (rng.standard_normal((Bz, L_, N)) * 0.5 for _ in range(2))
    dt = np.full((Bz, L_, H), 1.0)
    loga = np.full((Bz, L_, H), -2.0)             # 64 tokens: sum -128
    R = rng.standard_normal((Bz, L_, H, P))
    jins = [both(a)[0] for a in (X, Bm, Cm, dt, loga)]
    tins = [both(a)[1].requires_grad_() for a in (X, Bm, Cm, dt, loga)]

    def jloss(chunk):
        def f(*ins):
            Y, h = jm2.ssd_chunked(*ins, chunk)
            return jnp.sum(Y * jnp.asarray(R, jnp.float32)) + jnp.sum(h)
        return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*jins)
    assert any(bool(jnp.isnan(g).any()) for g in jloss(64))
    Y, h = tm2.ssd_chunked(*tins, 64)
    (torch.sum(Y * torch.from_numpy(R).float()) + torch.sum(h)).backward()
    for t, j in zip(tins, jloss(8)):
        assert bool(torch.isfinite(t.grad).all())
        rel_close(t.grad, j, TOL["float32"])


def test_trainable_families():
    """Every arch of every family builds its train step at full size
    (parameters and optimizer state as shapes only)."""
    from repro_torch.configs import list_archs
    families = set()
    for arch in list_archs():
        cfg = get_config(arch)
        bundle = build_train_step(cfg, ShapeConfig("t", 64, 2, "train"),
                                  default_config())
        assert bundle.kind == "train"
        families.add(cfg.family)
    assert families == {"dense", "moe", "vlm", "hybrid", "ssm", "encdec"}
