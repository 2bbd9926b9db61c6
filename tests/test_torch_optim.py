"""The port's optimizers against the reference's, on the CPU: one AdamW
and one Adafactor update of a random tree (factored and unfactored
leaves, stacked ones too), the global-norm clip, and the cosine
schedule at every step of a short run.

Tolerance 1e-6 relative to each leaf's scale: the same f32 formulas,
reduced in another order (the global norm, Adafactor's means) and with
XLA's and PyTorch's own pow/sqrt."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt

from _torch_parity import rel_close

TOL = 1e-6


def _tree(seed):
    rng = np.random.RandomState(seed)
    shapes = {"embed": {"embedding": (96, 80)},
              "blocks": {"attn": {"wq": (2, 80, 3, 16)},
                         "mlp": {"wd": (2, 128, 80)},
                         "ln1": (2, 80)},
              "final_norm": (80,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return make(shapes), make(shapes)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree))


def _leaves_close(t_tree, j_tree, tol=TOL):
    jl = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    for path, j in jl:
        t = t_tree
        for p in path:
            t = t[p.key]
        rel_close(t, j, tol)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"clip_norm": None}),
    ("adamw", {"weight_decay": 0.0, "b2": 0.999}),
    ("adafactor", {}), ("adafactor", {"weight_decay": 0.1, "min_dim": 16})])
@pytest.mark.parametrize("steps", [1, 2])
def test_update_matches_reference(name, kw, steps):
    p_np, g_np = _tree(0)
    jp, tp = _both(p_np)
    jg, tg = _both(g_np)
    jo = getattr(jopt, name)(jopt.cosine_schedule(3e-3, 1, 10), **kw)
    to = getattr(topt, name)(topt.cosine_schedule(3e-3, 1, 10), **kw)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(steps):
        jp, js, jm = jo.update(jg, js, jp)
        tp, ts, tm = to.update(tg, ts, tp)
    _leaves_close(tp, jp)
    _leaves_close(ts, js)
    rel_close(tm["grad_norm"], jm["grad_norm"], TOL)
    rel_close(tm["lr"], jm["lr"], TOL)
    assert int(ts["step"]) == int(js["step"]) == steps
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adafactor", {"weight_decay": 0.1, "min_dim": 16})])
def test_inplace_update_writes_the_functional_bits_into_its_inputs(name, kw):
    """``inplace=True`` (a donating train step) writes into the
    parameters and the state and returns them; the functional update
    returns new tensors and leaves its inputs as they were; both give
    the same bits over two steps."""
    from repro_torch.runtime.loops import tree_leaves
    p_np, g_np = _tree(0)
    opt = getattr(topt, name)(topt.cosine_schedule(3e-3, 1, 10), **kw)
    grads = _both(g_np)[1]
    fp = _both(p_np)[1]
    fs = opt.init(fp)
    ip = _both(p_np)[1]
    is_ = opt.init(ip)
    for _ in range(2):
        before = [t.clone() for t in tree_leaves((fp, fs))]
        nfp, nfs, fm = opt.update(grads, fs, fp)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves((fp, fs)), before))
        assert not any(a is b for a, b in zip(tree_leaves((nfp, nfs)),
                                              tree_leaves((fp, fs))))
        nip, nis, im = opt.update(grads, is_, ip, inplace=True)
        assert all(a is b for a, b in zip(tree_leaves((nip, nis)),
                                          tree_leaves((ip, is_))))
        fp, fs = nfp, nfs
        for a, b in zip(tree_leaves((ip, is_)), tree_leaves((fp, fs))):
            assert torch.equal(a, b)
        assert torch.equal(fm["grad_norm"], im["grad_norm"])


def test_state_layout_is_the_references():
    p_np, _ = _tree(1)
    jp, tp = _both(p_np)
    for name in ("adamw", "adafactor"):
        js = getattr(jopt, name)(jopt.constant_schedule(1e-3)).init(jp)
        ts = getattr(topt, name)(topt.constant_schedule(1e-3)).init(tp)
        jkeys = sorted("/".join(str(p.key) for p in path) for path, _ in
                       jax.tree_util.tree_flatten_with_path(js)[0])
        from repro_torch.checkpoint.checkpoint import _flatten
        assert sorted(_flatten(ts)) == jkeys


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm(max_norm):
    _, g_np = _tree(2)
    jg, tg = _both(g_np)
    jc, jn = jopt.clip_by_global_norm(jg, max_norm)
    tc, tn = topt.clip_by_global_norm(tg, max_norm)
    rel_close(tn, jn, TOL)
    _leaves_close(tc, jc)


@pytest.mark.parametrize("warmup,total,floor", [(10, 12, 0.1), (3, 20, 0.0),
                                                (0, 5, 0.5)])
def test_cosine_schedule_every_step(warmup, total, floor):
    js = jopt.cosine_schedule(3e-4, warmup, total, floor)
    ts = topt.cosine_schedule(3e-4, warmup, total, floor)
    for step in range(total + 3):
        want = float(js(jnp.asarray(step, jnp.int32)))
        assert abs(float(ts(torch.tensor(step, dtype=torch.int32)))
                   - want) <= TOL * 3e-4
        assert abs(float(ts(step)) - want) <= TOL * 3e-4


def test_make_optimizer_names():
    assert topt.make_optimizer("adamw").init({"w": torch.zeros(2)})["step"] \
        .item() == 0
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("sgd")
