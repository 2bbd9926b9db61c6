"""Helpers shared by the tests that hold the PyTorch port against the
JAX reference: one numpy array handed to both, parameters carried across
with ``from_jax_params``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.convert import from_jax_params

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(arr, dtype="float32"):
    return (jnp.asarray(arr).astype(JDT[dtype]),
            torch.from_numpy(np.asarray(arr)).to(TDT[dtype]))


def j2n(x):
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    return np.asarray(x)


def t2n(x):
    return (x.float() if x.is_floating_point() else x).numpy()


def shared_params(jax_params):
    """(reference params, port params) holding the same numbers."""
    return jax_params, from_jax_params(jax.tree.map(np.asarray, jax_params))


def rel_close(t, j, tol):
    """max |t - j| <= tol * max |j|: the tensor's scale, not each element's."""
    a, b = t2n(t), j2n(j)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-6)
    assert float(np.abs(a - b).max()) / scale <= tol, \
        (float(np.abs(a - b).max()), scale)


def fro_close(t, j, tol):
    """||t - j|| / ||j|| <= tol (relative Frobenius norm)."""
    a, b = t2n(t), j2n(j)
    assert a.shape == b.shape
    assert float(np.linalg.norm(a - b) / np.linalg.norm(b)) <= tol


# ------------------------------------------------ whole-model parity runs
def serve_both(jm, tm, jp, tp, jbatch, tbatch, jrt, trt, max_seq, steps):
    """Prefill, then ``steps`` decode steps, in both packages on the same
    weights and inputs -> {"prefill": (j, t) logits, "cache0": (j, t)
    caches after prefill (the port's copied), "steps": [(j, t) logits],
    "cache": (j, t) final caches}.  Both sides decode the reference's
    greedy token, so one flipped argmax cannot send them apart."""
    jlog, jcache = jm.prefill_fn(jp, jbatch, jrt, max_seq=max_seq)
    with torch.no_grad():
        tlog, tcache = tm.prefill_fn(tp, tbatch, trt, max_seq=max_seq)
    out = {"prefill": (jlog, tlog),
           "cache0": (jcache, {k: v.clone() if torch.is_tensor(v) else v
                               for k, v in tcache["layers"].items()}),
           "steps": []}
    jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    for _ in range(steps):
        jl, jcache = jm.decode_fn(jp, jcache, jtok, jrt)
        with torch.no_grad():
            tl, tcache = tm.decode_fn(tp, tcache,
                                      torch.from_numpy(np.array(jtok)), trt)
        out["steps"].append((jl, tl))
        jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    out["cache"] = (jcache, tcache)
    return out


def leaf_pairs(t_tree, j_tree):
    """(port leaf, reference leaf) over the reference tree's paths."""
    for path, j in jax.tree_util.tree_flatten_with_path(j_tree)[0]:
        t = t_tree
        for p in path:
            t = t[p.key]
        yield t, j


# AdamW at a learning rate at which an update stands well above the
# rounding of the parameters, and an eps at which it is a smooth function
# of the gradient (tests/test_torch_train.py says why)
LR, EPS = 1e-2, 1e-3


def port_train_step(tcfg, B, S, **kw):
    """fn(params, batch) -> the port's (params, opt, metrics) after one
    AdamW step of ``build_train_step`` from fresh optimizer state; the
    given parameters are left as they were."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.optim import optimizers as topt
    from repro_torch.runtime.loops import tree_map
    from repro_torch.runtime.stepfn import build_train_step
    to = topt.make_optimizer(tcfg.optimizer, topt.constant_schedule(LR),
                             eps=EPS)
    bundle = build_train_step(tcfg, ShapeConfig("t", S, B, "train"),
                              default_config(**kw), None, to)

    def fn(params, batch):
        params = tree_map(lambda t: t.clone(), params)
        return bundle.fn(params, to.init(params), batch)
    return fn


def step_outputs(before, after, opt):
    """The update of every parameter (after minus before) and every
    floating optimizer moment, as one list."""
    from repro_torch.runtime.loops import tree_leaves
    return [a - b for a, b in zip(tree_leaves(after), tree_leaves(before))] \
        + [t for t in tree_leaves(opt) if t.is_floating_point()]


def train_step_both(jcfg, tcfg, jp, tp, jbatch, tbatch, **kw):
    """One AdamW train step of each package's ``build_train_step`` from
    the same parameters and batch -> ((params, opt, metrics) of the
    reference as numpy, the same of the port).  The reference's step
    donates its inputs: it gets copies."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.core.params import default_config as jdefault
    from repro.launch.mesh import make_mesh
    from repro.optim import optimizers as jopt
    from repro.runtime.stepfn import build_train_step as jbuild_train
    B, S = np.asarray(jbatch["tokens"]).shape
    S += jcfg.frontend_tokens
    jo = jopt.make_optimizer(jcfg.optimizer, jopt.constant_schedule(LR),
                             eps=EPS)
    bundle = jbuild_train(jcfg, JShape("t", S, B, "train"), jdefault(**kw),
                          make_mesh((1, 1), ("data", "model")), jo)
    params = jax.tree.map(jnp.array, jp)
    jout = jax.tree.map(np.asarray, bundle.fn(params, jo.init(params),
                                              jbatch))
    return jout, port_train_step(tcfg, B, S, **kw)(tp, tbatch)


# ------------------------------------- one rounding unit: the floor of a
# comparison between frameworks that round differently
FLOOR_MULTIPLE = 5


def _relfro(a, b):
    a, b = t2n(a).astype(np.float64), t2n(b).astype(np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb else float(
        np.linalg.norm(a - b))


def ulp_floor(fn, params, draws=2, seed=0):
    """How far each output of ``fn(params)`` (a list of tensors) moves, in
    the relative Frobenius norm, when every floating parameter is moved
    by one f32 rounding unit (2^-23 relative, random signs): the most
    over ``draws`` draws.  At the reference's initialisation the
    attention logits are large and the softmax nearly one-hot, so a
    gradient can move by more than the comparison's tolerance under one
    rounding unit; two frameworks that round differently at every
    operation cannot come closer than that."""
    from repro_torch.runtime.loops import tree_map
    base = fn(params)
    rng = np.random.RandomState(seed)

    def move(t):
        if not t.is_floating_point():
            return t
        signs = torch.from_numpy(rng.choice([-1.0, 1.0], size=t.shape))
        return (t.double() * (1 + 2.0 ** -23 * signs)).to(t.dtype)
    floor = [0.0] * len(base)
    for _ in range(draws):
        moved = fn(tree_map(move, params))
        floor = [max(f, _relfro(m, b)) for f, m, b in zip(floor, moved,
                                                           base)]
    return floor


def fro_close_floor(t, j, tol, floor):
    """``fro_close`` at ``tol``, or at ``FLOOR_MULTIPLE`` times the
    one-rounding-unit floor where that lies above it."""
    fro_close(t, j, max(tol, FLOOR_MULTIPLE * floor))


def port_grads(tm, batch, rt):
    """fn(params) -> the port's gradient of the loss, leaf by leaf."""
    from repro_torch.runtime.loops import tree_leaves, tree_map

    def fn(params):
        work = tree_map(lambda t: t.detach().clone().requires_grad_()
                        if t.is_floating_point() else t, params)
        loss, _ = tm.loss_fn(work, batch, rt)
        leaves = [x for x in tree_leaves(work) if x.requires_grad]
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]
    return fn
