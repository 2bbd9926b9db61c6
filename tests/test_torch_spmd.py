"""The port's multi-device path held against its one-device step and
against the reference, on CPU ranks (gloo), the way the reference's
``tests/test_spmd.py`` forces host devices.  Each test is one spawn of
its ranks (``_torch_dist.run_ranks``: a ``FileStore`` under a
temporary directory, one thread per rank) that runs all of its cases; rank 0 hands its numbers back and the test process compares them
with the reference's (JAX on this process's one CPU device).

Covered: one train step under dp / tp / fsdp / fsdp_tp on a (4, 2)
mesh against the one-device step (the reference's own bound, 1e-4) and
against the reference's one-device step; the explicit path taken
exactly where the reference takes it; tp serving through the kernels'
wrappers under ``local_map``; gradient sync in every wire dtype on (8,)
and the int8 error feedback against its two phases restated on one
process; MoE's ep_alltoall and ep_gather against the dense path; a
checkpoint written on (4, 2) restored on (2, 2) and on one device.  One
spawn of 8 ranks (a module fixture) runs every case of the file but the
restore on (2, 2).  The other families: test_torch_spmd_families.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import run_ranks
from _torch_spmd_ranks import ARCH, STRATEGIES, _spmd_ranks


def _jax_setup(arch, B, S):
    from repro.configs import get_reduced
    from repro.models.model import build_model
    cfg = get_reduced(arch)
    params = jax.tree.map(np.asarray, build_model(cfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _flats():
    """Each of 8 ranks' vector and residual for ``int8_allreduce_ef``."""
    rng = np.random.RandomState(3)
    return [(rng.standard_normal(1001).astype(np.float32),
             (rng.standard_normal(1001) * 1e-2).astype(np.float32))
            for _ in range(8)]


def _moe_setup():
    from repro.configs import get_reduced
    from repro.models import moe as jmoe
    from repro.models.layers import init_params
    cfg = get_reduced("olmoe-1b-7b").replace(capacity_factor=8.0)
    params = jax.tree.map(np.asarray, init_params(jmoe.moe_spec(cfg),
                                                  jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    xs = (rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32),
          rng.standard_normal((8, 1, cfg.d_model)).astype(np.float32),
          # ep_gather's gradient: x and the cotangent of y (sequence 3)
          rng.standard_normal((4, 3, cfg.d_model)).astype(np.float32),
          rng.standard_normal((4, 3, cfg.d_model)).astype(np.float32))
    return cfg, params, xs


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Rank 0's results of every case, from one spawn of 8 ranks."""
    jcfg, params, batch = _jax_setup(ARCH, 8, 64)
    serve = np.random.RandomState(2).randint(0, jcfg.vocab, (8, 16)) \
        .astype(np.int32)
    _, moe_params, moe_xs = _moe_setup()
    ckpt_dir = tmp_path_factory.mktemp("spmd_ckpt") / "sharded"
    out = run_ranks(_spmd_ranks, 8, tmp_path_factory.mktemp("spmd"),
                    params, batch, serve, _flats(), moe_params, moe_xs,
                    str(ckpt_dir))
    return dict(out, ckpt_dir=ckpt_dir)


# ------------------------------------------- train step on (4, 2), serving
def test_strategies_match_one_device_and_reference(spmd):
    """One train step of smollm-135m (reduced) at (8, 64) under dp / tp /
    fsdp / fsdp_tp on a (4, 2) mesh: loss and mean |final_norm| within
    1e-4 of the port's one-device step (the reference's bound,
    test_spmd.py), also at two microbatches under tp (each rank splits
    its own rows) and under tp with ``attn_tp_fallback="batch_shard"``, and the one-device step's loss and gradient norm
    within the train parity tests' 1e-5 / 1e-4 of the reference's
    one-device step on the same weights and batch; the explicit path
    exactly where the reference takes it (dp, fsdp).  And tp serving through the kernels' wrappers under ``local_map``: prefill
    within 1e-5 and three decode steps within 1e-4 of the one-device
    path (f32 cache)."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.core.params import default_config as jdefault
    from repro.launch.mesh import make_mesh
    from repro.optim.optimizers import constant_schedule, make_optimizer
    from repro.runtime.stepfn import build_train_step
    from _torch_parity import rel_close
    jcfg, params, batch = _jax_setup(ARCH, 8, 64)
    out = spmd["strategies"]
    one = out["one"]
    for strat in STRATEGIES + ("tp_mb2", "tp_batch_shard"):
        loss, _, fnorm, explicit = out[strat]
        assert abs(loss - one[0]) < 1e-4, (strat, loss, one)
        assert abs(fnorm - one[2]) < 1e-4, (strat, fnorm, one)
        base = strat.replace("_mb2", "").replace("_batch_shard", "")
        assert explicit == (base in ("dp", "fsdp")), strat
    opt = make_optimizer("adamw", constant_schedule(1e-3))
    b = build_train_step(jcfg, JShape("t", 64, 8, "train"),
                         jdefault(donate_buffers=False),
                         make_mesh((1, 1), ("data", "model")), opt)
    jp = jax.tree.map(jnp.asarray, params)
    jp2, _, jmet = b.fn(jp, opt.init(jp), batch)
    rel_close(torch.tensor(one[0]), jmet["loss"], 1e-5)
    rel_close(torch.tensor(one[1]), jmet["grad_norm"], 1e-4)
    assert abs(one[2] - float(jnp.mean(jnp.abs(jp2["final_norm"])))) < 1e-4
    for strat, errs in out["serve"].items():
        # the sharded products sum in another order: the decode steps
        # read a cache a rounding unit away from the one-device one
        assert errs[0] < 1e-5 and max(errs) < 1e-4, (strat, errs)


# ------------------------------------------------------- gradient sync
# ------------------------------------------------------- gradient sync
def test_quantize_ef_bit_identical_to_reference():
    from repro.runtime import gradsync as jg
    from repro_torch.runtime import gradsync as tg
    rng = np.random.RandomState(0)
    for n, resid in ((1000, False), (4096, True), (7, True)):
        g = (rng.standard_normal(n) * 10 ** rng.uniform(-6, 2)).astype(
            np.float32)
        st = (rng.standard_normal(n) * 1e-3).astype(np.float32) \
            if resid else None
        jq, js, jr = jg.quantize_ef(jnp.asarray(g), None if st is None
                                    else jnp.asarray(st))
        tq, ts, tr = tg.quantize_ef(torch.from_numpy(g), None if st is None
                                    else torch.from_numpy(st))
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        assert np.array_equal(tr.numpy(), np.asarray(jr))
        assert np.array_equal(tg.dequantize_ef(tq, ts).numpy(),
                              np.asarray(jg.dequantize_ef(jq, js)))


def _int8_two_phases(flats, n):
    """The reference's two phases restated on one process: each rank's
    ``quantize_ef``, the all-to-all and the sum in f32, the requantize,
    the gather -> (the sum every rank gets, each rank's residual, the
    largest second-stage scale)."""
    from repro.runtime import gradsync as jg
    N = flats[0][0].shape[0]
    pad = (-N) % n
    qs, ss, rs = [], [], []
    for flat, resid in flats:
        q, s, r = jg.quantize_ef(jnp.pad(jnp.asarray(flat), (0, pad)),
                                 jnp.pad(jnp.asarray(resid), (0, pad)))
        qs.append(np.asarray(q).reshape(n, -1))
        ss.append(float(s))
        rs.append(np.asarray(r)[:N])
    out, s2s = [], []
    for j in range(n):
        partial = np.sum(np.stack([qs[i][j].astype(np.float32) * ss[i]
                                   for i in range(n)]), axis=0)
        s2 = max(float(np.max(np.abs(partial))), 1e-12) / 127.0
        q2 = np.clip(np.round(partial / s2), -127, 127)
        out.append(q2 * s2)
        s2s.append(s2)
    return np.concatenate(out)[:N], rs, max(s2s)


def test_gradsync_wire_dtypes_and_int8_ef(spmd):
    """On an (8,) mesh, as the reference's test_spmd.py: bf16, fused and
    fsdp-bf16 gradient collectives within 5e-3 of f32 (loss and gradient
    norm), all on the explicit path; int8 error feedback after four
    steps below 6.25 and within 0.1 of f32; and ``int8_allreduce_ef``
    within one quantisation step of the reference's two phases restated
    on one process, its residual equal to theirs bit for bit."""
    out = spmd["gradsync"]
    flats = _flats()
    f32 = out["f32"]
    for name in ("f32", "bf16", "fused", "fsdp_bf16"):
        loss, gnorm, explicit = out[name]
        assert explicit, name
        assert abs(loss - f32[0]) < 5e-3, (name, loss, f32)
        assert abs(gnorm - f32[1]) < 5e-3 * f32[1], (name, gnorm, f32)
    assert out["int8_ef"] < 6.25
    assert abs(out["int8_ef"] - out["float32"]) < 0.1
    assert out["ef_shape"][0] == 8
    want, resids, step = _int8_two_phases(flats, 8)
    for rank, (s, r) in enumerate(out["int8"]):
        assert np.max(np.abs(s - want)) <= step, rank
        assert np.array_equal(r, resids[rank]), rank


# --------------------------------------------------------- MoE EP paths
def test_moe_ep_paths_match_dense(spmd):
    """ep_alltoall (fsdp_tp, S 32) and ep_gather (tp, S 1) on a (2, 4)
    mesh within 1e-4 of the dense path (capacity 8, f32 wire: nothing
    drops); the EP aux within 1e-6 of the mean of the reference's
    ``_route`` aux over each shard's tokens."""
    from repro.models import moe as jmoe
    cfg, params, xs = _moe_setup()
    out = spmd["moe"]
    assert out["ep_alltoall"]["path"] == "ep_alltoall"
    assert out["ep_gather"]["path"] == "ep_gather"
    router = jnp.asarray(params["router"])
    for name, x, blocks in (("ep_alltoall", xs[0], (2, 4)),
                            ("ep_gather", xs[1], (2, 1))):
        r = out[name]
        err = float(np.max(np.abs(r["y"] - r["y_dense"])))
        assert err < 1e-4, (name, err)
        # each shard's tokens: batch over data (2), seq over model (4) for
        # ep_alltoall; ep_gather's model ranks repeat their data shard
        auxs = []
        for xb in np.split(x, blocks[0], axis=0):
            for xbs in np.split(xb, blocks[1], axis=1):
                _, _, a = jmoe._route(jnp.asarray(xbs.reshape(-1, x.shape[-1])),
                                      router, cfg)
                auxs.append(float(a))
        assert abs(r["aux"] - float(np.mean(auxs))) < 1e-6, (name, r["aux"],
                                                             auxs)


_REFERENCE_GRAD = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core.params import default_config
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.runtime.sharding import ShardingRules
d = np.load(sys.argv[1])
params = {k: jnp.asarray(d[k]) for k in ("router", "wg", "wu", "wd")}
x, cot = jnp.asarray(d["x"]), jnp.asarray(d["cot"])
from repro.configs import get_reduced
cfg = get_reduced("olmoe-1b-7b").replace(capacity_factor=8.0)
rt = default_config(compute_dtype="float32", comm_codec="float32")
mesh = make_mesh((2, 4), ("data", "model"))
rules = ShardingRules(mesh=mesh, strategy="tp")
assert moe._ep_paths_applicable(cfg, rules, x.shape[1]) == "ep_gather"
loss = lambda p, xx: jnp.sum(moe.moe_mlp(p, xx, cfg, rt, rules)[0] * cot)
with mesh:
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
np.savez(sys.argv[2], x=np.asarray(gx),
         **{k: np.asarray(v) for k, v in gp.items()})
"""


def test_moe_ep_gather_gradient_matches_reference(spmd, tmp_path):
    """The gradient of ep_gather (tp on (2, 4); a sequence of 3, which
    the model axis does not divide), w.r.t. the input, the router and
    the three expert weights, held within 1e-4 of the reference's
    ``jax.grad`` through its ``shard_map`` on 8 host devices (f32, an
    f32 wire, capacity 8: nothing drops).  The reference's gradient is
    its own dense gradient (factor 1: each model rank takes 1/ep of the
    cotangent of the output it holds whole, and the input's gradient
    sums the model ranks'), so the port's is held to the port's
    one-device dense gradient too, within 1e-4."""
    import os
    import subprocess
    import sys
    cfg, params, xs = _moe_setup()
    inp, res = tmp_path / "inputs.npz", tmp_path / "grads.npz"
    np.savez(inp, x=xs[2], cot=xs[3], **params)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": os.path.join(root, "src"),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    out = subprocess.run([sys.executable, "-c", _REFERENCE_GRAD, str(inp),
                          str(res)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(res)
    got = spmd["moe"]["ep_gather_grad"]
    assert got["path"] == "ep_gather"
    for k in ("x", "router", "wg", "wu", "wd"):
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(got["mesh"][k], want[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["mesh"][k], got["dense"][k],
                                   atol=1e-4, rtol=1e-4, err_msg=k)


# ------------------------------------------- checkpoints across meshes
def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(a, b), path


def test_checkpoint_across_meshes(spmd, tmp_path):
    """A checkpoint saved from an fsdp step's DTensor state on (4, 2) (8
    ranks, in the module's spawn) restores bit for bit on one device and
    on 4 ranks as (2, 2) (``elastic.restore_resharded``, a spawn of its
    own); a one-device checkpoint restores bit for bit on (2, 2) too."""
    from _torch_spmd_ranks import _ckpt_restore_ranks, _numpy
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.models.model import build_model as tbuild_model
    from repro_torch.optim.optimizers import constant_schedule, make_optimizer
    from repro_torch.runtime.stepfn import _meta_params
    sharded = spmd["ckpt_dir"]
    full, placements = spmd["ckpt"]
    assert "Shard" in placements
    from repro_torch.configs import get_reduced
    cfg = get_reduced("smollm-135m")
    meta = _meta_params(tbuild_model(cfg))
    opt = make_optimizer("adamw", constant_schedule(1e-3))
    target = {"params": meta, "opt": opt.init(meta)}
    one = ckpt.restore(sharded, 1, target, device="cpu")
    _leaves_equal(_numpy(one), full)
    # a one-device checkpoint of the same state, written by this process
    single = tmp_path / "single"
    ckpt.save(single, 1, one, extra={"step": 1})
    out = run_ranks(_ckpt_restore_ranks, 4, tmp_path,
                    [str(sharded), str(single)])
    for tree, pl in out:
        assert "Shard" in pl
        _leaves_equal(tree, full)
    assert ckpt.manifest_extra(sharded, 1) == {"step": 1}
    assert isinstance(one["params"]["final_norm"], torch.Tensor)
