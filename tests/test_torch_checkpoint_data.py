"""The port's checkpoints and data pipeline: the cases of
tests/test_checkpoint_data.py that need no mesh, pointed at the port,
plus the cross-package round trip (a checkpoint written by either
package restores in the other, leaf for leaf) and SyntheticLM's tokens
bit for bit against the reference's."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.params import default_config as jdefault
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models.model import build_model as jbuild
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.core.params import default_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.runtime.loops import tree_leaves, tree_map


def _tree(seed: int):
    """The reference test's seeded pytree: 1-5 keys, f32/i32 leaves of
    rank 0-3 (dims 1-5), some nested; as tensors."""
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(rng.randint(1, 6)):
        kind = ["f32", "i32", "nested"][rng.randint(3)]
        shp = tuple(rng.randint(1, 6, size=rng.randint(0, 4)))
        if kind == "nested":
            out[f"k{i}"] = {"a": torch.ones(shp, dtype=torch.float32),
                            "b": torch.zeros((), dtype=torch.int32)}
        else:
            arr = rng.standard_normal(shp).astype(
                np.float32 if kind == "f32" else np.int32)
            out[f"k{i}"] = torch.from_numpy(np.asarray(arr))
    return out


@pytest.mark.parametrize("seed,step", [(s, s * 9973 % 10**6)
                                       for s in range(20)])
def test_checkpoint_roundtrip_identity(tmp_path_factory, seed, step):
    tree = _tree(seed)
    d = tmp_path_factory.mktemp("ck")
    ckpt.save(d, step, tree, extra={"step": step})
    restored = ckpt.restore(d, step, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ckpt.manifest_extra(d, step)["step"] == step


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=1, keep=2)
    tree = {"w": torch.arange(4.0)}
    for s in range(5):
        mgr.maybe_save(s, tree_map(lambda x: x + s, tree))
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1])
                   for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]
    assert mgr.latest_step() == 4
    restored, s = mgr.restore_latest(tree)
    assert s == 4
    assert torch.equal(restored["w"], torch.arange(4.0) + 4)


def test_checkpoint_tree_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 0, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, 0, {"b": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 0, {"a": torch.ones(4)})


def test_no_partial_checkpoint_visible(tmp_path):
    """Atomicity: only committed step_* dirs exist after save."""
    ckpt.save(tmp_path, 7, {"a": torch.ones(3)})
    names = [p.name for p in pathlib.Path(tmp_path).iterdir()]
    assert names == ["step_00000007"]


def test_bf16_leaves_round_trip(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    ckpt.save(tmp_path, 1, {"w": x})
    meta = json.loads((tmp_path / "step_00000001" / "manifest.json")
                      .read_text())["leaves"]["w"]
    assert meta["dtype"] == "bfloat16"
    back = ckpt.restore(tmp_path, 1, {"w": x})["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


def _model_state(seed=0):
    """A reference model's parameters and AdamW state, and the port's
    copy of them (launch/train.py's checkpoint tree)."""
    jcfg = jget_reduced("smollm-135m")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    jo = jmake_optimizer("adamw").init(jp)
    jo = jax.tree.map(lambda x: x + 0.5 if x.dtype == jnp.float32 else x + 3,
                      jo)
    jtree = {"params": jp, "opt": jo}
    return jtree, from_jax_params(jax.tree.map(np.asarray, jtree))


def _same(ttree, jtree):
    flat_t = ckpt._flatten(ttree)
    flat_j = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jtree)[0]}
    assert set(flat_t) == set(flat_j)
    for k, leaf in flat_j.items():
        a = np.asarray(leaf)
        b = flat_t[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _model_state()
    jckpt.save(tmp_path, 5, jtree, extra={"step": 5})
    target = tree_map(lambda t: torch.empty_like(t), ttree)
    restored = ckpt.restore(tmp_path, 5, target)
    _same(restored, jtree)
    assert ckpt.manifest_extra(tmp_path, 5) == {"step": 5}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree = _model_state(1)
    ckpt.save(tmp_path, 9, ttree, extra={"step": 9})
    target = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jtree)
    restored = jckpt.restore(tmp_path, 9, target)
    _same(ttree, restored)
    # the same files and manifest the reference writes
    jckpt.save(tmp_path / "ref", 9, jtree, extra={"step": 9})
    mine = json.loads((tmp_path / "step_00000009" / "manifest.json")
                      .read_text())
    theirs = json.loads((tmp_path / "ref" / "step_00000009" /
                         "manifest.json").read_text())
    assert mine == theirs


# ---------------------------------------------------------------- data
def _source(seed=0):
    cfg = get_reduced("smollm-135m")
    shape = ShapeConfig("t", 32, 4, "train")
    return SyntheticLM(cfg, shape, default_config(), "cpu", seed=seed)


def test_data_deterministic_and_restart_exact():
    s1, s2 = _source(), _source()
    b_a = s1.batch_at(5)
    b_b = s2.batch_at(5)          # fresh instance, same step -> same batch
    assert torch.equal(b_a["tokens"], b_b["tokens"])
    # labels are next-token shifted
    full, lab = b_a["tokens"], b_a["labels"]
    assert (lab[:, :-1] == full[:, 1:]).all()
    assert full.dtype == torch.int32 and full.device.type == "cpu"


def test_data_steps_differ_and_seeds_differ():
    s = _source()
    t5 = s.batch_at(5)["tokens"]
    t6 = s.batch_at(6)["tokens"]
    assert (t5 != t6).any()
    t5b = _source(seed=1).batch_at(5)["tokens"]
    assert (t5 != t5b).any()


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 17), (11, 2)])
def test_tokens_bit_identical_to_the_reference(seed, step):
    jcfg = jget_reduced("smollm-135m")
    jsrc = JSyntheticLM(jcfg, JShape("t", 32, 4, "train"), jdefault(),
                        make_host_mesh(), seed=seed)
    want = jsrc.batch_at(step)
    got = _source(seed).batch_at(step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(np.asarray(want[k]),
                                      got[k].numpy())


def test_prefetcher_order_and_stop():
    s = _source()
    pf = Prefetcher(s, start_step=3, depth=2)
    steps = []
    for _ in range(3):
        step, batch = next(pf)
        steps.append(step)
        assert torch.equal(batch["tokens"], s.batch_at(step)["tokens"])
    pf.stop()
    assert steps == [3, 4, 5]
