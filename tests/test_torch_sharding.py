"""The port's sharding rules and elastic mesh arithmetic held against the
reference's, with no processes: every case of
``tests/test_sharding_rules.py`` (the 80 seeded parameter cases, the
activation cases, every full arch at 16x16 under tp and fsdp_tp, the
multi-pod case) gives the same specs, as tuples, and the same notes, in
both packages; ``remesh`` and ``survivors_mesh`` give the reference's
shapes.  The reference's side uses the fake single-device mesh its own
test builds; the port's an ``AbstractMesh`` of the same axis sizes."""
import numpy as np
import pytest

import jax

import test_sharding_rules as ref_cases
from repro.configs import get_config, list_archs
from repro.ft import elastic as jelastic
from repro.models.model import build_model as jbuild
from repro.runtime.sharding import ShardingRules as JRules

from repro_torch.configs import get_config as tget_config
from repro_torch.ft import elastic as telastic
from repro_torch.launch.mesh import AbstractMesh, host_mesh_shape
from repro_torch.models.model import build_model as tbuild
from repro_torch.runtime import sharding as tsh


def _both(strategy, shape=(4, 2), axes=("data", "model"), **kw):
    j = JRules(mesh=ref_cases.fake_mesh(shape, axes), strategy=strategy,
               **kw)
    t = tsh.ShardingRules(mesh=AbstractMesh(shape, axes),
                          strategy=strategy, **kw)
    return j, t


def test_param_logical_names_match():
    from repro.runtime.sharding import PARAM_LOGICAL
    assert tsh.PARAM_LOGICAL == PARAM_LOGICAL


@pytest.mark.parametrize("strategy,logical,shape", ref_cases._param_cases())
def test_param_spec_matches_reference(strategy, logical, shape):
    j, t = _both(strategy)
    assert t.param_spec(logical, shape) == tuple(j.param_spec(logical,
                                                              shape))
    assert t.notes == j.notes


@pytest.mark.parametrize("strategy", ref_cases.STRATEGIES)
@pytest.mark.parametrize("batch", [1, 2, 4, 8, 9, 64])
def test_act_spec_matches_reference(strategy, batch):
    j, t = _both(strategy)
    lg, shp = ("batch", None, "heads"), (batch, 16, 8)
    assert t.act_spec(lg, shp) == tuple(j.act_spec(lg, shp))
    for lg2 in [("batch", "seq_model", None), ("batch", "seq_data", "mlp"),
                ("batch", None, "kv_heads"), ("batch", "vocab", "expert")]:
        assert t.act_spec(lg2, shp) == tuple(j.act_spec(lg2, shp))
    for fallback in ("replicate", "batch_shard"):
        jb, tb = _both(strategy, attn_tp_fallback=fallback)
        jspec = jb.attn_batch_spec(batch)
        assert tb.attn_batch_spec(batch) == (
            None if jspec is None else tuple(jspec))
        assert tb.notes == jb.notes
    assert t.notes == j.notes


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("strategy", ["fsdp_tp", "tp"])
def test_full_arch_param_specs_match_on_production_mesh(arch, strategy):
    jcfg, tcfg = get_config(arch), tget_config(arch)
    j, t = _both(strategy, (16, 16), fsdp_axes=jcfg.fsdp_axes)
    jspecs = jax.tree.map(
        lambda lg, sd: tuple(j.param_spec(lg, sd.shape)),
        jbuild(jcfg).logical(), jbuild(jcfg).param_shapes(),
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    tm = tbuild(tcfg)
    tspecs = t.param_sharding_tree(tm.logical(), tm.param_shapes())
    assert tspecs == jspecs
    # jax.tree.map walks dicts in key order, the port in insertion order
    assert sorted(t.notes) == sorted(j.notes)


def test_multipod_pod_axis_in_batch():
    kw = dict(fsdp_axes=("data", "pod"))
    j, t = _both("fsdp_tp", (2, 4, 2), ("pod", "data", "model"), **kw)
    assert t.act_spec(("batch", None), (16, 8)) == (("pod", "data"), None) \
        == tuple(j.act_spec(("batch", None), (16, 8)))
    assert t.param_spec(("embed", "mlp"), (64, 32)) == \
        tuple(j.param_spec(("embed", "mlp"), (64, 32)))
    assert t.batch_axes == j.batch_axes
    assert t.data_axis_size() == j.data_axis_size() == 8
    assert t.model_axis_size() == j.model_axis_size() == 2
    assert t.notes == j.notes


def _jshape(mesh):
    return tuple(int(v) for v in mesh.devices.shape)


def _tshape(mesh):
    return tuple(mesh.shape.values())


def test_remesh_and_survivors_match_reference():
    devs = jax.devices() * 16
    for model in (1, 2, 4, 8):
        for n in range(1, 17):
            jm = jelastic.remesh(n, model, devices=devs)
            tm = telastic.remesh(n, model, devices=16)
            assert _tshape(tm) == _jshape(jm), (n, model)
            assert tm.axis_names == ("data", "model")
            old = ref_cases.fake_mesh(_jshape(jm), ("data", "model"))
            for lost in range(int(np.prod(_jshape(jm)))):
                jn, jsize = jelastic.survivors_mesh(old, lost)
                tn, tsize = telastic.survivors_mesh(tm, lost)
                assert (_tshape(tn), tsize) == (_jshape(jn), jsize), \
                    (n, model, lost)
    with pytest.raises(ValueError):
        telastic.remesh(17, 2, devices=16)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 256])
def test_host_mesh_factors_like_reference(n):
    model = 1
    for cand in (16, 8, 4, 2):
        if n % cand == 0 and n >= cand:
            model = cand
            break
    assert host_mesh_shape(n) == (n // model, model)
    assert host_mesh_shape(n, 1) == (n, 1)
