"""The PyTorch port's knob space and configs equal the reference's, and
the port imports without jax and without the reference package."""
import dataclasses
import subprocess
import sys
import pathlib

import pytest

import repro.configs as ref_configs
import repro.core.params as ref_params
import repro.core.space as ref_space
import repro_torch.configs as port_configs
import repro_torch.core.params as port_params
import repro_torch.core.space as port_space

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = (None, "train", "prefill", "decode")
FAMILIES = (None, "dense", "vlm", "moe", "hybrid", "ssm", "encdec")


def test_space_names_and_order():
    assert port_space.SPACE.names() == ref_space.SPACE.names()
    assert len(port_space.SPACE) == len(ref_space.SPACE)


@pytest.mark.parametrize("name", ["DOMAINS", "SENSITIVITY_SWEEP",
                                  "COMPILE_KNOBS", "ANALYTIC_KNOBS",
                                  "KNOB_REACH", "PARAM_DOCS"])
def test_params_reexports_equal(name):
    assert getattr(port_params, name) == getattr(ref_params, name)


def test_knob_registry_equal_entry_by_entry():
    for a, b in zip(port_space.SPACE, ref_space.SPACE):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_default_config_and_field_order():
    a, b = port_params.default_config(), ref_params.default_config()
    assert a.as_dict() == b.as_dict()
    assert list(a.as_dict()) == list(b.as_dict())       # field order
    assert ([f.name for f in dataclasses.fields(port_params.TunableConfig)]
            == [f.name for f in dataclasses.fields(ref_params.TunableConfig)])
    assert port_params.exhaustive_size() == ref_params.exhaustive_size()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_compile_key_equal(kind, family):
    overrides = [
        {},
        dict(compute_dtype="bfloat16", remat_policy="none",
             remat_save_dtype="bfloat16", kv_cache_dtype="int8",
             donate_buffers=False, attn_impl="pallas"),
        dict(shard_strategy="fsdp", grad_comm_dtype="int8_ef",
             microbatches=4, comm_codec="float32",
             remat_save_dtype="bfloat16"),
    ]
    for kw in overrides:
        a = port_params.default_config(**kw).compile_key(kind, family)
        b = ref_params.default_config(**kw).compile_key(kind, family)
        assert a == b


@pytest.mark.parametrize("arch", ref_configs.list_archs())
def test_arch_configs_equal(arch):
    assert port_configs.list_archs() == ref_configs.list_archs()
    for get in ("get_config", "get_reduced"):
        a = getattr(port_configs, get)(arch)
        b = getattr(ref_configs, get)(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.hd == b.hd and a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()


def test_shapes_and_cells_equal():
    assert ({k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_configs.SHAPES.items()})
    assert port_configs.all_cells() == ref_configs.all_cells()


def test_port_imports_without_jax_or_reference():
    """Every module of the port, and chip_smoke, in a fresh interpreter:
    neither jax nor the reference package may end up imported."""
    code = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
pkg = root / "src" / "repro_torch"
mods = []
for p in sorted(pkg.rglob("*.py")):
    rel = p.relative_to(root / "src").with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    mods.append(".".join(parts))
mods.append("chip_smoke")
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert len(mods) > 30, mods
print("imported", len(mods))
"""
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    done = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "imported" in done.stdout


def test_unported_parts_raise():
    """Since slice 7 (multi-device) the model functions take sharding
    rules: the refusals are gone.  Since slice 9 (the dry run) a step
    for a mesh that no process holds builds too, over the fake process
    group: nothing of the reference is left unported."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import build_model
    from repro_torch.models import layers, moe
    from repro_torch.runtime import stepfn
    from repro_torch.runtime.sharding import ShardingRules
    # every family builds (the ssm and encdec families since slice 5b)
    for arch in ("xlstm-1.3b", "seamless-m4t-medium"):
        build_model(port_configs.get_reduced(arch))
    assert not hasattr(layers, "require_no_rules")
    assert not hasattr(stepfn, "require_one_device")
    cfg = port_configs.get_reduced("olmoe-1b-7b")
    # the expert-parallel paths where the reference takes them
    for shape, S, path in (((1, 1), 32, None), ((2, 4), 32, "ep_alltoall"),
                           ((2, 4), 1, "ep_gather"), ((8, 1), 32, None)):
        rules = ShardingRules(AbstractMesh(shape, ("data", "model")), "tp")
        assert moe._ep_paths_applicable(cfg, rules, S) == path
    from _torch_fake_group import released
    with released():
        bundle = stepfn.build_step(cfg, ShapeConfig("t", 64, 8, "train"),
                                   default_config(), {"data": 4, "model": 2})
        assert tuple(bundle.rules.mesh.shape) == (4, 2)
        assert bundle.notes["explicit_comm"] is False    # moe: auto path
    # a mesh of one device is the one-device step, with its notes
    bundle = stepfn.build_step(cfg, ShapeConfig("t", 64, 8, "train"),
                               default_config(), AbstractMesh((1, 1), (
                                   "data", "model")))
    assert bundle.rules is None and "one_device_no_ops" in bundle.notes


def test_multi_device_modules_import_without_jax_or_reference():
    """The multi-device modules in a fresh interpreter: neither jax nor
    the reference package is loaded, and importing them starts no
    process group."""
    code = r"""
import importlib, pathlib, sys
sys.path[:0] = [str(pathlib.Path(sys.argv[1]) / "src")]
for m in ("repro_torch.launch.mesh", "repro_torch.runtime.sharding",
          "repro_torch.runtime.gradsync", "repro_torch.ft.elastic"):
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
import torch.distributed as dist
assert not dist.is_initialized()
print("clean")
"""
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    done = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "clean" in done.stdout


def test_entry_points_default_to_cuda_and_raise_without_it():
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.serving.scheduler import BatchScheduler
    if torch.cuda.is_available():        # decided inside the test:
        return                           # nothing to refuse on such a host
    cfg = port_configs.get_reduced("smollm-135m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchScheduler(cfg, port_params.default_config(), params)
