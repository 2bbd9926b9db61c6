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
    from repro_torch.models.model import build_model
    from repro_torch.models import layers, transformer, zamba
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(port_configs.get_reduced("xlstm-1.3b"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(port_configs.get_reduced("olmoe-1b-7b"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.loss_fn(None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zamba.loss_fn(None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.require_no_rules(object())


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
