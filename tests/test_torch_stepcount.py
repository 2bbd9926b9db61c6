"""The step counter (``repro_torch.core.stepcount``) on one device
against XLA's ``cost_analysis`` of the reference's same reduced step
(unrolled, eager attention, f32): prefill and train FLOPs within
0.9–1.2 for every family; the flop counter prices products only, so a
decode step is held to the analytic count of its products.  Its peak
against XLA's argument + temp bytes: 0.5–2x."""
from __future__ import annotations

import pytest

import repro.configs as ref_configs
import repro.core.costmodel as ref_cm
import repro.core.params as ref_params
import repro_torch.configs as port_configs
import repro_torch.core.params as port_params

FAMILIES = ("smollm-135m", "olmoe-1b-7b", "zamba2-7b", "xlstm-1.3b",
            "seamless-m4t-medium", "llava-next-34b")
B = 2
# xlstm at S 64: the reference's sLSTM scan and the loop that
# test_slstm_loop_counts_as_its_step_at_once counts go token by token
SEQ = {"xlstm-1.3b": 64}


def _seq(arch) -> int:
    return SEQ.get(arch, 128)


def _reference_count(arch, kind):
    """(flops, argument + temp bytes) of the reference's reduced step on a
    (1, 1) mesh, unrolled, eager attention, f32."""
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.mesh import make_mesh
    from repro.runtime.stepfn import build_step
    mesh = make_mesh((1, 1), ("data", "model"))
    rt = ref_params.default_config(attn_impl="xla", unroll_layers=True)
    bundle = build_step(ref_configs.get_reduced(arch),
                        RefShape("t", _seq(arch), B, kind), rt, mesh)
    with mesh:
        compiled = bundle.lower().compile()
    ma = compiled.memory_analysis()
    return (float(ref_cm.cost_analysis_dict(compiled)["flops"]),
            float(ma.argument_size_in_bytes + ma.temp_size_in_bytes))


def _port_count(arch, kind, cfg=None):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import stepcount
    from repro_torch.runtime.stepfn import build_step
    rt = port_params.default_config(attn_impl="xla", unroll_layers=True)
    cfg = cfg or port_configs.get_reduced(arch)
    return stepcount.count(build_step(
        cfg, ShapeConfig("t", _seq(arch), B, kind), rt, None))


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_step_against_xla(arch, kind):
    """FLOPs: prefill and train within 0.9–1.2 of XLA's count (XLA also
    counts elementwise ops; the flop counter prices products only).
    Peak bytes: within 0.5–2x of XLA's argument + temp bytes, except
    the MoE FFN's prefill and train, where the reference gathers each
    (token, slot)'s expert weights, a (T, d, ff) tensor per weight, that
    the port's sorted FFN never makes: there the port's peak is below the
    reference's (ROADMAP queue C; the ratios are in PERF.md)."""
    got = _port_count(arch, kind)
    flops, peak = _reference_count(arch, kind)
    if kind != "decode":
        assert 0.9 <= got.flops / flops <= 1.2, got.flops / flops
    if arch == "olmoe-1b-7b" and kind != "decode":
        assert got.argument_bytes < got.peak_bytes < peak, \
            got.peak_bytes / peak
    else:
        assert 0.5 <= got.peak_bytes / peak <= 2.0, got.peak_bytes / peak
    assert got.argument_bytes <= got.peak_bytes


def test_decode_flops_are_its_products():
    """A one-token decode step does almost nothing but elementwise work
    beside its products, which XLA counts and the flop counter does not
    (it reads about half of XLA's count): its count is held to the
    products themselves.  The dense family at position 0 against a cache
    of S rows, eager attention over every row: per layer the q, k, v, o
    and three MLP projections, QK^T and PV, then the unembedding."""
    cfg = port_configs.get_reduced("smollm-135m")
    got = _port_count("smollm-135m", "decode")
    d, hd, H, K = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = d * H * hd * 2 + d * K * hd * 2 + 3 * d * cfg.d_ff
    attn = 2 * H * hd * _seq("smollm-135m")
    want = 2 * B * (cfg.n_layers * (proj + attn) + d * cfg.vocab)
    assert got.flops == want
    assert got.collectives == []



@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_loop_counts_as_its_step_at_once(kind, monkeypatch):
    """The sLSTM's loop over the tokens is counted as its step run once
    on each block of them: against the count of the loop itself (reduced
    xlstm-1.3b, B 2, S 64), the same FLOPs and arguments, the bytes and
    the peak within 1e-2."""
    import contextlib

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import stepcount
    from repro_torch.models import xlstm
    from repro_torch.runtime.stepfn import build_step
    cfg = port_configs.get_reduced("xlstm-1.3b")
    rt = port_params.default_config(attn_impl="xla", unroll_layers=True)
    bundle = build_step(cfg, ShapeConfig("t", _seq("xlstm-1.3b"), B, kind),
                        rt, None)
    loop = xlstm._slstm_scan
    at_once = stepcount.count(bundle)
    assert xlstm._slstm_scan is loop
    monkeypatch.setattr(stepcount, "_token_loops_at_once",
                        contextlib.nullcontext)
    looped = stepcount.count(bundle)
    assert at_once.flops == looped.flops
    assert at_once.argument_bytes == looped.argument_bytes
    assert at_once.bytes == pytest.approx(looped.bytes, rel=1e-2)
    assert at_once.peak_bytes == pytest.approx(looped.peak_bytes, rel=1e-2)
