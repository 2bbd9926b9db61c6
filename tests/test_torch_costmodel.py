"""The port's cost model (``repro_torch.core.costmodel``) against the
reference's (``repro.core.costmodel``).

* The analytic half is the reference's arithmetic: every copied function
  gives bit-identical output over the ten archs x four shapes x a set of
  ``TunableConfig`` variants x (data, model) sizes (16, 16) and (32, 16).
* ``HW`` is the H100's table, the one ``chip_smoke.py`` reads.
* ``collective_seconds``: the ring factors, the latency and the topology
  rule under one injected table.
* ``RooflineEvaluator._compile_id`` keys are the reference's, byte for
  byte.
"""
from __future__ import annotations

import dataclasses
import types

import pytest

import repro.configs as ref_configs
import repro.core.costmodel as ref_cm
import repro.core.params as ref_params
import repro_torch.configs as port_configs
import repro_torch.core.costmodel as port_cm
import repro_torch.core.params as port_params

ARCHS = port_configs.list_archs()
SHAPES = list(port_configs.SHAPES)
SIZES = ((16, 16), (32, 16))
VARIANTS = (
    {},
    {"attn_impl": "pallas", "attn_block_q": 512, "remat_policy": "none"},
    {"attn_impl": "pallas", "compute_dtype": "bfloat16",
     "remat_policy": "full", "microbatches": 4},
    {"compute_dtype": "bfloat16", "kv_cache_dtype": "int8",
     "donate_buffers": False, "remat_save_dtype": "bfloat16"},
    {"seq_parallel": True, "kv_cache_dtype": "float32",
     "attn_tp_fallback": "batch_shard", "microbatches": 2},
    {"attn_impl": "pallas", "attn_block_q": 256, "remat_policy": "dots",
     "donate_buffers": False, "seq_parallel": True},
)


def _same(a, b) -> bool:
    """Equal to the last bit (floats by their hex form), recursively."""
    if isinstance(a, float) or isinstance(b, float):
        return type(a) is type(b) and (a == b or a != a and b != b) \
            and float(a).hex() == float(b).hex()
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("shape_id", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_are_the_references_to_the_bit(arch, shape_id):
    pc, rc = port_configs.get_config(arch), ref_configs.get_config(arch)
    ps, rs = port_configs.get_shape(shape_id), ref_configs.get_shape(shape_id)
    assert _same(port_cm.attention_applications(pc, ps),
                 ref_cm.attention_applications(rc, rs))
    assert _same(port_cm.model_flops(pc, ps), ref_cm.model_flops(rc, rs))
    assert _same(port_cm._layer_width(pc), ref_cm._layer_width(rc))
    (p_pts, p_units), (r_pts, r_units) = (port_cm.calibration_points(pc),
                                          ref_cm.calibration_points(rc))
    assert _same(p_units, r_units)
    assert [(dataclasses.asdict(c), u) for c, u in p_pts] == \
        [(dataclasses.asdict(c), u) for c, u in r_pts]
    for kw in VARIANTS:
        prt = port_params.default_config(**kw)
        rrt = ref_params.default_config(**kw)
        for d, m in SIZES:
            args_p, args_r = (pc, ps, prt, d, m), (rc, rs, rrt, d, m)
            for name in ("analytic_memory_bytes", "flash_refetch_bytes",
                         "flash_memory_correction_bytes",
                         "flash_peak_correction_bytes"):
                got = getattr(port_cm, name)(*args_p)
                want = getattr(ref_cm, name)(*args_r)
                assert _same(got, want), (name, kw, d, m, got, want)
            assert _same(port_cm.attention_shards(pc, prt, d, m),
                         ref_cm.attention_shards(rc, rrt, d, m))


ROOFS = (
    dict(compute_s=0.5, memory_s=0.25, collective_s=0.125,
         flops_per_chip=3.3e14, bytes_per_chip=8.1e11,
         collective_bytes=2.0e9,
         coll_summary={"all-reduce": {"count": 3, "bytes": 1.5e9}},
         peak_mem_bytes=6.0e10),
    dict(compute_s=0.1, memory_s=0.7, collective_s=0.7,
         flops_per_chip=1.0, bytes_per_chip=2.0, collective_bytes=0.0,
         coll_summary={}, peak_mem_bytes=None),
    dict(compute_s=1e-6, memory_s=1e-7, collective_s=3e-3,
         flops_per_chip=7.0, bytes_per_chip=0.0, collective_bytes=9.5e6,
         coll_summary={"all-gather": {"count": 2, "bytes": 9.0e6},
                       "all-to-all": {"count": 1, "bytes": 5.0e5}},
         peak_mem_bytes=1.0),
)


@pytest.mark.parametrize("i", range(len(ROOFS)))
def test_roofline_arithmetic_is_the_references_to_the_bit(i):
    kw, other = ROOFS[i], ROOFS[(i + 1) % len(ROOFS)]
    p1, r1 = port_cm.Roofline(**kw), ref_cm.Roofline(**kw)
    assert _same(p1.as_dict(), r1.as_dict())
    assert p1.total_s == r1.total_s and p1.bottleneck == r1.bottleneck
    assert _same(port_cm.roofline_from_dict(p1.as_dict()).as_dict(),
                 ref_cm.roofline_from_dict(r1.as_dict()).as_dict())
    p3, r3 = port_cm.Roofline(**other), ref_cm.Roofline(**other)
    for units in (1.0, 3.0, 7.5, 48.0, 61.0):
        assert _same(port_cm.extrapolate_roofline(p1, p3, units).as_dict(),
                     ref_cm.extrapolate_roofline(r1, r3, units).as_dict())
        for v1, v3 in ((1.0, 3.0), (10.0, 8.0), (0.3, 0.7),
                       (kw["compute_s"], other["compute_s"])):
            assert _same(port_cm.extrapolate(v1, v3, units),
                         ref_cm.extrapolate(v1, v3, units))
    ops = [("all-reduce", 4096, 16, "f32"), ("all-gather", 1 << 20, 8, "bf16"),
           ("reduce-scatter", 77, 2, "f32"), ("all-reduce", 12, 1, "s32")]
    ps = port_cm.CollectiveStats([port_cm.CollectiveOp(*o) for o in ops])
    rs = ref_cm.CollectiveStats([ref_cm.CollectiveOp(*o) for o in ops])
    assert _same(ps.summary(), rs.summary())
    assert ps.total_bytes() == rs.total_bytes()


def test_hw_is_the_h100_table_chip_smoke_reads():
    """One table: ``core/card.py``.  The kernel bounds of chip_smoke.py
    read the same figures, and none of the reference's v5e figures is
    carried."""
    import chip_smoke
    from repro_torch.core import card
    hw = port_cm.HW
    assert hw["flops_bf16"] == card.FLOPS_BF16 == 989e12
    assert hw["flops_f32"] == card.FLOPS_F32 == 67e12
    assert hw["hbm_bw"] == card.HBM_BYTES_PER_S == 3.35e12
    assert hw["hbm_per_chip"] == card.HBM_BYTES == 80e9
    assert hw["node_size"] == 8 and hw["link_bw"] > hw["net_bw"] > 0
    assert chip_smoke.MEM_BYTES_PER_S == hw["hbm_bw"]
    assert chip_smoke.PEAK_OPS == {"bf16": 989e12, "tf32x3": 495e12 / 3,
                                   "f32": 67e12}
    assert chip_smoke.PEAK_OPS["bf16"] == hw["flops_bf16"]
    assert chip_smoke.PEAK_OPS["f32"] == hw["flops_f32"]
    for key in ("flops_bf16", "flops_f32", "hbm_bw", "hbm_per_chip"):
        assert hw[key] != ref_cm.HW[key]


@pytest.mark.parametrize("kind, g, node_local, factor", [
    ("all-reduce", 16, False, 2 * 15 / 16),
    ("all-reduce", 4, None, 2 * 3 / 4),        # <= node_size: in a node
    ("all-gather", 8, True, 7 / 8),
    ("reduce-scatter", 16, None, 15 / 16),     # wider than a node
    ("all-to-all", 2, False, 1 / 2),           # a pod pair, across nodes
    ("collective-permute", 4, True, 1.0),
])
def test_collective_seconds_ring_latency_and_topology(kind, g, node_local,
                                                      factor):
    hw = dict(port_cm.HW, link_bw=400.0, net_bw=50.0, coll_latency=0.25,
              node_size=8)
    op = port_cm.CollectiveOp(kind, 1000, g, "bf16", node_local=node_local)
    local = node_local if node_local is not None else g <= 8
    bw = 400.0 if local else 50.0
    want = factor * 1000 / bw + 0.25
    assert port_cm.collective_seconds(port_cm.CollectiveStats([op]), hw) \
        == pytest.approx(want, rel=1e-12)
    # a group of one moves nothing and costs nothing; ops add up
    one = port_cm.CollectiveOp(kind, 1000, 1, "bf16")
    assert port_cm.collective_seconds(
        port_cm.CollectiveStats([op, one, op]), hw) == \
        pytest.approx(2 * want, rel=1e-12)
    # no halving of f32 reductions under bf16 compute (the reference's
    # undid an XLA-CPU rewrite the port does not have)
    f32 = port_cm.CollectiveOp(kind, 1000, g, "f32", node_local=node_local)
    assert port_cm.collective_seconds(port_cm.CollectiveStats([f32]), hw) \
        == port_cm.collective_seconds(port_cm.CollectiveStats([op]), hw)


@pytest.mark.parametrize("sizes", [(("data", 16), ("model", 16)),
                                   (("pod", 2), ("data", 16), ("model", 16)),
                                   (("data", 4), ("model", 2))])
def test_compile_ids_are_the_references(sizes):
    """The calibration keys name the same programs in both packages."""
    import collections

    from repro.core.trial import RooflineEvaluator as RefEv, \
        Workload as RefWl
    from repro_torch.core.trial import RooflineEvaluator, Workload
    from repro_torch.launch.mesh import AbstractMesh
    ref_mesh = types.SimpleNamespace(shape=collections.OrderedDict(sizes))
    mesh = AbstractMesh(tuple(s for _, s in sizes),
                        tuple(a for a, _ in sizes))
    ref_ev, ev = RefEv(use_cache=False), RooflineEvaluator(use_cache=False)
    mp = len(sizes) == 3
    for arch, shape in (("smollm-135m", "train_4k"),
                        ("olmoe-1b-7b", "prefill_32k"),
                        ("xlstm-1.3b", "long_500k"),
                        ("seamless-m4t-medium", "decode_32k")):
        for kw in VARIANTS[:4]:
            for units, unroll in ((1, True), (3, True), (1, False)):
                rt = port_params.default_config(**kw).replace(
                    unroll_layers=unroll, attn_impl="xla")
                rrt = ref_params.default_config(**kw).replace(
                    unroll_layers=unroll, attn_impl="xla")
                assert ev._compile_id(Workload(arch, shape, mp), mesh,
                                      units, rt) == \
                    ref_ev._compile_id(RefWl(arch, shape, mp), ref_mesh,
                                       units, rrt)


# one family each: dense, hybrid, encdec, ssm (no attention)
ARCHS_FOR_FLASH = ["smollm-135m", "zamba2-7b", "seamless-m4t-medium",
                   "xlstm-1.3b"]


@pytest.mark.parametrize("arch", ARCHS_FOR_FLASH)
def test_flash_kernel_flops_are_the_causal_half(arch):
    """The port's own term: the S x S products of the causal
    self-attention that the flash kernel runs, eager (the whole square)
    and as the kernel computes them (on and below the diagonal); only a
    prefill step on the kernel path has any."""
    cfg = port_configs.get_config(arch)
    shape = port_configs.get_shape("prefill_32k")
    rt = port_params.default_config(attn_impl="pallas")
    for other in (rt.replace(attn_impl="xla"),):
        assert port_cm.flash_kernel_flops(cfg, shape, other, 16, 16) == \
            (0.0, 0.0)
    for sid in ("train_4k", "decode_32k"):
        assert port_cm.flash_kernel_flops(
            cfg, port_configs.get_shape(sid), rt, 16, 16) == (0.0, 0.0)
    eager, kernel = port_cm.flash_kernel_flops(cfg, shape, rt, 16, 16)
    apps = port_cm.attention_applications(cfg, shape)
    if cfg.family == "encdec":
        apps = apps[1:2]                 # the decoder's self-attention
    S, B = shape.seq_len, shape.global_batch
    shards = port_cm.attention_shards(cfg, rt, 16, 16)
    want = sum(4.0 * n * B * cfg.n_heads * sq * skv * cfg.hd
               for n, sq, skv in apps) / shards
    assert eager == pytest.approx(want, rel=1e-12)
    assert kernel == pytest.approx(eager * (S + 1) / (2 * S), rel=1e-12)
    assert (eager > 0) == (cfg.family != "ssm")


@pytest.mark.parametrize("arch", ARCHS_FOR_FLASH)
def test_port_memory_prices_the_flash_kernel_by_its_own_reads(arch):
    """The port's memory term: the eager path's analytic bytes, with the
    causal self-attention that the flash kernel runs priced at its K/V
    read once in place of the (S, S) squares; the same as the
    reference's ``analytic_memory_bytes`` of the eager path wherever the
    kernel does not run, and moved by no tile knob."""
    cfg = port_configs.get_config(arch)
    rt = port_params.default_config(attn_impl="pallas")
    for sid in ("train_4k", "decode_32k", "prefill_32k"):
        shape = port_configs.get_shape(sid)
        eager_rt = rt.replace(attn_impl="xla")
        assert port_cm.port_memory_bytes(cfg, shape, eager_rt, 16, 16) == \
            port_cm.analytic_memory_bytes(cfg, shape, eager_rt, 16, 16)
        if sid != "prefill_32k":
            assert port_cm.port_memory_bytes(cfg, shape, rt, 16, 16) == \
                port_cm.analytic_memory_bytes(cfg, shape, eager_rt, 16, 16)
    shape = port_configs.get_shape("prefill_32k")
    got = port_cm.port_memory_bytes(cfg, shape, rt, 16, 16)
    for bq in (128, 256, 512):
        assert port_cm.port_memory_bytes(
            cfg, shape, rt.replace(attn_block_q=bq), 16, 16) == got
    eager, kernel = port_cm.flash_kernel_bytes(cfg, shape, rt, 16, 16)
    apps = port_cm.attention_applications(cfg, shape)
    if cfg.family == "encdec":
        apps = apps[1:2]                 # the decoder's self-attention
    B, shards = shape.global_batch, port_cm.attention_shards(cfg, rt, 16, 16)
    comp_b = 4 if rt.compute_dtype == "float32" else 2
    assert kernel == pytest.approx(sum(
        2.0 * n * B * cfg.n_heads * skv * cfg.hd * comp_b
        for n, sq, skv in apps) / shards, rel=1e-12)
    assert got == pytest.approx(port_cm.analytic_memory_bytes(
        cfg, shape, rt.replace(attn_impl="xla"), 16, 16) - eager + kernel,
        rel=1e-12)
    assert (got < port_cm.analytic_memory_bytes(
        cfg, shape, rt.replace(attn_impl="xla"), 16, 16)) == \
        (cfg.family != "ssm")
