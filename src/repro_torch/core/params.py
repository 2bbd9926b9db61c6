"""The tunable-parameter space — the analogue of the paper's Sec. 3.

This is the PyTorch port's own copy of the reference package's
``core/params.py``: knob names, domains and field order are identical,
so configs and history rows are interchangeable between the packages.
Read ``attn_impl="xla"`` as "eager torch ops" and ``"pallas"`` as
"hand-written CUDA kernel" here.

Each field of :class:`TunableConfig` maps 1:1 to one of the 12 Spark
parameters the paper tunes (the two memoryFraction parameters are one
*joint* knob, exactly as the paper tunes them: "shuffle/storage
.memoryFraction = 0.4/0.4").

Every per-knob fact — domain, default, Spark analogue, sensitivity
sweep values, compile-vs-analytic reach class and its evidence — is
declared exactly once in :data:`repro.core.space.SPACE`; the historical
module-level names below (``DOMAINS``, ``SENSITIVITY_SWEEP``,
``PARAM_DOCS``, ``COMPILE_KNOBS``/``ANALYTIC_KNOBS``, ``KNOB_REACH``)
are thin re-exports derived from that registry so existing imports keep
working (tests/test_space.py pins them against the registry).

The tuner strategies (core/strategy.py) treat the step function as a
black box and only ever edit these fields; the runtime
(runtime/stepfn.py) consumes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.core.space import SPACE

# value domains per tunable knob (first entry = Spark-like default)
DOMAINS: Dict[str, Tuple[Any, ...]] = SPACE.domains()

# ------------------------------------------------------- knob partition
# Which TunableConfig fields can change the lowered/compiled HLO of a
# step function, vs. which only ever enter the ANALYTIC roofline terms.
# The RooflineEvaluator's calibration compiles force attn_impl="xla"
# (core/trial.py), and the Pallas VMEM tile sizes exist only inside the
# Pallas kernel — so those three knobs never reach the compiled program
# and a sweep over them can reuse a single compile.  The tuple order is
# load-bearing (it fixes the compile_key layout, hence the disk
# compile-cache keys) and comes from the registry's registration order.
COMPILE_KNOBS: Tuple[str, ...] = SPACE.compile_knobs()
ANALYTIC_KNOBS: Tuple[str, ...] = SPACE.analytic_knobs()

# Where each knob actually reaches the step function.  Broader than the
# pre-registry re-export: every knob now carries an evidence line (the
# registry enforces it), not just the eight compile knobs that
# compile_key() conditionally canonicalizes — those eight are still the
# evidence for the canonicalizations below.
KNOB_REACH: Dict[str, str] = SPACE.reach_evidence()

# Spark parameter <-> knob documentation (DESIGN.md §2.1, Table 2 rows)
PARAM_DOCS: Dict[str, str] = SPACE.docs()

# Knobs swept by the Sec.-4 sensitivity analysis, with the values tested
# (default first, mirroring the paper's value-selection rules: binary ->
# non-default; categorical -> all; numeric -> neighbours of default).
SENSITIVITY_SWEEP: Dict[str, Tuple[Any, ...]] = SPACE.sweep()


@dataclasses.dataclass(frozen=True)
class TunableConfig:
    """One point in the 12-knob configuration space (Sec. 3 analogue)."""
    # 1. spark.serializer (Java -> Kryo)
    compute_dtype: str = "float32"
    # 2. spark.shuffle.manager (sort | hash | tungsten-sort)
    shard_strategy: str = "dp"
    # 3. spark.shuffle.compress
    grad_comm_dtype: str = "float32"
    # 4. spark.io.compression.codec (snappy | lzf | lz4; float32 = off)
    comm_codec: str = "bfloat16"
    # 5+6. spark.shuffle.memoryFraction / spark.storage.memoryFraction (joint)
    remat_policy: str = "dots"
    # 7. spark.reducer.maxSizeInFlight
    microbatches: int = 1
    # 8. spark.shuffle.file.buffer (Pallas VMEM tile)
    attn_block_q: int = 128
    attn_block_kv: int = 128
    # 9. spark.shuffle.consolidateFiles
    fuse_grad_collectives: bool = False
    # 10. spark.rdd.compress
    kv_cache_dtype: str = "bfloat16"
    # 11. spark.shuffle.spill.compress
    remat_save_dtype: str = "float32"
    # 12. spark.shuffle.io.preferDirectBufs
    donate_buffers: bool = True
    # beyond-paper
    attn_tp_fallback: str = "replicate"
    attn_impl: str = "xla"       # xla = eager torch ops | pallas = hand-written kernels
    seq_parallel: bool = False   # shard residual seq dim over the model axis
    # infrastructure (not tuned): unrolled layer stack for cost
    # calibration / cross-layer fusion experiments
    unroll_layers: bool = False
    # serving knobs (tuned only by serve cells via their own stage tree;
    # analytic reach, so compile keys and step campaigns are unaffected)
    max_wave_size: int = 4
    wave_admission: str = "greedy"

    def replace(self, **kw) -> "TunableConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def compile_key(self, kind: str = None, family: str = None
                    ) -> Tuple[Tuple[str, Any], ...]:
        """Projection onto the knobs that can reach the compiled HLO.

        Two configs with equal compile keys lower+compile to identical
        programs for a (kind, family) cell, so an evaluator may share
        one compile between them and recompute only the analytic
        roofline terms (the trial-throughput engine, core/trial.py).

        ``ANALYTIC_KNOBS`` are always dropped.  When the cell context is
        given, knobs that provably never reach that cell's step function
        are canonicalized to their defaults (see KNOB_REACH for the
        per-knob evidence).
        """
        d = {k: getattr(self, k) for k in COMPILE_KNOBS}
        dflt = _DEFAULT_CFG
        if kind is not None and kind != "train":
            # serve steps build no gradient/optimizer machinery
            # (runtime/stepfn.py build_prefill_step / build_decode_step)
            for k in ("grad_comm_dtype", "fuse_grad_collectives",
                      "microbatches"):
                d[k] = getattr(dflt, k)
            if kind == "prefill" and family in ("dense", "vlm", "moe"):
                # transformer prefill scans through remat.to_carry: the
                # remat pair only matters via the derived carry dtype
                d["remat_save_dtype"] = _carry_dtype(
                    d["remat_policy"], d["remat_save_dtype"],
                    d["compute_dtype"])
                d["remat_policy"] = "_carry"
            elif kind == "prefill" and family == "encdec":
                # encdec prefill runs the full encoder stack through
                # remat.wrap_layer + to_carry — keep the pair as-is
                pass
            else:
                # decode bodies (and ssm/hybrid prefills) never touch
                # the remat machinery
                d["remat_policy"] = dflt.remat_policy
                d["remat_save_dtype"] = dflt.remat_save_dtype
            if kind == "prefill":
                # build_prefill_step jits with no donate_argnums
                d["donate_buffers"] = dflt.donate_buffers
        if kind == "train":
            # the train step builds no KV cache
            d["kv_cache_dtype"] = dflt.kv_cache_dtype
        if family is not None:
            if family != "moe":
                # the wire codec exists only in the MoE all-to-all
                d["comm_codec"] = dflt.comm_codec
            if family == "ssm":
                # xlstm keeps f32 recurrent state, no attention KV cache
                d["kv_cache_dtype"] = dflt.kv_cache_dtype
            # grad-comm knobs are real only on the explicit path
            # (runtime/gradsync.explicit_applicable)
            if not (d["shard_strategy"] in ("dp", "fsdp")
                    and family != "moe"):
                d["grad_comm_dtype"] = dflt.grad_comm_dtype
                d["fuse_grad_collectives"] = dflt.fuse_grad_collectives
            elif (d["shard_strategy"] != "dp"
                  and d["grad_comm_dtype"] == "int8_ef"):
                d["grad_comm_dtype"] = "bfloat16"   # stepfn fallback
        if d["remat_policy"] == "none":
            d["remat_save_dtype"] = dflt.remat_save_dtype  # nothing saved
        return tuple((k, d[k]) for k in COMPILE_KNOBS)

    def validate(self) -> None:
        SPACE.validate(self)

    def describe_delta(self, other: "TunableConfig") -> str:
        ds = [f"{k}={v!r}" for k, v in other.as_dict().items()
              if self.as_dict().get(k) != v]
        return ", ".join(ds) if ds else "(no change)"


_DEFAULT_CFG = TunableConfig()

_DTYPE_SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def _carry_dtype(remat_policy: str, save_dtype: str, compute_dtype: str
                 ) -> str:
    """Mirror of runtime/remat.carry_dtype on knob strings."""
    if remat_policy == "none":
        return compute_dtype
    if _DTYPE_SIZE.get(save_dtype, 4) < _DTYPE_SIZE.get(compute_dtype, 4):
        return save_dtype
    return compute_dtype


def default_config(**overrides) -> TunableConfig:
    """Paper-faithful default (all-Spark-defaults analogue)."""
    c = TunableConfig(**overrides)
    c.validate()
    return c


def exhaustive_size() -> int:
    """Size of the exhaustive grid the paper's 10-trial tree avoids,
    computed arithmetically from the registry (the old implementation
    materialized the full ``itertools.product`` just to ``len`` it)."""
    return SPACE.exhaustive_size()
