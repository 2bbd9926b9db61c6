"""The declarative knob space — single source of truth per parameter.

(The PyTorch port's own copy of the reference package's
``core/space.py``; the registry is kept identical entry for entry.)

Before the Strategy API, the knob space was encoded four separate times
(``DOMAINS``, ``SENSITIVITY_SWEEP``, ``PARAM_DOCS`` and the
``COMPILE_KNOBS``/``ANALYTIC_KNOBS`` partition in ``core/params.py``,
plus the tree's stage deltas in ``core/tree.py``) and the encodings
could silently drift.  Now each knob is declared exactly once as a
:class:`Knob` in the :data:`SPACE` registry, and every historical name
is *derived* from it (``core/params.py`` keeps the old names as thin
re-exports so imports keep working).

Adding a knob = adding one :class:`Knob` entry here plus the matching
``TunableConfig`` field; the drift tests (tests/test_space.py) enforce
that the two stay in sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Sequence, Tuple

REACH_CLASSES = ("compile", "analytic")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable (or infrastructure) parameter of the step function.

    ``domain`` lists the legal values, first entry = the Spark-like
    default.  ``reach`` declares whether the knob can change the
    lowered/compiled HLO ("compile") or only ever enters the analytic
    roofline terms ("analytic") — the trial-throughput engine's compile
    projection (``TunableConfig.compile_key``) is derived from it.
    ``reach_evidence`` records where a conditionally-relevant compile
    knob actually reaches the step function (the per-knob evidence for
    the compile_key canonicalizations).  ``sweep`` lists the values the
    Sec.-4 sensitivity analysis tests (chosen by the paper's rules:
    binary -> non-default, categorical -> all, numeric -> neighbours).
    ``spark`` is the bare Spark-parameter analogue (used as the tree
    stage's spark_name); ``doc`` the annotated PARAM_DOCS line.
    Infrastructure knobs (``tunable=False``) are never swept or listed
    in DOMAINS/PARAM_DOCS but still carry a domain and a reach class.
    ``seq_tile=True`` marks a Pallas sequence-tile knob: its effective
    block is ``min(value, seq_len)`` and must divide the cell's
    sequence length (``ParamSpace.validate(cfg, seq_len=...)`` turns a
    non-dividing tile into a clean ``ValueError`` instead of a deep
    Pallas grid assertion).
    """
    name: str
    domain: Tuple[Any, ...]
    reach: str
    spark: str = ""
    doc: str = ""
    sweep: Tuple[Any, ...] = ()
    reach_evidence: str = ""
    tunable: bool = True
    seq_tile: bool = False

    def __post_init__(self):
        if self.reach not in REACH_CLASSES:
            raise ValueError(f"{self.name}: reach {self.reach!r} not in "
                             f"{REACH_CLASSES}")
        if not self.domain:
            raise ValueError(f"{self.name}: empty domain")
        bad = [v for v in self.sweep if v not in self.domain]
        if bad:
            raise ValueError(f"{self.name}: sweep values {bad} not in "
                             f"domain {self.domain}")

    @property
    def default(self) -> Any:
        return self.domain[0]

    def validate(self, value: Any) -> None:
        if value not in self.domain:
            raise ValueError(f"{self.name}={value!r} not in domain "
                             f"{self.domain}")

    def validate_tile(self, value: Any, seq_len: int) -> None:
        """Check a sequence-tile value against a concrete sequence
        length (kernels clamp the block to ``min(value, seq_len)``
        before asserting divisibility — mirror that here so the error
        is raised once, with the knob's name, before any Pallas call)."""
        if not self.seq_tile:
            return
        eff = min(int(value), int(seq_len))
        if eff <= 0 or seq_len % eff != 0:
            raise ValueError(
                f"{self.name}={value}: effective tile {eff} does not "
                f"divide sequence length {seq_len} — pick a tile that "
                f"divides the cell's sequence")


class ParamSpace:
    """Ordered registry of :class:`Knob` s; every projection the rest of
    the codebase consumes (domains, sweep, docs, compile partition,
    reach evidence, grid size) is computed from it."""

    def __init__(self, knobs: Sequence[Knob]):
        self._knobs: Dict[str, Knob] = {}
        for k in knobs:
            if k.name in self._knobs:
                raise ValueError(f"duplicate knob {k.name!r}")
            self._knobs[k.name] = k

    # ----------------------------------------------------------- access
    def __getitem__(self, name: str) -> Knob:
        return self._knobs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def __iter__(self) -> Iterator[Knob]:
        return iter(self._knobs.values())

    def __len__(self) -> int:
        return len(self._knobs)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._knobs)

    # ------------------------------------------------------ projections
    def domains(self) -> Dict[str, Tuple[Any, ...]]:
        """Legal values per *tunable* knob (the historical DOMAINS)."""
        return {k.name: k.domain for k in self if k.tunable}

    def sweep(self) -> Dict[str, Tuple[Any, ...]]:
        """Sensitivity sweep values per swept knob (SENSITIVITY_SWEEP)."""
        return {k.name: k.sweep for k in self if k.sweep}

    def docs(self) -> Dict[str, str]:
        """Spark-analogue documentation per tunable knob (PARAM_DOCS)."""
        return {k.name: (k.doc or k.spark) for k in self if k.tunable}

    def compile_knobs(self) -> Tuple[str, ...]:
        """Knobs that can reach the compiled HLO, in registration order
        (the order is load-bearing: it fixes the compile_key tuple
        layout, hence the disk compile-cache keys)."""
        return tuple(k.name for k in self if k.reach == "compile")

    def analytic_knobs(self) -> Tuple[str, ...]:
        return tuple(k.name for k in self if k.reach == "analytic")

    def reach_evidence(self) -> Dict[str, str]:
        """Where each conditionally-relevant compile knob reaches the
        step function (the historical KNOB_REACH)."""
        return {k.name: k.reach_evidence for k in self if k.reach_evidence}

    def defaults(self) -> Dict[str, Any]:
        return {k.name: k.default for k in self}

    def seq_tile_knobs(self) -> Tuple[str, ...]:
        """Pallas sequence-tile knobs (validated against the cell's
        sequence lengths by evaluators that actually run kernels)."""
        return tuple(k.name for k in self if k.seq_tile)

    # ------------------------------------------------------- validation
    def validate(self, cfg: Any, seq_len: int = None) -> None:
        """Check every tunable field of a TunableConfig-like object.

        With ``seq_len`` the sequence-tile knobs are additionally
        checked for divisibility against that concrete sequence length
        (a non-dividing tile is a deterministic crash trial, not a deep
        Pallas error).  Callers that never execute a kernel — the
        roofline evaluator in particular — pass no ``seq_len`` and keep
        their historical behaviour bit-identical."""
        for k in self:
            if k.tunable:
                k.validate(getattr(cfg, k.name))
            if seq_len is not None and k.seq_tile:
                k.validate_tile(getattr(cfg, k.name), seq_len)

    def validate_delta(self, delta: Dict[str, Any]) -> None:
        """Check a partial assignment (e.g. a tree stage alternative)."""
        for name, value in delta.items():
            if name not in self._knobs:
                raise KeyError(f"unknown knob {name!r} "
                               f"(known: {', '.join(self.names())})")
            self._knobs[name].validate(value)

    def exhaustive_size(self) -> int:
        """Size of the exhaustive grid over the tunable knobs, computed
        arithmetically (never materialize the cross-product)."""
        return math.prod(len(k.domain) for k in self if k.tunable)


# ---------------------------------------------------------------- SPACE
# Registration order = TunableConfig field order (load-bearing: the
# compile_knobs() projection fixes the compile_key tuple layout).
SPACE = ParamSpace([
    # 1. spark.serializer (Java -> Kryo)
    Knob("compute_dtype", ("float32", "bfloat16"), "compile",
         spark="spark.serializer",
         doc="spark.serializer (Java -> Kryo)",
         sweep=("float32", "bfloat16"),
         reach_evidence="structural: every matmul/activation dtype in "
                        "every step function"),
    # 2. spark.shuffle.manager (sort | hash | tungsten-sort)
    Knob("shard_strategy", ("dp", "fsdp", "tp", "fsdp_tp"), "compile",
         spark="spark.shuffle.manager",
         doc="spark.shuffle.manager (sort/hash/tungsten-sort)",
         # sweep order: baseline (fsdp_tp) first, then the alternatives
         sweep=("fsdp_tp", "dp", "fsdp", "tp"),
         reach_evidence="structural: param/activation sharding in every "
                        "step function (runtime/sharding.py)"),
    # 3. spark.shuffle.compress — the error-feedback int8 path joined
    # the sweep once the trial-throughput engine made the extra point
    # ~free (it shares the explicit-gradsync compile projection)
    Knob("grad_comm_dtype", ("float32", "bfloat16", "int8_ef"), "compile",
         spark="spark.shuffle.compress",
         sweep=("float32", "bfloat16", "int8_ef"),
         reach_evidence="train only; explicit path (gradsync) only"),
    # 4. spark.io.compression.codec (snappy | lzf | lz4; float32 = off)
    Knob("comm_codec", ("bfloat16", "float16", "int8", "float32"),
         "compile",
         spark="spark.io.compression.codec",
         doc="spark.io.compression.codec (snappy/lzf/lz4)",
         sweep=("bfloat16", "float16", "int8"),
         reach_evidence="moe family only (moe._encode_wire)"),
    # 5+6. spark.shuffle/storage.memoryFraction (one joint knob, exactly
    # as the paper tunes them).  default 'dots' = balanced (0.2/0.6);
    # 'none' = storage-heavy (store everything, 0.1/0.7); 'full' =
    # shuffle-heavy (recompute everything)
    Knob("remat_policy", ("dots", "none", "full"), "compile",
         spark="spark.shuffle/storage.memoryFraction",
         doc="spark.shuffle.memoryFraction + spark.storage.memoryFraction",
         sweep=("dots", "none", "full"),
         reach_evidence="train; prefill via remat.to_carry dtype"),
    # 7. spark.reducer.maxSizeInFlight
    Knob("microbatches", (1, 2, 4), "compile",
         spark="spark.reducer.maxSizeInFlight",
         sweep=(1, 2, 4),
         reach_evidence="train only (stepfn.build_train_step)"),
    # 8. spark.shuffle.file.buffer (Pallas VMEM tile)
    Knob("attn_block_q", (128, 256, 512), "analytic",
         spark="spark.shuffle.file.buffer",
         doc="spark.shuffle.file.buffer (q tile)",
         sweep=(128, 256, 512),
         reach_evidence="Pallas kernel tile only; never in the "
                        "calibration compiles (attn_impl forced to xla)",
         seq_tile=True),
    # the kv tile joined the sweep alongside the q tile: both are
    # analytic-only, so the whole sweep reuses one compile
    Knob("attn_block_kv", (128, 256, 512), "analytic",
         spark="spark.shuffle.file.buffer",
         doc="spark.shuffle.file.buffer (kv tile)",
         sweep=(128, 256, 512),
         reach_evidence="Pallas kernel tile only; never in the "
                        "calibration compiles (attn_impl forced to xla)",
         seq_tile=True),
    # 9. spark.shuffle.consolidateFiles
    Knob("fuse_grad_collectives", (False, True), "compile",
         spark="spark.shuffle.consolidateFiles",
         sweep=(False, True),
         reach_evidence="train only; explicit path (gradsync) only"),
    # 10. spark.rdd.compress — float32 (compression off) joined the
    # sweep so the matrix shows the cost of *disabling* the default,
    # like the paper's compress-off rows
    Knob("kv_cache_dtype", ("bfloat16", "int8", "float32"), "compile",
         spark="spark.rdd.compress",
         sweep=("bfloat16", "int8", "float32"),
         reach_evidence="prefill/decode cache ops; not ssm family"),
    # 11. spark.shuffle.spill.compress
    Knob("remat_save_dtype", ("float32", "bfloat16"), "compile",
         spark="spark.shuffle.spill.compress",
         sweep=("float32", "bfloat16"),
         reach_evidence="train; prefill via remat.to_carry dtype"),
    # 12. spark.shuffle.io.preferDirectBufs
    Knob("donate_buffers", (True, False), "compile",
         spark="spark.shuffle.io.preferDirectBufs",
         sweep=(True, False),
         reach_evidence="train/decode donate_argnums; not prefill"),
    # beyond-paper knob (see DESIGN.md): how attention is distributed
    # when head counts don't divide the model axis
    Knob("attn_tp_fallback", ("replicate", "batch_shard"), "compile",
         doc="(beyond-paper) attention TP fallback",
         reach_evidence="attention sharding when heads % model axis != 0"),
    # infrastructure (not tuned): the execution engine's attention
    # kernel; pallas on TPU, xla on dry-run.  Its VMEM tile size IS the
    # file.buffer tunable.
    Knob("attn_impl", ("xla", "pallas"), "analytic", tunable=False,
         reach_evidence="calibration compiles force attn_impl=xla; the "
                        "pallas/xla split enters analytically"),
    # infrastructure (not tuned): shard residual seq dim over model axis
    Knob("seq_parallel", (False, True), "compile", tunable=False,
         reach_evidence="residual sharding in stepfn (all kinds)"),
    # infrastructure (not tuned): unrolled layer stack for cost
    # calibration / cross-layer fusion experiments
    Knob("unroll_layers", (False, True), "compile", tunable=False,
         reach_evidence="calibration-compile variant selector"),
    # serving knobs (not tuned by step/kernel campaigns — only serve
    # cells propose deltas on them via their own stage tree, so the
    # classic DOMAINS/sweep/compile-key projections stay byte-identical).
    # Wave size of the batched serving scheduler: how many requests one
    # prefill+decode wave carries.
    Knob("max_wave_size", (4, 2, 8), "analytic", tunable=False,
         spark="spark.default.parallelism",
         doc="spark.default.parallelism (serving wave size)",
         reach_evidence="serving wave scheduler only "
                        "(serving/scheduler.py BatchScheduler); never "
                        "enters a step compile"),
    # Wave admission policy: "greedy" serves whatever has arrived,
    # "full" holds the wave until max_wave_size requests are queued
    # (higher batch efficiency, unbounded queue delay on sparse traffic).
    Knob("wave_admission", ("greedy", "full"), "analytic", tunable=False,
         spark="spark.locality.wait",
         doc="spark.locality.wait (serving wave admission)",
         reach_evidence="serving wave admission only "
                        "(serving/evaluator.py replay loop); never "
                        "enters a step compile"),
])
