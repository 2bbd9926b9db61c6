"""Roofline cost model: one counted step -> {compute, memory, collective}
seconds on the H100.

The PyTorch port of the reference's ``core/costmodel.py``.  The
reference reads the three roofline terms of the compiled step on the
production mesh from XLA (``compiled.cost_analysis()`` and the
collectives parsed out of the partitioned HLO text).  The port has no
HLO: ``core/stepcount.count_cell`` runs the step once on fake tensors
(shapes and dtypes, no data; ``FakeTensorMode``) on the CPU device type,
each argument made directly as the rank's local block of a mesh that no
process holds (``launch/mesh.fake_production_mesh``: a fake process
group of 256 or 512 ranks, at rank 0), and counts what the rank does:

  * FLOPs — ``torch.utils.flop_counter``'s formula for every op the
    rank runs on its local tensors (a DTensor op is counted by the local
    ops it runs, never at its global shape).  The formulas price
    products (matmul, bmm, convolution, attention), not elementwise ops,
    which XLA also counts: prefill and train steps read within 0.9–1.2
    of the reference's count, a one-token decode step (almost no
    products) about half or more (tests/test_torch_stepcount.py);
  * collectives — kind, output bytes per rank, group size and dtype of
    every collective the rank issues, functional (``_c10d_functional``:
    DTensor's redistributes) or not (``c10d``: the explicit path's
    gradient sync, MoE's all-to-all);
  * peak memory — the most bytes of live local tensors at once, the
    arguments included (never a whole tensor: arguments are made as
    local blocks);
  * bytes accessed — every op's operand and result bytes (views moved
    nothing), for the raw roofline only: the evaluator's memory term is
    :func:`analytic_memory_bytes`, as in the reference, with the flash
    kernel's own reads on the kernel path (:func:`port_memory_bytes`).

The analytic half (:func:`analytic_memory_bytes`, the flash corrections,
the calibration points, :func:`model_flops`) and the data classes are
the reference's, line for line: pure arithmetic on the configs, with
output bit-identical to the reference's; :func:`flash_kernel_flops`,
:func:`flash_kernel_bytes` and :func:`port_memory_bytes` are the port's
own (the flash kernel's share of the compute and memory terms).  ``HW``
is the H100's table (``core/card.py``, with the source of every
figure); no number of the reference's TPU table is carried over.

Normalization, as in the reference: every count is per rank (per card),
and the terms divide by one card's peaks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import card

HW = {
    "flops_bf16": card.FLOPS_BF16,
    "flops_f32": card.FLOPS_F32,
    # the f32 flash kernel: each product as three TF32 ones on the
    # tensor cores
    "flops_tf32x3": card.FLOPS_TF32 / 3,
    "hbm_bw": card.HBM_BYTES_PER_S,
    "link_bw": card.NVLINK_BYTES_PER_S,     # within one node (NVLink)
    "net_bw": card.NET_BYTES_PER_S,         # between nodes (InfiniBand)
    "node_size": card.NODE_SIZE,
    "hbm_per_chip": card.HBM_BYTES,
    "coll_latency": card.COLLECTIVE_LATENCY_S,   # an assumption
}

# torch dtype -> the reference's (HLO's) dtype name of a collective op
_DTYPE_NAMES = {
    "float64": "f64", "float32": "f32", "float16": "f16",
    "bfloat16": "bf16", "float8_e4m3fn": "f8e4m3", "float8_e5m2": "f8e5m2",
    "int64": "s64", "uint64": "u64", "int32": "s32", "uint32": "u32",
    "int16": "s16", "uint16": "u16", "int8": "s8", "uint8": "u8",
    "bool": "pred", "complex64": "c64", "complex128": "c128",
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_out: int       # per-partition output bytes
    group_size: int
    dtype: str = ""
    # the port's: whether the group's ranks share one node (None: not
    # known, judged by the group's size; see collective_seconds)
    node_local: Optional[bool] = None


@dataclasses.dataclass
class CollectiveStats:
    ops: List[CollectiveOp]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for op in self.ops:
            d = out.setdefault(op.kind, {"count": 0, "bytes": 0.0})
            d["count"] += 1
            d["bytes"] += op.bytes_out
        return out

    def total_bytes(self) -> float:
        return sum(op.bytes_out for op in self.ops)


def collective_seconds(stats: CollectiveStats, hw: Optional[Dict] = None
                       ) -> float:
    """Ring-model time: per op, (g-1)/g x bytes / bw (x2 for all-reduce,
    1 for collective-permute), plus a fixed latency per op.

    The bandwidth follows the card's topology.  Ranks are laid out with
    the model axis innermost, eight cards to a node: a group whose ranks
    share one node uses the NVLink rate (``link_bw``), any other group
    the network rate between nodes (``net_bw``).  The step counter reads
    each group's ranks (``CollectiveOp.node_local``); an op that does not
    say is within a node when it has at most ``node_size`` ranks (a
    model-axis slice).  On the production meshes every data and model
    group has 16 ranks and crosses nodes; a pod group of a multi-pod
    mesh has 2 ranks 256 apart and crosses too.

    The reference halves f32 reduction payloads under bf16 compute, to
    undo XLA-CPU's ``AllReducePromotion`` (which rewrites every bf16
    reduction to f32 in the HLO it parses).  The port's payloads are
    counted at the dtype they go on the wire, so nothing is halved.
    ``hw`` overrides the table (default ``HW``)."""
    hw = hw or HW
    t = 0.0
    for op in stats.ops:
        g = max(op.group_size, 1)
        if g == 1:
            continue
        local = op.node_local if op.node_local is not None \
            else g <= hw["node_size"]
        bw = hw["link_bw"] if local else hw["net_bw"]
        ring = (g - 1) / g
        factor = 2.0 * ring if op.kind == "all-reduce" else ring
        if op.kind == "collective-permute":
            factor = 1.0
        t += factor * op.bytes_out / bw + hw["coll_latency"]
    return t


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes: float
    coll_summary: Dict[str, Dict[str, float]]
    peak_mem_bytes: Optional[float] = None

    @property
    def total_s(self) -> float:
        # terms overlap on real hardware; the roofline step time is the max
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "total_s": self.total_s,
            "bottleneck": self.bottleneck,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes": self.collective_bytes,
            "coll_summary": self.coll_summary,
            "peak_mem_bytes": self.peak_mem_bytes,
        }


def roofline_from_dict(d: Dict) -> "Roofline":
    """Inverse of Roofline.as_dict (drops the derived total/bottleneck);
    used by the compile cache to rehydrate memoized measurements."""
    fields = {f.name for f in dataclasses.fields(Roofline)}
    return Roofline(**{k: v for k, v in d.items() if k in fields})


def roofline_of(count, compute_dtype: str = "bfloat16") -> Roofline:
    """Roofline terms of one counted step (``core/stepcount.StepCount``,
    per rank): with ``stepcount.count_cell``, the counterpart of the
    reference's ``analyze(compiled, ...)`` and the HLO parsing under
    it."""
    peak = HW["flops_bf16"] if compute_dtype != "float32" else HW["flops_f32"]
    stats = CollectiveStats(list(count.collectives))
    return Roofline(
        compute_s=count.flops / peak,
        memory_s=count.bytes / HW["hbm_bw"],
        collective_s=collective_seconds(stats),
        flops_per_chip=count.flops,
        bytes_per_chip=count.bytes,
        collective_bytes=stats.total_bytes(),
        coll_summary=stats.summary(),
        peak_mem_bytes=float(count.peak_bytes),
    )


# ----------------------------------------------------- flash correction
def attention_applications(cfg, shape):
    """[(count, S_q, S_kv)] softmax-attention applications per step."""
    S = shape.seq_len
    if shape.kind == "decode":
        return []                       # one-token scores are negligible
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return [(cfg.n_layers, S, S)]
    if fam == "hybrid":
        return [(cfg.n_layers // cfg.attn_every, S, S)]
    if fam == "ssm":
        return []
    if fam == "encdec":
        S_enc = S // cfg.enc_seq_ratio
        return [(cfg.enc_layers, S_enc, S_enc),   # encoder self
                (cfg.n_layers, S, S),             # decoder self
                (cfg.n_layers, S, S_enc)]         # cross
    raise ValueError(fam)


def attention_shards(cfg, rt, data_size: int, model_size: int) -> int:
    """How many ways the (B,H,Sq,Skv) attention tensors are sharded:
    batch over the data axes always; heads over the model axis only when
    divisible (otherwise replicated — the attn_tp_fallback situation)."""
    heads_sharded = (cfg.n_heads % max(1, model_size) == 0
                     or rt.attn_tp_fallback == "batch_shard")
    return data_size * (model_size if heads_sharded else 1)


def flash_refetch_bytes(cfg, shape, rt, data_size: int,
                        model_size: int) -> float:
    """Per-chip HBM bytes the flash kernel itself moves for the S x S
    part: K/V tiles re-fetched once per Q-tile (file.buffer knob)."""
    if rt.attn_impl != "pallas":
        return 0.0
    B, H, hd = shape.global_batch, cfg.n_heads, cfg.hd
    shards = attention_shards(cfg, rt, data_size, model_size)
    kvb = 2 if rt.compute_dtype != "float32" else 4
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd + 2 bwd passes
    total = 0.0
    for count, sq, skv in attention_applications(cfg, shape):
        n_qtiles = max(1, sq // max(1, rt.attn_block_q))
        total += count * mult * n_qtiles * 2.0 * B * H * skv * hd * kvb
    return total / shards


def flash_memory_correction_bytes(cfg, shape, rt, data_size: int,
                                  model_size: int) -> float:
    """Per-chip HBM bytes REMOVED from the memory term when the flash
    kernel (``attn_impl="pallas"``: the port's hand-written one) replaces
    the eager attention.

    The eager path materializes the (B,H,Sq,Skv) f32 score/softmax
    tensors in HBM (~4 round-trip passes for train incl. backward, 2 for
    prefill); the kernel keeps them on chip (shared memory and
    registers), at the cost of re-fetching the K/V tiles once per Q-tile
    (the spark.shuffle.file.buffer knob).  Reported as a separate
    correction, never silently folded into the raw counts.
    """
    if rt.attn_impl != "pallas":
        return 0.0
    B, H, hd = shape.global_batch, cfg.n_heads, cfg.hd
    shards = attention_shards(cfg, rt, data_size, model_size)
    kvb = 2 if rt.compute_dtype != "float32" else 4
    passes = 4.0 if shape.kind == "train" else 2.0
    total = 0.0
    for count, sq, skv in attention_applications(cfg, shape):
        xla = passes * B * H * sq * skv * 4.0
        n_qtiles = max(1, sq // max(1, rt.attn_block_q))
        refetch = max(0, n_qtiles - 1) * 2.0 * B * H * skv * hd * kvb
        total += count * max(0.0, xla - refetch)
    return total / shards


def flash_peak_correction_bytes(cfg, shape, rt, data_size: int,
                                model_size: int) -> float:
    """Per-chip PEAK bytes removed by the flash kernel: the stored
    (B,H,Sq,Skv) softmax tensors (x2: pre-softmax scores + probabilities).
    With remat 'none'/'dots' (dots_saveable keeps dot outputs) every
    layer's scores are live for the backward; with 'full' (or
    forward-only steps) only ~2 transient layers are."""
    if rt.attn_impl != "pallas":
        return 0.0
    B, H = shape.global_batch, cfg.n_heads
    shards = attention_shards(cfg, rt, data_size, model_size)
    stored_all = shape.kind == "train" and rt.remat_policy in ("none",
                                                               "dots")
    # ~3 (B,H,Sq,Skv) f32 tensors live per layer on the eager path (raw
    # scores, masked scores, softmax out — the reference measured ~2.7
    # of them as the per-layer delta of its scanned compile)
    total = 0.0
    for count, sq, skv in attention_applications(cfg, shape):
        live = count if stored_all else min(count, 2)
        total += live * 3.0 * B * H * sq * skv * 4.0
    return total / shards


def flash_kernel_flops(cfg, shape, rt, data_size: int,
                       model_size: int):
    """(eager, kernel): per-chip FLOPs of the causal self-attention
    products (QK^T and PV) as the eager path computes them, every
    (query, key) pair of the S x S square, and as the port's flash
    kernel computes them, the half on and below the diagonal (it skips
    the tiles above it).  (0, 0) unless ``attn_impl="pallas"`` on a
    prefill step: a train step takes the eager path (the kernels are
    forward-only), decode has no S x S product, and the encoder's self-
    and the cross-attention of the encdec family are eager (not causal).

    The port's own, not the reference's: its calibration counts run the
    eager path (``attn_impl="xla"``, as the reference's compiles do), and
    the evaluator swaps these FLOPs into the compute term, priced at the
    rate of the kernel's own products, so the roofline stays a lower
    bound of the port's kernel path."""
    if rt.attn_impl != "pallas" or shape.kind != "prefill":
        return 0.0, 0.0
    apps = attention_applications(cfg, shape)
    if cfg.family == "encdec":
        apps = apps[1:2]                # the decoder's self-attention
    B, H, hd = shape.global_batch, cfg.n_heads, cfg.hd
    shards = attention_shards(cfg, rt, data_size, model_size)
    eager = kernel = 0.0
    for count, sq, skv in apps:
        eager += count * 2 * 2.0 * B * H * sq * skv * hd
        kernel += count * 2 * 2.0 * B * H * sq * (skv + 1) / 2.0 * hd
    return eager / shards, kernel / shards


def flash_kernel_bytes(cfg, shape, rt, data_size: int,
                       model_size: int):
    """(eager, kernel): per-chip HBM bytes of the same causal self-
    attentions as :func:`flash_kernel_flops` (zero where it is), as
    :func:`analytic_memory_bytes` prices the eager path's (B,H,S,S) f32
    scores and probabilities (two passes of the square), and the least
    the port's kernel can move: each K and V row read once.

    The port's own.  The reference prices the kernel's K/V re-fetch once
    per ``attn_block_q`` query tile, but the port's kernels run tiles of
    their own whatever the knob (``kernels/flash_attention/ops.py``:
    ``tc_tiles``, ``f32_tiles``), and their re-reads of a head's K/V
    (at most 2 x S x hd x 4 bytes, 16.8 MB at S 32,768 and hd 64)
    may come from the card's 50 MB L2 rather than HBM; how many do is not
    measured, so the bound counts none (the query rows and the output
    are in the activation term)."""
    if rt.attn_impl != "pallas" or shape.kind != "prefill":
        return 0.0, 0.0
    apps = attention_applications(cfg, shape)
    if cfg.family == "encdec":
        apps = apps[1:2]                # the decoder's self-attention
    B, H, hd = shape.global_batch, cfg.n_heads, cfg.hd
    comp_b = 4 if rt.compute_dtype == "float32" else 2
    shards = attention_shards(cfg, rt, data_size, model_size)
    eager = kernel = 0.0
    for count, sq, skv in apps:
        eager += count * 2.0 * B * H * sq * skv * 4.0
        kernel += count * 2.0 * B * H * skv * hd * comp_b
    return eager / shards, kernel / shards


def port_memory_bytes(cfg, shape, rt, data_size: int,
                      model_size: int) -> float:
    """Per-chip HBM bytes of one step of the port (the evaluator's memory
    term): :func:`analytic_memory_bytes` of the eager path, with the
    causal self-attentions that the flash kernel runs
    (``attn_impl="pallas"`` prefill) priced as :func:`flash_kernel_bytes`
    says; no knob of the kernel's tiles moves it."""
    eager, kernel = flash_kernel_bytes(cfg, shape, rt, data_size,
                                       model_size)
    return analytic_memory_bytes(cfg, shape, rt.replace(attn_impl="xla"),
                                 data_size, model_size) - eager + kernel


# ------------------------------------------------- analytic memory model
# The reference found XLA-CPU's "bytes accessed" unreliable for HBM
# traffic (unfused elementwise chains count a round-trip per op), and
# the port's count of every op's operands is no better a model of what
# fused kernels move.  The memory term is therefore derived from first
# principles: params / activations / attention / vocab / optimizer / KV
# traffic, which is exactly dtype- and knob-sensitive.  FLOPs and
# collective bytes stay counted.  Constants as in the reference.

_ACT_RT_FWD = 8.0      # residual-stream round-trips per layer, forward
_ACT_RT_BWD = 16.0     # backward ~2x forward
_WIDE_RT_FWD = 3.0     # d_ff-wide tensors per layer, forward
_WIDE_RT_BWD = 6.0


def _layer_width(cfg) -> float:
    """Effective 'wide' dim per layer (d_ff; experts: top_k x d_ff;
    ssm: expanded inner dim)."""
    if cfg.family == "moe":
        return float(cfg.top_k * cfg.d_ff)
    if cfg.family in ("hybrid",):
        return float(cfg.ssm_expand * cfg.d_model * 2)
    if cfg.family == "ssm":
        return float(cfg.n_heads * cfg.hd * 3)
    return float(cfg.d_ff)


def analytic_memory_bytes(cfg, shape, rt, data_size: int,
                          model_size: int) -> float:
    """Per-chip HBM bytes of one step (the roofline memory term)."""
    chips = data_size * model_size
    comp_b = 4 if rt.compute_dtype == "float32" else 2
    p_b = 4 if cfg.param_dtype == "float32" else 2
    train = shape.kind == "train"
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else S)
    L = max(1, cfg.n_layers)

    # ---- parameters: read once per forward; backward reads them again;
    # remat 'full' recomputes the forward (one more read); each extra
    # microbatch re-reads them; cast read(p_b)+write(comp_b) if casting
    n_params = cfg.param_count()
    fwd_passes = 1.0 + (1.0 if train and rt.remat_policy == "full" else 0.0)
    passes = (fwd_passes + 1.0) if train else fwd_passes
    passes *= max(1, rt.microbatches if train else 1)
    param_traffic = n_params * (p_b + comp_b) * passes / chips
    if train:
        # optimizer: read grads+params+2 moments, write params+2 moments
        state_b = 4.0 * (7.0 if cfg.optimizer == "adamw" else 3.0)
        param_traffic += n_params * state_b / chips

    # ---- activations (residual stream replicated over model axis
    # unless seq_parallel; wide tensors sharded over model)
    d = cfg.d_model
    res_shards = data_size * (model_size if rt.seq_parallel else 1)
    act_rt = _ACT_RT_FWD + (_ACT_RT_BWD if train else 0.0) \
        + (_ACT_RT_FWD if train and rt.remat_policy == "full" else 0.0)
    act = L * tokens * d * comp_b * act_rt / res_shards
    wide_rt = _WIDE_RT_FWD + (_WIDE_RT_BWD if train else 0.0) \
        + (_WIDE_RT_FWD if train and rt.remat_policy == "full" else 0.0)
    act += L * tokens * _layer_width(cfg) * comp_b * wide_rt / chips
    # remat-saved residuals are written once and read once in backward,
    # in remat_save_dtype
    if train and rt.remat_policy != "none":
        save_b = 2 if rt.remat_save_dtype == "bfloat16" else comp_b
        act += 2.0 * L * tokens * d * save_b / res_shards

    # ---- attention S x S traffic
    attn = 0.0
    shards = attention_shards(cfg, rt, data_size, model_size)
    H, hd = cfg.n_heads, cfg.hd
    for count, sq, skv in attention_applications(cfg, shape):
        if rt.attn_impl == "pallas":
            n_qtiles = max(1, sq // max(1, rt.attn_block_q))
            mult = 3.0 if train else 1.0
            attn += (count * mult * n_qtiles * 2.0
                     * B * H * skv * hd * comp_b) / shards
        else:
            passes_sq = (4.0 if train else 2.0)
            attn += count * passes_sq * B * H * sq * skv * 4.0 / shards

    # ---- vocab: logits written f32 + softmax read + backward
    V = cfg.vocab
    lg_passes = 3.0 if train else 1.0
    vocab = tokens * V * 4.0 * lg_passes / chips

    # ---- decode KV cache: read the whole live cache at stored dtype
    kv = 0.0
    if shape.kind == "decode":
        kv_b = {"int8": 1, "bfloat16": 2, "float32": 4}[rt.kv_cache_dtype]
        if cfg.family in ("dense", "vlm", "moe"):
            n_kv_layers, state = cfg.n_layers, 0
        elif cfg.family == "hybrid":
            n_kv_layers = cfg.n_layers // cfg.attn_every
            d_in = cfg.ssm_expand * cfg.d_model
            state = (cfg.n_layers * B * (d_in // cfg.ssm_head_dim)
                     * cfg.ssm_head_dim * cfg.ssm_state * 4.0)
        elif cfg.family == "ssm":
            n_kv_layers = 0
            state = cfg.n_layers * B * H * hd * hd * 4.0
        else:  # encdec: self cache + fixed cross cache
            n_kv_layers, state = cfg.n_layers * 2, 0
        kv = (n_kv_layers * 2.0 * B * S * cfg.n_kv_heads * hd * kv_b
              + 2.0 * state) / chips
        # donate=False forces a copy of the updated cache
        if not rt.donate_buffers:
            kv *= 2.0

    return param_traffic + act + attn + vocab + kv


# ------------------------------------------------------------ calibration
# The reference calibrates because XLA's cost_analysis counts a `while`
# body ONCE whatever its trip count: roofline terms of scanned layer
# stacks are recovered from two small UNROLLED variants (1 unit and 3
# units of layers), extrapolated linearly:
#     term(U) = outside + U * per_unit.
# The port counts an eager step, whose loop over layers runs every
# layer, so a full-depth count is exact; the calibration is kept because
# two shallow counts cost far less than a deep one and extrapolate to
# the same terms.
# The unit is one iteration of the outermost stack (a layer; for
# hybrid/ssm families a GROUP of attn_every/slstm_every layers).

def calibration_points(cfg):
    """[(small_cfg, units), (mid_cfg, units)], true_units for ``cfg``."""
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return ([(cfg.replace(n_layers=1), 1),
                 (cfg.replace(n_layers=3), 3)], float(cfg.n_layers))
    if fam == "encdec":
        # enc and dec stacks both scale with the unit count
        return ([(cfg.replace(n_layers=1, enc_layers=1), 1),
                 (cfg.replace(n_layers=3, enc_layers=3), 3)],
                float(cfg.n_layers))
    if fam == "hybrid":
        ae = cfg.attn_every
        # unit = one group (ae mamba blocks + shared attn); the remainder
        # mamba blocks count as rem/ae of a group (attn share is small)
        return ([(cfg.replace(n_layers=ae), 1),
                 (cfg.replace(n_layers=3 * ae), 3)],
                cfg.n_layers / ae)
    if fam == "ssm":
        se = cfg.slstm_every
        return ([(cfg.replace(n_layers=se), 1),
                 (cfg.replace(n_layers=3 * se), 3)],
                cfg.n_layers / se)
    raise ValueError(fam)


def extrapolate(v1: float, v3: float, units: float) -> float:
    """outside + units*per_unit from measurements at 1 and 3 units."""
    per_unit = max(0.0, (v3 - v1) / 2.0)
    outside = max(0.0, v1 - per_unit)
    return outside + units * per_unit


def extrapolate_roofline(r1: "Roofline", r3: "Roofline", units: float
                         ) -> "Roofline":
    ex = lambda a, b: extrapolate(a, b, units)
    coll = {}
    for kind in set(r1.coll_summary) | set(r3.coll_summary):
        a = r1.coll_summary.get(kind, {"count": 0, "bytes": 0.0})
        b = r3.coll_summary.get(kind, {"count": 0, "bytes": 0.0})
        coll[kind] = {"count": ex(a["count"], b["count"]),
                      "bytes": ex(a["bytes"], b["bytes"])}
    return Roofline(
        compute_s=ex(r1.compute_s, r3.compute_s),
        memory_s=ex(r1.memory_s, r3.memory_s),
        collective_s=ex(r1.collective_s, r3.collective_s),
        flops_per_chip=ex(r1.flops_per_chip, r3.flops_per_chip),
        bytes_per_chip=ex(r1.bytes_per_chip, r3.bytes_per_chip),
        collective_bytes=ex(r1.collective_bytes, r3.collective_bytes),
        coll_summary=coll,
        peak_mem_bytes=(ex(r1.peak_mem_bytes, r3.peak_mem_bytes)
                        if r1.peak_mem_bytes and r3.peak_mem_bytes
                        else None),
    )


def model_flops(cfg, shape, per_token_factor: float = 6.0) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful model FLOPs for the cell.

    train: 6ND; prefill: 2ND (forward only); decode: 2N per token.
    encdec: encoder params see only the (seq/ratio) frame tokens."""
    factor = 6.0 if shape.kind == "train" else 2.0
    B = shape.global_batch
    tokens = B * (1 if shape.kind == "decode" else shape.seq_len)
    if cfg.family == "encdec":
        enc, dec, embed = cfg.encdec_split()
        enc_tokens = (B * (shape.seq_len // cfg.enc_seq_ratio)
                      if shape.kind != "decode" else 0)
        return factor * (enc * enc_tokens + (dec + embed) * tokens)
    return factor * cfg.active_param_count() * tokens
