"""Shared model-zoo building blocks (plain functions on tensors, dict
parameter trees).

Parameters are declared as ``PSpec`` trees: shape + logical dim names +
init scale.  The same tree yields real tensors (``init_params``) and
shape stand-ins (``param_shapes``).  The logical names are the
reference's: ``runtime/sharding.ShardingRules`` maps them to mesh axes.

With ``rules`` (a mesh's sharding rules) the tensors are DTensors and
``rules.constrain`` redistributes an activation where the reference
constrains its sharding.  A hand-written kernel never sees a DTensor:
``sharded_kernel`` runs it under ``local_map`` on this rank's block
(its heads, or its rows), as the reference's Pallas call runs on local
blocks under ``shard_map``.

With ``rt.attn_impl == "pallas"`` the norm and attention functions go
through the hand-written CUDA kernels of ``repro_torch.kernels``; with
``"xla"`` they are eager torch ops.  Each branch follows its own branch
of the reference, so the two differ in bf16 by design.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.params import TunableConfig
from repro_torch.runtime.loops import tree_map
from repro_torch.runtime.remat import torch_dtype
from repro_torch.runtime.sharding import is_dtensor


def _reduced(x):
    """A DTensor with no partial placement (the pending sums reduced)."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _whole_last_dim(x):
    """A DTensor with its last dim on no mesh axis (its other dims kept)."""
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    pl = tuple(Replicate() if getattr(p, "dim", None) == last else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def replicated_like(t, like):
    """A plain tensor the model made on the way (positions, a mask) as a
    replicated DTensor when ``like`` is a DTensor: the backward keeps it
    and must not meet a plain tensor there."""
    return _replicated(t, like) if is_dtensor(like) and \
        not is_dtensor(t) else t


def _replicated(w, like):
    """``w`` replicated on ``like``'s mesh (a norm's scale: every rank
    needs all of it)."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = (Replicate(),) * like.device_mesh.ndim
    if isinstance(w, DTensor):
        return w.redistribute(like.device_mesh, pl)
    return DTensor.from_local(w, like.device_mesh, pl, run_check=False)


def sharded_kernel(fn, out, *args):
    """``fn(*args)`` with every DTensor argument replaced by its local
    block, under ``local_map``: the output has the placements of the
    argument ``out`` indexes (a kernel's output is laid out like its
    query or its input rows).  Plain tensors call ``fn`` directly.  Every
    DTensor argument must be split only on dims ``fn`` treats as
    independent (batch, rows, heads): the caller's placements say so."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    # a pending sum is reduced first: ``fn`` sees whole values
    args = tuple(_reduced(a) if is_dtensor(a) else a for a in args)
    ref = args[out]
    ins = tuple(tuple(a.placements) if is_dtensor(a) else None
                for a in args)
    # one output: its placements as a list (a tuple means one per output)
    return local_map(fn, out_placements=list(ref.placements),
                     in_placements=ins, device_mesh=ref.device_mesh)(*args)


# ---------------------------------------------------------------- params
@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    scale: Any = "fan_in"          # "fan_in" | float | "zeros" | "ones"

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a tensor that is not allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_params(spec_tree, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Random parameters for a PSpec tree, drawn on ``device`` from an
    explicit generator (which must live on that device)."""
    device = generator.device if device is None else torch.device(device)

    def make(s: PSpec):
        if s.scale == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.scale == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        if s.scale == "fan_in":
            fan = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            sd = 1.0 / math.sqrt(max(1, fan))
        else:
            sd = float(s.scale)
        w = torch.randn(s.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * sd).to(dtype)

    return tree_map(make, spec_tree)


def param_shapes(spec_tree, dtype=torch.float32):
    return tree_map(lambda s: ShapeDtype(tuple(s.shape), dtype), spec_tree)


def logical_tree(spec_tree):
    return tree_map(lambda s: s.logical, spec_tree)


def stacked(n: int, spec_tree):
    """Prepend a 'layers' dim to every PSpec in the tree."""
    return tree_map(
        lambda s: PSpec((n,) + s.shape, ("layers",) + s.logical, s.scale),
        spec_tree)


# parameters the reference reads in their master dtype, never cast to the
# compute dtype: Mamba2's dt bias and log decay (mamba2._gates) and the
# sLSTM's diagonal recurrent weights (xlstm.slstm_block reads them in f32)
UNCAST = frozenset({"dt_bias", "A_log", "ri", "rf", "rz", "ro"})


def cast_params(params, spec_tree, rt: TunableConfig):
    """The parameter tree with every matrix cast to the compute dtype.

    The reference casts each f32 parameter at every use inside ``jit``;
    eagerly that would re-cast the whole model per step.  The serving
    entry points therefore call this once when the model is placed on
    the device; ``cast`` at the point of use is then free, and the
    numbers are the same.  Norm scales (``"ones"`` specs) and the
    parameters named in ``UNCAST`` stay as they are: the reference hands
    them on uncast."""
    if isinstance(spec_tree, dict):
        return {k: params[k] if k in UNCAST else
                cast_params(params[k], spec_tree[k], rt) for k in params}
    return params if spec_tree.scale == "ones" else cast(params, rt)


# ---------------------------------------------------------------- dtypes
def dt(rt: TunableConfig) -> torch.dtype:
    return torch_dtype(rt.compute_dtype)


def cast(x, rt: TunableConfig):
    return x.to(dt(rt))


# ---------------------------------------------------------------- norms
def rmsnorm_spec(d: int) -> PSpec:
    return PSpec((d,), ("embed",), "ones")


def rmsnorm(x, scale, rt: TunableConfig, eps: float = 1e-5):
    if rt.attn_impl == "pallas" and x.ndim == 3:
        from repro_torch.kernels.rmsnorm import ops as rms_ops
        if is_dtensor(x):
            # the kernel on this rank's rows: the normed dim whole
            x = _whole_last_dim(x)
            scale = _replicated(scale, x)
        return sharded_kernel(
            lambda a, w: rms_ops.rmsnorm(a.contiguous(), w, eps=eps),
            0, x, scale)
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """The reference's layernorm (f32 math, biased variance).  No model
    calls it: every family, the encoder-decoder too, norms with
    ``rmsnorm``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------- rope
def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integers."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None, None] * freq       # (...,S,1,half)
    sin, cos = (replicated_like(t, x) for t in (torch.sin(ang),
                                                 torch.cos(ang)))
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention
def attn_spec(cfg) -> Dict[str, PSpec]:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": PSpec((d, H, hd), ("embed", "heads", None)),
        "wk": PSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wv": PSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wo": PSpec((H, hd, d), ("heads", None, "embed")),
    }


def pin(x):
    """``x`` as it is, with its gradient brought back to ``x``'s own
    placements: DTensor may hand a flattened weight's gradient back split
    along a dim whose unflattening does not divide."""
    return x.redistribute(x.device_mesh, x.placements)


def heads_in(x, w):
    """``einsum("bsd,dhk->bshk", x, w)``.  On DTensors as one product
    with the weight's head dims flattened: DTensor's einsum can view its
    operands into splits that do not divide (9 heads on 2 ranks)."""
    if not is_dtensor(w):
        return torch.einsum("bsd,dhk->bshk", x, w)
    y = x @ pin(w.flatten(1))
    # the product may come out split along h*k where h does not divide
    split = math.prod(n for pl, n in zip(y.placements, y.device_mesh.shape)
                      if getattr(pl, "dim", None) == y.ndim - 1)
    if w.shape[1] % split:
        y = _whole_last_dim(y)
    return y.unflatten(-1, tuple(w.shape[1:]))


def heads_out(o, w):
    """``einsum("bshk,hkd->bsd", o, w)``, on DTensors as ``heads_in``."""
    if not is_dtensor(w):
        return torch.einsum("bshk,hkd->bsd", o, w)
    return pin(o.flatten(2)) @ pin(w.flatten(0, 1))


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, hkv, hd = k.shape
    k = k[:, :, :, None, :].expand(b, s, hkv, n_rep, hd)
    return k.reshape(b, s, hkv * n_rep, hd)


def _scores(q, k):
    """q k^T with f32 accumulation AND f32 output from any operand dtype
    (products of bf16 values are exact in f32)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def full_attention(q, k, v, *, causal: bool, rt: TunableConfig, rules=None,
                   q_positions=None, kv_positions=None):
    """q: (B,Sq,H,hd), k/v: (B,Skv,H,hd) (already GQA-repeated).  With
    DTensors the kernel runs on each rank's heads or batch rows (the
    placements ``attention_block`` gave them)."""
    if rt.attn_impl == "pallas" and causal and q.shape[1] == k.shape[1]:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return sharded_kernel(
            lambda a, b, c: fa_ops.flash_attention(
                a.contiguous(), b.contiguous(), c.contiguous(), causal=True,
                block_q=rt.attn_block_q, block_kv=rt.attn_block_kv),
            0, q, k, v)
    if is_dtensor(q):
        # each rank attends its own heads and batch rows (DTensor's einsum
        # would flatten a split head dim)
        return sharded_kernel(
            lambda a, b, c: _eager_attention(a, b, c, causal, q_positions,
                                             kv_positions), 0, q, k, v)
    return _eager_attention(q, k, v, causal, q_positions, kv_positions)


def _eager_attention(q, k, v, causal: bool, q_positions, kv_positions):
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _scores(q, k) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        if q_positions is None:
            q_positions = torch.arange(sq, device=q.device)
        if kv_positions is None:
            kv_positions = torch.arange(sk, device=q.device)
        mask = q_positions[:, None] >= kv_positions[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_block(p, x, *, cfg, rt: TunableConfig, rules, positions,
                    causal=True, kv_x=None, kv_positions=None):
    """Full (train/prefill) attention sub-block.  With ``kv_x`` it is
    cross-attention: K and V come from ``kv_x``, there is no RoPE and no
    causal mask, so it takes the eager path of ``full_attention``."""
    B = x.shape[0]
    src = x if kv_x is None else kv_x
    q = heads_in(x, cast(p["wq"], rt))
    k = heads_in(src, cast(p["wk"], rt))
    v = heads_in(src, cast(p["wv"], rt))
    if kv_x is None:      # self-attention gets RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_positions is None else kv_positions,
                 cfg.rope_theta)
    k = _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    bspec = rules.attn_batch_spec(B) if rules is not None else None
    if bspec is not None and is_dtensor(q):
        # beyond-paper fallback: reshard so the attention op is
        # batch-parallel over (data, model) when heads don't divide TP
        pl = rules.placements(bspec + (None, None, None))
        q, k, v = (t.redistribute(rules.mesh, pl) for t in (q, k, v))
    elif rules is not None:
        q = rules.constrain(q, "batch", None, "heads", None)
        k = rules.constrain(k, "batch", None, "heads", None)
        v = rules.constrain(v, "batch", None, "heads", None)
    o = full_attention(q, k, v, causal=causal and kv_x is None, rt=rt,
                       rules=rules)
    if rules is not None:
        o = rules.constrain(o, "batch", None, "heads", None)
    return heads_out(o, cast(p["wo"], rt))


# ------------------------------------------------------- KV-cache decode
def quantize_kv(x, kv_dtype: str):
    """x: (B,S,Hkv,hd) -> (stored, scale).  int8: per-(token,head) scale."""
    if kv_dtype != "int8":
        return x.to(torch_dtype(kv_dtype)), None
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)   # half-to-even
    return q.to(torch.int8), scale


def dequantize_kv(stored, scale, out_dtype):
    if scale is None:
        return stored.to(out_dtype)
    return (stored.float() * scale).to(out_dtype)


def attn_cache_shapes(cfg, batch: int, max_seq: int, rt: TunableConfig,
                      layers: Optional[int] = None):
    """Shapes/dtypes + logical names for a stacked KV cache."""
    L = cfg.n_layers if layers is None else layers
    kvd = torch_dtype(rt.kv_cache_dtype)
    shp = (L, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    logical = ("layers", "batch", "seq_data" if batch == 1 else None,
               "kv_heads", None)
    out = {"k": ShapeDtype(shp, kvd), "v": ShapeDtype(shp, kvd)}
    lg = {"k": logical, "v": logical}
    if rt.kv_cache_dtype == "int8":
        sshp = (L, batch, max_seq, cfg.n_kv_heads, 1)
        out["k_scale"] = ShapeDtype(sshp, torch.float32)
        out["v_scale"] = ShapeDtype(sshp, torch.float32)
        lg["k_scale"] = logical
        lg["v_scale"] = logical
    return out, lg


def decode_attention_block(p, x, layer_cache, pos: int, *, cfg,
                           rt: TunableConfig, rules):
    """One-token decode self-attention against a KV cache.

    x: (B,1,d); layer_cache: {'k','v'[,scales]} with shapes (B,Smax,Hkv,hd).
    pos: current position, a host integer.  The new K/V are written into
    ``layer_cache`` IN PLACE at ``pos`` for the whole batch (the caller
    decides whether that is the live cache or a copy, see
    ``transformer.decode_fn``).  Returns (out, layer_cache).
    """
    B = x.shape[0]
    pos = int(pos)
    q = heads_in(x, cast(p["wq"], rt))
    k = heads_in(x, cast(p["wk"], rt))
    v = heads_in(x, cast(p["wv"], rt))
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    kq, ks = quantize_kv(k, rt.kv_cache_dtype)
    vq, vs = quantize_kv(v, rt.kv_cache_dtype)
    cache = layer_cache
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]
    news = dict(zip(("k", "v", "k_scale", "v_scale"), (kq, vq, ks, vs)))

    def attend(qx, *bufs):
        # the cache write and the attention on plain (or local) tensors
        c = dict(zip(names, bufs[:len(names)]))
        for n, new in zip(names, bufs[len(names):]):
            c[n][:, pos:pos + 1] = new
        return _decode_attend(qx, c, pos, cfg, rt)

    args = [q] + [cache[n] for n in names] + [news[n] for n in names]
    if is_dtensor(cache["k"]):
        # each rank writes and attends its block of the cache: its batch
        # rows and its KV heads, the query's heads alongside them
        pl = tuple(cache["k"].placements)
        if any(getattr(pc, "dim", None) == 1 and n > 1 for pc, n in
               zip(pl, cache["k"].device_mesh.shape)):
            raise NotImplementedError(
                "decode against a cache split along its sequence (batch 1 "
                "on a data axis) is not ported (ROADMAP.md queue A, "
                "slice 7b)")
        args = [a.redistribute(a.device_mesh, pl) if is_dtensor(a) else a
                for a in args]
    o = sharded_kernel(attend, 0, *args)
    out = heads_out(o, cast(p["wo"], rt))
    return out, cache


def _decode_attend(q, cache, pos: int, cfg, rt: TunableConfig):
    """q: (B,1,H,hd) against the cache's first ``pos + 1`` rows."""
    if rt.attn_impl == "pallas":
        # flash-decode kernel: streams the live cache once at its stored
        # dtype (int8 dequant fused)
        from repro_torch.kernels.flash_decode import ops as fd_ops
        return fd_ops.flash_decode(q.contiguous(), cache["k"], cache["v"],
                                   pos + 1, cache.get("k_scale"),
                                   cache.get("v_scale"),
                                   block_kv=rt.attn_block_kv)
    n_rep = q.shape[2] // cache["k"].shape[2]
    kf = dequantize_kv(cache["k"], cache.get("k_scale"), dt(rt))
    vf = dequantize_kv(cache["v"], cache.get("v_scale"), dt(rt))
    kf = _repeat_kv(kf, n_rep)
    vf = _repeat_kv(vf, n_rep)
    smax = kf.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _scores(q, kf) * scale
    mask = (torch.arange(smax, device=q.device) <= pos)[None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    pr = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", pr, vf)


# ---------------------------------------------------------------- mlp
def mlp_spec(cfg, d_ff: Optional[int] = None) -> Dict[str, PSpec]:
    d = cfg.d_model
    ff = cfg.d_ff if d_ff is None else d_ff
    if cfg.mlp_act == "silu":
        return {"wg": PSpec((d, ff), ("embed", "mlp")),
                "wu": PSpec((d, ff), ("embed", "mlp")),
                "wd": PSpec((ff, d), ("mlp", "embed"))}
    return {"wu": PSpec((d, ff), ("embed", "mlp")),
            "wd": PSpec((ff, d), ("mlp", "embed"))}


def mlp_block(p, x, *, cfg, rt: TunableConfig, rules):
    if cfg.mlp_act == "silu":
        h = F.silu(x @ cast(p["wg"], rt)) * (x @ cast(p["wu"], rt))
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(x @ cast(p["wu"], rt)))
    else:   # the reference's gelu is the tanh approximation
        h = F.gelu(x @ cast(p["wu"], rt), approximate="tanh")
    if rules is not None:
        h = rules.constrain(h, "batch", None, "mlp")
    return h @ cast(p["wd"], rt)


# ---------------------------------------------------------------- embed
def padded_vocab(cfg, multiple: int = 512) -> int:
    return ((cfg.vocab + multiple - 1) // multiple) * multiple


def embed_spec(cfg) -> Dict[str, PSpec]:
    V = padded_vocab(cfg)
    out = {"embedding": PSpec((V, cfg.d_model), ("vocab", "embed"), 0.02)}
    if not cfg.tie_embeddings:
        out["unembed"] = PSpec((cfg.d_model, V), ("embed", "vocab"))
    return out


def embed(p, tokens, rt: TunableConfig):
    table = cast(p["embedding"], rt)
    if not is_dtensor(table):
        return table[tokens.long()]
    # on a mesh each rank looks its tokens up in its block of the table:
    # a vocab split stays split (rows outside the rank's slice read 0 and
    # the ranks' rows are summed), an embed split is gathered
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = replicated_like(tokens, table)
    keep = [p.is_shard(0) and not t.is_shard()
            for p, t in zip(table.placements, tokens.placements)]
    w_in = tuple(Shard(0) if k else Replicate() for k in keep)
    out = tuple(Partial() if k else t for k, t in zip(keep, tokens.placements))
    grad = tuple(Shard(0) if k else Partial() if t.is_shard() else Replicate()
                 for k, t in zip(keep, tokens.placements))
    lo = _block_start(mesh, w_in, 0, table.shape[0])

    def look(w, t):
        i = t.long() - lo
        inside = (i >= 0) & (i < w.shape[0])
        rows = w[i.clamp(0, w.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    y = local_map(look, out_placements=list(out),
                  in_placements=(w_in, tuple(tokens.placements)),
                  in_grad_placements=(grad, tuple(tokens.placements)),
                  device_mesh=mesh, redistribute_inputs=True)(table, tokens)
    return _reduced(y)


def _block_start(mesh, placements, dim: int, size: int) -> int:
    """The first index along ``dim`` (of extent ``size``) of this rank's
    block under ``placements`` (splits in mesh-dim order, each of
    ``torch.chunk``'s sizes)."""
    coord = mesh.get_coordinate()
    lo, cur = 0, size
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            step = -(-cur // mesh.size(i))
            lo += step * coord[i]
            cur = step
    return lo


def unembed(p, x, cfg, rt: TunableConfig, rules):
    """f32 logits from operands in the compute dtype: the operands are
    rounded to the compute dtype first and the product is then taken in
    f32, which accumulates AND returns f32 (a bf16 matmul would round the
    logits to bf16 and can flip an argmax)."""
    w = p.get("unembed")
    if w is None:
        w = p["embedding"].T
    if is_dtensor(w):
        logits = x.float() @ cast(w, rt).float()
    else:
        logits = torch.einsum("bsd,dv->bsv", x.float(), cast(w, rt).float())
    if rules is not None:
        logits = rules.constrain(logits, "batch", None, "vocab")
    return logits


def xent_loss(logits, labels, cfg):
    """logits: (B,S,Vpad) f32; labels: (B,S) integers.  Mean over tokens
    of logsumexp minus the gold logit, the padded columns masked to
    -1e30 first."""
    V = padded_vocab(cfg)
    mask = replicated_like(torch.arange(V, device=logits.device) >= cfg.vocab,
                           logits)
    logits = logits.masked_fill(mask, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    if not is_dtensor(logits):
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        gold = _gold_logit(logits, labels)
    return torch.mean(logz - gold)


def _gold_logit(logits, labels):
    """Each row's logit at its label, for DTensor logits: each rank reads
    it from its block of the vocab (0 where the label lies outside its
    slice) and the ranks' values are summed (a partial placement)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    last = logits.ndim - 1
    pl = tuple(logits.placements)
    if not any(p.is_shard(last) for p in pl):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    mesh = logits.device_mesh
    lab = tuple(p if p.is_shard() and not p.is_shard(last) else Replicate()
                for p in pl)
    out = tuple(Partial() if p.is_shard(last) else q for p, q in zip(pl, lab))
    lo = _block_start(mesh, pl, last, logits.shape[-1])

    def gold_of(lg, lb):
        i = lb.long() - lo
        inside = (i >= 0) & (i < lg.shape[-1])
        g = torch.gather(lg, -1, i.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(inside, g[..., 0], torch.zeros_like(g[..., 0]))

    return local_map(gold_of, out_placements=list(out),
                     in_placements=(pl, lab), device_mesh=mesh,
                     redistribute_inputs=True)(logits,
                                               replicated_like(labels, logits))
