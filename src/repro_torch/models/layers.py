"""Shared model-zoo building blocks (plain functions on tensors, dict
parameter trees).

Parameters are declared as ``PSpec`` trees: shape + logical dim names +
init scale.  The same tree yields real tensors (``init_params``) and
shape stand-ins (``param_shapes``).  The logical names are kept so the
trees match the reference's; sharding them is a later slice
(ROADMAP.md, queue A: multi-device), and every function here raises on
a non-``None`` ``rules`` argument until then.

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


def require_no_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "sharding rules are not ported yet (ROADMAP.md queue A, "
            "multi-device: runtime/sharding.py); pass rules=None")


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
        return rms_ops.rmsnorm(x.contiguous(), scale, eps=eps)
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
    sin, cos = torch.sin(ang), torch.cos(ang)
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
    """q: (B,Sq,H,hd), k/v: (B,Skv,H,hd) (already GQA-repeated)."""
    require_no_rules(rules)
    if rt.attn_impl == "pallas" and causal and q.shape[1] == k.shape[1]:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True,
                                      block_q=rt.attn_block_q,
                                      block_kv=rt.attn_block_kv)
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
    require_no_rules(rules)
    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, cast(p["wq"], rt))
    k = torch.einsum("bsd,dhk->bshk", src, cast(p["wk"], rt))
    v = torch.einsum("bsd,dhk->bshk", src, cast(p["wv"], rt))
    if kv_x is None:      # self-attention gets RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_positions is None else kv_positions,
                 cfg.rope_theta)
    k = _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    o = full_attention(q, k, v, causal=causal and kv_x is None, rt=rt,
                       rules=rules)
    return torch.einsum("bshk,hkd->bsd", o, cast(p["wo"], rt))


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
    require_no_rules(rules)
    B = x.shape[0]
    pos = int(pos)
    q = torch.einsum("bsd,dhk->bshk", x, cast(p["wq"], rt))
    k = torch.einsum("bsd,dhk->bshk", x, cast(p["wk"], rt))
    v = torch.einsum("bsd,dhk->bshk", x, cast(p["wv"], rt))
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    kq, ks = quantize_kv(k, rt.kv_cache_dtype)
    vq, vs = quantize_kv(v, rt.kv_cache_dtype)
    cache = layer_cache
    cache["k"][:, pos:pos + 1] = kq
    cache["v"][:, pos:pos + 1] = vq
    if ks is not None:
        cache["k_scale"][:, pos:pos + 1] = ks
        cache["v_scale"][:, pos:pos + 1] = vs
    if rt.attn_impl == "pallas":
        # flash-decode kernel: streams the live cache once at its stored
        # dtype (int8 dequant fused)
        from repro_torch.kernels.flash_decode import ops as fd_ops
        o = fd_ops.flash_decode(q.contiguous(), cache["k"], cache["v"],
                                pos + 1, cache.get("k_scale"),
                                cache.get("v_scale"),
                                block_kv=rt.attn_block_kv)
    else:
        kf = dequantize_kv(cache["k"], cache.get("k_scale"), dt(rt))
        vf = dequantize_kv(cache["v"], cache.get("v_scale"), dt(rt))
        kf = _repeat_kv(kf, cfg.n_heads // cfg.n_kv_heads)
        vf = _repeat_kv(vf, cfg.n_heads // cfg.n_kv_heads)
        smax = kf.shape[1]
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = _scores(q, kf) * scale
        mask = (torch.arange(smax, device=x.device) <= pos)[None, None, None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        pr = torch.softmax(scores, dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, vf)
    out = torch.einsum("bshk,hkd->bsd", o, cast(p["wo"], rt))
    return out, cache


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
    require_no_rules(rules)
    if cfg.mlp_act == "silu":
        h = F.silu(x @ cast(p["wg"], rt)) * (x @ cast(p["wu"], rt))
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(x @ cast(p["wu"], rt)))
    else:   # the reference's gelu is the tanh approximation
        h = F.gelu(x @ cast(p["wu"], rt), approximate="tanh")
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
    return cast(p["embedding"], rt)[tokens.long()]


def unembed(p, x, cfg, rt: TunableConfig, rules):
    """f32 logits from operands in the compute dtype: the operands are
    rounded to the compute dtype first and the product is then taken in
    f32, which accumulates AND returns f32 (a bf16 matmul would round the
    logits to bf16 and can flip an argmax)."""
    require_no_rules(rules)
    w = p.get("unembed")
    if w is None:
        w = p["embedding"].T
    return torch.einsum("bsd,dv->bsv", x.float(), cast(w, rt).float())


def xent_loss(logits, labels, cfg):
    """logits: (B,S,Vpad) f32; labels: (B,S) integers.  Mean over tokens
    of logsumexp minus the gold logit, the padded columns masked to
    -1e30 first."""
    V = padded_vocab(cfg)
    mask = torch.arange(V, device=logits.device) >= cfg.vocab
    logits = logits.masked_fill(mask, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
