"""Architecture configuration system.

Every assigned architecture is a frozen ``ArchConfig``.  The *full* configs
are exercised only through the dry-run (``ShapeDtypeStruct``, no
allocation); ``reduced()`` returns a same-family small config used by the
CPU smoke tests and the end-to-end examples.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                    # dense MLP width; for moe: per-expert width
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    mlp_act: str = "silu"            # silu | gelu | relu2
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0          # zamba: shared attn block after every k ssm blocks
    slstm_every: int = 0         # xlstm: sLSTM block every k blocks (others mLSTM)
    # --- encoder-decoder ---
    enc_layers: int = 0          # if >0, n_layers is the decoder depth
    enc_seq_ratio: int = 4       # enc frames = seq_len // ratio (audio frontend stub)
    # --- multimodal frontend stub ---
    frontend_tokens: int = 0     # precomputed patch/frame embeddings prepended
    # --- misc ---
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    optimizer: str = "adamw"     # adamw | adafactor
    param_dtype: str = "float32"  # master-weight dtype (bf16 for 1T-scale)
    fsdp_axes: Tuple[str, ...] = ("data",)   # biggest models add "pod"
    norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode a 500k context without O(S) per-token attention?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic total parameter count (used for 6·N·D model FLOPs)."""
        d, hd = self.d_model, self.hd
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        attn = qkv + (self.n_heads * hd) * d
        if self.mlp_act == "silu":
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        per_layer_norms = 2 * d
        if self.family == "moe":
            router = d * self.n_experts
            mlp = self.n_experts * (3 * d * self.d_ff) + router
            layer = attn + mlp + per_layer_norms
            body = self.n_layers * layer
        elif self.family == "ssm":
            # xlstm: mLSTM blocks ~ linear-attn qkv + out + gates
            m_layer = (d * (self.n_heads * hd) * 3 + (self.n_heads * hd) * d
                       + 4 * d + 2 * d)
            body = self.n_layers * m_layer
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm_layer = (d * 2 * d_in                         # in_proj (x, z)
                         + d * 2 * self.ssm_state             # B, C proj
                         + d * (d_in // self.ssm_head_dim)    # dt proj
                         + d_in * d                           # out proj
                         + 2 * d)
            shared = attn + mlp_dense + per_layer_norms       # one shared attn block
            body = self.n_layers * ssm_layer + shared
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + mlp_dense + per_layer_norms)
            cross = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
            dec = self.n_layers * (attn + cross + mlp_dense + 3 * d)
            body = enc + dec
        else:  # dense, vlm
            body = self.n_layers * (attn + mlp_dense + per_layer_norms)
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(body + embed + d)

    def encdec_split(self):
        """(enc_body, dec_body, embed) params — encdec FLOPs accounting."""
        d, hd = self.d_model, self.hd
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        attn = qkv + (self.n_heads * hd) * d
        mlp = (3 if self.mlp_act == "silu" else 2) * d * self.d_ff
        enc = self.enc_layers * (attn + mlp + 2 * d)
        cross = attn
        dec = self.n_layers * (attn + cross + mlp + 3 * d)
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return enc, dec, embed

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        total = self.param_count()
        expert_p = self.n_experts * 3 * self.d_model * self.d_ff * self.n_layers
        active_expert_p = self.top_k * 3 * self.d_model * self.d_ff * self.n_layers
        return int(total - expert_p + active_expert_p)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a cell runs; (False, reason) for documented skips."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, ("pure full-attention arch: 500k-token decode has no "
                       "sub-quadratic mechanism in the published architecture "
                       "(skip noted in DESIGN.md §4)")
    return True, ""
