"""Plain PyTorch version of the flash attention kernel."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """q/k/v: (B, H, S, hd) -> (B, H, S, hd); softmax in f32."""
    B, H, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
