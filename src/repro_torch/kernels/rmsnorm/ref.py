"""Plain PyTorch version of the fused RMSNorm kernel."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)
