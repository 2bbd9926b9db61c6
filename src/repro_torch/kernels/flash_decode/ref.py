"""Plain PyTorch version of the flash-decode kernel."""
from __future__ import annotations

import torch


def decode_ref(q, k, v, k_scale, v_scale, length):
    """q: (B,H,1,hd); k/v: (B,Hkv,S,hd) (+(B,Hkv,S,1) int8 scales);
    length: live positions (int).  Returns (B,H,1,hd) f32."""
    B, H, _, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale
        vf = vf * v_scale
    n_rep = H // Hkv
    kf = torch.repeat_interleave(kf, n_rep, dim=1)
    vf = torch.repeat_interleave(vf, n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    s = s / (hd ** 0.5)
    mask = torch.arange(S, device=q.device)[None, None, None, :] < int(length)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf)
