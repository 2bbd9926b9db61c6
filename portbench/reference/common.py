"""Plain PyTorch pieces shared by the reference models.

Everything here computes in float32 from the weights it is handed
(which it upcasts), with TF32 off (``judge_mode``).  The control,
``Prec("fp8")``, rounds every linear layer's operands to e4m3 float8,
the precision below the bf16 a configuration is served in (activations
scaled per row and weights per output column to their largest
magnitude), and takes the product in float32 as before.
"""
from __future__ import annotations

import contextlib
import math

import torch

@contextlib.contextmanager
def judge_mode():
    """float32 products with TF32 off, gradients off, restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def _fp8(t, dim):
    """``t`` rounded to e4m3, scaled to its largest magnitude along
    ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Prec:
    """The precision of the linear layers: ``"f32"`` or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown reference precision {kind!r}")
        self.kind = kind

    def mm(self, x, w):
        """``x @ w`` for x (..., k) and w (k, n), in float32."""
        x, w = x.float(), w.float()
        if self.kind == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w


def rmsnorm(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, positions, theta):
    """x (B, S, H, hd); positions (B, S): the halves rotated."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = positions.float()[..., None, None] * inv
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def causal_attention(q, k, v, block=512):
    """q, k, v (B, S, H, hd) float32 -> (B, S, H, hd), in query blocks."""
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    kt = k.permute(0, 2, 3, 1)                    # (B, H, hd, S)
    vt = v.permute(0, 2, 1, 3)                    # (B, H, S, hd)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        qb = q[:, lo:hi].permute(0, 2, 1, 3)      # (B, H, b, hd)
        s = (qb @ kt[..., :hi]) / math.sqrt(hd)
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[:, lo:hi] = (torch.softmax(s, -1) @ vt[:, :, :hi]) \
            .permute(0, 2, 1, 3)
    return out


def heads(prec, x, w):
    """x (B, S, d) with w (d, H, hd) -> (B, S, H, hd)."""
    d, H, hd = w.shape
    return prec.mm(x, w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


def attention(prec, p, x, positions, theta, n_heads, n_kv):
    """The self-attention sub-block on normed x (B, S, d)."""
    q = rope(heads(prec, x, p["wq"]), positions, theta)
    k = rope(heads(prec, x, p["wk"]), positions, theta)
    v = heads(prec, x, p["wv"])
    rep = n_heads // n_kv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    o = causal_attention(q, k, v)
    H, hd, d = p["wo"].shape
    return prec.mm(o.reshape(*o.shape[:2], H * hd), p["wo"].reshape(H * hd, d))


def layer(tree, i):
    """Leaf ``i`` along the leading (layers) dim of every leaf."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]
