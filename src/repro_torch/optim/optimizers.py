"""Optimizers: hand-rolled transformations over trees of tensors.

AdamW for everything that fits; Adafactor (factored second moments) for
the trillion-parameter archs whose Adam state exceeds the fleet's
memory.  This is the PyTorch port of the reference's
``optim/optimizers.py``: no ``torch.optim``; the update formulas, where
``eps`` sits and the order of the clip are the reference's, and the
state is a tree of tensors with the reference's leaf layout
(``{"mu", "nu", "step"}`` for AdamW, ``{"fac", "step"}`` for Adafactor),
so a checkpoint of it carries the reference's keys.

``state_specs`` gives the state's sharding specs from the parameters'
(the reference's): the moments take their parameter's spec, Adafactor's
factored moments its spec minus the reduced dim.  On a mesh the state
and the gradients are DTensors and ``update`` runs on them as it is:
the global norm of the clip and Adafactor's row and column means are
global reductions, so they stay global (each is reduced leaf by leaf,
over all of a leaf's mesh dims at once).

``update`` is functional by default: it returns new parameter and state
trees and leaves its inputs as they were.  With ``inplace=True`` (the
train step when it is asked to donate its buffers, runtime/stepfn.py)
it writes the new values into the parameters and the state, leaf by
leaf, and returns those same trees: the same operations in the same
order, so the two give the same bits.  The step counter and the
learning rate stay tensors on the parameters' device, so an update
reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.runtime.loops import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, inplace=False)
    #   -> (new_params, new_state, metrics)
    update: Callable[..., Tuple[Any, Any, Dict]]
    # (param_specs, param_shapes) -> the state's specs (sharding rules)
    state_specs: Optional[Callable[..., Any]] = None


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_whole(torch.sum(torch.square(x.float())))
                          for x in tree_leaves(tree)))


def _whole(t):
    """A reduction of a DTensor with its pending sums reduced, those over
    several mesh dims in one all-reduce (``sharding.reduced``); a
    tensor as it is."""
    from repro_torch.runtime import sharding as SH
    return SH.reduced(t) if SH.is_dtensor(t) else t


def clip_by_global_norm(tree, max_norm: float):
    gn = _global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), gn


# ------------------------------------------------------------ schedules
def _step_f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    def lr(step):
        step = _step_f32(step)
        warm = peak_lr * torch.clamp(step / max(1, warmup), max=1.0)
        frac = torch.clamp((step - warmup) / max(1, total - warmup),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_val: float) -> Callable:
    def lr(step):
        dev = step.device if torch.is_tensor(step) else None
        return torch.tensor(lr_val, dtype=torch.float32, device=dev)
    return lr


def _zeros_f32(p) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _ema(x, beta, new, inplace: bool):
    """``beta * x + (1 - beta) * new``, written into ``x`` when
    ``inplace``."""
    if inplace:
        return x.mul_(beta).add_((1 - beta) * new)
    return beta * x + (1 - beta) * new


def _apply(p, u, lr_t, inplace: bool):
    """``p - lr_t * u`` in f32, cast back to ``p``'s dtype; written into
    ``p`` when ``inplace``."""
    if inplace and p.dtype == torch.float32:
        return p.sub_(lr_t * u)
    new = (p.float() - lr_t * u).to(p.dtype)
    return p.copy_(new) if inplace else new


def _next_step(step, inplace: bool):
    return step.add_(1) if inplace else step + 1


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


# ------------------------------------------------------------ adamw
def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_f32, params),
                "nu": tree_map(_zeros_f32, params),
                "step": _step0(params)}

    def update(grads, state, params, inplace: bool = False):
        grads = tree_map(lambda g: g.float(), grads)
        if clip_norm is not None:
            grads, gn = clip_by_global_norm(grads, clip_norm)
        else:
            gn = _global_norm(grads)
        step = _next_step(state["step"], inplace)
        t = step.float()
        lr_t = lr(step)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        mu = tree_map2(lambda m, g: _ema(m, b1, g, inplace),
                       state["mu"], grads)
        nu = tree_map2(lambda v, g: _ema(v, b2, torch.square(g), inplace),
                       state["nu"], grads)

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            return _apply(p, u, lr_t, inplace)
        new_p = tree_map3(upd, params, mu, nu)
        return (new_p, {"mu": mu, "nu": nu, "step": step},
                {"grad_norm": gn, "lr": lr_t})

    def state_specs(param_specs, param_shapes=None):
        return {"mu": param_specs, "nu": param_specs, "step": ()}

    return Optimizer(init, update, state_specs)


# ------------------------------------------------------------ adafactor
def adafactor(lr: Callable, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim: int = 64) -> Optimizer:
    """Factored second moments over the last two dims of big matrices."""
    def _factored(p):
        return len(p.shape) >= 2 and p.shape[-1] >= min_dim \
            and p.shape[-2] >= min_dim

    def init(params):
        def mk(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_f32(p)}
        return {"fac": tree_map(mk, params), "step": _step0(params)}

    def update(grads, state, params, inplace: bool = False):
        step = _next_step(state["step"], inplace)
        t = step.float()
        lr_t = lr(step)
        beta2 = 1.0 - torch.pow(t, -0.8)

        def upd(p, g, s):
            g = g.float()
            g2 = torch.square(g) + eps
            if _factored(p):
                vr = _ema(s["vr"], beta2, _whole(torch.mean(g2, dim=-1)),
                          inplace)
                vc = _ema(s["vc"], beta2, _whole(torch.mean(g2, dim=-2)),
                          inplace)
                denom = torch.clamp(
                    _whole(torch.mean(vr, dim=-1, keepdim=True)),
                    min=eps)[..., None]
                u = g * torch.rsqrt(vr[..., None] / denom) \
                    * torch.rsqrt(vc[..., None, :])
                new_s = {"vr": vr, "vc": vc}
            else:
                v = _ema(s["v"], beta2, g2, inplace)
                u = g * torch.rsqrt(v)
                new_s = {"v": v}
            rms = torch.sqrt(_whole(torch.mean(torch.square(u))) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return _apply(p, u, lr_t, inplace), new_s

        new_p, new_fac = _unzip(tree_map3(upd, params, grads,
                                          state["fac"]))
        return (new_p, {"fac": new_fac, "step": step},
                {"grad_norm": _global_norm(grads), "lr": lr_t})

    def state_specs(param_specs, param_shapes):
        def mk(spec, shp):
            spec = tuple(spec) + (None,) * (len(shp.shape) - len(spec))
            if _factored(shp):
                # vr drops the last dim, vc drops the second-to-last
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"fac": tree_map2(mk, param_specs, param_shapes),
                "step": ()}

    return Optimizer(init, update, state_specs)


def make_optimizer(name: str, lr: Callable = None, **kw) -> Optimizer:
    lr = lr or cosine_schedule(3e-4, 100, 10_000)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


# ------------------------------------------------------------ trees
def tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of the same structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def tree_map3(fn, a, b, c):
    """``fn`` over the leaves of ``a`` and the matching parts of ``b``
    and ``c``; where ``a`` has a leaf, ``c`` may hold a subtree, which
    is handed over whole (Adafactor's per-parameter state)."""
    if isinstance(a, dict):
        return {k: tree_map3(fn, a[k], b[k], c[k]) for k in a}
    return fn(a, b, c)


def _unzip(tree):
    """A tree of ``(x, y)`` leaves -> the tree of ``x`` and of ``y``."""
    if isinstance(tree, dict):
        pairs = {k: _unzip(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return tree
