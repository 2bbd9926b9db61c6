"""Train / serve steps: the step a workload cell runs.

This is the PyTorch port of the single-device path of the reference's
``runtime/stepfn.py``.  ``build_step`` returns a :class:`StepBundle`: the
step as a plain function over tensors (``fn``) and the shapes and dtypes
of its arguments (``args``, :class:`~repro_torch.models.layers.ShapeDtype`
stand-ins in call order; ``measure_args`` makes them).  Everything a
step needs is built here, once: a call of ``fn`` builds nothing, so a
timed call is the step's own cost.

Kinds (``shape.kind``):

  * ``train`` — ``fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients w.r.t. the f32 master
    parameters (cast to the compute dtype once per step, inside the
    differentiated function, so the gradients come back in f32), split
    into ``microbatches`` whose gradients are summed in f32 and averaged,
    then one optimizer update.  The kernels are forward-only, as the
    reference's are, so the step takes attention and norm through the
    eager ops (``attn_impl="xla"``) whatever the config says.
  * ``prefill`` — ``fn(params, batch) -> (logits, cache)`` at the cell's
    length; ``decode`` — ``fn(params, cache, tokens) -> (logits,
    cache)``, one token against a cache as deep as the cell's length
    (at position 0, or at its last row with seeded values when the shape
    says ``cache_filled``).  Their parameters are the serving paths'
    (matrices in the compute dtype, ``Model.cast_params``).

``donate_buffers`` keeps its meaning: true updates the parameters and
the optimizer state (train: the optimizer's in-place update, leaf by
leaf) or the cache (decode) in place and returns the same tensors;
false returns new tensors and leaves the inputs as they were.  On one device ``shard_strategy``, ``grad_comm_dtype`` and
``fuse_grad_collectives`` reach nothing (there is no collective); a mesh
of more than one device raises, naming the multi-device slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Model, build_model, input_specs
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.runtime.loops import tree_leaves, tree_map
from repro_torch.runtime.remat import torch_dtype

MULTI_DEVICE = "ROADMAP.md queue A, slice 7: multi-device"
# knobs whose only reach is a collective or a sharding: measured no-ops
# on one device, recorded in every bundle's notes
ONE_DEVICE_NO_OPS = ("shard_strategy", "grad_comm_dtype",
                     "fuse_grad_collectives")


def require_one_device(mesh) -> None:
    """``mesh`` is None (this one device) or the mesh's axis sizes, a
    mapping like the reference's ``dict(mesh.shape)``; more than one
    device raises."""
    if mesh is None:
        return
    n = math.prod(int(v) for v in dict(mesh).values())
    if n > 1:
        raise NotImplementedError(
            f"a mesh of {n} devices ({dict(mesh)}) is not ported yet "
            f"({MULTI_DEVICE}); the port's steps run on one device")


def require_trainable(cfg: ArchConfig) -> None:
    """Raise for a family whose training path is not ported."""
    build_model(cfg)                      # raises for unported families
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training {cfg.name} ({cfg.family}) is not ported yet: the "
            f"{cfg.family} loss_fn comes with ROADMAP.md queue A, slice 5 "
            "(the other families)")


def cast_params_for_compute(params, rt: TunableConfig):
    """Every floating leaf cast to the compute dtype, as the reference
    casts its master weights once before any use.  Inside the train
    step's differentiated function, so gradients reach the f32 masters
    through the cast."""
    comp = torch_dtype(rt.compute_dtype)
    return tree_map(
        lambda x: x.to(comp) if x.is_floating_point() and x.dtype != comp
        else x, params)


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one workload cell's step."""
    fn: Callable                  # the step, a plain function over tensors
    args: Tuple                   # ShapeDtype stand-ins (call order)
    rules: Any                    # sharding rules: None on one device
    kind: str                     # train | prefill | decode
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fill_cache: bool = False      # decode: seeded values in the cache

    def measure_args(self, device) -> Tuple:
        """The measured evaluator's default arguments on ``device``:
        zeros of the bundle's shapes and dtypes (a time depends on
        shapes and dtypes, not values), except that a decode step built
        for a filled cache (``ShapeConfig.cache_filled``) gets seeded
        random values in its cache (its position in ``args`` is already
        the last row).  Host integers (a decode cache's position) are
        kept as they are."""
        args = tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device)
            if isinstance(s, L.ShapeDtype) else s, self.args)
        if not self.fill_cache:
            return args
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        for t in tree_leaves(args[1]):
            if not torch.is_tensor(t):
                continue
            if t.is_floating_point():
                t.normal_(generator=gen)
            else:
                t.random_(-127, 128, generator=gen)
        return args


def _shapes_of(tree):
    return tree_map(lambda t: L.ShapeDtype(tuple(t.shape), t.dtype)
                    if torch.is_tensor(t) else t, tree)


def _meta_params(model: Model):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"),
                    model.param_shapes())


def _notes(rt: TunableConfig, **extra) -> Dict[str, Any]:
    return {"one_device_no_ops": {k: getattr(rt, k)
                                  for k in ONE_DEVICE_NO_OPS}, **extra}


def _grad(loss, leaves):
    # a parameter the loss does not reach gets a zero gradient, as in
    # the reference
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ===================================================================== train
def build_train_step(cfg: ArchConfig, shape: ShapeConfig, rt: TunableConfig,
                     mesh=None, optimizer: Optional[Optimizer] = None
                     ) -> StepBundle:
    require_one_device(mesh)
    require_trainable(cfg)
    model = build_model(cfg)
    optimizer = optimizer or make_optimizer(cfg.optimizer)
    notes = _notes(rt, attn_impl=rt.attn_impl)
    if rt.attn_impl == "pallas":
        # the kernels are forward-only: the gradient step takes attention
        # and norm through the eager ops, as the reference's does
        rt = rt.replace(attn_impl="xla")
        notes["attn_impl"] = "xla (the kernels are forward-only)"
    m = rt.microbatches
    if shape.global_batch % m:
        raise ValueError(f"microbatches={m} does not divide the batch "
                         f"{shape.global_batch}")
    donate = rt.donate_buffers
    meta = _meta_params(model)
    args = (_shapes_of(meta), _shapes_of(optimizer.init(meta)),
            input_specs(cfg, shape, rt))

    def loss_of(p, b):
        loss, _ = model.loss_fn(cast_params_for_compute(p, rt), b, rt, None)
        return loss

    def step(params, opt_state, batch):
        work = tree_map(lambda x: x.detach().requires_grad_(), params)
        leaves = tree_leaves(work)
        with torch.enable_grad():
            if m == 1:
                loss = loss_of(work, batch)
                grads = list(_grad(loss, leaves))
            else:
                rows = batch["tokens"].shape[0] // m
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                grads = [torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device) for x in leaves]
                for i in range(m):
                    mb = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    lm = loss_of(work, mb)
                    gm = _grad(lm, leaves)
                    loss = loss + lm.detach().float()
                    grads = [a + g.float() for a, g in zip(grads, gm)]
                loss = loss / m
                grads = [g / m for g in grads]
        del work, leaves
        with torch.no_grad():
            new_p, new_s, met = optimizer.update(
                _unflatten(params, grads), opt_state, params,
                inplace=donate)
        return new_p, new_s, dict(met, loss=loss.detach())

    return StepBundle(step, args, None, "train", notes=notes)


# ===================================================================== serve
def _serve_params(model: Model, rt: TunableConfig):
    """Shapes of the serving paths' parameters: matrices in the compute
    dtype, as ``Model.cast_params`` leaves them."""
    return _shapes_of(model.cast_params(_meta_params(model), rt))


def build_prefill_step(cfg: ArchConfig, shape: ShapeConfig,
                       rt: TunableConfig, mesh=None) -> StepBundle:
    require_one_device(mesh)
    model = build_model(cfg)

    def step(params, batch):
        with torch.no_grad():
            return model.prefill_fn(params, batch, rt, None,
                                    max_seq=shape.seq_len)

    return StepBundle(step, (_serve_params(model, rt),
                             input_specs(cfg, shape, rt)),
                      None, "prefill", notes=_notes(rt))


def build_decode_step(cfg: ArchConfig, shape: ShapeConfig,
                      rt: TunableConfig, mesh=None) -> StepBundle:
    """One-token serve step against a seq_len-deep cache.  The cache's
    position is a host integer, as in the serving path: in ``args`` 0, or
    the last row (``seq_len - 1``) where the shape says
    ``cache_filled``."""
    require_one_device(mesh)
    model = build_model(cfg)
    cache, _ = model.cache_shapes(shape.global_batch, shape.seq_len, rt)
    cache = dict(cache, pos=shape.seq_len - 1 if shape.cache_filled else 0)
    tokens = L.ShapeDtype((shape.global_batch, 1), torch.int32)

    def step(params, cache, tokens):
        with torch.no_grad():
            return model.decode_fn(params, cache, tokens, rt, None)

    return StepBundle(step, (_serve_params(model, rt), cache, tokens),
                      None, "decode", notes=_notes(rt),
                      fill_cache=shape.cache_filled)


def build_step(cfg: ArchConfig, shape: ShapeConfig, rt: TunableConfig,
               mesh=None) -> StepBundle:
    """Dispatch on the cell kind (train_* -> train, decode_* -> decode...)."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, rt, mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, rt, mesh)
    return build_decode_step(cfg, shape, rt, mesh)
