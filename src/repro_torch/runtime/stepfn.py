"""Train / serve steps: the step a workload cell runs.

This is the PyTorch port of the reference's ``runtime/stepfn.py``.
``build_step`` returns a :class:`StepBundle`: the step as a plain
function over tensors (``fn``) and the shapes and dtypes of its
arguments (``args``, :class:`~repro_torch.models.layers.ShapeDtype`
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
false returns new tensors and leaves the inputs as they were.

``mesh`` is None (this one device), a ``DeviceMesh`` (``launch/mesh``)
or a mesh no process holds (``launch.mesh.AbstractMesh``, a mapping of
axis sizes).  A mesh of one device keeps the one-device step above
(``rules`` None, the same notes, the same cost: the reference runs a
(1, 1) mesh through its auto path, which is numerically the same).  On
one device ``shard_strategy``, ``grad_comm_dtype`` and
``fuse_grad_collectives`` reach nothing (there is no collective), nor,
in an MoE cell, ``comm_codec`` and the config's ``capacity_factor``
(only the expert-parallel paths read them): the notes record them
(``one_device_no_ops``).  A ``DeviceMesh`` of more than one device
(or any, through ``build_mesh_train_step``) takes the reference's two
train paths (notes ``explicit_comm`` and
``sharding_notes``, as the reference's):

  * explicit (``gradsync.explicit_applicable``: dp or fsdp, a data axis
    above 1, not moe) — each rank runs the model on local tensors with
    ``rules=None`` (fsdp parameters all-gathered first) on its batch
    rows, and ``gradsync`` reduces the gradients with explicit
    collectives in ``grad_comm_dtype`` (``int8_ef``: error feedback, its
    residual kept in the optimizer state as ``{"opt", "ef"}``);
  * auto — parameters, optimizer state and batch are DTensors on the
    placements of ``ShardingRules``; the model runs on them with the
    rules (``rules.constrain`` redistributes), DTensor places the
    collectives, and each gradient is brought to its parameter's
    placements before the update (also dp and fsdp with a data axis of
    1, as in the reference).

The step's parameters and state are DTensors on a mesh (a full tensor
that every rank holds is cut to the rank's block on the way in).  Serve
steps on a mesh run ``prefill_fn`` / ``decode_fn`` on DTensors with the
rules; the kernels run on local blocks under ``local_map``.  The
families whose serve steps on a mesh wait for slice 7b
(``SERVE_WAITS``) raise there; every family trains on a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.params import TunableConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import layers as L
from repro_torch.models.model import (Model, batch_logical, build_model,
                                      input_specs)
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.runtime import gradsync
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.loops import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime.remat import torch_dtype

# knobs whose only reach is a collective or a sharding: measured no-ops
# on one device, recorded in every one-device bundle's notes
ONE_DEVICE_NO_OPS = ("shard_strategy", "grad_comm_dtype",
                     "fuse_grad_collectives")
# and, in an MoE cell, the expert-parallel paths' wire dtype (a knob) and
# expert capacity (a config field): the one-device MoE path reads neither
MOE_ONE_DEVICE_NO_OPS = ("comm_codec", "capacity_factor")
SLICE_7B = "ROADMAP.md queue A, slice 7b"
DRY_RUN = "ROADMAP.md queue A, slice 9: the dry run"
# families whose serve steps on a mesh are not covered yet (their train
# steps are, under every strategy)
SERVE_WAITS = frozenset({"hybrid", "ssm", "encdec"})


def mesh_size(mesh) -> int:
    return 1 if mesh is None else math.prod(axis_sizes(mesh).values())


def one_device(mesh) -> bool:
    """True where the step is the one-device step: no mesh, or a mesh of
    one device.  A mesh of more than one device that no process holds
    raises (building for it without devices is the dry run's)."""
    if mesh_size(mesh) == 1:
        return True
    if not hasattr(mesh, "mesh_dim_names"):
        raise NotImplementedError(
            f"a mesh of {mesh_size(mesh)} devices that no process holds "
            f"({axis_sizes(mesh)}): building a step for it without the "
            f"devices is not ported yet ({DRY_RUN}); pass a DeviceMesh")
    return False


def build_rules(mesh, cfg: ArchConfig, rt: TunableConfig
                ) -> SH.ShardingRules:
    return SH.ShardingRules(mesh=mesh, strategy=rt.shard_strategy,
                            fsdp_axes=cfg.fsdp_axes,
                            attn_tp_fallback=rt.attn_tp_fallback)


def cast_params_for_compute(params, rt: TunableConfig):
    """Every floating leaf cast to the compute dtype, as the reference
    casts its master weights once before any use (before an fsdp gather,
    so the gather moves compute-dtype bytes).  Inside the train
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
    # on a mesh: the specs of the arguments (call order; train's optimizer
    # state with the EF residual when it carries one)
    specs: Optional[Tuple] = None

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


def _notes(cfg: ArchConfig, rt: TunableConfig, **extra) -> Dict[str, Any]:
    notes = {"one_device_no_ops": {k: getattr(rt, k)
                                   for k in ONE_DEVICE_NO_OPS}}
    if cfg.family == "moe":
        notes["moe_one_device_no_ops"] = {
            "comm_codec": rt.comm_codec,
            "capacity_factor": cfg.capacity_factor}
    return dict(notes, **extra)


def _grad(loss, leaves):
    # a parameter the loss does not reach gets a zero gradient, as in
    # the reference
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


# ===================================================================== train
def build_train_step(cfg: ArchConfig, shape: ShapeConfig, rt: TunableConfig,
                     mesh=None, optimizer: Optional[Optimizer] = None
                     ) -> StepBundle:
    """The train step: the one-device step where ``mesh`` is None or holds
    one device, else the mesh step (:func:`build_mesh_train_step`)."""
    if not one_device(mesh):
        return build_mesh_train_step(cfg, shape, rt, mesh, optimizer)
    model, optimizer, rt, attn_note, args = _train_parts(cfg, shape, rt,
                                                         optimizer)
    step = _local_train_step(model, rt, optimizer)
    return StepBundle(step, args, None, "train",
                      notes=_notes(cfg, rt, attn_impl=attn_note))


def _train_parts(cfg, shape, rt, optimizer):
    """(model, optimizer, rt, attn note, args) of a train step."""
    model = build_model(cfg)
    optimizer = optimizer or make_optimizer(cfg.optimizer)
    attn_note = rt.attn_impl
    if rt.attn_impl == "pallas":
        # the kernels are forward-only: the gradient step takes attention
        # and norm through the eager ops, as the reference's does
        rt = rt.replace(attn_impl="xla")
        attn_note = "xla (the kernels are forward-only)"
    m = rt.microbatches
    if shape.global_batch % m:
        raise ValueError(f"microbatches={m} does not divide the batch "
                         f"{shape.global_batch}")
    meta = _meta_params(model)
    args = (_shapes_of(meta), _shapes_of(optimizer.init(meta)),
            input_specs(cfg, shape, rt))
    return model, optimizer, rt, attn_note, args


def _local_grads(model: Model, rt: TunableConfig, params, batch, rules=None,
                 prepare=None):
    """(loss, f32 gradients as a list in ``tree_leaves(params)`` order) of
    the mean loss over ``batch``, split into ``rt.microbatches`` row
    blocks whose gradients are summed in f32 and averaged.  ``prepare``
    maps the differentiated leaves' tree to the parameters the model
    reads (default: the compute-dtype cast)."""
    prepare = prepare or (lambda p: cast_params_for_compute(p, rt))
    m = rt.microbatches
    work = tree_map(lambda x: x.detach().requires_grad_(), params)
    leaves = tree_leaves(work)

    def loss_of(b):
        loss, _ = model.loss_fn(prepare(work), b, rt, rules)
        return loss

    with torch.enable_grad(), _sharded(rules):
        if m == 1:
            loss = loss_of(batch)
            grads = list(_grad(loss, leaves))
        else:
            rows = _rows(batch) // m
            loss, grads = None, None
            for i in range(m):
                mb = {k: _row_block(v, i * rows, rows)
                      for k, v in batch.items()}
                lm = loss_of(mb)
                gm = _grad(lm, leaves)
                lm = lm.detach().float()
                loss = lm if loss is None else loss + lm
                gm = [g.float() for g in gm]
                grads = gm if grads is None else \
                    [a + g for a, g in zip(grads, gm)]
            loss = loss / m
            grads = [g / m for g in grads]
    return loss.detach(), grads


def _rows(batch) -> int:
    t = batch["tokens"]
    return (t.to_local() if SH.is_dtensor(t) else t).shape[0]


def _row_block(t, start: int, n: int):
    """Rows [start, start + n) of a batch tensor; of a DTensor, of each
    rank's local rows (the microbatches then hold other rows of the
    global batch than the one-device split, and the mean over them all
    is the same)."""
    if not SH.is_dtensor(t):
        return t[start:start + n]
    from torch.distributed.tensor import DTensor
    loc = t.to_local()[start:start + n]
    shape = (t.shape[0] * n // t.to_local().shape[0],) + tuple(t.shape[1:])
    return DTensor.from_local(loc, t.device_mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=loc.contiguous().stride())


def _sharded(rules):
    from repro_torch.models.model import _sharded as ctx
    return ctx(rules)


def _local_train_step(model: Model, rt: TunableConfig,
                      optimizer: Optimizer):
    """The one-device step."""
    donate = rt.donate_buffers

    def step(params, opt_state, batch):
        loss, grads = _local_grads(model, rt, params, batch)
        with torch.no_grad():
            new_p, new_s, met = optimizer.update(
                tree_unflatten(params, grads), opt_state, params,
                inplace=donate)
        return new_p, new_s, dict(met, loss=loss)

    return step


def build_mesh_train_step(cfg: ArchConfig, shape: ShapeConfig,
                          rt: TunableConfig, mesh,
                          optimizer: Optional[Optimizer] = None
                          ) -> StepBundle:
    """The train step on ``mesh``: the explicit path (dp / fsdp over a
    data axis above 1, not moe) or the auto path (DTensors), as the
    reference chooses.  A mesh of one device takes the auto path here
    (``build_train_step`` gives it the one-device step)."""
    model, optimizer, rt, attn_note, args = _train_parts(cfg, shape, rt,
                                                         optimizer)
    rules = build_rules(mesh, cfg, rt)
    p_specs = _param_specs(model, rules)
    b_specs = _batch_specs(cfg, shape, rt, rules)
    o_specs = optimizer.state_specs(p_specs, model.param_shapes())
    sizes = axis_sizes(mesh)
    explicit = (gradsync.explicit_applicable(cfg.family, rt)
                and sizes.get("data", 1) > 1)
    # int8+error-feedback gradient compression: dp strategy only (every
    # leaf replicated -> one fused bucket); falls back to bf16 otherwise
    ef = (explicit and rt.grad_comm_dtype == "int8_ef"
          and rt.shard_strategy == "dp")
    if rt.grad_comm_dtype == "int8_ef" and not ef:
        rt = rt.replace(grad_comm_dtype="bfloat16")
    donate = rt.donate_buffers
    data_axes = rules.batch_axes
    n_shards = rules.data_axis_size()
    if ef:
        # the optimizer state carries each data shard's EF residual
        n_total = sum(math.prod(s.shape) for s in tree_leaves(args[0]))
        o_specs = {"opt": o_specs, "ef": (data_axes, None)}
        args = (args[0], {"opt": args[1], "ef": L.ShapeDtype(
            (n_shards, n_total), torch.float32)}, args[2])

    def place(params, opt_state, batch):
        return (SH.shard_tree(params, p_specs, rules),
                SH.shard_tree(opt_state, o_specs, rules),
                SH.shard_tree(batch, b_specs, rules))

    def update(params, grads, opt_state):
        with torch.no_grad(), _sharded(rules):
            return optimizer.update(tree_unflatten(params, grads), opt_state,
                                    params, inplace=donate)

    if explicit:
        def inner(params, opt, batch):
            """Every rank on its blocks: full parameters (fsdp gathered in
            the compute dtype), its batch rows, explicit collectives."""
            local = SH.local_tree(params)
            with torch.no_grad():
                # cast before the gather: wire bytes at compute dtype
                full = gradsync.gather_params(
                    cast_params_for_compute(local, rt), p_specs, mesh)
            loss, grads = _local_grads(model, rt, full, SH.local_tree(batch),
                                       prepare=lambda p: p)
            grads = tree_unflatten(local, grads)
            scale = 1.0 / n_shards
            if ef:
                grads, ef_l = gradsync.reduce_grads_int8_ef(
                    grads, rt, data_axes, {a: sizes[a] for a in data_axes},
                    opt["ef"].to_local(), scale, mesh)
            else:
                grads = gradsync.reduce_grads(grads, p_specs, rt, data_axes,
                                              scale, mesh)
            loss = gradsync.psum(loss.clone(), mesh, data_axes) / n_shards
            grads = [SH.wrap_local(g, p) for g, p in
                     zip(tree_leaves(grads), tree_leaves(params))]
            if not ef:
                new_p, new_s, met = update(params, grads, opt)
                return new_p, new_s, dict(met, loss=loss)
            new_p, new_s, met = update(params, grads, opt["opt"])
            return new_p, {"opt": new_s,
                           "ef": SH.wrap_local(ef_l, opt["ef"])}, \
                dict(met, loss=loss)
    else:
        def inner(params, opt, batch):
            loss, grads = _local_grads(model, rt, params, batch, rules)
            # each gradient on its parameter's placements before the
            # update, as the reference's out_shardings place it
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, tree_leaves(params))]
            new_p, new_s, met = update(params, grads, opt)
            return new_p, new_s, dict(met, loss=loss)

    def step(params, opt_state, batch):
        params, opt_state, batch = place(params, opt_state, batch)
        new_p, new_s, met = inner(params, opt_state, batch)
        met = {k: v.full_tensor() if SH.is_dtensor(v) else v
               for k, v in met.items()}
        return new_p, new_s, met

    return StepBundle(step, args, rules, "train",
                      notes={"explicit_comm": explicit,
                             "sharding_notes": list(rules.notes),
                             "attn_impl": attn_note},
                      specs=(p_specs, o_specs, b_specs))


def _param_specs(model: Model, rules: SH.ShardingRules):
    return rules.param_sharding_tree(model.logical(), model.param_shapes())


def _batch_specs(cfg, shape, rt, rules: SH.ShardingRules):
    specs = input_specs(cfg, shape, rt)
    lg = batch_logical(cfg, shape, rt)
    return {k: rules.act_spec(lg[k], specs[k].shape) for k in specs}


def _cache_specs(model: Model, batch: int, max_seq: int,
                 rt: TunableConfig, rules: SH.ShardingRules):
    shapes, logical = model.cache_shapes(batch, max_seq, rt)
    return SH._map_logical(lambda lg, sd: rules.act_spec(lg, sd.shape),
                           logical, shapes)


# ===================================================================== serve
def _serve_params(model: Model, rt: TunableConfig):
    """Shapes of the serving paths' parameters: matrices in the compute
    dtype, as ``Model.cast_params`` leaves them."""
    return _shapes_of(model.cast_params(_meta_params(model), rt))


def _serve_rules(cfg, rt, mesh):
    if one_device(mesh):
        return None
    if cfg.family in SERVE_WAITS:
        raise NotImplementedError(
            f"serving the {cfg.family} family ({cfg.name}) on a mesh is not "
            f"ported yet ({SLICE_7B})")
    return build_rules(mesh, cfg, rt)


def build_prefill_step(cfg: ArchConfig, shape: ShapeConfig,
                       rt: TunableConfig, mesh=None) -> StepBundle:
    model = build_model(cfg)
    rules = _serve_rules(cfg, rt, mesh)
    args = (_serve_params(model, rt), input_specs(cfg, shape, rt))
    if rules is None:
        def step(params, batch):
            with torch.no_grad():
                return model.prefill_fn(params, batch, rt, None,
                                        max_seq=shape.seq_len)
        return StepBundle(step, args, None, "prefill", notes=_notes(cfg, rt))
    p_specs = _param_specs(model, rules)
    b_specs = _batch_specs(cfg, shape, rt, rules)

    def step(params, batch):
        with torch.no_grad():
            return model.prefill_fn(SH.shard_tree(params, p_specs, rules),
                                    SH.shard_tree(batch, b_specs, rules),
                                    rt, rules, max_seq=shape.seq_len)

    return StepBundle(step, args, rules, "prefill",
                      notes={"sharding_notes": list(rules.notes)},
                      specs=(p_specs, b_specs))


def build_decode_step(cfg: ArchConfig, shape: ShapeConfig,
                      rt: TunableConfig, mesh=None) -> StepBundle:
    """One-token serve step against a seq_len-deep cache.  The cache's
    position is a host integer, as in the serving path: in ``args`` 0, or
    the last row (``seq_len - 1``) where the shape says
    ``cache_filled``."""
    model = build_model(cfg)
    rules = _serve_rules(cfg, rt, mesh)
    cache, _ = model.cache_shapes(shape.global_batch, shape.seq_len, rt)
    cache = dict(cache, pos=shape.seq_len - 1 if shape.cache_filled else 0)
    tokens = L.ShapeDtype((shape.global_batch, 1), torch.int32)
    args = (_serve_params(model, rt), cache, tokens)
    if rules is None:
        def step(params, cache, tokens):
            with torch.no_grad():
                return model.decode_fn(params, cache, tokens, rt, None)
        return StepBundle(step, args, None, "decode", notes=_notes(cfg, rt),
                          fill_cache=shape.cache_filled)
    p_specs = _param_specs(model, rules)
    c_specs = _cache_specs(model, shape.global_batch, shape.seq_len, rt,
                           rules)
    t_spec = rules.act_spec(("batch", None), tokens.shape)

    def step(params, cache, tokens):
        with torch.no_grad():
            return model.decode_fn(
                SH.shard_tree(params, p_specs, rules),
                SH.shard_tree(cache, c_specs, rules),
                SH.to_dtensor(tokens, rules, t_spec), rt, rules)

    return StepBundle(step, args, rules, "decode",
                      notes={"sharding_notes": list(rules.notes)},
                      fill_cache=shape.cache_filled,
                      specs=(p_specs, c_specs, t_spec))


def build_step(cfg: ArchConfig, shape: ShapeConfig, rt: TunableConfig,
               mesh=None) -> StepBundle:
    """Dispatch on the cell kind (train_* -> train, decode_* -> decode...)."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, rt, mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, rt, mesh)
    return build_decode_step(cfg, shape, rt, mesh)
