"""The rank side of the port's multi-device tests: functions that each
CPU rank runs (``_torch_dist.run_ranks``).  This module imports no JAX,
so a spawned rank loads only torch and the port.  The one-device steps
that the mesh's are held against run on rank 0 alone (rank 0's results
come back)."""
import numpy as np

ARCH = "smollm-135m"
STRATEGIES = ("dp", "tp", "fsdp", "fsdp_tp")


def _t(x):
    from repro_torch.convert import from_jax_params
    return from_jax_params(x)


def _moe_ranks(rank, params, xs):
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.params import default_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.runtime.sharding import ShardingRules, shard_tree
    mesh = make_mesh((2, 4), ("data", "model"))
    cfg = get_reduced("olmoe-1b-7b").replace(capacity_factor=8.0)
    rt = default_config(compute_dtype="float32", comm_codec="float32")
    p = _t(params)
    out = {}
    for name, strat, x in (("ep_alltoall", "fsdp_tp", xs[0]),
                           ("ep_gather", "tp", xs[1])):
        rules = ShardingRules(mesh=mesh, strategy=strat)
        x = torch.from_numpy(x)
        path = moe._ep_paths_applicable(cfg, rules, x.shape[1])
        specs = rules.param_sharding_tree(
            {k: s.logical for k, s in moe.moe_spec(cfg).items()},
            {k: s for k, s in p.items()})
        dp = shard_tree(p, specs, rules)
        dx = shard_tree({"x": x}, {"x": rules.act_spec(
            ("batch", None, None), x.shape)}, rules)["x"]
        with torch.no_grad():
            y, aux = moe.moe_mlp(dp, dx, cfg, rt, rules)
            y_dense, aux_dense = moe._dense_moe(p, x, cfg, rt)
        out[name] = dict(path=path, y=y.full_tensor().numpy(),
                         aux=float(aux.full_tensor()),
                         y_dense=y_dense.numpy(), aux_dense=float(aux_dense))
    return out


def _port_step(cfg, params, batch, rt, mesh, **kw):
    """(loss, grad_norm, mean|final_norm|, explicit) of one AdamW step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.optimizers import constant_schedule, make_optimizer
    from repro_torch.runtime.sharding import full_tree
    from repro_torch.runtime.stepfn import build_train_step
    B, S = batch["tokens"].shape
    opt = make_optimizer("adamw", constant_schedule(1e-3))
    b = build_train_step(cfg, ShapeConfig("t", S, B, "train"), rt, mesh,
                         opt, **kw)
    p = _t(params)
    p2, _, met = b.fn(p, opt.init(p), _t(batch))
    fn = full_tree(p2)["final_norm"]
    return (float(met["loss"]), float(met["grad_norm"]),
            float(fn.abs().mean()), b.notes.get("explicit_comm"))


def _strategy_ranks(rank, params, batch, serve):
    from repro_torch.configs import get_reduced
    from repro_torch.core.params import default_config
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("data", "model"))
    cfg = get_reduced(ARCH)
    out = {}
    if rank == 0:
        out["one"] = _port_step(cfg, params, batch,
                                default_config(donate_buffers=False), None)
    for strat in STRATEGIES:
        rt = default_config(shard_strategy=strat, donate_buffers=False)
        out[strat] = _port_step(cfg, params, batch, rt, mesh)
    # two microbatches: each rank splits its own rows (the auto path's
    # DTensor batch and the explicit path's local one)
    # two microbatches on the auto path: each rank splits its own rows
    rt = default_config(shard_strategy="tp", donate_buffers=False,
                        microbatches=2)
    out["tp_mb2"] = _port_step(cfg, params, batch, rt, mesh)
    # attention batch-parallel over (data, model): 3 heads do not divide 2
    rt = default_config(shard_strategy="tp", donate_buffers=False,
                        attn_tp_fallback="batch_shard")
    out["tp_batch_shard"] = _port_step(cfg, params, batch, rt, mesh)
    out["serve"] = _serve_cases(cfg, params, serve, mesh)
    return out


def _serve_cases(cfg, params, tokens, mesh):
    """Prefill and three decode steps through the kernels' wrappers
    (plain versions on CPU tensors, under ``local_map``) with tp rules,
    against the one-device serve path: max |logit difference|."""
    import torch
    from repro_torch.core.params import default_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime import stepfn
    from repro_torch.configs.base import ShapeConfig
    model = build_model(cfg)
    p = _t(params)
    B, S = tokens.shape
    out = {}
    for strat in ("tp",):
        rt = default_config(shard_strategy=strat, attn_impl="pallas",
                            kv_cache_dtype="float32")
        pre = stepfn.build_prefill_step(cfg, ShapeConfig("p", S + 3, B,
                                                         "prefill"), rt, mesh)
        rules = pre.rules
        with torch.no_grad():
            cast = model.cast_params(p, rt)
            dp = {k: v for k, v in cast.items()}
            from repro_torch.runtime.sharding import shard_tree
            dparams = shard_tree(dp, pre.specs[0], rules)
            tok = torch.from_numpy(tokens)
            lg1, c1 = model.prefill_fn(dparams, {"tokens": shard_tree(
                {"t": tok}, {"t": pre.specs[1]["tokens"]}, rules)["t"]},
                rt, rules, max_seq=S + 3)
            lg0, c0 = model.prefill_fn(cast, {"tokens": tok}, rt, None,
                                       max_seq=S + 3)
            errs = [float((lg1.full_tensor() - lg0).abs().max())]
            nxt = lg0.argmax(-1).to(torch.int32)
            for _ in range(3):
                lg1, c1 = model.decode_fn(dparams, c1, nxt, rt, rules)
                lg0, c0 = model.decode_fn(cast, c0, nxt, rt, None)
                errs.append(float((lg1.full_tensor() - lg0).abs().max()))
                nxt = lg0.argmax(-1).to(torch.int32)
        out[strat] = errs
    return out


def _gradsync_ranks(rank, params, batch, flats):
    """On (8,): one step per wire dtype (f32, bf16, fused, fsdp bf16),
    four steps of f32 and of int8_ef, and ``int8_allreduce_ef`` on each
    rank's own vector."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import constant_schedule, make_optimizer
    from repro_torch.runtime import gradsync
    from repro_torch.runtime.loops import tree_leaves
    mesh = make_mesh((8,), ("data",))
    cfg = get_reduced(ARCH)
    shape = ShapeConfig("t", 64, 8, "train")
    opt = make_optimizer("adamw", constant_schedule(1e-3))
    out = {}
    for name, kw in {"f32": {}, "bf16": dict(grad_comm_dtype="bfloat16"),
                     "fused": dict(fuse_grad_collectives=True),
                     "fsdp_bf16": dict(grad_comm_dtype="bfloat16")}.items():
        rt = default_config(shard_strategy="fsdp" if name.startswith("fsdp")
                            else "dp", donate_buffers=False, **kw)
        from repro_torch.runtime.stepfn import build_train_step
        b = build_train_step(cfg, shape, rt, mesh, opt)
        p = _t(params)
        _, _, met = b.fn(p, opt.init(p), _t(batch))
        out[name] = (float(met["loss"]), float(met["grad_norm"]),
                     b.notes["explicit_comm"])
    for gcd in ("float32", "int8_ef"):
        rt = default_config(shard_strategy="dp", grad_comm_dtype=gcd,
                            fuse_grad_collectives=True, donate_buffers=False)
        b = build_train_step(cfg, shape, rt, mesh, opt)
        p = _t(params)
        st = b.measure_args("cpu")[1]
        for _ in range(4):
            p, st, met = b.fn(p, st, _t(batch))
        out[gcd] = float(met["loss"])
        if gcd == "int8_ef":
            out["ef_shape"] = tuple(st["ef"].shape)
    flat = torch.from_numpy(flats[rank][0])
    resid = torch.from_numpy(flats[rank][1])
    s, r = gradsync.int8_allreduce_ef(flat, resid, mesh.get_group("data"), 8)
    got = [None] * 8
    dist.all_gather_object(got, (s.numpy(), r.numpy()))
    out["int8"] = got
    return out


def _ckpt_specs(mesh_shape, strategy):
    from repro_torch.configs import get_reduced
    from repro_torch.core.params import default_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import constant_schedule, make_optimizer
    from repro_torch.runtime import stepfn
    cfg = get_reduced(ARCH)
    mesh = make_mesh(mesh_shape, ("data", "model"))
    rules = stepfn.build_rules(mesh, cfg, default_config(
        shard_strategy=strategy))
    model = build_model(cfg)
    opt = make_optimizer("adamw", constant_schedule(1e-3))
    p_specs = stepfn._param_specs(model, rules)
    return (cfg, mesh, rules, opt,
            {"params": p_specs,
             "opt": opt.state_specs(p_specs, model.param_shapes())})


def _ckpt_save_ranks(rank, params, batch, directory):
    """One fsdp step on (4, 2), its DTensor state saved (every rank
    calls ``save``; rank 0 writes); the full state comes back."""
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.runtime.sharding import full_tree
    from repro_torch.runtime.stepfn import build_train_step
    cfg, mesh, _, opt, _ = _ckpt_specs((4, 2), "fsdp")
    b = build_train_step(cfg, ShapeConfig("t", 64, 8, "train"),
                         default_config(shard_strategy="fsdp",
                                        donate_buffers=False), mesh, opt)
    p = _t(params)
    p2, s2, _ = b.fn(p, opt.init(p), _t(batch))
    placements = str(p2["embed"]["embedding"].placements)
    ckpt.save(directory, 1, {"params": p2, "opt": s2}, extra={"step": 1})
    dist.barrier()
    return _numpy(full_tree({"params": p2, "opt": s2})), placements


def _ckpt_restore_ranks(rank, directories):
    """Each checkpoint restored on (2, 2) under fsdp placements and
    gathered back to full tensors."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.ft import elastic
    from repro_torch.models.model import build_model
    from repro_torch.runtime.sharding import full_tree, map_specs
    from repro_torch.runtime.stepfn import _meta_params
    cfg, mesh, rules, opt, specs = _ckpt_specs((2, 2), "fsdp")
    meta = _meta_params(build_model(cfg))
    target = {"params": meta, "opt": opt.init(meta)}
    shardings = map_specs(rules.sharding, specs)
    out = []
    for d in directories:
        tree = elastic.restore_resharded(d, 1, target, shardings,
                                         device="cpu")
        out.append((_numpy(full_tree(tree)),
                    str(tree["params"]["embed"]["embedding"].placements)))
    return out


def _numpy(tree):
    from repro_torch.runtime.loops import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _family_ranks(rank, plan, mesh_shape, axes, B, S):
    """For each (arch, strategies, config overrides) of ``plan``: (loss,
    mean|final_norm|,
    explicit_comm) of one step on one device and under each strategy on
    the mesh (``mesh_shape`` None: ``make_host_mesh()``, the mesh that
    ``launch/train.py`` takes under torchrun), and the message a serve
    step on the mesh (tp; dp where it has no model axis) raises where it
    waits (None where it builds)."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.model import build_model, synth_inputs
    from repro_torch.optim.optimizers import constant_schedule, make_optimizer
    from repro_torch.runtime import stepfn
    from repro_torch.runtime.sharding import full_tree
    mesh = make_host_mesh() if mesh_shape is None else \
        make_mesh(mesh_shape, axes)
    out = {}
    for arch, strategies, overrides in plan:
        cfg = get_reduced(arch).replace(**overrides)
        shape = ShapeConfig("t", S, B, "train")
        opt = make_optimizer(cfg.optimizer, constant_schedule(1e-3))
        g = torch.Generator()
        g.manual_seed(1)
        batch = synth_inputs(cfg, shape, default_config(), g)
        params = build_model(cfg).init(0, device="cpu")
        res = {}
        for strat in ("one",) * (rank == 0) + tuple(strategies):
            rt = default_config(shard_strategy="dp" if strat == "one"
                                else strat, donate_buffers=False)
            b = stepfn.build_train_step(cfg, shape, rt,
                                        None if strat == "one" else mesh,
                                        opt)
            p2, _, met = b.fn(params, opt.init(params), batch)
            res[strat] = (float(met["loss"]),
                          float(full_tree(p2)["final_norm"].abs().mean()),
                          b.notes.get("explicit_comm"))
        try:
            # tp where the mesh has a model axis to split
            serve = "tp" if "model" in mesh.mesh_dim_names else "dp"
            stepfn.build_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"),
                                      default_config(shard_strategy=serve),
                                      mesh)
            res["serve"] = None
        except NotImplementedError as e:
            res["serve"] = str(e)
        out[arch] = res
    return out


def _spmd_ranks(rank, params, batch, serve, flats, moe_params, moe_xs,
                ckpt_dir):
    """Every case of tests/test_torch_spmd.py in one spawn of 8 ranks:
    the strategies on (4, 2), gradient sync on (8,), MoE on (2, 4), and
    an fsdp step's state on (4, 2) saved to ``ckpt_dir``."""
    return {"strategies": _strategy_ranks(rank, params, batch, serve),
            "gradsync": _gradsync_ranks(rank, params, batch, flats),
            "moe": _moe_ranks(rank, moe_params, moe_xs),
            "ckpt": _ckpt_save_ranks(rank, params, batch, ckpt_dir)}


def _families_all(rank, plan, plan_tp, plan_host, plan_data):
    """Every case of tests/test_torch_spmd_families.py in one spawn of 4
    ranks: ``plan`` on a (2, 2) mesh, ``plan_tp`` on a model axis of 4,
    ``plan_host`` on the host mesh ((1, 4)), ``plan_data`` on a data axis
    of 4, and the data pipeline's batch on (2, 2)."""
    return {"mesh": _family_ranks(rank, plan, (2, 2), ("data", "model"),
                                  4, 32),
            "model_axis": _family_ranks(rank, plan_tp, (4,), ("model",),
                                        4, 16),
            "host_mesh": _family_ranks(rank, plan_host, None, None, 4, 16),
            "data_axis": _family_ranks(rank, plan_data, (4,), ("data",),
                                       4, 16),
            "pipeline": _pipeline_ranks(rank)}


def _pipeline_ranks(rank):
    """``SyntheticLM(mesh=...)`` on (2, 2): each leaf's placements and
    whether its full value equals the one-device batch, bit for bit (a
    text model and a vlm with its frontend embeddings)."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, B in (("smollm-135m", 4), ("llava-next-34b", 2)):
        cfg = get_reduced(arch)
        shape = ShapeConfig("t", 32, B, "train")
        rt = default_config()
        one = SyntheticLM(cfg, shape, rt, "cpu", seed=5).batch_at(3)
        got = SyntheticLM(cfg, shape, rt, "cpu", seed=5,
                          mesh=mesh).batch_at(3)
        out[arch] = {k: (str(v.placements),
                         torch.equal(v.full_tensor(), one[k]))
                     for k, v in got.items()}
    return out
