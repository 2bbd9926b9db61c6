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
    out["ep_gather_grad"] = _moe_grads(cfg, rt, mesh, p, xs[2], xs[3])
    return out


def _moe_grads(cfg, rt, mesh, p, x, cot):
    """The gradient of sum(y * cot) w.r.t. x and the router and expert
    weights through ep_gather (tp on ``mesh``; the sequence of 3 does
    not divide the model axis) and through the one-device dense path."""
    import torch
    from repro_torch.models import moe
    from repro_torch.runtime.sharding import ShardingRules, shard_tree
    names = ("router", "wg", "wu", "wd")
    rules = ShardingRules(mesh=mesh, strategy="tp")
    x, cot = torch.from_numpy(x), torch.from_numpy(cot)
    specs = rules.param_sharding_tree(
        {k: s.logical for k, s in moe.moe_spec(cfg).items()}, p)
    xspec = rules.act_spec(("batch", None, None), x.shape)

    def grads(params, xx, rules_):
        leaves = [xx] + [params[n] for n in names]
        y, _ = moe.moe_mlp(params, xx, cfg, rt, rules_)
        c = cot if rules_ is None else shard_tree(
            {"c": cot}, {"c": xspec}, rules_)["c"]
        return torch.autograd.grad((y * c).sum(), leaves)

    with torch.enable_grad():
        dp = {k: v.detach().requires_grad_() for k, v in shard_tree(
            p, specs, rules).items()}
        dx = shard_tree({"x": x}, {"x": xspec}, rules)["x"]
        mesh_g = grads(dp, dx.detach().requires_grad_(), rules)
        dense_g = grads({k: v.detach().requires_grad_() for k, v in
                         p.items()}, x.clone().requires_grad_(), None)
    keys = ("x",) + names
    return {"path": moe._ep_paths_applicable(cfg, rules, x.shape[1]),
            "mesh": {k: g.full_tensor().numpy()
                     for k, g in zip(keys, mesh_g)},
            "dense": {k: g.numpy() for k, g in zip(keys, dense_g)}}


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
    ``launch/train.py`` takes under torchrun), and how far a prefill on
    the mesh (tp; dp where it has no model axis; f32, an f32 MoE wire,
    the kernels' wrappers) moves the last token's logits from one device's (over the
    largest magnitude, at least 1)."""
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
        model = build_model(cfg)
        params = model.init(0, device="cpu")
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
        # a prefill through the kernels' wrappers on the mesh (tp where
        # it has a model axis to split) against one device
        serve = "tp" if "model" in mesh.mesh_dim_names else "dp"
        pb = {k: v for k, v in batch.items() if k != "labels"}
        logits = []
        for m in (None, mesh):
            # f32 on the MoE's wire too (its default is bf16)
            rt = default_config(shard_strategy=serve, attn_impl="pallas",
                                compute_dtype="float32",
                                comm_codec="float32")
            step = stepfn.build_prefill_step(
                cfg, ShapeConfig("p", S, B, "prefill"), rt, m)
            with torch.no_grad():
                lg, _ = step.fn(model.cast_params(params, rt), pb)
            logits.append(lg.full_tensor() if hasattr(lg, "full_tensor")
                          else lg)
        res["serve"] = float((logits[1] - logits[0]).abs().max()
                             / max(1.0, float(logits[0].abs().max())))
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


# ------------------------------------------------- serving on a mesh
def _serve_one(model, rt, mesh, params, batch, gen: int, max_seq: int,
               feed=None):
    """Prefill ``batch`` and take ``gen`` decode steps through the serve
    steps of ``stepfn``, on one device (``mesh`` None) or on ``mesh``:
    each step feeds the next token of ``feed`` (default: greedy on this
    run's own logits).  Returns the logits of each call and the last
    cache gathered whole (as numpy), the cache itself and the tokens
    fed."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import stepfn
    from repro_torch.runtime.loops import tree_map
    from repro_torch.runtime.sharding import full_tree
    cfg = model.cfg
    B = batch["tokens"].shape[0]
    pre = stepfn.build_prefill_step(cfg, ShapeConfig("p", max_seq, B,
                                                     "prefill"), rt, mesh)
    dec = stepfn.build_decode_step(cfg, ShapeConfig("d", max_seq, B,
                                                    "decode"), rt, mesh)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    logits, cache = pre.fn(params, batch)
    out, fed = [full(logits)], []
    for i in range(gen):
        nxt = out[-1].argmax(-1).to(torch.int32) if feed is None \
            else feed[i]
        fed.append(nxt)
        logits, cache = dec.fn(params, cache, nxt)
        out.append(full(logits))
    whole = full_tree({k: v for k, v in cache.items() if k != "pos"})
    return [o.float().numpy() for o in out], _numpy(tree_map(
        lambda t: t.float() if t.dtype == torch.bfloat16 else t, whole)), \
        cache, fed


def _diffs(got, want):
    """|difference| over the largest |value| of ``want`` (at least 1),
    per leaf."""
    from repro_torch.runtime.loops import tree_leaves
    ga, wa = tree_leaves(got), tree_leaves(want)
    assert len(ga) == len(wa)
    return [float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
                  / max(1.0, np.abs(b.astype(np.float64)).max()))
            for a, b in zip(ga, wa)]


def _moved(params, seed):
    """Every floating parameter moved by one f32 rounding unit (2^-23
    relative, random signs), as tests/_torch_parity.ulp_floor moves them."""
    import torch
    from repro_torch.runtime.loops import tree_map
    rng = np.random.RandomState(seed)

    def move(t):
        if not t.is_floating_point():
            return t
        signs = torch.from_numpy(rng.choice([-1.0, 1.0], size=t.shape))
        return (t.double() * (1 + 2.0 ** -23 * signs)).to(t.dtype)
    return tree_map(move, params)


def _serve_case(rank, arch, rt_kw, B, S, gen, mesh, strategies, seed=3):
    """For each strategy: the differences of a mesh's serve (logits per
    call, each cache leaf) from the one-device serve (both fed the
    one-device path's greedy tokens), the position, and each rank's
    local shape of the KV cache's K; and the one-device path's floor:
    how far the same numbers move under one rounding unit of the
    parameters (the most over two draws)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.core.params import default_config
    from repro_torch.models.model import build_model
    cfg = get_reduced(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, S // 2, cfg.d_model), generator=g)
    one = default_config(**rt_kw)
    params = model.cast_params(params, one)
    want = _serve_one(model, one, None, params, batch, gen, S + gen)
    out = {"floor": None}
    if rank == 0:
        floor = None
        for draw in range(2):
            moved = _serve_one(model, one, None, _moved(params, draw), batch,
                               gen, S + gen, want[3])
            now = (_diffs(moved[0], want[0]), _diffs(moved[1], want[1]))
            floor = now if floor is None else tuple(
                [max(a, b) for a, b in zip(f, n)] for f, n in zip(floor, now))
        out["floor"] = {"logits": floor[0], "cache": floor[1]}
    for strat in strategies:
        rt = default_config(shard_strategy=strat, **rt_kw)
        got = _serve_one(model, rt, mesh, params, batch, gen, S + gen,
                         want[3])
        # the KV cache's K: (layers, B, Smax, Hkv, hd)
        k = (got[2].get("layers") or got[2].get("kv")
             or got[2].get("self") or {}).get("k")
        local = [None] * dist.get_world_size()
        dist.all_gather_object(local, None if k is None else (
            tuple(k.to_local().shape), str(k.placements)))
        out[strat] = {"logits": _diffs(got[0], want[0]),
                      "cache": _diffs(got[1], want[1]),
                      "pos": (int(got[2]["pos"]), S + gen), "local": local,
                      "full": None if k is None else tuple(k.shape)}
    return out


def _serve_all(rank, families, strategies, seq_plan):
    """Every case of tests/test_torch_spmd_serve.py in one spawn of 4
    ranks on a (2, 2) mesh: each family of ``families`` served (B 4) in
    f32 under each strategy with both ``attn_impl`` values, and each
    (arch, kv cache dtype) of ``seq_plan`` decoded at batch 1, its KV
    cache split along its sequence on the data axis."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in families:
        for impl in ("pallas", "xla"):
            kw = dict(compute_dtype="float32", attn_impl=impl,
                      kv_cache_dtype="float32", donate_buffers=False)
            out[(arch, impl)] = _serve_case(rank, arch, kw, 4, 8, 3, mesh,
                                            strategies)
    for arch, kv in seq_plan:
        kw = dict(compute_dtype="float32", attn_impl="pallas",
                  kv_cache_dtype=kv, donate_buffers=False)
        # a prompt of 13 in a cache of 16 split in two blocks of 8: the
        # live prefix crosses the split, and the steps write rows 13-15
        out[("seq", arch, kv)] = _serve_case(rank, arch, kw, 1, 13, 3,
                                             mesh, ("tp",))
    return out
