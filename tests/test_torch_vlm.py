"""The VLM family of the PyTorch port against the reference, on the CPU,
on the reduced llava-next-34b config (2 layers, d 128, 16 frontend
tokens): the frontend stub's inputs (shapes, dtypes, the data pipeline's
embeddings), the embeddings prepended after a cast, prefill / decode and
the cache, the loss with its label offset, the gradients and one AdamW
step.  Same weights (``from_jax_params``), same numpy inputs.

Tolerances as tests/test_torch_moe.py states them: the frontend's
inputs and the loss's offset exactly or at f32's 2e-5; a whole model as
tests/test_torch_model.py and tests/test_torch_train.py hold the dense
family (f32 1e-4, bf16 logits 5e-2 in the relative Frobenius norm)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.params import default_config as jdefault
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.params import default_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import layers as L
from repro_torch.models import model as tmodel
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.runtime.loops import tree_map
from repro_torch.runtime.stepfn import build_train_step

from _torch_parity import (fro_close, fro_close_floor, j2n, leaf_pairs,
                           port_grads, port_train_step, rel_close,
                           serve_both, shared_params, step_outputs, t2n,
                           train_step_both, ulp_floor)
from repro_torch.convert import from_jax_params

ARCH = "llava-next-34b"
TOL, MODEL_TOL = 2e-5, {"float32": 1e-4, "bfloat16": 5e-2}
B, TEXT, MAX_SEQ, STEPS = 2, 10, 32, 3


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp, tp = shared_params(jm.init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jm, tm, jp, tp


def _inputs(jcfg, dtype="float32", labels=False, seed=7):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, jcfg.vocab, (B, TEXT + 1)).astype(np.int32)
    emb = (rng.standard_normal((B, jcfg.frontend_tokens, jcfg.d_model))
           * 0.02).astype(np.float32)
    npb = {"tokens": toks[:, :-1].copy(), "frontend_embeds": emb}
    if labels:
        npb["labels"] = toks[:, 1:].copy()
    jb = {k: jnp.asarray(v) for k, v in npb.items()}
    tb = {k: torch.from_numpy(v) for k, v in npb.items()}
    jb["frontend_embeds"] = jb["frontend_embeds"].astype(jnp.dtype(dtype))
    tb["frontend_embeds"] = tb["frontend_embeds"].to(L.torch_dtype(dtype))
    return jb, tb


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_specs_match_reference(kind, dtype):
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    want = jmodel.input_specs(jcfg, JShape("t", 48, 2, kind),
                              jdefault(compute_dtype=dtype))
    got = tmodel.input_specs(tcfg, ShapeConfig("t", 48, 2, kind),
                             default_config(compute_dtype=dtype))
    assert {k: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for k, s in got.items()} == \
        {k: (s.shape, jnp.dtype(s.dtype).name) for k, s in want.items()}
    gen = torch.Generator().manual_seed(0)
    batch = tmodel.synth_inputs(tcfg, ShapeConfig("t", 48, 2, kind),
                                default_config(compute_dtype=dtype), gen)
    for name, s in got.items():
        assert tuple(batch[name].shape) == s.shape
        assert batch[name].dtype == s.dtype
    if kind != "decode":
        emb = batch["frontend_embeds"].float()
        assert 0.5 < float(emb.std()) < 1.5          # standard normal
        assert int(batch["tokens"].max()) < tcfg.vocab


@pytest.mark.parametrize("step", [0, 3])
def test_pipeline_embeddings_are_the_reference(step):
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    want = JSyntheticLM(jcfg, JShape("t", 32, 2, "train"), jdefault(),
                        make_host_mesh(), seed=1).batch_at(step)
    got = SyntheticLM(tcfg, ShapeConfig("t", 32, 2, "train"),
                      default_config(), "cpu", seed=1).batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels", "frontend_embeds"}
    for k in ("tokens", "labels", "frontend_embeds"):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_prepends_the_frontend(setup, dtype):
    jcfg, tcfg, _, _, jp, tp = setup
    jb, tb = _inputs(jcfg, "float32")           # f32 embeds, cast inside
    jh = jtransformer.embed_inputs(jp, jb, jcfg,
                                   jdefault(compute_dtype=dtype), None)
    th = transformer.embed_inputs(tp, tb, tcfg,
                                  default_config(compute_dtype=dtype), None)
    assert th.dtype == L.torch_dtype(dtype)
    assert tuple(th.shape) == jh.shape == (
        B, jcfg.frontend_tokens + TEXT, jcfg.d_model)
    np.testing.assert_array_equal(t2n(th), j2n(jh))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_f32_prefill_cache_decode(setup, impl):
    jcfg, tcfg, jm, tm, jp, tp = setup
    kw = dict(compute_dtype="float32", kv_cache_dtype="float32",
              attn_impl=impl)
    out = serve_both(jm, tm, jp, tp, *_inputs(jcfg), jdefault(**kw),
                     default_config(**kw), MAX_SEQ, STEPS)
    jlog, tlog = out["prefill"]
    assert tuple(tlog.shape) == jlog.shape
    rel_close(tlog, jlog, MODEL_TOL["float32"])
    for name, j in out["cache0"][0]["layers"].items():
        assert out["cache0"][1][name].shape[2] == MAX_SEQ
        rel_close(out["cache0"][1][name], j, MODEL_TOL["float32"])
    for jl, tl in out["steps"]:
        rel_close(tl, jl, MODEL_TOL["float32"])
    jc, tc = out["cache"]
    assert tc["pos"] == int(jc["pos"]) == jcfg.frontend_tokens + TEXT + STEPS
    for name, j in jc["layers"].items():
        rel_close(tc["layers"][name], j, MODEL_TOL["float32"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_bf16_prefill_decode(setup, impl, kv):
    jcfg, tcfg, jm, tm, jp, tp = setup
    kw = dict(compute_dtype="bfloat16", kv_cache_dtype=kv, attn_impl=impl)
    out = serve_both(jm, tm, jp, tp, *_inputs(jcfg, "bfloat16"),
                     jdefault(**kw), default_config(**kw), MAX_SEQ, STEPS)
    fro_close(out["prefill"][1], out["prefill"][0], MODEL_TOL["bfloat16"])
    for jl, tl in out["steps"]:
        fro_close(tl, jl, MODEL_TOL["bfloat16"])


def test_loss_offsets_the_labels(setup):
    """The frontend positions carry no labels: the loss is the
    cross-entropy of the last S - F positions' logits against the
    labels, and equals the reference's."""
    jcfg, tcfg, jm, tm, jp, tp = setup
    jb, tb = _inputs(jcfg, labels=True)
    rt = default_config(compute_dtype="float32")
    jl, jparts = jm.loss_fn(jp, jb, jdefault(compute_dtype="float32"))
    with torch.no_grad():
        tl, tparts = tm.loss_fn(tp, tb, rt)
        h = transformer.embed_inputs(tp, tb, tcfg, rt, None)
        S = h.shape[1]
        pos = torch.arange(S).expand(B, S)
        h, _ = transformer.forward(tp, h, pos, tcfg, rt, None)
        logits = L.unembed(tp["embed"], h, tcfg, rt, None)
        want = L.xent_loss(logits[:, jcfg.frontend_tokens:], tb["labels"],
                           tcfg)
        shifted = L.xent_loss(logits[:, :TEXT], tb["labels"], tcfg)
    assert S == jcfg.frontend_tokens + TEXT
    rel_close(tl, jl, TOL)
    rel_close(tparts["xent"], jparts["xent"], TOL)
    assert float(tparts["aux"]) == float(jparts["aux"]) == 0.0
    rel_close(tl, want.numpy(), 1e-6)
    assert abs(float(shifted) - float(tl)) > 1e-3


def test_grads_and_train_step_match_reference(setup):
    """Gradients, the update and the moments to 1e-4, or to five times
    the port's own one-rounding-unit floor where that lies above it
    (``ulp_floor``: the attention's nearly one-hot softmax)."""
    jcfg, tcfg, jm, tm, jp, tp = setup
    jb, tb = _inputs(jcfg, labels=True)
    kw = dict(compute_dtype="float32", remat_policy="dots")
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, jdefault(**kw))[0])(jp)
    grads = port_grads(tm, tb, default_config(**kw))
    floor = ulp_floor(grads, tp)
    for g, (_, j), f in zip(grads(tp), leaf_pairs(tp, jg), floor):
        fro_close_floor(g, j, MODEL_TOL["float32"], f)
    (jn, jo, jmet), (tn, to, tmet) = train_step_both(
        jcfg, tcfg, jp, tp, jb, tb, **kw)
    rel_close(tmet["loss"], jmet["loss"], TOL)
    rel_close(tmet["grad_norm"], jmet["grad_norm"], MODEL_TOL["float32"])
    step = port_train_step(tcfg, B, jcfg.frontend_tokens + TEXT, **kw)
    floor = ulp_floor(lambda p: step_outputs(p, *step(p, tb)[:2]), tp)
    want = step_outputs(from_jax_params(jp), from_jax_params(jn),
                        from_jax_params(jo))
    for t, j, f in zip(step_outputs(tp, tn, to), want, floor):
        fro_close_floor(t, j, MODEL_TOL["float32"], f)


def test_full_config_builds_and_trains():
    cfg = get_config(ARCH)
    shapes = build_model(cfg).param_shapes()
    assert "mlp" in shapes["blocks"] and "moe" not in shapes["blocks"]
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes, is_leaf=lambda s: isinstance(s, L.ShapeDtype)))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jbuild(jget_config(ARCH)).param_shapes()))
    assert build_train_step(cfg, ShapeConfig("t", 2048, 4, "train"),
                            default_config()).kind == "train"
    specs = tmodel.input_specs(cfg, ShapeConfig("t", 2048, 4, "train"),
                               default_config(compute_dtype="bfloat16"))
    assert tuple(specs["frontend_embeds"].shape) == (4, 576, 7168)
    assert specs["frontend_embeds"].dtype == torch.bfloat16
    assert tuple(specs["tokens"].shape) == tuple(specs["labels"].shape) \
        == (4, 2048 - 576)
