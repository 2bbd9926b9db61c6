"""The hybrid serving path of the PyTorch port against the reference in
f32: zamba2-7b prefill last-token logits, every cache tensor (SSM and
conv states of every Mamba2 block, K/V of every shared-block invocation)
and two decode steps, on the reduced config and on the variant with a
remainder, under both attention implementations and every KV-cache
dtype.  Weights and prompt are those of tests/test_torch_hybrid.py; the
port's parameters go through ``cast_params`` first, as on the serving
path.  bf16 is in tests/test_torch_hybrid_bf16.py.

Tolerances: 1e-4 relative to the tensor's scale (the SSM state 2e-4: it
sums a whole prompt); a bf16 KV cache 1e-2 (one stored step on a
boundary); an int8 KV cache at most one quantisation step on fewer than
0.1 % of values; decode logits, and the states after them, 2e-3 with a
rounded cache (attention reads the rounded K/V); greedy tokens equal."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.params import default_config as jdefault
from repro.models.model import build_model as jbuild
from repro_torch.core.params import default_config
from repro_torch.models.model import build_model

from _torch_parity import j2n, rel_close, t2n
from test_torch_hybrid import B, S, _clone, cfgs, weights

MAX_SEQ, STEPS = S + 8, 2


def _tokens(vocab):
    return np.random.RandomState(7).randint(0, vocab, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference(variant, compute, kv, impl):
    """The reference's prefill, cache and STEPS greedy decode steps."""
    jcfg, _ = cfgs(variant)
    jm, jp = jbuild(jcfg), weights(variant)[0]
    jrt = jdefault(compute_dtype=compute, kv_cache_dtype=kv, attn_impl=impl)
    logits, cache = jm.prefill_fn(
        jp, {"tokens": jnp.asarray(_tokens(jcfg.vocab))}, jrt,
        max_seq=MAX_SEQ)
    out = {"prefill": logits, "cache0": cache, "tokens": [], "steps": []}
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        logits, cache = jm.decode_fn(jp, cache, tok, jrt)
        out["tokens"].append(np.asarray(tok))
        out["steps"].append(logits)
    out["cache"] = cache
    return out


@functools.lru_cache(maxsize=None)
def port(variant, compute, kv, impl):
    """The port on the same inputs, fed the reference's decode tokens (one
    flipped argmax cannot send the two sequences apart)."""
    _, tcfg = cfgs(variant)
    tm = build_model(tcfg)
    trt = default_config(compute_dtype=compute, kv_cache_dtype=kv,
                         attn_impl=impl)
    tp = tm.cast_params(weights(variant)[1], trt)
    with torch.no_grad():
        logits, cache = tm.prefill_fn(
            tp, {"tokens": torch.from_numpy(_tokens(tcfg.vocab))}, trt,
            max_seq=MAX_SEQ)
        out = {"prefill": logits, "cache0": _clone(cache), "steps": []}
        for tok in reference(variant, compute, kv, impl)["tokens"]:
            logits, cache = tm.decode_fn(tp, cache, torch.tensor(tok),
                                         trt)
            out["steps"].append(logits)
    out["cache"] = cache
    return out


def cache_tensors(cache):
    """(part, name) -> tensor, for every tensor of a hybrid cache."""
    return {(part, name): t for part in ("groups", "kv", "rem")
            if part in cache for name, t in cache[part].items()}


def check_cache(jc, tc, kv, decoded=False):
    assert int(jc["pos"]) == tc["pos"]
    jt, tt = cache_tensors(jc), cache_tensors(tc)
    assert set(jt) == set(tt)
    for (part, name), j in jt.items():
        t = tt[part, name]
        assert tuple(t.shape) == j.shape, (part, name)
        assert str(t.dtype)[6:] == jnp.dtype(j.dtype).name, (part, name)
        if kv == "int8" and part == "kv" and not name.endswith("_scale"):
            a, b = t2n(t), j2n(j)
            assert np.abs(a - b).max() <= 1, name
            assert (a != b).mean() < 1e-3, name
        else:
            tol = 1e-2 if (part == "kv" and kv == "bfloat16") else \
                2e-3 if (decoded and kv != "float32") else \
                2e-4 if name == "ssm" else 1e-4
            rel_close(t, j, tol)


@pytest.mark.parametrize("variant", ["reduced", "rem"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_f32_prefill_cache_decode(variant, impl, kv):
    ref, got = reference(variant, "float32", kv, impl), \
        port(variant, "float32", kv, impl)
    jlog, tlog = ref["prefill"], got["prefill"]
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    rel_close(tlog, jlog, 1e-4)
    np.testing.assert_array_equal(
        tlog[:, -1].argmax(-1).numpy(), np.asarray(jnp.argmax(jlog[:, -1], -1)))
    check_cache(ref["cache0"], got["cache0"], kv)
    for jl, tl in zip(ref["steps"], got["steps"]):
        rel_close(tl, jl, 1e-4 if kv == "float32" else 2e-3)
        if kv == "float32":     # greedy tokens equal
            np.testing.assert_array_equal(
                tl[:, -1].argmax(-1).numpy(),
                np.asarray(jnp.argmax(jl[:, -1], -1)))
    check_cache(ref["cache"], got["cache"], kv, decoded=True)
    assert got["cache"]["pos"] == S + STEPS
