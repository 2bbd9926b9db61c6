"""The yardstick's counts against hand counts at one shape."""
import importlib.util
import pathlib

import pytest

from portbench import modelflops, peaks
from portbench.reference import moe_transformer

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"


def _metric(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arg(shape, dtype):
    return {"shape": shape, "dtype": dtype}


def test_flash_attention_count_by_hand():
    q = _arg((2, 3, 4, 8), "bfloat16")
    call = {"args": [q, q, q], "kw": {"causal": True}}
    flops, nbytes, _ = _metric("flash_attention_roofline").count(call)
    assert flops == 4 * 8 * (3 * 4 // 2) * 2 * 4
    assert nbytes == 4 * 2 * 3 * 4 * 8 * 2
    call["kw"]["causal"] = False
    assert _metric("flash_attention_roofline").count(call)[0] == \
        4 * 8 * 9 * 2 * 4


def test_least_seconds():
    assert peaks.least_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, "bfloat16") == pytest.approx(1.0)


@pytest.mark.parametrize("prompt,gen", [(1, 1), (5, 3), (17, 9)])
def test_served_flops_is_the_sum_over_tokens(prompt, gen):
    a, b, u = 7.0, 3.0, 11.0
    brute = sum(a + b * (c + 1) for c in range(prompt + gen - 1)) + u * gen
    assert modelflops.served((a, b, u), prompt, gen) == brute


def test_flops_terms_by_hand():
    moe = {"d_model": 4, "n_experts": 4, "top_k": 2, "d_ff": 2, "n_heads": 2,
           "n_kv_heads": 2, "head_dim": 2, "n_layers": 2, "vocab": 10}
    # per layer: attn 128, router 32, experts 2 * 2 * 3 * 4 * 2 = 96
    assert moe_transformer.flops_terms(moe) == (2 * 256, 32, 80)
