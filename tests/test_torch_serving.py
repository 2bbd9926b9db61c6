"""The PyTorch port's BatchScheduler, traffic traces and serve CLI against
the reference: the same requests through both schedulers in f32 give the
same tokens and the same counters."""
import hashlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core.params import default_config as jdefault
from repro.models.model import build_model as jbuild
from repro.serving import scheduler as JS, traffic as JT
from repro_torch.configs import get_reduced
from repro_torch.core.params import default_config
from repro_torch.launch import serve
from repro_torch.serving import scheduler as TS, traffic as TT

from _torch_parity import shared_params


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_reduced("smollm-135m")
    return shared_params(jbuild(jcfg).init(jax.random.PRNGKey(0)))


def make(weights, *, sched_kw=None, **rt_kw):
    jp, tp = weights
    kw = dict(wave_size=3, max_seq=48, **(sched_kw or {}))
    js = JS.BatchScheduler(jget_reduced("smollm-135m"), jdefault(**rt_kw),
                           jp, **kw)
    ts = TS.BatchScheduler(get_reduced("smollm-135m"), default_config(**rt_kw),
                           tp, device="cpu", **kw)
    return js, ts


def requests(mod, n, eos=None, t_submit=None):
    out = []
    for rid in range(n):
        rng = np.random.RandomState(100 + rid)
        out.append(mod.Request(
            rid=rid,
            tokens=rng.randint(1, 500, 4 + 2 * rid).astype(np.int32),
            max_new_tokens=3 + rid % 4, eos_id=eos, t_submit=t_submit))
    return out


def drain(sched, reqs):
    for r in reqs:
        sched.submit(r)
    return sched.run_until_drained()


def counters(m):
    return (m.requests, m.decode_tokens, m.prefill_tokens)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ten_requests_same_tokens_and_counters(weights, impl):
    js, ts = make(weights, attn_impl=impl)
    jdone = drain(js, requests(JS, 10))
    tdone = drain(ts, requests(TS, 10))
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(10))
    for a, b in zip(tdone, jdone):
        assert a.generated == b.generated
        assert len(a.generated) == a.max_new_tokens
        assert a.t_first_token is not None and a.t_done is not None
    assert counters(ts.metrics) == counters(js.metrics)
    assert set(ts.metrics.summary()) == set(js.metrics.summary())
    assert len(ts.metrics.ttft_s) == 10


@pytest.mark.parametrize("kv,donate", [("int8", True), ("bfloat16", False)])
def test_cache_knobs_reach_the_decode_path(weights, kv, donate):
    js, ts = make(weights, kv_cache_dtype=kv, donate_buffers=donate)
    jdone = drain(js, requests(JS, 4))
    tdone = drain(ts, requests(TS, 4))
    # rounded caches: the f32 logits agree to ~1e-3, so greedy tokens
    # agree unless two logits tie that closely; these seeds do not
    assert [r.generated for r in tdone] == [r.generated for r in jdone]
    assert counters(ts.metrics) == counters(js.metrics)


def test_eos_retirement(weights):
    js, ts = make(weights)
    first = drain(ts, requests(TS, 3))
    eos = first[1].generated[1]          # the token lane 1 emits second
    js, ts = make(weights)
    jdone = drain(js, requests(JS, 3, eos=eos))
    tdone = drain(ts, requests(TS, 3, eos=eos))
    assert [r.generated for r in tdone] == [r.generated for r in jdone]
    assert tdone[1].generated[-1] == eos
    assert len(tdone[1].generated) == 2 < tdone[1].max_new_tokens
    assert counters(ts.metrics) == counters(js.metrics)


def test_pad_to_and_pad_wave(weights):
    kw = dict(pad_to=24, pad_wave=True)
    js, ts = make(weights, sched_kw=kw)
    jdone = drain(js, requests(JS, 4))     # second wave has one real lane
    tdone = drain(ts, requests(TS, 4))
    assert [r.generated for r in tdone] == [r.generated for r in jdone]
    assert counters(ts.metrics) == counters(js.metrics)
    assert ts.metrics.prefill_tokens == 4 * 24
    toks = ts._pad_prompts(requests(TS, 2))
    assert tuple(toks.shape) == (3, 24) and toks.dtype == torch.int32
    assert int(toks[0, :20].abs().sum()) == 0      # left-padded with 0
    assert int(toks[2].abs().sum()) == 0           # filler lane


def test_explicit_t_submit_zero_is_kept(weights):
    _, ts = make(weights)
    reqs = requests(TS, 2, t_submit=0.0)
    done = drain(ts, reqs)
    assert all(r.t_submit == 0.0 for r in done)
    assert all(r.ttft_s == r.t_first_token for r in done)
    r = TS.Request(rid=9, tokens=np.ones(3, np.int32))
    ts.submit(r)
    assert r.t_submit is not None and r.t_submit > 0
    assert TS.ServeMetrics().summary() == JS.ServeMetrics().summary()
    assert ts.run_until_drained() and ts.run_wave() == []


def test_step_budget_is_capped_by_max_seq(weights):
    js, ts = make(weights, sched_kw=dict(pad_to=40))
    mk = lambda mod: [mod.Request(rid=0, tokens=np.arange(1, 9, dtype=np.int32),
                                  max_new_tokens=30)]
    jdone, tdone = drain(js, mk(JS)), drain(ts, mk(TS))
    # steps = min(budget, max_seq - S - 1) = min(29, 48 - 40 - 1) = 7
    assert len(tdone[0].generated) == len(jdone[0].generated) == 8
    assert tdone[0].generated == jdone[0].generated


@pytest.mark.parametrize("name", sorted(JT.TRACE_SPECS))
def test_registered_traces_equal_bytes_and_key(name):
    # the port's registry adds its full-width trace, poisson_card
    assert tuple(n for n in TT.trace_names()
                 if not TT.TRACE_SPECS[n].full_width) == JT.trace_names()
    a, b = TT.get_trace(name), JT.get_trace(name)
    assert a.to_json() == b.to_json()
    assert a.key() == b.key() == hashlib.sha1(
        b.to_json().encode()).hexdigest()[:16]
    for ra, rb in zip(a.requests, b.requests):
        np.testing.assert_array_equal(TT.request_tokens(ra),
                                      JT.request_tokens(rb))
    assert TT.Trace.from_json(a.to_json()).to_json() == a.to_json()


def test_trace_save_load_roundtrip(tmp_path):
    t = TT.get_trace("poisson_tiny")
    t.save(tmp_path / "sub" / "t.json")
    assert TT.Trace.load(tmp_path / "sub" / "t.json").key() == t.key()
    assert [p.name for p in (tmp_path / "sub").iterdir()] == ["t.json"]
    with pytest.raises(ValueError):
        TT.generate(TT.TraceSpec("x", "poisson", 1, 1.0, 0, ()))


@pytest.mark.parametrize("argv", [
    ["--kv-dtype", "bfloat16"],
    ["--kv-dtype", "int8", "--attn-impl", "xla"],
    ["--arch", "glm4-9b", "--kv-dtype", "int8"]])
def test_serve_cli_on_cpu(argv, capsys):
    rc = serve.main(["--device", "cpu", "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen-tokens", "4", *argv])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out and "device=cpu" in out
