"""The hybrid family through the PyTorch port's serving entry points
against the reference: the model API and input specs, the serve CLI, and
a registered tiny trace through both ``BatchScheduler``s in f32, whose
waves pad to ragged prompt lengths (the kernel path fits the SSM chunk
to a divisor of each one, the eager path pads) and must give the same
tokens and counters."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.params import default_config as jdefault
from repro.models.model import build_model as jbuild
from repro.serving import scheduler as JS, traffic as JT
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.params import default_config
from repro_torch.launch import serve
from repro_torch.models.model import build_model, input_specs, synth_inputs
from repro_torch.serving import scheduler as TS, traffic as TT

from test_torch_hybrid import cfgs, weights


def test_model_api_and_specs():
    jcfg, cfg = cfgs("rem")
    jm, m = jbuild(jcfg), build_model(cfg)
    jshapes = jax.tree.map(lambda s: (s.shape, jnp.dtype(s.dtype).name),
                           jm.param_shapes())

    def cmp(j, t):
        assert set(j) == set(t)
        for k in j:
            if isinstance(t[k], dict):
                cmp(j[k], t[k])
            else:
                assert j[k] == (t[k].shape, str(t[k].dtype)[6:]), k
    cmp(jshapes, m.param_shapes())
    assert m.logical() == jm.logical()
    for kv in ("bfloat16", "int8"):
        rt = default_config(kv_cache_dtype=kv)
        jshp, jlg = jm.cache_shapes(2, 16, jdefault(kv_cache_dtype=kv))
        tshp, tlg = m.cache_shapes(2, 16, rt)
        assert tlg == jlg
        assert set(tshp) == set(jshp) == {"groups", "kv", "pos", "rem"}
        for part in ("groups", "kv", "rem"):
            assert set(tshp[part]) == set(jshp[part])
            for k, s in jshp[part].items():
                assert tshp[part][k].shape == s.shape
                assert str(tshp[part][k].dtype)[6:] == jnp.dtype(s.dtype).name
        cache = m.init_cache(2, 16, rt, device="cpu")
        assert cache["pos"] == 0
        assert cache["groups"]["ssm"].shape == jshp["groups"]["ssm"].shape
        assert cache["rem"]["conv"].dtype == torch.float32
        assert cache["kv"]["k"].dtype == (torch.int8 if kv == "int8"
                                          else torch.bfloat16)
    rt = default_config()
    batch = synth_inputs(cfg, ShapeConfig("t", 8, 3, "prefill"), rt,
                         torch.Generator().manual_seed(0))
    assert set(batch) == {"tokens"} and batch["tokens"].shape == (3, 8)
    assert set(input_specs(cfg, ShapeConfig("t", 8, 3, "train"), rt)) == \
        {"tokens", "labels"}
    assert input_specs(cfg, ShapeConfig("t", 8, 3, "decode"),
                       rt)["tokens"].shape == (3, 1)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_tiny_trace_same_tokens_and_counters(impl):
    jp, tp = weights("reduced")
    jcfg, tcfg = cfgs("reduced")
    kw = dict(wave_size=3, max_seq=32)
    js = JS.BatchScheduler(jcfg, jdefault(attn_impl=impl), jp, **kw)
    ts = TS.BatchScheduler(tcfg, default_config(attn_impl=impl), tp,
                           device="cpu", **kw)
    trace = TT.get_trace("poisson_tiny")
    assert trace.to_json() == JT.get_trace("poisson_tiny").to_json()
    for mod, sched in ((JS, js), (TS, ts)):
        for r in trace.requests:
            sched.submit(mod.Request(rid=r.rid,
                                     tokens=TT.request_tokens(r),
                                     max_new_tokens=r.max_new_tokens,
                                     t_submit=0.0))
    jdone, tdone = js.run_until_drained(), ts.run_until_drained()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert len(tdone) == len(trace.requests)
    for a, b in zip(tdone, jdone):
        assert a.generated == b.generated
        assert len(a.generated) == a.max_new_tokens
    m, jmx = ts.metrics, js.metrics
    assert (m.requests, m.decode_tokens, m.prefill_tokens) == \
        (jmx.requests, jmx.decode_tokens, jmx.prefill_tokens)


@pytest.mark.parametrize("argv", [
    ["--kv-dtype", "bfloat16"], ["--kv-dtype", "int8", "--attn-impl", "xla"]])
def test_serve_cli_on_cpu(argv, capsys):
    rc = serve.main(["--arch", "zamba2-7b", "--device", "cpu", "--reduced",
                     "--batch", "2", "--prompt-len", "8", "--gen-tokens", "3",
                     *argv])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=zamba2-7b-reduced" in out and "decode:" in out
