"""Batched serving CLI: prefill a prompt batch, decode N tokens.

Runs on the CUDA device unless ``--device cpu`` is given; with no card
and no such request it raises.  ``--reduced`` serves a reduced config
(the CPU tests do).

The reference CLI builds its config with ``attn_impl="xla"`` and so
reaches no kernel; that knob's own documentation reads "pallas" as the
setting for the accelerator, so this CLI has ``--attn-impl`` and
defaults it to ``pallas`` (the hand-written CUDA kernels); ``xla`` is
eager torch ops.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.params import default_config
from repro_torch.models.model import build_model, resolve_device, synth_inputs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--kv-dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="pallas", choices=("xla", "pallas"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    rt = default_config(compute_dtype="bfloat16",
                        kv_cache_dtype=args.kv_dtype,
                        attn_impl=args.attn_impl)
    model = build_model(cfg)
    max_seq = args.prompt_len + args.gen_tokens

    with torch.no_grad():
        # parameters are cast to the compute dtype once, here; the f32
        # master tree is not kept (27 GB beside 13 GB of bf16 at zamba2-7b)
        params = model.cast_params(model.init(args.seed, device=device), rt)
        pshape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        batch = synth_inputs(cfg, pshape, rt, gen)

        _sync(device)
        t0 = time.time()
        logits, cache = model.prefill_fn(params, batch, rt, max_seq=max_seq)
        _sync(device)
        t_prefill = time.time() - t0
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)

        generated = [tok]
        t0 = time.time()
        for _ in range(args.gen_tokens - 1):
            logits, cache = model.decode_fn(params, cache, tok, rt)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            generated.append(tok)
        _sync(device)
        t_dec = time.time() - t0
        toks = torch.cat(generated, dim=1)

    n_dec = args.batch * (args.gen_tokens - 1)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"device={device} attn_impl={args.attn_impl}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_dec*1e3:.1f} ms for {n_dec} tokens "
          f"({n_dec/max(t_dec,1e-9):.0f} tok/s)")
    print(f"sample tokens[0,:8]: {toks[0,:8].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
