"""Whether what the timed path served is right.

The window keeps, for a few whole waves drawn from the seed, the
last-position logits that the timed path returned at each step (the
logits each served token was the argmax of).  Once the window has
closed and the program's state is freed, the weights are made again
from the seed, and the plain reference (``portbench/reference/<name>
.py``, float32, TF32 off) runs once over each judged request's padded
prompt followed by its served tokens.  At every served position:

* ``logit_err_mean``, compared: the program's logits against the
  reference's, the norm of their difference over the norm of the
  reference's (each centred over the vocabulary, as softmax ignores a
  shift), averaged over the served positions;
* ``served_logit_gap`` and ``served_gap_mean``, read and reported: how
  far the served token's reference logit lies below the reference's
  best, the widest and the mean.  They count rare near-tie flips and
  swing with the seed's weights too much to separate the control.

The control puts the reference in the program's place at the precision
below the served bf16 (``Prec("fp8")``): its logits and first choices,
read against the float32 reference's in the same way.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from portbench import weights
from portbench.reference import common as C


def _rows(rows, pad_to: int, device):
    """Token rows (left-padded with 0 to ``pad_to``, then the served
    tokens but the last), right-padded to one length; and per row the
    positions that produced its served tokens."""
    seqs, where = [], []
    for prompt, gen, _ in rows:
        seq = [0] * (pad_to - len(prompt)) + list(prompt) + list(gen[:-1])
        seqs.append(seq)
        where.append(list(range(pad_to - 1, pad_to - 1 + len(gen))))
    n = max(len(s) for s in seqs)
    toks = torch.zeros((len(seqs), n), dtype=torch.long)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = torch.tensor(s)
    return toks.to(device), where


def reference_weights(ctx):
    """The configuration's weights, made again from the seed."""
    return weights.make(ctx.model.param_shapes(), ctx.config["init"],
                        ctx.seed, ctx.device, torch.bfloat16)


def _blocks(rows: Sequence, n: int):
    for i in range(0, len(rows), n):
        yield rows[i:i + n]


def _logits(ctx, w, toks, where, prec):
    """Per row, the reference's logits (positions, vocab) at ``where``."""
    ref = ctx.reference
    h = ref.hidden(w, toks, ctx.arch, prec)
    return [ref.unembed(w, h[b, pos], prec) for b, pos in enumerate(where)]


def _err(lg, ref):
    """Per position, the centred logits' difference over the centred
    reference's norm."""
    lg = lg - lg.mean(-1, keepdim=True)
    ref = ref - ref.mean(-1, keepdim=True)
    return (lg - ref).norm(dim=-1) / ref.norm(dim=-1)


def _stats(gaps, errs) -> Dict[str, float]:
    g, e = torch.cat(gaps), torch.cat(errs)
    return {"logit_err_mean": float(e.mean()), "logit_err_max": float(e.max()),
            "served_logit_gap": float(g.max()),
            "served_gap_mean": float(g.mean())}


def _gap(lg, picked):
    return lg.max(-1).values - lg.gather(1, picked[:, None])[:, 0]


def _judge(ctx, rows, pad_to: int, low) -> Dict[str, float]:
    """The numbers over ``rows`` = (prompt, served tokens, the logits
    that served them): the program's, or with ``low`` the control's."""
    if not rows:
        return {"logit_err_mean": float("inf")}
    w = reference_weights(ctx)
    gaps, errs = [], []
    with C.judge_mode(), torch.no_grad():
        for block in _blocks(rows, int(ctx.config["ref_batch"])):
            toks, where = _rows(block, pad_to, ctx.device)
            exact = _logits(ctx, w, toks, where, C.Prec("f32"))
            other = (_logits(ctx, w, toks, where, C.Prec(low)) if low
                     else [lg.to(ctx.device) for _, _, lg in block])
            for (_, gen, _), ref, lg in zip(block, exact, other):
                got = (lg.argmax(-1) if low else
                       torch.tensor(gen, device=ref.device))
                gaps.append(_gap(ref, got))
                errs.append(_err(lg.float(), ref))
    return _stats(gaps, errs)


def served_gap(ctx, rows: List[Tuple], pad_to: int) -> Dict[str, float]:
    """How far what the program served lies from the reference."""
    return _judge(ctx, rows, pad_to, None)


def control_gap(ctx, rows: List[Tuple], pad_to: int) -> Dict[str, float]:
    """The control's readings at the same prompts and tokens: the fp8
    reference in the program's place."""
    return _judge(ctx, rows, pad_to, "fp8")
