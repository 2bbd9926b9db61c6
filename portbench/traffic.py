"""Seeded traffic for the serving cells, made from a mix file.

A mix (``portbench/mixes/<traffic>.json``) gives the ranges of prompt and
output lengths, the block of requests that share one set of sizes, and
how many requests a run draws.  ``arrivals: "backlog"``: every request
is due at the window's start.  ``sizes: "stratified"``: each block of
``block`` requests holds the same lengths, evenly spaced over the mix's
ranges with both ends in, in an order drawn from the seed.  Every seed
so gets the same work in another order, and a run's figures do not move
with the seed's draw of sizes.

Prompt token ids are drawn per request from a seed derived from the run's
seed and the request's id, over ``[1, vocab)``: 0 is the scheduler's
left-pad value.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List

import numpy as np


def sub_seed(seed: int, tag: str, bits: int = 32) -> int:
    """A seed for one purpose, derived from the run's seed (any integer)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()
    return int(h[:bits // 4], 16)


@dataclasses.dataclass(frozen=True)
class Req:
    rid: int
    prompt_len: int
    max_new: int
    tok_seed: int


def _spaced(lo: int, hi: int, n: int) -> List[int]:
    """``n`` lengths evenly spaced over [lo, hi], both ends in."""
    if n == 1:
        return [hi]
    return [int(round(lo + i * (hi - lo) / (n - 1))) for i in range(n)]


def requests(mix: Dict, seed: int) -> List[Req]:
    """The run's requests, all due at the window's start.  The same mix
    and seed give the same list on every host."""
    if mix["arrivals"] != "backlog" or mix["sizes"] != "stratified":
        raise ValueError("a mix is a backlog of stratified sizes")
    n, block = int(mix["n_requests"]), int(mix["block"])
    rng = np.random.RandomState(sub_seed(seed, "traffic"))
    (plo, phi), (olo, ohi) = mix["prompt"], mix["output"]
    P, O = _spaced(plo, phi, block), _spaced(olo, ohi, block)
    plen, onew = [], []
    for _ in range(-(-n // block)):
        order = rng.permutation(block)
        plen += [P[i] for i in order]
        onew += [O[i] for i in order]
    name = mix.get("name", "mix")
    return [Req(rid=i, prompt_len=plen[i], max_new=onew[i],
                tok_seed=sub_seed(seed, f"{name}:{i}"))
            for i in range(n)]


def prompt_tokens(req: Req, vocab: int) -> np.ndarray:
    """The request's prompt, regenerated from its own seed."""
    rng = np.random.RandomState(req.tok_seed)
    return rng.randint(1, vocab, size=req.prompt_len).astype(np.int32)
