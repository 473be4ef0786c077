"""The one generator of the benchmark's traffic, read from a mix's
parameters (``traffic/<mix>.json``).

Serving mixes are closed loops: each client holds one request and sends
its next when the last completes.  Prompt and output lengths are drawn
from a clipped lognormal at evenly spaced quantiles, any whole number of
tokens, so every seed serves the same set of sizes, in an order and with
token ids drawn from the seed.  The order is a golden-ratio walk over the
sorted sizes from an offset drawn from the seed, and requests take its
entries in the order they are sent: whatever run of consecutive requests a
window sends covers the distribution evenly, so the seed changes the order
and not the work a window holds.
Training mixes pack documents of heavy-tailed length, each followed by the
end-of-sequence token, into rows of ``seq + 1`` tokens.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["quantile_lengths", "walk", "ClosedLoop", "PackedDocs"]

GOLDEN = (math.sqrt(5) - 1) / 2
SILVER = math.sqrt(2) - 1      # a second irrational step, so prompt and output pair freely


def quantile_lengths(dist: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantile midpoints (i + 0.5) / n of a lognormal
    with the given median and sigma, rounded to whole tokens and clipped to
    [min, max]."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(vals, dist["min"], dist["max"]).astype(np.int64)


def walk(n: int, step: float, offset: int) -> np.ndarray:
    """A permutation of range(n): ``offset + i * g`` mod n, with g the whole
    number nearest ``step * n`` that is prime to n.  For an irrational step
    every run of consecutive entries spreads evenly over range(n)."""
    g = max(1, int(round(step * n)))
    while math.gcd(g, n) != 1:
        g += 1
    return (int(offset) + g * np.arange(n)) % n


class ClosedLoop:
    """Request streams of a serving mix.  The i-th request sent, by any
    client, takes entry ``i % pool`` of the walked pools; a client's first
    request is cut to a share of its output, spread evenly over the
    clients, so that the loop starts in its steady state."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.clients, self.vocab, self.seed = int(mix["clients"]), vocab, int(seed)
        pool = int(mix["pool"])
        rng = np.random.default_rng([self.seed, 0])
        a, b = (int(x) for x in rng.integers(0, pool, 2))
        self.prompts = quantile_lengths(mix["prompt"], pool)[walk(pool, GOLDEN, a)]
        self.outputs = quantile_lengths(mix["output"], pool)[walk(pool, SILVER, b)]
        self.first_share = rng.permutation((np.arange(self.clients) + 0.5) / self.clients)
        self.sent = [0] * self.clients
        self.count = 0

    def warm_lengths(self, step: int) -> List[int]:
        """The prompt lengths set-up prefills once: every ``step`` tokens
        across the mix's range of lengths, its longest included.  Lengths
        between them reach the window unseen, as new lengths reach a server."""
        lo, hi = int(self.prompts.min()), int(self.prompts.max())
        return sorted(set(range(lo, hi + 1, int(step))) | {hi})

    def next(self, client: int) -> Tuple[List[int], int]:
        """The client's next request: its prompt's token ids and the number
        of tokens it asks for."""
        k = self.sent[client]
        self.sent[client] += 1
        j = self.count % len(self.prompts)
        self.count += 1
        n_prompt, n_out = int(self.prompts[j]), int(self.outputs[j])
        if k == 0:
            n_out = max(1, math.ceil(self.first_share[client] * n_out))
        rng = np.random.default_rng([self.seed, 1, client, k])
        return rng.integers(0, self.vocab, n_prompt).tolist(), n_out


class PackedDocs:
    """Training batches of a mix: ``rows`` rows of ``seq`` tokens and their
    next-token labels, documents packed back to back and each closed by
    ``eos``; batch k is drawn from the seed and k alone."""

    def __init__(self, mix: Dict, vocab: int, eos: int, seed: int):
        self.rows, self.seq = int(mix["rows"]), int(mix["seq"])
        self.doc, self.vocab, self.eos, self.seed = mix["document"], vocab, int(eos), int(seed)

    def batch(self, k: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, 2, k])
        d = self.doc
        out = np.empty((self.rows, self.seq + 1), np.int64)
        for r in range(self.rows):
            parts, have = [], 0
            while have < self.seq + 1:
                n = int(np.clip(np.rint(d["median"] * math.exp(d["sigma"] * rng.standard_normal())),
                                d["min"], d["max"]))
                ids = rng.integers(0, self.vocab - 1, n)
                ids[ids >= self.eos] += 1                    # every id but the separator
                parts += [ids, np.array([self.eos])]
                have += n + 1
            out[r] = np.concatenate(parts)[:self.seq + 1]
        return {"tokens": out[:, :-1].astype(np.int32), "labels": out[:, 1:].astype(np.int32)}
