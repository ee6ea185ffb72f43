"""The one traffic generator: a stream of requests from a traffic file
(`traffic/<name>.json`) and a seed.

A traffic file gives prompt and output lengths as clipped log-normal
distributions (median, sigma, min, max), the size of the pool they are
drawn into, and the arrival process: `backlog` (a queue that never
empties; the harness tops it up) or `poisson` (an open loop whose rate
the cell file fixes).

Every seed serves the same requests' lengths at the same times: the pool
holds the distribution's quantiles at evenly spaced probabilities,
prompt and output lengths are paired, and each pass over the pool is
ordered, by permutations drawn from the traffic file's `pair_seed`; the
run's seed draws the token ids (and the harness the weights).  An order
drawn from the run's seed made the open loop's tails swing with the
bursts it happened to form (on an H100, the 95th percentile of time to first token
from 1549 to 3247 ms over three seeds, against 2034-2218 ms for three
runs of one seed), so the order is part of the traffic, not of the seed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """`n` lengths: the clipped log-normal's quantiles at (i + 0.5) / n."""
    nd = NormalDist()
    mu = math.log(spec["median"])
    out = [math.exp(mu + spec["sigma"] * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(out), spec["min"], spec["max"]).astype(np.int64)


def bucket(n: int) -> int:
    """The power of two at or above n: the prefill length of an n-token
    prompt in the engine."""
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


class Stream:
    """Requests in order: `next()` gives (index, prompt int32[S],
    max_new_tokens, due seconds after the loop's origin; 0.0 for a
    backlog)."""

    def __init__(self, traffic: dict, seed: int, vocab: int, rate_per_s=None):
        self.t = traffic
        n = traffic["pool"]
        self.prompts = quantile_lengths(traffic["prompt"], n)
        outs = quantile_lengths(traffic["output"], n)
        pair = np.random.default_rng(traffic["pair_seed"]).permutation(n)
        self.outputs = outs[pair]
        self.rng = np.random.default_rng(seed)
        self.order_rng = np.random.default_rng(traffic["pair_seed"] + 1)
        self.vocab = vocab
        self.kind = traffic["arrival"]
        if self.kind == "poisson":
            if not rate_per_s or rate_per_s <= 0:
                raise ValueError("a poisson traffic needs the cell's rate_per_s")
            # exponential quantiles: the same gaps for every seed
            self.gaps = np.array([-math.log(1 - (i + 0.5) / n) for i in range(n)]) / rate_per_s
        elif self.kind != "backlog":
            raise ValueError(f"unknown arrival process {self.kind!r}")
        self.i = 0
        self.due = 0.0
        self._order = None

    def next(self):
        n = len(self.prompts)
        k = self.i % n
        if k == 0:
            self._order = self.order_rng.permutation(n)
            self._gap_order = self.order_rng.permutation(n)
        j = self._order[k]
        S, new = int(self.prompts[j]), int(self.outputs[j])
        prompt = self.rng.integers(0, self.vocab, size=S, dtype=np.int64).astype(np.int32)
        if self.kind == "poisson":
            self.due += float(self.gaps[self._gap_order[k]])
        idx = self.i
        self.i += 1
        return idx, prompt, new, self.due

    def buckets(self) -> list:
        """The prefill lengths this traffic can reach."""
        return sorted({bucket(int(s)) for s in self.prompts})

    def longest(self) -> int:
        """The most tokens one request holds: prompt plus output."""
        return int(max(self.prompts) + max(self.outputs))
