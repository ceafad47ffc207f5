"""The one traffic generator: every mix is a data file under
``portbench/traffic/`` that this module reads.

Lengths and arrival gaps come from a fixed pool of ``POOL`` draws per
cycle, taken at evenly spaced quantiles of the stated distribution
(lognormal lengths clipped to ``[min, max]``, exponential gaps of a
Poisson process), and ``--seed`` only orders them: every seed gets the
same sizes and arrivals in another order, so runs with different seeds do
the same work.  Prompt token ids are uniform over the vocabulary, drawn
per request from the seed.  Training batches are uniform token ids too,
``S + 1`` per row, drawn on the device per step; labels are the next
tokens.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np
import torch

from portbench.weights import sub_seed

HERE = Path(__file__).resolve().parent
POOL = 128      # draws of each length and gap per cycle of a stream


def load(name: str) -> dict:
    """The mix ``portbench/traffic/<name>.json``."""
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_pool(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at evenly spaced quantiles of a lognormal of median
    ``spec["median"]`` and log-sd ``spec["sigma"]``, rounded and clipped
    to ``[spec["min"], spec["max"]]``."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf(u) for u in quantiles(n)])
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def exponential_pool(rate: float, n: int) -> np.ndarray:
    """``n`` gaps (s) at evenly spaced quantiles of an exponential of
    ``rate`` per second."""
    return -np.log1p(-quantiles(n)) / rate


@dataclass
class Draw:
    """One request: its index in the stream, lengths and prompt."""
    index: int
    prompt_len: int
    max_gen: int
    tokens: np.ndarray


class Stream:
    """The requests of a serving mix in order, cycling through the pool
    with a fresh order each cycle, and (open loop) each one's due time in
    seconds after the schedule's start."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, int(seed), int(vocab)
        self.n = POOL
        self._prompt = lognormal_pool(spec["prompt_len"], self.n)
        self._output = lognormal_pool(spec["output_len"], self.n)
        arr = spec.get("arrivals")
        self._gaps = (exponential_pool(arr["rate_per_s"], self.n)
                      if arr else None)
        self._orders: dict = {}
        self._due: List[float] = []

    @property
    def longest_prompt(self) -> int:
        """The longest prompt length in the pool."""
        return int(self._prompt.max())

    @property
    def longest_output(self) -> int:
        """The longest output length in the pool."""
        return int(self._output.max())

    def _order(self, cycle: int, what: int) -> np.ndarray:
        key = (cycle, what)
        if key not in self._orders:
            rng = np.random.default_rng(sub_seed(self.seed, 1, what, cycle))
            self._orders[key] = rng.permutation(self.n)
        return self._orders[key]

    def _pick(self, pool: np.ndarray, i: int, what: int):
        cycle, j = divmod(i, self.n)
        return pool[self._order(cycle, what)[j]]

    def request(self, i: int) -> Draw:
        n = int(self._pick(self._prompt, i, 0))
        rng = np.random.default_rng(sub_seed(self.seed, 2, i))
        return Draw(i, n, int(self._pick(self._output, i, 1)),
                    rng.integers(0, self.vocab, n).astype(np.int32))

    def due(self, i: int) -> float:
        """Due time of request ``i`` (open loop): the sum of the gaps
        before it, the first due at 0."""
        while len(self._due) <= i:
            k = len(self._due)
            self._due.append(0.0 if k == 0 else
                             self._due[-1] + float(self._pick(self._gaps,
                                                              k - 1, 2)))
        return self._due[i]


def train_batch(spec: dict, cfg: dict, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch: ``{"tokens", "labels"}`` int64 ``[B, S]`` of
    uniform ids, the labels the next ids."""
    b, s = spec["batch"], spec["seq"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3, step))
    seq = torch.randint(0, cfg["vocab_size"], (b, s + 1), generator=gen,
                        device=device)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
