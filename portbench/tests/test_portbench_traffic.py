"""The traffic generator: deterministic per seed, the stated
distributions and clips, the same work for every seed."""
import math
from statistics import NormalDist

import numpy as np
import pytest
import torch

from portbench import traffic
from helpers_tiny import tiny_cfg

MIXES = ["chat.poisson", "docqa.closed"]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = traffic.load(name)
    a, b = traffic.Stream(mix, 2 ** 31 + 7, 1000), \
        traffic.Stream(mix, 2 ** 31 + 7, 1000)
    for i in (0, 1, 17, traffic.POOL + 3):
        ra, rb = a.request(i), b.request(i)
        assert (ra.prompt_len, ra.max_gen) == (rb.prompt_len, rb.max_gen)
        assert np.array_equal(ra.tokens, rb.tokens)
    if "arrivals" in mix:
        assert a.due(50) == b.due(50)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_sizes(name):
    mix = traffic.load(name)
    n = traffic.POOL
    got = []
    for seed in (1, 2 ** 31 + 5, -3):
        s = traffic.Stream(mix, seed, 1000)
        got.append([s.request(i).prompt_len for i in range(n)])
    assert sorted(got[0]) == sorted(got[1]) == sorted(got[2])
    assert got[0] != got[1]


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("which", ["prompt_len", "output_len"])
def test_lengths_follow_clipped_lognormal(name, which):
    spec = traffic.load(name)[which]
    pool = traffic.lognormal_pool(spec, 4096)
    assert pool.min() >= spec["min"] and pool.max() <= spec["max"]
    assert abs(np.median(pool) - spec["median"]) <= 1
    nd = NormalDist(math.log(spec["median"]), spec["sigma"])
    for edge, want in ((spec["min"], nd.cdf(math.log(spec["min"]))),
                       (spec["max"], 1 - nd.cdf(math.log(spec["max"])))):
        share = np.mean(pool == edge)
        assert abs(share - want) < 0.01
    inner = pool[(pool > spec["min"]) & (pool < spec["max"])]
    q1, q3 = np.quantile(np.log(pool), [0.25, 0.75])
    if len(inner) > 0.6 * len(pool):
        assert abs((q3 - q1) / 1.349 - spec["sigma"]) < 0.05


def test_prompt_ids_uniform_over_vocabulary():
    s = traffic.Stream(traffic.load("chat.poisson"), 5, 50)
    ids = np.concatenate([s.request(i).tokens for i in range(40)])
    assert ids.min() >= 0 and ids.max() < 50
    counts = np.bincount(ids, minlength=50)
    assert counts.min() > 0.6 * counts.mean()


def test_poisson_gaps():
    mix = traffic.load("chat.poisson")
    rate = mix["arrivals"]["rate_per_s"]
    gaps = traffic.exponential_pool(rate, traffic.POOL)
    assert abs(gaps.mean() * rate - 1) < 0.01
    s = traffic.Stream(mix, 9, 100)
    due = [s.due(i) for i in range(300)]
    assert due[0] == 0 and all(b > a for a, b in zip(due, due[1:]))
    assert abs(due[-1] / 299 * rate - 1) < 0.2


def test_train_batches():
    mix = dict(traffic.load("train.s2048"), batch=3, seq=16)
    cfg = tiny_cfg()
    a = traffic.train_batch(mix, cfg, 2 ** 33, 4, "cpu")
    b = traffic.train_batch(mix, cfg, 2 ** 33, 4, "cpu")
    c = traffic.train_batch(mix, cfg, 2 ** 33, 5, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (3, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert len({tuple(r.tolist()) for r in a["tokens"]}) == 3
