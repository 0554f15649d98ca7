"""The traffic generator: the same seed gives the same requests, every
seed the same sizes and gaps in another order, at the stated
distributions."""

import math
from statistics import NormalDist

import numpy as np
import pytest

import _tiny  # noqa: F401
from harness import traffic

CHAT = {"kind": "open_loop",
        "prompt": {"dist": "lognormal", "median": 1020, "sigma": 0.8,
                   "min": 64, "max": 3584},
        "output": {"dist": "lognormal", "median": 129, "sigma": 0.8,
                   "min": 16, "max": 448}}
CELL = {"rate_per_s": 4.0}


def test_same_seed_same_requests():
    a = traffic.requests(CHAT, CELL, 2**31 + 7, 40, 50304)
    b = traffic.requests(CHAT, CELL, 2**31 + 7, 40, 50304)
    assert a.pairs() == b.pairs()
    assert np.array_equal(a.arrival_s, b.arrival_s)
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))


@pytest.mark.parametrize("seeds", [(1, 2), (5, 2**33 + 1)])
def test_every_seed_offers_the_same_work_in_another_order(seeds):
    a, b = (traffic.requests(CHAT, CELL, s, 40, 50304) for s in seeds)
    assert sorted(a.prompt_lens) == sorted(b.prompt_lens)
    assert sorted(a.output_lens) == sorted(b.output_lens)
    # the gaps between arrivals, and from the last one to the window's end
    ga, gb = ([*np.diff(r.arrival_s), 40 - r.arrival_s[-1]] for r in (a, b))
    assert np.allclose(sorted(ga), sorted(gb))
    assert a.pairs() != b.pairs()
    assert any(not np.array_equal(x, y)
               for x, y in zip(a.prompts, b.prompts))


def test_open_loop_arrivals_fill_the_window_at_the_rate():
    r = traffic.requests(CHAT, CELL, 3, 40, 50304)
    assert len(r) == 160
    assert r.arrival_s[0] == 0.0 and np.all(np.diff(r.arrival_s) >= 0)
    assert r.arrival_s[-1] < 40
    gaps = np.diff(r.arrival_s)
    # exponential gaps: mean 1/rate, about as many above the mean as e^-1
    assert gaps.mean() == pytest.approx(0.25, rel=0.05)
    assert np.mean(gaps > gaps.mean()) == pytest.approx(math.exp(-1),
                                                        abs=0.05)


def test_lengths_follow_the_stated_distribution():
    n = 2000
    lens = traffic.stratified_lengths(CHAT["prompt"], n)
    assert lens.min() >= 64 and lens.max() <= 3584
    assert np.median(lens) == pytest.approx(1020, rel=0.01)
    # the 90th percentile of a lognormal, median 1020, sigma 0.8
    q90 = 1020 * math.exp(0.8 * NormalDist().inv_cdf(0.9))
    assert np.quantile(lens, 0.9) == pytest.approx(q90, rel=0.01)
    uni = traffic.stratified_lengths({"dist": "uniform", "min": 16,
                                      "max": 96}, 810)
    assert uni.min() == 16 and uni.max() == 96
    assert np.bincount(uni)[16:].min() >= 9


def test_offline_backlog_is_due_at_once():
    mix = {**CHAT, "kind": "backlog"}
    r = traffic.requests(mix, {"backlog": 50}, 9, 40, 65024)
    assert len(r) == 50 and not r.arrival_s.any()
    assert all(p.max() < 65024 and len(p) == n
               for p, n in zip(r.prompts, r.prompt_lens))


@pytest.mark.parametrize("seeds", [(1, 2), (7, 2**33 + 5)])
def test_a_blocked_backlog_offers_the_same_work_in_every_prefix(seeds):
    mix = {**CHAT, "kind": "backlog", "block": 32}
    a, b = (traffic.requests(mix, {"backlog": 1536}, s, 51, 65024)
            for s in seeds)
    assert sorted(a.prompt_lens) == sorted(b.prompt_lens)
    assert a.pairs() != b.pairs()
    strata = traffic.stratified_lengths(CHAT["prompt"], 1536).reshape(32, -1)
    for r in (a, b):
        # each run of 32 holds one prompt length of each stratum
        for j in range(0, 1536, 32):
            run = np.sort(r.prompt_lens[j:j + 32])
            assert np.all((run >= strata[:, 0]) & (run <= strata[:, -1]))
    # the work of any prefix (prompt and output tokens) agrees within 5%
    for n in (256, 400, 600, 900):
        wa, wb = (r.prompt_lens[:n].sum() + r.output_lens[:n].sum()
                  for r in (a, b))
        assert wa == pytest.approx(wb, rel=0.05)
    with pytest.raises(ValueError):
        traffic.requests(mix, {"backlog": 50}, 1, 51, 65024)


def test_training_batches_are_fresh_rows_every_step():
    mix = {"kind": "tokens", "batch": 8, "seq_len": 2048}
    a = traffic.token_batch(mix, 11, 0, 50304)
    assert a.shape == (8, 2049) and a.max() < 50304
    assert np.array_equal(a, traffic.token_batch(mix, 11, 0, 50304))
    rows = np.concatenate([traffic.token_batch(mix, 11, k, 50304)
                           for k in range(4)])
    assert len({r.tobytes() for r in rows}) == 32
