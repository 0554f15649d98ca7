"""The one traffic generator: every mix is a data file that this reads.

Sizes and gaps are stratified: a mix of ``n`` requests takes its prompt
lengths, output lengths and inter-arrival gaps at the quantiles
``(i + 0.5) / n`` of their stated distributions, and the seed only
permutes them (each independently) and draws the prompt tokens.  So
every seed offers the same work in another order, and runs with
different seeds spread no more than runs of one seed.

Mix kinds (``"kind"`` in the file):

* ``open_loop`` — Poisson arrivals at the cell's ``rate_per_s`` over the
  window ``[0, seconds)``: ``n = round(rate · seconds)`` exponential gaps,
  scaled to sum to the window;
* ``backlog`` — the cell's ``backlog`` requests, all due at t = 0.  A
  window serves only a prefix of the backlog, so with ``"block": b`` in
  the mix every run of ``b`` consecutive requests holds one length from
  each of ``b`` strata of the sorted lengths (``backlog`` a multiple of
  ``b``): any prefix then offers about the same work whatever the seed;
* ``tokens`` — training batches of uniform token ids,
  ``batch × (seq_len + 1)`` a step (inputs and next-token labels);
* ``ctr_ids`` — click-through training batches of ``batch`` examples a
  step, one id per slot of the configuration's ``ctr.cardinalities``:
  slot ``s`` owns the rows ``[offset_s, offset_s + card_s)``, and its id
  is a bounded Zipf draw (``zipf_exponent``, by the inverse CDF) over
  them, rank ``r`` (0 the most frequent) giving row ``offset_s + r``.
  The labels follow a seeded logistic model of the ids: each example's
  score is ``Σ_s w_s · cos(id_s · GOLDEN_ANGLE)`` (``w_s`` normal with
  deviation ``label_weight``) plus standard logistic noise, and the
  ``round(positive_rate · batch)`` highest scores of the step are the
  clicks, so every step holds the same number of positives.  Step ``k``
  is drawn from its own stream, so a batch is made when it is asked for.

Length distributions: ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` or ``{"dist": "uniform", "min", "max"}`` (inclusive integers).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

_SEED_MASK = (1 << 64) - 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed`` (any integer)."""
    return np.random.default_rng([seed & _SEED_MASK, stream])


def quantile(dist: dict, p: float) -> float:
    """The ``p`` quantile of a length distribution, unclipped."""
    kind = dist["dist"]
    if kind == "lognormal":
        return dist["median"] * math.exp(dist["sigma"]
                                         * NormalDist().inv_cdf(p))
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return lo + p * (hi - lo + 1) - 0.5
    raise ValueError(f"unknown length distribution {kind!r}")


def stratified_lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the quantiles (i + 0.5) / n, clipped to
    ``[min, max]``, in ascending order."""
    q = [quantile(dist, (i + 0.5) / n) for i in range(n)]
    return np.clip(np.rint(q), dist["min"], dist["max"]).astype(np.int64)


def blocked(lengths: np.ndarray, block: int,
            r: np.random.Generator) -> np.ndarray:
    """``lengths`` (ascending, ``n`` a multiple of ``block``) reordered so
    that each run of ``block`` consecutive entries holds one entry of each
    of ``block`` strata (runs of ``n / block`` sorted entries), the seed
    choosing which of a stratum's entries goes to which run and the order
    within each run."""
    n = len(lengths)
    if n % block:
        raise ValueError(f"a backlog of {n} is not a multiple of the "
                         f"block {block}")
    strata = lengths.reshape(block, n // block)
    runs = np.stack([r.permutation(s) for s in strata]).T
    return np.concatenate([r.permutation(b) for b in runs])


def exponential_gaps(n: int, total: float) -> np.ndarray:
    """``n`` exponential quantile gaps scaled to sum to ``total``."""
    g = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    return g * (total / g.sum())


@dataclasses.dataclass
class Requests:
    prompt_lens: np.ndarray      # (n,) int
    output_lens: np.ndarray      # (n,) int
    arrival_s: np.ndarray        # (n,) float, non-decreasing
    prompts: list[np.ndarray]    # n int32 arrays

    def __len__(self) -> int:
        return len(self.prompt_lens)

    def pairs(self) -> list[tuple[int, int]]:
        return [(int(p), int(g))
                for p, g in zip(self.prompt_lens, self.output_lens)]


def request_count(mix: dict, cell: dict, seconds: float) -> int:
    if mix["kind"] == "open_loop":
        return max(1, round(cell["rate_per_s"] * seconds))
    if mix["kind"] == "backlog":
        return int(cell["backlog"])
    raise ValueError(f"mix kind {mix['kind']!r} has no requests")


def requests(mix: dict, cell: dict, seed: int, seconds: float,
             vocab: int) -> Requests:
    """The requests of one run of a serving cell."""
    n = request_count(mix, cell, seconds)
    r = rng(seed, 0)
    if mix.get("block"):
        plens, glens = (blocked(stratified_lengths(mix[k], n), mix["block"],
                                r) for k in ("prompt", "output"))
    else:
        plens = r.permutation(stratified_lengths(mix["prompt"], n))
        glens = r.permutation(stratified_lengths(mix["output"], n))
    if mix["kind"] == "open_loop":
        gaps = r.permutation(exponential_gaps(n, seconds))
        arrival = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    else:
        arrival = np.zeros(n)
    tok = rng(seed, 1)
    prompts = [tok.integers(0, vocab, size=int(p), dtype=np.int32)
               for p in plens]
    return Requests(plens, glens, arrival, prompts)


def max_lengths(mix: dict) -> tuple[int, int]:
    """The longest prompt and output the mix can draw."""
    return int(mix["prompt"]["max"]), int(mix["output"]["max"])


#: the feature of an id in the label model (radians)
GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))


def zipf_cdf(n: int, exponent: float) -> np.ndarray:
    """The CDF of the Zipf law ``p(r) ∝ r^-exponent`` over the ranks
    ``1..n`` (float64, exactly 1 at the end)."""
    c = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -exponent)
    return c / c[-1]


class ClickStream:
    """The ``ctr_ids`` batches of one seed over a configuration's slots:
    :meth:`batch` ``k`` gives step ``k``'s ``{"ids": (batch, slots) int32
    global row ids, "label": (batch,) float32}``, the same for the same
    seed and step whatever was drawn before."""

    def __init__(self, mix: dict, cardinalities, seed: int):
        cards = np.asarray(cardinalities, np.int64)
        self.batch_size = int(mix["batch"])
        self.offsets = np.concatenate([[0], np.cumsum(cards)[:-1]])
        self.cdfs = [zipf_cdf(int(n), mix["zipf_exponent"]) for n in cards]
        self.weights = rng(seed, 6000).standard_normal(len(cards)) \
            * mix["label_weight"]
        self.positives = round(mix["positive_rate"] * self.batch_size)
        self.seed = seed

    def batch(self, step: int) -> dict:
        r = rng(self.seed, 5000 + step)
        u = r.random((self.batch_size, len(self.cdfs)))
        ranks = np.stack([np.searchsorted(c, u[:, s])
                          for s, c in enumerate(self.cdfs)], axis=1)
        ids = self.offsets + ranks
        score = (np.cos(ids * GOLDEN_ANGLE) * self.weights).sum(axis=1) \
            + r.logistic(size=self.batch_size)
        label = np.zeros(self.batch_size, np.float32)
        label[np.argsort(-score, kind="stable")[:self.positives]] = 1.0
        return {"ids": ids.astype(np.int32), "label": label}


def token_batch(mix: dict, seed: int, step: int, vocab: int) -> np.ndarray:
    """Step ``step``'s (batch, seq_len + 1) int64 token ids: every row of
    every step is drawn afresh, so no two rows repeat."""
    return rng(seed, 1000 + step).integers(
        0, vocab, size=(mix["batch"], mix["seq_len"] + 1), dtype=np.int64)
