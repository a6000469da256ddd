"""The one traffic generator: it reads a mix's data file
(``bench/traffic/<mix>.json``) and the cell's parameters and makes the
requests from the seed.

Every seed gets the same schedule: prompt and output lengths are the
lognormal's quantiles at (i + 0.5) / n, clipped, and the gaps between
arrivals the exponential's, scaled so that n arrivals span n / rate seconds;
the mix's ``order_seed`` puts them in one order, and the run's seed draws
the token ids (uniform over the vocab). Only the ids move between seeds, so
runs of one cell do the same work and differ by the host's speed alone.

Arrivals ``"poisson"``: an open loop at the cell's ``rate_per_s``, starting
``ramp_s`` before the window (times are seconds from the window's start, so
the ramp's are negative); the ramp and the window are each a fixed set.
Arrivals ``"waves"``: ``wave_size`` requests a wave, all due at the wave's
start; wave w's order is drawn from (``order_seed``, w), its ids from
(seed, w).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Arrival:
    due: float  # seconds from the window's start
    prompt: List[int]
    max_new_tokens: int


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths: the lognormal (``median``, ``sigma``) at (i + 0.5) / n,
    rounded and clipped to [``min``, ``max``]."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def _tokens(rng: np.random.Generator, lengths, vocab: int) -> List[List[int]]:
    return [rng.integers(0, vocab, size=int(n)).tolist() for n in lengths]


def _segment(mix: dict, rng: np.random.Generator, order: np.random.Generator, n: int, start: float, span: float,
             vocab: int) -> List[Arrival]:
    """n arrivals over [start, start + span): the exponential's quantile
    gaps scaled to the span, the first at ``start``; gaps and lengths in the
    order ``order`` draws; token ids from ``rng``."""
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps = order.permutation(gaps * span / gaps.sum())
    due = start + np.cumsum(gaps) - gaps[0]
    prompts = order.permutation(quantile_lengths(mix["prompt"], n))
    outs = order.permutation(quantile_lengths(mix["output"], n))
    return [Arrival(float(t), p, int(o)) for t, p, o in zip(due, _tokens(rng, prompts, vocab), outs)]


def open_loop(mix: dict, cell: dict, seed: int, seconds: float, vocab: int) -> List[Arrival]:
    """The whole schedule of a ``poisson`` mix: the ramp's rate x ramp_s
    arrivals over [-ramp_s, 0), then the window's rate x seconds over
    [0, seconds), each segment with its own fixed set of gaps and lengths."""
    if mix["arrivals"] != "poisson":
        raise ValueError(f"mix arrivals {mix['arrivals']!r} is not an open loop")
    rate, ramp = cell["rate_per_s"], cell["ramp_s"]
    rng = np.random.default_rng([seed, 0])
    order = np.random.default_rng([mix["order_seed"], 0])
    out: List[Arrival] = []
    if ramp > 0:
        out += _segment(mix, rng, order, max(1, round(rate * ramp)), -ramp, ramp, vocab)
    return out + _segment(mix, rng, order, max(1, round(rate * seconds)), 0.0, seconds, vocab)


def wave(mix: dict, seed: int, index: int, vocab: int) -> List[Arrival]:
    """Wave ``index`` of a ``waves`` mix, all due at 0 (the wave's start)."""
    if mix["arrivals"] != "waves":
        raise ValueError(f"mix arrivals {mix['arrivals']!r} is not waves")
    n = mix["wave_size"]
    rng = np.random.default_rng([seed, 1, index])
    order = np.random.default_rng([mix["order_seed"], 1, index])
    prompts = order.permutation(quantile_lengths(mix["prompt"], n))
    outs = order.permutation(quantile_lengths(mix["output"], n))
    return [Arrival(0.0, p, int(o)) for p, o in zip(_tokens(rng, prompts, vocab), outs)]


def longest_prompt(mix: dict) -> int:
    return int(mix["prompt"]["max"])
