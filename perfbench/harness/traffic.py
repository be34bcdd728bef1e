"""The one traffic generator: a mix's parameters and a seed give a
schedule of sessions.

Arrivals are an open loop at a fixed rate: Poisson inter-arrival gaps.
Every quantity is drawn stratified: n values at the quantiles (i + 0.5) / n
of its distribution, put in an order drawn from the seed.  So every seed
offers the same set of gaps, prompt lengths, output lengths and pauses,
in another order, and the work of a run does not change with the seed.
Token ids are drawn uniformly from ``[2, vocab)``.

A session has phases: each phase asks for some output tokens, and every
phase but the last ends with a pause (a tool call) before the next one.

A mix's file names its ``source``: the public trace or benchmark its
sizes follow.  Distributions, as ``{"dist": ..., ...}`` in the file:
``fixed`` (``value``), ``uniform`` (``lo``, ``hi``, real),
``uniform_int`` (``lo``, ``hi``, both included) and ``log_uniform``
(``lo``, ``hi``, rounded to a whole number).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Session:
    idx: int
    due_s: float             # from the schedule's start
    prompt: np.ndarray       # int32 token ids
    outputs: list            # output tokens of each phase
    pauses: list             # seconds after each phase but the last


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of one seed (any whole number,
    negative ones folded into 64 bits)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n values of ``dist`` at the quantiles (i + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, dist["value"], dtype=np.float64)
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if kind == "uniform":
        return lo + u * (hi - lo)
    if kind == "uniform_int":
        return np.floor(lo + u * (hi - lo + 1))
    if kind == "log_uniform":
        return np.round(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
    raise ValueError(f"unknown distribution {kind!r}")


def most(dist: dict) -> int:
    """The largest value ``dist`` gives."""
    return int(dist["value"] if dist["dist"] == "fixed" else dist["hi"])


def longest(mix: dict) -> int:
    """Tokens of the mix's longest session: its longest prompt and every
    phase's most output tokens."""
    return most(mix["prompt_tokens"]) + sum(
        most(ph["output_tokens"]) for ph in mix["phases"])


def gaps(rate: float, n: int) -> np.ndarray:
    """n exponential inter-arrival gaps of mean 1 / rate, stratified."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def n_sessions(rate: float, horizon_s: float) -> int:
    """The fewest sessions whose stratified gaps cover ``horizon_s``."""
    n = max(1, int(np.ceil(rate * horizon_s)))
    while gaps(rate, n).sum() < horizon_s:
        n += 1
    return n


def schedule(mix: dict, rate: float, horizon_s: float, seed: int,
             vocab: int) -> list[Session]:
    """Sessions due over ``horizon_s`` seconds at ``rate`` a second."""
    n = n_sessions(rate, horizon_s)
    order = seed_rng(seed, 0)
    gap = order.permutation(gaps(rate, n))
    due = np.cumsum(gap) - gap[0]          # the first session is due at 0
    prompt_len = order.permutation(quantiles(mix["prompt_tokens"], n))
    outputs = [order.permutation(quantiles(ph["output_tokens"], n))
               for ph in mix["phases"]]
    pauses = [order.permutation(quantiles(ph["pause_s"], n))
              for ph in mix["phases"][:-1]]
    tokens = seed_rng(seed, 1)
    out = []
    for i in range(n):
        T = int(prompt_len[i])
        out.append(Session(
            idx=i, due_s=float(due[i]),
            prompt=tokens.integers(2, vocab, size=T, dtype=np.int64)
            .astype(np.int32),
            outputs=[int(o[i]) for o in outputs],
            pauses=[float(p[i]) for p in pauses]))
    return out

