"""The traffic generator: the same seed gives the same schedule, every
seed the same set of sizes in another order, every size in its mix's
range, and the pool's room for a sequence covers the mix's longest."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness import traffic
from perfbench.tests import tiny

MIXES = Path(__file__).resolve().parents[1] / "traffic"
BIG_SEED = 2**31 + 12345
NAMES = sorted(p.stem for p in MIXES.glob("*.json")) + ["tiny-swap"]


def mix(name):
    if name == "tiny-swap":
        return tiny.MIX
    return json.loads((MIXES / f"{name}.json").read_text())


def flat(sched):
    return [(s.due_s, s.prompt.tolist(), s.outputs, s.pauses) for s in sched]


@pytest.mark.parametrize("name", NAMES)
def test_schedule_is_the_seeds(name):
    a = traffic.schedule(mix(name), 2.0, 60.0, BIG_SEED, 32064)
    b = traffic.schedule(mix(name), 2.0, 60.0, BIG_SEED, 32064)
    c = traffic.schedule(mix(name), 2.0, 60.0, BIG_SEED + 1, 32064)
    assert flat(a) == flat(b)
    assert flat(a) != flat(c)
    # the same sizes and gaps in another order
    keys = [lambda s: len(s.prompt)]
    keys += [lambda s, i=i: s.outputs[i] for i in range(len(a[0].outputs))]
    keys += [lambda s, i=i: s.pauses[i] for i in range(len(a[0].pauses))]
    for key in keys:
        assert sorted(map(key, a)) == sorted(map(key, c))
    assert len(a) == len(c)


@pytest.mark.parametrize("name", NAMES)
def test_schedule_keeps_its_ranges(name):
    m = mix(name)
    sched = traffic.schedule(m, 3.0, 40.0, 7, 92544)
    dues = [s.due_s for s in sched]
    assert dues[0] == 0.0 and dues == sorted(dues)
    assert dues[-1] + 1e-9 >= 40.0 - max(np.diff(dues))
    p = m["prompt_tokens"]
    for s in sched:
        assert p["lo"] <= len(s.prompt) <= p["hi"]
        assert s.prompt.min() >= 2 and s.prompt.max() < 92544
        assert len(s.outputs) == len(m["phases"])
        assert len(s.pauses) == len(m["phases"]) - 1
        for n, ph in zip(s.outputs, m["phases"]):
            o = ph["output_tokens"]
            lo, hi = (o["value"], o["value"]) if o["dist"] == "fixed" \
                else (o["lo"], o["hi"])
            assert lo <= n <= hi
        for x, ph in zip(s.pauses, m["phases"]):
            assert ph["pause_s"]["lo"] <= x <= ph["pause_s"]["hi"]
    lens = sorted(len(s.prompt) for s in sched)
    assert lens[0] < 1.2 * p["lo"] and lens[-1] > 0.9 * p["hi"]


@pytest.mark.parametrize("name", NAMES)
def test_longest_session_bounds_every_session(name):
    m = mix(name)
    assert m["source"]
    sched = traffic.schedule(m, 3.0, 40.0, 11, 32064)
    most = max(len(s.prompt) + sum(s.outputs) for s in sched)
    assert most <= traffic.longest(m) < 1.1 * most + 2


def test_arrivals_cover_the_horizon_at_the_rate():
    gaps = traffic.gaps(2.0, 400)
    assert abs(gaps.mean() - 0.5) < 0.02       # mean 1 / rate
    n = traffic.n_sessions(2.0, 75.0)
    assert traffic.gaps(2.0, n).sum() >= 75.0 > traffic.gaps(2.0, n - 1).sum()
