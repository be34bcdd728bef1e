"""The spread of each metric over runs of a cell, as a bound is set from
it: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median.

    python3 perfbench/tools/spread.py set1.jsonl set2.jsonl ...

Each file holds one run's last output line (the result) a line; the runs
of one file are one set.  Prints, per metric, each set's median and
spread, five times the widest, the spread of every run together, and the
mean of the sets' spreads with each set's run farthest from its median
left out.
"""
from __future__ import annotations

import json
import statistics
import sys


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trim(values: list) -> list:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def read_set(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def main(paths: list[str]) -> int:
    sets = [read_set(p) for p in paths]
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        cols = []
        for s in sets:
            v = [r["metrics"][name]["value"] for r in s
                 if name in r["metrics"]]
            cols.append((statistics.median(v), spread(v), len(v))
                        if len(v) >= 2 else None)
        widest = max(c[1] for c in cols if c)
        every = [r["metrics"][name]["value"] for s in sets for r in s
                 if name in r["metrics"]]
        trimmed = [spread(trim(v)) for v in (
            [r["metrics"][name]["value"] for r in s if name in r["metrics"]]
            for s in sets) if len(v) >= 4]
        print(json.dumps({"metric": name, "sets": cols,
                          "five_times_widest": 5 * widest,
                          "all_runs": spread(every),
                          "trimmed_mean": (sum(trimmed) / len(trimmed)
                                           if trimmed else None)}))
    print(json.dumps({"correct": [[r["correct"] for r in s] for s in sets]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
