"""Find a cell's knee: serve its traffic at several fixed rates, one after
the other in one process (the weights made once), and print for each the
end-to-end metrics and whether the backlog of due requests not yet
admitted grew across the window.

    python3 perfbench/tools/sweep.py --workload <name> --rates 1,2,3 \\
        --seconds 30 --seed 7

The knee is the highest rate whose backlog does not grow (its mean over
the window's last quarter within 0.5 requests of its first quarter's);
``PERF.md`` records it beside the rate the cell offers.  Each rate's line
also holds the untraced per-layer readings (the tails).  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def backlog_growth(run) -> dict:
    """The queue of due requests not yet admitted, over the window's first
    and last quarters, and its largest size."""
    q = [(t, n) for t, n in run.backlog if run.in_window(t)]
    if not q:
        return {"first_quarter": None, "last_quarter": None, "max": None}
    span = run.t_close - run.t_open
    first = [n for t, n in q if t < run.t_open + span / 4]
    last = [n for t, n in q if t >= run.t_close - span / 4]
    mean = (lambda v: sum(v) / len(v) if v else None)
    return {"first_quarter": mean(first), "last_quarter": mean(last),
            "max": max(n for _, n in q)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.harness import spec
    from perfbench.harness.serve import Serving
    from perfbench.harness.weights import make_weights
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("the sweep needs a card", file=sys.stderr)
        return 2
    _build.build_all()
    cell = spec.load_cell(args.workload)
    weights = make_weights(cell.config, args.seed, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        t = time.perf_counter()
        srv = Serving(cell, args.seed, args.seconds, device="cuda",
                      torch=torch, weights=weights, rate=rate)
        run = srv.run()
        srv.close()
        row = {"workload": args.workload, "rate_per_s": rate,
               "seconds": args.seconds, "backlog": backlog_growth(run),
               "requests_due": len(run.due_in_window()),
               "mean_running_batch": (
                   sum(n for tt, n in run.steps if run.in_window(tt))
                   / max(1, sum(run.in_window(tt) for tt, _ in run.steps))),
               "counters": run.counters,
               "wall_s": time.perf_counter() - t}
        for m in cell.end_to_end + cell.per_layer:
            value = spec.reader(m["name"])(run)
            if m["name"] != "setup_s" and value is not None:
                row[m["name"]] = value
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
