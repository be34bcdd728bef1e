"""Serve a cell with the program's own spans on (``eng.trace.start()``)
and print what they show, or what they cost.

    python3 perfbench/tools/spans.py --workload <name> --seeds 11,12 \\
        --seconds 51 [--cost]

Without ``--cost``: a traced run a seed (the harness's wrappers and its
profiled slice, as ``run_cell.py --trace 1`` runs them) with the spans on,
the slice reduced by ``harness.spans.SpanSlice``.  One JSON line a seed:
the slice's busy and window seconds, its idle seconds by span (the
program's spans and the wrappers' labels) and the share of them under a
program span, the costliest device ops, the window's ``spans.split``
(the decode step's host ms by part, the transit's us a page, the retire
share, spans a decode step), the spans dropped, the traced run's
``output_tok_s`` and whether it was correct.

With ``--cost``: untraced runs on each seed, spans off and on (in turn
off-on and on-off from seed to seed), one JSON line a run: output tokens
a second and the median time between the window's decode steps.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TOP = 12                      # idle labels and device ops printed


def start(eng) -> None:
    eng.trace.start()


@contextmanager
def span_slice():
    """The harness's traced run with ``SpanSlice`` for its slice.
    ``Serving`` takes no slice class, so its module's ``Slice`` is swapped
    for the block and put back after it.  Once ``timing.Slice`` takes
    ``SpanSlice``'s rules, this swap goes with ``SpanSlice``."""
    from perfbench.harness import serve
    from perfbench.harness.spans import SpanSlice
    plain, serve.Slice = serve.Slice, SpanSlice
    try:
        yield
    finally:
        serve.Slice = plain


def top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def traced(cell, seed: int, seconds: float, *, device, torch) -> dict:
    from perfbench.harness import spec
    from perfbench.harness.serve import Serving, judge_run
    from perfbench.harness.spans import split
    from perfbench.harness.weights import make_weights
    weights = make_weights(cell.config, seed, device)
    with span_slice():
        srv = Serving(cell, seed, seconds, device=device, torch=torch,
                      weights=weights, trace=True, patch=start)
        run = srv.run()
    spans = srv.eng.trace.spans()
    dropped = srv.eng.metrics.count.get("spans_dropped", 0)
    srv.close()
    ok = judge_run(run, weights, seed)
    sl = run.slice or {}
    idle = sl.get("idle_by_span", {})
    names = {s.name for s in spans}
    idle_s = sum(idle.values())
    return {"workload": cell.name, "seed": seed, "correct": ok,
            "output_tok_s": spec.reader("output_tok_s", cell.root)(run),
            "busy_s": sl.get("busy_s"), "window_s": sl.get("window_s"),
            "idle_s": idle_s,
            "idle_under_program_spans": sum(
                v for k, v in idle.items() if k in names) / idle_s
            if idle_s else None,
            "idle_by_span": top(idle), "device_ops": top(sl.get("by_op", {})),
            "annotations": sl.get("annotations"),
            "split": split(spans, run.in_window), "spans_dropped": dropped}


def step_gap_ms(run) -> float | None:
    t = [t for t, _ in run.steps if run.in_window(t)]
    gaps = [b - a for a, b in zip(t, t[1:])]
    return 1e3 * statistics.median(gaps) if gaps else None


def cost(cell, seed: int, seconds: float, first_on: bool, *, device,
         torch) -> list[dict]:
    from perfbench.harness import spec
    from perfbench.harness.serve import Serving
    from perfbench.harness.weights import make_weights
    weights = make_weights(cell.config, seed, device)
    out = []
    for on in (first_on, not first_on):
        srv = Serving(cell, seed, seconds, device=device, torch=torch,
                      weights=weights, patch=start if on else None)
        run = srv.run()
        srv.close()
        out.append({"workload": cell.name, "seed": seed, "spans": on,
                    "output_tok_s":
                        spec.reader("output_tok_s", cell.root)(run),
                    "step_gap_ms_median": step_gap_ms(run),
                    "decode_steps": sum(run.in_window(t)
                                        for t, _ in run.steps)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.harness import spec
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("the spans' runs need a card", file=sys.stderr)
        return 2
    _build.build_all()
    cell = spec.load_cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        lines = (cost(cell, seed, args.seconds, i % 2 == 1, device="cuda",
                      torch=torch) if args.cost else
                 [traced(cell, seed, args.seconds, device="cuda",
                         torch=torch)])
        for line in lines:
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
