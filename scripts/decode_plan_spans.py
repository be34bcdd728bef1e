"""Serve a benchmark cell with the program's spans on and say how often the
decode-step plan engaged.

    python3 scripts/decode_plan_spans.py --workload <name> --seeds 11,12 \
        --seconds 51

A traced run a seed, as ``perfbench/tools/spans.py`` makes it (the
harness's wrappers and its profiled slice, the spans on), with
``PagedKVCache.plan_step`` wrapped to stamp each call.  One JSON line a
seed: the window's decode steps that took the plan and those that fell
back to the per-token path, the run's ``decode_plan_steps`` and
``decode_token_path_steps`` counters (warm-up and ramp too), the window's
``spans.split`` (the decode step's host ms by part), the slice's busy
and window seconds and idle seconds by span, the costliest device ops,
the traced run's ``output_tok_s`` and whether it was correct.  Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("decode_plan_steps", "decode_token_path_steps")


def stamp_plans(eng, calls: list) -> None:
    """Spans on, and each ``plan_step`` call stamped (host clock, whether
    it planned) into ``calls``."""
    eng.trace.start()
    plan_step = eng.cache.plan_step

    def stamped(sids):
        plan = plan_step(sids)
        calls.append((time.perf_counter(), plan is not None))
        return plan
    eng.cache.plan_step = stamped


def traced(cell, seed: int, seconds: float, *, device, torch) -> dict:
    from perfbench.harness import spec
    from perfbench.harness.serve import Serving, judge_run
    from perfbench.harness.spans import split
    from perfbench.harness.weights import make_weights
    from perfbench.tools.spans import span_slice, top
    weights = make_weights(cell.config, seed, device)
    calls: list = []
    with span_slice():
        srv = Serving(cell, seed, seconds, device=device, torch=torch,
                      weights=weights, trace=True,
                      patch=lambda eng: stamp_plans(eng, calls))
        run = srv.run()
    spans = srv.eng.trace.spans()
    count = srv.eng.metrics.count
    counters = {k: count.get(k, 0) for k in COUNTERS}
    srv.close()
    ok = judge_run(run, weights, seed)
    sl = run.slice or {}
    window = [planned for t, planned in calls if run.in_window(t)]
    return {"workload": cell.name, "seed": seed, "correct": ok,
            "window_plan_steps": sum(window),
            "window_token_path_steps": len(window) - sum(window),
            "run_counters": counters,
            "output_tok_s": spec.reader("output_tok_s", cell.root)(run),
            "busy_s": sl.get("busy_s"), "window_s": sl.get("window_s"),
            "idle_by_span": top(sl.get("idle_by_span", {})),
            "device_ops": top(sl.get("by_op", {})),
            "split": split(spans, run.in_window)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.harness import spec
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("the traced runs need a card", file=sys.stderr)
        return 2
    _build.build_all()
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(traced(cell, seed, args.seconds, device="cuda",
                                torch=torch)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
