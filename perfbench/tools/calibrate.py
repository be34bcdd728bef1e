"""Read the two numbers a cell's comparison limit is set from, on many
seeds in one process: the program's widest served-token gap (sound runs)
and the control's (the reference in float8 in the program's place, read
at the same positions).  Each seed serves the cell's traffic at its own
rate for ``--seconds`` after the ramp, then compares as a run does.

    python3 perfbench/tools/calibrate.py --workload <name> \\
        --seeds 101,102,103 --seconds 20

One JSON line a seed.  The limit goes between the largest sound reading
and the smallest control reading (``perfbench/cells/<name>.json``).
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.harness import spec
    from perfbench.harness.serve import Serving, judge_run
    from perfbench.harness.weights import make_weights
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("calibration needs a card", file=sys.stderr)
        return 2
    _build.build_all()
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        weights = make_weights(cell.config, seed, "cuda")
        srv = Serving(cell, seed, args.seconds, device="cuda", torch=torch,
                      weights=weights)
        run = srv.run()
        srv.close()
        t_ref = time.perf_counter()
        ok, lowered = judge_run(run, weights, seed, control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "correct": ok,
            "served_logit_gap": run.checks["served_logit_gap"]["value"],
            "control_logit_gap": float(lowered.max()) if lowered.size
            else None,
            "tokens_compared": int(lowered.size),
            "requests_compared": len(run.sample),
            "sample_tokens": [len(tr.prompt) + len(tr.out)
                              for tr in run.sample],
            "reference_s": time.perf_counter() - t_ref,
            "wall_s": time.perf_counter() - t}), flush=True)
        del weights, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
