"""Run one cell of the serving benchmark once, from the checkout's root:

    python3 perfbench/run_cell.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; ``perfbench/cells/<name>.json`` holds its rate.  The program
(``src/repro_torch``) serves the traffic on the card: a ramp, then the
measured window of ``--seconds``.  Then a sample of its outputs is held
against the plain reference.  The last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit, which also close standard error.  Counters go
on the lines before.  The run fails, and prints no result, without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded at the end.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TOP_OPS = 10


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def result_line(run, ok: bool, trace: bool, kind: str) -> dict:
    from perfbench.harness import spec
    cell = run.cell
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": bool(ok), "attempted": len(run.due_in_window()),
            "failed": 0, "metrics": metrics, "device": device}
    if trace and run.slice is not None:
        device["busy_s"] = run.slice["busy_s"]
        device["window_s"] = run.slice["window_s"]
        ops = sorted(run.slice["by_op"].items(), key=lambda kv: -kv[1])
        gaps = sorted(run.slice["idle_by_span"].items(),
                      key=lambda kv: -kv[1])
        line["breakdown"] = {"device_ops": [list(x) for x in ops[:TOP_OPS]],
                             "idle_gaps": [list(x) for x in gaps[:TOP_OPS]]}
    line["checks"] = run.checks
    return line


def counters_line(run) -> dict:
    sizes = [n for t, n in run.steps if run.in_window(t)]
    return {"traffic_source": run.cell.traffic["source"],
            "counters": run.counters, "launches": run.launches,
            "mean_running_batch": sum(sizes) / len(sizes) if sizes else 0.0,
            "decode_steps": len(sizes),
            "requests_due": len(run.due_in_window()),
            "requests_finished": sum(tr.done for tr in run.tracks),
            "output_tokens": run.tokens_in_window(),
            "setup_s": run.setup_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.harness import spec
    from perfbench.harness.serve import serve_cell
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    run, ok = serve_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", torch=torch, t_start=T_START)
    line = result_line(run, ok, bool(args.trace),
                       torch.cuda.get_device_name(0))
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded JAX or the JAX package: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(counters_line(run)), flush=True)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']} (limit {c['holds']} {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
