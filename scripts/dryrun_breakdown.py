#!/usr/bin/env python3
"""One dry-run cell of the port, broken down: its collectives by kind,
dtype and result shape (count and payload bytes per device), and the
live storages at the peak of its temporaries, each with the op that made
it.  ``--json`` writes the cell's record (``launch.dryrun.trace_cell``'s,
without ``trace_s``) so that two trees' records compare byte for byte.

    PYTHONPATH=src python scripts/dryrun_breakdown.py \\
        --arch deepseek-coder-33b --shape train_4k [--multi-pod] \\
        [--overrides '{"n_layers": 2}'] [--top 12] [--json rec.json]

Counted on fake tensors over a fake process group of 256 (512) ranks,
as ``launch/dryrun.py`` counts: nothing is computed or allocated.
Imports the port only.
"""
import argparse
import collections
import json

import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._pytree import tree_leaves

from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import make_production_mesh


class _Breakdown(op_cost.OpCost):
    """``OpCost`` that also files each collective under (kind, dtype,
    result shape) and keeps, at each new peak, the live storages with
    the op that made each."""

    def __init__(self):
        super().__init__()
        self.by_shape = collections.defaultdict(lambda: [0, 0.0])
        self.made = {}
        self.at_peak = []
        self._func = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._func = func
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _count(self, func, args, kwargs, out) -> None:
        coll = op_cost._collective(func, args, out)
        if coll is not None:
            # the payload's first tensor, as ``_collective`` reads it: a
            # ``c10d`` op's first argument, a functional op's result
            t = next(x for x in tree_leaves(
                args[0] if func.namespace == "c10d" else out)
                if isinstance(x, torch.Tensor))
            ent = self.by_shape[(coll[0], str(t.dtype).split(".")[-1],
                                 tuple(t.shape))]
            ent[0] += 1
            ent[1] += coll[1]
        super()._count(func, args, kwargs, out)

    def _track(self, out) -> None:
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else None
        for st in self._storages(out):
            if st._cdata not in self._live and st._cdata not in self._args:
                self.made[st._cdata] = (str(self._func), shape)
        peak = self.peak
        super()._track(out)
        if self.peak > peak:
            self.at_peak = [(n, self.made.get(k))
                            for k, n in self._live.items()]


def breakdown(arch: str, shape: str, multi_pod: bool, overrides: dict):
    """-> (the cell's record, ``launch.dryrun.trace_cell``'s, and the
    ``_Breakdown`` that counted it in place of its ``OpCost``)."""
    made = []

    class Counter(_Breakdown):
        def __init__(self):
            super().__init__()
            made.append(self)

    n = 512 if multi_pod else 256
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    dryrun.OpCost = Counter
    try:
        rec = dryrun.trace_cell(arch, shape,
                                make_production_mesh(multi_pod=multi_pod),
                                {"cfg_overrides": overrides})
    finally:
        dryrun.OpCost = op_cost.OpCost
        dist.destroy_process_group()
    return rec, made[-1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    rec, bd = breakdown(a.arch, a.shape, a.multi_pod,
                        json.loads(a.overrides))
    if a.json:
        rec.pop("trace_s")
        with open(a.json, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
    mem = rec["memory"]
    print(f"{a.arch} {a.shape}: temporaries "
          f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, arguments "
          f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, "
          f"{rec['cost']['flops'] / 1e12:.3f} TFLOP")
    print("collectives (kind, dtype, result shape: count, GB):")
    for (kind, dt, shape), (cnt, by) in sorted(
            bd.by_shape.items(), key=lambda kv: -kv[1][1]):
        print(f"  {kind:15s} {dt:9s} {str(shape):26s} {cnt:6d} "
              f"{by / 1e9:10.3f}")
    print(f"at the peak, the {a.top} largest live storages (GB, made by):")
    for n, made in sorted(bd.at_peak, key=lambda x: -x[0])[:a.top]:
        print(f"  {n / 1e9:8.3f}  {made}")


if __name__ == "__main__":
    main()
