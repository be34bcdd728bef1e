#!/usr/bin/env python3
"""A/B of chip_smoke's qwen2.5-3b serve phase (phase 3) between checkouts
of the repository, on one GPU.

    python3 scripts/serve_ab.py TREE [TREE ...]

Runs each TREE's own ``chip_smoke.py`` phase 3 in a process of its own,
in the order given (parent, change, change, parent pairs the host's
drift): it builds that tree's kernels, draws qwen2.5-3b FULL from seed 0
and serves 4 requests of 128 + 16 tokens, then the profiled decode
window.  One JSON line a run: decode tokens/s, the profiled step's host
ms, device busy ms, idle share and device ops a step; then the card's
name and power limit.  Compare versions only within one call.
"""
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys, time
sys.path.insert(0, "src")
import numpy as np, torch
import chip_smoke as c
from repro_torch.kernels import _build
_build.build_all()
for name in _build.SOURCES:
    _build.load(name)
cfg, params = c.init_full(torch, c.QWEN)
r = c.serve_full(torch, np, cfg, params, profile=True)
p = r["profile"]
print("AB " + json.dumps({"decode_tok_s": r["decode_tok_s"],
      "host_step_ms": p["step_ms"],
      "device_busy_ms": p["device_busy_ms_per_step"],
      "idle_share": p["device_idle_share"],
      "device_ops": p["device_ops_per_step"]}))
"""


def main(trees) -> int:
    for tree in trees:
        root = Path(tree).resolve()
        out = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                             capture_output=True, text=True, timeout=900)
        line = [x for x in out.stdout.splitlines() if x.startswith("AB ")]
        if out.returncode or not line:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"tree": str(root), **json.loads(line[0][3:])}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
