"""One short run of a cell on the card, from the checkout's root, as the
benchmark's command runs it.  Marked ``cuda``; it skips where no card is
found (decided inside the test)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    out = subprocess.run(
        [sys.executable, "perfbench/run_cell.py", "--workload",
         "phi3-mini.agent-swap", "--seed", "2147483711", "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=REPO, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"output_tok_s", "setup_s"}
