"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``repro_torch`` passes, ``repro`` does not), and
without a card the runner fails and prints no result."""
import json
import os
import subprocess
import sys
from pathlib import Path

from perfbench import run_cell

REPO = Path(__file__).resolve().parents[2]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))

RUN_PATH = """
import sys, tempfile, torch
from pathlib import Path
sys.path[:0] = [{src!r}, {repo!r}]
from perfbench import run_cell
from perfbench.harness import judge, reference, serve, spec, timing, \\
    traffic, weights, work
from perfbench.tests import tiny
root = tiny.make_root(Path(tempfile.mkdtemp()))
serve.RAMP_S, serve.SAMPLE_REQUESTS = tiny.RAMP_S, tiny.SAMPLE_REQUESTS
cell = spec.load_cell(tiny.CELL, root)
run, ok = serve.serve_cell(cell, 5, 0.6, True, device="cpu", torch=torch,
                           t_start=0.0)
run_cell.result_line(run, ok, True, "cpu")
for m in spec.load_benchmark()["end_to_end"] + \\
        spec.load_benchmark()["per_layer"]:
    spec.reader(m["name"])
print(run_cell.forbidden_modules())
"""


def test_the_run_path_loads_no_jax():
    code = RUN_PATH.format(src=str(REPO / "src"), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.serve", "reprox", "jaxtyping",
             "numpy"]
    assert run_cell.forbidden_modules(names) == []
    assert run_cell.forbidden_modules(names + ["repro.kernels", "jax",
                                               "jaxlib.xla", "flax"]) == \
        ["flax", "jax", "jaxlib.xla", "repro.kernels"]


def test_no_source_of_the_benchmark_imports_jax():
    for path in (REPO / "perfbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in run_cell.FORBIDDEN, (path, line)


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run_cell.py", "--workload",
         "phi3-mini.agent-swap", "--seed", str(2**31 + 3), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, env=ENV,
        timeout=300, cwd=REPO)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except ValueError:
            pass
