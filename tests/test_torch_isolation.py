"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor any module of the JAX package, and neither the port nor
``chip_smoke.py`` calls PyTorch's fused attention or its compiler in place
of a kernel of its own."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.serve.kvcache" in mods
    assert "repro_torch.kernels.paged_attention" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_library_attention_or_compiler_in_the_port():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        for word in ("torch.compile", "scaled_dot_product_attention",
                     "import jax", "from repro.", "import repro\n"):
            assert word not in text, f"{f.relative_to(ROOT)}: {word!r}"
