"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor any module of the JAX package, and neither the port nor
``chip_smoke.py`` calls PyTorch's fused attention or its compiler in place
of a kernel of its own.  ``chip_smoke.py`` names the fused attention in one
function only, the one that times it as flash attention's ``library_ms``."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SDPA = "scaled_dot_product_attention"
LIBRARY_TIMER = "library_attention_ms"


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.serve.kvcache" in mods
    assert "repro_torch.kernels.paged_attention" in mods
    assert "repro_torch.kernels.flash_attention" in mods
    assert "repro_torch.configs.phi3_mini" in mods
    assert "repro_torch.volume.volume" in mods
    assert "repro_torch.serve.kvpager" in mods
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
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    assert len(files) > 10
    assert PORT / "kernels" / "flash_attention.py" in files
    assert PORT / "configs" / "phi3_mini.py" in files
    for f in files + [ROOT / "chip_smoke.py"]:
        text = f.read_text()
        for word in ("torch.compile", "import jax", "from repro.",
                     "import repro\n"):
            assert word not in text, f"{f.relative_to(ROOT)}: {word!r}"
    for f in files:
        text = f.read_text()
        assert SDPA not in text, f"{f.relative_to(ROOT)}: {SDPA!r}"
        for lib in ("cublas", "cudnn"):      # no library kernels either
            assert lib not in text.lower(), f"{f.relative_to(ROOT)}: {lib}"


def _sdpa_outside_timer(source: str) -> list[int]:
    """Lines of ``source`` that name the fused attention outside the
    function that times it (``library_attention_ms``)."""
    inside = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.FunctionDef) and node.name == LIBRARY_TIMER:
            inside.update(range(node.lineno, node.end_lineno + 1))
    return [i for i, line in enumerate(source.splitlines(), 1)
            if SDPA in line and i not in inside]


@pytest.mark.parametrize("case", ["as committed", "named outside"])
def test_chip_smoke_names_library_attention_only_in_its_timer(case):
    source = (ROOT / "chip_smoke.py").read_text()
    assert f"def {LIBRARY_TIMER}(" in source and SDPA in source
    if case == "as committed":
        assert _sdpa_outside_timer(source) == []
    else:
        bad = source.replace("\ndef main() -> int:\n",
                             f"\nATTN = torch.nn.functional.{SDPA}\n\n"
                             f"\ndef main() -> int:\n")
        assert bad != source
        assert len(_sdpa_outside_timer(bad)) == 1
