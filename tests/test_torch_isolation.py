"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor any module of the JAX package nor ``ml_dtypes``, no import
statement of the port or of ``chip_smoke.py`` names any of them (not even
one inside a function, which importing the module does not run), and
neither calls PyTorch's fused attention or its compiler in place of a
kernel of its own.  The ported examples (``examples/*_torch.py``) name
neither JAX nor the JAX package.
``chip_smoke.py`` names the fused attention in one function only, the one
that times it as flash attention's ``library_ms``.  The entry points run
on the card unless the caller asks for another device."""
import ast
import inspect
import json
import os
import pkgutil
import re
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
    assert "repro_torch.configs.internlm2_1p8b" in mods
    assert "repro_torch.configs.deepseek_coder_33b" in mods
    assert "repro_torch.volume.evict_pool" in mods
    assert "repro_torch.volume.volume" in mods
    assert "repro_torch.serve.kvpager" in mods
    for m in ("models.api", "configs.moonshot_16b", "configs.qwen3_moe_235b",
              "configs.whisper_large_v3", "configs.llama32_vision_11b",
              "models.xlstm", "models.rglru", "configs.xlstm_1p3b",
              "configs.recurrentgemma_9b", "optim.adamw", "train.step",
              "train.loop", "data.pipeline", "launch.train", "ckpt.engine",
              "ckpt.blockstore", "cluster.cluster", "parallel.sharding",
              "parallel.collectives", "launch.mesh"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
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


def _forbidden_imports(source: str) -> list[str]:
    """Every import statement of ``source``, at any depth, that names JAX,
    the JAX package (``repro``) or ``ml_dtypes``, as ``module`` strings."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "repro", "ml_dtypes")]
    return bad


@pytest.mark.parametrize("case", ["as committed", "import in a function"])
def test_no_import_of_jax_or_the_jax_package_at_any_depth(case):
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert PORT / "configs" / "deepseek_coder_33b.py" in files
    assert PORT / "serve" / "engine.py" in files
    if case == "as committed":
        for f in files:
            assert _forbidden_imports(f.read_text()) == [], \
                f"{f.relative_to(ROOT)}"
    else:
        # the import forms the text search above does not see, inside a
        # function, which importing the module does not run
        source = "def f():\n    from repro import serve\n" \
                 "    import repro.kernels.ref\n    from jax import numpy\n" \
                 "    import ml_dtypes\n"
        for word in ("import jax", "from repro.", "import repro\n"):
            assert word not in source
        assert _forbidden_imports(source) == ["repro", "repro.kernels.ref",
                                              "jax", "ml_dtypes"]


@pytest.mark.parametrize("path", sorted(
    (ROOT / "examples").glob("*_torch.py")), ids=lambda p: p.name)
def test_ported_examples_name_neither_jax_nor_the_jax_package(path):
    """An example of the port imports neither JAX nor ``repro`` (nor
    ``ml_dtypes``), and its text names neither as a word."""
    source = path.read_text()
    assert _forbidden_imports(source) == []
    assert re.findall(r"\b(?:jax|repro)\b", source) == []
    assert "repro_torch" in source


def test_entry_points_default_to_the_card():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import init_norm
    from repro_torch.models.transformer import make_cache, params_from_jax
    from repro_torch.serve import PagedKVCache, ServeEngine
    from repro_torch.ckpt import CheckpointEngine
    for fn in (PagedKVCache, ServeEngine, params_from_jax, init_norm,
               make_cache, CheckpointEngine.restore):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert build_parser().parse_args([]).device == "cuda"
    from repro_torch.launch.mesh import make_local_mesh
    assert inspect.signature(make_local_mesh).parameters[
        "device_type"].default == "cuda"
    for arch in ("xlstm-1.3b", "recurrentgemma-9b", "moonshot-v1-16b-a3b"):
        model = build_model(get_config(arch, smoke=True))
        assert inspect.signature(model.make_cache).parameters[
            "device"].default == "cuda"
    # init with no generator draws from seed 0 on the card: there, or a
    # refusal where there is none
    if torch.cuda.is_available():
        assert model.init()["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError):
            model.init()


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
