"""The port's examples (``examples/*_torch.py``) against the reference's.

Each is the reference example's text with the package ``repro`` renamed
``repro_torch`` and nothing else, byte for byte, as
``tests/test_torch_storage.py`` holds the copied modules.

The seven storage examples run in subprocesses beside the reference's,
under a timeout, and print the same lines.  The lines of virtual-time
simulations must be equal as they are.  The lines of threaded runs are
compared with their numbers masked (``MASKED``): their counts and
latencies depend on when the worker threads ran, and two runs of the
reference differ there too.

``serve_paged_torch.py`` runs in this process with ``--device cpu`` and
the reference's parameters (the reference draws them from
``jax.random.PRNGKey(0)``, the port from a torch generator, so the port's
``init_lm`` is swapped for the reference's tree through
``models.transformer.params_from_jax``).  Its greedy tokens and its
page-out, page-in and bypass counts equal those of the reference's own
``launch.serve.main`` on the same arguments, run with the codec swapped
for the eager oracles of ``repro.kernels.ref`` (the reference's Pallas
codec does not trace on jax 0.9.0, ROADMAP Queue 3 item 7; the reference
example itself fails there).
"""
import contextlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
STORAGE = ("quickstart", "crash_recovery", "multi_tenant_volume", "async_qd",
           "autotune_phase_change", "limping_shard", "cluster_quickstart")
PORTED = STORAGE + ("serve_paged",)
# per example, the tags of the lines of threaded runs whose numbers
# depend on when the worker threads ran, masked: the device's and the
# volume's background eviction counts (two runs of the reference printed
# bg_evictions=1190 and 1196), and the hedged reads' wall-clock
# latencies on the threaded volume with the health verdicts read from
# them (a shard judged "healthy" in one run, "limping" in another)
MASKED = {"quickstart": ("[device]",),
          "multi_tenant_volume": ("[qos]",),
          "limping_shard": ("[hedge]", "[score]")}
TIMEOUT = 240


def _port_name(name: str) -> Path:
    return EXAMPLES / f"{name}_torch.py"


@pytest.mark.parametrize("name", PORTED)
def test_example_is_the_reference_text_renamed(name):
    port = _port_name(name).read_text()
    ref = (EXAMPLES / f"{name}.py").read_text()
    assert re.sub(r"\brepro\b", "repro_torch", ref) == port
    assert port.replace("repro_torch", "repro") == ref


def _masked(name: str, text: str) -> list[str]:
    tags = MASKED.get(name, ())
    if not tags:
        return text.splitlines()
    # a number's width also moves its padding
    return [" ".join(re.sub(r"\d+(\.\d+)?|healthy|limping|dead", "#",
                            line).split())
            if line.strip().startswith(tags) else line
            for line in text.splitlines()]


@pytest.mark.parametrize("name", STORAGE)
def test_storage_example_prints_the_reference_lines(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {side: subprocess.Popen(
        [sys.executable, str(path)], cwd=tmp_path, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for side, path in (("ref", EXAMPLES / f"{name}.py"),
                           ("port", _port_name(name)))}
    out = {}
    for side, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
        finally:
            p.kill()
        assert p.returncode == 0, (side, stderr[-3000:])
        out[side] = stdout
    assert out["port"].strip(), "the example printed nothing"
    assert _masked(name, out["port"]) == _masked(name, out["ref"])


def _oracle_gather(pool, ids):
    from repro.kernels import ref as jref
    q, s = jref.gather_quantize_ref(pool, ids)
    return q, s, jref.transit_crc_ref(q)


def _oracle_scatter(pool, ids, q, s):
    from repro.kernels import ref as jref
    return (jref.scatter_dequantize_ref(pool, ids, q, s),
            jref.transit_crc_ref(q))


def _run_main(main, argv, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue()


COUNTS = ("pages_out", "pages_in", "bypass_pages")


@pytest.mark.parametrize("args", [
    [],                                       # eager page-out on retire
    ["--pool-pages", "4"],                    # conditional bypass
    ["--spill-volume", "--host-pages", "1", "--suspend-every", "3"],
], ids=["default", "pool-pressure", "spill"])
def test_serve_paged_example_equals_the_reference_serve(args, monkeypatch):
    import jax
    import repro.launch.serve as ref_serve
    import repro_torch.launch.serve as port_serve
    from repro.serve import kvcache as jkv
    from repro_torch.models.transformer import params_from_jax

    monkeypatch.setattr(jkv, "gather_quantize_crc", _oracle_gather)
    monkeypatch.setattr(jkv, "scatter_dequantize_crc", _oracle_scatter)
    engines = {}

    def recorded(cls, side):
        class Recorded(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines[side] = self
        return Recorded
    monkeypatch.setattr(ref_serve, "ServeEngine",
                        recorded(ref_serve.ServeEngine, "ref"))
    monkeypatch.setattr(port_serve, "ServeEngine",
                        recorded(port_serve.ServeEngine, "port"))
    ref_out = _run_main(ref_serve.main, ["serve_paged.py"] + args,
                        monkeypatch)
    ref_params = jax.tree.map(np.asarray, engines["ref"].lm.params)
    monkeypatch.setattr(port_serve, "init_lm", lambda cfg, gen:
                        params_from_jax(ref_params, cfg, "cpu"))
    port_out = _run_main(
        lambda: runpy.run_path(str(_port_name("serve_paged")),
                               run_name="__main__"),
        ["serve_paged_torch.py", "--device", "cpu"] + args, monkeypatch)
    assert "[serve]" in ref_out and "on cpu" in port_out
    ref, port = engines["ref"], engines["port"]
    assert str(port.cache.device) == "cpu"

    def tokens(eng):
        return [r.out_tokens for r in sorted(eng.finished,
                                             key=lambda r: r.req_id)]
    assert len(tokens(port)) == 8
    assert tokens(port) == tokens(ref)
    got = {k: port.metrics.count.get(k, 0) for k in COUNTS}
    assert got == {k: ref.metrics.count.get(k, 0) for k in COUNTS}
    if args:                                   # each case exercises its path
        assert got["bypass_pages"] > 0 or got["pages_in"] > 0
