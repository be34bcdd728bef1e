"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` file is compiled on first use into its own shared
library with a plain C interface, under ``kernels/build/`` (listed in
``.gitignore``).  The library's name carries a hash of its source and the
compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build_all()`` starts one ``nvcc`` per source at once
and waits for all of them.

The flags leave out ``--use_fast_math`` on purpose: the transit codec is
bit-exact only with IEEE division and ``rintf``.

Every wrapper counts its launches here (``count_launch``), so a caller can
show that a run went through the kernels: ``reset_launch_counts()`` before
the run, ``launch_counts()`` after it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention", "flash_attention_sm90", "paged_attention",
           "block_transit")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_launches: dict[str, int] = {}
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    # under a lock: the KV cache's eviction-pool workers launch the codec
    # from their own threads, beside the decode thread's launches
    with _count_lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        _launches.clear()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's usual place.  Raises if there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)            # atomic: a concurrent build loses nothing
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source that is not built yet, all at once; returns
    the compiler's output for each source that was built."""
    jobs = {}
    try:
        for name in names:
            job = _start(name)
            if job is not None:
                jobs[name] = job
    except BaseException:
        for proc, tmp, _ in jobs.values():
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
        raise
    logs, err = {}, None
    for name, job in jobs.items():   # wait for every nvcc, even after a failure
        try:
            logs[name] = _finish(name, job)
        except RuntimeError as e:
            err = err or e
    if err is not None:
        raise err
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
