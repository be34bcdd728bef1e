#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``:

1. build  — compile every CUDA source of ``src/repro_torch/kernels/csrc``
            (one nvcc per source, all at once), print the seconds and
            each kernel's registers and spills from ptxas; the tensor-core
            flash kernel must not spill, and ``cuobjdump -sass`` of its
            library must show HGMMA (wgmma) instructions;
2. kernels — each kernel against its plain PyTorch version on the card, at
            the serving path's full-width shapes (qwen2.5-3b: page 16, Hkv
            2, hd 128; phi3-mini-3.8b: Hkv 32, hd 96) and at smoke shapes,
            f32 and bf16: the codec's one launch over a stack of units
            (``CODEC_CASES``: one pool, a qwen2.5-3b page of 72 units, a
            phi3-mini-3.8b page of 64, a 251-page qwen sequence of 18072)
            with q, scales and crcs bit-identical, every crc equal to
            ``zlib.adler32``, a flipped byte moving one crc and the units
            not named untouched; paged attention within
            2e-5 (f32) / 2e-2 (bf16) with poison written past each length;
            flash attention within the same tolerances over the reference's
            sweep, windows, non-causal, ragged lengths, hd 16 and 96 and
            the prefill shapes, every bf16 case on the tensor-core kernel
            and every f32 one on the SIMT kernel, and its gradient equal
            to the plain one;
            then each path kernel timed beside its plain version, its bound
            and, where one PyTorch call computes the same function, that
            call (``library_ms``), the codec at ``CODEC_TIMED``'s unit
            counts;
3. serve  — qwen2.5-3b FULL (36 layers, d_model 2048, vocab 151936) in bf16
            with random weights from a seeded generator: 4 requests of 128
            prompt tokens and 16 new tokens, one of them suspended and
            resumed mid-decode, so prefill attention, decode attention,
            page-out and page-in all run; every ``deactivate`` and
            ``activate`` is timed (the ``transit:`` line), and a fresh
            sequence of the phase's length is paged out and in again
            under the profiler; then a profiled decode window;
4. long   — the same model and weights, one engine with 512 pages of 16:
            prompts of 1000 and 4000 tokens prefilled, decoded 4 tokens
            and retired (63 and 251 pages out, one launch each), the
            transit timed and profiled as in phase 3;
5. spill  — the same model and weights through the volume-backed spill
            tier: 8 requests of 128 prompt and 32 new tokens at batch 4,
            the first running request suspended every 6 ticks, a KVPager on
            a striped volume (``SPILL_VOLUME``) behind a 4-page host tier,
            prefetch depth 2; then the same traffic and suspends with no
            pager.  The greedy tokens must be equal; pages must spill, be
            prefetched and restored, with no wire or transit crc error and
            no slot, pool page or host entry left; it prints the seconds
            per spill, per fetch and per activate of a volume-resident
            session, the records, blocks and bytes written, the dedup and
            prefetch hit rates and each run's end-to-end time;
6. phi3   — phi3-mini-3.8b FULL (32 layers, d_model 3072, MHA 32 heads of
            96, vocab 32064) in bf16, served as in phase 3 without the
            decode profile;
7. parity — qwen2.5-3b and phi3-mini-3.8b SMOKE in f32 (TF32 off) served on
            the card and on the CPU from the same weights, with a roomy
            pool (page-out and page-in), with a 2-page pool (conditional
            bypass and hybrid attention, which runs the paged-attention
            kernel), and with a 6-page pool behind a pager with no host
            budget (``PARITY_CASES``: a resume stalls right after promoting
            a spilled page, and the hybrid path reads spilled pages): the
            greedy tokens and the cache's counters are equal.

Launch counts are zeroed just before each of phases 3-7 drives the path
and read just after; every bf16 prefill layer must run the tensor-core
flash kernel, every f32 one the SIMT kernel; the spill kernel launches
once for each ``deactivate`` that pages out, and the restore kernel at
most once for each volume record an ``activate`` fetched plus once for
each ``activate`` that pages in (exactly once where no record was
fetched and nothing bypassed); the cache counts the reference's 2 fused
passes per layer per page.  Then it prints the
phases' results, a ``{"kernels": [...]}`` line, the card's name and power
limit from nvidia-smi, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failed check
exits non-zero before those lines; so does a machine without CUDA, or a
directory without the repository's ``src/repro_torch``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
TOL = {"f32": 2e-5, "bf16": 2e-2}
# Each output row (the hd values of one query head at one position) is
# also held as a whole: ||got - exp|| <= ROW_TOL * ||exp||.  Attention over
# thousands of keys gives elements of a few hundredths, the size of the
# bf16 element tolerance, so that tolerance alone could miss a kernel that
# drops or repeats a tile of keys on long rows; a sound bf16 kernel reads
# about 0.004 here (output rounding plus P rounded to bf16), a dropped
# tile 0.07 or more.
ROW_TOL = {"f32": 1e-4, "bf16": 1e-2}
QWEN, PHI3 = "qwen2.5-3b", "phi3-mini-3.8b"

# name -> (kernel source, TPU kernel it replaces).  Flash attention has two
# kernels: "flash_attention_tc" (bf16 with hd % 8 == 0, every full-width
# prefill) and "flash_attention", the SIMT kernel (f32, other hd).  The
# wrapper counts every call as "flash_attention" and the tensor-core ones
# also as "flash_attention_tc"; the SIMT kernel's launches are the
# difference.
KERNELS = {
    "flash_attention_tc": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:91"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:73"),
    "gather_quantize_crc": ("src/repro_torch/kernels/csrc/block_transit.cu",
                            "src/repro/kernels/block_transit.py:118"),
    "scatter_dequantize_crc": ("src/repro_torch/kernels/csrc/block_transit.cu",
                               "src/repro/kernels/block_transit.py:193"),
}


class SmokeFailure(RuntimeError):
    pass


def kernel_launches(counts: dict) -> dict:
    """Launches of each kernel from the wrappers' counts: the SIMT flash
    kernel's are the flash calls that did not take the tensor cores."""
    out = dict(counts)
    out["flash_attention"] = (counts.get("flash_attention", 0)
                              - counts.get("flash_attention_tc", 0))
    return out


def row_rel_err(got, exp) -> float:
    """The largest ||got - exp|| / ||exp|| over the output's rows (its last
    dimension); a row whose reference is zero must come out zero."""
    d = (got.float() - exp.float()).norm(dim=-1)
    n = exp.float().norm(dim=-1)
    return float((d / n.clamp(min=1e-30)).max()) if d.numel() else 0.0


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean time per call in ms, by CUDA events around ``iters``
    back-to-back calls after a warm-up: what a caller pays, host-side
    launch work included when it exceeds the device time."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The device ops (kernels, copies) of a finished profile."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters: int, match: str | None = None) -> float | None:
    """Device time per call in ms from the profiler (CUPTI): the device ops
    whose name holds ``match``, or all of them when it is None.  None when
    the profiler saw no device time, or missed ops: a profile of ``iters``
    calls must hold ``iters`` times the ops a profile of one call holds
    (it has been seen to drop some of a library call's kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def ops(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e for e in device_events(prof)
                if match is None or match in e.name]

    fn()
    per_call, events = len(ops(1)), ops(iters)
    us = sum(e.time_range.end - e.time_range.start for e in events)
    if us <= 0 or len(events) != per_call * iters:
        return None
    return us / iters / 1e3


def kernel_times(fn, plain, iters: int, match: str) -> dict:
    """``ms``/``plain_ms``: device time per call from the profiler, each
    column on its own falling back to the CUDA-event time per call where
    its profile is empty or incomplete (``ms_from``/``plain_ms_from`` say
    which); ``call_ms``/``plain_call_ms``: the event time per call.  The
    kernel's profile counts only its own kernel's events (``match``)."""
    call, plain_call = time_ms(fn, iters), time_ms(plain, iters // 4)
    dev, plain_dev = device_ms(fn, iters, match), device_ms(plain, iters // 4)
    return dict(ms=call if dev is None else dev,
                ms_from="events" if dev is None else "profiler",
                plain_ms=plain_call if plain_dev is None else plain_dev,
                plain_ms_from="events" if plain_dev is None else "profiler",
                call_ms=call, plain_call_ms=plain_call)


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phase 1
def check_build(_build) -> None:
    """Each kernel's registers and spills from ptxas (the build's log kept
    beside each library), no spills in the tensor-core flash kernel, and
    ``HGMMA`` (wgmma) instructions in its compiled SASS."""
    import re
    for name in _build.SOURCES:
        fn = "?"
        for line in _build.lib_path(name).with_suffix(".log").read_text() \
                .splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
            if m:
                fn = m.group(1)
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name} {fn[:60]}: {line.strip()}")
                spills = re.search(r"(\d+) bytes spill stores", line)
                check(name != "flash_attention_sm90" or spills is None
                      or spills.group(1) == "0",
                      f"ptxas: {fn} spills registers")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.lib_path("flash_attention_sm90"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    n = sass.count("HGMMA")
    check(n > 0, "flash_attention_sm90: no HGMMA instruction in its SASS")
    log(f"cuobjdump -sass flash_attention_sm90: {n} HGMMA, "
        f"{sass.count('UTMALDG')} UTMALDG (TMA load) instructions")


# ------------------------------------------------------------- phase 2
def paged_case(torch, rng, B, H, Hkv, hd, page, P, maxp, lens, dtype):
    """Random pools with poison past every length, a unique-page table."""
    dev = "cuda"
    q = torch.tensor(rng.standard_normal((B, H, hd)), dtype=dtype, device=dev)
    k = rng.standard_normal((P, page, Hkv, hd)).astype("float32")
    v = rng.standard_normal((P, page, Hkv, hd)).astype("float32")
    table = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype("int32")
    for b, n in enumerate(lens):
        for pi in range(maxp):
            for off in range(page):
                if pi * page + off >= n:
                    k[table[b, pi], off] = 99.0
                    v[table[b, pi], off] = -99.0
    return (q, torch.tensor(k, dtype=dtype, device=dev),
            torch.tensor(v, dtype=dtype, device=dev),
            torch.tensor(table, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def check_paged_attention(torch, rng, results) -> None:
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    cases = [  # (label, B, H, Hkv, hd, page, P, maxp, lens)
        ("full", 4, 16, 2, 128, 16, 64, 16, [144, 137, 129, 1]),
        ("full-empty", 2, 16, 2, 128, 16, 64, 16, [0, 256]),
        ("smoke", 3, 4, 2, 16, 16, 16, 4, [1, 17, 64]),
        ("mqa-nrep8", 2, 8, 1, 128, 16, 12, 3, [48, 20]),
        ("mha-nrep1", 2, 2, 2, 64, 8, 8, 2, [9, 16]),
        ("phi3-full", 4, 32, 32, 96, 16, 64, 16, [144, 137, 129, 1]),
        ("qwen-long", 2, 16, 2, 128, 16, 512, 256, [1004, 4004]),
    ]
    worst = worst_row = 0.0
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, B, H, Hkv, hd, page, P, maxp, lens in cases:
            args = paged_case(torch, rng, B, H, Hkv, hd, page, P, maxp, lens,
                              dtype)
            exp = paged_attention_plain(*args)
            # the wrapper's split plan, then one split and a page a split
            for pps in (None, maxp, 1):
                got = paged_attention_cuda(*args, pages_per_split=pps)
                torch.cuda.synchronize()
                tag = f"paged_attention {label}/{dt} pages_per_split {pps}"
                check(got.dtype == dtype and got.shape == (B, H, hd),
                      f"{tag}: {got.dtype} {got.shape}")
                err = (got.float() - exp.float()).abs()
                ok = bool((err <= TOL[dt] + TOL[dt] * exp.float().abs()).all())
                row = row_rel_err(got, exp)
                check(ok and torch.isfinite(got).all(),
                      f"{tag}: max err {err.max():.3g}")
                check(row <= ROW_TOL[dt],
                      f"{tag}: row error {row:.3g} > {ROW_TOL[dt]}")
                if lens[0] == 0:
                    check(bool((got[0] == 0).all()), "len 0 must give zeros")
                worst = max(worst, float(err.max()))
                worst_row = max(worst_row, row)
            log(f"paged_attention {label}/{dt} ok at 3 split plans, max abs "
                f"err {float(err.max()):.3g}, max row rel err {row:.3g}")
    results["paged_attention"] = {"max_abs_err": worst,
                                  "max_row_rel_err": worst_row}


# (label, S, P, page, F, n): a stack of S slots of P pages, n units read.
# With S = 1 a single pool, as the one-pool API gives it; otherwise the
# cache's layout, n // S pages of every slot, as one page-out or page-in
# of a sequence launches it (qwen2.5-3b: 36 layers x K/V = 72 slots, F 256;
# phi3-mini-3.8b: 64 slots, F 3072).
CODEC_CASES = [
    ("full-n1", 1, 64, 16, 256, 1),
    ("full-n5", 1, 64, 16, 256, 5),
    ("smoke", 1, 16, 16, 32, 3),
    ("wide", 1, 16, 8, 384, 4),
    ("phi3-full", 1, 64, 16, 3072, 2),
    ("qwen-page", 72, 4, 16, 256, 72),
    ("phi3-page", 64, 4, 16, 3072, 64),
    ("qwen-251pages", 72, 512, 16, 256, 72 * 251),
]


def codec_case(torch, rng, S, P, page, F, n, dtype):
    """A random stack (magnitudes over five decades, an all-zero row in
    every page) and two disjoint unit lists of n: units to read and units
    to write, in the cache's order (page, then slot) over pages in random
    order when S > 1."""
    import numpy as np
    x = rng.standard_normal((S, P, page, F), dtype=np.float32) \
        * rng.uniform(1e-3, 1e2, (S, P, page, 1)).astype(np.float32)
    x[:, :, 0] = 0.0
    stack = torch.from_numpy(x).to("cuda").to(dtype)
    if S == 1:
        perm = rng.permutation(P)[:2 * n]
        pairs = np.stack([np.zeros_like(perm), perm], 1)
    else:
        pages = rng.permutation(P)[:2 * (n // S)]
        pairs = np.stack([np.tile(np.arange(S), len(pages)),
                          np.repeat(pages, S)], 1)
    pairs = pairs.astype(np.int32)
    return stack, (torch.tensor(pairs[:n], device="cuda"),
                   torch.tensor(pairs[n:], device="cuda"))


def check_codec(torch, rng, results) -> None:
    """The codec's one launch over n units against its plain version, bit
    for bit, at every ``CODEC_CASES`` shape in f32 and bf16."""
    from repro_torch.kernels import block_transit as bt
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, S, P, page, F, n in CODEC_CASES:
            stack, (src, dst) = codec_case(torch, rng, S, P, page, F, n,
                                           dtype)
            tag = f"{label}/{dt} ({n} units)"
            # spill: fused and plain, bit for bit, and zlib on the host
            q, s, c = bt.gather_quantize_cuda(stack, src)
            qp, sp, cp = bt.gather_quantize_crc_plain(stack, src)
            q2, s2 = bt.gather_quantize_cuda(stack, src, with_crc=False)
            torch.cuda.synchronize()
            check(torch.equal(q, qp) and torch.equal(s, sp)
                  and torch.equal(c, cp), f"gather_quantize_crc {tag}")
            check(torch.equal(q2, qp) and torch.equal(s2, sp),
                  f"gather_quantize {tag}")
            qh = q.cpu().numpy()
            check([zlib.adler32(qh[i].tobytes()) for i in range(n)]
                  == c.cpu().tolist(), f"crc != zlib.adler32 {tag}")
            del qh, qp, sp, cp, q2, s2
            # restore into other units: everything else untouched
            pk, pp, p2 = stack.clone(), stack.clone(), stack.clone()
            _, rc = bt.scatter_dequantize_cuda(pk, dst, q, s)
            _, rcp = bt.scatter_dequantize_crc_plain(pp, dst, q, s)
            bt.scatter_dequantize_cuda(p2, dst, q, s, with_crc=False)
            torch.cuda.synchronize()
            check(torch.equal(pk, pp) and torch.equal(p2, pp)
                  and torch.equal(rc, rcp) and torch.equal(rc, c),
                  f"scatter_dequantize(_crc) {tag}")
            keep = torch.ones((S, P), dtype=torch.bool, device="cuda")
            keep[dst[:, 0].long(), dst[:, 1].long()] = False
            check(torch.equal(pk[keep], stack[keep]),
                  f"scatter touched other units {tag}")
            del pp, p2
            # a flipped payload byte moves only that unit's crc
            k = n // 2
            qc = q.clone()
            qc[k, page // 2, F // 3] ^= 1
            _, rc2 = bt.scatter_dequantize_cuda(pk, dst, qc, s)
            torch.cuda.synchronize()
            check((rc2 != c).nonzero().flatten().tolist() == [k],
                  f"corruption not isolated to its unit {tag}")
            log(f"codec {tag} ok: q/scales/crc bit-identical, zlib agrees, "
                f"other units untouched, a flipped byte in unit {k} moves "
                f"its crc only")
            del stack, src, dst, q, s, c, pk, qc
    results["gather_quantize_crc"] = {"max_abs_err": 0.0}
    results["scatter_dequantize_crc"] = {"max_abs_err": 0.0}


FLASH_CASES = [  # (label, B, T, S, H, Hkv, hd, causal, window, dtypes)
    ("sweep-mha", 1, 128, 128, 2, 2, 64, True, 0, ("f32", "bf16")),
    ("sweep-gqa", 2, 256, 256, 4, 2, 64, True, 0, ("f32", "bf16")),
    ("sweep-mqa-rect", 1, 128, 384, 8, 1, 128, True, 0, ("f32", "bf16")),
    ("sweep-q>kv", 2, 384, 128, 4, 4, 64, True, 0, ("f32", "bf16")),
    ("window32", 1, 256, 256, 2, 2, 64, True, 32, ("f32", "bf16")),
    ("window128", 1, 256, 256, 2, 2, 64, True, 128, ("f32", "bf16")),
    ("window500", 1, 256, 256, 2, 2, 64, True, 500, ("f32", "bf16")),
    ("non-causal", 2, 128, 256, 2, 2, 64, False, 0, ("f32", "bf16")),
    ("ragged100", 1, 100, 100, 4, 2, 64, True, 0, ("f32", "bf16")),
    ("ragged300x257", 1, 300, 257, 4, 2, 128, True, 0, ("f32", "bf16")),
    ("hd16", 1, 12, 12, 4, 2, 16, True, 0, ("f32", "bf16")),
    ("hd96", 1, 100, 100, 4, 4, 96, True, 0, ("f32", "bf16")),
    ("qwen-T128", 1, 128, 128, 16, 2, 128, True, 0, ("bf16",)),
    ("qwen-T1000", 1, 1000, 1000, 16, 2, 128, True, 0, ("bf16",)),
    ("qwen-T4000", 1, 4000, 4000, 16, 2, 128, True, 0, ("bf16",)),
    ("phi3-T128", 1, 128, 128, 32, 32, 96, True, 0, ("bf16",)),
]


def flash_case(torch, rng, B, T, S, H, Hkv, hd, dtype):
    return tuple(torch.tensor(rng.standard_normal(shape), dtype=dtype,
                              device="cuda")
                 for shape in ((B, T, H, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


def check_flash_attention(torch, rng, results) -> None:
    """Every case through the wrapper's own route: bf16 on the tensor-core
    kernel (all these hd are multiples of 8), f32 on the SIMT kernel."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = {"flash_attention": 0.0, "flash_attention_tc": 0.0}
    worst_row = dict(worst)
    for label, B, T, S, H, Hkv, hd, causal, window, dts in FLASH_CASES:
        for dt in dts:
            q, k, v = flash_case(torch, rng, B, T, S, H, Hkv, hd, dtypes[dt])
            before = _build.launch_counts().get("flash_attention_tc", 0)
            got = flash_attention_cuda(q, k, v, causal=causal, window=window)
            tc = _build.launch_counts().get("flash_attention_tc", 0) - before
            check(tc == (dt == "bf16"),
                  f"flash_attention {label}/{dt}: {tc} tensor-core launches")
            exp = flash_attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(got.dtype == q.dtype and got.shape == q.shape,
                  f"flash_attention {label}/{dt}: {got.dtype} {got.shape}")
            err = (got.float() - exp.float()).abs()
            ok = bool((err <= TOL[dt] + TOL[dt] * exp.float().abs()).all())
            row = row_rel_err(got, exp)
            check(ok and bool(torch.isfinite(got).all()),
                  f"flash_attention {label}/{dt}: max err {err.max():.3g}")
            check(row <= ROW_TOL[dt], f"flash_attention {label}/{dt}: row "
                  f"error {row:.3g} > {ROW_TOL[dt]}")
            name = "flash_attention_tc" if tc else "flash_attention"
            worst[name] = max(worst[name], float(err.max()))
            worst_row[name] = max(worst_row[name], row)
            log(f"flash_attention {label}/{dt} ok on {name}, max abs err "
                f"{float(err.max()):.3g}, max row rel err {row:.3g}")
            del q, k, v, got, exp, err
    # the gradient: forward on the kernel, backward by recompute through
    # the plain version, against autograd through the plain version alone
    q, k, v = flash_case(torch, rng, 1, 128, 128, 16, 2, 128, torch.float32)
    dout = torch.randn_like(q)
    grads = []
    for fn in (ops.flash_attention, flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, causal=True, window=0).backward(dout)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for name, got, exp in zip("qkv", *grads):
        err = (got - exp).abs()
        check(bool(torch.isfinite(got).all())
              and bool((err <= 2e-5 + 2e-5 * exp.abs()).all()),
              f"flash_attention d{name}: max err {float(err.max()):.3g}")
    log("flash_attention gradient (q, k, v) on the card equals the plain "
        "version's, finite")
    for name, err in worst.items():
        results[name] = {"max_abs_err": err,
                         "max_row_rel_err": worst_row[name]}


def library_attention_ms(torch, q, k, v, iters: int) -> tuple[float, str]:
    """``library_ms`` of flash attention: one call of PyTorch's fused
    attention on the same inputs (heads moved to dim 1 as it wants them,
    causal, GQA), device time per call, or the CUDA-event time where the
    profiler could not give it; and which of the two.  Timed here only:
    the port never calls it."""
    import torch.nn.functional as F

    def fn():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
    dev = device_ms(fn, iters)
    return (dev, "profiler") if dev is not None else (time_ms(fn, iters),
                                                      "events")


def flash_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the mask keeps: the work this input needs."""
    import numpy as np
    qp = np.arange(T)
    hi = np.minimum(qp + 1, S) if causal else np.full(T, S)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(T, int)
    return int(np.maximum(hi - lo, 0).sum())


def time_flash(torch, rng, label, B, T, H, Hkv, hd, iters,
               dtype: str = "bf16") -> tuple[str, dict]:
    """The flash kernel of the wrapper's route (bf16 here: tensor cores;
    f32: SIMT), its plain version and the library call at one causal
    prefill shape (S = T), beside the bound; with the kernel's name."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_route)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v = flash_case(torch, rng, B, T, T, H, Hkv, hd, tdt)
    n_bytes = q.element_size() * (2 * B * T * H * hd + 2 * B * T * Hkv * hd)
    n_ops = 4 * hd * H * B * flash_pairs(T, T, True, 0)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S if dtype == "bf16"
                       else F32_OPS_PER_S)
    lib_ms, lib_from = library_attention_ms(torch, q, k, v, iters)
    name = "flash_attention_tc" if flash_route(tdt, hd, T) == "tc" \
        else "flash_attention"
    r = dict(kernel_times(lambda: flash_attention_cuda(q, k, v),
                          lambda: flash_attention_plain(q, k, v), iters,
                          f"{name}_kernel"),
             shape=[B, T, H, Hkv, hd], dtype=dtype, bound_ms=b_ms,
             bound_by=b_by, library_ms=lib_ms, library_ms_from=lib_from)
    log(f"time {name} {label}/{dtype}: kernel {r['ms']:.5f} ms "
        f"({r['ms_from']}), plain {r['plain_ms']:.5f} ms "
        f"({r['plain_ms_from']}), library {lib_ms:.5f} ms ({lib_from}); "
        f"per call: kernel {r['call_ms']:.5f} ms; bound {b_ms:.6f} ms "
        f"({b_by})")
    return name, r


def time_paged(torch, rng, label, B, H, Hkv, hd, page, P, maxp, lens,
               iters) -> dict:
    """The kernel and its plain version at one bf16 decode shape, beside
    the bound: each live page of K and V read once, q read and the output
    written once."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    args = paged_case(torch, rng, B, H, Hkv, hd, page, P, maxp, lens,
                      torch.bfloat16)
    n_pages = sum(math.ceil(n / page) for n in lens)
    n_bytes = (2 * B * H * hd * 2 + n_pages * page * Hkv * hd * 2 * 2
               + n_pages * 4 + B * 4)
    n_ops = sum(4 * H * n * hd + 3 * H * n for n in lens)
    b_ms, b_by = bound(n_bytes, n_ops)
    out = dict(kernel_times(lambda: paged_attention_cuda(*args),
                            lambda: paged_attention_plain(*args), iters,
                            "paged_attention"),
               shape=[B, H, Hkv, hd, page, maxp, list(lens)], dtype="bf16",
               bound_ms=b_ms, bound_by=b_by)
    log(f"time paged_attention {label}: kernel {out['ms']:.5f} ms "
        f"({out['ms_from']}), plain {out['plain_ms']:.5f} ms "
        f"({out['plain_ms_from']}); per call: kernel {out['call_ms']:.5f} "
        f"ms; bound {b_ms:.6f} ms ({b_by})")
    return out


# (label, S, P, page, F, n) of the timed codec launches in bf16: one unit;
# a page of qwen2.5-3b and of phi3-mini-3.8b; a 144-token sequence of
# each (9 pages: a serve phase's page-out and page-in, the first the
# kernels line's numbers); the long-prompt phase's 1000- and 4000-token
# sequences (63 and 251 pages).
CODEC_TIMED = [
    ("qwen-serve-9pages", 72, 64, 16, 256, 72 * 9),
    ("n1", 1, 64, 16, 256, 1),
    ("qwen-page", 72, 64, 16, 256, 72),
    ("phi3-page", 64, 20, 16, 3072, 64),
    ("phi3-serve-9pages", 64, 20, 16, 3072, 64 * 9),
    ("qwen-63pages", 72, 128, 16, 256, 72 * 63),
    ("qwen-251pages", 72, 512, 16, 256, 72 * 251),
]


def time_codec(torch, rng, label, S, P, page, F, n) -> dict:
    """The four codec instances at one bf16 shape, each one launch over n
    units, beside its bound: every unit read once and its other form, the
    scales, the unit list and (with the checksum) the crcs written or read
    once."""
    from repro_torch.kernels import block_transit as bt
    stack, (src, _) = codec_case(torch, rng, S, P, page, F, n,
                                 torch.bfloat16)
    q, s, _ = bt.gather_quantize_cuda(stack, src)
    elems = n * page * F
    base = elems * 2 + elems + n * page * 4 + n * 8
    iters = 200 if n < 1000 else 50
    cases = {
        "gather_quantize_crc": (
            lambda: bt.gather_quantize_cuda(stack, src),
            lambda: bt.gather_quantize_crc_plain(stack, src),
            "gather_quantize_kernel", base + n * 8, 10 * elems),
        "scatter_dequantize_crc": (
            lambda: bt.scatter_dequantize_cuda(stack, src, q, s),
            lambda: bt.scatter_dequantize_crc_plain(stack, src, q, s),
            "scatter_dequantize_kernel", base + n * 8, 6 * elems),
        "gather_quantize": (
            lambda: bt.gather_quantize_cuda(stack, src, with_crc=False),
            lambda: bt.gather_quantize_plain(stack, src),
            "gather_quantize_kernel", base, 6 * elems),
        "scatter_dequantize": (
            lambda: bt.scatter_dequantize_cuda(stack, src, q, s,
                                               with_crc=False),
            lambda: bt.scatter_dequantize_plain(stack, src, q, s),
            "scatter_dequantize_kernel", base, 2 * elems)}
    out = {}
    for name, (fn, plain, match, n_bytes, n_ops) in cases.items():
        b_ms, b_by = bound(n_bytes, n_ops)
        r = dict(kernel_times(fn, plain, iters, match), shape=label,
                 units=n, unit_shape=[page, F], dtype="bf16", bound_ms=b_ms,
                 bound_by=b_by)
        out[name] = r
        log(f"time {name} {label} ({n} units): kernel {r['ms']:.6f} ms "
            f"({r['ms_from']}), {n_bytes / r['ms'] / 1e6:.1f} GB/s; plain "
            f"{r['plain_ms']:.5f} ms; per call {r['call_ms']:.5f} ms; bound "
            f"{b_ms:.6f} ms ({b_by})")
    return out


def time_kernels(torch, rng, results) -> None:
    """Each path kernel at the serving path's full-width shapes in bf16:
    prefill attention on the tensor-core kernel at qwen2.5-3b's 128-token
    prompt (the row's numbers) and at 1000 and 4000 tokens and
    phi3-mini-3.8b's prompt (``at_shapes``), and on the SIMT kernel at
    qwen's 128 tokens in f32, the input its route takes; decode attention
    over 4 sequences of 144 tokens (the last step; the row's numbers), and at
    phi3-mini-3.8b's width and the long-prompt shape (2 sequences of 1004
    and 4004 tokens over a 256-wide table) in ``at_shapes``; the codec at
    ``CODEC_TIMED``'s shapes, a qwen2.5-3b serve page-out (9 pages, 648
    units) the row's numbers."""
    keys = ("ms", "plain_ms", "ms_from", "plain_ms_from", "call_ms",
            "plain_call_ms", "bound_ms", "bound_by")
    flash = [time_flash(torch, rng, "qwen-T128", 1, 128, 16, 2, 128, 200),
             time_flash(torch, rng, "qwen-T1000", 1, 1000, 16, 2, 128, 50),
             time_flash(torch, rng, "qwen-T4000", 1, 4000, 16, 2, 128, 20),
             time_flash(torch, rng, "phi3-T128", 1, 128, 32, 32, 96, 200),
             time_flash(torch, rng, "qwen-T128", 1, 128, 16, 2, 128, 200,
                        dtype="f32")]
    for name in ("flash_attention_tc", "flash_attention"):
        shapes = [r for n, r in flash if n == name]
        results[name].update({k: shapes[0][k] for k in (*keys, "library_ms")},
                             at_shapes=shapes)
    B, H, Hkv, hd, page, P, maxp = 4, 16, 2, 128, 16, 64, 16
    shapes = [time_paged(torch, rng, "qwen-serve", B, H, Hkv, hd, page, P,
                         maxp, [144] * B, 200),
              time_paged(torch, rng, "phi3-serve", B, 32, 32, 96, page, P,
                         maxp, [144] * B, 200),
              time_paged(torch, rng, "qwen-long", 2, H, Hkv, hd, page, 512,
                         256, [1004, 4004], 50)]
    results["paged_attention"].update(
        {k: shapes[0][k] for k in keys}, library_ms=None,
        at_shapes=shapes[1:])

    codec = [time_codec(torch, rng, *case) for case in CODEC_TIMED]
    for name in ("gather_quantize_crc", "scatter_dequantize_crc",
                 "gather_quantize", "scatter_dequantize"):
        shapes = [c[name] for c in codec]
        results.setdefault(name, {"max_abs_err": 0.0}).update(
            {k: shapes[0][k] for k in keys}, library_ms=None,
            at_shapes=shapes[1:])
    for name, r in results.items():
        log(f"time {name}: kernel {r['ms']:.5f} ms ({r['ms_from']}), plain "
            f"{r['plain_ms']:.5f} ms ({r['plain_ms_from']}); per call with "
            f"launch: kernel "
            f"{r['call_ms']:.5f} ms, plain {r['plain_call_ms']:.5f} ms; bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")


# ------------------------------------------------------------- phase 3-6
def init_full(torch, arch: str):
    """FULL config and random bf16 parameters on the card from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    cfg = get_config(arch, smoke=False)
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch} FULL: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, {n_params / 1e9:.3f} B "
        f"params ({cfg.dtype}), init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def timed_engine(torch, eng) -> dict:
    """Wrap the engine's prefill and decode step with synchronised host
    clocks; returns the running totals (restore with ``untime``)."""
    spent = {"prefill_s": [], "decode_s": 0.0, "decode_tokens": 0,
             "decode_steps": 0, "finite": True}
    prefill, decode = eng.lm.prefill, eng.lm.decode_step

    def timed_prefill(tokens, sid):
        t = time.perf_counter()
        out = prefill(tokens, sid)
        torch.cuda.synchronize()
        spent["prefill_s"].append(time.perf_counter() - t)
        spent["finite"] &= bool(torch.isfinite(out).all())
        return out

    def timed_decode(tokens, sids, positions):
        t = time.perf_counter()
        out = decode(tokens, sids, positions)
        torch.cuda.synchronize()
        spent["decode_s"] += time.perf_counter() - t
        spent["decode_tokens"] += len(sids)
        spent["decode_steps"] += 1
        spent["finite"] &= bool(torch.isfinite(out).all())
        return out

    eng.lm.prefill, eng.lm.decode_step = timed_prefill, timed_decode
    return spent


def untime(eng) -> None:
    """Drop the wrappers: the instance attributes go and the methods show
    through again, with no bound method of the model left on it (a
    reference cycle that would keep the weights alive after ``del``)."""
    del eng.lm.prefill, eng.lm.decode_step


def _fetched(count) -> int:
    """Volume records read back so far (whole or failing their crc)."""
    return count.get("kv_restores", 0) + count.get("kv_restore_crc_errors", 0)


def timed_transit(torch, eng) -> dict:
    """Wrap the cache's page-out (``deactivate``) and page-in
    (``activate``) with synchronised host clocks: per call its seconds,
    the pages it moved and the volume records it fetched (restore with
    ``untime_transit``)."""
    calls = {"deactivate": [], "activate": []}
    count = eng.cache.metrics.count
    for name, key in (("deactivate", "pages_out"), ("activate", "pages_in")):
        def timed(sid, _fn=getattr(eng.cache, name), _log=calls[name],
                  _key=key):
            torch.cuda.synchronize()
            before, got, t = count.get(_key, 0), _fetched(count), \
                time.perf_counter()
            _fn(sid)
            torch.cuda.synchronize()
            _log.append((time.perf_counter() - t, count.get(_key, 0) - before,
                         _fetched(count) - got))
        setattr(eng.cache, name, timed)
    return calls


def untime_transit(eng) -> None:
    del eng.cache.deactivate, eng.cache.activate


def transit_summary(calls) -> dict:
    """Calls, the calls that moved pages, pages, volume records fetched,
    seconds and the longest call, for page-out and for page-in."""
    out = {}
    for name, log_ in calls.items():
        out[name] = {"calls": len(log_),
                     "calls_moving_pages": sum(n > 0 for _, n, _ in log_),
                     "pages": sum(n for _, n, _ in log_),
                     "records_fetched": sum(f for _, _, f in log_),
                     "s": sum(t for t, _, _ in log_),
                     "longest_s": max((t for t, _, _ in log_), default=0.0)}
    return out


def transit_line(tag, transit) -> None:
    d, a = transit["deactivate"], transit["activate"]
    log(f"{tag}: transit: {d['calls']} deactivate calls "
        f"({d['calls_moving_pages']} paged out) moved {d['pages']} pages in {d['s']:.4f} s (longest "
        f"{d['longest_s']:.4f} s); {a['calls']} activate calls "
        f"({a['calls_moving_pages']} paged in) moved {a['pages']} pages in "
        f"{a['s']:.4f} s (longest {a['longest_s']:.4f} s)")


def profile_transit(torch, eng, tokens: int, repeats: int = 3) -> dict:
    """Where one page-out and one page-in of a sequence spend their time,
    on an engine whose served run has ended: a fresh sequence of ``tokens``
    random K/V tokens is paged out and back in ``repeats`` times on
    synchronised host clocks, then once more each under torch.profiler.
    The profile gives the host's CUDA runtime calls and aten ops by self
    time (pinned allocation, copies, synchronisation, the launch) and the
    device's kernels and copies; what they leave of the call is Python and
    numpy (host entries, stacking the payloads)."""
    from torch.profiler import ProfilerActivity, profile
    cache, c = eng.cache, eng.cache.cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    kv = [torch.randn((tokens, c.n_kv_heads, c.head_dim), generator=g,
                      device="cuda").to(c.dtype)
          for _ in range(2 * c.n_layers)]
    sid = cache.new_sequence()
    cache.append_tokens(sid, kv[0::2], kv[1::2])
    pages = len(cache.seqs[sid].table)

    def once(name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        getattr(cache, name)(sid)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    out = {"tokens": tokens, "pages": pages}
    for name in ("deactivate", "activate"):
        out[name] = {"s": []}
    for _ in range(repeats):
        for name in ("deactivate", "activate"):
            out[name]["s"].append(once(name))
    for name in ("deactivate", "activate"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = once(name)
        host = sorted(((e.key[:50], e.self_cpu_time_total, e.count)
                       for e in prof.key_averages()
                       if e.self_cpu_time_total > 0), key=lambda r: -r[1])
        dev: dict[str, list] = {}
        for e in device_events(prof):
            row = dev.setdefault(e.name[:50], [0.0, 0])
            row[0] += e.time_range.end - e.time_range.start
            row[1] += 1
        out[name].update(profiled_s=wall, host_self_us_top=host[:8],
                         device_us=sorted(dev.items(),
                                          key=lambda kv_: -kv_[1][0]))
    cache.release(sid)
    torch.cuda.synchronize()
    for name in ("deactivate", "activate"):
        r = out[name]
        log(f"transit profile {c.n_layers} layers x {pages} pages, {name}: "
            f"{', '.join(f'{t:.4f}' for t in r['s'])} s; profiled "
            f"{r['profiled_s']:.4f} s, host self us {r['host_self_us_top']}; "
            f"device us {r['device_us']}")
    return out


def run_counted(torch, eng, suspend_at: int | None = None,
                suspend_every: int | None = None, suspend_all: bool = False):
    """Drive the engine to the end with the launch counts zeroed just
    before and read just after; returns (seconds, ticks, counts).  After
    tick ``suspend_at`` (or every ``suspend_every`` ticks) the first
    running request is suspended (with ``suspend_all``, every one)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    ticks = 0
    while eng.queue or eng.running or eng.suspended:
        eng.step()
        ticks += 1
        if eng.running and (ticks == suspend_at or (
                suspend_every and ticks % suspend_every == 0)):
            for req in list(eng.running) if suspend_all else eng.running[:1]:
                eng.suspend(req)             # preempt mid-decode
    torch.cuda.synchronize()
    return time.perf_counter() - t0, ticks, _build.launch_counts()


def path_kernels(cfg) -> list[str]:
    """The kernels a served config runs: one of the two flash kernels, by
    the wrapper's route for its dtype and head width, and the others."""
    from repro_torch.kernels.flash_attention import flash_route
    skip = ("flash_attention" if flash_route(cfg.dtype, cfg.hd) == "tc"
            else "flash_attention_tc")
    return [name for name in KERNELS if name != skip]


COUNTERS = ("pages_out", "pages_in", "fused_kernel_passes",
            "fused_kernel_bytes", "activate_stalls", "transit_crc_errors",
            "bypass_pages", "hybrid_attention")


def check_path_counts(tag, cfg, spent, counts, m, transit) -> None:
    """Every launch on the path went through its kernel, once per layer,
    and every prefill layer through the flash kernel of its route; the
    codec launched once for each deactivate that paged out, at most once
    for each volume record an activate fetched plus once for each
    activate, and, where nothing bypassed and no record was fetched, once
    for each activate that paged in; and the cache counted the
    reference's 2 passes per layer per page.  A page that bypassed to the
    host tier comes back in without the codec, so the page-in counts are
    exact only where nothing bypassed."""
    from repro_torch.kernels.flash_attention import flash_route
    n_pre = len(spent["prefill_s"])
    check(counts.get("flash_attention", 0) == cfg.n_layers * n_pre,
          f"{tag}: {counts.get('flash_attention', 0)} flash launches for "
          f"{n_pre} prefills of {cfg.n_layers} layers")
    n_tc = cfg.n_layers * n_pre if flash_route(cfg.dtype, cfg.hd) == "tc" \
        else 0
    check(counts.get("flash_attention_tc", 0) == n_tc,
          f"{tag}: {counts.get('flash_attention_tc', 0)} tensor-core flash "
          f"launches, {n_tc} expected")
    check(counts.get("paged_attention", 0)
          == cfg.n_layers * spent["decode_steps"],
          f"{tag}: {counts.get('paged_attention', 0)} attention launches for "
          f"{spent['decode_steps']} decode steps")
    out, inn = transit["deactivate"], transit["activate"]
    check(counts.get("gather_quantize_crc", 0) == out["calls_moving_pages"]
          and out["pages"] == m.get("pages_out", 0),
          f"{tag}: {counts.get('gather_quantize_crc', 0)} spill launches for "
          f"{out['calls_moving_pages']} page-outs")
    # an activate launches once, and once more before each record it
    # fetches after pages it has not restored yet
    restores = counts.get("scatter_dequantize_crc", 0)
    most = inn["calls_moving_pages"] + inn["records_fetched"]
    check(restores <= most, f"{tag}: {restores} restore launches for "
          f"{inn['calls_moving_pages']} page-ins that fetched "
          f"{inn['records_fetched']} volume records")
    if m.get("bypass_pages", 0):
        return
    check(inn["pages"] == m.get("pages_in", 0)
          and restores >= inn["calls_moving_pages"]
          and (inn["records_fetched"] > 0
               or restores == inn["calls_moving_pages"]),
          f"{tag}: {restores} restore launches for "
          f"{inn['calls_moving_pages']} page-ins")
    check(m.get("fused_kernel_passes", 0) == 2 * cfg.n_layers
          * (m.get("pages_out", 0) + m.get("pages_in", 0)),
          f"{tag}: {m.get('fused_kernel_passes', 0)} fused passes for "
          f"{m.get('pages_out', 0)} pages out and {m.get('pages_in', 0)} in")


def serve_full(torch, np, cfg, params, profile: bool) -> dict:
    """4 requests x (128 prompt + 16 new tokens) at full width, one of them
    suspended and resumed, then a fresh prompt's logits; with ``profile``
    also the profiled decode window."""
    from repro_torch.serve import PagedCacheConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    cache_cfg = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        page_size=16, n_pages=64, max_pages_per_seq=16, dtype=cfg.dtype)
    eng = ServeEngine(cfg, params, cache_cfg=cache_cfg, max_batch=4,
                      device="cuda")
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(2, cfg.vocab, size=128).tolist(),
                       max_new_tokens=16) for _ in range(4)]
    spent = timed_engine(torch, eng)
    calls = timed_transit(torch, eng)
    e2e, ticks, counts = run_counted(torch, eng, suspend_at=3)
    untime(eng)
    untime_transit(eng)
    m = dict(eng.metrics.count)
    transit = transit_summary(calls)
    tag = f"serve {cfg.name}"

    check(all(r.done and len(r.out_tokens) == 16 for r in reqs),
          f"{tag}: not every request finished with 16 tokens")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens),
          f"{tag}: a token outside the vocabulary")
    check(spent["finite"], f"{tag}: logits not finite")
    check(m.get("pages_out", 0) > 0 and m.get("pages_in", 0) > 0,
          f"{tag}: pages out/in {m.get('pages_out')}/{m.get('pages_in')}")
    check(m.get("transit_crc_errors", 0) == 0, f"{tag}: transit crc errors")
    check(m.get("suspends") == 1 and m.get("resumes") == 1,
          f"{tag}: the suspend/resume did not happen")
    for name in path_kernels(cfg):
        check(kernel_launches(counts).get(name, 0) > 0,
              f"{tag}: {name} never launched")
    check_path_counts(tag, cfg, spent, counts, m, transit)
    check(eng.cache.free_pages() == cache_cfg.n_pages and len(eng.cache.host)
          == 0, f"{tag}: pages leaked")
    transit["profile"] = profile_transit(torch, eng, 144)
    # the output itself: a fresh prompt's logits at full width
    sid = eng.cache.new_sequence()
    logits = eng.lm.prefill(np.asarray(reqs[0].prompt[:32], np.int32), sid)
    eng.cache.release(sid)
    torch.cuda.synchronize()
    check(logits.shape == (cfg.vocab,) and bool(torch.isfinite(logits).all()),
          f"{tag}: full-width logits not finite")
    out = dict(spent, prefill_s=sum(spent["prefill_s"]),
               prefills=len(spent["prefill_s"]), e2e_s=e2e, ticks=ticks,
               launches=counts, transit=transit,
               counters={k: m.get(k, 0) for k in COUNTERS},
               decode_tok_s=spent["decode_tokens"] / spent["decode_s"],
               max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile:
        out["profile"] = profile_decode(torch, np, eng, cfg)
    log(f"{tag}: 4 requests x 16 tokens in {e2e:.2f} s end to end "
        f"({ticks} ticks); decode {spent['decode_tokens']} tokens in "
        f"{spent['decode_s']:.2f} s = {out['decode_tok_s']:.1f} tok/s; "
        f"prefill {out['prefill_s']:.2f} s; pages out/in "
        f"{m['pages_out']}/{m['pages_in']}; launches {counts}; peak memory "
        f"{out['max_memory_gb']:.2f} GB")
    transit_line(tag, transit)
    del eng
    return out


def long_prompts(torch, np, cfg, params) -> dict:
    """Prompts of 1000 and 4000 tokens through one engine with 512 pages
    of 16 (max 256 a sequence): both prefilled, then 4 decode steps."""
    from repro_torch.serve import PagedCacheConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    cache_cfg = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        page_size=16, n_pages=512, max_pages_per_seq=256, dtype=cfg.dtype)
    eng = ServeEngine(cfg, params, cache_cfg=cache_cfg, max_batch=2,
                      device="cuda")
    rng = np.random.default_rng(2)
    lens = (1000, 4000)
    reqs = [eng.submit(rng.integers(2, cfg.vocab, size=n).tolist(),
                       max_new_tokens=5) for n in lens]
    spent = timed_engine(torch, eng)
    calls = timed_transit(torch, eng)
    e2e, ticks, counts = run_counted(torch, eng)
    untime(eng)
    untime_transit(eng)
    m = dict(eng.metrics.count)
    transit = transit_summary(calls)
    tag = f"long prompts {cfg.name}"
    check(all(r.done and len(r.out_tokens) == 5 for r in reqs),
          f"{tag}: unfinished")
    check(spent["finite"], f"{tag}: logits not finite")
    check(len(spent["prefill_s"]) == 2 and spent["decode_steps"] == 4,
          f"{tag}: {len(spent['prefill_s'])} prefills, "
          f"{spent['decode_steps']} decode steps")
    check(m.get("bypass_pages", 0) == 0 and m.get("hybrid_attention", 0) == 0,
          f"{tag}: the pool should hold both prompts")
    check(m.get("transit_crc_errors", 0) == 0, f"{tag}: transit crc errors")
    check_path_counts(tag, cfg, spent, counts, m, transit)
    check(eng.cache.free_pages() == cache_cfg.n_pages and len(eng.cache.host)
          == 0, f"{tag}: pages leaked")
    transit["profile"] = profile_transit(torch, eng, lens[1])
    out = {"prompt_tokens": list(lens), "prefill_s": spent["prefill_s"],
           "decode_s": spent["decode_s"], "decode_steps": 4, "e2e_s": e2e,
           "launches": counts, "transit": transit,
           "counters": {k: m.get(k, 0) for k in COUNTERS},
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{tag}: prefill {lens[0]} tokens {spent['prefill_s'][0]:.3f} s, "
        f"{lens[1]} tokens {spent['prefill_s'][1]:.3f} s; 4 decode steps "
        f"{spent['decode_s']:.3f} s; end to end {e2e:.3f} s; launches "
        f"{counts}; peak memory {out['max_memory_gb']:.2f} GB")
    transit_line(tag, transit)
    del eng
    return out


# the spill phase's volume: 885 slots of a qwen2.5-3b FULL record (74
# blocks), against at most 80 live records.  The in-flight window holds
# every record of the 2 prefetched requests (10 pages each) as linked
# reads, with room for spill writes: the default of 16 holds no record, so
# nothing would be prefetched, and a window that cuts a chain short makes
# the pager cancel the chain's queued links, which takes time doubling
# with each link (the error text of each link's cancellation quotes the
# one before)
SPILL_VOLUME = dict(n_lbas=1 << 16, n_shards=2, aio_workers=2,
                    cache_bytes=1 << 22, max_inflight=2048)


def timed_pager(pager) -> dict:
    """Wrap the pager's ``spill``, ``fetch`` and ``prefetch`` with host
    clocks: the seconds of each call (restore with ``untime_pager``).  A
    prefetch first waits for its records' spill writes to land."""
    spent = {"spill": [], "fetch": [], "prefetch": []}
    for name, log_ in spent.items():
        def timed(*args, _fn=getattr(pager, name), _log=log_):
            t = time.perf_counter()
            out = _fn(*args)
            _log.append(time.perf_counter() - t)
            return out
        setattr(pager, name, timed)
    return spent


def untime_pager(pager) -> None:
    del pager.spill, pager.fetch, pager.prefetch


def _mean_max(xs) -> tuple[float, float]:
    return (sum(xs) / len(xs), max(xs)) if xs else (0.0, 0.0)


def spill_full(torch, np, cfg, params) -> dict:
    """8 requests x (128 prompt + 32 new tokens) at full width, batch 4,
    the first running request suspended every 6 ticks, through a pager on
    a volume (host tier 4 pages, prefetch depth 2), then the same traffic
    and suspends with no pager and an unbounded host tier: the greedy
    tokens must be equal, pages must have spilled, been prefetched and
    restored with no crc error, and nothing may be left behind."""
    from repro_torch.launch.serve import record_blocks
    from repro_torch.serve import KVPager, PagedCacheConfig, ServeEngine
    from repro_torch.volume.volume import make_volume

    tag = f"spill {cfg.name}"
    runs = {}
    for mode in ("pager", "no pager"):
        torch.cuda.reset_peak_memory_stats()
        vol = make_volume(**SPILL_VOLUME) if mode == "pager" else None
        try:
            pager = KVPager(vol) if vol is not None else None
            cache_cfg = PagedCacheConfig(
                n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, page_size=16, n_pages=64,
                host_pages=4 if pager else 1 << 30, max_pages_per_seq=16,
                dtype=cfg.dtype)
            eng = ServeEngine(cfg, params, cache_cfg=cache_cfg, max_batch=4,
                              pager=pager, prefetch_depth=2, device="cuda")
            rng = np.random.default_rng(4)
            reqs = [eng.submit(rng.integers(2, cfg.vocab, size=128).tolist(),
                               max_new_tokens=32) for _ in range(8)]
            spent = timed_engine(torch, eng)
            calls = timed_transit(torch, eng)
            io = timed_pager(pager) if pager else None
            e2e, ticks, counts = run_counted(torch, eng, suspend_every=6)
            untime(eng)
            untime_transit(eng)
            m = dict(eng.metrics.count)
            transit = transit_summary(calls)
            check(all(r.done and len(r.out_tokens) == 32 for r in reqs),
                  f"{tag} ({mode}): not every request finished")
            check(spent["finite"], f"{tag} ({mode}): logits not finite")
            check(m.get("transit_crc_errors", 0) == 0,
                  f"{tag} ({mode}): transit crc errors")
            check(m.get("bypass_pages", 0) == 0,
                  f"{tag} ({mode}): the pool should hold the batch")
            for name in path_kernels(cfg):
                check(kernel_launches(counts).get(name, 0) > 0,
                      f"{tag} ({mode}): {name} never launched")
            check_path_counts(f"{tag} ({mode})", cfg, spent, counts, m,
                              transit)
            check(eng.cache.free_pages() == cache_cfg.n_pages
                  and len(eng.cache.host) == 0
                  and eng.cache.host_page_count() == 0,
                  f"{tag} ({mode}): pages or host entries left behind")
            run = {"e2e_s": e2e, "ticks": ticks, "launches": counts,
                   "tokens": [r.out_tokens for r in reqs],
                   "prefill_s": sum(spent["prefill_s"]),
                   "decode_s": spent["decode_s"],
                   "decode_tok_s": spent["decode_tokens"] / spent["decode_s"],
                   "suspends": m.get("suspends", 0),
                   "resumes": m.get("resumes", 0), "transit": transit,
                   "counters": {k: m.get(k, 0) for k in COUNTERS},
                   "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            if pager is not None:
                untime_pager(pager)
                st = pager.stats()
                check(st["records"] == 0 and st["free_slots"] == st["n_slots"],
                      f"{tag}: pager slots left behind {st}")
                path = eng.metrics.kv_paging_path()
                resident = [t for t, _, f in calls["activate"] if f > 0]
                blocks = path["kv_spill_blocks"]
                run.update(
                    kv_paging=path, slot_blocks=st["slot_blocks"],
                    n_slots=st["n_slots"],
                    record_blocks=record_blocks(cfg, 16),
                    spill_s=io["spill"], fetch_s=io["fetch"],
                    prefetch_s=io["prefetch"],
                    spill_s_mean_max=_mean_max(io["spill"]),
                    fetch_s_mean_max=_mean_max(io["fetch"]),
                    resident_activate_s=resident,
                    blocks_written=blocks,
                    bytes_written=blocks * vol.block_size)
            runs[mode] = run
            del eng
        finally:
            if vol is not None:
                vol.close()
    got, ref = runs["pager"], runs["no pager"]
    check(got["tokens"] == ref["tokens"],
          f"{tag}: greedy tokens differ from the run with no pager")
    check(got["suspends"] == ref["suspends"] > 0
          and got["resumes"] == got["suspends"],
          f"{tag}: suspends/resumes {got['suspends']}/{got['resumes']}")
    p = got["kv_paging"]
    for key in ("kv_spills", "kv_restores", "kv_prefetch_issued",
                "kv_prefetch_hits"):
        check(p[key] > 0, f"{tag}: {key} = {p[key]}")
    check(p["kv_restore_crc_errors"] == 0, f"{tag}: wire crc errors")
    check(got["slot_blocks"] == got["record_blocks"],
          f"{tag}: {got['slot_blocks']}-block records, "
          f"{got['record_blocks']} expected")
    (sm, sx), (fm, fx) = got["spill_s_mean_max"], got["fetch_s_mean_max"]
    log(f"{tag}: 8 requests x 32 tokens in {got['e2e_s']:.2f} s end to end "
        f"with the pager ({got['ticks']} ticks), {ref['e2e_s']:.2f} s with no "
        f"pager ({ref['ticks']} ticks); decode {got['decode_tok_s']:.1f} / "
        f"{ref['decode_tok_s']:.1f} tok/s; suspends/resumes "
        f"{got['suspends']}/{got['resumes']}; greedy tokens equal the run "
        f"with no pager")
    log(f"{tag}: volume: {p['kv_spills']} records of {got['slot_blocks']} "
        f"blocks written ({got['n_slots']} slots), {got['blocks_written']} "
        f"blocks = {got['bytes_written']} bytes; dedup rate "
        f"{p['dedup_rate']:.3f}; prefetch {p['kv_prefetch_issued']} issued / "
        f"{p['kv_prefetch_hits']} hits / {p['kv_prefetch_wasted']} wasted, "
        f"hit rate {p['prefetch_hit_rate']:.3f}; {p['kv_restores']} restores, "
        f"{p['kv_restore_crc_errors']} crc errors, {p['kv_spill_frees']} "
        f"slots freed")
    log(f"{tag}: seconds per spill {sm} (max {sx}), per fetch {fm} (max "
        f"{fx}); activate of a volume-resident session "
        f"{got['resident_activate_s']} s")
    log(f"{tag}: where the time goes, pager / no pager: prefill "
        f"{got['prefill_s']} / {ref['prefill_s']} s, decode "
        f"{got['decode_s']} / {ref['decode_s']} s, deactivate "
        f"{got['transit']['deactivate']['s']} / "
        f"{ref['transit']['deactivate']['s']} s, activate "
        f"{got['transit']['activate']['s']} / "
        f"{ref['transit']['activate']['s']} s; {len(got['prefetch_s'])} "
        f"prefetch calls {sum(got['prefetch_s'])} s (max "
        f"{max(got['prefetch_s'], default=0.0)})")
    transit_line(f"{tag} (pager)", got["transit"])
    for run in runs.values():
        del run["tokens"]
    return {"launches": got["launches"], "pager": got, "no_pager": ref}


def profile_decode(torch, np, eng, cfg) -> dict:
    """Where a full-width decode step's time goes: 4 fresh requests are
    admitted, then 3 pure decode steps (no admission, no retirement) run
    under torch.profiler.  Device busy time is the union of the device
    ops' intervals; the idle share is the rest of the window from the
    first device op's start to the last one's end."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)
    for _ in range(4):
        eng.submit(rng.integers(2, cfg.vocab, size=128).tolist(),
                   max_new_tokens=8)
    eng.step()
    torch.cuda.synchronize()
    steps = 3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += (hi - lo) if hi is not None else 0.0
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    per_name: dict[str, list] = {}
    for e in events:
        row = per_name.setdefault(e.name[:70], [0.0, 0])
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    eng.run()
    torch.cuda.synchronize()
    check(eng.cache.free_pages() == eng.cache.cfg.n_pages,
          "profile: pages leaked")
    out = {"steps": steps, "step_ms": wall / steps * 1e3,
           "device_busy_ms_per_step": busy / steps / 1e3,
           "device_idle_share": (1.0 - busy / window) if window else None,
           "device_ops_per_step": len(spans) / steps,
           "top_device_us_per_step": [
               [k, us / steps, n // steps] for k, (us, n) in top]}
    log(f"profile: decode step {out['step_ms']:.1f} ms (profiled), device "
        f"busy {out['device_busy_ms_per_step']:.2f} ms, idle share "
        f"{out['device_idle_share']}, {out['device_ops_per_step']:.0f} "
        f"device ops per step")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------- phase 7
def parity_smoke(torch, np) -> dict:
    """For each served architecture, the pools of ``PARITY_CASES``: a
    roomy one (64 pages of 8), where every page stays on the card and the
    suspended request pages out and back in; a tiny one (2 pages of 4),
    where pages bypass to the host tier and decode runs the hybrid
    attention path; and 6 pages of 4 behind a pager on a volume with no
    host budget, where a stalled resume leaves spilled pages that the
    hybrid path reads without promoting them.  Tokens and the cache's
    counters (the spill tier's too, and the spilled pages read) must be
    the same on the card and on the CPU, nothing may be left behind, and
    on the card every prefill layer launches the flash kernel once and
    every decode layer the paged-attention kernel once, hybrid or not."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.core.metrics import KV_PAGING_COUNTERS
    from repro_torch.serve import KVPager, PagedCacheConfig, ServeEngine
    from repro_torch.volume.volume import make_volume

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keys = (*COUNTERS, *KV_PAGING_COUNTERS)
    launches = {}
    for arch in (QWEN, PHI3):
        cfg = get_config(arch, smoke=True, dtype=torch.float32)
        params = init_lm(cfg, torch.Generator().manual_seed(0))
        for label, n_pages, page_size, lens, drive in PARITY_CASES:
            tag = f"parity {arch} {label}"
            tokens, counts = {}, {}
            for dev in ("cuda", "cpu"):
                vol = (make_volume(n_lbas=4096, n_shards=2, aio_workers=2,
                                   cache_bytes=1 << 22)
                       if label == "pager" else None)
                try:
                    eng = ServeEngine(
                        cfg, _to(params, dev), max_batch=2, device=dev,
                        pager=KVPager(vol) if vol is not None else None,
                        cache_cfg=PagedCacheConfig(
                            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.hd, page_size=page_size,
                            n_pages=n_pages, max_pages_per_seq=16,
                            host_pages=0 if vol is not None else 1024,
                            dtype=cfg.dtype))
                    vol_reads = count_vol_page_reads(eng.cache)
                    rng = np.random.default_rng(1)
                    reqs = [eng.submit(rng.integers(2, cfg.vocab,
                                                    size=n).tolist(),
                                       max_new_tokens=8) for n in lens]
                    spent = timed_engine(torch, eng)
                    calls = timed_transit(torch, eng)
                    _, _, launched = run_counted(torch, eng, **drive)
                    untime(eng)
                    untime_transit(eng)
                    check(all(r.done for r in reqs), f"{tag}: unfinished")
                    check(eng.cache.free_pages() == n_pages
                          and len(eng.cache.host) == 0
                          and (vol is None
                               or eng.cache.pager.stats()["records"] == 0),
                          f"{tag} ({dev}): pages, host entries or records "
                          f"left behind")
                finally:
                    if vol is not None:
                        vol.close()
                tokens[dev] = [r.out_tokens for r in reqs]
                counts[dev] = {k: eng.metrics.count.get(k, 0) for k in keys}
                counts[dev]["vol_page_reads"] = len(vol_reads)
                if dev == "cuda":
                    check_path_counts(f"{tag} (cuda)", cfg, spent, launched,
                                      counts[dev], transit_summary(calls))
                    launches[f"{arch} {label}"] = launched
            check(tokens["cuda"] == tokens["cpu"], f"{tag}: cuda "
                  f"{tokens['cuda']} != cpu {tokens['cpu']}")
            check(counts["cuda"] == counts["cpu"], f"{tag}: counters "
                  f"cuda {counts['cuda']} != cpu {counts['cpu']}")
            c = counts["cuda"]
            check(c["transit_crc_errors"] == 0, f"{tag}: crc errors")
            if label == "roomy":
                check(c["pages_in"] > 0, f"{tag}: no page-in")
            else:
                check(c["bypass_pages"] > 0 and c["hybrid_attention"] > 0,
                      f"{tag}: no bypass or hybrid attention {c}")
            if label == "pager":
                check(c["kv_spills"] > 0 and c["kv_restores"] > 0
                      and c["activate_stalls"] > 0 and c["vol_page_reads"] > 0
                      and c["kv_restore_crc_errors"] == 0,
                      f"{tag}: no spill, stalled resume or hybrid read of a "
                      f"spilled page {c}")
            log(f"{tag}: SMOKE f32 (TF32 off) greedy tokens equal on cuda "
                f"and cpu: {tokens['cuda']}; counters {c}; cuda launches "
                f"{launches[f'{arch} {label}']}")
    return launches


# (label, pool pages, page size, prompt lengths, how run_counted suspends):
# a roomy pool (page-out and page-in); a 2-page pool (bypass and hybrid
# attention); and a 6-page pool behind a pager with no host budget, where
# suspending both running requests at once makes the second resume stall
# right after promoting a spilled page with spilled pages behind it, so
# decode reads those through the hybrid path without promoting them
PARITY_CASES = [
    ("roomy", 64, 8, (12, 20, 9), {"suspend_at": 2}),
    ("bypass", 2, 4, (12, 20, 9), {"suspend_at": 2}),
    ("pager", 6, 4, (8, 16, 9), {"suspend_at": 5, "suspend_all": True}),
]


def count_vol_page_reads(cache) -> list:
    """Wrap the cache's one-page read of the hybrid path; the returned
    list gets an entry for each spilled page it read."""
    reads = []
    page_kv = cache._page_kv

    def counted(layer, entry):
        if entry[0] == "vol":
            reads.append(layer)
        return page_kv(layer, entry)
    cache._page_kv = counted
    return reads


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ------------------------------------------------------------------ main
def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs on a GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    torch.cuda.synchronize()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(logs) or 'already built'})")
    check_build(_build)

    rng = np.random.default_rng(0)
    results: dict[str, dict] = {}
    check_paged_attention(torch, rng, results)
    check_codec(torch, rng, results)
    check_flash_attention(torch, rng, results)
    time_kernels(torch, rng, results)
    torch.cuda.synchronize()

    cfg, params = init_full(torch, QWEN)
    paths = {"serve": serve_full(torch, np, cfg, params, profile=True)}
    torch.cuda.synchronize()
    paths["long_prompts"] = long_prompts(torch, np, cfg, params)
    torch.cuda.synchronize()
    paths["spill"] = spill_full(torch, np, cfg, params)
    del params
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 1e9,
          f"qwen2.5-3b weights still held: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    cfg, params = init_full(torch, PHI3)
    paths["serve_phi3"] = serve_full(torch, np, cfg, params, profile=False)
    del params
    torch.cuda.empty_cache()
    parity = parity_smoke(torch, np)
    torch.cuda.synchronize()

    # launches of each kernel on the paths of phases 3-7, each counted
    # alone: the full-width paths and the SMOKE f32 parity runs
    by_path = {k: kernel_launches(p["launches"]) for k, p in paths.items()}
    by_path.update({f"parity {k}": kernel_launches(c)
                    for k, c in parity.items()})
    launches = {name: sum(c.get(name, 0) for c in by_path.values())
                for name in (*KERNELS, "gather_quantize", "scatter_dequantize")}
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the paths")

    def row(name, src, rep):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "launches_by_path": {k: c.get(name, 0)
                                     for k, c in by_path.items()},
                **{k: results[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "ms_from", "plain_ms_from", "call_ms",
                    "plain_call_ms")},
                **{k: results[name][k] for k in (
                    "max_row_rel_err", "at_shapes") if k in results[name]}}

    line = {"kernels": [row(name, *v) for name, v in KERNELS.items()]}
    variants = {"variants_off_the_path": [
        row(name, "src/repro_torch/kernels/csrc/block_transit.cu", rep)
        for name, rep in (
            ("gather_quantize", "src/repro/kernels/block_transit.py:50"),
            ("scatter_dequantize",
             "src/repro/kernels/block_transit.py:157"))]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    for key, p in paths.items():
        print(json.dumps({key: {k: v for k, v in p.items()
                                if k != "launches"}}))
    print(json.dumps({"parity_launches": parity}))
    print(json.dumps({"flash_launches_by_path": {
        k: {"calls": c.get("flash_attention", 0)
            + c.get("flash_attention_tc", 0),
            "tensor_core": c.get("flash_attention_tc", 0),
            "simt": c.get("flash_attention", 0)}
        for k, c in by_path.items()}}))
    print(json.dumps(variants))
    print(json.dumps(line))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
