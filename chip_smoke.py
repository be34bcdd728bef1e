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
            2, hd 128; phi3-mini-3.8b: Hkv 32, hd 96; deepseek-coder-33b:
            56:8, n_rep 7) and at smoke shapes (deepseek's SMOKE: 7:1, hd
            8), f32 and bf16: the codec's one launch over a stack of units
            (``CODEC_CASES``: one pool, a qwen2.5-3b page of 72 units, a
            phi3-mini-3.8b page of 64, a 251-page qwen sequence of 18072, a
            deepseek-coder-33b page of 124)
            with q, scales and crcs bit-identical, every crc equal to
            ``zlib.adler32``, a flipped byte moving one crc and the units
            not named untouched; paged attention within
            2e-5 (f32) / 2e-2 (bf16) with poison written past each length;
            flash attention within the same tolerances over the reference's
            sweep, windows, non-causal, ragged lengths, hd 16 and 96 and
            the prefill shapes (and the model API's, ``model_shapes``
            from ``MODEL_RUNS``: each phase's prompt, non-causal with
            T != S, 128 x 1600 at 32:8 and 64 x 1500 at 20:20 hd 64, the
            whisper encoder's T = S = 1500, n_rep 16, recurrentgemma's
            2 x 2176 at 16:1 of hd 256 with a 2048-token window, in bf16
            and f32), every bf16 case on the tensor-core kernel and every
            f32 one on the SIMT kernel, and its gradient equal to the
            plain one (hd 128, and hd 256 windowed); the model API's
            decode attention (``model_shapes``: one paged launch over a
            contiguous cache viewed as pages of 4, 8 or 16, n_rep 16 as
            two rows of 8, recurrentgemma's 2048-slot ring part-filled and
            full) against the plain version at the full n_rep; then each
            path kernel timed beside its plain version, its bound and,
            where one PyTorch call computes the same function, that call
            (``library_ms``: fused attention for flash, and for decode
            over a contiguous cache the same call with a length mask),
            the codec at ``CODEC_TIMED``'s unit counts;
            and the arguments the mesh added: the paged kernel's per-row
            log-sum-exp against the plain version's at the serving and
            model API shapes, each with a row of length 0 (lse -inf,
            output 0), and flash attention's ``q_offset`` at a
            deepseek-coder-33b shape (56:8, hd 128, T 512) split 2 and 4
            ways, causal and windowed, bf16 on the tensor-core kernel and
            f32 on the SIMT one, within the same tolerances; and the
            sLSTM's recurrence as one op (``repro_torch::slstm_scan``, a
            plain loop: the reference has no kernel there) at
            xlstm-1.3b's width (4 x 256, 4 heads of 512): its output equal
            to the plain loop's bit for bit, its backward's gradients
            within ``SLSTM_GRAD_TOL`` of autograd's through the loop, both
            timed beside the loop's; and the mLSTM's chunk loop as two ops
            (``repro_torch::mlstm_scores`` and ``mlstm_hidden``, plain
            loops) at the same width in chunks of 128: their output and
            final state equal to the plain loop's bit for bit in f32 and
            bf16, their backwards' gradients within ``MLSTM_GRAD_TOL`` of
            autograd's through the loop, both timed beside the loop's;
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
7. pool   — internlm2-1.8b FULL (24 layers, d_model 2048, 16:8 heads of
            128, vocab 92544): 8 requests of 128 prompt and 32 new tokens
            at batch 4, the first running request suspended every 6 ticks,
            twice.  Leg A: the engine's model over a cache whose page-outs
            run on a volume's 4-worker eviction pool, in batches of up to
            8 items, each one codec launch from a worker thread.  Leg B: no
            pool, every retired request appended to a request log on a
            second volume with the autotuner attached, a control step every
            4 ticks, driven by ``run()``.  Tokens must be equal, nothing
            freed twice or left behind, the log must read back; it prints
            the caller's seconds per deactivate against synchronous
            page-outs, the waits of activate on the pool, the batches, the
            longest lock hold, and the log's append and drain seconds;
8. deepseek — deepseek-coder-33b FULL (62 layers, d_model 7168, 56:8 heads
            of 128, 66.7 GB of bf16 weights) once every other full-width
            phase has freed its weights: 2 requests of 128 + 8 tokens at
            batch 2 in a 32-page pool, one suspend and resume, the memory
            before init and its peaks, and the profiled decode step beside
            the weight-bytes bound;
9. parity — SMOKE in f32 (TF32 off) served on the card and on the CPU from
            the same weights (``PARITY_RUNS``): qwen2.5-3b and
            phi3-mini-3.8b with a roomy pool (page-out and page-in), with a
            2-page pool (conditional bypass and hybrid attention, which
            runs the paged-attention kernel), and with a 6-page pool behind
            a pager with no host budget (a resume stalls right after
            promoting a spilled page, and the hybrid path reads spilled
            pages); internlm2-1.8b and deepseek-coder-33b (hd 8, n_rep 7)
            with the roomy pool, deepseek's also behind an eviction pool:
            the greedy tokens and the cache's counters are equal;
10. moonshot — the model API (``build_model(cfg).prefill`` and
            ``.decode_step``) on moonshot-v1-16b-a3b FULL (48 layers,
            d_model 2048, 16:16 heads of 128, MoE 64 experts of 1408,
            top-6, vocab 163840; 28.06 B parameters, 56.1 GB in bf16)
            after deepseek's weights are freed: 4 prompts of 128 tokens
            with ``s_max`` 144, then 16 greedy decode steps, the last 3
            profiled beside the step's bound (at batch 4 the capacity
            dispatch runs every expert, so the step reads every weight);
11. vlm    — llama-3.2-vision-11b FULL (40 layers, a gated cross-attention
            layer every 5th over 1600 patch embeddings drawn from the
            seed; every xgate set to 0.5): 2 x (128 + 16);
12. whisper — whisper-large-v3 FULL (32 encoder and 32 decoder layers,
            hd 64, 1500 frames, xgate 0.5): 2 x (64 + 16);
13. qwen3-moe — qwen3-moe-235b-a22b at full width cut to 4 of its 94
            layers (22.1 GB; printed as ``reduced``): 4 x (128 + 8), the
            attention kernels at n_rep 16;
14. recurrentgemma — recurrentgemma-9b FULL (38 layers: 12 x (rec, rec,
            attn) + 2 rec, d_model 4096, 16:1 heads of 256, d_ff 12288,
            vocab 256000, window 2048; 10.4 B parameters, 20.9 GB): 2 x
            (2176 + 16), prompts past the window, then 2 x (128 + 16), the
            ring part-filled; 12 flash launches a prefill, 12 paged a step,
            the ring's positions checked;
15. xlstm  — xlstm-1.3b FULL (48 blocks: 6 x (7 mLSTM + 1 sLSTM), d_model
            2048, 4 heads of 512, vocab 50304; 1.17 B parameters): 4 x
            (256 + 16), the chunkwise mLSTM in 2 chunks of 128; no
            attention kernel runs, and the step's bound counts the mLSTM
            state read and written; one sLSTM op call a group in the
            prefill and in each step, one call of each mLSTM op a layer in
            the prefill; the same prefill and steps with the mLSTM's plain
            chunk loop in its ops' place give the same tokens and logits,
            and with the sLSTM's plain loop in its op's place the same
            tokens;
16. model parity — the model API at SMOKE in f32 (TF32 off) for
            ``MODEL_PARITY`` (moonshot, qwen3-moe, whisper, llama-vision,
            xlstm, recurrentgemma at prompts of 40 and of 8 decoded past
            its 32-slot ring), card against CPU: forward, prefill logits
            and cache or state, the greedy decode steps within
            ``ROW_TOL["f32"]``, tokens equal.

17. train  — phi3-mini-3.8b FULL in bf16 (3.82 B parameters: 7.6 GB of
            weights, 7.6 GB of gradients, 30.6 GB of f32 AdamW moments)
            trained with remat "dots" after every other phase's weights
            are freed: the port's ``Trainer`` for 6 steps of 4 x 1024
            tokens from ``SyntheticLM`` (the last one profiled), then 2
            steps of ``make_train_step`` at accum 2 on the next batches;
            every loss finite, every parameter moved by the first step,
            64 tensor-core flash launches a step and microbatch (each of
            the 32 layers' forward, and its recompute in the backward);
            it prints the state's GB by part and the peak, step ms and
            tokens/s, the profiled step's busy ms, idle share and ops
            beside the step's bound (6 N tokens + causal attention at 989
            TFLOP/s, then the update's 22 bytes a parameter at 3.35
            TB/s), the flash forward and its plain backward alone at the
            step's shape (device ms, the backward's memory), and the
            optimizer's update;
18. train parity — phi3-mini-3.8b SMOKE in f32 (TF32 off), 4 ``Trainer``
            steps on the card and on the CPU from the same weights and
            data: losses within rtol 1e-4, parameters within
            ``ROW_TOL["f32"]`` row by row, the SIMT flash kernel twice a
            layer and step;
19. train ckpt — right after phase 17: phi3-mini-3.8b at its full width
            cut to 1 layer (3.10 GB of bf16 weights and f32 moments;
            printed as ``reduced``), 4 x 1024 tokens a step, through the
            ``Trainer`` with Caiti-backed checkpoints to a ``caiti`` file
            store in a temporary directory: run A saves once, async,
            after step 3, runs steps 4-6 with the save in flight and
            crashes at step 7; the store is reopened from the file and
            run B resumes steps 4-7 from it, the restored state equal bit
            for bit (per-leaf digests) to the state saved; run C trains
            steps 0-7 without checkpoints, and both runs' losses must
            equal its own within rtol 1e-4; it prints the checkpoint's GB,
            the snapshot's ms (the loop's stall), the background write's
            s and MB/s, ``cache_flush`` and commit s, the staged and
            bypassed chunks, the steps beside the save against run C's,
            the reopen and restore s and the store file's size.
20. mesh   — the port's mesh (``parallel/``, ``launch/mesh.py``, the
            models' ``ctx``) on an NCCL process group of one rank (a file
            rendezvous in a temporary directory), ``make_local_mesh(1)``
            -> (data 1, model 1), in two legs: moonshot-v1-16b-a3b FULL
            right after phase 10's off-mesh run, while its weights are on
            the card (wrapped as DTensors with no copy: the same storage,
            no byte more allocated): the same 4 x (128 + 16) through
            ``prefill`` / ``decode_step(..., ctx)``, the greedy tokens
            equal to phase 10's, 48 flash launches a prefill, 48 paged a
            step (the S-sharded branch: the paged kernel's log-sum-exp,
            shards merged by an NCCL all-reduce), 48 calls of the MoE's
            ``local_map`` branch a step, peak memory, tok/s and the
            profiled step's busy ms, idle share and ops beside phase
            10's; and after phase 19, phi3-mini-3.8b at full width cut
            to 1 layer (printed as ``reduced``): two ``make_train_step(...,
            ctx, grad_compression="int8")`` steps of 4 x 1024 tokens
            against two off-mesh steps from the same state, losses within
            rtol 1e-4, parameters within ``ROW_TOL["bf16"]`` row by row,
            2 flash launches a step.
21. dry run — after phase 20's process group is closed: the port's dry
            run (``launch/dryrun.py``) of eleven production cells at full
            width (``DRYRUN_CELLS``), each on a fake process group that
            ``run_cell`` opens and closes (phi3-mini-3.8b ``train_4k`` on
            (16, 16), moonshot-v1-16b-a3b ``decode_32k`` on (2, 16, 16),
            and on (16, 16) recurrentgemma-9b ``train_4k``, xlstm-1.3b
            ``decode_32k`` and llama-3.2-vision-11b ``decode_32k``, whose
            recurrent mixers or decode cross-attention run split over
            ``model``, qwen2.5-3b and deepseek-coder-33b ``train_4k``,
            phi3 and deepseek ``prefill_32k``, xlstm-1.3b ``train_4k``
            and whisper-large-v3 ``train_4k``), every record ``status:
            OK``, the train and prefill cells within one card and the
            reference's temporaries as ``dryrun_phase`` says, whisper's
            FLOPs at most the reference's, printing per device
            the counted FLOPs (beside ``dryrun_terms``: what still runs
            whole over ``model`` and what ran whole before the split),
            bytes, wire bytes, arguments, temporaries and the trace's
            seconds; then phase 17's
            step traced on fake tensors at one device: the counted bytes
            of the parameters and AdamW state equal those phase 17 held
            on the card, and the counted peak and FLOPs are printed
            beside phase 17's measured peak and its bound's products.
            Nothing of it runs on the card.
22. examples — every ``examples/<name>_torch.py`` but ``train_e2e``
            once, each as a subprocess (``examples_phase``), its exit
            code and seconds printed, a non-zero exit a failure;
            ``serve_paged_torch.py`` on the card with the spill tier,
            its flash, paged and both codec kernels' launches counted.

In phases 10-16 every self-attention over a prompt and every
cross-attention runs the flash kernel (one launch a layer), every decode
attention the paged kernel (one launch a layer and step); the counts are
checked.

Launch counts are zeroed just before each of phases 3-19 drives the path
and read just after (with an eviction pool, after its work has drained);
every bf16 prefill layer must run the tensor-core
flash kernel, every f32 one the SIMT kernel; the spill kernel launches
once for each ``deactivate`` that pages out (with an eviction pool, once
for each batch of the workers that pages out), and the restore kernel at
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

import gc
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
INTERNLM2, DEEPSEEK = "internlm2-1.8b", "deepseek-coder-33b"
MOONSHOT, QWEN3_MOE = "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"
WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-11b"
RGEMMA, XLSTM = "recurrentgemma-9b", "xlstm-1.3b"
# The model API's full-width phases 10-13 and 15-16: (label, arch, B
# prompts of T tokens, decode steps, config overrides, the cut printed as
# ``reduced``).  The kernel checks and timings at the model API's shapes
# are derived from these (``model_shapes``), so they are the shapes the
# phases serve.  recurrentgemma's first prompts pass its 2048-token window
# (the flash window masks, the ring is full from the prefill), its second
# leave the ring part-filled; xlstm's 256 tokens run the chunkwise mLSTM
# as 2 chunks of 128.
MODEL_RUNS = [
    ("moonshot", MOONSHOT, 4, 128, 16, {}, None),
    ("vlm", VISION, 2, 128, 16, {}, None),
    ("whisper", WHISPER, 2, 64, 16, {}, None),
    ("qwen3-moe", QWEN3_MOE, 4, 128, 8, {"n_layers": 4},
     "depth 94 -> 4 layers: 463 GB at full depth, 22.1 GB cut"),
    ("recurrentgemma", RGEMMA, 2, 2176, 16, {}, None),
    ("recurrentgemma-part", RGEMMA, 2, 128, 16, {}, None),
    ("xlstm", XLSTM, 4, 256, 16, {}, None),
]

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


# a profile that comes back empty or incomplete is taken again, up to this
# many times, before a time falls back to the CUDA events
PROFILE_RETRIES = 3


def profiled_ms(fn, iters: int, match: str | None = None) -> tuple:
    """(``device_ms``, or None where every profile failed, and the number
    of profiles taken): the first and up to ``PROFILE_RETRIES`` more."""
    for n in range(1, PROFILE_RETRIES + 2):
        ms = device_ms(fn, iters, match)
        if ms is not None:
            break
    return ms, n


def kernel_times(fn, plain, iters: int, match: str) -> dict:
    """``ms``/``plain_ms``: device time per call from the profiler, each
    column on its own taken again (``profiled_ms``) where its profile is
    empty or incomplete, and falling back to the CUDA-event time per call
    only where every profile was (``ms_from``/``plain_ms_from`` say which,
    ``ms_profiles``/``plain_ms_profiles`` how many profiles were taken);
    ``call_ms``/``plain_call_ms``: the event time per call.  The kernel's
    profile counts only its own kernel's events (``match``)."""
    call, plain_call = time_ms(fn, iters), time_ms(plain, iters // 4)
    dev, n_dev = profiled_ms(fn, iters, match)
    plain_dev, n_plain = profiled_ms(plain, iters // 4)
    return dict(ms=call if dev is None else dev,
                ms_from="events" if dev is None else "profiler",
                plain_ms=plain_call if plain_dev is None else plain_dev,
                plain_ms_from="events" if plain_dev is None else "profiler",
                ms_profiles=n_dev, plain_ms_profiles=n_plain,
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
        ("deepseek-full-nrep7", 2, 56, 8, 128, 16, 32, 9, [136, 129]),
        ("deepseek-smoke-hd8", 2, 7, 1, 8, 16, 16, 4, [64, 17]),
        ("recurrentgemma-ring", 2, 8, 1, 256, 16, 260, 128, [2048, 700]),
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


def model_shapes() -> tuple[list, list]:
    """The attention kernels' inputs in the ``MODEL_RUNS`` phases, from
    their configs: flash (label, B, T, S, H, Hkv, hd, causal, window) for
    each prompt's self-attention (causal; recurrentgemma's with its
    2048-token window), whisper's encoder and every cross-attention
    (non-causal, T != S); paged (label, B, S, H, Hkv, hd, lens) for decode
    self-attention in the ``s_max = T + steps`` cache, the lengths spread
    over the steps' pos + 1 (T + 1 .. s_max), and cross-attention over
    every frame or patch; recurrentgemma's ring always has S = W slots,
    with lengths min(pos + 1, W).  The page is the cache's
    (``layers.contiguous_page``): 16 for 144 slots and the 2048-slot ring,
    8 for 136, 4 for 1500 frames; n_rep 16 (qwen3-moe, recurrentgemma)
    runs as two rows of 8.  xlstm has no attention."""
    from repro_torch.configs import get_config
    flash, paged = [], []
    for label, arch, B, T, steps, _, _ in MODEL_RUNS:
        cfg = get_config(arch)
        if cfg.family == "ssm":
            continue
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        W = cfg.attn_window if cfg.family == "hybrid" else 0
        S = W or T + steps
        flash.append((f"{label}-self-T{T}" + (f"-w{W}" if W else ""), B, T,
                      T, *heads, True, W))
        paged.append((f"{label}-self-S{S}", B, S, *heads,
                      [min(T + 1 + (steps - 1) * b // max(B - 1, 1), S)
                       for b in range(B)]))
        n = {"encdec": cfg.enc_seq, "vlm": cfg.n_img_tokens}.get(cfg.family)
        if n is not None:
            if cfg.family == "encdec":
                flash.append((f"{label}-enc-{n}", B, n, n, *heads, False, 0))
            flash.append((f"{label}-cross-{T}x{n}", B, T, n, *heads, False,
                          0))
            paged.append((f"{label}-cross-{n}", B, n, *heads, [n] * B))
    return flash, paged


def contiguous_case(torch, rng, B, S, H, Hkv, hd, lens, dtype):
    """q (B, 1, H, hd) and a contiguous cache with poison past each
    length; the pages of ``layers.decode_pages``; and the plain version's
    inputs: the cache as a pool, the identity table, the lengths."""
    from repro_torch.models.layers import contiguous_page, decode_pages
    q = torch.tensor(rng.standard_normal((B, 1, H, hd)), dtype=dtype,
                     device="cuda")
    k = rng.standard_normal((B, S, Hkv, hd)).astype("float32")
    v = rng.standard_normal((B, S, Hkv, hd)).astype("float32")
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = 99.0, -99.0
    k, v = (torch.tensor(a, dtype=dtype, device="cuda") for a in (k, v))
    n_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pages = decode_pages(n_lens, S, H // Hkv)
    page = contiguous_page(S)
    table = torch.arange(B * S // page, dtype=torch.int32,
                         device="cuda").view(B, -1)
    plain = (q[:, 0], k.view(-1, page, Hkv, hd), v.view(-1, page, Hkv, hd),
             table, n_lens)
    return q, k, v, pages, plain


def check_paged_contiguous(torch, rng, results) -> None:
    """``layers.decode_attention`` (the model API's decode attention: one
    launch of the paged kernel over the cache viewed as pages, n_rep above
    8 split into rows) against the plain version at the full n_rep."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.models.layers import decode_attention
    worst, worst_row = (results["paged_attention"][k] for k in (
        "max_abs_err", "max_row_rel_err"))
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, B, S, H, Hkv, hd, lens in model_shapes()[1]:
            q, k, v, pages, plain = contiguous_case(torch, rng, B, S, H, Hkv,
                                                    hd, lens, dtype)
            before = _build.launch_counts().get("paged_attention", 0)
            got = decode_attention(q, k, v, pages)[:, 0]
            n = _build.launch_counts().get("paged_attention", 0) - before
            exp = paged_attention_plain(*plain)
            torch.cuda.synchronize()
            tag = f"paged_attention contiguous {label}/{dt}"
            check(n == 1, f"{tag}: {n} launches")
            check(got.dtype == dtype and got.shape == (B, H, hd),
                  f"{tag}: {got.dtype} {got.shape}")
            err = (got.float() - exp.float()).abs()
            row = row_rel_err(got, exp)
            check(bool((err <= TOL[dt] + TOL[dt] * exp.float().abs()).all())
                  and bool(torch.isfinite(got).all()),
                  f"{tag}: max err {err.max():.3g}")
            check(row <= ROW_TOL[dt], f"{tag}: row error {row:.3g}")
            worst, worst_row = max(worst, float(err.max())), max(worst_row,
                                                                 row)
            log(f"{tag} ok: page {pages.page}, {pages.split} row(s) a "
                f"sequence, n_rep {H // Hkv}, max abs err "
                f"{float(err.max()):.3g}, max row rel err {row:.3g}")
    results["paged_attention"].update(max_abs_err=worst,
                                      max_row_rel_err=worst_row)


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
    ("deepseek-page", 124, 4, 16, 1024, 124),
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
    ("internlm2-T128", 1, 128, 128, 16, 8, 128, True, 0, ("bf16",)),
    ("deepseek-T128-nrep7", 1, 128, 128, 56, 8, 128, True, 0, ("bf16",)),
    ("deepseek-smoke-hd8", 1, 128, 128, 7, 1, 8, True, 0, ("f32", "bf16")),
]


def flash_cases() -> list:
    """``FLASH_CASES``, the model API's prefill shapes (``model_shapes``):
    bf16, the served type, and the cross-attention (T != S) and head width
    256 (recurrentgemma, on the SIMT kernel) in f32 too; and the shape the
    train phase (``TRAIN``) gives the kernel in every layer, in bf16."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN["arch"])
    B, T = TRAIN["B"], TRAIN["T"]
    return FLASH_CASES + [
        (label, B, T, S, H, Hkv, hd, causal, window,
         ("bf16",) if T == S and hd <= 128 else ("f32", "bf16"))
        for label, B, T, S, H, Hkv, hd, causal, window in model_shapes()[0]
    ] + [(f"{cfg.name}-train", B, T, T, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
          True, cfg.attn_window, ("bf16",))]


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
    for label, B, T, S, H, Hkv, hd, causal, window, dts in flash_cases():
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
    # the plain version, against autograd through the plain version alone;
    # at hd 128 and at recurrentgemma's hd 256 with 16:1 heads and a window
    for shape, window in (((1, 128, 128, 16, 2, 128), 0),
                          ((1, 256, 256, 16, 1, 256), 128)):
        q, k, v = flash_case(torch, rng, *shape, torch.float32)
        dout = torch.randn_like(q)
        grads = []
        for fn in (ops.flash_attention, flash_attention_plain):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fn(*leaves, causal=True, window=window).backward(dout)
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        for name, got, exp in zip("qkv", *grads):
            err = (got - exp).abs()
            check(bool(torch.isfinite(got).all())
                  and bool((err <= 2e-5 + 2e-5 * exp.abs()).all()),
                  f"flash_attention d{name} {shape}: max err "
                  f"{float(err.max()):.3g}")
        log(f"flash_attention gradient (q, k, v) at {shape}, window "
            f"{window}, on the card equals the plain version's, finite")
    for name, err in worst.items():
        results[name] = {"max_abs_err": err,
                         "max_row_rel_err": worst_row[name]}


def check_paged_lse(torch, rng, results) -> None:
    """The paged kernel's per-row log-sum-exp (the mesh's S-sharded decode
    merges its shards by it) against the plain version's, at the serving
    shape and the model API's (moonshot's 144-slot cache viewed as 9
    pages, recurrentgemma's ring), each with a row of length 0: lse -inf
    and output 0; the output equals the launch without lse."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    cases = [  # (label, B, H, Hkv, hd, page, P, maxp, lens)
        ("serve-qwen", 4, 16, 2, 128, 16, 64, 16, [144, 0, 129, 1]),
        ("model-moonshot", 4, 16, 16, 128, 16, 36, 9, [144, 0, 73, 1]),
        ("model-ring", 2, 8, 1, 256, 16, 260, 128, [2048, 0]),
    ]
    worst = 0.0
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, B, H, Hkv, hd, page, P, maxp, lens in cases:
            args = paged_case(torch, rng, B, H, Hkv, hd, page, P, maxp, lens,
                              dtype)
            out, lse = paged_attention_cuda(*args, return_lse=True)
            exp, exp_lse = paged_attention_plain(*args, return_lse=True)
            plain_out = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            tag = f"paged_attention lse {label}/{dt}"
            empty = args[4] == 0
            check(bool(torch.equal(out, plain_out)), f"{tag}: the output "
                  f"with lse differs from the launch without")
            check(bool(torch.isneginf(lse[empty]).all())
                  and bool((out[empty] == 0).all()),
                  f"{tag}: a row of length 0 must give lse -inf, output 0")
            err = float((lse[~empty] - exp_lse[~empty]).abs().max())
            check(err <= 1e-4 + 1e-5 * float(exp_lse[~empty].abs().max()),
                  f"{tag}: lse max err {err:.3g}")
            row = row_rel_err(out, exp)
            check(row <= ROW_TOL[dt], f"{tag}: row error {row:.3g}")
            worst = max(worst, err)
            log(f"{tag} ok, lse max abs err {err:.3g}, output row rel err "
                f"{row:.3g}")
    results["paged_attention"]["max_lse_abs_err"] = worst


def check_flash_offset(torch, rng, results) -> None:
    """flash attention with ``q_offset`` (the mesh's query-sharded
    attention: a rank's rows start at rank * T / tp) at a
    deepseek-coder-33b shape (56:8 heads of 128, T = S = 512), the rows
    split 2 and 4 ways, causal and windowed: each part against the plain
    version at its offset, bf16 on the tensor-core kernel, f32 on the
    SIMT one."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    B, T, H, Hkv, hd = 1, 512, 56, 8, 128
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = flash_case(torch, rng, B, T, T, H, Hkv, hd, dtype)
        name = "flash_attention_tc" if dt == "bf16" else "flash_attention"
        for causal, window in ((True, 0), (True, 100)):
            for parts in (2, 4):
                n = T // parts
                for i in range(parts):
                    qi = q[:, i * n:(i + 1) * n].contiguous()
                    before = _build.launch_counts().get(
                        "flash_attention_tc", 0)
                    got = flash_attention_cuda(qi, k, v, causal=causal,
                                               window=window, q_offset=i * n)
                    tc = _build.launch_counts().get(
                        "flash_attention_tc", 0) - before
                    exp = flash_attention_plain(qi, k, v, causal=causal,
                                                window=window,
                                                q_offset=i * n)
                    torch.cuda.synchronize()
                    tag = (f"flash_attention q_offset {i * n} of {T} "
                           f"(window {window})/{dt}")
                    check(tc == (dt == "bf16"), f"{tag}: {tc} tensor-core "
                          f"launches")
                    err = (got.float() - exp.float()).abs()
                    ok = bool((err <= TOL[dt] + TOL[dt]
                               * exp.float().abs()).all())
                    row = row_rel_err(got, exp)
                    check(ok and row <= ROW_TOL[dt], f"{tag}: max err "
                          f"{float(err.max()):.3g}, row {row:.3g}")
                    r = results[name]
                    r["max_abs_err"] = max(r["max_abs_err"],
                                           float(err.max()))
                    r["max_row_rel_err"] = max(r["max_row_rel_err"], row)
                log(f"flash_attention q_offset {dt} on {name}: "
                    f"{parts} parts of {n} rows, window {window}, ok")
        del q, k, v


def library_ms(torch, fn, iters: int) -> tuple[float, str]:
    """Device time per call of a PyTorch call, or the CUDA-event time
    where the profiler could not give it; and which of the two."""
    dev = device_ms(fn, iters)
    return (dev, "profiler") if dev is not None else (time_ms(fn, iters),
                                                      "events")


def library_attention_ms(torch, q, k, v, iters: int, causal: bool = True,
                         window: int = 0, lens=None) -> tuple:
    """``library_ms`` of an attention kernel: one call of PyTorch's fused
    attention on the same inputs (heads moved to dim 1 as it wants them,
    GQA): flash attention's, causal or not, a window as a boolean mask; or,
    with ``lens`` (B,), decode attention's over a contiguous cache, q (B,
    1, H, hd), row b's keys 0..lens[b]-1 as a mask.  Timed here only: the
    port never calls it.  Returns (ms, where ms came from, the output of
    one call)."""
    import torch.nn.functional as F
    mask = None
    if lens is not None:
        mask = (torch.arange(k.shape[1], device=q.device)[None, :]
                < lens[:, None])[:, None, None, :]        # (B, 1, 1, S)
        causal = False
    elif window:
        qp = torch.arange(q.shape[1], device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (kp <= qp) & (qp - kp < window)

    def fn():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
    return (*library_ms(torch, fn, iters), fn().transpose(1, 2))


def flash_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the mask keeps: the work this input needs."""
    import numpy as np
    qp = np.arange(T)
    hi = np.minimum(qp + 1, S) if causal else np.full(T, S)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(T, int)
    return int(np.maximum(hi - lo, 0).sum())


def time_flash(torch, rng, label, B, T, H, Hkv, hd, iters,
               dtype: str = "bf16", S: int | None = None,
               causal: bool = True, window: int = 0) -> tuple[str, dict]:
    """The flash kernel of the wrapper's route (bf16 here: tensor cores;
    f32: SIMT), its plain version and the library call at one prefill
    shape (S = T unless given; causal unless not; a window if given),
    beside the bound; with the kernel's name."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_route)
    S = T if S is None else S
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v = flash_case(torch, rng, B, T, S, H, Hkv, hd, tdt)
    n_bytes = q.element_size() * (2 * B * T * H * hd + 2 * B * S * Hkv * hd)
    n_ops = 4 * hd * H * B * flash_pairs(T, S, causal, window)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S if dtype == "bf16"
                       else F32_OPS_PER_S)
    lib_ms, lib_from, _ = library_attention_ms(torch, q, k, v, iters, causal,
                                               window)
    name = "flash_attention_tc" if flash_route(tdt, hd, S) == "tc" \
        else "flash_attention"
    r = dict(kernel_times(
        lambda: flash_attention_cuda(q, k, v, causal=causal, window=window),
        lambda: flash_attention_plain(q, k, v, causal=causal, window=window),
        iters, f"{name}_kernel"),
             label=label, shape=[B, T, H, Hkv, hd], S=S, causal=causal,
             window=window, dtype=dtype, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, library_ms_from=lib_from)
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
               label=label, shape=[B, H, Hkv, hd, page, maxp, list(lens)],
               dtype="bf16", bound_ms=b_ms, bound_by=b_by)
    log(f"time paged_attention {label}: kernel {out['ms']:.5f} ms "
        f"({out['ms_from']}), plain {out['plain_ms']:.5f} ms "
        f"({out['plain_ms_from']}); per call: kernel {out['call_ms']:.5f} "
        f"ms; bound {b_ms:.6f} ms ({b_by})")
    return out


def dispatch_cost(torch, rng, calls: int = 100, rounds: int = 7) -> dict:
    """The host's microseconds a call of the paged kernel through its
    ``torch.library`` op (``ops.paged_attention``, as the decode path calls
    it) and through its wrapper alone (``paged_attention_cuda``), at
    qwen2.5-3b's serve shape (4 x 144 tokens): ``calls`` calls issued back
    to back with no synchronisation (fewer launches than the device's
    queue holds, so the host never waits for it), the least of ``rounds``
    rounds, the two in turn."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    args = paged_case(torch, rng, 4, 16, 2, 128, 16, 64, 16, [144] * 4,
                      torch.bfloat16)
    fns = {"op": lambda: ops.paged_attention(*args),
           "wrapper": lambda: paged_attention_cuda(*args)}
    best = {k: math.inf for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            best[k] = min(best[k], (time.perf_counter() - t) / calls * 1e6)
            torch.cuda.synchronize()
    out = {"op_us": best["op"], "wrapper_us": best["wrapper"],
           "dispatch_us": best["op"] - best["wrapper"], "calls": calls,
           "rounds": rounds}
    log(f"paged attention host cost a call (qwen-serve, least of {rounds} "
        f"rounds of {calls}): op {out['op_us']:.2f} us, wrapper alone "
        f"{out['wrapper_us']:.2f} us, the dispatcher "
        f"{out['dispatch_us']:.2f} us")
    return out


# ------------------------------------------ phase 2: the sLSTM's operator
# xlstm-1.3b's recurrence at the width and prompt of its serve phase
SLSTM_SHAPE = dict(B=4, T=256, H=4, dh=512)
# the op's gradients against autograd through the plain loop: the largest
# difference of each gradient over its largest magnitude (the two sum the
# same terms in other orders, over 256 steps of the recurrence)
SLSTM_GRAD_TOL = 1e-4


def plain_slstm_scan(torch, z_in, o_in, i_in, f_in, p, s):
    """The sLSTM's recurrence as the port ran it before it became one
    operator (``models/xlstm.py`` ``slstm_scan`` then): a loop of eager
    ops, h kept in a list and stacked; its gradient is autograd's."""
    import torch.nn.functional as F
    T, dh = z_in.shape[1], z_in.shape[-1]
    rec = torch.cat([p["rz"].float(), p["ri"], p["rf"]], dim=-1)
    c, n, h, m = s["c"], s["n"], s["h"], s["m"]
    hs = []
    for t in range(T):
        hr = torch.einsum("bhd,hde->bhe", h, rec)
        z = torch.tanh(z_in[:, t] + hr[..., :dh])
        ipre = i_in[:, t] + hr[..., dh]
        fpre = f_in[:, t] + hr[..., dh + 1]
        logf = F.logsigmoid(fpre)
        m_new = torch.maximum(logf + m, ipre)
        i_g = torch.exp(ipre - m_new)[..., None]
        f_g = torch.exp(logf + m - m_new)[..., None]
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = torch.sigmoid(o_in[:, t]) * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "h": h, "m": m}


# the mLSTM's chunk loop at xlstm-1.3b's width and serve prompt, in the
# model's chunks of 128
MLSTM_SHAPE = dict(B=4, T=256, H=4, dh=512, chunk=128)
# the ops' gradients against autograd through the plain loop, as for the
# sLSTM's op
MLSTM_GRAD_TOL = 1e-4


def plain_mlstm_chunkwise(torch, q, k, v, ipre, fpre, s0, *, chunk: int,
                          ks=slice(None), psum=None):
    """The mLSTM's chunkwise form as the port ran it before it became two
    operators (``models/xlstm.py`` ``mlstm_chunkwise`` then): a Python
    loop of eager ops over the chunks, q, k and v cast to f32 whole, h
    kept in a list and stacked; its gradient is autograd's."""
    import torch.nn.functional as F
    B, T, H, dh = q.shape
    L = min(chunk, T)
    nc = T // L

    def to_chunks(x):
        x = x.float().reshape(B, nc, L, *x.shape[2:])
        if x.dim() == 5:
            return x.permute(1, 0, 3, 2, 4)
        return x.permute(1, 0, 3, 2)

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    ic, fc = to_chunks(ipre), to_chunks(fpre)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    C_in, n_in, m_in = s0["C"], s0["n"], s0["m"]
    hs = []
    for c in range(nc):
        qb, kb, vb, ib, fb = qc[c], kc[c], vc[c], ic[c], fc[c]
        F_ = torch.cumsum(F.logsigmoid(fb), dim=-1)
        g = ib - F_
        M = torch.maximum(m_in[..., None], torch.cummax(g, dim=-1).values)
        inter_w = torch.exp(m_in[..., None] - M)
        D = torch.exp(g[..., None, :] - M[..., :, None])
        D = torch.where(causal, D, 0.0)
        qk, kk = qb[..., ks], kb[..., ks]
        n_j = inter_w[..., None] * n_in[:, :, None, :] + \
            torch.einsum("bhls,bhsd->bhld", D, kk)
        scores = torch.einsum("bhld,bhsd->bhls", qk, kk)
        dot = torch.einsum("bhld,bhld->bhl", qk, n_j)
        if psum is not None:
            scores, dot = psum(scores, dot)
        intra = torch.einsum("bhls,bhsd->bhld", scores * D, vb)
        h_num = inter_w[..., None] * torch.einsum(
            "bhde,bhle->bhld", C_in, qb) + intra
        m_j = F_ + M
        denom = torch.maximum(dot.abs(), torch.exp(-m_j))
        hs.append(h_num / denom[..., None])
        M_L, F_L = M[..., -1], F_[..., -1]
        w = torch.exp(g - M_L[..., None])
        decay = torch.exp(m_in - M_L)
        C_in = decay[..., None, None] * C_in + \
            torch.einsum("bhs,bhsd,bhse->bhde", w, vb, kb)
        n_in = decay[..., None] * n_in + torch.einsum("bhs,bhsd->bhd", w, kk)
        m_in = F_L + M_L
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, T, H, -1)
    return h, {"C": C_in, "n": n_in, "m": m_in}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def check_slstm_op(torch, rng) -> dict:
    """``repro_torch::slstm_scan`` (``models/xlstm.py`` ``slstm_scan``) on
    the card at ``SLSTM_SHAPE`` from a zero state, inputs drawn from the
    seed at the model's scales: its output and final state equal the plain
    loop's (``plain_slstm_scan``) bit for bit, and the gradients of z_in,
    o_in, i_in, f_in, rz, ri and rf through ``slstm_scan_backward`` equal
    autograd's through the loop within ``SLSTM_GRAD_TOL``.  Both are
    timed (``op_times``)."""
    from repro_torch.models import slstm_op, xlstm
    B, T, H, dh = (SLSTM_SHAPE[k] for k in ("B", "T", "H", "dh"))

    def rand(*shape, scale=1.0, shift=0.0):
        x = rng.standard_normal(shape).astype("float32") * scale + shift
        return torch.as_tensor(x, device="cuda")

    sr = 1.0 / math.sqrt(dh)
    leaves = [rand(B, T, H, dh), rand(B, T, H, dh), rand(B, T, H),
              rand(B, T, H, shift=3.0), rand(H, dh, dh, scale=sr),
              rand(H, dh, 1, scale=sr), rand(H, dh, 1, scale=sr)]
    zeros = torch.zeros((B, H, dh), device="cuda")
    state = {"c": zeros, "n": zeros, "h": zeros,
             "m": torch.full((B, H), -1e30, device="cuda")}
    cot = rand(B, T, H, dh)

    def op(*xs):
        return xlstm.slstm_scan(*xs[:4], dict(zip(("rz", "ri", "rf"),
                                                  xs[4:])), state)

    def plain(*xs):
        return plain_slstm_scan(torch, *xs[:4], dict(zip(
            ("rz", "ri", "rf"), xs[4:])), state)

    def grads(fn):
        xs = [x.detach().requires_grad_() for x in leaves]
        hs, _ = fn(*xs)
        return torch.autograd.grad((hs * cot).sum(), xs)

    tag = f"slstm op (B {B}, T {T}, H {H}, dh {dh}, f32)"
    calls0 = dict(slstm_op.CALLS)
    with torch.no_grad():
        got_h, got_s = op(*leaves)
        exp_h, exp_s = plain(*leaves)
    equal = torch.equal(got_h, exp_h) and all(
        torch.equal(got_s[k], exp_s[k]) for k in exp_s)
    check(equal, f"{tag}: the op's forward differs from the plain loop's "
          f"(max abs {float((got_h - exp_h).abs().max())})")
    g_op, g_plain = grads(op), grads(plain)
    calls = {k: slstm_op.CALLS[k] - calls0[k] for k in calls0}
    check(calls == {"slstm_scan": 2, "slstm_scan_backward": 1},
          f"{tag}: op calls {calls}")
    names = ("z_in", "o_in", "i_in", "f_in", "rz", "ri", "rf")
    rel = {n: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
           for n, a, b in zip(names, g_op, g_plain)}
    check(max(rel.values()) <= SLSTM_GRAD_TOL, f"{tag}: gradients against "
          f"autograd through the loop {rel}, past {SLSTM_GRAD_TOL}")
    del got_h, got_s, exp_h, exp_s, g_op, g_plain

    card = card_line()
    log(f"{tag} on {card}: forward equal to the plain loop bit for bit; "
        f"gradients within {max(rel.values()):.3g} of autograd's through "
        f"the loop (tolerance {SLSTM_GRAD_TOL})")
    return {"shape": SLSTM_SHAPE, "forward_bit_for_bit": equal,
            "grad_rel_err": rel, "grad_tol": SLSTM_GRAD_TOL,
            "times": op_times(torch, tag, lambda: op(*leaves),
                              lambda: plain(*leaves), lambda: grads(op),
                              lambda: grads(plain)),
            "card": card}


def op_times(torch, tag: str, op, plain, op_grads, plain_grads) -> dict:
    """Event ms a call of the op's forward, the plain loop's, and each
    with its backward (the loops are host-bound: tens of launches a step
    or chunk), and the two forwards' device ms from one profile of one
    call each (profiles of the backwards' launches took minutes to read
    back)."""
    def forward(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    times = {}
    for key, fn, profiled in (
            ("op_forward", forward(op), True),
            ("plain_forward", forward(plain), True),
            ("op_forward_backward", op_grads, False),
            ("plain_forward_backward", plain_grads, False)):
        times[key] = {"event_ms": time_ms(fn, 3, warmup=1),
                      "device_ms": device_ms(fn, 1) if profiled else None}
        dev = "not measured" if times[key]["device_ms"] is None else \
            f"{times[key]['device_ms']:.3f} ms (profiler)"
        log(f"{tag} {key}: {times[key]['event_ms']:.3f} ms a call "
            f"(events), device busy {dev}")
    return times


def check_mlstm_op(torch, rng) -> dict:
    """``repro_torch::mlstm_scores`` and ``mlstm_hidden`` (through
    ``models/xlstm.py`` ``mlstm_chunkwise``) on the card at
    ``MLSTM_SHAPE``, inputs drawn from the seed at the model's scales: from
    a zero state in f32 and in bf16 (q, k and v in the model dtype), and
    from a carried state in f32, the output and final state equal the plain
    loop's (``plain_mlstm_chunkwise``) bit for bit; the gradients of q, k,
    v, ipre and fpre through the ops' backwards, from a cotangent of h
    alone from the zero state (a train step's) and of h and the final
    state from the carried one (that state's gradients too), equal
    autograd's through the loop within ``MLSTM_GRAD_TOL``.  Both are timed
    (``op_times``)."""
    from repro_torch.models import mlstm_op, xlstm
    B, T, H, dh, L = (MLSTM_SHAPE[k] for k in ("B", "T", "H", "dh",
                                                 "chunk"))

    def rand(*shape, scale=1.0, shift=0.0):
        x = rng.standard_normal(shape).astype("float32") * scale + shift
        return torch.as_tensor(x, device="cuda")

    # q and k carry the model's 1 / sqrt(dh); the forget gates start open
    sq = 1.0 / math.sqrt(dh)
    leaves = [rand(B, T, H, dh, scale=sq), rand(B, T, H, dh, scale=sq),
              rand(B, T, H, dh), rand(B, T, H), rand(B, T, H, shift=3.0)]
    zero = {"C": torch.zeros((B, H, dh, dh), device="cuda"),
            "n": torch.zeros((B, H, dh), device="cuda"),
            "m": torch.full((B, H), -1e30, device="cuda")}
    carried = {"C": rand(B, H, dh, dh, scale=0.1),
               "n": rand(B, H, dh, scale=0.1), "m": rand(B, H)}
    cot = {"h": rand(B, T, H, dh), "C": rand(B, H, dh, dh),
           "n": rand(B, H, dh), "m": rand(B, H)}

    def op(*xs, state=zero):
        return xlstm.mlstm_chunkwise(*xs, state, chunk=L)

    def plain(*xs, state=zero):
        return plain_mlstm_chunkwise(torch, *xs, state, chunk=L)

    def grads(fn, state=None):
        xs = [x.detach().requires_grad_() for x in leaves]
        if state is None:
            h, _ = fn(*xs)
            return torch.autograd.grad((h * cot["h"]).sum(), xs)
        st = {k: t.detach().requires_grad_() for k, t in state.items()}
        h, fin = fn(*xs, state=st)
        loss = (h * cot["h"]).sum() + sum((fin[k] * cot[k]).sum()
                                          for k in fin)
        return torch.autograd.grad(loss, xs + list(st.values()))

    tag = f"mlstm ops (B {B}, T {T}, H {H}, dh {dh}, chunks of {L})"
    calls0 = dict(mlstm_op.CALLS)
    equal = {}
    with torch.no_grad():
        for key, xs, state in (
                ("f32", leaves, zero),
                ("bf16", [x.bfloat16() for x in leaves[:3]] + leaves[3:],
                 zero),
                ("f32_carried", leaves, carried)):
            got_h, got_s = op(*xs, state=state)
            exp_h, exp_s = plain(*xs, state=state)
            equal[key] = torch.equal(got_h, exp_h) and all(
                torch.equal(got_s[k], exp_s[k]) for k in exp_s)
            check(equal[key], f"{tag}, {key}: the ops' forward differs from "
                  f"the plain loop's (h max abs "
                  f"{float((got_h - exp_h).abs().max())})")
    names = ("q", "k", "v", "ipre", "fpre", "C", "n", "m")
    rel = {}
    for key, state in (("h_only", None), ("carried", carried)):
        g_op, g_plain = grads(op, state), grads(plain, state)
        rel[key] = {n: float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30))
                    for n, a, b in zip(names, g_op, g_plain)}
        check(max(rel[key].values()) <= MLSTM_GRAD_TOL, f"{tag}, {key}: "
              f"gradients against autograd through the loop {rel[key]}, "
              f"past {MLSTM_GRAD_TOL}")
    calls = {k: mlstm_op.CALLS[k] - calls0[k] for k in calls0}
    check(calls == {"mlstm_scores": 5, "mlstm_hidden": 5,
                    "mlstm_scores_backward": 2, "mlstm_hidden_backward": 2},
          f"{tag}: op calls {calls}")
    del g_op, g_plain, got_h, got_s, exp_h, exp_s
    card = card_line()
    log(f"{tag} on {card}: forward equal to the plain loop bit for bit "
        f"({', '.join(equal)}); gradients within "
        f"{max(max(r.values()) for r in rel.values()):.3g} of autograd's "
        f"through the loop (tolerance {MLSTM_GRAD_TOL})")
    return {"shape": MLSTM_SHAPE, "forward_bit_for_bit": equal,
            "grad_rel_err": rel, "grad_tol": MLSTM_GRAD_TOL,
            "times": op_times(torch, tag, lambda: op(*leaves),
                              lambda: plain(*leaves), lambda: grads(op),
                              lambda: grads(plain)),
            "card": card}


def time_paged_contiguous(torch, rng, label, B, S, H, Hkv, hd, lens,
                          iters) -> dict:
    """The model API's decode attention at one bf16 shape: the kernel on
    the inputs ``layers.decode_attention`` gives it (a contiguous cache
    viewed as pages; n_rep above 8 as rows of 8) and the plain version at
    the full n_rep, beside the bound of ``time_paged``; and, as
    ``library_ms``, PyTorch's fused attention over the contiguous cache
    with each row's length as a mask and GQA, which computes the same
    function (checked against the plain version)."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    from repro_torch.models.layers import paged_view
    q, k, v, pages, plain = contiguous_case(torch, rng, B, S, H, Hkv, hd,
                                            lens, torch.bfloat16)
    lib_ms, lib_from, got = library_attention_ms(torch, q, k, v, iters,
                                                 lens=plain[4])
    exp = paged_attention_plain(*plain)
    check(bool((got[:, 0].float() - exp.float()).abs().le(
        TOL["bf16"] + TOL["bf16"] * exp.float().abs()).all()),
        f"paged_attention {label}: the library call computes another "
        f"function")
    # the kernel on the inputs decode_attention gives it (n_rep 16: two
    # rows of 8 a sequence)
    args = (*paged_view(q, k, v, pages), pages.table, pages.lens)
    n_pages = sum(math.ceil(n / pages.page) for n in lens)
    n_bytes = (2 * B * H * hd * 2 + n_pages * pages.page * Hkv * hd * 2 * 2
               + n_pages * 4 + B * 4)
    n_ops = sum(4 * H * n * hd + 3 * H * n for n in lens)
    b_ms, b_by = bound(n_bytes, n_ops)
    out = dict(kernel_times(lambda: paged_attention_cuda(*args),
                            lambda: paged_attention_plain(*plain), iters,
                            "paged_attention"),
               label=label, shape=[B, H, Hkv, hd, pages.page, S, list(lens)],
               rows_per_sequence=pages.split, dtype="bf16", bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, library_ms_from=lib_from)
    log(f"time paged_attention {label} (contiguous, page {pages.page}, "
        f"{pages.split} row(s) a sequence): kernel {out['ms']:.5f} ms "
        f"({out['ms_from']}), plain {out['plain_ms']:.5f} ms, library "
        f"{lib_ms:.5f} ms ({lib_from}); per call {out['call_ms']:.5f} ms; "
        f"bound {b_ms:.6f} ms ({b_by})")
    return out


# (label, S, P, page, F, n) of the timed codec launches in bf16: one unit;
# a page of qwen2.5-3b and of phi3-mini-3.8b; a 144-token sequence of
# each (9 pages: a serve phase's page-out and page-in, the first the
# kernels line's numbers); the long-prompt phase's 1000- and 4000-token
# sequences (63 and 251 pages); a 160-token internlm2-1.8b sequence (a
# pool batch holds at most 8 of its pages) and a 144-token
# deepseek-coder-33b one.
CODEC_TIMED = [
    ("qwen-serve-9pages", 72, 64, 16, 256, 72 * 9),
    ("n1", 1, 64, 16, 256, 1),
    ("qwen-page", 72, 64, 16, 256, 72),
    ("phi3-page", 64, 20, 16, 3072, 64),
    ("phi3-serve-9pages", 64, 20, 16, 3072, 64 * 9),
    ("qwen-63pages", 72, 128, 16, 256, 72 * 63),
    ("qwen-251pages", 72, 512, 16, 256, 72 * 251),
    ("internlm2-10pages", 48, 20, 16, 1024, 48 * 10),
    ("deepseek-serve-9pages", 124, 20, 16, 1024, 124 * 9),
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
    phi3-mini-3.8b's, internlm2-1.8b's and deepseek-coder-33b's (n_rep 7)
    prompts (``at_shapes``), and on the SIMT kernel at qwen's 128 tokens
    in f32, the input its route takes; decode attention over 4 sequences
    of 144 tokens (the last step; the row's numbers), and at
    phi3-mini-3.8b's width, the long-prompt shape (2 sequences of 1004
    and 4004 tokens over a 256-wide table), internlm2-1.8b's (4 x 160)
    and deepseek-coder-33b's (2 x 136, n_rep 7) in ``at_shapes``, and
    the model API's (``model_shapes``, every slot valid: the last
    decode step), its flash shapes too (each phase's prompt, whisper's
    encoder, the cross-attention); the codec at
    ``CODEC_TIMED``'s shapes, a qwen2.5-3b serve page-out (9 pages, 648
    units) the row's numbers."""
    keys = ("ms", "plain_ms", "ms_from", "plain_ms_from", "ms_profiles",
            "plain_ms_profiles", "call_ms", "plain_call_ms", "bound_ms",
            "bound_by")
    flash = [time_flash(torch, rng, "qwen-T128", 1, 128, 16, 2, 128, 200),
             time_flash(torch, rng, "qwen-T1000", 1, 1000, 16, 2, 128, 50),
             time_flash(torch, rng, "qwen-T4000", 1, 4000, 16, 2, 128, 20),
             time_flash(torch, rng, "phi3-T128", 1, 128, 32, 32, 96, 200),
             time_flash(torch, rng, "internlm2-T128", 1, 128, 16, 8, 128,
                        200),
             time_flash(torch, rng, "deepseek-T128", 1, 128, 56, 8, 128, 200),
             time_flash(torch, rng, "qwen-T128", 1, 128, 16, 2, 128, 200,
                        dtype="f32"),
             time_flash(torch, rng, "recurrentgemma-T2176-w2048", 2, 2176,
                        16, 1, 256, 8, dtype="f32", window=2048)]
    model_flash, model_paged = model_shapes()
    flash += [time_flash(torch, rng, label, B_, T, H_, Hkv_, hd_,
                         50 if T >= 1000 else 100, S=S, causal=causal,
                         window=window)
              for label, B_, T, S, H_, Hkv_, hd_, causal, window
              in model_flash]
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
                         256, [1004, 4004], 50),
              time_paged(torch, rng, "internlm2-serve", B, 16, 8, 128, page,
                         P, maxp, [160] * B, 200),
              time_paged(torch, rng, "deepseek-serve", 2, 56, 8, 128, page,
                         32, 9, [136] * 2, 200)]
    shapes += [time_paged_contiguous(torch, rng, label, B_, S, H_, Hkv_, hd_,
                                     [S] * B_, 200)
               for label, B_, S, H_, Hkv_, hd_, _ in model_paged]
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


def check_path_counts(tag, cfg, spent, counts, m, transit,
                      pool_batches=None) -> None:
    """Every launch on the path went through its kernel, once per layer,
    and every prefill layer through the flash kernel of its route; the
    codec launched once for each deactivate that paged out (with an
    eviction pool, ``pool_batches`` — the (items, paged out, seconds) of
    each batch the workers ran — once for each batch that paged out, and
    never on the caller's thread), at most once for each volume record an
    activate fetched plus once for each activate, and, where nothing
    bypassed and no record was fetched, once for each activate that paged
    in; and the cache counted the reference's 2 passes per layer per
    page.  A page that bypassed to the host tier comes back in without the
    codec, so the page-in counts are exact only where nothing bypassed."""
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
    if pool_batches is None:
        page_outs, pages_out = out["calls_moving_pages"], out["pages"]
    else:
        page_outs = sum(n > 0 for _, n, _ in pool_batches)
        pages_out = sum(n for _, n, _ in pool_batches)
    check(counts.get("gather_quantize_crc", 0) == page_outs
          and pages_out == m.get("pages_out", 0),
          f"{tag}: {counts.get('gather_quantize_crc', 0)} spill launches for "
          f"{page_outs} page-outs")
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


def serve_full(torch, np, cfg, params, profile: bool, n_req: int = 4,
               new_tokens: int = 16, n_pages: int = 64) -> dict:
    """``n_req`` requests x (128 prompt + ``new_tokens`` new tokens) at
    full width and batch ``n_req``, one of them suspended and resumed,
    then a fresh prompt's logits; with ``profile`` also the profiled
    decode window."""
    from repro_torch.serve import PagedCacheConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    cache_cfg = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        page_size=16, n_pages=n_pages, max_pages_per_seq=16, dtype=cfg.dtype)
    eng = ServeEngine(cfg, params, cache_cfg=cache_cfg, max_batch=n_req,
                      device="cuda")
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(2, cfg.vocab, size=128).tolist(),
                       max_new_tokens=new_tokens) for _ in range(n_req)]
    spent = timed_engine(torch, eng)
    calls = timed_transit(torch, eng)
    e2e, ticks, counts = run_counted(torch, eng, suspend_at=3)
    untime(eng)
    untime_transit(eng)
    m = dict(eng.metrics.count)
    transit = transit_summary(calls)
    tag = f"serve {cfg.name}"

    check(all(r.done and len(r.out_tokens) == new_tokens for r in reqs),
          f"{tag}: not every request finished with {new_tokens} tokens")
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
    log(f"{tag}: {n_req} requests x {new_tokens} tokens in {e2e:.2f} s end "
        f"to end "
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


PAGER_CALLS = ("spill", "fetch", "prefetch")


def timed_calls(obj, names) -> dict:
    """Wrap these methods of ``obj`` with host clocks: the seconds of each
    call, by name (restore with ``untime_calls``).  A pager's prefetch
    first waits for its records' spill writes to land."""
    spent = {name: [] for name in names}
    for name, log_ in spent.items():
        def timed(*args, _fn=getattr(obj, name), _log=log_):
            t = time.perf_counter()
            out = _fn(*args)
            _log.append(time.perf_counter() - t)
            return out
        setattr(obj, name, timed)
    return spent


def untime_calls(obj, names) -> None:
    for name in names:
        delattr(obj, name)


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
            io = timed_calls(pager, PAGER_CALLS) if pager else None
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
                untime_calls(pager, PAGER_CALLS)
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


# the pool phase's volumes: the eviction pool of the first (4 workers,
# batches of at most 8 items) pages the KV cache out; the second holds
# the request log and runs the control plane's ticks
POOL_VOLUME = dict(n_lbas=1 << 14, n_shards=2, cache_bytes=1 << 22)


def timed_evictions(cache) -> list:
    """Wrap the pool workers' page-out of a batch (run under the cache's
    lock): per batch handed to a hook, (items, items paged out, seconds
    the worker held the lock for them).  Restore with ``del
    cache._evict_items_locked``."""
    batches = []
    page_out = cache._evict_items_locked

    def timed(items):
        t = time.perf_counter()
        n = page_out(items)
        batches.append((len(items), n, time.perf_counter() - t))
        return n
    cache._evict_items_locked = timed
    return batches


def suspending(eng, every: int) -> None:
    """Make ``eng.step`` suspend the first running request after every
    ``every``-th tick, as ``run_counted`` does, so that ``run()`` drives
    the same preemptions (restore with ``del eng.step``)."""
    step, ticks = eng.step, [0]

    def stepped():
        n = step()
        ticks[0] += 1
        if eng.running and ticks[0] % every == 0:
            eng.suspend(eng.running[0])
        return n
    eng.step = stepped


def read_log(vol, n_records: int) -> list:
    """The first ``n_records`` records of a request log at lba 0."""
    out, lba = [], 0
    for _ in range(n_records):
        raw = bytes(vol.read(lba))
        n = int.from_bytes(raw[:4], "little")
        buf, blocks = raw[4:], 1
        while len(buf) < n:
            buf += bytes(vol.read(lba + blocks))
            blocks += 1
        out.append(json.loads(buf[:n].decode()))
        lba += blocks
    return out


def pool_full(torch, np, cfg, params, sync_ref: dict) -> tuple[dict, dict]:
    """8 requests x (128 prompt + 32 new tokens) at full width, batch 4,
    the first running request suspended every 6 ticks, twice.  Leg A: the
    engine's model over a cache whose page-outs run on the eviction pool of
    a volume (the engine itself takes no pool, as the reference's takes
    none), driven in ``ServeEngine.step``'s order.  Leg B: an engine with
    no pool, a request log on a second volume with the stock autotuner
    attached, ``autotune_every=4``, driven by ``run()`` with the same
    suspends.  The greedy tokens must be equal; nothing may bypass, be
    freed twice or be left behind; the log must read back record for
    record.  ``sync_ref``: the qwen serve phase's synchronous page-outs."""
    from repro_torch.kernels import _build
    from repro_torch.serve import (AsyncRequestLog, PagedCacheConfig,
                                   PagedKVCache, PagedLM, ServeEngine)
    from repro_torch.volume.volume import make_volume

    tag = f"pool {cfg.name}"
    cache_cfg = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        page_size=16, n_pages=64, max_pages_per_seq=16, dtype=cfg.dtype)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab, size=128).tolist()
               for _ in range(8)]
    legs = {}
    vol, vol2 = make_volume(**POOL_VOLUME), None
    try:
        vol2 = make_volume(**POOL_VOLUME)
        for leg in ("A", "B"):
            torch.cuda.reset_peak_memory_stats()
            log_ = io = None
            if leg == "A":
                eng = ServeEngine(cfg, params, cache_cfg=cache_cfg,
                                  max_batch=4, device="cuda")
                eng.cache = PagedKVCache(cache_cfg, metrics=eng.metrics,
                                         evict_pool=vol.pool, device="cuda")
                eng.lm = PagedLM(cfg, params, eng.cache)
                drains = timed_calls(eng.cache, ("drain_evictions",))
                batches = timed_evictions(eng.cache)
            else:
                vol2.attach_autotuner()
                log_ = AsyncRequestLog(vol2)
                io = timed_calls(log_, ("append", "drain"))
                eng = ServeEngine(cfg, params, cache_cfg=cache_cfg,
                                  max_batch=4, request_log=log_,
                                  autotune_every=4, device="cuda")
            reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
            spent = timed_engine(torch, eng)
            calls = timed_transit(torch, eng)
            if leg == "A":
                e2e, ticks, _ = run_counted(torch, eng, suspend_every=6)
                untime_calls(eng.cache, ("drain_evictions",))
                # retired requests' page-outs may still be queued
                check(eng.cache.drain_evictions(), f"{tag}: drain")
                del eng.cache._evict_items_locked
            else:
                suspending(eng, 6)
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                eng.run()
                torch.cuda.synchronize()
                e2e, ticks = time.perf_counter() - t0, None
                del eng.step
                untime_calls(log_, ("append", "drain"))
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            untime(eng)
            untime_transit(eng)
            m = dict(eng.metrics.count)
            transit = transit_summary(calls)
            t = f"{tag} (leg {leg})"
            check(all(r.done and len(r.out_tokens) == 32 for r in reqs),
                  f"{t}: not every request finished")
            check(spent["finite"], f"{t}: logits not finite")
            check(m.get("bypass_pages", 0) == 0 and
                  m.get("transit_crc_errors", 0) == 0,
                  f"{t}: bypass or crc errors {m}")
            free = eng.cache._free
            check(len(free) == len(set(free)) == cache_cfg.n_pages
                  and len(eng.cache.host) == 0,
                  f"{t}: pages freed twice, or pages or host entries left")
            for name in path_kernels(cfg):
                check(kernel_launches(counts).get(name, 0) > 0,
                      f"{t}: {name} never launched")
            check_path_counts(t, cfg, spent, counts, m, transit,
                              pool_batches=batches if leg == "A" else None)
            run = {"e2e_s": e2e, "launches": counts, "transit": transit,
                   "tokens": [r.out_tokens for r in reqs],
                   "prefill_s": sum(spent["prefill_s"]),
                   "decode_s": spent["decode_s"],
                   "decode_tok_s": spent["decode_tokens"] / spent["decode_s"],
                   "suspends": m.get("suspends", 0),
                   "counters": {k: m.get(k, 0) for k in (
                       *COUNTERS, "evict_batches", "evict_skipped",
                       "request_log_failures", "autotune_moves")},
                   "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            if leg == "A":
                check(m.get("evict_batches", 0) > 0, f"{t}: no batch")
                sizes = [n for n, _, _ in batches]
                run.update(ticks=ticks, deactivate_s=[
                               x for x, _, _ in calls["deactivate"]],
                           drain_wait_s=drains["drain_evictions"],
                           batches=len(batches),
                           batch_mean=sum(sizes) / len(sizes),
                           batch_max=max(sizes),
                           lock_held_max_s=max(x for _, _, x in batches),
                           batch_items_paged_s=batches)
            else:
                check(m.get("request_log_failures", 0) == 0
                      and log_.logged == 8 and not log_.errors,
                      f"{t}: request log failures {log_.errors}")
                got = read_log(vol2, 8)
                want = [{"req_id": r.req_id, "prompt": r.prompt,
                         "tokens": r.out_tokens} for r in reqs]
                check(sorted(got, key=lambda r: r["req_id"]) == want,
                      f"{t}: the log does not read back the requests")
                run.update(deactivate_s=[x for x, _, _ in calls["deactivate"]],
                           log_append_s=io["append"], log_drain_s=io["drain"],
                           log_records=log_.logged,
                           autotune_ticks=vol2.metrics.count.get(
                               "autotune_ticks", 0))
            legs[leg] = run
            del eng
    finally:
        vol.close()
        if vol2 is not None:
            vol2.close()
    a, b = legs["A"], legs["B"]
    check(a["tokens"] == b["tokens"], f"{tag}: greedy tokens differ "
          f"between the pool leg and the log leg")
    check(a["suspends"] == b["suspends"] > 0, f"{tag}: suspends "
          f"{a['suspends']} / {b['suspends']}")
    (da, dax), (db, dbx) = _mean_max(a["deactivate_s"]), \
        _mean_max(b["deactivate_s"])
    ref = sync_ref["deactivate"]
    log(f"{tag}: 8 requests x 32 tokens, end to end {a['e2e_s']:.3f} s with "
        f"the pool / {b['e2e_s']:.3f} s with the log; decode "
        f"{a['decode_tok_s']:.1f} / {b['decode_tok_s']:.1f} tok/s; greedy "
        f"tokens equal; {a['suspends']} suspends")
    log(f"{tag}: deactivate on the caller's thread {da} s mean (max {dax}) "
        f"with the pool, {db} s (max {dbx}) synchronous; qwen serve's "
        f"synchronous page-outs {ref['s'] / max(ref['calls'], 1)} s a call; "
        f"activate waited in drain_evictions {a['drain_wait_s']} s")
    log(f"{tag}: {a['batches']} batches, mean {a['batch_mean']:.2f} max "
        f"{a['batch_max']} items; evict_batches "
        f"{a['counters']['evict_batches']}, evict_skipped "
        f"{a['counters']['evict_skipped']}; longest lock hold "
        f"{a['lock_held_max_s']} s; pages out {a['counters']['pages_out']}")
    log(f"{tag}: request log {b['log_records']} records, append "
        f"{sum(b['log_append_s'])} s (max {max(b['log_append_s'])}), drain "
        f"{b['log_drain_s']} s; autotune {b['autotune_ticks']} ticks, "
        f"{b['counters']['autotune_moves']} moves; records read back equal")
    for run in legs.values():
        del run["tokens"]
    return a, b


def profile_window(torch, fn, steps: int) -> dict:
    """``steps`` calls of ``fn`` under torch.profiler.  Device busy time is
    the union of the device ops' intervals; the idle share is the rest of
    the window from the first device op's start to the last one's end."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
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
    return {"steps": steps, "step_ms": wall / steps * 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_idle_share": (1.0 - busy / window) if window else None,
            "device_ops_per_step": len(spans) / steps,
            "top_device_us_per_step": [
                [k, us / steps, n // steps] for k, (us, n) in top]}


def profile_decode(torch, np, eng, cfg) -> dict:
    """Where a full-width decode step's time goes: a batch of fresh
    requests (the engine's ``max_batch``) is admitted, then 3 pure decode
    steps (no admission, no retirement) run under torch.profiler
    (``profile_window``)."""
    rng = np.random.default_rng(1)
    for _ in range(eng.max_batch):
        eng.submit(rng.integers(2, cfg.vocab, size=128).tolist(),
                   max_new_tokens=8)
    eng.step()
    out = profile_window(torch, eng.step, 3)
    eng.run()
    torch.cuda.synchronize()
    check(eng.cache.free_pages() == eng.cache.cfg.n_pages,
          "profile: pages leaked")
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


def release_weights(torch, params, arch: str) -> None:
    """Free a phase's weights (the caller's name for them is its last
    reference once the phase's engines are gone) and check that under
    1 GB stays allocated on the card."""
    params.clear()
    gc.collect()          # a cache and its eviction pool refer to each other
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 1e9,
          f"{arch} weights still held: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")


def serve_deepseek(torch, np) -> dict:
    """deepseek-coder-33b FULL (62 layers, d_model 7168, 56:8 heads of
    128, 33.3 B parameters, 66.7 GB in bf16) after every other full-width
    phase has freed its weights: 2 requests x (128 + 8) at batch 2, a pool
    of 32 pages of 16, ``running[0]`` suspended and resumed at tick 3, and
    the profiled decode window beside the step's weight-bytes bound."""
    before = torch.cuda.memory_allocated()
    check(before < 1e9, f"{before / 1e9:.2f} GB allocated before "
          f"{DEEPSEEK}'s init")
    torch.cuda.reset_peak_memory_stats()
    cfg, params = init_full(torch, DEEPSEEK)
    init_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    out = serve_full(torch, np, cfg, params, profile=True, n_req=2,
                     new_tokens=8, n_pages=32)
    out.update(memory_before_init_gb=before / 1e9,
               init_peak_gb=init_peak / 1e9, weight_gb=weight_bytes / 1e9,
               decode_bound_ms=bound_ms)
    prof = out["profile"]
    log(f"serve {DEEPSEEK}: allocated before init {before / 1e9:.3f} GB, "
        f"weights {weight_bytes / 1e9:.2f} GB, peak after init "
        f"{init_peak / 1e9:.2f} GB, peak while serving "
        f"{out['max_memory_gb']:.2f} GB; prefill {out['prefill_s']:.3f} s "
        f"(2 x 128), decode {out['decode_tok_s']:.2f} tok/s; profiled decode "
        f"step {prof['step_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms_per_step']:.2f} ms against the weight-bytes "
        f"bound {bound_ms:.2f} ms")
    release_weights(torch, params, DEEPSEEK)
    return out


# ------------------------------------------------------- phases 10-14
def attention_layers(cfg) -> tuple[int, int, int]:
    """(decoder self-attention, cross-attention, encoder) layers of a
    config: a prefill launches flash attention once for each of the three,
    a decode step paged attention once for each of the first two.
    recurrentgemma's attention layers are its ``attn`` kinds (12 of 38);
    xlstm has none."""
    if cfg.family == "encdec":
        return cfg.n_layers, cfg.n_layers, cfg.enc_layers
    if cfg.family == "vlm":
        return cfg.n_layers, cfg.n_layers // cfg.cross_every, 0
    if cfg.family == "ssm":
        return 0, 0, 0
    return sum(cfg._layer_kind(i) == "attn" for i in range(cfg.n_layers)), \
        0, 0


def set_xgate(params, value: float) -> int:
    """Set every cross-attention gate to ``value``; returns how many.  The
    reference initialises them to 0, and tanh(0) = 0 multiplies the
    cross-attention away."""
    blocks = params.get("dec_blocks", []) + [
        g["cross"] for g in params.get("groups", []) if "cross" in g]
    for blk in blocks:
        blk["xgate"].fill_(value)
    return len(blocks)


def model_batch(torch, cfg, B: int, T: int, device, seed: int = 0) -> dict:
    """Prompt tokens and the family's stub frontend output (whisper's
    frames, the VLM's patch embeddings), drawn from ``seed`` on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {"tokens": torch.randint(2, cfg.vocab, (B, T), generator=g,
                                     device=device)}
    n = {"encdec": cfg.enc_seq, "vlm": cfg.n_img_tokens}.get(cfg.family)
    if n is not None:
        key = "frames" if cfg.family == "encdec" else "image_embeds"
        batch[key] = torch.randn((B, n, cfg.d_model), generator=g,
                                 device=device).to(cfg.dtype)
    return batch


def decode_step_work(cfg, params, B: int, self_len: float, cross_len: int,
                     state=None) -> tuple[float, float]:
    """(bytes, operations) one decode step needs at batch B: every weight
    it reads once (the embedding's B rows; not the encoder, nor the
    cross-attention's K/V projections, which run at prefill; each MoE
    expert's weights once, for the capacity's tokens), the cache's valid
    K/V read once and the new token's written, the logits written; and a
    recurrent ``state`` (xlstm's, recurrentgemma's h and conv tails, not
    its ring) read and written once, with 6 operations an element of the
    mLSTM's C (its decay, outer product, add and the product with q)."""
    from repro_torch.models.layers import moe_capacity
    cap = (moe_capacity(B, cfg.moe.top_k, cfg.moe.n_experts,
                        cfg.moe.capacity_factor) if cfg.moe else B)
    n_bytes = n_ops = 0.0

    def walk(tree, path):
        nonlocal n_bytes, n_ops
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for v in tree:
                walk(v, path)
        elif path[0] in ("enc_blocks", "enc_norm") or (
                "xattn" in path and path[-1] in ("wk", "wv")):
            return
        elif path[0] == "embed":
            n_bytes += B * tree.shape[1] * tree.element_size()
        else:
            n_bytes += tree.numel() * tree.element_size()
            if tree.dim() >= 2:
                tokens = cap if "moe" in path and path[-1] != "router" else B
                n_ops += 2 * tree.numel() * tokens
    walk(params, ())
    n_self, n_cross, _ = attention_layers(cfg)
    row = cfg.n_kv_heads * cfg.hd * 2 * 2          # K and V, bf16
    n_bytes += B * row * (n_self * (self_len + 1) + n_cross * cross_len)
    n_ops += 4 * B * cfg.n_heads * cfg.hd * (n_self * self_len
                                             + n_cross * cross_len)
    n_bytes += B * cfg.vocab * 4
    for t in ([] if state is None else _leaves(state)):
        n_bytes += 2 * t.numel() * t.element_size()
    if state is not None and cfg.family == "ssm":
        n_ops += 6 * state["m"]["C"].numel()
    return n_bytes, n_ops


def ring_positions(torch, n: int, W: int):
    """The positions a W-slot ring holds after positions 0..n-1, slot s
    the last p with p % W == s, -1 where none has been written."""
    s = torch.arange(W, device="cuda")
    return torch.where(s < n, s + W * ((n - 1 - s) // W), -1)


def serve_model(torch, np, arch: str, B: int, T: int, steps: int,
                profiled: int = 3, reduced: str | None = None,
                **overrides) -> dict:
    """``build_model(cfg)`` at full width in bf16 with random weights
    drawn on the card from seed 0 (every xgate set to 0.5): ``prefill`` of
    B prompts of T tokens with ``s_max = T + steps`` (the recurrent
    families ignore it), then ``steps`` greedy ``decode_step``s, the last
    ``profiled`` of them under the profiler.  Once under 1 GB is allocated
    (every other phase's weights freed); the weights are freed at the end.
    ``overrides`` cut the config (``reduced`` says how, for the output)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_route
    from repro_torch.models import mlstm_op, slstm_op
    from repro_torch.models.api import build_model
    before = torch.cuda.memory_allocated()
    check(before < 1e9, f"{before / 1e9:.2f} GB allocated before {arch}'s "
          f"init")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch, **overrides)
    model = build_model(cfg)
    tag = f"model {arch}"
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = list(_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in weights)
    init_peak = torch.cuda.max_memory_allocated()
    gates = set_xgate(params, 0.5)
    log(f"{tag}: {cfg.family}, {cfg.n_layers} layers"
        f"{f' (+ {cfg.enc_layers} encoder)' if cfg.enc_layers else ''}, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}:{cfg.n_kv_heads} of "
        f"{cfg.hd}, {sum(t.numel() for t in weights) / 1e9:.3f} B params "
        f"(param_count {cfg.param_count() / 1e9:.3f} B), "
        f"{weight_bytes / 1e9:.2f} GB, init {init_s:.1f} s"
        + (f"; reduced: {reduced}" if reduced else "")
        + (f"; set {gates} xgate values to 0.5 (init leaves 0)" if gates
           else ""))
    n_self, n_cross, n_enc = attention_layers(cfg)
    batch = model_batch(torch, cfg, B, T, "cuda")
    torch.cuda.synchronize()
    calls0 = dict(slstm_op.CALLS)
    mcalls0 = dict(mlstm_op.CALLS)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, s_max=T + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = dict(_build.launch_counts())
    n_flash = n_self + n_cross + n_enc
    n_tc = n_flash if flash_route(cfg.dtype, cfg.hd, T) == "tc" else 0
    check(pre.get("flash_attention", 0) == n_flash
          and pre.get("flash_attention_tc", 0) == n_tc
          and pre.get("paged_attention", 0) == 0,
          f"{tag}: prefill launches {pre}, {n_flash} flash launches ({n_tc} "
          f"tensor-core) expected")
    out_logits = [logits]
    tok = logits.argmax(-1)
    state = {"i": 0, "tok": tok, "cache": cache}

    def step():
        i = state["i"]
        lg, state["cache"] = model.decode_step(
            params, state["cache"], state["tok"], np.full(B, T + i))
        state["tok"] = lg.argmax(-1)
        state["i"] = i + 1
        out_logits.append(lg)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps - profiled):
        step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    prof = profile_window(torch, step, profiled)
    dec = dict(_build.launch_counts())
    # the sLSTM's recurrence: one op call a group in the prefill and in
    # each decode step, never its backward
    calls = {k: slstm_op.CALLS[k] - calls0[k] for k in calls0}
    groups = cfg.n_layers // 8 if cfg.family == "ssm" else 0
    check(calls == {"slstm_scan": groups * (1 + steps),
                    "slstm_scan_backward": 0},
          f"{tag}: slstm op calls {calls}, {groups} a prefill and a step "
          f"expected")
    # the mLSTM's chunk loop: one call of each op a layer in the prefill
    # (the decode steps take the step recurrence), never a backward
    mcalls = {k: mlstm_op.CALLS[k] - mcalls0[k] for k in mcalls0}
    chunked = groups and T > 1 and T % min(128, T) == 0
    check(mcalls == {"mlstm_scores": 7 * groups if chunked else 0,
                     "mlstm_hidden": 7 * groups if chunked else 0,
                     "mlstm_scores_backward": 0,
                     "mlstm_hidden_backward": 0},
          f"{tag}: mlstm op calls {mcalls}, {7 * groups} of each a prefill "
          f"expected")
    check(dec.get("paged_attention", 0) == steps * (n_self + n_cross)
          and dec.get("flash_attention", 0) == 0,
          f"{tag}: decode launches {dec} for {steps} steps of "
          f"{n_self + n_cross} attention layers")
    peak = torch.cuda.max_memory_allocated()
    lg = torch.stack(out_logits)
    check(tuple(lg.shape) == (steps + 1, B, cfg.vocab)
          and bool(torch.isfinite(lg).all()), f"{tag}: logits {lg.shape}, "
          f"finite {bool(torch.isfinite(lg).all())}")
    tokens = lg.argmax(-1).T.tolist()
    check(all(0 <= t < cfg.vocab for row in tokens for t in row),
          f"{tag}: a token outside the vocabulary")
    # every slot of every row filled, 0..s_max-1, once prefill and decode
    # have run; recurrentgemma's ring holds the last W positions, slot p %
    # W for position p (slots past T + steps empty)
    c = state["cache"]
    rec_state = None
    if cfg.family == "hybrid":
        pos = c["groups"]["attn"]["pos"]
        check(bool((pos == ring_positions(torch, T + steps,
                                          cfg.attn_window)).all()),
              f"{tag}: ring positions are not the last {cfg.attn_window} "
              f"of 0..{T + steps - 1}, slot p % {cfg.attn_window}")
        rec_state = {k: v for k, v in c.items() if k != "groups"}
        rec_state["groups"] = {k: c["groups"][k] for k in ("rec1", "rec2")}
    elif cfg.family == "ssm":
        rec_state = c
    else:
        pos = (c if cfg.family not in ("encdec", "vlm") else c["self"])["pos"]
        check(bool((pos == torch.arange(T + steps, device="cuda")).all()),
              f"{tag}: cache positions not 0..{T + steps - 1} in every row")
    # the profiled steps' mean count of valid slots (pos + 1, at most W)
    lens = [p + 1 for p in range(T + steps - profiled, T + steps)]
    if cfg.family == "hybrid":
        lens = [min(n, cfg.attn_window) for n in lens]
    mean_len = sum(lens) / len(lens)
    cross_len = c["cross_k"].shape[2] if n_cross else 0
    n_bytes, n_ops = decode_step_work(cfg, params, B, mean_len, cross_len,
                                      rec_state)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    out = {"arch": arch, "family": cfg.family, "reduced": reduced,
           "B": B, "prompt_tokens": T, "decode_steps": steps,
           "params": sum(t.numel() for t in weights),
           "memory_before_init_gb": before / 1e9,
           "weight_gb": weight_bytes / 1e9, "init_peak_gb": init_peak / 1e9,
           "peak_gb": peak / 1e9, "prefill_s": prefill_s,
           "decode_tok_s": B * (steps - profiled) / decode_s,
           "decode_step_ms": decode_s / (steps - profiled) * 1e3,
           "profile": prof, "decode_bound_ms": b_ms,
           "decode_bound_by": b_by, "decode_bytes": n_bytes,
           "flash_per_prefill": pre.get("flash_attention", 0),
           "flash_tc_per_prefill": pre.get("flash_attention_tc", 0),
           "paged_per_step": dec.get("paged_attention", 0) / steps,
           "attention_layers": n_self + n_cross + n_enc,
           "xgates_set": gates, "tokens": tokens,
           "launches": {k: pre.get(k, 0) + dec.get(k, 0)
                        for k in set(pre) | set(dec)}}
    log(f"{tag}: allocated before init {before / 1e9:.3f} GB, weights "
        f"{weight_bytes / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB; prefill "
        f"{prefill_s:.3f} s ({B} x {T}), decode {out['decode_tok_s']:.2f} "
        f"tok/s ({out['decode_step_ms']:.1f} ms a step); profiled decode "
        f"step {prof['step_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms_per_step']:.2f} ms, idle share "
        f"{prof['device_idle_share']}, {prof['device_ops_per_step']:.0f} "
        f"device ops; bound {b_ms:.3f} ms ({b_by}: "
        f"{n_bytes / 1e9:.2f} GB); flash launches a prefill "
        f"{out['flash_per_prefill']}, paged a step {out['paged_per_step']}"
        + ("" if n_self + n_cross + n_enc else
           " (no attention layer: neither attention kernel runs here)"))
    if groups:
        out["mlstm"] = plain_loop_leg(torch, np, model, params, batch, B, T,
                                      steps, lg, "mlstm_chunkwise",
                                      plain_mlstm_chunkwise, mcalls, tag)
        out["slstm"] = plain_loop_leg(torch, np, model, params, batch, B, T,
                                      steps, lg, "slstm_scan",
                                      plain_slstm_scan, calls, tag)
    if arch == MESH_ARCH:
        del out_logits, lg, logits, cache, state, c
        out["mesh_leg"] = mesh_serve(torch, np, model, params, batch, B, T,
                                     steps, profiled, out)
    else:
        del out_logits, lg, logits, cache, state, c
    del batch, weights, rec_state
    release_weights(torch, params, arch)
    return out


def plain_loop_leg(torch, np, model, params, batch, B: int, T: int,
                   steps: int, lg, name: str, plain, calls: dict,
                   tag: str) -> dict:
    """The same prefill and greedy decode steps with ``xlstm.<name>``
    swapped for ``plain``, the loop the port ran before it became ops
    (the sLSTM's ``plain_slstm_scan``, the mLSTM's
    ``plain_mlstm_chunkwise``): the tokens and the logits must be those of
    the run through the ops (``lg``), bit for bit."""
    from repro_torch.models import xlstm
    orig = getattr(xlstm, name)
    setattr(xlstm, name, lambda *a, **kw: plain(torch, *a, **kw))
    try:
        logits, cache = model.prefill(params, batch, s_max=T + steps)
        out = [logits]
        for i in range(steps):
            logits, cache = model.decode_step(params, cache,
                                              out[-1].argmax(-1),
                                              np.full(B, T + i))
            out.append(logits)
        torch.cuda.synchronize()
    finally:
        setattr(xlstm, name, orig)
    loop = torch.stack(out)
    same = lg.argmax(-1).T.tolist() == loop.argmax(-1).T.tolist()
    equal = torch.equal(lg, loop)
    diff = float((lg.float() - loop.float()).abs().max())
    check(same and equal, f"{tag}: greedy tokens (equal {same}) or logits "
          f"through the ops differ from the plain {name} loop's (logits "
          f"max abs {diff})")
    log(f"{tag}: the ops in {name} called {calls}; greedy tokens and "
        f"logits equal to the plain loop's bit for bit")
    return {"calls": calls, "tokens_equal_plain_loop": same,
            "logits_equal_plain_loop": equal, "logits_max_abs_diff": diff}


# ---------------------------------------------------- phases 17-18: train
# phase 17: phi3-mini-3.8b FULL trained through the port's Trainer (6 steps
# at accum 1) and make_train_step (2 steps at accum 2 on the next batches)
TRAIN = dict(arch=PHI3, B=4, T=1024, steps=6, accum=2, accum_steps=2)


def timed_ms(fn, iters: int) -> tuple:
    """(device ms per call from the profiler, "profiler"), or where its
    profile is empty or incomplete (it has been seen to drop events) the
    CUDA-event time per call, which includes host time the device waits
    on, and "events"."""
    ms = device_ms(fn, iters)
    if ms is not None:
        return ms, "profiler"
    return time_ms(fn, iters, warmup=1), "events"


def flash_backward_times(torch, cfg, B: int, T: int) -> dict:
    """The attention of one training layer at (B, T) alone: the flash
    kernel's forward (``ops.flash_attention`` on the card) and its
    backward, which recomputes through the plain version (device ms each,
    from the profiler), and the memory the backward takes beyond its
    inputs and the forward's output."""
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((B, T, H, cfg.hd), generator=g, device="cuda")
               .to(cfg.dtype).requires_grad_()
               for H in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    dout = torch.randn((B, T, cfg.n_heads, cfg.hd), generator=g,
                       device="cuda").to(cfg.dtype)
    with torch.no_grad():
        fwd = timed_ms(lambda: ops.flash_attention(q, k, v), 20)
    out = ops.flash_attention(q, k, v)

    def backward():
        return torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    bwd = timed_ms(backward, 10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(all(bool(torch.isfinite(t).all()) for t in grads),
          "flash backward: a gradient is not finite")
    n_bytes = q.element_size() * 2 * (q.numel() + k.numel())
    n_ops = 4 * cfg.hd * cfg.n_heads * B * flash_pairs(T, T, True, 0)
    fwd_bound, fwd_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    return {"shape": [B, T, cfg.n_heads, cfg.n_kv_heads, cfg.hd],
            "forward_bound_ms": fwd_bound, "forward_bound_by": fwd_by,
            "forward_ms": fwd[0], "forward_ms_from": fwd[1],
            "backward_ms": bwd[0], "backward_ms_from": bwd[1],
            "backward_peak_gb": peak / 1e9}


def train_step_bound(cfg, params, B: int, T: int) -> dict:
    """The least time one training step could take on the card: the
    model's products, 6 N operations a token (N every parameter but the
    input embedding's, a gather; the head's counted, tied or not), plus
    causal attention, 4 hd operations for
    each (head, query, key) pair it sees in the forward and twice that in
    the backward, at the bf16 tensor-core rate; then the optimizer's
    update, which reads each parameter, its gradient and both moments and
    writes the parameter and the moments (22 bytes a bf16 parameter), at
    the memory rate.  The update needs the whole gradient, so the two
    add."""
    n = sum(t.numel() for t in _leaves(params))
    if not cfg.tie_embeddings:
        n -= params["embed"].numel()
    n_self, n_cross, n_enc = attention_layers(cfg)
    pairs = flash_pairs(T, T, True, cfg.attn_window)
    model_ops = 6 * n * B * T
    attn_ops = 12 * cfg.hd * cfg.n_heads * B * pairs * n_self
    opt_bytes = sum(t.numel() * (3 * t.element_size() + 16)
                    for t in _leaves(params))
    compute_ms = (model_ops + attn_ops) / BF16_OPS_PER_S * 1e3
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"model_tflop": model_ops / 1e12, "attention_tflop": attn_ops
            / 1e12, "compute_bound_ms": compute_ms, "optimizer_bytes_gb":
            opt_bytes / 1e9, "optimizer_bound_ms": opt_ms,
            "step_bound_ms": compute_ms + opt_ms}


def train_full(torch, np) -> dict:
    """phi3-mini-3.8b FULL (32 layers, MHA 32:32 of 96) in bf16 with random
    weights drawn on the card from seed 0, trained with remat "dots" once
    every other phase's weights are freed: ``Trainer`` for 6 steps of 4 x
    1024 tokens from ``SyntheticLM`` (AdamW at lr 3e-4, 2 warm-up steps
    of 8), the last step under the profiler, then 2 steps of
    ``make_train_step`` at accum 2 on the source's batches 6 and 7.
    Every loss is finite, every parameter moved in the first step, and the
    flash kernel ran on the tensor cores 64 times a step and microbatch
    (the forward of each of the 32 layers, and its recompute in the
    backward).  Prints the state's GB by part, the peak, step ms and
    tokens/s of the unprofiled steps, the profiled step's busy ms, idle
    share and ops beside the step's bound, the flash forward and plain
    backward alone at the step's shape, and the optimizer's update."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import decay_mask
    from repro_torch.optim import AdamW, apply_updates, tree_map
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import TrainConfig, Trainer
    arch, B, T = TRAIN["arch"], TRAIN["B"], TRAIN["T"]
    tag = f"train {arch}"
    before = torch.cuda.memory_allocated()
    check(before < 1e9, f"{before / 1e9:.2f} GB allocated before {tag}")
    cfg = get_config(arch)
    check(cfg.remat == "dots" and cfg.dtype == torch.bfloat16,
          f"{tag}: remat {cfg.remat}, dtype {cfg.dtype}")
    attn = flash_backward_times(torch, cfg, B, T)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    opt = AdamW(lr=3e-4, warmup_steps=2,
                total_steps=TRAIN["steps"] + TRAIN["accum_steps"])
    source = SyntheticLM(cfg.vocab, seq=T, global_batch=B)
    tr = Trainer(model, opt, source, cfg=TrainConfig(
        total_steps=TRAIN["steps"]))
    step_fn = tr.step_fn
    seen = {"moved": None, "profile": None}

    def watched(params, opt_state, batch):
        """The Trainer's step: the weights kept on the host before the
        first, compared after it; the last one under the profiler."""
        i = len(tr.history)
        if i == 0:
            seen["before"] = [t.detach().cpu() for t in _leaves(params)]
        if i == TRAIN["steps"] - 1:
            out = {}
            seen["profile"] = profile_window(
                torch, lambda: out.setdefault(
                    "r", step_fn(params, opt_state, batch)), 1)
            return out["r"]
        r = step_fn(params, opt_state, batch)
        if i == 0:
            seen["moved"] = [float((t.detach() != h.to("cuda")).float()
                                   .mean())
                             for t, h in zip(_leaves(r[0]),
                                             seen.pop("before"))]
        return r

    tr.step_fn = watched
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = tr.run(torch.Generator(device="cuda").manual_seed(0))
    params, opt_state = out["params"], out["opt_state"]
    # the step's arguments on the card (each storage once): the parameters
    # and the AdamW state, which phase 21 counts on fake tensors
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in _leaves({"p": params, "s": opt_state.step,
                              "m": opt_state.m, "v": opt_state.v})}
    state_arg_bytes = sum(held.values())
    step2 = make_train_step(model, opt, accum=TRAIN["accum"])
    accum_s, losses2 = [], []
    for s in range(TRAIN["steps"], TRAIN["steps"] + TRAIN["accum_steps"]):
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in source.batch_at(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step2(params, opt_state, batch)
        losses2.append(float(m["loss"]))
        accum_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"] + losses2
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(seen["moved"] is not None and min(seen["moved"]) > 0,
          f"{tag}: a parameter leaf did not move in the first step "
          f"({seen['moved']})")
    n_layers = attention_layers(cfg)[0]
    micro = TRAIN["steps"] + TRAIN["accum"] * TRAIN["accum_steps"]
    check(launches.get("flash_attention_tc", 0)
          == launches.get("flash_attention", 0) == 2 * n_layers * micro
          and launches.get("paged_attention", 0) == 0,
          f"{tag}: launches {launches}, {2 * n_layers * micro} tensor-core "
          f"flash launches expected (forward and recompute, {n_layers} "
          f"layers, {micro} microbatches)")
    # the optimizer's update alone, on gradients the size of the weights
    grads = tree_map(lambda t: t.detach().clone(), params)
    mask = decay_mask(params, cfg)

    def update():
        upd, _, _ = opt.update(grads, opt_state, params, decay=mask)
        apply_updates(params, upd)
    opt_ms = time_ms(update, 3, warmup=1)
    opt_prof = profile_window(torch, update, 1)
    del grads
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    state_gb = {
        "weights": sum(t.numel() * t.element_size() for t in leaves) / 1e9,
        "gradients": sum(t.numel() * t.element_size() for t in leaves)
        / 1e9,
        "adam_m_v": sum(t.numel() * t.element_size()
                        for t in _leaves({"m": opt_state.m,
                                          "v": opt_state.v})) / 1e9}
    b = train_step_bound(cfg, params, B, T)
    steady = [s.dt_s for s in tr.history[1:TRAIN["steps"] - 1]]
    step_ms = sum(steady) / len(steady) * 1e3
    prof = seen["profile"]
    res = {"arch": arch, "B": B, "T": T, "params": n_params,
           "remat": cfg.remat, "state_gb": state_gb,
           "state_total_gb": sum(state_gb.values()), "peak_gb": peak / 1e9,
           "peak_bytes": peak, "state_argument_bytes": state_arg_bytes,
           "losses": losses, "first_step_s": tr.history[0].dt_s,
           "step_ms": step_ms, "steps_timed": len(steady),
           "tokens_per_s": B * T / (step_ms / 1e3),
           "accum2_step_ms": [x * 1e3 for x in accum_s],
           "min_moved_share": min(seen["moved"]),
           "profile": prof, "optimizer_call_ms": opt_ms,
           "optimizer_profile": opt_prof, **b,
           "attention": attn, "stragglers": out["stragglers"],
           "flash_tc_per_step": launches.get("flash_attention_tc", 0)
           / micro, "launches": launches}
    log(f"{tag}: {n_params / 1e9:.3f} B params, state GB {state_gb} "
        f"({res['state_total_gb']:.2f} GB), peak {peak / 1e9:.2f} GB; "
        f"losses {[round(x, 4) for x in losses]}; step {step_ms:.1f} ms "
        f"({res['tokens_per_s']:.0f} tokens/s over {len(steady)} steps; "
        f"first {tr.history[0].dt_s:.2f} s; accum 2: "
        f"{[round(x * 1e3, 1) for x in accum_s]} ms); profiled step "
        f"{prof['step_ms']:.1f} ms, busy {prof['device_busy_ms_per_step']:.1f}"
        f" ms, idle share {prof['device_idle_share']}, "
        f"{prof['device_ops_per_step']:.0f} device ops; bound "
        f"{b['step_bound_ms']:.1f} ms ({b['compute_bound_ms']:.1f} ms of "
        f"{b['model_tflop'] + b['attention_tflop']:.1f} TFLOP + "
        f"{b['optimizer_bound_ms']:.1f} ms of {b['optimizer_bytes_gb']:.1f} "
        f"GB); optimizer update {opt_ms:.2f} ms a call (events), device busy "
        f"{opt_prof['device_busy_ms_per_step']:.2f} ms in "
        f"{opt_prof['device_ops_per_step']:.0f} device ops, idle share "
        f"{opt_prof['device_idle_share']}, top ops "
        f"{opt_prof['top_device_us_per_step'][:4]}; flash forward "
        f"{attn['forward_ms']:.4f} ms ({attn['forward_ms_from']}; bound "
        f"{attn['forward_bound_ms']:.4f} ms, {attn['forward_bound_by']}), "
        f"plain backward {attn['backward_ms']:.3f} ms "
        f"({attn['backward_ms_from']}) and {attn['backward_peak_gb']:.2f} GB "
        f"at {attn['shape']}; every leaf "
        f"moved (least share {res['min_moved_share']:.3f}); flash launches "
        f"{launches}")
    del out, params, opt_state, leaves, prof
    seen.clear()
    release_weights(torch, {}, arch)
    return res


# phase 19: Caiti-backed checkpoints of phi3-mini-3.8b at full width with
# its depth cut to one layer (3.10 GB of state: one save has to fit the
# script's time), through the Trainer: run A saves once asynchronously
# after step 3 and crashes at step 7; run B reopens the file store and
# resumes at step 4; run C trains steps 0-7 without a checkpoint
CKPT = dict(arch=PHI3, B=4, T=1024, n_layers=1, steps=12, every=4, crash=7,
            resume_steps=8, store_bytes=8 << 30)
BITS = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


class SimulatedCrash(RuntimeError):
    """Raised by run A's step 7: the training process dies there."""


def _paths(tree, prefix=""):
    """(path, leaf) of a tree of dicts, lists and NamedTuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(tree._fields, tree)
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [p for k, v in items for p in _paths(v, f"{prefix}/{k}")]


def state_digests(torch, state) -> dict:
    """{path: (sum of the bits, sum of the bits weighted by position, mod
    2^64)} of every leaf, computed on its device: two states with equal
    digests hold the same bits, short of a collision."""
    out = {}
    for path, t in _paths(state):
        bits = t.detach().contiguous().view(
            getattr(torch, BITS[t.element_size()])).reshape(-1).long()
        w = torch.arange(bits.numel(), device=bits.device) * 2654435761 + 1
        out[path] = (int(bits.sum()), int((bits * w).sum()))
    return out


def train_ckpt(torch, np) -> dict:
    """phi3-mini-3.8b at its published widths (d 3072, 32:32 heads of 96,
    d_ff 8192, vocab 32064) in bf16 with remat "dots", depth cut to one
    layer, trained on 4 x 1024 tokens a step with Caiti-backed
    checkpoints to a file store (``make_blockstore(policy="caiti")``, a
    sparse file in a temporary directory, removed at the end):

    * run A, ``TrainConfig(total_steps=12, ckpt_every=4,
      async_ckpt=True)``: one ``save_async`` after step 3 (its snapshot is
      the loop's stall), steps 4-6 while the save is in flight, and step
      7 raises a simulated crash; the Trainer's ``finally`` waits for the
      save's commit;
    * the crash drops the Trainer, the engine and the store; a new store
      reopens the file, and ``latest_step()`` is 3;
    * run B, a new Trainer (8 steps), restores and resumes at step 4 (its
      restore is timed up to the tensors on the card, and the restored
      state's per-leaf digests must equal those taken of the Trainer's
      state when it saved), and runs steps 4-7 without a second save;
    * run C trains steps 0-7 without a checkpoint engine: run A's losses
      and run B's equal its own within rtol 1e-4.

    Every run launches the tensor-core flash kernel twice a layer and
    step."""
    import os
    import shutil
    import tempfile
    from repro_torch.ckpt import CheckpointEngine, make_blockstore
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.loop import TrainConfig, Trainer
    c = CKPT
    arch, B, T = c["arch"], c["B"], c["T"]
    tag = f"train_ckpt {arch}"
    before = torch.cuda.memory_allocated()
    check(before < 1e9, f"{before / 1e9:.2f} GB allocated before {tag}")
    full_layers = get_config(arch).n_layers
    cfg = get_config(arch, n_layers=c["n_layers"])
    check(cfg.remat == "dots" and cfg.dtype == torch.bfloat16,
          f"{tag}: remat {cfg.remat}, dtype {cfg.dtype}")
    model = build_model(cfg)
    source = SyntheticLM(cfg.vocab, seq=T, global_batch=B)
    opt = AdamW(lr=3e-4, warmup_steps=2, total_steps=c["steps"])

    def trainer(ckpt, steps):
        return Trainer(model, opt, source, ckpt=ckpt, cfg=TrainConfig(
            total_steps=steps, ckpt_every=c["every"], async_ckpt=True))

    def run(tr, n_steps: int) -> tuple:
        """Runs ``tr``; -> (its output or None after a simulated crash,
        its flash launches, checked: the tensor-core kernel twice a layer
        in each of ``n_steps`` steps)."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        try:
            out = tr.run(torch.Generator(device="cuda").manual_seed(0))
        except SimulatedCrash:
            out = None
        torch.cuda.synchronize()
        n = dict(_build.launch_counts())
        want = 2 * c["n_layers"] * n_steps
        check(n.get("flash_attention_tc", 0) == n.get("flash_attention", 0)
              == want and n.get("paged_attention", 0) == 0,
              f"{tag}: launches {n}, {want} tensor-core flash launches "
              f"expected")
        return out, n

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    pool = os.path.join(tmp, "pool")
    try:
        # ---- run A: one async save after step 3, a crash at step 7
        store = make_blockstore(pool, policy="caiti",
                                capacity_bytes=c["store_bytes"])
        commit_s = []
        commit = store.commit

        def timed_commit():
            t0 = time.perf_counter()
            gen = commit()
            commit_s.append(time.perf_counter() - t0)
            return gen
        store.commit = timed_commit
        eng = CheckpointEngine(store)
        saves = []
        save_async = eng.save_async

        def watched_save(step, state):
            """The Trainer's save: the state's digests first (on the
            card), then the save's own call, timed: the snapshot."""
            digests = state_digests(torch, state)
            gb = {part: sum(t.numel() * t.element_size()
                            for _, t in _paths(tree)) / 1e9
                  for part, tree in (("params", state["params"]),
                                     ("adam_m", state["opt"].m),
                                     ("adam_v", state["opt"].v))}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_async(step, state)
            saves.append({"step": step, "digests": digests, "gb": gb,
                          "snapshot_ms": (time.perf_counter() - t0) * 1e3})
        eng.save_async = watched_save
        tr = trainer(eng, c["steps"])
        step_fn = tr.step_fn
        in_flight, crashed_at = {}, []

        def crashing(params, opt_state, batch):
            i = len(tr.history)
            if i == c["crash"]:
                crashed_at.append(time.perf_counter())
                raise SimulatedCrash(f"step {i}")
            r = step_fn(params, opt_state, batch)
            in_flight[i] = bool(saves) and "ckpt_save" not in \
                eng.metrics.count
            return r
        tr.step_fn = crashing
        out_a, n_a = run(tr, c["crash"])
        check(out_a is None and len(crashed_at) == 1
              and len(tr.history) == c["crash"],
              f"{tag}: run A ran {len(tr.history)} steps, no crash")
        wait_s = time.perf_counter() - crashed_at[0]
        check([s["step"] for s in saves] == [c["every"] - 1]
              and eng.metrics.count.get("ckpt_save") == 1,
              f"{tag}: saves {[s['step'] for s in saves]}, one after step "
              f"{c['every'] - 1} expected")
        overlap = list(range(c["every"], c["crash"]))
        check(all(in_flight[i] for i in overlap),
              f"{tag}: the save was not in flight through steps {overlap}: "
              f"{in_flight}")
        losses_a = [s.loss for s in tr.history]
        dt_a = [s.dt_s for s in tr.history]
        m = eng.metrics
        manifest = json.loads(store.get(
            f"step{c['every'] - 1:010d}/MANIFEST").decode())
        n_chunks = sum(v["chunks"] for v in manifest.values())
        save = saves[0]
        save_bytes = sum(save["gb"].values()) * 1e9
        write_s = m.ns["ckpt_save"] / 1e9
        crash = {"write_s": write_s, "cache_flush_s": m.ns["cache_flush"]
                 / 1e9, "commit_s": commit_s, "chunks": n_chunks,
                 "bypass_writes": m.count.get("bypass_writes", 0),
                 "conditional_bypass": m.count.get("conditional_bypass", 0),
                 "wait_after_crash_s": wait_s}
        crash["staged"] = n_chunks - crash["bypass_writes"]
        # ---- the crash: drop the Trainer, the engine and the store
        dropped = (eng, store)
        del tr, eng, store, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < 1e9,
              f"{tag}: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
              f"allocated after the crash")
        # ---- run B: reopen the file, restore, resume at step 4
        t0 = time.perf_counter()
        store = make_blockstore(pool, policy="caiti",
                                capacity_bytes=c["store_bytes"])
        eng = CheckpointEngine(store)
        reopen_s = time.perf_counter() - t0
        check(eng.latest_step() == c["every"] - 1,
              f"{tag}: latest step {eng.latest_step()} after the reopen")
        tr = trainer(eng, c["resume_steps"])
        restore = tr.restore_or_init
        restored = {}

        def restoring(gen):
            t0 = time.perf_counter()
            params, opt_state, start = restore(gen)
            torch.cuda.synchronize()
            restored.update(
                restore_s=time.perf_counter() - t0, start=start,
                digests=state_digests(torch, {"params": params,
                                              "opt": opt_state}))
            tr.ckpt = None     # run B saves nothing: one save a phase
            return params, opt_state, start
        tr.restore_or_init = restoring
        out_b, n_b = run(tr, c["resume_steps"] - c["every"])
        eng.close()
        check(restored["start"] == c["every"],
              f"{tag}: run B resumed at step {restored['start']}")
        differ = [k for k, d in save["digests"].items()
                  if restored["digests"].get(k) != d]
        check(restored["digests"].keys() == save["digests"].keys()
              and not differ, f"{tag}: the restored state differs from "
              f"the saved one at {differ[:5]}")
        store_bytes = os.stat(pool)
        del out_b["params"], out_b["opt_state"]
        # ---- run C: steps 0-7 without a checkpoint engine
        tr_c = trainer(None, c["resume_steps"])
        out_c, n_c = run(tr_c, c["resume_steps"])
        del out_c["params"], out_c["opt_state"]
        dropped[0].transit.close()
        dropped[1].close()
    finally:
        shutil.rmtree(tmp)
    losses_c = out_c["losses"]
    err_a = max(abs(x - y) / abs(y) for x, y in zip(losses_a, losses_c))
    err_b = max(abs(x - y) / abs(y)
                for x, y in zip(out_b["losses"], losses_c[c["every"]:]))
    check(out_b["last_step"] == c["resume_steps"] - 1 and err_b <= 1e-4,
          f"{tag}: run B's losses {out_b['losses']} against run C's "
          f"{losses_c[c['every']:]}")
    check(err_a <= 1e-4, f"{tag}: run A's losses {losses_a} against run "
          f"C's {losses_c}")
    check(all(math.isfinite(x) for x in losses_c), f"{tag}: {losses_c}")
    dt_c = [s.dt_s for s in tr_c.history]
    launches = {k: n_a.get(k, 0) + n_b.get(k, 0) + n_c.get(k, 0)
                for k in set(n_a) | set(n_b) | set(n_c)}
    res = {"arch": arch, "B": B, "T": T,
           "reduced": {"n_layers": f"{full_layers} -> {c['n_layers']}"},
           "ckpt_gb": save["gb"], "ckpt_total_gb": save_bytes / 1e9,
           "snapshot_ms": save["snapshot_ms"], **crash,
           "save_mb_s": save_bytes / 1e6 / write_s,
           "overlap_steps": overlap,
           "overlap_step_ms": [dt_a[i] * 1e3 for i in overlap],
           "same_steps_run_c_ms": [dt_c[i] * 1e3 for i in overlap],
           "reopen_s": reopen_s, "restore_s": restored["restore_s"],
           "run_b_first_step_ms": tr.history[0].dt_s * 1e3,
           "store_file_gb": store_bytes.st_size / 1e9,
           "store_file_allocated_gb": store_bytes.st_blocks * 512 / 1e9,
           "losses_a": losses_a, "losses_b": out_b["losses"],
           "losses_c": losses_c, "max_rel_loss_diff_a": err_a,
           "max_rel_loss_diff_b": err_b, "leaves": len(save["digests"]),
           "launches": launches}
    log(f"{tag}: reduced {res['reduced']}; checkpoint {res['ckpt_gb']} GB "
        f"({res['ckpt_total_gb']:.3f} GB); snapshot (the loop's stall) "
        f"{res['snapshot_ms']:.1f} ms; background write {write_s:.2f} s "
        f"({res['save_mb_s']:.1f} MB/s), cache_flush "
        f"{crash['cache_flush_s']:.2f} s, commit "
        f"{[round(x, 3) for x in commit_s]} s; chunks {n_chunks}: staged "
        f"{crash['staged']}, bypassed {crash['bypass_writes']} "
        f"(conditional_bypass {crash['conditional_bypass']}); steps "
        f"{overlap} with the save in flight "
        f"{[round(x, 1) for x in res['overlap_step_ms']]} ms, run C's "
        f"{[round(x, 1) for x in res['same_steps_run_c_ms']]} ms; crash at "
        f"step {c['crash']}, then {wait_s:.2f} s to the commit and the "
        f"run's end; reopen "
        f"{reopen_s:.2f} s + restore to the card {res['restore_s']:.2f} s, "
        f"{res['leaves']} leaves bit for bit (digests); run B's first step "
        f"{res['run_b_first_step_ms']:.1f} ms; store file "
        f"{res['store_file_gb']:.2f} GB ({res['store_file_allocated_gb']:.2f}"
        f" GB allocated); losses max rel diff: run B {err_b:.3g}, run A "
        f"{err_a:.3g}; flash launches A {n_a}, B {n_b}, C {n_c}")
    release_weights(torch, {}, arch)
    return res


def parity_train(torch, np) -> dict:
    """phase 18: phi3-mini-3.8b SMOKE in f32 (TF32 off), 4 ``Trainer``
    steps on the card and on the CPU from the same weights and data:
    losses within rtol 1e-4 and every parameter within ``ROW_TOL["f32"]``
    row by row; on the card the SIMT flash kernel twice a layer and step.
    Returns the card's launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.loop import TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"train parity {PHI3}"
    cfg = get_config(PHI3, smoke=True, dtype=torch.float32)
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(0))
    out, launches = {}, {}
    for dev in ("cuda", "cpu"):
        m = dataclasses.replace(model, init=lambda gen: _to(init, gen.device))
        tr = Trainer(m, AdamW(lr=1e-3, total_steps=100),
                     SyntheticLM(cfg.vocab, seq=32, global_batch=4),
                     cfg=TrainConfig(total_steps=4), device=dev)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out[dev] = tr.run()
        torch.cuda.synchronize()
        if dev == "cuda":
            launches = dict(_build.launch_counts())
    a, c = out["cuda"], out["cpu"]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       c["losses"]))
    check(loss_err <= 1e-4, f"{tag}: losses cuda {a['losses']} cpu "
          f"{c['losses']}")
    errs = [row_rel_err(x.detach().cpu().reshape(-1, x.shape[-1]),
                        y.detach().reshape(-1, y.shape[-1]))
            for x, y in zip(_leaves(a["params"]), _leaves(c["params"]))]
    check(max(errs) <= ROW_TOL["f32"], f"{tag}: parameter row error "
          f"{max(errs):.3g} > {ROW_TOL['f32']}")
    n = 4 * 2 * cfg.n_layers
    check(launches.get("flash_attention", 0) == n
          and launches.get("flash_attention_tc", 0) == 0,
          f"{tag}: launches {launches}, {n} SIMT flash launches expected")
    log(f"{tag}: SMOKE f32 (TF32 off), 4 Trainer steps: losses agree card "
        f"against CPU (max rel err {loss_err:.3g}: {a['losses']}), "
        f"parameters within ROW_TOL (max row rel err {max(errs):.3g}); "
        f"cuda launches {launches}")
    return launches


# the model API's SMOKE parity, card against CPU, one arch per family:
# (arch, prompt tokens, decode steps).  recurrentgemma SMOKE's window is
# 32: a prompt of 40 fills its ring from the prefill, one of 8 decoded 30
# steps wraps it on the card.
MODEL_PARITY = ((MOONSHOT, 12, 8), (QWEN3_MOE, 12, 8), (WHISPER, 12, 8),
                (VISION, 12, 8), (XLSTM, 12, 8), (RGEMMA, 40, 8),
                (RGEMMA, 8, 30))


def parity_models(torch, np) -> dict:
    """The model API at SMOKE in f32 (TF32 off), every xgate 0.5, on the
    card and on the CPU from the same weights: forward logits, prefill
    logits and cache or state (``s_max``), and the greedy decode steps
    agree within ``ROW_TOL["f32"]`` row by row, the cache positions and
    the tokens are equal, and on the card the forward and the prefill each
    launch flash attention once for each attention layer and each decode
    step the paged kernel once for each decoder attention layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = 2
    launches = {}
    for arch, T, steps in MODEL_PARITY:
        cfg = get_config(arch, smoke=True, dtype=torch.float32)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        set_xgate(params, 0.5)
        batch = model_batch(torch, cfg, B, T, "cpu", seed=2)
        got = {}
        for dev in ("cuda", "cpu"):
            p, b = _to(params, dev), _to(batch, dev)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            fwd = model.forward(p, b)
            logits, cache = model.prefill(p, b, s_max=T + steps)
            steps_out = [logits]
            for i in range(steps):
                lg, cache = model.decode_step(
                    p, cache, steps_out[-1].argmax(-1), np.full(B, T + i))
                steps_out.append(lg)
            torch.cuda.synchronize()
            if dev == "cuda":
                launches[f"{arch} T{T}"] = dict(_build.launch_counts())
            got[dev] = {"forward": fwd.cpu(), "logits": [
                lg.cpu() for lg in steps_out], "cache": _to(cache, "cpu")}
        tag = f"model parity {arch} T{T}"
        a, c = got["cuda"], got["cpu"]
        errs = [row_rel_err(a["forward"], c["forward"])] + [
            row_rel_err(x, y) for x, y in zip(a["logits"], c["logits"])]
        for x, y in zip(_leaves(a["cache"]), _leaves(c["cache"])):
            if x.dtype == torch.int32:
                check(torch.equal(x, y), f"{tag}: cache positions differ")
            else:
                errs.append(row_rel_err(x, y))
        check(max(errs) <= ROW_TOL["f32"], f"{tag}: row error "
              f"{max(errs):.3g} > {ROW_TOL['f32']}")
        toks = {d: [lg.argmax(-1).tolist() for lg in got[d]["logits"]]
                for d in got}
        check(toks["cuda"] == toks["cpu"], f"{tag}: tokens cuda "
              f"{toks['cuda']} != cpu {toks['cpu']}")
        n_self, n_cross, n_enc = attention_layers(cfg)
        n = launches[f"{arch} T{T}"]
        check(n.get("flash_attention", 0) == 2 * (n_self + n_cross + n_enc)
              and n.get("flash_attention_tc", 0) == 0
              and n.get("paged_attention", 0) == steps * (n_self + n_cross),
              f"{tag}: launches {n}")
        if cfg.family == "hybrid":
            ring = a["cache"]["groups"]["attn"]["pos"]
            check(bool((ring == ring_positions(torch, T + steps,
                                               cfg.attn_window).cpu()).all()),
                  f"{tag}: ring positions {ring.tolist()}")
        log(f"{tag}: SMOKE f32 (TF32 off), xgate 0.5: forward, prefill "
            f"(logits, cache), {steps} decode steps agree card against CPU "
            f"(max row rel err {max(errs):.3g}), tokens equal "
            f"{toks['cuda'][1:]}; cuda launches {n}")
    return launches


# ------------------------------------------------------------- phase 7
def parity_smoke(torch, np) -> dict:
    """The SMOKE configs of ``PARITY_RUNS`` in f32 (TF32 off), each over
    its pools of ``PARITY_CASES``: a roomy one (64 pages of 8), where every
    page stays on the card and the suspended request pages out and back
    in; a tiny one (2 pages of 4), where pages bypass to the host tier and
    decode runs the hybrid attention path; 6 pages of 4 behind a pager on a
    volume with no host budget, where a stalled resume leaves spilled
    pages that the hybrid path reads without promoting them; and the roomy
    pool with a 4-worker eviction pool, every running request's page-outs
    run by the pool's workers.  Tokens and the cache's counters (the spill
    tier's too, and the spilled pages read) must be the same on the card
    and on the CPU — with the pool, all but the page-out counts, which
    depend on whether a retiring request's queued page-outs run before
    its release skips them — nothing may be left behind, and on the card
    every prefill layer launches the flash kernel once and every decode
    layer the paged-attention kernel once, hybrid or not."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.core.metrics import KV_PAGING_COUNTERS
    from repro_torch.kernels import _build
    from repro_torch.serve import (KVPager, PagedCacheConfig, PagedKVCache,
                                   PagedLM, ServeEngine)
    from repro_torch.volume.evict_pool import SharedEvictionPool
    from repro_torch.volume.volume import make_volume

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    for arch, labels in PARITY_RUNS:
        cfg = get_config(arch, smoke=True, dtype=torch.float32)
        params = init_lm(cfg, torch.Generator().manual_seed(0))
        for label, n_pages, page_size, lens, drive in PARITY_CASES:
            if label not in labels:
                continue
            tag = f"parity {arch} {label}"
            keys = (*COUNTERS, *KV_PAGING_COUNTERS)
            if label == "pool":
                keys = tuple(k for k in keys if k not in (
                    "pages_out", "fused_kernel_passes", "fused_kernel_bytes"))
            tokens, counts = {}, {}
            for dev in ("cuda", "cpu"):
                vol = (make_volume(n_lbas=4096, n_shards=2, aio_workers=2,
                                   cache_bytes=1 << 22)
                       if label == "pager" else None)
                pool = SharedEvictionPool(4, name="parity") \
                    if label == "pool" else None
                try:
                    cache_cfg = PagedCacheConfig(
                        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.hd, page_size=page_size,
                        n_pages=n_pages, max_pages_per_seq=16,
                        host_pages=0 if vol is not None else 1024,
                        dtype=cfg.dtype)
                    eng = ServeEngine(
                        cfg, _to(params, dev), max_batch=2, device=dev,
                        pager=KVPager(vol) if vol is not None else None,
                        cache_cfg=cache_cfg)
                    batches = None
                    if pool is not None:
                        eng.cache = PagedKVCache(cache_cfg,
                                                 metrics=eng.metrics,
                                                 evict_pool=pool, device=dev)
                        eng.lm = PagedLM(cfg, eng.lm.params, eng.cache)
                        batches = timed_evictions(eng.cache)
                    vol_reads = count_vol_page_reads(eng.cache)
                    rng = np.random.default_rng(1)
                    reqs = [eng.submit(rng.integers(2, cfg.vocab,
                                                    size=n).tolist(),
                                       max_new_tokens=8) for n in lens]
                    spent = timed_engine(torch, eng)
                    calls = timed_transit(torch, eng)
                    _, _, launched = run_counted(torch, eng, **drive)
                    if pool is not None:
                        check(eng.cache.drain_evictions(), f"{tag}: drain")
                        torch.cuda.synchronize()
                        launched = _build.launch_counts()
                    untime(eng)
                    untime_transit(eng)
                    check(all(r.done for r in reqs), f"{tag}: unfinished")
                    free = eng.cache._free
                    check(len(free) == len(set(free)) == n_pages
                          and len(eng.cache.host) == 0
                          and (vol is None
                               or eng.cache.pager.stats()["records"] == 0),
                          f"{tag} ({dev}): pages freed twice, or pages, host "
                          f"entries or records left behind")
                finally:
                    if vol is not None:
                        vol.close()
                    if pool is not None:
                        pool.close()
                tokens[dev] = [r.out_tokens for r in reqs]
                counts[dev] = {k: eng.metrics.count.get(k, 0) for k in keys}
                counts[dev]["vol_page_reads"] = len(vol_reads)
                if dev == "cuda":
                    check_path_counts(f"{tag} (cuda)", cfg, spent, launched,
                                      dict(eng.metrics.count),
                                      transit_summary(calls),
                                      pool_batches=batches)
                    launches[f"{arch} {label}"] = launched
            check(tokens["cuda"] == tokens["cpu"], f"{tag}: cuda "
                  f"{tokens['cuda']} != cpu {tokens['cpu']}")
            check(counts["cuda"] == counts["cpu"], f"{tag}: counters "
                  f"cuda {counts['cuda']} != cpu {counts['cpu']}")
            c = counts["cuda"]
            check(c["transit_crc_errors"] == 0, f"{tag}: crc errors")
            if label in ("roomy", "pool"):
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
# attention); a 6-page pool behind a pager with no host budget, where
# suspending both running requests at once makes the second resume stall
# right after promoting a spilled page with spilled pages behind it, so
# decode reads those through the hybrid path without promoting them; and
# the roomy pool with an eviction pool, a request suspended every 3 ticks
PARITY_CASES = [
    ("roomy", 64, 8, (12, 20, 9), {"suspend_at": 2}),
    ("bypass", 2, 4, (12, 20, 9), {"suspend_at": 2}),
    ("pager", 6, 4, (8, 16, 9), {"suspend_at": 5, "suspend_all": True}),
    ("pool", 64, 8, (12, 20, 9), {"suspend_every": 3}),
]
# (arch, its PARITY_CASES): internlm2-1.8b and deepseek-coder-33b SMOKE
# (hd 8, n_rep 7 on the SIMT flash kernel and the paged kernel) in the
# roomy pool, deepseek's also with the eviction pool
PARITY_RUNS = [(QWEN, ("roomy", "bypass", "pager")),
               (PHI3, ("roomy", "bypass", "pager")),
               (INTERNLM2, ("roomy",)),
               (DEEPSEEK, ("roomy", "pool"))]


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

# ------------------------------------------------------ phase 20: the mesh
# The mesh's two legs run on a world-size-1 NCCL process group (a file
# rendezvous in a temporary directory) folded into (data 1, model 1) by
# ``launch.mesh.make_local_mesh``: moonshot's (``MESH_ARCH``) beside phase
# 10, while its weights are on the card; phi3's train steps after phase 19.
MESH_ARCH = MOONSHOT
MESH = {}


def open_mesh(torch) -> None:
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    MESH["dir"] = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", init_method=f"file://{MESH['dir']}/pg",
                            rank=0, world_size=1)
    MESH["mesh"] = make_local_mesh(1)
    log(f"mesh: NCCL process group of 1 rank, mesh "
        f"{dict(zip(MESH['mesh'].mesh_dim_names, MESH['mesh'].shape))}")


def close_mesh() -> None:
    import shutil
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(MESH.pop("dir", ""), ignore_errors=True)
    MESH.pop("mesh", None)


def mesh_params(torch, params):
    """The parameters as DTensors of ``parallel.param_spec_tree``'s
    placements on the mesh, wrapping each tensor with no copy (checked:
    the same storage, no byte more allocated)."""
    from repro_torch.parallel import distribute_tree, param_spec_tree
    mesh = MESH["mesh"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pd = distribute_tree(params, param_spec_tree(params, mesh), mesh)
    same = all(d.to_local().data_ptr() == t.data_ptr()
               for d, t in zip(_leaves(pd), _leaves(params)))
    grown = torch.cuda.memory_allocated() - before
    check(same and grown == 0, f"mesh: the weights were copied ({grown} "
          f"bytes more, same storage {same})")
    return pd


def mesh_serve(torch, np, model, params, batch, B: int, T: int, steps: int,
               profiled: int, off: dict) -> dict:
    """Phase 10's run again through the mesh (``ctx``): the weights
    wrapped as DTensors with no copy, ``prefill`` and ``decode_step``
    with the cache a tree of DTensors (its S over ``model``), the same
    prompts and greedy steps.  Tokens must equal the off-mesh run's; a
    prefill launches the flash kernel once a layer, a step the paged
    kernel once a layer (the S-sharded branch) and the MoE's ``local_map``
    branch once a layer."""
    from repro_torch.kernels import _build
    from repro_torch.models import layers
    from repro_torch.parallel import make_ctx
    t_leg = time.perf_counter()
    cfg = model.cfg
    tag = f"mesh {cfg.name}"
    ctx = make_ctx(MESH["mesh"], B)
    torch.cuda.reset_peak_memory_stats()
    pd = mesh_params(torch, params)
    n_self = attention_layers(cfg)[0]
    _build.reset_launch_counts()
    moe0 = layers.MOE_MESH_CALLS[0]
    t0 = time.perf_counter()
    logits, cache = model.prefill(pd, batch, ctx=ctx, s_max=T + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = dict(_build.launch_counts())
    moe_pre = layers.MOE_MESH_CALLS[0] - moe0
    check(pre.get("flash_attention", 0) == n_self
          and pre.get("flash_attention_tc", 0) == n_self
          and pre.get("paged_attention", 0) == 0 and moe_pre == cfg.n_layers,
          f"{tag}: prefill launches {pre}, MoE mesh calls {moe_pre}")
    out_logits = [logits.full_tensor()]
    state = {"i": 0, "cache": cache, "tok": out_logits[0].argmax(-1)}

    def step():
        i = state["i"]
        lg, state["cache"] = model.decode_step(
            pd, state["cache"], state["tok"], np.full(B, T + i), ctx=ctx)
        lg = lg.full_tensor()
        state["tok"] = lg.argmax(-1)
        state["i"] = i + 1
        out_logits.append(lg)

    _build.reset_launch_counts()
    moe0 = layers.MOE_MESH_CALLS[0]
    t0 = time.perf_counter()
    for _ in range(steps - profiled):
        step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    prof = profile_window(torch, step, profiled)
    dec = dict(_build.launch_counts())
    moe_dec = layers.MOE_MESH_CALLS[0] - moe0
    check(dec.get("paged_attention", 0) == steps * n_self
          and dec.get("flash_attention", 0) == 0
          and moe_dec == steps * cfg.n_layers,
          f"{tag}: decode launches {dec}, MoE mesh calls {moe_dec} for "
          f"{steps} steps")
    peak = torch.cuda.max_memory_allocated()
    lg = torch.stack(out_logits)
    check(bool(torch.isfinite(lg).all()), f"{tag}: logits not finite")
    tokens = lg.argmax(-1).T.tolist()
    check(tokens == off["tokens"], f"{tag}: greedy tokens differ from the "
          f"off-mesh run's")
    pos = cache["pos"].full_tensor()
    check(bool((pos == torch.arange(T + steps, device="cuda")).all()),
          f"{tag}: cache positions not 0..{T + steps - 1} in every row")
    res = {"arch": cfg.name, "B": B, "prompt_tokens": T,
           "decode_steps": steps, "peak_gb": peak / 1e9,
           "off_mesh_peak_gb": off["peak_gb"], "prefill_s": prefill_s,
           "off_mesh_prefill_s": off["prefill_s"],
           "decode_tok_s": B * (steps - profiled) / decode_s,
           "decode_step_ms": decode_s / (steps - profiled) * 1e3,
           "off_mesh_decode_tok_s": off["decode_tok_s"],
           "off_mesh_decode_step_ms": off["decode_step_ms"],
           "profile": prof, "off_mesh_profile": off["profile"],
           "flash_per_prefill": pre.get("flash_attention", 0),
           "paged_per_step": dec.get("paged_attention", 0) / steps,
           "moe_mesh_calls_per_step": moe_dec / steps,
           "cache_k_placements": [str(p) for p in cache["k"].placements],
           "tokens_equal_off_mesh": True,
           "leg_s": time.perf_counter() - t_leg,
           "launches": {k: pre.get(k, 0) + dec.get(k, 0)
                        for k in set(pre) | set(dec)}}
    op = off["profile"]
    log(f"{tag}: tokens equal the off-mesh run's; peak {peak / 1e9:.2f} GB "
        f"(off the mesh {off['peak_gb']:.2f} GB); prefill {prefill_s:.3f} s "
        f"({off['prefill_s']:.3f}); decode {res['decode_tok_s']:.2f} tok/s, "
        f"{res['decode_step_ms']:.1f} ms a step ({off['decode_tok_s']:.2f} "
        f"tok/s, {off['decode_step_ms']:.1f} ms); profiled step "
        f"{prof['step_ms']:.1f} ms ({op['step_ms']:.1f}), busy "
        f"{prof['device_busy_ms_per_step']:.2f} ms "
        f"({op['device_busy_ms_per_step']:.2f}), idle share "
        f"{prof['device_idle_share']} ({op['device_idle_share']}), "
        f"{prof['device_ops_per_step']:.0f} device ops a step "
        f"({op['device_ops_per_step']:.0f}); flash a prefill "
        f"{res['flash_per_prefill']}, paged a step {res['paged_per_step']}, "
        f"MoE local_map calls a step {res['moe_mesh_calls_per_step']}; "
        f"the leg {res['leg_s']:.1f} s")
    del out_logits, lg, logits, cache, state, pd
    return res


# the mesh's train leg: phi3-mini-3.8b's widths, depth cut to one layer
MESH_TRAIN = dict(arch=PHI3, B=4, T=1024, n_layers=1, steps=2)


def mesh_train(torch, np) -> dict:
    """phi3-mini-3.8b at full width (d 3072, 32:32 heads of 96, d_ff
    8192, vocab 32064) cut to one layer, bf16, remat "dots": two
    ``make_train_step(model, opt, ctx=ctx, grad_compression="int8")``
    steps of 4 x 1024 tokens on the mesh (the parameters and moments
    DTensors; the gradients reduced exactly, then through the int8 ring,
    which over one data rank hands them back unchanged) against two
    off-mesh steps from the same state.  Losses within rtol 1e-4,
    parameters within ``ROW_TOL["bf16"]`` row by row, 2 tensor-core
    flash launches a step (the layer's forward and its recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamW, tree_map
    from repro_torch.parallel import make_ctx
    from repro_torch.train import make_train_step
    c = MESH_TRAIN
    t_leg = time.perf_counter()
    before = torch.cuda.memory_allocated()
    check(before < 1e9, f"{before / 1e9:.2f} GB allocated before the mesh "
          f"train leg")
    cfg = get_config(c["arch"], n_layers=c["n_layers"])
    reduced = f"depth {get_config(c['arch']).n_layers} -> {c['n_layers']} " \
        f"layer"
    model = build_model(cfg)
    tag = f"mesh train {cfg.name}"
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab, (c["B"], c["T"]),
                                 generator=g, device="cuda")
                for k in ("tokens", "targets")} for _ in range(c["steps"])]
    opt = AdamW()
    p_off = tree_map(torch.clone, params)
    s_off = opt.init(p_off)
    step_off = make_train_step(model, opt)
    ctx = make_ctx(MESH["mesh"], c["B"])
    pd = mesh_params(torch, params)
    sd = opt.init(pd)
    step_mesh = make_train_step(model, opt, ctx=ctx, grad_compression="int8")
    rows = {"off": [], "mesh": []}
    for b in batches:
        for leg, fn in (("off", step_off), ("mesh", step_mesh)):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if leg == "off":
                p_off, s_off, m = fn(p_off, s_off, b)
            else:
                pd, sd, m = fn(pd, sd, b)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n = dict(_build.launch_counts())
            check(n.get("flash_attention_tc", 0) == 2 * cfg.n_layers
                  and n.get("flash_attention", 0) == 2 * cfg.n_layers,
                  f"{tag} ({leg}): flash launches {n}")
            rows[leg].append({"loss": loss, "step_ms": ms, "launches": n})
    for a, b in zip(rows["off"], rows["mesh"]):
        check(math.isfinite(a["loss"]) and abs(b["loss"] - a["loss"])
              <= 1e-4 * abs(a["loss"]), f"{tag}: losses {b['loss']} on the "
              f"mesh, {a['loss']} off it")
    worst = 0.0
    for d, t in zip(_leaves(pd), _leaves(p_off)):
        d, t = d.full_tensor().detach(), t.detach()
        worst = max(worst, row_rel_err(d, t) if t.dim()
                    else float((d - t).abs()))
    check(worst <= ROW_TOL["bf16"], f"{tag}: parameter row error {worst:.3g}"
          f" > {ROW_TOL['bf16']}")
    res = {"arch": cfg.name, "reduced": reduced, "B": c["B"], "T": c["T"],
           "steps": rows, "max_param_row_rel_err": worst,
           "leg_s": time.perf_counter() - t_leg,
           "launches": {k: sum(r["launches"].get(k, 0) for r in rows["mesh"])
                        for k in rows["mesh"][0]["launches"]}}
    log(f"{tag} ({reduced}): {c['steps']} int8-compressed steps of "
        f"{c['B']} x {c['T']} on the mesh, losses "
        f"{[r['loss'] for r in rows['mesh']]} (off the mesh "
        f"{[r['loss'] for r in rows['off']]}), step ms "
        f"{[round(r['step_ms'], 1) for r in rows['mesh']]} (off "
        f"{[round(r['step_ms'], 1) for r in rows['off']]}), parameter row "
        f"rel err {worst:.3g}, 2 flash launches a step; the leg "
        f"{res['leg_s']:.1f} s")
    del pd, sd, p_off, s_off, batches
    release_weights(torch, params, c["arch"])
    return res



# ---------------------------------------------------- phase 21: the dry run
# Production cells at full width on fake process groups (the card's
# machine has its own torch, whose fake backend, DTensor and fake tensors
# must trace them), and phase 17's step traced at world size 1 against
# what phase 17 held and measured on the card.  Each train cell's counted
# arguments and temporaries must fit one card (``CARD_BYTES``): its loss
# reduces over the vocab shards, where logits gathered whole over
# ``model`` would not fit.  deepseek's 56 heads do not divide 16: its
# blocks run sequence-parallel, and its temporaries are held to the
# reference's (``REFERENCE_TEMPS``).  xlstm-1.3b's sLSTM runs its
# recurrence as one op (``models/slstm_op.py``) and its mLSTM its chunk
# loop as two (``models/mlstm_op.py``), counted by formula: its train
# step's temporaries are held within ``TRAIN_TEMP_FACTOR`` of the
# reference's.  whisper-large-v3's encoder (1500 frames, 20 heads, neither
# divided by 16) runs its attention split by query rows, and its FLOPs
# are held to the reference's (``REFERENCE_FLOPS``).  A prefill cell's
# arguments and temporaries must fit the
# card too, each rank allocating only its shard of the cache, and its
# temporaries less its outputs (the cache, which the reference counts as
# output bytes) must stay within ``TEMP_FACTOR`` of the reference's
# temporaries
DRYRUN_CELLS = [(PHI3, "train_4k", False), (MOONSHOT, "decode_32k", True),
                (RGEMMA, "train_4k", False), (XLSTM, "decode_32k", False),
                (XLSTM, "train_4k", False),
                (VISION, "decode_32k", False), (QWEN, "train_4k", False),
                (DEEPSEEK, "train_4k", False), (PHI3, "prefill_32k", False),
                (DEEPSEEK, "prefill_32k", False),
                (WHISPER, "train_4k", False)]
CARD_BYTES = 80e9
# the reference's temporaries per device on (16, 16), counted by
# ``scripts/reference_cells.py`` (its ``build_cell`` compiled on the CPU,
# jax 0.9.0)
REFERENCE_TEMPS = {(DEEPSEEK, "train_4k"): 95.674e9,
                   (XLSTM, "train_4k"): 11.073156296e9,
                   (PHI3, "prefill_32k"): 3.688366856e9,
                   (DEEPSEEK, "prefill_32k"): 14.13829532e9}
TEMP_FACTOR = 2.5
# how far past the reference's temporaries a train cell's may go:
# deepseek's sequence-parallel blocks stay under the reference's own;
# xlstm's chunk loops keep their chunk states, not autograd's saves
TRAIN_TEMP_FACTOR = {(DEEPSEEK, "train_4k"): 1.0,
                     (XLSTM, "train_4k"): 1.8}
# the reference's FLOPs per device on (16, 16), counted by
# ``scripts/reference_cells.py``: whisper's encoder attention split over
# ``model`` by query rows may count no more
REFERENCE_FLOPS = {(WHISPER, "train_4k"): 47.196e12}


def dryrun_terms(arch: str, shape_name: str, mesh_shape: dict) -> dict:
    """FLOPs per device, from the config, of the work that ran whole over
    ``model`` before the recurrent mixers and the decode's
    cross-attention were split over it (``removed``) and of what still
    runs whole (``kept``: the sLSTM's recurrence, 2 T H dh (dh + 2) a
    batch row), each (tp - 1) / tp of it past the reference's partition
    on a rank; ``tests/test_torch_dryrun.py`` holds the kept term at
    SMOKE widths.  The removed terms: the mLSTM's products, 2 T d (5 d +
    2 H), and its per-head core; the sLSTM's, 2 T d (3 d + 2 H), and its
    recurrence; the RG-LRU's, 2 T (3 d R + 2 R^2); the decode's
    cross-attention, 4 hd a query head and key.  A train step runs a
    layer 4 times under remat (3 outside it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import SHAPES
    cfg, shape = get_config(arch), SHAPES[shape_name]
    T = 1 if shape.kind == "decode" else shape.seq
    tp = mesh_shape["model"]
    rows = shape.batch // math.prod(n for k, n in mesh_shape.items()
                                    if k != "model")
    share = (1 - 1 / tp) * rows
    d, H = cfg.d_model, cfg.n_heads
    passes = 4 if shape.kind == "train" and cfg.remat != "none" else 1
    kept = removed = 0.0
    if cfg.family == "ssm":
        dh = d // H
        rec = 2.0 * T * H * dh * (dh + 2)
        kept = share * (cfg.n_layers // 8) * passes * rec
        if shape.kind == "decode":
            core = H * (2 * dh + 2 * dh * dh)
        else:
            L = min(128, T)
            core = T // L * H * (6 * L * L * dh + 2 * L * dh * dh + 2 * L * dh)
            core += T // L * H * (2 * L * dh * dh + 2 * L * dh)
        mlstm = 2.0 * T * d * (5 * d + 2 * H) + core
        slstm = 2.0 * T * d * (3 * d + 2 * H) + rec
        removed = share * (cfg.n_layers // 8) * passes * (7 * mlstm + slstm)
    elif cfg.family == "hybrid":
        R = cfg.lru_width or d
        groups, rest = divmod(cfg.n_layers, 3)
        per = 2.0 * T * (3 * d * R + 2 * R * R)
        n = (passes * 2 * groups + 3 * min(rest, 2) if shape.kind == "train"
             else 2 * groups + min(rest, 2))
        removed = share * per * n
    elif cfg.family in ("encdec", "vlm") and shape.kind == "decode":
        n_cross = cfg.n_layers if cfg.family == "encdec" \
            else cfg.n_layers // cfg.cross_every
        s_x = cfg.enc_seq if cfg.family == "encdec" else cfg.n_img_tokens
        removed = share * 4.0 * cfg.hd * H * s_x * n_cross
    return {"kept": kept, "removed": removed}


def hold_dryrun_cell(arch: str, shape: str, rec: dict, res: dict) -> None:
    """One record of phase 21: ``status: OK``, its counts printed and kept
    in ``res``, a train or prefill cell held to ``CARD_BYTES`` and to the
    reference's temporaries where ``REFERENCE_TEMPS`` has them."""
    import torch.distributed as dist
    cell = f"{arch} {shape} {rec['mesh']}"
    check(rec["status"] == "OK", f"dry run {cell}: {rec['status']} "
          f"{rec.get('error')}\n{rec.get('traceback')}")
    check(not dist.is_initialized(), f"dry run {cell}: its fake "
          f"process group was left open")
    hc, mem = rec["hlo_cost"], rec["memory"]
    res["cells"][cell] = {k: rec[k] for k in (
        "status", "trace_s", "n_devices", "cost", "memory",
        "collectives", "hlo_cost", "attention")}
    terms = dryrun_terms(arch, shape, dict(zip(
        ("pod", "data", "model")[-len(rec["mesh"].split("x")):],
        map(int, rec["mesh"][len("pod"):].split("x")))))
    res["cells"][cell]["terms"] = terms
    if terms["kept"] or terms["removed"]:
        log(f"dry run {cell}: {hc['flops'] / 1e12:.4f} TFLOP "
            f"counted; whole over model, by the config's "
            f"formulas: kept {terms['kept'] / 1e12:.4f} TFLOP (the "
            f"sLSTM's recurrence), removed "
            f"{terms['removed'] / 1e12:.4f} TFLOP (the mixers' or "
            f"the decode cross-attention's work, now split)")
    log(f"dry run {cell} (counted, per device of "
        f"{rec['n_devices']}): {hc['flops'] / 1e12:.3f} TFLOP, "
        f"{hc['bytes'] / 1e9:.2f} GB moved, "
        f"{hc['wire_bytes'] / 1e9:.3f} GB on the wire, "
        f"{hc['ops']} ops; arguments "
        f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, temporaries "
        f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, outputs "
        f"{mem['output_size_in_bytes'] / 1e9:.3f} GB (aliased "
        f"{mem['alias_size_in_bytes'] / 1e9:.3f}); traced in "
        f"{rec['trace_s']} s")
    ref_flops = REFERENCE_FLOPS.get((arch, shape))
    if ref_flops is not None:
        check(hc["flops"] <= ref_flops, f"dry run {cell}: "
              f"{hc['flops'] / 1e12:.3f} TFLOP a device, past the "
              f"reference's {ref_flops / 1e12:.3f}")
        log(f"dry run {cell}: {hc['flops'] / 1e12:.3f} TFLOP a device, "
            f"{hc['flops'] / ref_flops:.3f} x the reference's "
            f"{ref_flops / 1e12:.3f}")
    temps = mem["temp_size_in_bytes"]
    held = mem["argument_size_in_bytes"] + temps
    ref = REFERENCE_TEMPS.get((arch, shape))
    if shape == "prefill_32k":
        outs = mem["output_size_in_bytes"]
        check(held <= CARD_BYTES, f"dry run {cell}: arguments + "
              f"temporaries {held / 1e9:.3f} GB a device, past "
              f"the card's {CARD_BYTES / 1e9:.0f} GB")
        check(temps - outs <= TEMP_FACTOR * ref, f"dry run {cell}: "
              f"temporaries less outputs {(temps - outs) / 1e9:.3f}"
              f" GB a device, past {TEMP_FACTOR} x the reference's "
              f"{ref / 1e9:.3f} GB")
        log(f"dry run {cell}: arguments + temporaries "
            f"{held / 1e9:.3f} GB a device, within "
            f"{CARD_BYTES / 1e9:.0f} GB; temporaries "
            f"{temps / 1e9:.3f} GB, of which outputs (the cache "
            f"and the logits) {outs / 1e9:.3f} GB; less the "
            f"outputs {(temps - outs) / ref:.2f} x the "
            f"reference's {ref / 1e9:.3f} GB")
    elif shape == "train_4k":
        if ref is not None:
            limit = TRAIN_TEMP_FACTOR[(arch, shape)] * ref
            check(temps <= limit, f"dry run {cell}: temporaries "
                  f"{temps / 1e9:.3f} GB a device, past "
                  f"{limit / 1e9:.3f} GB, "
                  f"{TRAIN_TEMP_FACTOR[(arch, shape)]} x the "
                  f"reference's {ref / 1e9:.3f} GB")
            log(f"dry run {cell}: temporaries {temps / 1e9:.3f} "
                f"GB a device, {temps / ref:.2f} x the "
                f"reference's {ref / 1e9:.3f} GB (at most "
                f"{TRAIN_TEMP_FACTOR[(arch, shape)]})")
        check(held <= CARD_BYTES, f"dry run {cell}: arguments + "
              f"temporaries {held / 1e9:.3f} GB a device, past "
              f"the card's {CARD_BYTES / 1e9:.0f} GB")
        log(f"dry run {cell}: arguments + temporaries "
            f"{held / 1e9:.3f} GB a device, within "
            f"{CARD_BYTES / 1e9:.0f} GB")


def dryrun_phase(torch, train: dict) -> dict:
    """(a) ``launch.dryrun.run_cell`` for each of ``DRYRUN_CELLS``: every
    record ``status: OK``, a train or prefill cell's arguments + temporaries within
    ``CARD_BYTES``, a train cell's temporaries within
    ``TRAIN_TEMP_FACTOR`` of the reference's and a prefill cell's less
    its outputs within ``TEMP_FACTOR`` (``hold_dryrun_cell``); prints per
    device the counted FLOPs, bytes, wire bytes, argument, output and
    temporary bytes and the trace's seconds.
    (b) ``trace_cell`` of phase 17's step (phi3-mini-3.8b FULL, 4 x 1024
    tokens, remat "dots", AdamW, one device) on fake tensors: the counted
    bytes of the parameters and the AdamW state must equal those phase 17
    held on the card; the counted peak (arguments + temporaries) beside
    phase 17's ``max_memory_allocated`` and the counted FLOPs beside the
    products of its step's bound.  Nothing here touches the card; every
    counted number is counted, not measured."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.dryrun import run_cell, trace_cell
    from repro_torch.models import ShapeCfg
    check(not dist.is_initialized(), "dry run: a process group is still "
          "open (close phase 20's mesh first)")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    res = {"cells": {}, "launches": {}}
    try:
        for arch, shape, multi_pod in DRYRUN_CELLS:
            hold_dryrun_cell(arch, shape, run_cell(
                arch, shape, multi_pod, out_dir), res)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    shape = ShapeCfg("train_phase17", "train", TRAIN["T"], TRAIN["B"])
    rec = trace_cell(TRAIN["arch"], shape, None, {})
    mem, hc = rec["memory"], rec["hlo_cost"]
    params_b, opt_b, batch_b = mem["argument_bytes_by_input"]
    state_b = params_b + opt_b
    check(state_b == train["state_argument_bytes"], f"dry run: counted "
          f"parameters + AdamW state {state_b} bytes, phase 17 held "
          f"{train['state_argument_bytes']}")
    counted_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    bound_flops = (train["model_tflop"] + train["attention_tflop"]) * 1e12
    res["phase17"] = {
        "trace_s": rec["trace_s"], "cost": rec["cost"], "memory": mem,
        "hlo_cost": hc, "state_argument_bytes": state_b,
        "measured_state_argument_bytes": train["state_argument_bytes"],
        "counted_peak_bytes": counted_peak,
        "measured_peak_bytes": train["peak_bytes"],
        "counted_flops": hc["flops"], "bound_product_flops": bound_flops}
    log(f"dry run of phase 17's step (counted on fake tensors, one "
        f"device): parameters + AdamW state {state_b / 1e9:.3f} GB, equal "
        f"to phase 17's on the card; batch {batch_b} bytes; peak "
        f"{counted_peak / 1e9:.2f} GB counted (arguments + "
        f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB of temporaries) against "
        f"{train['peak_bytes'] / 1e9:.2f} GB measured; "
        f"{hc['flops'] / 1e12:.2f} TFLOP counted against the bound's "
        f"{bound_flops / 1e12:.2f} TFLOP of products; "
        f"{hc['bytes'] / 1e9:.1f} GB moved, {hc['ops']} ops; traced in "
        f"{rec['trace_s']} s")
    return res


# phase 22: every ported example once, each a subprocess from a fresh
# directory; serve_paged_torch.py on the card with the spill tier, so
# that a page-out and a page-in both run the codec, its kernels' launches
# counted in that process
EXAMPLES = ("quickstart", "crash_recovery", "multi_tenant_volume",
            "async_qd", "autotune_phase_change", "limping_shard",
            "cluster_quickstart", "serve_paged")
SERVE_EXAMPLE_ARGS = ("--spill-volume", "--host-pages", "1",
                      "--suspend-every", "3")
_COUNTED_RUN = """
import json, runpy, sys
from repro_torch.kernels import _build
sys.argv = sys.argv[1:]
_build.reset_launch_counts()
runpy.run_path(sys.argv[0], run_name="__main__")
print("launches " + json.dumps(_build.launch_counts()))
"""


def examples_phase() -> dict:
    """Each of ``EXAMPLES`` (``examples/<name>_torch.py``) run once as a
    subprocess under a 300 s limit: its exit code and seconds printed, a
    non-zero exit a failure.  ``serve_paged_torch.py`` runs on the
    card's default device with ``SERVE_EXAMPLE_ARGS``: its ``[serve]``
    line must say cuda, and flash, paged attention and both codec
    kernels must have launched."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = {"examples": {}, "launches": {}}
    for name in EXAMPLES:
        path = ROOT / "examples" / f"{name}_torch.py"
        cmd = [sys.executable, str(path)]
        if name == "serve_paged":
            cmd = [sys.executable, "-c", _COUNTED_RUN, str(path),
                   *SERVE_EXAMPLE_ARGS]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as cwd:
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                                 text=True, timeout=300)
            dt = time.perf_counter() - t0
        log(f"example {name}_torch.py: exit {run.returncode} in {dt:.2f} s")
        check(run.returncode == 0, f"example {name}_torch.py exited "
              f"{run.returncode}:\n{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
        lines = run.stdout.splitlines()
        res["examples"][name] = {"exit": run.returncode,
                                 "seconds": round(dt, 2)}
        if name != "serve_paged":
            continue
        counts = json.loads(next(ln for ln in lines
                                 if ln.startswith("launches "))[9:])
        serve = next(ln for ln in lines if ln.startswith("[serve]"))
        log(f"example serve_paged_torch.py: {serve}; launches {counts}")
        check(" on cuda" in serve, f"serve_paged_torch.py: {serve}")
        got = kernel_launches(counts)
        for k in ("paged_attention", "gather_quantize_crc",
                  "scatter_dequantize_crc"):
            check(got.get(k, 0) > 0, f"serve_paged_torch.py: {k} never "
                  f"launched ({counts})")
        check(counts.get("flash_attention", 0) > 0, f"serve_paged_torch.py:"
              f" flash attention never launched ({counts})")
        res["launches"] = counts
        res["serve_line"] = serve
    return res


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
    check_paged_contiguous(torch, rng, results)
    check_codec(torch, rng, results)
    check_flash_attention(torch, rng, results)
    t0 = time.perf_counter()
    check_paged_lse(torch, rng, results)
    check_flash_offset(torch, rng, results)
    log(f"the mesh's kernel arguments checked in "
        f"{time.perf_counter() - t0:.1f} s")
    time_kernels(torch, rng, results)
    dispatch = dispatch_cost(torch, rng)
    slstm = check_slstm_op(torch, np.random.default_rng(1))
    mlstm = check_mlstm_op(torch, np.random.default_rng(2))
    torch.cuda.synchronize()

    cfg, params = init_full(torch, QWEN)
    paths = {"serve": serve_full(torch, np, cfg, params, profile=True)}
    torch.cuda.synchronize()
    paths["long_prompts"] = long_prompts(torch, np, cfg, params)
    torch.cuda.synchronize()
    paths["spill"] = spill_full(torch, np, cfg, params)
    release_weights(torch, params, QWEN)
    cfg, params = init_full(torch, PHI3)
    paths["serve_phi3"] = serve_full(torch, np, cfg, params, profile=False)
    release_weights(torch, params, PHI3)
    cfg, params = init_full(torch, INTERNLM2)
    paths["pool_evict"], paths["pool_log"] = pool_full(
        torch, np, cfg, params, paths["serve"]["transit"])
    release_weights(torch, params, INTERNLM2)
    paths["serve_deepseek"] = serve_deepseek(torch, np)
    # the model API (build_model's prefill and decode_step) at full width,
    # each after the previous weights are freed
    open_mesh(torch)
    for label, arch, B, T, steps, overrides, reduced in MODEL_RUNS:
        key = f"model_{label.replace('-', '_')}"
        paths[key] = serve_model(torch, np, arch, B, T, steps,
                                 reduced=reduced, **overrides)
        if "mesh_leg" in paths[key]:
            paths[f"mesh_{label}"] = paths[key].pop("mesh_leg")
    # training at full width, once every other phase's weights are freed
    paths["train"] = train_full(torch, np)
    paths["train_ckpt"] = train_ckpt(torch, np)
    paths["mesh_train"] = mesh_train(torch, np)
    close_mesh()
    paths["dryrun"] = dryrun_phase(torch, paths["train"])
    paths["examples"] = examples_phase()
    parity = parity_smoke(torch, np)
    model_parity = parity_models(torch, np)
    train_parity = parity_train(torch, np)
    torch.cuda.synchronize()

    # launches of each kernel on the paths of phases 3-7, each counted
    # alone: the full-width paths and the SMOKE f32 parity runs
    by_path = {k: kernel_launches(p["launches"]) for k, p in paths.items()}
    by_path.update({f"parity {k}": kernel_launches(c)
                    for k, c in parity.items()})
    by_path.update({f"model parity {k}": kernel_launches(c)
                    for k, c in model_parity.items()})
    by_path["train parity"] = kernel_launches(train_parity)
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
                    "library_ms", "ms_from", "plain_ms_from", "ms_profiles",
                    "plain_ms_profiles", "call_ms", "plain_call_ms")},
                **{k: results[name][k] for k in (
                    "max_row_rel_err", "at_shapes") if k in results[name]}}

    line = {"kernels": [row(name, *v) for name, v in KERNELS.items()]}
    variants = {"variants_off_the_path": [
        row(name, "src/repro_torch/kernels/csrc/block_transit.cu", rep)
        for name, rep in (
            ("gather_quantize", "src/repro/kernels/block_transit.py:50"),
            ("scatter_dequantize",
             "src/repro/kernels/block_transit.py:157"))]}
    card = card_line()
    log(f"total {time.perf_counter() - t_all:.1f} s")
    for key, p in paths.items():
        print(json.dumps({key: {k: v for k, v in p.items()
                                if k != "launches"}}))
    print(json.dumps({"parity_launches": parity,
                      "model_parity_launches": model_parity,
                      "train_parity_launches": train_parity}))
    print(json.dumps({"flash_launches_by_path": {
        k: {"calls": c.get("flash_attention", 0)
            + c.get("flash_attention_tc", 0),
            "tensor_core": c.get("flash_attention_tc", 0),
            "simt": c.get("flash_attention", 0)}
        for k, c in by_path.items()}}))
    print(json.dumps({"paged_dispatch": dispatch}))
    print(json.dumps({"slstm_op": slstm}))
    print(json.dumps({"mlstm_op": mlstm}))
    print(json.dumps(variants))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
