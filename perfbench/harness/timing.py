"""Host clocks and the device trace of a run.

``Recorder`` wraps the calls into each layer of the program: the model's
prefill and decode step, the cache's page-out (``deactivate``) and
page-in (``activate``), and the engine's sampling.  In a traced run each
call is timed on synchronised host clocks (as ``chip_smoke.py``'s
``timed_engine`` and ``timed_transit`` do, copied) and labelled for the
profiler (``record_function``), so that an idle gap of the device can be
put down to what the host was doing.

``Slice`` profiles the last few seconds of the window (torch.profiler,
CUPTI), so that the profiler's collection, which takes seconds, falls
after the close, and reduces the trace in memory: device busy time as the union of the device
ops' intervals (``chip_smoke.py``'s ``profile_window``, copied), device
seconds by kernel, and idle seconds by the host span they fell in.
"""
from __future__ import annotations

import time

OUTSIDE = "scheduler_harness"      # the host in none of the spans below
FLASH_KERNEL = "flash_attention"   # flash_attention_tc_kernel and the SIMT one
PAGED_KERNEL = "paged_attention"   # the split and the combine launches
NAME_CHARS = 100                   # a device op's name as the breakdown has it


class Recorder:
    """Per call: what it worked on and its synchronised host seconds."""

    def __init__(self, eng, torch):
        self.torch = torch
        self.count = eng.cache.metrics.count
        self.prefill = []       # (sid, T, t0, t1)
        self.decode = []        # (lens after the step's append, t0, t1)
        self.page_out = []      # (pages moved, t0, t1)
        self.page_in = []
        self._wrap(eng.lm, "prefill", "prefill", self._prefill)
        self._wrap(eng.lm, "decode_step", "decode_step", self._decode)
        self._wrap(eng.cache, "deactivate", "page_out",
                   self._moved(self.page_out), "pages_out")
        self._wrap(eng.cache, "activate", "page_in",
                   self._moved(self.page_in), "pages_in")

    def _wrap(self, obj, name, label, log, counter=None):
        fn = getattr(obj, name)
        rf = self.torch.profiler.record_function
        card = obj.device.type == "cuda"
        sync = self.torch.cuda.synchronize

        def timed(*args):
            with rf(label):
                if card:
                    sync()
                n0 = self.count.get(counter, 0)
                t0 = time.perf_counter()
                out = fn(*args)
                if card:
                    sync()
                t1 = time.perf_counter()
            log(args, self.count.get(counter, 0) - n0, t0, t1)
            return out
        setattr(obj, name, timed)

    def _prefill(self, args, _n, t0, t1):
        tokens, sid = args
        self.prefill.append((sid, len(tokens), t0, t1))

    def _decode(self, args, _n, t0, t1):
        _tokens, _sids, positions = args
        self.decode.append(([int(p) + 1 for p in positions], t0, t1))

    @staticmethod
    def _moved(log):
        return lambda _args, n, t0, t1: log.append((n, t0, t1))


def merge(spans):
    """Sorted (start, end) spans -> the merged busy intervals (the union
    that ``chip_smoke.py``'s ``profile_window`` sums)."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def label_at(t, host):
    """The innermost host span (start, end, label) that holds time t."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return OUTSIDE if best is None else best[2]


class Slice:
    """torch.profiler over a few seconds of the window, reduced in memory."""

    HOST = ("prefill", "decode_step", "sample", "page_out", "page_in")

    def __init__(self, torch, card: bool):
        self.torch = torch
        self.card = card
        self.prof = None
        self.t0 = self.t1 = None
        self.prefills = []      # T of each prefill inside the slice
        self.decodes = []       # lens of each decode step inside it

    def warm(self):
        """One short profile in set-up: the profiler's first start (CUPTI's
        set-up) is paid there and not inside the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.card else [])
        with profile(activities=acts):
            self.torch.ones(8, device="cuda" if self.card else "cpu").sum()
            self._sync()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.card else []))
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def holds_a_call(self) -> bool:
        """Whether the slice has seen a prefill and a decode step, so that
        each kernel's roofline has launches to read."""
        return bool(self.prefills) and bool(self.decodes)

    def _sync(self):
        if self.card:
            self.torch.cuda.synchronize()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        from torch.autograd import DeviceType
        events = self.prof.events()
        # the host spans' labels come back on the device too (as user
        # annotations that cover their kernels): they are not device ops
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in self.HOST]
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events if e.device_type == DeviceType.CPU
                and e.name in self.HOST]
        busy = merge((e.time_range.start, e.time_range.end) for e in dev)
        busy_us = sum(b - a for a, b in busy)
        window_us = (busy[-1][1] - busy[0][0]) if busy else 0.0
        idle: dict[str, float] = {}
        for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
            key = label_at((a + b) / 2, host)
            idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
        by_op: dict[str, float] = {}
        for e in dev:
            name = e.name[:NAME_CHARS]
            by_op[name] = by_op.get(name, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e6

        def kernel_s(part):
            return sum(s for n, s in by_op.items() if part in n)
        self.prof = None
        return {"busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
                "wall_s": self.t1 - self.t0, "device_ops": len(dev),
                "by_op": by_op, "idle_by_span": idle,
                "flash_s": kernel_s(FLASH_KERNEL),
                "paged_s": kernel_s(PAGED_KERNEL),
                "flash_launches": sum(FLASH_KERNEL in e.name for e in dev),
                "paged_launches": sum(PAGED_KERNEL in e.name for e in dev),
                "prefills": list(self.prefills),
                "decodes": [list(x) for x in self.decodes]}
