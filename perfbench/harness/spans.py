"""The program's own spans (``repro_torch.core.trace``) as
the benchmark reads them.

With ``eng.trace.start()`` the engine, its model and its cache
record a span a call or a layer (``engine.step``, ``lm.decode_step``,
``lm.kv_write``, ``lm.attention``, ``kvcache.table``,
``kvcache.page_out.entries``, ``kvcache.page_in.stage``, ...) on
``time.perf_counter_ns``, the harness's clock, and each span also enters
``record_function``, so that it lands in the profiler's trace.  There it
comes back twice: as a host event, which can label a gap of the device,
and as a device-side user annotation stretching from its first kernel to
its last, which is no device op.  ``SpanSlice`` is ``timing.Slice`` with
both rules: annotations are not busy time, and each idle gap is labelled
by the innermost of the wrappers' labels and the program's spans, found
by one sweep (``label_gaps``) instead of a scan of every span for every
gap.  Both are copies of ``timing.Slice.reduce`` and ``timing.label_at``
with those rules: once ``timing.py`` takes the rules, both are deleted,
so that one reducer remains.  ``split`` reduces the spans of a window to
the numbers the decode step and the transit are judged by.
"""
from __future__ import annotations

import heapq

from .timing import FLASH_KERNEL, NAME_CHARS, OUTSIDE, PAGED_KERNEL, Slice, \
    merge

DECODE = "lm.decode_step"
DECODE_PARTS = ("lm.kv_write", "lm.attention")
TABLE = "kvcache.table"


def annotations(events) -> set:
    """The names of ``record_function`` labels: those the profiler marks
    (``is_user_annotation``), or, where its torch lacks the field, those
    that come back on both the host and the device side (a kernel's name
    never names a host event)."""
    if events and hasattr(events[0], "is_user_annotation"):
        return {e.name for e in events if e.is_user_annotation}
    from torch.autograd import DeviceType
    side = {DeviceType.CPU: set(), DeviceType.CUDA: set()}
    for e in events:
        side.get(e.device_type, set()).add(e.name)
    return side[DeviceType.CPU] & side[DeviceType.CUDA]


def label_gaps(points: list, spans: list) -> list:
    """For each time in ``points``, the label of the innermost span
    (start, end, label) that holds it, ends included, as
    ``timing.label_at`` finds it (the shortest; of equal ones the first
    listed), else ``OUTSIDE``: one sweep over both sorted."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    heap, out, j = [], [OUTSIDE] * len(points), 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while j < len(order) and spans[order[j]][0] <= t:
            a, b, _ = spans[order[j]]
            heapq.heappush(heap, (b - a, order[j]))
            j += 1
        while heap and spans[heap[0][1]][1] < t:
            heapq.heappop(heap)
        if heap:
            out[i] = spans[heap[0][1]][2]
    return out


class SpanSlice(Slice):
    """``timing.Slice`` for a run with the program's spans on."""

    HOST = ("prefill", "decode_step", "page_out", "page_in")

    def reduce(self) -> dict:
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        labels = annotations(events) | set(self.HOST)
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events if e.device_type == DeviceType.CPU
                and e.name in labels]
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in labels]
        busy = merge((e.time_range.start, e.time_range.end) for e in dev)
        gaps = [(a, b) for (_, a), (b, _) in zip(busy[:-1], busy[1:])]
        idle: dict[str, float] = {}
        for (a, b), key in zip(gaps, label_gaps(
                [(a + b) / 2 for a, b in gaps], host)):
            idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
        by_op: dict[str, float] = {}
        for e in dev:
            name = e.name[:NAME_CHARS]
            by_op[name] = by_op.get(name, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e6
        self.prof = None
        return {"busy_s": sum(b - a for a, b in busy) / 1e6,
                "window_s": (busy[-1][1] - busy[0][0]) / 1e6 if busy
                else 0.0,
                "wall_s": self.t1 - self.t0, "device_ops": len(dev),
                "annotations": len(labels - set(self.HOST)),
                "by_op": by_op, "idle_by_span": idle,
                "flash_s": sum(s for n, s in by_op.items()
                               if FLASH_KERNEL in n),
                "paged_s": sum(s for n, s in by_op.items()
                               if PAGED_KERNEL in n),
                "prefills": list(self.prefills),
                "decodes": [list(x) for x in self.decodes]}


def _seconds(s) -> float:
    return (s.t1 - s.t0) / 1e9


def split(spans: list, in_window) -> dict:
    """The window's numbers, from spans whose ``t0`` (seconds on the
    harness's clock) ``in_window`` holds: per decode step, the host ms of
    its token writes, its attention calls (their table builds left out),
    its table builds and the rest (its self time); the us a page of the
    page-outs and of their host entries, of the page-ins and of their
    staging; the share of
    the pages paged out that retire paged out; and the window's spans a
    decode step."""
    win = [i for i, s in enumerate(spans)
           if s.t1 is not None and in_window(s.t0 / 1e9)]
    steps = {i for i in win if spans[i].name == DECODE}
    part = {name: 0.0 for name in DECODE_PARTS + (TABLE,)}
    for i in win:
        s = spans[i]
        if s.name in DECODE_PARTS and s.parent in steps:
            part[s.name] += _seconds(s)
        elif s.name == TABLE and s.parent is not None \
                and spans[s.parent].parent in steps:
            part[TABLE] += _seconds(s)
    n = len(steps)
    total = sum(_seconds(spans[i]) for i in steps)

    def per_page(name):
        got = [spans[i] for i in win if spans[i].name == name]
        pages = sum(s.counts["pages"] for s in got)
        return 1e6 * sum(map(_seconds, got)) / pages if pages else None

    outs = [i for i in win if spans[i].name == "kvcache.page_out"]
    out_pages = sum(spans[i].counts["pages"] for i in outs)
    retired = sum(spans[i].counts["pages"] for i in outs
                  if spans[i].parent is not None
                  and spans[spans[i].parent].name == "engine.retire")

    def ms(seconds):
        return 1e3 * seconds / n if n else None
    return {"decode_steps": n,
            "decode_step_ms": ms(total),
            "decode_kv_write_ms": ms(part["lm.kv_write"]),
            "decode_attention_ms": ms(part["lm.attention"] - part[TABLE]),
            "decode_table_ms": ms(part[TABLE]),
            "decode_self_ms": ms(total - part["lm.kv_write"]
                                 - part["lm.attention"]),
            "page_out_us_per_page": per_page("kvcache.page_out"),
            "page_out_entries_us_per_page":
                per_page("kvcache.page_out.entries"),
            "page_in_us_per_page": per_page("kvcache.page_in"),
            "page_in_stage_us_per_page": per_page("kvcache.page_in.stage"),
            "retire_page_out_share":
                100.0 * retired / out_pages if out_pages else None,
            "spans_per_decode_step": len(win) / n if n else None}
