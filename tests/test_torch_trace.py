"""The serving path's spans and counters on the CPU (``core.trace``):
off records nothing and enters no ``record_function``; on, a tick is a
tree from ``engine.step`` down to ``kvcache.table``, a request's spans
carry its ``sid``, a pool worker's page-out is a root of its own, the cap
counts what it drops; the spans' counts give the decode step's token
writes and the pages its table builds walked, and ``retire_pages_out``
counts the pages retire paged out (none it only queued to a pool)."""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import trace as trace_mod
from repro_torch.core.metrics import Metrics
from repro_torch.core.trace import trace_of
from repro_torch.models.transformer import init_lm
from repro_torch.serve import PagedCacheConfig, PagedKVCache, ServeEngine
from repro_torch.serve.engine import PagedLM
from repro_torch.volume.evict_pool import SharedEvictionPool

PAGE = 4


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2.5-3b", smoke=True, dtype=torch.float32)
    return cfg, init_lm(cfg, torch.Generator().manual_seed(0))


def engine(model, max_batch=2):
    cfg, params = model
    cc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.hd, page_size=PAGE, n_pages=64,
                          max_pages_per_seq=16, dtype=cfg.dtype)
    return ServeEngine(cfg, params, cache_cfg=cc, max_batch=max_batch,
                       device="cpu")


def prompt(n, seed=0):
    return np.random.default_rng(seed).integers(2, 256, size=n).tolist()


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_enters_no_record_function(model,
                                                           monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) while off")
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    eng = engine(model)
    assert eng.trace.span("a") is eng.trace.span("b", 3, pages=2)
    req = eng.submit(prompt(9), max_new_tokens=4)
    eng.step()
    eng.suspend(req)
    while eng.queue or eng.running or eng.suspended:
        eng.step()
    assert eng.trace.spans() == []
    # the counters are on all the same
    assert eng.metrics.count["retire_pages_out"] > 0


def test_one_trace_rides_on_the_metrics_the_engine_shares(model):
    eng = engine(model)
    assert eng.trace is trace_of(eng.metrics) is eng.cache.trace \
        is eng.lm.trace
    # a cache made on the engine's metrics records into the same spans
    other = PagedKVCache(eng.cache.cfg, metrics=eng.metrics, device="cpu")
    assert other.trace is eng.trace
    assert trace_of(Metrics()) is not eng.trace


def test_spans_on_serve_the_tokens_spans_off_do(model):
    outs = []
    for on in (False, True):
        eng = engine(model)
        if on:
            eng.trace.start()
        reqs = [eng.submit(prompt(n, n), max_new_tokens=6) for n in (9, 14)]
        eng.step()
        eng.suspend(reqs[0])
        while eng.queue or eng.running or eng.suspended:
            eng.step()
        outs.append([r.out_tokens for r in reqs])
        assert bool(eng.trace.spans()) == on
    assert outs[0] == outs[1]


def test_one_tick_is_a_tree(model):
    eng = engine(model)
    eng.trace.start()
    for n in (9, 14):
        eng.submit(prompt(n, n), max_new_tokens=5)
    eng.step()
    spans = eng.trace.spans()
    L = model[0].n_layers

    def parent(s):
        return spans[s.parent].name if s.parent is not None else None
    assert all(s.t0 <= s.t1 for s in spans)
    (step,) = by_name(spans, "engine.step")
    assert step.parent is None and spans[0] is step
    assert [parent(s) for s in by_name(spans, "engine.admit")] == \
        ["engine.step"]
    assert [parent(s) for s in by_name(spans, "engine.prefill")] == \
        ["engine.admit"] * 2
    assert [s.counts["T"] for s in by_name(spans, "lm.prefill")] == [9, 14]
    assert {parent(s) for s in by_name(spans, "lm.prefill")} == \
        {"engine.prefill"}
    assert [parent(s) for s in by_name(spans, "engine.sample")] == \
        ["engine.prefill"] * 2 + ["engine.step"]
    (dec,) = by_name(spans, "lm.decode_step")
    assert parent(dec) == "engine.step" and dec.counts == {"n": 2}
    idx = spans.index(dec)
    for name in ("lm.kv_write", "lm.attention"):
        got = by_name(spans, name)
        assert len(got) == L and {s.parent for s in got} == {idx}
    writes = by_name(spans, "lm.kv_write")
    assert all(s.counts == {"n": 2} for s in writes)
    # the step is planned: one table, built in the first layer's attention
    count = eng.metrics.count
    assert count["decode_plan_steps"] == 1
    assert count.get("decode_token_path_steps", 0) == 0
    (table,) = by_name(spans, "kvcache.table")
    assert table.parent == spans.index(by_name(spans, "lm.attention")[0])
    # 9 + 1 and 14 + 1 tokens: 3 and 4 pages of 4
    assert table.counts["pages"] == 7
    p = spans[table.parent]                   # nested in time as well
    assert p.t0 <= table.t0 <= table.t1 <= p.t1


def test_a_requests_spans_carry_its_sid(model):
    eng = engine(model)
    eng.trace.start()
    req = eng.submit(prompt(11), max_new_tokens=4)
    eng.step()
    eng.suspend(req)
    while eng.queue or eng.running or eng.suspended:
        eng.step()
    sid = req.seq_id
    named = {s.name for s in eng.trace.spans() if s.sid == sid}
    assert {"engine.prefill", "lm.prefill", "engine.suspend",
            "kvcache.page_out", "engine.resume", "kvcache.page_in",
            "engine.retire", "kvcache.release"} <= named
    outs = by_name(eng.trace.spans(), "kvcache.page_out")
    assert len(outs) == 2 and all(s.sid == sid for s in outs)
    ins = by_name(eng.trace.spans(), "kvcache.page_in")
    assert [s.counts["pages"] for s in ins] == [outs[0].counts["pages"]]


def test_a_page_out_on_a_pool_worker_is_a_root_of_its_own():
    pool = SharedEvictionPool(2, name="trace", batch_max=8)
    try:
        m = Metrics()
        c = PagedKVCache(PagedCacheConfig(n_layers=2, n_kv_heads=2,
                                          head_dim=8, page_size=PAGE,
                                          dtype=torch.float32),
                         metrics=m, evict_pool=pool, device="cpu")
        sid = c.new_sequence()
        k = [torch.ones(2, 8)] * 2
        for _ in range(9):
            c.append_token(sid, k, k)
        tr = c.trace
        tr.start()
        with tr.span("caller"):
            assert c.deactivate(sid) == 0     # queued, not paged out
            c.drain_evictions()
        spans = tr.spans()
        outs = by_name(spans, "kvcache.page_out")
        assert outs and all(s.parent is None for s in outs)
        assert sum(s.counts["pages"] for s in outs) == 3
        # each worker's stack is its own: the page-out's parts nest in it
        for part in by_name(spans, "kvcache.page_out.entries"):
            assert spans[part.parent].name == "kvcache.page_out"
    finally:
        pool.close()


def test_another_threads_span_does_not_nest_in_this_ones():
    m = Metrics()
    tr = trace_of(m)
    tr.start()
    def worker():
        with tr.span("worker"):
            pass
    with tr.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with tr.span("inner"):
            pass
    spans = {s.name: s for s in tr.spans()}
    assert spans["worker"].parent is None
    assert spans["inner"].parent == 0


def test_spans_of_many_threads_at_once_are_all_kept():
    """More threads than cores open nested spans with a short switch
    interval: none is lost, and each nests in a span of its own thread."""
    m = Metrics()
    tr = trace_of(m)
    tr.start()
    n_threads, n_spans = 16, 200

    def worker(i):
        for _ in range(n_spans):
            with tr.span(f"t{i}"):
                with tr.span(f"t{i}.inner"):
                    pass
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = tr.spans()
    assert len(spans) == 2 * n_threads * n_spans
    for s in spans:
        if s.name.endswith(".inner"):
            assert spans[s.parent].name == s.name[:-len(".inner")]
        else:
            assert s.parent is None


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace_mod, "SPAN_CAP", 3)
    m = Metrics()
    tr = trace_of(m)
    tr.start()
    with tr.span("a"):
        for _ in range(3):
            with tr.span("b"):
                with tr.span("c"):
                    pass
    spans = tr.spans()
    assert [s.name for s in spans] == ["a", "b", "c"]
    assert m.count["spans_dropped"] == 4
    assert all(s.t1 is not None for s in spans)


def test_reset_clears_the_spans_and_stop_ends_the_recording():
    m = Metrics()
    tr = trace_of(m)
    tr.start()
    with tr.span("a", 7, pages=2):
        pass
    (s,) = tr.spans()
    assert (s.name, s.sid, s.counts) == ("a", 7, {"pages": 2})
    tr.reset()
    assert tr.spans() == []
    tr.stop()
    with tr.span("b"):
        pass
    assert tr.spans() == []


def test_a_span_is_a_profiler_annotation_while_on():
    m = Metrics()
    tr = trace_of(m)
    tr.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("lm.decode_step"):
            torch.ones(4).sum()
    assert "lm.decode_step" in {e.name for e in prof.events()}


def test_the_counters_count_what_the_steps_did(model):
    """Two requests decoded together to the end, no swap: the token-write
    spans count B x L writes a step, the table spans walk every page of
    every running sequence once a step (the step is planned), and retire
    pages out every page."""
    L = model[0].n_layers
    eng = engine(model)
    eng.trace.start()
    lens, new = (9, 14), 5
    for n in lens:
        eng.submit(prompt(n, n), max_new_tokens=new)
    while eng.queue or eng.running:
        eng.step()
    spans, c = eng.trace.spans(), eng.metrics.count
    steps = new - 1                       # the first token comes of prefill
    assert sum(s.counts["n"] for s in by_name(spans, "lm.kv_write")) == \
        steps * len(lens) * L
    pages = [-(-(n + k) // PAGE) for k in range(1, steps + 1) for n in lens]
    assert sum(s.counts["pages"] for s in by_name(spans, "kvcache.table")) \
        == sum(pages)
    assert c["decode_plan_steps"] == steps
    assert c["retire_pages_out"] == c["pages_out"] == \
        sum(-(-(n + steps) // PAGE) for n in lens)
    # none of the spans' counts is a counter of its own
    assert "kv_token_writes" not in c and "table_pages" not in c


def test_retire_with_a_pool_counts_no_page_it_only_queued(model):
    """With an eviction pool, retire's ``release`` comes before the
    workers reach its pages: they are dropped, not paged out, and
    ``retire_pages_out`` stays within ``pages_out``."""
    cfg, params = model
    pool = SharedEvictionPool(2, name="retire", batch_max=8)
    try:
        eng = engine(model)
        # the engine takes no pool: its model runs over a pooled cache
        eng.cache = PagedKVCache(eng.cache.cfg, metrics=eng.metrics,
                                 evict_pool=pool, device="cpu")
        eng.lm = PagedLM(cfg, params, eng.cache)
        reqs = [eng.submit(prompt(n, n), max_new_tokens=4) for n in (9, 14)]
        eng.step()
        eng.suspend(reqs[0])
        while eng.queue or eng.running or eng.suspended:
            eng.step()
        eng.cache.drain_evictions()
        c = eng.metrics.count
        assert c.get("retire_pages_out", 0) == 0
        assert c.get("retire_pages_out", 0) <= c["pages_out"]
        assert [r.out_tokens for r in reqs] == \
            [r.out_tokens for r in serve_plain(model, (9, 14))]
    finally:
        pool.close()


def serve_plain(model, lens):
    """The same requests, suspend and turns without a pool."""
    eng = engine(model)
    reqs = [eng.submit(prompt(n, n), max_new_tokens=4) for n in lens]
    eng.step()
    eng.suspend(reqs[0])
    while eng.queue or eng.running or eng.suspended:
        eng.step()
    return reqs


def test_a_page_in_counts_the_codec_once(model, monkeypatch):
    eng = engine(model, max_batch=1)
    req = eng.submit(prompt(13), max_new_tokens=3)
    eng.step()
    eng.suspend(req)
    bumps = []
    bump = eng.metrics.bump
    monkeypatch.setattr(eng.metrics, "bump",
                        lambda e, n=1: (bumps.append((e, n)), bump(e, n)))
    eng.cache.activate(req.seq_id)                  # one page-in
    got = [(e, n) for e, n in bumps if e.startswith("fused_kernel")]
    L, pages = model[0].n_layers, -(-14 // PAGE)
    assert [e for e, _ in got] == ["fused_kernel_passes",
                                   "fused_kernel_bytes"]
    assert got[0][1] == 2 * L * pages
    assert got[1][1] == 2 * L * pages * PAGE * model[0].n_kv_heads \
        * model[0].hd


def test_the_plan_script_counts_the_windows_steps(tmp_path, monkeypatch):
    """``scripts/decode_plan_spans.py`` on the benchmark's tiny test cell,
    on the CPU: every decode step of the window took the plan, as the
    counters and the split agree."""
    import importlib.util
    from perfbench.harness import spec
    from perfbench.tests import tiny
    tiny.shorten(monkeypatch)
    root = Path(__file__).resolve().parents[1]
    loader = importlib.util.spec_from_file_location(
        "decode_plan_spans", root / "scripts" / "decode_plan_spans.py")
    script = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(script)
    cell = spec.load_cell(tiny.CELL, tiny.make_root(tmp_path))
    out = script.traced(cell, 2**31 + 99, 1.2, device="cpu", torch=torch)
    steps = out["split"]["decode_steps"]
    assert steps > 0 and out["window_plan_steps"] == steps
    assert out["window_token_path_steps"] == 0
    assert out["run_counters"]["decode_plan_steps"] > steps
    assert out["run_counters"]["decode_token_path_steps"] == 0
