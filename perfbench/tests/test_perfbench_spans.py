"""The program's spans as the benchmark reads them (``harness/spans.py``,
``tools/spans.py``, the ``retire_page_out_share_whole_run`` reader): the
sweep labels gaps as ``timing.label_at``'s scan does; a device-side
annotation adds no busy time and a gap inside ``lm.kv_write`` is put down
to it; an engine with the spans on gives every number of the window's
split."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from perfbench import run_cell
from perfbench.harness import spec, timing
from perfbench.harness.serve import serve_cell
from perfbench.harness.spans import SpanSlice, label_gaps, split
from perfbench.tests import tiny
from perfbench.tools import spans as tool

SEED = 2**31 + 1234


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True)
def short_ramp(monkeypatch):
    tiny.shorten(monkeypatch)


def nested(rng, a, b, depth, out):
    """Random spans nested in [a, b], some of equal length side by side."""
    t = a
    while depth and t < b:
        s = t + rng.integers(0, 5)
        e = min(b, s + rng.integers(1, 40))
        if s >= e:
            break
        out.append((float(s), float(e), f"s{len(out)}"))
        nested(rng, s, e, depth - 1, out)
        t = e + rng.integers(0, 3)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_the_sweep_labels_as_the_scan_does(seed):
    rng = np.random.default_rng(seed)
    host = nested(rng, 0, 400, 4, [])
    # and some that overlap without nesting (another thread's)
    host += [(float(a), float(a + rng.integers(1, 60)), f"x{i}")
             for i, a in enumerate(rng.integers(0, 400, 10))]
    rng.shuffle(host)
    host = [tuple(h) for h in host]
    points = list(rng.uniform(-5, 405, 300)) + [h[0] for h in host[:20]] \
        + [h[1] for h in host[:20]]
    assert label_gaps(points, host) == \
        [timing.label_at(t, host) for t in points]


def event(name, dev, a, b, annotation=None):
    e = SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                        device_type=dev)
    if annotation is not None:      # a torch without the field leaves it out
        e.is_user_annotation = annotation
    return e


@pytest.mark.parametrize("field", [True, False])
def test_an_annotation_is_no_device_op_and_a_gap_is_put_down_to_its_span(
        field):
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [event("decode_step", cpu, 0, 100, True if field else None),
              event("lm.decode_step", cpu, 1, 99, True if field else None),
              event("lm.kv_write", cpu, 10, 40, True if field else None),
              event("aten::index_put_", cpu, 12, 14, False if field else None),
              event("kernel_a", cuda, 5, 8, False if field else None),
              # launched in the write, run after the host has gone on
              event("kernel_b", cuda, 50, 60, False if field else None),
              event("lm.decode_step", cuda, 5, 60, True if field else None),
              event("lm.kv_write", cuda, 50, 60, True if field else None)]
    prof = SimpleNamespace(events=lambda: events)
    old, new = timing.Slice(torch, True), SpanSlice(torch, True)
    for s in (old, new):
        s.prof, s.t0, s.t1 = prof, 0.0, 1.0
    was, got = old.reduce(), new.reduce()
    assert was["busy_s"] == pytest.approx(55e-6)   # the annotation as busy
    assert got["busy_s"] == pytest.approx(13e-6)
    assert got["window_s"] == pytest.approx(55e-6)
    assert set(got["by_op"]) == {"kernel_a", "kernel_b"}
    assert got["annotations"] == 2
    assert got["idle_by_span"] == {"lm.kv_write": pytest.approx(42e-6)}


def test_split_reads_every_number_of_a_driven_engine(root):
    """The tiny cell's engine driven by hand with the spans on: three
    sessions, one swapped out and in, all to the end."""
    from perfbench.harness.serve import make_engine
    from perfbench.harness.weights import make_weights
    cell = spec.load_cell(tiny.CELL, root)
    eng = make_engine(cell.config, make_weights(cell.config, SEED, "cpu"),
                      64, "cpu", torch)
    eng.trace.start()
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(2, 256, size=n).tolist(),
                       max_new_tokens=6) for n in (12, 23, 31)]
    eng.step()
    eng.suspend(reqs[1])
    while eng.queue or eng.running or eng.suspended:
        eng.step()
    s = split(eng.trace.spans(), lambda t: True)
    assert s["decode_steps"] == 5
    for name in ("decode_kv_write_ms", "decode_table_ms",
                 "page_out_entries_us_per_page", "page_in_stage_us_per_page",
                 "decode_attention_ms", "decode_self_ms"):
        assert s[name] is not None and s[name] > 0, name
    assert s["page_out_entries_us_per_page"] < s["page_out_us_per_page"]
    assert s["page_in_stage_us_per_page"] < s["page_in_us_per_page"]
    # pages of 4 tokens: 5 + 7 + 9 at retire ((12, 23, 31) + 5 tokens), 6
    # at the suspend (23 + 1)
    assert s["retire_page_out_share"] == pytest.approx(100 * 21 / (21 + 6))
    assert s["decode_kv_write_ms"] + s["decode_attention_ms"] \
        + s["decode_table_ms"] + s["decode_self_ms"] == \
        pytest.approx(s["decode_step_ms"])
    # 2 layers: a step, a write, an attention and a table a layer
    assert s["spans_per_decode_step"] >= 1 + 3 * 2
    assert split(eng.trace.spans(), lambda t: False)["decode_steps"] == 0


def test_the_tool_traces_a_tiny_run(root):
    cell = spec.load_cell(tiny.CELL, root)
    out = tool.traced(cell, SEED, 3.6, device="cpu", torch=torch)
    assert out["spans_dropped"] == 0 and out["split"]["decode_steps"] > 0
    assert out["busy_s"] == 0.0           # the CPU runs no device op


def test_the_cost_runs_take_turns(root):
    cell = spec.load_cell(tiny.CELL, root)
    lines = tool.cost(cell, SEED, 1.2, True, device="cpu", torch=torch)
    assert [x["spans"] for x in lines] == [True, False]
    assert all({"output_tok_s", "step_gap_ms_median", "decode_steps"}
               <= set(x) for x in lines)


def test_the_retire_share_reads_the_programs_counter(root):
    cell = spec.load_cell(tiny.CELL, root)
    run, ok = serve_cell(cell, SEED, 1.2, True, device="cpu", torch=torch,
                         t_start=0.0)
    value = run_cell.result_line(run, ok, True, "cpu")["metrics"][
        "retire_page_out_share_whole_run"]["value"]
    assert 0 < value < 100
    # the engine's whole life: the live counters, not the window's
    assert value == 100.0 * run.rec.count["retire_pages_out"] / \
        run.rec.count["pages_out"]
    assert run.rec.count["pages_out"] >= run.counters["pages_out"]
    # a program without the counter: no number, no error
    del run.rec.count["retire_pages_out"]
    assert spec.reader("retire_page_out_share_whole_run", root)(run) is None
