"""The whole run on the CPU at a tiny size, the program on its kernels'
plain versions: a test-only configuration, mix, cell and metric found by
name; the program's served tokens against the reference, through a
suspend and resume (int8 page-out and page-in); and the same run with the
timed path broken underneath, which has to come out not correct."""
import numpy as np
import pytest
import torch

from perfbench import run_cell
from perfbench.harness import judge, spec
from perfbench.harness.serve import serve_cell
from perfbench.tests import tiny

SEED = 2**31 + 77
SECONDS = 1.2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True)
def short_ramp(monkeypatch):
    tiny.shorten(monkeypatch)


def serve(root, trace=False, patch=None, seed=SEED):
    cell = spec.load_cell(tiny.CELL, root)
    return serve_cell(cell, seed, 3 * SECONDS if trace else SECONDS, trace, device="cpu", torch=torch,
                      t_start=0.0, patch=patch)


def test_served_tokens_match_the_reference_through_a_swap(root):
    run, ok = serve(root, trace=True)
    assert ok, run.checks
    assert run.checks["served_logit_gap"]["value"] <= \
        tiny.PARAMS["limits"]["served_logit_gap"]
    assert run.counters["pages_in"] > 0 and run.counters["suspends"] > 0
    assert run.counters["bypass_pages"] == 0
    # the sample went through a page-out and a page-in
    assert all(tr.packed for tr in run.sample)
    line = run_cell.result_line(run, ok, True, "cpu")
    # the test-only metric, found by name, and the reader-less ones left out
    assert "tiny_tokens" in line["metrics"]
    assert list(line)[-1] == "checks"
    e2e = run_cell.result_line(run, ok, False, "cpu")["metrics"]
    assert set(e2e) == {"output_tok_s", "setup_s"}
    assert {"itl_p95_ms", "resume_p90_ms", "running_batch_mean",
            "page_in_us_per_page"} <= set(line["metrics"])


def altered_token(eng):
    sample = eng._sample

    def wrong(logits, reqs):
        out = sample(logits, reqs)
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    eng._sample = wrong


def unwritten_kv(eng):
    eng.cache._write_locked = lambda *a: None


def unrestored_pages(monkeypatch):
    from repro_torch.kernels.ref import transit_crc_ref
    from repro_torch.serve import kvcache
    monkeypatch.setattr(kvcache, "scatter_dequantize_crc_units",
                        lambda stack, units, q, s: (stack,
                                                    transit_crc_ref(q)))


@pytest.mark.parametrize("fault", ["altered_token", "unwritten_kv",
                                   "unrestored_pages"])
def test_a_broken_timed_path_is_not_correct(root, fault, monkeypatch):
    patch = None
    if fault == "unrestored_pages":
        unrestored_pages(monkeypatch)
    else:
        patch = {"altered_token": altered_token,
                 "unwritten_kv": unwritten_kv}[fault]
    run, ok = serve(root, patch=patch)
    assert not ok, run.checks


def test_the_control_reads_above_the_limit(root):
    """The reference in float8 in the program's place: at the positions of
    sessions the float32 reference decoded greedily (through a swap), the
    token the float8 model puts first lies below the float32 best by more
    than the cell's limit somewhere."""
    from types import SimpleNamespace

    from perfbench.harness.reference import Reference
    from perfbench.harness.traffic import seed_rng
    from perfbench.harness.weights import make_weights
    cell = spec.load_cell(tiny.CELL, root)
    weights = make_weights(cell.config, SEED, "cpu")
    ref = Reference(cell.config, weights)
    rng = seed_rng(SEED, 9)
    sample = []
    for n in (12, 20, 28, 40):
        seq = rng.integers(2, 256, size=n).tolist()
        out = []
        for _ in range(12):
            out.append(int(ref.logits(seq + out, n + len(out) - 1)[-1]
                           .argmax()))
        sample.append(SimpleNamespace(prompt=seq, out=out, packed=[n + 3]))
    served, lowered = judge.served_gaps(cell.config, weights, sample,
                                        control=True)
    limit = tiny.PARAMS["limits"]["served_logit_gap"]
    assert served.size == 48 and np.max(served) <= limit
    assert np.max(lowered) > limit
