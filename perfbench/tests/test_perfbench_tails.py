"""The end-to-end arithmetic is over all requests and all gaps of the
window: one stall of the whole batch moves the gap tail, a request still
waiting at the close counts what it waited, and the rate counts every
token of the window."""
import numpy as np

from perfbench.harness import spec
from perfbench.harness.serve import Run, Track


def run_of(times_by_req, dues, t_open=0.0, t_close=10.0, resumes=None,
           after_pause=None, running=()):
    tracks = []
    for i, (times, due) in enumerate(zip(times_by_req, dues)):
        tr = Track(i, [1, 2], [len(times)], [], due)
        tr.times = list(times)
        tr.resumes = (resumes or {}).get(i, [])
        tr.after_pause = (after_pause or {}).get(i, set())
        tracks.append(tr)
    return Run(cell=None, seconds=t_close - t_open, t_open=t_open,
               t_close=t_close, setup_s=1.5, dims={}, tracks=tracks,
               steps=[], counters={}, launches={},
               running_at_close=set(running))


def metric(name, run):
    return spec.reader(name)(run)


def steady(n_req=10, n_tok=10, step=0.01, stall_at=None, stall=1.0):
    """n_req requests due at 0.1 decoding together, one token a step."""
    t, times = 0.5, []
    for k in range(n_tok):
        t += step + (stall if k == stall_at else 0.0)
        times.append(t)
    return [list(times) for _ in range(n_req)], [0.1] * n_req


def test_one_stall_of_the_batch_moves_the_gap_tail():
    calm = metric("itl_p95_ms", run_of(*steady()))
    stalled = metric("itl_p95_ms", run_of(*steady(stall_at=5)))
    assert np.isclose(calm, 10.0)
    # one step in ten stalled: 10% of all gaps, past the p95
    assert stalled > 500.0


def test_the_rate_counts_every_token_of_the_window():
    times, dues = steady()
    assert metric("output_tok_s", run_of(times, dues)) == 100 / 10.0
    # tokens before the opening or at the close are outside it
    late = run_of([[0.5, 9.99, 10.0, 10.5]], [0.1], t_open=1.0)
    assert late.tokens_in_window() == 1


def test_a_request_waiting_at_the_close_counts_its_wait():
    open_gap = run_of([[9.0]], [0.5], running={0}).token_gaps()
    assert open_gap == [1.0]                      # 9.0 to the close
    assert run_of([[9.0]], [0.5]).token_gaps() == []   # retired: no gap


def test_pauses_leave_the_gaps_and_time_the_resume():
    run = run_of([[1.0, 1.1, 3.0, 3.1]], [0.5],
                 resumes={0: [[2.5, 3.0]]}, after_pause={0: {2}})
    assert np.allclose(sorted(run.token_gaps()), [0.1, 0.1])
    assert np.isclose(metric("resume_p90_ms", run), 500.0)
    late = run_of([[1.0]], [0.5], resumes={0: [[8.0, None]]})
    assert np.isclose(metric("resume_p90_ms", late), 2000.0)


def test_setup_is_read_as_measured():
    assert metric("setup_s", run_of([[1.0]], [0.5])) == 1.5
