"""One run of a cell: the program serves the cell's traffic through its
engine for a ramp and a measured window, then its outputs are judged.

The timed path is the program's serving entry, ``ServeEngine`` (``submit``,
``step``, ``suspend``, and resume through its own admission), over
``PagedLM`` and ``PagedKVCache`` with the weights this benchmark made.
The loop offers load open-loop: each session is submitted when it is due,
and between phases it is suspended (its KV paged out) and held off the
engine's resume queue until its pause is over.  Each output token is
stamped when the engine's sampling returns it (a synchronising copy to
the host); a request is timed from when it was due.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field

from . import judge, traffic
from .timing import Recorder, Slice
from .weights import dims, make_weights

COUNTERS = ("pages_out", "pages_in", "transit_crc_errors", "bypass_pages",
            "hybrid_attention", "activate_stalls", "suspends", "resumes")
RAMP_S = 30.0             # traffic before the window opens: the batch
                          # fills and sessions reach every phase
SAMPLE_REQUESTS = 8       # finished requests compared with the reference
SLICE_S = 5.0             # the profiled slice: the window's last seconds
SLICE_GRACE_S = 30.0      # how long past the close a slice may wait for
                          # its first prefill (traced runs only)


@dataclass
class Track:
    """One session as the harness saw it."""
    idx: int
    prompt: list
    outputs: list               # tokens each phase asks for
    pauses: list
    due: float                  # host clock
    req: object = None
    phase: int = 0
    times: list = field(default_factory=list)     # per output token
    after_pause: set = field(default_factory=set)  # tokens a pause precedes
    resumes: list = field(default_factory=list)    # [pause end, next token]
    resume_due: float = 0.0
    packed: list = field(default_factory=list)     # KV length at suspends
    done: bool = False

    @property
    def out(self) -> list:
        return self.req.out_tokens if self.req is not None else []


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: object
    seconds: float
    t_open: float
    t_close: float
    setup_s: float
    dims: dict
    tracks: list
    steps: list                 # (token time, batch decoded) per step
    counters: dict
    launches: dict
    rec: Recorder | None = None
    slice: dict | None = None
    sample: list = field(default_factory=list)
    checks: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    running_at_close: set = field(default_factory=set)
    crc_errors: int = 0         # over the whole run, warm-up and ramp too
    backlog: list = field(default_factory=list)    # (time, queued) a tick

    def in_window(self, t) -> bool:
        return t is not None and self.t_open <= t < self.t_close

    def due_in_window(self) -> list:
        return [tr for tr in self.tracks if self.in_window(tr.due)]

    def token_gaps(self) -> list:
        """Every gap between consecutive output tokens of a request that
        ends in the window, the tool pauses left out; a running request's
        open gap at the close counts up to the close."""
        out = []
        for tr in self.tracks:
            for i in range(1, len(tr.times)):
                if i not in tr.after_pause and self.in_window(tr.times[i]):
                    out.append(tr.times[i] - tr.times[i - 1])
            last = [t for t in tr.times if t < self.t_close]
            if tr.idx in self.running_at_close and last:
                out.append(self.t_close - max(last[-1], self.t_open))
        return out

    def resume_latencies(self) -> list:
        """From each pause's end in the window to the session's next token
        (to the close, where none came)."""
        out = []
        for end, tok in (r for tr in self.tracks for r in tr.resumes):
            if self.in_window(end):
                out.append((tok if tok is not None and tok < self.t_close
                            else self.t_close) - end)
        return out

    def tokens_in_window(self) -> int:
        return sum(1 for tr in self.tracks for t in tr.times
                   if self.in_window(t))


def model_config(config: dict, torch):
    """The program's model configuration for a configuration file."""
    from repro_torch.models.common import ModelConfig
    m = dims(config)
    return ModelConfig(
        name=config["arch"], family="dense", n_layers=m["L"],
        d_model=m["d"], n_heads=m["H"], n_kv_heads=m["Hkv"],
        d_ff=m["f"], vocab=m["V"], head_dim=m["hd"],
        rope_theta=float(config["rope_theta"]),
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        dtype=getattr(torch, config["torch_dtype"]))


def make_engine(config: dict, weights: dict, longest: int, device, torch):
    """The program's engine over a pool of ``max_batch`` sequences of
    ``longest`` tokens each: room for every running sequence at the mix's
    longest, so that no page bypasses to the host."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedCacheConfig
    m = dims(config)
    pages_per_seq = -(-longest // config["page_size"])
    cache = PagedCacheConfig(
        n_layers=m["L"], n_kv_heads=m["Hkv"], head_dim=m["hd"],
        page_size=config["page_size"],
        n_pages=config["max_batch"] * pages_per_seq,
        max_pages_per_seq=pages_per_seq,
        dtype=getattr(torch, config["torch_dtype"]))
    return ServeEngine(model_config(config, torch), weights, cache_cfg=cache,
                       max_batch=config["max_batch"], device=device)


def warm_up(eng, prompt) -> None:
    """One request through every call the traffic makes: a prefill, decode
    steps, a suspend and its resume, a retire."""
    req = eng.submit(prompt, max_new_tokens=4)
    eng.step()
    eng.suspend(req)
    while not req.done:
        eng.step()
    eng.finished.clear()


class Serving:
    """The engine under the cell's traffic, from the ramp to the close."""

    def __init__(self, cell, seed, seconds, *, device, torch, weights,
                 rate=None, trace=False, patch=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.torch, self.device = torch, device
        self.trace = trace
        self.rate = float(rate if rate is not None
                          else cell.params["rate_per_s"])
        self.ramp_s = RAMP_S
        self.eng = make_engine(cell.config, weights,
                               traffic.longest(cell.traffic), device, torch)
        warm_up(self.eng, traffic.seed_rng(seed, 3).integers(
            2, dims(cell.config)["V"],
            size=int(cell.traffic["prompt_tokens"].get("lo", 16))).tolist())
        if patch is not None:
            patch(self.eng)
        self.stamps = []
        sample = self.eng._sample

        def stamped(*args):
            out = sample(*args)
            self.stamps.append(time.perf_counter())
            return out
        self.eng._sample = stamped
        self.rec = Recorder(self.eng, torch) if trace else None

    def _counts(self) -> dict:
        c = self.eng.metrics.count
        return {k: c.get(k, 0) for k in COUNTERS}

    def run(self) -> Run:
        torch, eng = self.torch, self.eng
        from repro_torch.kernels import _build
        sched = traffic.schedule(self.cell.traffic, self.rate,
                                 self.ramp_s + self.seconds, self.seed,
                                 dims(self.cell.config)["V"])
        card = self.device != "cpu"
        slc = Slice(torch, card) if self.trace else None
        if slc is not None:
            slc.warm()
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_open, t_close = t0 + self.ramp_s, t0 + self.ramp_s + self.seconds
        # the last few seconds of the window, at most a third of it; the
        # profiler stops after the close, once the slice holds a prefill
        # and a decode step (a full batch may admit none for seconds), and
        # what the engine serves past the close counts in no metric but
        # the slice's
        slice_at = t_close - min(SLICE_S, self.seconds / 3)
        pending = deque(sched)
        tracks, live, paused, steps, backlog = [], [], [], [], []
        c_open = l_open = c_close = None
        while True:
            now = time.perf_counter()
            if c_open is None and now >= t_open:
                c_open, l_open = self._counts(), _build.launch_counts()
            if c_close is None and now >= t_close:
                c_close, l_close = self._counts(), _build.launch_counts()
                running = {id(r) for r in eng.running}
            if now >= t_close and (slc is None or slc.prof is None
                                   or slc.holds_a_call()
                                   or now >= t_close + SLICE_GRACE_S):
                break
            while pending and t0 + pending[0].due_s <= now:
                s = pending.popleft()
                tr = Track(s.idx, s.prompt.tolist(), s.outputs, s.pauses,
                           t0 + s.due_s)
                tr.req = eng.submit(tr.prompt,
                                    max_new_tokens=sum(s.outputs))
                tracks.append(tr)
                live.append(tr)
            for tr in [p for p in paused if p.resume_due <= now]:
                paused.remove(tr)
                eng.suspended.append(tr.req)
                tr.resumes.append([tr.resume_due, None])
            if not (eng.queue or eng.running or eng.suspended):
                if now >= t_close:
                    break
                nxt = min([t_close] + [p.resume_due for p in paused]
                          + ([t0 + pending[0].due_s] if pending else []))
                time.sleep(max(nxt - time.perf_counter(), 0.0))
                continue
            if slc is not None and slc.prof is None and now >= slice_at:
                slc.start()
            n_pre = len(self.rec.prefill) if self.rec else 0
            n_dec = len(self.rec.decode) if self.rec else 0
            before = {id(tr): len(tr.out) for tr in live}
            backlog.append((now, len(eng.queue)))
            self.stamps.clear()
            n = eng.step()
            t_tok = self.stamps[-1] if n else None
            if n:
                steps.append((t_tok, n))
            if slc is not None and slc.prof is not None:
                slc.prefills += [T for _, T, _, _ in self.rec.prefill[n_pre:]]
                slc.decodes += [lens for lens, _, _ in self.rec.decode[n_dec:]]
            for tr in list(live):
                got = len(tr.out) - before[id(tr)]
                if got:
                    first = [tr.req.t_first] if before[id(tr)] == 0 else []
                    if tr.resumes and tr.resumes[-1][1] is None:
                        tr.resumes[-1][1] = t_tok
                        tr.after_pause.add(len(tr.times))
                    tr.times += first + [t_tok] * (got - len(first))
                if tr.req.done:
                    tr.done = True
                    live.remove(tr)
                elif (tr.phase < len(tr.outputs) - 1
                      and len(tr.out) >= sum(tr.outputs[:tr.phase + 1])
                      and tr.req in eng.running):
                    eng.suspend(tr.req)
                    eng.suspended.remove(tr.req)
                    tr.packed.append(len(tr.prompt) + len(tr.out) - 1)
                    tr.resume_due = tr.times[-1] + tr.pauses[tr.phase]
                    tr.phase += 1
                    paused.append(tr)
        if slc is not None and slc.prof is not None:
            slc.stop()
        c_open = c_open or {k: 0 for k in COUNTERS}
        l_open = l_open or {}
        return Run(cell=self.cell, seconds=self.seconds, t_open=t_open,
                   t_close=t_close, setup_s=0.0, dims=dims(self.cell.config),
                   tracks=tracks, steps=steps,
                   counters={k: c_close[k] - c_open[k] for k in COUNTERS},
                   launches={k: v - l_open.get(k, 0)
                             for k, v in l_close.items()},
                   rec=self.rec, slice=slc.reduce() if slc and slc.t1 else None,
                   running_at_close={tr.idx for tr in tracks
                                     if id(tr.req) in running},
                   backlog=backlog,
                   crc_errors=self._counts()["transit_crc_errors"])

    def close(self) -> None:
        """Free the program's state (its pools) and keep the weights."""
        self.eng = self.rec = None
        gc.collect()
        if self.torch.cuda.is_available():
            self.torch.cuda.empty_cache()


def judge_run(run: Run, weights, seed: int, *, control: bool = False):
    """Compare a sample of the finished requests with the reference; sets
    ``run.checks`` and returns whether the run is correct (with the
    control's gaps as well when asked)."""
    done = [tr for tr in run.tracks if tr.done]
    run.sample = judge.choose(done, SAMPLE_REQUESTS, seed)
    judge.reference_precision()
    served, lowered = judge.served_gaps(run.cell.config, weights,
                                        run.sample, control=control)
    gap = float(served.max()) if served.size else float("inf")
    limits = run.cell.params["limits"]
    n_req = SAMPLE_REQUESTS
    run.checks = {
        "served_logit_gap": {"value": gap, "limit": limits["served_logit_gap"],
                             "holds": "<="},
        "transit_crc_errors": {"value": run.crc_errors, "limit": 0,
                               "holds": "<="},
        "requests_compared": {"value": len(run.sample), "limit": n_req,
                              "holds": ">="}}
    ok = (gap <= limits["served_logit_gap"]
          and run.crc_errors == 0
          and len(run.sample) >= n_req)
    return (ok, lowered) if control else ok


def serve_cell(cell, seed: int, seconds: float, trace: bool, *, device,
               torch, t_start: float, patch=None):
    """Make the weights, serve the window, read the peak, free the program's
    state, judge.  Returns the run and whether it is correct."""
    weights = make_weights(cell.config, seed, device)
    srv = Serving(cell, seed, seconds, device=device, torch=torch,
                  weights=weights, trace=trace, patch=patch)
    run = srv.run()
    run.setup_s = run.t_open - t_start
    if device != "cpu":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    srv.close()
    ok = judge_run(run, weights, seed)
    return run, ok
