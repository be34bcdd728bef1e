"""Self-tuning control plane: a feedback controller over the knob set.

The stack has ~10 load-bearing knobs (``commit_window``, ``log_window``,
the bypass watermark, ``scan_threshold``, the hedge delay, ...) that
PRs 1-8 froze at hand-picked defaults.  Static tunings lose the moment
the workload shifts: a ``commit_window`` that amortizes four syncing
tenants is pure added latency once the workload turns read-only, and a
``scan_threshold`` tuned for backup scans starves a serving tier whose
working set *is* long sequential runs (NVCache's plug-and-play
adaptivity and the Optane-DBMS "lessons learned" evaluation both make
this argument; PAPERS.md).  This module closes the loop:

  signals (metrics layer)          Controller             applied knobs
  ---------------------------      -----------------      --------------
  fsync rate, coalesce rate   ──>  per-knob decision ──>  commit_window
  log rate, log coalesce      ──>  rules vote +1/-1  ──>  log_window
  stall / bypass rates        ──>  moves gated by    ──>  bypass watermark
  tier hit + scan denials     ──>  HYSTERESIS, step  ──>  scan_threshold
  scrub()["tail"] verdicts    ──>  sizes bounded by  ──>  hedge delay
  per-tenant p99 vs SLO       ──>  hard CLAMPS       ──>  (all of the above)

Control discipline (the safety story, enforced by tests):

  * **bounded AIMD-style steps** — a knob raises by one additive
    ``quantum`` per move and lowers multiplicatively (``decay`` x),
    snapping to its floor once a decrease lands within half a quantum
    of it, so windows really return to 0 instead of asymptoting;
  * **hard clamps** — every knob declares ``[lo, hi]``; a move lands
    inside the range or does not happen.  The controller can NEVER
    push a knob past its clamp, no matter what the signals say;
  * **hysteresis** — a knob moves only after ``hysteresis`` consecutive
    same-direction votes, and a *reversal* (raise after lower or vice
    versa) must clear twice that bar — one noisy window cannot flap a
    knob, and sustained oscillation pressure damps instead of ringing;
  * **per-tenant SLOs** — ``slos={"gold": {"p99_us": 500}}`` (or
    ``"*"`` for a fleet-wide target) turns observed per-tenant p99s
    into a pressure term that biases latency-adding knobs downward
    while the SLO is violated.

The controller is deliberately transport-agnostic: it consumes a flat
``signals`` dict of rates and latencies, so the SAME object drives the
threaded :class:`~repro_torch.volume.volume.StripedVolume`
(``autotune_step()`` computes signal deltas from the live metrics
layer), the :class:`~repro_torch.cluster.cluster.ClusterVolume`, and the
virtual-time ``run_autotune_sim_workload`` in ``core/sim.py`` — the
repo's established idiom of the simulator validating the real policy
object rather than a reimplementation of it.
"""
from __future__ import annotations


class Knob:
    """One tunable with hard clamps, bounded steps and hysteresis.

    ``vote(direction)`` is the only mutator: the controller's decision
    rule votes +1 (raise) / -1 (lower) / 0 (hold) once per control
    tick; the knob moves only after ``hysteresis`` consecutive
    same-direction votes (doubled after a reversal) and every move
    lands inside ``[lo, hi]`` by construction.
    """

    __slots__ = ("name", "value", "lo", "hi", "quantum", "decay",
                 "integer", "hysteresis", "moves", "raises", "lowers",
                 "rail_hits", "_trend", "_last_dir")

    def __init__(self, name: str, value: float, lo: float, hi: float, *,
                 quantum: float, decay: float = 0.5,
                 integer: bool = False, hysteresis: int = 2) -> None:
        assert lo <= hi and quantum > 0 and 0.0 < decay < 1.0
        assert hysteresis >= 1
        self.name = name
        self.lo = lo
        self.hi = hi
        self.quantum = quantum
        self.decay = decay
        self.integer = integer
        self.hysteresis = hysteresis
        self.value = self._clamp(value)
        self.moves = 0
        self.raises = 0
        self.lowers = 0
        self.rail_hits = 0        # votes that found the knob at a rail
        self._trend = 0           # consecutive same-direction votes
        self._last_dir = 0        # direction of the last APPLIED move

    def _clamp(self, v: float) -> float:
        v = min(self.hi, max(self.lo, v))
        return float(round(v)) if self.integer else v

    def set(self, v: float) -> float:
        """Re-seed the knob (e.g. from a live config at attach time);
        clamped, trend reset, not counted as a controller move."""
        self.value = self._clamp(v)
        self._trend = 0
        self._last_dir = 0
        return self.value

    def in_range(self, v: float | None = None) -> bool:
        v = self.value if v is None else v
        return self.lo <= v <= self.hi

    def vote(self, direction: int) -> float | None:
        """One control-tick decision.  Returns the new value iff the
        knob moved, else None (held, gathering hysteresis, or pinned
        at a rail)."""
        if direction == 0:
            self._trend = 0
            return None
        if self._trend * direction < 0:
            self._trend = direction          # vote flip: restart trend
        else:
            self._trend += direction
        need = self.hysteresis
        if self._last_dir and direction == -self._last_dir:
            need *= 2                        # reversal: damp, don't ring
        if abs(self._trend) < need:
            return None
        self._trend = 0
        return self._move(direction)

    def _move(self, direction: int) -> float | None:
        old = self.value
        if direction > 0:
            v = self.value + self.quantum    # additive increase
        else:
            v = self.value * self.decay      # multiplicative decrease
            if v - self.lo < 0.5 * self.quantum:
                v = self.lo                  # snap to the floor
        v = self._clamp(v)
        if self.integer and direction > 0 and v == old and old < self.hi:
            v = self._clamp(old + 1.0)
        if v == old:
            self.rail_hits += 1              # already pinned at a clamp
            return None
        self.value = v
        self.moves += 1
        if direction > 0:
            self.raises += 1
        else:
            self.lowers += 1
        self._last_dir = direction
        return v

    def stats(self) -> dict:
        return {"value": self.value, "lo": self.lo, "hi": self.hi,
                "moves": self.moves, "raises": self.raises,
                "lowers": self.lowers, "rail_hits": self.rail_hits}


def default_knobs(*, hysteresis: int = 2) -> list[Knob]:
    """The five knobs the control plane owns, with their safe clamp
    ranges.  Windows are MICROSECONDS here (the sim's native unit); the
    threaded volume converts to seconds when applying."""
    return [
        Knob("commit_window_us", 0.0, 0.0, 200.0, quantum=20.0,
             hysteresis=hysteresis),
        Knob("log_window_us", 0.0, 0.0, 200.0, quantum=20.0,
             hysteresis=hysteresis),
        Knob("bypass_watermark", 0.9, 0.5, 0.98, quantum=0.04,
             hysteresis=hysteresis),
        Knob("scan_threshold", 64.0, 8.0, 512.0, quantum=32.0,
             integer=True, hysteresis=hysteresis),
        Knob("hedge_delay_us", 1000.0, 50.0, 5000.0, quantum=250.0,
             hysteresis=hysteresis),
    ]


class Controller:
    """Feedback controller: flat signal dict in, knob moves out.

    ``observe(signals)`` runs every knob's decision rule once and
    returns ``{knob_name: new_value}`` for the knobs that actually
    moved this tick (usually empty — hysteresis holds).  Signals are
    window RATES (per-op fractions over the interval since the last
    tick) plus a few absolute latencies; missing keys are neutral, so
    any layer can wire up the subset it can measure:

      ``ops``                window op count (informational)
      ``fsync_rate``         fsyncs per op
      ``coalesce_rate``      fraction of fsyncs that rode a leader
      ``log_rate``           chained-tx log calls per op
      ``log_coalesce_rate``  fraction of chains that rode a batch
      ``stall_rate``         foreground eviction stalls per op
      ``bypass_rate``        writes bypassed straight to PMem, per write
      ``staged_frac``        staged slots / total slots (instantaneous)
      ``read_rate``          reads per op
      ``tier_hit_rate``      DRAM tier hits per read
      ``scan_denial_rate``   tier fills denied as scans, per read
      ``limping``            any shard/node currently limping (bool)
      ``healthy_p99_us``     scorer's healthy-cohort p99 (hedge basis)
      ``pin_rate``           zero-copy pin rate (informational)
      ``wfq_debt_share``     worst tenant's WFQ debt share (info)
      ``per_tenant_p99_us``  {tenant: window p99} — matched to SLOs

    Per-tenant SLOs (``slos={"gold": {"p99_us": 500}, "*": {...}}``)
    produce a *pressure* ratio (worst observed p99 / target); pressure
    above 1 vetoes raises of the latency-adding window knobs and votes
    them down instead.
    """

    #: signal thresholds (class attrs so tests/benches can tighten them)
    FSYNC_HOT = 0.02          # fsyncs/op above which windows matter
    FSYNC_COLD = 0.005        # below: the window is pure latency tax
    COALESCE_TARGET = 0.6     # stop widening once this share coalesces
    LOG_HOT = 0.02
    LOG_COLD = 0.005
    STALL_HOT = 0.005         # stalls/op that justify earlier bypass
    BYPASS_HOT = 0.25         # bypassed-write share worth re-staging
    TIER_COLD = 0.2           # tier hit rate low enough to suspect scans
    SCAN_DENIAL_HOT = 0.2     # denial rate high enough to suspect a
    TIER_HOT = 0.5            # ...hot set misread as a scan
    HEDGE_BAND = 1.5          # deadband ratio around the hedge target
    SLO_BAND = 1.0            # pressure above this biases latency down

    def __init__(self, knobs: list[Knob] | None = None, *,
                 slos: dict[str, dict] | None = None,
                 hysteresis: int = 2) -> None:
        self.knobs: dict[str, Knob] = {
            k.name: k for k in (knobs if knobs is not None
                                else default_knobs(hysteresis=hysteresis))}
        self.slos = dict(slos or {})
        self.ticks = 0
        self.total_moves = 0
        self.history: list[tuple[int, str, float, float]] = []
        self.last_signals: dict = {}
        self.last_pressure = 0.0

    # ------------------------------------------------------------- wiring
    def bind(self, values: dict[str, float]) -> None:
        """Seed knob values from a live config (attach time): the
        controller starts from what the stack is actually running, not
        from its own defaults.  Unknown names are ignored; values are
        clamped into the knob's declared range."""
        for name, v in values.items():
            knob = self.knobs.get(name)
            if knob is not None:
                knob.set(v)

    def value(self, name: str) -> float:
        return self.knobs[name].value

    def values(self) -> dict[str, float]:
        return {name: k.value for name, k in self.knobs.items()}

    def clamp_range(self, name: str) -> tuple[float, float]:
        k = self.knobs[name]
        return (k.lo, k.hi)

    # ------------------------------------------------------------ control
    def slo_pressure(self, signals: dict) -> float:
        """Worst observed-p99 / target-p99 over the tenants with SLOs
        (``"*"`` matches every observed tenant).  0 when nothing to
        compare; > 1 means a violation is in progress."""
        per = signals.get("per_tenant_p99_us") or {}
        press = 0.0
        wild = self.slos.get("*", {}).get("p99_us")
        for tenant, p99 in per.items():
            target = self.slos.get(tenant, {}).get("p99_us", wild)
            if target and target > 0:
                press = max(press, p99 / target)
        if not per and wild and signals.get("p99_us"):
            press = signals["p99_us"] / wild
        return press

    def observe(self, signals: dict) -> dict[str, float]:
        """One control tick: vote every knob, return the applied moves
        (``{name: new_value}``; empty on hold ticks)."""
        self.ticks += 1
        self.last_signals = dict(signals)
        press = self.slo_pressure(signals)
        self.last_pressure = press
        changed: dict[str, float] = {}
        for name, decide in (
                ("commit_window_us", self._decide_commit_window),
                ("log_window_us", self._decide_log_window),
                ("bypass_watermark", self._decide_watermark),
                ("scan_threshold", self._decide_scan_threshold),
                ("hedge_delay_us", self._decide_hedge_delay)):
            knob = self.knobs.get(name)
            if knob is None:
                continue
            old = knob.value
            new = knob.vote(decide(signals, press, knob))
            if new is not None:
                changed[name] = new
                self.total_moves += 1
                self.history.append((self.ticks, name, old, new))
        return changed

    # ------------------------------------------------- per-knob decisions
    def _decide_commit_window(self, s: dict, press: float,
                              knob: Knob) -> int:
        rate = s.get("fsync_rate", 0.0)
        coal = s.get("coalesce_rate", 0.0)
        if rate >= self.FSYNC_HOT and coal < self.COALESCE_TARGET \
                and press <= self.SLO_BAND:
            return +1                 # syncs queueing un-coalesced: widen
        if knob.value > knob.lo and (rate < self.FSYNC_COLD
                                     or press > self.SLO_BAND):
            return -1                 # window is pure latency tax: decay
        return 0

    def _decide_log_window(self, s: dict, press: float,
                           knob: Knob) -> int:
        rate = s.get("log_rate", 0.0)
        coal = s.get("log_coalesce_rate", 0.0)
        if rate >= self.LOG_HOT and coal < self.COALESCE_TARGET \
                and press <= self.SLO_BAND:
            return +1
        if knob.value > knob.lo and (rate < self.LOG_COLD
                                     or press > self.SLO_BAND):
            return -1
        return 0

    def _decide_watermark(self, s: dict, press: float,
                          knob: Knob) -> int:
        stalls = s.get("stall_rate", 0.0)
        bypass = s.get("bypass_rate", 0.0)
        if stalls > self.STALL_HOT:
            return -1                 # evict-on-critical-path: bypass earlier
        if stalls <= self.STALL_HOT / 5 and bypass > self.BYPASS_HOT:
            return +1                 # staging has headroom: use the DRAM
        return 0

    def _decide_scan_threshold(self, s: dict, press: float,
                               knob: Knob) -> int:
        reads = s.get("read_rate", 0.0)
        hits = s.get("tier_hit_rate", 0.0)
        denials = s.get("scan_denial_rate", 0.0)
        if reads > 0.5 and hits < self.TIER_COLD \
                and denials < self.SCAN_DENIAL_HOT / 4:
            return -1                 # undetected scans flushing the tier
        if denials > self.SCAN_DENIAL_HOT and hits > self.TIER_HOT:
            return +1                 # hot working set misread as a scan
        return 0

    def _decide_hedge_delay(self, s: dict, press: float,
                            knob: Knob) -> int:
        if not s.get("limping"):
            return 0                  # healthy fleet: leave the trigger be
        target = s.get("healthy_p99_us", 0.0)
        if target <= 0:
            return 0
        if target > knob.value * self.HEDGE_BAND:
            return +1                 # trigger fires on healthy requests
        if target < knob.value / self.HEDGE_BAND:
            return -1                 # trigger too lazy to save the tail
        return 0

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"ticks": self.ticks, "total_moves": self.total_moves,
                "last_pressure": round(self.last_pressure, 4),
                "knobs": {n: k.stats() for n, k in self.knobs.items()}}


def make_default_controller(slos: dict[str, dict] | None = None, *,
                            hysteresis: int = 2) -> Controller:
    """The stock control plane: the five default knobs at their declared
    clamps, optional per-tenant SLOs (``{"tenant": {"p99_us": x}}``,
    ``"*"`` wildcard)."""
    return Controller(default_knobs(hysteresis=hysteresis), slos=slos,
                      hysteresis=hysteresis)
