"""Unified admission layer for the write/read pipeline.

Before this module the stack's admission decisions were scattered: the
volume installed a ``bypass_hook`` closure on every shard cache (global
conditional-bypass watermark), the read tier filled on every miss
unconditionally, and QoS debiting lived inline in ``StripedVolume`` and
priced every read like a PMem round trip.  :class:`AdmissionPolicy` pulls
all three behind one object that ``CaitiCache``, ``StripedVolume``,
``ReadTier`` and ``TransitBuffer`` consult:

  * **write bypass** — ``should_bypass_write()`` is the volume's
    aggregate-staged watermark (the paper's conditional bypass extended
    volume-wide): when staged slots across all shards cross the
    watermark, a write miss transits straight to BTT even though its own
    shard still has free slots;
  * **read-tier fill admission** — ``admit_tier_fill(ns, lba)`` denies
    fills to *sequential scans*: a reader streaming a long contiguous
    range (backup, ``BlockStore.get`` of a giant object, table scan)
    would flush the tier's hot set for blocks it will never touch again.
    The detector tracks up to ``max_streams`` concurrent per-namespace
    runs (Linux-readahead style: an access extending a previously seen
    ``lba+1`` expectation lengthens that run); once a run exceeds
    ``scan_threshold`` blocks, further fills from it are dropped.  The
    first ``scan_threshold`` blocks of any scan still fill — random and
    short-run readers are unaffected;
  * **tier-aware QoS pricing** — ``read_charge(nbytes, source)`` is the
    byte cost a tenant's token bucket is debited for a read.  A transit-
    cache or read-tier hit is a DRAM copy, not a PMem round trip, so it
    is charged ``tier_hit_cost_frac`` of its size (default 1/8); only
    backend reads pay full price.  A tier-hot tenant therefore is not
    throttled like a PMem-bound one (ROADMAP follow-on);
  * **limping-shard steering** — ``set_shard_penalties`` installs the
    :class:`~repro_torch.core.metrics.ShardScorer`'s per-shard price
    multipliers (healthy 1x, limping/dead higher), and ``op_charge``
    applies them when the caller tags the op with its target ``shard=``:
    work headed for a fail-slow device costs MORE virtual time, so the
    WFQ gate naturally schedules around the limper instead of feeding
    the queue that is already 25x slow.

The object is deliberately dumb and lock-cheap: every hook is O(1) under
one small lock, safe to call from foreground read/write paths and from
pool workers.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class ScanDetector:
    """Sequential-run tracker, keyed by (namespace, expected-next-lba).

    ``observe(ns, lba)`` returns the length of the run this access
    extends (1 for a random access).  Up to ``max_streams`` interleaved
    streams are tracked per namespace so two concurrent scanners (or a
    scanner plus random readers) do not reset each other.
    """

    def __init__(self, max_streams: int = 8) -> None:
        self.max_streams = max_streams
        # ns -> OrderedDict{expected_next_lba -> run_len}
        self._streams: dict[object, OrderedDict] = {}

    def observe(self, ns, lba: int) -> int:
        streams = self._streams.setdefault(ns, OrderedDict())
        run = streams.pop(lba, 0) + 1
        # expectation-key collision: a one-shot access at (stream head
        # - 1) writes the SAME next-lba key an established run already
        # owns — keep the longer counter instead of clobbering it (and
        # pop first so the entry really moves to MRU, keeping the
        # just-inserted-survives eviction rule honest)
        run_kept = max(run, streams.pop(lba + 1, 0))
        streams[lba + 1] = run_kept
        while len(streams) > self.max_streams:
            # Two-class eviction.  Run-length-1 entries (noise and
            # not-yet-established streams) churn in a NURSERY of up to
            # half the table: while they fit, the victim is instead the
            # least recently extended entry overall — so one-shot noise
            # cannot push out an established run counter, stale counters
            # from finished scans age out, and a brand-new stream's
            # first expectation survives moderate noise long enough to
            # establish.  Only when run-1 entries overflow the nursery
            # does the coldest of THEM (never the one this access just
            # inserted) get dropped — a noise rate of half the table per
            # stream step is the documented starvation bound.
            nursery = max(1, self.max_streams // 2)
            newest = next(reversed(streams))
            run1 = [k for k, v in streams.items()
                    if v <= 1 and k != newest]
            if len(run1) >= nursery:
                streams.pop(run1[0])         # noise churns in the nursery
            else:
                streams.popitem(last=False)  # aging: least recently
        return run                           # extended goes first

    def current_run(self, ns, lba: int) -> int:
        """Run length of the stream that ``lba`` belongs to (after its
        observe), without mutating detector state."""
        streams = self._streams.get(ns)
        if not streams:
            return 1
        return streams.get(lba + 1, 1)


class AdmissionPolicy:
    """One policy object for the three scattered admission decisions.

    ``staged_slots_fn``/``watermark_slots`` — aggregate bypass watermark
    (the volume wires its shard caches' staged-slot sum in here).
    ``scan_threshold`` — run length above which tier fills are denied
    (0 disables scan detection: every fill admitted).
    ``tier_hit_cost_frac`` — QoS price of a DRAM-served read relative to
    a backend (PMem) read of the same size.
    """

    def __init__(self, *, staged_slots_fn=None, watermark_slots: int = 0,
                 scan_threshold: int = 64, max_streams: int = 8,
                 tier_hit_cost_frac: float = 0.125) -> None:
        assert 0.0 <= tier_hit_cost_frac <= 1.0
        self.staged_slots_fn = staged_slots_fn
        self.watermark_slots = watermark_slots
        self.scan_threshold = scan_threshold
        self.tier_hit_cost_frac = tier_hit_cost_frac
        self._detector = ScanDetector(max_streams=max_streams)
        self._lock = threading.Lock()
        self.scan_fill_denials = 0
        # limping-shard steering: shard -> price multiplier (>= 1.0),
        # refreshed from the ShardScorer by the volume's tail-state pass
        self._shard_penalty: dict[int, float] = {}
        self.steered_charges = 0

    # ----------------------------------------------------------- retuning
    def retune(self, *, watermark_slots: int | None = None,
               scan_threshold: int | None = None,
               tier_hit_cost_frac: float | None = None) -> dict:
        """Online knob update from the control plane (``autotune``):
        each provided value replaces the live one under the policy lock,
        so foreground readers never see a torn update.  Returns the
        post-update values.  Callers (the volume's ``autotune_step``)
        are responsible for clamping — this layer only refuses
        nonsense."""
        with self._lock:
            if watermark_slots is not None:
                self.watermark_slots = max(0, int(watermark_slots))
            if scan_threshold is not None:
                self.scan_threshold = max(0, int(scan_threshold))
            if tier_hit_cost_frac is not None:
                assert 0.0 <= tier_hit_cost_frac <= 1.0
                self.tier_hit_cost_frac = tier_hit_cost_frac
            return {"watermark_slots": self.watermark_slots,
                    "scan_threshold": self.scan_threshold,
                    "tier_hit_cost_frac": self.tier_hit_cost_frac}

    # -------------------------------------------------- fail-slow steering
    def set_shard_penalties(self, penalties: dict[int, float]) -> None:
        """Install the scorer's per-shard price multipliers (1.0 =
        healthy; entries at 1.0 are dropped so the hot path dict stays
        tiny)."""
        with self._lock:
            self._shard_penalty = {s: p for s, p in penalties.items()
                                   if p > 1.0}

    def shard_penalty(self, shard) -> float:
        with self._lock:
            return self._shard_penalty.get(shard, 1.0)

    # ------------------------------------------------------- write bypass
    def should_bypass_write(self) -> bool:
        """Volume-wide conditional bypass: aggregate staged slots crossed
        the watermark — one PMem write beats evict-then-fill."""
        if self.staged_slots_fn is None or self.watermark_slots <= 0:
            return False
        return self.staged_slots_fn() >= self.watermark_slots

    # --------------------------------------------------- read observation
    def observe_read(self, ns, lba: int) -> int:
        """Feed one read access to the scan detector; returns the run
        length this access extends.  Call once per read, before the fill
        decision."""
        if self.scan_threshold <= 0:
            return 1
        with self._lock:
            return self._detector.observe(ns, lba)

    def observe_and_admit(self, ns, lba: int) -> bool:
        """One-lock fast path for the cache read miss: feed the detector
        AND decide the fill in a single acquisition (the observe/admit
        split costs two lock round trips per miss on a shared policy)."""
        if self.scan_threshold <= 0:
            return True
        with self._lock:
            if self._detector.observe(ns, lba) <= self.scan_threshold:
                return True
            self.scan_fill_denials += 1
            return False

    def admit_tier_fill(self, ns, lba: int) -> bool:
        """May this read-miss fill the clean read tier?  False once the
        access belongs to a sequential run longer than the threshold —
        giant scans bypass the tier instead of flushing the hot set.
        Pure (no detector update): safe to re-check at insert time."""
        if self.scan_threshold <= 0:
            return True
        with self._lock:
            if self._detector.current_run(ns, lba) <= self.scan_threshold:
                return True
            self.scan_fill_denials += 1
            return False

    def admit_key_fill(self, key) -> bool:
        """Tier-side hook for ``ReadTier.insert``: unpack the volume's
        ``(ns, lba)`` block keys; object-mode keys are always admitted
        (no address locality to detect scans on)."""
        if (isinstance(key, tuple) and len(key) == 2
                and isinstance(key[1], int)):
            return self.admit_tier_fill(key[0], key[1])
        return True

    # ------------------------------------------------------- QoS pricing
    def read_charge(self, nbytes: int, source: str) -> int:
        """Token-bucket debit for a read served from ``source``
        ('transit' | 'tier' | 'backend').  DRAM hits cost a fraction."""
        if source == "backend":
            return nbytes
        return int(nbytes * self.tier_hit_cost_frac)

    def write_charge(self, nbytes: int) -> int:
        return nbytes

    def op_charge(self, nbytes: int, op: str, tier: str | None = None,
                  shard=None) -> int:
        """Virtual-time price of one op for the tier-aware WFQ gate.

        Reads are priced like :meth:`read_charge` by their PROBED tier
        (``CaitiCache.probe``): a read the probe found DRAM-resident
        ('transit'/'tier') admits at the DRAM fraction; an untagged read
        (``tier=None`` — probe says it is headed for the backend) pays
        the full PMem price up front.  The probe can race the stack, so
        the volume settles one-sidedly post-service (``_debit_read``): a
        read that cost MORE than its tag charges the remainder via
        ``WFQGate.charge``; the rare cheaper-than-tagged read (a fill
        landed mid-flight) keeps its conservative price.  Writes
        (including batched ``log`` flushes) pay full byte price.

        ``shard=`` tags the op with its target device: an op headed for
        a limping shard is priced UP by the installed penalty
        multiplier (fail-slow steering — see module docstring)."""
        if op == "read":
            cost = self.read_charge(nbytes, tier or "backend")
        else:
            cost = self.write_charge(nbytes)
        if shard is not None and self._shard_penalty:
            with self._lock:
                pen = self._shard_penalty.get(shard, 1.0)
            if pen > 1.0:
                self.steered_charges += 1
                cost = int(cost * pen)
        return cost

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"scan_fill_denials": self.scan_fill_denials,
                "scan_threshold": self.scan_threshold,
                "watermark_slots": self.watermark_slots,
                "tier_hit_cost_frac": self.tier_hit_cost_frac,
                "shard_penalties": dict(self._shard_penalty),
                "steered_charges": self.steered_charges}
