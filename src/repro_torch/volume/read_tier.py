"""CLOCK read tier in object mode: the part of
``repro.volume.read_tier.ReadTier`` the serving path uses.

Slots hold arbitrary objects (dequantized KV pages); the cache holds only
clean data, so losing an entry costs a hit, never data.  Readers fill on a
miss and writers invalidate.
"""
from __future__ import annotations

import threading


class ReadTier:
    """CLOCK/second-chance cache over ``n_slots`` clean object slots."""

    def __init__(self, n_slots: int, *, metrics=None) -> None:
        assert n_slots >= 1
        self.n_slots = n_slots
        self.metrics = metrics
        self._objs: list = [None] * n_slots
        self._keys: list = [None] * n_slots
        self._ref = bytearray(n_slots)
        self._map: dict = {}                   # key -> slot index
        self._hand = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.invalidations = 0

    def lookup(self, key):
        """Return the cached object (second chance granted), or None."""
        with self._lock:
            slot = self._map.get(key)
            if slot is None:
                self.misses += 1
                return None
            self._ref[slot] = 1
            self.hits += 1
            if self.metrics is not None:
                self.metrics.bump("read_tier_hits")
            return self._objs[slot]

    def insert(self, key, data) -> None:
        with self._lock:
            slot = self._map.get(key)
            if slot is None:
                slot = self._clock_victim()
                old = self._keys[slot]
                if old is not None:
                    del self._map[old]
                self._keys[slot] = key
                self._map[key] = slot
            self._ref[slot] = 1
            self._objs[slot] = data
            self.fills += 1
            if self.metrics is not None:
                self.metrics.bump("read_tier_fills")

    def _clock_victim(self) -> int:
        """Second chance: sweep the hand, clearing ref bits, until a slot
        with a clear bit comes up (bounded by two sweeps)."""
        for _ in range(2 * self.n_slots):
            slot = self._hand
            self._hand = (self._hand + 1) % self.n_slots
            if self._keys[slot] is None or not self._ref[slot]:
                return slot
            self._ref[slot] = 0
        return self._hand                       # pragma: no cover

    def invalidate(self, key) -> None:
        with self._lock:
            slot = self._map.pop(key, None)
            if slot is not None:
                self._keys[slot] = None
                self._ref[slot] = 0
                self._objs[slot] = None
                self.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._keys = [None] * self.n_slots
            self._ref = bytearray(self.n_slots)
            self._objs = [None] * self.n_slots

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "fills": self.fills, "invalidations": self.invalidations,
                "resident": len(self), "n_slots": self.n_slots,
                "hit_rate": self.hit_rate()}
