"""Deterministic, restartable data pipeline.

Production property this reproduces: after a crash/restart at step k, the
pipeline re-issues *exactly* the batches k, k+1, ... (checkpoint stores only
the step number — no pipeline state files).  Achieved by deriving every
batch from ``fold_in(seed, step)``; multi-host sharding derives per-host
slices from ``fold_in(·, host_id)``.

Two sources:
  * ``SyntheticLM``   — zipf-ish token stream with documents + BOS/EOS
                        packing (shape-faithful stand-in for a tokenized
                        corpus; CPU container has no real corpus).
  * ``MemmapCorpus``  — a flat token memmap (e.g. tokenized The Pile shard)
                        sampled with the same deterministic schedule.

A double-buffering prefetch thread overlaps host batch assembly with device
compute (the data-side analogue of eager eviction: produce ahead, never
stall the consumer).
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    """Deterministic synthetic LM batches: (tokens, targets) int32."""

    def __init__(self, vocab: int, seq: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0) -> None:
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.seq = seq
        self.batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, step]))
        B, T, V = self.batch, self.seq, self.vocab
        # zipf-ish marginal over the vocab (reserve 0/1 for BOS/EOS)
        z = rng.zipf(1.3, size=(B, T + 1)).astype(np.int64)
        toks = 2 + (z % (V - 2))
        # document packing: segment lengths ~ geometric, BOS at starts
        doc_end = rng.random((B, T + 1)) < (1.0 / 256)
        toks = np.where(doc_end, 1, toks)               # EOS
        starts = np.roll(doc_end, 1, axis=1)
        starts[:, 0] = True
        toks = np.where(starts, 0, toks)                # BOS
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :T], "targets": toks[:, 1:T + 1]}


class MemmapCorpus:
    """Flat-token corpus (np.memmap/ndarray) with the same contract."""

    def __init__(self, tokens: np.ndarray, seq: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0) -> None:
        assert global_batch % n_hosts == 0
        self.tokens = tokens
        self.seq = seq
        self.batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id
        self._n = len(tokens) - seq - 1

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, step]))
        offs = rng.integers(0, self._n, size=(self.batch,))
        toks = np.stack([self.tokens[o:o + self.seq + 1] for o in offs])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :self.seq], "targets": toks[:, 1:]}


class Prefetcher:
    """Double-buffered background batch producer."""

    def __init__(self, source, start_step: int = 0, depth: int = 2) -> None:
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="data-prefetch")
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict[str, np.ndarray]]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
