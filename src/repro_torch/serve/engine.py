"""Serving engine: continuous batching over the paged (BTT-style) KV cache.

The port of ``repro.serve.engine`` for the dense decoder family.  Prefill
attends over the prompt in the flash-attention kernel.  Per decode layer,
the new token's K/V are written into the sequence's pages (the block-table
write, lba -> pba) and attention walks the pages through the table inside
the paged-attention kernel.  CPU tensors take each kernel's plain version.

Scheduling follows the paper's transit discipline:
  * finished / preempted sequences are *eagerly* packed to the host tier
    (``deactivate``) so the device pool stays near-empty;
  * when admission would overflow the pool anyway, the new sequence's pages
    *bypass* to the host tier rather than stall a running decode;
  * with a pager, host-tier overflow descends to a volume, and the next
    suspended requests' records are prefetched each tick before admission;
  * with a request log, each retired request is appended to a volume
    through its async frontend, overlapped with decode, and ``run()``
    settles the appends with one fsync barrier at the end.

The layer loop runs on the host in Python, and the parameters are a plain
dict on the engine's device (``models.transformer``).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.metrics import Metrics
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_norm, mlp_apply, out_proj,
                                       qkv_proj, rope)
from .kvcache import PagedCacheConfig, PagedKVCache


@dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: list[int] = field(default_factory=list)
    seq_id: int = -1
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class PagedLM:
    """Paged decode path for the dense transformer family."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 cache: PagedKVCache) -> None:
        assert cfg.family == "dense", "paged engine serves dense LMs"
        self.cfg = cfg
        self.params = params
        self.cache = cache
        self.device = params["embed"].device

    def _qkv(self, x, blk, positions):
        """x: (B, T, D) -> rotated q (B, T, H, hd), k, v (B, T, Hkv, hd)."""
        cfg = self.cfg
        q, k, v = qkv_proj(apply_norm(x, blk["ln1"], cfg.norm), blk["attn"],
                           cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        if cfg.pos == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _finish_block(self, x, a, blk):
        """Output projection of attention ``a`` (B, T, H, hd), then the MLP."""
        x = x + out_proj(a, blk["attn"])
        h = apply_norm(x, blk["ln2"], self.cfg.norm)
        return x + mlp_apply(h, blk["mlp"], self.cfg.act)

    def _logits(self, x):
        p, cfg = self.params, self.cfg
        x = apply_norm(x, p["final_norm"], cfg.norm)
        w = p["embed"].T if cfg.tie_embeddings else p["head"]
        return (x @ w).float()

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, sid: int) -> torch.Tensor:
        """Run the prompt through the model, write its K/V pages, return
        the last-token logits (V,) f32.  tokens: (T,) one sequence."""
        cfg, p = self.cfg, self.params
        T = len(tokens)
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=self.device)[None]
        x = p["embed"][tok]
        positions = torch.arange(T, device=self.device)[None]
        ks, vs = [], []
        for blk in p["blocks"]:
            q, k, v = self._qkv(x, blk, positions)
            # causal attention over the prompt (the flash kernel); pages
            # are written below for the decode phase
            a = flash_attention(q, k, v, causal=True, window=cfg.attn_window)
            x = self._finish_block(x, a, blk)
            ks.append(k[0])                              # (T, Hkv, hd)
            vs.append(v[0])
        self.cache.append_tokens(sid, ks, vs)            # bulk write path
        return self._logits(x[:, -1:])[0, 0]

    @torch.no_grad()
    def decode_step(self, tokens: np.ndarray, sids: list[int],
                    positions: np.ndarray) -> torch.Tensor:
        """One token for each running sequence. tokens: (B,), returns
        (B, V) f32 logits."""
        cfg, p = self.cfg, self.params
        B = len(tokens)
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=self.device)[:, None]
        pos = torch.as_tensor(np.asarray(positions, np.int64),
                              device=self.device)[:, None]
        x = p["embed"][tok]                              # (B, 1, D)
        none = [None] * cfg.n_layers
        for li, blk in enumerate(p["blocks"]):
            q, k, v = self._qkv(x, blk, pos)
            # write THIS layer's kv before attending (token attends to
            # self): layer 0 appends the slot, layers > 0 fill it in place
            for bi, sid in enumerate(sids):
                if li == 0:
                    self.cache.append_token(sid, [k[bi, 0]] + none[1:],
                                            [v[bi, 0]] + none[1:])
                else:
                    self.cache.overwrite_token(sid, li, (k[bi, 0], v[bi, 0]))
            a = self.cache.attention(li, q[:, 0], sids)
            x = self._finish_block(x, a[:, None], blk)
        return self._logits(x)[:, 0]


class AsyncRequestLog:
    """Durable request log riding a striped volume's async frontend, or a
    cluster's (``cluster.make_cluster``: each record chain-replicated to
    its chunk's members, an oversized record refused by the cluster's
    chunk-bounded atomic write).

    Each retired request is one JSON record (a 4-byte little-endian
    length, then the text, padded to whole blocks), appended as a
    ``write`` or chained ``write_multi`` through ``volume.submit``, so
    the write overlaps the next decode step instead of stalling the
    scheduler tick.  ``drain()`` issues one async fsync barrier, which
    the volume orders after every in-flight append, then collects each
    append's error: a device error surfaces as that record's failure,
    not as a serving-loop exception.

    The log is a ring over ``[base_lba, base_lba + capacity_blocks)``:
    a long-running loop wraps and overwrites its oldest records instead
    of writing past the volume.  A record may not exceed the device's
    ``max_atomic_write_blocks()``, so a multi-block append commits
    whole.  ``registered_buffers > 0`` appends through a pool of pinned
    buffers registered with the volume's engine (the payload is never
    copied under the engine's lock; buffers return to the pool when
    their ticket settles)."""

    def __init__(self, volume, *, base_lba: int = 0,
                 capacity_blocks: int | None = None,
                 tenant: str | None = None,
                 registered_buffers: int = 0) -> None:
        self.vol = volume
        self.tenant = tenant
        self.block_size = volume.block_size
        self._reg = (volume.register_buffers(registered_buffers)
                     if registered_buffers > 0 else None)
        self._max_rec = volume.max_atomic_write_blocks()
        self._base = base_lba
        self._cap = (volume.n_lbas - base_lba if capacity_blocks is None
                     else capacity_blocks)
        if self._cap < 1:
            raise ValueError(f"request log ring of {self._cap} blocks")
        self._off = 0
        self._tickets: list = []
        self.logged = 0
        self.wraps = 0
        self.errors: list[tuple[int, BaseException]] = []

    def _alloc(self, n_blocks: int) -> int:
        if n_blocks > self._cap:
            raise ValueError(f"record of {n_blocks} blocks is larger than "
                             f"the log ring ({self._cap})")
        if n_blocks > self._max_rec:
            raise ValueError(f"record of {n_blocks} blocks exceeds the "
                             f"device's whole-object-atomic bound "
                             f"({self._max_rec})")
        if self._off + n_blocks > self._cap:
            self._off = 0                    # wrap: oldest records go
            self.wraps += 1
        lba = self._base + self._off
        self._off += n_blocks
        return lba

    def append(self, record: dict) -> None:
        raw = json.dumps(record).encode()
        bs = self.block_size
        payload = len(raw).to_bytes(4, "little") + raw
        blocks = [payload[i:i + bs].ljust(bs, b"\x00")
                  for i in range(0, len(payload), bs)]
        if self._reg is not None:
            regs = []
            for chunk in blocks:
                buf = self._reg.acquire()
                buf.data[:len(chunk)] = np.frombuffer(chunk, np.uint8)
                regs.append(buf)
            blocks = regs
        # block=True: a retirement burst deeper than the engine's in-flight
        # window waits its turn; a record is never dropped
        lba = self._alloc(len(blocks))
        if len(blocks) > 1:
            t = self.vol.submit("write_multi", lba, blocks=blocks,
                                tenant=self.tenant, block=True)
        else:
            t = self.vol.submit("write", lba, data=blocks[0],
                                tenant=self.tenant, block=True)
        self._tickets.append((lba, t))
        self.logged += 1

    def drain(self) -> int:
        """One async fsync barrier, then the appends' errors; returns how
        many records failed since the previous drain (all failures stay in
        ``errors``).  The barrier goes first: the volume orders it after
        every in-flight append, so one wait covers them all."""
        reported = len(self.errors)
        sync = self.vol.submit("fsync", block=True)
        self.vol.wait(sync)
        tickets, self._tickets = self._tickets, []
        for lba, t in tickets:           # already settled: collect
            self.vol.wait(t)
            if t.error is not None:
                self.errors.append((lba, t.error))
        if sync.error is not None:
            raise sync.error
        return len(self.errors) - reported


class ServeEngine:
    """Continuous-batching front end.

    ``pager`` adds the volume-backed KV spill tier, with ``prefetch_depth``
    suspended requests' records read ahead each tick.  ``request_log``
    (an :class:`AsyncRequestLog`) records every retired request's
    ``{"req_id", "prompt", "tokens"}``; ``run()`` drains it at the end
    and counts its failures (``request_log_failures``).  ``autotune_every
    = N > 0`` runs one ``autotune_step()`` of the request log's volume
    every N ticks of ``run()`` and counts the knobs it moved
    (``autotune_moves``)."""

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 cache_cfg: PagedCacheConfig | None = None,
                 max_batch: int = 8, eos_token: int = -1, rng_seed: int = 0,
                 request_log: AsyncRequestLog | None = None,
                 autotune_every: int = 0,
                 pager=None, prefetch_depth: int = 2,
                 device="cuda") -> None:
        self.cfg = cfg
        self.metrics = Metrics()
        self.request_log = request_log
        self.autotune_every = autotune_every
        self._ticks_since_tune = 0
        # optional volume-backed KV spill tier (serve.kvpager.KVPager):
        # suspended sessions' cold pages descend past the host tier onto
        # the volume; prefetch_depth suspended requests get decode-ahead
        # linked reads issued each tick so their resume overlaps decode
        self.prefetch_depth = prefetch_depth
        # the default pools are the cache config's own dtype (bf16), as
        # the reference's are, whatever the model's dtype
        self.cache = PagedKVCache(cache_cfg or PagedCacheConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd), metrics=self.metrics, pager=pager,
            device=device)
        self.lm = PagedLM(cfg, params, self.cache)
        if self.lm.device != self.cache.device:
            raise ValueError(f"parameters on {self.lm.device}, cache on "
                             f"{self.cache.device}")
        self.max_batch = max_batch
        self.eos = eos_token
        self.queue: list[Request] = []
        self.running: list[Request] = []
        self.suspended: list[Request] = []
        self.finished: list[Request] = []
        self._rng = np.random.default_rng(rng_seed)
        self._next_id = 0

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               temperature: float = 0.0) -> Request:
        req = Request(self._next_id, list(prompt), max_new_tokens,
                      temperature, t_submit=time.perf_counter())
        self._next_id += 1
        self.queue.append(req)
        return req

    # ----------------------------------------------------------- scheduling
    def suspend(self, req: Request) -> None:
        """Preempt a running request: its pages eagerly transit out
        (host tier, then the volume once the host budget overflows);
        ``_admit`` resumes it ahead of fresh prompts."""
        self.running.remove(req)
        self.cache.deactivate(req.seq_id)
        self.suspended.append(req)
        self.metrics.bump("suspends")

    def _prefetch_ahead(self) -> None:
        """Decode-ahead restore: linked async reads for the next
        ``prefetch_depth`` suspended requests' spilled pages, issued
        BEFORE admission so the volume round trip overlaps this tick's
        decode instead of stalling activate()."""
        for req in self.suspended[:self.prefetch_depth]:
            self.cache.prefetch(req.seq_id)

    def _admit(self) -> None:
        # resumes first: a suspended request already holds KV
        while self.suspended and len(self.running) < self.max_batch:
            req = self.suspended.pop(0)
            self.cache.activate(req.seq_id)
            self.running.append(req)
            self.metrics.bump("resumes")
        while self.queue and len(self.running) < self.max_batch:
            req = self.queue.pop(0)
            req.seq_id = self.cache.new_sequence()
            logits = self.lm.prefill(np.asarray(req.prompt, np.int32),
                                     req.seq_id)
            tok = self._sample(logits[None], [req])[0]
            req.out_tokens.append(int(tok))
            req.t_first = time.perf_counter()
            self.running.append(req)

    def _sample(self, logits, reqs) -> np.ndarray:
        out = np.zeros((len(reqs),), np.int64)
        logits = logits.cpu().numpy()
        for i, req in enumerate(reqs):
            if req.temperature <= 0:
                out[i] = int(np.argmax(logits[i]))
            else:
                z = logits[i] / req.temperature
                z = z - z.max()
                prob = np.exp(z) / np.exp(z).sum()
                out[i] = int(self._rng.choice(len(prob), p=prob))
        return out

    def _retire(self, req: Request) -> None:
        req.done = True
        req.t_done = time.perf_counter()
        self.cache.deactivate(req.seq_id)     # eager transit to host tier
        self.cache.release(req.seq_id)
        if self.request_log is not None:      # overlapped, never a stall
            self.request_log.append({"req_id": req.req_id,
                                     "prompt": req.prompt,
                                     "tokens": req.out_tokens})
        self.finished.append(req)

    def step(self) -> int:
        """One scheduler tick: admit, decode one token for every runner."""
        self._prefetch_ahead()
        self._admit()
        if not self.running:
            return 0
        reqs = self.running
        tokens = np.asarray([r.out_tokens[-1] for r in reqs], np.int64)
        positions = np.asarray([len(r.prompt) + len(r.out_tokens) - 1
                                for r in reqs], np.int64)
        logits = self.lm.decode_step(tokens, [r.seq_id for r in reqs],
                                     positions)
        nxt = self._sample(logits, reqs)
        still = []
        for req, tok in zip(reqs, nxt):
            req.out_tokens.append(int(tok))
            if (len(req.out_tokens) >= req.max_new_tokens
                    or tok == self.eos):
                self._retire(req)
            else:
                still.append(req)
        self.running = still
        return len(reqs)

    def _autotune_tick(self) -> None:
        """Every ``autotune_every`` ticks, one control step of the request
        log's volume (a no-op without a controller attached to it)."""
        if self.autotune_every <= 0 or self.request_log is None:
            return
        self._ticks_since_tune += 1
        if self._ticks_since_tune < self.autotune_every:
            return
        self._ticks_since_tune = 0
        moves = self.request_log.vol.autotune_step()
        if moves:
            self.metrics.bump("autotune_moves", len(moves))

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        ticks = 0
        while (self.queue or self.running or self.suspended) \
                and ticks < max_ticks:
            self.step()
            self._autotune_tick()
            ticks += 1
        if self.request_log is not None:
            n_bad = self.request_log.drain()  # settle overlapped appends
            if n_bad:                         # surfaced, not swallowed
                self.metrics.bump("request_log_failures", n_bad)
        return self.finished
