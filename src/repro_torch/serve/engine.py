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
    suspended requests' records are prefetched each tick before admission.

The layer loop runs on the host in Python, and the parameters are a plain
dict on the engine's device (``models.transformer``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.metrics import Metrics
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_norm, mlp_apply, rope
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
        cfg, a = self.cfg, blk["attn"]
        B, T, _ = x.shape
        xn = apply_norm(x, blk["ln1"], cfg.norm)
        q = (xn @ a["wq"]).reshape(B, T, cfg.n_heads, cfg.hd)
        k = (xn @ a["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
        v = (xn @ a["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
        if "bq" in a:
            q = q + a["bq"].reshape(1, 1, cfg.n_heads, cfg.hd)
            k = k + a["bk"].reshape(1, 1, cfg.n_kv_heads, cfg.hd)
            v = v + a["bv"].reshape(1, 1, cfg.n_kv_heads, cfg.hd)
        if cfg.pos == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _finish_block(self, x, a, blk):
        """Output projection of attention ``a`` (B, T, H*hd), then the MLP."""
        x = x + a @ blk["attn"]["wo"]
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
            x = self._finish_block(x, a.reshape(1, T, -1), blk)
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
            x = self._finish_block(x, a.reshape(B, 1, -1), blk)
        return self._logits(x)[:, 0]


class ServeEngine:
    """Continuous-batching front end."""

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 cache_cfg: PagedCacheConfig | None = None,
                 max_batch: int = 8, eos_token: int = -1, rng_seed: int = 0,
                 pager=None, prefetch_depth: int = 2,
                 device="cuda") -> None:
        self.cfg = cfg
        self.metrics = Metrics()
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

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        ticks = 0
        while (self.queue or self.running or self.suspended) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
