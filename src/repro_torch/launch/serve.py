"""Serving launcher: batched requests against the paged-KV engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --no-smoke --requests 4 --max-new 16

Demonstrates continuous batching, the BTT-style block table, eager
page-out of finished sequences, and conditional bypass under pool pressure
(shrink --pool-pages to force it).  Weights are random, drawn from --seed.
Runs on the card by default; ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.transformer import init_lm
from repro_torch.serve import PagedCacheConfig, ServeEngine

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list(ARCHS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="the SMOKE config (--no-smoke: FULL)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--pool-pages", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_lm(cfg, gen)
    cache_cfg = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        page_size=args.page_size, n_pages=args.pool_pages, dtype=cfg.dtype,
        max_pages_per_seq=max(4, (args.prompt_len + args.max_new)
                              // args.page_size + 2))
    eng = ServeEngine(cfg, params, cache_cfg=cache_cfg,
                      max_batch=args.max_batch, device=args.device)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(2, cfg.vocab, size=(args.prompt_len,)).tolist()
        eng.submit(prompt, max_new_tokens=args.max_new,
                   temperature=args.temperature)

    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    lat = [r.t_done - r.t_submit for r in done]
    print(f"[serve] {cfg.name} on {eng.cache.device}: {len(done)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s) "
          f"| mean latency {np.mean(lat) * 1e3:.0f}ms "
          f"| pool occupancy now {eng.cache.occupancy():.2f} "
          f"| pages out/in {eng.metrics.count.get('pages_out', 0)}/"
          f"{eng.metrics.count.get('pages_in', 0)} "
          f"| bypass pages {eng.metrics.count.get('bypass_pages', 0)}")


if __name__ == "__main__":
    main()
