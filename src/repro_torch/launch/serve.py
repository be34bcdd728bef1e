"""Serving launcher: batched requests against the paged-KV engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --no-smoke --requests 4 --max-new 16

Demonstrates continuous batching, the BTT-style block table, eager
page-out of finished sequences, and conditional bypass under pool pressure
(shrink --pool-pages to force it).  Weights are random, drawn from --seed.
Runs on the card by default; ``--device cpu`` runs the plain versions.

With ``--spill-volume`` the engine gets a volume-backed KV spill tier
(``serve.kvpager.KVPager`` on a striped async volume): requests are
suspended every ``--suspend-every`` ticks mid-decode, their packed pages
descend past ``--host-pages`` onto the volume as content-deduplicated
atomic records, and decode-ahead prefetch restores them before resume.
The volume is sized from the record (:func:`spill_volume_kwargs`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.transformer import init_lm
from repro_torch.serve import KVPager, PagedCacheConfig, ServeEngine
from repro_torch.volume.volume import make_volume


PREFETCH_DEPTH = 2     # suspended requests whose records are prefetched


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    # the paged engine serves the dense family, as the reference's does;
    # the other families run through ``models.api.build_model``
    ap.add_argument("--arch", default="qwen2.5-3b", choices=[
        a for a in ARCHS if get_config(a).family == "dense"])
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
    ap.add_argument("--spill-volume", action="store_true",
                    help="attach a volume-backed KV spill tier and "
                         "suspend/resume requests through it")
    ap.add_argument("--host-pages", type=int, default=4,
                    help="host-tier budget before pages spill to the "
                         "volume (with --spill-volume)")
    ap.add_argument("--suspend-every", type=int, default=6,
                    help="scheduler ticks between preemptions "
                         "(with --spill-volume)")
    return ap


def record_blocks(cfg, page_size: int, block_size: int = 4096) -> int:
    """Volume blocks of one spilled page's record: the pager's 8-byte
    header, then per layer two crcs and the K and V int8 payloads with
    their f32 row scales."""
    per_layer = 8 + 2 * page_size * (cfg.n_kv_heads * cfg.hd + 4)
    return -(-(8 + cfg.n_layers * per_layer) // block_size)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def spill_volume_kwargs(cfg, page_size: int, n_records: int, seq_pages: int,
                        prefetch_depth: int) -> dict:
    """``make_volume`` parameters for a spill tier of ``n_records`` page
    records of sequences of at most ``seq_pages`` pages: the journal
    commits one record atomically (``journal_slots`` x 8 blocks at least a
    record); the in-flight window holds every record of ``prefetch_depth``
    sequences as linked reads, and 64 spill writes beside them, so the
    pager never issues a chain that the window cuts short (cancelling a
    cut chain's queued links takes time that doubles with each link); and
    the pager's region (half the volume) holds every record."""
    blocks = record_blocks(cfg, page_size)
    return dict(n_lbas=2 * max(1 << 13, _pow2(n_records * blocks)),
                n_shards=2, aio_workers=2, cache_bytes=1 << 22,
                journal_slots=max(64, _pow2(-(-blocks // 8))),
                max_inflight=max(16, _pow2(prefetch_depth * seq_pages * blocks
                                           + 64)))


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_lm(cfg, gen)
    seq_pages = max(4, (args.prompt_len + args.max_new) // args.page_size + 2)
    vol = pager = None
    if args.spill_volume:
        kw = spill_volume_kwargs(cfg, args.page_size,
                                 args.requests * seq_pages, seq_pages,
                                 PREFETCH_DEPTH)
        vol = make_volume(**kw)
        pager = KVPager(vol, capacity_blocks=kw["n_lbas"] // 2)
    cache_cfg = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        page_size=args.page_size, n_pages=args.pool_pages,
        host_pages=args.host_pages if args.spill_volume else 1 << 30,
        max_pages_per_seq=seq_pages)
    eng = ServeEngine(cfg, params, cache_cfg=cache_cfg,
                      max_batch=args.max_batch, pager=pager,
                      prefetch_depth=PREFETCH_DEPTH, device=args.device)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(2, cfg.vocab, size=(args.prompt_len,)).tolist()
        eng.submit(prompt, max_new_tokens=args.max_new,
                   temperature=args.temperature)

    t0 = time.perf_counter()
    try:
        if args.spill_volume:
            # drive the scheduler by hand so we can preempt mid-decode: the
            # suspended request's pages transit host -> volume, and the
            # decode-ahead prefetch restores them before _admit resumes it
            ticks = 0
            while eng.queue or eng.running or eng.suspended:
                eng.step()
                ticks += 1
                if eng.running and ticks % args.suspend_every == 0:
                    eng.suspend(eng.running[0])
            done = eng.finished
        else:
            done = eng.run()
    finally:
        if vol is not None:
            vol.close()
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
    if args.spill_volume:
        path = eng.metrics.kv_paging_path()
        print(f"[spill] suspends {eng.metrics.count.get('suspends', 0)} "
              f"resumes {eng.metrics.count.get('resumes', 0)} "
              f"| spills {path['kv_spills']} "
              f"(dedup rate {path['dedup_rate']:.2f}) "
              f"| restores {path['kv_restores']} "
              f"(prefetch hit rate {path['prefetch_hit_rate']:.2f}) "
              f"| crc errors {path['kv_restore_crc_errors']}")


if __name__ == "__main__":
    main()
