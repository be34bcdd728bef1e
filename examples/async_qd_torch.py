"""Async submission/completion frontend quickstart + queue-depth sweep.

    PYTHONPATH=src python examples/async_qd.py

1. submit/poll against a real threaded volume: overlapped writes, an
   async read, a failed ticket (journal-ring overflow) that does NOT
   tear down the ring, and an async fsync barrier.
2. The zero-copy data plane: a registered buffer pool (pinned payloads
   instead of staging copies) driving a linked write -> fsync ->
   read-back-verify chain — three ops sequenced in-engine by IO_LINK,
   one wait instead of a poll round-trip per dependency.
3. The paper-scale contrast in virtual time: ops/s at queue depth
   1 (what a blocking frontend gets) vs 2/4/8/16 — submission batching
   amortizes the per-op stack cost and submitted ops overlap across the
   engine cores and shard DIMM banks.
"""
import numpy as np

from repro_torch.core.sim import run_aio_sim_workload
from repro_torch.volume import make_volume


def blk(x):
    return bytes([x % 256]) * 4096


# -- 1. real threaded engine -------------------------------------------------
vol = make_volume("caiti", n_lbas=65536, n_shards=4, cache_bytes=16 << 20)
# size the submit-side window up front (the default rides
# cfg.max_inflight; a submit over the bound fails ITS ticket — never
# blocks, never deadlocks the ring)
vol.aio_engine(n_workers=2, max_inflight_per_tenant=128)
rng = np.random.default_rng(0)
tickets = [vol.submit("write", int(lba), data=blk(int(lba)))
           for lba in rng.integers(0, 65536, size=64)]
tickets.append(vol.submit("write_multi", 70_000 % 65536,
                          blocks=[blk(i) for i in range(8)]))
bad = vol.submit("write_multi", 0, blocks=[blk(i) for i in range(4096)])
rd = vol.submit("read", int(tickets[0].lba))
sync = vol.submit("fsync")                   # barrier: runs after the rest
vol.wait(sync)
done = vol.poll()
ok = sum(1 for t in done if t.ok)
print(f"[aio] {len(done)} completions polled, {ok} ok; "
      f"oversized chain failed ITS ticket only: {type(bad.error).__name__}")
print(f"[aio] async read value matches: "
      f"{bytes(rd.value) == blk(int(tickets[0].lba))}")
print(f"[aio] engine stats: {vol.metrics_snapshot()['aio']}")

# -- 2. zero-copy pool + linked write -> fsync -> read-verify chain ----------
reg = vol.register_buffers(8)                # io_uring register_buffers
buf = reg.acquire()                          # pinned, not copied
buf.data[:] = 0xA5
w = vol.submit("write", 123, data=buf)       # head of the chain
f = vol.submit("fsync", link_to=w)           # runs only after w succeeds
verify = np.zeros(vol.block_size, np.uint8)  # read lands HERE, no copy
r = vol.submit("read", 123, link_to=f, out=verify)
vol.wait(r)                                  # ONE wait settles the chain
print(f"[link] write->fsync->read chain ok={w.ok and f.ok and r.ok}; "
      f"read-back verified: {bool((verify == 0xA5).all())}")
zc = vol.scrub()["zerocopy"]
print(f"[link] zerocopy: copies_avoided={zc['copies_avoided']} "
      f"bytes_pinned={zc['bytes_pinned']} "
      f"links={zc['links_submitted']} depth={zc['link_depth_max']} "
      f"pool={zc['registry']}")
vol.close()

# -- 3. queue-depth sweep (virtual time, deterministic) ----------------------
print("\n[sim] qd sweep: 4 shards, 4 tenants, uniform 4K writes")
tenants = [{"name": f"t{j}", "n_ops": 4000} for j in range(4)]
base = None
for qd in (1, 2, 4, 8, 16):
    r = run_aio_sim_workload("caiti", n_shards=4, n_lbas=262144,
                             cache_slots=8192, n_workers=16, qdepth=qd,
                             tenants=tenants)
    base = base or r["ops_s"]
    print(f"  qd={qd:<3d} ops/s={r['ops_s']:12.0f}  "
          f"agg={r['agg_mb_s']:8.1f} MB/s  "
          f"({r['ops_s'] / base:.2f}x vs qd=1)")
print("-> depth 8 is the acceptance point: >= 1.5x over depth 1")
