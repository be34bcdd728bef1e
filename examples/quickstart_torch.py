"""Quickstart: the paper's device stack in 60 seconds.

    PYTHONPATH=src python examples/quickstart.py

1. builds a Caiti-cached PMem block device (threaded implementation),
   writes/reads/fsyncs through the bio interface;
2. runs the calibrated virtual-time simulator to reproduce the paper's
   headline contrast (BTT vs staging caches vs Caiti);
3. shows the same algorithm as a checkpoint transit buffer.
"""
import numpy as np

from repro_torch.core import fsync_bio, make_device
from repro_torch.core.sim import run_sim_workload

# -- 1. a real (threaded) Caiti device -------------------------------------
dev = make_device("caiti", n_lbas=4096, cache_bytes=1 << 20)
block = bytes(np.random.default_rng(0).integers(0, 256, 4096, np.uint8))
for lba in range(256):
    dev.write(lba, block)
dev.submit_bio(fsync_bio())                     # PREFLUSH|FUA drain
assert bytes(dev.read(17)) == block
print(f"[device] 256 writes + fsync done; cache occupancy now "
      f"{dev.occupancy():.2f}; background evictions "
      f"{dev.metrics.count.get('bg_evictions', 0)}")
dev.close()

# -- 2. the paper's contrast in virtual time --------------------------------
print("\n[sim] uniform 4K random writes, iodepth 32 (virtual time):")
base = {}
for policy in ("raw", "dax", "btt", "pmbd", "lru", "coactive", "caiti"):
    m = run_sim_workload(policy, n_ops=20_000, n_lbas=262_144,
                         cache_slots=4_096, iodepth=32)
    base[policy] = m.counts["makespan_us"] / 1e6
    print(f"  {policy:10s} {base[policy]:7.3f}s  mean {m.mean():7.2f}us  "
          f"p99.99 {m.pct(99.99):9.1f}us")
print(f"  -> caiti is {base['btt'] / base['caiti']:.2f}x faster than BTT "
      f"(paper: up to 3.6x)")

# -- 3. Caiti as a transit buffer for arbitrary sinks ------------------------
from repro_torch.core import TransitBuffer

stored = []
tb = TransitBuffer(stored.append, capacity_bytes=1 << 20, n_workers=2)
for i in range(100):
    tb.put(f"chunk{i}", nbytes=8 << 10)        # eagerly evicted to the sink
tb.flush()                                      # the fsync analogue
print(f"\n[transit] 100 chunks staged -> {len(stored)} sunk; "
      f"flush found {tb.staged_bytes()} bytes left (eager eviction)")
tb.close()
