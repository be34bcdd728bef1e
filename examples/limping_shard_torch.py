"""Fail-slow ("limplock") quickstart: one limping shard, hedged reads.

    PYTHONPATH=src python examples/limping_shard.py

A limping device is the failure replication can't see: 10-100x slow,
never erroring, never missing a heartbeat — mean throughput looks fine
(only 1/n_shards of uniform reads land on it) while p99 collapses to
the limping device's service time.

1. sim — the acceptance contrast in virtual time: a 4-shard volume with
   one 25x limping shard, unhedged vs hedged.  The hedge fires the
   replica leg after ~3x a healthy read and takes the first completion;
   p99 drops back to healthy territory at no throughput cost (the same
   contrast CI gates with the `volume_hedge` lower-is-better floor).
2. threaded — the real async engine: stall one shard's read path,
   `hedged_read` escapes through the replica while the loser is
   cancelled (pinned buffers released, counters balance).
3. scoring + steering — per-shard p50/p99 digests classify the shard
   `limping`; `scrub()["tail"]` surfaces the verdicts, the auto hedge
   delay, and the `hedges_fired == hedges_won + hedges_cancelled`
   balance; the same pass prices limping shards up in WFQ and steers
   eviction drains away from them.
"""
import time

from repro_torch.core.sim import run_hedge_sim_workload
from repro_torch.volume import make_volume


def blk(x):
    return bytes([x % 256]) * 4096


# -- 1. sim: hedged vs unhedged under one 25x limping shard ------------------
kw = dict(n_lbas=65536, n_ops=4000, n_shards=4, slow_shard=0,
          slow_factor=25.0)
un = run_hedge_sim_workload("btt", hedge=False, **kw)
he = run_hedge_sim_workload("btt", hedge=True, **kw)
print(f"[sim] unhedged: p50 {un['p50_us']:6.2f}us  p99 {un['p99_us']:6.2f}us"
      f"  ({un['ops_s'] / 1e3:.0f}k ops/s)  <- p99 limping, mean fine")
print(f"[sim]   hedged: p50 {he['p50_us']:6.2f}us  p99 {he['p99_us']:6.2f}us"
      f"  ({he['ops_s'] / 1e3:.0f}k ops/s)")
c = he["counts"]
print(f"[sim] p99 {un['p99_us'] / he['p99_us']:.1f}x better; hedges: "
      f"{c.get('hedges_fired', 0)} fired = {c.get('hedges_won', 0)} won + "
      f"{c.get('hedges_cancelled', 0)} cancelled")

# -- 2. threaded: escape a stalled shard through the replica leg -------------
vol = make_volume("btt", n_lbas=256, n_shards=2, replicas=2,
                  stripe_blocks=1, aio_workers=2)
for i in range(16):
    vol.write(i, blk(i))

shard0 = vol.shards[0].impl
_attr = "read_ex" if hasattr(shard0, "read_ex") else "read"
orig_read = getattr(shard0, _attr)


def limping_read(local, out=None, **kwargs):
    time.sleep(0.02)                       # 20 ms stall, no error
    return orig_read(local, out=out, **kwargs)


setattr(shard0, _attr, limping_read)
lba = next(i for i in range(16) if vol._map(i, 0)[0] == 0)
t0 = time.perf_counter()
data = vol.hedged_read(lba, delay_s=0.002)
dt = (time.perf_counter() - t0) * 1e3
assert bytes(data) == blk(lba)
print(f"[hedge] read of lba {lba} (primary on the stalled shard) served "
      f"in {dt:.1f}ms vs the 20ms stall")

# warm the digests while the shard limps so the scorer can classify
# (min_samples per member); shard 0's p50/p99 sit at the stall, shard
# 1's at healthy service time
for i in range(16):
    vol.read(i)
setattr(shard0, _attr, orig_read)

# -- 3. scoring + steering ---------------------------------------------------
tail = vol.scrub()["tail"]
print(f"[score] verdicts: {tail['states']}  "
      f"(auto hedge delay {tail['hedge_delay_us']:.0f}us)")
assert tail["states"]["shard0"] in ("limping", "dead")
# (on a noisy box the HEALTHY shard can also read "limping" — wall-time
# p99 vs peer-median p50 is jitter-sensitive at microsecond scale; the
# virtual-time sim above is the deterministic contrast)
for name, row in sorted(tail["shards"].items()):
    print(f"[score]   {name}: n={row['n']}  p50 {row['p50_us']:9.1f}us  "
          f"p99 {row['p99_us']:9.1f}us")
assert tail["hedges_fired"] == tail["hedges_won"] + tail["hedges_cancelled"]
print(f"[score] hedge balance holds: {tail['hedges_fired']} fired = "
      f"{tail['hedges_won']} won + {tail['hedges_cancelled']} cancelled "
      f"({tail['primaries_cancelled']} primaries recalled)")
vol.close()
