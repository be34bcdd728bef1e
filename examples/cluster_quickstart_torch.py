"""Distributed cluster volume quickstart: 3 nodes, K=2 chain replication.

    PYTHONPATH=src python examples/cluster_quickstart.py

1. put — chain-replicated writes over virtual-time NetLinks: every chunk
   of the cluster LBA space maps to an ordered chain of K nodes
   (rack-aware spread placement); a write is acknowledged only once ALL
   K members hold it durably, whole-object-atomic end to end via each
   node's chained-tx journal.
2. kill — fail-stop one member mid-cluster.  Reads walk the chain past
   the dead member and keep serving crc-verified data (degraded reads);
   writes whose chains include the corpse fail THEIR op only.
3. restore — the heartbeat monitor declares the silent node dead after
   the timeout and the ReReplicator regenerates every lost block onto a
   survivor, restoring K live copies (scrub shows nothing
   under-replicated).
"""
from repro_torch.cluster import NodeDownError, make_cluster


def blk(x):
    return bytes([x % 256]) * 4096


class Clock:
    """Manual clock so heartbeat timeouts are deterministic here."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


clock = Clock()
cl = make_cluster("caiti", n_lbas=4096, n_nodes=3, replication_k=2,
                  chunk_blocks=64, racks=2, placement="spread",
                  heartbeat_timeout=5.0, now_fn=clock)

# -- 1. put ------------------------------------------------------------------
for obj in range(8):
    cl.write_multi(obj * 64, [blk(obj * 16 + i) for i in range(16)])
cl.fsync()
snap = cl.metrics_snapshot()
print(f"[put] {snap['acked_blocks']} blocks acked on "
      f"{snap['chunks_mapped']} chunks; chains:")
for chunk in sorted(cl._chains):
    names = [cl.nodes[ni].name for ni in cl._chains[chunk]]
    print(f"      chunk {chunk}: {' -> '.join(names)}")

# -- 2. kill -----------------------------------------------------------------
victim = cl._chains[0][0]                     # chunk 0's chain primary
cl.kill_node(victim)
print(f"[kill] {cl.nodes[victim].name} is gone")
ok = sum(1 for obj in range(8) for i in range(16)
         if bytes(cl.read(obj * 64 + i)) == blk(obj * 16 + i))
snap = cl.metrics_snapshot()
print(f"[kill] all {ok}/128 blocks still readable "
      f"({snap.get('read_failovers', 0)} chain failovers, "
      f"{snap.get('degraded_reads', 0)} degraded reads)")
try:
    cl.write(0, blk(99))
except NodeDownError as e:
    print(f"[kill] write through the dead primary fails its op only: {e}")
scrub = cl.scrub()
print(f"[kill] scrub: {len(scrub['under_replicated'])} chunks "
      f"under-replicated")

# -- 3. restore --------------------------------------------------------------
clock.t = 10.0                                # sail past the 5s timeout
st = cl.rereplicator.run_once()
print(f"[restore] heartbeat declared dead: "
      f"{[cl.nodes[ni].name for ni in st['declared_dead']]}; "
      f"re-replicated {st['chunks_repaired']} chunks "
      f"({st['blocks_copied']} blocks) onto survivors")
scrub = cl.scrub()
assert scrub["under_replicated"] == []
print(f"[restore] scrub: 0 under-replicated, "
      f"{scrub['divergent_blocks']} divergent")
cl.write(0, blk(99))                          # repaired chain takes writes
assert bytes(cl.read(0)) == blk(99)
ok = sum(1 for obj in range(1, 8) for i in range(16)
         if bytes(cl.read(obj * 64 + i)) == blk(obj * 16 + i))
print(f"[restore] repaired chain serving writes again; "
      f"{ok}/112 untouched blocks intact")
cl.close()
