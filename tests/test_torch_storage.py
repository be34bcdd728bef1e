"""The port's copies of the storage stack against the reference.

The port may not import ``repro``, so it carries whole copies of the
jax-free storage modules its spill tier needs (``core/``, ``volume/``), of
``serve/kvpager.py``, of the training data pipeline (``data/``), of the
checkpoints' block store (``ckpt/blockstore.py``) and of the cluster
volume under it (``cluster/``).  A copy is the reference's text with the
package name changed and nothing else; one seeded workload through the
reference's ``make_volume`` and through the copy's reads back the same
bytes and moves the same counters; and the block store over the copy's
cluster survives a node's loss."""
from pathlib import Path

import numpy as np
import pytest

import repro.volume.volume as ref_volume
import repro_torch.volume.volume as port_volume

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = ([f"core/{m}.py" for m in ("__init__", "bio", "btt", "cache",
                                     "device", "metrics", "pmem",
                                     "policies", "transit")]
          + [f"volume/{m}.py" for m in ("__init__", "admission", "aio",
                                         "autotune", "evict_pool", "journal",
                                         "qos", "read_tier", "volume")]
          + ["serve/kvpager.py", "data/__init__.py", "data/pipeline.py",
             "ckpt/blockstore.py"]
          + [f"cluster/{m}.py" for m in ("__init__", "cluster", "node",
                                          "placement")])

# counters of the workload below that do not depend on thread timing: the
# journal's transactions and commit batches, the async frontend's tickets,
# the reads served (hits + misses; the split between them depends on when
# the eviction workers ran), and the read path's failures
COUNTERS = ("applied_txid", "journal_txs", "chain_txs", "chains_logged",
            "group_commits", "log_batches", "log_batch_links",
            "bypass_writes", "degraded_reads", "verify_failures",
            "unrecoverable_reads", "aio.submitted", "aio.completed",
            "aio.failed", "reads")


@pytest.mark.parametrize("rel", COPIES)
def test_storage_copy_is_the_reference_text(rel):
    port_text = (SRC / "repro_torch" / rel).read_text()
    ref_text = (SRC / "repro" / rel).read_text()
    assert port_text.replace("repro_torch", "repro") == ref_text


def _workload(make_volume, seed: int = 0):
    """Single writes, chained ``write_multi`` records and fsyncs at random
    addresses, then every written block read back, one async read and a
    last fsync; returns the bytes read, the blocks written and the
    timing-independent counters."""
    rng = np.random.default_rng(seed)
    n_lbas = 1 << 12
    vol = make_volume(n_lbas=n_lbas, n_shards=2, aio_workers=2,
                      cache_bytes=1 << 20, shared_workers=2)
    try:
        bs = vol.block_size
        written = {}
        for i in range(200):
            lba = int(rng.integers(0, n_lbas))
            written[lba] = rng.integers(0, 256, bs, dtype=np.uint8)
            vol.write(lba, written[lba])
            if i % 20 == 0:
                n = int(rng.integers(2, 12))
                lba0 = int(rng.integers(0, n_lbas - n))
                blocks = [rng.integers(0, 256, bs, dtype=np.uint8)
                          for _ in range(n)]
                vol.write_multi(lba0, blocks)
                written.update({lba0 + k: b for k, b in enumerate(blocks)})
            if i % 50 == 0:
                vol.fsync()
        got = {lba: vol.read(lba).copy() for lba in sorted(written)}
        t = vol.submit("read", min(written), block=True)
        vol.wait(t)
        assert t.error is None
        got["async"] = np.asarray(t.value).view(np.uint8).copy()
        vol.fsync()
        snap = vol.metrics_snapshot()
    finally:
        vol.close()
    counters = {k: snap[k] for k in COUNTERS[:-4]}
    counters.update({f"aio.{k}": snap["aio"][k]
                     for k in ("submitted", "completed", "failed")})
    counters["reads"] = snap["read_hits"] + snap["read_misses"]
    return got, written, counters


def test_volume_copy_matches_the_reference_on_a_seeded_workload():
    got_ref, written, ref_counts = _workload(ref_volume.make_volume)
    got_port, written_port, port_counts = _workload(port_volume.make_volume)
    assert written.keys() == written_port.keys()
    for lba, block in written.items():
        assert np.array_equal(got_ref[lba], block)
        assert np.array_equal(got_port[lba], block)
    assert np.array_equal(got_port["async"], written[min(written)])
    assert port_counts == ref_counts
    assert ref_counts["reads"] == len(written) + 1      # and the async one
    assert ref_counts["chain_txs"] > 0 and ref_counts["group_commits"] > 0


def test_blockstore_over_cluster_survives_node_loss():
    """``tests/test_cluster.py``'s case on the copies."""
    from repro_torch.ckpt.blockstore import make_blockstore

    bs = make_blockstore(capacity_bytes=4 << 20, cache_bytes=1 << 20,
                         cluster=3, replication_k=2)
    try:
        payload = np.arange(50_000, dtype=np.float32).tobytes()
        bs.put("step1", payload)
        data_lba = bs.directory["step1"][0]
        primary = bs.dev._chain_for(data_lba // bs.dev.cfg.chunk_blocks)[0]
        bs.dev.kill_node(primary)        # lose the data chunk's primary
        assert bs.get("step1") == payload
        assert bs.dev.metrics_snapshot()["read_failovers"] > 0
    finally:
        bs.close()
