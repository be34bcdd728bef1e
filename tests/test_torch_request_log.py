"""The port's durable request log (``AsyncRequestLog``) and the engine's
``request_log=`` and ``autotune_every=`` on the CPU.

The request-log tests of ``tests/test_aio.py`` and ``tests/test_zerocopy.py``
on the port's own volume; then a SMOKE engine run whose log, read back
record for record, and tokens equal the reference engine's on the same
traffic (its Pallas codec replaced by the eager oracles, which it equals
bit for bit); then the control ticks of ``autotune_every``, counted on one
stub volume by both engines.  Every volume is closed by a fixture."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.models import build_model
from repro.serve import kvcache as jkv
from repro.serve.engine import AsyncRequestLog as JaxRequestLog
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kvcache import PagedCacheConfig as JaxCacheConfig
from repro.volume.volume import make_volume as jax_make_volume
from repro_torch.configs import get_config
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import (AsyncRequestLog, PagedCacheConfig, Request,
                               ServeEngine)
from repro_torch.volume.volume import make_volume


@pytest.fixture
def volumes():
    """A factory of caiti volumes (the port's by default), all closed."""
    made = []

    def make(n_lbas=2048, factory=make_volume):
        vol = factory("caiti", n_lbas=n_lbas, n_shards=2,
                      cache_bytes=64 * 4096)
        made.append(vol)
        return vol
    yield make
    for vol in made:
        vol.close()


def read_log(vol, n_records: int) -> list:
    """The first ``n_records`` records of a log at lba 0, read back."""
    out, lba = [], 0
    for _ in range(n_records):
        raw = bytes(vol.read(lba))
        n = int.from_bytes(raw[:4], "little")
        buf, blocks = raw[4:], 1
        while len(buf) < n:
            buf += bytes(vol.read(lba + blocks))
            blocks += 1
        out.append(json.loads(buf[:n].decode()))
        lba += blocks
    return out


def test_serve_async_request_log_roundtrip(volumes):
    """Records ride the async frontend, drain() settles and fsyncs, and
    the log reads back record for record."""
    vol = volumes()
    log = AsyncRequestLog(vol)
    recs = [{"req_id": i, "prompt": [1, 2, i], "tokens": [4] * (i + 1)}
            for i in range(8)]
    for r in recs:
        log.append(r)
    assert log.drain() == 0
    assert read_log(vol, 8) == recs


def test_request_log_backpressure_never_drops_records(volumes):
    """A burst deeper than the engine's in-flight window settles
    oldest-first and waits its turn: no record is dropped, and the
    completions that wait() consumed leave the ring empty."""
    vol = volumes()
    vol.aio_engine(n_workers=2, max_inflight_per_tenant=4)
    log = AsyncRequestLog(vol)
    recs = [{"req_id": i, "tokens": [i] * 8} for i in range(32)]
    for r in recs:                                 # 32 >> window of 4
        log.append(r)
    assert log.logged == 32
    assert log.drain() == 0 and not log.errors
    assert vol.poll() == []
    assert read_log(vol, 32) == recs


def test_request_log_is_a_ring_and_never_overruns_the_volume(volumes):
    vol = volumes(n_lbas=256)
    log = AsyncRequestLog(vol, capacity_blocks=8)
    recs = [{"req_id": i} for i in range(30)]
    for r in recs:
        log.append(r)
    assert log.drain() == 0 and not log.errors
    assert log.wraps >= 3
    raw = bytes(vol.read((30 - 1) % 8))            # 1 block a record
    n = int.from_bytes(raw[:4], "little")
    assert json.loads(raw[4:4 + n].decode()) == recs[-1]


def test_request_log_refuses_a_record_past_its_bounds(volumes):
    vol = volumes()
    with pytest.raises(ValueError, match="larger than the log ring"):
        AsyncRequestLog(vol, capacity_blocks=1).append(
            {"tokens": [0] * 2000})
    with pytest.raises(ValueError, match="whole-object-atomic"):
        AsyncRequestLog(vol).append(
            {"tokens": [0] * (vol.max_atomic_write_blocks() * 1400)})


def test_serve_engine_wires_request_log(volumes):
    """ServeEngine._retire appends after release, and the log drains."""
    log = AsyncRequestLog(volumes(n_lbas=1024))
    eng = ServeEngine.__new__(ServeEngine)         # no model needed here
    eng.request_log = log
    eng.finished = []
    calls = []

    class _Cache:
        def deactivate(self, sid):
            calls.append(("deactivate", sid))

        def release(self, sid):
            calls.append(("release", sid, log.logged))

    eng.cache = _Cache()
    req = Request(0, [1, 2, 3], seq_id=5)
    req.out_tokens = [7, 8]
    eng._retire(req)
    assert calls == [("deactivate", 5), ("release", 5, 0)]
    assert log.logged == 1 and eng.finished == [req]
    assert log.drain() == 0


def test_request_log_registered_pool_pins_block_lists(volumes):
    """Appends through a registered buffer pool: the engine avoids the
    staging copies, every buffer returns to the pool once the tickets
    settle, and the records read back intact."""
    vol = volumes()
    log = AsyncRequestLog(vol, registered_buffers=4)
    recs = [{"req_id": i, "tokens": [i] * 3000} for i in range(6)]
    for r in recs:
        log.append(r)
    assert log.drain() == 0 and not log.errors
    assert vol.aio_engine().stats()["copies_avoided"] >= len(recs)
    assert log._reg.free_count() == len(log._reg)
    assert read_log(vol, 6) == recs


# ------------------------------------------------- engine against reference
def _smoke(arch: str):
    """The JAX SMOKE init in f32 and the port's parameters from it."""
    cj = jax_config(arch, smoke=True).with_(dtype=jnp.float32)
    params = build_model(cj).init(jax.random.PRNGKey(0))
    ct = get_config(arch, smoke=True, dtype=torch.float32)
    return cj, params, ct, params_from_jax(jax.tree.map(np.asarray, params),
                                           ct, "cpu")


def _oracle_codec(monkeypatch):
    monkeypatch.setattr(jkv, "gather_quantize_crc", lambda pool, ids: (
        *jref.gather_quantize_ref(pool, ids),
        jref.transit_crc_ref(jref.gather_quantize_ref(pool, ids)[0])))
    monkeypatch.setattr(jkv, "scatter_dequantize_crc", lambda pool, ids, q, s: (
        jref.scatter_dequantize_ref(pool, ids, q, s),
        jref.transit_crc_ref(q)))


def _submit(eng, vocab):
    rng = np.random.default_rng(6)
    return [eng.submit(rng.integers(2, vocab, size=n).tolist(),
                       max_new_tokens=m) for n, m in ((9, 4), (6, 2),
                                                      (11, 3))]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-coder-33b"])
def test_engine_log_and_tokens_equal_the_reference_engine(monkeypatch,
                                                          volumes, arch):
    _oracle_codec(monkeypatch)
    cj, params, ct, tp = _smoke(arch)
    shape = dict(n_layers=ct.n_layers, n_kv_heads=ct.n_kv_heads,
                 head_dim=ct.hd, page_size=4, n_pages=64,
                 max_pages_per_seq=16)
    runs = {}
    for name in ("port", "reference"):
        vol = volumes(factory=make_volume if name == "port"
                      else jax_make_volume)
        if name == "port":
            log = AsyncRequestLog(vol)
            eng = ServeEngine(ct, tp, max_batch=2, request_log=log,
                              device="cpu", cache_cfg=PagedCacheConfig(
                                  **shape, dtype=torch.float32))
        else:
            log = JaxRequestLog(vol)
            eng = JaxServeEngine(cj, params, max_batch=2, request_log=log,
                                 cache_cfg=JaxCacheConfig(
                                     **shape, dtype=jnp.float32))
        reqs = _submit(eng, cj.vocab)
        eng.run()
        assert log.logged == 3 and not log.errors
        assert eng.metrics.count.get("request_log_failures", 0) == 0
        runs[name] = ([r.out_tokens for r in reqs], read_log(vol, 3))
    assert runs["port"] == runs["reference"]
    tokens, records = runs["port"]
    assert sorted(r["req_id"] for r in records) == [0, 1, 2]
    assert all(r["tokens"] == tokens[r["req_id"]] for r in records)


class _TunedVolume:
    """A stand-in for the log's volume: its control step records the tick
    it ran at and moves one knob."""

    def __init__(self, ticks) -> None:
        self.ticks = ticks
        self.at = []

    def autotune_step(self) -> dict:
        self.at.append(self.ticks[0])
        return {"commit_window_us": 1.0}


class _StubLog:
    def __init__(self, ticks) -> None:
        self.vol = _TunedVolume(ticks)
        self.records = []

    def append(self, record) -> None:
        self.records.append(record)

    def drain(self) -> int:
        return 0


def test_autotune_every_ticks_like_the_reference(monkeypatch):
    """``autotune_every=2``: both engines run the log volume's control
    step after ticks 2, 4, 6, ... of ``run()`` and count its moves."""
    _oracle_codec(monkeypatch)
    cj, params, ct, tp = _smoke("internlm2-1.8b")
    got = {}
    for name in ("port", "reference"):
        ticks = [0]
        log = _StubLog(ticks)
        eng = (ServeEngine(ct, tp, max_batch=2, request_log=log,
                           autotune_every=2, device="cpu")
               if name == "port" else
               JaxServeEngine(cj, params, max_batch=2, request_log=log,
                              autotune_every=2))
        step = eng.step

        def counted(_step=step, _ticks=ticks):
            _ticks[0] += 1
            return _step()
        eng.step = counted
        _submit(eng, cj.vocab)
        eng.run()
        got[name] = (log.vol.at, ticks[0],
                     eng.metrics.count.get("autotune_moves", 0),
                     [r["tokens"] for r in log.records])
    at, n_ticks, moves, _ = got["port"]
    assert got["port"] == got["reference"]
    assert at == list(range(2, n_ticks + 1, 2)) and moves == len(at) > 0


def test_autotune_step_of_a_real_volume_runs_every_n_ticks(volumes):
    """On the port's own volume with a controller attached, the engine's
    cadence is the volume's count of control ticks."""
    _, _, ct, tp = _smoke("internlm2-1.8b")
    vol = volumes()
    vol.attach_autotuner()
    eng = ServeEngine(ct, tp, max_batch=2, request_log=AsyncRequestLog(vol),
                      autotune_every=3, device="cpu")
    _submit(eng, ct.vocab)
    ticks = 0
    step = eng.step

    def counted():
        nonlocal ticks
        ticks += 1
        return step()
    eng.step = counted
    eng.run()
    assert vol.metrics.count["autotune_ticks"] == ticks // 3 > 0
    assert eng.metrics.count.get("autotune_moves", 0) == \
        vol.metrics.count.get("autotune_moves", 0)


def test_async_request_log_over_cluster():
    """``tests/test_cluster.py``'s case on the port's cluster: six records
    appended and drained with no failure, both members of the first
    record's chain holding the same bytes, and a record past the
    cluster's chunk-bounded atomic write refused whole.  The port raises ``ValueError`` there, where the
    reference's ``assert`` would vanish under ``python -O``."""
    from repro_torch.cluster import make_cluster
    cl = make_cluster(policy="caiti", n_lbas=256, aio_workers=2, n_nodes=4,
                      replication_k=2, chunk_blocks=16, node_shards=2,
                      stripe_blocks=4, journal_slots=8, journal_span=4)
    try:
        log = AsyncRequestLog(cl, base_lba=128, capacity_blocks=64)
        for i in range(6):
            log.append({"rid": i, "tokens": list(range(i))})
        assert log.drain() == 0 and log.logged == 6
        # records are chain-replicated: both members hold the first one
        chain = cl._chain_for(128 // cl.cfg.chunk_blocks)
        raws = [bytes(cl.nodes[ni].volume.read(128)) for ni in chain]
        assert len(raws) == 2 and raws[0] == raws[1]
        rec = json.loads(raws[0][4:4 + int.from_bytes(raws[0][:4],
                                                       "little")])
        assert rec == {"rid": 0, "tokens": []}
        big = {"rid": 99, "pad": "x" * (cl.max_atomic_write_blocks()
                                        * cl.block_size)}
        with pytest.raises(ValueError, match="whole-object-atomic"):
            log.append(big)
    finally:
        cl.close()
