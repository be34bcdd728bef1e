"""Caiti-backed checkpoint engine, as ``repro.ckpt.engine`` over the port's
tensors.

The training loop calls ``save_async(step, state)``; the engine

  1. snapshots the state to the host (``models.transformer.params_to_jax``:
     a fresh host copy of every leaf, each list of layers stacked on the
     host into the reference's layout) — the only sync point,
  2. cuts every leaf into fixed-size chunks and *transits* them through a
     :class:`repro_torch.core.TransitBuffer` (eager eviction: background
     threads stream chunks into the block store while the next training
     step runs; conditional bypass: if staging RAM is exhausted, the chunk
     is written synchronously instead of stalling the whole save),
  3. commits the store generation (atomic root flip — the fsync analogue).

The wire format is the reference's, byte for byte, so a checkpoint that
either package writes restores in the other.  Leaf keys are the
``/``-joined paths that ``jax.tree_util.tree_flatten_with_path`` gives
the reference's tree: dict keys sorted at every level, a NamedTuple's
fields in field order behind a dot (``opt/.step``, ``opt/.m/embed``).
Each leaf is ``header json {dtype, shape} | raw little-endian bytes``,
chunked as ``step{step:010d}/<key>/<i>``; the step's ``MANIFEST`` records
each key's chunk count and codec.  The optional int8 codec (one scale a
leaf) applies to f32 and f16 leaves of more than 1024 elements.  bf16
travels as its 16-bit pattern under the header dtype ``"bfloat16"`` and
never needs ``ml_dtypes``: ``restore`` returns such a leaf as a host
``torch.bfloat16`` tensor over those bits.

``restore(like=...)`` takes a tree of the port's (its lists of layers
unstacked; meta tensors will do, ``Model.param_shape``) in place of the
reference's ``like``: the leaves come back in its structure and dtypes on
``device`` (the card unless the caller names another).

On a mesh (the elastic restore, the reference's ``shardings=``): the
state's DTensor leaves are gathered whole while the snapshot is taken,
every rank taking part (``join_save`` on the ranks that hold no engine),
and one rank writes the same bytes as from one device.  ``restore(like=,
placements=, mesh=)`` reads the checkpoint whole on the rank that holds
the engine (rank 0), the others call ``receive_restore``; each leaf is
broadcast and kept as the DTensor of its placements on ``mesh``, which
need not be the mesh that saved it.  The leaves are distributed one at a
time, so no rank's card holds more than its shards and one whole leaf.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import Metrics, TransitBuffer
from repro_torch.models.transformer import params_to_jax
from repro_torch.parallel.collectives import broadcast_object
from repro_torch.parallel.sharding import place
from .blockstore import BlockStore

_CHUNK = 4 << 20          # 4 MB chunks — large enough to amortize, small
                          # enough that bypass granularity stays fine
BF16 = "bfloat16"         # the header's dtype of a bf16 leaf, as numpy
                          # names it with ml_dtypes


def _leaf_paths(tree) -> list[tuple[str, object]]:
    """(key, leaf) of a tree of dicts and NamedTuples, in the order and
    with the keys of the reference's ``tree_flatten_with_path``."""
    def walk(x, parts):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from walk(x[k], parts + [str(k)])
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                yield from walk(getattr(x, f), parts + [f".{f}"])
        else:
            yield "/".join(parts), x
    return list(walk(tree, []))


def _snapshot(state) -> list[tuple[str, np.ndarray, str]]:
    """(key, host array, header dtype) of every leaf: a copy of ``state``
    taken now, which later in-place updates of ``state`` do not reach."""
    out = []
    for key, t in _leaf_paths(params_to_jax(state)):
        if t.dtype == torch.bfloat16:
            out.append((key, t.view(torch.int16).numpy(), BF16))
        else:
            arr = t.numpy()
            out.append((key, arr, str(arr.dtype)))
    return out


def _encode_header(arr: np.ndarray, dtype: str) -> bytes:
    h = json.dumps({"dtype": dtype, "shape": list(arr.shape)}).encode()
    return len(h).to_bytes(4, "little") + h


def _int8_encode(arr: np.ndarray) -> tuple[bytes, dict]:
    flat = arr.astype(np.float32).reshape(-1)
    amax = float(np.abs(flat).max()) if flat.size else 0.0
    scale = amax / 127.0 + 1e-12
    q = np.clip(np.round(flat / scale), -127, 127).astype(np.int8)
    return q.tobytes(), {"codec": "int8", "scale": scale}


def _unstack(like, arrays: dict | None, device, placements=None,
             mesh=None):
    """The leaves of ``arrays`` in the structure and dtypes of the port's
    tree ``like``: a list position is an index into the stacked leaf.
    ``arrays`` None: empty leaves of ``like``'s shapes.  With ``mesh``:
    each leaf, made whole and broadcast from rank 0 where the world has
    more than one rank, is kept as the DTensor of its placements
    (``placements`` a tree in ``like``'s structure, None for a leaf to
    keep whole) before the next is made, so that a rank holds its shards
    and one whole leaf at a time."""
    def build(x, parts, index, pl):
        if isinstance(x, dict):
            return {k: build(v, parts + [str(k)], index,
                             None if pl is None else pl[k])
                    for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(build(getattr(x, f), parts + [f".{f}"], index,
                                   None if pl is None else getattr(pl, f))
                             for f in x._fields))
        if isinstance(x, list):
            return [build(v, parts, index + (i,),
                          None if pl is None else pl[i])
                    for i, v in enumerate(x)]
        proto = torch.as_tensor(x)
        dev = proto.device if device is None else device
        if arrays is None:
            t = torch.empty(proto.shape, dtype=proto.dtype, device=dev)
        else:
            src = torch.as_tensor(arrays["/".join(parts)])[index]
            t = src.to(device=dev, dtype=proto.dtype, copy=True)
        if mesh is None:
            return t
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast(t, src=0)
        return t if pl is None else place(t, pl, mesh)
    return build(like, [], (), placements)


def join_save(state) -> None:
    """What a rank that holds no engine does while the writer (rank 0)
    saves a state of DTensors: it takes part in each leaf's gather, in
    the writer's order, and writes nothing."""
    _snapshot(state)


def receive_restore(like, placements, mesh, device="cuda"):
    """The counterpart, on a rank other than 0, of rank 0's
    ``CheckpointEngine.restore(like=, placements=, mesh=)``: -> (tree,
    step), the same leaves as DTensors of ``placements``."""
    step = broadcast_object(None)
    return _unstack(like, None, device, placements, mesh), step


class CheckpointEngine:
    def __init__(self, store: BlockStore, *, staging_bytes: int = 256 << 20,
                 n_workers: int = 4, keep: int = 3,
                 codec: str = "raw") -> None:
        self.store = store
        self.keep = keep
        self.codec = codec
        self.metrics = Metrics()
        self._store_lock = threading.Lock()   # store.put is not thread-safe
        self.transit = TransitBuffer(self._sink, capacity_bytes=staging_bytes,
                                     n_workers=n_workers,
                                     metrics=self.metrics)
        self._save_thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- internals
    def _sink(self, item) -> None:
        key, payload = item
        with self._store_lock:
            self.store.put(key, payload)

    def _write_state(self, step: int, snapshot) -> None:
        t0 = time.perf_counter()
        prefix = f"step{step:010d}"
        manifest: dict[str, dict] = {}
        for key, arr, dtype in snapshot:
            if self.codec == "int8" and arr.dtype in (np.float32, np.float16
                                                      ) and arr.size > 1024:
                body, meta = _int8_encode(arr)
            else:
                body, meta = arr.tobytes(), {"codec": "raw"}
            header = _encode_header(arr, dtype)
            blob = header + body
            n_chunks = max(1, (len(blob) + _CHUNK - 1) // _CHUNK)
            for i in range(n_chunks):
                self.transit.put(
                    (f"{prefix}/{key}/{i}", blob[i * _CHUNK:(i + 1) * _CHUNK]),
                    nbytes=min(_CHUNK, len(blob) - i * _CHUNK))
            manifest[key] = {"chunks": n_chunks, **meta}
        # wait for every staged chunk to land, then commit atomically
        self.transit.flush()
        with self._store_lock:
            self.store.put(f"{prefix}/MANIFEST",
                           json.dumps(manifest).encode())
            steps = self.list_steps()
            if step not in steps:
                steps.append(step)
            steps = sorted(steps)[-self.keep:]
            self._gc(steps)
            self.store.put("STEPS", json.dumps(steps).encode())
            self.store.commit()
        self.metrics.add_ns("ckpt_save",
                            int((time.perf_counter() - t0) * 1e9))

    def _gc(self, keep_steps: list[int]) -> None:
        prefixes = {f"step{s:010d}" for s in keep_steps}
        for key in self.store.keys():
            if key.startswith("step") and key.split("/")[0] not in prefixes:
                self.store.delete(key)

    # ------------------------------------------------------------ public API
    def save(self, step: int, state) -> None:
        """Synchronous save + commit."""
        self._write_state(step, _snapshot(state))

    def save_async(self, step: int, state) -> None:
        """Snapshot now, persist in the background (overlaps next steps)."""
        self.wait()                           # one in-flight save at a time
        host = _snapshot(state)

        def run():
            try:
                self._write_state(step, host)
            except BaseException as e:        # surfaced on wait()
                self._error = e

        self._save_thread = threading.Thread(target=run, daemon=True,
                                             name=f"ckpt-save-{step}")
        self._save_thread.start()

    def wait(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def list_steps(self) -> list[int]:
        if "STEPS" not in self.store.directory:
            return []
        return list(json.loads(self.store.get("STEPS").decode()))

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, like=None,
                device="cuda", placements=None, mesh=None):
        """Rebuild the tree of ``step`` (default latest) -> (tree, step).

        With no ``like``: the flat ``{key: numpy array}`` of the stacked
        layout (a bf16 leaf a host ``torch.bfloat16`` tensor).  ``like``:
        a tree of the port's giving the structure and dtypes; its leaves
        come back on ``device`` (None: each on its ``like`` leaf's
        device).  ``placements`` (a tree in ``like``'s structure of
        placement tuples, None for a leaf to keep whole) and ``mesh``:
        the leaves come back as DTensors of those placements, on rank 0
        while every other rank calls ``receive_restore``.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
        prefix = f"step{step:010d}"
        manifest = json.loads(self.store.get(f"{prefix}/MANIFEST").decode())

        arrays: dict[str, np.ndarray | torch.Tensor] = {}
        for key, meta in manifest.items():
            blob = b"".join(self.store.get(f"{prefix}/{key}/{i}")
                            for i in range(meta["chunks"]))
            hlen = int.from_bytes(blob[:4], "little")
            h = json.loads(blob[4:4 + hlen].decode())
            body = blob[4 + hlen:]
            if meta.get("codec") == "int8":
                q = np.frombuffer(body, dtype=np.int8).astype(np.float32)
                arr = (q * meta["scale"]).astype(h["dtype"]
                                                 ).reshape(h["shape"])
            elif h["dtype"] == BF16:
                arr = torch.from_numpy(np.frombuffer(body, dtype=np.int16)
                                       .reshape(h["shape"]).copy()
                                       ).view(torch.bfloat16)
            else:
                arr = np.frombuffer(body, dtype=np.dtype(h["dtype"])
                                    ).reshape(h["shape"]).copy()
            arrays[key] = arr

        if like is None:
            return arrays, step
        if placements is None:
            return _unstack(like, arrays, device), step
        # the step goes first, as ``receive_restore`` takes it
        step = broadcast_object(step)
        return _unstack(like, arrays, device, placements, mesh), step

    def close(self) -> None:
        self.wait()
        self.transit.close()
        self.store.close()
