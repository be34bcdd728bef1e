"""Per-device cost of one step, counted op by op as it is dispatched: the
counterpart of ``repro.launch.hlo_cost``.

The reference reads a step's roofline inputs from the text of its
compiled, SPMD-partitioned HLO module, multiplying each while-loop body
by its trip count.  The port runs eagerly: nothing is compiled, so there
is no HLO to parse, and a Python loop runs its body once a trip by
itself.  ``OpCost`` is a ``TorchDispatchMode`` instead: it sees every
aten op of the step it wraps (in the dry run under ``FakeTensorMode``,
so nothing is computed or allocated), and ``totals()`` returns
``HloCost.totals()``'s keys:

  * flops           — products only, as ``HloCost`` counts dots and
                      convolutions: 2 x the output's elements x the
                      contracted length of each ``mm``, ``addmm``,
                      ``bmm``, ``baddbmm`` (and ``mv``, ``dot``,
                      ``convolution``), and each ``repro_torch`` op by its
                      own formula (``OP_WORK``): the two attention
                      kernels 4 hd a (query head, key) pair the mask
                      keeps (``attention_work``), the sLSTM's recurrence
                      and its backward what their plain loops count
                      eagerly (``models/slstm_op.py``)
  * bytes           — each op's operand plus result bytes: eager's device
                      memory traffic with nothing fused.  Views, metadata
                      and allocations that write nothing move none
  * transcendentals — the elements of each exp, log, tanh, sigmoid, sqrt,
                      rsqrt, pow, sin, cos, expm1 and erf, the inputs of
                      each softmax and logsumexp, one exp a pair in the
                      attention kernels, the sLSTM and mLSTM ops' by
                      their formulas
  * collectives     — per kind, under the reference's HLO names: the
                      count, the payload bytes and the largest group
  * collective_bytes, wire_bytes — the payloads summed, and the bytes a
                      device puts on its links by ``hlo_cost.py``'s ring
                      formulas

and ``ops``, the count of ops that move bytes (the kernels an eager step
launches, before any fusion).

**Every number is per device**: what rank 0 runs.  A dispatch mode sees
an op before any tensor subclass does, so on a mesh it would see a
DTensor op at its global shapes (a product sharded 16 ways counted
whole).  This one steps aside for every op on DTensors (it returns
``NotImplemented``): DTensor desugars the op into the local op on the
rank's shards and the collectives of its redistributions, and those
come back through the mode, which counts them.  DTensor's sharding
propagation also runs each new op once at the global shapes, on fake
tensors, to learn its output's shape: those calls are no rank's work and
are neither counted nor followed (``_skip_propagation``).  Collectives
are counted from both of their sources: the functional collectives of
DTensor's redistributions and of ``local_map`` regions, and the ``c10d``
calls the port makes itself (``parallel/collectives.py``'s int8 ring,
whose ``batch_isend_irecv`` hops count as collective-permutes, and the
all-reduces of the mesh decode's merge and the MoE's sum).

It also follows the memory.  ``hold`` names the step's arguments; every
other storage an op creates is live until it is freed, and ``memory()``
gives the argument bytes, the outputs' bytes, the bytes of outputs that
are arguments updated in place (the reference's donated aliases) and the
peak of live storage above the arguments.
"""
from __future__ import annotations

import contextlib
import functools
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models.mlstm_op import (mlstm_hidden_backward_work,
                                         mlstm_hidden_work,
                                         mlstm_scores_backward_work,
                                         mlstm_scores_work)
from repro_torch.models.slstm_op import (slstm_scan_backward_work,
                                         slstm_scan_work)

aten = torch.ops.aten

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the products: op -> index of the left operand (its last dim contracts)
_PRODUCTS = {aten.mm: 0, aten.addmm: 1, aten.bmm: 0, aten.baddbmm: 1,
             aten.mv: 0, aten.addmv: 1}
_TRANSCENDENTAL = {"exp", "exp2", "log", "log1p", "log2", "log10", "tanh",
                   "sigmoid", "sqrt", "rsqrt", "pow", "sin", "cos", "expm1",
                   "erf", "gelu", "silu"}
_SOFTMAX = {"_softmax", "_log_softmax", "logsumexp"}
# allocations that write nothing
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}
# collective ops by name -> HLO kind; recv_ is the other end of a send
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_reduce_coalesced_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_out": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "broadcast", "broadcast_": "broadcast"}
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "broadcast_": "broadcast", "send": "collective-permute"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def pairs(T: int, S: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """The (query, key) pairs a flash call's mask keeps: query row t at
    position q_offset + t, key s at s (``chip_smoke.py``'s
    ``flash_pairs`` with the offset)."""
    qp = q_offset + np.arange(T)
    hi = np.minimum(qp + 1, S) if causal else np.full(T, S)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(T, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_work(name: str, args) -> tuple[float, float, float]:
    """(flops, bytes, exps) of one attention kernel call, by the formulas
    of its bound: 4 hd flops and one exp a (query head, key) pair it
    attends; bytes q, k, v and the output once (flash), or q, the output
    and the K and V pages its block table names (paged; a row split
    into several reads its pages once each)."""
    q = args[0]
    if name == "flash_attention":
        k, causal, window, q_offset = args[1], args[3], args[4], args[5]
        B, T, H, hd = q.shape
        n = H * B * pairs(T, k.shape[1], causal, window, q_offset)
        by = 2 * _nbytes(q) + _nbytes(k) + _nbytes(args[2])
        return 4.0 * hd * n, float(by), float(n)
    k_pool, table = args[1], args[3]
    R, H, hd = q.shape
    slots = table.shape[1] * k_pool.shape[1]
    n = R * H * slots
    kv = 2 * R * slots * k_pool.shape[2] * hd * k_pool.element_size()
    out = 2 * _nbytes(q) + (4 * R * H if name == "paged_attention_lse"
                            else 0)
    return 4.0 * hd * n, float(kv + out + _nbytes(table)
                               + _nbytes(args[4])), float(n)


# each ``repro_torch`` op -> (flops, bytes, transcendentals) of a call
# from its arguments; a call counts as one op
OP_WORK = {"flash_attention": functools.partial(attention_work,
                                                "flash_attention"),
           "paged_attention": functools.partial(attention_work,
                                                "paged_attention"),
           "paged_attention_lse": functools.partial(attention_work,
                                                    "paged_attention_lse"),
           "slstm_scan": slstm_scan_work,
           "slstm_scan_backward": slstm_scan_backward_work,
           "mlstm_scores": mlstm_scores_work,
           "mlstm_scores_backward": mlstm_scores_backward_work,
           "mlstm_hidden": mlstm_hidden_work,
           "mlstm_hidden_backward": mlstm_hidden_backward_work}


def _group_size(func_name: str, args) -> int:
    """The group of a collective op: a ``c10d`` op's ProcessGroup
    argument, a functional one's group size or group name."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue                  # the ReduceOp, not the group
    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    if "gather" in func_name or "scatter" in func_name:
        if ints:
            return ints[0]
    names = [a for a in args if isinstance(a, str)]
    if names:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(names[-1]).size()
    return 0


def _collective(func, args, out) -> tuple[str, int, int] | None:
    """(kind, payload bytes, group size) of a collective op, else None."""
    ns, name = func.namespace, func.overloadpacket.__name__
    if ns in ("_c10d_functional", "_c10d_functional_autograd"):
        kind = _FUNCTIONAL.get(name)
        if kind is None:
            return None
        return kind, sum(_nbytes(t) for t in tree_leaves(out)), \
            _group_size(name, args)
    if ns == "c10d" and name in _C10D:
        # the first argument: the tensors reduced or sent, or the output
        # (gathered, scattered) where the op takes one
        payload = args[0]
        return _C10D[name], sum(_nbytes(t) for t in tree_leaves(payload)), \
            _group_size(name, args)
    return None


def _is_view(func) -> bool:
    """Every result of ``func`` aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


@contextlib.contextmanager
def _skip_propagation(flag: list):
    """While DTensor's sharding propagation runs an op at the global
    shapes, ``flag[0]`` is above 0."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    def wrapped(*a, **kw):
        flag[0] += 1
        try:
            return orig(*a, **kw)
        finally:
            flag[0] -= 1
    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class OpCost(TorchDispatchMode):
    """Counts one step's per-device work and follows its memory; enter it
    around the step (``with OpCost() as c: step(...)``), then read
    ``totals()`` and ``memory()``."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.transcendentals = 0.0
        self.ops = 0
        self.colls: dict[str, dict] = {}
        self._prop = [0]
        self._stack = contextlib.ExitStack()
        self._args: set[int] = set()
        self._arg_bytes = 0
        self.held: list[int] = []          # the bytes of each ``hold``
        self._live: dict[int, int] = {}
        self.live = self.peak = 0

    # --------------------------------------------------------------- memory
    @staticmethod
    def _storages(tree):
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                yield t.untyped_storage()

    def hold(self, tree) -> None:
        """The step's arguments (tensors or DTensors, whose local shards
        count): their storages are not temporaries."""
        n = 0
        for st in self._storages(tree):
            if st._cdata not in self._args:
                self._args.add(st._cdata)
                n += st.nbytes()
        self._arg_bytes += n
        self.held.append(n)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for st in self._storages(out):
            key = st._cdata
            if key in self._args or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def memory(self, outputs) -> dict:
        """Per-device bytes in the keys of the reference's
        ``memory_analysis``: the arguments, the outputs, the outputs that
        are arguments (updated in place), and the peak of live storage
        above the arguments while the step ran."""
        seen, out_bytes, alias = set(), 0, 0
        for st in self._storages(outputs):
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            out_bytes += st.nbytes()
            if st._cdata in self._args:
                alias += st.nbytes()
        return {"argument_size_in_bytes": self._arg_bytes,
                "output_size_in_bytes": out_bytes,
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": self.peak}

    # ------------------------------------------------------------- dispatch
    def __enter__(self):
        self._stack.enter_context(_skip_propagation(self._prop))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._prop[0]:
            return func(*args, **kwargs)
        if func is torch.ops._c10d_functional.wait_tensor.default \
                and is_fake(args[0]):
            # the fake form returns a new tensor; eager waits in place
            return args[0]
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.namespace == "repro_torch":
            fl, by, tr = OP_WORK[name](args)
            self.flops += fl
            self.bytes += by
            self.transcendentals += tr
            self.ops += 1
            return
        coll = _collective(func, args, out)
        if coll is not None:
            kind, payload, group = coll
            ent = self.colls.setdefault(kind, {"count": 0, "bytes": 0.0,
                                               "group": group})
            ent["count"] += 1
            ent["bytes"] += payload
            ent["group"] = max(ent["group"], group)
        results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not results or _is_view(func) or name in _NO_WRITE:
            return
        operands = [t for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_nbytes, operands)) + sum(map(_nbytes, results))
        self.ops += 1
        if func.overloadpacket in _PRODUCTS:
            lhs = args[_PRODUCTS[func.overloadpacket]]
            self.flops += 2.0 * results[0].numel() * lhs.shape[-1]
        elif name in ("dot", "vdot"):
            self.flops += 2.0 * args[0].numel()
        elif name == "convolution":
            w = args[1]
            self.flops += 2.0 * results[0].numel() * (w.numel() // w.shape[0])
        base = name.rstrip("_")
        if base in _TRANSCENDENTAL:
            self.transcendentals += results[0].numel()
        elif name in _SOFTMAX:
            self.transcendentals += args[0].numel()

    # --------------------------------------------------------------- totals
    def totals(self) -> dict:
        wire = 0.0
        for k, v in self.colls.items():
            g = max(2, v.get("group", 2))
            frac = (g - 1) / g
            if k == "all-reduce":
                wire += 2 * frac * v["bytes"]
            elif k == "collective-permute":
                wire += v["bytes"]
            elif k == "reduce-scatter":
                wire += (g - 1) * v["bytes"]
            else:
                wire += frac * v["bytes"]
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "collectives": {k: dict(v) for k, v in self.colls.items()},
                "collective_bytes": sum(v["bytes"]
                                        for v in self.colls.values()),
                "wire_bytes": wire, "ops": self.ops}
