"""Roofline inputs of one step, counted while it runs.

The counterpart of ``repro/launch/hlo_stats.py`` and ``repro/launch/hlo_cost.py``,
with their names and record fields: :class:`CollectiveStats`,
:func:`cost_summary` (``flops``, ``bytes_accessed``, ``transcendentals``),
:func:`memory_summary` (the five ``*_size_in_bytes`` fields and
``total_per_device``) and :class:`ExactCost` (``flops``, ``coll_bytes``,
``coll_total``, ``mem_bytes``). The reference reads them from XLA's
compiled artifact: ``cost_analysis()``, ``memory_analysis()`` and the
optimized HLO text. There is no HLO here to parse. The port's steps run
eagerly, so one counting context, :class:`StepCounter`, sits around a step
and sees every op this rank runs, forward and backward (on fake tensors in
the dry run, where nothing is allocated and no kernel launches).

What it counts, for this rank alone (rank 0 in the dry run):

* **FLOPs on the local shards**: ``torch.utils.flop_counter``'s formulas
  (mm, bmm, addmm, baddbmm, convolutions and their backward) and those the
  kernels register for their custom ops (``repro_torch::matmul``,
  ``::flash_attention``, ``::rmsnorm``, ``::ssd``), applied to ops on plain
  tensors. An op on DTensors counts nothing itself: the counter steps aside
  (``NotImplemented``), DTensor runs the op on each local shard, and that
  local op is counted. ``FlopCounterMode`` would count the DTensor op at its
  global shape. Dot and convolution FLOPs only, as ``exact_cost`` counts.
* **Collectives by kind**, in the reference's names: the functional
  collectives DTensor makes and the ``torch.distributed`` calls the port
  makes itself (expert parallelism's all-reduces), their bytes the size of
  the result (an all-gather's is the gathered size), as ``collective_stats``
  takes the result shape.
* **Bytes accessed** (``mem_bytes``): the input and output bytes of every op
  that materialises a tensor, views and allocations without a write left
  out. Eager PyTorch does not fuse, so this is what the step moves through
  memory; XLA counts it at fusion granularity, where a fused chain of
  elementwise ops reads and writes memory once.
* **Transcendentals**: the output elements of exp, log, tanh, sigmoid,
  rsqrt, erf, sin, cos and the ops built on them (softmax, softplus, ...).
* **Memory**: the arguments' local bytes, the outputs', the outputs that
  are arguments updated in place (AdamW's params and moments), and the peak
  of the storage the step allocates while it runs (fake storages have sizes
  too).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.tree import leaves

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# op name (after the namespace, overload dropped) -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "broadcast": "all-gather", "broadcast_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
    "reduce-scatter", "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COMM_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sigmoid",
                   "rsqrt", "sqrt", "erf", "erfc", "sin", "cos", "pow", "_softmax",
                   "_log_softmax", "logsumexp", "softplus", "log_sigmoid_forward", "gelu",
                   "silu", "_safe_softmax"}

# ops that write no tensor data (allocations, aliases, the wait on a collective)
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "alias", "lift_fresh", "wait_tensor"}


_SHADOW = threading.local()  # .depth > 0 while DTensor infers an op's global output shape

def _shadowed(fn):
    """``fn`` (DTensor's shape inference) with the counter told that the ops
    it runs are not the step's."""
    def inner(*args, **kwargs):
        _SHADOW.depth = getattr(_SHADOW, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _SHADOW.depth -= 1

    return inner


# DTensor infers an op's global output shape by running the op once on fake
# tensors of the global shapes, before it runs the op on the local shards:
# in ShardingPropagator._propagate_tensor_meta_non_cached (the cached form
# calls it) or, in older releases, _propagate_tensor_meta
_INFERENCE = tuple(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                   if hasattr(ShardingPropagator, n))


@contextlib.contextmanager
def _shadow_marked():
    """The counter lets DTensor's shape inference through uncounted."""
    if not _INFERENCE:
        raise RuntimeError("this torch's DTensor has none of the shape-inference methods the "
                           "counter knows; its global-shape ops would be counted")
    saved = {n: getattr(ShardingPropagator, n) for n in _INFERENCE}
    for n, fn in saved.items():
        setattr(ShardingPropagator, n, _shadowed(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _storage_bytes(tree) -> dict[int, int]:
    """{storage id: bytes} of the tensors of ``tree``, each rank's local
    shard of a DTensor, each storage once."""
    out = {}
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _flat_tensors(xs) -> list[torch.Tensor]:
    return [x for x in tree_flatten(xs)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclasses.dataclass
class ExactCost:
    flops: float
    coll_bytes: dict[str, float]
    mem_bytes: float = 0.0

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "coll_bytes": self.coll_bytes,
                "coll_total": self.coll_total, "mem_bytes": self.mem_bytes}


class StepCounter(TorchDispatchMode):
    """The counting context: ``c.run(step, *args)`` runs the step under it and
    records the arguments' and outputs' memory. (A ``TorchDispatchMode``
    sees each op before ``FakeTensorMode``, an infrastructure mode, does.)"""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.mem_bytes = 0
        self.transcendentals = 0
        self.coll_bytes = dict.fromkeys(_COLLECTIVES, 0)
        self.coll_count = dict.fromkeys(_COLLECTIVES, 0)
        # the kernels' ops by their inputs' shapes, keyed as the launchers see
        # them: matmul (a, b), rmsnorm ((rows, D),), flash (q, k), ssd (x, b)
        self.kernel_shapes: dict[str, dict] = {}
        self.argument_bytes = self.output_bytes = self.alias_bytes = 0
        self._args: set[int] = set()
        self._live: dict[int, int] = {}    # allocation -> bytes
        self._owner: dict[int, int] = {}   # storage key -> its allocation
        self._refs: dict[int, int] = {}    # allocation -> its live storages
        self._allocs = 0
        self.live_bytes = self.peak_bytes = 0
        self.run_s = 0.0

    # -- live storage -----------------------------------------------------
    # Each storage an op returns is an allocation, freed when its last tensor
    # goes, except a collective's wait: on a device it returns the
    # collective's result, under fake tensors a new storage, which counts
    # here as the result's. Allocations are numbered: a storage's address
    # (its key) is reused once it is freed, while its allocation may live on
    # in the wait's storage.
    def _freed(self, key: int, alloc: int) -> None:
        self._owner.pop(key, None)
        self._refs[alloc] -= 1
        if not self._refs[alloc]:
            del self._refs[alloc]
            self.live_bytes -= self._live.pop(alloc)

    def _track(self, out, alias_of: int | None = None) -> None:
        for t in _flat_tensors(out):
            if is_traceable_wrapper_subclass(t):  # a DTensor, a collective's wrapper: no storage
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._owner or key in self._args:
                continue
            alloc = self._owner.get(alias_of)
            if alloc is None:
                alloc = self._allocs = self._allocs + 1
                self._live[alloc] = st.nbytes()
                self.live_bytes += self._live[alloc]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._owner[key] = alloc
            self._refs[alloc] = self._refs.get(alloc, 0) + 1
            weakref.finalize(st, self._freed, key, alloc)

    # -- the dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, which are counted
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload) or getattr(_SHADOW, "depth", 0):
            return out
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        ins, outs = _flat_tensors((args, kwargs)), _flat_tensors(out)
        if ns in _COMM_NAMESPACES and name in _KINDS:
            kind = _KINDS[name]
            self.coll_count[kind] += 1
            # the result's bytes; a c10d call that returns only its work handle
            # wrote into its first tensor argument (the output, or the tensors sent)
            res = outs or ins[:1]
            self.coll_bytes[kind] += sum(_bytes(t) for t in res)
        if ns == "repro_torch":
            shapes = [tuple(t.shape) for t in ins]
            key = ((math.prod(shapes[0][:-1]), shapes[0][-1]),) if name == "rmsnorm" else \
                (shapes[0], shapes[3]) if name == "ssd" else tuple(shapes[:2])
            seen = self.kernel_shapes.setdefault(name, {})
            seen[key] = seen.get(key, 0) + 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view and name not in _NO_WRITE and outs:
            self.mem_bytes += sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
        self._track(out, ins[0].untyped_storage()._cdata if name == "wait_tensor" and ins
                    else None)
        return out

    # -- a whole step -------------------------------------------------------
    def run(self, fn, *args):
        """``fn(*args)`` counted, with the arguments' and outputs' local bytes
        recorded for :func:`memory_summary`; returns its outputs."""
        arg_storages = _storage_bytes(args)
        self._args = set(arg_storages)
        self.argument_bytes = sum(arg_storages.values())
        t0 = time.perf_counter()
        with _shadow_marked(), self:
            out = fn(*args)
        self.run_s = time.perf_counter() - t0
        out_storages = _storage_bytes(out)
        self.output_bytes = sum(out_storages.values())
        self.alias_bytes = sum(n for k, n in out_storages.items() if k in self._args)
        return out

    def collective_stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.coll_bytes), dict(self.coll_count))

    def exact(self) -> ExactCost:
        return ExactCost(self.flops, dict(self.coll_bytes), self.mem_bytes)


def kind_counts(comm_counts: dict) -> dict[str, int]:
    """``CommDebugMode.get_comm_counts()`` (op -> count) by the reference's
    kinds, as :class:`StepCounter` counts them."""
    out = dict.fromkeys(_COLLECTIVES, 0)
    for op, n in comm_counts.items():
        name = getattr(op, "__name__", str(op)).split(".")[-1]
        if name in _KINDS:
            out[_KINDS[name]] += n
    return out


def cost_summary(counter: StepCounter) -> dict:
    return {"flops": float(counter.flops), "bytes_accessed": float(counter.mem_bytes),
            "transcendentals": float(counter.transcendentals)}


def memory_summary(counter: StepCounter) -> dict:
    """The reference's five fields and ``total_per_device`` by its formula.
    ``temp_size_in_bytes`` is the peak of the storage the step allocated,
    less its outputs that are new (XLA counts outputs apart from temps), so
    that the total is the arguments plus that peak. Nothing is generated:
    ``generated_code_size_in_bytes`` is 0."""
    new_out = counter.output_bytes - counter.alias_bytes
    out = {"argument_size_in_bytes": counter.argument_bytes,
           "output_size_in_bytes": counter.output_bytes,
           "temp_size_in_bytes": max(counter.peak_bytes - new_out, 0),
           "generated_code_size_in_bytes": 0,
           "alias_size_in_bytes": counter.alias_bytes}
    out["total_per_device"] = (out["argument_size_in_bytes"] + out["output_size_in_bytes"]
                               + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out
