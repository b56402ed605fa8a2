"""Roofline terms of a traced step, and the counters that trace it.

The port of ``repro.launch.roofline``.  Hardware model: one NVIDIA H100
SXM, figures from NVIDIA's data sheet (dense rates, no sparsity, at the
full 700 W power limit), not measured here:

    PEAK_FLOPS  989e12 FLOP/s bf16 and fp16 on the tensor cores; 67e12
                float32 and 34e12 float64 outside them (the f32 and f64
                cells: the window and direct-sum kernels issue plain FMAs)
    TENSOR_PEAK_FLOPS
                the dense tensor-core peaks by input dtype: 989e12 bf16
                and fp16, 495e12 float32 (run as TF32): the bound of a
                kernel on the tensor cores (flash attention); the float32
                flash kernel's own ceiling is TF32_SPLIT_PRODUCTS times
                its operations term (:func:`tf32_split_ceiling_ms`)
    HBM_BW      3.35e12 bytes/s
    LINK_BW     50e9 bytes/s, one 400 Gb/s NDR InfiniBand port a GPU: the
                link a 256-rank mesh's collectives cross, charged as the
                reference charges its one ICI link

The dry run (:mod:`repro_torch.launch.dryrun`) traces one rank's step on
the ``meta`` device, so its counts are per-rank quantities:

    compute_s    = flops / PEAK_FLOPS[dtype]
    memory_s     = hbm_bytes / HBM_BW
    collective_s = collective_bytes / LINK_BW

so a float32 step's compute term charges every FLOP at the 67e12 of the
FP32 cores, the float32 flash kernel's TF32 FLOPs too (the term is an
upper bound there); a kernel's own bound (:func:`bound_ms`) takes the
peak of the units it runs on.

Collective bytes follow the reference's two models (``repro.launch.
hlo_analysis``), derived from :class:`repro_torch.launch.mesh.Mesh`'s
record of each collective (kind, operand bytes, group size):

    kind            "moved" (ring wire)     "payload" (shard)
    all-gather      G x operand (result)    operand
    reduce-scatter  operand                 operand / G (result)
    all-reduce      2 x operand             2 x operand
    all-to-all      operand                 operand

A collective whose group spans the ``"pod"`` axis mixes ranks below and
at or above ``pod_boundary`` = 256 of the (2, 16, 16) mesh: its moved
bytes are also DCI bytes, as the reference tallies them.

:class:`TraceCounter` is the dispatch mode that counts HBM bytes (input
plus output bytes of every aten op that is not a view or an allocation)
and the peak of live bytes over the meta tensors' storages; a kernel
wrapper handed ``meta`` tensors adds its kernel's ``work`` (FLOPs, bytes)
to the active counter through :func:`add_kernel_work` instead of running
anything.  :func:`bound_ms` is the least time of a kernel's work, the
bound column of ``PERF.md``'s kernel table.
"""

from __future__ import annotations

import dataclasses
import threading

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 34e12}
# ... and on the tensor cores, by input dtype (float32 runs as TF32)
TENSOR_PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
                     "float32": 495e12}
# TF32 products a float32 product takes with each operand split into a
# TF32 high and low part: hi hi + hi lo + lo hi
TF32_SPLIT_PRODUCTS = 3
HBM_BW = 3.35e12
LINK_BW = 50e9
POD_BOUNDARY = 256

# Mesh's collective kinds by the reference's HLO opcodes
HLO_KIND = {"all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
            "reduce_scatter": "reduce-scatter", "all_gather": "all-gather",
            "all_to_all": "all-to-all"}


def bound_ms(flops: float, nbytes: float, peak_flops: float) -> tuple:
    """(ms, "operations" or "bytes"): the larger of ``flops`` over
    ``peak_flops`` and ``nbytes`` over :data:`HBM_BW`, the card's least
    time for that work."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def tf32_split_ceiling_ms(flops: float) -> float:
    """The least time of ``flops`` float32 FLOPs taken as three TF32
    products of split operands (the float32 flash kernel's ceiling)."""
    return TF32_SPLIT_PRODUCTS * flops / TENSOR_PEAK_FLOPS["float32"] * 1e3


def moved_bytes(kind: str, operand: int, group: int) -> int:
    """Ring-wire bytes of one collective (``hlo_analysis``'s
    ``_collective_moved_bytes``)."""
    kind = HLO_KIND[kind]
    if kind == "all-gather":
        return operand * group
    if kind == "all-reduce":
        return 2 * operand
    return operand


def payload_bytes(kind: str, operand: int, group: int) -> int:
    """This rank's shard payload of one collective (``hlo_analysis``'s
    ``_collective_payload_bytes``)."""
    kind = HLO_KIND[kind]
    if kind == "reduce-scatter":
        return operand // group
    if kind == "all-reduce":
        return 2 * operand
    return operand


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    total_bytes: int
    dci_bytes: int
    op_count: int

    def to_json(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TraceStats:
    """One rank's counts of a traced step (``hlo_analysis.HloStats``'
    keys where they have a meaning).  ``flops``: the aten ops' FLOPs
    (``FlopCounterMode``'s registry) plus the kernels' ``work``;
    ``matmul_flops`` the first alone; ``hbm_bytes`` every non-view op's
    input and output bytes plus the kernels' ``work`` bytes."""
    flops: float
    matmul_flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_payload_bytes: float
    dci_bytes: float
    collective_by_kind: dict
    collective_ops: int
    largest_collectives: list
    kernels: dict

    def to_json(self):
        return dataclasses.asdict(self)


def collective_stats(records: list) -> dict:
    """The reference's collective columns from a mesh's records of (kind,
    operand bytes, axes, group size, (lowest, highest) global rank of the
    group): a group that mixes ranks below and at or above
    :data:`POD_BOUNDARY` moves DCI bytes."""
    by_kind: dict = {}
    moved_total = payload = dci = 0
    largest = []
    for kind, operand, axes, group, (lo, hi) in records:
        moved = moved_bytes(kind, operand, group)
        hlo = HLO_KIND[kind]
        by_kind[hlo] = by_kind.get(hlo, 0) + moved
        moved_total += moved
        payload += payload_bytes(kind, operand, group)
        if lo < POD_BOUNDARY <= hi:
            dci += moved
        largest.append((moved, hlo, "+".join(axes)))
    largest.sort(key=lambda t: -t[0])
    return {"collective_bytes": moved_total,
            "collective_payload_bytes": payload, "dci_bytes": dci,
            "collective_by_kind": by_kind, "collective_ops": len(records),
            "largest_collectives": [list(t) for t in largest[:10]]}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops: float
    bytes_accessed: float
    comm_bytes: int
    dci_bytes: int
    model_flops_per_chip: float
    useful_flop_ratio: float  # MODEL_FLOPS / traced FLOPs (per rank)
    peak_flops: float

    def to_json(self):
        return dataclasses.asdict(self)


def model_flops(kind: str, active_params: float, batch: int,
                seq: int) -> float:
    """Whole-job useful FLOPs: 6ND train, 2ND prefill, 2N*batch decode."""
    if kind == "train":
        return 6.0 * active_params * batch * seq
    if kind == "prefill":
        return 2.0 * active_params * batch * seq
    return 2.0 * active_params * batch  # decode: one token per request


def _roofline(flops, nbytes, comm, dci, *, kind, active_params, batch, seq,
              chips, dtype) -> Roofline:
    peak = PEAK_FLOPS[dtype]
    compute_s = flops / peak
    memory_s = nbytes / HBM_BW
    collective_s = comm / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(kind, active_params, batch, seq) / chips
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, flops=flops, bytes_accessed=nbytes,
        comm_bytes=int(comm), dci_bytes=int(dci), model_flops_per_chip=mf,
        useful_flop_ratio=(mf / flops if flops > 0 else 0.0),
        peak_flops=peak)


def roofline_from_stats(stats, *, kind: str, active_params: float,
                        batch: int, seq: int, chips: int,
                        dtype: str = "bfloat16") -> Roofline:
    """Roofline from a traced step's :class:`TraceStats`; ``dtype`` picks
    the compute peak."""
    return _roofline(stats.flops, stats.hbm_bytes, stats.collective_bytes,
                     stats.dci_bytes, kind=kind, active_params=active_params,
                     batch=batch, seq=seq, chips=chips, dtype=dtype)


def compute_roofline(cost: dict, coll: CollectiveStats, *, kind: str,
                     active_params: float, batch: int, seq: int,
                     chips: int, dtype: str = "bfloat16") -> Roofline:
    """Roofline from a cost dict (``flops``, ``bytes accessed``) and
    :class:`CollectiveStats`."""
    return _roofline(float(cost.get("flops", 0.0)),
                     float(cost.get("bytes accessed", 0.0)),
                     coll.total_bytes, coll.dci_bytes, kind=kind,
                     active_params=active_params, batch=batch, seq=seq,
                     chips=chips, dtype=dtype)


# ---------------------------------------------------------------------------
# Tracing counters
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()
# allocations that move no bytes
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}
# indexed writes: the values and indices are read, the rows they hit
# written; the tensor written is not read whole
_INDEXED_WRITES = {"index_put", "index_put_", "_index_put_impl_"}


def add_kernel_work(name: str, flops: float, nbytes: float) -> None:
    """Add one kernel launch's ``work`` to the innermost active
    :class:`TraceCounter` of this thread (nothing without one)."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack:
        stack[-1].add_kernel(name, flops, nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


class TraceCounter(TorchDispatchMode):
    """Counts, while active, the FLOPs of every aten op that
    ``FlopCounterMode`` counts (its registry: the matmuls, convolutions and
    attentions), the HBM bytes of every aten op (its tensor inputs and
    outputs, once each; views and allocations move none; an indexed write
    its values and indices twice over), the kernels' work
    (:func:`add_kernel_work`) and the peak of live bytes: ``base`` (the
    arguments' bytes, held throughout) plus every storage an op made that
    is still alive, sampled at each new storage.  (``FlopCounterMode``
    itself is not used: its module tracker keeps activations alive, which
    would raise the peak.)"""

    def __init__(self, base: int = 0):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.kernels: dict = {}
        self.base = base
        self.peak = base
        self._live: dict = {}

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    @property
    def kernel_flops(self) -> float:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())

    def __enter__(self):
        if not hasattr(_ACTIVE, "stack"):
            _ACTIVE.stack = []
        _ACTIVE.stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.stack.remove(self)
        return super().__exit__(*exc)

    def _track(self, outs: list) -> None:
        fresh = []
        for t in outs:
            s = t.untyped_storage()
            ref = StorageWeakRef(s)
            old = self._live.get(ref.cdata)
            if old is None or old[0].expired():
                fresh.append((ref, s.nbytes()))
        if not fresh:
            return
        self._live = {k: v for k, v in self._live.items()
                      if not v[0].expired()}
        for ref, n in fresh:
            self._live[ref.cdata] = (ref, n)
        live = self.base + sum(n for _, n in self._live.values())
        self.peak = max(self.peak, live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        name = func.overloadpacket.__name__
        if func.is_view or name in _ALLOCS:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _INDEXED_WRITES:
            self.hbm_bytes += 2 * sum(_nbytes(t) for t in ins[1:])
            return out
        held = {StorageWeakRef(t.untyped_storage()).cdata for t in ins}
        new = [t for t in outs
               if StorageWeakRef(t.untyped_storage()).cdata not in held]
        if not new and not func._schema.is_mutable:
            return out  # views the schema does not mark (split, unbind)
        written = {id(t) for t in outs}
        self.hbm_bytes += sum(_nbytes(t) for t in ins
                              if id(t) not in written)
        self.hbm_bytes += sum(_nbytes(t) for t in outs)
        self._track(new)
        return out
