"""Graph-predict serving tier: continuous-batched NFFT kernel predictions.

PyTorch counterpart of ``repro.serving.graph``.  The engine serves
``F(x) = sum_i alpha_i K(x_i - x)`` to many concurrent users with the
request/slot/recycle idiom of :mod:`repro_torch.serving.engine`, but the
"decode step" is a fastsum gather instead of a transformer forward:

* A :class:`GraphModelRegistry` holds multi-tenant
  :class:`~repro_torch.graph.krr.KRRModel`\\ s grouped by training points:
  every model fitted on the same nodes shares ONE
  :class:`~repro_torch.core.fastsum.PredictionPlan` and contributes only its
  spectral multiplier (the layout of
  :class:`~repro_torch.core.fastsum.FastsumOperatorBank`).
* Per (model, dual-vector) column the registry caches the transformed
  grid: spread -> rfftn -> multiply -> irfftn of the dual vector
  (:func:`repro_torch.core.fastsum_exec.fused_transform_columns`).  It
  depends only on the source side, so it is built once (the cold columns
  of one tick share one transform) and reused by every later tick.
* A tick packs the due chunk of every active request's query points into
  ONE target set, builds one window geometry and runs ONE ragged gather
  (:func:`repro_torch.core.fastsum_exec.fused_gather_columns`) in which each
  packed row reads its request's grid channel.  Steady traffic replans
  nothing.
* Requests longer than ``chunk`` rows span several ticks with a per-slot
  cursor; finished slots are refilled in the same tick.  The transform is
  padded to ``min(slots, 8)`` columns and the tick grid to ``slots``
  channels, the JAX package's fixed widths, so the registry's counters and
  the packed gather's channel indices are the JAX engine's, one for one.

Queries and their packing stay on the host (numpy), as in the JAX
package; a tick moves the packed rows to the plan's device once and its
output back once.  The plan's device is the models' training points'.

Guarded execution (``guards=True``): per-request deadlines with slot
eviction, bounded-queue backpressure, out-of-domain queries rejected or
served through the exact :func:`~repro_torch.graph.krr.krr_predict` replan,
a non-finite output guard, plan validation with group rebuild, and a
per-tenant circuit breaker that drops the tenant's cached grids.
Durability: ``GraphModelRegistry(journal=...)`` appends one checksummed
record per registration or eviction
(:class:`~repro_torch.serving.journal.RegistryJournal`), from which
:func:`~repro_torch.serving.journal.recover_registry` warm-restarts the
registry.  Fault injection: ``GraphServeEngine(chaos=...)`` takes a
per-tick schedule (:class:`~repro_torch.runtime.faultinject.TickChaos`)
whose dropped ticks are counted.  The JAX package's ``backend=`` has no
counterpart, since the port's window step is chosen by the tensors'
device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import fastsum_exec
from repro_torch.core.fastsum import (
    PredictionPlan, make_prediction_plan, prediction_multiplier,
)
from repro_torch.core.nfft import build_window_geometry
from repro_torch.graph.krr import KRRModel, krr_predict, points_fingerprint

_ALPHA = "alpha"  # column id of a request served with the model's own dual


@dataclasses.dataclass
class PredictRequest:
    """One user's prediction request.

    ``rhs`` overrides the model's dual vector (length n_train); ``None``
    serves the registered model's own.
    """

    uid: int
    model_id: str
    query_points: np.ndarray  # (m, d)
    rhs: Optional[np.ndarray] = None
    deadline_s: Optional[float] = None  # relative to submit; None = none
    # filled by the engine:
    output: Optional[np.ndarray] = None  # (m,) predictions
    done: bool = False
    error: Optional[str] = None
    submitted_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency(self) -> float:
        return self.finished_at - self.submitted_at


@dataclasses.dataclass
class TickStats:
    """Per-tick observability record (appended to ``engine.tick_log``)."""

    queue_depth: int  # waiting requests after admission
    occupancy: int  # active slots this tick
    groups: int  # tenant groups touched
    rows: int  # query rows served
    grid_builds: int  # cold (model, rhs) columns transformed this tick
    grid_hits: int  # columns served from the grid cache
    finished: int  # requests retired this tick
    seconds: float
    # guard counters (0 / False on a healthy tick):
    evicted: int = 0  # deadline-expired requests evicted
    out_of_domain: int = 0  # inadmissible queries rejected or re-planned
    nonfinite: int = 0  # requests failed by the non-finite output guard
    rebuilds: int = 0  # corrupted-plan group rebuilds triggered
    dropped: bool = False  # tick dropped by fault injection


@dataclasses.dataclass
class _ModelEntry:
    model: KRRModel
    member: int  # index into the group's multiplier stack


class _TenantGroup:
    """Models sharing training points (hence plan, scaling, geometry)."""

    def __init__(self, pred: PredictionPlan, grid_cache_slots: int):
        self.pred = pred
        self.gkey: Optional[tuple] = None  # registry group key
        self.domain_args: tuple = (None, 0.5)  # (domain_points, margin)
        self.entries: dict[str, _ModelEntry] = {}
        self.multipliers: list[torch.Tensor] = []  # folded half-spectra
        self.mult_stack: Optional[torch.Tensor] = None  # (S,) + half-spectrum
        # transformed-grid LRU keyed (model_id, rhs fingerprint | "alpha")
        self.grids: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self.grid_cache_slots = grid_cache_slots
        self._zero_grid: Optional[torch.Tensor] = None

    def add(self, model_id: str, model: KRRModel,
            mult: torch.Tensor) -> None:
        self.multipliers.append(mult)
        self.mult_stack = torch.stack(self.multipliers)
        self.entries[model_id] = _ModelEntry(model, len(self.multipliers) - 1)
        # a re-registered model invalidates its cached grids
        for key in [k for k in self.grids if k[0] == model_id]:
            del self.grids[key]

    def zero_grid(self) -> torch.Tensor:
        """A zero channel for padding the tick grid to its fixed width."""
        if self._zero_grid is None:
            plan, src = self.pred.plan, self.pred.scaled_src
            self._zero_grid = torch.zeros((plan.grid_size,) * plan.d,
                                          dtype=src.dtype, device=src.device)
        return self._zero_grid


class GraphModelRegistry:
    """Multi-tenant model registry with per-group plan and grid caches.

    Thread-safe: registration and grid-cache access hold one lock.
    """

    def __init__(self, *, grid_cache_slots: int = 32, journal=None):
        """``journal``: an optional
        :class:`~repro_torch.serving.journal.RegistryJournal`; every
        registration and eviction then appends one checksummed record, and
        :func:`~repro_torch.serving.journal.recover_registry` rebuilds the
        registry from them."""
        self._groups: dict[tuple, _TenantGroup] = {}
        self._model_group: dict[str, _TenantGroup] = {}
        self._lock = threading.Lock()
        self._journal = journal
        self._journal_local = threading.local()
        self.grid_cache_slots = grid_cache_slots
        self.counters = {
            "plan_builds": 0,        # PredictionPlan constructions
            "multiplier_builds": 0,  # per-model spectral multipliers
            "grid_builds": 0,        # (model, rhs) transform-to-grid runs
            "grid_hits": 0,          # columns served from the grid cache
            "bank_transforms": 0,    # fused_transform_columns calls
            "grid_invalidations": 0,  # cached grids dropped by the guards
            "group_rebuilds": 0,     # corrupted-plan group rebuilds
        }

    # -- journal plumbing ----------------------------------------------------
    def attach_journal(self, journal) -> None:
        """Journal later registrations and evictions (recovery attaches
        the journal only after its replay, so replay appends nothing)."""
        self._journal = journal

    @contextlib.contextmanager
    def _suppress_journal(self):
        """Internal re-registrations (group rebuilds, an eviction's
        siblings) append no records: theirs are in the journal already."""
        prev = getattr(self._journal_local, "suppress", False)
        self._journal_local.suppress = True
        try:
            yield
        finally:
            self._journal_local.suppress = prev

    def _journal_append(self, make_record) -> None:
        if (self._journal is not None
                and not getattr(self._journal_local, "suppress", False)):
            self._journal.append(make_record())

    def register(self, model_id: str, model: KRRModel, *,
                 domain_points=None, margin: float = 0.5) -> None:
        """Add (or replace) a servable model.

        Models fitted on the same training points (same content, params and
        declared domain) join one tenant group and share its prediction
        plan; only the model's spectral multiplier is built.  With a
        journal attached, the registration is durable before it is
        servable.
        """
        from repro_torch.serving import journal as journal_mod
        self._journal_append(lambda: journal_mod.register_record(
            model_id, model, domain_points=domain_points, margin=margin))
        with self._lock:
            gkey = (points_fingerprint(model.train_points), model.params,
                    None if domain_points is None
                    else points_fingerprint(domain_points), margin)
            group = self._groups.get(gkey)
            if group is None:
                pred = make_prediction_plan(
                    model.train_points, model.params,
                    domain_points=domain_points, margin=margin,
                    device=model.train_points.device)
                group = _TenantGroup(pred, self.grid_cache_slots)
                group.gkey = gkey
                group.domain_args = (domain_points, margin)
                self._groups[gkey] = group
                self.counters["plan_builds"] += 1
            mult = prediction_multiplier(model.kernel, group.pred,
                                         model.params)
            self.counters["multiplier_builds"] += 1
            group.add(model_id, model, mult)
            self._model_group[model_id] = group

    def _dissolve(self, model_id: str):
        """Drop ``model_id``'s group (under the lock): returns its entries
        and domain arguments, or None when the model is unknown."""
        group = self._model_group.get(model_id)
        if group is None:
            return None
        items = list(group.entries.items())
        self._groups.pop(group.gkey, None)
        for mid, _ in items:
            self._model_group.pop(mid, None)
        return items, group.domain_args

    def _reregister(self, items, domain_args) -> None:
        """Register ``items`` again (a rebuild, not new registrations:
        the journal already holds their records)."""
        domain_points, margin = domain_args
        with self._suppress_journal():
            for mid, entry in items:  # register() takes the lock itself
                self.register(mid, entry.model, domain_points=domain_points,
                              margin=margin)

    def unregister(self, model_id: str) -> bool:
        """Evict a model from serving (journaled as an eviction record).
        The multiplier stack and the grid cache are group-shared, so the
        group is rebuilt from its remaining models (sibling grids re-derive
        lazily).  False when unknown."""
        with self._lock:
            dissolved = self._dissolve(model_id)
        if dissolved is None:
            return False
        from repro_torch.serving import journal as journal_mod
        self._journal_append(lambda: journal_mod.unregister_record(model_id))
        items, domain_args = dissolved
        self._reregister([(mid, e) for mid, e in items if mid != model_id],
                         domain_args)
        return True

    def group_of(self, model_id: str) -> Optional[_TenantGroup]:
        with self._lock:
            return self._model_group.get(model_id)

    def model_ids(self) -> list:
        with self._lock:
            return list(self._model_group)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["groups"] = len(self._groups)
            out["models"] = len(self._model_group)
            out["grids_resident"] = sum(
                len(g.grids) for g in self._groups.values())
            return out

    # -- guarded-execution surface -----------------------------------------
    def invalidate_grids(self, model_id: str) -> int:
        """Drop every cached grid of ``model_id`` (poisoned-state recovery);
        the next request rebuilds clean grids from the registered model."""
        with self._lock:
            group = self._model_group.get(model_id)
            if group is None:
                return 0
            keys = [k for k in group.grids if k[0] == model_id]
            for k in keys:
                del group.grids[k]
            self.counters["grid_invalidations"] += len(keys)
            return len(keys)

    @staticmethod
    def plan_valid(group: _TenantGroup) -> bool:
        """Invariant of a group's frozen plan: its own sources are finite
        and admissible under its own scaling (checked on the plan's
        device, one boolean read back).  A corrupted plan violates it."""
        src = group.pred.scaled_src
        return bool(torch.isfinite(src).all()
                    & group.pred.admissible(src).all())

    def rebuild_group(self, model_id: str) -> bool:
        """Rebuild ``model_id``'s whole tenant group from its registered
        models: fresh plan, fresh multipliers, empty grid cache (the
        recovery path for a corrupted plan)."""
        with self._lock:
            dissolved = self._dissolve(model_id)
            if dissolved is None:
                return False
            self.counters["group_rebuilds"] += 1
        self._reregister(*dissolved)
        return True

    # -- grid cache ---------------------------------------------------------
    def ensure_grids(self, group: _TenantGroup, columns: Sequence[tuple],
                     rhs_arrays: dict, *, pad_to: int) -> tuple:
        """The cached grid of every column, building the cold ones.

        ``columns`` lists (model_id, rhs_key); ``rhs_arrays`` maps a
        non-``"alpha"`` rhs_key to its dual vector.  All cold columns of
        the call ride ONE transform, padded to ``pad_to`` columns.
        Returns ``(grids, number built)``.
        """
        with self._lock:
            missing = [c for c in columns if c not in group.grids]
            if missing:
                src = group.pred.scaled_src
                cols, members = [], []
                for model_id, rhs_key in missing:
                    entry = group.entries[model_id]
                    vec = (entry.model.alpha if rhs_key == _ALPHA
                           else rhs_arrays[rhs_key])
                    cols.append(torch.as_tensor(vec, dtype=src.dtype,
                                                device=src.device))
                    members.append(entry.member)
                k = len(cols)
                width = max(pad_to, k)
                if k < width:  # zero columns keep the transform's width
                    cols += [torch.zeros_like(cols[0])] * (width - k)
                    members += [members[0]] * (width - k)
                xb = torch.stack(cols, dim=1)  # (n, width)
                mult_cols = group.mult_stack[
                    torch.tensor(members, device=src.device)]
                grids = fastsum_exec.fused_transform_columns(
                    group.pred.plan, mult_cols, group.pred.src_window, xb)
                for i, ckey in enumerate(missing):
                    # a copy, not a view of the whole transform: evicting
                    # a column then frees its memory
                    group.grids[ckey] = grids[..., i].contiguous()
                while len(group.grids) > group.grid_cache_slots:
                    group.grids.popitem(last=False)  # evict LRU
                self.counters["grid_builds"] += k
                self.counters["bank_transforms"] += 1
            out = []
            for ckey in columns:
                group.grids.move_to_end(ckey)  # most recently used
                out.append(group.grids[ckey])
            self.counters["grid_hits"] += len(columns) - len(missing)
            return out, len(missing)


def tick_predict(plan, points: torch.Tensor, grid: torch.Tensor,
                 col_index: torch.Tensor) -> torch.Tensor:
    """The device part of one tick: the window geometry of the packed,
    scaled query ``points`` (m, d) and the ragged gather in which row ``i``
    reads channel ``col_index[i]`` of the tick grid ``grid`` ((P,)^d x
    slots) -> (m,).  The engine's tick runs it, and the dry run's
    graph-serve cell traces it (``launch.dryrun.run_graph_serve_cell``)."""
    tgt = build_window_geometry(plan, points)
    return fastsum_exec.fused_gather_columns(plan, tgt, grid, col_index)


class GraphServeEngine:
    """Slot-based continuous-batching engine for graph predictions.

    ``slots`` bounds the requests in flight; each slot serves up to
    ``chunk`` query rows a tick.  Every tick runs, per touched tenant
    group, exactly one packed gather (plus one transform when cold columns
    appear).
    """

    def __init__(self, registry: GraphModelRegistry, *, slots: int = 8,
                 chunk: int = 128, max_queue: Optional[int] = None,
                 guards: bool = True, out_of_domain: str = "reject",
                 breaker_threshold: int = 3, breaker_cooldown: int = 8,
                 chaos=None):
        """``max_queue`` bounds admission (submit rejects with backpressure
        when full); ``guards=False`` disables the runtime guards;
        ``out_of_domain`` is ``"reject"`` or ``"replan"`` (the exact slow
        path); ``chaos`` is an optional fault schedule with an
        ``apply(engine, tick) -> drop`` method
        (:class:`~repro_torch.runtime.faultinject.TickChaos`)."""
        if out_of_domain not in ("reject", "replan"):
            raise ValueError(f"out_of_domain must be 'reject' or 'replan', "
                             f"got {out_of_domain!r}")
        self.registry = registry
        self.slots = slots
        self.chunk = chunk
        self.guards = guards
        self.out_of_domain = out_of_domain
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.chaos = chaos
        self.queue: "queue.Queue[PredictRequest]" = \
            queue.Queue(maxsize=max_queue or 0)
        self.active: list[Optional[PredictRequest]] = [None] * slots
        self.pos = np.zeros((slots,), np.int64)
        self._scaled: list[Optional[np.ndarray]] = [None] * slots
        self._group: list[Optional[_TenantGroup]] = [None] * slots
        self._breaker_fails: dict[str, int] = {}
        self._breaker_open_until: dict[str, int] = {}
        self._tick_guard: dict = {}
        self.tick_log: list[TickStats] = []
        self.counters = {"ticks": 0, "rows": 0, "admitted": 0,
                         "finished": 0, "rejected": 0,
                         "geometry_builds": 0,
                         # guard counters
                         "backpressure": 0, "deadline_evicted": 0,
                         "out_of_domain": 0, "replans": 0,
                         "nonfinite": 0, "plan_rebuilds": 0,
                         "breaker_trips": 0, "breaker_rejections": 0,
                         "dropped_ticks": 0}

    # -- public -------------------------------------------------------------
    def submit(self, req: PredictRequest) -> bool:
        """Enqueue a request; False (the request failed at once) when the
        bounded queue is full."""
        req.submitted_at = time.perf_counter()
        try:
            self.queue.put_nowait(req)
        except queue.Full:
            req.error = "queue full (backpressure)"
            req.done = True
            req.finished_at = time.perf_counter()
            self.counters["backpressure"] += 1
            return False
        return True

    def step(self) -> TickStats:
        """One tick: admit, one packed gather per touched group, retire
        finished requests."""
        t0 = time.perf_counter()
        self._tick_guard = {"evicted": 0, "out_of_domain": 0,
                            "nonfinite": 0, "rebuilds": 0}
        dropped = bool(self.chaos is not None
                       and self.chaos.apply(self, self.counters["ticks"]))
        rows = builds = hits = finished = 0
        by_group: dict[int, list[int]] = {}
        if dropped:  # requests wait for a later tick
            self.counters["dropped_ticks"] += 1
            occupancy = sum(1 for r in self.active if r is not None)
        else:
            if self.guards:
                self._evict_expired()
            self._admit()
            groups: dict[int, _TenantGroup] = {}
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                g = self._group[slot]
                by_group.setdefault(id(g), []).append(slot)
                groups[id(g)] = g
            occupancy = sum(len(s) for s in by_group.values())
            for gid, slot_ids in by_group.items():
                r, b, h, f = self._tick_group(groups[gid], slot_ids)
                rows += r
                builds += b
                hits += h
                finished += f
        stats = TickStats(
            queue_depth=self.queue.qsize(), occupancy=occupancy,
            groups=len(by_group), rows=rows, grid_builds=builds,
            grid_hits=hits, finished=finished,
            seconds=time.perf_counter() - t0, **self._tick_guard,
            dropped=dropped)
        self.tick_log.append(stats)
        self.counters["ticks"] += 1
        self.counters["rows"] += rows
        self.counters["finished"] += finished
        return stats

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            stats = self.step()
            if stats.occupancy == 0 and self.queue.empty():
                return

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _finish(req: PredictRequest, error: Optional[str] = None) -> None:
        req.error = error
        req.done = True
        req.finished_at = time.perf_counter()

    def _fail(self, req: PredictRequest, msg: str) -> None:
        self._finish(req, msg)
        self.counters["rejected"] += 1

    def _release(self, slot: int) -> None:
        self.active[slot] = None
        self._scaled[slot] = None
        self._group[slot] = None

    def _evict(self, slot: int, msg: str, counter: str) -> None:
        """Fail an in-flight request and recycle its slot at once."""
        self._finish(self.active[slot], msg)
        self._release(slot)
        self.counters[counter] += 1

    def _evict_expired(self) -> None:
        now = time.perf_counter()
        for slot, req in enumerate(self.active):
            if req is None or req.deadline_s is None:
                continue
            if now - req.submitted_at > req.deadline_s:
                self._evict(slot, "deadline exceeded", "deadline_evicted")
                self._tick_guard["evicted"] += 1

    def _scale(self, group: _TenantGroup, q: np.ndarray):
        """(scaled queries as numpy, all admissible?) on the host."""
        scaled = group.pred.scale_targets(q)
        return scaled.numpy(), bool(group.pred.admissible(scaled).all())

    def _handle_inadmissible(self, req: PredictRequest, group: _TenantGroup,
                             q: np.ndarray):
        """Admission found inadmissible scaled queries.  In order: a
        corrupted plan (detected by the plan invariant; the group is
        rebuilt from its models and the admission retried), non-finite
        query points (rejected), or queries outside the domain (rejected,
        or served by the exact replan under ``out_of_domain="replan"``).

        Returns ``(group, scaled)`` when the request may take a slot,
        ``(None, None)`` when it was finished here."""
        if self.guards and not self.registry.plan_valid(group):
            if self.registry.rebuild_group(req.model_id):
                self.counters["plan_rebuilds"] += 1
                self._tick_guard["rebuilds"] += 1
                group = self.registry.group_of(req.model_id)
                if group is not None:
                    scaled, ok = self._scale(group, q)
                    if ok:
                        return group, scaled
            if group is None or not self.registry.plan_valid(group):
                self._fail(req, "serving plan corrupted and rebuild failed")
                return None, None
        self._tick_guard["out_of_domain"] += 1
        if not np.all(np.isfinite(q)):
            self._fail(req, "non-finite query points")
            self.counters["out_of_domain"] += 1
            return None, None
        if self.out_of_domain == "replan":
            self._replan(req)
            return None, None
        self._fail(req, "query points outside the registered serving "
                        "domain (inadmissible after scaling)")
        self.counters["out_of_domain"] += 1
        return None, None

    # -- circuit breaker ----------------------------------------------------
    def _breaker_allow(self, model_id: str) -> bool:
        return (self.counters["ticks"]
                >= self._breaker_open_until.get(model_id, 0))

    def _breaker_failure(self, model_id: str) -> None:
        if not self.guards:
            return
        fails = self._breaker_fails.get(model_id, 0) + 1
        if fails >= self.breaker_threshold:
            # trip: shed this tenant's load for the cooldown and drop its
            # cached grids (poisoned serving state is the likely cause)
            self._breaker_open_until[model_id] = (
                self.counters["ticks"] + 1 + self.breaker_cooldown)
            self.counters["breaker_trips"] += 1
            # half-open after the cooldown: a single failure re-trips
            self._breaker_fails[model_id] = self.breaker_threshold - 1
            self.registry.invalidate_grids(model_id)
        else:
            self._breaker_fails[model_id] = fails

    def _breaker_success(self, model_id: str) -> None:
        self._breaker_fails.pop(model_id, None)

    def _replan(self, req: PredictRequest) -> None:
        """Serve an out-of-domain request through the exact slow path: a
        full :func:`~repro_torch.graph.krr.krr_predict` replans over train ∪
        query jointly, so any finite query location is served correctly."""
        model = self.registry.group_of(req.model_id).entries[
            req.model_id].model
        dev = model.alpha.device
        if req.rhs is not None:
            model = model._replace(alpha=torch.as_tensor(
                req.rhs, dtype=model.alpha.dtype, device=dev))
        out = krr_predict(model, torch.as_tensor(
            np.asarray(req.query_points), device=dev)).cpu().numpy()
        if not np.all(np.isfinite(out)):
            self._breaker_failure(req.model_id)
            self._fail(req, "non-finite output from out-of-domain replan")
            self.counters["nonfinite"] += 1
            self._tick_guard["nonfinite"] += 1
            return
        req.output = out
        self._finish(req)
        self.counters["replans"] += 1

    def _admit(self) -> None:
        """Fill free slots from the queue (scale + admissibility).

        Runs at the top of every tick, so a recycled slot is refilled in
        the tick that freed it."""
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            # a rejected request takes no slot: keep pulling until this
            # slot is filled or the queue is empty
            while True:
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    return
                if (self.guards and req.deadline_s is not None
                        and time.perf_counter() - req.submitted_at
                        > req.deadline_s):
                    self._finish(req, "deadline exceeded")
                    self.counters["deadline_evicted"] += 1
                    self._tick_guard["evicted"] += 1
                    continue
                group = self.registry.group_of(req.model_id)
                if group is None:
                    self._fail(req, f"unknown model_id {req.model_id!r}")
                    continue
                if self.guards and not self._breaker_allow(req.model_id):
                    self._fail(req, f"circuit open for model "
                                    f"{req.model_id!r} (repeated failures)")
                    self.counters["breaker_rejections"] += 1
                    continue
                q = np.asarray(req.query_points)
                d = group.pred.scaled_src.shape[1]
                if q.ndim != 2 or q.shape[1] != d:
                    self._fail(req, f"query_points shape {q.shape} does not "
                                    f"match d={d}")
                    continue
                if (req.rhs is not None and np.asarray(req.rhs).shape
                        != (group.pred.n_source,)):
                    self._fail(req, f"rhs shape {np.asarray(req.rhs).shape} "
                                    f"!= ({group.pred.n_source},)")
                    continue
                if (self.guards and req.rhs is not None
                        and not np.all(np.isfinite(np.asarray(req.rhs)))):
                    self._fail(req, "non-finite rhs")
                    continue
                scaled, ok = self._scale(group, q)
                if not ok:
                    group, scaled = self._handle_inadmissible(req, group, q)
                    if group is None:
                        continue  # rejected or served by the replan
                req.output = np.zeros((q.shape[0],), scaled.dtype)
                self.active[slot] = req
                self.pos[slot] = 0
                self._scaled[slot] = scaled
                self._group[slot] = group
                self.counters["admitted"] += 1
                break

    def _columns(self, slot_ids: list) -> tuple:
        """The (model, dual-vector) columns of the slots, deduped:
        ``(columns, column of each slot, rhs arrays by key)``."""
        columns: list[tuple] = []
        col_of_slot: dict[int, int] = {}
        rhs_arrays: dict = {}
        for slot in slot_ids:
            req = self.active[slot]
            if req.rhs is None:
                ckey = (req.model_id, _ALPHA)
            else:
                fp = points_fingerprint(req.rhs)
                rhs_arrays[fp] = req.rhs
                ckey = (req.model_id, fp)
            if ckey not in columns:
                columns.append(ckey)
            col_of_slot[slot] = columns.index(ckey)
        return columns, col_of_slot, rhs_arrays

    def _pack(self, slot_ids: list, col_of_slot: dict, d: int,
              dtype) -> tuple:
        """This tick's chunk of every slot's scaled queries, packed into
        ``slots * chunk`` rows on the host (pad rows sit at the origin,
        always admissible, and their values are discarded):
        ``(packed, col_index, takes)``."""
        m_pack = self.slots * self.chunk
        packed = np.zeros((m_pack, d), dtype)
        col_index = np.zeros((m_pack,), np.int32)
        takes = []
        row = 0
        for slot in slot_ids:
            req = self.active[slot]
            pos = int(self.pos[slot])
            take = min(self.chunk, req.query_points.shape[0] - pos)
            packed[row:row + take] = self._scaled[slot][pos:pos + take]
            col_index[row:row + take] = col_of_slot[slot]
            takes.append((slot, row, pos, take))
            row += take
        return packed, col_index, takes

    def _tick_group(self, group: _TenantGroup, slot_ids: list) -> tuple:
        """One packed predict for every active slot of one tenant group:
        ``(rows, columns built, columns hit, requests finished)``."""
        pred = group.pred
        columns, col_of_slot, rhs_arrays = self._columns(slot_ids)
        grids, n_built = self.registry.ensure_grids(
            group, columns, rhs_arrays, pad_to=min(self.slots, 8))
        # fixed-width tick grid: the JAX engine's channel layout
        chans = list(grids) + [group.zero_grid()] * (self.slots - len(grids))
        grid = torch.stack(chans[:self.slots], dim=-1)
        src = pred.scaled_src
        packed, col_index, takes = self._pack(
            slot_ids, col_of_slot, src.shape[1],
            torch.empty((), dtype=src.dtype).numpy().dtype)
        points = torch.as_tensor(packed, dtype=src.dtype, device=src.device)
        self.counters["geometry_builds"] += 1
        out = tick_predict(
            pred.plan, points, grid,
            torch.as_tensor(col_index, device=grid.device)).cpu().numpy()

        finished = 0
        for slot, row0, pos, take in takes:
            req = self.active[slot]
            seg = out[row0:row0 + take]
            if self.guards and not np.all(np.isfinite(seg)):
                # poisoned grid or multiplier: fail the request and feed
                # the tenant's breaker (tripping drops its grids)
                self._evict(slot, "non-finite prediction output",
                            "nonfinite")
                self._tick_guard["nonfinite"] += 1
                self._breaker_failure(req.model_id)
                finished += 1
                continue
            req.output[pos:pos + take] = seg
            self.pos[slot] += take
            if self.pos[slot] >= req.query_points.shape[0]:
                self._finish(req)
                self._release(slot)
                self._breaker_success(req.model_id)
                finished += 1
        rows = sum(take for _, _, _, take in takes)
        return rows, n_built, len(columns) - n_built, finished
