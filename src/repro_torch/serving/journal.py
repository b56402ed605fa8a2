"""Journaled serving registry: checksummed append-only durability.

PyTorch counterpart of ``repro.serving.journal``, in its JSON-lines record
format, so either package replays the other's journal.  A
:class:`~repro_torch.serving.graph.GraphModelRegistry` is derived state
over its registered models: prediction plans, multiplier stacks and grid
caches are all rebuilt from (model, domain) pairs.  This module makes that
source of truth durable:

* every registration or eviction appends ONE self-contained record: the
  model's dual vector and training points (base64 of the raw bytes, with
  dtype and shape), the kernel's name and parameter, the frozen
  :class:`~repro_torch.core.fastsum.FastsumParams` fields, and the group's
  domain (domain points and margin);
* each record carries a CRC32 of its canonical JSON, so a torn final line
  (a crash mid-append) or a bit-flipped record is detected: replay skips it
  and reports it in the :class:`RecoveryReport`;
* :func:`recover_registry` replays the journal in order through the
  registry's own ``register`` / ``unregister``; grids re-derive on first
  demand, and the journal is attached again afterwards.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import threading
import zlib
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.fastsum import FastsumParams
from repro_torch.device import resolve_device
from repro_torch.core.kernels import KERNEL_PARAM_NAME, kernel_from_param
from repro_torch.graph.krr import KRRModel
from repro_torch.serving.graph import GraphModelRegistry

JOURNAL_VERSION = 1


class JournalError(RuntimeError):
    """A journal record could not be encoded or decoded."""


# ---------------------------------------------------------------------------
# Record encoding
# ---------------------------------------------------------------------------

def encode_array(arr) -> dict:
    """Tensor or array -> JSON-safe {dtype, shape, data (base64 bytes)}."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj["data"].encode("ascii"))
    a = np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
    return a.reshape(tuple(obj["shape"])).copy()


def _canonical(record: dict) -> bytes:
    """Canonical bytes the CRC covers (the crc field excluded)."""
    body = {k: v for k, v in record.items() if k != "crc"}
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def record_crc(record: dict) -> int:
    return zlib.crc32(_canonical(record)) & 0xFFFFFFFF


def register_record(model_id: str, model: KRRModel, *,
                    domain_points=None, margin: float = 0.5) -> dict:
    """The record of one registration: everything the registry derives
    (plan, multiplier, grids) is a function of its contents."""
    kname = model.kernel.name
    pname = KERNEL_PARAM_NAME.get(kname)
    if pname is None or pname not in model.kernel.params:
        raise JournalError(
            f"kernel {kname!r} is not journal-serializable (custom phi); "
            f"only named kernels {sorted(KERNEL_PARAM_NAME)} round-trip")
    return {
        "v": JOURNAL_VERSION,
        "op": "register",
        "model_id": model_id,
        "alpha": encode_array(model.alpha),
        "train_points": encode_array(model.train_points),
        "kernel": {"name": kname,
                   "param": float(model.kernel.params[pname])},
        "params": dataclasses.asdict(model.params),
        "num_iters": int(model.num_iters),
        "converged": bool(model.converged),
        "domain_points": (None if domain_points is None
                          else encode_array(domain_points)),
        "margin": float(margin),
    }


def unregister_record(model_id: str) -> dict:
    return {"v": JOURNAL_VERSION, "op": "unregister", "model_id": model_id}


def decode_register(record: dict, *,
                    device: str | torch.device = "cpu"):
    """A register record -> (KRRModel, domain_points | None, margin), the
    model's tensors on ``device``."""
    points = torch.as_tensor(decode_array(record["train_points"]),
                             device=device)
    model = KRRModel(
        alpha=torch.as_tensor(decode_array(record["alpha"]), device=device),
        train_points=points,
        kernel=kernel_from_param(record["kernel"]["name"],
                                 record["kernel"]["param"]),
        params=FastsumParams(**record["params"]),
        num_iters=torch.as_tensor(record["num_iters"], dtype=torch.int32),
        converged=torch.as_tensor(record["converged"]),
        pred_cache={})
    domain = record.get("domain_points")
    domain_points = None if domain is None else decode_array(domain)
    return model, domain_points, float(record.get("margin", 0.5))


# ---------------------------------------------------------------------------
# The journal file
# ---------------------------------------------------------------------------

class RegistryJournal:
    """Append-only CRC-checked JSON-lines journal of a serving registry.

    An append is synchronous (write, flush, fsync) under a lock: when
    ``append`` returns, the record survives a process kill.  A crash during
    an append leaves at most one torn final line, which replay detects and
    skips.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None

    def append(self, record: dict) -> None:
        record = dict(record)
        record["crc"] = record_crc(record)
        line = json.dumps(record, sort_keys=True,
                          separators=(",", ":")) + "\n"
        with self._lock:
            if self._fh is None:
                parent = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(parent, exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_records(path: str) -> Iterator[tuple]:
    """``(line_no, record | None, error | None)`` per journal line.

    A line that does not parse, or whose CRC does not match, yields
    ``(line_no, None, reason)``; the caller decides whether that is fatal
    (for replay it never is: one corrupt record costs one tenant)."""
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as fh:
        for line_no, line in enumerate(fh, start=1):
            if not line.strip():
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError as e:
                yield line_no, None, f"unparseable record (torn write?): {e}"
                continue
            crc = record.get("crc")
            want = record_crc(record)
            if crc != want:
                yield (line_no, None,
                       f"checksum mismatch (stored {crc}, computed {want})")
                continue
            yield line_no, record, None


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryReport:
    """What :func:`recover_registry` found and rebuilt."""

    journal_path: str
    records_total: int = 0    # journal lines examined
    records_applied: int = 0  # records replayed successfully
    records_skipped: int = 0  # corrupt / unreplayable records skipped
    corrupt: list = dataclasses.field(default_factory=list)  # (line, reason)
    tenants: dict = dataclasses.field(default_factory=dict)  # id -> status

    @property
    def clean(self) -> bool:
        """True when every record replayed and every tenant recovered."""
        return (not self.corrupt and all(
            s in ("recovered", "evicted") for s in self.tenants.values()))

    def summary(self) -> str:
        n_rec = sum(1 for s in self.tenants.values() if s == "recovered")
        return (f"replayed {self.records_applied}/{self.records_total} "
                f"records from {self.journal_path}: {n_rec} models "
                f"recovered, {self.records_skipped} records skipped"
                + ("" if self.clean else " [DEGRADED]"))


def recover_registry(journal_path: str, *, grid_cache_slots: int = 32,
                     device: str | torch.device | None = None,
                     ) -> tuple[GraphModelRegistry, RecoveryReport]:
    """Warm-restart a registry by replaying its journal.

    Registrations and evictions replay in journal order through the
    registry's own ``register`` / ``unregister``, so plans and multipliers
    are rebuilt as live registration built them, on ``device`` (default:
    the card, ``cuda``; ``"cpu"`` when asked); grids re-derive on first
    request.  Corrupt records are skipped and reported (a tenant whose
    model could not be rebuilt gets a ``failed: ...`` status).  The journal
    is attached to the recovered registry afterwards, so later
    registrations continue it; replay itself appends nothing.
    """
    device = resolve_device(device)
    registry = GraphModelRegistry(grid_cache_slots=grid_cache_slots)
    report = RecoveryReport(journal_path=journal_path)
    for line_no, record, err in iter_records(journal_path):
        report.records_total += 1
        if err is not None:
            report.records_skipped += 1
            report.corrupt.append((line_no, err))
            continue
        op = record.get("op")
        model_id = record.get("model_id", "?")
        try:
            if op == "register":
                model, domain_points, margin = decode_register(
                    record, device=device)
                registry.register(model_id, model,
                                  domain_points=domain_points, margin=margin)
                report.tenants[model_id] = "recovered"
            elif op == "unregister":
                registry.unregister(model_id)
                report.tenants[model_id] = "evicted"
            else:
                raise JournalError(f"unknown journal op {op!r}")
        except Exception as e:  # one bad record loses one tenant, not all
            report.records_skipped += 1
            report.corrupt.append((line_no, f"{type(e).__name__}: {e}"))
            report.tenants[model_id] = f"failed: {e}"
            continue
        report.records_applied += 1
    registry.attach_journal(RegistryJournal(journal_path))
    return registry, report
