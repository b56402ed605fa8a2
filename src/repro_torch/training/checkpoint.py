"""Checkpointing: leaf-per-file snapshots of a tree of tensors, with an
atomic manifest.

PyTorch counterpart of ``repro.training.checkpoint``, in the same on-disk
format, byte for byte, so each package restores what the other wrote.
Format (``<dir>/step_<n>/``, n as eight digits):

    manifest.json   tree paths, shapes, dtypes, per-leaf CRC32 checksums,
                    step, the writers' process count
    leaf_<i>.npy    one array per leaf, on the host

A tree is what :mod:`repro_torch.tree` walks: dicts, lists, tuples and
NamedTuples around leaves, with an ``nn.Module`` standing for the dict of
its parameters by name; leaf paths are spelled as JAX's ``keystr`` spells
them.  Restore copies a module's leaves into its parameters in place and
returns the module itself, so that a restored train state keeps the
model's storage.

* atomic: written to ``step_<n>.tmp`` and renamed; a crash mid-write never
  damages the latest step, and ``.tmp`` directories left by a killed
  writer are swept by a later save once older than :data:`TMP_SWEEP_TTL_S`;
* async: ``save_checkpoint(..., blocking=False)`` copies the leaves to host
  memory at once (a device-to-host copy, which waits for the card) and
  writes them in a daemon thread (:class:`CheckpointWriter`);
* checksummed: restore checks every leaf's CRC32, shape, dtype and tree
  path; a damaged step raises :class:`CheckpointCorruptionError`, and
  :func:`restore_latest_valid` falls back to the newest intact step;
* multi-process: leaves are dealt round-robin over ``process_count``
  writers (``leaf % process_count == process_index``), each writing its
  own leaves and a shard manifest, and process 0 merging them; the
  defaults (0 of 1) give the single-process layout.  Nothing here reads
  ``torch.distributed``.

``restore_checkpoint(..., device=)`` places the restored tensors on one
device; by default each goes to its ``like`` leaf's device (CPU for a leaf
that is not a tensor).

Sharded (``shardings=``, a tree of :class:`repro_torch.dist.sharding.
NamedSharding` beside the state, as the sharded train step holds it): a
save gathers one leaf at a time from the ranks' blocks to global rank 0,
which writes the same format (full leaves, manifest, CRCs); a restore
reads each leaf memory-mapped, checks its CRC and full shape, and keeps
this rank's block under the new sharding, so a step written on one mesh
restores onto another, onto one device, and into the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import (  # noqa: F401  (the checkpoint's tree walk)
    tree_flatten_with_path, tree_leaves, tree_unflatten,
)

_SENTINEL = "manifest.json"
_SHARD_MANIFEST = "manifest_shard_{p}.json"

#: Orphaned ``step_*.tmp`` directories older than this many seconds are
#: swept by the next save (a live non-blocking writer's tmp dir is younger).
TMP_SWEEP_TTL_S = 600.0


class CheckpointError(RuntimeError):
    """A checkpoint could not be restored into the requested tree."""


class CheckpointCorruptionError(CheckpointError):
    """A checkpoint step is damaged on disk (checksum/shape/missing file)."""


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

#: A bfloat16 leaf on disk: numpy has no bfloat16, and the JAX package's
#: ``np.save`` of an ml_dtypes bfloat16 array writes raw 2-byte voids; the
#: port writes the same array bytes (its header spells the void "|V2",
#: ml_dtypes "<V2") and names the dtype "bfloat16" in the manifest, as the
#: JAX package does.
_BF16 = np.dtype("V2")


def _np_dtype(x) -> np.dtype:
    """A leaf's numpy dtype without a device transfer (tensors, arrays,
    anything with a ``dtype``, Python numbers); bfloat16 is ``_BF16``."""
    dt = getattr(x, "dtype", None)
    if dt == torch.bfloat16:
        return _BF16
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).numpy().dtype
    return np.dtype(dt) if dt is not None else np.asarray(x).dtype


def _dtype_name(x) -> str:
    dt = _np_dtype(x)
    return "bfloat16" if dt == _BF16 else str(dt)


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf; a card's tensor goes through page-locked
    memory (several times the bandwidth of a pageable copy)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return _to_host(x.view(torch.int16)).view(_BF16)
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x).numpy()
        return x.cpu().numpy()
    return np.asarray(x)


def leaf_crc32(arr: np.ndarray) -> int:
    """CRC32 of a leaf's raw bytes (shape/dtype are covered by the manifest)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def _sweep_orphaned_tmp(directory: str, ttl_s: float, *,
                        skip: Optional[str] = None) -> int:
    """Remove ``step_*.tmp`` dirs older than ``ttl_s`` (killed writers).

    ``skip`` protects the caller's own tmp dir; another tmp dir younger than
    the TTL is taken to belong to a live concurrent writer and kept."""
    if not os.path.isdir(directory):
        return 0
    now = time.time()
    swept = 0
    for name in os.listdir(directory):
        if not (name.startswith("step_") and name.endswith(".tmp")):
            continue
        full = os.path.join(directory, name)
        if full == skip:
            continue
        try:
            age = now - os.path.getmtime(full)
        except OSError:  # a concurrent writer renamed/removed it: not ours
            continue
        if age >= ttl_s:
            shutil.rmtree(full, ignore_errors=True)
            swept += 1
    return swept


class CheckpointWriter(threading.Thread):
    """Async checkpoint writer: keeps a write failure instead of dying
    silently.  ``check()`` (after ``join()``) re-raises it; a blocking save
    calls it for the caller, so a failed blocking save raises.
    ``seconds``: how long the write took."""

    def __init__(self, target):
        super().__init__(daemon=True)
        self._write = target
        self.exception: Optional[BaseException] = None
        self.seconds = 0.0

    def run(self):
        t0 = time.perf_counter()
        try:
            self._write()
        except BaseException as e:  # surfaced via check()
            self.exception = e
        finally:
            self.seconds = time.perf_counter() - t0

    def check(self) -> None:
        if self.exception is not None:
            raise self.exception


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    blocking: bool = True, keep: int = 3,
                    process_index: int = 0, process_count: int = 1,
                    tmp_ttl_s: float = TMP_SWEEP_TTL_S,
                    barrier_timeout_s: float = 300.0,
                    shardings: Any = None) -> CheckpointWriter:
    """Snapshot ``tree`` at ``step``; returns the writer thread.

    Every process calls this with the same ``step`` and tree structure; a
    process copies to the host and writes only the leaves it owns
    (``i % process_count == process_index``).  Process 0 waits for every
    shard manifest, merges them, writes the final manifest and publishes
    the step with one rename.  ``keep`` > 0 keeps the newest ``keep``
    steps.  With ``shardings`` (every rank of the mesh calls this), the
    leaves are blocks: each is gathered whole, and global rank 0 writes
    them all (the one-process layout); the other ranks' writers do
    nothing.
    """
    p, np_procs = process_index, process_count
    flat = tree_flatten_with_path(tree)
    paths = [path for path, _ in flat]
    leaves = [leaf for _, leaf in flat]
    shapes = [list(np.shape(x)) if not isinstance(x, torch.Tensor)
              else list(x.shape) for x in leaves]
    dtypes = [_dtype_name(x) for x in leaves]
    if shardings is not None:
        # every rank gathers each leaf; rank 0 alone copies and writes
        sh = tree_leaves(shardings)
        writer = sh[0].mesh.rank == 0
        host = {}
        for i, (leaf, s) in enumerate(zip(leaves, sh)):
            full = s.gather(leaf.detach()) if isinstance(
                leaf, torch.Tensor) and s.is_split else leaf
            shapes[i] = list(np.shape(full)) if not isinstance(
                full, torch.Tensor) else list(full.shape)
            if writer:
                host[i] = _to_host(full)
            del full
        if not writer:
            t = CheckpointWriter(lambda: None)
            t.start()
            t.join()
            return t
    else:
        owned = [i for i in range(len(leaves)) if i % np_procs == p]
        host = {i: _to_host(leaves[i]) for i in owned}

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        _sweep_orphaned_tmp(directory, tmp_ttl_s, skip=tmp)
        crcs = {}
        for i, arr in host.items():
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            crcs[i] = leaf_crc32(arr)
        shard = {
            "process_index": p,
            "leaves": sorted(host),
            "crc32": {str(i): crcs[i] for i in host},
        }
        shard_path = os.path.join(tmp, _SHARD_MANIFEST.format(p=p))
        with open(shard_path + ".part", "w") as f:
            json.dump(shard, f)
        os.rename(shard_path + ".part", shard_path)  # shard commit point
        if p != 0:
            return  # process 0 merges and publishes
        deadline = time.time() + barrier_timeout_s
        crc_all: dict[int, int] = dict(crcs)
        for q in range(1, np_procs):
            qpath = os.path.join(tmp, _SHARD_MANIFEST.format(p=q))
            while not os.path.exists(qpath):
                if time.time() > deadline:
                    raise CheckpointError(
                        f"multi-host save barrier timed out waiting for "
                        f"process {q}'s shard manifest at step {step}")
                time.sleep(0.01)
            with open(qpath) as f:
                qshard = json.load(f)
            crc_all.update({int(k): v for k, v in qshard["crc32"].items()})
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "paths": paths,
            "shapes": shapes,
            "dtypes": dtypes,
            "crc32": [crc_all[i] for i in range(len(leaves))],
            "process_count": np_procs,
        }
        with open(os.path.join(tmp, _SENTINEL), "w") as f:
            json.dump(manifest, f)
        try:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except OSError:
            # a concurrent writer published this step first: keep theirs
            shutil.rmtree(tmp, ignore_errors=True)
        _garbage_collect(directory, keep)

    t = CheckpointWriter(write)
    t.start()
    if blocking:
        t.join()
        t.check()  # a failed blocking save must raise, not return
    return t


def _garbage_collect(directory: str, keep: int) -> None:
    """Drop all but the newest ``keep`` steps (``keep <= 0`` keeps all);
    ``.tmp`` dirs are never touched, and a step another GC removed first is
    ignored."""
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

def _load_manifest(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:08d}", _SENTINEL)
    if not os.path.exists(path):
        raise CheckpointCorruptionError(
            f"step {step} in {directory!r} has no manifest "
            f"(partially written or deleted)")
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptionError(
            f"step {step} manifest in {directory!r} is unreadable: {e}")


def all_steps(directory: str) -> list[int]:
    """Steps with a parseable manifest; a torn manifest never lists."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not (name.startswith("step_") and not name.endswith(".tmp")):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            continue
        try:
            _load_manifest(directory, step)
        except CheckpointCorruptionError:
            continue
        out.append(step)
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _restore_arrays(directory: str, step: int, like: Any,
                    shardings: Any = None) -> list:
    """Load and check every leaf; raises CheckpointError subclasses.  With
    ``shardings``, a leaf is read memory-mapped, checked whole against its
    full shape and CRC, and this rank's block is returned."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = _load_manifest(directory, step)
    flat = tree_flatten_with_path(like)
    like_paths = [p for p, _ in flat]
    if manifest["num_leaves"] != len(flat):
        raise CheckpointError(
            f"checkpoint step {step} holds {manifest['num_leaves']} leaves "
            f"but the target tree has {len(flat)}")
    # a drifted state definition (renamed or reordered fields) must not
    # restore silently into the wrong leaves
    for i, (mp, lp) in enumerate(zip(manifest.get("paths", like_paths),
                                     like_paths)):
        if mp != lp:
            raise CheckpointError(
                f"checkpoint step {step} leaf {i} was saved at tree path "
                f"{mp!r} but the target tree expects {lp!r} — the state "
                f"definition drifted since this checkpoint was written")
    crcs = manifest.get("crc32")
    sh = [None] * len(flat) if shardings is None else tree_leaves(shardings)
    arrs = []
    for i, ((name, ref), s) in enumerate(zip(flat, sh)):
        leaf_path = os.path.join(path, f"leaf_{i}.npy")
        name = name or f"leaf_{i}"
        try:
            arr = np.load(leaf_path, mmap_mode=None if s is None else "r")
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(
                f"checkpoint step {step} leaf {name!r} ({leaf_path}) is "
                f"missing or unreadable: {e}")
        if s is not None and s.shape is not None:
            want_shape = s.shape
        else:
            want_shape = tuple(ref.shape) if hasattr(ref, "shape") \
                else np.shape(ref)
        if tuple(arr.shape) != tuple(want_shape):
            raise CheckpointError(
                f"checkpoint step {step} leaf {name!r} has shape "
                f"{tuple(arr.shape)} but the target tree expects "
                f"{tuple(want_shape)}")
        ref_dtype = _np_dtype(ref)
        if arr.dtype != ref_dtype:
            raise CheckpointError(
                f"checkpoint step {step} leaf {name!r} has dtype "
                f"{arr.dtype} but the target tree expects {ref_dtype}")
        if crcs is not None:
            crc = leaf_crc32(arr)
            if crc != crcs[i]:
                raise CheckpointCorruptionError(
                    f"checkpoint step {step} leaf {name!r} failed its CRC32 "
                    f"check (stored {crcs[i]:#010x}, got {crc:#010x}) — "
                    f"the file was truncated or bit-flipped on disk")
        if s is not None:
            arr = np.array(arr[s.block_slices(arr.shape)] if s.is_split
                           else arr)
        arrs.append(arr)
    return arrs


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       device: str | torch.device | None = None,
                       shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` as tensors.

    ``like``'s leaves give the expected shape and dtype (tensors, arrays,
    or anything with ``shape`` and ``dtype``).  Every leaf is checked
    against ``like`` (count, tree path, shape, dtype) and against its CRC32;
    a violation raises :class:`CheckpointError` /
    :class:`CheckpointCorruptionError` naming the leaf.  ``device``: where
    the tensors go; by default each goes to its ``like`` leaf's device
    (CPU for a leaf that is not a tensor).  A module of ``like`` is
    restored into its own parameters, in place.  ``shardings``: ``like``
    holds this rank's blocks under these shardings (elastic restore: the
    mesh may differ from the one that saved); each leaf is checked whole
    and this rank keeps its block.
    """
    arrs = _restore_arrays(directory, step, like, shardings)
    out = []
    for arr, ref in zip(arrs, tree_leaves(like)):
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        if arr.dtype == _BF16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(dev))
    return _into_modules(like, tree_unflatten(like, out))


def _into_modules(like: Any, built: Any) -> Any:
    """``built`` with each module of ``like`` put back in its place, its
    parameters overwritten in place by the dict ``built`` holds there."""
    if isinstance(like, torch.nn.Module):
        with torch.no_grad():
            for name, param in like.named_parameters():
                param.copy_(built[name])
        return like
    if isinstance(like, dict):
        return {k: _into_modules(like[k], built[k]) for k in like}
    if isinstance(like, tuple) and hasattr(type(like), "_fields"):
        return type(like)(*[_into_modules(a, b) for a, b in zip(like, built)])
    if isinstance(like, (list, tuple)):
        return type(like)(_into_modules(a, b) for a, b in zip(like, built))
    return built


def restore_latest_valid(directory: str, like: Any, *,
                         device: str | torch.device | None = None,
                         shardings: Any = None
                         ) -> tuple[Optional[int], Any]:
    """Restore the newest step that passes every check.

    Walks the steps newest first, skipping a step that fails its checksum,
    shape or manifest checks, so a bit-flipped latest snapshot costs one
    step of progress.  Returns ``(step, tree)``; ``(None, None)`` when no
    intact step exists.
    """
    for step in sorted(all_steps(directory), reverse=True):
        try:
            return step, restore_checkpoint(directory, step, like,
                                            device=device,
                                            shardings=shardings)
        except CheckpointError:
            continue
    return None, None
