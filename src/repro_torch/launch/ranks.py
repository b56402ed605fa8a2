"""SPMD ranks in spawned processes, for driving the distributed layer from
one process (tests, ``chip_smoke.py``'s ``[dist]`` phase).

``RankPool(world, backend, device)`` starts ``world`` processes (the
``spawn`` start method), each of which initialises ``torch.distributed``
with the backend the caller picked, over a ``file://`` store in a fresh
temporary directory, and then waits for work.  :meth:`RankPool.run` sends
the same call ``fn(ctx, *args)`` to every rank, SPMD, and returns the
ranks' results in rank order; ``ctx`` is the rank's :class:`RankContext`,
whose ``cache`` dict lives as long as the rank (meshes, operators).  ``fn``
and its arguments are pickled, so ``fn`` is a module-level function of an
importable module (or of the main script).  A rank that raises, or dies,
makes ``run`` raise with its traceback or exit code, after which the pool
is done: :meth:`close` (or leaving the ``with`` block) stops every rank,
and terminates the ones a failed collective left waiting.

    with RankPool(4, "gloo", "cpu", threads=1) as pool:
        ys = pool.run(some_module.case, 4099, "pencil")

    with RankPool(1, "nccl", "cuda:0") as pool:
        ys = pool.run(some_module.case, 10**5, "psum")

On one card, several ranks share ``cuda:0`` and must use gloo (NCCL refuses
two ranks on one device); gloo stages CUDA tensors through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue
import shutil
import tempfile
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

# How long a rank's collectives, and run()'s wait for the ranks' results, may
# take before they fail; and how long close() waits for a rank to stop.
TIMEOUT_S = 600.0
CLOSE_TIMEOUT_S = 30.0


@dataclasses.dataclass
class RankContext:
    rank: int
    world: int
    device: torch.device
    cache: dict = dataclasses.field(default_factory=dict)


def _rank_main(rank, world, backend, store, device, threads, tasks, results):
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            device_id=dev if backend == "nccl" else None)
    ctx = RankContext(rank, world, dev)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args = item
            try:
                results.put((rank, True, fn(ctx, *args)))
            except Exception:  # reported to the caller, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks on ``torch.distributed``.  ``backend``
    (``"nccl"``, ``"gloo"``) and ``device`` (``"cuda:0"``, ``"cpu"``) are
    the caller's to pick; nothing here defaults them.  ``threads``: torch
    threads a rank, 0 keeps torch's default."""

    def __init__(self, world: int, backend: str, device: str, *,
                 threads: int = 0):
        self.world = world
        self._dir = Path(tempfile.mkdtemp(prefix="repro_torch_ranks_"))
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, backend, str(self._dir / "store"), str(device),
                  threads, self._tasks[r], self._results),
            daemon=True) for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args):
        """``fn(ctx, *args)`` on every rank; the results in rank order."""
        for q in self._tasks:
            q.put((fn, args))
        got = {}
        waited = 0.0
        while len(got) < self.world:
            try:
                rank, ok, out = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    raise RuntimeError(f"rank(s) exited during "
                                       f"{fn.__name__}: (rank, exit code) "
                                       f"{dead}")
                if waited > TIMEOUT_S:
                    missing = sorted(set(range(self.world)) - set(got))
                    raise TimeoutError(f"{fn.__name__}: no result from "
                                       f"ranks {missing} in "
                                       f"{TIMEOUT_S:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed in {fn.__name__}:\n"
                                   f"{out}")
            got[rank] = out
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        """Stop every rank: ask, wait ``CLOSE_TIMEOUT_S``, then terminate."""
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(CLOSE_TIMEOUT_S)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(CLOSE_TIMEOUT_S)
        for q in self._tasks + [self._results]:
            q.close()
            q.join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
