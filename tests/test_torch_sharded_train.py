"""The port's sharded LM train step against the JAX package's single-device
step, on four gloo ranks on the CPU.

One :class:`repro_torch.launch.ranks.RankPool` of four spawned ranks (one
torch thread each) serves every case of this module; the rank side is
``tests/_torch_shard_cases.py``.  The JAX package's own sharded step is red
on jax 0.9.0 (tests/test_distributed.py::
test_sharded_train_step_matches_single_device), so the port is held, as
that test holds the reference, against the single-device step:

* reduced granite-3-2b (float32, batch 8 x 64 tokens) at meshes (4, 1),
  (2, 2) and (1, 4), AdamW with 1 and 2 microbatches (the second with
  error-feedback compression) and Adafactor; a batch of 6 rows (not a
  multiple of 4: the rows are replicated); three steps from the JAX
  package's initial state.  Loss, ``grad_norm`` and ``lr`` within
  ``STEP_TOL`` relative (tests/test_torch_train.py's 1e-5) of the JAX
  step's, every gathered parameter within ``STEP_TOL`` of its leaf's
  largest entry, the residuals as test_torch_train holds them; every
  leaf that no axis splits bitwise equal on the ranks; each rank's bytes
  of state exactly the blocks of ``_state_shardings``;
* reduced olmoe-1b-7b at (2, 2) against the JAX step with ``token_groups``
  = 2: the reference's MoE routing under a (2, 2) mesh;
* elastic restore: a sharded checkpoint written at (4, 1) after 2 steps
  restores onto (2, 2) and onto one device, the third step's loss within
  1e-4 of continuing at (4, 1) (tests/test_distributed.py::
  test_elastic_restore_across_meshes), and into the JAX package with
  every leaf equal;
* ``torchrun`` of ``repro_torch.launch.train --model-parallel 2``.

The JAX steps are jitted once per case in a module fixture, side by side
on threads.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_cases as C
from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.launch.ranks import RankPool
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import train_loop as ttl
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-2b"
MOE_ARCH = "olmoe-1b-7b"
STEP_TOL = 1e-5  # tests/test_torch_train.py's
ELASTIC_TOL = 1e-4  # tests/test_distributed.py's
STEPS = 3
ROWS, ODD_ROWS = 8, 6
MESHES = [(4, 1), (2, 2), (1, 4)]
# (optimizer, microbatches, compress_grads)
CASES = [("adamw", 1, False), ("adamw", 2, True), ("adafactor", 1, False)]


def _jax_run(arch, case, rows, token_groups=None):
    """The JAX package's initial state (plain numpy, no JAX classes), and
    after STEPS jitted single-device steps its metrics, parameters and
    residuals."""
    name, micro, compress = case
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch),
                                   global_batch=rows)
    if token_groups is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, token_groups=token_groups))
    kw = {"factored_min_dim": 16} if name == "adafactor" else {}
    tc = jtl.TrainConfig(optimizer=jopt.OptimizerConfig(name=name, **kw),
                         num_microbatches=micro, compress_grads=compress)
    state = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, tc)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    plain = {"step": int(state.step), "params": np_tree(state.params),
             "opt_state": [np_tree(f) for f in state.opt_state],
             "ef": None if state.ef_state is None
             else np_tree(state.ef_state.residuals)}
    step = jax.jit(jtl.make_train_step(jcfg, tc))
    metrics = []
    for s in range(STEPS):
        state, m = step(state, jax.tree.map(
            jnp.asarray, jpipe.batch_for_step(jcfg, jcfg.shapes[0], s)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"plain": plain, "metrics": metrics,
            "params": np_tree(state.params),
            "ef": None if state.ef_state is None
            else np_tree(state.ef_state.residuals)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This process's own steps are small: one torch thread (pytest-xdist's
    parallel workers would oversubscribe the cores); the caller's count
    back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", threads=1) as ranks:
        yield ranks


@pytest.fixture(scope="module", autouse=True)
def jax_refs():
    """Every JAX reference, each built once, on threads side by side from
    the module's start (the tests that need none run first, meanwhile):
    ``jax_refs[key].result()``."""
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        refs = {(MOE_ARCH, CASES[0], ROWS): ex.submit(
            _jax_run, MOE_ARCH, CASES[0], ROWS, 2)}  # the slowest first
        for case in CASES:
            refs[ARCH, case, ROWS] = ex.submit(_jax_run, ARCH, case, ROWS)
        refs[ARCH, CASES[0], ODD_ROWS] = ex.submit(_jax_run, ARCH, CASES[0],
                                                   ODD_ROWS)
        yield refs


def test_moe_route_under_the_mesh_is_the_single_device_route(pool):
    """The ranks' positions and slots, side by side, are the single-device
    route's with two token groups; the aux loss is the whole batch's."""
    outs = pool.run(C.route_positions, (2, 2), 128, 5)
    cfg = C.config(MOE_ARCH, 2, token_groups=2)
    from repro_torch.models.model import init_params
    moe = init_params(cfg, 0, device="cpu").blocks[0].moe
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (128, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        r = moe.route(x)
    # ranks 0 and 2 hold data blocks 0 and 1 (ranks 1 and 3 repeat them)
    got_pos = np.concatenate([outs[0]["pos"], outs[2]["pos"]])
    got_slot = np.concatenate([outs[0]["slot"], outs[2]["slot"]])
    for rank in (1, 3):
        np.testing.assert_array_equal(outs[rank]["pos"],
                                      outs[rank - 1]["pos"])
    np.testing.assert_array_equal(got_pos, r.pos.numpy())
    np.testing.assert_array_equal(got_slot, r.slot.numpy())
    assert all(abs(o["aux"] - float(r.aux)) <= 1e-6 * float(r.aux)
               for o in outs)


def test_launch_train_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced
    --device cpu --model-parallel 2 --steps 2`` (4 x 32 tokens): two gloo
    ranks on a (1, 2) mesh train, rank 0 writes the checkpoints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", ARCH, "--reduced", "--device", "cpu",
         "--model-parallel", "2", "--steps", "2", "--batch", "4",
         "--seq-len", "32",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "rank 0 of 2: backend gloo on cpu" in out
    assert "rank 1 of 2: backend gloo on cpu" in out
    assert "mesh={'data': 1, 'model': 2}" in out
    assert "done: 2 steps" in out and "restarts=0" in out
    assert tckpt.all_steps(str(tmp_path / "ckpt")) == [0, 2]


def test_elastic_restore_across_meshes_and_into_one_device(pool, tmp_path):
    """Save at (4, 1) after 2 steps; restore onto (2, 2) and onto one
    device: the third step's loss within 1e-4 of continuing at (4, 1).
    The JAX package restores the step with every leaf equal."""
    directory = str(tmp_path)
    outs = pool.run(C.train, ARCH, (4, 1), "adamw", 1, False, ROWS, None, 3,
                    None, directory, 2)
    cont = outs[0]["metrics"][2]["loss"]
    moved = pool.run(C.resume, ARCH, (2, 2), "adamw", ROWS, directory, 2, 1)
    assert all(abs(o[0]["loss"] - cont) <= ELASTIC_TOL for o in moved)
    cfg, tc = C.config(ARCH, ROWS), C.train_config("adamw", 1, False)
    like = ttl.init_train_state(cfg, tc, 1, device="cpu")
    single = tckpt.restore_checkpoint(directory, 2, like)
    assert int(single.step) == 2

    class Ctx:
        device = torch.device("cpu")

    _, m = ttl.make_train_step(cfg, tc)(single, C.batch(Ctx, cfg, 2))
    assert abs(float(m["loss"]) - cont) <= ELASTIC_TOL
    # the JAX package restores the same step: every leaf equal
    restored = tckpt.restore_checkpoint(directory, 2, like)
    sds = lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                         np.dtype(str(t.dtype)[6:]))
    jlike = jtl.TrainState(
        step=jax.ShapeDtypeStruct((), np.int32),
        params={n: sds(p) for n, p in restored.params.named_parameters()},
        opt_state=jopt.AdamWState(*[jax.tree.map(sds, f)
                                    for f in restored.opt_state]),
        ef_state=None)
    jstate = jckpt.restore_checkpoint(directory, 2, jlike)
    port = tckpt.tree_leaves(restored)
    assert len(port) == len(jax.tree_util.tree_leaves(jstate))
    for a, b in zip(port, jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _check_against_jax(outs, ref, compress, params=True):
    """Every rank's metrics and gathered leaves against the JAX run."""
    first = outs[0]
    for o in outs:
        assert o["digests"] == first["digests"]  # unsplit leaves: bitwise
        assert all(np.array_equal(a, b) for a, b in
                   zip(tree_leaves(o["full"]), tree_leaves(first["full"])))
        held, want, full = o["bytes"]
        assert held == want <= full
    for s in range(STEPS):
        got, w = first["metrics"][s], ref["metrics"][s]
        assert sorted(got) == sorted(w)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(got[k] - w[k]) <= STEP_TOL * abs(w[k]), (s, k,
                                                               got[k], w[k])
    got = tree_flatten_with_path(first["full"]["params"])
    want = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == np.shape(w), path
        assert not params or _rel(g, w) <= STEP_TOL, (path, _rel(g, w))
    if compress:
        # a residual is the gradient's rounding to the int8 lattice: as
        # test_torch_train holds it, within 1e-5 of the gradient's scale
        # (254 x the leaf's largest residual) but at most 0.1 % of elements
        off = total = 0
        for g, w in zip(tree_leaves(first["full"]["ef"]),
                        jax.tree_util.tree_leaves(ref["ef"])):
            w = np.asarray(w)
            off += int((np.abs(g - w) > STEP_TOL * 254 * np.abs(w).max())
                       .sum())
            total += w.size
        assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_step_matches_jax_single_device(pool, jax_refs, shape, case):
    ref = jax_refs[ARCH, case, ROWS].result()
    outs = pool.run(C.train, ARCH, shape, *case, ROWS, ref["plain"], STEPS)
    _check_against_jax(outs, ref, case[2])
    if shape != (1, 4):  # the FSDP axis splits the matrices' rows
        assert outs[0]["bytes"][0] < outs[0]["bytes"][2] / 2
    traffic = outs[0]["traffic"][0]
    assert traffic["all_gather"] > 0 and traffic["all_reduce"] > 0
    assert ("reduce_scatter" in traffic) == (shape[0] > 1)
    assert ("all_reduce_max" in traffic) == case[2]


def test_batch_that_does_not_divide_is_replicated(pool, jax_refs):
    """6 rows over a data axis of 4: every rank computes the whole batch,
    and the step still gives the single-device result."""
    ref = jax_refs[ARCH, CASES[0], ODD_ROWS].result()
    outs = pool.run(C.train, ARCH, (4, 1), *CASES[0], ODD_ROWS, ref["plain"],
                    STEPS)
    _check_against_jax(outs, ref, False)


def test_moe_at_2x2_routes_as_the_reference_under_the_mesh(pool, jax_refs):
    """Reduced olmoe-1b-7b at (2, 2): two token groups (the mesh's data
    extent), each rank routing its own; the JAX single-device step with
    ``token_groups=2`` is the reference's routing under that mesh.  The
    metrics are held to STEP_TOL.  So are the parameters, against the
    port's single-device step on the same state; against the JAX step the
    port's single-device MoE step itself differs by up to ~1.8e-5 of the
    stacked norms' largest entry (~1.8e-5 after three AdamW steps: an
    element whose gradient lies within float noise of Adam's eps moves by
    an amount the noise decides), so there the sharded step may be at most
    STEP_TOL farther from the JAX step than the single-device one is."""
    ref = jax_refs[MOE_ARCH, CASES[0], ROWS].result()
    outs = pool.run(C.train, MOE_ARCH, (2, 2), *CASES[0], ROWS, ref["plain"],
                    STEPS, 2)
    _check_against_jax(outs, ref, False, params=False)
    assert all(m["aux_loss"] > 0 for m in outs[0]["metrics"])
    cfg, tc = C.config(MOE_ARCH, ROWS, 2), C.train_config(*CASES[0])
    state = ttl.train_state_from_arrays(C._Plain(ref["plain"], "adamw"), cfg,
                                        tc, device="cpu")
    step = ttl.make_train_step(cfg, tc)

    class Ctx:
        device = torch.device("cpu")

    for s in range(STEPS):
        state, _ = step(state, C.batch(Ctx, cfg, s))
    single = C.param_tree(state.params)
    for (path, g), w, j in zip(
            tree_flatten_with_path(outs[0]["full"]["params"]),
            tree_leaves(single), jax.tree_util.tree_leaves(ref["params"])):
        assert _rel(g, w) <= STEP_TOL, (path, _rel(g, w))
        assert _rel(g, j) <= _rel(w, j) + STEP_TOL, (path, _rel(g, j))
