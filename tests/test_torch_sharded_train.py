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
  largest entry from the JAX step's and from the port's single-device
  step's (under a "model" split, the zero-initialised vector leaves
  ``ZERO_INIT`` from the single-device step's alone: ``_check_params``),
  the residuals as test_torch_train holds them; every
  leaf that no axis splits bitwise equal on the ranks; each rank's bytes
  of state exactly the blocks of ``_state_shardings``;
* reduced olmoe-1b-7b at (2, 2) against the JAX step with ``token_groups``
  = 2: the reference's MoE routing under a (2, 2) mesh;
* at (2, 2) and (1, 4) the ranks of "model" compute their blocks of the
  heads, hidden units, experts, Mamba heads and vocabulary: reduced
  olmoe-1b-7b (8 experts, 2 a rank), reduced mamba2-1.3b (the gated norm
  over the whole inner dim) and reduced granite with a vocabulary of 130
  (ceil blocks of 33, the last of 31) at (1, 4) against the JAX step; each
  rank's forward matmul FLOPs (``FlopCounterMode``) held to the formula,
  its block's share of the single-device forward's; at (4, 1) no
  collective runs over "model";
* where "model" does not divide a part's units, each rank computes its
  ceil block of them (the last ranks' blocks short or empty), as GSPMD
  pads: at (1, 4), reduced qwen1.5-32b with 5 heads (blocks 2, 2, 1, 0),
  granite with 6 heads over 2 kv heads (blocks of 2: rank 1's crosses a
  kv group), paligemma-3b with 2 heads over 1 kv head (1, 1, 0, 0),
  olmoe-1b-7b with 6 experts (2, 2, 2, 0) and mamba2-1.3b with 6 heads
  (d_model 48: 2, 2, 2, 0), each made by ``dataclasses.replace`` in both
  packages, against the JAX step; each rank's forward FLOPs held to its
  ceil block's formula;
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
MAMBA_ARCH = "mamba2-1.3b"
# the zero-initialised vector leaves of the families: the RMS norms' gains
# (stored as weight - 1), Mamba's conv biases and dt_bias, and qwen's key
# bias, whose gradient is zero in exact arithmetic (a key bias shifts each
# query's logits alike, and the softmax ignores the shift): its values are
# the optimizer's normalised updates of float noise alone
ZERO_INIT = ("final_norm", "norm_ffn", "norm_mixer", "out_norm", "conv_x_b",
             "conv_bc_b", "dt_bias", "bk")
STEPS = 3
ROWS, ODD_ROWS = 8, 6
MESHES = [(4, 1), (2, 2), (1, 4)]
# (optimizer, microbatches, compress_grads)
CASES = [("adamw", 1, False), ("adamw", 2, True), ("adafactor", 1, False)]
# the families split over "model" at (1, 4): (arch, token_groups, vocab);
# at (1, 4) the MoE routes the batch as one group (the FSDP extent)
SPLIT_CASES = [(MOE_ARCH, 1, None), (MAMBA_ARCH, None, None),
               (ARCH, None, 130)]
# the uneven splits at (1, 4): (arch, token_groups, fields replaced in both
# packages' reduced configs, each rank's block of the split part's units)
UNEVEN_CASES = [
    ("qwen1.5-32b", None, (("num_heads", 5), ("num_kv_heads", 5),
                           ("head_dim", 16)), (2, 2, 1, 0)),
    (ARCH, None, (("num_heads", 6), ("num_kv_heads", 2)), (2, 2, 2, 0)),
    ("paligemma-3b", None, (("num_heads", 2),), (1, 1, 0, 0)),
    (MOE_ARCH, 1, (("moe.num_experts", 6),), (2, 2, 2, 0)),
    (MAMBA_ARCH, None, (("d_model", 48),), (2, 2, 2, 0))]


def _uneven_id(case) -> str:
    arch, _, over, blocks = case
    fields = "-".join(f"{k.split('.')[-1]}{v}" for k, v in over)
    return f"{arch}-{fields}-blocks{''.join(map(str, blocks))}"


def _jax_run(arch, case, rows, token_groups=None, vocab=None, over=()):
    """The JAX package's initial state (plain numpy, no JAX classes), and
    after STEPS jitted single-device steps its metrics, parameters and
    residuals.  ``over``: fields replaced (``C.replace_fields``)."""
    name, micro, compress = case
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch),
                                   global_batch=rows)
    if token_groups is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, token_groups=token_groups))
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
    jcfg = C.replace_fields(jcfg, over)
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
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        refs = {(MOE_ARCH, CASES[0], ROWS): ex.submit(
            _jax_run, MOE_ARCH, CASES[0], ROWS, 2)}  # the slowest first
        for split in SPLIT_CASES:
            refs[split] = ex.submit(_jax_run, split[0], CASES[0], ROWS,
                                    *split[1:])
        for arch, groups, over, _ in UNEVEN_CASES:
            refs[arch, over] = ex.submit(_jax_run, arch, CASES[0], ROWS,
                                         groups, None, over)
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


_SINGLE = {}


def _single_params(ref, arch, case, rows, groups=None, vocab=None,
                   over=()) -> list:
    """The port's single-device step's parameters after STEPS steps from the
    JAX initial state of ``ref`` (numpy leaves, the JAX layout; each case
    run once)."""
    key = (arch, case, rows, groups, vocab, over)
    if key not in _SINGLE:
        cfg = C.config(arch, rows, groups, vocab, over)
        tc = C.train_config(*case)
        state = ttl.train_state_from_arrays(C._Plain(ref["plain"], case[0]),
                                            cfg, tc, device="cpu")
        step = ttl.make_train_step(cfg, tc)

        class Ctx:
            device = torch.device("cpu")

        for s in range(STEPS):
            state, _ = step(state, C.batch(Ctx, cfg, s))
        _SINGLE[key] = tree_leaves(C.param_tree(state.params))
    return _SINGLE[key]


def _check_params(outs, ref, single, split):
    """Every gathered parameter within STEP_TOL of its leaf's largest entry
    from the JAX step's and from the port's single-device step's
    (``single``).  Under a "model" split (``split``), the ZERO_INIT leaves
    are held to the single-device step alone: within twice the farthest
    that step is from the JAX step on any ZERO_INIT leaf, or STEP_TOL
    where that is larger.

    Such a leaf's values are the optimizer's normalised updates alone (each
    element's gradient over its own size), so an element whose gradient is
    small beside the leaf's largest moves by the float noise of its sums.
    The split reorders them, as the JAX step's XLA program orders them
    otherwise: the two float32 single-device steps already differ there by
    up to ~8e-6 of the largest entry (granite), ~1.8e-5 (olmoe) and ~6.3e-5
    (mamba2, whose chunked scan is the noisiest).  Every other leaf starts
    at its init's scale, which that noise does not reach."""
    got = tree_flatten_with_path(outs[0]["full"]["params"])
    want = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    init = jax.tree_util.tree_leaves(ref["plain"]["params"])
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    zero = [split and path.split("'")[-2] in ZERO_INIT for path, _ in got]
    noise = max([_rel(w, j) for z, w, (_, j) in zip(zero, single, want)
                 if z], default=0.0)
    for (path, g), (_, j), w, i, z in zip(got, want, single, init, zero):
        assert g.shape == np.shape(j) == np.shape(w), path
        if z:
            assert not np.any(i), path  # zero-initialised
            assert _rel(g, w) <= max(STEP_TOL, 2 * noise), (
                path, _rel(g, w), noise)
        else:
            assert _rel(g, j) <= STEP_TOL, (path, _rel(g, j))
            assert _rel(g, w) <= STEP_TOL, (path, _rel(g, w))


def _check_against_jax(outs, ref, compress, single, split):
    """Every rank's metrics and gathered leaves against the JAX run (the
    parameters by ``_check_params``)."""
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
    _check_params(outs, ref, single, split)
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
    _check_against_jax(outs, ref, case[2],
                       _single_params(ref, ARCH, case, ROWS), shape[1] > 1)
    if shape != (1, 4):  # the FSDP axis splits the matrices' rows
        assert outs[0]["bytes"][0] < outs[0]["bytes"][2] / 2
    traffic, by_axes = outs[0]["traffic"][0], outs[0]["traffic_axes"][0]
    assert traffic["all_gather"] > 0 and traffic["all_reduce"] > 0
    assert (("reduce_scatter", ("data",)) in by_axes) == (shape[0] > 1)
    # the vocabulary-parallel cross entropy's max over "model": 4 bytes a
    # token of the rank's rows; compression's block maxima come on top
    ce_max = 4 * 64 * ROWS // shape[0] if shape[1] > 1 else 0
    assert traffic.get("all_reduce_max", 0) >= ce_max
    assert (traffic.get("all_reduce_max", 0) > ce_max) == case[2]


def test_batch_that_does_not_divide_is_replicated(pool, jax_refs):
    """6 rows over a data axis of 4: every rank computes the whole batch,
    and the step still gives the single-device result."""
    ref = jax_refs[ARCH, CASES[0], ODD_ROWS].result()
    outs = pool.run(C.train, ARCH, (4, 1), *CASES[0], ODD_ROWS, ref["plain"],
                    STEPS)
    _check_against_jax(outs, ref, False,
                       _single_params(ref, ARCH, CASES[0], ODD_ROWS), False)


def test_moe_at_2x2_routes_as_the_reference_under_the_mesh(pool, jax_refs):
    """Reduced olmoe-1b-7b at (2, 2): two token groups (the mesh's data
    extent), each rank routing its own; the JAX single-device step with
    ``token_groups=2`` is the reference's routing under that mesh.  The
    metrics are held to STEP_TOL, the parameters by ``_check_params``: the
    compute splits over "model" (2 of 8 experts a rank), and the port's
    single-device MoE step itself is up to ~1.8e-5 of the stacked norms'
    largest entry from the JAX step's."""
    ref = jax_refs[MOE_ARCH, CASES[0], ROWS].result()
    outs = pool.run(C.train, MOE_ARCH, (2, 2), *CASES[0], ROWS, ref["plain"],
                    STEPS, 2)
    _check_against_jax(outs, ref, False,
                       _single_params(ref, MOE_ARCH, CASES[0], ROWS, 2), True)
    assert all(m["aux_loss"] > 0 for m in outs[0]["metrics"])


@pytest.mark.parametrize("split", SPLIT_CASES,
                         ids=lambda c: f"{c[0]}-vocab{c[2] or 128}")
def test_split_families_match_jax_single_device(pool, jax_refs, split):
    """At (1, 4) every rank computes its block over "model": olmoe's 2 of 8
    experts (one token group: the FSDP extent), mamba2's 2 of 8 heads with
    the gated norm's squares summed over the whole inner dim, granite's
    ceil block of a 130-token vocabulary (33, 33, 33, 31 rows of the tied
    embedding); three steps against the JAX single-device step.  The
    row-parallel weights and the experts arrive by all_to_all over
    "model", and nothing runs over "data".  The metrics are held to the
    JAX step at STEP_TOL, the parameters by ``_check_params``."""
    arch, groups, vocab = split
    ref = jax_refs[split].result()
    outs = pool.run(C.train, arch, (1, 4), *CASES[0], ROWS, ref["plain"],
                    STEPS, groups, None, None, vocab)
    _check_against_jax(outs, ref, False, _single_params(
        ref, arch, CASES[0], ROWS, groups, vocab), True)
    by_axes = outs[0]["traffic_axes"][0]
    assert by_axes[("all_to_all", ("model",))] > 0
    assert by_axes[("all_reduce_max", ("model",))] == 4 * 64 * ROWS
    assert all(axes == ("model",) for _, axes in by_axes)


@pytest.mark.parametrize("uneven", UNEVEN_CASES, ids=_uneven_id)
def test_uneven_splits_match_jax_single_device(pool, jax_refs, uneven):
    """At (1, 4) a part whose units "model" does not divide splits in ceil
    blocks: 5 q heads as 2, 2, 1, 0 (the kv projections computed whole,
    each rank reading its heads' kv heads); 6 heads over 2 kv heads as
    2, 2, 2, 0 (rank 1's heads 2 and 3 read kv heads 0 and 1, by index);
    2 heads over 1 kv head as 1, 1, 0, 0; 6 experts as 2, 2, 2, 0; 6 Mamba
    heads as 2, 2, 2, 0.  A rank with an empty block joins every
    collective with zeros.  Three steps against the JAX single-device
    step: the metrics at STEP_TOL, the parameters by ``_check_params``."""
    arch, groups, over, _ = uneven
    ref = jax_refs[arch, over].result()
    outs = pool.run(C.train, arch, (1, 4), *CASES[0], ROWS, ref["plain"],
                    STEPS, groups, None, None, None, over)
    _check_against_jax(outs, ref, False, _single_params(
        ref, arch, CASES[0], ROWS, groups, None, over), True)
    assert all(axes == ("model",) for _, axes in outs[0]["traffic_axes"][0])


def test_no_collective_over_model_at_4x1(pool):
    """At (4, 1) the split is off: every collective of a step runs over
    "data" (the storage-only step's); at (1, 4), over "model" alone."""
    for shape, axes in (((4, 1), ("data",)), ((1, 4), ("model",))):
        outs = pool.run(C.train, ARCH, shape, *CASES[0], ROWS, None, 1)
        for o in outs:
            assert o["traffic_axes"][0]
            assert {a for _, a in o["traffic_axes"][0]} == {axes}


def _block_flops(cfg, tokens: int, seq: int, m: int, j: int) -> int:
    """Matmul FLOPs of one rank's forward of reduced granite over ``tokens``
    tokens of ``seq``-token rows, on block ``j`` of a "model" split of
    ``m``: per layer its ceil block of the q heads (and the kv heads they
    read), their causal-square attention, ``wo``'s rows of them, its ceil
    block of the d_ff hidden units; then its ceil block of the
    vocabulary."""
    from repro_torch.launch.mesh import block_range
    d, hd = cfg.d_model, cfg.head_dim_eff
    hl, kv = _heads_read(cfg, m, j)
    lo, hi = block_range(cfg.d_ff, m, j)
    layer = (2 * tokens * d * hl * hd + 2 * 2 * tokens * d * kv * hd
             + 2 * 2 * tokens * seq * hl * hd + 2 * tokens * hl * hd * d
             + 3 * 2 * tokens * d * (hi - lo))
    lo, hi = block_range(cfg.vocab_size, m, j)
    return cfg.num_layers * layer + 2 * tokens * d * (hi - lo)


def _heads_read(cfg, m: int, j: int) -> tuple:
    """(q heads, kv heads they read) of rank ``j``'s ceil block of the q
    heads over ``m``: the kv heads' own block when ``m`` divides them."""
    from repro_torch.launch.mesh import block_range
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    lo, hi = block_range(h, m, j)
    if hkv % m == 0:
        return hi - lo, hkv // m
    group = h // hkv
    return hi - lo, (hi - 1) // group + 1 - lo // group if hi > lo else 0


def _split_units(cfg, tokens: int, seq: int, m: int, j: int) -> list:
    """(FLOPs a unit, the part's units, rank ``j``'s units of it) for every
    part a "model" split of ``m`` divides among its ranks, over the layers
    of one forward of ``tokens`` tokens of ``seq``-token rows: q heads, the
    kv heads they read, hidden units, experts on their capacity slots (one
    token group), Mamba heads and the vocabulary rows.  Every other matmul
    (the MoE's router and combine, Mamba's B/C projection, a frontend's
    projection) each rank computes whole."""
    from repro_torch.launch.mesh import block_range
    from repro_torch.models.model import layer_signature
    d, t = cfg.d_model, tokens
    mats = 3 if cfg.activation in ("silu", "geglu") else 2

    def ceil(n):
        lo, hi = block_range(n, m, j)
        return hi - lo

    out = []
    for i in range(cfg.num_layers):
        sig = layer_signature(cfg, i)
        if sig.mixer == "attn":
            hd = cfg.head_dim_eff
            hl, kv = _heads_read(cfg, m, j)
            out.append((2 * t * d * hd + 2 * 2 * t * seq * hd
                        + 2 * t * hd * d, cfg.num_heads, hl))
            out.append((2 * 2 * t * d * hd, cfg.num_kv_heads, kv))
        elif sig.mixer == "mamba":
            mc = cfg.mamba
            p, n, q = mc.head_dim, mc.d_state, min(mc.chunk_size, seq)
            heads = mc.expand * d // p
            out.append((2 * 2 * t * d * p + 2 * t * d + 2 * t * q * n
                        + 2 * t * q * p + 2 * 2 * t * n * p + 2 * t * p * d,
                        heads, ceil(heads)))
        if sig.ffn == "dense":
            out.append((mats * 2 * t * d, cfg.d_ff, ceil(cfg.d_ff)))
        elif sig.ffn == "moe":
            moe = cfg.moe
            e, f = moe.num_experts, moe.d_ff_expert
            capacity = max(1, int(moe.capacity_factor * t * moe.top_k / e))
            out.append((capacity * mats * 2 * d * f, e, ceil(e)))
    logit_rows = t
    if cfg.frontend == "vision_stub":
        logit_rows = t // seq * (seq - cfg.num_prefix_embeds)
    out.append((2 * logit_rows * d, cfg.vocab_size, ceil(cfg.vocab_size)))
    return out


def _check_rank_flops(pool, arch, shape, groups, over=()):
    """Each rank's matmul FLOPs of one microbatch's forward
    (``FlopCounterMode``) are the single-device forward's on its rows less
    the units of each split part that its ceil block leaves to the other
    ranks (``_split_units``); for granite, exactly ``_block_flops``.  A
    split that computed whole blocks would count the single-device
    forward's."""
    outs = pool.run(C.forward_flops, arch, shape, ROWS, groups, over)
    cfg = C.config(arch, ROWS, groups, over=over)
    m = shape[1]
    tokens = ROWS // shape[0] * 64
    single = outs[0]["single"]
    assert all(o["single"] == single for o in outs)
    if arch == ARCH and not over:
        assert single == _block_flops(cfg, tokens, 64, 1, 0)
    for o in outs:
        j = o["rank"] % m
        want = single - sum(per * (n - mine) for per, n, mine
                            in _split_units(cfg, tokens, 64, m, j))
        assert o["flops"] == want, (o["rank"], o["flops"], want, single)
        if arch == ARCH and not over:
            assert o["flops"] == _block_flops(cfg, tokens, 64, m, j)
        assert o["flops"] < single


@pytest.mark.parametrize("arch,shape,groups", [
    (ARCH, (2, 2), None), (ARCH, (1, 4), None), (MOE_ARCH, (1, 4), 1),
    (MAMBA_ARCH, (1, 4), None)], ids=lambda v: str(v))
def test_each_rank_computes_its_block_of_the_forward(pool, arch, shape,
                                                     groups):
    """The even splits: every rank's block the same size
    (``_check_rank_flops``)."""
    _check_rank_flops(pool, arch, shape, groups)


@pytest.mark.parametrize("uneven", UNEVEN_CASES, ids=_uneven_id)
def test_each_rank_computes_its_ceil_block_of_the_forward(pool, uneven):
    """The uneven splits at (1, 4): each rank's FLOPs are its ceil
    block's (``_check_rank_flops``), none for a rank whose block is
    empty."""
    arch, groups, over, _ = uneven
    _check_rank_flops(pool, arch, (1, 4), groups, over)
