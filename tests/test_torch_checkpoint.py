"""Checkpoints and the fault-tolerant step loop of the PyTorch port.

The port writes the JAX package's on-disk format: each package restores a
dict tree the other wrote, and the manifests are equal key for key.  The
cases of tests/test_checkpoint.py follow (round trip, GC, ``.tmp`` dirs,
async save, the straggler timer, leaf checks, corruption and its fallback,
the orphan sweep, the multi-process layout), with ``run_resilient`` driving
a toy torch step, and the port's LM train step as that file drives the
JAX one: a kill-and-resume bitwise equal to the uninterrupted run.
"""

import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_loop import (
    SpentStateError, TrainConfig, init_train_state, make_train_step)
from repro_torch.tree import tree_map
from repro_torch.training.fault_tolerance import (
    InjectedFault, StepTimer, run_resilient)


def _tiny_state():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "step": torch.tensor(7)}


def _jax_state():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": {"c": jnp.asarray([1, 2, 3], jnp.int32)},
            "step": jnp.asarray(7, jnp.int64)}


def _leaves_equal(a, b):
    la, lb = ckpt.tree_leaves(a), ckpt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _step_dir(tmp_path, step):
    return tmp_path / f"step_{step:08d}"


# -- the JAX package's format -------------------------------------------------

def test_each_package_restores_what_the_other_wrote(tmp_path):
    ckpt.save_checkpoint(str(tmp_path / "t"), 3, _tiny_state())
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, _jax_state())
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        _jax_state())
    from_port = jckpt.restore_checkpoint(str(tmp_path / "t"), 3, like)
    from_jax = ckpt.restore_checkpoint(str(tmp_path / "j"), 3,
                                       _tiny_state())
    _leaves_equal(jax.tree_util.tree_leaves(from_port),
                  ckpt.tree_leaves(_tiny_state()))
    _leaves_equal(from_jax, _tiny_state())
    assert isinstance(from_jax["b"]["c"], torch.Tensor)
    manifests = [json.load(open(tmp_path / k / "step_00000003" /
                                "manifest.json")) for k in ("t", "j")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["paths"] == ["['a']", "['b']['c']", "['step']"]
    for i in range(3):
        assert ((tmp_path / "t" / "step_00000003" / f"leaf_{i}.npy")
                .read_bytes() == (tmp_path / "j" / "step_00000003" /
                                  f"leaf_{i}.npy").read_bytes())


def test_bfloat16_leaves_on_disk_as_the_jax_package_writes_them(tmp_path):
    """numpy has no bfloat16: the JAX package's np.save of an ml_dtypes
    array writes 2-byte voids and its manifest says "bfloat16".  The port
    writes the same array bytes and manifest, and restores both packages'
    files into bfloat16 tensors bit for bit (the JAX package's own
    restore rejects them: it expects the dtype bfloat16 and loads a
    void)."""
    vals = torch.tensor([[1.0, -2.5, 3.0e-3], [7.0, 0.0, -1e4]])
    ckpt.save_checkpoint(str(tmp_path / "t"), 1,
                         {"w": vals.to(torch.bfloat16)})
    jckpt.save_checkpoint(str(tmp_path / "j"), 1,
                          {"w": jnp.asarray(vals.numpy(), jnp.bfloat16)})
    manifests = [json.load(open(tmp_path / k / "step_00000001" /
                                "manifest.json")) for k in ("t", "j")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["dtypes"] == ["bfloat16"]
    # the same bytes; the header spells the void "|V2" where ml_dtypes
    # spells it "<V2", and both load as 2-byte voids
    files = [np.load(tmp_path / k / "step_00000001" / "leaf_0.npy")
             for k in ("t", "j")]
    assert files[0].dtype == files[1].dtype == np.dtype("V2")
    assert files[0].tobytes() == files[1].tobytes()
    like = {"w": torch.zeros((2, 3), dtype=torch.bfloat16)}
    for k in ("t", "j"):
        got = ckpt.restore_checkpoint(str(tmp_path / k), 1, like)["w"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, vals.to(torch.bfloat16))


def test_paths_spell_namedtuples_lists_and_none_as_jax_does():
    from repro_torch.core.solvers import SolveHealth
    tree = {"h": SolveHealth(*(torch.zeros(2),) * 4), "l": [1, (2.0, None)],
            "n": None}
    paths = [p for p, _ in ckpt.tree_flatten_with_path(tree)]
    jtree = {"h": SolveHealth(*(jnp.zeros(2),) * 4), "l": [1, (2.0, None)],
             "n": None}
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert paths == jpaths
    back = ckpt.tree_unflatten(tree, ckpt.tree_leaves(tree))
    assert type(back["h"]) is SolveHealth and back["l"][1][1] is None


def test_tree_helpers_never_write_into_a_module(tmp_path):
    """A module flattens as its parameters by name; tree_map builds a
    dict of new leaves and leaves the module as it was, and only the
    checkpoint's restore writes into a module, in place."""
    lin = torch.nn.Linear(3, 2)
    before = {k: v.detach().clone() for k, v in lin.named_parameters()}
    zeroed = tree_map(torch.zeros_like, {"m": lin, "s": torch.ones(())})
    assert sorted(zeroed["m"]) == ["bias", "weight"]
    assert all(torch.equal(t, torch.zeros_like(t))
               for t in zeroed["m"].values())
    for k, v in lin.named_parameters():
        assert torch.equal(v.detach(), before[k])
    ckpt.save_checkpoint(str(tmp_path), 1, zeroed)
    weight = lin.weight
    back = ckpt.restore_checkpoint(str(tmp_path), 1,
                                   {"m": lin, "s": torch.ones(())})
    assert back["m"] is lin and lin.weight is weight
    assert float(lin.weight.detach().abs().sum()
                 + lin.bias.detach().abs().sum()) == 0.0


def test_restored_tensors_land_on_the_like_leaves_device(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, _tiny_state())
    got = ckpt.restore_checkpoint(str(tmp_path), 1,
                                  {"a": np.zeros((2, 3), np.float32),
                                   "b": {"c": torch.zeros(3, dtype=torch.int32)},
                                   "step": 0})
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in ckpt.tree_leaves(got))
    _leaves_equal(got, _tiny_state())


# -- tests/test_checkpoint.py -------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    state = _tiny_state()
    ckpt.save_checkpoint(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    _leaves_equal(ckpt.restore_checkpoint(str(tmp_path), 7, state), state)


def test_garbage_collection(tmp_path):
    state = _tiny_state()
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(str(tmp_path), s, state, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]


def test_tmp_dirs_ignored(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 3, _tiny_state())
    os.makedirs(tmp_path / "step_00000009.tmp")  # simulated torn write
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_async_save(tmp_path):
    t = ckpt.save_checkpoint(str(tmp_path), 11, _tiny_state(),
                             blocking=False)
    t.join()
    assert ckpt.latest_step(str(tmp_path)) == 11
    assert t.seconds > 0.0


def test_step_timer_flags_stragglers():
    t = StepTimer(warmup=2, threshold_sigmas=3.0)
    flagged = [t.observe(dt) for dt in
               [1.0, 1.0, 1.05, 0.95, 1.02, 0.98, 1.03, 5.0, 1.0]]
    assert flagged[7] is True
    assert sum(flagged) == 1


@pytest.mark.parametrize("change,match", [
    ("dtype", r"\['b'\]\['c'\].*dtype"), ("shape", r"\['a'\].*shape"),
    ("path", "tree path"), ("count", "leaves")])
def test_restore_rejects_a_drifted_tree(tmp_path, change, match):
    state = _tiny_state()
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    like = _tiny_state()
    if change == "dtype":
        like["b"]["c"] = torch.zeros(3, dtype=torch.float64)
    elif change == "shape":
        like["a"] = torch.zeros((3, 2), dtype=torch.float32)
    elif change == "path":
        like["b"] = {"renamed": like["b"]["c"]}
    else:
        like = {"a": like["a"]}
    with pytest.raises(ckpt.CheckpointError, match=match):
        ckpt.restore_checkpoint(str(tmp_path), 1, like)


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "delete_leaf",
                                    "delete_manifest"])
def test_corruption_recovers_previous_step(tmp_path, damage):
    state = _tiny_state()
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    state2 = {"a": state["a"] + 1, "b": {"c": state["b"]["c"] + 1},
              "step": state["step"] + 1}
    ckpt.save_checkpoint(str(tmp_path), 2, state2)
    leaf = _step_dir(tmp_path, 2) / "leaf_0.npy"
    if damage == "truncate":
        raw = leaf.read_bytes()
        leaf.write_bytes(raw[:len(raw) // 2])
    elif damage == "bitflip":
        raw = bytearray(leaf.read_bytes())
        raw[-1] ^= 0x40
        leaf.write_bytes(bytes(raw))
    elif damage == "delete_leaf":
        os.remove(leaf)
    else:
        os.remove(_step_dir(tmp_path, 2) / "manifest.json")
    if damage == "delete_manifest":
        assert ckpt.latest_step(str(tmp_path)) == 1
    else:
        with pytest.raises(ckpt.CheckpointError):
            ckpt.restore_checkpoint(str(tmp_path), 2, state)
    step, restored = ckpt.restore_latest_valid(str(tmp_path), state)
    assert step == 1
    _leaves_equal(restored, state)


def test_bitflip_raises_corruption_error_naming_leaf(tmp_path):
    state = _tiny_state()
    ckpt.save_checkpoint(str(tmp_path), 5, state)
    leaf = _step_dir(tmp_path, 5) / "leaf_1.npy"  # ['b']['c']
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0x01
    leaf.write_bytes(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorruptionError,
                       match=r"\['b'\]\['c'\].*CRC32"):
        ckpt.restore_checkpoint(str(tmp_path), 5, state)


def test_all_steps_corrupt_returns_none(tmp_path):
    state = _tiny_state()
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    os.remove(_step_dir(tmp_path, 1) / "leaf_0.npy")
    assert ckpt.restore_latest_valid(str(tmp_path), state) == (None, None)


def test_killed_writer_orphan_swept_by_next_save(tmp_path, monkeypatch):
    state = _tiny_state()
    calls = {"n": 0}
    real_save = np.save

    def dying_save(path, arr, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("simulated writer death mid-flight")
        return real_save(path, arr, *a, **k)

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(OSError, match="mid-flight"):
        ckpt.save_checkpoint(str(tmp_path), 1, state)
    monkeypatch.setattr(np, "save", real_save)
    orphans = [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert orphans == ["step_00000001.tmp"]
    assert ckpt.latest_step(str(tmp_path)) is None
    old = time.time() - 2 * ckpt.TMP_SWEEP_TTL_S
    os.utime(tmp_path / orphans[0], (old, old))
    ckpt.save_checkpoint(str(tmp_path), 2, state)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_young_tmp_of_live_writer_not_swept(tmp_path):
    state = _tiny_state()
    live = tmp_path / "step_00000009.tmp"
    os.makedirs(live)
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    assert live.is_dir()
    for s in (2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), s, state, keep=2)
    assert live.is_dir()


def test_multihost_sharded_save_restores_identically(tmp_path):
    """Two writers (leaves {0, 2} and {1}); process 0 merges and publishes,
    and the JAX package restores the step too."""
    state = _tiny_state()
    t1 = ckpt.save_checkpoint(str(tmp_path), 3, state, blocking=False,
                              process_index=1, process_count=2)
    t0 = ckpt.save_checkpoint(str(tmp_path), 3, state, blocking=False,
                              process_index=0, process_count=2)
    t0.join()
    t1.join()
    assert ckpt.latest_step(str(tmp_path)) == 3
    manifest = json.load(open(_step_dir(tmp_path, 3) / "manifest.json"))
    assert manifest["process_count"] == 2
    assert len(manifest["crc32"]) == 3
    _leaves_equal(ckpt.restore_checkpoint(str(tmp_path), 3, state), state)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        _jax_state())
    _leaves_equal(jax.tree_util.tree_leaves(
        jckpt.restore_checkpoint(str(tmp_path), 3, like)),
        ckpt.tree_leaves(state))


def test_multihost_barrier_times_out_without_peer(tmp_path):
    with pytest.raises(ckpt.CheckpointError, match="barrier timed out"):
        ckpt.save_checkpoint(str(tmp_path), 1, _tiny_state(),
                             process_index=0, process_count=2,
                             barrier_timeout_s=0.2)
    assert ckpt.latest_step(str(tmp_path)) is None


# -- run_resilient on a toy torch step ----------------------------------------

def _toy_step(state, batch):
    """A deterministic step: x <- x + tanh(W x) * batch, W fixed."""
    w = torch.linspace(-1.0, 1.0, 16, dtype=torch.float64).reshape(4, 4)
    x = state["x"] + torch.tanh(w @ state["x"]) * batch
    return ({"x": x, "step": state["step"] + 1},
            {"loss": (x * x).sum()})


def _toy_batch(s):
    return torch.full((4,), 0.1 * (s + 1), dtype=torch.float64)


def _toy_state():
    return {"x": torch.ones(4, dtype=torch.float64),
            "step": torch.tensor(0, dtype=torch.int32)}


def test_resilient_resume_bit_identical(tmp_path):
    ref_state, ref_info = run_resilient(
        _toy_step, _toy_state(), _toy_batch, total_steps=6,
        ckpt_dir=str(tmp_path / "ref"), ckpt_every=2, log_every=100)
    fired = {"done": False}

    def fault_hook(s):
        if s == 4 and not fired["done"]:
            fired["done"] = True
            raise InjectedFault("simulated node failure")

    state, info = run_resilient(
        _toy_step, _toy_state(), _toy_batch, total_steps=6,
        ckpt_dir=str(tmp_path / "ft"), ckpt_every=2, fault_hook=fault_hook,
        log_every=100)
    assert info["restarts"] == 1
    assert torch.equal(info["final_metrics"]["loss"],
                       ref_info["final_metrics"]["loss"])
    _leaves_equal(state, ref_state)
    assert int(state["step"]) == 6


def test_fault_before_first_checkpoint_restarts_from_initial(tmp_path):
    state0 = {"x": torch.zeros(4, dtype=torch.float32)}

    def train_step(state, batch):
        return {"x": state["x"] + batch}, {"loss": batch.sum()}

    batch_fn = lambda s: torch.full((4,), float(s), dtype=torch.float32)
    fired = {"n": 0}

    def fault_hook(s):
        if s == 1 and fired["n"] < 2:  # ckpt_every=5: no checkpoint yet
            fired["n"] += 1
            raise InjectedFault("fault before first checkpoint")

    state, info = run_resilient(
        train_step, state0, batch_fn, total_steps=4, ckpt_dir=str(tmp_path),
        ckpt_every=5, fault_hook=fault_hook, log_every=100)
    assert info["restarts"] == 2
    np.testing.assert_allclose(state["x"].numpy(),
                               np.full((4,), float(sum(range(4)))))

    def always_fault(s):
        raise InjectedFault("always")

    with pytest.raises(InjectedFault):
        run_resilient(train_step, state0, batch_fn, total_steps=4,
                      ckpt_dir=str(tmp_path / "cap"), ckpt_every=5,
                      max_restarts=2, fault_hook=always_fault,
                      log_every=100)


def test_run_without_checkpoints_replays_from_the_initial_state(tmp_path):
    """``ckpt_dir=None``: nothing is written, and a fault replays from the
    caller's initial state."""
    state0 = {"x": torch.zeros(4, dtype=torch.float32)}

    def train_step(state, batch):
        return {"x": state["x"] + batch}, {"loss": batch.sum()}

    fired = {"n": 0}

    def fault_hook(s):
        if s == 3 and fired["n"] == 0:
            fired["n"] += 1
            raise InjectedFault("fault without checkpoints")

    state, info = run_resilient(
        train_step, state0, lambda s: torch.full((4,), float(s)),
        total_steps=5, ckpt_dir=None, ckpt_every=1, fault_hook=fault_hook,
        log_every=100)
    assert info["restarts"] == 1 and info["steps"] == 5
    np.testing.assert_allclose(state["x"].numpy(), np.full((4,), 10.0))
    assert list(tmp_path.iterdir()) == []


def test_straggler_detection_across_restore_and_replay(tmp_path):
    state0 = {"x": torch.zeros(4, dtype=torch.float32),
              "step": torch.tensor(0, dtype=torch.int32)}

    def train_step(state, batch):
        return ({"x": state["x"] + batch, "step": state["step"] + 1},
                {"loss": batch.sum()})

    def batch_fn(s):  # runs inside the timed step
        time.sleep(0.30 if s == 5 else 0.01)
        return torch.full((4,), float(s), dtype=torch.float32)

    fired = {"done": False}

    def fault_hook(s):
        if s == 4 and not fired["done"]:
            fired["done"] = True
            raise InjectedFault("simulated node failure")

    flagged = []
    state, info = run_resilient(
        train_step, state0, batch_fn, total_steps=8,
        ckpt_dir=str(tmp_path / "strag"), ckpt_every=2,
        fault_hook=fault_hook, log_every=100,
        on_straggler=lambda s, dt: flagged.append((s, dt)))
    assert info["restarts"] == 1
    assert any(s == 5 and dt > 0.25 for s, dt in flagged), flagged
    assert all(s == 5 for s, dt in flagged), flagged
    assert int(state["step"]) == 8
    np.testing.assert_allclose(state["x"].numpy(),
                               np.full((4,), float(sum(range(8)))))


def _lm_state_and_step(cfg, tc):
    """A fresh seeded train state (the step updates its state in place, so
    each run starts from its own) and the step."""
    return (init_train_state(cfg, tc, 0, device="cpu"),
            make_train_step(cfg, tc))


def test_lm_resilient_resume_bit_identical(tmp_path):
    """The LM twin of tests/test_checkpoint.py::
    test_resilient_resume_bit_identical: reduced granite-3-2b, a fault at
    step 4 after the checkpoint at 2; the final loss and every parameter,
    optimizer leaf and the step equal the uninterrupted run's, bit for
    bit."""
    cfg = reduced_config(get_config("granite-3-2b"))
    tc = TrainConfig(num_microbatches=1)
    batch_fn = lambda s: {k: torch.from_numpy(v) for k, v in
                          batch_for_step(cfg, cfg.shapes[0], s).items()}
    state0, step = _lm_state_and_step(cfg, tc)
    ref_state, ref_info = run_resilient(
        step, state0, batch_fn, total_steps=6,
        ckpt_dir=str(tmp_path / "ref"), ckpt_every=2, log_every=100)
    fired = {"done": False}

    def fault_hook(s):
        if s == 4 and not fired["done"]:
            fired["done"] = True
            raise InjectedFault("simulated node failure")

    state1, step = _lm_state_and_step(cfg, tc)
    state, info = run_resilient(
        step, state1, batch_fn, total_steps=6,
        ckpt_dir=str(tmp_path / "ft"), ckpt_every=2, fault_hook=fault_hook,
        log_every=100)
    assert info["restarts"] == 1 and info["steps"] == 6
    assert torch.equal(info["final_metrics"]["loss"],
                       ref_info["final_metrics"]["loss"])
    assert state.params is state1.params  # restored into the model
    paths = [p for p, _ in ckpt.tree_flatten_with_path(state)]
    assert ".params['blocks.0.attn.wq']" in paths
    assert ".opt_state.master['stack'][0]['attn']['wq']" in paths
    for a, b in zip(ckpt.tree_leaves(state), ckpt.tree_leaves(ref_state)):
        assert torch.equal(a, b)
    assert int(state.step) == 6


def _lm_replay_setup():
    cfg = reduced_config(get_config("granite-3-2b"))
    batch_fn = lambda s: {k: torch.from_numpy(v) for k, v in
                          batch_for_step(cfg, cfg.shapes[0], s).items()}
    return cfg, TrainConfig(num_microbatches=1), batch_fn


@functools.lru_cache(maxsize=None)
def _lm_uninterrupted(total_steps: int):
    """The uninterrupted run the replay cases end equal to, run once."""
    cfg, tc, batch_fn = _lm_replay_setup()
    state0, step = _lm_state_and_step(cfg, tc)
    state, info = run_resilient(step, state0, batch_fn,
                                total_steps=total_steps, ckpt_dir=None,
                                log_every=100)
    assert info["restarts"] == 0
    return state, info


@pytest.mark.parametrize("with_dir, faults", [(True, 1), (False, 1),
                                              (True, 2)],
                         ids=["before_first_checkpoint", "no_checkpoints",
                              "twice_before_first_checkpoint"])
def test_lm_fault_before_first_checkpoint_replays_from_initial(
        tmp_path, with_dir, faults):
    """The LM twin of tests/test_checkpoint.py::
    test_fault_before_first_checkpoint_restarts_from_initial.  The step
    updates its state in place, so the replay target is a step-0
    checkpoint (``ckpt_dir`` given) or a host copy of the initial state
    (``ckpt_dir=None``): a fault (once, or twice) before the first
    periodic checkpoint replays from step 0, and every leaf of the final
    state equals the uninterrupted run's, bit for bit."""
    cfg, tc, batch_fn = _lm_replay_setup()
    ref_state, ref_info = _lm_uninterrupted(3)
    fired = {"n": 0}

    def fault_hook(s):
        if s == 2 and fired["n"] < faults:  # ckpt_every=5: none yet
            fired["n"] += 1
            raise InjectedFault("fault before first checkpoint")

    state1, step = _lm_state_and_step(cfg, tc)
    state, info = run_resilient(
        step, state1, batch_fn, total_steps=3,
        ckpt_dir=str(tmp_path) if with_dir else None, ckpt_every=5,
        fault_hook=fault_hook, log_every=100)
    assert fired["n"] == faults and info["restarts"] == faults
    assert info["steps"] == 3 and int(state.step) == 3
    assert state.params is state1.params  # replayed into the same model
    assert torch.equal(info["final_metrics"]["loss"],
                       ref_info["final_metrics"]["loss"])
    for a, b in zip(ckpt.tree_leaves(state), ckpt.tree_leaves(ref_state)):
        assert torch.equal(a, b)
    if with_dir:
        assert ckpt.all_steps(str(tmp_path)) == [0, 3]
        assert info["initial_copy"] is None
    else:
        assert list(tmp_path.iterdir()) == []
        copied = info["initial_copy"]
        assert copied["bytes"] == sum(t.numel() * t.element_size()
                                      for t in ckpt.tree_leaves(state))
        assert copied["seconds"] >= 0.0


def test_lm_step_refuses_a_spent_state_and_takes_a_restored_one(tmp_path):
    """Stepping the state a step was already given raises; a state
    restored from a checkpoint into the same model steps on."""
    cfg = reduced_config(get_config("granite-3-2b"))
    tc = TrainConfig(num_microbatches=1)
    batch = {k: torch.from_numpy(v) for k, v in
             batch_for_step(cfg, cfg.shapes[0], 0).items()}
    state0, step = _lm_state_and_step(cfg, tc)
    ckpt.save_checkpoint(str(tmp_path), 0, state0)
    state1, _ = step(state0, batch)
    with pytest.raises(SpentStateError):
        step(state0, batch)
    restored = ckpt.restore_checkpoint(str(tmp_path), 0, state1)
    assert restored.params is state0.params and int(restored.step) == 0
    state2, _ = step(restored, batch)
    assert int(state2.step) == 1
