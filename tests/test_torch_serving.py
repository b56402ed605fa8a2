"""The port's serving engine: greedy consistency, continuous batching,
backpressure, and token-for-token agreement with the JAX engine.

Mirrors ``tests/test_serving.py`` on the port (reduced granite-3-2b,
float32, on the CPU; reduced granite-3-2b-nfft for the NFFT twins; the
reduced MLA, MoE, Mamba and hybrid models against the manual loop), and
runs the JAX ``ServeEngine`` and the port's on
the same carried weights and seeded prompts: their tokens must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve, trace_serve
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServeEngine


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's tensors are small, and under pytest-xdist's parallel
    workers torch's OpenMP threads oversubscribe the cores, so its many
    small parallel operations stall.  One thread here; the caller's count
    back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("granite-3-2b"))
    return cfg, M.init_params(cfg, 3, device="cpu")


@pytest.fixture(scope="module")
def nfft_setup():
    """Reduced granite-3-2b-nfft: every layer an NFFT kernel attention
    block, whose (S, z) caches prefill fills by adding into the engine's
    slot views."""
    cfg = reduced_config(get_config("granite-3-2b-nfft"))
    return cfg, M.init_params(cfg, 3, device="cpu")


def _manual_greedy(cfg, model, prompt, n_new, max_seq):
    caches = M.init_caches(cfg, 1, max_seq, device="cpu")
    toks = torch.as_tensor(prompt)[None, :]
    logits, caches = model.forward_prefill({"tokens": toks}, caches)
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, caches = model.forward_decode(
            torch.as_tensor([[out[-1]]]), torch.as_tensor([pos]), caches)
        out.append(int(torch.argmax(logits[0, 0])))
        pos += 1
    return out


def _engine(cfg, model, **kw):
    return ServeEngine(cfg, model, device="cpu", **kw)


def test_engine_matches_manual_decode(setup):
    _engine_matches_manual_decode(*setup)


def test_nfft_engine_matches_manual_decode(nfft_setup):
    """The NFFT twin: a prefill that rebound its cache instead of adding
    into the slot's views would be lost, and decode would start from an
    empty (S, z)."""
    _engine_matches_manual_decode(*nfft_setup)


def _engine_matches_manual_decode(cfg, model):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 9))).tolist()
               for _ in range(3)]
    n_new = 6
    engine = _engine(cfg, model, slots=2, max_seq=64)
    reqs = [Request(uid=i, tokens=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    for r, p in zip(reqs, prompts):
        assert r.output == _manual_greedy(cfg, model, p, n_new, 64), r.uid


MIXERS = ["deepseek-v3-671b", "olmoe-1b-7b", "mamba2-1.3b",
          "jamba-1.5-large-398b"]


@pytest.mark.parametrize("name", MIXERS)
def test_mixer_engines_match_manual_decode(name):
    """MLA caches, Mamba conv buffers and states and the MoE blocks through
    the engine's slot views: prefill fills them in place, and recycled
    slots (zeroed at admission) keep nothing of their earlier tenant."""
    cfg = reduced_config(get_config(name))
    model = M.init_params(cfg, 3, device="cpu")
    _engine_matches_manual_decode(cfg, model)
    _recycled_slot_has_no_stale_cache(cfg, model)


def test_continuous_batching_recycles_slots(setup):
    cfg, model = setup
    engine = _engine(cfg, model, slots=2, max_seq=32)
    reqs = [Request(uid=i, tokens=[1, 2, 3], max_new_tokens=4)
            for i in range(5)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(len(r.output) == 4 for r in reqs)


def test_mixed_progress_batch(setup):
    """Requests admitted at different ticks share decode steps correctly."""
    cfg, model = setup
    engine = _engine(cfg, model, slots=2, max_seq=64)
    r1 = Request(uid=0, tokens=[5, 6, 7, 8], max_new_tokens=8)
    engine.submit(r1)
    engine.step()
    engine.step()  # r1 two tokens in
    r2 = Request(uid=1, tokens=[9, 10], max_new_tokens=8)
    engine.submit(r2)
    engine.run_until_drained()
    assert r1.done and r2.done
    assert r1.output == _manual_greedy(cfg, model, [5, 6, 7, 8], 8, 64)
    assert r2.output == _manual_greedy(cfg, model, [9, 10], 8, 64)


def test_recycled_slot_has_no_stale_cache(setup):
    """A short request admitted into a slot that held a longer one must not
    read the earlier tenant's KV rows: slots recycled at shrinking lengths
    agree exactly with unbatched decoding."""
    _recycled_slot_has_no_stale_cache(*setup)


def test_nfft_recycled_slot_has_no_stale_cache(nfft_setup):
    """The NFFT twin: the earlier tenant's (S, z) sums, which have no
    positions to mask, must be zeroed at admission."""
    _recycled_slot_has_no_stale_cache(*nfft_setup)


def _recycled_slot_has_no_stale_cache(cfg, model):
    rng = np.random.default_rng(4)
    specs = [(14, 10), (3, 4), (12, 8), (2, 3), (5, 6), (2, 8)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in specs]
    engine = _engine(cfg, model, slots=2, max_seq=64)
    reqs = [Request(uid=i, tokens=p, max_new_tokens=specs[i][1])
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    for r, p, (_, n_new) in zip(reqs, prompts, specs):
        assert r.done
        assert r.output == _manual_greedy(cfg, model, p, n_new, 64), r.uid


def test_backpressure_rejects_when_queue_full(setup):
    cfg, model = setup
    engine = _engine(cfg, model, slots=1, max_seq=32, max_queue=2)
    reqs = [Request(uid=i, tokens=[1, 2], max_new_tokens=2)
            for i in range(3)]
    assert [engine.submit(r) for r in reqs] == [True, True, False]
    assert reqs[2].done and reqs[2].error == "queue full (backpressure)"
    assert engine.backpressure_rejections == 1
    engine.run_until_drained()
    assert all(r.done and len(r.output) == 2 for r in reqs[:2])
    assert reqs[2].output == []


def test_engine_stops_at_max_seq(setup):
    cfg, model = setup
    engine = _engine(cfg, model, slots=1, max_seq=8)
    r = Request(uid=0, tokens=[1, 2, 3, 4], max_new_tokens=50)
    engine.submit(r)
    engine.run_until_drained()
    assert r.done and len(r.output) == 4  # positions 4..7 of max_seq 8


def test_engine_refuses_a_model_on_another_device(setup):
    cfg, model = setup
    with pytest.raises(ValueError, match="model on cpu"):
        ServeEngine(cfg, model, device="meta")


def test_port_engine_matches_jax_engine():
    """The JAX engine and the port's, on the same weights (carried by
    params_from_arrays) and the same seeded prompts, emit the same
    tokens, with slots recycled."""
    _port_engine_matches_jax_engine("granite-3-2b")


def test_port_engine_matches_jax_engine_nfft():
    """The same on granite-3-2b-nfft: the JAX engine writes each prefill's
    new NFFTCache back into the slot, the port's adds into its views."""
    _port_engine_matches_jax_engine("granite-3-2b-nfft")


def _port_engine_matches_jax_engine(arch):
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    cfg = reduced_config(get_config(arch))
    params = JM.init_params(jax.random.PRNGKey(11), jcfg)
    model = M.params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    rng = np.random.default_rng(8)
    specs = [(int(rng.integers(3, 15)), int(rng.integers(2, 9)))
             for _ in range(5)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in specs]
    jeng = JServeEngine(jcfg, params, slots=2, max_seq=48)
    teng = _engine(cfg, model, slots=2, max_seq=48)
    jreqs = [JRequest(uid=i, tokens=p, max_new_tokens=specs[i][1])
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, tokens=p, max_new_tokens=specs[i][1])
             for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_drained()
    teng.run_until_drained()
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert tr.output == jr.output, (tr.uid, tr.output, jr.output)


def test_serve_cli_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert "device=cpu" in out


def test_serve_cli_serves_the_nfft_arch_on_cpu(capsys):
    serve.main(["--arch", "granite-3-2b-nfft", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert "granite-3-2b-nfft-smoke" in out


def test_trace_serve_on_cpu():
    """The trace CLI counts the host's operations per layer; the CPU has no
    device timeline."""
    out = trace_serve.main(["--reduced", "--device", "cpu", "--prompt-len",
                            "24", "--max-seq", "48", "--reps", "1"])
    assert out["layers"] == reduced_config(get_config("granite-3-2b")) \
        .num_layers
    for what in ("prefill", "tick"):
        r = out[what]
        assert r["wall_ms"] > 0 and r["host_ops_per_layer"] > 1
        assert r["device_busy_ms"] is None and r["device_events"] == 0
