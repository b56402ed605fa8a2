"""The journaled serving registry of the PyTorch port against the JAX
package.

The port's models carry the JAX package's fits (same dual vectors, training
points, kernels and parameters), so both packages write the same journal
records byte for byte, and each package recovers a registry from the
other's journal.  The cases of tests/test_serving_journal.py run on the
port: a warm restart serves the pre-crash predictions within 1e-12 with
zero replans and one plan build, replay appends nothing, evictions replay,
a bit-flipped record or a torn last line is skipped and reported, a group
rebuild appends nothing, and a missing journal recovers empty.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FastsumParams as JParams
from repro.core import make_kernel as jmake_kernel
from repro.graph import krr_fit as jkrr_fit
from repro.serving import GraphServeEngine as JEngine
from repro.serving import PredictRequest as JRequest
from repro.serving import journal as jjournal
from repro_torch.core import FastsumParams as TParams
from repro_torch.core import make_kernel as tmake_kernel
from repro_torch.graph import krr as tkrr
from repro_torch.serving import (
    GraphModelRegistry, GraphServeEngine, PredictRequest, RegistryJournal,
    recover_registry,
)
from repro_torch.serving import journal as tjournal

TWIN = 1e-10  # port vs JAX engine, relative to the largest output


@pytest.fixture(scope="module")
def models():
    """{"jax": {...}, "torch": {...}}: tests/test_serving_journal.py's two
    tenants, fitted by the JAX package; the port's carry the same arrays."""
    rng = np.random.default_rng(11)
    xtr = rng.uniform(-3, 3, (150, 2))
    ytr = np.sign(rng.standard_normal(150))
    out = {"jax": {}, "torch": {}}
    pts = torch.as_tensor(xtr)
    for mid, sigma in (("a", 1.0), ("b", 1.5)):
        jm = jkrr_fit(jmake_kernel("gaussian", sigma=sigma),
                      jnp.asarray(xtr), jnp.asarray(ytr), 1e-2,
                      JParams(n_bandwidth=32, m=4))
        out["jax"][mid] = jm
        out["torch"][mid] = tkrr.KRRModel(
            alpha=torch.as_tensor(np.array(jm.alpha)), train_points=pts,
            kernel=tmake_kernel("gaussian", sigma=sigma),
            params=TParams(n_bandwidth=32, m=4),
            num_iters=torch.as_tensor(int(jm.num_iters), dtype=torch.int32),
            converged=torch.as_tensor(bool(jm.converged)), pred_cache={})
    return out


def _journaled_registry(tmp_path, models):
    jpath = str(tmp_path / "registry.journal")
    reg = GraphModelRegistry(journal=RegistryJournal(jpath))
    for mid, model in models["torch"].items():
        reg.register(mid, model)
    return reg, jpath


QUERIES = [(mid, np.random.default_rng(i).uniform(-2.5, 2.5, (40, 2)))
           for i, mid in enumerate(("a", "b", "a"))]


def _serve_all(registry, engine_cls=GraphServeEngine,
               request_cls=PredictRequest):
    engine = engine_cls(registry, slots=4, chunk=32)
    reqs = [request_cls(uid=i, model_id=mid, query_points=q)
            for i, (mid, q) in enumerate(QUERIES)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done and r.error is None for r in reqs), \
        [(r.uid, r.error) for r in reqs]
    return [np.asarray(r.output) for r in reqs], engine


def _lines(path):
    return open(path).read().splitlines()


def test_records_are_the_jax_packages(models):
    for mid in ("a", "b"):
        trec = tjournal.register_record(mid, models["torch"][mid],
                                        margin=0.75)
        jrec = jjournal.register_record(mid, models["jax"][mid], margin=0.75)
        assert trec == jrec
        assert tjournal.record_crc(trec) == jjournal.record_crc(jrec)
    assert tjournal.unregister_record("a") == jjournal.unregister_record("a")


def test_record_roundtrip(models):
    rec = tjournal.register_record("a", models["torch"]["a"], margin=0.75)
    rec["crc"] = tjournal.record_crc(rec)
    rt = json.loads(json.dumps(rec))
    assert tjournal.record_crc(rt) == rt["crc"]
    model, domain, margin = tjournal.decode_register(rt)
    assert torch.equal(model.alpha, models["torch"]["a"].alpha)
    assert torch.equal(model.train_points, models["torch"]["a"].train_points)
    assert model.kernel.name == "gaussian"
    assert float(model.kernel.params["sigma"]) == 1.0
    assert model.params == models["torch"]["a"].params
    assert domain is None and margin == 0.75


def test_warm_restart_identical_predictions(tmp_path, models):
    reg, jpath = _journaled_registry(tmp_path, models)
    before, _ = _serve_all(reg)
    reg2, report = recover_registry(jpath, device="cpu")
    assert report.clean, report.summary()
    assert report.tenants == {"a": "recovered", "b": "recovered"}
    after, engine = _serve_all(reg2)
    for b, a in zip(before, after):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert engine.counters["replans"] == 0
    assert reg2.stats()["plan_builds"] == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_recovers_the_others_journal(tmp_path, models, writer):
    """A journal written by either package recovers in both; the two
    recovered registries serve the same predictions."""
    jpath = str(tmp_path / "registry.journal")
    if writer == "jax":
        from repro.serving import GraphModelRegistry as JRegistry
        reg = JRegistry(journal=jjournal.RegistryJournal(jpath))
        for mid, model in models["jax"].items():
            reg.register(mid, model)
        reg._journal.close()
    else:
        _, jpath = _journaled_registry(tmp_path, models)
    treg, treport = recover_registry(jpath, device="cpu")
    jreg, jreport = jjournal.recover_registry(jpath)
    assert treport.clean and jreport.clean
    assert treport.tenants == jreport.tenants
    tout, _ = _serve_all(treg)
    jout, _ = _serve_all(jreg, JEngine, JRequest)
    for t, j in zip(tout, jout):
        assert np.abs(t - j).max() <= TWIN * np.abs(j).max()


def test_recovery_replay_appends_nothing(tmp_path, models):
    _, jpath = _journaled_registry(tmp_path, models)
    n_lines = len(_lines(jpath))
    reg2, _ = recover_registry(jpath, device="cpu")
    assert len(_lines(jpath)) == n_lines
    reg2.register("a2", models["torch"]["a"])  # continues the journal
    assert len(_lines(jpath)) == n_lines + 1


def test_eviction_is_journaled_and_replayed(tmp_path, models):
    reg, jpath = _journaled_registry(tmp_path, models)
    assert reg.unregister("a")
    assert not reg.unregister("nope")
    assert reg.model_ids() == ["b"]
    assert len(_lines(jpath)) == 3  # two registrations, one eviction
    reg2, report = recover_registry(jpath, device="cpu")
    assert reg2.model_ids() == ["b"]
    assert report.tenants == {"a": "evicted", "b": "recovered"}


def test_corrupt_record_detected_skipped_surfaced(tmp_path, models):
    _, jpath = _journaled_registry(tmp_path, models)
    lines = _lines(jpath)
    bad = lines[0].replace('"op":"register"', '"op":"registeR"', 1)
    with open(jpath, "w") as fh:
        fh.write("\n".join([bad] + lines[1:]) + "\n")
    reg, report = recover_registry(jpath, device="cpu")
    assert not report.clean
    assert report.records_skipped == 1
    assert any("checksum mismatch" in reason for _, reason in report.corrupt)
    assert reg.model_ids() == ["b"]
    assert "[DEGRADED]" in report.summary()


def test_torn_final_line_skipped(tmp_path, models):
    _, jpath = _journaled_registry(tmp_path, models)
    with open(jpath, "a") as fh:
        fh.write('{"op":"register","model_id":"half')  # torn, no newline
    reg, report = recover_registry(jpath, device="cpu")
    assert sorted(reg.model_ids()) == ["a", "b"]
    assert report.records_skipped == 1
    assert any("unparseable" in reason for _, reason in report.corrupt)


def test_rebuild_group_appends_no_duplicate_records(tmp_path, models):
    reg, jpath = _journaled_registry(tmp_path, models)
    n_lines = len(_lines(jpath))
    assert reg.rebuild_group("a")
    assert len(_lines(jpath)) == n_lines


def test_missing_journal_recovers_empty(tmp_path):
    reg, report = recover_registry(str(tmp_path / "absent.journal"),
                                   device="cpu")
    assert reg.model_ids() == []
    assert report.records_total == 0 and report.clean


def test_recovery_runs_on_the_card_unless_asked(tmp_path, models):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default is exercised "
                    "by chip_smoke.py")
    _, jpath = _journaled_registry(tmp_path, models)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        recover_registry(jpath)
