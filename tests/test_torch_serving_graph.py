"""The graph-predict serving tier of the PyTorch port against the JAX package.

Every test of tests/test_serving_graph.py, and the guard tests of
tests/test_chaos.py that need no fault-injection module (grids poisoned
and plans corrupted by hand instead), run the same request stream through
the JAX engine (``repro.serving``, XLA window backend, CPU, x64) and the
port's (``repro_torch.serving``, CPU).  The port's models carry the JAX
models' dual vectors, so both engines serve the same functions: their
outputs agree within 1e-10 of the largest output, their registry and
engine counters are equal, and the port's outputs are held against the
dense oracle within tests/test_serving_graph.py's 1e-3 (the NFFT error at
n=300, d=2, N=64 is ~1e-4).  The durability and fault-injection seams
follow: each package's ``TickChaos`` (dropped ticks, poisoned grids, a
corrupted plan) through its own engine, and the journal's records.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FastsumParams as JParams
from repro.core import make_kernel as jmake_kernel
from repro.graph import krr_fit as jkrr_fit
from repro.runtime import faultinject as jfi
from repro.serving import graph as jgraph
from repro_torch.core import FastsumParams as TParams
from repro_torch.core import make_kernel as tmake_kernel
from repro_torch.graph import krr as tkrr
from repro_torch.runtime import faultinject as tfi
from repro_torch.serving import graph as tgraph

TOL = 1e-3  # NFFT prediction error at these settings is ~1e-4
TWIN = 1e-10  # port vs JAX engine, relative to the largest output
PKGS = {"jax": jgraph, "torch": tgraph}


@pytest.fixture(scope="module")
def models():
    """{package: {model id: model}}: tests/test_serving_graph.py's three
    tenants (two sharing train points, one on its own), fitted by the JAX
    package; the port's models carry the same dual vectors."""
    rng = np.random.default_rng(11)
    xtr = rng.uniform(-3, 3, (300, 2))
    ytr = np.sign(rng.standard_normal(300))
    xtr2 = rng.uniform(-3, 3, (200, 2))
    ytr2 = np.sign(rng.standard_normal(200))
    specs = {"a": (xtr, ytr, 1.0), "b": (xtr, ytr, 1.5),
             "c": (xtr2, ytr2, 1.2)}
    out = {"jax": {}, "torch": {}}
    train = {}
    for mid, (x, y, sigma) in specs.items():
        jm = jkrr_fit(jmake_kernel("gaussian", sigma=sigma), jnp.asarray(x),
                      jnp.asarray(y), 1e-2, JParams(n_bandwidth=64, m=4))
        out["jax"][mid] = jm
        pts = train.setdefault(id(x), torch.as_tensor(x))
        out["torch"][mid] = tkrr.KRRModel(
            alpha=torch.as_tensor(np.array(jm.alpha)), train_points=pts,
            kernel=tmake_kernel("gaussian", sigma=sigma),
            params=TParams(n_bandwidth=64, m=4),
            num_iters=torch.as_tensor(int(jm.num_iters)),
            converged=torch.as_tensor(bool(jm.converged)), pred_cache={})
    return out


def _registry(pkg, models, ids=("a", "b", "c")):
    reg = PKGS[pkg].GraphModelRegistry()
    for mid in ids:
        reg.register(mid, models[pkg][mid])
    return reg


def _submit(pkg, engine, uid, mid, q, rhs=None, deadline_s=None):
    req = PKGS[pkg].PredictRequest(
        uid=uid, model_id=mid, query_points=np.asarray(q),
        rhs=None if rhs is None else np.asarray(rhs), deadline_s=deadline_s)
    engine.submit(req)
    return req


def _oracle(models, mid, q, rhs=None):
    model = models["torch"][mid]
    if rhs is not None:
        model = model._replace(alpha=torch.as_tensor(rhs))
    return tkrr.krr_predict_direct(model, np.asarray(q)).numpy()


def _poison_grids(registry, model_id, *, frac=0.5, seed=1) -> int:
    """NaN a seeded share of every cached grid of ``model_id`` (by hand,
    as repro.runtime.faultinject.poison_registry_grids does)."""
    group = registry.group_of(model_id)
    poisoned = 0
    with registry._lock:
        for key in list(group.grids):
            if key[0] != model_id:
                continue
            grid = group.grids[key]
            mask = np.random.default_rng(seed + poisoned).random(
                tuple(grid.shape)) < frac
            if isinstance(grid, torch.Tensor):
                group.grids[key] = torch.where(
                    torch.as_tensor(mask), float("nan"), grid)
            else:
                group.grids[key] = jnp.where(mask, jnp.nan, grid)
            poisoned += 1
    return poisoned


def _corrupt_plan(registry, model_id, shift_by=10.0) -> None:
    """Shift a group's frozen plan and its sources out of the admissible
    ball (by hand, as faultinject.corrupt_group_plan does)."""
    group = registry.group_of(model_id)
    with registry._lock:
        pred = group.pred
        group.pred = dataclasses.replace(
            pred, shift=pred.shift + shift_by,
            scaled_src=pred.scaled_src + 2.0 * pred.radius)


def _twin(scenario, models):
    """Run ``scenario(pkg, models)`` -> (requests, engine, registry) for
    both packages; check outputs and errors agree and counters are
    equal.  Returns the port's run."""
    runs = {pkg: scenario(pkg, models) for pkg in PKGS}
    (jreqs, jeng, jreg), (treqs, teng, treg) = runs["jax"], runs["torch"]
    assert len(jreqs) == len(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert (jr.uid, jr.done, jr.error) == (tr.uid, tr.done, tr.error)
        if jr.output is None or tr.error is not None:
            continue
        want = np.asarray(jr.output)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(tr.output - want).max() <= TWIN * scale, tr.uid
    assert teng.counters == jeng.counters
    assert treg.counters == jreg.counters
    tstats, jstats = treg.stats(), jreg.stats()
    assert tstats == jstats
    for js, ts in zip(jeng.tick_log, teng.tick_log):
        assert (dataclasses.replace(ts, seconds=0.0).__dict__
                == dataclasses.replace(js, seconds=0.0).__dict__)
    assert len(jeng.tick_log) == len(teng.tick_log)
    return runs["torch"]


# ---------------------------------------------------- test_serving_graph.py
def test_engine_matches_direct_oracle(models):
    """Batched, chunked, multi-tenant predictions against the dense oracle,
    with a custom dual vector and requests spanning several ticks."""
    def scenario(pkg, models):
        rng = np.random.default_rng(0)
        reg = _registry(pkg, models)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=3, chunk=16)
        reqs = []
        for i, mid in enumerate(["a", "b", "c", "a", "b", "c", "a"]):
            m = int(rng.integers(5, 60))
            q = rng.uniform(-2.5, 2.5, (m, 2))
            rhs = rng.standard_normal(
                models["torch"][mid].train_points.shape[0]) if i == 3 \
                else None
            reqs.append(_submit(pkg, engine, i, mid, q, rhs))
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, _, _ = _twin(scenario, models)
    for req in reqs:
        assert req.done and req.error is None, (req.uid, req.error)
        np.testing.assert_allclose(
            req.output, _oracle(models, req.model_id, req.query_points,
                                req.rhs), atol=TOL)


def test_zero_replans_in_steady_state(models):
    """After the warm-up builds the (model, alpha) grids, six waves of
    fresh query arrays build no plan, multiplier or grid."""
    def scenario(pkg, models):
        rng = np.random.default_rng(1)
        reg = _registry(pkg, models)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=4, chunk=32)
        reqs = [_submit(pkg, engine, i, mid, rng.uniform(-2, 2, (20, 2)))
                for i, mid in enumerate(["a", "b"])]
        engine.run_until_drained()
        warm = reg.stats()
        assert warm["grid_builds"] == 2 and warm["bank_transforms"] == 1
        uid = 10
        for _ in range(6):
            wave = [_submit(pkg, engine, uid + k, mid,
                            rng.uniform(-2, 2, (25, 2)))
                    for k, mid in enumerate(["a", "b", "a"])]
            uid += len(wave)
            engine.run_until_drained()
            assert all(r.done and r.error is None for r in wave)
            reqs += wave
        steady = reg.stats()
        for key in ("plan_builds", "multiplier_builds", "grid_builds"):
            assert steady[key] == warm[key], key
        assert steady["grid_hits"] > warm["grid_hits"]
        return reqs, engine, reg

    _twin(scenario, models)


def test_slot_recycling_never_drains(models):
    """More requests than slots: recycled slots are refilled the same tick,
    and every request is served correctly."""
    def scenario(pkg, models):
        rng = np.random.default_rng(2)
        reg = _registry(pkg, models)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=8)
        reqs = [_submit(pkg, engine, i, "a", rng.uniform(-2, 2, (m, 2)))
                for i, m in enumerate([4, 40, 6, 30, 5, 20])]
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, engine, _ = _twin(scenario, models)
    for r in reqs:
        assert r.done and r.error is None
        np.testing.assert_allclose(r.output,
                                   _oracle(models, "a", r.query_points),
                                   atol=TOL)
    busy = [t for t in engine.tick_log if t.queue_depth > 0]
    assert busy and all(t.occupancy == 2 for t in busy)


def test_out_of_domain_request_rejected(models):
    def scenario(pkg, models):
        reg = _registry(pkg, models)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=8)
        reqs = [_submit(pkg, engine, 0, "a", np.full((3, 2), 50.0)),
                _submit(pkg, engine, 1, "nope", np.zeros((3, 2))),
                _submit(pkg, engine, 2, "a", np.zeros((3, 5)))]
        engine.step()
        return reqs, engine, reg

    (bad, unknown, wrong_d), engine, _ = _twin(scenario, models)
    assert bad.done and "domain" in bad.error
    assert unknown.done and "unknown model_id" in unknown.error
    assert wrong_d.done and "does not match" in wrong_d.error
    assert engine.counters["rejected"] == 3


def test_tick_stats_observability(models):
    def scenario(pkg, models):
        rng = np.random.default_rng(3)
        reg = _registry(pkg, models)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=8)
        reqs = [_submit(pkg, engine, i, "a", rng.uniform(-2, 2, (8, 2)))
                for i in range(4)]
        s1 = engine.step()
        assert s1.occupancy <= 2 and s1.queue_depth == 2 and s1.rows == 16
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, engine, _ = _twin(scenario, models)
    assert all(r.done for r in reqs)
    assert engine.counters["rows"] == 32 and engine.counters["finished"] == 4
    assert all(r.latency > 0 for r in reqs)


def test_custom_rhs_grid_cache_reuse(models):
    """A repeated custom dual vector (a copy) hits the grid cache."""
    def scenario(pkg, models):
        rng = np.random.default_rng(4)
        reg = _registry(pkg, models)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=32)
        rhs = rng.standard_normal(300)
        reqs = [_submit(pkg, engine, 0, "a", rng.uniform(-2, 2, (10, 2)),
                        rhs)]
        engine.run_until_drained()
        builds = reg.stats()["grid_builds"]
        reqs.append(_submit(pkg, engine, 1, "a",
                            rng.uniform(-2, 2, (12, 2)), rhs.copy()))
        engine.run_until_drained()
        assert reg.stats()["grid_builds"] == builds
        return reqs, engine, reg

    reqs, _, _ = _twin(scenario, models)
    for r in reqs:
        np.testing.assert_allclose(
            r.output, _oracle(models, "a", r.query_points, r.rhs), atol=TOL)


# ------------------------------------------- test_chaos.py's serving guards
def test_poisoned_grids_evict_trip_breaker_and_recover(models):
    """NaN-poisoned cached grids fail their requests (never serve NaN),
    trip the tenant's breaker (which drops its grids), shed its load for
    the cooldown while the sibling tenant is served, and clean grids are
    rebuilt after it."""
    def scenario(pkg, models):
        rng = np.random.default_rng(20)
        reg = _registry(pkg, models, ids=("a", "b"))
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=16,
                                            breaker_threshold=2,
                                            breaker_cooldown=2)
        reqs = [_submit(pkg, engine, 0, "a", rng.uniform(-2, 2, (8, 2)))]
        engine.run_until_drained()
        assert _poison_grids(reg, "a") == 1
        reqs += [_submit(pkg, engine, i, "a", rng.uniform(-2, 2, (8, 2)))
                 for i in (1, 2)]
        stats = engine.step()
        assert stats.nonfinite == 2
        assert engine.counters["breaker_trips"] == 1
        assert reg.counters["grid_invalidations"] >= 1
        reqs.append(_submit(pkg, engine, 3, "a", rng.uniform(-2, 2, (8, 2))))
        engine.step()
        assert engine.counters["breaker_rejections"] == 1
        reqs.append(_submit(pkg, engine, 4, "b", rng.uniform(-2, 2, (10, 2))))
        engine.run_until_drained()
        for _ in range(4):
            engine.step()
        reqs.append(_submit(pkg, engine, 5, "a",
                            rng.uniform(-2, 2, (12, 2))))
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, _, _ = _twin(scenario, models)
    warm, r1, r2, r3, rb, r5 = reqs
    assert warm.error is None
    assert "non-finite" in r1.error and "non-finite" in r2.error
    assert "circuit open" in r3.error
    for r in (rb, r5):
        assert r.done and r.error is None, r.error
        np.testing.assert_allclose(
            r.output, _oracle(models, r.model_id, r.query_points), atol=TOL)


def test_corrupted_plan_detected_rebuilt_and_served(models):
    def scenario(pkg, models):
        rng = np.random.default_rng(21)
        reg = _registry(pkg, models, ids=("a", "b"))
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=16)
        _corrupt_plan(reg, "a")
        assert not reg.plan_valid(reg.group_of("a"))
        reqs = [_submit(pkg, engine, 0, "a", rng.uniform(-2, 2, (10, 2))),
                _submit(pkg, engine, 1, "b", rng.uniform(-2, 2, (10, 2)))]
        engine.run_until_drained()
        assert reg.plan_valid(reg.group_of("a"))
        return reqs, engine, reg

    reqs, engine, reg = _twin(scenario, models)
    for r in reqs:
        assert r.done and r.error is None, r.error
        np.testing.assert_allclose(
            r.output, _oracle(models, r.model_id, r.query_points), atol=TOL)
    assert engine.counters["plan_rebuilds"] == 1
    assert reg.counters["group_rebuilds"] == 1
    assert any(t.rebuilds for t in engine.tick_log)


def test_deadline_expiry_evicts_and_recycles_slot(models):
    def scenario(pkg, models):
        rng = np.random.default_rng(22)
        reg = _registry(pkg, models, ids=("a",))
        engine = PKGS[pkg].GraphServeEngine(reg, slots=1, chunk=4)
        long = _submit(pkg, engine, 0, "a", rng.uniform(-2, 2, (64, 2)),
                       deadline_s=3600.0)
        engine.step()
        assert not long.done
        long.submitted_at -= 7200.0  # expire the deadline
        nxt = _submit(pkg, engine, 1, "a", rng.uniform(-2, 2, (6, 2)))
        stats = engine.step()
        assert stats.evicted == 1
        assert stats.occupancy == 1 and stats.rows > 0
        engine.run_until_drained()
        dead = _submit(pkg, engine, 2, "a", rng.uniform(-2, 2, (4, 2)),
                       deadline_s=1e-9)
        engine.step()
        return [long, nxt, dead], engine, reg

    (long, nxt, dead), engine, _ = _twin(scenario, models)
    assert "deadline" in long.error and "deadline" in dead.error
    assert nxt.done and nxt.error is None
    np.testing.assert_allclose(nxt.output,
                               _oracle(models, "a", nxt.query_points),
                               atol=TOL)
    assert engine.counters["deadline_evicted"] == 2


@pytest.mark.parametrize("mode", ["reject", "replan"])
def test_out_of_domain_rejected_or_replanned_never_wrong(models, mode):
    q_out = np.array([[4.5, -4.0], [5.0, 5.0], [4.2, 0.0]])

    def scenario(pkg, models):
        reg = _registry(pkg, models, ids=("a",))
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=8,
                                            out_of_domain=mode)
        reqs = [_submit(pkg, engine, 0, "a", q_out)]
        engine.step()
        reqs.append(_submit(pkg, engine, 1, "a", np.full((3, 2), np.nan)))
        engine.step()
        return reqs, engine, reg

    (r, bad), engine, _ = _twin(scenario, models)
    if mode == "reject":
        assert "domain" in r.error and r.output is None
        assert engine.counters["out_of_domain"] == 2
    else:
        assert r.error is None and engine.counters["replans"] == 1
        np.testing.assert_allclose(r.output, _oracle(models, "a", q_out),
                                   atol=TOL)
    assert any(t.out_of_domain for t in engine.tick_log)
    assert "non-finite query" in bad.error


def test_bounded_queue_backpressure(models):
    def scenario(pkg, models):
        rng = np.random.default_rng(24)
        reg = _registry(pkg, models, ids=("a",))
        engine = PKGS[pkg].GraphServeEngine(reg, slots=1, chunk=8,
                                            max_queue=2)
        reqs = [PKGS[pkg].PredictRequest(
            uid=i, model_id="a", query_points=rng.uniform(-2, 2, (4, 2)))
            for i in range(3)]
        assert [engine.submit(r) for r in reqs] == [True, True, False]
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, engine, _ = _twin(scenario, models)
    assert "backpressure" in reqs[2].error
    assert engine.counters["backpressure"] == 1
    assert engine.counters["finished"] == 2


def test_unregister_rebuilds_the_group(models):
    """Evicting a tenant rebuilds its group from the survivors, which are
    served as before; the evicted id is unknown afterwards."""
    def scenario(pkg, models):
        rng = np.random.default_rng(25)
        reg = _registry(pkg, models)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=16)
        reqs = [_submit(pkg, engine, 0, "a", rng.uniform(-2, 2, (9, 2)))]
        engine.run_until_drained()
        assert reg.unregister("b") and not reg.unregister("b")
        assert sorted(reg.model_ids()) == ["a", "c"]
        reqs += [_submit(pkg, engine, 1, "a", rng.uniform(-2, 2, (9, 2))),
                 _submit(pkg, engine, 2, "b", rng.uniform(-2, 2, (9, 2)))]
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, _, reg = _twin(scenario, models)
    assert reqs[1].error is None and "unknown model_id" in reqs[2].error
    assert reg.stats()["plan_builds"] == 3


FAULTS = {"jax": jfi, "torch": tfi}


def test_dropped_ticks_delay_but_never_corrupt(models):
    """tests/test_chaos.py's dropped ticks, through each package's
    TickChaos: the drops stall their ticks only, are counted, and every
    request completes with the oracle's output."""
    def scenario(pkg, models):
        rng = np.random.default_rng(23)
        reg = _registry(pkg, models, ids=("a",))
        chaos = FAULTS[pkg].TickChaos(drop_ticks=frozenset({0, 2}))
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=4,
                                            chaos=chaos)
        reqs = [_submit(pkg, engine, i, "a", rng.uniform(-2, 2, (10, 2)))
                for i in range(3)]
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, engine, _ = _twin(scenario, models)
    assert engine.counters["dropped_ticks"] == 2
    assert [t.dropped for t in engine.tick_log][:3] == [True, False, True]
    for req in reqs:
        assert req.done and req.error is None
        np.testing.assert_allclose(req.output,
                                   _oracle(models, "a", req.query_points),
                                   atol=TOL)


def test_tick_chaos_poisons_grids_and_corrupts_plans(models):
    """A TickChaos schedule fires each package's own injectors: grids
    poisoned at tick 1 fail requests by the non-finite guard and trip the
    breaker; a plan corrupted at tick 6 is detected, the group rebuilt and
    served.  Both engines count the same."""
    def scenario(pkg, models):
        rng = np.random.default_rng(26)
        reg = _registry(pkg, models, ids=("a", "b"))
        chaos = FAULTS[pkg].TickChaos(poison_grids={1: "a"},
                                      corrupt_plans={6: "b"}, seed=3)
        engine = PKGS[pkg].GraphServeEngine(reg, slots=2, chunk=8,
                                            breaker_threshold=1,
                                            breaker_cooldown=1,
                                            chaos=chaos)
        reqs = [_submit(pkg, engine, 0, "a", rng.uniform(-2, 2, (8, 2)))]
        engine.step()  # tick 0 builds the (a, alpha) grid
        reqs.append(_submit(pkg, engine, 1, "a",
                            rng.uniform(-2, 2, (8, 2))))
        engine.step()  # tick 1 poisons it: non-finite, breaker trips
        for _ in range(4):
            engine.step()
        reqs += [_submit(pkg, engine, 2 + i, mid, rng.uniform(-2, 2, (8, 2)))
                 for i, mid in enumerate(("a", "b"))]
        engine.run_until_drained()
        return reqs, engine, reg

    reqs, engine, reg = _twin(scenario, models)
    assert reqs[0].error is None and "non-finite" in reqs[1].error
    assert engine.counters["breaker_trips"] == 1
    assert engine.counters["plan_rebuilds"] == 1
    for req in reqs[2:]:
        assert req.error is None, req.error
        np.testing.assert_allclose(
            req.output, _oracle(models, req.model_id, req.query_points),
            atol=TOL)


def test_journal_seam_appends_registrations_only(models, tmp_path):
    """GraphModelRegistry(journal=): a registration or an eviction appends
    one record; a group rebuild and an eviction's siblings append none."""
    from repro_torch.serving import journal as tjournal
    jpath = tmp_path / "j.journal"
    reg = tgraph.GraphModelRegistry(
        journal=tjournal.RegistryJournal(str(jpath)))
    for mid in ("a", "b", "c"):
        reg.register(mid, models["torch"][mid])
    assert reg.rebuild_group("a")
    assert reg.unregister("b")
    ops = [json.loads(line)["op"] for line in jpath.read_text().splitlines()]
    assert ops == ["register"] * 3 + ["unregister"]
    assert sorted(reg.model_ids()) == ["a", "c"]


def test_out_of_domain_mode_is_checked(models):
    reg = _registry("torch", models, ids=("a",))
    with pytest.raises(ValueError, match="out_of_domain"):
        tgraph.GraphServeEngine(reg, out_of_domain="ignore")
