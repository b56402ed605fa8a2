"""The JAX package's graph-serving error at chip_smoke.py's [graph_serve]
settings, on the CPU in float64.

    PYTHONPATH=src python tests/jax_graph_serve_reference.py

Fits the two serve_scaling.py tenants and the [sweep] phase's d = 2 grid
with the JAX package, serves chip_smoke.py's first burst through the JAX
``GraphServeEngine`` and prints, per tenant group, max|served - direct| /
max|direct| over the group's requests (the exact oracle is
``krr_predict_direct``), the same against the exact trigonometric sum
that the served NFFT approximates (an NDFT of the frozen frame's nodes
with each kernel's Fourier coefficients), the same for the sequential
path (one ``krr_predict`` per request) and for an out-of-domain request
served by the replan.  chip_smoke.py keeps these numbers as
``JAX_GRAPH_SERVE_REL`` and holds the port on the card to 10x them.
Takes a few minutes and ~4 GB.
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro.core import FastsumParams, make_kernel  # noqa: E402
from repro.core.fastsum import _member_spectral  # noqa: E402
from repro.data.synthetic import crescent_fullmoon, spiral  # noqa: E402
from repro.graph import (  # noqa: E402
    krr_fit, krr_fit_sweep, krr_predict, krr_predict_direct, krr_sweep_model,
)
from repro.serving import (  # noqa: E402
    GraphModelRegistry, GraphServeEngine, PredictRequest,
)


def ndft_served(group, model, alpha_hat, query_points):
    """The exact trigonometric sum the served prediction approximates:
    out_scale * Re sum_k b_hat_k e^{2 pi i k.y} alpha_hat_k, y the frozen
    frame's scaled queries; ``alpha_hat`` caches each model's NDFT of
    alpha over the scaled training nodes."""
    pred, params = group.pred, model.params
    n_bw, d = params.n_bandwidth, pred.plan.d
    k = np.fft.fftfreq(n_bw, d=1.0 / n_bw)
    freq = np.stack([g.reshape(-1) for g in np.meshgrid(*[k] * d,
                                                        indexing="ij")], -1)
    b_hat, _, out_scale, _ = _member_spectral(model.kernel, pred.rho,
                                              pred.plan, params)
    key = id(model)
    if key not in alpha_hat:
        src, alpha = np.asarray(pred.scaled_src), np.asarray(model.alpha)
        acc = np.zeros(len(freq), complex)
        for s in range(0, len(src), 4096):
            acc += np.exp(-2j * np.pi * (freq @ src[s:s + 4096].T)) \
                @ alpha[s:s + 4096]
        alpha_hat[key] = acc
    tgt = np.asarray(pred.scale_targets(jnp.asarray(query_points)))
    phase = np.exp(2j * np.pi * (tgt @ freq.T))
    return (phase @ (np.asarray(b_hat).reshape(-1) * alpha_hat[key])).real \
        * float(out_scale)


def main() -> None:
    rng = np.random.default_rng(cs.GS_SEED)
    xtr, ytr = cs.graph_serve_data(rng)
    params = FastsumParams(n_bandwidth=cs.GS_N_BANDWIDTH, m=cs.GS_M)
    models = {f"tenant{i}": krr_fit(make_kernel("gaussian", sigma=s),
                                    jnp.asarray(xtr), jnp.asarray(ytr),
                                    cs.GS_REG, params)
              for i, s in enumerate(cs.GS_SIGMAS)}
    d = cs.GS_SWEEP_D
    n_bw, m, _, betas = cs.SWEEP_CONFIGS[d]
    pts, f = cs.sweep_dataset(d, cs.SWEEP_N, crescent_fullmoon, spiral)
    sweep = krr_fit_sweep("gaussian", jnp.asarray(pts), jnp.asarray(f),
                          betas, cs.sweep_sigmas(d),
                          FastsumParams(n_bandwidth=n_bw, m=m),
                          tol=cs.SWEEP_TOL, maxiter=cs.SWEEP_MAXITER)
    for i in range(len(sweep.sigmas)):
        for j in range(len(betas)):
            models[f"cell{i * len(betas) + j}"] = krr_sweep_model(sweep, i, j)
    registry = GraphModelRegistry()
    for mid, model in models.items():
        registry.register(mid, model)
    engine = GraphServeEngine(registry, slots=cs.GS_SLOTS, chunk=cs.GS_CHUNK)
    reqs = [PredictRequest(uid=i, model_id=mid, query_points=q)
            for i, (mid, q) in enumerate(cs.graph_serve_burst(rng, pts))]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    err = {k: [0.0, 0.0] for k in ("uniform", "sweep", "ndft_uniform",
                                   "ndft_sweep")}
    alpha_hat = {}
    for r in reqs:
        assert r.done and r.error is None, r.error
        model = models[r.model_id]
        direct = np.asarray(krr_predict_direct(model,
                                               jnp.asarray(r.query_points)))
        ndft = ndft_served(registry.group_of(r.model_id), model, alpha_hat,
                           r.query_points)
        g = "uniform" if r.model_id.startswith("tenant") else "sweep"
        for key, ref in ((g, direct), ("ndft_" + g, ndft)):
            e = err[key]
            e[0] = max(e[0], float(np.abs(r.output - ref).max()))
            e[1] = max(e[1], float(np.abs(ref).max()))
    out = {k: v[0] / v[1] for k, v in err.items()}
    # the sequential path: one krr_predict (a joint replan) per request
    seq = {"sequential_uniform": [0.0, 0.0], "sequential_sweep": [0.0, 0.0]}
    for r in reqs:
        q = jnp.asarray(r.query_points)
        model = models[r.model_id]
        direct = np.asarray(krr_predict_direct(model, q))
        e = seq["sequential_" + ("uniform" if r.model_id.startswith("tenant")
                                 else "sweep")]
        e[0] = max(e[0], float(np.abs(np.asarray(krr_predict(model, q))
                                      - direct).max()))
        e[1] = max(e[1], float(np.abs(direct).max()))
    out.update({k: v[0] / v[1] for k, v in seq.items()})
    # an out-of-domain request served by the replan (tenant0)
    rep = GraphServeEngine(registry, slots=2, chunk=cs.GS_CHUNK,
                           out_of_domain="replan")
    req = PredictRequest(uid=-1, model_id="tenant0",
                         query_points=cs.GS_OUT_OF_DOMAIN)
    rep.submit(req)
    rep.step()
    assert req.done and req.error is None, req.error
    direct = np.asarray(krr_predict_direct(
        models["tenant0"], jnp.asarray(cs.GS_OUT_OF_DOMAIN)))
    out["replan"] = float(np.abs(req.output - direct).max()
                          / np.abs(direct).max())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
