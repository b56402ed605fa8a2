"""Kernel ridge regression with NFFT-accelerated Gram matvecs (Section 6.3).

PyTorch counterpart of the fit/predict part of ``repro.graph.krr``.  Dual
solve:  alpha = (K + beta I)^{-1} f  by CG, where the Gram matrix
K_ij = K(x_i - x_j) (*with* diagonal K(0), unlike the graph weight matrix)
is applied by Algorithm 3.1.  Prediction at new points x uses the
separate-target fast summation  F(x) = sum_i alpha_i K(x_i - x);
:func:`krr_predict_direct` is the exact O(n m) oracle, on the card the
hand-written direct-sum kernel.

Model selection (:func:`krr_fit_sweep`) runs a whole (sigma, beta) grid as
ONE lockstep solve on an operator bank: every CG iteration is one spread
and one gather for the entire grid.  :func:`krr_fit_grad` instead descends
the validation loss (:func:`krr_validation_loss`) in (log sigma, log beta)
with Adam, its gradient taken through implicit-diff CG and the fused
pipeline's transpose.
"""

from __future__ import annotations

import hashlib
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.fastsum import (
    FastsumOperator, FastsumParams, _as_points, make_fastsum,
    make_fastsum_bank,
)
from repro_torch.core.kernels import Kernel, kernel_from_param, make_kernel
from repro_torch.core.solvers import cg
from repro_torch.kernels.kernel_matvec import kernel_matvec

# serving cache capacity: how many target sets a model keeps planned
# operators for (a validation set and a live set alternating both stay)
PRED_CACHE_SLOTS = 4


def points_fingerprint(arr) -> tuple:
    """Content key for a point set: (shape, dtype, sha1 of the raw bytes).

    Cache lookups key on content, not object identity, so a round-tripped
    copy of a resident target set is a hit.  Tensors on the card are
    copied to the host to be hashed.
    """
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    return (a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).digest())


class KRRModel(NamedTuple):
    alpha: torch.Tensor
    train_points: torch.Tensor
    kernel: Kernel
    params: FastsumParams
    num_iters: torch.Tensor
    converged: torch.Tensor
    # keyed LRU of the last PRED_CACHE_SLOTS target sets' operators;
    # mutable on purpose (shared by every _replace copy of the model), and
    # only touched under the lock stored inside it (_pred_cache_lock)
    pred_cache: dict | None = None


def krr_fit(kernel: Kernel, points, f, beta: float, params: FastsumParams,
            *, tol: float = 1e-8, maxiter: int = 1000,
            device: str | torch.device | None = None) -> KRRModel:
    """Fit the dual variable alpha = (K + beta I)^{-1} f via CG.

    ``device`` defaults to ``cuda``."""
    pts = _as_points(points, device)
    f = torch.as_tensor(f, device=pts.device)
    gram = make_fastsum(kernel, pts, params, device=pts.device)

    def matvec(x):
        # Gram matrix = W̃ (diagonal K(0) kept)
        return gram.matvec_tilde(x) + beta * x

    sol = cg(matvec, f, tol=tol, maxiter=maxiter)
    return KRRModel(alpha=sol.x, train_points=pts, kernel=kernel,
                    params=params, num_iters=sol.num_iters,
                    converged=sol.converged, pred_cache={})


class KRRSweepResult(NamedTuple):
    """One lockstep fit of a whole (sigma, beta) model-selection grid.

    ``alphas[i, :, j]`` is the dual variable of ``(sigmas[i], betas[j])``;
    ``num_iters`` / ``residual_norm`` / ``converged`` are (|sigmas|,
    |betas|), one tolerance mask per system.
    """

    alphas: torch.Tensor  # (S_sigma, n, S_beta)
    sigmas: tuple
    betas: tuple
    num_iters: torch.Tensor  # (S_sigma, S_beta)
    residual_norm: torch.Tensor
    converged: torch.Tensor
    kernel_name: str
    train_points: torch.Tensor
    params: FastsumParams


def krr_fit_sweep(kernel_name: str, points, f, betas: Sequence[float],
                  sigmas: Sequence[float], params: FastsumParams, *,
                  tol: float = 1e-8, maxiter: int = 1000,
                  device: str | torch.device | None = None) -> KRRSweepResult:
    """Fit alpha = (K_sigma + beta I)^{-1} f for a whole (sigma, beta) grid.

    ONE operator bank over the training points (a member per sigma, plan
    and geometry shared) and lockstep CG on its flat bank-major columns:
    per iteration one spread, one rfftn, |sigmas| multiplies, one batched
    irfftn and one gather; the betas ride the channel axis.
    ``kernel_name`` is "gaussian" or "laplacian_rbf".  ``device`` defaults
    to ``cuda``.
    """
    sigmas = tuple(float(s) for s in sigmas)
    betas = tuple(float(b) for b in betas)
    ns, nb = len(sigmas), len(betas)
    pts = _as_points(points, device)
    f = torch.as_tensor(f, device=pts.device)
    bank = make_fastsum_bank([make_kernel(kernel_name, sigma=s)
                              for s in sigmas], pts, params,
                             device=pts.device)
    # column s*nb + j is the (sigmas[s], betas[j]) system
    beta_cols = torch.tensor(betas, dtype=f.dtype, device=f.device).repeat(ns)

    def matvec_cols(u):  # (n, S*B) -> (n, S*B)
        return bank.matvec_tilde_columns(u) + beta_cols[None, :] * u

    n = f.shape[0]
    rhs = f[:, None].expand(n, ns * nb).contiguous()
    sol = cg(matvec_cols, rhs, tol=tol, maxiter=maxiter)
    alphas = sol.x.reshape(n, ns, nb).permute(1, 0, 2).contiguous()
    stats = [a.reshape(ns, nb) for a in
             (sol.num_iters, sol.residual_norm, sol.converged)]
    return KRRSweepResult(
        alphas=alphas, sigmas=sigmas, betas=betas, num_iters=stats[0],
        residual_norm=stats[1], converged=stats[2], kernel_name=kernel_name,
        train_points=pts, params=params)


def krr_validation_loss(kernel_name: str, gram_op: FastsumOperator,
                        pred_op: FastsumOperator, f_train, f_val, log_sigma,
                        log_beta, *, tol: float = 1e-10,
                        maxiter: int = 1000) -> torch.Tensor:
    """Validation MSE of a KRR fit, differentiable in (log sigma, log beta).

    (log sigma, log beta) -> a kernel with a tensor parameter ->
    :meth:`FastsumOperator.with_kernel` (differentiable ``b_hat`` and
    multiplier) -> implicit-diff CG on the Gram system -> the
    separate-target prediction -> MSE.  ``gram_op`` is a square operator
    over the training points and ``pred_op`` a training -> validation
    operator; both keep their plan (and ``rho``) across calls, only their
    spectral data is rebuilt.  ``log_sigma`` / ``log_beta`` are numbers or
    0-d tensors (to differentiate, tensors that require grad).  The
    prediction cache of :func:`krr_prediction_operator` is not used.
    """
    dev = gram_op.device
    log_sigma = torch.as_tensor(log_sigma, dtype=torch.float64)
    log_beta = torch.as_tensor(log_beta, dtype=torch.float64)
    kern = kernel_from_param(kernel_name, torch.exp(log_sigma))
    beta = torch.exp(log_beta)
    gram = gram_op.with_kernel(kern)

    def matvec(x):  # Gram matrix = W̃ (diagonal K(0) kept)
        return gram.matvec_tilde(x) + beta * x

    sol = cg(matvec, torch.as_tensor(f_train, device=dev), tol=tol,
             maxiter=maxiter)
    pred = pred_op.with_kernel(kern).matvec_tilde(sol.x)
    return torch.mean((pred - torch.as_tensor(f_val, device=dev)) ** 2)


class KRRGradResult(NamedTuple):
    """Gradient-based model selection trace (see :func:`krr_fit_grad`)."""

    model: KRRModel
    kernel_name: str
    sigma: float  # selected kernel parameter (sigma or c)
    beta: float
    val_loss: float
    log_sigma_path: torch.Tensor  # (steps + 1,) iterates, init first
    log_beta_path: torch.Tensor
    loss_path: torch.Tensor  # (steps + 1,) validation loss at each iterate


def krr_fit_grad(kernel_name: str, points, f, val_points, val_f,
                 params: FastsumParams, *, init_sigma: float = 0.5,
                 init_beta: float = 1e-2, steps: int = 40, lr: float = 0.25,
                 tol: float = 1e-10, maxiter: int = 1000,
                 device: str | torch.device | None = None) -> KRRGradResult:
    """Gradient-based (sigma, beta) model selection on a validation loss.

    Adam on ``(log sigma, log beta)`` (the JAX package's constants: beta1
    0.9, beta2 0.999, eps 1e-8) over :func:`krr_validation_loss`; each
    step costs two solves (forward and adjoint), whatever the grid
    resolution would have been.  The two operators are planned once.  The
    iterate with the best validation loss is refit (:func:`krr_fit`) as a
    servable :class:`KRRModel`.  ``device`` defaults to ``cuda``.
    """
    pts = _as_points(points, device)
    dev = pts.device
    f = torch.as_tensor(f, device=dev)
    val_f = torch.as_tensor(val_f, device=dev)
    init_kernel = kernel_from_param(kernel_name, float(init_sigma))
    gram_op = make_fastsum(init_kernel, pts, params, device=dev)
    pred_op = make_fastsum(init_kernel, pts, params, target_points=val_points,
                           device=dev)

    def value_and_grads(ls: float, lb: float):
        a, b = (torch.tensor(v, dtype=torch.float64, device=dev,
                             requires_grad=True) for v in (ls, lb))
        loss = krr_validation_loss(kernel_name, gram_op, pred_op, f, val_f,
                                   a, b, tol=tol, maxiter=maxiter)
        ga, gb = torch.autograd.grad(loss, (a, b))
        return float(loss.detach()), np.array([float(ga), float(gb)])

    ls, lb = float(np.log(float(init_sigma))), float(np.log(float(init_beta)))
    m, v = np.zeros(2), np.zeros(2)
    ls_path, lb_path, loss_path = [], [], []
    best = (np.inf, ls, lb)
    for t in range(steps + 1):
        val, g = value_and_grads(ls, lb)
        ls_path.append(ls)
        lb_path.append(lb)
        loss_path.append(val)
        if val < best[0]:
            best = (val, ls, lb)
        if t == steps:  # the last iterate is evaluated, not stepped from
            break
        # a quarantined solve gives zero cotangents (cg's implicit-diff
        # contract); scrub anything non-finite all the same
        g = np.where(np.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1.0 - 0.9 ** (t + 1))
        vh = v / (1.0 - 0.999 ** (t + 1))
        upd = lr * mh / (np.sqrt(vh) + 1e-8)
        ls, lb = ls - upd[0], lb - upd[1]
    sigma_best, beta_best = float(np.exp(best[1])), float(np.exp(best[2]))
    model = krr_fit(kernel_from_param(kernel_name, sigma_best), pts, f,
                    beta_best, params, tol=min(tol, 1e-8), maxiter=maxiter,
                    device=dev)
    return KRRGradResult(
        model=model, kernel_name=kernel_name, sigma=sigma_best,
        beta=beta_best, val_loss=best[0],
        log_sigma_path=torch.tensor(ls_path, dtype=torch.float64),
        log_beta_path=torch.tensor(lb_path, dtype=torch.float64),
        loss_path=torch.tensor(loss_path, dtype=torch.float64))


def krr_sweep_model(sweep: KRRSweepResult, i_sigma: int,
                    j_beta: int) -> KRRModel:
    """One (sigma, beta) cell of a sweep as a servable :class:`KRRModel`."""
    return KRRModel(
        alpha=sweep.alphas[i_sigma, :, j_beta], train_points=sweep.train_points,
        kernel=make_kernel(sweep.kernel_name, sigma=sweep.sigmas[i_sigma]),
        params=sweep.params, num_iters=sweep.num_iters[i_sigma, j_beta],
        converged=sweep.converged[i_sigma, j_beta], pred_cache={})


def _pred_cache_lock(cache: dict) -> threading.Lock:
    """The cache's lock, created on first use (``dict.setdefault`` is atomic
    under the GIL, so concurrent first calls agree on one lock)."""
    lock = cache.get("lock")
    if lock is None:
        lock = cache.setdefault("lock", threading.Lock())
    return lock


def krr_pred_cache_stats(model: KRRModel) -> dict:
    """Snapshot of the prediction-cache counters: hits / misses / plans."""
    cache = model.pred_cache
    if cache is None:
        return {"hits": 0, "misses": 0, "plans": 0, "resident": 0}
    with _pred_cache_lock(cache):
        return {"hits": cache.get("hits", 0),
                "misses": cache.get("misses", 0),
                "plans": cache.get("plans", 0),
                "resident": len(cache.get("targets", []))}


def krr_prediction_operator(model: KRRModel, new_points, *,
                            cache_key=None) -> FastsumOperator:
    """Plan-once prediction operator for ``new_points``.

    Operators are cached on the model in a keyed LRU of
    :data:`PRED_CACHE_SLOTS` entries.  The key is the content of the target
    and training points plus the kernel's name and parameter and the
    params; a caller that knows its target set's identity may pass
    ``cache_key`` instead of having the targets hashed (equal keys must
    then mean equal content).
    """
    cache = model.pred_cache
    key = (cache_key if cache_key is not None
           else points_fingerprint(new_points),
           points_fingerprint(model.train_points), model.kernel.name,
           tuple(sorted(model.kernel.params.items())), model.params)
    if cache is not None:
        with _pred_cache_lock(cache):
            entries = cache.setdefault("targets", [])
            for i, (ek, op) in enumerate(entries):
                if ek == key:
                    if i:  # move to front (most recently used)
                        entries.insert(0, entries.pop(i))
                    cache["hits"] = cache.get("hits", 0) + 1
                    return op
            cache["misses"] = cache.get("misses", 0) + 1
    # plan outside the lock: planning is the expensive part
    op = make_fastsum(model.kernel, model.train_points, model.params,
                      target_points=new_points,
                      device=model.train_points.device)
    if cache is not None:
        with _pred_cache_lock(cache):
            cache["plans"] = cache.get("plans", 0) + 1
            entries = cache.setdefault("targets", [])
            if not any(ek == key for ek, _ in entries):  # racing builder won
                entries.insert(0, (key, op))
                del entries[PRED_CACHE_SLOTS:]
    return op


def krr_predict(model: KRRModel, new_points, *, op=None,
                cache_key=None) -> torch.Tensor:
    """F(x) = sum_i alpha_i K(x_i - x) via separate-target fast summation
    (the operator is planned once per target set and cached on the model;
    pass a prebuilt ``op`` to manage caching yourself)."""
    if op is None:
        op = krr_prediction_operator(model, new_points, cache_key=cache_key)
    return op.matvec_tilde(model.alpha)


def krr_predict_many(model: KRRModel, queries: Sequence,
                     rhs: Sequence | None = None, *,
                     cache_key=None) -> list:
    """Many query sets through ONE plan application.

    Packs the query sets into one target set, dedupes the per-request dual
    vectors into channel columns (``rhs[i] is None`` means the model's own
    ``alpha``), runs one multi-RHS ``matvec_tilde`` and splits the rows
    back per request.
    """
    dev = model.train_points.device
    queries = [torch.as_tensor(q, device=dev) for q in queries]
    if rhs is None:
        rhs = [None] * len(queries)
    if len(rhs) != len(queries):
        raise ValueError(f"got {len(queries)} query sets but {len(rhs)} rhs")
    op = krr_prediction_operator(model, torch.cat(queries),
                                 cache_key=cache_key)
    cols, col_of_req, col_ids = [], [], {}
    for r in rhs:
        cid = "alpha" if r is None else points_fingerprint(r)
        if cid not in col_ids:
            col_ids[cid] = len(cols)
            cols.append(model.alpha if r is None
                        else torch.as_tensor(r, device=dev))
        col_of_req.append(col_ids[cid])
    if len(cols) == 1:
        out = op.matvec_tilde(cols[0])[:, None]
    else:
        out = op.matvec_tilde(torch.stack(cols, dim=1))
    results, row = [], 0
    for q, c in zip(queries, col_of_req):
        results.append(out[row:row + q.shape[0], c])
        row += q.shape[0]
    return results


def krr_predict_direct(model: KRRModel, new_points) -> torch.Tensor:
    """Exact O(n m) prediction (the oracle): the rectangular direct sum
    with no zero diagonal, on the card the hand-written kernel."""
    pts = torch.as_tensor(new_points, device=model.train_points.device,
                          dtype=model.train_points.dtype)
    (param,) = model.kernel.params.values()  # sigma or c
    return kernel_matvec(pts, model.train_points, model.alpha,
                         kernel_name=model.kernel.name, param=param,
                         zero_diagonal=False)
