"""The port's LM training against the JAX package's, on the CPU.

The reduced granite-3-2b config (float32, 4 layers, d 64, V 128, seq 64,
batch 2): the JAX package's initial ``TrainState`` is carried onto the
port (``train_state_from_arrays``) and both packages take the same
numpy-seeded batches.  Tolerances:

* ``make_schedule``: within 1e-7 of the reference's learning rate;
* one AdamW and one Adafactor update from the same numpy gradients and
  state: every leaf within 1e-6 of its largest entry (``_rel``);
* three train steps (microbatches 1 and 2, compression on and off,
  Adafactor) at the reference's default schedule: loss, ``grad_norm`` and
  ``lr`` within 1e-5 relative, every parameter within 1e-5 of its leaf's
  largest entry.  The two packages' gradients agree to ~2e-6 of a leaf's
  largest entry, and Adam moves an element by ~lr whatever its gradient's
  size, so an element whose gradient lies within that noise of zero moves
  by an amount the noise decides: at the default schedule (lr 3e-6, 6e-6,
  9e-6) that is far below the tolerance, at a peak lr of 1e-3 it reaches
  2e-5 (one wq element with |g| = 1.2e-8).  The optimizers' arithmetic
  is held at 1e-6 on its own, at lr 1e-2, by ``test_one_update``;
* ``forward_train`` against the JAX package's within 1e-5 relative, and
  against ``forward_train_reference`` exactly;
* whole train steps of reduced olmoe-1b-7b and mamba2-1.3b (AdamW) and
  deepseek-v3-671b (Adafactor, one MTP depth): step 0's gradient within
  1e-4 of each leaf's largest entry, three steps' metrics within 1e-5
  relative, then parameters within 1e-5 of each leaf's largest entry (of
  1 for a leaf that is zero at init: ``_assert_params_close``) and the
  optimizer's moments within 1e-4;
* learn_sigma (granite-3-2b-nfft): every gradient leaf within 1e-4 of its
  largest entry (b_hat's float64 FFT, as tests/test_torch_nfft_attention);
* compression: bit for bit.

The optimizers decide per JAX leaf, and the JAX package stacks the
periodic layers: ``test_per_layer_optimizer_would_fail`` shows that an
optimizer applied per layer (no weight decay on a (d,) norm, one update
RMS per layer) misses these tolerances by far.
"""

import dataclasses
import io
import math
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as cases
from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.dist import compression as jcomp
from repro.models import model as JM
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch.dist import compression as tcomp
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

ARCH = "granite-3-2b"
STEP_TOL = 1e-5
OPT_TOL = 1e-6
GRAD_TOL = 1e-4
STEPS = 3
# (optimizer, microbatches, compress_grads)
STEP_CASES = [("adamw", 1, False), ("adamw", 2, False), ("adamw", 1, True),
              ("adamw", 2, True), ("adafactor", 1, False)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread (pytest-xdist's parallel workers
    would oversubscribe the cores); the caller's count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _cfgs(name=ARCH, **nfft):
    jcfg = jconfigs.reduced_config(jconfigs.get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if nfft:
        jcfg = dataclasses.replace(jcfg, nfft_attention=dataclasses.replace(
            jcfg.nfft_attention, **nfft))
        tcfg = dataclasses.replace(tcfg, nfft_attention=dataclasses.replace(
            tcfg.nfft_attention, **nfft))
    return jcfg, tcfg


def _opt_cfg(name):
    """The reference's default optimizer settings (its tests train with
    them), Adafactor factoring leaves of 16 and more."""
    kw = dict(name=name)
    if name == "adafactor":
        kw["factored_min_dim"] = 16  # at 128 no reduced leaf is factored
    return kw


def _batch(cfg, step):
    return jpipe.batch_for_step(cfg, cfg.shapes[0], step)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
            batch.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(port_tree, jax_tree, tol):
    got = tree_flatten_with_path(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == np.shape(w), path
        assert _rel(g, w) <= tol, (path, _rel(g, w))


# -- the schedule -------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 9, 10, 55, 100, 150])
def test_schedule_matches_jax(step):
    """Steps 0, warmup-1, warmup, mid, total and beyond."""
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    want = float(jopt.make_schedule(jopt.OptimizerConfig(**kw))(
        jnp.asarray(step, jnp.int32)))
    got = float(topt.make_schedule(topt.OptimizerConfig(**kw))(
        torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= 1e-7 * want, (got, want)


# -- one optimizer update -----------------------------------------------------

def _update_inputs(name, seed=0):
    """(params, grads, optimizer state) as numpy trees in the JAX layout:
    the reduced model's leaves, random nonzero norms, gradients whose
    scale differs by layer (so that per-layer update RMS would differ),
    and a random state at step 5."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    params = _np_tree(JM.init_params(jax.random.PRNGKey(seed), jcfg))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.5)
                          .astype(a.dtype) if a.ndim <= 2 and a.shape[-1]
                          == jcfg.d_model else a, params)
    layer_scale = np.array([0.1, 1.0, 3.0, 10.0])

    def grad(a):
        g = rng.normal(size=a.shape)
        if a.shape[:1] == (jcfg.num_layers,):
            g = g * layer_scale.reshape((-1,) + (1,) * (a.ndim - 1))
        return g.astype(np.float32)

    grads = jax.tree.map(grad, params)
    opt = jopt.init_optimizer(jopt.OptimizerConfig(**_opt_cfg(name)))
    state = _np_tree(opt.init(jax.tree.map(jnp.asarray, params)))
    state = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) * np.abs(a).max()
                   if np.abs(a).max() > 0 else
                   rng.uniform(0.01, 0.1, a.shape)).astype(np.float32),
        state)
    if name == "adamw":
        state = state._replace(master=jax.tree.map(
            lambda a: a.astype(np.float32), params),
            m=jax.tree.map(lambda a: (a - 0.05).astype(np.float32),
                           state.m))
    return params, grads, state


def _jax_update(name, params, grads, state, lr=1e-2, step=5):
    opt = jopt.init_optimizer(jopt.OptimizerConfig(**_opt_cfg(name)))
    new_p, new_s = opt.update(*[jax.tree.map(jnp.asarray, t) for t in
                                (grads, state, params)],
                              jnp.asarray(lr, jnp.float32),
                              jnp.asarray(step, jnp.int32))
    return _np_tree(new_p), _np_tree(new_s)


def _port_update(name, params, grads, state, lr=1e-2, step=5):
    opt = topt.init_optimizer(topt.OptimizerConfig(**_opt_cfg(name)))
    t = lambda tree: tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    state_type = type(opt.init(t(params)))
    p, s = opt.update(t(grads), state_type(*[t(x) for x in state]),
                      t(params), torch.tensor(lr, dtype=torch.float32),
                      torch.tensor(step, dtype=torch.int32))
    return p, s


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_jax(name):
    """AdamW (fp32 master, m, v; decoupled decay on ndim >= 2) and
    Adafactor (factored second moment, Shazeer-Stern beta2, update-RMS
    clip), each leaf of params and state within OPT_TOL."""
    params, grads, state = _update_inputs(name)
    jp, js = _jax_update(name, params, grads, state)
    tp, ts = _port_update(name, params, grads, state)
    _assert_tree_close(tp, jp, OPT_TOL)
    for field in js._fields:
        _assert_tree_close(getattr(ts, field), getattr(js, field), OPT_TOL)
    if name == "adafactor":  # the factored path ran
        assert any(np.ndim(a) >= 2 for a in jax.tree_util.tree_leaves(
            js.v_row))


def _unstack(tree, n):
    """Each ``stack`` leaf cut into its n layers, as extra list items."""
    out = dict(tree)
    out["stack"] = [jax.tree.map(lambda a, p=p: a[p] if np.ndim(a) else a,
                                 slot)
                    for slot in tree["stack"] for p in range(n)]
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_per_layer_optimizer_would_fail(name):
    """The same update applied to each layer's tensor on its own (what a
    per-tensor optimizer over the port's per-layer parameters would do)
    misses the JAX package's stacked norms by far more than OPT_TOL: no
    weight decay on a (d,) norm, and (Adafactor) one update RMS per
    layer instead of one per stacked leaf."""
    n = _cfgs()[0].num_layers
    params, grads, state = _update_inputs(name)
    jp, _ = _jax_update(name, params, grads, state)
    tp, _ = _port_update(name, *[
        _unstack(t, n) if isinstance(t, dict) else
        type(t)(*[_unstack(x, n) for x in t])
        for t in (params, grads, state)])
    norm = np.stack([tp["stack"][p]["norm_mixer"].numpy()
                     for p in range(n)])
    assert _rel(norm, jp["stack"][0]["norm_mixer"]) > 100 * OPT_TOL
    if name == "adafactor":
        wq = np.stack([tp["stack"][p]["attn"]["wq"].numpy()
                       for p in range(n)])
        assert _rel(wq, jp["stack"][0]["attn"]["wq"]) > 100 * OPT_TOL


# -- the train step -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """Per case: the JAX initial state (numpy) and, after each of STEPS
    jitted steps, its metrics; the final parameters."""
    jcfg, _ = _cfgs()
    out = {}
    for name, n, compress in STEP_CASES:
        tc = jtl.TrainConfig(optimizer=jopt.OptimizerConfig(**_opt_cfg(name)),
                             num_microbatches=n, compress_grads=compress)
        state = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, tc)
        init = _np_tree(state)
        step = jax.jit(jtl.make_train_step(jcfg, tc))
        metrics = []
        for s in range(STEPS):
            state, m = step(state, jax.tree.map(jnp.asarray, _batch(jcfg, s)))
            metrics.append({k: float(v) for k, v in m.items()})
        out[(name, n, compress)] = (init, metrics, _np_tree(state))
    return out


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_train_steps_match_jax(jax_steps, case):
    name, n, compress = case
    jcfg, tcfg = _cfgs()
    init, want_metrics, want = jax_steps[case]
    tc = ttl.TrainConfig(optimizer=topt.OptimizerConfig(**_opt_cfg(name)),
                         num_microbatches=n, compress_grads=compress)
    state = ttl.train_state_from_arrays(init, tcfg, tc, device="cpu")
    step = ttl.make_train_step(tcfg, tc)
    for s in range(STEPS):
        state, got = step(state, _torch_batch(_batch(jcfg, s)))
        assert sorted(got) == sorted(want_metrics[s])
        for k in ("loss", "grad_norm", "lr"):
            w = want_metrics[s][k]
            assert abs(float(got[k]) - w) <= STEP_TOL * abs(w), (s, k)
    assert int(state.step) == int(want.step) == STEPS
    _assert_tree_close(state.params.leaf_tree, want.params, STEP_TOL)
    if compress:
        _assert_residuals_close(state.ef_state.residuals,
                                want.ef_state.residuals)


def _assert_residuals_close(port_tree, jax_tree):
    """The error-feedback residuals after the steps.  A residual is the
    gradient's rounding to the int8 lattice, so the gradients' ~2e-6
    disagreement shows in it at the gradient's scale (254 times the largest
    residual of a leaf), and where a value lies within that noise of a
    rounding boundary the two packages round a step apart (6-33 of 148,032
    elements here).  So: within 1e-5 of the gradient's scale everywhere but
    at most 0.1 % of the elements.  Equal inputs give equal bits
    (test_apply_error_feedback_bit_identical_to_jax)."""
    off = total = 0
    for g, w in zip(tree_leaves(port_tree), jax.tree_util.tree_leaves(
            jax_tree)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        off += int((np.abs(g.numpy() - w)
                    > STEP_TOL * 254 * np.abs(w).max()).sum())
        total += w.size
    assert off <= 1e-3 * total, (off, total)


def test_stacked_tree_is_the_jax_tree_over_the_models_storage():
    """``stack_for_training``'s tree has the JAX package's paths and
    shapes; each layer's parameter is a view of its stacked leaf, so an
    in-place update of the leaf moves the layer."""
    jcfg, tcfg = _cfgs()
    jtree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    model = TM.init_params(tcfg, 0, device="cpu")
    tree = model.stack_for_training()
    assert model.stack_for_training() is tree
    _assert_tree_close(tree_map(lambda t: np.zeros(t.shape), tree),
                       jax.tree.map(lambda s: np.zeros(s.shape), jtree), 0)
    assert all(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        tree["stack"][0]["attn"]["wq"][2].fill_(7.0)
    assert bool((model.blocks[2].attn.wq == 7.0).all())
    assert [len(m) for m in model.leaf_members] == [
        1 if t.shape == p.shape else tcfg.num_layers
        for t, p in zip(tree_leaves(tree), (m[0] for m in
                                            model.leaf_members))]


# -- the training forward -----------------------------------------------------

def test_forward_train_matches_jax_and_the_reference_loop():
    """Loss and metrics against the JAX package's forward_train, with and
    without a loss mask; remat and the plain loop agree exactly, values
    and gradients."""
    jcfg, tcfg = _cfgs()
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    model = TM.params_from_arrays(_np_tree(params), tcfg, device="cpu")
    model.stack_for_training()
    batch = _batch(jcfg, 0)
    mask = (np.random.default_rng(0).random(batch["labels"].shape) < 0.7
            ).astype(np.float32)
    for b in (batch, dict(batch, loss_mask=mask)):
        want, wm = JM.forward_train(params, jcfg,
                                    jax.tree.map(jnp.asarray, b))
        with torch.no_grad():
            got, gm = model.forward_train(_torch_batch(b))
        assert abs(float(got) - float(want)) <= STEP_TOL * float(want)
        assert sorted(gm) == sorted(wm) == ["aux_loss", "ce_loss", "loss"]
        assert float(gm["aux_loss"]) == 0.0
    tb = _torch_batch(dict(batch, loss_mask=mask))
    flat = list(model.parameters())
    grads = {}
    for label, fn in (("remat", lambda: model.forward_train(tb)),
                      ("plain", lambda: model.forward_train(tb, remat=False)),
                      ("loop", lambda: model.forward_train_reference(tb))):
        loss, _ = fn()
        grads[label] = (loss.detach(), torch.autograd.grad(loss, flat))
    for label in ("plain", "loop"):
        assert torch.equal(grads[label][0], grads["remat"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(grads[label][1], grads["remat"][1]))


def test_training_refuses_flash_mtp_and_serving_builds_no_graph():
    """The flash kernel has no backward: a forward that wants a gradient
    through it raises.  Multi-token prediction (granite-3-2b with
    ``mtp_depth=1``, one chained attention block) gives the JAX package's
    loss and ``mtp_loss`` within STEP_TOL.  The serving forwards of a
    trainable model build no graph."""
    jcfg, tcfg = _cfgs()
    model = TM.init_params(tcfg, 0, device="cpu")
    model.stack_for_training()
    x = torch.randn((1, 8, tcfg.d_model))
    pos = torch.arange(8)[None]
    with pytest.raises(RuntimeError, match="no backward"):
        model.blocks[0].attn(x, pos, use_flash=True)
    with torch.no_grad():
        model.blocks[0].attn(x, pos, use_flash=True)
    jmtp = dataclasses.replace(jcfg, mtp_depth=1)
    tmtp = dataclasses.replace(tcfg, mtp_depth=1)
    tree = cases.port_tree(TM.init_params(tmtp, 0, device="cpu"))
    cases.assert_tree_is_jax_init(tree, jmtp)
    mtp = TM.params_from_arrays(tree, tmtp, device="cpu")
    batch = _batch(jmtp, 0)
    want, wm = jax.jit(lambda p, b: JM.forward_train(p, jmtp, b))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, gm = mtp.forward_train(_torch_batch(batch))
    assert sorted(gm) == sorted(wm)
    for key in ("loss", "mtp_loss"):
        assert abs(float(gm[key]) - float(wm[key])) \
            <= STEP_TOL * float(wm[key]), key
    caches = TM.init_caches(tcfg, 1, 16, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    logits, _ = model.forward_prefill({"tokens": tokens}, caches)
    assert not logits.requires_grad
    logits, _ = model.forward_decode(torch.zeros((1, 1), dtype=torch.long),
                                     torch.tensor([8]), caches)
    assert not logits.requires_grad


# -- the other mixers and the frontends -------------------------------------

# MLA + MoE + MTP, MoE, pure SSM, the hybrid, the audio and vision stubs
FAMILIES = ["deepseek-v3-671b", "olmoe-1b-7b", "mamba2-1.3b",
            "jamba-1.5-large-398b", "hubert-xlarge", "paligemma-3b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_train_of_every_family_matches_jax(name):
    """Reduced configs, the reference's step-0 batch (tokens, or frame /
    image embeddings): every metric (cross entropy, the MoE aux loss, the
    MTP loss, the total) within STEP_TOL of the JAX package's; the plain
    layer loop gives the same loss exactly."""
    jcfg, params, _, model = cases.carried(name)
    batch = _batch(jcfg, 0)
    want, wm = cases.jax_fns(name).train(params, jax.tree.map(jnp.asarray,
                                                              batch))
    with torch.no_grad():
        got, gm = model.forward_train(_torch_batch(batch))
        ref, _ = model.forward_train_reference(_torch_batch(batch))
    assert sorted(gm) == sorted(wm)
    for key, val in wm.items():
        assert abs(float(gm[key]) - float(val)) <= STEP_TOL * abs(
            float(val)), key
    assert float(ref) == float(got)
    if jcfg.moe is not None:
        assert float(gm["aux_loss"]) > 0.0


def test_value_and_grad_of_deepseek_matches_jax():
    """Reduced deepseek-v3-671b (a dense MLA layer, then MLA + MoE layers
    with a shared expert and capacity drops, and one MTP depth): the loss
    within STEP_TOL and every gradient leaf within GRAD_TOL of its largest
    entry against ``jax.value_and_grad`` of the JAX package's
    ``forward_train``, through the port's remat train-step gradients."""
    jcfg, params, tcfg, _ = cases.carried("deepseek-v3-671b")
    batch = _batch(jcfg, 0)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b)[0]))(
            params, jax.tree.map(jnp.asarray, batch))
    model = TM.params_from_arrays(_np_tree(params), tcfg, device="cpu")
    step = ttl.make_train_step(tcfg, ttl.TrainConfig(num_microbatches=1))
    loss, _, grads = step.gradients(model, _torch_batch(batch))
    assert abs(float(loss) - float(want_loss)) <= STEP_TOL * float(want_loss)
    _assert_tree_close(grads, _np_tree(want), GRAD_TOL)
    moe = grads["stack"][1]["moe"]  # the plan: one period of 5 layers
    assert float(moe["router"].abs().max()) > 0.0
    assert float(grads["mtp"][0]["combine"].abs().max()) > 0.0


# the families' whole train steps: (arch, optimizer); deepseek-v3 trains
# under Adafactor, the reference's choice at its size
FAMILY_STEPS = [("olmoe-1b-7b", "adamw"), ("mamba2-1.3b", "adamw"),
                ("deepseek-v3-671b", "adafactor")]


def _assert_params_close(port_tree, jax_tree, init_tree, tol):
    """Every parameter leaf within ``tol`` of its largest entry, but a leaf
    that is zero at init (a norm gain stored as weight - 1, a conv bias,
    dt_bias) within ``tol`` of 1, the scale of the gain 1 + w or of the
    pre-activation it shifts.  Such a leaf holds the updates alone (at most
    the schedule's summed lr, ~2e-5 after three warm-up steps), and on
    elements whose gradient is as small as the optimizer's epsilon (~1e-8)
    the float noise of the two packages' sums decides them: up to a few
    1e-4 of the leaf's largest entry, a few 1e-9 absolute.  Their
    gradients are held at GRAD_TOL, and the updates' arithmetic at OPT_TOL
    (``test_one_update_matches_jax``)."""
    got = tree_flatten_with_path(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    init = jax.tree_util.tree_leaves(init_tree)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w), i in zip(got, want, init):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, path
        scale = 1.0 if not np.any(i) else np.abs(w).max()
        assert np.abs(g - w).max() <= tol * scale, (path, _rel(g, w))


@pytest.mark.parametrize("arch,opt", FAMILY_STEPS)
def test_train_steps_of_the_families_match_jax(arch, opt):
    """Reduced olmoe-1b-7b (the router, top-2 of 8 experts, the aux loss),
    mamba2-1.3b (the chunked SSD's backward) and deepseek-v3-671b (MLA,
    MoE with a shared expert, one MTP depth; Adafactor), from the JAX
    package's initial state: step 0's gradient, every leaf within GRAD_TOL
    of its largest entry against ``jax.grad``; STEPS whole train steps
    (gradients, clipping, schedule, update) against the JAX package's
    jitted step, every metric within STEP_TOL relative; then every
    parameter (and AdamW's master copy) within STEP_TOL
    (``_assert_params_close``), and every moment, a statistic of the
    gradients, within GRAD_TOL of its leaf's largest entry."""
    jcfg, tcfg = _cfgs(arch)
    jtc = jtl.TrainConfig(optimizer=jopt.OptimizerConfig(**_opt_cfg(opt)),
                          num_microbatches=1)
    state = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    init = _np_tree(state)
    want_grads = _np_tree(jax.jit(jax.grad(lambda p, b: JM.forward_train(
        p, jcfg, b)[0]))(state.params, jax.tree.map(jnp.asarray,
                                                    _batch(jcfg, 0))))
    tc = ttl.TrainConfig(optimizer=topt.OptimizerConfig(**_opt_cfg(opt)),
                         num_microbatches=1)
    tstate = ttl.train_state_from_arrays(init, tcfg, tc, device="cpu")
    step = ttl.make_train_step(tcfg, tc)
    _, _, grads = step.gradients(tstate.params, _torch_batch(_batch(jcfg,
                                                                    0)))
    _assert_tree_close(grads, want_grads, GRAD_TOL)
    jstep = jax.jit(jtl.make_train_step(jcfg, jtc))
    for s in range(STEPS):
        state, want = jstep(state, jax.tree.map(jnp.asarray,
                                                _batch(jcfg, s)))
        tstate, got = step(tstate, _torch_batch(_batch(jcfg, s)))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = float(w)
            assert abs(float(got[k]) - w) <= STEP_TOL * abs(w), (s, k)
    if jcfg.moe is not None:
        assert float(got["aux_loss"]) > 0.0
    if jcfg.mtp_depth:
        assert float(got["mtp_loss"]) > 0.0
    _assert_params_close(tstate.params.leaf_tree, _np_tree(state.params),
                         init.params, STEP_TOL)
    for field in state.opt_state._fields:
        want = _np_tree(getattr(state.opt_state, field))
        if field == "master":
            _assert_params_close(tstate.opt_state.master, want,
                                 init.params, STEP_TOL)
        else:
            _assert_tree_close(getattr(tstate.opt_state, field), want,
                               GRAD_TOL)


# -- learn_sigma: tests/test_differentiable.py's train step -------------------

def test_nfft_attention_learn_sigma_train_step():
    """The twin of test_nfft_attention_learn_sigma_train_step: every
    leaf's gradient finite and within GRAD_TOL of jax.grad's, log_sigma's
    nonzero; one train step moves log_sigma."""
    jcfg, tcfg = _cfgs("granite-3-2b-nfft", learn_sigma=True)
    jtc = jtl.TrainConfig(num_microbatches=1)
    state = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    batch = _batch(jcfg, 0)
    want = _np_tree(jax.jit(jax.grad(lambda p, b: JM.forward_train(
        p, jcfg, b)[0]))(state.params, jax.tree.map(jnp.asarray, batch)))
    tc = ttl.TrainConfig(num_microbatches=1)
    tstate = ttl.train_state_from_arrays(_np_tree(state), tcfg, tc,
                                         device="cpu")
    step = ttl.make_train_step(tcfg, tc)
    _, _, grads = step.gradients(tstate.params, _torch_batch(batch))
    for path, g in tree_flatten_with_path(grads):
        assert bool(torch.isfinite(g).all()), path
    _assert_tree_close(grads, want, GRAD_TOL)
    sigma = grads["stack"][0]["nfft"]["log_sigma"]
    assert sigma.shape == (tcfg.num_layers,) and bool((sigma != 0).any())
    before = tstate.params.leaf_tree["stack"][0]["nfft"]["log_sigma"].clone()
    tstate, metrics = step(tstate, _torch_batch(batch))
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["grad_norm"]))
    after = tstate.params.leaf_tree["stack"][0]["nfft"]["log_sigma"]
    assert bool((after != before).any()), "optimizer did not move log_sigma"
    assert float(after[0]) == float(tstate.params.blocks[0].nfft.log_sigma)


# -- compression --------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 257, 5000])
def test_compress_decompress_bit_identical_to_jax(n):
    """Quantization, dequantization and the residual, bit for bit, on
    values with a zero block and blocks of very different scales."""
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(
        np.float32)
    g[:min(n, 256) // 2] = 0.0
    r = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    jq, js = jcomp._quantize(jnp.asarray(g))
    tq, ts = tcomp._quantize(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for want, got in zip(jcomp.compress_decompress(jnp.asarray(g),
                                                   jnp.asarray(r)),
                         tcomp.compress_decompress(torch.from_numpy(g),
                                                   torch.from_numpy(r))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_error_feedback_bit_identical_to_jax():
    """Two rounds over the reduced model's stacked gradient tree (blocks
    of the (4, 64) norms span the layers), residuals carried."""
    jcfg, _ = _cfgs()
    params, grads, _ = _update_inputs("adamw", seed=3)
    jstate = jcomp.init_compression_state(jax.tree.map(jnp.asarray, params))
    tstate = tcomp.init_compression_state(
        tree_map(lambda a: torch.from_numpy(np.array(a)), params))
    for _ in range(2):
        jout, jstate = jcomp.apply_error_feedback(
            jax.tree.map(jnp.asarray, grads), jstate)
        tout, tstate = tcomp.apply_error_feedback(
            tree_map(lambda a: torch.from_numpy(np.array(a)), grads), tstate)
        for got, want in ((tout, jout), (tstate.residuals, jstate.residuals)):
            for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compress_psum_waits_for_distribution():
    """compress_psum is the mean over the ranks of a mesh axis, so it needs
    a mesh over an initialised process group (tests/test_torch_dist.py
    runs it on four ranks); a mesh that is only described has none."""
    with pytest.raises(RuntimeError, match="described mesh"):
        tcomp.compress_psum(torch.zeros(3), "data", torch.zeros(3),
                            Mesh({"data": 4}))


@pytest.mark.parametrize("n,seed,scale", [(1, 0, 1e-6), (300, 1, 1.0),
                                          (5000, 2, 1e6), (4097, 3, 3e2)])
def test_quantize_error_bound(n, seed, scale):
    """|x - deq(q(x))| <= max|block| / 254 per element (half a step)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)
                         * scale).float()
    q, s = tcomp._quantize(x)
    deq = tcomp._dequantize(q, s, n)
    pad = (-n) % tcomp.BLOCK
    blocks = torch.nn.functional.pad(x, (0, pad)).reshape(-1, tcomp.BLOCK)
    bound = blocks.abs().amax(dim=1) / 127.0 * 0.5 + 1e-30
    err = torch.nn.functional.pad(x - deq, (0, pad)).abs().reshape(
        -1, tcomp.BLOCK)
    assert bool((err <= bound[:, None] * 1.001).all())


def test_error_feedback_accumulates_residual():
    g = torch.tensor([1.0, 1e-6, -1e-6, 0.5])
    out, resid = tcomp.compress_decompress(g, torch.zeros_like(g))
    assert torch.allclose(out + resid, g, atol=1e-7)


def test_error_feedback_converges_quadratic():
    """SGD on a quadratic with compressed grads + EF reaches the optimum."""
    target = torch.tensor([3.0, -2.0, 0.5, 10.0])
    params = {"w": torch.zeros(4)}
    state = tcomp.init_compression_state(params)
    for _ in range(400):
        cgrads, state = tcomp.apply_error_feedback(
            {"w": params["w"] - target}, state)
        params = {"w": params["w"] - 0.1 * cgrads["w"]}
    assert torch.allclose(params["w"], target, atol=1e-3), params["w"]


def test_error_feedback_beats_no_feedback():
    """Without EF, tiny gradients are lost; with EF they accumulate."""
    g = torch.tensor([1000.0] + [0.1] * 63)
    with_ef, resid = tcomp.compress_decompress(g, torch.zeros_like(g))
    with_ef2, _ = tcomp.compress_decompress(g, resid)
    small_err_1 = float((with_ef[1:] - 0.1).abs().max())
    small_err_2 = float(((with_ef + with_ef2)[1:] / 2 - 0.1).abs().max())
    assert small_err_2 <= small_err_1 + 1e-9


# -- the command lines -------------------------------------------------------

def test_launch_train_reduced_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch granite-3-2b --reduced
    --device cpu``: the reference's lines, a finite loss, the checkpoints
    (step 0's, written before the first step as ``run_resilient``'s replay
    target, then every ``--ckpt-every`` steps and the last)."""
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "3", "--seq-len", "32", "--batch", "4",
                      "--microbatches", "2", "--compress-grads",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"arch={ARCH}-smoke params=")
    assert "device=cpu optimizer=adamw" in lines[0]
    assert lines[-1].startswith("done: 3 steps in ")
    assert math.isfinite(float(lines[-1].split("final loss ")[1].split()[0]))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000000", "step_00000002", "step_00000003"]


def test_train_lm_tiny_loss_falls(tmp_path):
    """``python -m repro_torch.train_lm --params tiny --device cpu``: 30
    steps through run_resilient, and its own assertion that the loss fell
    by more than 0.02."""
    from repro_torch import train_lm
    out = io.StringIO()
    with redirect_stdout(out):
        train_lm.main(["--params", "tiny", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    assert "loss " in out.getvalue().splitlines()[-1]


def test_trace_train_on_cpu():
    """The train-step trace CLI counts the host's operations per layer;
    the CPU has no device timeline."""
    from repro_torch.launch import trace_train
    out = trace_train.main(["--reduced", "--device", "cpu", "--seq-len",
                            "32", "--reps", "1", "--top", "4"])
    r = out["step"]
    assert out["layers"] == _cfgs()[1].num_layers
    assert r["wall_ms"] > 0 and r["host_ops_per_layer"] > 1
    assert r["device_busy_ms"] is None and r["device_events"] == 0
