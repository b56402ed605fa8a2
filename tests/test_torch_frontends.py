"""The port's modality frontends against the JAX package's.

hubert-xlarge (the audio stub: frame embeddings through one projection
into a bidirectional encoder, an untied head) and paligemma-3b (the vision
stub: image patch embeddings through one projection, in front of scaled
token embeddings, as a bidirectional prefix of a causal decoder) at their
reduced configs in float32; weights drawn by the port and carried into the
JAX package's tree (tests/_torch_lm_cases.py), numpy-seeded inputs.
``embed_inputs`` must agree within 1e-6 of its largest entry (one matrix
product); prefill logits, decode logits and the KV caches within 1e-5 of
the largest entry (sums run in another order).  The twins of
tests/test_causality.py's encoder and prefix-LM tests hold the same
properties of the port, with the same 1e-4 limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as cases
from repro.models import model as JM
from repro_torch.models import model as TM

TOL = 1e-5
EMBED_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(cfg, b, s, seed):
    return {"embeds": np.random.default_rng(seed).standard_normal(
        (b, s, cfg.frontend_dim)).astype(np.float32)}


def _vision(cfg, b, text, seed):
    rng = np.random.default_rng(seed)
    return {"image_embeds": rng.standard_normal(
                (b, cfg.num_prefix_embeds, cfg.frontend_dim)
            ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, text))}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _assert_caches(tcaches, jcaches, cfg):
    plan = JM.make_layer_plan(cfg)
    for slot, c in enumerate(jcaches["stack"]):
        for p in range(plan.n_periods):
            layer = len(plan.prefix) + p * len(plan.period) + slot
            for name in c._fields:
                got = getattr(tcaches[layer], name).numpy()
                assert cases.rel(got, getattr(c, name)[p]) <= TOL, \
                    (layer, name)


@pytest.mark.parametrize("name", ["hubert-xlarge", "paligemma-3b"])
def test_embed_inputs_matches_jax(name):
    jcfg, params, tcfg, model = cases.carried(name)
    batch = (_audio(tcfg, 2, 12, 0) if tcfg.frontend == "audio_stub"
             else _vision(tcfg, 2, 9, 0))
    jb, tb = _both(batch)
    jx, jpos, jprefix = JM.embed_inputs(params, jcfg, jb)
    x, pos, prefix = model.embed_inputs(tb)
    assert x.shape == jx.shape and x.dtype == tcfg.dtype
    assert cases.rel(x.numpy(), jx) <= EMBED_TOL
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert prefix == jprefix == tcfg.num_prefix_embeds


@pytest.mark.parametrize("use_flash", [False, True])
def test_hubert_prefill_matches_jax(use_flash):
    """The encoder's prefill, through the einsum and through the flash
    kernel's path (its plain version on the CPU, non-causal)."""
    jcfg, params, tcfg, model = cases.carried("hubert-xlarge")
    jb, tb = _both(_audio(tcfg, 2, 20, 1))
    jl, jc = cases.jax_fns("hubert-xlarge").prefill(
        params, jb, JM.init_caches(jcfg, 2, 20))
    tl, tc = model.forward_prefill(
        tb, TM.init_caches(tcfg, 2, 20, device="cpu"), use_flash=use_flash)
    assert tl.shape == (2, 1, tcfg.vocab_size)
    assert cases.rel(tl.numpy(), jl) <= TOL
    _assert_caches(tc, jc, jcfg)


def test_paligemma_prefill_and_decode_match_jax():
    """Image prefix + 9 text tokens, then four decode steps."""
    jcfg, params, tcfg, model = cases.carried("paligemma-3b")
    fns = cases.jax_fns("paligemma-3b")
    jb, tb = _both(_vision(tcfg, 2, 9, 2))
    n = tcfg.num_prefix_embeds + 9
    jl, jc = fns.prefill(params, jb, JM.init_caches(jcfg, 2, n + 4))
    tl, tc = model.forward_prefill(
        tb, TM.init_caches(tcfg, 2, n + 4, device="cpu"))
    assert cases.rel(tl.numpy(), jl) <= TOL
    rng = np.random.default_rng(3)
    for step in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1))
        pos = np.full((2,), n + step)
        jl, jc = fns.decode(params, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32), jc)
        tl, tc = model.forward_decode(torch.as_tensor(tok),
                                      torch.as_tensor(pos), tc)
        assert cases.rel(tl.numpy(), jl) <= TOL, step
    _assert_caches(tc, jc, jcfg)


def _logits(model, batch):
    x, positions, prefix_len = model.embed_inputs(batch)
    h = model.run_backbone(x, positions, mode="train", prefix_len=prefix_len)
    return model.lm_logits(h)


def test_encoder_is_bidirectional():
    """Twin of tests/test_causality.py::test_encoder_is_bidirectional:
    frames after the cut change the logits before it."""
    _, _, tcfg, model = cases.carried("hubert-xlarge")
    b, s, cut = 2, 16, 9
    rng = np.random.default_rng(6)
    e = rng.standard_normal((b, s, tcfg.frontend_dim)).astype(np.float32)
    e2 = e.copy()
    e2[:, cut:] += rng.standard_normal((b, s - cut, tcfg.frontend_dim))
    la = _logits(model, {"embeds": torch.from_numpy(e)})
    lb = _logits(model, {"embeds": torch.from_numpy(e2)})
    assert float((la[:, :cut] - lb[:, :cut]).abs().max()) > 1e-4


def test_paligemma_prefix_lm_mask():
    """Twin of tests/test_causality.py::test_paligemma_prefix_lm_mask: a
    late image patch changes early image positions; late text leaves
    earlier text unchanged."""
    _, _, tcfg, model = cases.carried("paligemma-3b")
    b, text, npx = 2, 24, tcfg.num_prefix_embeds
    rng = np.random.default_rng(7)
    img = rng.standard_normal((b, npx, tcfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (b, text))

    def logits(image, tokens):
        return _logits(model, {"image_embeds": torch.from_numpy(image),
                               "tokens": torch.as_tensor(tokens)})

    base = logits(img, toks)
    img2 = img.copy()
    img2[:, -1] += 1.0
    assert float((base[:, :2] - logits(img2, toks)[:, :2]).abs().max()) \
        > 1e-4
    cut = 10
    toks2 = toks.copy()
    toks2[:, cut:] = rng.integers(0, tcfg.vocab_size, (b, text - cut))
    alt = logits(img, toks2)
    end = npx + cut
    assert float((base[:, :end] - alt[:, :end]).abs().max()) < 1e-4
    assert float((base[:, end:] - alt[:, end:]).abs().max()) > 1e-4


def test_engine_refuses_frontends():
    """As the JAX package's serve command line: the engine serves token-only
    decoders."""
    from repro_torch.serving.engine import ServeEngine
    for name in ("hubert-xlarge", "paligemma-3b"):
        _, _, tcfg, model = cases.carried(name)
        with pytest.raises(ValueError, match="token-only"):
            ServeEngine(tcfg, model, device="cpu")
