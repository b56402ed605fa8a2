"""Window spread/gather of the PyTorch port against the JAX package.

The port's wrappers on CPU tensors run the plain PyTorch versions; they are
held against ``repro.kernels.ref`` and the interpret-mode Pallas kernels
over the sweeps of ``tests/test_kernels_pallas.py``.  Tolerance: 1e-12 in
float64 (only the summation order differs), 1e-5 relative in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import nfft_window as jwin
from repro.kernels import ref
from repro_torch.kernels import nfft_window as twin
from repro_torch.launch.roofline import TraceCounter

SHAPES = [(100, 1, 9, 512), (257, 2, 9, 64), (120, 3, 5, 40)]
CHANNEL_SHAPES = [(100, 1, 9, 512, 3), (140, 2, 9, 64, 4), (90, 3, 5, 40, 2)]


def _tol(dtype):
    return 1e-5 if dtype == np.float32 else 1e-12


def _geom(rng, n, d, taps, padded, dtype):
    base = rng.integers(0, padded - taps + 1, (n, d)).astype(np.int32)
    w = rng.normal(size=(n, d, taps)).astype(dtype)
    return base, w


def _close(got, want, dtype):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= _tol(dtype) * scale


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain path: no kernel launch is ever counted."""
    twin.window_spread.launches = twin.window_gather.launches = 0
    yield
    assert twin.window_spread.launches == 0
    assert twin.window_gather.launches == 0


@pytest.mark.parametrize("n,d,taps,padded", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_matches_ref_and_pallas(n, d, taps, padded, dtype):
    rng = np.random.default_rng(n + d)
    base, w = _geom(rng, n, d, taps, padded, dtype)
    g = rng.normal(size=(padded,) * d).astype(dtype)
    got = twin.window_gather(torch.as_tensor(g[..., None]),
                             torch.as_tensor(base), torch.as_tensor(w))
    assert got.shape == (n, 1) and got.dtype == torch.as_tensor(g).dtype
    want = np.asarray(ref.window_gather_ref(jnp.asarray(g), jnp.asarray(base),
                                            jnp.asarray(w)))
    _close(got.numpy()[:, 0], want, dtype)
    pallas = np.asarray(jwin.window_gather(
        jnp.asarray(g), jnp.asarray(base), jnp.asarray(w), node_tile=128,
        interpret=True))
    _close(got.numpy()[:, 0], pallas, dtype)


@pytest.mark.parametrize("n,d,taps,padded", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spread_matches_ref_and_pallas(n, d, taps, padded, dtype):
    rng = np.random.default_rng(n * d)
    base, w = _geom(rng, n, d, taps, padded, dtype)
    x = rng.normal(size=(n,)).astype(dtype)
    got = twin.window_spread(torch.as_tensor(x[:, None]), torch.as_tensor(base),
                             torch.as_tensor(w), padded_size=padded)
    assert got.shape == (padded,) * d + (1,)
    want = np.asarray(ref.window_spread_ref(
        jnp.asarray(x), jnp.asarray(base), jnp.asarray(w), padded))
    _close(got.numpy()[..., 0], want, dtype)
    pallas = np.asarray(jwin.window_spread(
        jnp.asarray(x), jnp.asarray(base), jnp.asarray(w), padded_size=padded,
        node_tile=128, interpret=True))
    _close(got.numpy()[..., 0], pallas, dtype)


@pytest.mark.parametrize("n,d,taps,padded,c", CHANNEL_SHAPES)
def test_batched_channels_match_ref(n, d, taps, padded, c):
    rng = np.random.default_rng(7 * n + c)
    base, w = _geom(rng, n, d, taps, padded, np.float64)
    g = rng.normal(size=(padded,) * d + (c,))
    x = rng.normal(size=(n, c))
    tb, tw = torch.as_tensor(base), torch.as_tensor(w)
    got_g = twin.window_gather(torch.as_tensor(g), tb, tw).numpy()
    got_s = twin.window_spread(torch.as_tensor(x), tb, tw,
                               padded_size=padded).numpy()
    jb, jw = jnp.asarray(base), jnp.asarray(w)
    _close(got_g, np.asarray(ref.window_gather_ref(jnp.asarray(g), jb, jw)),
           np.float64)
    _close(got_s, np.asarray(ref.window_spread_ref(jnp.asarray(x), jb, jw,
                                                   padded)), np.float64)
    for i in range(c):  # each channel equals its own single-channel run
        one = twin.window_gather(torch.as_tensor(g[..., i:i + 1]), tb, tw)
        np.testing.assert_allclose(got_g[:, i], one.numpy()[:, 0],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("d,taps,padded", [(1, 9, 256), (2, 9, 64), (3, 5, 40)])
def test_spread_gather_adjoint(d, taps, padded):
    """<gather(g), x> == <g, spread(x)>."""
    rng = np.random.default_rng(d)
    base, w = _geom(rng, 200, d, taps, padded, np.float64)
    tb, tw = torch.as_tensor(base), torch.as_tensor(w)
    g = torch.as_tensor(rng.normal(size=(padded,) * d + (2,)))
    x = torch.as_tensor(rng.normal(size=(200, 2)))
    lhs = float((twin.window_gather(g, tb, tw) * x).sum())
    rhs = float((g * twin.window_spread(x, tb, tw, padded_size=padded)).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_plain_chunking_is_invisible(monkeypatch):
    """Chunked plain versions equal the one-chunk result."""
    rng = np.random.default_rng(3)
    base, w = _geom(rng, 300, 2, 9, 64, np.float64)
    tb, tw = torch.as_tensor(base), torch.as_tensor(w)
    g = torch.as_tensor(rng.normal(size=(64, 64, 2)))
    x = torch.as_tensor(rng.normal(size=(300, 2)))
    whole_g = twin.window_gather(g, tb, tw)
    whole_s = twin.window_spread(x, tb, tw, padded_size=64)
    monkeypatch.setattr(twin, "_PLAIN_CUBE_ELEMS", 81 * 7)  # 7 nodes a chunk
    np.testing.assert_allclose(twin.window_gather(g, tb, tw).numpy(),
                               whole_g.numpy(), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        twin.window_spread(x, tb, tw, padded_size=64).numpy(),
        whole_s.numpy(), rtol=1e-13, atol=1e-13)


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(0)
    base, w = _geom(rng, 10, 2, 5, 16, np.float64)
    tb, tw = torch.as_tensor(base), torch.as_tensor(w)
    x = torch.zeros((10, 1), dtype=torch.float64)
    g = torch.zeros((16, 16, 1), dtype=torch.float64)
    with pytest.raises(TypeError):  # base must be int32
        twin.window_spread(x, tb.long(), tw, padded_size=16)
    with pytest.raises(TypeError):  # weights and values share a dtype
        twin.window_gather(g.float(), tb, tw)
    with pytest.raises(ValueError):  # x must be (n, C)
        twin.window_spread(x[:, 0], tb, tw, padded_size=16)
    with pytest.raises(ValueError):  # grid rank must be d + 1
        twin.window_gather(g[..., 0], tb, tw)
    with pytest.raises(ValueError):  # d = 4 has no kernel
        twin.window_gather(torch.zeros((8,) * 4 + (1,), dtype=torch.float64),
                           torch.zeros((2, 4), dtype=torch.int32),
                           torch.zeros((2, 4, 3), dtype=torch.float64))
    # meta (the dry run) takes no silent fallback either: the plain version
    # does not run, the result is a meta grid of the kernel's shape, and
    # the launch is the trace counter's (the card's count, which the
    # fixture checks, stays 0)
    with TraceCounter() as counter:
        grid = twin.window_spread(x.to("meta"), tb.to("meta"),
                                  tw.to("meta"), padded_size=16)
    assert grid.device.type == "meta" and tuple(grid.shape) == (16, 16, 1)
    assert counter.kernels["window_spread"]["launches"] == 1
