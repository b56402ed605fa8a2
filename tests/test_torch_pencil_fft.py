"""The port's pencil-decomposed FFT (``repro_torch.dist.pencil_fft``).

``PencilSpec`` and ``resolve_pencil_spec`` against the JAX package's for
meshes (8,), (2, 4), (2, 2, 2) and (3,) at d = 1, 2 and 3; the JAX side
reads only ``mesh.shape[a]``, so a stand-in with a ``shape`` dict serves
and no process is spawned.  Then the transforms on four gloo ranks on the
CPU (one :class:`repro_torch.launch.ranks.RankPool` for the module, one
torch thread a rank): every rank spreads its own random grid, the pencils
of the summed grid go through ``pencil_rfftn``, and the assembled spectrum
must equal ``torch.fft.rfftn`` of the summed grid within 1e-12 (relative
to its largest entry), with the rfft axis's pad bins exact zeros; the
round trip ``pencil_irfftn(pencil_rfftn(p))`` and the all-gathered inverse
within 1e-12, and the multiplier sandwich ``irfftn . mult . rfftn``
symmetric within 1e-12, as ``tests/test_pencil_fft.py`` asserts for the
JAX package.
"""

import types

import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from repro.core import fastsum as jfs
from repro.dist import fastsum_dist as jdist
from repro.dist import pencil_fft as jpencil
from repro_torch.core import fastsum as tfs
from repro_torch.dist import fastsum_dist as tdist
from repro_torch.dist import pencil_fft as tpencil
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import RankPool

MESHES = {"8": {"data": 8}, "2x4": {"data": 2, "model": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}, "3": {"data": 3}}
FIELDS = ("d", "grid", "row_axes", "row_sizes", "col_axes", "col_sizes",
          "extra_axes")


def _fields(spec):
    return None if spec is None else {f: getattr(spec, f) for f in FIELDS}


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("setup", ["SETUP_1", "SETUP_2"])
def test_pencil_specs_match_jax(setup, mesh, d):
    shape = MESHES[mesh]
    axes = tuple(shape)
    stand_in = types.SimpleNamespace(shape=dict(shape))
    jplan = getattr(jfs, setup).nfft_plan(d)
    tplan = getattr(tfs, setup).nfft_plan(d)
    assert jplan.grid_size == tplan.grid_size
    assert _fields(tdist.resolve_pencil_spec(tplan, Mesh(shape), axes)) \
        == _fields(jdist.resolve_pencil_spec(jplan, stand_in, axes))
    if d >= 2:
        for pencil_axes in (None, (axes[:1], axes[1:] if d >= 3 else ())):
            try:
                want = jpencil.make_pencil_spec(
                    stand_in, axes, jplan.grid_size, d,
                    pencil_axes=pencil_axes)
            except AssertionError:  # the split does not divide the grid
                with pytest.raises(ValueError):
                    tpencil.make_pencil_spec(Mesh(shape), axes,
                                             tplan.grid_size, d,
                                             pencil_axes=pencil_axes)
                continue
            got = tpencil.make_pencil_spec(Mesh(shape), axes,
                                           tplan.grid_size, d,
                                           pencil_axes=pencil_axes)
            assert _fields(got) == _fields(want)
            assert (got.row_size, got.col_size, got.half) \
                == (want.row_size, want.col_size, want.half)
            for group in (1, 2, 3, 4, 8):
                assert got.padded_half(group) == want.padded_half(group)


def test_pencil_spec_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        tpencil.PencilSpec(d=1, grid=32, row_axes=(), row_sizes=())
    with pytest.raises(ValueError):  # d = 2 has one shardable axis
        tpencil.PencilSpec(d=2, grid=32, row_axes=("a",), row_sizes=(2,),
                           col_axes=("b",), col_sizes=(2,))
    with pytest.raises(ValueError):
        tpencil.make_pencil_spec(Mesh({"a": 2, "b": 2}), ("a", "b"), 32, 3,
                                 pencil_axes=(("a",), ("a",)))


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", threads=1) as ranks:
        yield ranks


CASES = {  # d, grid, mesh shape, pencil_axes
    "d2-slab": (2, 64, (4,), None),
    "d2-extra-axis": (2, 64, (2, 2), (("data",), ())),
    "d3-slab": (3, 32, (4,), None),
    "d3-row-group-of-two-axes": (3, 32, (2, 2), None),
    "d3-row-x-col": (3, 32, (2, 2), (("data",), ("model",))),
}


@pytest.mark.parametrize("case", CASES)
def test_pencil_transforms_match_torch_fft(pool, case):
    d, grid, shape, pencil_axes = CASES[case]
    channels, seed = 2, 5
    outs = pool.run(C.pencil, d, grid, shape, pencil_axes, seed, channels)
    total = sum(C.rhs((grid,) * d + (channels,), seed + r)
                for r in range(len(outs)))
    want = torch.fft.rfftn(torch.as_tensor(total),
                           dim=tuple(range(d))).numpy()
    half = outs[0]["half"]
    # place each rank's block: axis 1 by its row index, for d >= 3 the
    # padded rfft axis (d - 1) by its col index; ranks that differ only
    # on extra axes hold the same block
    blk = outs[0]["spectrum"].shape
    rows = max(o["row"] for o in outs) + 1
    cols = max(o["col"] for o in outs) + 1
    full_shape = list(blk)
    full_shape[1] *= rows
    if d >= 3:
        full_shape[d - 1] *= cols
    full = np.full(full_shape, np.nan, dtype=complex)
    for o in outs:
        index = [slice(None)] * len(blk)
        index[1] = slice(o["row"] * blk[1], (o["row"] + 1) * blk[1])
        if d >= 3:
            index[d - 1] = slice(o["col"] * blk[d - 1],
                                 (o["col"] + 1) * blk[d - 1])
        placed = full[tuple(index)]
        assert np.isnan(placed).all() or np.array_equal(placed,
                                                        o["spectrum"])
        full[tuple(index)] = o["spectrum"]
    rfft_axis = 1 if d == 2 else d - 1
    body = np.take(full, np.arange(half), axis=rfft_axis)
    pad = np.take(full, np.arange(half, full.shape[rfft_axis]),
                  axis=rfft_axis)
    assert not np.isnan(full).any()
    assert np.abs(body - want).max() / np.abs(want).max() < 1e-12
    assert pad.size == 0 or not pad.any()  # exact zeros
    for o in outs:
        assert o["roundtrip"] < 1e-12
        assert np.abs(o["grid"] - total).max() < 1e-12
        assert o["adjoint"] < 1e-12
    assert outs[0]["spec"][:2] == (
        (pencil_axes[0], pencil_axes[1]) if pencil_axes
        else (("data",) if len(shape) == 1 else ("data", "model"), ()))
