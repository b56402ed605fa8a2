"""The window kernels' tile plan, and their tile arithmetic, on the CPU.

``build_tile_plan`` cuts a geometry's rows into tiles whose windows' box
fits the shared-memory budget; the CUDA spread sums each tile's windows
into its box and adds the box onto the grid at its corner, and the CUDA
gather contracts each node's window out of its tile's box.  Here the plan's
invariants are checked on the geometries the paths build, and both kernels'
arithmetic is emulated tile by tile in PyTorch through the plan and held
against the plain versions, ``repro.kernels.ref`` and the JAX package's
Pallas kernels in interpret mode (as ``tests/test_kernels_pallas.py`` runs
them); the deterministic spread's waves, boxes, chunks and partials
likewise, through the plan's output-block index.  Tolerances: 1e-12
relative to the largest output entry in float64 (only the order of the
sums differs), 1e-5 in float32.
"""

import hashlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import nfft_window as jwin
from repro.kernels import ref
from repro_torch.core import fastsum as tfs
from repro_torch.core import fastsum_exec as tex
from repro_torch.core.kernels import make_kernel
from repro_torch.core.nfft import (
    NfftPlan, WindowGeometry, build_window_geometry, padded_grid_size,
)
from repro_torch.data.synthetic import crescent_fullmoon, spiral
from repro_torch.kernels import nfft_window as twin

# the module: ``repro_torch.core`` re-exports the function ``lanczos``
# under its name, as ``repro.core`` does
tlan = importlib.import_module("repro_torch.core.lanczos")


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-12


def _geometry(kind, setup_name, d, n):
    """(NFFT plan, geometry) as the paths build them; "ssl" is the SSL
    path's crescent-fullmoon at N=128, m=3, d=2."""
    if kind == "ssl":
        pts, _ = crescent_fullmoon(n, seed=0)
        params = tfs.FastsumParams(n_bandwidth=128, m=3, eps_b=0.0)
    else:
        if kind == "uniform":
            pts = np.random.default_rng(0).uniform(-1, 1, (n, d))
        else:
            pts, _ = spiral(n, seed=0)
        params = getattr(tfs, setup_name)
    pts = torch.as_tensor(pts[:, :d])
    scaled, _, _ = tfs.scale_nodes(pts, params.eps_b_eff)
    plan = params.nfft_plan(d)
    return plan, build_window_geometry(plan, scaled, sort=kind != "unsorted")


def _gather_channels(tiles, dtype, c):
    """(n_tiles,) channels of one gather pass over each tile's box, as the
    CUDA gather picks them: ``gather_chunk(c)`` halved until the box fits
    the block's box memory, min(BOX_BYTES, the largest box at
    ``gather_chunk(c)`` channels)."""
    s, chunk = (8 if dtype == torch.float64 else 4), twin.gather_chunk(c)
    alloc = min(twin.BOX_BYTES, tiles.max_cells * chunk * s)
    cells = tiles.table[:, 5:8].to(torch.long).prod(dim=1)
    out = torch.full_like(cells, chunk)
    while chunk > 1:
        out[cells * out * s > alloc] //= 2
        chunk //= 2
    return out


def _tile_rows(table):
    """(rows, tile index) of every (row, tile) pair of a plan's table."""
    start, count = table[:, 0], table[:, 1]
    tile = torch.repeat_interleave(torch.arange(len(table)), count)
    offset = torch.arange(len(tile)) - (torch.cumsum(count, 0) - count)[tile]
    return start[tile] + offset, tile


def _check_plan(tiles, base, taps):
    """Every invariant the kernels rely on."""
    n, d = base.shape
    t = tiles.table.long()
    assert tiles.table.dtype == torch.int32 and tiles.table.shape[1] == 11
    assert (tiles.n, tiles.d, tiles.taps) == (n, d, taps)
    start, count = t[:, 0], t[:, 1]
    corner, ext, first = t[:, 2:5], t[:, 5:8], t[:, 8:11]
    # each row in exactly one tile, or in one run of consecutive pieces of
    # its window (single-row tiles with the same start), in order
    head = torch.ones(len(t), dtype=torch.bool)
    head[1:] = start[1:] != start[:-1]
    assert int(start[0]) == 0 and int(count[head].sum()) == n
    assert torch.equal(start[head][1:], (start + count)[head][:-1])
    assert bool((count[~head] == 1).all())
    assert bool((count >= 1).all())
    # a plan of pieces has the same number for every row, one row a tile
    runs = torch.diff(torch.cat([torch.nonzero(head)[:, 0],
                                 torch.tensor([len(t)])]))
    assert bool((runs == tiles.pieces).all())
    assert tiles.pieces == 1 or tiles.max_rows == 1
    assert int(count.max()) == tiles.max_rows <= twin.tile_rows(d, taps)
    assert tiles.max_rows * d * taps <= max(twin.TILE_WEIGHTS, d * taps)
    # unused axes: corner 0, extent 1, first tap 0
    assert bool((corner[:, d:] == 0).all() and (ext[:, d:] == 1).all()
                and (first[:, d:] == 0).all())
    # a tile covers the taps [first, first + span) of each axis
    span = torch.minimum(ext[:, :d], taps - first[:, :d])
    assert bool((first[:, :d] >= 0).all() and (span >= 1).all())
    # each box holds those taps of every window of its tile ...
    rows, tile = _tile_rows(t)
    lo = base.long()[rows] + first[tile, :d]
    assert bool((lo >= corner[tile, :d]).all())
    assert bool((lo + span[tile] <= corner[tile, :d] + ext[tile, :d]).all())
    # ... and a row's tiles cover each cell of its window once
    volume = torch.zeros(n, dtype=torch.long).index_add_(
        0, rows, span.prod(dim=1)[tile])
    assert bool((volume == taps ** d).all())
    for r in {0, n - 1}:
        seen = torch.zeros((taps,) * d, dtype=torch.long)
        for i in tile[rows == r].tolist():
            seen[tuple(slice(f, f + s) for f, s in
                       zip(first[i, :d].tolist(), span[i].tolist()))] += 1
        assert bool((seen == 1).all())
    # ... and fits the budget, in both types, at the gather's channels
    cells = ext.prod(dim=1)
    assert int(cells.max()) == tiles.max_cells <= twin.BOX_CELLS
    for dtype in (torch.float64, torch.float32):
        for c in (1, 3, 4, 16):
            chunk = twin.gather_chunk(c)
            per_tile = _gather_channels(tiles, dtype, c)
            assert chunk <= 2 * min(c, twin.KERNEL_CHUNK)
            assert bool((per_tile >= 1).all() and (per_tile <= chunk).all())
            assert bool(((per_tile & (per_tile - 1)) == 0).all())
            itemsize = 8 if dtype == torch.float64 else 4
            assert int((cells * per_tile).max()) * itemsize <= twin.BOX_BYTES


def _covered(rest, d, taps):
    """(corner, extent, first taps, tap spans) of a table row's tail."""
    corner, ext, first = rest[:d], rest[3:3 + d], rest[6:6 + d]
    return corner, ext, first, [min(e, taps - f) for e, f in zip(ext, first)]


def _emulate_spread(x, base, weights, padded_size, tiles, chunk):
    """The spread kernel's arithmetic, tile by tile: each tile's windows
    (the taps it covers) summed into its box in row order, the box added
    at its corner."""
    n, d, taps = weights.shape
    c = x.shape[1]
    grid = torch.zeros((padded_size,) * d + (c,), dtype=x.dtype)
    cube = twin._weight_cube(weights)  # (n, taps^d)
    for start, count, *rest in tiles.table.tolist():
        corner, ext, first, span = _covered(rest, d, taps)
        taps_at = tuple(slice(f, f + s) for f, s in zip(first, span))
        for c0 in range(0, c, chunk):
            cc = min(chunk, c - c0)
            box = torch.zeros(ext + [cc], dtype=x.dtype)
            for r in range(start, start + count):
                lo = [int(base[r, a]) + first[a] - corner[a]
                      for a in range(d)]
                patch = tuple(slice(v, v + s) for v, s in zip(lo, span))
                box[patch] += (cube[r].reshape((taps,) * d)[taps_at][..., None]
                               * x[r, c0:c0 + cc])
            at = tuple(slice(v, v + e) for v, e in zip(corner, ext))
            grid[at + (slice(c0, c0 + cc),)] += box
    return grid


def _emulate_gather(grid, base, weights, tiles, chunk=None):
    """The gather kernel's arithmetic: each tile's box read once per pass of
    ``chunk`` channels (by default the kernel's per-tile choice), each node
    contracted from it, the last axis innermost; the pieces of a row's
    window added in table order."""
    n, d, taps = weights.shape
    c = grid.shape[-1]
    out = torch.zeros((n, c), dtype=grid.dtype)
    chunks = _gather_channels(tiles, grid.dtype, c).tolist()
    for t, (start, count, *rest) in enumerate(tiles.table.tolist()):
        corner, ext, first, span = _covered(rest, d, taps)
        chunk = chunks[t] if chunk is None else chunk
        for c0 in range(0, c, chunk):
            cc = min(chunk, c - c0)
            at = tuple(slice(v, v + e) for v, e in zip(corner, ext))
            box = grid[at + (slice(c0, c0 + cc),)]
            for r in range(start, start + count):
                lo = [int(base[r, a]) + first[a] - corner[a]
                      for a in range(d)]
                acc = box[tuple(slice(v, v + s) for v, s in zip(lo, span))]
                for a in range(d - 1, -1, -1):  # last axis first
                    acc = torch.tensordot(
                        acc, weights[r, a, first[a]:first[a] + span[a]],
                        dims=([a], [0]))
                out[r, c0:c0 + cc] += acc
    return out


def _tile_boxes(x, base, weights, tiles):
    """Every tile's box, all C channels: its windows (the taps it covers)
    summed in row order, as phase A of the deterministic spread stores
    it."""
    n, d, taps = weights.shape
    cube = twin._weight_cube(weights)
    boxes = []
    for start, count, *rest in tiles.table.tolist():
        corner, ext, first, span = _covered(rest, d, taps)
        taps_at = tuple(slice(f, f + s) for f, s in zip(first, span))
        box = torch.zeros(ext + [x.shape[1]], dtype=x.dtype)
        for r in range(start, start + count):
            lo = [int(base[r, a]) + first[a] - corner[a] for a in range(d)]
            patch = tuple(slice(v, v + s) for v, s in zip(lo, span))
            box[patch] += (cube[r].reshape((taps,) * d)[taps_at][..., None]
                           * x[r])
        boxes.append(box)
    return boxes


def _emulate_deterministic_spread(x, base, weights, padded_size, tiles):
    """The deterministic spread's arithmetic, wave by wave through the
    plan's output-block index: phase A stores each tile's box (summed in
    row order, all channels) in the wave's scratch at its offset, C order;
    phase B gives each chunk the sum, over its output block, of its tiles'
    boxes in ascending tile order, and each output block the sum of its
    chunks' partials in chunk order, stored onto the grid in the first
    wave and added to it after."""
    n, d, taps = weights.shape
    c = x.shape[1]
    index = twin.spread_block_index(tiles, padded_size, c, x.element_size())
    side, blocks = index.side, index.blocks
    grid = torch.zeros((padded_size,) * d + (c,), dtype=x.dtype)
    boxes = _tile_boxes(x, base, weights, tiles)
    table, box_off = tiles.table.tolist(), index.box_off.tolist()
    pair_tile, chunks = index.pair_tile.tolist(), index.chunks.tolist()
    for w, (t0, t1, ch0, ch1, _) in enumerate(index.waves.tolist()):
        scratch = torch.full((index.scratch_cells, c), float("nan"),
                             dtype=x.dtype)
        for t in range(t0, t1):
            cells = boxes[t][..., 0].numel()
            scratch[box_off[t]:box_off[t] + cells] = boxes[t].reshape(-1, c)
        partials = {}
        for block, first, count, k, nk, _ in chunks[ch0:ch1]:
            origin = [(block // blocks ** (d - 1 - a)) % blocks * side
                      for a in range(d)]
            acc = torch.zeros((side,) * d + (c,), dtype=x.dtype)
            for t in pair_tile[first:first + count]:
                corner, ext = table[t][2:2 + d], table[t][5:5 + d]
                box = scratch[box_off[t]:box_off[t] + int(np.prod(ext))]
                box = box.reshape(ext + [c])
                lo = [max(corner[a], origin[a]) for a in range(d)]
                hi = [min(corner[a] + ext[a], origin[a] + side)
                      for a in range(d)]
                acc[tuple(slice(lo[a] - origin[a], hi[a] - origin[a])
                          for a in range(d))] += box[tuple(
                              slice(lo[a] - corner[a], hi[a] - corner[a])
                              for a in range(d))]
            partials.setdefault(block, []).append((k, nk, origin, acc))
        for parts in partials.values():
            assert [k for k, *_ in parts] == list(range(parts[0][1]))
            total = torch.zeros_like(parts[0][3])
            for *_, acc in parts:
                total += acc
            origin = parts[0][2]
            at = tuple(slice(o, min(o + side, padded_size)) for o in origin)
            clip = tuple(slice(0, v.stop - v.start) for v in at)
            grid[at] = total[clip] if w == 0 else grid[at] + total[clip]
    return grid


def _close(got, want, dtype):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _tol(dtype) * max(scale, 1e-300)


# -- the plan ---------------------------------------------------------------

PLAN_CASES = ([("spiral", s, d) for s in ("SETUP_2", "SETUP_3")
               for d in (1, 2, 3)]
              + [("unsorted", s, d) for s in ("SETUP_2", "SETUP_3")
                 for d in (1, 2, 3)]
              + [("uniform", "SETUP_3", 3), ("ssl", None, 2)])


@pytest.mark.parametrize("kind,setup_name,d", PLAN_CASES)
def test_plan_invariants_on_path_geometries(kind, setup_name, d):
    plan, geom = _geometry(kind, setup_name, d, 5000)
    _check_plan(geom.tiles, geom.base, plan.taps)


@pytest.mark.parametrize("n", [1, 37, 64, 65])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_plan_invariants_on_small_and_ragged_row_counts(n, d):
    base = torch.as_tensor(
        np.random.default_rng(n).integers(0, 40, (n, d)), dtype=torch.int32)
    _check_plan(twin.build_tile_plan(base, 7), base, 7)


def test_all_nodes_on_one_corner_make_full_tiles():
    base = torch.full((1000, 3), 11, dtype=torch.int32)
    tiles = twin.build_tile_plan(base, 15)
    _check_plan(tiles, base, 15)
    assert tiles.n_tiles == 16 and tiles.max_cells == 15 ** 3
    assert tiles.table[:, 1].tolist() == [64] * 15 + [40]


def test_boxes_over_budget_split_down_to_single_rows():
    """Far-apart corners: no two windows share a box, every tile is one
    row, and its box is one window."""
    base = torch.as_tensor([[0, 0, 0], [60, 60, 60]] * 8, dtype=torch.int32)
    tiles = twin.build_tile_plan(base, 15)
    _check_plan(tiles, base, 15)
    assert tiles.n_tiles == 16 and tiles.max_rows == 1
    assert tiles.max_cells == 15 ** 3


def test_wide_windows_take_fewer_rows_per_tile():
    base = torch.zeros((300, 1), dtype=torch.int32)
    tiles = twin.build_tile_plan(base, 101)  # 64 * 101 > TILE_WEIGHTS
    _check_plan(tiles, base, 101)
    assert tiles.max_rows == twin.tile_rows(1, 101) == 32


def _random_base(n, d, taps, padded, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, padded - taps + 1, (n, d)), dtype=torch.int32)


@pytest.mark.parametrize("d,taps", [(3, 19), (2, 79), (1, twin.BOX_CELLS + 1)])
def test_no_plan_when_one_window_exceeds_the_budget(d, taps):
    """No tile holds such a window whole: the plan cuts each row's window
    along its first axis into slabs that fit, one single-row tile each."""
    base = _random_base(4, d, taps, taps + 30, taps)
    tiles = twin.build_tile_plan(base, taps)
    _check_plan(tiles, base, taps)
    lengths = twin.piece_lengths(d, taps)
    assert lengths[0] < taps and lengths[1:] == (taps,) * (d - 1)
    slabs = -(-taps // lengths[0])
    assert slabs == 2 and tiles.n_tiles == 4 * slabs and tiles.max_rows == 1
    assert tiles.max_cells == lengths[0] * taps ** (d - 1) <= twin.BOX_CELLS
    first = tiles.table[:, 8].view(4, slabs)
    assert first.tolist() == [[0, lengths[0]]] * 4


@pytest.mark.parametrize("d,taps,lengths", [
    (3, 19, (17, 19, 19)), (3, 33, (5, 33, 33)), (3, 80, (1, 76, 80)),
    (2, 79, (77, 79)), (2, 6145, (1, 6144)),
    (1, twin.BOX_CELLS + 1, (twin.BOX_CELLS,)), (3, 15, (15, 15, 15))])
def test_piece_lengths_cut_the_leading_axes_least(d, taps, lengths):
    assert twin.piece_lengths(d, taps) == lengths
    cells = 1
    for n in lengths:
        cells *= n
    assert cells <= twin.BOX_CELLS


@pytest.mark.parametrize("d,taps", [(3, 19), (3, 33), (3, 80), (2, 79),
                                    (1, twin.BOX_CELLS + 1)])
def test_piece_plans_cover_every_window_once(d, taps):
    """Pieces over two axes too (d = 3, taps 80: one tap of the first axis
    is 6,400 cells), and a plan whose last piece is dropped fails the
    checks."""
    base = _random_base(5, d, taps, taps + 20, d + taps)
    tiles = twin.build_tile_plan(base, taps)
    _check_plan(tiles, base, taps)
    pieces = tiles.n_tiles // 5
    assert pieces == np.prod([-(-taps // n)
                              for n in twin.piece_lengths(d, taps)])
    cut = twin.TilePlan(tiles.table[:-1], tiles.n, d, taps, tiles.max_cells,
                        tiles.max_rows)
    with pytest.raises(AssertionError):
        _check_plan(cut, base, taps)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d,taps,padded,n", [
    (3, 19, 40, 12), (3, 33, 45, 4), (3, 80, 84, 2), (2, 79, 100, 9),
    (1, twin.BOX_CELLS + 1, twin.BOX_CELLS + 40, 7)])
def test_tile_emulation_on_piece_plans_matches_plain(d, taps, padded, n,
                                                     dtype):
    base = _random_base(n, d, taps, padded, n)
    tiles = twin.build_tile_plan(base, taps)
    rng = np.random.default_rng(taps)
    w = torch.as_tensor(rng.normal(size=(n, d, taps)), dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype)
    g = torch.as_tensor(rng.normal(size=(padded,) * d + (3,)), dtype=dtype)
    _close(_emulate_spread(x, base, w, padded, tiles, twin.SPREAD_CHUNK),
           twin.window_spread_plain(x, base, w, padded_size=padded), dtype)
    _close(_emulate_gather(g, base, w, tiles),
           twin.window_gather_plain(g, base, w), dtype)


# sha256 of the first 8 columns of the tile plan of the main path's spiral
# (n = 5000, first d coordinates) as built before window pieces existed:
# the plans of every geometry whose windows fit must not change
MAIN_PATH_PLANS = {
    ("SETUP_2", 1): "6d41a97d9dd491c9b8aeaf837731c63d102e74fb766517468e403e2280d6f931",
    ("SETUP_2", 2): "999297b8dff4740a5d611f8b5533f5b33391bfd0f0bbdabb3b70d33392b150a0",
    ("SETUP_2", 3): "a29305ef298ec69ae2eaaedc8bed418b5ed09b58d1464d328ac13907f39f0ce9",
    ("SETUP_3", 1): "ca033ae11b1da2e42c4d55bf0960ecc9ebe1a338bfa64843e2e2cd48cc6d0a70",
    ("SETUP_3", 2): "27b8ab1bacbf6265515009362bb1750bfef7eb1260228592cb38897e07b9dd09",
    ("SETUP_3", 3): "8dd0fa5cc7b28e0f422ab15754500e1646a7e2086b65068b300f5731d1f32f54",
}


def test_wrappers_check_a_pieced_plan():
    base = _random_base(6, 3, 19, 40, 1)
    w = torch.ones((6, 3, 19), dtype=torch.float64)
    tiles = twin.build_tile_plan(base, 19)
    assert tiles.pieces == 2 and tiles.n_tiles == 12
    x = torch.ones((6, 1), dtype=torch.float64)
    got = twin.window_spread(x, base, w, padded_size=40, tiles=tiles)
    assert torch.equal(got, twin.window_spread_plain(x, base, w,
                                                     padded_size=40))
    for bad in (twin.TilePlan(tiles.table, 6, 3, 19, tiles.max_cells, 1, 3),
                twin.TilePlan(tiles.table[:-2], 6, 3, 19, tiles.max_cells, 1,
                              2)):
        with pytest.raises(ValueError, match="pieces a row"):
            twin.window_spread(x, base, w, padded_size=40, tiles=bad)


@pytest.mark.parametrize("setup_name,d", sorted(MAIN_PATH_PLANS))
def test_main_path_plans_are_unchanged(setup_name, d):
    plan, geom = _geometry("spiral", setup_name, d, 5000)
    table = geom.tiles.table
    digest = hashlib.sha256(table[:, :8].contiguous().numpy().tobytes())
    assert digest.hexdigest() == MAIN_PATH_PLANS[(setup_name, d)]
    assert bool((table[:, 8:] == 0).all()) and geom.tiles.pieces == 1


def test_invariants_catch_a_shrunk_box_and_a_dropped_row():
    """The checks above fail on the two faults a plan could have."""
    plan, geom = _geometry("spiral", "SETUP_3", 3, 3000)
    good = geom.tiles
    shrunk = good.table.clone()
    shrunk[:, 7] -= 1  # every box one cell short on its last axis
    dropped = good.table.clone()
    dropped[0, 1] -= 1  # the first tile loses its last row
    for table in (shrunk, dropped):
        bad = twin.TilePlan(table, good.n, good.d, good.taps,
                            good.max_cells, good.max_rows)
        with pytest.raises(AssertionError):
            _check_plan(bad, geom.base, plan.taps)


# -- the tile arithmetic ----------------------------------------------------

EMULATION_CASES = [("spiral", "SETUP_2", 3), ("spiral", "SETUP_3", 3),
                   ("spiral", "SETUP_3", 2), ("spiral", "SETUP_3", 1),
                   ("unsorted", "SETUP_3", 3), ("uniform", "SETUP_3", 3),
                   ("ssl", None, 2)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,setup_name,d", EMULATION_CASES)
def test_tile_emulation_matches_plain(kind, setup_name, d, dtype):
    plan, geom = _geometry(kind, setup_name, d, 600)
    pad = padded_grid_size(plan)
    base, w, tiles = geom.base, geom.weights.to(dtype), geom.tiles
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.normal(size=(600, 3)), dtype=dtype)
    g = torch.as_tensor(rng.normal(size=(pad,) * d + (3,)), dtype=dtype)
    _close(_emulate_spread(x, base, w, pad, tiles, min(3, twin.SPREAD_CHUNK)),
           twin.window_spread_plain(x, base, w, padded_size=pad), dtype)
    _close(_emulate_gather(g, base, w, tiles),
           twin.window_gather_plain(g, base, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_emulation_in_channel_chunks(dtype):
    """C = 16 takes four spread passes of 4 channels, and gather passes of
    the kernel's per-tile width; a chunk of 3 forces a ragged last pass."""
    plan, geom = _geometry("spiral", "SETUP_2", 3, 400)
    pad = padded_grid_size(plan)
    base, w, tiles = geom.base, geom.weights.to(dtype), geom.tiles
    rng = np.random.default_rng(16)
    x = torch.as_tensor(rng.normal(size=(400, 16)), dtype=dtype)
    g = torch.as_tensor(rng.normal(size=(pad,) * 3 + (16,)), dtype=dtype)
    want_s = twin.window_spread_plain(x, base, w, padded_size=pad)
    want_g = twin.window_gather_plain(g, base, w)
    for spread_chunk, gather_chunk in ((twin.SPREAD_CHUNK, None), (3, 3)):
        _close(_emulate_spread(x, base, w, pad, tiles, spread_chunk), want_s,
               dtype)
        _close(_emulate_gather(g, base, w, tiles, gather_chunk), want_g,
               dtype)


def _det_case(case):
    """(x, base, weights, padded size, plan) of a deterministic-spread
    case, float64: the spiral's geometries at n = 300, or a d = 3, m = 9
    plan of window pieces on 12 random corners."""
    if case == "m9 pieces":
        plan = NfftPlan(d=3, n_bandwidth=8, m=9)
        pad = padded_grid_size(plan)
        base = _random_base(12, 3, plan.taps, pad, 4)
        w = torch.as_tensor(np.random.default_rng(5).normal(
            size=(12, 3, plan.taps)))
        x = torch.as_tensor(np.random.default_rng(6).normal(size=(12, 2)))
        tiles = twin.build_tile_plan(base, plan.taps)
        assert tiles.pieces > 1
        return x, base, w, pad, tiles
    kind, setup_name, d, c = case
    plan, geom = _geometry(kind, setup_name, d, 300)
    x = torch.as_tensor(np.random.default_rng(c).normal(size=(300, c)))
    return x, geom.base, geom.weights, padded_grid_size(plan), geom.tiles


# the cases of both deterministic-spread tests: (kind, setup, d, C), the
# m = 9 pieces, and "waves": SETUP_2 d=3 with the scratch cap cut to
# force waves
DETERMINISTIC_CASES = [("spiral", "SETUP_2", 3, 5), ("spiral", "SETUP_3", 2, 1),
                       ("spiral", "SETUP_3", 1, 3), "m9 pieces", "waves",
                       ("uniform", "SETUP_3", 2, 2), ("unsorted", "SETUP_2", 3, 1),
                       ("ssl", None, 2, 1)]


def _det_setup(case, monkeypatch):
    if case != "waves":
        return _det_case(case)
    x, base, w, pad, tiles = _det_case(("spiral", "SETUP_2", 3, 2))
    largest = int(tiles.table[:, 5:8].to(torch.long).prod(dim=1).max())
    cells = int(tiles.table[:, 5:8].to(torch.long).prod(dim=1).sum())
    # about a quarter of the plan's boxes a wave, at least the largest box
    cap = max(largest, cells // 4) * x.shape[1] * 8
    monkeypatch.setattr(twin, "DET_SCRATCH_BYTES", cap)
    return x, base, w, pad, tiles


@pytest.mark.parametrize("case", DETERMINISTIC_CASES, ids=str)
def test_deterministic_spread_emulation_matches_plain_ref_and_pallas(
        case, monkeypatch):
    """float64: within 1e-13 of the plain spread, repro.kernels.ref and the
    Pallas spread in interpret mode (relative to the largest entry), and
    two runs bitwise equal."""
    x, base, w, pad, tiles = _det_setup(case, monkeypatch)
    got = _emulate_deterministic_spread(x, base, w, pad, tiles)
    if case == "waves":
        assert twin.spread_block_index(tiles, pad, x.shape[1],
                                       8).n_waves >= 3
    want = twin.window_spread_plain(x, base, w, padded_size=pad)
    jb, jw, jx = (jnp.asarray(base.numpy()), jnp.asarray(w.numpy()),
                  jnp.asarray(x.numpy()))
    refs = [want, torch.as_tensor(np.array(
        ref.window_spread_ref(jx, jb, jw, pad)))]
    if case in ("m9 pieces", "waves") or case[0] == "spiral":
        refs.append(torch.as_tensor(np.array(jwin.window_spread(
            jx, jb, jw, padded_size=pad, node_tile=128, interpret=True))))
    for r in refs:
        assert float((got - r).abs().max()) <= 1e-13 * float(r.abs().max())
    again = _emulate_deterministic_spread(x, base, w, pad, tiles)
    assert torch.equal(got, again)


def _blocks_met(table_row, d, side, blocks):
    """The flat output blocks a tile's box meets."""
    corner, ext = table_row[2:2 + d], table_row[5:5 + d]
    ranges = [range(corner[a] // side, (corner[a] + ext[a] - 1) // side + 1)
              for a in range(d)]
    out = [0]
    for r in ranges:
        out = [o * blocks + b for o in out for b in r]
    return out


@pytest.mark.parametrize("case", DETERMINISTIC_CASES[:5], ids=str)
def test_block_index_lists_every_intersection_once_in_tile_order(
        case, monkeypatch):
    """Each wave's (output block, tile) pairs, exactly once, in ascending
    tile order within an output block, as int32; chunks of the wave's
    chunk length cut each list in order, with consecutive partial slots;
    the waves' boxes fit the cap; and a rebuild from a copy of the plan
    gives the same tensors (the chunks depend on the index alone)."""
    x, base, w, pad, tiles = _det_setup(case, monkeypatch)
    d, c = tiles.d, x.shape[1]
    wave_cells = twin.det_wave_cells(c, 8)
    index = twin.spread_block_index(tiles, pad, c, 8)
    assert twin.spread_block_index(tiles, pad, c, 8) is index
    for t in (index.box_off, index.pair_tile, index.chunks, index.arrivals):
        assert t.dtype == torch.int32
    side, blocks = index.side, index.blocks
    assert side == twin.det_block_side(d, c) and blocks == -(-pad // side)
    assert side ** d * c <= max(twin.DET_BLOCK_ITEMS, c)
    assert torch.equal(index.arrivals, torch.zeros(blocks ** d,
                                                   dtype=torch.int32))
    table = tiles.table.tolist()
    sizes = tiles.table[:, 5:8].to(torch.long).prod(dim=1)
    waves = index.waves.tolist()
    assert waves[0][0] == 0 and waves[-1][1] == tiles.n_tiles
    assert waves[-1][3] == index.chunks.shape[0]
    chunks, pair_tile = index.chunks.tolist(), index.pair_tile.tolist()
    seen, at = [], 0
    for w_i, (t0, t1, ch0, ch1, slots) in enumerate(waves):
        if w_i:
            assert (t0, ch0) == tuple(waves[w_i - 1][1:4:2])
        off = torch.cumsum(sizes[t0:t1], 0) - sizes[t0:t1]
        assert torch.equal(index.box_off[t0:t1].to(torch.long), off)
        assert int(sizes[t0:t1].sum()) <= min(wave_cells, index.scratch_cells)
        want = sorted((b, t) for t in range(t0, t1)
                      for b in _blocks_met(table[t], d, side, blocks))
        length = max(twin.DET_CHUNK_TILES,
                     -(-len(want) // twin.DET_WAVE_CHUNKS))
        got, slot_seen = [], []
        for block, first, count, k, nk, slot in chunks[ch0:ch1]:
            assert first == at and 1 <= count <= length
            at += count
            run = pair_tile[first:first + count]
            got += [(block, t) for t in run]
            if k + 1 < nk:
                assert count == length
            assert slot == -1 if nk == 1 else slot >= 0
            if nk > 1:
                slot_seen.append(slot)
        assert got == want  # block-major, tiles ascending: each pair once
        assert sorted(slot_seen) == list(range(slots))
        seen += got
    # consecutive chunks of one (wave, block): k counts up, slots follow
    for a, b in zip(chunks, chunks[1:]):
        if b[3]:
            assert (b[0], b[3], b[4], b[5]) == (a[0], a[3] + 1, a[4],
                                                a[5] + 1)
    assert len(seen) == index.pair_tile.numel()
    fresh = twin.TilePlan(tiles.table.clone(), tiles.n, tiles.d, tiles.taps,
                          tiles.max_cells, tiles.max_rows, tiles.pieces)
    again = twin.spread_block_index(fresh, pad, c, 8)
    assert again is not index
    for name in ("waves", "box_off", "pair_tile", "chunks"):
        assert torch.equal(getattr(again, name), getattr(index, name))
    assert again.scratch_cells == index.scratch_cells


def test_deterministic_mode_on_the_cpu_is_the_plain_spread():
    """On a CPU tensor the switch changes nothing (the plain spread is
    deterministic); the two-phase kernel itself needs the card."""
    plan, geom = _geometry("spiral", "SETUP_2", 3, 200)
    pad = padded_grid_size(plan)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(200, 2)))
    want = twin.window_spread_plain(x, geom.base, geom.weights,
                                    padded_size=pad)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = twin.window_spread(x, geom.base, geom.weights, padded_size=pad,
                                 tiles=geom.tiles)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="on the card"):
        twin.window_spread_deterministic(x, geom.base, geom.weights,
                                         torch.zeros_like(want), geom.tiles)


@pytest.mark.parametrize("kind,setup_name,d", [("spiral", "SETUP_2", 3),
                                               ("spiral", "SETUP_3", 2),
                                               ("unsorted", "SETUP_2", 2),
                                               ("ssl", None, 2),
                                               ("spiral", "SETUP_3", 1)])
def test_tile_emulation_matches_jax_ref_and_pallas(kind, setup_name, d):
    """float64, against repro.kernels.ref and the Pallas kernels run in
    interpret mode."""
    n = 150
    plan, geom = _geometry(kind, setup_name, d, n)
    pad = padded_grid_size(plan)
    base, w, tiles = geom.base, geom.weights, geom.tiles
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n,))
    g = rng.normal(size=(pad,) * d)
    spread = _emulate_spread(torch.as_tensor(x[:, None]), base, w, pad,
                             tiles, 1)[..., 0]
    gather = _emulate_gather(torch.as_tensor(g[..., None]), base, w, tiles,
                             1)[:, 0]
    jb, jw = jnp.asarray(base.numpy()), jnp.asarray(w.numpy())
    for want in (ref.window_spread_ref(jnp.asarray(x), jb, jw, pad),
                 jwin.window_spread(jnp.asarray(x), jb, jw, padded_size=pad,
                                    node_tile=128, interpret=True)):
        _close(spread, torch.as_tensor(np.array(want)), torch.float64)
    for want in (ref.window_gather_ref(jnp.asarray(g), jb, jw),
                 jwin.window_gather(jnp.asarray(g), jb, jw, node_tile=128,
                                    interpret=True)):
        _close(gather, torch.as_tensor(np.array(want)), torch.float64)


def test_tile_emulation_adjoint_identity():
    plan, geom = _geometry("uniform", "SETUP_3", 3, 300)
    pad = padded_grid_size(plan)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(300, 2)))
    g = torch.as_tensor(rng.normal(size=(pad,) * 3 + (2,)))
    lhs = float((_emulate_gather(g, geom.base, geom.weights, geom.tiles, 2)
                 * x).sum())
    rhs = float((g * _emulate_spread(x, geom.base, geom.weights, pad,
                                     geom.tiles, 2)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


# -- one plan per geometry --------------------------------------------------

def test_plan_built_once_per_geometry_across_matvecs_and_eigsh():
    """On the CPU the matvecs build no plan (the plain window versions need
    none); the geometry builds its plan at first read, and only then."""
    pts, _ = spiral(2000, seed=0)
    kern = make_kernel("gaussian", sigma=3.5)
    before = twin.build_tile_plan.builds
    op = tfs.make_normalized_adjacency(kern, pts, tfs.SETUP_1, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(2000, 2)))
    for _ in range(3):
        op.matvec(x)
    res = tlan.eigsh(op.matvec, op.n, 4, device="cpu")
    assert res.num_matvecs > 3
    assert twin.build_tile_plan.builds == before
    assert op.fastsum.src_window.tiles is op.fastsum.src_window.tiles
    assert twin.build_tile_plan.builds == before + 1


def test_rectangular_operator_builds_one_plan_per_geometry():
    pts, _ = spiral(500, seed=1)
    kern = make_kernel("gaussian", sigma=3.5)
    op = tfs.make_fastsum(kern, pts, tfs.SETUP_1, target_points=pts[:70],
                          device="cpu")
    before = twin.build_tile_plan.builds
    x = torch.ones(500, dtype=torch.float64)
    for _ in range(3):
        assert op.matvec_tilde(x).shape == (70,)
    assert twin.build_tile_plan.builds == before
    for _ in range(2):
        assert op.src_window.tiles.n == 500 and op.tgt_window.tiles.n == 70
    assert twin.build_tile_plan.builds == before + 2


def test_window_geometry_from_sorted_builds_its_plan_lazily():
    plan, geom = _geometry("spiral", "SETUP_2", 2, 300)
    fresh = WindowGeometry.from_sorted(geom.base, geom.weights, geom.perm)
    want = geom.tiles.table
    before = twin.build_tile_plan.builds
    x = torch.ones((300, 1), dtype=torch.float64)
    tex.window_spread(plan, fresh, x)
    tex.window_gather(plan, fresh, torch.ones((plan.grid_size,) * 2 + (1,),
                                              dtype=torch.float64))
    assert twin.build_tile_plan.builds == before  # none on the CPU
    assert torch.equal(fresh.tiles.table, want)
    assert fresh.tiles is fresh.tiles
    assert twin.build_tile_plan.builds == before + 1


def test_plan_does_not_depend_on_the_weights_dtype():
    plan, geom = _geometry("spiral", "SETUP_3", 3, 800)
    as_f32 = WindowGeometry.from_sorted(geom.base, geom.weights.float(),
                                        geom.perm)
    assert torch.equal(as_f32.tiles.table, geom.tiles.table)
    assert as_f32.tiles.max_cells == geom.tiles.max_cells


def test_wrappers_check_the_plan():
    plan, geom = _geometry("spiral", "SETUP_2", 2, 100)
    pad = padded_grid_size(plan)
    x = torch.ones((100, 1), dtype=torch.float64)
    g = torch.ones((pad, pad, 1), dtype=torch.float64)
    got = twin.window_spread(x, geom.base, geom.weights, padded_size=pad,
                             tiles=geom.tiles)
    assert torch.equal(got, twin.window_spread_plain(x, geom.base,
                                                     geom.weights,
                                                     padded_size=pad))
    other = twin.build_tile_plan(geom.base[:50], plan.taps)
    with pytest.raises(ValueError, match="tile plan is for"):
        twin.window_spread(x, geom.base, geom.weights, padded_size=pad,
                           tiles=other)
    with pytest.raises(ValueError, match="tile plan is for"):
        twin.window_gather(g, geom.base, geom.weights, tiles=other)
    wide = twin.TilePlan(geom.tiles.table, 100, 2, plan.taps,
                         twin.BOX_CELLS + 1, geom.tiles.max_rows)
    with pytest.raises(ValueError, match="budget"):
        twin.window_gather(g, geom.base, geom.weights, tiles=wide)
    narrow = twin.TilePlan(geom.tiles.table[:, :8], 100, 2, plan.taps,
                           geom.tiles.max_cells, geom.tiles.max_rows)
    with pytest.raises(ValueError, match="11"):
        twin.window_gather(g, geom.base, geom.weights, tiles=narrow)
    assert isinstance(NfftPlan(d=2, n_bandwidth=8, m=1), NfftPlan)


def test_time_window_reports_the_plan_and_needs_a_card():
    from repro_torch.launch import time_window
    plan, geom = time_window.geometry(2000, "SETUP_2", "cpu")
    line = time_window.plan_line(2000, "SETUP_2", geom, 1.5)
    corners = torch.unique(geom.base, dim=0).shape[0]
    cells = int(geom.tiles.table[:, 5:8].prod(dim=1).sum())
    assert f"{corners} distinct window corners" in line
    assert f"all boxes {cells} cells against {2000 * 9 ** 3}" in line
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            time_window.main([])
