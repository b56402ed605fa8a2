"""NFFT window spread and gather: CUDA kernels and their plain versions.

The window step of the NFFT on the fused engine's separable geometry
(:class:`repro_torch.core.nfft.WindowGeometry`): per-node patch corner
``base`` (n, d) int32 in padded-grid coordinates and per-dimension weights
(n, d, taps).  The grid is the wrap-padded grid ``(P,)*d + (C,)``,
channels last, so no wrapping logic lives in the kernels; the fold-back of
the periodic pad is the caller's job.

* :func:`window_spread` — scatter-add each node's ``(taps,)^d`` window
  times its C values onto the grid.  Replaces the TPU kernel
  ``src/repro/kernels/nfft_window.py:_spread_kernel``.
* :func:`window_gather` — the exact transpose: contract each node's grid
  patch with its weight cube, giving (n, C).  Replaces
  ``src/repro/kernels/nfft_window.py:_gather_kernel``.

A tensor on the CPU takes the plain PyTorch version (same semantics as
``repro.kernels.ref``); a CUDA tensor launches the hand-written kernel in
``csrc/nfft_window.cu`` or raises; a ``meta`` tensor (the dry run,
:mod:`repro_torch.launch.dryrun`) gets a ``meta`` result of the kernel's
shape, and the kernel's :func:`work` goes to the active trace counter,
which counts the launch.  Each wrapper counts its launches on the card in
a ``launches`` attribute.

Both kernels walk a :class:`TilePlan` (:func:`build_tile_plan`): the rows
cut into contiguous tiles, each with the bounding box of its windows.  The
CUDA spread sums a tile's windows in registers, in row order, and then has
two modes, picked by PyTorch's own switch,
``torch.are_deterministic_algorithms_enabled()``, as ``index_add_`` and
``scatter_add_`` pick theirs:

* atomic (the switch off): each box goes onto the grid with atomics;
  neighbouring tiles' boxes overlap, so the order in which tiles land, and
  the result's last bits, vary from run to run.
* deterministic (:func:`window_spread_deterministic`, the switch on): each
  tile stores its box in a scratch buffer, and a second kernel adds, for
  every grid cell, the boxes that cover it in ascending tile order,
  through the plan's cell index (:func:`spread_cell_index`, built once per
  plan on the card).  Two runs give the same bits.  It has no fallback: a
  cell index, scratch or launch that fails raises.

The gather stages a tile's box in shared memory and is deterministic.  A
window larger than the box budget is cut into pieces along its leading
axes, one tile each (:func:`piece_lengths`): the spread adds each piece's
cells (in the deterministic mode, a piece is a tile like any other), and
one gather block sums a node's pieces in table order.  Only tensors on the
card use the plan.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.float64)
# Tile plan.  A tile takes at most TILE_ROWS rows, and at most TILE_WEIGHTS
# per-dimension weights (rows * d * taps), which the kernels stage in
# shared memory.  Its box, one channel wide, must fit BOX_BYTES of shared
# memory in the widest type (float64): at most BOX_CELLS cells.
TILE_ROWS = 64
TILE_WEIGHTS = 4096
BOX_BYTES = 48 * 1024
BOX_CELLS = BOX_BYTES // 8
# channels a kernel thread keeps in registers per pass (csrc kSpreadChunk,
# kChunk)
SPREAD_CHUNK = 4
KERNEL_CHUNK = 8
# columns of TilePlan.table: row start, row count, box corner (3), box
# extent (3), first window tap (3); unused dimensions have corner 0,
# extent 1 and first tap 0
_TABLE_COLS = 11
# nodes per chunk of the plain versions: bounds the materialized cube at
# ~2^24 elements per channel
_PLAIN_CUBE_ELEMS = 1 << 24


def _check_geometry(base: torch.Tensor, weights: torch.Tensor,
                    device: torch.device, dtype: torch.dtype):
    if weights.ndim != 3:
        raise ValueError(f"weights must be (n, d, taps), got {tuple(weights.shape)}")
    n, d, taps = weights.shape
    if not 1 <= d <= 3:
        raise ValueError(f"d must be 1, 2 or 3, got {d}")
    if taps < 1:
        raise ValueError(f"taps must be >= 1, got {taps}")
    if tuple(base.shape) != (n, d):
        raise ValueError(f"base must be {(n, d)}, got {tuple(base.shape)}")
    if base.dtype != torch.int32:
        raise TypeError(f"base must be int32, got {base.dtype}")
    if weights.dtype != dtype:
        raise TypeError(f"weights are {weights.dtype}, values are {dtype}")
    if dtype not in _FLOATS:
        raise TypeError(f"values must be float32 or float64, got {dtype}")
    for name, t in (("base", base), ("weights", weights)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, values on {device}")
    return n, d, taps


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The rows of a window geometry cut into contiguous tiles.

    table: (n_tiles, 11) int32 on the geometry's device, one row per tile
      in row order: first row, row count, box corner (d values, then 0),
      box extent (d values, then 1), in padded-grid cells, and the first
      window tap the tile covers (d values, then 0).  The box is the
      bounding box of the tile's windows: corner = min base, extent =
      max base - min base + taps along each axis, first taps 0.  Where one
      window exceeds the budget, every tile is one row and one piece of
      its window: taps [first, first + extent) along each axis, corner =
      base + first; a row's pieces are consecutive, in C order.
    n, d, taps: the geometry's shape.
    max_cells: the largest box, in cells (at most :data:`BOX_CELLS`).
    max_rows: the most rows of one tile.
    pieces: tiles per row where windows are cut into pieces (every row has
      that many, consecutive); 1 for tiles of whole windows.
    cell_index: the deterministic spread's :class:`SpreadCellIndex` by
      padded grid size, built the first time that mode needs it.
    """

    table: torch.Tensor
    n: int
    d: int
    taps: int
    max_cells: int
    max_rows: int
    pieces: int = 1
    cell_index: dict = dataclasses.field(default_factory=dict, compare=False,
                                         hash=False, repr=False)

    @property
    def n_tiles(self) -> int:
        return self.table.shape[0]


def tile_rows(d: int, taps: int) -> int:
    """Most rows of a tile: a power of two <= TILE_ROWS whose weights,
    rows * d * taps, fit TILE_WEIGHTS (at least 1)."""
    rows = TILE_ROWS
    while rows > 1 and rows * d * taps > TILE_WEIGHTS:
        rows //= 2
    return rows


def piece_lengths(d: int, taps: int) -> tuple:
    """Taps per axis of the pieces a window is cut into: (taps,)*d when
    taps^d fits :data:`BOX_CELLS`; else the leading axes are cut, the
    first as little as the budget allows (to one tap, then the next axis,
    and so on)."""
    lengths = []
    for a in range(d):
        rest = taps ** (d - 1 - a)  # cells of one tap on this axis
        if rest <= BOX_CELLS:
            return tuple(lengths) + (min(taps, BOX_CELLS // rest),) \
                + (taps,) * (d - 1 - a)
        lengths.append(1)
    return tuple(lengths)


def _piece_plan(base: torch.Tensor, taps: int, lengths: tuple) -> TilePlan:
    """One tile per (row, piece): every row's window cut into the pieces
    of ``lengths``, in C order over the axes."""
    n, d = base.shape
    dev = base.device
    firsts = torch.cartesian_prod(*[torch.arange(0, taps, step, device=dev)
                                    for step in lengths]).reshape(-1, d)
    k = firsts.shape[0]
    ext = torch.minimum(torch.as_tensor(lengths, device=dev),
                        taps - firsts)
    table = torch.zeros((n, k, _TABLE_COLS), dtype=torch.long, device=dev)
    table[:, :, 0] = torch.arange(n, device=dev)[:, None]
    table[:, :, 1] = 1
    table[:, :, 2:2 + d] = base.to(torch.long)[:, None, :] + firsts
    table[:, :, 5:8] = 1
    table[:, :, 5:5 + d] = ext
    table[:, :, 8:8 + d] = firsts
    max_cells = int(ext.prod(dim=1).max())
    return TilePlan(table.reshape(n * k, _TABLE_COLS).to(torch.int32)
                    .contiguous(), n, d, taps, max_cells, 1 if n else 0, k)


def build_tile_plan(base: torch.Tensor, taps: int) -> TilePlan:
    """Cut the rows of ``base`` (n, d) int32 into tiles whose box fits.

    Aligned blocks of :func:`tile_rows` rows are tried first; a block whose
    box exceeds :data:`BOX_CELLS` is split in halves, down to one row if
    need be.  Where one row's window (taps^d cells) exceeds the budget,
    each row's window is cut into pieces instead (:func:`piece_lengths`),
    one tile each.  Runs on ``base``'s device and reads back two integers.
    Works for any row order; Morton-sorted rows give the small boxes the
    kernels are fast on.  Counts its calls in ``build_tile_plan.builds``.
    """
    if base.ndim != 2 or not 1 <= base.shape[1] <= 3:
        raise ValueError(f"base must be (n, d) with d in 1..3, got "
                         f"{tuple(base.shape)}")
    n, d = base.shape
    if taps < 1:
        raise ValueError(f"taps must be >= 1, got {taps}")
    build_tile_plan.builds += 1
    dev = base.device
    if taps ** d > BOX_CELLS:
        return _piece_plan(base, taps, piece_lengths(d, taps))
    rows = tile_rows(d, taps)
    table = torch.zeros((0, _TABLE_COLS), dtype=torch.int32, device=dev)
    if n == 0:
        return TilePlan(table, 0, d, taps, 0, 0)
    n_pad = -(-n // rows) * rows
    # pad with copies of the last row: a ragged tile's box is unchanged
    b = base.to(torch.long)
    b = torch.cat([b, b[-1:].expand(n_pad - n, d)])
    starts, sizes, corners, extents = [], [], [], []
    size, covered = rows, None
    while size >= 1:
        blocks = b.view(-1, size, d)
        lo = blocks.amin(dim=1)
        ext = blocks.amax(dim=1) - lo + taps
        fits = ext.prod(dim=1) <= BOX_CELLS
        first = torch.arange(blocks.shape[0], device=dev) * size
        use = fits & (first < n)
        if covered is not None:
            use &= ~covered
        starts.append(first[use])
        sizes.append(torch.full_like(first[use], size))
        corners.append(lo[use])
        extents.append(ext[use])
        covered = fits if covered is None else covered | fits
        covered = covered.repeat_interleave(2)
        size //= 2
    start = torch.cat(starts)
    order = torch.argsort(start)
    start = start[order]
    count = torch.minimum(torch.cat(sizes)[order], n - start)
    corner = torch.cat(corners)[order]
    extent = torch.cat(extents)[order]
    table = torch.zeros((start.shape[0], _TABLE_COLS), dtype=torch.long,
                        device=dev)
    table[:, 0], table[:, 1] = start, count
    table[:, 2:2 + d] = corner
    table[:, 5:8] = 1
    table[:, 5:5 + d] = extent
    max_cells = int(extent.prod(dim=1).max())
    max_rows = int(count.max())
    return TilePlan(table.to(torch.int32).contiguous(), n, d, taps,
                    max_cells, max_rows)


build_tile_plan.builds = 0


def _check_plan(tiles: TilePlan, n: int, d: int, taps: int,
                device: torch.device) -> None:
    if (tiles.n, tiles.d, tiles.taps) != (n, d, taps):
        raise ValueError(f"tile plan is for (n, d, taps) = "
                         f"{(tiles.n, tiles.d, tiles.taps)}, geometry is "
                         f"{(n, d, taps)}")
    if tiles.table.device != device:
        raise ValueError(f"tile plan is on {tiles.table.device}, values on "
                         f"{device}")
    if tiles.table.ndim != 2 or tiles.table.shape[1] != _TABLE_COLS:
        raise ValueError(f"tile plan table must be (n_tiles, {_TABLE_COLS}), "
                         f"got {tuple(tiles.table.shape)}")
    if tiles.max_cells > BOX_CELLS:
        raise ValueError(f"tile plan has a {tiles.max_cells}-cell box, over "
                         f"the {BOX_CELLS}-cell budget")
    # whole-window tiles need a window that fits a box; pieces are single
    # rows, the same number for every row
    if tiles.pieces < 1 or (tiles.pieces == 1 and taps ** d > BOX_CELLS) or (
            tiles.pieces > 1 and (tiles.n_tiles != n * tiles.pieces
                                  or tiles.max_rows != 1)):
        raise ValueError(f"tile plan with {tiles.pieces} pieces a row has "
                         f"{tiles.n_tiles} tiles of up to {tiles.max_rows} "
                         f"rows for {n} rows of {taps}^{d}-cell windows")


@dataclasses.dataclass(frozen=True)
class SpreadCellIndex:
    """Where the deterministic spread's boxes land, on the plan's device.

    The scratch holds every tile's box in tile order, each in C order:
    ``box_off`` (n_tiles,) int64 is a tile's first scratch cell, and
    ``total`` the scratch's cells.  ``cells`` (n_cells,) int64 are the flat
    padded-grid cells some box covers, ascending; grid cell ``cells[u]`` is
    the sum of the scratch cells ``entries[starts[u]:starts[u + 1]]``
    (int64), which run in ascending tile order.
    """

    box_off: torch.Tensor
    entries: torch.Tensor
    starts: torch.Tensor
    cells: torch.Tensor
    total: int

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]


def spread_cell_index(tiles: TilePlan, padded_size: int) -> SpreadCellIndex:
    """The plan's cell index for a padded grid of ``padded_size`` cells a
    side (cached on the plan; built on its device with one stable sort and
    two sizes read back).  Counts its builds in
    ``spread_cell_index.builds``."""
    cached = tiles.cell_index.get(padded_size)
    if cached is not None:
        return cached
    spread_cell_index.builds += 1
    table = tiles.table.to(torch.long)
    dev, d = table.device, tiles.d
    ext = table[:, 5:8]
    sizes = ext.prod(dim=1)
    box_off = torch.cumsum(sizes, 0) - sizes
    total = int(sizes.sum()) if tiles.n_tiles else 0
    tile = torch.repeat_interleave(torch.arange(tiles.n_tiles, device=dev),
                                   sizes, output_size=total)
    local = torch.arange(total, device=dev) - box_off[tile]
    e1, e2 = ext[tile, 1], ext[tile, 2]
    at = (local // (e1 * e2), (local // e2) % e1, local % e2)
    flat = torch.zeros_like(local)
    for a in range(d):
        flat = flat * padded_size + table[tile, 2 + a] + at[a]
    del tile, local, e1, e2, at
    keys, entries = torch.sort(flat, stable=True)
    del flat
    cells, counts = torch.unique_consecutive(keys, return_counts=True)
    starts = torch.zeros(cells.shape[0] + 1, dtype=torch.long, device=dev)
    torch.cumsum(counts, 0, out=starts[1:])
    index = SpreadCellIndex(box_off.contiguous(), entries.contiguous(),
                            starts, cells.contiguous(), total)
    tiles.cell_index[padded_size] = index
    return index


spread_cell_index.builds = 0


def gather_chunk(c: int) -> int:
    """Most channels of one gather pass: min(C, KERNEL_CHUNK) rounded up to
    a power of two (channels past C are zero)."""
    chunk = 1
    while chunk < min(c, KERNEL_CHUNK):
        chunk *= 2
    return chunk


def _launch(entry: str, tensors, tiles: TilePlan, args,
            device: torch.device) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA window kernels need contiguous tensors")
    fn = getattr(_build.load_library("nfft_window.cu"), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*(t.data_ptr() for t in tensors), tiles.table.data_ptr(),
            tiles.n_tiles, *args, tiles.max_cells, tiles.max_rows,
            tiles.pieces, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {rc}")


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def work(n: int, d: int, taps: int, c: int, pad: int,
         dtype_name: str) -> tuple:
    """(FLOPs, bytes) of one spread or gather of n nodes, C channels, on
    the (pad,)^d grid: each input read once, each output written once.

    FLOPs: one multiply-add per window cell and channel (2C per cell),
    plus the leading weight products, one per (taps,)^(d-1) prefix and
    axis beyond the first.  Scaling x by the prefix product (spread) or
    contracting axis by axis (gather) needs no more than that.  Bytes: the
    int32 corners, the weights and the node values, and the grid."""
    s = 8 if dtype_name == "float64" else 4
    flops = n * (2 * c * taps ** d + (d - 1) * taps ** (d - 1))
    nbytes = n * (4 * d + s * d * taps + s * c) + s * pad ** d * c
    return flops, nbytes


def _meta_launch(name: str, n: int, d: int, taps: int, c: int, pad: int,
                 dtype: torch.dtype) -> None:
    """A kernel launch on ``meta`` tensors: its :func:`work` handed to the
    active trace counter, which counts the launch; nothing runs, and the
    wrapper's ``launches`` (the card's count) stays as it was."""
    from repro_torch.launch.roofline import add_kernel_work
    add_kernel_work(name, *work(n, d, taps, c, pad,
                                str(dtype).replace("torch.", "")))


def window_spread(x: torch.Tensor, base: torch.Tensor, weights: torch.Tensor,
                  *, padded_size: int,
                  tiles: TilePlan | None = None) -> torch.Tensor:
    """Scatter-add separable node windows onto the padded grid.

    x: (n, C); base: (n, d) int32 with ``0 <= base`` and
    ``base + taps <= padded_size``; weights: (n, d, taps), x's dtype.
    ``tiles``: the geometry's :class:`TilePlan` (built here when None).
    Returns the padded grid ``(padded_size,)*d + (C,)``.
    """
    if x.ndim != 2:
        raise ValueError(f"x must be (n, C), got {tuple(x.shape)}")
    n, d, taps = _check_geometry(base, weights, x.device, x.dtype)
    if x.shape[0] != n:
        raise ValueError(f"x has {x.shape[0]} rows, geometry has {n}")
    if padded_size < taps:
        raise ValueError(f"padded_size {padded_size} < taps {taps}")
    if tiles is not None:
        _check_plan(tiles, n, d, taps, x.device)
    if x.device.type == "meta":
        c = x.shape[1]
        _meta_launch("window_spread_deterministic"
                     if torch.are_deterministic_algorithms_enabled()
                     else "window_spread", n, d, taps, c, padded_size,
                     x.dtype)
        return torch.empty((padded_size,) * d + (c,), dtype=x.dtype,
                           device="meta")
    if x.device.type == "cpu":
        return window_spread_plain(x, base, weights, padded_size=padded_size)
    if x.device.type != "cuda":
        raise ValueError(f"no window_spread kernel for device {x.device}")
    c = x.shape[1]
    grid = torch.zeros((padded_size,) * d + (c,), dtype=x.dtype,
                       device=x.device)
    if n == 0 or c == 0:
        return grid
    if tiles is None:
        tiles = build_tile_plan(base, taps)
    if torch.are_deterministic_algorithms_enabled():
        window_spread_deterministic(x, base, weights, grid, tiles)
        return grid
    _launch(f"repro_window_spread_{_suffix(x.dtype)}",
            (x, base, weights, grid), tiles,
            (d, taps, c, padded_size, min(c, SPREAD_CHUNK)),
            x.device)
    window_spread.launches += 1
    return grid


window_spread.launches = 0


def window_spread_deterministic(x: torch.Tensor, base: torch.Tensor,
                                weights: torch.Tensor, grid: torch.Tensor,
                                tiles: TilePlan) -> torch.Tensor:
    """The deterministic spread of :func:`window_spread` (CUDA tensors
    only) into the zeroed ``grid``: every tile's box stored in scratch, then
    the boxes that cover each grid cell added in tile order, one pass of up
    to :data:`SPREAD_CHUNK` channels at a time.  Its scratch is the plan's
    box cells times the pass's channels.  Raises where the cell index,
    the scratch or a launch fails; there is no fallback.  Counts its calls
    (two kernel launches a pass) in ``launches``; records its last scratch,
    in bytes, in ``scratch_bytes``.  On ``meta`` tensors (the dry run)
    it hands its :func:`work` to the active trace counter and returns
    ``grid``."""
    if x.device.type == "meta":
        n, d, taps = weights.shape
        _meta_launch("window_spread_deterministic", n, d, taps, x.shape[1],
                     grid.shape[0], x.dtype)
        return grid
    if x.device.type != "cuda":
        raise ValueError(f"the deterministic spread runs on the card, got "
                         f"{x.device}")
    n, c = x.shape
    d, taps = tiles.d, tiles.taps
    padded_size = grid.shape[0]
    index = spread_cell_index(tiles, padded_size)
    chunk = min(c, SPREAD_CHUNK)
    scratch = torch.empty(index.total * chunk, dtype=x.dtype, device=x.device)
    window_spread_deterministic.scratch_bytes = (scratch.numel()
                                                 * scratch.element_size())
    for t in (x, base, weights, grid):
        if not t.is_contiguous():
            raise ValueError("the CUDA window kernels need contiguous tensors")
    fn = getattr(_build.load_library("nfft_window.cu"),
                 f"repro_window_spread_det_{_suffix(x.dtype)}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), base.data_ptr(), weights.data_ptr(),
            grid.data_ptr(), tiles.table.data_ptr(), tiles.n_tiles, d, taps,
            c, padded_size, chunk, tiles.max_cells, tiles.max_rows,
            tiles.pieces, stream, scratch.data_ptr(),
            index.box_off.data_ptr(), index.entries.data_ptr(),
            index.starts.data_ptr(), index.cells.data_ptr(), index.n_cells)
    if rc != 0:
        raise RuntimeError(f"the deterministic window_spread failed to "
                           f"launch: CUDA error {rc}")
    window_spread_deterministic.launches += 1
    return grid


window_spread_deterministic.launches = 0
window_spread_deterministic.scratch_bytes = 0


def window_gather(grid: torch.Tensor, base: torch.Tensor,
                  weights: torch.Tensor, *,
                  tiles: TilePlan | None = None) -> torch.Tensor:
    """Gather separable node windows from the padded grid -> (n, C).

    grid: ``(P,)*d + (C,)``; base/weights/tiles as in
    :func:`window_spread`.
    """
    n, d, taps = _check_geometry(base, weights, grid.device, grid.dtype)
    if grid.ndim != d + 1 or len(set(grid.shape[:d])) != 1:
        raise ValueError(f"grid must be (P,)*{d} + (C,), got "
                         f"{tuple(grid.shape)}")
    padded_size, c = grid.shape[0], grid.shape[-1]
    if padded_size < taps:
        raise ValueError(f"padded grid {padded_size} < taps {taps}")
    if tiles is not None:
        _check_plan(tiles, n, d, taps, grid.device)
    if grid.device.type == "meta":
        _meta_launch("window_gather", n, d, taps, c, padded_size,
                     grid.dtype)
        return torch.empty((n, c), dtype=grid.dtype, device="meta")
    if grid.device.type == "cpu":
        return window_gather_plain(grid, base, weights)
    if grid.device.type != "cuda":
        raise ValueError(f"no window_gather kernel for device {grid.device}")
    out = torch.empty((n, c), dtype=grid.dtype, device=grid.device)
    if n == 0 or c == 0:
        return out
    if tiles is None:
        tiles = build_tile_plan(base, taps)
    _launch(f"repro_window_gather_{_suffix(grid.dtype)}",
            (grid, base, weights, out), tiles,
            (d, taps, c, padded_size, gather_chunk(c)),
            grid.device)
    window_gather.launches += 1
    return out


window_gather.launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (semantics of repro.kernels.ref.window_*_ref).
# They materialize the weight cube, chunked over nodes to bound memory.
# ---------------------------------------------------------------------------

def _chunk_rows(n: int, taps: int, d: int) -> int:
    return max(1, min(n, _PLAIN_CUBE_ELEMS // taps ** d))


def _weight_cube(w: torch.Tensor) -> torch.Tensor:
    """(t, d, taps) -> (t, taps**d), C order over the d tap axes."""
    t, d, taps = w.shape
    cube = w[:, 0]
    for ax in range(1, d):
        cube = cube[..., None] * w[:, ax].reshape((t,) + (1,) * ax + (taps,))
    return cube.reshape(t, -1)


def _flat_cells(base: torch.Tensor, taps: int, padded_size: int) -> torch.Tensor:
    """(t, d) corners -> (t, taps**d) int64 row indices of the flat grid."""
    d = base.shape[1]
    offs = torch.arange(taps, device=base.device)
    cube = offs
    corner = base[:, 0].to(torch.long)
    for ax in range(1, d):
        cube = (cube[..., None] * padded_size + offs).reshape(-1)
        corner = corner * padded_size + base[:, ax]
    return corner[:, None] + cube[None, :]


def window_spread_plain(x: torch.Tensor, base: torch.Tensor,
                        weights: torch.Tensor, *,
                        padded_size: int) -> torch.Tensor:
    """Plain version of :func:`window_spread` (``index_add_`` of the cube)."""
    n, d, taps = weights.shape
    c = x.shape[1]
    flat = torch.zeros((padded_size ** d, c), dtype=x.dtype, device=x.device)
    step = _chunk_rows(n, taps, d)
    for s in range(0, n, step):
        cube = _weight_cube(weights[s:s + step])
        idx = _flat_cells(base[s:s + step], taps, padded_size)
        updates = cube[..., None] * x[s:s + step, None, :]
        flat.index_add_(0, idx.reshape(-1), updates.reshape(-1, c))
    return flat.reshape((padded_size,) * d + (c,))


def window_gather_plain(grid: torch.Tensor, base: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`window_gather` (advanced-index take)."""
    n, d, taps = weights.shape
    padded_size, c = grid.shape[0], grid.shape[-1]
    flat = grid.reshape(-1, c)
    out = torch.empty((n, c), dtype=grid.dtype, device=grid.device)
    step = _chunk_rows(n, taps, d)
    for s in range(0, n, step):
        cube = _weight_cube(weights[s:s + step])
        idx = _flat_cells(base[s:s + step], taps, padded_size)
        vals = flat[idx]  # (t, taps**d, C)
        out[s:s + step] = (vals * cube[..., None]).sum(dim=1)
    return out
