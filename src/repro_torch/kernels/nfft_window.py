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
* deterministic (:func:`window_spread_deterministic`, the switch on): the
  tiles run in waves of consecutive tiles whose boxes, times the call's
  channels, fit :data:`DET_SCRATCH_BYTES` of scratch.  In each wave every
  tile stores its box in the scratch (all channels in one launch); then
  the padded grid, cut into aligned output blocks of
  :data:`DET_BLOCK` cells a side, is summed in parallel by output block:
  each output block's tiles, ascending, are cut into chunks, one CUDA
  block a chunk adds its tiles' boxes in order, and the partials of a
  block's chunks are added in chunk order.  The schedule
  (:func:`spread_block_index`, built on the card and cached on the plan)
  alone fixes every sum's order, so two runs give the same bits.  It has
  no fallback: a schedule, scratch or launch that fails raises.

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
# Deterministic spread.  Output blocks of at most DET_BLOCK[d] cells a
# side, a power of two, halved while side^d * C exceeds DET_BLOCK_ITEMS
# (det_block_side); an output block's tile list is cut into chunks of
# DET_CHUNK_TILES tiles, or of more where a wave has over DET_WAVE_CHUNKS *
# DET_CHUNK_TILES (output block, tile) pairs, so that a wave's chunks stay
# near DET_WAVE_CHUNKS; a wave's boxes times the call's channels fill at
# most DET_SCRATCH_BYTES of scratch.
DET_BLOCK = {1: 16, 2: 8, 3: 8}
DET_BLOCK_ITEMS = 1024
DET_CHUNK_TILES = 16
DET_WAVE_CHUNKS = 1024
DET_SCRATCH_BYTES = 512 << 20
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
    block_index: the deterministic spread's :class:`SpreadBlockIndex` by
      (padded grid size, wave cells, output block side), built the first
      time that mode needs it.
    """

    table: torch.Tensor
    n: int
    d: int
    taps: int
    max_cells: int
    max_rows: int
    pieces: int = 1
    block_index: dict = dataclasses.field(default_factory=dict,
                                          compare=False, hash=False,
                                          repr=False)

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
class SpreadBlockIndex:
    """The deterministic spread's schedule on the plan's device, int32.

    The tiles run in waves of consecutive tiles.  ``waves`` (n_waves, 5)
    int64 on the host: first tile, end tile, first chunk, end chunk and
    partial slots of each wave.  ``box_off`` (n_tiles,): a tile's first
    cell in its wave's scratch (boxes in tile order, each in C order);
    ``scratch_cells``: the largest wave's box cells, the pitch of the
    scratch's one plane a channel.  The padded grid is
    cut into aligned output blocks of ``side`` cells a side, ``blocks`` a
    side, numbered in C order.  ``pair_tile`` (n_pairs,): for each wave and
    each output block some box of the wave meets, in (wave, block) order,
    the tiles whose box meets it, ascending.  ``chunks`` (n_chunks, 6):
    output block, first entry of ``pair_tile``, tiles, chunk k of the
    output block's nk in this wave, nk, and its partial slot in the wave
    (-1 where nk is 1).  ``arrivals`` (blocks^d,): the kernel's arrival
    count for each output block, zero between calls.
    """

    side: int
    blocks: int
    waves: torch.Tensor
    box_off: torch.Tensor
    scratch_cells: int
    pair_tile: torch.Tensor
    chunks: torch.Tensor
    arrivals: torch.Tensor
    partial_slots: int  # the most of one wave

    @property
    def n_waves(self) -> int:
        return self.waves.shape[0]

    @property
    def nbytes(self) -> int:
        """Device bytes of the schedule."""
        return sum(t.numel() * t.element_size() for t in (
            self.box_off, self.pair_tile, self.chunks, self.arrivals))


def det_block_side(d: int, c: int) -> int:
    """Output block side of the deterministic spread for C channels:
    :data:`DET_BLOCK` [d], halved while side^d * C exceeds
    :data:`DET_BLOCK_ITEMS` (down to 1)."""
    side = DET_BLOCK[d]
    while side > 1 and side ** d * c > DET_BLOCK_ITEMS:
        side //= 2
    return side


def det_wave_cells(c: int, itemsize: int) -> int:
    """Box cells one wave may hold: :data:`DET_SCRATCH_BYTES` over C
    channels of ``itemsize`` bytes."""
    return DET_SCRATCH_BYTES // (c * itemsize)


def _waves(ends: torch.Tensor, wave_cells: int) -> list:
    """(first, end) tiles of each wave: greedy, consecutive tiles whose box
    cells (cumulative ``ends``, on the host) sum to at most
    ``wave_cells``."""
    out, t0, done = [], 0, 0
    n = ends.shape[0]
    while t0 < n:
        t1 = int(torch.searchsorted(ends, done + wave_cells, right=True))
        if t1 <= t0:
            raise ValueError(f"the deterministic spread's scratch cap of "
                             f"{wave_cells} cells holds no box of tile {t0} "
                             f"({int(ends[t0]) - done} cells)")
        out.append((t0, t1))
        done, t0 = int(ends[t1 - 1]), t1
    return out


def spread_block_index(tiles: TilePlan, padded_size: int, c: int,
                       itemsize: int) -> SpreadBlockIndex:
    """The deterministic spread's schedule for a padded grid of
    ``padded_size`` cells a side and C channels of ``itemsize`` bytes:
    waves of at most :func:`det_wave_cells` box cells, output blocks of
    :func:`det_block_side` cells a side.  Cached on the plan by (padded
    size, wave cells, side); built on its device from one stable sort of
    (wave, output block) keys over the (output block, tile) pairs, reading
    back a few integers a wave.  Counts its builds in
    ``spread_block_index.builds``."""
    d, n_tiles = tiles.d, tiles.n_tiles
    wave_cells, side = det_wave_cells(c, itemsize), det_block_side(d, c)
    key = (padded_size, wave_cells, side)
    cached = tiles.block_index.get(key)
    if cached is not None:
        return cached
    spread_block_index.builds += 1
    dev = tiles.table.device
    i32 = dict(dtype=torch.int32, device=dev)
    corner, ext = tiles.table[:, 2:2 + d], tiles.table[:, 5:5 + d]
    # products of columns written out: an integer prod() reduction on the
    # card takes seconds the first time a process runs it
    sizes = ext[:, 0].to(torch.long)
    for a in range(1, d):
        sizes = sizes * ext[:, a]
    ends = torch.cumsum(sizes, 0)
    blocks = -(-padded_size // side)
    lo = torch.div(corner, side, rounding_mode="floor")
    count = torch.div(corner + ext - 1, side, rounding_mode="floor") - lo + 1
    per_tile = count[:, 0]
    for a in range(1, d):
        per_tile = per_tile * count[:, a]
    # one read-back: the tiles' box ends (for the waves) and the pairs
    head = torch.cat([ends, per_tile.sum(dtype=torch.long)[None]]).cpu()
    ends_host, n_pairs = head[:-1], int(head[-1])
    if n_pairs >= 2 ** 31:
        raise ValueError(f"{n_pairs} (output block, tile) pairs pass int32")
    spans = _waves(ends_host, wave_cells)
    n_waves = len(spans)
    firsts = torch.tensor([t0 for t0, _ in spans], dtype=torch.long)
    lengths = torch.tensor([t1 - t0 for t0, t1 in spans], dtype=torch.long)
    wave_start = torch.cat([torch.zeros(1, dtype=torch.long),
                            ends_host[firsts[1:] - 1]])
    scratch_cells = int((ends_host[firsts + lengths - 1] - wave_start).max())
    wave = torch.repeat_interleave(torch.arange(n_waves, **i32),
                                   lengths.to(dev), output_size=n_tiles)
    box_off = (ends - sizes - wave_start.to(dev)[wave]).to(torch.int32)
    # the (output block, tile) pairs, in tile order, and their blocks
    tile = torch.repeat_interleave(torch.arange(n_tiles, **i32), per_tile,
                                   output_size=n_pairs)
    rest = torch.arange(n_pairs, **i32) - (
        torch.cumsum(per_tile, 0, dtype=torch.int32) - per_tile)[tile]
    block = torch.zeros_like(rest)
    scale = 1
    for a in range(d - 1, -1, -1):  # C order: the last axis fastest
        at = count[:, a][tile]
        block += (lo[:, a][tile] + rest % at) * scale
        rest = torch.div(rest, at, rounding_mode="floor")
        scale *= blocks
    del rest
    key_type = torch.int32 if n_waves * scale < 2 ** 31 else torch.long
    keys, order = torch.sort(wave[tile].to(key_type) * scale + block,
                             stable=True)
    pair_tile = tile[order]
    del tile, block, order
    # runs of one (wave, block), cut into chunks of the wave's length
    run_key, run_len = torch.unique_consecutive(keys, return_counts=True)
    del keys
    run_key = run_key.to(torch.long)
    run_wave = torch.div(run_key, scale, rounding_mode="floor")
    wave_pairs = torch.zeros(n_waves, dtype=torch.long, device=dev)
    wave_pairs.index_add_(0, run_wave, run_len)
    chunk_len = torch.clamp(-(-wave_pairs // DET_WAVE_CHUNKS),
                            min=DET_CHUNK_TILES)[run_wave]
    run_chunks = -(-run_len // chunk_len)
    per_wave = torch.zeros((2, n_waves), dtype=torch.long, device=dev)
    per_wave[0].index_add_(0, run_wave, run_chunks)
    per_wave[1].index_add_(0, run_wave, run_chunks * (run_chunks > 1))
    wave_chunks, wave_slots = per_wave.cpu()  # the second read-back
    n_chunks = int(wave_chunks.sum())
    run = torch.repeat_interleave(torch.arange(run_key.shape[0], device=dev),
                                  run_chunks, output_size=n_chunks)
    k = torch.arange(n_chunks, device=dev) - (torch.cumsum(run_chunks, 0)
                                              - run_chunks)[run]
    length, nk = chunk_len[run], run_chunks[run]
    multi = (nk > 1).to(torch.long)
    slot_base = (torch.cumsum(per_wave[1], 0) - per_wave[1])[run_wave[run]]
    slot = torch.where(nk > 1, torch.cumsum(multi, 0) - multi - slot_base, -1)
    first = (torch.cumsum(run_len, 0) - run_len)[run] + k * length
    chunks = torch.stack([run_key[run] % scale, first,
                          torch.minimum(length, run_len[run] - k * length),
                          k, nk, slot], dim=1).to(torch.int32).contiguous()
    chunk_end = torch.cumsum(wave_chunks, 0)
    waves = torch.stack([firsts, firsts + lengths, chunk_end - wave_chunks,
                         chunk_end, wave_slots], dim=1).contiguous()
    index = SpreadBlockIndex(
        side, blocks, waves, box_off.contiguous(), scratch_cells,
        pair_tile.contiguous(), chunks, torch.zeros(blocks ** d, **i32),
        int(wave_slots.max()))
    tiles.block_index[key] = index
    return index


spread_block_index.builds = 0


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
    shape = (padded_size,) * d + (c,)
    if n == 0 or c == 0:
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    if tiles is None:
        tiles = build_tile_plan(base, taps)
    if torch.are_deterministic_algorithms_enabled():
        grid = torch.empty(shape, dtype=x.dtype, device=x.device)
        return window_spread_deterministic(x, base, weights, grid, tiles)
    grid = torch.zeros(shape, dtype=x.dtype, device=x.device)
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
    only) into ``grid``, which the launch zeroes first, wave by wave:
    every tile's box stored
    in scratch, all C channels in one launch, then each output block's
    boxes added in tile order by chunks in parallel and the chunks'
    partials in chunk order, through the plan's
    :func:`spread_block_index`.  Its scratch, the largest wave's boxes
    times C, is at most :data:`DET_SCRATCH_BYTES`.  Raises where the
    schedule, the scratch or a launch fails; there is no fallback.  Counts
    its calls (two kernel launches a wave) in ``launches``; records its
    last scratch and partials, in bytes, in ``scratch_bytes`` and
    ``partial_bytes``.  The schedule's arrival counters make calls on two
    streams at once with one plan unsafe.  On ``meta`` tensors (the dry
    run) it hands its :func:`work` to the active trace counter and returns
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
    if grid.shape != (padded_size,) * d + (c,) or grid.dtype != x.dtype:
        raise ValueError(f"grid must be {(padded_size,) * d + (c,)} "
                         f"{x.dtype}, got {tuple(grid.shape)} {grid.dtype}")
    itemsize = x.element_size()
    index = spread_block_index(tiles, padded_size, c, itemsize)
    cells = index.scratch_cells * c
    partial = index.partial_slots * index.side ** d * c
    window_spread_deterministic.scratch_bytes = cells * itemsize
    window_spread_deterministic.partial_bytes = partial * itemsize
    scratch = torch.empty(cells + partial, dtype=x.dtype, device=x.device)
    for t in (x, base, weights, grid):
        if not t.is_contiguous():
            raise ValueError("the CUDA window kernels need contiguous tensors")
    fn = getattr(_build.load_library("nfft_window.cu"),
                 f"repro_window_spread_det_{_suffix(x.dtype)}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), base.data_ptr(), weights.data_ptr(),
            grid.data_ptr(), tiles.table.data_ptr(), tiles.n_tiles, d, taps,
            c, padded_size, min(c, SPREAD_CHUNK), tiles.max_cells,
            tiles.max_rows, tiles.pieces, stream, scratch.data_ptr(),
            index.box_off.data_ptr(), index.pair_tile.data_ptr(),
            index.chunks.data_ptr(), scratch.data_ptr() + cells * itemsize,
            index.arrivals.data_ptr(), index.waves.data_ptr(),
            index.n_waves, index.side, index.scratch_cells)
    if rc != 0:
        raise RuntimeError(f"the deterministic window_spread failed to "
                           f"launch: CUDA error {rc}")
    window_spread_deterministic.launches += 1
    return grid


window_spread_deterministic.launches = 0
window_spread_deterministic.scratch_bytes = 0
window_spread_deterministic.partial_bytes = 0


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
