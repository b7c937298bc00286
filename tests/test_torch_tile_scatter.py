"""`ops/warp.py` `tile_scatter_branches`: how many blocks of the tile scatter
(csrc/tile_scatter.cuh, kernels B, A-bwd, D and E) sort their corners in
shared memory and how many add them straight to device memory. The card's
tests and chip_smoke.py use it to show which branch a grid sends the
kernels down. Here: its constants against the kernel source, and its count
against a loop over the tiles of ragged grids. CPU only, no JAX, < 1 s."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smow_net_tpu_torch.ops import warp

CUH = Path(__file__).resolve().parents[1] / "smow_net_tpu_torch" / "csrc" / "tile_scatter.cuh"


def test_constants_match_the_kernel_source():
    """SCATTER_WINDOW_CELLS is kWindowCells and SCATTER_TILES each
    ScatterTile<C>'s (kTH, kTW)."""
    src = CUH.read_text()
    assert int(re.search(r"kWindowCells = (\d+);", src).group(1)) == warp.SCATTER_WINDOW_CELLS
    tiles = re.findall(r"struct ScatterTile<(\d+)> \{ static constexpr int kTH = (\d+), "
                       r"kTW = (\d+); \}", src)
    assert {int(c): (int(h), int(w)) for c, h, w in tiles} == warp.SCATTER_TILES


def _loop_count(grid, H, W, C, mode):
    """(sorted, direct) by a loop over the tiles: each tile's box from its
    pixels' corner rows and columns, sorted below the window's cells."""
    y0, y1, _, _, x0, x1, _, _ = warp.corner_rows(grid, H, W, *mode)
    TH, TW = warp.SCATTER_TILES[C]
    counts = [0, 0]
    for b in range(grid.shape[0]):
        for ty in range(0, grid.shape[1], TH):
            for tx in range(0, grid.shape[2], TW):
                t = (b, slice(ty, ty + TH), slice(tx, tx + TW))
                cells = ((y1[t].max() - y0[t].min() + 1) * (x1[t].max() - x0[t].min() + 1))
                counts[int(cells >= warp.SCATTER_WINDOW_CELLS)] += 1
    return tuple(counts)


@pytest.mark.parametrize("mode", [("border", True), ("zeros", False)], ids=["border", "zeros"])
@pytest.mark.parametrize("kind", ["near", "far", "nan"])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_branch_count_matches_a_loop_over_tiles(C, kind, mode):
    """Grids of 3 x 37 x 45 pixels (no multiple of any tile) into a 48 x 50
    image (2400 cells): "near", the identity grid plus a flow of a few
    pixels (sorted); "far", uniform over [-1.2, 1.2] (direct); "nan", the
    near grid with NaN coordinates at two pixels of the first batch entry
    (corners at rows and columns 0 and 1: those tiles' boxes widen)."""
    rng = np.random.default_rng(C)
    B, Hg, Wg, H, W = 3, 37, 45, 48, 50
    if kind == "far":
        grid = rng.uniform(-1.2, 1.2, size=(B, Hg, Wg, 2))
    else:
        base = np.stack(np.meshgrid(np.linspace(-1, 1, Wg), np.linspace(-1, 1, Hg)), -1)
        grid = base[None] + rng.normal(size=(B, Hg, Wg, 2)) * 2.0 / np.array([W, H])
        if kind == "nan":
            grid[0, -1, -1] = np.nan
            grid[0, 20, 40, 0] = np.nan
    grid = torch.from_numpy(grid.astype(np.float32))
    got = warp.tile_scatter_branches(grid, H, W, C, *mode)
    assert got == _loop_count(grid, H, W, C, mode)
    n_tiles = B * -(-Hg // warp.SCATTER_TILES[C][0]) * -(-Wg // warp.SCATTER_TILES[C][1])
    assert sum(got) == n_tiles
    assert got[1] == {"near": 0, "far": n_tiles}.get(kind, got[1])
    if kind == "nan":
        assert got[1] >= 1
