"""The yardstick's operation and byte counts on hand-counted shapes."""

import torch

from lib import arith

VOXEL = dict(field_impl="voxel", hidden=64, geo_features=15, voxel_features=8, voxel_pe_freqs=4,
             voxel_grid_size=40, train_rays=4096, n_samples=16, train_coarse=12, train_warmup_steps=25,
             train_warmup_samples=48, n_steps=500, render_coarse=24)
HASH = dict(VOXEL, field_impl="hash", grid=dict(levels=16, features=2, log2_table=19, n_min=16, n_max=2048))


def test_mlp_flops():
    # density 32 -> 64 -> 16, colour 31 -> 64 -> 64 -> 3, two operations a multiply-add
    assert arith.mlp_flops(VOXEL) == (2 * (32 * 64 + 64 * 16), 2 * (31 * 64 + 64 * 64 + 64 * 3))
    assert arith.mlp_flops(HASH) == arith.mlp_flops(VOXEL)  # 16 levels x 2 features = 32 inputs too


def test_train_flops():
    dens, col = 6144, 12544
    warm = 25 * 8 * 4096 * (48 * 3 * (dens + col))
    tight = 475 * 8 * 4096 * (16 * 3 * (dens + col) + 12 * dens)
    assert arith.train_flops(VOXEL, 8) == warm + tight
    assert arith.train_phases(dict(VOXEL, train_coarse=0)) == [(0, 16, 500)]


def test_eval_flops():
    dens, col = 6144, 12544
    assert arith.eval_flops(VOXEL, 10, 7, 16) == 7 * 16 * (dens + col) + 40 ** 3 * 8 * dens
    assert arith.eval_flops(HASH, 10, 7, 32) == 7 * 32 * (dens + col) + 10 * 24 * dens


def test_gather_bound_counts_distinct_rows():
    idx = torch.tensor([0, 1, 1, 5], dtype=torch.int32)
    # 4 indices of 4 B, 3 distinct rows of 128 B read, 4 rows of 128 B written
    assert arith.gather_bound_s(idx, 128, 1.0) == 4 * 4 + 3 * 128 + 4 * 128


def test_scatter_bound():
    # 4 int32 indices, 4 x 16 float32 updates, the whole 10 x 16 output
    assert arith.scatter_bound_s(4, 4, 16, 10, 1.0, 1e30) == 16 + 4 * 4 * 16 + 4 * 10 * 16
    assert arith.scatter_bound_s(4, 4, 16, 10, 1e30, 1.0) == 4 * 16  # one add an element


def test_table_rows_touched():
    grid = dict(levels=1, features=2, log2_table=10, n_min=2, n_max=2)
    # one point inside the 2^3 dense grid: its cell's 8 corners, each one row
    x = torch.tensor([[0.25, 0.25, 0.25]])
    assert arith.table_rows_touched(x, grid) == 8
    # two points in the same cell read the same 8 rows
    assert arith.table_rows_touched(torch.cat([x, x * 1.5]), grid) == 8
    # a point in the next cell along x shares the 4 corners of the face between them
    assert arith.table_rows_touched(torch.tensor([[0.25, 0.25, 0.25], [0.75, 0.25, 0.25]]), grid) == 12


def test_encode_and_backward_bounds():
    grid = dict(levels=1, features=2, log2_table=10, n_min=2, n_max=2)
    x = torch.tensor([[0.25, 0.25, 0.25]])
    ops = 1 * 1 * (9 + 8 * (2 + 2 * 2))
    assert arith.encode_bound_s(x, grid, 1.0, 1e30) == 4 * (3 + 8 * 2 + 2)
    assert arith.encode_bound_s(x, grid, 1e30, 1.0) == ops
    assert arith.backward_bound_s(1, grid, 1.0, 1e30) == 4 * (3 + 2 + 1024 * 2)


def test_peaks_table():
    pk = arith.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops_per_s"] == 989e12 and pk["hbm_bytes_per_s"] == 3.35e12
    assert arith.peaks("a card the table does not hold") is None
