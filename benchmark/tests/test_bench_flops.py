"""The frozen operation counts against the numbers they were frozen at."""

import json
import os

import pytest

from tiny import BENCH

from bmk import flops as F


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)["net_config"]


def test_tile_flops_per_voxel_of_the_3d_affs_tile():
    fl = F.tile_flops(config("3d_affs"), (32, 412, 412))
    assert fl["output_shape"] == [4, 320, 320]
    assert round(F.per_output_voxel(fl)) == 24_466_816


@pytest.mark.parametrize("name,batch,tflop", [("3d_affs", 1, 4.579), ("2d_mtlsd", 10, 1.005)])
def test_train_step_flops(name, batch, tflop):
    assert round(F.train_step_flops(config(name), batch) / 1e12, 3) == tflop


@pytest.mark.parametrize("name,mflop", [("3d_affs", 6.09), ("2d_mtlsd", 1.93)])
def test_least_work_of_a_cremi_pass(name, mflop):
    per_voxel = F.least_volume_flops(config(name), (125, 1250, 1250)) / (125 * 1250 * 1250)
    assert round(per_voxel / 1e6, 2) == mflop


def test_conv_work_and_bound():
    flops, nbytes = F.conv_key_work((1, 18, 46, 46, 1500), (3, 3, 3, 1500, 1500))
    assert flops == 2.0 * 16 * 44 * 44 * 1500 * 27 * 1500
    assert nbytes == 2 * (18 * 46 * 46 * 1500 + 27 * 1500 * 1500 + 16 * 44 * 44 * 1500)
    assert F.bound_s(flops, nbytes) == flops / F.PEAK_BF16
