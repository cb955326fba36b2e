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


def test_sam_vit_h_section():
    """ViT-H's encoder by hand: 28 windowed blocks (qkv and proj on 70^2
    padded tokens, the MLP on 64^2, 25 windows of 196 tokens' products and
    relative positions), 4 global blocks on 4096 tokens, the patch
    embedding and the neck: 5.96 TFLOP; a click's decoder a few GFLOP."""
    with open(os.path.join(BENCH, "configs", "sam_vit_h.json")) as f:
        cfg = json.load(f)
    c, t = 1280, 4096
    windowed = 2 * 4900 * c * 4 * c + 2 * t * c * 8 * c + 25 * 2 * (2 * 196 * 196 * c + 196 * 2 * 14 * c)
    global_ = 2 * t * c * 12 * c + 2 * 2 * t * t * c + 2 * t * 2 * 64 * c
    hand = 28 * windowed + 4 * global_ + 2 * t * c * 768 + 2 * t * c * 256 + 2 * t * 256 * 256 * 9
    encoder = F.sam_section_flops(cfg, 0)
    assert encoder == pytest.approx(hand, rel=1e-12)
    assert encoder == pytest.approx(5.96e12, rel=0.01)
    click = F.sam_section_flops(cfg, 1) - encoder
    assert 1e9 < click < 1e10
    assert F.sam_section_flops(cfg, 4) == pytest.approx(encoder + 4 * click)
