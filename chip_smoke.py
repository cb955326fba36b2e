#!/usr/bin/env python3
"""Drive bootstrapper_torch on one NVIDIA GPU (an H100) and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

(a) doctor: torch/CUDA versions, the device, nvcc; meanwhile the kernels
    are built from ``bootstrapper_torch/csrc`` (one nvcc per source, in
    parallel) and the host library with g++, and each conv kernel
    instantiation reports its registers, shared memory and spill bytes;
(b) every kernel against its plain PyTorch version on the card, at the
    shapes the main path gives it: the conv kernel (K1) at all eleven
    U-Net shapes of one tile in bf16 (the wgmma kernel) and at one shape
    in fp32 (the FMA kernel), the seed kernel (K2, and K3 as its Z=1
    case) bit-exact, also on a CREMI-sized stack and with a window of 33
    (the kernel's general body), with the copy width and body each launch
    took.  Each with its device time (the conv kernel's from CUDA events
    around 2-10 launches, about KERNEL_TIMING_MS of them, queued behind a
    device sleep, the seed kernel's from
    profiler device events), the plain version's, the library call's
    where one exists, and the least time the card could take;
(c) the main path through the user entry points: a synthetic uint8 raw
    volume (made from --seed) as an uncompressed Zarr, the full-width
    3d_affs setup with numpy-seeded weights saved as a checkpoint,
    ``run_prediction`` over 2x2x2 output tiles (8, 640, 640) in bf16 on
    the tiled path (``BS_ZSTREAM=0``), then ``run_segmentation`` in ws
    mode.  Launch counts are zeroed just before each entry point and read
    just after; both kernels must have run, the conv kernel once per tile
    at each of its eleven shapes;
(z) the streamed path (``zstream``): ``run_prediction`` over a
    (130, 640, 640) volume, which it streams in z (a warm step, then steps
    of 64 slices, the last one clipped), then ``run_segmentation``; the
    conv kernel must have run once per step at each of the warm or steady
    step's eleven shapes, which are traced on the ``meta`` device and
    checked against the plain version like (b)'s.  The affinities are
    compared with the tiled ``Predictor``'s at the stream's xy tile (at
    most 1 apart on under 1% of voxels) and at the zoo's tile (under 1%
    differ, counted near the tiled xy seams and away from them).  Then one
    steady step is profiled at the plan's tile and at ``ZSTREAM_SWEEP``'s
    and the widest the default budget plans: device time by group, peak
    memory per effective voxel (what ``predict/zstream.py``'s budget rests
    on).  Then what the segmentation pays around the seed kernel:
    ``device_seed_maxima`` (upload, kernel, download) timed at two stack
    sizes;
(d) reference checks on a small input: the forward on the card (fp32 and
    bf16) against the CPU fp32 forward, and the segmentation with seeds
    on the card against the CPU path; then one full-size tile forward
    under ``torch.profiler``, its device time grouped by kernel;
(t) the training slice (``train``): a synthetic sample (uint8 raw of
    TRAIN_VOLUME, Voronoi labels with background, a mask) as Zarr with a
    ``train.toml``; K1 against its plain version at the eleven kernel
    shapes of a training forward at the net's (32,196,196) input (traced on
    the ``meta`` device); ``Conv3dFunction`` (K1 with a gradient) against
    autograd through the plain version in fp32; on one batch, the bf16
    net's gradients (kernel route) against fp32 ones (library route), each
    parameter's nonzero and within GRAD_REL_L2; OVERFIT_STEPS steps on that
    batch, whose loss must fall, and no packed weight stale after them;
    ``run_training`` to TRAIN_ITERATIONS[0], again to [1] (it must resume),
    with launch counts zeroed before and read after (K1 once per iteration
    at each of the eleven shapes), then ``run_prediction`` with the
    checkpoint it wrote; last, the steady step by parts (loader wait, then
    CUDA events and host clock around transform, forward, backward and
    optimizer), its device groups, idle share, peak memory and TFLOP/s;
(r) one whole round (``round``), as a user runs it from the configs
    ``make_round_configs`` writes, on the training slice's Voronoi sample
    with its labels as GT: ``run_training`` (ROUND_ITERATIONS[0]),
    ``run_prediction`` (streamed), ``run_segmentation`` (ws),
    ``run_evaluation`` by VOI and again by prediction errors (the config
    written without GT, the error map computed on the card), ``run_filter``
    (the next round's labels and mask), and a ``round_1`` line.  A net
    this young (from this init its top level dies in most runs) segments
    little or nothing, so the round then runs segment, evaluate and filter
    once more through the same configs on the GT's own affinities written
    in place of the prediction (what a perfect net predicts), and trains
    round 2 from round 1's ``next_volumes.toml`` (ROUND_ITERATIONS[1]) on
    the pseudo-GT that pass leaves.  Launch counts are zeroed before each
    entry point and read after: K1 once per iteration at each training
    shape and on every predict step (its stream shapes held against the
    plain version), K2 in each segment (its shape held against plain).
    The error maps of every segmentation and of the GT labels are held
    against the CPU route (within ERR_ATOL, masks equal except on ties,
    which are counted), each filter's output against the host filter
    recomputed; seconds per stage, segments before and after each filter,
    VOI, error ratios and the pseudo-GT's coverage;
(l) the LSD setups: ``lsd``, the card's LSDs against the CPU route at a
    training crop and at one error block, with TF32 switched on around
    them (the route turns it off itself), their device ms and peak memory;
    ``mtlsd_round``, a 3d_mtlsd round from ``make_round_configs`` without
    GT on a fresh Voronoi sample of TRAIN_VOLUME: train (MTLSD_ITERATIONS),
    predict (streamed, both heads), segment, evaluate by LSD errors on the
    card, filter; one block of the scan against the CPU route, the GT's own
    LSDs through the scan on a crop (under 1% masked), the scan by parts,
    the steady train step; ``chain``, ``3d_lsd -> 3d_affs_from_3d_lsd``
    with the shipped refiner on the same sample: train 3d_lsd
    (CHAIN_ITERATIONS), predict the chain (both links streamed), segment;
    the refiner's bf16 forward against the CPU fp32 one on the 3d_lsd
    link's outputs, voxels/s per link.  Launch counts as in (r); the
    refiner's K1 convs are held against the plain version and added to the
    ``kernels`` line;
(2) the 2D setups: ``chain2d``, the reference's flagship round
    ``2d_mtlsd -> 3d_affs_from_2d_mtlsd`` on the same sample, from
    ``make_round_configs`` with the sample's labels as GT: the full-width
    2D net (run as a unit-z 3D net, ``adj_slices`` sections as channels)
    in bf16 on the card against fp32 on the CPU, its bf16 gradients at
    batch 10 against fp32; ``run_training`` (CHAIN2D_ITERATIONS batches of
    10), ``run_prediction`` (the 2D link tiled 32 sections a batch, the
    shipped refiner streamed), ``run_segmentation`` (ws),
    ``run_evaluation`` (VOI), ``run_filter``; then the GT's own 2D heads
    written over the 2D link's outputs and the refiner link, segment,
    evaluate and filter again (``gt_2d``: its segmentation may not be
    empty); the 2D link's Mvox/s at BATCH_TILES_SWEEP sections a batch;
    the steady train step.  Every K1 shape it launches (the 2D net's at
    batches of 10, 8, 32 and 64 sections, the refiner's 243-channel warm
    and steady shapes) is traced on the ``meta`` device, held against the
    plain version and counted into the ``kernels`` line;
(s) the synthetic refiners (``synth``), on the same sample: the shipped
    3d_affs_from_2d_mtlsd and 3d_affs_from_3d_lsd checkpoints' bf16 loss,
    forward only, over the port's ``SyntheticTrainingPipeline`` batches,
    each held to its gate (SYNTH_FORWARD); ``run_training`` on a copy of
    the first one's ``train.toml`` resumes from the shipped checkpoint and
    trains SYNTH_ITERATIONS more, the mean loss of the last 20 held to
    SYNTH_LAST20_MEAN; the steady step by parts and the host's draw of one
    synthetic pair; then the GT's own 2D heads as the 2D link's outputs,
    the refiner link predicted with the retrained checkpoint, and
    ``run_segmentation`` in mws (defaults and SYNTH_BIAS_SWEEP), cc and ws
    from the configs ``make_round_configs`` writes for each, scored by
    ``run_evaluation`` (VOI); no mws or cc segmentation may be empty.  K1
    at the refiners' training shapes (and ``Conv3dFunction`` in fp32 at the
    widest of them) and on every prediction step is held against the plain
    version and counted into the ``kernels`` line;
(w) blockwise segmentation (``blockwise``), after ``synth``: a Voronoi
    volume of BLOCKWISE_VOLUME (the CREMI sample size) made on the card,
    its 3 direct affinities written as uint8 with seeded noise, segmented
    by ``run_segmentation(mode="ws", blockwise=True)`` at the default
    block and context on BLOCKWISE_NUM_WORKERS threads: seconds by stage,
    K2 once per block (launches counted, must equal the blocks), K2's and
    the copies' device time from ``torch.profiler``, the wall time of each
    ``device_seed_maxima`` call, RAG size, VOI at BLOCKWISE_THRESHOLDS,
    peak host RSS.  Then on ``synth``'s 9-channel affinities, 8 blocks:
    mws with SYNTH_BIAS_SWEEP as its global sweep (its VOI beside the
    in-memory mws's), cc (must equal in-memory ``cc_segmentation``: same
    partition and background), ws sharded over 2 worker processes with a
    ledger (must equal one process's fragments and partitions).  K2 is
    held bit-exact at the block shape in (b), and the phase's launches
    are counted on that row of the ``kernels`` line.
(k) the command line (``cli``), after ``blockwise``, on a fresh Voronoi
    sample of TRAIN_VOLUME at full 3d_affs width: ``python -m
    bootstrapper_torch prepare round`` in a subprocess (its five stage
    TOMLs must equal ``configs.make_round_configs``'s), then ``run <round
    dir>`` in this process through the command line's ``main`` (train
    CLI_ITERATIONS, predict streamed, segment ws, evaluate by VOI,
    filter; seconds by stage, launch counts zeroed before and read
    after: K1 once per iteration at each training conv and on every
    stream step, K2 in segment); ``run_prediction`` again on the same
    config and checkpoint (bit-equal affinities); ``predict --auto-tile``
    (one tile for the volume, within +-1 of the stream further than
    SEAM_BAND voxels from either's xy tile edges; its eleven K1 shapes
    held against the plain version and counted into the ``kernels``
    line); and the peak memory of a tile forward per input voxel at the
    zoo's tile, CLI_SWEEP_INCREASES', the auto tile's and the largest the
    budget admits, which must stay under ``predict/scan.py``'s
    TILE_BYTES_PER_INPUT_VOXEL.
(m) several devices (``multi``), after ``cli``, on a fresh Voronoi sample
    of TRAIN_VOLUME at full 3d_affs width, over MULTI_DEVICES (two logical
    devices of the one card): ``predict --sharded`` through ``main``
    (``BS_ZSTREAM=0``, a batch of tiles one per device) against
    ``run_prediction`` on one device; the spatially split tile at
    ``spatial_shape_increase``'s tile against the slab-sized and the whole
    tile's forwards (also in fp32 and with the library's convs made plain,
    the witnesses), and ``predict --sharded spatial --auto-tile`` against
    the one-device auto tile, with the halo bytes and peak memories;
    lockstep z streaming of MULTI_ZSTREAM_SHAPE (one xy column, two z
    segments) against the one-device stream, and the warm and steady steps'
    times behind ``WARM_COST_FACTOR``; mesh training over gloo, (1, 2): one
    step against the one-device step (loss, reduced gradient), then
    ``run_training`` MULTI_TRAIN_ITERATIONS and a prediction from its
    checkpoint, 2d_mtlsd at batch 10 over (2, 1), and one NCCL rank in this
    process.  K1's launches per logical device (the training ranks report
    theirs); every new K1 shape is held against the plain version and
    counted into the ``kernels`` line.
(q) int8 inference (``int8``), after ``multi``: the int8 conv kernel (K4:
    amax, quantization, ``mma.sync`` s8 conv) against its plain version
    (exact int32 sums in float64) at every conv of a tile under
    ``BS_INT8=1`` (traced on the ``meta`` device: the 1-, 12-, 60-, 300- and
    1500-channel levels, the concat parts, the residuals with their scales
    over the uncropped inputs, the heads) and at a 2D (1,3,3) shape, each
    within one bf16 ulp, timed beside the bf16 route at the same shape;
    then ``run_prediction`` under ``BS_INT8=1`` on
    the main path's tiled volume and on the streamed one, launch counts
    zeroed before and read after (every conv of every tile or step on K4,
    once per tile or step at each traced shape, none on K1 or the
    library; the stream's warm and steady steps traced under the flag at
    its plan and K4 held against its plain version at their convs too),
    the uint8 affinities held to the bf16 ones within INT8_MAX_MEAN and
    INT8_MAX_DIFF;
(p) SAM and proofreading (``proofread``): ``bs-torch proofread --script``
    over a PROOFREAD_VOLUME raw volume with a random vit_b checkpoint
    written under the official keys (its mask head set so that masks
    follow the section), and again on affinities alone (point, merge,
    unmerge, omit, filter, write; no command refused, the Zarrs read back
    with a segment in them); a session of the first prompt alone, its
    segment held against SAM on the CPU from the same weights (fp32, TF32
    off); SAM on the card against the CPU (vit_b width, a windowed and a
    global block, fp32, TF32 off); vit_b's ``set_image`` and ``predict``
    and the vit_l and vit_h encoders timed with peak memory; ``bs-torch
    view`` of a written container.

Then the card's name and power limit as nvidia-smi reports them, the
``kernels`` line, and last ``{"ok": true, "device": {...}}``.  Any failure
raises: the script exits non-zero and prints no result.  It needs a CUDA
device and the bootstrapper_torch package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
from concurrent.futures import ThreadPoolExecutor
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# a kernel check's timing: about KERNEL_TIMING_MS of calls (``timing_iters``),
# queued behind KERNEL_SLEEP_MS of device sleep (a kernel's call enqueues in
# well under a millisecond; a forward's many ops keep cuda_time_ms's 50)
KERNEL_TIMING_MS = 100
KERNEL_SLEEP_MS = 10

# The JAX reference package, named for the "replaces" keys only (nothing
# of it is imported; the name is assembled so a grep for imports of it
# stays meaningful).
_JAX_PKG = "bootstrapper" + "_tpu"

# bf16 kernel vs plain: both round one fp32 sum to bf16, the sums taken
# in another order, so they differ by at most ~1 bf16 ulp (2^-8 rel)
CONV_RTOL = 2.0**-6
CONV_ATOL = 2.0**-6
# fp32 kernel vs plain: both sum 8100 fp32 products in fp32, in another
# order, into outputs of magnitude up to ~5 (ulp 5e-7): tens of ulps
# (2.5e-5 was read on an H100; TF32 products would be off by ~1e-3)
CONV_ATOL_FP32 = 1e-4
# forward on the card vs the CPU fp32 forward, on sigmoid outputs in
# [0, 1]: fp32 differs only by summation order; bf16 rounds every layer
FWD_ATOL_FP32 = 1e-4
FWD_ATOL_BF16 = 0.05
# Conv3dFunction in fp32 against autograd through the plain version: the
# kernel, cuDNN's backward and the plain matmuls sum the same fp32 products
# in other orders (thousands of terms): the largest difference within this
# share of the reference's largest value
FUNCTION_RTOL = 1e-4
# the bf16 net's gradients (kernel route) against fp32 ones (library
# route): relative L2 per parameter tensor
GRAD_REL_L2 = 0.05

# the training slice: the synthetic sample, the iterations of the two
# run_training calls (the second resumes), the overfit steps, the timed
# steps, and the predicted ROI (voxel offset, shape).  The training
# phases run at these depths (halved since the int8 and proofread phases
# came in; the loops they drive are the same) so that `done` stays under
# 1000 s: TRAIN_ITERATIONS, ROUND_ITERATIONS[0], MTLSD_ITERATIONS,
# CHAIN2D_ITERATIONS, CLI_ITERATIONS and MULTI_TRAIN_ITERATIONS
TRAIN_VOLUME = (64, 512, 512)
TRAIN_ITERATIONS = (30, 40)
OVERFIT_STEPS = 200
TIMED_STEPS = 10
TRAIN_PREDICT_ROI = ((16, 96, 96), (16, 320, 320))


# the round (``round``): round 1's and round 2's training iterations, on
# TRAIN_VOLUME's Voronoi sample (from this init the net's top level died
# within 100 iterations in most runs, in the JAX package too at a medium
# width); the card's error map against the CPU route's, and the distance
# from a threshold within which the two may put a voxel on either side (a
# tie)
ROUND_ITERATIONS = (40, 10)
ERR_ATOL = 1e-6


# the LSD setups (``lsd``, ``mtlsd_round``, ``chain``): the zoo's sigma and
# downsample; the card's LSDs against the CPU route at a training crop (64
# labels) and at one error block (the (16,128,128) block read with its
# (6,60,60) margin, 256 labels): fp32 blurs summed in another order differ
# by ~1e-6, TF32 ones by up to ~7e-4; the card's LSD error map against the
# CPU route's (within LSD_ERR_ATOL); the GT's own LSDs through the error
# scan on a crop of the sample, which may mask this share of the voxels;
# the iterations of the 3d_mtlsd round and of the chain's 3d_lsd
LSD_SIGMA = 80
LSD_DOWNSAMPLE = 2
LSD_CASES = [("train_crop", (4, 104, 104), 64), ("error_block", (28, 248, 248), 256)]
LSD_ATOL = 1e-4
LSD_ERR_ATOL = 1e-5
SANITY_CROP = (16, 256, 256)
SANITY_MAX_MASKED = 0.01
MTLSD_ITERATIONS = 20
CHAIN_ITERATIONS = 20

# the 2D chain (``chain2d``): 2d_mtlsd's iterations (batches of 10), and the
# batches of sections its link's throughput is measured at (the JAX
# package's default, 32, was its knee on a TPU)
CHAIN2D_ITERATIONS = 10
BATCH_TILES_SWEEP = (32, 8, 64)


# the synthetic refiners (``synth``): each shipped refiner's bf16 loss,
# forward only, over this many of the port's synthetic batches, and its
# gates (the JAX package read mean 0.025 / median about 0.020 with
# 3d_affs_from_2d_mtlsd over 30 batches, 0.022 / 0.020 with
# 3d_affs_from_3d_lsd over 16, in a CPU run of its own pipeline on the
# shipped checkpoints; a fresh net reads about 0.2); the iterations
# 3d_affs_from_2d_mtlsd then trains on from its shipped checkpoint, the
# gate on the mean loss of the last 20 of them, and the mws bias sweep's
# (direct, long-range) points
SYNTH_FORWARD = [
    ("3d_affs_from_2d_mtlsd", 32, {"mean": 0.045, "median": 0.035}),
    ("3d_affs_from_3d_lsd", 16, {"mean": 0.04}),
]
SYNTH_JAX_CPU = {
    "3d_affs_from_2d_mtlsd": {"batches": 30, "mean": 0.025, "median": 0.020, "max": 0.086},
    "3d_affs_from_3d_lsd": {"batches": 16, "mean": 0.022, "median": 0.020, "max": 0.038},
}
SYNTH_ITERATIONS = 40
SYNTH_LAST20_MEAN = 0.06
# the blockwise phase: ws at the CREMI sample size, 4 x 5 x 5 blocks of the
# pipelines' default (32,256,256) (read with their (2,32,32) context), on
# uint8 affinities of a Voronoi volume with seeded noise
BLOCKWISE_VOLUME = (125, 1250, 1250)
BLOCKWISE_THRESHOLDS = [0.35, 0.5]
BLOCKWISE_NUM_WORKERS = 8
BLOCKWISE_NOISE = 0.15
BLOCKWISE_BLOCK = (32, 256, 256)
# blockwise mws runs on the first 16 of the synth volume's 64 sections (2
# blocks), so that the whole script's `done` stays under 1000 s with the
# multi phase (the whole depth takes about 64 s)
BLOCKWISE_MWS_SECTIONS = 16
SYNTH_BIAS_SWEEP = [[-0.55, -0.8], [-0.7, -0.9]]


# the streamed main path's volume: deeper than 96 slices and, at the plan's
# 64-slice step after a 4-slice warm step, two slices short of the last
# step's end, so that the clipped overhang runs
ZSTREAM_SHAPE = (130, 640, 640)
# steady-step tiles (s new slices, xy, xy) measured for memory and
# throughput besides the plan's; ``main`` adds the widest the default
# budget plans (at the least step, 24 slices) on this card
ZSTREAM_SWEEP = [(24, 732, 732), (64, 732, 732)]
# streamed against tiled uint8 affinities: the largest difference and the
# share of voxels that may differ
ZSTREAM_MAX_DIFF = 1
ZSTREAM_MAX_SHARE = 1e-2
# voxels this close to a boundary between two tiled xy tiles count as near
# a seam
SEAM_BAND = 8
# the tiled predictor's input tile: the zoo's input shape + shape_increase
TILED_INPUT = (32, 412, 412)
# the command line's round: iterations, and the shape increases (beside
# the zoo's and the auto tile's) of the tile memory sweep
CLI_ITERATIONS = 10
CLI_SWEEP_INCREASES = [[28, 312, 312]]


# the multi phase: two logical devices on one card; the sharded batch's ROI
# (the sample's first 8 sections);
# its deep volume of one xy column; mesh training's iterations; its gates
# int8 inference (``int8``): the int8 predictions against the bf16 ones of
# the same weights, uint8 mean and max absolute difference
# (tests/test_quant.py:199-200's bounds); the 2D shape of the kernel check
INT8_MAX_MEAN = 1.5
INT8_MAX_DIFF = 12
INT8_2D_CASE = ("2d_300to300_k133", (32, 1, 60, 60, 300), None, (32, 1, 60, 60, 300), (1, 3, 3, 300, 300), True,
                False)

# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
PEAK_INT8 = 1979e12
# proofreading (``proofread``): the raw volume, SAM's card-vs-CPU check at
# vit_b width with the encoder cut to one windowed and one global block
# (fp32, TF32 off: the two devices sum the same products in other orders,
# so each output within this share of its largest magnitude), and the
# variants whose encoder is timed
PROOFREAD_VOLUME = (4, 1024, 1024)
SAM_RTOL = 1e-4
SAM_TIMED = ("vit_l", "vit_h")
MULTI_DEVICES = ["cuda:0", "cuda:0"]
MULTI_ROI_SECTIONS = 8
MULTI_ZSTREAM_SHAPE = (130, 640, 640)
MULTI_TRAIN_ITERATIONS = 5
MULTI_2D_ITERATIONS = 3
MULTI_NCCL_STEPS = 2
MULTI_MAX_DIFF = 1
MULTI_SEAM_MAX_DIFF = 2
# a split tile against the whole tile away from the seams, in bf16: the
# slabs equal the slab-sized forward exactly, but the library route's
# convs (cuDNN, an algorithm per shape) round the whole tile differently
# (0.53% of voxels 1 apart on an H100 80GB HBM3 at 700 W), so the gate is
# about twice that; the witnesses must read 0: the same comparison in
# fp32 with TF32 off, and in bf16 with those convs made plain
MULTI_SPLIT_MAX_SHARE = 1e-2
MULTI_LOSS_RTOL = 1e-2
MULTI_GRAD_REL_L2 = 0.05


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t``)."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, queued: bool = False, sleep_ms: float = 50.0) -> float:
    """Mean time of ``fn`` over ``iters`` calls between two CUDA events,
    after one warm-up call.  ``queued``: the calls are queued behind a
    ``sleep_ms`` device sleep, so the events bracket the device's work
    alone and not the host's time to enqueue it (for kernels shorter than
    the call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        rate = torch.cuda.get_device_properties(0).clock_rate  # kHz
        torch.cuda._sleep(int(sleep_ms * rate))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timing_iters(ms: float, most: int = 10) -> int:
    """The calls a kernel check times a kernel over, from the ``ms`` of one
    call: about KERNEL_TIMING_MS of them, at least 2 and at most ``most``."""
    return max(2, min(most, int(KERNEL_TIMING_MS // max(ms, 1e-3))))


def timed_call(fn) -> tuple:
    """``(fn(), ms)``: one call between two CUDA events on the current
    stream, after the work queued before it.  The plain versions are timed
    so, on the call whose result checks the kernel: they run for seconds
    at the largest shapes, where a warm-up and a mean over calls would
    cost the script tens of seconds and change nothing of consequence."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_time_ms(fn, iters: int = 10, required: bool = True):
    """Mean time the device spends in the kernels and copies of ``fn``, from
    ``torch.profiler`` device events over ``iters`` calls after one
    warm-up call; the host's time to enqueue them is not in it.  Where the
    profiler saw no device event in three tries: raises, or (not
    ``required``) gives None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(
            ev.time_range.elapsed_us()
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
        )
        if us:
            return us / 1e3 / iters
    if not required:
        return None
    raise RuntimeError("torch.profiler recorded no device event in three traces")


def bound(flops: float, peak_flops: float, nbytes: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- (b) kernels against their plain versions ------------------------------


def conv_cases():
    """The eleven convs one (32,412,412) tile of the full-width 3d_affs
    net sends to the kernel: name, input shape, centre crop of it (a
    strided view, as the net passes it), weight shape, with bias.  Each is
    launched once per tile.  None fuses a ReLU here, so each computes what
    one F.conv3d call computes."""
    return [
        ("enc2_c1_300to300_k3", (1, 22, 98, 98, 300), None, (3, 3, 3, 300, 300), True),
        ("enc3_c0_300to1500_k3", (1, 20, 48, 48, 300), None, (3, 3, 3, 300, 1500), True),
        ("enc3_c1_1500to1500_k3", (1, 18, 46, 46, 1500), None, (3, 3, 3, 1500, 1500), True),
        ("enc3_res_300to1500_k1", (1, 20, 48, 48, 300), (16, 44, 44), (1, 1, 1, 300, 1500), True),
        # decoder convs over [skip, upsampled]: one launch per part; the
        # skip is a crop of the encoder's output, the bias rides on it
        ("dec2_c0_skip300to300_k3", (1, 18, 94, 94, 300), (16, 88, 88), (3, 3, 3, 300, 300), True),
        ("dec2_c0_up1500to300_k3", (1, 16, 88, 88, 1500), None, (3, 3, 3, 1500, 300), False),
        ("dec2_c1_300to300_k3", (1, 14, 86, 86, 300), None, (3, 3, 3, 300, 300), True),
        ("dec2_res_skip300to300_k1", (1, 18, 94, 94, 300), (12, 84, 84), (1, 1, 1, 300, 300), True),
        ("dec2_res_up1500to300_k1", (1, 16, 88, 88, 1500), (12, 84, 84), (1, 1, 1, 1500, 300), False),
        ("dec1_c0_up300to60_k3", (1, 12, 168, 168, 300), None, (3, 3, 3, 300, 60), False),
        ("dec1_res_up300to60_k1", (1, 12, 168, 168, 300), (8, 164, 164), (1, 1, 1, 300, 60), False),
    ]


def storage_shape(x) -> tuple:
    """The NDHWC shape of the tensor whose storage the view ``x`` shows
    (its ``_base``, or ``x``), with ``x``'s channels.  The base is shaped
    NDHWC, or NCDHW where an op on the ``meta`` device gave a permuted
    view (its spatial dims then do not hold ``x``'s)."""
    base = x if x._base is None else x._base
    s = tuple(base.shape)
    if not all(b >= v for b, v in zip(s[1:4], x.shape[1:4])):
        s = (s[0], *s[2:], s[1])
    return (*s[:-1], x.shape[-1])


def trace_kernel_convs(run) -> tuple:
    """``run()`` (a forward on the ``meta`` device) with the U-Net's conv
    call wrapped: returns ``(run's result, cases)``, every conv the kernel
    route takes in call order, as ``(input shape, crop, weight shape,
    bias)`` in the form of ``conv_cases`` (the input's storage as the
    shape, its view as a centre crop of it)."""
    from bootstrapper_torch.models import unet as U
    from bootstrapper_torch.ops.conv3d import conv3d_supported

    real, cases = U.conv3d, []

    def record(x, w, b=None, **kw):
        if conv3d_supported(tuple(x.shape), tuple(w.shape)):
            xs = storage_shape(x)
            crop = None if tuple(x.shape[1:4]) == tuple(xs[1:4]) else tuple(x.shape[1:4])
            cases.append((xs, crop, tuple(w.shape), b is not None))
        return real(x, w, b, **kw)

    U.conv3d = record
    try:
        out = run()
    finally:
        U.conv3d = real
    return out, cases


def trace_stream_convs(net_config: dict, step_tile, s_warm: int) -> tuple:
    """The kernel-route convs of a z stream's warm step (``s_warm`` output
    slices) and steady step (``step_tile``: s new slices at the stream's
    xy), traced on the ``meta`` device: ``(warm cases, steady cases)``, each
    as ``trace_kernel_convs`` gives them."""
    import torch

    from bootstrapper_torch.models import Model
    from bootstrapper_torch.models.zstream import z_context

    with torch.device("meta"):
        model = Model(net_config).eval()
    ctx = z_context(model.unet_config)
    s, xy = step_tile[0], step_tile[1:]
    warm_x = torch.empty((1, s_warm + ctx, *xy, model.unet_config.in_channels), device="meta")
    steady_x = torch.empty((1, s, *xy, model.unet_config.in_channels), device="meta")
    with torch.no_grad():
        (_, state), warm = trace_kernel_convs(lambda: model.forward_stream(warm_x, None))
        _, steady = trace_kernel_convs(lambda: model.forward_stream(steady_x, state))
    return warm, steady


def stream_conv_cases(net_config: dict, step_tile, s_warm: int) -> list:
    """``trace_stream_convs`` of a net with the 3d_affs trunk, named after
    the tile's convs of ``conv_cases`` (a step runs the same convs in the
    same order): ``(name, input shape, crop, weight shape, bias)``."""
    tile_cases = conv_cases()
    out = []
    for phase, cases in zip(("warm", "steady"), trace_stream_convs(net_config, step_tile, s_warm)):
        if [(c[2], c[3]) for c in cases] != [(t[3], t[4]) for t in tile_cases]:
            raise AssertionError(f"the stream's {phase} step runs other kernel convs than a tile")
        out += [(f"{phase}_{t[0]}", *c) for t, c in zip(tile_cases, cases)]
    return out


def conv_key(case) -> tuple:
    """``(input view shape, weight shape)`` of a traced conv, as the launch
    counts key it."""
    xs, crop, ws = case[-4], case[-3], case[-2]
    return ((xs[0], *crop, xs[-1]) if crop else tuple(xs), tuple(ws))


def conv_inputs(gen, xs, crop, ws, with_bias, dtype):
    import torch

    from bootstrapper_torch.models.unet import center_crop
    from bootstrapper_torch.ops.conv3d import empty_channels_last

    # in the layout the U-Net's ops give their outputs (16-byte voxel lines)
    x = empty_channels_last(xs, dtype, "cuda")
    x.copy_(torch.randn(xs, generator=gen, device="cuda"))
    if crop is not None:
        x = center_crop(x, crop)
    fan_in = ws[0] * ws[1] * ws[2] * ws[3]
    w = (torch.randn(ws, generator=gen, device="cuda") / fan_in**0.5).to(dtype)
    b = torch.randn(ws[-1], generator=gen, device="cuda").to(dtype) if with_bias else None
    return x, w, b


def conv_work(x, w, b, out):
    """(operations, bytes) of one conv: 2 per multiply-add; every operand
    read once (a cropped view counts its own voxels) and the output
    written once."""
    item = x.element_size()
    fan_in = w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]
    flops = 2.0 * (out.numel() // w.shape[-1]) * w.shape[-1] * fan_in
    nbytes = item * (x.numel() + w.numel() + out.numel() + (0 if b is None else b.numel()))
    return flops, float(nbytes)


def check_conv(seed: int, cases=None, fp32: bool = True) -> list:
    """K1 against its plain version at each of ``cases`` (default: the
    eleven of a tile), in bf16, then (``fp32``) the fp32 route at one
    shape; one ``kernel_check`` line each."""
    import torch
    import torch.nn.functional as F

    from bootstrapper_torch.ops import conv3d as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, xs, crop, ws, with_bias in conv_cases() if cases is None else cases:
        x, w, b = conv_inputs(gen, xs, crop, ws, with_bias, torch.bfloat16)
        packed = C.pack_weights(w, x.dtype)  # once, as the U-Net keeps it
        got, first_ms = timed_call(lambda: C.conv3d_cuda(x, w, b, packed=packed))
        ref, plain_ms = timed_call(lambda: C.conv3d_plain(x, w, b))
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= CONV_ATOL + CONV_RTOL * ref.float().abs()).all())
        if not ok:
            raise AssertionError(f"conv kernel {name}: max |err| {err} outside tolerance")
        xp = x.contiguous().permute(0, 4, 1, 2, 3)  # dense, for the library
        wp = w.permute(4, 3, 0, 1, 2).contiguous()
        # CUDA events around queued launches (profiler device events read
        # up to half the time of the largest convs, under their bound)
        iters = timing_iters(first_ms)
        ms = cuda_time_ms(
            lambda: C.conv3d_cuda(x, w, b, packed=packed), iters=iters, queued=True, sleep_ms=KERNEL_SLEEP_MS
        )
        # a cross-check of ``ms``; None where the profiler's traces came back
        # without device events, as one now and then does
        profiler_ms = device_time_ms(lambda: C.conv3d_cuda(x, w, b, packed=packed), iters=iters, required=False)
        library_ms = cuda_time_ms(lambda: F.conv3d(xp, wp, b), iters=iters, queued=True, sleep_ms=KERNEL_SLEEP_MS)
        flops, nbytes = conv_work(x, w, b, got)
        bound_ms, bound_by = bound(flops, PEAK_BF16, nbytes)
        plan = C.tile_plan(ws[3], ws[4])
        rows.append(
            {
                "shape": name, "x": list(x.shape), "w": list(ws), "dtype": "bf16",
                "tile": [plan.bm, plan.bn], "stages": plan.stages,
                "copy_bytes": C._copy_bytes(x),
                "max_abs_err": err, "rtol": CONV_RTOL, "atol": CONV_ATOL,
                "ms": ms, "profiler_ms": profiler_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flops / ms / 1e9, "gbytes_per_s": nbytes / ms / 1e6,
            }
        )
        emit({"phase": "kernel_check", "kernel": "conv3d", **rows[-1]})
        del x, w, b, packed, got, ref, diff, xp, wp
        torch.cuda.empty_cache()
    if fp32:
        rows.append(check_conv_fp32(gen))
    return rows


def check_conv_fp32(gen) -> dict:
    """The fp32 route (exact FMAs, another kernel body) at one shape."""
    import torch
    import torch.nn.functional as F

    from bootstrapper_torch.ops import conv3d as C

    name, xs, ws = "fp32_300to300_k3", (1, 8, 30, 30, 300), (3, 3, 3, 300, 300)
    x, w, b = conv_inputs(gen, xs, None, ws, True, torch.float32)
    packed = C.pack_weights(w, x.dtype)
    got = C.conv3d_cuda(x, w, b, packed=packed)
    ref = C.conv3d_plain(x, w, b)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= CONV_ATOL_FP32:
        raise AssertionError(f"fp32 conv kernel {name}: max |err| {err} > {CONV_ATOL_FP32}")
    xp = x.contiguous().permute(0, 4, 1, 2, 3)
    wp = w.permute(4, 3, 0, 1, 2).contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the library in full fp32 too
    library_ms = device_time_ms(lambda: F.conv3d(xp, wp, b))
    torch.backends.cudnn.allow_tf32 = tf32
    ms = device_time_ms(lambda: C.conv3d_cuda(x, w, b, packed=packed))
    plain_ms = device_time_ms(lambda: C.conv3d_plain(x, w, b), iters=2)
    flops, nbytes = conv_work(x, w, b, got)
    bound_ms, bound_by = bound(flops, PEAK_FP32, nbytes)
    row = {
        "shape": name, "x": list(xs), "w": list(ws), "dtype": "fp32",
        "max_abs_err": err, "atol": CONV_ATOL_FP32,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / ms / 1e9,
    }
    emit({"phase": "kernel_check", "kernel": "conv3d", **row})
    return row


SEED_CASES = [
    ("stack_8x640x640_size10", (8, 640, 640), 10),
    ("stack_8x640x640_size7", (8, 640, 640), 7),
    ("section_640x640_size10", (1, 640, 640), 10),
    # a CREMI-sized stack: large enough that the time is the kernel's
    # and not a launch's
    ("stack_125x1250x1250_size10", (125, 1250, 1250), 10),
    # a window past the register body's 16: the general body
    ("stack_8x640x640_size33", (8, 640, 640), 33),
    # a blockwise ws block with its context at the pipelines' defaults
    ("block_36x320x320_size10", (36, 320, 320), 10),
]


def check_seeds(seed: int, cases=SEED_CASES) -> list:
    import torch

    from bootstrapper_torch.ops import seeds as S

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, shape, size in cases:
        # normal, so the border holds negative values (outside counts as
        # -inf, not 0)
        dist = torch.randn(shape, generator=gen, device="cuda")
        dist[:, ::9, ::7] = 0.5  # plateaus: ties must compare equal
        mask = torch.rand(shape, generator=gen, device="cuda") > 0.3
        if shape[0] == 1:  # K3: the single-section entry point
            run = lambda: S.seed_maxima(dist[0], mask[0], size)[None]  # noqa: E731
        else:
            run = lambda: S.seed_maxima_3d(dist, mask, size)  # noqa: E731
        got = run()
        plan = dict(S.LAST_PLAN)
        ref = S.seed_maxima_plain(dist, mask, size)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        if mismatches:
            raise AssertionError(f"seed kernel {name}: {mismatches} voxels differ")
        del got, ref
        ms = device_time_ms(run)
        call_ms = cuda_time_ms(run)  # the Python call, enqueue included
        plain_ms = device_time_ms(lambda: S.seed_maxima_plain(dist, mask, size), iters=2)
        n = dist.numel()
        # fp32 in, bool mask in, uint8 out; 2*(size-1) maxes + 1 compare
        bound_ms, bound_by = bound(n * (2.0 * (size - 1) + 1), PEAK_FP32, n * 6.0)
        rows.append(
            {
                "shape": name, "dist": list(shape), "size": size, **plan,
                "max_abs_err": 0.0, "mismatches": mismatches,
                "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "gbytes_per_s": n * 6.0 / ms / 1e6,
            }
        )
        emit({"phase": "kernel_check", "kernel": "seed_maxima", **rows[-1]})
    return rows


def time_seed_call(seed: int, shape, size: int = 10) -> dict:
    """What ``post/fragments.py:device_seed_maxima`` costs on a host stack
    of ``shape``: the wall time of the call, and its three parts (upload
    of pageable fp32 distances and a bool mask, the kernel launch, download
    of the uint8 seeds) from CUDA events between the same statements run
    once more; the rest is the host's (the bool conversion)."""
    import torch

    from bootstrapper_torch.ops.seeds import seed_maxima_3d
    from bootstrapper_torch.post.fragments import device_seed_maxima

    rng = np.random.default_rng(seed)
    dist = rng.standard_normal(shape, dtype=np.float32)
    mask = rng.random(shape, dtype=np.float32) > 0.3
    ref = device_seed_maxima(dist, mask, size, "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device_seed_maxima(dist, mask, size, "cuda")
    call_ms = (time.perf_counter() - t0) * 1e3

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.perf_counter()
    marks[0].record()
    d = torch.from_numpy(dist).to("cuda")
    m = torch.from_numpy(mask).to("cuda")
    marks[1].record()
    seeds = seed_maxima_3d(d, m, size)
    marks[2].record()
    host = seeds.cpu()
    marks[3].record()
    got = host.numpy().astype(bool)
    parts_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if not np.array_equal(got, ref):
        raise AssertionError(f"seed call at {shape}: two runs differ")
    upload, kernel, download = (marks[i].elapsed_time(marks[i + 1]) for i in range(3))
    nbytes = dist.nbytes + mask.nbytes + host.numel()
    return {
        "stack": list(shape), "size": size, "call_wall_ms": call_ms,
        # the same statements once more, with events between them
        "parts_wall_ms": parts_ms, "upload_ms": upload, "kernel_ms": kernel,
        "download_ms": download, "host_rest_ms": parts_ms - upload - kernel - download,
        "pcie_bytes": nbytes, "pcie_gbytes_per_s": nbytes / (upload + download) / 1e6,
    }


# -- (c) the main path -----------------------------------------------------


def write_inputs(work: str, net_config: dict, params, raw_shape, seed: int) -> dict:
    """Raw volume, setup dir with checkpoint, and the two TOMLs."""
    from bootstrapper_torch.core.arrays import prepare_ds
    from bootstrapper_torch.models.weights import save_checkpoint
    from bootstrapper_torch.utils import tomlio

    rng = np.random.default_rng(seed)
    z, y, x = raw_shape
    # membrane-like texture: coarse blobs, upsampled, plus noise
    coarse = rng.uniform(0, 255, (z, -(-y // 16), -(-x // 16)))
    raw = np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2)[:, :y, :x]
    raw = np.clip(raw + rng.normal(0, 20, raw.shape), 0, 255).astype(np.uint8)
    voxel_size = (40, 4, 4)
    ds = prepare_ds(
        os.path.join(work, "vol.zarr", "raw"), raw.shape, (0, 0, 0), voxel_size,
        np.uint8, chunk_shape=(z, 128, 128),
    )
    ds[ds.roi] = raw

    setup = os.path.join(work, "setup", "3d_affs")
    os.makedirs(setup, exist_ok=True)
    with open(os.path.join(setup, "net_config.json"), "w") as f:
        json.dump(net_config, f)
    save_checkpoint(setup, params, 0)

    predict_toml = os.path.join(work, "predict.toml")
    tomlio.dump(
        {
            "predict": {
                "vol": {
                    "raw_dataset": os.path.join(work, "vol.zarr", "raw"),
                    "output_container": os.path.join(work, "vol.zarr"),
                    "chain": [
                        {
                            "setup_dir": setup,
                            "output_prefix": "predictions",
                            "checkpoint_iteration": 0,
                        }
                    ],
                }
            }
        },
        predict_toml,
    )
    affs = os.path.join(work, "vol.zarr", "predictions", "3d_affs")
    segment_toml = os.path.join(work, "segment.toml")
    tomlio.dump(
        {
            "segment": {
                "vol": {
                    "affs_dataset": affs,
                    "seg_dataset_prefix": os.path.join(work, "vol.zarr", "segmentations"),
                }
            }
        },
        segment_toml,
    )
    return {"predict_toml": predict_toml, "segment_toml": segment_toml, "affs": affs}


def run_main_path(
    work: str, net_config: dict, params, raw_shape, seed: int, device, zstream: bool = False,
    segment: bool = True,
) -> dict:
    """``run_prediction`` then (``segment``) ``run_segmentation`` with the
    launch counts zeroed just before each and read just after.  ``zstream`` False runs
    the tiled path (``BS_ZSTREAM=0``, as a user opts out); True leaves the
    workflow its default, which must then stream.  On the card, the
    device's busy time over ``run_prediction`` comes from ``torch.profiler``
    device events (``profiled``)."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.ops import (
        conv3d_kernel_launches, launch_counts, qconv_kernel_launches, reset_launch_counts,
    )
    from bootstrapper_torch.workflows import run_prediction, run_segmentation

    paths = write_inputs(work, net_config, params, raw_shape, seed)

    saved = os.environ.get("BS_ZSTREAM")
    if not zstream:
        os.environ["BS_ZSTREAM"] = "0"
    try:
        reset_launch_counts()
        stats, device_ms = profiled(
            lambda: run_prediction(paths["predict_toml"], device=device), device
        )
        predict_counts = launch_counts()
        conv_launches = conv3d_kernel_launches()
        qconv_launches = qconv_kernel_launches()
    finally:
        if saved is None:
            os.environ.pop("BS_ZSTREAM", None)
        else:
            os.environ["BS_ZSTREAM"] = saved
    (pstats,) = stats.values()
    if ("steps_per_column" in pstats) != zstream:
        raise AssertionError(f"run_prediction took the wrong route: {pstats}")

    segs, seg_seconds, segment_counts = {"vol": {}}, None, None
    if segment:
        reset_launch_counts()
        t0 = time.perf_counter()
        segs = run_segmentation(paths["segment_toml"], device=device)
        seg_seconds = time.perf_counter() - t0
        segment_counts = launch_counts()

    affs = open_ds(paths["affs"])
    a = affs.to_ndarray()
    n_out = len(net_config["outputs"]["3d_affs"]["neighborhood"])
    if a.shape != (n_out, *raw_shape) or a.dtype != np.uint8:
        raise AssertionError(f"affinities {a.shape} {a.dtype}, want {(n_out, *raw_shape)} uint8")
    # every chunk written once, none read back and rewritten: a tile per
    # chunk, or the stream's columns times its z chunks
    n_chunks = sum(1 for f in os.listdir(affs.path) if not f.startswith("."))
    want_chunks = pstats["tiles"]
    if zstream:
        chunk_z = math.gcd(pstats["step_z"], pstats["warm_step_z"])
        want_chunks = pstats["columns"] * -(-raw_shape[0] // chunk_z)
    if n_chunks != want_chunks:
        raise AssertionError(f"{n_chunks} output chunks written, want {want_chunks}")
    labels = {}
    for t, path in segs["vol"].items():
        seg = open_ds(path).to_ndarray()
        if seg.shape != tuple(raw_shape) or seg.dtype != np.uint64:
            raise AssertionError(f"segmentation {t}: {seg.shape} {seg.dtype}")
        labels[t] = int(len(np.unique(seg[seg != 0])))
    out = {
        "tiles": pstats["tiles"],
        "predict_seconds": pstats["seconds"],
        "output_voxels_per_sec": pstats["voxels_per_sec"],
        "output_chunks": n_chunks,
        "segment_seconds": seg_seconds,
        "affs_mean": float(a.mean()),
        "segments_per_threshold": labels,
        "predict_launches": predict_counts,
        "conv_launches": conv_launches,
        "qconv_launches": qconv_launches,
        "segment_launches": segment_counts,
        "affs": a,
    }
    if device_ms is not None:
        out["predict_device_ms"] = device_ms
        # the device's busy time against the wall time of the same call
        out["predict_idle_share"] = 1 - device_ms / (pstats["seconds"] * 1e3)
    if zstream:
        out["plan"] = {
            k: pstats[k] for k in ("input_tile", "step_z", "warm_step_z", "columns", "steps_per_column")
        }
    return out


def profiled(fn, device):
    """``(fn(), device ms)``: on the card, the sum of ``torch.profiler``
    device events over the call (kernels and copies, which the
    predictors queue on one stream, so they do not overlap); None on the
    CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return fn(), None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = sum(
        ev.time_range.elapsed_us()
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
    )
    return out, (us / 1e3 if us else None)


# -- (d) reference checks on a small input ---------------------------------


def check_reference(net_config: dict, params, affs: np.ndarray, seed: int) -> dict:
    import torch

    from bootstrapper_torch.models import Model, load_params, min_input_shape
    from bootstrapper_torch.post.segment import waterz_segmentation

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = load_params(Model(net_config, compute_dtype=torch.float32), params).eval()
    shape = min_input_shape(cpu.unet_config)
    x = np.random.default_rng(seed).uniform(-1, 1, (1, *shape, 1)).astype(np.float32)
    with torch.no_grad():
        ref = cpu(torch.from_numpy(x))["3d_affs"].numpy()
        gpu32 = load_params(Model(net_config, compute_dtype=torch.float32), params)
        gpu32 = gpu32.to("cuda").eval()
        out32 = gpu32(torch.from_numpy(x).cuda())["3d_affs"].cpu().numpy()
        gpu16 = gpu32.to(torch.bfloat16)
        gpu16.compute_dtype = torch.bfloat16
        out16 = gpu16(torch.from_numpy(x).cuda())["3d_affs"].cpu().numpy()
    err32 = float(np.abs(out32 - ref).max())
    err16 = float(np.abs(out16 - ref).max())
    if not (np.isfinite(out16).all() and err32 <= FWD_ATOL_FP32 and err16 <= FWD_ATOL_BF16):
        raise AssertionError(f"forward vs CPU fp32: fp32 err {err32}, bf16 err {err16}")

    crop = affs[:, :, :160, :160]
    seg_gpu = waterz_segmentation(crop, device="cuda")
    seg_cpu = waterz_segmentation(crop, device="cpu")
    for t in seg_cpu:
        if not np.array_equal(seg_gpu[t], seg_cpu[t]):
            raise AssertionError(f"segmentation at {t} differs between card and CPU seeds")
    return {
        "input": list(shape), "fp32_max_abs_err": err32, "fp32_atol": FWD_ATOL_FP32,
        "bf16_max_abs_err": err16, "bf16_atol": FWD_ATOL_BF16,
        "segment_crop": list(crop.shape[1:]), "segment_labels_equal": True,
    }


def tile_flops(net_config: dict, input_shape) -> dict:
    """Operations of one tile forward (a 2D net's: one section's), by conv
    route, from the U-Net's shape algebra (2 per multiply-add; residuals on
    the cropped inputs)."""
    from bootstrapper_torch.models.model import head_dims, unet_config
    from bootstrapper_torch.models.unet import lift_2d_config
    from bootstrapper_torch.ops.conv3d import conv3d_supported

    cfg = unet_config(net_config)
    if cfg.dims == 2:  # the lifted net on one section
        cfg, input_shape = lift_2d_config(cfg), (1, *input_shape)
    nf, inc = cfg.num_fmaps, cfg.fmap_inc_factor
    # "on_input": the part of both routes whose convs read the net's input
    flops = {"kernel": 0.0, "library": 0.0, "on_input": 0.0}

    def conv(shape, parts, co, k, on_input=False):
        out = [s - kk + 1 for s, kk in zip(shape, k)]
        for ci in parts:
            route = "kernel" if conv3d_supported((1, *shape, ci), (*k, ci, co)) else "library"
            flops[route] += 2.0 * np.prod(out) * ci * co * np.prod(k)
            if on_input:
                flops["on_input"] += 2.0 * np.prod(out) * ci * co * np.prod(k)
        return out

    def conv_pass(shape, parts, co, kernels, on_input=False):
        for i, k in enumerate(kernels):
            shape = conv(shape, parts if i == 0 else [co], co, k, on_input and i == 0)
        conv(shape, parts, co, (1, 1, 1), on_input)  # residual, on the crop
        return shape

    def rec(level, shape):
        i = cfg.num_levels - level - 1
        ci = cfg.in_channels if i == 0 else nf * inc ** (i - 1)
        shape = conv_pass(shape, [ci], nf * inc**i, cfg.kernel_size_down[i], on_input=i == 0)
        if level == 0:
            return shape
        f = cfg.downsample_factors[i]
        inner = rec(level - 1, [s // ff for s, ff in zip(shape, f)])
        up = [s * ff for s, ff in zip(inner, f)]
        cc = [sum(k[d] - 1 for k in cfg.kernel_size_up[i]) for d in range(3)]
        up = [((s - c) // cf) * cf + c for s, c, cf in zip(up, cc, cfg.crop_factors[i])]
        return conv_pass(up, [nf * inc**i, nf * inc ** (i + 1)], nf * inc**i, cfg.kernel_size_up[i])

    out = rec(cfg.num_levels - 1, list(input_shape))
    for o in net_config["outputs"].values():
        conv_pass(out, [cfg.out_channels], head_dims(o), [(1, 1, 1)])
    return {**flops, "output_voxels": int(np.prod(out))}


def stream_step_flops(net_config: dict, step_tile) -> dict:
    """Operations of one steady z-stream step (``step_tile``: s new slices
    at the stream's xy), by conv route, and per output voxel: a steady
    step computes exactly s more output slices at every conv than a tile
    of the same xy, so it is the difference of ``tile_flops`` at two z
    extents s apart."""
    from bootstrapper_torch.models.model import unet_config
    from bootstrapper_torch.models.zstream import z_context

    s, xy = step_tile[0], tuple(step_tile[1:])
    z0 = z_context(unet_config(net_config)) + 1
    hi, lo = tile_flops(net_config, (z0 + s, *xy)), tile_flops(net_config, (z0, *xy))
    out_voxels = hi["output_voxels"] - lo["output_voxels"]
    flops = {k: hi[k] - lo[k] for k in ("kernel", "library")}
    return {**flops, "output_voxels": out_voxels, "per_output_voxel": sum(flops.values()) / out_voxels}


def stream_step_profile(model, step_tile, s_warm: int, seed: int) -> dict:
    """One steady z-stream step of ``step_tile`` (s new slices, xy, xy)
    after a warm step and a first steady step, through
    ``ZStreamPredictor.step`` on device tensors of random bytes: wall ms;
    device ms, its groups and the idle share of one profiled step
    (``torch.profiler`` device events); the step's time between CUDA events
    (queued) and the output Mvox/s and TFLOP/s it gives; peak memory and
    the part of it the step itself takes beyond the weights and the stream
    state; FLOPs per output voxel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bootstrapper_torch.predict.zstream import ZStreamPredictor

    nc = model.net_config
    s, xy = step_tile[0], step_tile[1]
    inc = xy - nc["input_shape"][1]
    zp = ZStreamPredictor(
        model, (40, 4, 4), shape_increase=[0, inc, inc], device="cuda", step_z=s, warm_step_z=s_warm
    )
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape):
        return torch.randint(0, 256, (1, *shape, 1), generator=gen, device="cuda", dtype=torch.uint8)

    _, state = zp.step(rand(zp.warm_input_tile), None)
    x = rand(tuple(step_tile))  # a steady step takes s new slices
    outs, state = zp.step(x, state)
    del outs
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, state = zp.step(x, state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del outs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs, state = zp.step(x, state)
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    # the step once more between CUDA events, queued behind a device sleep
    rate = torch.cuda.get_device_properties(0).clock_rate  # kHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(200 * rate))
    start.record()
    outs, state = zp.step(x, state)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end)
    del outs, state, x
    torch.cuda.empty_cache()
    device_ms, groups, top = device_groups(prof)
    if not device_ms:
        raise RuntimeError("torch.profiler recorded no device event in a stream step")
    flops = stream_step_flops(nc, step_tile)
    eff = (s + 8) * xy * xy  # the planner's effective input voxels
    step_bytes = peak - held
    return {
        "step_tile": list(step_tile), "output_tile": list(zp.output_tile),
        "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms, "device_ms": device_ms,
        "event_ms": event_ms, "idle_share": 1 - device_ms / profiled_wall_ms,
        "groups_ms": groups, "top_kernels_ms": top,
        "output_mvox_per_s_device": flops["output_voxels"] / event_ms / 1e3,
        "flops_per_output_voxel": flops["per_output_voxel"],
        "kernel_route_flop_share": flops["kernel"] / (flops["kernel"] + flops["library"]),
        "tflops_device": (flops["kernel"] + flops["library"]) / event_ms / 1e9,
        "peak_memory_gb": peak / 1e9, "held_gb": held / 1e9, "step_gb": step_bytes / 1e9,
        "effective_voxels": eff, "step_bytes_per_effective_voxel": step_bytes / eff,
    }


def zstream_phase(net_config: dict, params, raw_shape, seed: int, device="cuda") -> dict:
    """The streamed main path: ``run_prediction`` (which streams this deep
    volume) then ``run_segmentation``, as ``run_main_path``; then the tiled
    ``Predictor`` over the same volume twice, and the affinities compared:
    at the stream's xy tile (``vs_tiled``: only the z walk differs; ``main``
    holds it to its bound), and at the zoo's tile (``vs_zoo_tiled``: a
    tile's outputs within a few voxels of its xy edges depend on where the
    edge is, through the upsample's edge clamp, so the differences are
    counted near the tiled seams and away from them)."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import Model, load_params
    from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs, tile_rois

    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_zstream_") as work:
        res = run_main_path(work, net_config, params, raw_shape, seed, device, zstream=True)
        raw = open_ds(os.path.join(work, "vol.zarr", "raw"))
        model = load_params(Model(net_config), params)
        xy_inc = res["plan"]["input_tile"][1] - net_config["input_shape"][1]
        tiled = {}
        for name, inc in (("vs_tiled", [0, xy_inc, xy_inc]), ("vs_zoo_tiled", None)):
            pred = Predictor(model, raw.voxel_size, shape_increase=inc, device=device)
            outs = prepare_prediction_outputs(
                os.path.join(work, f"{name}.zarr"), model, raw.roi, raw.voxel_size, pred
            )
            stats = pred.predict(raw, outs)
            seams = {
                d: sorted({int(t.begin[d] // raw.voxel_size[d]) for t in tile_rois(raw.roi, pred.output_size)} - {0})
                for d in (1, 2)
            }
            tiled[name] = (pred.output_tile, stats, outs["3d_affs"].to_ndarray(), seams)
    got = res.pop("affs")
    res["stream_affs"] = got  # the int8 phase's bf16 reference
    for name, (tile, stats, want, seams) in tiled.items():
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        # voxels within SEAM_BAND of a boundary between two tiled xy tiles
        near = np.zeros(diff.shape[2:], dtype=bool)
        for d, starts in seams.items():
            for b in starts:
                band = [slice(None), slice(None)]
                band[d - 1] = slice(max(0, b - SEAM_BAND), b + SEAM_BAND)
                near[tuple(band)] = True
        differs = diff != 0
        res[name] = {
            "output_tile": list(tile), "tiled_tiles": stats["tiles"], "tiled_seconds": stats["seconds"],
            "tiled_output_voxels_per_sec": stats["voxels_per_sec"],
            "max_abs_diff": int(diff.max()), "differing_share": float(differs.mean()),
            "voxels_by_diff": {int(d): int((diff == d).sum()) for d in np.unique(diff) if d},
            "xy_seams": seams, "seam_band": SEAM_BAND,
            "differing_near_seams": int(differs[:, :, near].sum()),
            "differing_elsewhere": int(differs[:, :, ~near].sum()),
            "max_abs_diff_elsewhere": int(diff[:, :, ~near].max(initial=0)),
        }
    return res


def per_voxel(flops: dict) -> float:
    """Operations per output voxel of a ``tile_flops`` count."""
    return (flops["kernel"] + flops["library"]) / flops["output_voxels"]


def device_groups(prof) -> tuple:
    """``(device ms, ms by group, the 8 longest kernels)`` of a profile's
    device events: the conv kernel, the library's convs, everything else."""
    import torch

    by_name = {}
    for ev in prof.events():  # device-side events only: kernels, copies
        # (not the device-side ranges of user annotations such as
        # "Optimizer.step", which overlap the kernels they enclose)
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            ms = ev.time_range.elapsed_us() / 1e3
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    groups = {"conv3d_kernel": 0.0, "library_conv": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "conv3d_kernel" in low:
            groups["conv3d_kernel"] += ms
        elif any(k in low for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass")):
            groups["library_conv"] += ms
        else:
            groups["other"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()), groups, [[n[:120], ms] for n, ms in top]


def tile_breakdown(net_config: dict, params, seed: int) -> dict:
    """Device time of one full-size tile forward (bf16), by kernel, from
    ``torch.profiler``; ``None`` where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bootstrapper_torch.models import Model, load_params
    from bootstrapper_torch.ops import launch_counts
    from bootstrapper_torch.predict.scan import Predictor

    model = load_params(Model(net_config), params)
    pred = Predictor(model, (40, 4, 4), device="cuda")
    shape = (1, *pred.input_tile, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    pred.forward(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):  # wall time without the profiler's overhead
        pred.forward(x)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    packs_before = launch_counts()["conv3d.pack"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()  # after the profiler's start-up
        pred.forward(x)
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    repacked = launch_counts()["conv3d.pack"] - packs_before
    if repacked:
        raise AssertionError(f"a warm forward packed weights {repacked} times")
    device_ms, groups, top = device_groups(prof)
    flops = tile_flops(net_config, pred.input_tile)
    return {
        "input_tile": list(pred.input_tile),
        "flops_kernel_route": flops["kernel"],
        "flops_library_route": flops["library"],
        "flops_per_output_voxel": per_voxel(flops),
        "wall_ms": wall_ms,
        "profiled_wall_ms": profiled_wall_ms,
        "device_ms": device_ms or None,
        # kernel time and wall time of the same (profiled) forward
        "idle_share": (1 - device_ms / profiled_wall_ms) if device_ms else None,
        "groups_ms": groups if device_ms else None,
        "top_kernels_ms": top,
        "peak_memory_gb": peak_gb,
        "weight_packs_in_profiled_forward": repacked,
    }


# -- (t) the training slice ------------------------------------------------


#: distances computed at once in ``voronoi_sample`` (fp32, 1 GB)
VORONOI_ELEMENTS = 2**28


def voronoi_sample(shape, n_cells: int, seed: int, device) -> dict:
    """A synthetic training sample made from ``seed`` on ``device``: Voronoi
    labels (z distances weighted 10x, as 40 nm sections against 4 nm
    pixels) with ids past 2^32 and a tenth of the cells as background, raw
    with dark membranes between the cells and noise, a mask with a band of
    sections masked out.  Numpy arrays."""
    import torch

    rng = np.random.default_rng(seed)
    pts = torch.tensor(rng.uniform(0, 1, (n_cells, 3)) * np.array(shape), dtype=torch.float32, device=device)
    ids = torch.tensor(rng.integers(1, 2**40, n_cells).astype(np.int64), device=device)
    ids[torch.tensor(rng.random(n_cells) < 0.1, device=device)] = 0
    yy, xx = torch.meshgrid(
        torch.arange(shape[1], device=device, dtype=torch.float32),
        torch.arange(shape[2], device=device, dtype=torch.float32),
        indexing="ij",
    )
    labels = torch.empty(shape, dtype=torch.int64, device=device)
    # rows at a time: a CREMI-sized section against its thousands of cells
    # would take tens of GB of distances at once
    rows = max(1, VORONOI_ELEMENTS // (shape[2] * n_cells))
    for z in range(shape[0]):
        for y0 in range(0, shape[1], rows):
            yc, xc = yy[y0 : y0 + rows].reshape(-1, 1), xx[y0 : y0 + rows].reshape(-1, 1)
            d = ((z - pts[:, 0]) * 10.0) ** 2 + (yc - pts[:, 1]) ** 2 + (xc - pts[:, 2]) ** 2
            labels[z, y0 : y0 + rows] = ids[d.argmin(1)].reshape(-1, shape[2])
    edge = torch.zeros(shape, dtype=torch.bool, device=device)
    edge[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    edge[:, :, 1:] |= labels[:, :, 1:] != labels[:, :, :-1]
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = 170.0 - 110.0 * edge.float() + 15.0 * torch.randn(shape, generator=gen, device=device)
    mask = torch.ones(shape, dtype=torch.uint8, device=device)
    mask[: max(1, shape[0] // 8)] = 0
    return {
        "raw": raw.clamp(0, 255).to(torch.uint8).cpu().numpy(),
        "labels": labels.cpu().numpy().astype(np.uint64),
        "mask": mask.cpu().numpy(),
    }


def write_train_inputs(work: str, net_config: dict, shape, seed: int, device, predict_roi) -> dict:
    """The sample as uncompressed Zarr, a setup dir holding ``net_config``,
    a ``train.toml`` with ``samples`` and a ``predict.toml`` over
    ``predict_roi`` (voxel offset, shape) with the latest checkpoint."""
    from bootstrapper_torch.core.arrays import prepare_ds
    from bootstrapper_torch.utils import tomlio

    voxel_size = (40, 4, 4)
    sample = voronoi_sample(shape, max(8, int(np.prod(shape) // 40_000)), seed, device)
    for name, a in sample.items():
        ds = prepare_ds(os.path.join(work, "sample.zarr", name), a.shape, (0, 0, 0), voxel_size, a.dtype)
        ds[ds.roi] = a
    setup = os.path.join(work, "setup", "3d_affs")
    os.makedirs(setup, exist_ok=True)
    with open(os.path.join(setup, "net_config.json"), "w") as f:
        json.dump(net_config, f)
    train_toml = os.path.join(work, "train.toml")
    tomlio.dump(
        {
            "train": {
                "setup_dir": setup, "voxel_size": list(voxel_size), "seed": seed,
                "save_checkpoints_every": 20, "save_snapshots_every": 0,
                "samples": [{k: os.path.join(work, "sample.zarr", k) for k in ("raw", "labels", "mask")}],
            }
        },
        train_toml,
    )
    predict_toml = os.path.join(work, "predict.toml")
    offset, roi_shape = predict_roi
    tomlio.dump(
        {
            "predict": {
                "vol": {
                    "raw_dataset": os.path.join(work, "sample.zarr", "raw"),
                    "output_container": os.path.join(work, "sample.zarr"),
                    "roi_offset": [o * v for o, v in zip(offset, voxel_size)],
                    "roi_shape": [s * v for s, v in zip(roi_shape, voxel_size)],
                    "chain": [{"setup_dir": setup, "output_prefix": "predictions", "checkpoint_iteration": "latest"}],
                }
            }
        },
        predict_toml,
    )
    return {"train_toml": train_toml, "predict_toml": predict_toml, "setup": setup, "voxel_size": voxel_size}


def train_conv_cases(net_config: dict) -> list:
    """The kernel-route convs of one training forward at the net's input
    shape, traced on the ``meta`` device, named after the tile's convs of
    ``conv_cases`` (the same convs in the same order):
    ``(name, input shape, crop, weight shape, bias)``."""
    import torch

    from bootstrapper_torch.models import Model

    with torch.device("meta"):
        model = Model(net_config)
    x = torch.empty((1, *net_config["input_shape"], 1), device="meta")
    with torch.no_grad():
        _, cases = trace_kernel_convs(lambda: model(x))
    tile_cases = conv_cases()
    if [(c[2], c[3]) for c in cases] != [(t[3], t[4]) for t in tile_cases]:
        raise AssertionError("the training forward runs other kernel convs than a tile")
    return [(f"train_{t[0]}", *c) for t, c in zip(tile_cases, cases)]


def train_conv_keys(net_config: dict) -> set:
    """``(input view shape, weight shape)`` of each kernel conv of a
    training forward, as the launch counts key them."""
    return {conv_key(c) for c in train_conv_cases(net_config)}


FUNCTION_CASES = [
    ("relu_300to300_k3", (1, 8, 30, 30, 300), None, (3, 3, 3, 300, 300), True),
    ("residual_view_300to1500_k1", (1, 10, 36, 36, 300), (6, 28, 28), (1, 1, 1, 300, 1500), False),
]


def check_conv_function(seed: int, device="cuda", cases=FUNCTION_CASES) -> list:
    """``Conv3dFunction`` in fp32 on the card (the fp32 kernel forward, cuDNN
    backward in full fp32) against autograd through ``conv3d_plain``: output
    and dX, dW, db, each within FUNCTION_RTOL of the reference's largest
    value.  ``cases``: ``(name, input shape, crop, weight shape, relu)``; by
    default ReLU fused, and a 1x1 residual on a cropped view."""
    import torch

    from bootstrapper_torch.models.unet import center_crop
    from bootstrapper_torch.ops import conv3d as C

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    try:
        for name, xs, crop, ws, relu in cases:
            base = C.empty_channels_last(xs, torch.float32, device)
            base.copy_(torch.randn(xs, generator=gen, device=device))
            x0 = base if crop is None else center_crop(base, crop)
            w0 = torch.randn(ws, generator=gen, device=device) / math.sqrt(np.prod(ws[:4]))
            b0 = torch.randn(ws[-1], generator=gen, device=device)
            got_in = [t.detach().clone().requires_grad_(True) for t in (w0, b0)]
            ref_in = [t.detach().clone().requires_grad_(True) for t in (w0, b0)]
            xg = x0.detach().requires_grad_(True)  # the view itself, strides and all
            xr = x0.detach().clone().requires_grad_(True)
            before = C.COUNTS["kernel"]
            out = C.Conv3dFunction.apply(xg, got_in[0], got_in[1], relu, None)
            if C.COUNTS["kernel"] != before + 1:
                raise AssertionError("Conv3dFunction did not launch the kernel")
            ref = C.conv3d_plain(xr, ref_in[0], ref_in[1], relu=relu)
            g = torch.randn(ref.shape, generator=gen, device=device)
            (out * g).sum().backward()
            (ref * g).sum().backward()
            errs = {}
            for key, a, r in (
                ("out", out.detach(), ref.detach()), ("dx", xg.grad, xr.grad),
                ("dw", got_in[0].grad, ref_in[0].grad), ("db", got_in[1].grad, ref_in[1].grad),
            ):
                errs[key] = float((a - r).abs().max() / r.abs().max())
            if max(errs.values()) > FUNCTION_RTOL:
                raise AssertionError(f"Conv3dFunction {name}: {errs} beyond {FUNCTION_RTOL}")
            rows.append({"shape": name, "x": list(x0.shape), "w": list(ws), "relu": relu, "rel_err": errs})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return rows


def whole_net_gradients(net_config: dict, params, batch: dict, device="cuda") -> dict:
    """On one batch: the bf16 model's gradients (kernel route, as it trains)
    against the fp32 model's with every conv on the library route (cuDNN,
    TF32 off): per parameter tensor present, nonzero and within GRAD_REL_L2
    relative L2."""
    import torch

    from bootstrapper_torch.models import Model, load_params
    from bootstrapper_torch.models import unet as U
    from bootstrapper_torch.ops import conv3d as C
    from bootstrapper_torch.train.loop import loss_fn

    def grads(model):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}

    before = C.COUNTS["kernel"]
    bf16 = load_params(Model(net_config), params).to(device)
    loss16, g16 = grads(bf16)
    kernel_launches = C.COUNTS["kernel"] - before
    if kernel_launches == 0 and torch.device(device).type == "cuda":
        raise AssertionError("the bf16 training forward launched no conv kernel")
    fp32 = load_params(Model(net_config, compute_dtype=torch.float32), params).to(device)
    real, tf32 = U.conv3d, torch.backends.cudnn.allow_tf32
    U.conv3d = lambda x, w, b=None, relu=False, pack=None: C.conv3d_library(x, w, b, relu=relu)
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss32, g32 = grads(fp32)
    finally:
        U.conv3d, torch.backends.cudnn.allow_tf32 = real, tf32
    rel = {}
    for n, ref in g32.items():
        got = g16[n]
        if got is None or not bool(got.abs().max() > 0):
            raise AssertionError(f"{n}: no gradient on the kernel route")
        rel[n] = float((got - ref).norm() / ref.norm())
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_REL_L2:
        raise AssertionError(f"bf16 gradients vs fp32: {worst} relative L2 {rel[worst]} > {GRAD_REL_L2}")
    return {
        "parameters": len(rel), "loss_bf16": loss16, "loss_fp32": loss32,
        "kernel_launches": kernel_launches, "max_rel_l2": rel[worst], "worst": worst,
        "median_rel_l2": float(np.median(list(rel.values()))), "bound": GRAD_REL_L2,
    }


def overfit(net_config: dict, params, batch: dict, steps: int, device="cuda") -> dict:
    """``steps`` train steps on one batch: the mean loss of the last 20 must
    lie below that of the first 20.  Then every packed weight the kernel
    read must equal the updated parameter (no stale pack), and every
    parameter's version must have moved with each step."""
    import torch

    from bootstrapper_torch.models import Model, load_params
    from bootstrapper_torch.models.unet import Conv
    from bootstrapper_torch.ops import conv3d as C
    from bootstrapper_torch.train.loop import TrainState, make_optimizer, make_train_step

    model = load_params(Model(net_config), params).to(device)
    state = TrainState(0, model, make_optimizer(model, 0.5e-4))
    step = make_train_step()
    versions = {n: p._version for n, p in model.named_parameters()}
    packs = C.COUNTS["pack"]
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        _, m = step(state, batch)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    seconds = time.perf_counter() - t0
    stale = [n for n, p in model.named_parameters() if p._version < versions[n] + steps]
    if stale:
        raise AssertionError(f"optimizer steps did not bump the versions of {stale[:4]}")
    # the last step updated the weights after its forward packed them: the
    # next call must repack, not serve what was packed before
    checked = 0
    for name, conv in model.named_modules():
        if isinstance(conv, Conv):
            for dtype, lo, hi in list(conv._packed):
                want = conv.w.detach()[..., lo:hi, :].to(dtype)
                if not torch.equal(C.unpack_weights(conv.packed(dtype, lo, hi)), want):
                    raise AssertionError(f"{name}: the packed weights are stale")
                checked += 1
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"overfit: mean loss of the first 20 steps {first}, of the last 20 {last}")
    return {
        "steps": steps, "first20_mean_loss": first, "last20_mean_loss": last,
        "loss_first": losses[0], "loss_last": losses[-1], "seconds": seconds,
        "packs_during": C.COUNTS["pack"] - packs, "packs_checked": checked,
    }


def top_level_zero_share(net_config: dict, params, batch: dict, device="cuda") -> float:
    """Share of the U-Net's top-level outputs (after its last ReLU, what the
    heads read) that are 0 on ``batch``, with ``params``."""
    import torch

    from bootstrapper_torch.models import Model, load_params

    model = load_params(Model(net_config), params).to(device)
    with torch.no_grad():
        z = model.unet(batch["input"].to(model.compute_dtype))
    return float((z == 0).float().mean())


def train_round(paths: dict, iterations, device="cuda") -> dict:
    """``run_training`` to ``iterations[0]``, again to ``iterations[1]``
    (which resumes), then ``run_prediction`` with the latest checkpoint.
    Launch counts zeroed before the first and read after the second."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.ops import conv3d_kernel_launches, launch_counts, reset_launch_counts
    from bootstrapper_torch.workflows import run_prediction, run_training

    first_n, total = iterations
    reset_launch_counts()
    t0 = time.perf_counter()
    first = run_training(paths["train_toml"], device=device, max_iterations=first_n)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = run_training(paths["train_toml"], device=device, max_iterations=total)
    second_s = time.perf_counter() - t0
    counts, by_conv = launch_counts(), conv3d_kernel_launches()
    log = [json.loads(line) for line in open(os.path.join(paths["setup"], "log", "loss.jsonl"))]
    # a second run that started afresh would log its iterations from 10 again
    its = [r["iteration"] for r in log]
    if its != sorted(set(its)) or its[-1] != total or first["iterations"] != first_n:
        raise AssertionError(f"training did not resume: {first}, {second}, log {log}")
    with np.load(second["checkpoint"]) as data:
        if int(data["step"]) != total or int(data["opt/0000"]) != total:
            raise AssertionError(f"checkpoint {second['checkpoint']}: step {data['step']}")
    t0 = time.perf_counter()
    stats = run_prediction(paths["predict_toml"], device=device)
    predict_s = time.perf_counter() - t0
    affs = open_ds(os.path.join(os.path.dirname(paths["train_toml"]), "sample.zarr", "predictions", "3d_affs"))
    a = affs.to_ndarray()
    if a.dtype != np.uint8 or a.shape[0] != 9 or a.min() == a.max():
        raise AssertionError(f"predictions from the trained checkpoint: {a.shape} {a.dtype} {a.min()}..{a.max()}")
    (pstats,) = stats.values()
    return {
        "iterations": [first_n, total], "seconds": [first_s, second_s],
        "losses": [[r["iteration"], r["loss"]] for r in log],
        "checkpoint": second["checkpoint"],
        "train_launches": counts, "conv_launches": by_conv,
        "predict_seconds": predict_s, "predict_tiles": pstats["tiles"], "predict_shape": list(a.shape),
        "affs_mean": float(a.mean()),
    }


def time_train_step(net_config: dict, sample_root: str, voxel_size, seed: int, steps: int, device="cuda",
                    pipe=None) -> dict:
    """The steady train step at the net's input shape, on the sample in
    ``sample_root`` (Zarr with raw, labels and mask) or from ``pipe`` (a
    pipeline the step then stops), by parts, over ``steps`` steps after
    three warm ones: host wait on the loader (host clock), then CUDA events
    around the device transform, forward, backward and optimizer; the wall
    time per step; peak memory; then one step under ``torch.profiler``:
    device time by group of its forward and its backward, and the idle
    share of the whole step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import Model
    from bootstrapper_torch.pipeline.training import TrainingPipeline
    from bootstrapper_torch.train.loop import create_train_state, loss_fn
    from bootstrapper_torch.train.sampler import Sample

    if pipe is None:
        sample = Sample(*(open_ds(os.path.join(sample_root, k)) for k in ("raw", "labels", "mask")))
        pipe = TrainingPipeline(net_config, voxel_size, [sample], seed=seed, device=device)
    state = create_train_state(Model(net_config).to(device), seed, 0.5e-4)
    model, opt = state.model, state.optimizer
    names = ("transform", "forward", "backward", "optimizer")
    try:
        for _ in range(3):
            batch = pipe.next_batch()
            opt.zero_grad(set_to_none=True)
            loss_fn(model, batch).backward()
            opt.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(steps)]
        host_s = np.zeros((steps, 5))  # host clock at the same five marks
        wait = 0.0
        t0 = time.perf_counter()
        for ev, hs in zip(marks, host_s):
            t = time.perf_counter()
            host = next(pipe.loader)
            wait += time.perf_counter() - t
            hs[0] = time.perf_counter()
            ev[0].record()
            batch = pipe.transform_batch(host)
            ev[1].record()
            hs[1] = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch)
            ev[2].record()
            hs[2] = time.perf_counter()
            loss.backward()
            ev[3].record()
            hs[3] = time.perf_counter()
            opt.step()
            ev[4].record()
            hs[4] = time.perf_counter()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        peak = torch.cuda.max_memory_allocated()
        parts = {
            k: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / steps for i, k in enumerate(names)
        }
        # the host's time to enqueue each part (it waits for the card only
        # in the transform's renumbering)
        host_parts = {k: float(np.diff(host_s, axis=1)[:, i].mean() * 1e3) for i, k in enumerate(names)}
        # one step under the profiler, its forward and backward apart
        batch = pipe.next_batch()
        torch.cuda.synchronize()
        opt.zero_grad(set_to_none=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as fwd_prof:
            loss = loss_fn(model, batch)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as bwd_prof:
            loss.backward()
            torch.cuda.synchronize()
        opt.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as step_prof:
            t = time.perf_counter()
            batch = pipe.next_batch()
            opt.zero_grad(set_to_none=True)
            loss_fn(model, batch).backward()
            opt.step()
            torch.cuda.synchronize()
            step_wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        pipe.stop()
    fwd_ms, fwd_groups, _ = device_groups(fwd_prof)
    bwd_ms, bwd_groups, bwd_top = device_groups(bwd_prof)
    step_ms, _, step_top = device_groups(step_prof)
    host_top = sorted(
        ((e.key, e.self_cpu_time_total / 1e3) for e in step_prof.key_averages()), key=lambda kv: -kv[1]
    )[:10]
    if not (fwd_ms and bwd_ms and step_ms):
        raise RuntimeError("torch.profiler recorded no device event in a train step")
    fl = tile_flops(net_config, net_config["input_shape"])
    n = pipe.batch_size
    forward = (fl["kernel"] + fl["library"]) * n
    # backward, counted: dW of every conv, dX of every conv but those that
    # read the net's input (conv products only)
    backward = forward + (forward - fl["on_input"] * n)
    return {
        "input_tile": list(net_config["input_shape"]), "batch": pipe.batch_size, "steps": steps,
        "wall_ms_per_iteration": wall_ms, "samples_per_s": 1e3 / wall_ms * pipe.batch_size,
        "loader_wait_ms": wait * 1e3 / steps, "device_ms_by_part": parts, "host_ms_by_part": host_parts,
        "host_top_self_cpu_ms": [[k[:100], ms] for k, ms in host_top],
        "forward_groups_ms": fwd_groups, "backward_groups_ms": bwd_groups,
        "backward_top_kernels_ms": bwd_top, "step_top_kernels_ms": step_top,
        "profiled_step_wall_ms": step_wall_ms, "profiled_step_device_ms": step_ms,
        "idle_share": 1 - step_ms / step_wall_ms, "peak_memory_gb": peak / 1e9,
        "flops_forward": forward, "flops_backward": backward,
        "flops_forward_kernel_route": fl["kernel"] * n,
        "tflops_per_s": (forward + backward) / wall_ms / 1e9,
        "bf16_roofline_share": (forward + backward) / wall_ms / 1e9 / (PEAK_BF16 / 1e12),
        "bound_ms": (forward + backward) / PEAK_BF16 * 1e3,
    }


def train_phase(seed: int, net_config: dict, shape, iterations, overfit_steps: int, timed_steps: int,
                predict_roi, device="cuda") -> tuple:
    """The training slice on the card: (a) a synthetic sample, (b) K1 at the
    training forward's shapes, (c) ``Conv3dFunction`` against plain in
    fp32, (d) whole-net gradients against fp32, (e) overfit one batch, (f)
    train, resume and predict through the entry points, (g) the steady
    step by parts.  Returns the phase's line and K1's rows, their launches
    those of (f)."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import init_params_numpy, load_checkpoint
    from bootstrapper_torch.pipeline.training import TrainingPipeline
    from bootstrapper_torch.train.sampler import Sample

    out = {}
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_train_") as work:
        t0 = time.perf_counter()
        paths = write_train_inputs(work, net_config, shape, seed, device, predict_roi)
        out["sample"] = {"shape": list(shape), "seconds": time.perf_counter() - t0}
        cases = train_conv_cases(net_config)
        rows = check_conv(seed, cases, fp32=False) if device == "cuda" else []
        out["function_fp32"] = check_conv_function(seed, device) if device == "cuda" else []
        root = os.path.join(work, "sample.zarr")
        sample = Sample(*(open_ds(os.path.join(root, k)) for k in ("raw", "labels", "mask")))
        pipe = TrainingPipeline(net_config, paths["voxel_size"], [sample], seed=seed, device=device, num_threads=1)
        try:
            batch = pipe.next_batch()
        finally:
            pipe.stop()
        params = init_params_numpy(net_config, seed)
        out["gradients"] = whole_net_gradients(net_config, params, batch, device)
        out["overfit"] = overfit(net_config, params, batch, overfit_steps, device)
        out["round"] = train_round(paths, iterations, device)
        trained = load_checkpoint(out["round"]["checkpoint"])
        out["round"]["checkpoint"] = os.path.basename(out["round"]["checkpoint"])
        out["top_level_zero_share"] = {
            "init": top_level_zero_share(net_config, params, batch, device),
            "trained": top_level_zero_share(net_config, trained, batch, device),
        }
        del batch
        by_conv = out["round"].pop("conv_launches")
        for row in rows:
            row["launches"] = by_conv.pop((tuple(row["x"]), tuple(row["w"])), 0)
        want = iterations[1]
        off_plan = by_conv or [r["shape"] for r in rows if r["launches"] != want]
        if device == "cuda" and (off_plan or out["round"]["train_launches"]["conv3d.kernel"] != want * len(rows)):
            raise AssertionError(
                f"training: conv kernel launches {out['round']['train_launches']} "
                f"(not one per iteration at {off_plan})"
            )
        if device == "cuda":
            out["step"] = time_train_step(net_config, root, paths["voxel_size"], seed, timed_steps, device)
    return out, rows


# -- (r) one whole round ---------------------------------------------------


def stage(log: dict, name: str, fn):
    """``fn()`` with the launch counts zeroed just before it and read just
    after; its seconds and counts go to ``log[name]``."""
    from bootstrapper_torch.ops import conv3d_kernel_launches, launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    log[name] = {
        "seconds": time.perf_counter() - t0,
        "launches": launch_counts(),
        "conv_launches": conv3d_kernel_launches(),
    }
    return out


def errors_by_parts(run, block_fn: str) -> dict:
    """``run()``, an error scan on the card, once more with each block's
    upload, device work (``eval.errors.<block_fn>``) and download
    synchronised and timed on the host's clock; the rest of the wall time
    is the host's (Zarr reads, renumbering, writes).  Also the blocks, the
    seconds per block and the scan's peak device memory."""
    import torch

    from bootstrapper_torch.eval import errors as E

    names = {"upload": "upload_block", "device": block_fn, "download": "download_block"}
    parts = dict.fromkeys(names, 0.0)
    real = {k: getattr(E, n) for k, n in names.items()}
    blocks = 0

    def timed(key, fn):
        def call(*args, **kw):
            nonlocal blocks
            blocks += key == "device"
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            return out

        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k, n in names.items():
        setattr(E, n, timed(k, real[k]))
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        for k, n in names.items():
            setattr(E, n, real[k])
    return {
        "wall_s": wall, **{f"{k}_s": v for k, v in parts.items()},
        "host_rest_s": wall - sum(parts.values()), "blocks": blocks, "seconds_per_block": wall / max(blocks, 1),
        "device_s_per_block": parts["device"] / max(blocks, 1),
        "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
    }


def check_errors(entry: dict, seg, pred, neighborhood, thresholds, out_container) -> dict:
    """The card's error map and mask (``entry``, from ``run_evaluation``)
    against the CPU route's on the same Zarrs: the map within ERR_ATOL,
    the masks equal except on ties, the counts equal up to the ties whose
    mask differs."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.eval import compute_aff_errors

    t0 = time.perf_counter()
    cpu = compute_aff_errors(seg, pred, neighborhood, out_container, thresholds=thresholds, device="cpu")
    cpu_s = time.perf_counter() - t0
    got, want = open_ds(entry["error_map"]).to_ndarray(), open_ds(cpu["error_map"]).to_ndarray()
    err = float(np.abs(got - want).max())
    tie = np.zeros(want.shape, dtype=bool)
    for t in thresholds:
        tie |= np.abs(want - t) <= ERR_ATOL
    differs = open_ds(entry["error_mask"]).to_ndarray() != open_ds(cpu["error_mask"]).to_ndarray()
    out = {
        "max_abs_err": err, "atol": ERR_ATOL, "ties": int(tie.sum()),
        "tie_voxels_differing": int(differs[tie].sum()), "voxels_differing_elsewhere": int(differs[~tie].sum()),
        "nonzero_ratio": entry["nonzero_ratio"], "cpu_nonzero_ratio": cpu["nonzero_ratio"], "cpu_seconds": cpu_s,
    }
    if (
        err > ERR_ATOL
        or out["voxels_differing_elsewhere"]
        or abs(entry["nonzero_voxels"] - cpu["nonzero_voxels"]) > out["tie_voxels_differing"]
        or entry["total_voxels"] != cpu["total_voxels"]
    ):
        raise AssertionError(f"prediction errors on the card against the CPU route: {out}")
    return out


def write_gt_affinities(labels, pred, neighborhood, device, grow: int = 0) -> None:
    """Overwrite the prediction ``pred`` (uint8, channels first) with the
    affinities of the GT ``labels`` over its ROI, as a perfect net would
    predict them: ``seg_to_affs`` on ``device`` of the labels read grown by
    the neighbourhood's extent (renumbered on the host, exactly; their
    boundaries grown in xy by ``grow``, as the net's targets), 255 for an
    affinity."""
    import torch

    from bootstrapper_torch.core.geometry import Coordinate
    from bootstrapper_torch.ops.affinities import grow_boundary, seg_to_affs
    from bootstrapper_torch.train.sampler import renumber

    if pred.shape[0] != len(neighborhood):
        raise AssertionError(f"{pred.shape[0]} prediction channels for {len(neighborhood)} offsets")
    ext = Coordinate(np.abs(np.asarray(neighborhood)).max(0).tolist())
    ids = renumber(labels.to_ndarray(pred.roi.grow(ext * pred.voxel_size, ext * pred.voxel_size)))
    ids = torch.from_numpy(ids.astype(np.int64)).to(device)
    if grow:
        ids = grow_boundary(ids, steps=grow, only_xy=True)
    affs = seg_to_affs(ids, neighborhood, torch.uint8) * 255
    crop = tuple(slice(e, n - e) for e, n in zip(ext, ids.shape))
    pred[pred.roi] = affs[(slice(None), *crop)].cpu().numpy()


def write_gt_lsds(labels, pred, device) -> None:
    """Overwrite the LSD prediction ``pred`` (uint8, channels first) with
    the GT ``labels``' own LSDs, as a perfect net would predict them: per
    block of the LSD error scan, from the labels read with the scan's
    margin (renumbered on the host) in its id chunks, the core written as
    ``round(lsd * 255)``."""
    import torch

    from bootstrapper_torch.core.geometry import Coordinate
    from bootstrapper_torch.eval import errors as E
    from bootstrapper_torch.predict.scan import tile_rois
    from bootstrapper_torch.train.sampler import renumber

    vs = pred.voxel_size
    pad = E.lsd_context((LSD_SIGMA,) * 3, vs)
    block = Coordinate(min(b * v, s) for b, v, s in zip((16, 128, 128), vs, pred.roi.shape))
    for wroi in tile_rois(pred.roi, block):
        ids = renumber(labels.to_ndarray(wroi.grow(pad, pad)))
        lsds = E.block_lsds(torch.from_numpy(ids).to(device), int(ids.max()), (LSD_SIGMA,) * 3, tuple(vs), LSD_DOWNSAMPLE)
        core = tuple(slice(p // v, p // v + s // v) for p, v, s in zip(pad, vs, wroi.shape))
        pred[wroi] = torch.round(torch.clamp(lsds[(slice(None), *core)], 0, 1) * 255).to(torch.uint8).cpu().numpy()


def check_filter(result: dict, best: str, err_mask, fcfg: dict) -> dict:
    """``run_filter``'s output against the host filter recomputed: it
    filtered the evaluation's best segmentation, every voxel is the
    source's or 0, the removed ids are ``compute_ids_to_remove``'s, the
    mask is the kept labels with the error mask applied.  Object counts
    and the pseudo-GT's coverage."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.post.filter import compute_ids_to_remove

    if result["source_segmentation"] != best:
        raise AssertionError(f"filtered {result['source_segmentation']}, the evaluation's best is {best}")
    src = open_ds(best).to_ndarray()
    labels = open_ds(result["labels"]).to_ndarray()
    mask = open_ds(result["mask"]).to_ndarray()
    removed = compute_ids_to_remove(
        src, fcfg["dust_filter"], fcfg["remove_outliers"], fcfg["remove_z_fragments"], fcfg["overlap_filter"]
    )
    want_mask = labels > 0
    if err_mask is not None:
        want_mask &= open_ds(err_mask).to_ndarray() == 0
    if (
        result["removed_ids"] != len(removed)
        or not np.array_equal(labels, np.where(np.isin(src, removed), 0, src))
        or not np.array_equal(mask, want_mask.astype(np.uint8))
    ):
        raise AssertionError(f"filter output differs from the host filter: {result}")
    return {
        "segments_before_filter": int(len(np.unique(src[src != 0]))),
        "segments_after_filter": int(len(np.unique(labels[labels != 0]))),
        "removed_ids": result["removed_ids"],
        "pseudo_gt_mask_coverage": float(mask.mean()),
    }


def round_zero_share(net_config: dict, volume: dict, checkpoint: str, seed: int, device) -> dict:
    """``top_level_zero_share`` of the net at init and with ``checkpoint``,
    on one training batch of ``volume``."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import init_params_numpy, load_checkpoint
    from bootstrapper_torch.pipeline.training import TrainingPipeline
    from bootstrapper_torch.train.sampler import Sample

    sample = Sample(*(open_ds(volume[k]) for k in ("raw_dataset", "labels_dataset", "labels_mask_dataset")))
    pipe = TrainingPipeline(net_config, volume["voxel_size"], [sample], seed=seed, device=device, num_threads=1)
    try:
        batch = pipe.next_batch()
    finally:
        pipe.stop()
    return {
        "init": top_level_zero_share(net_config, init_params_numpy(net_config, 0), batch, device),
        "trained": top_level_zero_share(net_config, load_checkpoint(checkpoint), batch, device),
    }


def write_round_sample(work: str, shape, seed: int, device) -> dict:
    """``voronoi_sample`` of ``shape`` as uncompressed Zarr in
    ``work/vol.zarr``; the volumes dict ``make_round_configs`` takes."""
    from bootstrapper_torch.core.arrays import prepare_ds

    container, voxel_size = os.path.join(work, "vol.zarr"), (40, 4, 4)
    sample = voronoi_sample(shape, max(8, int(np.prod(shape) // 40_000)), seed, device)
    for name, a in sample.items():
        ds = prepare_ds(os.path.join(container, name), a.shape, (0, 0, 0), voxel_size, a.dtype)
        ds[ds.roi] = a
    return {
        "vol": {
            "raw_dataset": f"{container}/raw", "labels_dataset": f"{container}/labels",
            "labels_mask_dataset": f"{container}/mask", "voxel_size": list(voxel_size),
            "output_container": container,
        }
    }


def round_phase(seed: int, net_config: dict, shape, iterations, train_shapes=None, device="cuda") -> tuple:
    """One whole round through the entry points, as a user runs it from
    the configs ``make_round_configs`` writes: round 1 on the Voronoi
    sample of ``shape`` with its labels as GT (train ``iterations[0]``,
    predict, segment in ws mode, evaluate by VOI, evaluate again by
    prediction errors with the config written without GT, filter); then
    segment, evaluate and filter again from the same configs on the GT's
    affinities written over the prediction (``gt_affs``: what a perfect net
    would hand on, since a net this young segments little or nothing);
    then round 2 from round 1's ``next_volumes.toml`` (train
    ``iterations[1]`` on the pseudo-GT that pass left).  Launch counts are
    zeroed before each entry point and read after it.  Checks: K1 once per
    iteration at each of ``train_shapes`` and on every predict step at the
    stream's shapes (held against the plain version here), K2 in each
    segment; the error maps against the CPU route; each filter's output
    against the host filter.  Returns the phase's line, K1's rows at the
    predict shapes and K2's at the segment's."""
    from bootstrapper_torch import configs
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.eval import compute_aff_errors
    from bootstrapper_torch.utils import tomlio
    from bootstrapper_torch.workflows import (
        run_evaluation, run_filter, run_prediction, run_segmentation, run_training,
    )
    from bootstrapper_torch.workflows.filter import get_best_seg_from_eval

    first_n, second_n = iterations
    stages: dict = {}
    out = {"volume": list(shape), "iterations": list(iterations)}
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_round_") as work:
        t0 = time.perf_counter()
        volumes = write_round_sample(work, shape, seed, device)
        container = volumes["vol"]["output_container"]

        def make_round(name, vols, n, **kw):
            paths = configs.make_round_configs(
                os.path.join(work, name), vols, ["3d_affs"], max_iterations=n, **kw
            )
            write_setup_config(os.path.join(work, name, "setups", "3d_affs"), net_config)
            return paths

        r1 = make_round("round_1", volumes, first_n, gt_labels=f"{container}/labels")
        # a snapshot runs one forward more
        snapshot_every = tomlio.load(r1["train_3d_affs"])["train"]["save_snapshots_every"] or 10**9
        # the same round written without GT: its evaluation scores by
        # prediction errors against round 1's affinities
        nogt = make_round("nogt", volumes, first_n)["evaluate"]
        out["prepare_seconds"] = time.perf_counter() - t0

        train1 = stage(stages, "train", lambda: run_training(r1["train_3d_affs"], device=device))
        (pstats,) = stage(stages, "predict", lambda: run_prediction(r1["predict"], device=device)).values()

        def segment_evaluate_filter(suffix, errors=None):
            """segment, evaluate by VOI (and, given ``errors``, by prediction
            errors into it) and filter from round 1's configs; the filter
            held against the host filter."""
            segs = stage(stages, f"segment{suffix}", lambda: run_segmentation(r1["segment"], device=device))["vol"]
            voi = stage(stages, f"evaluate{suffix or '_gt'}", lambda: run_evaluation(r1["evaluate"], device=device))["vol"]
            if errors is not None:
                errors.update(stage(
                    stages, "evaluate_pred",
                    lambda: run_evaluation(nogt, out_result=os.path.join(work, "nogt_results.json"), device=device),
                )["vol"])
            filtered = stage(stages, f"filter{suffix}", lambda: run_filter(r1["filter"]))["vol"]
            best, err_mask = get_best_seg_from_eval(os.path.join(container, "eval", "vol_results.json"))
            return best, {
                "segments_per_threshold": {
                    t: int(len(np.unique(open_ds(p).to_ndarray())) - 1) for t, p in segs.items()
                },
                "best_segmentation": os.path.basename(best),
                "voi": {os.path.basename(p): e["voi"] for p, e in voi.items()},
                **check_filter(filtered, best, err_mask, tomlio.load(r1["filter"])["filter"]["vol"]),
            }

        errors: dict = {}
        best, quality = segment_evaluate_filter("", errors)
        # prediction errors: the card against the CPU route, every segmentation
        ev = tomlio.load(nogt)["evaluate"]["vol"]["pred"]
        pred = open_ds(ev["pred_dataset"])
        nbhd, thresholds = ev["params"]["aff_neighborhood"], tuple(ev["thresholds"])
        # and on the GT labels (ids past 2^32), whatever round 1 segmented
        gt_ds = open_ds(f"{container}/labels")
        checks = {
            os.path.basename(path): (entry["pred_errors"], open_ds(path)) for path, entry in errors.items()
        }
        checks["gt_labels"] = (
            compute_aff_errors(gt_ds, pred, nbhd, os.path.join(work, "gt_errors"), thresholds=thresholds, device=device),
            gt_ds,
        )
        # the CPU routes in threads, each into its own container: their block
        # loops are host work that releases the interpreter lock in the
        # reads, renumbering, torch ops and writes (one after another they
        # took 35-40 s of the phase)
        with ThreadPoolExecutor(len(checks)) as pool:
            futures = {
                name: pool.submit(
                    check_errors, entry, seg, pred, nbhd, thresholds, os.path.join(work, "cpu_errors", name)
                )
                for name, (entry, seg) in checks.items()
            }
            out["errors_vs_cpu"] = {name: f.result() for name, f in futures.items()}
        if device == "cuda":
            out["errors_by_parts"] = errors_by_parts(
                lambda: compute_aff_errors(open_ds(best), pred, nbhd, os.path.join(work, "timed_errors"), device=device),
                "block_error",
            )
        gt = gt_ds.to_ndarray()
        setup1 = os.path.join(work, "round_1", "setups", "3d_affs")
        log = [json.loads(line) for line in open(os.path.join(setup1, "log", "loss.jsonl"))]
        out.update(
            {
                "losses": {"round_1": train1["final_loss"]},
                "round_1_loss_log": [[r["iteration"], r["loss"]] for r in log if r["iteration"] % 100 == 0],
                "top_level_zero_share": round_zero_share(
                    net_config, volumes["vol"], train1["checkpoint"], seed, device
                ),
                "predict": {k: pstats[k] for k in pstats if k != "plan"},
                **quality,
                "error_ratio": {os.path.basename(p): e["pred_errors"]["nonzero_ratio"] for p, e in errors.items()},
                "gt_segments": int(len(np.unique(gt[gt != 0]))),
            }
        )
        del gt
        emit({"phase": "round_1", **out, "stage_seconds": {k: v["seconds"] for k, v in stages.items()}})

        # the same stages on a perfect prediction, so that round 2 trains on
        # a pseudo-GT whatever the net learnt
        write_gt_affinities(gt_ds, pred, nbhd, device)
        out["gt_affs"] = segment_evaluate_filter("_gt_affs")[1]

        next_volumes = tomlio.load(os.path.join(work, "round_1", "next_volumes.toml"))["volumes"]
        r2 = make_round("round_2", next_volumes, second_n)
        r2_sample = tomlio.load(r2["train_3d_affs"])["train"]["samples"][0]
        if "pseudo_gt" not in r2_sample["labels"] or "pseudo_gt" not in r2_sample["mask"]:
            raise AssertionError(f"round 2 does not train on the pseudo-GT: {r2_sample}")
        train2 = stage(stages, "train_round_2", lambda: run_training(r2["train_3d_affs"], device=device))
        out["losses"]["round_2"] = train2["final_loss"]
        for res, n in ((train1, first_n), (train2, second_n)):
            if res["iterations"] != n or not res["checkpoint"].endswith(f"model_checkpoint_{n}"):
                raise AssertionError(f"training: {res}")
        out["stage_seconds"] = {k: v["seconds"] for k, v in stages.items()}
        out["launches"] = {k: v["launches"] for k, v in stages.items()}
    if device != "cuda":
        return out, [], []

    # K1: once per iteration at each training shape; on every predict step
    # at the warm or steady step's shapes, held here against plain
    n_train = len(train_shapes)
    for name, n in (("train", first_n), ("train_round_2", second_n)):
        n += n // snapshot_every
        by_conv = stages[name]["conv_launches"]
        if set(by_conv) != train_shapes or set(by_conv.values()) != {n}:
            raise AssertionError(f"round {name}: conv kernel launches {by_conv}, want {n} at each of {n_train}")
    if "steps_per_column" not in pstats:
        raise AssertionError(f"the round's prediction was not streamed: {pstats}")
    step_tile = [pstats["step_z"], *pstats["input_tile"][1:]]
    rows = check_conv(seed, stream_conv_cases(net_config, step_tile, pstats["warm_step_z"]), fp32=False)
    columns, steps = pstats["columns"], pstats["steps_per_column"]
    by_conv = dict(stages["predict"]["conv_launches"])
    for row in rows:
        row["shape"] = f"round_{row['shape']}"
        row["launches"] = by_conv.pop((tuple(row["x"]), tuple(row["w"])), 0)
    off_plan = by_conv or [
        r["shape"] for r in rows
        if r["launches"] != (columns if r["shape"].startswith("round_warm_") else columns * (steps - 1))
    ]
    if off_plan or stages["predict"]["launches"]["conv3d.kernel"] != n_train * columns * steps:
        raise AssertionError(f"round predict: conv kernel launches off plan at {off_plan}")
    seed_launches = {k: stages[k]["launches"]["seed_maxima.kernel"] for k in ("segment", "segment_gt_affs")}
    if min(seed_launches.values()) < 1:
        raise AssertionError(f"round segment: the seed kernel did not run in each: {seed_launches}")
    seed_rows = check_seeds(seed, [(f"round_stack_{'x'.join(map(str, shape))}_size10", tuple(shape), 10)])
    seed_rows[0]["launches"] = sum(seed_launches.values())
    # what the stages counted, by stage (and for training by shape)
    out["conv_launches"] = {
        name: sum(stages[name]["conv_launches"].values()) for name in ("train", "predict", "train_round_2")
    }
    out["train_conv_launches"] = {
        key: stages["train"]["conv_launches"][key] + stages["train_round_2"]["conv_launches"][key]
        for key in train_shapes
    }
    out["seed_launches"] = seed_launches
    return out, rows, seed_rows


# -- (l) the LSD setups ----------------------------------------------------


def lsd_phase(seed: int, device="cuda") -> dict:
    """``lsd_descriptors_downsampled`` on the card against its CPU route at
    each of LSD_CASES (Voronoi ids, renumbered, clamped to the case's
    labels), with TF32 switched on for cuBLAS and cuDNN around the card's
    call, which the LSD route must turn off itself: max |diff| within
    LSD_ATOL.  Device ms (CUDA events around calls queued behind a device
    sleep), the call's ms, its peak memory and the CPU route's seconds."""
    import torch

    from bootstrapper_torch.ops.lsd import lsd_descriptors_downsampled
    from bootstrapper_torch.train.sampler import renumber

    out = {}
    for name, shape, max_labels in LSD_CASES:
        ids = renumber(voronoi_sample(shape, max_labels + max_labels // 8, seed, device)["labels"])
        seg = torch.from_numpy(ids.astype(np.int64))

        def run(s):
            return lsd_descriptors_downsampled(
                s, LSD_SIGMA, (40, 4, 4), downsample=LSD_DOWNSAMPLE, max_labels=max_labels
            )

        t0 = time.perf_counter()
        want = run(seg)
        cpu_s = time.perf_counter() - t0
        seg_d = seg.to(device)
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            got = run(seg_d).cpu()
            if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != (True, True):
                raise AssertionError("the LSD route left the caller's TF32 setting changed")
            ms = cuda_time_ms(lambda: run(seg_d), iters=5, queued=True)
            call_ms = cuda_time_ms(lambda: run(seg_d), iters=5)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run(seg_d)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        err = float((got - want).abs().max())
        if not err <= LSD_ATOL or not torch.isfinite(got).all():
            raise AssertionError(f"LSDs {name}: card against CPU max |err| {err} > {LSD_ATOL}")
        out[name] = {
            "shape": list(shape), "max_labels": max_labels, "ids": int(ids.max()),
            "max_abs_err": err, "atol": LSD_ATOL, "ms": ms, "call_ms": call_ms,
            "peak_memory_gb": peak / 1e9, "cpu_seconds": cpu_s,
        }
    return out


def launch_group(stage_log: dict, cases) -> dict:
    """A stage's K1 launches by conv beside the traced convs it may run
    (``(name, input shape, crop, weight shape, bias)``), for the
    ``kernels`` line."""
    return {"by_conv": dict(stage_log["conv_launches"]), "cases": list(cases)}


def check_launches(name: str, by_conv: dict, runs) -> None:
    """K1 launched ``n`` times at each traced conv of ``cases`` (once per
    forward) for each ``(cases, n)`` of ``runs``, and nowhere else."""
    want: dict = {}
    for cases, n in runs:
        for c in cases:
            want[conv_key(c)] = want.get(conv_key(c), 0) + n
    if by_conv != want:
        raise AssertionError(f"{name}: conv kernel launches {by_conv}, want {want}")


def check_stream_launches(name: str, by_conv: dict, warm, steady, stats: dict) -> None:
    """K1 once per column at each warm-step conv and once per later step
    at each steady-step conv of a streamed prediction, nowhere else."""
    if "steps_per_column" not in stats:
        raise AssertionError(f"{name}: the prediction was not streamed: {stats}")
    columns, steps = stats["columns"], stats["steps_per_column"]
    check_launches(name, by_conv, [(warm, columns), (steady, columns * (steps - 1))])


def check_train_launches(name: str, by_conv: dict, net_config: dict, n: int) -> None:
    check_launches(name, by_conv, [(train_conv_cases(net_config), n)])


def check_lsd_block(seg, pred, seed: int, device) -> dict:
    """One block of the LSD error scan, on the card and on the CPU route
    from the same host block: the map within LSD_ERR_ATOL, the masks equal
    except on ties.  The block is drawn from ``seed`` among the scan's."""
    from bootstrapper_torch.core.geometry import Coordinate
    from bootstrapper_torch.eval import errors as E
    from bootstrapper_torch.predict.scan import tile_rois
    from bootstrapper_torch.train.sampler import renumber

    vs = seg.voxel_size
    roi = seg.roi.intersect(pred.roi)
    blocks = tile_rois(roi, Coordinate(min(b * v, s) for b, v, s in zip((16, 128, 128), vs, roi.shape)))
    block = blocks[np.random.default_rng(seed).integers(len(blocks))]
    pad = E.lsd_context((LSD_SIGMA,) * 3, vs)
    ids = renumber(seg.to_ndarray(block.grow(pad, pad)))
    p = pred.to_ndarray(block.grow(pad, pad))
    runs = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        seg_t, pred_t = E.upload_block(ids, p, dev)
        err, mask = E.block_lsd_error(seg_t, int(ids.max()), pred_t, (LSD_SIGMA,) * 3, tuple(vs), LSD_DOWNSAMPLE)
        runs[dev] = (err.cpu().numpy(), mask.cpu().numpy(), time.perf_counter() - t0)
    (got, got_mask, dev_s), (want, want_mask, cpu_s) = runs[device], runs["cpu"]
    diff = float(np.abs(got - want).max())
    tie = (np.abs(want - 0.1) <= LSD_ERR_ATOL) | (np.abs(want - 1.0) <= LSD_ERR_ATOL)
    out = {
        "block": [list(block.offset), list(block.shape)], "read_shape": list(ids.shape), "ids": int(ids.max()),
        "max_abs_err": diff, "atol": LSD_ERR_ATOL, "ties": int(tie.sum()),
        "masks_differ_elsewhere": int((got_mask != want_mask)[~tie].sum()),
        "device_call_s": dev_s, "cpu_s": cpu_s, "mean_error": float(want.mean()),
    }
    if diff > LSD_ERR_ATOL or out["masks_differ_elsewhere"]:
        raise AssertionError(f"LSD error block on the card against the CPU route: {out}")
    return out


def lsd_sanity(labels, work: str, device) -> dict:
    """``compute_lsd_errors`` of a SANITY_CROP of the GT ``labels`` against
    the crop's own LSDs written as uint8: they are computed on the whole
    crop in id chunks of 255 (``errors.block_lsds``, as the scan chunks
    them), so every block the scan reads agrees with them up to the uint8
    step, and under SANITY_MAX_MASKED of the voxels may be masked."""
    import torch

    from bootstrapper_torch.core.arrays import open_ds, prepare_ds
    from bootstrapper_torch.core.geometry import Coordinate, Roi
    from bootstrapper_torch.eval import compute_lsd_errors
    from bootstrapper_torch.eval import errors as E
    from bootstrapper_torch.train.sampler import renumber

    vs = labels.voxel_size
    shape = Coordinate(SANITY_CROP)
    begin = (labels.roi.shape / vs - shape) // 2 * vs + labels.roi.begin
    crop = Roi(begin, shape * vs)
    ids = labels.to_ndarray(crop)
    dense = renumber(ids)
    lsds = E.block_lsds(torch.from_numpy(dense).to(device), int(dense.max()), (LSD_SIGMA,) * 3, tuple(vs), LSD_DOWNSAMPLE)
    q = torch.round(torch.clamp(lsds, 0, 1) * 255).to(torch.uint8).cpu().numpy()
    arrays = {}
    for name, a in (("labels", ids), ("lsds", q)):
        ds = prepare_ds(os.path.join(work, "sanity.zarr", name), a.shape, crop.offset, vs, a.dtype)
        ds[ds.roi] = a
        arrays[name] = ds
    res = compute_lsd_errors(
        arrays["labels"], arrays["lsds"], LSD_SIGMA, os.path.join(work, "sanity_errors.zarr"), device=device
    )
    err = open_ds(res["error_map"]).to_ndarray()
    out = {
        "crop": [list(crop.offset), list(SANITY_CROP)], "ids": int(dense.max()),
        "masked_share": res["nonzero_ratio"], "max_masked_share": SANITY_MAX_MASKED,
        "mean_error": float(err.mean()), "max_error": float(err.max()),
    }
    if not res["nonzero_ratio"] < SANITY_MAX_MASKED:
        raise AssertionError(f"LSD errors of the GT against its own LSDs: {out}")
    return out


def write_setup_config(setup_dir: str, net_config: dict) -> None:
    """``net_config`` over the setup's ``net_config.json`` (the zoo's, as
    ``make_round_configs`` wrote it; a narrower one in a rehearsal)."""
    with open(os.path.join(setup_dir, "net_config.json"), "w") as f:
        json.dump(net_config, f)


def mtlsd_round_phase(work: str, volumes: dict, seed: int, net_config: dict, iterations: int,
                      timed_steps: int, device="cuda") -> tuple:
    """A 3d_mtlsd round from the configs ``make_round_configs`` writes
    without GT, on the Voronoi sample ``volumes`` names: train (both
    heads), predict (streamed, both heads written), segment (ws), evaluate
    by LSD errors against the LSD head (on the card), filter; then segment,
    evaluate and filter again from the same configs on the GT's own
    affinities and LSDs written over both heads (``gt_heads``: what a
    perfect net would hand on).  Checks: both heads' outputs; K1 once per
    iteration at each training shape and on every predict step; K2 in each
    segment; a block of the scan on the card against the CPU route (GT
    labels, and the perfect pass's best segmentation); the GT's own LSDs
    through the scan (``lsd_sanity``); each filter against the host
    filter.  The scan once more by parts, and the steady train step.
    Returns the phase's line and its K1 launch groups."""
    from bootstrapper_torch import configs
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.eval import compute_lsd_errors
    from bootstrapper_torch.utils import tomlio
    from bootstrapper_torch.workflows import (
        run_evaluation, run_filter, run_prediction, run_segmentation, run_training,
    )
    from bootstrapper_torch.workflows.filter import get_best_seg_from_eval

    stages: dict = {}
    vol = volumes["vol"]
    container = vol["output_container"]
    t0 = time.perf_counter()
    round_dir = os.path.join(work, "mtlsd")
    paths = configs.make_round_configs(round_dir, volumes, ["3d_mtlsd"], max_iterations=iterations)
    write_setup_config(os.path.join(round_dir, "setups", "3d_mtlsd"), net_config)
    ev = tomlio.load(paths["evaluate"])["evaluate"]["vol"]
    if "gt" in ev or ev["pred"]["params"] != {"lsd_sigma": LSD_SIGMA}:
        raise AssertionError(f"the round's evaluation does not score by LSD errors: {ev}")
    (link,) = tomlio.load(paths["predict"])["predict"]["vol"]["chain"]
    labels = open_ds(vol["labels_dataset"])
    out = {"volume": list(labels.roi.shape / labels.voxel_size), "prepare_seconds": time.perf_counter() - t0}

    train = stage(stages, "train", lambda: run_training(paths["train_3d_mtlsd"], device=device))
    (pstats,) = stage(stages, "predict", lambda: run_prediction(paths["predict"], device=device)).values()
    if train["iterations"] != iterations:
        raise AssertionError(f"training: {train}")
    fcfg = tomlio.load(paths["filter"])["filter"]["vol"]

    def segment_evaluate_filter(suffix):
        """segment, evaluate by LSD errors and filter from the round's
        configs; the filter held against the host filter."""
        segs = stage(stages, f"segment{suffix}", lambda: run_segmentation(paths["segment"], device=device))["vol"]
        evaluation = stage(stages, f"evaluate{suffix}", lambda: run_evaluation(paths["evaluate"], device=device))["vol"]
        filtered = stage(stages, f"filter{suffix}", lambda: run_filter(paths["filter"]))["vol"]
        best, err_mask = get_best_seg_from_eval(os.path.join(container, "eval", "vol_results.json"))
        return best, {
            "segments_per_threshold": {
                t: int(len(np.unique(open_ds(p).to_ndarray())) - 1) for t, p in segs.items()
            },
            "error_ratio": {os.path.basename(p): e["pred_errors"]["nonzero_ratio"] for p, e in evaluation.items()},
            "best_segmentation": os.path.basename(best),
            **check_filter(filtered, best, err_mask, fcfg),
        }

    _, quality = segment_evaluate_filter("")
    heads = {}
    for name, out_cfg in net_config["outputs"].items():
        a = open_ds(os.path.join(container, link["output_prefix"], name))
        c = len(out_cfg["neighborhood"]) if "neighborhood" in out_cfg else out_cfg["dims"]
        if a.shape != (c, *out["volume"]) or a.dtype != np.uint8:
            raise AssertionError(f"head {name}: {a.shape} {a.dtype}")
        heads[name] = a
    out.update(
        heads_mean={k: float(a.to_ndarray().mean()) for k, a in heads.items()},
        final_loss=train["final_loss"], predict={k: pstats[k] for k in pstats if k != "plan"}, **quality,
    )
    lsds = heads["3d_lsds"]
    block_checks = {"gt_labels": check_lsd_block(labels, lsds, seed, device)}

    # the same stages on a perfect prediction of both heads (a net this
    # young segments little or nothing, and its LSD errors then score an
    # empty segmentation)
    write_gt_affinities(labels, heads["3d_affs"], net_config["outputs"]["3d_affs"]["neighborhood"], device)
    write_gt_lsds(labels, lsds, device)
    best, out["gt_heads"] = segment_evaluate_filter("_gt_heads")
    block_checks["gt_heads_best_segmentation"] = check_lsd_block(open_ds(best), lsds, seed, device)
    out["error_block_vs_cpu"] = block_checks
    out["sanity"] = lsd_sanity(labels, work, device)
    if device == "cuda":
        # the scan by parts on the GT labels, whose blocks hold tens of ids
        # (a young net's segmentation may hold none)
        out["errors_by_parts"] = errors_by_parts(
            lambda: compute_lsd_errors(labels, lsds, LSD_SIGMA, os.path.join(work, "timed_lsd_errors"), device=device),
            "block_lsd_error",
        )
        out["step"] = time_train_step(net_config, container, vol["voxel_size"], seed, timed_steps, device)
    out["stage_seconds"] = {k: v["seconds"] for k, v in stages.items()}
    out["launches"] = {k: v["launches"] for k, v in stages.items()}
    if device != "cuda":
        return out, []

    snapshot_every = tomlio.load(paths["train_3d_mtlsd"])["train"]["save_snapshots_every"] or 10**9
    check_train_launches("mtlsd train", stages["train"]["conv_launches"], net_config,
                         iterations + iterations // snapshot_every)
    step_tile = [pstats["step_z"], *pstats["input_tile"][1:]]
    cases = stream_conv_cases(net_config, step_tile, pstats["warm_step_z"])
    warm = [c for c in cases if c[0].startswith("warm_")]
    check_stream_launches("mtlsd predict", stages["predict"]["conv_launches"], warm,
                          [c for c in cases if c not in warm], pstats)
    seed_launches = [stages[k]["launches"]["seed_maxima.kernel"] for k in ("segment", "segment_gt_heads")]
    if min(seed_launches) < 1:
        raise AssertionError(f"mtlsd segment: the seed kernel did not run in each: {seed_launches}")
    out["seed_launches"] = sum(seed_launches)
    groups = [
        launch_group(stages["train"], train_conv_cases(net_config)),
        launch_group(stages["predict"], [(f"mtlsd_{c[0]}", *c[1:]) for c in cases]),
    ]
    return out, groups


def chain_phase(work: str, volumes: dict, seed: int, net_config: dict, iterations: int, device="cuda") -> tuple:
    """The chain ``3d_lsd -> 3d_affs_from_3d_lsd`` from the configs
    ``make_round_configs`` writes, on the Voronoi sample ``volumes`` names:
    train 3d_lsd, predict the chain (both links streamed, the refiner with
    its shipped checkpoint), segment.  Checks: the refiner's shipped
    checkpoint installed; its bf16 forward on the card against the CPU fp32
    forward on a crop of the 3d_lsd link's real outputs; K1 once per
    iteration at each training shape and on every step of both links; K2 in
    the segment.  Returns the phase's line and its K1 launch groups."""
    import torch

    from bootstrapper_torch import configs
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import Model, load_checkpoint, load_params
    from bootstrapper_torch.models.weights import latest_checkpoint
    from bootstrapper_torch.utils import tomlio
    from bootstrapper_torch.workflows import run_prediction, run_segmentation, run_training

    names = ["3d_lsd", "3d_affs_from_3d_lsd"]
    stages: dict = {}
    vol = volumes["vol"]
    container = vol["output_container"]
    chain_dir = os.path.join(work, "chain")
    paths = configs.make_round_configs(chain_dir, volumes, names, max_iterations=iterations)
    write_setup_config(os.path.join(chain_dir, "setups", "3d_lsd"), net_config)
    refiner_dir = os.path.join(chain_dir, "setups", names[1])
    shipped = latest_checkpoint(refiner_dir)
    if shipped is None or not shipped.endswith("model_checkpoint_20000"):
        raise AssertionError(f"the refiner's shipped checkpoint is not installed: {shipped}")
    links = tomlio.load(paths["predict"])["predict"]["vol"]["chain"]
    out = {"iterations": iterations, "refiner_checkpoint": os.path.basename(shipped)}

    train = stage(stages, "train", lambda: run_training(paths["train_3d_lsd"], device=device))
    stats = stage(stages, "predict", lambda: run_prediction(paths["predict"], device=device))
    segs = stage(stages, "segment", lambda: run_segmentation(paths["segment"], device=device))["vol"]
    if train["iterations"] != iterations:
        raise AssertionError(f"training: {train}")
    per_link = [stats[f"vol/{link['output_prefix']}"] for link in links]
    out["links"] = {
        name: {k: s[k] for k in s if k != "plan"} for name, s in zip(names, per_link)
    }
    out["voxels_per_sec"] = {name: s["voxels_per_sec"] for name, s in zip(names, per_link)}
    out["segments_per_threshold"] = {
        t: int(len(np.unique(open_ds(p).to_ndarray())) - 1) for t, p in segs.items()
    }
    lsds = open_ds(os.path.join(container, links[0]["output_prefix"], "3d_lsds"))
    affs = open_ds(os.path.join(container, links[1]["output_prefix"], "3d_affs"))
    if affs.shape != (9, *lsds.shape[1:]) or affs.dtype != np.uint8:
        raise AssertionError(f"the refiner's affinities: {affs.shape} {affs.dtype}")
    out["affs_mean"] = float(affs.to_ndarray().mean())

    # the refiner in bf16 on the card against fp32 on the CPU, on a crop of
    # the 3d_lsd link's outputs at the refiner's input shape
    nc = Model.from_setup(refiner_dir).net_config
    params = load_checkpoint(shipped)
    shape = nc["input_shape"]
    src = lsds.to_ndarray()
    begin = [(s - t) // 2 for s, t in zip(src.shape[1:], shape)]
    crop = src[(slice(None), *(slice(b, b + t) for b, t in zip(begin, shape)))]
    x = torch.from_numpy(np.moveaxis(crop, 0, -1)[None].astype(np.float32) / np.float32(255))
    with torch.no_grad():
        ref = load_params(Model(nc, compute_dtype=torch.float32), params).eval()(x)["3d_affs"]
        card = load_params(Model(nc, compute_dtype=torch.bfloat16), params).to(device, torch.bfloat16).eval()
        got = card(x.to(device))["3d_affs"].float().cpu()
    err = float((got - ref).abs().max())
    out["refiner_forward"] = {"input": list(shape), "bf16_max_abs_err": err, "atol": FWD_ATOL_BF16,
                              "input_mean": float(crop.mean()) / 255}
    if not err <= FWD_ATOL_BF16 or not torch.isfinite(got).all():
        raise AssertionError(f"refiner bf16 forward against CPU fp32: {out['refiner_forward']}")
    out["stage_seconds"] = {k: v["seconds"] for k, v in stages.items()}
    out["launches"] = {k: v["launches"] for k, v in stages.items()}
    if device != "cuda":
        return out, []

    snapshot_every = tomlio.load(paths["train_3d_lsd"])["train"]["save_snapshots_every"] or 10**9
    check_train_launches("chain train", stages["train"]["conv_launches"], net_config,
                         iterations + iterations // snapshot_every)
    # each link's kernel convs at its own plan; the two nets share none
    by_conv = dict(stages["predict"]["conv_launches"])
    cases, out["conv_launches_by_link"] = [], {}
    for name, link_nc, s in ((names[0], net_config, per_link[0]), (names[1], nc, per_link[1])):
        step_tile = [s["step_z"], *s["input_tile"][1:]]
        warm, steady = trace_stream_convs(link_nc, step_tile, s["warm_step_z"])
        keys = {conv_key(c) for c in warm + steady}
        link = {k: by_conv.pop(k) for k in keys if k in by_conv}
        check_stream_launches(f"chain predict {name}", link, warm, steady, s)
        out["conv_launches_by_link"][name] = sum(link.values())
        for phase, traced in (("warm", warm), ("steady", steady)):
            for i, c in enumerate(traced):
                ci, co, k = c[2][3], c[2][4], c[2][0]
                cases.append((f"chain_{name}_{phase}_{i}_{ci}to{co}_k{k}", *c))
    if by_conv or min(out["conv_launches_by_link"].values()) < 1:
        raise AssertionError(f"chain predict: conv kernel launches {stages['predict']['conv_launches']}")
    if stages["segment"]["launches"]["seed_maxima.kernel"] < 1:
        raise AssertionError("chain segment: the seed kernel did not run")
    out["seed_launches"] = stages["segment"]["launches"]["seed_maxima.kernel"]
    groups = [
        launch_group(stages["train"], train_conv_cases(net_config)),
        launch_group(stages["predict"], cases),
    ]
    return out, groups


def traced_cases(prefix: str, net_config: dict, x_shape, stack_infer: bool = False) -> list:
    """The kernel-route convs of one forward of ``net_config`` on an input
    of ``x_shape``, traced on the ``meta`` device, each named after its
    place in the forward, widths and kernel: ``(name, input shape, crop,
    weight shape, bias)``."""
    import torch

    from bootstrapper_torch.models import Model

    with torch.device("meta"):
        model = Model(net_config, stack_infer=stack_infer)
    x = torch.empty(tuple(x_shape), device="meta")
    with torch.no_grad():
        _, cases = trace_kernel_convs(lambda: model(x))
    return [(f"{prefix}_{i}_{c[2][3]}to{c[2][4]}_k{'x'.join(map(str, c[2][:3]))}", *c) for i, c in enumerate(cases)]


def write_gt_2d(labels, affs, lsds, net_config: dict, device) -> None:
    """Overwrite a 2D net's two heads (uint8, channels first) with what a
    perfect 2D net predicts from the GT ``labels``, its training targets:
    each section's affinities (the 2D neighbourhood at z offset 0, the
    boundaries grown as the head's ``grow_boundary`` says) and each
    section's 2D
    LSDs, on the downsampled grid the net's targets use, from the
    section's ids renumbered on the host (all of them: no label cap)."""
    import torch

    from bootstrapper_torch.core.geometry import Coordinate, Roi
    from bootstrapper_torch.ops.lsd import lsd_descriptors_downsampled
    from bootstrapper_torch.train.sampler import renumber

    outs = net_config["outputs"]
    nbhd = [[0, *o] for o in outs["2d_affs"]["neighborhood"]]
    write_gt_affinities(labels, affs, nbhd, device, grow=outs["2d_affs"].get("grow_boundary", 0))
    vs, roi = lsds.voxel_size, lsds.roi
    for z in range(roi.shape[0] // vs[0]):
        section = Roi(roi.begin + Coordinate((z * vs[0], 0, 0)), Coordinate((vs[0], *roi.shape[1:])))
        ids = renumber(labels.to_ndarray(section)[0])
        t = lsd_descriptors_downsampled(
            torch.from_numpy(ids.astype(np.int64)).to(device), outs["2d_lsds"]["sigma"], tuple(vs[1:]),
            outs["2d_lsds"]["downsample"], max_labels=int(ids.max()) + 1,
        )
        lsds[section] = torch.round(torch.clamp(t, 0, 1) * 255).to(torch.uint8)[:, None].cpu().numpy()


def forward_2d_check(net_config: dict, params, x, device) -> dict:
    """The 2D net's bf16 forward on the card (the kernel route, lifted to a
    unit z) against the CPU's fp32 one on the same sections, every head
    within FWD_ATOL_BF16."""
    import torch

    from bootstrapper_torch.models import Model, load_params

    x = x.float().cpu()
    with torch.no_grad():
        ref = load_params(Model(net_config, compute_dtype=torch.float32), params).eval()(x)
        card = load_params(Model(net_config), params).to(device).eval()
        got = {k: v.cpu() for k, v in card(x.to(device)).items()}
    errs = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
    out = {"input": list(x.shape), "bf16_max_abs_err": errs, "atol": FWD_ATOL_BF16}
    if max(errs.values()) > FWD_ATOL_BF16 or not all(bool(torch.isfinite(v).all()) for v in got.values()):
        raise AssertionError(f"2D bf16 forward against CPU fp32: {out}")
    return out


def chain2d_phase(work: str, volumes: dict, seed: int, net_config: dict, iterations: int, timed_steps: int,
                  device="cuda") -> tuple:
    """The reference's flagship round, ``2d_mtlsd -> 3d_affs_from_2d_mtlsd``,
    from the configs ``make_round_configs`` writes with the sample's labels
    as GT, on the Voronoi sample ``volumes`` names: the 2D net's bf16
    forward against CPU fp32 and its bf16 gradients at batch 10 against
    fp32 on a real batch; then train 2d_mtlsd (batch 10), predict the chain
    (the 2D link tiled, 32 sections a batch; the shipped refiner
    streamed), segment (ws), evaluate (VOI), filter; then the GT's own 2D
    affinities and LSDs written over the 2D link's outputs, the refiner
    link alone again, segment, evaluate and filter (``gt_2d``: that
    segmentation may not be empty); the steady train step; the 2D link's
    Mvox/s at BATCH_TILES_SWEEP.  Launch counts as in ``chain_phase``: K1
    once per iteration at each training shape, once per batch of sections
    at each 2D predict shape, on every refiner step; K2 in each segment.
    Returns the phase's line and its K1 launch groups."""
    import torch

    from bootstrapper_torch import configs
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import Model, init_params_numpy, load_checkpoint, load_params
    from bootstrapper_torch.models.weights import latest_checkpoint
    from bootstrapper_torch.pipeline.training import TrainingPipeline
    from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs, shrink_shape_increase
    from bootstrapper_torch.train.sampler import Sample
    from bootstrapper_torch.utils import tomlio
    from bootstrapper_torch.workflows import (
        run_evaluation, run_filter, run_prediction, run_segmentation, run_training,
    )
    from bootstrapper_torch.workflows.filter import get_best_seg_from_eval

    names = ["2d_mtlsd", "3d_affs_from_2d_mtlsd"]
    stages: dict = {}
    vol = volumes["vol"]
    container, vs = vol["output_container"], tuple(vol["voxel_size"])
    chain_dir = os.path.join(work, "chain2d")
    paths = configs.make_round_configs(
        chain_dir, volumes, names, max_iterations=iterations, gt_labels=vol["labels_dataset"]
    )
    write_setup_config(os.path.join(chain_dir, "setups", names[0]), net_config)
    refiner_dir = os.path.join(chain_dir, "setups", names[1])
    shipped = latest_checkpoint(refiner_dir)
    if shipped is None or not shipped.endswith("model_checkpoint_20000"):
        raise AssertionError(f"the refiner's shipped checkpoint is not installed: {shipped}")
    links = tomlio.load(paths["predict"])["predict"]["vol"]["chain"]
    fcfg = tomlio.load(paths["filter"])["filter"]["vol"]
    out = {"iterations": iterations, "refiner_checkpoint": os.path.basename(shipped)}

    # the 2D net on a real batch of 10: bf16 forward, bf16 gradients
    sample = Sample(*(open_ds(vol[k]) for k in ("raw_dataset", "labels_dataset", "labels_mask_dataset")))
    pipe = TrainingPipeline(net_config, vs, [sample], seed=seed, device=device, num_threads=1)
    try:
        batch = pipe.next_batch()
    finally:
        pipe.stop()
    params = init_params_numpy(net_config, seed)
    out["batch"] = pipe.batch_size
    out["forward"] = forward_2d_check(net_config, params, batch["input"][:2], device)
    out["gradients"] = whole_net_gradients(net_config, params, batch, device)
    del batch

    train = stage(stages, "train", lambda: run_training(paths[f"train_{names[0]}"], device=device))
    stats = stage(stages, "predict", lambda: run_prediction(paths["predict"], device=device))
    if train["iterations"] != iterations:
        raise AssertionError(f"training: {train}")
    per_link = [stats[f"vol/{link['output_prefix']}"] for link in links]
    heads = {k: open_ds(os.path.join(container, links[0]["output_prefix"], k)) for k in net_config["outputs"]}
    affs = open_ds(os.path.join(container, links[1]["output_prefix"], "3d_affs"))
    shape = tuple(affs.roi.shape / vs)
    if affs.shape != (9, *shape) or any(h.shape != (6, *shape) or h.dtype != np.uint8 for h in heads.values()):
        raise AssertionError(f"chain outputs: {affs.shape}, {[h.shape for h in heads.values()]}")

    def segment_evaluate_filter(suffix):
        """segment, evaluate by VOI and filter from the chain's configs; the
        filter held against the host filter."""
        segs = stage(stages, f"segment{suffix}", lambda: run_segmentation(paths["segment"], device=device))["vol"]
        voi = stage(stages, f"evaluate{suffix}", lambda: run_evaluation(paths["evaluate"], device=device))["vol"]
        filtered = stage(stages, f"filter{suffix}", lambda: run_filter(paths["filter"]))["vol"]
        best, err_mask = get_best_seg_from_eval(os.path.join(container, "eval", "vol_results.json"))
        return {
            "segments_per_threshold": {t: int(len(np.unique(open_ds(p).to_ndarray())) - 1) for t, p in segs.items()},
            "best_segmentation": os.path.basename(best),
            "voi": {os.path.basename(p): e["voi"] for p, e in voi.items()},
            **check_filter(filtered, best, err_mask, fcfg),
        }

    out.update(
        final_loss=train["final_loss"],
        links={name: {k: s[k] for k in s if k != "plan"} for name, s in zip(names, per_link)},
        voxels_per_sec={name: s["voxels_per_sec"] for name, s in zip(names, per_link)},
        heads_mean={k: float(h.to_ndarray().mean()) for k, h in heads.items()},
        affs_mean=float(affs.to_ndarray().mean()),
        **segment_evaluate_filter(""),
    )
    # the refiner on real 2D inputs: the GT's own 2D heads (a net this
    # young sits on the loss floor), the refiner link alone again
    labels = open_ds(vol["labels_dataset"])
    t0 = time.perf_counter()
    write_gt_2d(labels, heads["2d_affs"], heads["2d_lsds"], net_config, device)
    out["write_gt_2d_seconds"] = time.perf_counter() - t0
    gt_stats = stage(stages, "predict_gt_2d", lambda: run_prediction(paths["predict"], setup_id=names[1], device=device))
    out["gt_2d"] = {
        "refiner": {k: v for k, v in gt_stats[f"vol/{links[1]['output_prefix']}"].items() if k != "plan"},
        "affs_mean": float(affs.to_ndarray().mean()),
        **segment_evaluate_filter("_gt_2d"),
    }
    if max(out["gt_2d"]["segments_per_threshold"].values()) < 1:
        raise AssertionError(f"the refiner segmented nothing from the GT's own 2D heads: {out['gt_2d']}")

    # the 2D link's throughput by batch of sections
    raw = open_ds(vol["raw_dataset"])
    model = load_params(Model(net_config), load_checkpoint(train["checkpoint"]))
    fitted = shrink_shape_increase(model, shape)
    sweep_stages: dict = {}
    out["batch_tiles_sweep"] = {}
    for b in BATCH_TILES_SWEEP:
        pred = Predictor(model, vs, shape_increase=fitted, batch_tiles=b, device=device)
        outputs = prepare_prediction_outputs(
            os.path.join(work, "sweep.zarr"), model, raw.roi, vs, pred, dataset_prefix=f"b{b}/"
        )
        s = stage(sweep_stages, f"batch_{b}", lambda: pred.predict(raw, outputs))
        out["batch_tiles_sweep"][b] = {"voxels_per_sec": s["voxels_per_sec"], "seconds": s["seconds"], "tiles": s["tiles"]}
    del model
    if device == "cuda":
        out["step"] = time_train_step(net_config, container, vs, seed, timed_steps, device)
    out["stage_seconds"] = {k: v["seconds"] for k, v in stages.items()}
    out["launches"] = {k: v["launches"] for k, v in stages.items()}
    if device != "cuda":
        return out, []

    snapshot_every = tomlio.load(paths[f"train_{names[0]}"])["train"]["save_snapshots_every"] or 10**9
    train_cases = traced_cases("chain2d_train", net_config, (pipe.batch_size, *pipe.spec.input_tile, 1))
    check_launches("chain2d train", stages["train"]["conv_launches"],
                   [(train_cases, iterations + iterations // snapshot_every)])
    # the 2D link: once per batch of sections; the refiner: on every step
    by_conv = dict(stages["predict"]["conv_launches"])
    batches = -(-per_link[0]["tiles"] // 32)
    predict_cases = traced_cases("chain2d_predict_b32", net_config, (32, *tile_2d(net_config, fitted), 1), True)
    link = {k: by_conv.pop(k) for k in {conv_key(c) for c in predict_cases} if k in by_conv}
    check_launches("chain2d predict 2d_mtlsd", link, [(predict_cases, batches)])
    refiner_nc = Model.from_setup(refiner_dir).net_config
    s = per_link[1]
    warm, steady = trace_stream_convs(refiner_nc, [s["step_z"], *s["input_tile"][1:]], s["warm_step_z"])
    check_stream_launches("chain2d predict refiner", by_conv, warm, steady, s)
    check_stream_launches("chain2d predict_gt_2d", stages["predict_gt_2d"]["conv_launches"], warm, steady,
                          gt_stats[f"vol/{links[1]['output_prefix']}"])
    refiner_cases = [
        (f"chain2d_refiner_{phase}_{i}_{c[2][3]}to{c[2][4]}_k{c[2][0]}", *c)
        for phase, traced in (("warm", warm), ("steady", steady)) for i, c in enumerate(traced)
    ]
    seed_launches = [stages[k]["launches"]["seed_maxima.kernel"] for k in ("segment", "segment_gt_2d")]
    if min(seed_launches) < 1:
        raise AssertionError(f"chain2d segment: the seed kernel did not run in each: {seed_launches}")
    out["seed_launches"] = sum(seed_launches)
    groups = [
        launch_group(stages["train"], train_cases),
        launch_group(stages["predict"], predict_cases + refiner_cases),
        launch_group(stages["predict_gt_2d"], refiner_cases),
    ]
    for b in BATCH_TILES_SWEEP:
        cases = predict_cases if b == 32 else traced_cases(
            f"chain2d_predict_b{b}", net_config, (b, *tile_2d(net_config, fitted), 1), True
        )
        n = -(-out["batch_tiles_sweep"][b]["tiles"] // b)
        check_launches(f"chain2d batch_tiles {b}", sweep_stages[f"batch_{b}"]["conv_launches"], [(cases, n)])
        groups.append(launch_group(sweep_stages[f"batch_{b}"], cases))
    return out, groups


def tile_2d(net_config: dict, inc) -> tuple:
    """A 2D setup's predictor input tile at ``shape_increase`` ``inc``:
    ``(adj_slices, H, W)``."""
    return (net_config.get("adj_slices", 1), *(a + b for a, b in zip(net_config["input_shape"], inc)))


# -- (s) the synthetic refiners ---------------------------------------------


def synth_forward_losses(setup_dir: str, batches: int, seed: int, stages: dict, name: str, device) -> tuple:
    """The checkpoint in ``setup_dir`` (a refiner's shipped one) in bf16,
    forward only, over ``batches`` batches of the port's
    ``SyntheticTrainingPipeline`` at the voxel size of the setup's
    ``train.toml``: the loss per batch, their mean, median and max, and the
    shipped training log's last 100 entries beside them.  Returns the line
    and the forward's kernel-route convs (traced on ``meta``)."""
    import torch

    from bootstrapper_torch.models import Model, load_checkpoint, load_params
    from bootstrapper_torch.models.weights import latest_checkpoint
    from bootstrapper_torch.pipeline.synthetic import SyntheticTrainingPipeline, input_channels
    from bootstrapper_torch.train.loop import loss_fn
    from bootstrapper_torch.utils import tomlio

    nc = Model.from_setup(setup_dir).net_config
    ckpt = latest_checkpoint(setup_dir)
    vs = tomlio.load(os.path.join(setup_dir, "train.toml"))["train"]["voxel_size"]
    model = load_params(Model(nc), load_checkpoint(ckpt)).to(device).eval()
    pipe = SyntheticTrainingPipeline(nc, vs, seed=seed, device=device)

    def run():
        with torch.no_grad():
            return [loss_fn(model, pipe.next_batch()) for _ in range(batches)]

    try:
        losses = [float(v) for v in stage(stages, name, run)]
    finally:
        pipe.stop()
    out = {
        "checkpoint": os.path.basename(ckpt), "voxel_size": vs, "batches": batches, "seed": seed,
        "mean": float(np.mean(losses)), "median": float(np.median(losses)), "max": float(np.max(losses)),
        "losses": losses, "seconds": stages[name]["seconds"],
    }
    log = os.path.join(setup_dir, "log", "loss.jsonl")
    if os.path.exists(log):
        shipped = [json.loads(line)["loss"] for line in open(log)][-100:]
        out["shipped_log_last_100"] = {
            "mean": float(np.mean(shipped)), "median": float(np.median(shipped)), "max": float(np.max(shipped)),
        }
    cases = traced_cases(f"synth_{os.path.basename(setup_dir)}", nc, (1, *nc["input_shape"], input_channels(nc)))
    return out, cases


def synth_phase(work: str, volumes: dict, seed: int, shipped: dict, iterations: int, timed_steps: int,
                device="cuda") -> tuple:
    """The refiners' synthetic training on the card, and the retrained
    refiner through predict, segment (mws, its bias sweep, cc, ws) and
    evaluate.  ``shipped`` maps each refiner of SYNTH_FORWARD to its shipped
    setup dir.  (a) Each shipped checkpoint's bf16 loss, forward only, over
    the port's synthetic batches, held to SYNTH_FORWARD's gates; (b)
    ``run_training`` on a copy of 3d_affs_from_2d_mtlsd's ``train.toml``
    resumes from the shipped checkpoint and trains ``iterations`` more at
    batch 1 (the loss of each iteration recorded; the mean of the last 20
    held to SYNTH_LAST20_MEAN); (c) the steady step by parts and the host
    draw of one synthetic pair; (d) on the Voronoi sample of ``volumes``,
    the GT's own 2D heads written as the 2D link's outputs, the refiner link
    predicted with the retrained checkpoint, then ``run_segmentation`` in
    mws (defaults, and a SYNTH_BIAS_SWEEP), cc and ws from the configs
    ``make_round_configs`` writes for each method, and ``run_evaluation`` by
    VOI: each mode's seconds, segments and VOI; every mws and cc
    segmentation must be non-empty.  Launch counts: K1 at each training
    convs once per iteration (and per forward-only batch), on every
    prediction step; K2 in the ws segment.  Returns the phase's line and
    its K1 launch groups."""
    import shutil

    from bootstrapper_torch import configs
    from bootstrapper_torch.core.arrays import open_ds, prepare_ds
    from bootstrapper_torch.models import Model
    from bootstrapper_torch.models.weights import latest_checkpoint
    from bootstrapper_torch.models.zoo import get_net_config
    from bootstrapper_torch.pipeline.synthetic import SyntheticTrainingPipeline, input_channels
    from bootstrapper_torch.train.synth import synthetic_pair
    from bootstrapper_torch.utils import tomlio
    from bootstrapper_torch.workflows import run_evaluation, run_prediction, run_segmentation, run_training
    from bootstrapper_torch.workflows import train as train_workflow

    stages: dict = {}
    out: dict = {"forward_only": {}}
    groups = []
    # (a) the shipped weights on the port's synthetic inputs
    for i, (name, batches, gates) in enumerate(SYNTH_FORWARD):
        line, cases = synth_forward_losses(shipped[name], batches, seed + 2 * i, stages, f"forward_{name}", device)
        line["gates"], line["jax_cpu"] = gates, SYNTH_JAX_CPU[name]
        out["forward_only"][name] = line
        if any(line[k] > v for k, v in gates.items()):
            raise AssertionError(f"{name}: the shipped weights' loss on the port's synthetic batches: {line}")
        groups.append(launch_group(stages[f"forward_{name}"], cases))

    # the round's configs, one per segmentation method: the 2D link's
    # outputs named as iteration 0 (the GT's own heads go there), the
    # refiner's as the iteration its training ends at
    name, vol = "3d_affs_from_2d_mtlsd", volumes["vol"]
    start = int(os.path.basename(latest_checkpoint(shipped[name])).rsplit("_", 1)[1])
    names, its = ["2d_mtlsd", name], [0, start + iterations]
    rounds = {
        m: configs.make_round_configs(
            os.path.join(work, f"synth_{m}"), volumes, names, iterations=its, segment_method=m,
            gt_labels=vol["labels_dataset"],
        )
        for m in ("mws", "cc", "ws")
    }
    paths = rounds["mws"]
    # the shipped setup over the one the round installed
    refiner_dir = os.path.join(work, "synth_mws", "setups", name)
    for f in ("net_config.json", "train.toml", os.path.basename(latest_checkpoint(shipped[name]))):
        shutil.copy2(os.path.join(shipped[name], f), os.path.join(refiner_dir, f))
    nc = Model.from_setup(refiner_dir).net_config

    # (b) resumed synthetic training through the entry point
    cfg = tomlio.load(os.path.join(refiner_dir, "train.toml"))["train"]
    cfg.update(setup_dir=refiner_dir, max_iterations=start + iterations)
    toml = os.path.join(work, "synth_train.toml")
    tomlio.dump({"train": cfg}, toml)
    real_step, losses = train_workflow.make_train_step, []

    def recording_step():  # the loss of every iteration, read after the run
        step = real_step()

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            return state, metrics

        return run

    train_workflow.make_train_step = recording_step
    try:
        train = stage(stages, "train", lambda: run_training(toml, device=device))
    finally:
        train_workflow.make_train_step = real_step
    losses = [float(v) for v in losses]
    log = [json.loads(line) for line in open(os.path.join(refiner_dir, "log", "loss.jsonl"))]
    if train["iterations"] != start + iterations or len(losses) != iterations:
        raise AssertionError(f"synthetic training did not resume at {start}: {train}, {len(losses)} steps")
    if not train["checkpoint"].endswith(f"model_checkpoint_{start + iterations}"):
        raise AssertionError(f"synthetic training's checkpoint: {train['checkpoint']}")
    last20 = float(np.mean(losses[-20:]))
    out["train"] = {
        "resumed_at": start, "iterations": iterations, "batch": 1, "voxel_size": cfg["voxel_size"],
        "losses": losses, "log": log, "first_10_mean": float(np.mean(losses[:10])),
        "last_20_mean": last20, "gate": SYNTH_LAST20_MEAN, "seconds": stages["train"]["seconds"],
        "checkpoint": os.path.basename(train["checkpoint"]),
    }
    if not last20 <= SYNTH_LAST20_MEAN:
        raise AssertionError(f"resumed synthetic training: last 20 iterations' mean loss {last20}: {out['train']}")
    train_cases = traced_cases("synth_train", nc, (1, *nc["input_shape"], input_channels(nc)))
    groups.append(launch_group(stages["train"], train_cases))

    # (c) the steady step, and the host's draw of one pair
    t0 = time.perf_counter()
    for i in range(4):
        synthetic_pair(np.random.default_rng(seed + i), shape=tuple(nc["input_shape"]))
    out["host_draw_ms_per_sample"] = (time.perf_counter() - t0) * 1e3 / 4
    if device == "cuda":
        pipe = SyntheticTrainingPipeline(nc, cfg["voxel_size"], seed=seed, device=device)
        out["step"] = time_train_step(nc, None, None, seed, timed_steps, device, pipe=pipe)

    # (d) predict with the retrained refiner on the GT's own 2D heads
    labels = open_ds(vol["labels_dataset"])
    links = tomlio.load(paths["predict"])["predict"]["vol"]["chain"]
    nc2d = get_net_config("2d_mtlsd")
    heads = {}
    for head, head_cfg in nc2d["outputs"].items():
        c = len(head_cfg["neighborhood"]) if "neighborhood" in head_cfg else head_cfg["dims"]
        heads[head] = prepare_ds(
            os.path.join(vol["output_container"], links[0]["output_prefix"], head), (c, *labels.shape),
            labels.roi.offset, labels.voxel_size, np.uint8,
        )
    t0 = time.perf_counter()
    write_gt_2d(labels, heads["2d_affs"], heads["2d_lsds"], nc2d, device)
    out["write_gt_2d_seconds"] = time.perf_counter() - t0
    stats = stage(stages, "predict", lambda: run_prediction(paths["predict"], setup_id=name, device=device))
    pstats = stats[f"vol/{links[1]['output_prefix']}"]
    affs = open_ds(os.path.join(vol["output_container"], links[1]["output_prefix"], "3d_affs"))
    out["predict"] = {k: v for k, v in pstats.items() if k != "plan"}
    out["affs_mean"] = float(affs.to_ndarray().mean())
    out["affs_dataset"] = affs.path

    # segment by each method from its round's configs, and score by VOI
    segment_runs = [
        ("mws", "mws", ()), ("mws_sweep", "mws", (f"bias_sweep={SYNTH_BIAS_SWEEP}",)), ("cc", "cc", ()),
        ("ws", "ws", ()),
    ]
    out["segment"] = {}
    for key, method, overrides in segment_runs:
        segs = stage(stages, f"segment_{key}", lambda: run_segmentation(
            rounds[method]["segment"], mode=method, param_overrides=overrides, device=device))["vol"]
        out["segment"][key] = {
            "seconds": stages[f"segment_{key}"]["seconds"],
            "segments": {os.path.basename(p): int(len(np.unique(open_ds(p).to_ndarray())) - 1) for p in segs.values()},
        }
    for method in ("mws", "cc", "ws"):
        voi = stage(stages, f"evaluate_{method}", lambda: run_evaluation(rounds[method]["evaluate"], device=device))
        out["segment"][method]["evaluate_seconds"] = stages[f"evaluate_{method}"]["seconds"]
        out["segment"][method]["voi"] = {os.path.basename(p): e["voi"] for p, e in voi["vol"].items()}
    out["segment"]["mws_sweep"]["voi"] = {
        k: v for k, v in out["segment"]["mws"]["voi"].items() if k in out["segment"]["mws_sweep"]["segments"]
    }
    empty = [
        (k, d) for k in ("mws", "mws_sweep", "cc") for d, n in out["segment"][k]["segments"].items() if n < 1
    ]
    if empty or len(out["segment"]["mws_sweep"]["segments"]) != len(SYNTH_BIAS_SWEEP):
        raise AssertionError(f"synth: empty or missing mws/cc segmentations {empty}: {out['segment']}")
    out["stage_seconds"] = {k: v["seconds"] for k, v in stages.items()}
    out["launches"] = {k: v["launches"] for k, v in stages.items()}
    if device != "cuda":
        return out, []

    # every K1 launch where it belongs: the forward-only batches and the
    # training at the training shapes, the prediction on every step
    for (refiner, batches, _), group in zip(SYNTH_FORWARD, groups):
        check_launches(f"synth forward {refiner}", group["by_conv"], [(group["cases"], batches)])
    check_launches("synth train", stages["train"]["conv_launches"], [(train_cases, iterations)])
    out["train"]["conv_launches"] = sum(stages["train"]["conv_launches"].values())
    warm, steady = trace_stream_convs(nc, [pstats["step_z"], *pstats["input_tile"][1:]], pstats["warm_step_z"])
    check_stream_launches("synth predict", stages["predict"]["conv_launches"], warm, steady, pstats)
    predict_cases = [
        (f"synth_refiner_{phase}_{i}_{c[2][3]}to{c[2][4]}_k{c[2][0]}", *c)
        for phase, traced in (("warm", warm), ("steady", steady)) for i, c in enumerate(traced)
    ]
    groups.append(launch_group(stages["predict"], predict_cases))
    out["seed_launches"] = stages["segment_ws"]["launches"]["seed_maxima.kernel"]
    if out["seed_launches"] < 1 or any(
        stages[f"segment_{k}"]["launches"]["seed_maxima.kernel"] for k in ("mws", "mws_sweep", "cc")
    ):
        raise AssertionError(f"synth segment: the seed kernel ran in {out['launches']}")
    # Conv3dFunction in fp32 at the widest refiner conv of the training,
    # without a fused ReLU: among its 470k outputs one lies within the
    # kernel's fp32 rounding of 0 now and then, and the ReLU mask then
    # moves dX, dW and db by that voxel's gradient (1e-2 of their largest)
    widest = max(train_cases, key=lambda c: c[3][3] * c[3][4] * np.prod(c[3][:3]))
    out["function_fp32"] = check_conv_function(seed, device, [(widest[0], *widest[1:4], False)])
    return out, groups


# -- the blockwise phase ---------------------------------------------------

WS_STAGES = {
    "fragments": "extract_fragments_blockwise", "agglomerate": "agglomerate_blockwise",
    "luts": "find_segments", "extract": "extract_segmentation_blockwise",
}
MWS_STAGES = {
    "fragments": "extract_fragments_blockwise", "agglomerate": "mws_agglomerate_blockwise",
    "luts": "global_mutex_segments", "extract": "extract_segmentation_blockwise",
}


@contextlib.contextmanager
def timed_stages(module, stages: dict, log: dict):
    """Within the block, each function of ``module`` named by ``stages``
    (``{stage: function name}``; the pipelines look them up in the module)
    adds its seconds to ``log[stage]``."""
    real = {k: getattr(module, name) for k, name in stages.items()}

    def timed(stage_name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                log[stage_name] = log.get(stage_name, 0.0) + time.perf_counter() - t0

        return run

    for k, fn in real.items():
        setattr(module, stages[k], timed(k, fn))
    try:
        yield log
    finally:
        for k, fn in real.items():
            setattr(module, stages[k], fn)


@contextlib.contextmanager
def recorded_seed_calls(calls: list):
    """Within the block, every ``post/fragments.py:device_seed_maxima``
    call appends ``(stack shape, wall ms)`` to ``calls``, from whichever
    thread."""
    from bootstrapper_torch.post import fragments

    real = fragments.device_seed_maxima

    def run(dist_stack, mask_stack, size, device):
        t0 = time.perf_counter()
        out = real(dist_stack, mask_stack, size, device)
        calls.append((tuple(dist_stack.shape), (time.perf_counter() - t0) * 1e3))
        return out

    fragments.device_seed_maxima = run
    try:
        yield calls
    finally:
        fragments.device_seed_maxima = real


def rss_gib() -> float:
    """The process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


@contextlib.contextmanager
def sampled_peak_rss(out: dict, every: float = 0.05):
    """Within the block, a thread samples ``rss_gib`` every ``every`` s;
    after it, ``out["peak_rss_gib"]`` holds the largest sample and
    ``out["max_rss_gib_process"]`` the process's peak since it started
    (``getrusage``)."""
    import resource
    import threading

    samples = [rss_gib()]
    stop = threading.Event()

    def sample():
        while not stop.wait(every):
            samples.append(rss_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        samples.append(rss_gib())
        out["peak_rss_gib"] = max(samples)
        out["max_rss_gib_process"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def seed_device_ms(prof) -> dict:
    """The seed kernel's and the copies' device ms in a profile."""
    import torch

    out = {"kernel": 0.0, "kernel_launches": 0, "copies": 0.0, "other": 0.0}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.is_user_annotation:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        if "seed_" in ev.name and "kernel" in ev.name:
            out["kernel"] += ms
            out["kernel_launches"] += 1
        elif "memcpy" in ev.name.lower():
            out["copies"] += ms
        else:
            out["other"] += ms
    return out


def write_blockwise_volume(path: str, shape, seed: int, device) -> np.ndarray:
    """A Voronoi label volume of ``shape`` (``voronoi_sample`` on the card)
    and its 3 direct affinities, their boundaries grown by one voxel in xy
    (as the nets' targets) and seeded noise added, written to ``path`` as
    uint8 (``round(clip(a) * 255)``, as ``predict`` writes them).  Returns
    the labels."""
    import torch

    from bootstrapper_torch.core.arrays import prepare_ds
    from bootstrapper_torch.ops.affinities import grow_boundary, seg_to_affs

    labels = voronoi_sample(shape, max(8, int(np.prod(shape) // 40_000)), seed, device)["labels"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    grown = grow_boundary(torch.from_numpy(labels.view(np.int64)).to(device), steps=1, only_xy=True)
    affs = seg_to_affs(grown, [[-1, 0, 0], [0, -1, 0], [0, 0, -1]])
    del grown
    affs += BLOCKWISE_NOISE * torch.randn(affs.shape, generator=gen, device=device)
    affs = (affs.clamp_(0, 1) * 255).round_().to(torch.uint8).cpu().numpy()
    ds = prepare_ds(path, affs.shape, (0, 0, 0), (40, 4, 4), np.uint8)
    ds[ds.roi] = affs
    return labels


def segment_toml(path: str, affs_path: str, container: str, mode: str, **cfg) -> str:
    """A one-volume segment config whose outputs go to ``container``."""
    from bootstrapper_torch.utils import tomlio

    tomlio.dump(
        {"segment": {"vol": {
            "affs_dataset": affs_path, "seg_dataset_prefix": os.path.join(container, f"segmentations_{mode}"),
            "blockwise": True, **cfg,
        }}},
        path,
    )
    return path


def blockwise_full_scale(work: str, shape, seed: int, device) -> dict:
    """(1) ws through ``run_segmentation(blockwise=True)`` on a Voronoi
    volume of ``shape``: the default block and context, BLOCKWISE_NUM_WORKERS
    threads, BLOCKWISE_THRESHOLDS.  Seconds by stage, K2's launches (one per
    block), its device time and the copies' from ``torch.profiler`` (device
    events only), the wall time of each ``device_seed_maxima`` call, RAG
    size, VOI against the labels and the peak host RSS."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.eval.voi import rand_voi
    from bootstrapper_torch.post import blockwise_seg
    from bootstrapper_torch.post.rag import RagDB
    from bootstrapper_torch.workflows import run_segmentation

    out: dict = {"volume": list(shape), "block": list(BLOCKWISE_BLOCK), "num_workers": BLOCKWISE_NUM_WORKERS}
    t0 = time.perf_counter()
    affs_path = os.path.join(work, "full.zarr", "affs")
    labels = write_blockwise_volume(affs_path, shape, seed, device)
    out["write_volume_seconds"] = time.perf_counter() - t0
    container = os.path.join(work, "full.zarr", "post")
    toml = segment_toml(
        os.path.join(work, "full_segment.toml"), affs_path, container, "ws",
        ws_params={"thresholds": BLOCKWISE_THRESHOLDS},
    )
    stages: dict = {}
    by_stage: dict = {}
    calls: list = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(sampled_peak_rss(out))
        stack.enter_context(timed_stages(blockwise_seg, WS_STAGES, by_stage))
        stack.enter_context(recorded_seed_calls(calls))
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA])) if device == "cuda" else None
        segs = stage(stages, "ws", lambda: run_segmentation(
            toml, mode="ws", blockwise=True, num_workers=BLOCKWISE_NUM_WORKERS, device=device))["vol"]
        if device == "cuda":
            torch.cuda.synchronize()
    out["seconds"] = stages["ws"]["seconds"]
    out["stage_seconds"] = by_stage
    grid = [-(-n // b) for n, b in zip(shape, BLOCKWISE_BLOCK)]
    out["blocks"] = int(np.prod(grid))
    out["seed_launches"] = stages["ws"]["launches"]["seed_maxima.kernel"]
    wall = np.array([ms for _, ms in calls])
    out["seed_calls"] = {
        "calls": len(calls),
        "stacks": {"x".join(map(str, k)): sum(1 for c in calls if c[0] == k) for k in sorted({c[0] for c in calls})},
        "wall_ms_sum": float(wall.sum()), "wall_ms_mean": float(wall.mean()), "wall_ms_max": float(wall.max()),
    }
    if prof is not None:
        dev = seed_device_ms(prof)
        out["seed_calls"].update(
            kernel_device_ms_sum=dev["kernel"], kernel_events=dev["kernel_launches"],
            copies_device_ms_sum=dev["copies"], other_device_ms_sum=dev["other"],
            # the call's wall time around its kernel: copies, conversions,
            # and waits behind the other threads' work on the stream
            host_ms_around_kernel_sum=float(wall.sum()) - dev["kernel"],
            kernel_share_of_fragments=dev["kernel"] / 1e3 / by_stage["fragments"],
        )
    rag = RagDB(os.path.join(container, "rag_ws.db"), mode="r")
    out["rag_nodes"], out["rag_edges"] = rag.counts()
    out["voi"] = {}
    t0 = time.perf_counter()
    for t, path in segs.items():
        seg = open_ds(path).to_ndarray()
        scores = rand_voi(labels, seg)
        out["voi"][t] = {
            "voi_split": scores["voi_split"], "voi_merge": scores["voi_merge"],
            "voi_sum": scores["voi_split"] + scores["voi_merge"], "segments": int(len(np.unique(seg)) - 1),
        }
        del seg
    out["voi_seconds"] = time.perf_counter() - t0
    if len(calls) != out["blocks"] or (device == "cuda" and out["seed_launches"] != out["blocks"]):
        raise AssertionError(
            f"blockwise ws: {out['blocks']} blocks, {len(calls)} seed calls, {out['seed_launches']} K2 launches"
        )
    if any(v["segments"] < 1 for v in out["voi"].values()):
        raise AssertionError(f"blockwise ws segmented nothing: {out['voi']}")
    return out


def same_partition(a: np.ndarray, b: np.ndarray) -> dict:
    """Whether ``a`` and ``b`` hold the same background and the same
    partition of the rest: a one-to-one map between their ids."""
    background = int(((a == 0) != (b == 0)).sum())
    ids_a, dense_a = np.unique(a, return_inverse=True)
    ids_b, dense_b = np.unique(b, return_inverse=True)
    pairs = len(np.unique(dense_a.astype(np.int64) * len(ids_b) + dense_b))
    return {
        "equal": background == 0 and pairs == len(ids_a) == len(ids_b),
        "background_differs": background, "ids": [len(ids_a), len(ids_b)], "pairs": pairs,
    }


def blockwise_against_in_memory(work: str, affs_path: str, labels_path: str, in_memory_voi: dict, device) -> dict:
    """(2) The blockwise pipelines on the ``synth`` phase's 9-channel
    affinities (its (64,512,512) volume, 8 blocks of BLOCKWISE_BLOCK): mws
    on its first BLOCKWISE_MWS_SECTIONS sections with the defaults and
    ``global_bias_sweep = SYNTH_BIAS_SWEEP`` (one RAG for both points), its
    VOI beside the in-memory mws's on the whole volume; cc at 0.5, whose
    partition and background must equal in-memory ``cc_segmentation``'s;
    ws sharded over 2 worker processes with a ledger, whose fragments and
    partitions must equal one process's."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.eval.metrics import compute_metrics
    from bootstrapper_torch.post import blockwise_seg
    from bootstrapper_torch.post.segment import METHOD_DEFAULTS, cc_segmentation
    from bootstrapper_torch.workflows import run_segmentation

    stages: dict = {}
    out: dict = {}
    labels = open_ds(labels_path)
    kw = dict(blockwise=True, block_shape=BLOCKWISE_BLOCK, num_workers=BLOCKWISE_NUM_WORKERS, device=device)

    def run(name, mode, overrides=(), roi=(None, None), **cfg):
        container = os.path.join(work, f"{name}.zarr")
        toml = segment_toml(os.path.join(work, f"{name}_segment.toml"), affs_path, container, mode, **cfg)
        return stage(stages, name, lambda: run_segmentation(
            toml, mode=mode, param_overrides=overrides, roi_offset=roi[0], roi_shape=roi[1], **kw))["vol"]

    affs_roi = open_ds(affs_path).roi
    vz = open_ds(affs_path).voxel_size[0]
    mws_roi = (list(affs_roi.begin), [BLOCKWISE_MWS_SECTIONS * vz, *affs_roi.shape[1:]])
    mws_stages: dict = {}
    with timed_stages(blockwise_seg, MWS_STAGES, mws_stages):
        mws = run("mws", "mws", (f"global_bias_sweep={SYNTH_BIAS_SWEEP}",), roi=mws_roi)
    out["mws"] = {
        "sections": BLOCKWISE_MWS_SECTIONS, "seconds": stages["mws"]["seconds"], "stage_seconds": mws_stages,
        "voi": {k: compute_metrics(open_ds(p), gt_labels=labels)["voi"] for k, p in mws.items()},
        "in_memory_voi": {k: in_memory_voi.get(k) for k in mws},
        "segments": {k: int(len(np.unique(open_ds(p).to_ndarray())) - 1) for k, p in mws.items()},
    }
    cc = run("cc", "cc")
    threshold, debris = METHOD_DEFAULTS["cc"]["threshold"], METHOD_DEFAULTS["cc"]["remove_debris"]
    t0 = time.perf_counter()
    ref = cc_segmentation(open_ds(affs_path).to_ndarray(), threshold=threshold, remove_debris=debris)
    out["cc"] = {
        "seconds": stages["cc"]["seconds"], "in_memory_seconds": time.perf_counter() - t0,
        "threshold": threshold, "remove_debris": debris,
        **same_partition(open_ds(cc["cc"]).to_ndarray(), ref),
    }
    one = run("ws_one", "ws")
    two = run("ws_two", "ws", workers=2, ledger=os.path.join(work, "ws_ledger.db"))
    frags = [open_ds(os.path.join(work, f"{n}.zarr", "fragments_ws")).to_ndarray() for n in ("ws_one", "ws_two")]
    out["ws_sharded"] = {
        "seconds": stages["ws_two"]["seconds"], "one_process_seconds": stages["ws_one"]["seconds"],
        "fragments_equal": bool(np.array_equal(*frags)),
        "partitions": {t: same_partition(open_ds(two[t]).to_ndarray(), open_ds(p).to_ndarray()) for t, p in one.items()},
    }
    # K2 in the parent's ws only: the workers' launches are their own
    out["seed_launches"] = stages["ws_one"]["launches"]["seed_maxima.kernel"]
    out["launches"] = {k: v["launches"] for k, v in stages.items()}
    bad = [
        name for name, ok in [
            ("cc", out["cc"]["equal"]), ("ws_sharded fragments", out["ws_sharded"]["fragments_equal"]),
            *[(f"ws_sharded {t}", v["equal"]) for t, v in out["ws_sharded"]["partitions"].items()],
        ] if not ok
    ]
    if bad or (device == "cuda" and out["seed_launches"] != 8):
        raise AssertionError(f"blockwise against in-memory / one process: {bad}: {out}")
    return out


def blockwise_phase(work: str, volumes: dict, synth: dict, seed: int, device="cuda",
                    shape=BLOCKWISE_VOLUME) -> dict:
    """Blockwise segmentation: (1) ``blockwise_full_scale`` at ``shape``
    (its files deleted after), (2) ``blockwise_against_in_memory`` on the
    ``synth`` phase's affinities and its in-memory mws VOI."""
    import shutil

    full_dir = os.path.join(work, "blockwise_full")
    os.makedirs(full_dir, exist_ok=True)
    try:
        full = blockwise_full_scale(full_dir, shape, seed, device)
    finally:
        shutil.rmtree(full_dir, ignore_errors=True)
    os.makedirs(os.path.join(work, "blockwise"), exist_ok=True)
    vs = blockwise_against_in_memory(
        os.path.join(work, "blockwise"), synth["affs_dataset"], volumes["vol"]["labels_dataset"],
        synth["segment"]["mws"]["voi"], device,
    )
    return {"full_scale": full, "synth_volume": vs, "seed_launches": full["seed_launches"] + vs["seed_launches"]}

# -- (c') the command line -------------------------------------------------


@contextlib.contextmanager
def timed_workflows(log: dict):
    """The workflow entry points the command line calls, wrapped so that
    each call's seconds, result and launch counts (by route and K1's by
    conv, read as differences around the call) land in ``log[stage]``."""
    from bootstrapper_torch.ops import conv3d_kernel_launches, launch_counts
    from bootstrapper_torch.workflows import evaluate, filter, predict, segment, train

    def diff(after: dict, before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    wrapped = [
        (train, "run_training", "train"), (predict, "run_prediction", "predict"),
        (segment, "run_segmentation", "segment"), (evaluate, "run_evaluation", "evaluate"),
        (filter, "run_filter", "filter"),
    ]
    originals = [getattr(mod, fn) for mod, fn, _ in wrapped]
    for (mod, fn, name), orig in zip(wrapped, originals):
        def timed(*args, _orig=orig, _name=name, **kw):
            counts, convs, t0 = launch_counts(), conv3d_kernel_launches(), time.perf_counter()
            result = _orig(*args, **kw)
            log[_name] = {
                "seconds": time.perf_counter() - t0, "result": result,
                "launches": diff(launch_counts(), counts), "conv_launches": diff(conv3d_kernel_launches(), convs),
            }
            return result

        setattr(mod, fn, timed)
    try:
        yield log
    finally:
        for (mod, fn, _), orig in zip(wrapped, originals):
            setattr(mod, fn, orig)


def xy_edges(size: int, tile: int) -> list:
    """Where the tiles of ``tile`` voxels that cover ``size`` begin and end
    (edge tiles shifted inward, as ``predict.scan.tile_rois`` places them)."""
    starts = list(range(0, size - tile + 1, tile)) or [0]
    if starts[-1] + tile < size:
        starts.append(size - tile)
    return sorted({e for s in starts for e in (s, s + tile)})


def away_from_edges(shape, tiles, band: int) -> np.ndarray:
    """(Y, X) mask of the voxels further than ``band`` from every xy tile
    edge of each output xy tile size in ``tiles``."""
    keep = [np.ones(n, bool) for n in shape]
    for tile in tiles:
        for axis, n in enumerate(shape):
            for e in xy_edges(n, tile):
                keep[axis][max(0, e - band - 1) : e + band] = False
    return keep[0][:, None] & keep[1][None, :]


def tile_memory_sweep(model, tiles, seed: int) -> list:
    """Peak device memory of one bf16 tile forward through ``Predictor`` at
    each ``(shape_increase, input tile)`` of ``tiles``, beyond what the
    weights and the input hold, per input voxel, and the forward's time
    between CUDA events and its output Mvox/s."""
    import torch

    from bootstrapper_torch.predict.scan import Predictor

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for inc, tile in tiles:
        pred = Predictor(model, (40, 4, 4), shape_increase=inc, device="cuda")
        x = torch.randint(0, 256, (1, *tile, 1), generator=gen, device="cuda", dtype=torch.uint8)
        pred.forward(x)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = pred.forward(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out
        ms = cuda_time_ms(lambda: pred.forward(x), iters=3, queued=True)
        voxels = int(np.prod(tile))
        rows.append({
            "input_tile": list(tile), "output_tile": list(pred.output_tile), "input_voxels": voxels,
            "peak_gb": peak / 1e9, "held_gb": held / 1e9,
            "bytes_per_input_voxel": (peak - held) / voxels, "ms": ms,
            "output_mvox_per_s_device": int(np.prod(pred.output_tile)) / ms / 1e3,
        })
        del x, pred
        torch.cuda.empty_cache()
    return rows


def cli_phase(work: str, seed: int, net_config: dict, shape, iterations: int, device="cuda") -> tuple:
    """The command line, as a user drives a round with it, on a fresh
    Voronoi sample of ``shape``: ``python -m bootstrapper_torch prepare
    round`` in a subprocess (its five stage TOMLs held to the ones
    ``configs.make_round_configs`` writes with the same arguments), ``net_config``
    written over the setup's, then ``run <round dir>`` in this process
    through the command line's ``main`` (train ``iterations``, predict,
    segment in ws, evaluate by VOI, filter), launch counts zeroed before it
    and read after.  Then ``run_prediction`` once more on the same config
    and checkpoint, whose affinities must equal ``run``'s bit for bit; then
    ``predict --auto-tile``, within +-1 of the default tiling further than
    SEAM_BAND voxels from either tiling's xy tile edges, K1 once at each of
    its tile's convs per tile.  On the card, last, the memory sweep behind
    ``predict/scan.py``'s tile budget.  Returns the phase's line and K1's
    launch groups (``merge_launches``)."""
    import torch

    from bootstrapper_torch import configs
    from bootstrapper_torch.cli.main import main as bs
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import Model, load_checkpoint, load_params
    from bootstrapper_torch.ops import conv3d_kernel_launches, launch_counts, reset_launch_counts
    from bootstrapper_torch.predict import scan
    from bootstrapper_torch.utils import tomlio
    from bootstrapper_torch.workflows import run_prediction

    out = {"volume": list(shape), "iterations": iterations}
    t0 = time.perf_counter()
    volumes = write_round_sample(work, shape, seed, device)
    container, labels = volumes["vol"]["output_container"], volumes["vol"]["labels_dataset"]
    volumes_toml = os.path.join(work, "volumes.toml")
    tomlio.dump({"volumes": volumes}, volumes_toml)
    out["sample_seconds"] = time.perf_counter() - t0

    # prepare, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bootstrapper_torch", "--device", device, "prepare", "round", "-b", work,
         "-v", volumes_toml, "-m", "3d_affs", "-r", "cli_round", "--max-iterations", str(iterations),
         "--gt-labels", labels],
        capture_output=True, text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    out["prepare_seconds"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"prepare round exited {proc.returncode}: {proc.stderr[-3000:]}")
    round_dir = os.path.join(work, "cli_round")
    ref_base = os.path.join(work, "ref")
    ref = configs.make_round_configs(
        os.path.join(ref_base, "cli_round"), volumes, ["3d_affs"], max_iterations=iterations, gt_labels=labels
    )
    stage_tomls = sorted(os.path.basename(p) for p in ref.values() if os.path.basename(p)[0].isdigit())
    for name in stage_tomls:
        got = json.dumps(tomlio.load(os.path.join(round_dir, name)))
        want = json.dumps(tomlio.load(os.path.join(ref_base, "cli_round", name))).replace(ref_base, work)
        if got != want:
            raise AssertionError(f"prepare round wrote {name} unlike make_round_configs: {got} != {want}")
    out["stage_tomls"] = stage_tomls
    setup = os.path.join(round_dir, "setups", "3d_affs")
    write_setup_config(setup, net_config)

    # run the round in this process, through the command line's main
    log: dict = {}
    with timed_workflows(log), contextlib.redirect_stdout(sys.stderr):
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = bs(["--device", device, "run", round_dir], standalone_mode=False)
        out["run_seconds"] = time.perf_counter() - t0
        run_launches, run_convs = launch_counts(), conv3d_kernel_launches()
    if rc != 0 or sorted(log) != ["evaluate", "filter", "predict", "segment", "train"]:
        raise AssertionError(f"run {round_dir}: exit {rc}, stages {sorted(log)}")
    train, (pstats,) = log["train"]["result"], log["predict"]["result"].values()
    if train["iterations"] != iterations or not train["checkpoint"].endswith(f"model_checkpoint_{iterations}"):
        raise AssertionError(f"run's training: {train}")
    predict_toml = os.path.join(round_dir, "02_predict.toml")
    (link,) = tomlio.load(predict_toml)["predict"]["vol"]["chain"]
    affs_path = os.path.join(container, link["output_prefix"], "3d_affs")
    affs = open_ds(affs_path).to_ndarray()
    with open(os.path.join(container, "eval", "vol_results.json")) as f:
        voi = {os.path.basename(p): e["voi"] for p, e in json.load(f).items()}
    filtered = log["filter"]["result"]["vol"]
    pseudo = open_ds(filtered["labels"]).to_ndarray()
    out.update({
        "stage_seconds": {k: v["seconds"] for k, v in log.items()},
        "launches": {k: v["launches"] for k, v in log.items()},
        "run_launches": run_launches,
        "checkpoint": os.path.basename(train["checkpoint"]), "final_loss": train["final_loss"],
        "predict": {k: pstats[k] for k in pstats if k != "plan"},
        "predict_mvox_per_s": pstats["voxels_per_sec"] / 1e6,
        "voi": voi,
        "pseudo_gt": {"dataset": filtered["labels"], "removed_ids": filtered["removed_ids"],
                      "labelled_share": float((pseudo > 0).mean())},
    })
    del pseudo

    # the command line adds nothing: the entry point on the same config
    t0 = time.perf_counter()
    run_prediction(predict_toml, device=device)
    direct = open_ds(affs_path).to_ndarray()
    out["direct_predict_seconds"] = time.perf_counter() - t0
    if not np.array_equal(direct, affs):
        raise AssertionError(f"run's affinities differ from run_prediction's at {int((direct != affs).sum())} voxels")
    out["cli_equals_direct"] = True
    del direct

    # predict --auto-tile
    nc = net_config
    inc = scan.auto_shape_increase(nc, open_ds(volumes["vol"]["raw_dataset"]).spatial_shape, device=device)
    auto_log: dict = {}
    with timed_workflows(auto_log), contextlib.redirect_stdout(sys.stderr):
        reset_launch_counts()
        rc = bs(["--device", device, "predict", predict_toml, "--auto-tile"], standalone_mode=False)
        auto_convs = conv3d_kernel_launches()
    (astats,) = auto_log["predict"]["result"].values()
    auto = open_ds(affs_path).to_ndarray()
    ctx_xy = nc["input_shape"][1] - nc["output_shape"][1]
    tiles_xy = [nc["output_shape"][1] + inc[1], pstats["input_tile"][1] - ctx_xy]
    keep = away_from_edges(auto.shape[-2:], tiles_xy, SEAM_BAND)
    diff = np.abs(auto.astype(np.int16) - affs.astype(np.int16))[..., keep]
    tile_in = [a + b for a, b in zip(nc["input_shape"], inc)]
    out["auto_tile"] = {
        "shape_increase": inc, "input_tile": tile_in, "input_voxels": int(np.prod(tile_in)),
        "budget_input_voxels": scan.default_tile_budget(device),
        "tiles": astats["tiles"], "streamed": "steps_per_column" in astats,
        "seconds": auto_log["predict"]["seconds"], "mvox_per_s": astats["voxels_per_sec"] / 1e6,
        "compared_voxels": int(diff.size), "max_abs_diff": int(diff.max()),
        "differing_share": float((diff != 0).mean()), "edge_band": SEAM_BAND, "xy_tiles": tiles_xy,
        "launches": auto_log["predict"]["launches"],
    }
    if rc != 0 or out["auto_tile"]["streamed"] or int(diff.max()) > 1:
        raise AssertionError(f"predict --auto-tile: exit {rc}, {out['auto_tile']}")
    del affs, auto, diff
    if device != "cuda":
        return out, []

    # K1: once per iteration at each training conv, on every predict step at
    # the stream's convs, once per tile at the auto tile's convs; K2 in segment
    check_train_launches("cli train", log["train"]["conv_launches"], net_config, iterations)
    step_tile = [pstats["step_z"], *pstats["input_tile"][1:]]
    warm, steady = trace_stream_convs(net_config, step_tile, pstats["warm_step_z"])
    check_stream_launches("cli predict", log["predict"]["conv_launches"], warm, steady, pstats)
    auto_cases = traced_cases("cli_auto", net_config, (1, *tile_in, 1))
    check_launches("cli predict --auto-tile", auto_convs, [(auto_cases, astats["tiles"])])
    seed_launches = log["segment"]["launches"].get("seed_maxima.kernel", 0)
    if seed_launches < 1 or run_launches["seed_maxima.kernel"] != seed_launches:
        raise AssertionError(f"cli segment: the seed kernel launches {seed_launches}")
    out["seed_launches"] = seed_launches
    out["conv_launches"] = {
        "train": sum(log["train"]["conv_launches"].values()),
        "predict": sum(log["predict"]["conv_launches"].values()),
        "auto_tile": sum(auto_convs.values()),
    }
    if sum(run_convs.values()) != out["conv_launches"]["train"] + out["conv_launches"]["predict"]:
        raise AssertionError(f"cli run: K1 launches outside train and predict: {run_convs}")

    # the tile budget: peak memory of a tile forward per input voxel
    model = load_params(Model(net_config), load_checkpoint(train["checkpoint"]))
    base_inc = list(net_config.get("shape_increase", [0, 0, 0]))
    sweep = [(base_inc, [a + b for a, b in zip(nc["input_shape"], base_inc)])]
    sweep += [(i, [a + b for a, b in zip(nc["input_shape"], i)]) for i in CLI_SWEEP_INCREASES]
    sweep.append((inc, tile_in))
    # and the largest tile the budget admits (a volume past any tile)
    widest = scan.auto_shape_increase(nc, (10_000, 20_000, 20_000), device=device)
    sweep.append((widest, [a + b for a, b in zip(nc["input_shape"], widest)]))
    rows = tile_memory_sweep(model, sweep, seed)
    del model
    worst = max(r["bytes_per_input_voxel"] for r in rows)
    total = torch.cuda.get_device_properties(0).total_memory
    out["tile_memory"] = {
        "sweep": rows, "max_bytes_per_input_voxel": worst,
        "code_bytes_per_input_voxel": scan.TILE_BYTES_PER_INPUT_VOXEL,
        "auto_tile_peak_gb": rows[-2]["peak_gb"], "widest_tile_peak_gb": rows[-1]["peak_gb"],
        "budget_gb": scan.TILE_MEMORY_SHARE * total / 1e9, "total_gb": total / 1e9,
    }
    if worst > scan.TILE_BYTES_PER_INPUT_VOXEL:
        raise AssertionError(f"a tile forward took {worst} bytes an input voxel, over the budget's: {out['tile_memory']}")
    groups = [
        launch_group(log["train"], train_conv_cases(net_config)),
        launch_group(log["predict"], stream_conv_cases(net_config, step_tile, pstats["warm_step_z"])),
        {"by_conv": dict(auto_convs), "cases": auto_cases},
    ]
    return out, groups


def multi_toml(work: str, name: str, raw_path: str, setup: str, iteration: int) -> str:
    """A predict TOML of one link, writing under ``multi/<name>``."""
    from bootstrapper_torch.utils import tomlio

    path = os.path.join(work, f"predict_{name}.toml")
    tomlio.dump({"predict": {"vol": {
        "raw_dataset": raw_path, "output_container": os.path.join(work, "multi.zarr"),
        "chain": [{"setup_dir": setup, "output_prefix": f"multi/{name}", "checkpoint_iteration": iteration}],
    }}}, path)
    return path


def compare_split(got: np.ndarray, want: np.ndarray, axis: int, seams, band: int) -> dict:
    """A split tile's uint8 outputs against the whole tile's: the largest
    difference within ``band`` voxels of a seam (along spatial ``axis`` of
    ``(C, Z, Y, X)`` arrays) and elsewhere."""
    diff = np.moveaxis(np.abs(got.astype(np.int16) - want.astype(np.int16)), 1 + axis, 0)
    near = np.zeros(diff.shape[0], bool)
    for b in seams:
        near[max(0, b - band) : b + band] = True
    return {
        "shape": list(got.shape), "axis": axis, "seams": list(seams), "band": band,
        "max_abs_diff_near_seams": int(diff[near].max(initial=0)),
        "max_abs_diff_elsewhere": int(diff[~near].max(initial=0)),
        "differing_share_elsewhere": float((diff[~near] != 0).mean()),
        "differing_share": float((diff != 0).mean()),
    }


@contextlib.contextmanager
def fp32_exact():
    """fp32 convs and matmuls without TF32 inside, as before after."""
    import torch

    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@contextlib.contextmanager
def library_as_plain():
    """The library route's convs (``conv3d_library``: cuDNN, its algorithm
    picked per shape) computed by the plain version inside, one fixed
    order of fp32 sums for each output; the library again after."""
    from bootstrapper_torch.ops import conv3d as C

    before = C.conv3d_library
    C.conv3d_library = C.conv3d_plain
    try:
        yield
    finally:
        C.conv3d_library = before


def split_ok(cmp: dict) -> bool:
    """``compare_split``'s result within the gates: near a seam at most
    MULTI_SEAM_MAX_DIFF; elsewhere at most MULTI_MAX_DIFF on under
    MULTI_SPLIT_MAX_SHARE of voxels."""
    return (
        cmp["max_abs_diff_near_seams"] <= MULTI_SEAM_MAX_DIFF and cmp["max_abs_diff_elsewhere"] <= MULTI_MAX_DIFF
        and cmp["differing_share_elsewhere"] < MULTI_SPLIT_MAX_SHARE
    )


def mesh_step_check(mesh, net_config: dict, seed: int, lr: float) -> dict:
    """A rank of the ``multi`` phase's one-step check (spawned): rank 0 holds
    parameters from ``seed`` (the others zeros, so that the broadcast is what
    makes them equal) and, first, the one-device gradient and loss on the
    whole batch; then one sharded step over the mesh, after which each
    parameter's ``grad`` is the reduced gradient.  Rank 0 returns the loss
    against the one-device loss, the reduced gradient's relative L2
    distance from the one-device gradient (over all parameters, and the
    largest of one parameter), the step's ms, and every rank's K1 launches
    by conv."""
    import torch
    import torch.distributed as dist

    from bootstrapper_torch.models import Model, init_params_numpy, load_params
    from bootstrapper_torch.ops import conv3d_kernel_launches, reset_launch_counts
    from bootstrapper_torch.train import loop as L

    dev = mesh.device
    model = Model(net_config)
    if mesh.rank == 0:
        load_params(model, init_params_numpy(net_config, seed))
    model = model.to(dev)
    rng = np.random.default_rng(seed)
    out = net_config["output_shape"]
    batch = {
        "input": torch.tensor(rng.uniform(-1, 1, (1, *net_config["input_shape"], 1)), dtype=torch.float32),
        "targets": {"3d_affs": torch.tensor((rng.random((1, *out, 9)) > 0.5), dtype=torch.float32)},
        "weights": {"3d_affs": torch.tensor((rng.random((1, *out, 9)) > 0.2), dtype=torch.float32)},
    }
    batch = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev)) for k, v in batch.items()}
    ref = {}
    if mesh.rank == 0:
        loss = L.loss_fn(model, batch)
        loss.backward()
        ref = {"loss": float(loss.detach()), "grads": [p.grad.detach().clone() for p in model.parameters()]}
        model.zero_grad(set_to_none=True)
    state = L.broadcast_state(L.TrainState(0, model, L.make_optimizer(model, lr)), mesh)
    group = L.broadcast_batch(batch if mesh.rank == mesh.leader else None, mesh)
    step = L.shard_train_step(mesh, model.unet_config, model.dims)
    reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, group)
    loss = float(metrics["loss"])  # waits for the step
    ms = (time.perf_counter() - t0) * 1e3
    launches = [None] * mesh.world
    dist.all_gather_object(launches, conv3d_kernel_launches())
    if mesh.rank != 0:
        return {}
    num = den = 0.0
    worst = 0.0
    for p, g in zip(model.parameters(), ref["grads"]):
        d2, g2 = float(((p.grad - g).double() ** 2).sum()), float((g.double() ** 2).sum())
        num, den = num + d2, den + g2
        if g2 > 0:
            worst = max(worst, (d2 / g2) ** 0.5)
    return {
        "loss": loss, "one_device_loss": ref["loss"], "loss_rel_diff": abs(loss - ref["loss"]) / abs(ref["loss"]),
        "grad_rel_l2": (num / den) ** 0.5, "worst_param_grad_rel_l2": worst, "step_ms": ms,
        "conv_launches_by_rank": launches,
    }


def mesh_check_then_train(mesh, net_config: dict, seed: int, lr: float, cfg: dict, batch_size: int,
                          compute_dtype, spawned_at: float) -> dict:
    """A rank of the ``multi`` phase's 3D mesh run (spawned): the one-step
    check (``mesh_step_check``), then the training loop that each rank of
    ``run_training(mesh=True)`` runs (``workflows.train._mesh_rank``) on
    ``cfg``, in the same process group (one spawn of the ranks, not two).
    Also the seconds from ``spawned_at`` (the parent's ``time.time()``
    before the spawn) to the joined process group, of the check and of
    the training."""
    import torch

    from bootstrapper_torch.ops import reset_launch_counts
    from bootstrapper_torch.workflows import train as T

    t0 = time.time()
    check = mesh_step_check(mesh, net_config, seed, lr)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    reset_launch_counts()
    t1 = time.time()
    train = T._mesh_rank(mesh, cfg, compute_dtype, batch_size)
    seconds = {"to_process_group": t0 - spawned_at, "check": t1 - t0, "train": time.time() - t1}
    return {"check": check, "train": train, "seconds": seconds}


def multi_phase(work: str, seed: int, net_config: dict, net_config_2d: dict, shape, devices: list,
                device="cuda") -> tuple:
    """Multi-device prediction and mesh training on the logical devices
    ``devices`` (two entries of one card on the GPU host), on a fresh
    Voronoi sample of ``shape`` at ``net_config``'s width (3D) and
    ``net_config_2d``'s (the 2D setup), each against the one-device path:

    - ``predict --sharded`` through the command line's ``main`` with
      ``BS_ZSTREAM=0`` on the first MULTI_ROI_SECTIONS sections: a batch of
      tiles, one per device,
      equal to ``run_prediction``'s one-device result at the same tile;
    - ``spatial_small``: ``SpatialShardedPredictor`` at
      ``spatial_shape_increase``'s tile on one tile of the sample: each
      slab equal to a forward of the slab-sized tile, the whole split tile
      against the whole tile's forward (within SEAM_BAND voxels of the
      seam by at most MULTI_SEAM_MAX_DIFF, elsewhere ``split_ok``'s), and
      0 apart elsewhere in fp32 with TF32 off (``fp32_exact``) and in bf16
      with the library route's convs made plain (``library_as_plain``);
    - ``spatial_wide``: ``predict --sharded spatial --auto-tile`` through
      ``main``, one auto tile split in two, against ``predict --auto-tile``
      on one device, held as the small tile; the peak memory of each split
      tile against its unsplit forward, and the halo bytes copied;
    - ``zstream``: ``run_prediction(sharded="batch")`` over a deep volume of
      one xy column (MULTI_ZSTREAM_SHAPE), streamed in lockstep in
      ``plan_z_groups`` segments, against the one-device stream; the warm
      and steady steps' device ms, and ``WARM_COST_FACTOR`` from them;
    - ``train``: two ranks over gloo, factorisation (1, 2): one step from
      one state on one batch against the one-device step
      (``mesh_step_check``), then, in the same spawn, the loop each rank of
      ``run_training(mesh=True)`` runs, MULTI_TRAIN_ITERATIONS, whose
      checkpoint ``run_prediction`` loads; 2d_mtlsd at batch 10 through
      ``run_training``, (2, 1), MULTI_2D_ITERATIONS; and one rank over NCCL
      (world size 1) for MULTI_NCCL_STEPS steps in this process.

    Two ranks share one card and gloo stages CUDA tensors through the
    host, so the times are those of correctness runs.  Returns the phase's
    line and K1's launch groups (``merge_launches``), the training ranks'
    included."""
    import torch

    from bootstrapper_torch import resolve_devices
    from bootstrapper_torch.cli.main import main as bs
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models import Model, init_params_numpy, load_params
    from bootstrapper_torch.models.weights import save_checkpoint
    from bootstrapper_torch.ops import conv3d_kernel_launches, reset_launch_counts
    from bootstrapper_torch.predict import scan, zstream
    from bootstrapper_torch.predict.spatial import SpatialShardedPredictor, spatial_shape_increase
    from bootstrapper_torch.train import loop as L
    from bootstrapper_torch.utils import tomlio
    from bootstrapper_torch.workflows import run_prediction, run_training

    cuda = device == "cuda"
    dev_list = ",".join(devices)
    out = {"volume": list(shape), "devices": list(devices), "nvidia_smi": nvidia_smi() if cuda else None}
    groups, launches = [], {}
    t_phase = time.perf_counter()
    volumes = write_round_sample(work, shape, seed, device)
    raw_path = volumes["vol"]["raw_dataset"]
    raw = open_ds(raw_path)
    setup = os.path.join(work, "setup", "3d_affs")
    os.makedirs(setup)
    write_setup_config(setup, net_config)
    params = init_params_numpy(net_config, seed)
    save_checkpoint(setup, params, 1)
    nc = net_config

    def timed(fn):
        """``fn()`` with the launch counts zeroed first; its K1 launches by
        conv, its result and seconds."""
        if cuda:
            torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        if cuda:
            torch.cuda.synchronize()
        return result, conv3d_kernel_launches(), time.perf_counter() - t0

    # predict --sharded: a batch of tiles, one per device (tiled, not streamed)
    vs = raw.voxel_size
    roi = [[0, 0, 0], [min(MULTI_ROI_SECTIONS, shape[0]) * vs[0], shape[1] * vs[1], shape[2] * vs[2]]]
    roi_args = ["--roi-offset", *map(str, roi[0]), "--roi-shape", *map(str, roi[1])]
    os.environ["BS_ZSTREAM"] = "0"
    try:
        log: dict = {}
        with timed_workflows(log), contextlib.redirect_stdout(sys.stderr):
            toml_b = multi_toml(work, "batch", raw_path, setup, 1)
            rc, by_conv, secs = timed(lambda: bs(["--device", dev_list, "predict", toml_b, *roi_args, "--sharded"]))
        bstats = log["predict"]["result"]["vol/multi/batch"]
        toml_1 = multi_toml(work, "batch_one", raw_path, setup, 1)
        ostats, _, one_secs = timed(lambda: run_prediction(
            toml_1, device=devices[0], roi_offset=roi[0], roi_shape=roi[1]))
    finally:
        del os.environ["BS_ZSTREAM"]
    got = open_ds(os.path.join(work, "multi.zarr", "multi", "batch", "3d_affs")).to_ndarray()
    want = open_ds(os.path.join(work, "multi.zarr", "multi", "batch_one", "3d_affs")).to_ndarray()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    out["sharded_batch"] = {
        "roi_voxels": roi, "tiles": bstats["tiles"], "devices": bstats["devices"], "seconds": secs,
        "mvox_per_s": bstats["voxels_per_sec"] / 1e6,
        "one_device_mvox_per_s": ostats["vol/multi/batch_one"]["voxels_per_sec"] / 1e6,
        "one_device_seconds": one_secs, "max_abs_diff": int(diff.max()),
        "differing_share": float((diff != 0).mean()),
    }
    launches["sharded_batch"] = bstats["launches_by_device"]
    groups.append({"by_conv": dict(by_conv), "cases": conv_cases() if cuda else []})  # the main path's tile
    if rc != 0 or "steps_per_column" in bstats or int(diff.max()) > MULTI_MAX_DIFF or bstats["devices"] != len(devices):
        raise AssertionError(f"predict --sharded: exit {rc}, {out['sharded_batch']}")
    del got, want, diff

    # --sharded spatial at spatial_shape_increase's tile, on one tile
    inc = spatial_shape_increase(nc, len(devices), raw.spatial_shape)
    model = load_params(Model(nc), params)
    sp = SpatialShardedPredictor(model, raw.voxel_size, devices=devices, shape_increase=inc)
    wroi = scan.tile_rois(raw.roi, sp.output_size)[0]  # the sample's first tile
    x = sp.read_tile([raw], wroi)
    if cuda:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    handles, by_conv, _ = timed(lambda: sp.dispatch(x))
    split = sp.gather(handles)["3d_affs"]
    split_peak = torch.cuda.max_memory_allocated() - held if cuda else None
    one = scan.Predictor(model, raw.voxel_size, shape_increase=[0, 0, 0], device=devices[0])
    own, rows, ax = sp.own_out, sp.slab_rows, sp.shard_axis
    slab_outs = []
    for k in range(len(devices)):
        xs = np.ascontiguousarray(np.take(x, range(k * own, k * own + rows), axis=ax))[None]
        slab_outs.append(one.forward(torch.from_numpy(xs).to(one.device))["3d_affs"].cpu().numpy())
    whole_p = scan.Predictor(model, raw.voxel_size, shape_increase=inc, device=devices[0])
    xw = torch.from_numpy(np.ascontiguousarray(np.take(x, range(sp.in_tile[ax]), axis=ax))[None]).to(whole_p.device)
    if cuda:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    whole = whole_p.forward(xw)["3d_affs"].cpu().numpy()
    whole_peak = torch.cuda.max_memory_allocated() - held if cuda else None
    slab_diff = np.abs(split.astype(np.int16) - np.concatenate(slab_outs, axis=1 + ax).astype(np.int16))
    chw = lambda a: np.moveaxis(a[0], -1, 0)  # noqa: E731
    seams = [own * k for k in range(1, len(devices))]
    cmp = compare_split(chw(split), chw(whole), ax, seams, SEAM_BAND)
    # the witnesses, each 0 apart away from the seam: the same split and
    # whole tile in fp32 with TF32 off (the split itself is exact), and in
    # bf16 with the library route's convs made plain (the bf16 difference
    # is the library's per-shape rounding)

    def split_and_whole(m, dtype):
        spw = SpatialShardedPredictor(m, raw.voxel_size, devices=devices, shape_increase=inc, compute_dtype=dtype)
        got = spw.gather(spw.dispatch(x))["3d_affs"]
        ref = scan.Predictor(m, raw.voxel_size, shape_increase=inc, device=devices[0], compute_dtype=dtype)
        return compare_split(chw(got), chw(ref.forward(xw)["3d_affs"].cpu().numpy()), ax, seams, SEAM_BAND)

    with fp32_exact():
        cmp32 = split_and_whole(load_params(Model(nc, compute_dtype=torch.float32), params), torch.float32)
    with library_as_plain():
        cmp_plain = split_and_whole(model, torch.bfloat16) if cuda else None
    out["spatial_small"] = {
        "shape_increase": inc, "input_tile": list(sp.in_tile), "output_tile": list(sp.out_tile),
        "shard_axis": ax, "hops": list(sp.hops), "halo": list(sp.halo), "halo_bytes": sp.halo_bytes,
        "slab_max_abs_diff": int(slab_diff.max()), "vs_whole": cmp, "vs_whole_fp32": cmp32,
        "vs_whole_library_plain": cmp_plain,
        "split_peak_gb": None if split_peak is None else split_peak / 1e9,
        "whole_peak_gb": None if whole_peak is None else whole_peak / 1e9,
    }
    launches["spatial_small"] = list(sp.launches_by_device)
    # a slab is the net's base tile: the training forward's shapes
    groups.append({"by_conv": dict(by_conv), "cases": train_conv_cases(nc) if cuda else []})
    witnesses = [cmp32] + ([cmp_plain] if cuda else [])
    if (int(slab_diff.max()) > MULTI_MAX_DIFF or not split_ok(cmp)
            or any(w["max_abs_diff_elsewhere"] != 0 for w in witnesses)):
        raise AssertionError(f"--sharded spatial at {sp.in_tile}: {out['spatial_small']}")
    # the whole tile's convs, launched to compare: held against the plain
    # version, counted as no launch of the path
    whole_cases = traced_cases("multi_spatial_whole", nc, (1, *sp.in_tile, 1))
    groups.append({"by_conv": {conv_key(c): 0 for c in whole_cases}, "cases": whole_cases})
    del sp, one, whole_p, handles, x, xw, split, whole, slab_outs

    # --sharded spatial --auto-tile: one wide tile split in two, through main
    log = {}
    for name, args in (("wide", ["--device", dev_list]), ("wide_one", ["--device", devices[0]])):
        toml_w = multi_toml(work, name, raw_path, setup, 1)
        extra = ["--sharded", "spatial"] if name == "wide" else []
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with timed_workflows(log), contextlib.redirect_stdout(sys.stderr):
            rc, by_conv, secs = timed(lambda: bs([*args, "predict", toml_w, "--auto-tile", *extra]))
        if rc != 0:
            raise AssertionError(f"predict --auto-tile {' '.join(extra)}: exit {rc}")
        log[name] = {
            "stats": log["predict"]["result"][f"vol/multi/{name}"], "seconds": secs, "by_conv": by_conv,
            "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9 if cuda else None,
        }
    wide, wide_one = log["wide"], log["wide_one"]
    winc = scan.auto_shape_increase(nc, raw.spatial_shape, device=devices[0])
    w_in = [a + b for a, b in zip(nc["input_shape"], winc)]
    w_out = [a + b for a, b in zip(nc["output_shape"], winc)]
    w_ax = wide["stats"]["shard_axis"]
    got = open_ds(os.path.join(work, "multi.zarr", "multi", "wide", "3d_affs")).to_ndarray()
    want = open_ds(os.path.join(work, "multi.zarr", "multi", "wide_one", "3d_affs")).to_ndarray()
    own = w_out[w_ax] // len(devices)
    cmp = compare_split(got, want, w_ax, [own * k for k in range(1, len(devices))], SEAM_BAND)
    out["spatial_wide"] = {
        "input_tile": w_in, "output_tile": w_out, "tiles": wide["stats"]["tiles"], "shard_axis": w_ax,
        "halo_bytes": wide["stats"]["halo_bytes"], "seconds": wide["seconds"],
        "mvox_per_s": wide["stats"]["voxels_per_sec"] / 1e6,
        "one_device_mvox_per_s": wide_one["stats"]["voxels_per_sec"] / 1e6,
        "peak_gb": wide["peak_gb"], "one_device_peak_gb": wide_one["peak_gb"], "vs_whole": cmp,
    }
    launches["spatial_wide"] = wide["stats"]["launches_by_device"]
    slab_in = list(w_in)
    slab_in[w_ax] = own + (w_in[w_ax] - w_out[w_ax])
    groups.append({"by_conv": dict(wide["by_conv"]), "cases": traced_cases("multi_spatial_slab", nc, (1, *slab_in, 1))})
    if wide["stats"]["tiles"] != 1 or not split_ok(cmp):
        raise AssertionError(f"--sharded spatial --auto-tile: {out['spatial_wide']}")
    del got, want

    # lockstep z streaming: a deep volume of one xy column
    from bootstrapper_torch.core.arrays import prepare_ds

    zshape = MULTI_ZSTREAM_SHAPE
    zraw = prepare_ds(os.path.join(work, "deep.zarr", "raw"), zshape, (0, 0, 0), raw.voxel_size, np.uint8)
    # the sample's texture, wrapped around to the deep volume's shape
    zraw[zraw.roi] = np.pad(raw.to_ndarray(), [(0, max(0, a - b)) for a, b in zip(zshape, shape)], mode="wrap")[
        : zshape[0], : zshape[1], : zshape[2]
    ]
    log = {}
    with timed_workflows(log), contextlib.redirect_stdout(sys.stderr):
        toml_z = multi_toml(work, "deep", zraw.path, setup, 1)
        zs, z_by_conv, z_secs = timed(lambda: run_prediction(toml_z, device=devices, sharded="batch"))
        toml_z1 = multi_toml(work, "deep_one", zraw.path, setup, 1)
        zs1, _, z1_secs = timed(lambda: run_prediction(toml_z1, device=devices[0]))
    zs, zs1 = zs["vol/multi/deep"], zs1["vol/multi/deep_one"]
    got = open_ds(os.path.join(work, "multi.zarr", "multi", "deep", "3d_affs")).to_ndarray()
    want = open_ds(os.path.join(work, "multi.zarr", "multi", "deep_one", "3d_affs")).to_ndarray()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    ctx_z = nc["input_shape"][0] - nc["output_shape"][0]
    out["zstream"] = {
        "volume": list(zshape), "columns": zs.get("columns"), "z_segments": zs.get("z_segments"),
        "devices": zs.get("devices"), "step_z": zs.get("step_z"), "warm_step_z": zs.get("warm_step_z"),
        "input_tile": zs.get("input_tile"), "seconds": z_secs, "mvox_per_s": zs["voxels_per_sec"] / 1e6,
        "one_device_seconds": z1_secs, "one_device_mvox_per_s": zs1["voxels_per_sec"] / 1e6,
        "max_abs_diff": int(diff.max()), "differing_share": float((diff != 0).mean()),
        "plan_z_groups": list(zstream.plan_z_groups(zshape[0], 1, len(devices), zs.get("step_z", 1),
                                                     zs.get("warm_step_z", 1), ctx_z)),
    }
    launches["zstream"] = zs.get("launches_by_device")
    step_tile = [zs["step_z"], *zs["input_tile"][1:]] if "step_z" in zs else None
    if (
        "steps_per_column" not in zs or zs["columns"] != 1 or zs["z_segments"] < 2
        or int(diff.max()) > ZSTREAM_MAX_DIFF or float((diff != 0).mean()) >= ZSTREAM_MAX_SHARE
    ):
        raise AssertionError(f"lockstep z stream: {out['zstream']}")
    groups.append({"by_conv": dict(z_by_conv), "cases": stream_conv_cases(nc, step_tile, zs["warm_step_z"]) if cuda else []})
    del got, want, diff
    if cuda:  # the warm cost: one warm and one steady step between CUDA events
        zinc = [0, step_tile[1] - nc["input_shape"][1], step_tile[2] - nc["input_shape"][2]]
        zp = zstream.ZStreamPredictor(model, raw.voxel_size, shape_increase=zinc, device=devices[0],
                                      step_z=zs["step_z"], warm_step_z=zs["warm_step_z"])
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xw = torch.randint(0, 256, (1, *zp.warm_input_tile, 1), generator=gen, device="cuda", dtype=torch.uint8)
        xs = torch.randint(0, 256, (1, *step_tile, 1), generator=gen, device="cuda", dtype=torch.uint8)
        _, state = zp.step(xw, None)
        warm_ms = cuda_time_ms(lambda: zp.step(xw, None), iters=2, queued=True)
        steady_ms = cuda_time_ms(lambda: zp.step(xs, state), iters=2, queued=True)
        share = (zp.s_warm + ctx_z) / zp.s
        out["zstream"].update({
            "warm_ms": warm_ms, "steady_ms": steady_ms, "warm_slices_over_steady": share,
            "warm_cost_factor_measured": warm_ms / (steady_ms * share),
            "warm_cost_factor_in_code": zstream.WARM_COST_FACTOR,
        })
        del zp, state, xw, xs
    del model
    if cuda:
        torch.cuda.empty_cache()

    # mesh training: two ranks over gloo
    mesh_backend = L.mesh_backend(devices)
    samples = [{"raw": raw_path, "labels": volumes["vol"]["labels_dataset"],
                "mask": volumes["vol"]["labels_mask_dataset"]}]
    kw = {} if cuda else {"compute_dtype": torch.float32}

    def train_config(name, setup_nc, iterations, batch):
        tsetup = os.path.join(work, "train", name)
        os.makedirs(tsetup)
        write_setup_config(tsetup, setup_nc)
        cfg = {"setup_dir": tsetup, "samples": samples, "voxel_size": volumes["vol"]["voxel_size"],
               "max_iterations": iterations, "save_checkpoints_every": iterations, "save_snapshots_every": 0,
               "mesh": True}
        if batch:
            cfg["batch_size"] = batch
        ttoml = os.path.join(work, f"train_{name}.toml")
        tomlio.dump({"train": cfg}, ttoml)
        return tsetup, ttoml, cfg

    def train_line(name, setup_dir, res, secs, iterations, grid):
        with open(os.path.join(setup_dir, "log", "loss.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        if res["iterations"] != iterations or not all(np.isfinite(e["loss"]) for e in logged):
            raise AssertionError(f"mesh training {name}: {res}, losses {logged}")
        return {
            "iterations": res["iterations"], "final_loss": res["final_loss"], "seconds": secs,
            "ms_per_iteration": 1e3 * logged[-1]["seconds"] / iterations, "grid": grid,
        }

    # 3d_affs over (1, 2): the step against the one-device step, then the
    # training loop of run_training's ranks, in one spawn of the two ranks
    grid = L.make_mesh(len(devices), batch_size=1, spatial=math.gcd(nc["input_shape"][0], nc["output_shape"][0]),
                       devices=devices)
    tsetup, _, cfg3 = train_config("3d_affs", nc, MULTI_TRAIN_ITERATIONS, None)
    both, _, secs = timed(lambda: L.spawn_mesh(
        mesh_check_then_train, grid,
        args=(nc, seed, 0.5e-4, cfg3, 1, kw.get("compute_dtype", torch.bfloat16), time.time())))
    check, res = both["check"], both["train"]
    by_rank = check.pop("conv_launches_by_rank")
    launches["train_step_check"] = [sum(b.values()) for b in by_rank]
    slab_z = nc["output_shape"][0] // len(grid[0]) + ctx_z
    slab_cases = traced_cases("multi_train_slab", nc, (1, slab_z, *nc["input_shape"][1:], 1))
    groups += [{"by_conv": b, "cases": slab_cases} for b in by_rank]
    out["train_step_check"] = {"backend": mesh_backend, "grid": [len(grid), len(grid[0])], **check}
    if check["loss_rel_diff"] > MULTI_LOSS_RTOL or check["grad_rel_l2"] > MULTI_GRAD_REL_L2:
        raise AssertionError(f"mesh step against the one-device step: {out['train_step_check']}")
    train = {"3d_affs": train_line("3d_affs", tsetup, res, secs, MULTI_TRAIN_ITERATIONS, [len(grid), len(grid[0])])}
    train["3d_affs"]["rank0_seconds"] = both["seconds"]
    by_rank = res.pop("conv_launches_by_rank")
    launches["train_3d_affs"] = [sum(b.values()) for b in by_rank]
    groups += [{"by_conv": b, "cases": slab_cases} for b in by_rank]
    # its checkpoint predicts
    ptoml = multi_toml(work, "trained", raw_path, tsetup, MULTI_TRAIN_ITERATIONS)
    pres = run_prediction(ptoml, device=devices[0], roi_offset=roi[0], roi_shape=roi[1])
    affs = open_ds(os.path.join(work, "multi.zarr", "multi", "trained", "3d_affs")).to_ndarray()
    train["3d_affs"]["predicted_tiles"] = pres["vol/multi/trained"]["tiles"]
    if affs.size == 0:
        raise AssertionError("the mesh checkpoint predicted nothing")

    # 2d_mtlsd at batch 10 through run_training: (2, 1)
    tsetup, ttoml, _ = train_config("2d_mtlsd", net_config_2d, MULTI_2D_ITERATIONS, 10)
    res, _, secs = timed(lambda: run_training(ttoml, device=dev_list, **kw))
    train["2d_mtlsd"] = train_line("2d_mtlsd", tsetup, res, secs, MULTI_2D_ITERATIONS, [len(devices), 1])
    by_rank = res.pop("conv_launches_by_rank")
    launches["train_2d_mtlsd"] = [sum(b.values()) for b in by_rank]
    spec_in = (10 // len(devices), net_config_2d.get("adj_slices", 1), *net_config_2d["input_shape"], 1)
    groups += [{"by_conv": b, "cases": traced_cases("multi_train_2d", net_config_2d, spec_in)} for b in by_rank]
    out["train"] = train

    # one rank over NCCL, the backend of a host with several cards
    if cuda:
        import torch.distributed as dist

        ngrid = [[devices[0]]]
        nccl_backend = L.mesh_backend([devices[0]])
        mesh = L.init_mesh(ngrid, 0, nccl_backend, f"tcp://localhost:{L.free_port()}")
        try:
            m = load_params(Model(nc), params).to(devices[0])
            state = L.broadcast_state(L.TrainState(0, m, L.make_optimizer(m, 0.5e-4)), mesh)
            rng = np.random.default_rng(seed + 1)
            o = nc["output_shape"]
            b = {
                "input": torch.tensor(rng.uniform(-1, 1, (1, *nc["input_shape"], 1)), dtype=torch.float32, device="cuda"),
                "targets": {"3d_affs": torch.tensor(rng.random((1, *o, 9)) > 0.5, dtype=torch.float32, device="cuda")},
                "weights": {"3d_affs": torch.ones((1, *o, 9), device="cuda")},
            }
            step = L.shard_train_step(mesh, m.unet_config, m.dims)
            losses, ms = [], []
            reset_launch_counts()
            for _ in range(MULTI_NCCL_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            nccl_convs = conv3d_kernel_launches()
        finally:
            dist.destroy_process_group()
        out["nccl"] = {"backend": nccl_backend, "steps": MULTI_NCCL_STEPS, "losses": losses, "ms": ms}
        launches["train_nccl"] = [sum(nccl_convs.values())]
        groups.append({"by_conv": nccl_convs, "cases": train_conv_cases(nc)})
        if nccl_backend != "nccl" or not all(np.isfinite(losses)):
            raise AssertionError(f"NCCL mesh step: {out['nccl']}")
        del m, state, b
        torch.cuda.empty_cache()
    out["backends"] = {"two_ranks_one_card": mesh_backend, "resolved": [str(d) for d in resolve_devices(dev_list)]}
    out["launches_by_logical_device"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out, groups


# -- (q) int8 inference ------------------------------------------------------


def trace_int8_convs(net_config: dict, input_shape=None, stream=None) -> list:
    """Every conv that one tile of ``input_shape`` hands to ``quant.qconv``
    under ``BS_INT8=1``, or (``stream``: ``(step_tile, s_warm)``, as
    ``trace_stream_convs`` takes them) a z stream's warm step and then its
    steady step, named ``warm_``/``steady_``; traced on the ``meta``
    device, in call order: ``(name, base shape, scale shape, x shape,
    weight shape, bias, relu)``; ``x`` is a centre crop of the tensor its
    scale is taken over (``scale shape``, None: ``x`` itself), which is a
    centre crop of a tensor of the base shape."""
    import torch

    from bootstrapper_torch.models import Model
    from bootstrapper_torch.models.zstream import z_context
    from bootstrapper_torch.ops import quant as Q

    real, cases, prefix = Q.qconv, [], [""]

    def record(x, w, b=None, *, relu=False, out_dtype=None, qw=None, scale_of=None):
        src = x if scale_of is None else scale_of
        bs = storage_shape(src)
        ws = tuple(w.shape)
        n = sum(c[0].startswith(prefix[0]) for c in cases)
        name = f"{prefix[0]}c{n:02d}_{ws[3]}to{ws[4]}_k{''.join(map(str, ws[:3]))}"
        cases.append((name, bs, None if scale_of is None else tuple(src.shape), tuple(x.shape), ws, b is not None,
                      relu))
        return real(x, w, b, relu=relu, out_dtype=out_dtype, qw=qw, scale_of=scale_of)

    saved = os.environ.get("BS_INT8")
    os.environ["BS_INT8"] = "1"
    Q.qconv = record
    try:
        with torch.device("meta"):
            model = Model(net_config).eval()
        cin = model.unet_config.in_channels
        with torch.no_grad():
            if stream is None:
                model(torch.empty((1, *input_shape, cin), device="meta"))
            else:
                step_tile, s_warm = stream
                warm_z = s_warm + z_context(model.unet_config)
                prefix[0] = "warm_"
                _, state = model.forward_stream(torch.empty((1, warm_z, *step_tile[1:], cin), device="meta"), None)
                prefix[0] = "steady_"
                model.forward_stream(torch.empty((1, *step_tile, cin), device="meta"), state)
    finally:
        Q.qconv = real
        if saved is None:
            os.environ.pop("BS_INT8", None)
        else:
            os.environ["BS_INT8"] = saved
    return cases


def check_qconv(seed: int, cases) -> list:
    """K4 (amax, quantization, s8 conv: ``qconv_cuda``) against
    ``qconv_plain`` on the card at each of ``cases``: bf16 out, each output
    within one bf16 ulp of the plain version (whose int32 sums are exact);
    its time (CUDA events around 2-5 queued calls, ``timing_iters``, the
    activation's quantization included), the plain version's, the bf16 route's at the
    same shape (K1 where it takes the shape, else the library: the
    ``library_ms`` of the row, as no PyTorch call computes an s8 conv) and
    the bound at the int8 peak."""
    import torch

    from bootstrapper_torch.models.unet import center_crop
    from bootstrapper_torch.ops import conv3d as C
    from bootstrapper_torch.ops import quant as Q

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, bs, ss, xs, ws, with_bias, relu in cases:
        base = C.empty_channels_last(bs, torch.bfloat16, "cuda")
        base.copy_(torch.randn(bs, generator=gen, device="cuda"))
        outer = base if ss is None else center_crop(base, ss[1:4])
        x = center_crop(outer, xs[1:4])
        src = x if ss is None else outer  # the tensor the scale is taken over
        fan_in = ws[0] * ws[1] * ws[2] * ws[3]
        w = torch.randn(ws, generator=gen, device="cuda") / fan_in**0.5
        b = torch.randn(ws[-1], generator=gen, device="cuda").to(torch.bfloat16) if with_bias else None
        qw = Q.pack_qweights(w)
        scale_of = None if ss is None else src
        got, first_ms = timed_call(lambda: Q.qconv_cuda(x, qw, b, relu=relu, scale_of=scale_of))
        got = got.float()
        ref, plain_ms = timed_call(lambda: Q.qconv_plain(x, w, b, relu=relu, qw=qw, sx=Q.activation_scale(src)))
        ref = ref.float()
        diff = (got - ref).abs()
        ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))))
        err = float(diff.max())
        if not bool((diff <= ulp).all()):
            raise AssertionError(f"qconv kernel {name}: max |err| {err}, beyond one bf16 ulp of the plain version")
        iters, sleep = timing_iters(first_ms, most=5), KERNEL_SLEEP_MS
        ms = cuda_time_ms(
            lambda: Q.qconv_cuda(x, qw, b, relu=relu, scale_of=scale_of), iters=iters, queued=True, sleep_ms=sleep
        )
        wb = w.to(torch.bfloat16)
        if C.conv3d_supported(tuple(x.shape), ws):
            packed = C.pack_weights(wb, torch.bfloat16)
            bf16_route = "conv3d (K1)"
            bf16_ms = cuda_time_ms(
                lambda: C.conv3d_cuda(x, wb, b, relu=relu, packed=packed), iters=iters, queued=True, sleep_ms=sleep
            )
        else:
            bf16_route = "library (F.conv3d, the port's bf16 route for Ci < 128)"
            bf16_ms = cuda_time_ms(lambda: C.conv3d_library(x, wb, b, relu=relu), iters=iters, queued=True, sleep_ms=sleep)
        out_vox = got.numel() // ws[-1]
        macs = out_vox * ws[-1] * fan_in
        nbytes = x.numel() + w.numel() + 2 * got.numel() + (0 if b is None else 4 * b.numel())
        bound_ms, bound_by = bound(2.0 * macs, PEAK_INT8, float(nbytes))
        rows.append({
            "shape": name, "x": list(xs), "scale_over": None if ss is None else list(ss), "w": list(ws),
            "relu": relu, "max_abs_err": err, "tolerance": "one bf16 ulp of the plain version",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": bf16_ms, "library_ms_of": f"the bf16 route at this shape: {bf16_route}",
            "tops": 2.0 * macs / ms / 1e9,
        })
        emit({"phase": "kernel_check", "kernel": "qconv3d", **rows[-1]})
        del base, outer, src, x, w, b, qw, got, ref, diff, ulp
        torch.cuda.empty_cache()
    return rows


def int8_phase(work: str, net_config: dict, params, seed: int, bf16: dict, device="cuda") -> tuple:
    """``BS_INT8=1`` through the user entry points: K4 held against its
    plain version at every conv of a tile (traced under the flag) and at a
    2D (1,3,3) shape; then ``run_prediction`` on the main path's tiled
    volume and on the streamed one (segmentation reads no flag), with the
    launch counts zeroed before and read after: every conv of every tile
    or step on K4, none on K1 or the library, and K4 launched once per
    tile, or per step, at each traced (x, weight) shape and at no other;
    the stream's warm and steady steps are traced under the flag at the
    run's plan and K4 held against its plain version at their convs too;
    the uint8 affinities against the bf16 ones of the same weights
    (``bf16``: {"tiled", "stream"}) within INT8_MAX_MEAN and
    INT8_MAX_DIFF.  Returns ``(line, kernel rows)``: the tile's rows first,
    then the 2D shape's, then the stream's, each with its launches."""
    from collections import Counter

    t_phase = time.perf_counter()
    cuda = torch_cuda(device)
    cases = trace_int8_convs(net_config, TILED_INPUT)
    t0 = time.perf_counter()
    rows = check_qconv(seed, cases + [INT8_2D_CASE]) if cuda else []
    out = {"check_seconds": time.perf_counter() - t0, "convs_per_tile": len(cases)}
    if rows:
        tile_rows = rows[: len(cases)]
        out["tile_ms"] = {"int8_k4": sum(r["ms"] for r in tile_rows), "bf16": sum(r["library_ms"] for r in tile_rows)}
        for r in rows:
            r["launches"] = 0
    saved = os.environ.get("BS_INT8")
    os.environ["BS_INT8"] = "1"
    try:
        for name, shape, stream in (("tiled", (8, 640, 640), False), ("stream", ZSTREAM_SHAPE, True)):
            with tempfile.TemporaryDirectory(prefix=f"bs_chip_smoke_int8_{name}_", dir=work) as sub:
                res = run_main_path(sub, net_config, params, shape, seed, device, zstream=stream, segment=False)
            counts = res["predict_launches"]
            steps = res["tiles"]  # a stream's tiles are its steps
            if (
                counts["qconv3d.kernel" if cuda else "qconv3d.plain"] != steps * len(cases)
                or counts["conv3d.kernel"] or counts["conv3d.library"] or counts["conv3d.plain"]
                or res["conv_launches"]
            ):
                raise AssertionError(f"int8 {name}: launches {counts} over {steps} tiles of {len(cases)} convs")
            if stream:
                plan = res["plan"]
                columns, per_column = plan["columns"], plan["steps_per_column"]
                step_tile = [plan["step_z"], *plan["input_tile"][1:]]
                traced = trace_int8_convs(net_config, stream=(step_tile, plan["warm_step_z"]))
                runs = [(c, columns if c[0].startswith("warm_") else columns * (per_column - 1)) for c in traced]
            else:
                traced, runs = cases, [(c, steps) for c in cases]
            want = Counter()
            for c, n in runs:
                want[(c[3], c[4])] += n
            by_conv = dict(res.pop("qconv_launches"))
            if cuda:
                if by_conv != dict(want):
                    raise AssertionError(f"int8 {name}: K4 launches by conv {by_conv}, want {dict(want)}")
                if stream:
                    t0 = time.perf_counter()
                    new = check_qconv(seed, traced)
                    out["stream_check_seconds"] = time.perf_counter() - t0
                    rows += new
                else:
                    new = rows[: len(cases)]
                for r, c in zip(new, traced):  # a shape traced twice takes its launches on its first row
                    r["launches"] = by_conv.pop((c[3], c[4]), 0)
            a, ref = res.pop("affs"), bf16[name]
            diff = np.abs(a.astype(np.int16) - ref.astype(np.int16))
            res.pop("conv_launches")
            res["vs_bf16"] = {
                "mean_abs_diff": float(diff.mean()), "max_abs_diff": int(diff.max()),
                "differing_share": float((diff != 0).mean()),
                "bounds": {"mean": INT8_MAX_MEAN, "max": INT8_MAX_DIFF},
            }
            out[name] = res
            if not (diff.mean() < INT8_MAX_MEAN and diff.max() <= INT8_MAX_DIFF):
                raise AssertionError(f"int8 {name} predictions beyond the bounds of the bf16 ones: {res['vs_bf16']}")
    finally:
        if saved is None:
            os.environ.pop("BS_INT8", None)
        else:
            os.environ["BS_INT8"] = saved
    if cuda:
        out["launches"] = sum(out[n]["predict_launches"]["qconv3d.kernel"] for n in ("tiled", "stream"))
        if sum(r["launches"] for r in rows) != out["launches"]:
            raise AssertionError("int8: K4's launches do not add up over its checked shapes")
    out["seconds"] = time.perf_counter() - t_phase
    return out, rows


def torch_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


# -- (p) SAM and proofreading ------------------------------------------------


def random_sam(cfg, seed: int, device):
    """A ``Sam`` of ``cfg`` on ``device`` with every parameter and buffer
    drawn from ``seed`` by a generator on ``device`` (the default init
    leaves the position tables at zero)."""
    import torch

    from bootstrapper_torch.models.sam import Sam

    gen = torch.Generator(device=device).manual_seed(seed)
    model = Sam(cfg).to(device)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
        for b in model.buffers():
            b.copy_(torch.randn(b.shape, generator=gen, device=device))
    return model.eval()


def session_sam(seed: int):
    """The proofreading sessions' vit_b: ``random_sam`` on the CPU, its
    mask head set so that a mask follows the section: the upscaling's
    norm at unit scale, the upscaling's and the mask MLPs' output biases
    zero (drawn at 0.02 like the rest, those biases outweigh the image,
    and a mask is all of a section or none of it)."""
    import torch

    from bootstrapper_torch.models.sam import PRESETS

    model = random_sam(PRESETS["vit_b"], seed, "cpu")
    dec = model.mask_decoder
    with torch.no_grad():
        dec.output_upscaling[1].weight.fill_(1.0)
        for t in (dec.output_upscaling[0].bias, dec.output_upscaling[1].bias, dec.output_upscaling[3].bias):
            t.zero_()
        for mlp in dec.output_hypernetworks_mlps:
            mlp.layers[-1].bias.zero_()
    return model


def sam_prompt_on_cpu(model, raw_path: str, point) -> dict:
    """A session's SAM prompt computed directly: ``SamPredictor`` on the CPU
    on the prompted section of ``raw_path`` at the world-unit ``point``,
    the logits of the multimask output of highest IOU (the session's
    choice)."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.models.sam import SamPredictor

    raw = open_ds(raw_path)
    z, y, x = (int((p - o) // v) for p, o, v in zip(point, raw.offset, raw.voxel_size))
    pred = SamPredictor(model, device="cpu").set_image(raw.to_ndarray()[z])
    logits, iou = pred.predict([[x, y]], [1], return_logits=True)
    best = 1 + int(np.argmax(iou[1:]))
    return {"z": z, "logits": logits[best], "token": best}


def write_proofread_volume(work: str, shape, seed: int, device) -> dict:
    """A raw volume (blocks of 128 voxels a side at several grey levels,
    dark seams between them, noise) and its uint8 affinities."""
    import torch

    from bootstrapper_torch.core.arrays import prepare_ds
    from bootstrapper_torch.ops.affinities import seg_to_affs

    rng = np.random.default_rng(seed)
    z, y, x = shape
    ids = (np.arange(y)[:, None] // 128) * (x // 128 + 1) + np.arange(x)[None, :] // 128 + 1
    labels = np.broadcast_to(ids, shape).copy()
    raw = rng.integers(60, 200, labels.max() + 1).astype(np.float32)[labels]
    raw[:, (np.arange(y) % 128) < 2] = 10
    raw[:, :, (np.arange(x) % 128) < 2] = 10
    raw = np.clip(raw + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)
    vs = (40, 4, 4)
    rds = prepare_ds(os.path.join(work, "pr.zarr", "raw"), shape, (0, 0, 0), vs, np.uint8)
    rds[rds.roi] = raw
    nbh = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    seg = torch.from_numpy(labels.astype(np.int64)).to(device)
    seg[:, (torch.arange(y, device=device) % 128) < 2] = 0
    seg[:, :, (torch.arange(x, device=device) % 128) < 2] = 0
    affs = (seg_to_affs(seg, nbh, torch.uint8) * 255).cpu().numpy()
    ads = prepare_ds(os.path.join(work, "pr.zarr", "affs"), affs.shape, (0, 0, 0), vs, np.uint8)
    ads[ads.roi] = affs
    return {"raw": rds.path, "affs": ads.path, "voxel_size": vs}


def run_cli(argv) -> tuple:
    """``bs-torch <argv>`` in this process: ``(exit code, its output)``."""
    import io

    from bootstrapper_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def sam_card_vs_cpu(seed: int) -> dict:
    """SAM at vit_b width, the encoder cut to a windowed and a global
    block, on the card and on the CPU from the same weights, in fp32 with
    TF32 off: embedding, mask logits and IOU each within SAM_RTOL of its
    largest magnitude."""
    import copy
    import dataclasses

    import torch

    from bootstrapper_torch.models.sam import PRESETS

    cfg = dataclasses.replace(PRESETS["vit_b"], encoder_depth=2, global_attn_indexes=(1,))
    card = random_sam(cfg, seed, "cuda")
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    pts = np.array([[[300.0, 500.0], [700.0, 200.0]]], np.float32)
    lab = np.array([[1, 0]])
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        outs = {}
        for name, m, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
            with torch.no_grad():
                emb = m.image_encoder(torch.from_numpy(x).to(dev))
                sparse, dense = m.prompt_encoder(torch.from_numpy(pts).to(dev), torch.from_numpy(lab).to(dev))
                masks, iou = m.mask_decoder(emb, m.prompt_encoder.dense_pe(64), sparse, dense)
            outs[name] = {"embedding": emb.cpu(), "mask_logits": masks.cpu(), "iou": iou.cpu()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    errs = {k: float((outs["card"][k] - outs["cpu"][k]).abs().max()) for k in outs["cpu"]}
    scale = {k: float(outs["cpu"][k].abs().max()) for k in outs["cpu"]}
    if not all(errs[k] <= SAM_RTOL * scale[k] for k in errs):
        raise AssertionError(f"SAM on the card against the CPU: max |err| {errs} (scale {scale}, rtol {SAM_RTOL})")
    return {"config": "vit_b width, blocks (windowed, global)", "max_abs_err": errs, "max_abs": scale,
            "rtol": SAM_RTOL, "tf32": False}


def sam_timings(seed: int) -> dict:
    """On the card from in-memory random weights: vit_b's ``set_image`` on a
    1024x1024 section and one ``predict``, and the encoder of SAM_TIMED's
    variants once each, with peak memory."""
    import torch

    from bootstrapper_torch.models.sam import PRESETS, SamPredictor

    out = {}
    img = np.random.default_rng(seed).integers(0, 255, (1024, 1024)).astype(np.uint8)
    for name in ("vit_b",) + SAM_TIMED:
        model = random_sam(PRESETS[name], seed, "cuda")
        pred = SamPredictor(model, device="cuda")
        pred.set_image(img)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred.set_image(img)
        torch.cuda.synchronize()
        row = {"set_image_ms": (time.perf_counter() - t0) * 1e3,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
        if name == "vit_b":
            pred.predict([[500, 400]], [1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks, iou = pred.predict([[500, 400]], [1])
            row["predict_ms"] = (time.perf_counter() - t0) * 1e3
            if masks.shape != (4, 1024, 1024) or not np.isfinite(iou).all():
                raise AssertionError(f"SAM predict: masks {masks.shape}, iou {iou}")
        out[name] = row
        del model, pred
        torch.cuda.empty_cache()
    return out


PROOFREAD_SCRIPT = (
    "point 80 260 300\npoint 80 700 640\nmerge 1 2\nunmerge 1\npoint 120 900 150\nomit 3\nfilter 50\n"
    "write {out}\nquit\n"
)
# the SAM session's first prompt, held against SAM on the CPU
FIRST_PROMPT = (80, 260, 300)


def proofread_phase(work: str, seed: int, device="cuda") -> dict:
    """``bs-torch proofread --script`` over PROOFREAD_VOLUME, once with a
    vit_b checkpoint written under the official keys (``session_sam``,
    ``torch.save``) and once on the affinities alone: point, merge,
    unmerge, omit, filter, write; no command may be refused, and the
    written Zarrs must read back with a segment in them.  A session of the
    first prompt alone (fp32, TF32 off) writes SAM's mask on the card,
    held against SAM on the CPU from the same weights: equal wherever the
    CPU's logit is beyond SAM_RTOL of its largest magnitude.  Then SAM on
    the card against the CPU, SAM's timings, and ``bs-torch view`` on a
    written container."""
    from bootstrapper_torch.core.arrays import open_ds

    import torch

    t_phase = time.perf_counter()
    vol = write_proofread_volume(work, PROOFREAD_VOLUME, seed, device)
    ckpt = os.path.join(work, "sam_vit_b_random.pth")
    model = session_sam(seed)
    torch.save(model.state_dict(), ckpt)
    out = {"volume": list(PROOFREAD_VOLUME), "checkpoint_mib": os.path.getsize(ckpt) / 2**20}
    written = {}
    with ThreadPoolExecutor(1) as pool:  # the CPU's prompt while the card runs the sessions
        on_cpu = pool.submit(sam_prompt_on_cpu, model, vol["raw"], FIRST_PROMPT)
        sessions = (
            ("sam", ["--sam-checkpoint", ckpt], PROOFREAD_SCRIPT),
            ("affinities", [], PROOFREAD_SCRIPT),
            ("sam_first_prompt", ["--sam-checkpoint", ckpt], "point {} {} {}\nwrite {{out}}\nquit\n".format(*FIRST_PROMPT)),
        )
        for name, extra, script_text in sessions:
            dest = os.path.join(work, f"proofread_{name}.zarr")
            script = os.path.join(work, f"{name}.txt")
            with open(script, "w") as f:
                f.write(script_text.format(out=dest))
            t0 = time.perf_counter()
            with fp32_exact() if name == "sam_first_prompt" else contextlib.nullcontext():
                rc, text = run_cli(["--device", device, "proofread", vol["raw"], "-a", vol["affs"], "--script", script,
                                    *extra])
            labels = written[name] = open_ds(os.path.join(dest, "proofread", "labels")).to_ndarray()
            mask = open_ds(os.path.join(dest, "proofread", "mask")).to_ndarray()
            refused = [line for line in text.splitlines() if "bad command" in line or "unknown command" in line]
            ok = (
                rc == 0 and not refused and ("(SAM)" in text) == (name != "affinities")
                and labels.shape == mask.shape == PROOFREAD_VOLUME and labels.dtype == np.uint64
                and mask.dtype == np.uint8 and (labels > 0).any()
            )
            out[name] = {
                "seconds": time.perf_counter() - t0, "exit_code": rc, "lines": text.strip().splitlines()[-8:],
                "refused": refused, "segments": int(len(np.unique(labels[labels > 0]))),
                "labelled_share": float((labels > 0).mean()), "mask_share": float(mask.mean()),
            }
            if not ok:
                raise AssertionError(f"proofread ({name}): {out[name]}")
        ref = on_cpu.result()
    del model
    z, logits, labels = ref["z"], ref["logits"], written["sam_first_prompt"]
    margin = SAM_RTOL * float(np.abs(logits).max())
    got = labels[z] == 1
    differ = got != (logits > 0)
    out["sam_first_prompt"].update({
        "section": z, "token": ref["token"], "cpu_mask_share": float((logits > 0).mean()),
        "differing_pixels": int(differ.sum()), "margin": margin,
        "differing_beyond_margin": int((differ & (np.abs(logits) > margin)).sum()),
    })
    if (
        out["sam_first_prompt"]["differing_beyond_margin"] or set(np.unique(labels).tolist()) != {0, 1}
        or (labels[np.arange(labels.shape[0]) != z] != 0).any()
    ):
        raise AssertionError(f"proofread: the SAM session's first segment against SAM on the CPU: {out['sam_first_prompt']}")
    out["sam_card_vs_cpu"] = sam_card_vs_cpu(seed)
    out["sam_timings"] = sam_timings(seed)
    rc, text = run_cli(["--device", device, "view", os.path.join(work, "proofread_sam.zarr")])
    if rc != 0 or "proofread/labels: shape=" not in text:
        raise AssertionError(f"view: exit {rc}: {text[-500:]}")
    out["view_lines"] = text.strip().splitlines()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def merge_launches(rows: list, groups, seed: int) -> int:
    """Adds each group's K1 launches to the row of its conv; a conv no row
    holds yet is held against its plain version (``check_conv``, the
    group's traced case of it) and added as a row.  Returns the launches
    added."""
    index = {(tuple(r["x"]), tuple(r["w"])): r for r in rows}
    total = 0
    for group in groups:
        for key, n in group["by_conv"].items():
            if key not in index:
                case = next((c for c in group["cases"] if conv_key(c) == key), None)
                if case is None:
                    raise AssertionError(f"K1 launched at {key}, which no traced conv of its stage has")
                (row,) = check_conv(seed, [case], fp32=False)
                row["launches"] = 0
                rows.append(row)
                index[key] = row
            index[key]["launches"] += n
            total += n
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    # the package beside this script; an ImportError ends the run here
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bootstrapper_torch import native
    from bootstrapper_torch.__main__ import doctor
    from bootstrapper_torch.configs import pretrained_dir
    from bootstrapper_torch.models import Model, init_params_numpy, load_params
    from bootstrapper_torch.models.zoo import get_net_config
    from bootstrapper_torch.ops import _build, launch_counts
    from bootstrapper_torch.ops import conv3d as conv3d_ops
    from bootstrapper_torch.ops import quant as quant_ops
    from bootstrapper_torch.predict.zstream import plan_stream

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    # the kernels (one nvcc each) and the host watershed/agglomeration
    # library (g++) build while the doctor starts the card up
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        built = pool.submit(lambda: (_build.build_all(), time.perf_counter() - t0)[1])
        host = pool.submit(native.get_lib)
        smi = nvidia_smi()
        emit({"phase": "doctor", **doctor(), "nvidia_smi": smi})
        kernels_s = built.result()
        host.result()
    instantiations = conv3d_ops.kernel_info()
    qconv_instantiations = quant_ops.kernel_info()
    emit(
        {
            "phase": "build", "kernels_seconds": kernels_s,
            "seconds": time.perf_counter() - t0, "sources": list(_build.SOURCES),
            "conv3d_instantiations": instantiations,
            "qconv3d_instantiations": qconv_instantiations,
            "compiler_warnings": [
                line for log in _build.LOGS.values() for line in log.splitlines()
                if "warning" in line.lower()
            ][:20],
        }
    )
    spilled = [k for k in instantiations if k["dtype"] == "bf16" and k["local_bytes"]]
    spilled += [k for k in qconv_instantiations if k["local_bytes"]]
    if spilled:
        raise AssertionError(f"a conv kernel spills registers: {spilled}")

    conv_rows = check_conv(args.seed)
    seed_rows = check_seeds(args.seed)

    net_config = get_net_config("3d_affs")
    params = init_params_numpy(net_config, args.seed)
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_") as work:
        main_path = run_main_path(
            work, net_config, params, (8, 640, 640), args.seed, "cuda"
        )
    affs = main_path.pop("affs")
    main_path.pop("qconv_launches")  # int8 is off here: empty
    by_conv = main_path.pop("conv_launches")  # counted where the kernel launches
    for row in conv_rows:
        row["launches"] = by_conv.pop((tuple(row["x"]), tuple(row["w"])), 0)
    emit(
        {
            "phase": "main_path", **main_path,
            "conv_launches": {r["shape"]: r["launches"] for r in conv_rows},
        }
    )
    conv_launches = main_path["predict_launches"]["conv3d.kernel"]
    seed_launches = main_path["segment_launches"]["seed_maxima.kernel"]
    # every tile launches the kernel once at each bf16 shape of conv_cases,
    # at no other shape, and never on the fp32 route
    tiles = main_path["tiles"]
    off_plan = by_conv or [
        r["shape"] for r in conv_rows
        if r["launches"] != (tiles if r["dtype"] == "bf16" else 0)
    ]
    want_conv = tiles * len(conv_cases())
    if tiles != 8 or conv_launches != want_conv or off_plan or seed_launches == 0:
        raise AssertionError(
            f"main path: {tiles} tiles, conv kernel launches {conv_launches} "
            f"(not one per tile at {off_plan}), seed kernel launches {seed_launches}"
        )

    # the streamed path: a deep volume, run_prediction's default route
    zs = zstream_phase(net_config, params, ZSTREAM_SHAPE, args.seed)
    plan = zs.pop("plan")
    # a steady step takes step_z new slices at the stream tile's xy
    step_tile = [plan["step_z"], *plan["input_tile"][1:]]
    stream_cases = stream_conv_cases(net_config, step_tile, plan["warm_step_z"])
    stream_rows = check_conv(args.seed, stream_cases, fp32=False)
    # one launch per step at each of the step's kernel convs: the warm
    # step's once per column, the steady step's once per later step
    columns, steps = plan["columns"], plan["steps_per_column"]
    by_stream = zs.pop("conv_launches")
    zs.pop("qconv_launches")
    stream_affs = zs.pop("stream_affs")
    for row in stream_rows:
        row["launches"] = by_stream.pop((tuple(row["x"]), tuple(row["w"])), 0)
    want = {
        r["shape"]: columns if r["shape"].startswith("warm_") else columns * (steps - 1)
        for r in stream_rows
    }
    off_plan = by_stream or [r["shape"] for r in stream_rows if r["launches"] != want[r["shape"]]]
    stream_conv = zs["predict_launches"]["conv3d.kernel"]
    stream_seed = zs["segment_launches"]["seed_maxima.kernel"]
    emit(
        {
            "phase": "zstream", "volume": list(ZSTREAM_SHAPE), "plan": plan, **zs,
            "conv_launches": {r["shape"]: r["launches"] for r in stream_rows},
            "flops_per_output_voxel": {
                "tiled": per_voxel(tile_flops(net_config, TILED_INPUT)),
                "steady": stream_step_flops(net_config, step_tile)["per_output_voxel"],
            },
        }
    )
    if stream_conv != len(conv_cases()) * columns * steps or off_plan or stream_seed == 0:
        raise AssertionError(
            f"zstream: conv kernel launches {stream_conv} over {columns} columns x {steps} "
            f"steps (off plan: {off_plan}), seed kernel launches {stream_seed}"
        )
    # the steady step at the plan's tile, and the memory and throughput
    # sweep behind the planner's default budget
    model = load_params(Model(net_config), params)
    inc, s_wide, _ = plan_stream(net_config, (10_000, 20_000, 20_000), device="cuda")
    widest = [s_wide, net_config["input_shape"][1] + inc[1], net_config["input_shape"][2] + inc[2]]
    sweep = [list(t) for t in ZSTREAM_SWEEP] + [widest]
    for tile in [step_tile] + [t for t in sweep if t != step_tile]:
        emit(
            {
                "phase": "zstream_step", "plan": list(tile) == step_tile,
                **stream_step_profile(model, tile, plan["warm_step_z"], args.seed),
            }
        )
    del model

    for shape in [(8, 640, 640), (125, 1250, 1250)]:
        emit({"phase": "seed_call", **time_seed_call(args.seed, shape)})

    emit({"phase": "reference", **check_reference(net_config, params, affs, args.seed)})
    emit({"phase": "tile_breakdown", **tile_breakdown(net_config, params, args.seed)})
    train, train_rows = train_phase(
        args.seed, net_config, TRAIN_VOLUME, TRAIN_ITERATIONS, OVERFIT_STEPS, TIMED_STEPS, TRAIN_PREDICT_ROI
    )
    emit(
        {
            "phase": "train", "nvidia_smi": smi, **train,
            "conv_launches": {r["shape"]: r["launches"] for r in train_rows},
        }
    )
    # one whole round through the entry points, round 2 on round 1's pseudo-GT
    round_line, round_rows, round_seed_rows = round_phase(
        args.seed, net_config, TRAIN_VOLUME, ROUND_ITERATIONS, train_conv_keys(net_config)
    )
    by_train = round_line.pop("train_conv_launches")
    emit(
        {
            "phase": "round", "nvidia_smi": smi, **round_line,
            "conv_launches_by_shape": {r["shape"]: r["launches"] for r in round_rows},
        }
    )
    for row in train_rows:  # the round trains at the same eleven shapes
        row["launches"] += by_train[(tuple(row["x"]), tuple(row["w"]))]

    # the LSD setups: LSDs on the card, a 3d_mtlsd round scored by LSD
    # errors, and the chain 3d_lsd -> 3d_affs_from_3d_lsd with the shipped
    # refiner, both on a Voronoi sample of TRAIN_VOLUME
    lsd = lsd_phase(args.seed)
    emit({"phase": "lsd", "nvidia_smi": smi, **lsd})
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_lsd_") as work:
        volumes = write_round_sample(work, TRAIN_VOLUME, args.seed, "cuda")
        mtlsd, mtlsd_groups = mtlsd_round_phase(
            work, volumes, args.seed, get_net_config("3d_mtlsd"), MTLSD_ITERATIONS, TIMED_STEPS
        )
        mtlsd["lsd_targets_share_of_transform"] = (
            lsd["train_crop"]["ms"] / mtlsd["step"]["device_ms_by_part"]["transform"]
        )
        emit({"phase": "mtlsd_round", "nvidia_smi": smi, **mtlsd})
        chain, chain_groups = chain_phase(work, volumes, args.seed, get_net_config("3d_lsd"), CHAIN_ITERATIONS)
        emit({"phase": "chain", "nvidia_smi": smi, **chain})
        # the 2D chain: 2d_mtlsd -> 3d_affs_from_2d_mtlsd, the shipped refiner
        chain2d, chain2d_groups = chain2d_phase(
            work, volumes, args.seed, get_net_config("2d_mtlsd"), CHAIN2D_ITERATIONS, TIMED_STEPS
        )
        emit({"phase": "chain2d", "nvidia_smi": smi, **chain2d})
        # the refiners' synthetic training, the retrained refiner through
        # predict, mws / cc / ws segment and evaluate on the same sample
        synth, synth_groups = synth_phase(
            work, volumes, args.seed, {name: os.path.join(pretrained_dir(), name) for name, _, _ in SYNTH_FORWARD},
            SYNTH_ITERATIONS, TIMED_STEPS,
        )
        emit({"phase": "synth", "nvidia_smi": smi, **synth})
        # blockwise segmentation: ws at the CREMI sample size, K2 once per
        # block; mws, cc and sharded ws on the synth phase's affinities
        blockwise = blockwise_phase(work, volumes, synth, args.seed)
        emit({"phase": "blockwise", "nvidia_smi": smi, **blockwise})
    # the command line: prepare round in a subprocess, then run the round
    # in this process through its main, and predict --auto-tile
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_cli_") as work:
        cli, cli_groups = cli_phase(work, args.seed, net_config, TRAIN_VOLUME, CLI_ITERATIONS)
    emit({"phase": "cli", "nvidia_smi": smi, **cli})
    # multi-device prediction and mesh training on two logical devices of
    # this card: each path against its one-device counterpart
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_multi_") as work:
        multi, multi_groups = multi_phase(
            work, args.seed, net_config, get_net_config("2d_mtlsd"), TRAIN_VOLUME, MULTI_DEVICES
        )
    emit({"phase": "multi", **multi})
    # int8 inference: K4 at every conv of a tile, then the tiled and the
    # streamed main path under BS_INT8=1 against their bf16 runs
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_int8_") as work:
        int8, qconv_rows = int8_phase(work, net_config, params, args.seed, {"tiled": affs, "stream": stream_affs})
    del stream_affs
    emit({"phase": "int8", "nvidia_smi": smi, **int8})
    # SAM and proofreading through the command line, SAM card vs CPU, timings
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_proofread_") as work:
        proofread = proofread_phase(work, args.seed)
    emit({"phase": "proofread", "nvidia_smi": smi, **proofread})
    # the stream against the tiled path at its own xy tile, and the share of
    # voxels that differ from the zoo-tiled path, seams included
    vs_tiled, vs_zoo = zs["vs_tiled"], zs["vs_zoo_tiled"]
    if (
        vs_tiled["max_abs_diff"] > ZSTREAM_MAX_DIFF
        or vs_tiled["differing_share"] >= ZSTREAM_MAX_SHARE
        or vs_zoo["differing_share"] >= ZSTREAM_MAX_SHARE
    ):
        raise AssertionError(f"streamed affinities differ from the tiled ones: {vs_tiled}, {vs_zoo}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "counts_now": launch_counts()})

    conv_rows += stream_rows + train_rows + round_rows
    conv_launches += (
        stream_conv + train["round"]["train_launches"]["conv3d.kernel"]
        + sum(round_line["conv_launches"].values())
    )
    # the LSD phases' launches, on the rows of their convs (new convs, the
    # refiner's, held against plain here)
    conv_launches += merge_launches(
        conv_rows, mtlsd_groups + chain_groups + chain2d_groups + synth_groups + cli_groups + multi_groups, args.seed
    )
    # their segments run K2 at the round's (64,512,512) stack, as the
    # command line's round does
    lsd_seed_launches = (
        mtlsd["seed_launches"] + chain["seed_launches"] + chain2d["seed_launches"] + synth["seed_launches"]
        + cli["seed_launches"]
    )
    round_seed_rows[0]["launches"] += lsd_seed_launches
    # the blockwise phase's, on the row of its block shape
    next(r for r in seed_rows if r["shape"] == "block_36x320x320_size10")["launches"] = blockwise["seed_launches"]
    seed_launches += (
        stream_seed + sum(round_line["seed_launches"].values()) + lsd_seed_launches + blockwise["seed_launches"]
    )
    seed_rows += round_seed_rows
    top_conv = max(conv_rows, key=lambda r: r["ms"] * r["launches"])
    top_qconv = max(qconv_rows[: int8["convs_per_tile"]], key=lambda r: r["ms"])
    top_seed = seed_rows[0]
    kernels = [
        {
            "name": "conv3d",
            "route": "cuda",
            "source": "bootstrapper_torch/csrc/conv3d.cu",
            "replaces": f"{_JAX_PKG}/ops/pallas_conv.py:205",
            "launches": conv_launches,
            "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
            **{k: top_conv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "at": top_conv["shape"],
            "shapes": conv_rows,
        },
        {
            "name": "seed_maxima_3d",
            "route": "cuda",
            "source": "bootstrapper_torch/csrc/seed_maxima.cu",
            "replaces": f"{_JAX_PKG}/ops/pallas_kernels.py:111",
            "also_replaces": f"{_JAX_PKG}/ops/pallas_kernels.py:86",
            "launches": seed_launches,
            "max_abs_err": 0.0,
            **{k: top_seed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "at": top_seed["shape"],
            "shapes": seed_rows,
        },
        {
            "name": "qconv3d",
            "route": "cuda",
            "source": "bootstrapper_torch/csrc/qconv3d.cu",
            "replaces": f"{_JAX_PKG}/ops/quant.py:58",
            "launches": int8["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in qconv_rows),
            **{k: top_qconv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_ms_of")},
            "at": top_qconv["shape"],
            "tile_ms": int8["tile_ms"],
            "shapes": qconv_rows,
        },
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
