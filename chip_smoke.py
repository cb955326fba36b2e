#!/usr/bin/env python3
"""Drive bootstrapper_torch on one NVIDIA GPU (an H100) and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

(a) doctor: torch/CUDA versions, the device, nvcc; the kernels are built
    from ``bootstrapper_torch/csrc`` (one nvcc per source, in parallel),
    and each conv kernel instantiation reports its registers, shared
    memory and spill bytes;
(b) every kernel against its plain PyTorch version on the card, at the
    shapes the main path gives it: the conv kernel (K1) at all eleven
    U-Net shapes of one tile in bf16 (the wgmma kernel) and at one shape
    in fp32 (the FMA kernel), the seed kernel (K2, and K3 as its Z=1
    case) bit-exact, also on a CREMI-sized stack and with a window of 33
    (the kernel's general body), with the copy width and body each launch
    took.  Each with its device time (profiler device events, not the
    Python call), the plain version's, the library call's where one
    exists, and the least time the card could take;
(c) the main path through the user entry points: a synthetic uint8 raw
    volume (made from --seed) as an uncompressed Zarr, the full-width
    3d_affs setup with numpy-seeded weights saved as a checkpoint,
    ``run_prediction`` over 2x2x2 output tiles (8, 640, 640) in bf16, then
    ``run_segmentation`` in ws mode.  Launch counts are zeroed just before
    each entry point and read just after; both kernels must have run,
    the conv kernel once per tile at each of its eleven shapes.  Then what
    the segmentation pays around the seed kernel: ``device_seed_maxima``
    (upload, kernel, download) timed at two stack sizes;
(d) reference checks on a small input: the forward on the card (fp32 and
    bf16) against the CPU fp32 forward, and the segmentation with seeds
    on the card against the CPU path; then one full-size tile forward
    under ``torch.profiler``, its device time grouped by kernel.

Then the card's name and power limit as nvidia-smi reports them, the
``kernels`` line, and last ``{"ok": true, "device": {...}}``.  Any failure
raises: the script exits non-zero and prints no result.  It needs a CUDA
device and the bootstrapper_torch package beside it.
"""

from __future__ import annotations

import argparse
import json
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int = 10) -> float:
    """Mean time the device spends in the kernels and copies of ``fn``, from
    ``torch.profiler`` device events over ``iters`` calls after one
    warm-up call; the host's time to enqueue them is not in it.  Raises
    where the profiler saw no device event in three tries."""
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


def check_conv(seed: int) -> list:
    import torch
    import torch.nn.functional as F

    from bootstrapper_torch.ops import conv3d as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, xs, crop, ws, with_bias in conv_cases():
        x, w, b = conv_inputs(gen, xs, crop, ws, with_bias, torch.bfloat16)
        packed = C.pack_weights(w, x.dtype)  # once, as the U-Net keeps it
        got = C.conv3d_cuda(x, w, b, packed=packed)
        ref = C.conv3d_plain(x, w, b)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= CONV_ATOL + CONV_RTOL * ref.float().abs()).all())
        if not ok:
            raise AssertionError(f"conv kernel {name}: max |err| {err} outside tolerance")
        xp = x.contiguous().permute(0, 4, 1, 2, 3)  # dense, for the library
        wp = w.permute(4, 3, 0, 1, 2).contiguous()
        ms = device_time_ms(lambda: C.conv3d_cuda(x, w, b, packed=packed))
        plain_ms = device_time_ms(lambda: C.conv3d_plain(x, w, b), iters=2)
        library_ms = device_time_ms(lambda: F.conv3d(xp, wp, b))
        flops, nbytes = conv_work(x, w, b, got)
        bound_ms, bound_by = bound(flops, PEAK_BF16, nbytes)
        plan = C.tile_plan(ws[3], ws[4])
        rows.append(
            {
                "shape": name, "x": list(x.shape), "w": list(ws), "dtype": "bf16",
                "tile": [plan.bm, plan.bn], "stages": plan.stages,
                "copy_bytes": C._copy_bytes(x),
                "max_abs_err": err, "rtol": CONV_RTOL, "atol": CONV_ATOL,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flops / ms / 1e9, "gbytes_per_s": nbytes / ms / 1e6,
            }
        )
        emit({"phase": "kernel_check", "kernel": "conv3d", **rows[-1]})
        del x, w, b, packed, got, ref, diff, xp, wp
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


def check_seeds(seed: int) -> list:
    import torch

    from bootstrapper_torch.ops import seeds as S

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, shape, size in [
        ("stack_8x640x640_size10", (8, 640, 640), 10),
        ("stack_8x640x640_size7", (8, 640, 640), 7),
        ("section_640x640_size10", (1, 640, 640), 10),
        # a CREMI-sized stack: large enough that the time is the kernel's
        # and not a launch's
        ("stack_125x1250x1250_size10", (125, 1250, 1250), 10),
        # a window past the register body's 16: the general body
        ("stack_8x640x640_size33", (8, 640, 640), 33),
    ]:
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


def run_main_path(work: str, net_config: dict, params, raw_shape, seed: int, device) -> dict:
    """``run_prediction`` then ``run_segmentation`` with the launch counts
    zeroed just before each and read just after."""
    from bootstrapper_torch.core.arrays import open_ds
    from bootstrapper_torch.ops import (
        conv3d_kernel_launches, launch_counts, reset_launch_counts,
    )
    from bootstrapper_torch.workflows import run_prediction, run_segmentation

    paths = write_inputs(work, net_config, params, raw_shape, seed)

    reset_launch_counts()
    stats = run_prediction(paths["predict_toml"], device=device)
    predict_counts = launch_counts()
    conv_launches = conv3d_kernel_launches()
    (pstats,) = stats.values()

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
    n_chunks = sum(1 for f in os.listdir(affs.path) if not f.startswith("."))
    if n_chunks != pstats["tiles"]:
        raise AssertionError(f"{n_chunks} output chunks written for {pstats['tiles']} tiles")
    labels = {}
    for t, path in segs["vol"].items():
        seg = open_ds(path).to_ndarray()
        if seg.shape != tuple(raw_shape) or seg.dtype != np.uint64:
            raise AssertionError(f"segmentation {t}: {seg.shape} {seg.dtype}")
        labels[t] = int(len(np.unique(seg[seg != 0])))
    return {
        "tiles": pstats["tiles"],
        "predict_seconds": pstats["seconds"],
        "output_voxels_per_sec": pstats["voxels_per_sec"],
        "segment_seconds": seg_seconds,
        "affs_mean": float(a.mean()),
        "segments_per_threshold": labels,
        "predict_launches": predict_counts,
        "conv_launches": conv_launches,
        "segment_launches": segment_counts,
        "affs": a,
    }


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
    """Operations of one tile forward, by conv route, from the U-Net's
    shape algebra (2 per multiply-add; residuals on the cropped inputs)."""
    from bootstrapper_torch.models.model import head_dims, unet_config
    from bootstrapper_torch.ops.conv3d import conv3d_supported

    cfg = unet_config(net_config)
    nf, inc = cfg.num_fmaps, cfg.fmap_inc_factor
    flops = {"kernel": 0.0, "library": 0.0}

    def conv(shape, parts, co, k):
        out = [s - kk + 1 for s, kk in zip(shape, k)]
        for ci in parts:
            route = "kernel" if conv3d_supported((1, *shape, ci), (*k, ci, co)) else "library"
            flops[route] += 2.0 * np.prod(out) * ci * co * np.prod(k)
        return out

    def conv_pass(shape, parts, co, kernels):
        for i, k in enumerate(kernels):
            shape = conv(shape, parts if i == 0 else [co], co, k)
        conv(shape, parts, co, (1, 1, 1))  # residual, on the crop
        return shape

    def rec(level, shape):
        i = cfg.num_levels - level - 1
        ci = cfg.in_channels if i == 0 else nf * inc ** (i - 1)
        shape = conv_pass(shape, [ci], nf * inc**i, cfg.kernel_size_down[i])
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
    by_name = {}
    for ev in prof.events():  # device-side events only: kernels, copies
        if ev.device_type == torch.autograd.DeviceType.CUDA:
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
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flops = tile_flops(net_config, pred.input_tile)
    return {
        "input_tile": list(pred.input_tile),
        "flops_kernel_route": flops["kernel"],
        "flops_library_route": flops["library"],
        "flops_per_output_voxel": (flops["kernel"] + flops["library"]) / flops["output_voxels"],
        "wall_ms": wall_ms,
        "profiled_wall_ms": profiled_wall_ms,
        "device_ms": device_ms or None,
        # kernel time and wall time of the same (profiled) forward
        "idle_share": (1 - device_ms / profiled_wall_ms) if device_ms else None,
        "groups_ms": groups if device_ms else None,
        "top_kernels_ms": [[n[:120], ms] for n, ms in top],
        "peak_memory_gb": peak_gb,
        "weight_packs_in_profiled_forward": repacked,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    # the package beside this script; an ImportError ends the run here
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bootstrapper_torch import native
    from bootstrapper_torch.__main__ import doctor
    from bootstrapper_torch.models import init_params_numpy
    from bootstrapper_torch.models.zoo import get_net_config
    from bootstrapper_torch.ops import _build, launch_counts
    from bootstrapper_torch.ops import conv3d as conv3d_ops

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "doctor", **doctor(), "nvidia_smi": smi})

    t0 = time.perf_counter()
    _build.build_all()
    kernels_s = time.perf_counter() - t0
    native.get_lib()  # the host watershed/agglomeration library (g++)
    instantiations = conv3d_ops.kernel_info()
    emit(
        {
            "phase": "build", "kernels_seconds": kernels_s,
            "seconds": time.perf_counter() - t0, "sources": list(_build.SOURCES),
            "conv3d_instantiations": instantiations,
            "compiler_warnings": [
                line for log in _build.LOGS.values() for line in log.splitlines()
                if "warning" in line.lower()
            ][:20],
        }
    )
    spilled = [k for k in instantiations if k["dtype"] == "bf16" and k["local_bytes"]]
    if spilled:
        raise AssertionError(f"wgmma kernel spills registers: {spilled}")

    conv_rows = check_conv(args.seed)
    seed_rows = check_seeds(args.seed)

    net_config = get_net_config("3d_affs")
    params = init_params_numpy(net_config, args.seed)
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_") as work:
        main_path = run_main_path(
            work, net_config, params, (8, 640, 640), args.seed, "cuda"
        )
    affs = main_path.pop("affs")
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

    for shape in [(8, 640, 640), (125, 1250, 1250)]:
        emit({"phase": "seed_call", **time_seed_call(args.seed, shape)})

    emit({"phase": "reference", **check_reference(net_config, params, affs, args.seed)})
    emit({"phase": "tile_breakdown", **tile_breakdown(net_config, params, args.seed)})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "counts_now": launch_counts()})

    top_conv = max(conv_rows, key=lambda r: r["ms"] * r["launches"])
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
