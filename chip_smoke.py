#!/usr/bin/env python3
"""Drive bootstrapper_torch on one NVIDIA GPU (an H100) and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

(a) doctor: torch/CUDA versions, the device, nvcc; the kernels are built
    from ``bootstrapper_torch/csrc`` (one nvcc per source, in parallel);
(b) every kernel against its plain PyTorch version on the card, at the
    shapes the main path gives it: the conv kernel (K1) at four U-Net
    shapes in bf16, the seed kernel (K2, and K3 as its Z=1 case)
    bit-exact.  Each with its time, the plain version's, the library
    call's where one exists, and the least time the card could take;
(c) the main path through the user entry points: a synthetic uint8 raw
    volume (made from --seed) as an uncompressed Zarr, the full-width
    3d_affs setup with numpy-seeded weights saved as a checkpoint,
    ``run_prediction`` over 2x2x2 output tiles (8, 640, 640) in bf16, then
    ``run_segmentation`` in ws mode.  Launch counts are zeroed just before
    each entry point and read just after; both kernels must have run;
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


def bound(flops: float, peak_flops: float, nbytes: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- (b) kernels against their plain versions ------------------------------


def conv_cases():
    """Main-path conv shapes (full-width 3d_affs, (32,412,412) input
    tile): name, input shape, crop of it, weight shape, with bias.  None
    fuses a ReLU, so each computes what one F.conv3d call computes."""
    return [
        # level-2 encoder conv, 300 -> 300, 3x3x3 (the pass's last conv)
        ("enc2_300to300_k3", (1, 22, 98, 98, 300), None, (3, 3, 3, 300, 300), True),
        # level-1 decoder conv: the upsampled 300-channel part of its
        # 360-channel input (the bias rides on the 60-channel part)
        ("dec1_part300to60_k3", (1, 12, 168, 168, 300), None, (3, 3, 3, 300, 60), False),
        # level-2 decoder residual: the 1500-channel part, 1x1, applied to
        # the centre crop (a strided view) of the (16,88,88) input
        ("dec2_res_part1500to300_k1", (1, 16, 88, 88, 1500), (12, 84, 84), (1, 1, 1, 1500, 300), False),
        # level-3 encoder conv, 1500 -> 1500, 3x3x3: the most operations
        ("enc3_1500to1500_k3", (1, 18, 46, 46, 1500), None, (3, 3, 3, 1500, 1500), True),
    ]


def check_conv(seed: int) -> list:
    import torch
    import torch.nn.functional as F

    from bootstrapper_torch.models.unet import center_crop
    from bootstrapper_torch.ops import conv3d as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, xs, crop, ws, with_bias in conv_cases():
        x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16)
        if crop is not None:
            x = center_crop(x, crop)
        fan_in = ws[0] * ws[1] * ws[2] * ws[3]
        w = (torch.randn(ws, generator=gen, device="cuda") / fan_in**0.5).to(torch.bfloat16)
        b = torch.randn(ws[-1], generator=gen, device="cuda").to(torch.bfloat16) if with_bias else None
        got = C.conv3d_cuda(x, w, b)
        ref = C.conv3d_plain(x, w, b)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= CONV_ATOL + CONV_RTOL * ref.float().abs()).all())
        if not ok:
            raise AssertionError(f"conv kernel {name}: max |err| {err} outside tolerance")
        xp = x.permute(0, 4, 1, 2, 3)
        wp = w.permute(4, 3, 0, 1, 2).contiguous()
        ms = cuda_time_ms(lambda: C.conv3d_cuda(x, w, b))
        plain_ms = cuda_time_ms(lambda: C.conv3d_plain(x, w, b), iters=3)
        library_ms = cuda_time_ms(lambda: F.conv3d(xp, wp, b))
        out_vox = got.numel() // ws[-1]
        flops = 2.0 * out_vox * ws[-1] * fan_in
        nbytes = 2.0 * (x.numel() + w.numel() + got.numel()) + (
            0 if b is None else 2.0 * b.numel()
        )
        bound_ms, bound_by = bound(flops, PEAK_BF16, nbytes)
        rows.append(
            {
                "shape": name, "x": list(x.shape), "w": list(ws), "dtype": "bf16",
                "max_abs_err": err, "rtol": CONV_RTOL, "atol": CONV_ATOL,
                "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flops / ms / 1e9,
            }
        )
        emit({"phase": "kernel_check", "kernel": "conv3d", **rows[-1]})
    return rows


def check_seeds(seed: int) -> list:
    import torch

    from bootstrapper_torch.ops import seeds as S

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, shape, size in [
        ("stack_8x640x640_size10", (8, 640, 640), 10),
        ("stack_8x640x640_size7", (8, 640, 640), 7),
        ("section_640x640_size10", (1, 640, 640), 10),
    ]:
        dist = torch.rand(shape, generator=gen, device="cuda")
        dist[:, ::9, ::7] = 0.5  # plateaus: ties must compare equal
        mask = torch.rand(shape, generator=gen, device="cuda") > 0.3
        if shape[0] == 1:  # K3: the single-section entry point
            run = lambda: S.seed_maxima(dist[0], mask[0], size)[None]  # noqa: E731
        else:
            run = lambda: S.seed_maxima_3d(dist, mask, size)  # noqa: E731
        got = run()
        ref = S.seed_maxima_plain(dist, mask, size)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        if mismatches:
            raise AssertionError(f"seed kernel {name}: {mismatches} voxels differ")
        ms = cuda_time_ms(run)
        plain_ms = cuda_time_ms(lambda: S.seed_maxima_plain(dist, mask, size), iters=3)
        n = dist.numel()
        # fp32 in, bool mask in, uint8 out; 2*(size-1) maxes + 1 compare
        bound_ms, bound_by = bound(n * (2.0 * (size - 1) + 1), PEAK_FP32, n * 6.0)
        rows.append(
            {
                "shape": name, "dist": list(shape), "size": size,
                "max_abs_err": 0.0, "mismatches": mismatches,
                "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
        )
        emit({"phase": "kernel_check", "kernel": "seed_maxima", **rows[-1]})
    return rows


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
    from bootstrapper_torch.ops import launch_counts, reset_launch_counts
    from bootstrapper_torch.workflows import run_prediction, run_segmentation

    paths = write_inputs(work, net_config, params, raw_shape, seed)

    reset_launch_counts()
    stats = run_prediction(paths["predict_toml"], device=device)
    predict_counts = launch_counts()
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()  # after the profiler's start-up
        pred.forward(x)
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
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
    emit(
        {
            "phase": "build", "kernels_seconds": kernels_s,
            "seconds": time.perf_counter() - t0, "sources": list(_build.SOURCES),
        }
    )

    conv_rows = check_conv(args.seed)
    seed_rows = check_seeds(args.seed)

    net_config = get_net_config("3d_affs")
    params = init_params_numpy(net_config, args.seed)
    with tempfile.TemporaryDirectory(prefix="bs_chip_smoke_") as work:
        main_path = run_main_path(
            work, net_config, params, (8, 640, 640), args.seed, "cuda"
        )
    affs = main_path.pop("affs")
    emit({"phase": "main_path", **main_path})
    conv_launches = main_path["predict_launches"]["conv3d.kernel"]
    seed_launches = main_path["segment_launches"]["seed_maxima.kernel"]
    if main_path["tiles"] != 8 or conv_launches == 0 or seed_launches == 0:
        raise AssertionError(
            f"main path: {main_path['tiles']} tiles, conv kernel launches "
            f"{conv_launches}, seed kernel launches {seed_launches}"
        )

    emit({"phase": "reference", **check_reference(net_config, params, affs, args.seed)})
    emit({"phase": "tile_breakdown", **tile_breakdown(net_config, params, args.seed)})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "counts_now": launch_counts()})

    top_conv, top_seed = conv_rows[0], seed_rows[0]
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
