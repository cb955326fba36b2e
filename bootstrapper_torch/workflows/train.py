"""Training workflow: TOML config -> training loop (the JAX package's
``workflows/train.py``).

The config is the JAX package's ``[train]`` table: ``setup_dir`` (with its
``net_config.json``), ``samples`` (``raw``/``labels``/``mask`` datasets),
optional ``artifact_samples``, ``voxel_size``, ``max_iterations``,
``save_checkpoints_every``, ``save_snapshots_every``, ``batch_size``,
``min_masked``, ``prob_artifact``, ``learning_rate``, ``seed``.  It keeps
the operational surface: ``model_checkpoint_{iter}`` files in the JAX
layout, auto-resume from the latest one, ``log/loss.jsonl`` every 10
iterations, snapshot Zarrs, a host RSS cap and a stall watchdog.

It trains the 3D and 2D image setups on ``samples`` (affinities, LSDs
or both; a 2D setup at batch 10 by default), and the ``_from_`` refiner
setups, or any config without ``samples``, on synthetic labels
(``pipeline/synthetic.py``; batch 1 and learning rate 1e-4 unless the
config sets them).  ``mesh = true`` (``bs-torch train --mesh``) over
more than one device shards the step over a ``(data, space)`` grid, one
process per device entry (``run_training``); the process group's backend
is NCCL where every entry is a distinct card, gloo where the entries are
CPUs or a card repeats.  Not ported, and raised as ``NotImplementedError``
where a config asks for it: TPU folding (``fold_xy = true``).  The JAX
package's fold probe, which turns
folding on for a batch of 8 or more where a TPU compile of it passes, is
TPU machinery: here a config without ``fold_xy`` trains unfolded at any
batch, with no probe.  ``BS_INT8=1`` is ignored here with a warning, as
the JAX package ignores it in training (int8 is inference-only there, and
the port's prediction refuses it until it is ported).
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import time

import numpy as np
import torch

from .. import resolve_devices
from ..core.arrays import open_ds, prepare_ds
from ..models.model import Model, unet_config
from ..models.zoo import get_net_config
from ..ops import conv3d_kernel_launches
from ..ops.quant import int8_enabled
from ..pipeline.synthetic import SyntheticTrainingPipeline
from ..pipeline.training import SetupSpec, TrainingPipeline
from ..train.loop import (
    MeshRank,
    broadcast_batch,
    broadcast_state,
    check_mesh_slabs,
    create_train_state,
    latest_checkpoint,
    load_checkpoint,
    make_mesh,
    make_train_step,
    save_checkpoint,
    shard_train_step,
    spawn_mesh,
)
from ..train.sampler import Sample
from ..utils import tomlio
from ..utils.stall import StallWatchdog

logger = logging.getLogger(__name__)


def _rss_gb() -> float:
    """Current host RSS in GB (0 when /proc is unavailable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return 0.0


def _start_watchdog():
    """The training loop's stall watchdog (``utils/stall.py``), unless
    ``BS_STALL_TIMEOUT_S`` is 0.  Training opts into respawn: it resumes
    from the last checkpoint, so replacing the process loses at most
    ``save_checkpoints_every`` iterations."""
    timeout_s = float(os.environ.get("BS_STALL_TIMEOUT_S", "900"))
    if timeout_s <= 0:
        return None
    return StallWatchdog(timeout_s, timeout_s, label="training", respawn=True).start()


def setup_train(config_file: str, **overrides) -> dict:
    """Load and validate a training config; apply keyword overrides (only
    real values count) and write them to ``*_modified.toml``."""
    cfg = tomlio.load(config_file)
    cfg = cfg.get("train", cfg)
    overrides = {k: v for k, v in overrides.items() if v is not None}
    cfg.update(overrides)
    if overrides:
        mod = config_file.replace(".toml", "_modified.toml")
        tomlio.dump({"train": cfg}, mod)
    if "setup_dir" not in cfg:
        raise ValueError("train config needs setup_dir")
    return cfg


def _check_ported(cfg: dict) -> None:
    if cfg.get("fold_xy"):
        raise NotImplementedError("fold_xy: folded (TPU layout) training is not ported")


def _is_synthetic(cfg: dict) -> bool:
    setup_name = os.path.basename(os.path.normpath(cfg["setup_dir"]))
    return "_from_" in setup_name or "samples" not in cfg


def run_training(config_file: str, device=None, compute_dtype=torch.bfloat16, **overrides) -> dict:
    """Train the setup of ``config_file`` on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for); returns ``{"iterations", "rss_limit_hit",
    "final_loss", "checkpoint"}``.

    With ``mesh`` (an override or the config's) and more than one device
    in ``device`` (``resolve_devices``: every visible card by default, or a
    list in which an entry may repeat), the step is sharded over a
    ``(data, space)`` grid (``train/loop.py:make_mesh``), one spawned
    process per device entry; the result is rank 0's."""
    if int8_enabled():
        # int8 convs are inference-only (round and clip have zero gradient):
        # off for the whole run, snapshots included, and restored for a
        # prediction that follows in this process, as the JAX package does
        logger.warning("BS_INT8=1 ignored during training (inference-only)")
        os.environ["BS_INT8"] = "0"
        try:
            return run_training(config_file, device, compute_dtype, **overrides)
        finally:
            os.environ["BS_INT8"] = "1"
    devices = resolve_devices(device)
    cfg = setup_train(config_file, **overrides)
    _check_ported(cfg)
    if cfg.get("mesh", False) and len(devices) > 1:
        return _run_mesh_training(cfg, devices, compute_dtype)
    return _train(cfg, devices[0], compute_dtype)


def _run_mesh_training(cfg: dict, devices: list, compute_dtype) -> dict:
    """The mesh's factorisation, checked and logged before any launch, then
    one process per device entry (``_mesh_rank``; ``spawn_mesh`` chooses
    and logs the backend)."""
    nc = get_net_config(cfg["setup_dir"])
    batch_size = cfg.get("batch_size") or (
        1 if _is_synthetic(cfg) else SetupSpec(nc, tuple(cfg.get("voxel_size", [1, 1, 1]))).batch_size
    )
    # the factorisation divides what it splits: the batch over data, the
    # net's first spatial axis (input and output) over space
    grid = make_mesh(
        len(devices), batch_size=batch_size,
        spatial=math.gcd(int(nc["input_shape"][0]), int(nc["output_shape"][0])), devices=devices,
    )
    check_mesh_slabs(unet_config(nc), nc["input_shape"], nc["output_shape"], grid)
    logger.info(
        "mesh training over (%d data, %d space) = %s (batch %d)",
        len(grid), len(grid[0]), [[str(d) for d in row] for row in grid], batch_size,
    )
    return spawn_mesh(_mesh_rank, grid, args=(cfg, compute_dtype, batch_size))


def _mesh_rank(mesh: MeshRank, cfg: dict, compute_dtype, batch_size: int) -> dict:
    return _train(cfg, mesh.device, compute_dtype, mesh=mesh, batch_size=batch_size)


def _train(cfg: dict, dev: torch.device, compute_dtype, mesh: MeshRank = None, batch_size=None) -> dict:
    """The training loop on ``dev``; as a rank of ``mesh``, the sharded step:
    the leader of each data group draws its share of the batch (its
    pipeline seeded by the data group's index) and broadcasts it to the
    group's space ranks, rank 0's state is broadcast first, and only rank 0
    writes checkpoints, the loss log and snapshots."""
    setup_dir = cfg["setup_dir"]
    synthetic = _is_synthetic(cfg)
    voxel_size = cfg.get("voxel_size", [1, 1, 1])
    max_iterations = int(cfg.get("max_iterations", 30001))
    save_every = int(cfg.get("save_checkpoints_every", 5000))
    snap_every = int(cfg.get("save_snapshots_every", 1000))
    batch_size = batch_size or cfg.get("batch_size")
    rank0, draws, data_group = True, True, 0
    if mesh is not None:
        rank0, draws, data_group = mesh.rank == 0, mesh.rank == mesh.leader, mesh.coords[0]
        batch_size //= mesh.data

    model = Model.from_setup(setup_dir, compute_dtype=compute_dtype)
    if synthetic:  # refiners train on synthetic labels
        lr = 1e-4
    else:
        spec = SetupSpec(model.net_config, tuple(voxel_size))
        lr = spec.learning_rate
    model = model.to(dev)
    state = create_train_state(model, cfg.get("seed", 0), cfg.get("learning_rate", lr))
    if mesh is None:
        step_fn = make_train_step()
    else:
        step_fn = shard_train_step(mesh, model.unet_config, model.dims)

    ckpt = latest_checkpoint(setup_dir)
    start_iter = 0
    if ckpt and rank0:
        load_checkpoint(ckpt, state)
        logger.info("resuming from %s (iteration %d)", ckpt, state.step)
    if mesh is not None:
        broadcast_state(state, mesh)
    start_iter = int(state.step)

    pipeline = None
    if draws and synthetic:
        pipeline = SyntheticTrainingPipeline(
            model.net_config, voxel_size=voxel_size, batch_size=batch_size or 1, device=dev, seed=data_group
        )
    elif draws:
        samples = [Sample.open(s["raw"], s["labels"], s.get("mask")) for s in cfg["samples"]]
        artifact_samples = None
        if cfg.get("artifact_samples"):
            # real-artifact blending: each entry names an intensities
            # dataset and optionally its alpha mask
            artifact_samples = [
                (open_ds(a["artifacts"]), open_ds(a["artifacts_mask"]) if a.get("artifacts_mask") else None)
                for a in cfg["artifact_samples"]
            ]
        pipeline = TrainingPipeline(
            model.net_config,
            voxel_size,
            samples,
            batch_size=batch_size,
            min_masked=cfg.get("min_masked", 0.05),
            artifact_samples=artifact_samples,
            prob_artifact=cfg.get("prob_artifact", 0.05),
            device=dev,
            seed=data_group,
        )

    log_dir = os.path.join(setup_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, "loss.jsonl")
    snap_dir = os.path.join(setup_dir, "snapshots")

    # past the cap: checkpoint, stop cleanly, and let the caller resume in
    # a fresh process
    max_rss_gb = float(os.environ.get("BS_MAX_RSS_GB", "64"))
    rss_check_every = max(1, int(os.environ.get("BS_RSS_CHECK_EVERY", "100")))
    rss_hit = False
    # a stalled rank is replaced by re-executing its process, which a
    # spawned rank of a mesh cannot be: there the process group's timeout
    # ends a stall instead
    watchdog = _start_watchdog() if mesh is None else None

    t0 = time.perf_counter()
    losses = []
    try:
        with open(log_path, "a") if rank0 else contextlib.nullcontext() as logf:
            it = start_iter - 1
            for it in range(start_iter, max_iterations):
                if watchdog is not None:
                    watchdog.beat(it)
                batch = pipeline.next_batch() if pipeline is not None else None
                if mesh is not None:
                    batch = broadcast_batch(batch, mesh)
                state, metrics = step_fn(state, batch)
                if (it + 1) % 10 == 0 or it + 1 == max_iterations:
                    loss = float(metrics["loss"])
                    losses.append(loss)
                    if rank0:
                        logf.write(
                            json.dumps({"iteration": it + 1, "loss": loss, "seconds": time.perf_counter() - t0})
                            + "\n"
                        )
                        logf.flush()
                if rank0 and ((it + 1) % save_every == 0 or it + 1 == max_iterations):
                    path = save_checkpoint(setup_dir, state, it + 1)
                    logger.info("saved %s", path)
                if rank0 and snap_every and (it + 1) % snap_every == 0:
                    _save_snapshot(snap_dir, it + 1, batch, model)
                if max_rss_gb > 0 and (it + 1) % rss_check_every == 0 and it + 1 < max_iterations:
                    over = _rss_gb() > max_rss_gb
                    if mesh is not None:  # every rank stops where any is over
                        flag = torch.tensor([float(over)], device=dev)
                        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
                        over = bool(flag.item())
                    if over:
                        if rank0:
                            save_checkpoint(setup_dir, state, it + 1)
                        logger.warning(
                            "host RSS %.1f GB exceeds BS_MAX_RSS_GB=%g: checkpointed at "
                            "iteration %d and stopping; resume in a fresh process",
                            _rss_gb(), max_rss_gb, it + 1,
                        )
                        rss_hit = True
                        break
    finally:
        if watchdog is not None:
            watchdog.stop()
        if pipeline is not None:
            pipeline.stop()
    result = {
        "iterations": it + 1,
        "rss_limit_hit": rss_hit,
        "final_loss": losses[-1] if losses else None,
        "checkpoint": latest_checkpoint(setup_dir),
    }
    if mesh is not None:  # each rank's conv kernel launches, by conv
        by_rank = [None] * mesh.world
        torch.distributed.all_gather_object(by_rank, conv3d_kernel_launches())
        result["conv_launches_by_rank"] = by_rank
    return result


def _save_snapshot(snap_dir, iteration, batch, model):
    """Write a batch and the current predictions as a snapshot Zarr."""
    try:
        with torch.no_grad():
            preds = model(batch["input"])
        container = os.path.join(snap_dir, f"batch_{iteration}.zarr")
        arrays = {"input": batch["input"]}
        for name in batch["targets"]:
            arrays[f"gt_{name}"] = batch["targets"][name]
            arrays[f"weights_{name}"] = batch["weights"][name]
            arrays[f"pred_{name}"] = preds[name]
        for name, arr in arrays.items():
            # (b, *spatial, c) -> channels-first, sample 0
            a = np.moveaxis(arr[0].float().cpu().numpy(), -1, 0)
            ds = prepare_ds(
                os.path.join(container, name), a.shape, (0,) * (a.ndim - 1), (1,) * (a.ndim - 1), np.float32
            )
            ds[ds.roi] = a
    except Exception as e:  # snapshots must never kill training
        logger.warning("snapshot failed: %r", e)
