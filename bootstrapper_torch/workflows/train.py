"""Training workflow: TOML config -> training loop (the JAX package's
``workflows/train.py``, on one device).

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
config sets them).  Not ported, and raised as ``NotImplementedError``
where a config asks for them: TPU folding (``fold_xy = true``) and the
device ``mesh``.  The JAX package's fold probe, which turns
folding on for a batch of 8 or more where a TPU compile of it passes, is
TPU machinery: here a config without ``fold_xy`` trains unfolded at any
batch, with no probe.  ``BS_INT8=1`` is ignored here with a warning, as
the JAX package ignores it in training (int8 is inference-only there, and
the port's prediction refuses it until it is ported).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.arrays import open_ds, prepare_ds
from ..models.model import Model
from ..pipeline.synthetic import SyntheticTrainingPipeline
from ..pipeline.training import SetupSpec, TrainingPipeline
from ..train.loop import (
    create_train_state,
    latest_checkpoint,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
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
    if cfg.get("mesh", False):
        raise NotImplementedError("mesh: multi-device training is not ported yet")


def run_training(config_file: str, device=None, compute_dtype=torch.bfloat16, **overrides) -> dict:
    """Train the setup of ``config_file`` on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for); returns ``{"iterations", "rss_limit_hit",
    "final_loss", "checkpoint"}``."""
    dev = resolve_device(device)
    if os.environ.get("BS_INT8") == "1":
        logger.warning("BS_INT8=1 ignored during training (inference-only)")
    cfg = setup_train(config_file, **overrides)
    setup_dir = cfg["setup_dir"]
    setup_name = os.path.basename(os.path.normpath(setup_dir))
    _check_ported(cfg)
    synthetic = "_from_" in setup_name or "samples" not in cfg
    voxel_size = cfg.get("voxel_size", [1, 1, 1])
    max_iterations = int(cfg.get("max_iterations", 30001))
    save_every = int(cfg.get("save_checkpoints_every", 5000))
    snap_every = int(cfg.get("save_snapshots_every", 1000))
    batch_size = cfg.get("batch_size")

    model = Model.from_setup(setup_dir, compute_dtype=compute_dtype)
    if synthetic:  # refiners train on synthetic labels
        lr = 1e-4
    else:
        spec = SetupSpec(model.net_config, tuple(voxel_size))
        samples = [Sample.open(s["raw"], s["labels"], s.get("mask")) for s in cfg["samples"]]
        artifact_samples = None
        if cfg.get("artifact_samples"):
            # real-artifact blending: each entry names an intensities
            # dataset and optionally its alpha mask
            artifact_samples = [
                (open_ds(a["artifacts"]), open_ds(a["artifacts_mask"]) if a.get("artifacts_mask") else None)
                for a in cfg["artifact_samples"]
            ]
        lr = spec.learning_rate
    model = model.to(dev)
    state = create_train_state(model, cfg.get("seed", 0), cfg.get("learning_rate", lr))
    step_fn = make_train_step()

    ckpt = latest_checkpoint(setup_dir)
    start_iter = 0
    if ckpt:
        load_checkpoint(ckpt, state)
        start_iter = int(state.step)
        logger.info("resuming from %s (iteration %d)", ckpt, start_iter)

    if synthetic:
        pipeline = SyntheticTrainingPipeline(
            model.net_config, voxel_size=voxel_size, batch_size=batch_size or 1, device=dev
        )
    else:
        pipeline = TrainingPipeline(
            model.net_config,
            voxel_size,
            samples,
            batch_size=batch_size,
            min_masked=cfg.get("min_masked", 0.05),
            artifact_samples=artifact_samples,
            prob_artifact=cfg.get("prob_artifact", 0.05),
            device=dev,
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
    watchdog = _start_watchdog()

    t0 = time.perf_counter()
    losses = []
    try:
        with open(log_path, "a") as logf:
            it = start_iter - 1
            for it in range(start_iter, max_iterations):
                if watchdog is not None:
                    watchdog.beat(it)
                batch = pipeline.next_batch()
                state, metrics = step_fn(state, batch)
                if (it + 1) % 10 == 0 or it + 1 == max_iterations:
                    loss = float(metrics["loss"])
                    losses.append(loss)
                    logf.write(
                        json.dumps({"iteration": it + 1, "loss": loss, "seconds": time.perf_counter() - t0})
                        + "\n"
                    )
                    logf.flush()
                if (it + 1) % save_every == 0 or it + 1 == max_iterations:
                    path = save_checkpoint(setup_dir, state, it + 1)
                    logger.info("saved %s", path)
                if snap_every and (it + 1) % snap_every == 0:
                    _save_snapshot(snap_dir, it + 1, batch, model)
                if (
                    max_rss_gb > 0
                    and (it + 1) % rss_check_every == 0
                    and it + 1 < max_iterations
                    and _rss_gb() > max_rss_gb
                ):
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
        pipeline.stop()
    return {
        "iterations": it + 1,
        "rss_limit_hit": rss_hit,
        "final_loss": losses[-1] if losses else None,
        "checkpoint": latest_checkpoint(setup_dir),
    }


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
