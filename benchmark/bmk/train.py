"""Training cells: the program's training loop at the setup's published
shapes on a Voronoi sample, then its first steps held against the plain
reference.

As ``workflows/train.py:_train`` runs it, less checkpoints, snapshots and
the watchdog: ``TrainingPipeline`` (the host loader's threads, then the
device transform) feeds ``train/loop.py:make_train_step``'s step, whose
loss is read every 10 iterations.  Set-up builds the one train state that
the window goes on with, and drives it through its first steps by the
window's own call and feed: the reference follows the first
``check_steps`` of them from the same weights, on the batches the
program's transform made (the transform is checked on its own, below).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import events as E
from . import flops as F
from .data import seed32, voronoi_sample
from .predict import build_model, on_cuda, sync
from .trace import Tracer, span
from .weights import make_weights

#: the loss is read every this many iterations, as ``_train`` reads it
LOSS_EVERY = 10


def make_sample(traffic: dict, seed: int, device):
    from bootstrapper_torch.core.arrays import Array
    from bootstrapper_torch.train.sampler import Sample

    shape = tuple(traffic["sample"])
    vs = traffic["voxel_size"]
    n_cells = max(8, int(np.prod(shape)) // int(traffic["cell_voxels"]))
    s = voronoi_sample(shape, n_cells, seed, device)
    return Sample(*(Array.from_ndarray(s[k], (0, 0, 0), vs) for k in ("raw", "labels", "mask")))


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        out: dict, quantize=None) -> dict:
    """One run of a training cell; fills and returns ``out``.  ``quantize``
    (the control's runs): the reference in that precision takes the
    program's place on the feed's batches, and there is no window."""
    from bootstrapper_torch.ops import conv3d_kernel_launches, reset_launch_counts
    from bootstrapper_torch.pipeline.training import TrainingPipeline
    from bootstrapper_torch.train.loop import TrainState, make_optimizer, make_train_step

    nc = cfg["net_config"]
    tcfg = cfg["training"]
    batch_size, lr = int(tcfg["batch_size"]), float(tcfg["learning_rate"])
    n_check = int(traffic["check_steps"])
    sample = make_sample(traffic, seed, device)
    pipe = TrainingPipeline(
        nc, traffic["voxel_size"], [sample], batch_size=batch_size, min_masked=float(traffic["min_masked"]),
        seed=seed32(seed, 4), num_threads=int(traffic["loader_threads"]), device=device,
    )
    try:
        weights = make_weights(nc, seed32(seed, 0), device)
        check = {"host": [], "batches": [], "losses": []}
        if quantize is not None:
            # the control: no program; the batches come from its feed
            for _ in range(n_check):
                host = next(pipe.loader)
                check["host"].append(host)
                check["batches"].append(pipe.transform_batch(host))
            out.update(setup_s=0.0, window_s=0.0, attempted=0, failed=0, memory_peak_bytes=0, e2e={})
            pipe.stop()
            from reference.train import reference_steps

            got = reference_steps(nc, weights, check["batches"], lr, quantize=quantize)
            check.update(losses=got["losses"], grad=got["grad"], params=got["params"])
            out["detail"] = {}
            out["numbers"] = compare_steps(nc, weights, check, lr, out["detail"])
            # the reference starts from the weights themselves; the feed is the program's
            out["numbers"]["start_gap"] = 0
            out["numbers"].update(check_transform(nc, traffic, check["host"][0], seed, device))
            return out

        model = build_model(cfg, weights, device)
        state = TrainState(0, model, make_optimizer(model, lr))
        step_fn = make_train_step()
        names = [n for n, _ in model.named_parameters()]
        params = dict(model.named_parameters())
        start_equal = all(torch.equal(params[n].detach(), weights[n]) for n in names)

        def one_step(record=None):
            nonlocal state
            with span("bmk.loader_wait"):
                t = time.perf_counter()
                host = next(pipe.loader)
                waited = time.perf_counter() - t
            with span("bmk.transform"):
                batch = pipe.transform_batch(host)
            with span("bmk.step"):
                state, metrics = step_fn(state, batch)
            if record is not None:
                record["host"].append(host)
                record["batches"].append({k: _clone(v) for k, v in batch.items()})
                record["losses"].append(metrics["loss"])
            return metrics, waited

        for k in range(n_check):
            one_step(check)
            if k == 0:
                opt = state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                # the first gradient as the optimizer got it (none where it kept no state)
                check["grad"] = {
                    n: opt.state[params[n]].get("exp_avg", torch.zeros_like(params[n])) / (1.0 - beta1)
                    for n in names
                }
        check["params"] = {n: params[n].detach().clone() for n in names}
        for _ in range(int(traffic["warm_steps"])):
            one_step()
        sync(device)

        t_w0 = time.perf_counter()
        steps, wait, marks = 0, 0.0, []
        while True:
            metrics, waited = one_step()
            steps += 1
            wait += waited
            if steps % LOSS_EVERY == 0:
                float(metrics["loss"])
                marks.append(time.perf_counter() - t_w0)
            if time.perf_counter() - t_w0 >= seconds:
                break
        sync(device)
        t_w1 = time.perf_counter()
        # seconds per LOSS_EVERY steps, between the loss reads
        out["chunk_s"] = list(np.diff([0.0, *marks]))
        memory_peak = torch.cuda.max_memory_allocated(device) if on_cuda(device) else 0
        # the same loop, traced: the card's busy time a step (the end-to-end
        # metric) and, in a traced run, the per-layer metrics' trace
        n = int(traffic["trace_steps"])
        reset_launch_counts()
        tracer = Tracer(device)
        with tracer:
            for _ in range(n):
                one_step()
        lo, hi = E.window(tracer.events)
        # on a host without a card (tests) the host is the device
        busy_us = E.busy_us(tracer.events, lo, hi) if on_cuda(device) else hi - lo
        out.update(
            setup_s=t_w0 - t_start,
            window_s=t_w1 - t_w0,
            attempted=steps,
            failed=0,
            memory_peak_bytes=memory_peak,
            e2e={"train_device_ms": busy_us / n / 1e3},
        )
        record = {
            "kind": "train",
            "window_s": t_w1 - t_w0,
            "steps": steps,
            "loader_wait_s": wait,
            "flops_per_step": F.train_step_flops(nc, batch_size),
            "trace": None,
            "trace_steps": 0,
            "k1_launches": None,
        }
        if trace:
            record.update(trace=tracer.events, trace_steps=n, k1_launches=conv3d_kernel_launches())
        out["record"] = record
    finally:
        pipe.stop()

    check["losses"] = [float(v) for v in check["losses"]]
    del state, model, params, step_fn
    gc.collect()
    if on_cuda(device):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["detail"] = {}
    numbers = compare_steps(nc, weights, check, lr, out["detail"])
    numbers["start_gap"] = int(not start_equal)
    numbers.update(check_transform(nc, traffic, check["host"][0], seed, device))
    out["numbers"] = numbers
    out["check_s"] = time.perf_counter() - t0
    return out


def _clone(v):
    if isinstance(v, dict):
        return {k: t.detach().clone() for k, t in v.items()}
    return v.detach().clone()


def compare_steps(nc, weights, check: dict, lr: float, detail: dict) -> dict:
    """The program's first steps against the reference's, on the same
    batches from the same weights: the largest relative gap of a step's
    loss; the worst leaf's gap between the norms of the first gradient and
    of the parameters' change over the steps, each over the reference's
    norm of that leaf or of the median leaf, whichever is larger.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move under Adam by round-off alone and are left out.  ``detail`` gets
    the losses and the worst leaves."""
    from reference.train import reference_steps

    ref = reference_steps(nc, weights, check["batches"], lr)
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(check["losses"], ref["losses"])]
    detail["losses"] = [[a, b] for a, b in zip(check["losses"], ref["losses"])]
    g_ref = {n: float(v.norm()) for n, v in ref["grad"].items()}
    g_med = float(np.median(list(g_ref.values())))
    live = [n for n, v in g_ref.items() if v >= 1e-3 * g_med]
    d_ref = {n: float((ref["params"][n] - weights[n]).norm()) for n in live}
    d_med = float(np.median(list(d_ref.values())))

    def worst(prog, refn, med, key):
        gaps = {n: abs(prog[n] - refn[n]) / max(refn[n], med) for n in live}
        n = max(gaps, key=gaps.get)
        detail[key] = [n, prog[n], refn[n], med]
        return gaps[n]

    g_prog = {n: float(check["grad"][n].float().norm()) for n in live}
    d_prog = {n: float((check["params"][n].float() - weights[n]).norm()) for n in live}
    # the distance of the first gradients, leaf by leaf, over the
    # reference's norm of that leaf or of the median leaf
    g_dist = {n: float((check["grad"][n].float() - ref["grad"][n]).norm()) / max(g_ref[n], g_med) for n in live}
    return {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": worst(g_prog, g_ref, g_med, "grad_worst_leaf"),
        "step_gap": worst(d_prog, d_ref, d_med, "step_worst_leaf"),
        "grad_dist_max": max(g_dist.values()),
        "grad_dist_median": float(np.median(list(g_dist.values()))),
        "leaves_left_out": len(g_ref) - len(live),
    }


def check_transform(nc, traffic, host: dict, seed: int, device) -> dict:
    """The device transform alone, at the training crop, on the first
    checked batch's first host crop: the program's ``apply_transform`` with
    a draw of mirrors and a transpose and no gated augment or defect,
    against the plain targets of ``reference/targets.py``."""
    from bootstrapper_torch.pipeline.training import SetupSpec, apply_transform, upload

    from reference.targets import transform_reference

    spec = SetupSpec(nc, tuple(traffic["voxel_size"]))
    rng = np.random.default_rng(seed32(seed, 6))
    flips = [bool(f) for f in rng.integers(0, 2, 3)]
    transpose = bool(rng.integers(0, 2))
    z = spec.input_tile[0]
    draws = {
        "simple": {"flips": flips, "transpose": transpose},
        "defect": {"u": np.ones(z, dtype=np.float32), "alpha": np.full(z, 0.5, dtype=np.float32)},
    }
    one = {k: v[:1] for k, v in host.items()}
    b = upload(one, device)
    x, targets, weights = apply_transform(spec, draws, b["raw"][0], b["labels"][0], b["mask"][0])
    want = transform_reference(
        nc, tuple(traffic["voxel_size"]), host["raw"][0], host["labels"][0], host["mask"][0], flips, transpose
    )
    def gap(a, b):
        return float(np.abs(a.cpu().numpy() - b).max())

    out = {"input_gap": gap(x, want["input"])}
    for name in targets:
        key = "lsds" if "lsd" in name else "affs"
        out[f"{key}_target_gap"] = gap(targets[name], want["targets"][name])
        out[f"{key}_weight_gap"] = gap(weights[name], want["weights"][name])
    return out
