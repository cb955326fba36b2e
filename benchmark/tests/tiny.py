"""A checkout of the benchmark at test size: a ``BENCHMARK.json`` whose
cells run narrow nets on small volumes, with files of their own dropped in
beside the harness's metric readers, and a way to drive one run in this
process on the CPU."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

from bmk.spec import Bench  # noqa: E402

PREDICT_CELLS = ["a.stream", "m.sections"]
TRAIN_CELLS = ["a.train", "m.train"]
PROOFREAD_CELLS = ["s.proofread"]
#: the tiny cells of each traffic kind
CELLS_OF_KIND = {"predict": PREDICT_CELLS, "train": TRAIN_CELLS, "proofread": PROOFREAD_CELLS}
#: limits at test size, between what sound runs and the faults read
PREDICT_LIMITS = {"share_ge2": 0.15, "share_ge8": 1e-4}
TRAIN_LIMITS = {"start_gap": 0, "affs_target_gap": 0.0, "affs_weight_gap": 0.0, "loss1_gap": 2e-4, "grad_gap": 0.1,
                "grad_dist_median": 0.015, "step_gap": 0.2}
PROOFREAD_LIMITS = {"embed_gap": 1e-4, "logit_gap": 1e-4, "iou_gap": 1e-4, "label_flip_share": 1e-5}
#: SAM at test size: a windowed and a global block, windows of 3 over a
#: grid of 8 (so that they pad), a 128^2 image
TINY_SAM = {"encoder_dim": 64, "encoder_depth": 2, "encoder_heads": 4, "global_attn_indexes": [1], "img_size": 128,
            "patch_size": 16, "window_size": 3, "prompt_dim": 32, "decoder_heads": 4, "decoder_depth": 2,
            "decoder_mlp_dim": 64, "num_mask_tokens": 4, "iou_head_hidden_dim": 32}


def tiny_sam_config():
    """TINY_SAM as the program's ``SamConfig``, for its ``PRESETS`` (the
    session infers the variant from the encoder's width)."""
    from bootstrapper_torch.models.sam import SamConfig

    return SamConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_SAM.items()})


def narrow(name: str) -> dict:
    """A published setup at 2 feature maps (x2 a level), its shapes kept."""
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["name"] = f"tiny_{name}"
    cfg["net_config"].update(num_fmaps=2, fmap_inc_factor=2)
    if name.startswith("2d"):
        # CPU convolutions are slow in bf16, and the 2D net trains at batch 2
        cfg["compute_dtype"] = "float32"
        cfg["training"]["batch_size"] = 2
    return cfg


def make_root(root: str, volume=(20, 160, 160), sample=(24, 240, 240)) -> str:
    """The test checkout at ``root``; returns it."""
    b = os.path.join(root, "benchmark")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(b, d), exist_ok=True)
    if not os.path.exists(os.path.join(b, "metrics")):
        shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(b, "metrics"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = []
    for name in ("3d_affs", "2d_mtlsd"):
        cfg = narrow(name)
        path = f"benchmark/configs/{cfg['name']}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        spec["configs"].append({"name": cfg["name"], "source": "test", "file": path, "reduced": [], "why": "test"})

    def traffic(src, name, **kw):
        with open(os.path.join(BENCH, "traffic", f"{src}.json")) as f:
            t = json.load(f)
        t.update(kw)
        with open(os.path.join(b, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)

    sam = {"name": "tiny_sam", **TINY_SAM, "compute_dtype": "float32", "reduced": []}
    with open(os.path.join(b, "configs", "tiny_sam.json"), "w") as f:
        json.dump(sam, f)
    spec["configs"].append({"name": "tiny_sam", "source": "test", "file": "benchmark/configs/tiny_sam.json",
                            "reduced": [], "why": "test"})
    traffic("proofread_sections", "tiny_proofread", volume=[6, 150, 150], cell_voxels=2000, clicks_per_section=4)
    traffic("predict_stream", "tiny_stream", volume=list(volume), check_blocks=6)
    traffic("predict_sections", "tiny_sections", volume=list(volume), check_blocks=6)
    traffic("train", "tiny_train", sample=list(sample), cell_voxels=2000, loader_threads=1, warm_steps=1,
            trace_steps=2)
    spec["workloads"] = [
        {"name": "a.stream", "config": "tiny_3d_affs", "traffic": "tiny_stream", "chips": 1, "why": "test"},
        {"name": "m.sections", "config": "tiny_2d_mtlsd", "traffic": "tiny_sections", "chips": 1, "why": "test"},
        {"name": "a.train", "config": "tiny_3d_affs", "traffic": "tiny_train", "chips": 1, "why": "test"},
        {"name": "m.train", "config": "tiny_2d_mtlsd", "traffic": "tiny_train", "chips": 1, "why": "test"},
        {"name": "s.proofread", "config": "tiny_sam", "traffic": "tiny_proofread", "chips": 1, "why": "test"},
    ]
    # each metric goes to the tiny cells of the kinds of the cells it lists
    real = Bench(REPO)
    kind = {c["name"]: real.traffic(c["traffic"])["kind"] for c in real.spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [t for k in dict.fromkeys(kind[c] for c in m["workloads"]) for t in CELLS_OF_KIND[k]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for cells, limits in ((PREDICT_CELLS, PREDICT_LIMITS), (TRAIN_CELLS, TRAIN_LIMITS),
                          (PROOFREAD_CELLS, PROOFREAD_LIMITS)):
        for c in cells:
            with open(os.path.join(b, "limits", f"{c}.json"), "w") as f:
                json.dump({"numbers": limits}, f)
    return root


def drive(root: str, cell: str, seed: int = 3_000_000_007, seconds: float = 0.5, trace: int = 0,
          control=None) -> tuple:
    """One run on the CPU in this process: ``(exit code, result or None,
    standard error)``."""
    from bmk.cli import main

    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
            "--device", "cpu"]
    if control:
        argv += ["--control", control]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, time.perf_counter(), root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()
