"""Config factory: per-round TOML configs for every workflow stage (a
copy of the JAX package's ``configs.py``, writing the same TOMLs).

Capability parity with the reference config system (reference
``bootstrapper/configs.py:385-905``): a round directory receives
numbered stage configs

    01_train_<setup>.toml  02_predict.toml  03_segment.toml
    04_evaluate.toml       05_filter.toml

with the same key schema, model chaining (``{iteration}--from--{chain}``
dataset naming, ``configs.py:494-516``) and round chaining (the filter
stage's pseudo-GT labels/mask become the next round's volumes,
``configs.py:791-845``).  All functions here are non-interactive; the
``bs prepare`` wizard wraps them with prompts.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import logging

from .models.zoo import SETUPS, write_net_config
from .utils import tomlio

logger = logging.getLogger(__name__)

MODEL_NAMES = list(SETUPS)


PRETRAINED_ENV = "BS_PRETRAINED_DIR"


def pretrained_dir() -> str:
    """Where release checkpoints for the ``*_from_*`` refiners live.

    The reference downloads these from GitHub release zips
    (``configs.py:34-39,354-382``); here they ship with the package
    and can be overridden with $BS_PRETRAINED_DIR."""
    return os.environ.get(PRETRAINED_ENV) or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "pretrained",
    )


def install_pretrained(setup_name: str, setup_dir: str):
    """Copy the shipped checkpoint for a refiner setup into a freshly
    prepared setup dir (the reference's download-checkpoints UX,
    ``configs.py:354-382``, without the network)."""
    import shutil

    from .train.loop import latest_checkpoint

    src_dir = os.path.join(pretrained_dir(), setup_name)
    if not os.path.isdir(src_dir):
        return None
    src = latest_checkpoint(src_dir)
    if not src:
        return None
    dst = os.path.join(setup_dir, os.path.basename(src))
    if not os.path.exists(dst):
        os.makedirs(setup_dir, exist_ok=True)
        shutil.copy2(src, dst)
    return dst


def setup_models(
    model_names: Sequence[str], parent_dir: str
) -> List[str]:
    """Materialise setup dirs (net_config.json per model); returns dirs.

    Unlike the reference (which copies python scripts per setup,
    ``configs.py:67-76``), setups here are pure config — one parametric
    model implementation serves all of them.  Refiner setups get the
    shipped synthetic-trained checkpoint installed when available.
    """
    setup_dirs = []
    os.makedirs(parent_dir, exist_ok=True)
    for name in model_names:
        setup_dir = os.path.join(parent_dir, name)
        write_net_config(name, setup_dir)
        if "_from_" in name:
            ckpt = install_pretrained(name, setup_dir)
            if ckpt:
                logger.info("installed pretrained checkpoint %s", ckpt)
        setup_dirs.append(setup_dir)
    return setup_dirs


def create_training_config(
    setup_dir: str,
    voxel_size: Sequence[int],
    samples: List[dict],
    max_iterations: int = 30001,
    save_checkpoints_every: int = 5000,
    save_snapshots_every: int = 1000,
) -> dict:
    return {
        "setup_dir": setup_dir,
        "voxel_size": list(voxel_size),
        "max_iterations": max_iterations,
        "save_checkpoints_every": save_checkpoints_every,
        "save_snapshots_every": save_snapshots_every,
        "samples": [
            {k: v for k, v in s.items() if v is not None} for s in samples
        ],
    }


def create_prediction_configs(
    volumes: Dict[str, dict],
    setup_dirs: Sequence[str],
    iterations: Sequence[int],
    num_workers: int = 1,
) -> dict:
    """Per volume: the chain of setups, each reading the previous
    setup's outputs; datasets named ``{setup}/{iter}[--from--{chain}]``."""
    configs = {}
    for volume_name, volume in volumes.items():
        container = volume["output_container"]
        raw = volume["raw_dataset"]
        chain_datasets = []
        setups = []
        for i, setup_dir in enumerate(setup_dirs):
            setup_name = os.path.basename(setup_dir)
            iteration = iterations[i]
            with open(os.path.join(setup_dir, "net_config.json")) as f:
                net_config = json.load(f)
            chain = [
                f"{os.path.basename(s)}_{it}"
                for s, it in zip(setup_dirs[:i], iterations[:i])
            ]
            chain_str = "--from--".join(chain)
            ds_suffix = (
                str(iteration)
                if not chain_str
                else f"{iteration}--from--{chain_str}"
            )
            if i == 0:
                in_datasets = [raw]
            else:
                # Feed only the datasets this setup declares as inputs,
                # in declared order (the reference matches datasets to
                # model inputs by name, ``predict.py:246-265``); a
                # refiner taking a subset of the previous setup's
                # outputs (e.g. 2d_mtlsd -> 3d_affs_from_2d_affs) must
                # not receive the extras.
                wanted = list(net_config.get("inputs", {}))
                if wanted:
                    missing = [w for w in wanted if w not in prev_outputs]
                    if missing:
                        raise ValueError(
                            f"chain link {setup_name!r} declares inputs "
                            f"{wanted} but the previous setup only "
                            f"outputs {prev_outputs} (missing {missing})"
                        )
                    use = wanted
                else:
                    use = prev_outputs
                in_datasets = [
                    os.path.join(container, prev_prefix, name)
                    for name in use
                ]
            out_prefix = os.path.join(setup_name, ds_suffix)
            setups.append(
                {
                    "setup_dir": setup_dir,
                    "checkpoint_iteration": iteration,
                    "input_datasets": in_datasets,
                    "output_container": container,
                    "output_prefix": out_prefix,
                }
            )
            prev_prefix = out_prefix
            prev_outputs = list(net_config["outputs"])
            chain_datasets.append(out_prefix)
        configs[volume_name] = {
            "raw_dataset": raw,
            "output_container": container,
            "num_workers": num_workers,
            "chain": setups,
        }
        # optional sub-ROI (the reference's get_sub_roi prompt capability)
        if "roi_offset" in volume:
            configs[volume_name]["roi_offset"] = volume["roi_offset"]
            configs[volume_name]["roi_shape"] = volume["roi_shape"]
    return configs


def create_segmentation_configs(
    volumes: Dict[str, dict],
    affs_prefix: str,
    method: str = "ws",
    blockwise: bool = False,
    block_shape: Sequence[int] = (32, 256, 256),
    num_workers: int = 8,
    params: Optional[dict] = None,
    affs_name: str = "3d_affs",
) -> dict:
    configs = {}
    for volume_name, volume in volumes.items():
        container = volume["output_container"]
        out_prefix = os.path.join("post", os.path.basename(affs_prefix))
        cfg = {
            "affs_dataset": os.path.join(container, affs_prefix, affs_name),
            "fragments_dataset": os.path.join(
                container, out_prefix, f"fragments_{method}"
            ),
            "lut_dir": os.path.join(container, out_prefix, f"luts_{method}"),
            "seg_dataset_prefix": os.path.join(
                container, out_prefix, f"segmentations_{method}"
            ),
            "mask_dataset": volume.get("mask_dataset"),
            "block_shape": list(block_shape),
            "context": [2, 32, 32],
            "blockwise": blockwise,
            "num_workers": num_workers,
            f"{method}_params": params or {},
        }
        if blockwise:
            cfg["db"] = {
                "db_file": os.path.join(container, out_prefix, f"rag_{method}.db")
            }
        configs[volume_name] = {k: v for k, v in cfg.items() if v is not None}
    return configs


def create_evaluation_configs(
    volumes: Dict[str, dict],
    seg_prefix: str,
    pred_dataset: Optional[str] = None,
    pred_params: Optional[dict] = None,
    gt_labels: Optional[str] = None,
    gt_skeletons: Optional[str] = None,
) -> dict:
    configs = {}
    for volume_name, volume in volumes.items():
        container = volume["output_container"]
        cfg = {
            "out_result_dir": os.path.join(container, "eval"),
            "seg_datasets_prefix": os.path.join(container, seg_prefix),
            "mask_dataset": volume.get("mask_dataset"),
        }
        if pred_dataset is not None:
            cfg["pred"] = {
                "pred_dataset": os.path.join(container, pred_dataset),
                "thresholds": [0.1, 1.0],
                "params": pred_params or {},
            }
        if gt_labels or gt_skeletons:
            cfg["gt"] = {}
            if gt_labels:
                cfg["gt"]["labels_dataset"] = gt_labels
            if gt_skeletons:
                cfg["gt"]["skeletons_file"] = gt_skeletons
        configs[volume_name] = {k: v for k, v in cfg.items() if v is not None}
    return configs


def create_filter_configs(
    volumes: Dict[str, dict],
    seg_prefix: str,
    round_name: str,
    dust_filter: int = 500,
    remove_outliers: bool = True,
    remove_z_fragments: int = 10,
    overlap_filter: float = 0.0,
    erode_out_mask: bool = False,
) -> dict:
    """Filter configs; their outputs define the next round's volumes
    (round chaining, ``configs.py:828-845``)."""
    configs = {}
    next_volumes = {}
    for volume_name, volume in volumes.items():
        container = volume["output_container"]
        out_labels = os.path.join(
            container, f"pseudo_gt/{round_name}/labels"
        )
        out_mask = os.path.join(container, f"pseudo_gt/{round_name}/mask")
        configs[volume_name] = {
            "seg_datasets_prefix": os.path.join(container, seg_prefix),
            "eval_dir": os.path.join(container, "eval"),
            "out_seg_dataset_prefix": out_labels,
            "out_mask_dataset_prefix": out_mask,
            "dust_filter": dust_filter,
            "remove_outliers": remove_outliers,
            "remove_z_fragments": remove_z_fragments,
            "overlap_filter": overlap_filter,
            "erode_out_mask": erode_out_mask,
        }
        next_volumes[volume_name] = {
            **volume,
            "labels_dataset": out_labels,
            "labels_mask_dataset": out_mask,
        }
    return {"configs": configs, "next_volumes": next_volumes}


def make_round_configs(
    round_dir: str,
    volumes: Dict[str, dict],
    model_names: Sequence[str],
    iterations: Optional[Sequence[int]] = None,
    max_iterations: int = 30001,
    segment_method: str = "ws",
    blockwise: bool = False,
    gt_labels: Optional[str] = None,
    gt_skeletons: Optional[str] = None,
) -> Dict[str, str]:
    """Write all stage configs for one round; returns {stage: path}."""
    os.makedirs(round_dir, exist_ok=True)
    setups_dir = os.path.join(round_dir, "setups")
    setup_dirs = setup_models(model_names, setups_dir)
    if iterations is None:
        iterations = [max_iterations - 1] * len(setup_dirs)
    voxel_size = next(iter(volumes.values()))["voxel_size"]
    samples = [
        {
            "raw": v["raw_dataset"],
            "labels": v.get("labels_dataset"),
            "mask": v.get("labels_mask_dataset"),
        }
        for v in volumes.values()
        if v.get("labels_dataset")
    ]

    paths = {}
    for i, (name, setup_dir) in enumerate(zip(model_names, setup_dirs)):
        cfg = create_training_config(
            setup_dir, voxel_size, samples, max_iterations
        )
        if "_from_" in name:
            cfg.pop("samples")  # synthetic-data setups need no samples
        p = os.path.join(round_dir, f"01_train_{name}.toml")
        tomlio.dump({"train": cfg}, p)
        paths[f"train_{name}"] = p

    pred = create_prediction_configs(volumes, setup_dirs, iterations)
    p = os.path.join(round_dir, "02_predict.toml")
    tomlio.dump({"predict": pred}, p)
    paths["predict"] = p

    # Segment the LAST 3d_affs output along the chain (reference picks
    # the last dataset whose basename starts with "3d_affs",
    # ``configs.py:534-542``); a chain whose final model emits no
    # 3d_affs cannot feed watershed/mws and is a config error.
    affs_link = affs_name = None
    for j in range(len(setup_dirs) - 1, -1, -1):
        with open(os.path.join(setup_dirs[j], "net_config.json")) as f:
            outs = list(json.load(f)["outputs"])
        hits = [n for n in outs if os.path.basename(n).startswith("3d_affs")]
        if hits:
            affs_link, affs_name = j, hits[-1]
            break
    if affs_link is None:
        raise ValueError(
            f"model chain {model_names} produces no 3d_affs output to "
            "segment; end the chain in an affinity model (3d_affs, "
            "3d_mtlsd, or a 3d_affs_from_* refiner)"
        )
    chain = [
        f"{os.path.basename(s)}_{it}"
        for s, it in zip(setup_dirs[:affs_link], iterations[:affs_link])
    ]
    suffix = (
        str(iterations[affs_link])
        if not chain
        else f"{iterations[affs_link]}--from--{'--from--'.join(chain)}"
    )
    affs_prefix = os.path.join(os.path.basename(setup_dirs[affs_link]), suffix)
    seg = create_segmentation_configs(
        volumes, affs_prefix, segment_method, blockwise, affs_name=affs_name
    )
    p = os.path.join(round_dir, "03_segment.toml")
    tomlio.dump({"segment": seg}, p)
    paths["segment"] = p

    seg_prefix = os.path.join(
        "post", os.path.basename(affs_prefix), f"segmentations_{segment_method}"
    )
    pred_dataset = None
    pred_params = None
    if not gt_labels and not gt_skeletons:
        # no ground truth: score segmentations by self-supervised
        # prediction-consistency errors against the final model output
        # (the reference's "pred" eval mode, ``configs.py:767-777``)
        last_nc = json.load(
            open(os.path.join(setup_dirs[-1], "net_config.json"))
        )
        out_name, out_cfg = next(iter(last_nc["outputs"].items()))
        last_chain = [
            f"{os.path.basename(s)}_{it}"
            for s, it in zip(setup_dirs[:-1], iterations[:-1])
        ]
        last_suffix = (
            str(iterations[-1])
            if not last_chain
            else f"{iterations[-1]}--from--{'--from--'.join(last_chain)}"
        )
        last_prefix = os.path.join(
            os.path.basename(setup_dirs[-1]), last_suffix
        )
        pred_dataset = os.path.join(last_prefix, out_name)
        if "sigma" in out_cfg:
            pred_params = {"lsd_sigma": out_cfg["sigma"]}
        else:
            pred_params = {"aff_neighborhood": out_cfg["neighborhood"]}
    ev = create_evaluation_configs(
        volumes, seg_prefix,
        pred_dataset=pred_dataset, pred_params=pred_params,
        gt_labels=gt_labels, gt_skeletons=gt_skeletons,
    )
    p = os.path.join(round_dir, "04_evaluate.toml")
    tomlio.dump({"evaluate": ev}, p)
    paths["evaluate"] = p

    filt = create_filter_configs(
        volumes, seg_prefix, os.path.basename(round_dir)
    )
    p = os.path.join(round_dir, "05_filter.toml")
    tomlio.dump({"filter": filt["configs"]}, p)
    paths["filter"] = p
    tomlio.dump(
        {"volumes": filt["next_volumes"]},
        os.path.join(round_dir, "next_volumes.toml"),
    )
    return paths
