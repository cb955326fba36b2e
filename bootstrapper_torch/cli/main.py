"""The port's ``bs`` command line (``bs-torch``, or ``python -m
bootstrapper_torch``): the JAX package's ``cli/main.py`` over the port's
entry points.

The same commands, options, short flags and aliases
(``prep/pred/infer/seg/eval/refine``), a bare ``prepare`` meaning
``prepare round``, and a ``run`` dispatcher that sniffs a TOML's keys to
pick the right workflow.  Where the JAX package picks its device through
``JAX_PLATFORMS``, the group takes ``--device`` (default ``cuda``) and
passes it to every entry point that runs on one; without a GPU and without
``--device cpu`` those fail as ``resolve_device`` does.  ``--device`` also
takes a comma list (``cuda:0,cuda:1``, or ``cpu,cpu`` and ``cuda:0,cuda:0``
for two logical devices on one CPU or card): ``predict --sharded`` and
``train --mesh`` spread over its entries (``cuda`` alone: every visible
card), the other commands run on its first (``proofread``: where SAM runs).

``main(argv)`` runs one command in this interpreter and returns its exit
code.
"""

from __future__ import annotations

import logging
import os

import click

from .. import __version__
from .styles import cli_echo

logging.basicConfig(
    level=os.environ.get("BS_LOGLEVEL", "INFO"),
    format="%(asctime)s %(name)s %(levelname)s %(message)s",
)

ALIASES = {
    "prep": "prepare",
    "pred": "predict",
    "infer": "predict",
    "seg": "segment",
    "eval": "evaluate",
    "refine": "filter",
}


class CommandGroup(click.Group):
    """Ordered commands + alias resolution."""

    def list_commands(self, ctx):
        return list(self.commands)

    def get_command(self, ctx, name):
        name = ALIASES.get(name, name)
        return super().get_command(ctx, name)


@click.group(cls=CommandGroup)
@click.version_option(version=__version__, prog_name="bs-torch")
@click.option("--device", default="cuda", show_default=True,
              help="device of the entry points: cuda, or cpu for the "
              "kernels' plain PyTorch versions; a comma list (cuda:0,cuda:1) "
              "for predict --sharded and train --mesh")
@click.pass_context
def cli(ctx, device):
    """bootstrapper_torch: volumetric segmentation bootstrapping on an
    NVIDIA GPU."""
    ctx.obj = {"device": device}


def _devices() -> str:
    """``--device`` as given: a multi-device entry point's list."""
    return click.get_current_context().obj["device"]


def _device() -> str:
    """The device of a one-device entry point: ``--device``'s first entry."""
    return _devices().split(",")[0].strip()


# ---------------------------------------------------------------------------
# workflows
# ---------------------------------------------------------------------------


class PrepareGroup(click.Group):
    """`bs prepare` runs the full wizard when invoked bare, or a
    subcommand for one piece (reference PrepareGroup behaviour,
    ``bootstrapper/prepare.py:22-385``)."""

    def parse_args(self, ctx, args):
        if args and args[0] not in self.commands and not args[0].startswith("-"):
            raise click.UsageError(f"unknown prepare subcommand {args[0]!r}")
        if not args or args[0].startswith("-"):
            args = ["round"] + list(args)
        return super().parse_args(ctx, args)


@cli.group(cls=PrepareGroup, invoke_without_command=False)
def prepare():
    """Create configs: a full round, or one piece (volumes/model/...)."""


@prepare.command("round")
@click.option("--base-dir", "-b", default=".", help="project directory")
@click.option("--volumes-toml", "-v", default=None,
              help="TOML with a [volumes] table (skip the wizard)")
@click.option("--models", "-m", multiple=True, help="model chain, in order")
@click.option("--round-name", "-r", default="round_1")
@click.option("--max-iterations", default=30001, type=int)
@click.option("--segment-method", default="ws",
              type=click.Choice(["ws", "mws", "cc"]))
@click.option("--blockwise/--no-blockwise", default=False)
@click.option("--gt-labels", default=None)
@click.option("--gt-skeletons", default=None)
def prepare_round(base_dir, volumes_toml, models, round_name, max_iterations,
                  segment_method, blockwise, gt_labels, gt_skeletons):
    """Create round configs (volumes -> 01..05 stage TOMLs)."""
    from ..configs import MODEL_NAMES, make_round_configs
    from ..utils import tomlio
    from .wizard import prompt_models, prompt_volumes

    if volumes_toml:
        volumes = tomlio.load(volumes_toml)
        volumes = volumes.get("volumes", volumes)
    else:
        volumes = prompt_volumes()
    model_names = list(models) if models else prompt_models(MODEL_NAMES)
    round_dir = os.path.join(base_dir, round_name)
    paths = make_round_configs(
        round_dir,
        volumes,
        model_names,
        max_iterations=max_iterations,
        segment_method=segment_method,
        blockwise=blockwise,
        gt_labels=gt_labels,
        gt_skeletons=gt_skeletons,
    )
    for stage, path in paths.items():
        cli_echo(f"{stage}: {path}", "prepare")


@prepare.command("volumes")
@click.argument("name")
@click.argument("raw_path")
@click.option("--labels", default=None)
@click.option("--labels-mask", default=None)
@click.option("--out-container", "-o", default=None)
@click.option("--voxel-size", "-vs", nargs=3, type=int, default=(1, 1, 1))
@click.option("--make-masks", is_flag=True)
@click.option("--append-to", "-a", default="volumes.toml",
              help="volumes TOML to create/extend")
def prepare_volumes(name, raw_path, labels, labels_mask, out_container,
                    voxel_size, make_masks, append_to):
    """Ingest one volume (any format) and record it in a volumes TOML."""
    from ..data.volumes import prepare_volume
    from ..utils import tomlio

    vol = prepare_volume(
        name, raw_path, labels, labels_mask, out_container,
        voxel_size, make_raw_mask_ds=False,
        make_labels_mask_ds=make_masks,
    )
    existing = {}
    if os.path.exists(append_to):
        existing = tomlio.load(append_to).get("volumes", {})
    existing.update(vol)
    tomlio.dump({"volumes": existing}, append_to)
    cli_echo(f"volume {name!r} -> {append_to}", "prepare")


@prepare.command("model")
@click.argument("model_names", nargs=-1, required=True)
@click.option("--parent-dir", "-p", default="setups")
def prepare_model(model_names, parent_dir):
    """Materialise setup dirs (net_config.json) for the given models."""
    from ..configs import setup_models

    for d in setup_models(list(model_names), parent_dir):
        cli_echo(d, "prepare")


def _load_volumes(volumes_toml):
    """Volumes table from a TOML, or the interactive wizard (the
    reference's get_volumes prompt, ``prepare.py:190-213``)."""
    from ..utils import tomlio
    from .wizard import prompt_volumes

    if volumes_toml:
        vols = tomlio.load(volumes_toml)
        return vols.get("volumes", vols)
    return prompt_volumes()


def _dump_stage(cfg, out, stage):
    from ..utils import tomlio

    tomlio.dump({stage: cfg}, out)
    cli_echo(out, stage)


@prepare.command("train")
@click.option("--volumes-toml", "-v", default=None)
@click.option("--setup-dir", "-s", "setup_dirs", multiple=True,
              required=True)
@click.option("--max-iterations", default=30001, type=int)
@click.option("--out", "-o", default=None,
              help="output TOML (default train_{setup}.toml per setup)")
def prepare_train(volumes_toml, setup_dirs, max_iterations, out):
    """Create training config file(s) (reference ``prepare.py:239-257``)."""
    from ..configs import create_training_config

    if out and len(setup_dirs) > 1:
        raise click.UsageError(
            "--out names a single file but multiple --setup-dir were "
            "given; omit --out to write train_{setup}.toml per setup"
        )
    volumes = _load_volumes(volumes_toml)
    voxel_size = next(iter(volumes.values())).get("voxel_size", [1, 1, 1])
    samples = [
        {
            "raw": v["raw_dataset"],
            "labels": v.get("labels_dataset"),
            "mask": v.get("labels_mask_dataset"),
        }
        for v in volumes.values()
        if v.get("labels_dataset")
    ]
    for setup_dir in setup_dirs:
        cfg = create_training_config(
            setup_dir, voxel_size, samples, max_iterations
        )
        if "_from_" in os.path.basename(os.path.normpath(setup_dir)):
            cfg.pop("samples", None)
        path = out or f"train_{os.path.basename(os.path.normpath(setup_dir))}.toml"
        _dump_stage(cfg, path, "train")


@prepare.command("predict")
@click.option("--volumes-toml", "-v", default=None)
@click.option("--setup-dir", "-s", "setup_dirs", multiple=True,
              required=True, help="setup dirs, in chain order")
@click.option("--iteration", "-i", "iterations", multiple=True, type=int,
              help="checkpoint iteration per setup (default: latest)")
@click.option("--num-workers", default=1, type=int)
@click.option("--out", "-o", default="predict.toml")
def prepare_predict(volumes_toml, setup_dirs, iterations, num_workers, out):
    """Create prediction config (reference ``prepare.py:259-319``).

    Bare ``*_from_*`` model names resolve to fresh setup dirs with the
    shipped pretrained checkpoint installed."""
    from ..configs import create_prediction_configs, setup_models
    from ..models.zoo import SETUPS

    volumes = _load_volumes(volumes_toml)
    resolved = []
    for sd in setup_dirs:
        if not os.path.isdir(sd) and sd in SETUPS:
            if "_from_" not in sd:
                raise click.UsageError(
                    f"setup dir {sd!r} does not exist (bare names are "
                    "only accepted for *_from_* refiners)"
                )
            sd = setup_models([sd], "setups")[0]
        resolved.append(sd)
    its = list(iterations)
    if its and len(its) != len(resolved):
        raise click.UsageError(
            f"got {len(its)} --iteration value(s) for {len(resolved)} "
            "--setup-dir value(s); give one -i per setup (or none to "
            "use each setup's latest checkpoint)"
        )
    if not its:
        from ..train.loop import latest_checkpoint

        for sd in resolved:
            ckpt = latest_checkpoint(sd)
            its.append(
                int(ckpt.rsplit("_", 1)[1]) if ckpt else 0
            )
    cfg = create_prediction_configs(volumes, resolved, its, num_workers)
    _dump_stage(cfg, out, "predict")


@prepare.command("segment")
@click.option("--volumes-toml", "-v", default=None)
@click.option("--affs-prefix", "-a", required=True,
              help="affinities dataset prefix inside each container")
@click.option("--method", "-m", default="ws",
              type=click.Choice(["ws", "mws", "cc"]))
@click.option("--blockwise/--no-blockwise", default=False)
@click.option("--out", "-o", default="segment.toml")
def prepare_segment(volumes_toml, affs_prefix, method, blockwise, out):
    """Create segmentation config (reference ``prepare.py:321-339``)."""
    from ..configs import create_segmentation_configs

    volumes = _load_volumes(volumes_toml)
    cfg = create_segmentation_configs(
        volumes, affs_prefix, method, blockwise
    )
    _dump_stage(cfg, out, "segment")


@prepare.command("evaluate")
@click.option("--volumes-toml", "-v", default=None)
@click.option("--seg-prefix", "-s", required=True)
@click.option("--pred-dataset", default=None)
@click.option("--gt-labels", default=None)
@click.option("--gt-skeletons", default=None)
@click.option("--out", "-o", default="evaluate.toml")
def prepare_evaluate(volumes_toml, seg_prefix, pred_dataset, gt_labels,
                     gt_skeletons, out):
    """Create evaluation config (reference ``prepare.py:341-364``)."""
    from ..configs import create_evaluation_configs

    volumes = _load_volumes(volumes_toml)
    cfg = create_evaluation_configs(
        volumes, seg_prefix, pred_dataset,
        gt_labels=gt_labels, gt_skeletons=gt_skeletons,
    )
    _dump_stage(cfg, out, "evaluate")


@prepare.command("filter")
@click.option("--volumes-toml", "-v", default=None)
@click.option("--seg-prefix", "-s", required=True)
@click.option("--round-name", "-r", default="round_1")
@click.option("--out", "-o", default="filter.toml")
def prepare_filter(volumes_toml, seg_prefix, round_name, out):
    """Create filter config + next-round volumes (reference
    ``prepare.py:366-385``)."""
    from ..utils import tomlio

    from ..configs import create_filter_configs

    volumes = _load_volumes(volumes_toml)
    ret = create_filter_configs(volumes, seg_prefix, round_name)
    _dump_stage(ret["configs"], out, "filter")
    nxt = out.replace(".toml", "") + "_next_volumes.toml"
    tomlio.dump({"volumes": ret["next_volumes"]}, nxt)
    cli_echo(nxt, "filter")


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--max-iterations", "-i", type=int, default=None)
@click.option("--batch-size", type=int, default=None)
@click.option("--save-checkpoints-every", "-ce", type=int, default=None)
@click.option("--save-snapshots-every", "-s", type=int, default=None)
@click.option("--voxel-size", "-v", default=None,
              help="space-separated integers, e.g. '40 4 4'")
@click.option("--mesh", is_flag=True, default=None,
              help="shard the train step over all devices (data+space)")
def train(config_file, max_iterations, batch_size, save_checkpoints_every,
          save_snapshots_every, voxel_size, mesh):
    """Train a setup from a training config TOML.

    Options override the config file (reference ``train.py:136-149``)."""
    from ..workflows.train import run_training

    result = run_training(
        config_file, max_iterations=max_iterations, batch_size=batch_size,
        save_checkpoints_every=save_checkpoints_every,
        save_snapshots_every=save_snapshots_every,
        voxel_size=(
            [int(x) for x in voxel_size.split()] if voxel_size else None
        ),
        mesh=mesh,
        device=_devices(),
    )
    if result.get("rss_limit_hit") and os.environ.get(
        "BS_RSS_RESPAWN", "1"
    ) == "1":
        # host memory past BS_MAX_RSS_GB is only reclaimable by
        # replacing the process: re-exec this exact command — auto-resume
        # continues from the checkpoint just written
        import sys

        cli_echo(
            f"training paused at iteration {result['iterations']} "
            "(host RSS cap) — re-executing to reclaim memory "
            "and resume", "train",
        )
        if sys.argv[0].endswith("__main__.py"):
            # `python -m bootstrapper_torch ...`: the module file can't
            # be re-run as a plain script (relative imports)
            argv = [sys.executable, "-m", "bootstrapper_torch"] + sys.argv[1:]
        else:
            argv = [sys.executable] + sys.argv
        os.execv(sys.executable, argv)
    cli_echo(f"done: {result}", "train")


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--volume", "-v", default=None)
@click.option("--batch-tiles", "-b", type=int, default=None,
              help="tiles per device step (default: 32 for 2D setups, "
              "1 for 3D — one 3D tile already fills the card)")
@click.option("--sharded", "-s", is_flag=False, flag_value="batch",
              default=None, type=click.Choice(["batch", "spatial"]),
              help="shard over --device's devices: 'batch' runs a batch of "
              "tiles (or lockstep z streams), one per device; 'spatial' "
              "splits one tile's extent over them (halo exchange)")
@click.option("--auto-tile", is_flag=True,
              help="maximise the inference tile for throughput")
@click.option("--roi-offset", nargs=3, type=int, default=None)
@click.option("--roi-shape", nargs=3, type=int, default=None)
@click.option("--setup-id", default=None,
              help="run only chain links whose setup name contains this")
def predict(config_file, volume, batch_tiles, sharded, auto_tile,
            roi_offset, roi_shape, setup_id):
    """Run chained prediction from a prediction config TOML."""
    from ..workflows.predict import run_prediction

    result = run_prediction(
        config_file,
        volume=volume,
        batch_tiles=batch_tiles,
        sharded=sharded,
        auto_tile=auto_tile,
        roi_offset=roi_offset or None,
        roi_shape=roi_shape or None,
        setup_id=setup_id,
        device=_devices() if sharded else _device(),
    )
    for k, v in result.items():
        cli_echo(
            f"{k}: {v['tiles']} tiles, {v['voxels_per_sec']/1e6:.2f} Mvox/s",
            "predict",
        )


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--mode", "-m", "modes", multiple=True,
              type=click.Choice(["ws", "mws", "cc"]),
              help="repeatable; default = every method with a "
                   "{method}_params table in the config, else ws")
@click.option("--volume", "-v", default=None)
@click.option("--param", "-p", multiple=True, help="key=value overrides")
@click.option("--roi-offset", "-ro", nargs=3, type=int, default=None)
@click.option("--roi-shape", "-rs", nargs=3, type=int, default=None)
@click.option("--blockwise/--no-blockwise", "-b/ ", default=None)
@click.option("--num-workers", "-n", type=int, default=None)
@click.option("--block-shape", "-bs", nargs=3, type=int, default=None)
@click.option("--block-context", "-bc", nargs=3, type=int, default=None)
def segment(config_file, modes, volume, param, roi_offset, roi_shape,
            blockwise, num_workers, block_shape, block_context):
    """Segment affinities (ws | mws | cc).

    With no -m, runs every method that has a ``{method}_params`` table
    in the config (reference ``segment.py:199-213``), falling back to
    plain watershed."""
    from ..utils import tomlio
    from ..workflows.segment import run_segmentation

    autodetected = not modes
    if autodetected:
        cfg = tomlio.load(config_file)
        cfg = cfg.get("segment", cfg)
        tables = set()
        for vol_name, vol_cfg in cfg.items():
            if volume is not None and vol_name != volume:
                continue
            if isinstance(vol_cfg, dict):
                tables |= {
                    m for m in ("ws", "mws", "cc")
                    if vol_cfg.get(f"{m}_params") is not None
                }
        modes = tuple(m for m in ("ws", "mws", "cc") if m in tables) or (
            "ws",
        )
    for mode in modes:
        result = run_segmentation(
            config_file, mode=mode, volume=volume, param_overrides=param,
            roi_offset=roi_offset or None, roi_shape=roi_shape or None,
            blockwise=blockwise, num_workers=num_workers,
            block_shape=block_shape or None, context=block_context or None,
            # auto-detected methods run only on volumes that configure
            # them; explicit -m applies everywhere
            require_params=autodetected and len(tables) > 0,
            device=_device(),
        )
        for vol, segs in result.items():
            for k, path in segs.items():
                cli_echo(f"{vol} [{k}]: {path}", "segment")


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--volume", "-v", default=None)
@click.option("--gt", "-gt", "gt_only", is_flag=True,
              help="evaluate only against ground truth")
@click.option("--pred", "-p", "pred_only", is_flag=True,
              help="evaluate only against predictions (self-eval)")
@click.option("--out-result", "-o", default=None)
def evaluate(config_file, volume, gt_only, pred_only, out_result):
    """Evaluate segmentations (GT metrics and/or self-eval errors)."""
    from ..workflows.evaluate import run_evaluation

    result = run_evaluation(
        config_file, volume=volume, gt_only=gt_only, pred_only=pred_only,
        out_result=out_result, device=_device(),
    )
    for vol, res in result.items():
        cli_echo(f"{vol}: {len(res)} segmentations evaluated", "evaluate")


@cli.command()
@click.argument("config_file", type=click.Path(exists=True))
@click.option("--volume", "-v", default=None)
@click.option("--param", "-p", multiple=True, help="key=value overrides")
@click.option("--roi-offset", "-ro", nargs=3, type=int, default=None)
@click.option("--roi-shape", "-rs", nargs=3, type=int, default=None)
@click.option("--num-workers", "-n", type=int, default=None)
@click.option("--block-shape", "-bs", nargs=3, type=int, default=None)
def filter(config_file, volume, param, roi_offset, roi_shape, num_workers,
           block_shape):
    """Filter the best segmentation into pseudo-GT for the next round."""
    from ..workflows.filter import run_filter

    result = run_filter(
        config_file, volume=volume, param_overrides=param,
        roi_offset=roi_offset or None, roi_shape=roi_shape or None,
        num_workers=num_workers, block_shape=block_shape or None,
    )
    for vol, res in result.items():
        cli_echo(
            f"{vol}: removed {res['removed_ids']} ids -> {res['labels']}",
            "filter",
        )


@cli.command()
@click.argument("config_files", nargs=-1, type=click.Path(exists=True))
def run(config_files):
    """Dispatch configs to the right workflow by their keys.

    A directory argument runs its numbered stage configs in order
    (01_train_* ... 05_filter) — one command for a whole round.
    """
    from ..utils import tomlio

    expanded = []
    for path in config_files:
        if os.path.isdir(path):
            expanded.extend(
                sorted(
                    os.path.join(path, f)
                    for f in os.listdir(path)
                    if f.endswith(".toml") and f[0].isdigit()
                )
            )
        else:
            expanded.append(path)

    for config_file in expanded:
        cfg = tomlio.load(config_file)
        keys = set(cfg)
        ctx = click.get_current_context()
        if "train" in keys or "setup_dir" in keys:
            ctx.invoke(train, config_file=config_file)
        elif "predict" in keys or any(
            "chain" in v for v in cfg.values() if isinstance(v, dict)
        ):
            ctx.invoke(predict, config_file=config_file)
        elif "segment" in keys or any(
            "affs_dataset" in v for v in cfg.values() if isinstance(v, dict)
        ):
            ctx.invoke(segment, config_file=config_file)
        elif "evaluate" in keys or any(
            "seg_datasets_prefix" in v and "out_seg_dataset_prefix" not in v
            for v in cfg.values()
            if isinstance(v, dict)
        ):
            ctx.invoke(evaluate, config_file=config_file)
        elif "filter" in keys or any(
            "out_seg_dataset_prefix" in v
            for v in cfg.values()
            if isinstance(v, dict)
        ):
            ctx.invoke(filter, config_file=config_file)
        else:
            raise click.UsageError(
                f"cannot infer workflow from keys of {config_file}: {keys}"
            )


@cli.command()
@click.argument("raw_path")
@click.option("--affs", "-a", default=None,
              help="affinity predictions dataset (prompt growing)")
@click.option("--sam-checkpoint", default=None,
              help="official sam_vit_*.pth weights; enables real SAM "
              "mask-from-point (default: $BS_SAM_CHECKPOINT)")
@click.option("--out", "-o", default=None,
              help="output container for written labels+mask")
@click.option("--script", type=click.File("r"), default=None,
              help="read commands from a file instead of stdin")
def proofread(raw_path, affs, sam_checkpoint, out, script):
    """Point-prompted proofreading session (reference
    ``ng_interactive_sam.py`` capability, terminal-native); SAM runs on
    ``--device``.

    Commands, one per line (world-unit coordinates):

    \b
      point Z Y X     grow a segment from a point prompt
      merge ID ID..   merge segments into the first id
      unmerge ID      split a segment into connected components
      omit ID         exclude a segment from the output mask
      delete ID       erase a segment
      filter MIN      drop segments smaller than MIN voxels
      write [PATH]    write labels + mask Zarrs
      quit
    """
    import sys as _sys

    from ..core.arrays import open_ds
    from ..proofread import ProofreadSession

    session = ProofreadSession(
        open_ds(raw_path),
        affs=open_ds(affs) if affs else None,
        sam_checkpoint=sam_checkpoint,
        device=_device(),
    )
    cli_echo(
        f"session over {raw_path}"
        + (" (SAM)" if session._sam is not None else " (affinity prompting)"),
        "proofread",
    )
    stream = script or _sys.stdin
    for line in stream:
        parts = line.split()
        if not parts:
            continue
        cmd, args = parts[0].lower(), parts[1:]
        try:
            if cmd in ("quit", "exit", "q"):
                break
            elif cmd == "point":
                sid = session.segment_from_point(tuple(float(v) for v in args[:3]))
                cli_echo(f"segment {sid}", "proofread")
            elif cmd == "merge":
                kept = session.merge([int(a) for a in args])
                cli_echo(f"merged into {kept}", "proofread")
            elif cmd == "unmerge":
                new = session.unmerge(int(args[0]))
                cli_echo(f"split into {new}", "proofread")
            elif cmd == "omit":
                session.omit(int(args[0]))
            elif cmd == "delete":
                session.delete(int(args[0]))
            elif cmd == "filter":
                n = session.filter_small(int(args[0]))
                cli_echo(f"removed {n} small segments", "proofread")
            elif cmd == "write":
                dest = args[0] if args else out
                if not dest:
                    raise click.UsageError("write needs a PATH (or --out)")
                written = session.write(dest)
                cli_echo(f"wrote {written}", "proofread")
            else:
                cli_echo(f"unknown command: {cmd}", "proofread")
        except (ValueError, IndexError) as e:
            cli_echo(f"bad command {line.strip()!r}: {e}", "proofread")


@cli.command()
@click.argument("paths", nargs=-1)
@click.option("--snapshot", "-s", is_flag=True, help="view a snapshot zarr")
def view(paths, snapshot):
    """Inspect Zarr datasets (neuroglancer when available, else a text
    summary of shapes/dtypes/ROIs)."""
    from .viewer import view_datasets

    view_datasets(paths, snapshot=snapshot)


# utils subgroup + doctor live in their own modules
from .doctor import doctor_command  # noqa: E402
from .utils_cmds import utils  # noqa: E402

cli.add_command(utils)
cli.add_command(doctor_command)


def main(argv=None, standalone_mode: bool = False) -> int:
    """Run one ``bs`` command on ``argv`` (default: this process's
    arguments) and return its exit code.  Not standalone, a command's
    errors raise and ``main`` returns; standalone (``python -m
    bootstrapper_torch``), click reports them and exits."""
    rv = cli.main(args=argv, prog_name="bs-torch", standalone_mode=standalone_mode)
    return rv if isinstance(rv, int) else 0
