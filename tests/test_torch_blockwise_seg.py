"""bootstrapper_torch's blockwise segmentation (``post/blockwise_seg.py``
and ``run_segmentation(..., blockwise=True)``) against the JAX package's,
on the same affinities made from a seed.  Each package writes them with
its own ``prepare_ds``; the port runs with ``device="cpu"``, the JAX
package as its own tests run it.

Fragment ids are ``dense + block_id * voxels_per_block`` in both, so
fragments are held to equality.  A segment's id is whichever fragment id
union-find picks, which can depend on the order in which threads wrote
RAG rows, so segmentations are held to the same partition and the same
background."""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from scipy import ndimage

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.core.geometry import Roi
from bootstrapper_torch.ops import seeds
from bootstrapper_torch.ops.affinities import seg_to_affs
from bootstrapper_torch.post import blockwise_seg as B
from bootstrapper_torch.post import fragments as F
from bootstrapper_torch.post.rag import RagDB
from bootstrapper_torch.post.segment import METHOD_DEFAULTS, MWS_DEFAULT_NEIGHBORHOOD, cc_segmentation
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows.segment import run_segmentation
from bootstrapper_tpu.core import arrays as JA
from bootstrapper_tpu.post import blockwise_seg as JB
from bootstrapper_tpu.workflows.segment import run_segmentation as jax_run_segmentation

SHAPE = (8, 64, 64)
BLOCK = (4, 32, 32)  # 2 x 2 x 2 blocks
CONTEXT = (2, 8, 8)
VOXEL_SIZE = (4, 1, 1)


def _labels(shape, n, seed):
    """Voronoi cells (anisotropic z) with a little background."""
    rng = np.random.default_rng(seed)
    seeds_ = np.zeros(shape, np.int32)
    pts = (rng.uniform(0, 1, (n, 3)) * np.array(shape)).astype(int)
    seeds_[tuple(pts.T)] = np.arange(1, n + 1)
    idx = ndimage.distance_transform_edt(seeds_ == 0, sampling=[4, 1, 1], return_distances=False,
                                         return_indices=True)
    lab = seeds_[tuple(idx)]
    lab[rng.random(shape) < 0.02] = 0
    return lab


def _affs(shape=SHAPE, seed=0, n=30, nbhd=MWS_DEFAULT_NEIGHBORHOOD):
    """The labels' affinities over ``nbhd``, blurred in xy and noised, as
    uint8 (what ``predict`` writes), and the labels."""
    rng = np.random.default_rng(seed)
    lab = _labels(shape, n, seed)
    a = seg_to_affs(torch.from_numpy(lab.astype(np.int64)), nbhd).numpy()
    a = ndimage.gaussian_filter(a, sigma=(0, 0, 1.0, 1.0)) + rng.normal(0, 0.15, a.shape)
    return np.round(np.clip(a, 0, 1) * 255).astype(np.uint8), lab


def _write(root, affs, offset=(0, 0, 0)):
    """``affs`` into ``root/port.zarr`` and ``root/jax.zarr``, each by its
    package's ``prepare_ds``; returns the two dataset paths."""
    out = []
    for prepare, name in ((A.prepare_ds, "port"), (JA.prepare_ds, "jax")):
        path = os.path.join(str(root), f"{name}.zarr", "affs")
        ds = prepare(path, affs.shape, offset, VOXEL_SIZE, affs.dtype)
        ds[ds.roi] = affs
        out.append(path)
    return out


def _read(path):
    return A.open_ds(path).to_ndarray()


def _read_jax(path):
    return np.asarray(JA.open_ds(path).to_ndarray())


def assert_same_partition(got, want):
    """Same background, and a one-to-one map between the two id sets."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    m = got != 0
    pairs = np.unique(np.stack([got[m], want[m]]), axis=1)
    assert pairs.shape[1] == len(np.unique(got[m])) == len(np.unique(want[m]))


def _segment_toml(root, name, affs_path, **extra):
    cfg = {
        "vol": {
            "affs_dataset": affs_path,
            "seg_dataset_prefix": os.path.join(str(root), f"{name}.zarr", "segmentations"),
            **extra,
        }
    }
    path = os.path.join(str(root), f"{name}_segment.toml")
    tomlio.dump({"segment": cfg}, path)
    return path


def _rel(result, root):
    return {v: {k: os.path.relpath(p, str(root)) for k, p in d.items()} for v, d in result.items()}


@pytest.mark.parametrize(
    "mode, overrides",
    [
        ("ws", ("thresholds=[0.35, 0.5]",)),
        # the defaults' global bias sweep: three points over one RAG
        ("mws", ()),
        ("cc", ("remove_debris=0",)),
    ],
)
def test_run_segmentation_blockwise_matches_jax(tmp_path, mode, overrides):
    """``run_segmentation(blockwise=True)`` in each mode: the same dataset
    paths (relative to each package's container) as the JAX
    ``run_segmentation``, the same fragments, and per dataset the same
    partition and background."""
    affs, _ = _affs()
    port_affs, jax_affs = _write(tmp_path, affs)
    kw = dict(mode=mode, param_overrides=overrides, blockwise=True, num_workers=4,
              block_shape=BLOCK, context=CONTEXT)
    got = run_segmentation(_segment_toml(tmp_path, "port", port_affs), device="cpu", **kw)
    want = jax_run_segmentation(_segment_toml(tmp_path, "jax", jax_affs), **kw)
    assert _rel(got, tmp_path / "port.zarr") == _rel(want, tmp_path / "jax.zarr")
    if mode == "mws":
        assert len(got["vol"]) == len(METHOD_DEFAULTS["mws"]["global_bias_sweep"])
    np.testing.assert_array_equal(
        _read(str(tmp_path / "port.zarr" / f"fragments_{mode}")),
        _read_jax(str(tmp_path / "jax.zarr" / f"fragments_{mode}")),
    )
    for key, path in got["vol"].items():
        seg = _read(path)
        assert_same_partition(seg, _read_jax(want["vol"][key]))
        assert 1 < len(np.unique(seg)) < seg.size // 4
    if mode == "cc":  # blockwise cc is exact: in-memory cc's partition
        assert_same_partition(_read(got["vol"]["cc"]), cc_segmentation(affs, threshold=0.5))


@pytest.mark.parametrize(
    "kw",
    [
        {"epsilon_agglomerate": 0.1, "replace_sections": [2, 5]},
        {"filter_fragments": 0.3, "merge_function": "hist_quant_75"},
    ],
    ids=["epsilon_replace_sections", "filter_hist_quant"],
)
def test_ws_pipeline_blockwise_matches_jax(tmp_path, kw):
    """The ws pipeline's options: the same fragments, and each threshold's
    partition."""
    affs, _ = _affs(nbhd=[[-1, 0, 0], [0, -1, 0], [0, 0, -1]], seed=1)
    port_affs, jax_affs = _write(tmp_path, affs)
    common = dict(block_shape=BLOCK, context_voxels=CONTEXT, thresholds=[0.2, 0.5], num_workers=4, **kw)
    got = B.waterz_pipeline_blockwise(port_affs, str(tmp_path / "port.zarr"), device="cpu", **common)
    want = JB.waterz_pipeline_blockwise(jax_affs, str(tmp_path / "jax.zarr"), **common)
    frags = _read(str(tmp_path / "port.zarr" / "fragments_ws"))
    np.testing.assert_array_equal(frags, _read_jax(str(tmp_path / "jax.zarr" / "fragments_ws")))
    if "replace_sections" in kw:
        assert not frags[list(kw["replace_sections"])].any() and frags.any()
    assert set(got) == set(want)
    for t in got:
        assert_same_partition(_read(got[t]), _read_jax(want[t]))


def test_cc_pipeline_blockwise_debris_roi_and_low_block(tmp_path):
    """cc with ``remove_debris``, restricted to an ROI that starts inside
    the volume (its processed-ROI boundary behaves like a volume
    boundary), and a near-background uint8 block (max value 1, read as
    1/255, not normalised by its max): equal to in-memory cc on the same
    ROI and to the JAX pipeline."""
    affs, _ = _affs(nbhd=[[-1, 0, 0], [0, -1, 0], [0, 0, -1]], seed=2)
    affs[:, 4:, 32:, 32:] = np.minimum(affs[:, 4:, 32:, 32:], 1)
    port_affs, jax_affs = _write(tmp_path, affs)
    # voxels (2:8, 8:64, 16:64): the block grid starts at the ROI, and its
    # chunks with it
    roi = Roi((2 * VOXEL_SIZE[0], 8, 16), (6 * VOXEL_SIZE[0], 56, 48))
    common = dict(threshold=0.5, remove_debris=20, block_shape=BLOCK, context_voxels=(1, 2, 2), num_workers=4,
                  roi=roi)
    got = B.cc_pipeline_blockwise(port_affs, str(tmp_path / "port.zarr"), device="cpu", **common)
    want = JB.cc_pipeline_blockwise(jax_affs, str(tmp_path / "jax.zarr"), **common)
    seg = A.open_ds(got["cc"])
    assert seg.roi == roi and seg.store.chunks == BLOCK
    ref = cc_segmentation(affs[:, 2:, 8:, 16:], threshold=0.5, remove_debris=20)
    assert_same_partition(seg.to_ndarray(), ref)
    assert_same_partition(seg.to_ndarray(), _read_jax(want["cc"]))
    # the low block: every affinity <= 1/255, so all background
    assert not seg.to_ndarray()[2:, 24:, 16:].any() and seg.to_ndarray().any()


def test_find_segments_drops_dangling_edges(tmp_path):
    """Edges whose endpoints are missing from the node table (a partly
    written RAG) are dropped, not mapped to a neighbouring id; the LUT
    equals the JAX package's."""
    from bootstrapper_tpu.post.rag import RagDB as JaxRagDB

    luts = []
    for rag_cls, find, name in ((RagDB, B.find_segments, "port"), (JaxRagDB, JB.find_segments, "jax")):
        db = rag_cls(str(tmp_path / f"{name}.db"), mode="w")
        db.write_nodes([10, 20, 30, 40], np.zeros((4, 3)))
        db.write_edges([10, 15, 99, 30], [20, 30, 30, 40], [0.1, 0.1, 0.1, 0.9])
        paths = find(db, str(tmp_path / f"{name}_luts"), [0.5, 1.0])
        luts.append({t: np.load(p)["fragment_segment_lut"] for t, p in paths.items()})
    for t in (0.5, 1.0):
        np.testing.assert_array_equal(luts[0][t], luts[1][t])
    m = dict(zip(*luts[0][0.5].tolist()))
    assert m[10] == m[20] and m[30] not in (m[10], m[40])
    m = dict(zip(*luts[0][1.0].tolist()))
    assert m[30] == m[40] != m[10]


def test_ws_sharded_workers_match_one_process(tmp_path):
    """``workers=2`` (two worker processes, each a stride-shard of every
    block grid, synchronised by a ledger) gives the fragments and the
    partitions of one process."""
    affs, _ = _affs(nbhd=[[-1, 0, 0], [0, -1, 0], [0, 0, -1]], seed=3)
    path, _ = _write(tmp_path, affs)
    common = dict(block_shape=BLOCK, context_voxels=CONTEXT, thresholds=[0.5], num_workers=2, device="cpu")
    one = B.waterz_pipeline_blockwise(path, str(tmp_path / "one.zarr"), **common)
    two = B.waterz_pipeline_blockwise(path, str(tmp_path / "two.zarr"), workers=2,
                                      ledger=str(tmp_path / "ledger.db"), **common)
    np.testing.assert_array_equal(_read(str(tmp_path / "one.zarr" / "fragments_ws")),
                                  _read(str(tmp_path / "two.zarr" / "fragments_ws")))
    assert_same_partition(_read(two[0.5]), _read(one[0.5]))


@pytest.mark.parametrize("failure", ["kernel_raises", "no_card"])
def test_ws_seed_failure_ends_the_run(tmp_path, monkeypatch, failure):
    """A block whose seeds fail (the kernel raised) ends the run as the
    engine's RuntimeError after its retries: no block is skipped and none
    seeded elsewhere.  Without a card, the default device raises before
    the first block."""
    affs, _ = _affs(nbhd=[[-1, 0, 0], [0, -1, 0], [0, 0, -1]], seed=4)
    path, _ = _write(tmp_path, affs)
    calls = []
    if failure == "kernel_raises":
        def launch(dist, mask, size):
            calls.append(tuple(dist.shape))
            raise RuntimeError("seed kernel launch failed: cudaError 700")

        monkeypatch.setattr(F, "seed_maxima_3d", launch)
        device, match = "cpu", "blockwise task 'extract_fragments_ws' failed on 8/8 blocks"
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        device, match = None, "no CUDA device"
    with pytest.raises(RuntimeError, match=match):
        B.waterz_pipeline_blockwise(path, str(tmp_path / "out.zarr"), block_shape=BLOCK,
                                    context_voxels=CONTEXT, thresholds=[0.5], num_workers=4, device=device)
    # each of the 8 blocks tried once and retried 5 times, all through the kernel
    assert len(calls) == (48 if failure == "kernel_raises" else 0)
    if failure == "kernel_raises":
        assert not _read(str(tmp_path / "out.zarr" / "fragments_ws")).any()


def test_seed_launch_count_is_thread_safe():
    """The seed kernel's launch count loses no launch when many threads
    count at once (the blockwise pool launches from its threads)."""
    before = seeds.COUNTS["kernel"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [seeds.count_launch() for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert seeds.COUNTS["kernel"] - before == 16 * 2000
    seeds.COUNTS["kernel"] = before


def test_zarr_chunk_writes_from_threads(tmp_path):
    """Threads of one process that write one chunk at once each write
    through a temporary file of their own; ``open_ds`` takes the JAX
    package's ``mode``."""
    ds = A.prepare_ds(str(tmp_path / "a.zarr" / "x"), (4, 16, 16), (0, 0, 0), (1, 1, 1), np.uint64,
                      chunk_shape=(4, 16, 16))
    errors = []

    def write(value):
        try:
            for _ in range(10):
                ds[ds.roi] = np.full((4, 16, 16), value, np.uint64)
        except OSError as e:  # a temporary file another thread moved
            errors.append(e)

    threads = [threading.Thread(target=write, args=(7,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    back = A.open_ds(str(tmp_path / "a.zarr" / "x"), mode="r+")
    assert (back.to_ndarray() == 7).all()
    assert not [f for f in os.listdir(tmp_path / "a.zarr" / "x") if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="mode"):
        A.open_ds(str(tmp_path / "a.zarr" / "x"), mode="w")
