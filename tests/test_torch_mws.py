"""bootstrapper_torch's mws and cc segmentation (``post/fragments.py``,
``post/segment.py``, ``workflows/segment.py``) against the JAX package's,
on the same affinities made from a seed.  Labels are integers: every
comparison is exact, dataset names included."""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.ops.affinities import seg_to_affs
from bootstrapper_torch.post import segment as S
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows.segment import get_seg_config, run_segmentation
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.post import segment as JS
from bootstrapper_tpu.workflows.segment import get_seg_config as jax_get_seg_config
from bootstrapper_tpu.workflows.segment import run_segmentation as jax_run_segmentation

NBHD = S.MWS_DEFAULT_NEIGHBORHOOD
# direct neighbours and long-range offsets interleaved
CUSTOM_NBHD = [[-1, 0, 0], [0, -9, 0], [0, -1, 0], [0, 0, -9], [0, 0, -1], [-2, 0, 0]]
CUSTOM_STRIDES = [[1, 1, 1], [1, 3, 3], [1, 1, 1], [1, 3, 3], [1, 1, 1], [2, 2, 2]]


def _labels(shape, n, seed):
    """Voronoi cells (anisotropic z) with a little background."""
    rng = np.random.default_rng(seed)
    seeds = np.zeros(shape, np.int32)
    pts = (rng.uniform(0, 1, (n, len(shape))) * np.array(shape)).astype(int)
    seeds[tuple(pts.T)] = np.arange(1, n + 1)
    idx = ndimage.distance_transform_edt(seeds == 0, sampling=[4] + [1] * (len(shape) - 1),
                                         return_distances=False, return_indices=True)
    lab = seeds[tuple(idx)]
    lab[rng.random(shape) < 0.02] = 0
    return lab


def _affs(nbhd, shape=(8, 64, 64), seed=0, n=30, blur=1.0, noise=0.15):
    """The labels' affinities over ``nbhd``, blurred in xy and noised,
    clipped to [0, 1] (float32)."""
    rng = np.random.default_rng(seed)
    lab = _labels(shape, n, seed)
    if len(shape) == 2:  # a 2D neighbourhood: one section of a 3D volume
        a = seg_to_affs(torch.from_numpy(lab[None].astype(np.int64)), [[0, *o] for o in nbhd]).numpy()[:, 0]
    else:
        a = seg_to_affs(torch.from_numpy(lab.astype(np.int64)), nbhd).numpy()
    a = ndimage.gaussian_filter(a, sigma=(0,) * (a.ndim - 2) + (blur, blur)) + rng.normal(0, noise, a.shape)
    return np.clip(a, 0, 1).astype(np.float32)


def _as_uint8(a):
    return np.round(a * 255).astype(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize(
    "kw",
    [
        # the workflow's defaults: randomized strides, noise, debris removal
        {k: v for k, v in S.METHOD_DEFAULTS["mws"].items() if k != "global_bias_sweep"},
        # smoothed affinities, fixed strides, no noise
        {"neighborhood": NBHD, "bias": S.MWS_DEFAULT_BIAS, "sigma": (0, 2, 2), "noise_eps": None,
         "strides": S.MWS_DEFAULT_STRIDES, "randomized_strides": False, "remove_debris": 0},
    ],
    ids=["defaults", "sigma"],
)
def test_mws_segmentation_exact(kw, dtype):
    a = _affs(NBHD)
    if dtype == "uint8":
        a = _as_uint8(a)
    got, want = S.mws_segmentation(a, **kw), JS.mws_segmentation(a, **kw)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 10


@pytest.mark.parametrize("randomized", [True, False])
def test_mws_edge_list_path_exact(randomized):
    """A 2D neighbourhood: not the dense native path but ``_grid_edges``
    and the edge-list clustering."""
    nbhd = [[-1, 0], [0, -1], [-9, 0], [0, -9]]
    a = _affs(nbhd, shape=(96, 96), n=25)
    kw = dict(neighborhood=nbhd, bias=[-0.4, -0.4, -0.7, -0.7], sigma=None, noise_eps=0.001,
              strides=[[1, 1], [1, 1], [3, 3], [3, 3]], randomized_strides=randomized, remove_debris=16)
    got, want = S.mws_segmentation(a, **kw), JS.mws_segmentation(a, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (96, 96) and len(np.unique(got)) > 5


@pytest.mark.parametrize("threshold", [0.3, 0.6])
def test_cc_segmentation_exact(threshold):
    a = _affs(NBHD, blur=0, noise=0.1)[:3]
    for x in (a, _as_uint8(a)):
        got = S.cc_segmentation(x, threshold=threshold, remove_debris=64)
        np.testing.assert_array_equal(got, JS.cc_segmentation(x, threshold=threshold, remove_debris=64))
        assert len(np.unique(got)) > 2


def test_seg_config_matches_jax():
    """Method defaults, the volume's ``<method>_params`` and overrides, as
    the JAX package merges them; ws keeps its defaults."""
    cfg = {"mws_params": {"bias": [-0.5] * 9}, "cc_params": {"threshold": 0.4}}
    for method in ("ws", "mws", "cc"):
        for overrides in ((), ("remove_debris=8", "thresholds=[0.5]", "merge_function=max")):
            assert get_seg_config(cfg, method, overrides) == jax_get_seg_config(cfg, method, overrides)
    assert get_seg_config({}, "ws") == S.WS_DEFAULTS


@pytest.fixture(scope="module")
def affs_paths(tmp_path_factory):
    """Uint8 affinities over the default and a custom neighbourhood, as
    Zarr written by the port."""
    work = tmp_path_factory.mktemp("mws")
    paths = {}
    for name, nbhd in (("default", NBHD), ("custom", CUSTOM_NBHD)):
        a = _as_uint8(_affs(nbhd, seed=2, blur=0, noise=0.1))
        paths[name] = str(work / "affs.zarr" / name)
        ds = A.prepare_ds(paths[name], a.shape, (0, 0, 0), (40, 4, 4), np.uint8, chunk_shape=(3, 4, 32, 32))
        ds[ds.roi] = a
    return work, paths


def _segment_both(work, affs, method, params, overrides=()):
    """Both packages' ``run_segmentation`` over one volume: their results
    with dataset paths made relative to each package's prefix."""
    out = {}
    for pkg, run, open_ds in (("port", run_segmentation, A.open_ds), ("jax", jax_run_segmentation, jax_open_ds)):
        prefix = str(work / pkg / f"{method}_{len(overrides)}")
        cfg = {"vol": {"affs_dataset": affs, "seg_dataset_prefix": prefix, f"{method}_params": params}}
        toml = str(work / f"{pkg}_{method}.toml")
        tomlio.dump({"segment": cfg}, toml)
        kw = {"device": "cpu"} if pkg == "port" else {}
        res = run(toml, mode=method, param_overrides=overrides, **kw)["vol"]
        out[pkg] = {k: os.path.relpath(v, prefix) for k, v in res.items()}
        out[pkg + "_arrays"] = {k: open_ds(v).to_ndarray() for k, v in res.items()}
    return out


@pytest.mark.parametrize(
    "case",
    ["mws_defaults", "mws_bias_sweep_custom_nbhd", "cc_default", "cc_override"],
)
def test_run_segmentation_exact(affs_paths, case):
    work, paths = affs_paths
    if case == "mws_defaults":
        out = _segment_both(work, paths["default"], "mws", {})
        want_names = {"mws": "mws"}
    elif case == "mws_bias_sweep_custom_nbhd":
        params = {"neighborhood": CUSTOM_NBHD, "bias": [-0.5] * 6, "strides": CUSTOM_STRIDES}
        out = _segment_both(work, paths["custom"], "mws", params, ("bias_sweep=[[-0.3, -0.8], [-0.45, -0.6]]",))
        want_names = {k: k for k in ("mws--a-0.3_l-0.8", "mws--a-0.45_l-0.6")}
    elif case == "cc_default":
        out = _segment_both(work, paths["default"], "cc", {})
        want_names = {"cc": "cc--0_5"}
    else:
        out = _segment_both(work, paths["default"], "cc", {"remove_debris": 0}, ("threshold=0.35",))
        want_names = {"cc": "cc--0_35"}
    assert out["port"] == out["jax"] == want_names
    for k, got in out["port_arrays"].items():
        assert got.dtype == np.uint64 and got.shape == (8, 64, 64)
        np.testing.assert_array_equal(got, out["jax_arrays"][k])
        assert len(np.unique(got)) > 2
    if case == "mws_bias_sweep_custom_nbhd":  # the two points segment differently
        a, b = out["port_arrays"].values()
        assert not np.array_equal(a, b)


def test_require_params_skips_volumes(affs_paths, tmp_path):
    """A volume that did not configure the method is skipped."""
    work, paths = affs_paths
    cfg = {
        "a": {"affs_dataset": paths["default"], "seg_dataset_prefix": str(tmp_path / "a"), "cc_params": {}},
        "b": {"affs_dataset": paths["default"], "seg_dataset_prefix": str(tmp_path / "b")},
    }
    toml = str(tmp_path / "seg.toml")
    tomlio.dump({"segment": cfg}, toml)
    assert sorted(run_segmentation(toml, mode="cc", require_params=True)) == ["a"]
    assert sorted(jax_run_segmentation(toml, mode="cc", require_params=True)) == ["a"]
    with pytest.raises(ValueError, match="unknown segmentation mode"):
        run_segmentation(toml, mode="lmc")
