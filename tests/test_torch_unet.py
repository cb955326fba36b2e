"""bootstrapper_torch U-Net and Model against the JAX package's, in fp32
on the CPU (rtol 1e-4 on sigmoid outputs: only summation order differs).

Both packages get the same weights: JAX ``Model.init`` params (or a
shipped checkpoint) converted with ``np.asarray``, loaded into the port
through ``params_from_jax`` / ``load_checkpoint``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.models import (
    Model,
    init_params_numpy,
    load_checkpoint,
    load_params,
    params_from_jax,
    save_checkpoint,
)
from bootstrapper_torch.models import unet as U
from bootstrapper_torch.models.model import unet_config
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_tpu.models import unet as JU
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.train.loop import load_params as jax_load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ["3d_affs_from_2d_affs", "3d_affs_from_2d_lsd", "3d_affs_from_2d_mtlsd", "3d_affs_from_3d_lsd"]
# smallest valid input of the 3d_affs geometry: output (1, 8, 8)
SMALL_INPUT = (29, 100, 100)


def _narrow(num_fmaps, inc):
    nc = get_net_config("3d_affs")
    nc.update(num_fmaps=num_fmaps, fmap_inc_factor=inc)
    return nc


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize(
    "num_fmaps,inc",
    [
        (4, 2),  # every conv narrower than 128 channels: library route
        (4, 6),  # 144- and 864-channel levels take the kernel route
    ],
)
def test_forward_matches_jax_fp32(num_fmaps, inc):
    nc = _narrow(num_fmaps, inc)
    jm = JModel(nc, compute_dtype=jnp.float32)
    params = _numpy_tree(jm.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).uniform(-1, 1, (1, *SMALL_INPUT, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x))["3d_affs"])

    model = load_params(Model(nc, compute_dtype=torch.float32), params).eval()
    before = dict(C.COUNTS)
    with torch.no_grad():
        got = model(torch.from_numpy(x))["3d_affs"].numpy()
    assert got.shape == ref.shape == (1, 1, 8, 8, 9)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert C.COUNTS["library"] > before["library"]
    assert (C.COUNTS["plain"] > before["plain"]) == (num_fmaps * inc**2 >= 128)


@pytest.mark.parametrize("setup", SHIPPED)
def test_shipped_checkpoint_matches_jax_fp32(setup):
    """``pretrained/<setup>``: each package loads the npz with its own
    loader; compared at the setup's 24x148x148 input in fp32."""
    pretrained = os.path.join(REPO, "pretrained", setup)
    ckpt = os.path.join(pretrained, "model_checkpoint_20000")
    nc = get_net_config(pretrained)
    jm = JModel(nc, compute_dtype=jnp.float32)
    in_ch = sum(i["dims"] for i in nc["inputs"].values())
    x = np.random.default_rng(1).uniform(0, 1, (1, *nc["input_shape"], in_ch))
    x = x.astype(np.float32)
    ref = np.asarray(
        jax.jit(jm.apply)(jax_load_params(ckpt), jnp.asarray(x))["3d_affs"]
    )

    model = load_params(
        Model(nc, compute_dtype=torch.float32), load_checkpoint(ckpt)
    ).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))["3d_affs"].numpy()
    assert got.shape == ref.shape == (1, *nc["output_shape"], 9)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_state_dict_keys_and_numpy_init_match_jax_layout():
    nc = get_net_config("3d_affs")
    nc.update(num_fmaps=2, fmap_inc_factor=2)
    jparams = JModel(nc).init(jax.random.PRNGKey(0))
    nparams = init_params_numpy(nc, seed=0)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    nleaves = jax.tree_util.tree_leaves_with_path(nparams)
    assert [p for p, _ in jleaves] == [p for p, _ in nleaves]
    assert [v.shape for _, v in jleaves] == [v.shape for _, v in nleaves]
    model = Model(nc)
    assert set(params_from_jax(_numpy_tree(jparams))) == set(model.state_dict())


def test_checkpoint_round_trip_through_both_loaders(tmp_path):
    nc = _narrow(2, 2)
    params = init_params_numpy(nc, seed=3)
    path = save_checkpoint(str(tmp_path), params, 7)
    assert os.path.basename(path) == "model_checkpoint_7"
    ours = params_from_jax(load_checkpoint(path))
    theirs = params_from_jax(_numpy_tree(jax_load_params(path)))
    want = params_from_jax(params)
    for k, v in want.items():
        assert torch.equal(ours[k], v) and torch.equal(theirs[k], v)


def test_upsample_pool_crop_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 5, 7, 6, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(
        U.upsample_resize(t, (1, 2, 2)).numpy(),
        np.asarray(JU.upsample_resize(jnp.asarray(x), (1, 2, 2))),
        rtol=1e-5, atol=1e-6,
    )
    y = rng.normal(size=(1, 4, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        U.max_pool(torch.from_numpy(y), (1, 2, 2)).numpy(),
        np.asarray(JU.max_pool(jnp.asarray(y), (1, 2, 2))),
    )
    with pytest.raises(ValueError):
        U.max_pool(torch.from_numpy(x), (1, 2, 2))
    k = [(3, 3, 3), (3, 3, 3)]
    z = rng.normal(size=(1, 12, 27, 30, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        U.crop_to_factor(torch.from_numpy(z), (1, 4, 4), k).numpy(),
        np.asarray(JU.crop_to_factor(jnp.asarray(z), (1, 4, 4), k)),
    )


@pytest.mark.parametrize(
    "shape", [(29, 100, 100), (32, 196, 196), (32, 412, 412), (30, 101, 100)]
)
def test_output_shape_algebra_matches_jax(shape):
    nc = get_net_config("3d_affs")
    jcfg = JModel(nc).unet_config
    try:
        want = JU.compute_output_shape(jcfg, shape)
    except ValueError:
        with pytest.raises(ValueError):
            U.compute_output_shape(unet_config(nc), shape)
        return
    assert U.compute_output_shape(unet_config(nc), shape) == want
