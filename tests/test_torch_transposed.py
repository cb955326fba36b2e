"""Transposed-conv upsampling (``constant_upsample = false``) in the port
against the JAX package, on the CPU from the same numpy inputs and
parameters:

- ``upsample_transposed`` against the JAX op at four factors, in fp32
  within 1e-5, with a distinct weight at every kernel offset (a kernel
  read unflipped fails);
- the reference converter against ``torch.nn.ConvTranspose3d``/``2d`` and
  leaf for leaf against the JAX converter, a missing key reported;
- a narrow 3-level U-Net, 3D and 2D: forward in fp32 within 1e-4 of the
  JAX model's (rtol on sigmoid outputs), in bf16 within bf16 noise of the
  JAX bf16 forward (atol 2e-2), and under ``BS_INT8=1`` at
  ``test_torch_quant.py``'s tolerance (atol 1e-6 of the largest output);
- training: loss and gradients (``r_up`` included) within rtol 1e-4,
  three Adam steps' losses within rtol 1e-4 of optax's, checkpoints with
  Adam state both ways;
- ``run_prediction`` of a volume deeper than one tiled pass: the stream
  declines the net, and the tiled affinities are within +-1 of the JAX
  ``Predictor``'s; the batch-sharded predictor equal to one device, the
  spatially split tile equal to the whole tile's forward (a transposed
  upsample reaches no voxel across a slab seam, where the trilinear one
  clamps).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, init_params_numpy, load_params, save_checkpoint
from bootstrapper_torch.models import convert_torch as CT
from bootstrapper_torch.models import unet as U
from bootstrapper_torch.models import weights as W
from bootstrapper_torch.models.model import unet_config
from bootstrapper_torch.models.unet import compute_output_shape, min_input_shape
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.models.zstream import stream_eligible
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_torch.ops import quant as Q
from bootstrapper_torch.predict import spatial as S
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs
from bootstrapper_torch.predict.sharded import ShardedPredictor
from bootstrapper_torch.train import loop as L
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_prediction
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models import convert_torch as JCT
from bootstrapper_tpu.models import model as JM
from bootstrapper_tpu.models import unet as JU
from bootstrapper_tpu.models import zstream as JZ
from bootstrapper_tpu.predict.scan import Predictor as JPredictor
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs
from bootstrapper_tpu.train import loop as JL
from test_torch_train_loop import narrow_net_config

VOXEL = (40, 4, 4)
LR = 0.5e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU threads: the test run uses several
    worker processes at once, and torch's thread pools in all of them
    oversubscribe the cores; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sized(nc, start):
    cfg = unet_config(nc)
    nc["input_shape"] = list(min_input_shape(cfg, start))
    nc["output_shape"] = list(compute_output_shape(cfg, nc["input_shape"]))
    return nc


def net_3d():
    """``narrow_net_config`` (3 levels, 3 -> 21 -> 147 channels: the 147-
    channel convs take the kernel route, and the 147-channel upsample's
    output lies on a padded channel pitch) with transposed upsampling."""
    nc = narrow_net_config()
    nc["constant_upsample"] = False
    return nc


def net_2d():
    """2d_affs with two downsamples and 3 -> 9 -> 27 channels, transposed."""
    nc = get_net_config("2d_affs")
    nc.update(
        num_fmaps=3, fmap_inc_factor=3, downsample_factors=[[2, 2], [2, 2]],
        kernel_size_down=nc["kernel_size_down"][:3], kernel_size_up=nc["kernel_size_up"][:2],
        constant_upsample=False,
    )
    return _sized(nc, (40, 40))


NETS = {"3d": net_3d, "2d": net_2d}


def _input(nc, seed, n=1):
    shape = (n, nc["adj_slices"], *nc["input_shape"], 1) if "adj_slices" in nc else (n, *nc["input_shape"], 1)
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


# -- the op ----------------------------------------------------------------------


@pytest.mark.parametrize("factors", [(1, 2, 2), (2, 2, 2), (1, 3, 3), (2, 2)])
def test_upsample_transposed_matches_jax(factors):
    """(2, 2) is a 2D net's factor, run lifted: the port's input gains a
    unit z axis and its weight a unit z kernel axis."""
    rng = np.random.default_rng(len(factors) + sum(factors))
    spatial = (3, 5, 4)[-len(factors):]
    x = rng.standard_normal((2, *spatial, 6)).astype(np.float32)
    w = rng.standard_normal((*factors, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(JU.upsample_transposed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), factors, jnp.float32))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if len(factors) == 2:
        tx, tw, factors = tx[:, None], tw[None], (1, *factors)
    got = U.upsample_transposed(tx, tw, torch.from_numpy(b), factors)
    got = got[:, 0] if got.shape[1] == 1 and want.ndim == 4 else got
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # each offset of the kernel reads its own weight: the unflipped read differs
    flipped = U.upsample_transposed(tx, torch.flip(tw, (0, 1, 2)), torch.from_numpy(b), factors)
    assert np.abs(flipped.numpy().reshape(want.shape) - want).max() > 1e-2


def test_upsample_output_lies_on_the_kernel_pitch():
    """A 300-channel bf16 output is 600 bytes a voxel: it is laid out by
    ``empty_channels_last`` (a padded pitch), as a resize output is."""
    x = torch.randn(1, 2, 3, 3, 300).to(torch.bfloat16)
    w = torch.randn(1, 2, 2, 300, 300)
    y = U.upsample_transposed(x, w, torch.zeros(300), (1, 2, 2))
    assert y.shape == (1, 2, 6, 6, 300) and y.stride()[-2] == 304
    ref = U.upsample_transposed(x.float(), w.to(torch.bfloat16).float(), torch.zeros(300), (1, 2, 2))
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), rtol=2e-2, atol=2e-2 * float(ref.abs().max()))


# -- the converter ---------------------------------------------------------------


@pytest.mark.parametrize("dims", [3, 2])
def test_converter_matches_torch_conv_transpose(dims):
    """A torch ``ConvTranspose`` (kernel = stride) as the reference trains
    it, converted to the JAX layout and run through the port's op."""
    torch.manual_seed(dims)
    factors = (1, 2, 2) if dims == 3 else (2, 2)
    layer = (torch.nn.ConvTranspose3d if dims == 3 else torch.nn.ConvTranspose2d)(5, 4, factors, stride=factors)
    x = torch.randn(2, 5, *(3, 4, 6)[-dims:])
    with torch.no_grad():
        want = torch.movedim(layer(x), 1, -1).numpy()
    w = torch.from_numpy(np.ascontiguousarray(CT._to_jax_conv_transpose(layer.weight.detach().numpy())))
    xl = torch.movedim(x, 1, -1)
    if dims == 2:
        xl, w = xl[:, None], w[None]
    got = U.upsample_transposed(xl, w, layer.bias.detach(), (1, 2, 2)).numpy().reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _reference_state(params, nc):
    """A reference state dict (the funlib module tree) holding ``params``:
    convs (O, I, *K) at their Sequential indices, transposed convs (I, O, *K)
    with every kernel axis reversed."""
    state = {}

    def conv(key, p):
        dims = p["w"].ndim - 2
        state[f"{key}.weight"] = np.transpose(p["w"], (dims + 1, dims, *range(dims)))
        state[f"{key}.bias"] = p["b"]

    def conv_pass(key, p):
        for j, layer in enumerate(p["layers"]):
            conv(f"{key}.conv_pass.{2 * j}", layer)
        conv(f"{key}.residual.0", p["residual"])

    for i, p in enumerate(params["unet"]["l_conv"]):
        conv_pass(f"unet.l_conv.{i}", p)
    for i, p in enumerate(params["unet"]["r_conv"][0]):
        conv_pass(f"unet.r_conv.0.{i}", p)
    for i, p in enumerate(params["unet"]["r_up"][0]):
        dims = p["w"].ndim - 2
        w = p["w"][tuple(slice(None, None, -1) for _ in range(dims))]
        state[f"unet.r_up.0.{i}.up.weight"] = np.transpose(w, (dims, dims + 1, *range(dims)))
        state[f"unet.r_up.0.{i}.up.bias"] = p["b"]
    for name in nc["outputs"]:
        conv_pass(f"{name.split('_', 1)[1]}_head", params[f"head_{name}"])
    return state


@pytest.mark.parametrize("dims", ["3d", "2d"])
def test_torch_to_params_matches_the_jax_converter(dims):
    nc = NETS[dims]()
    params = init_params_numpy(nc, 2)
    state = _reference_state(params, nc)
    got = W._flatten(CT.torch_to_params(state, Model(nc)))
    want = W._flatten(JCT.torch_to_params(state, JM.Model(nc)))
    assert set(got) == set(want) == set(W._flatten(params))
    assert any("/r_up/" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], W._flatten(params)[k], err_msg=k)
    del state["unet.r_up.0.1.up.weight"]
    with pytest.raises(KeyError, match=r"unet\.r_up\.0\.1\.up\.weight"):
        CT.torch_to_params(state, Model(nc))


def test_numpy_init_matches_the_jax_layout():
    """``init_params_numpy`` gives the JAX ``Model.init``'s leaves (paths and
    shapes, ``r_up`` included), and the port's state dict names them all;
    a resize net draws the same numbers as before."""
    nc = net_3d()
    jleaves = jax.tree_util.tree_leaves_with_path(JM.Model(nc).init(jax.random.PRNGKey(0)))
    nleaves = jax.tree_util.tree_leaves_with_path(init_params_numpy(nc, 0))
    assert [p for p, _ in jleaves] == [p for p, _ in nleaves]
    assert [v.shape for _, v in jleaves] == [v.shape for _, v in nleaves]
    state = W.params_from_jax(init_params_numpy(nc, 0))
    assert set(state) == set(Model(nc).state_dict())
    assert state["unet.r_up.0.1.w"].shape == (1, 2, 2, 147, 147)
    resize = narrow_net_config()
    a, b = W._flatten(init_params_numpy(resize, 0)), W._flatten(init_params_numpy(nc, 0))
    assert not any("r_up" in k for k in a)
    np.testing.assert_array_equal(a["unet/l_conv/0/layers/0/w"], b["unet/l_conv/0/layers/0/w"])


def test_the_z_stream_declines_a_transposed_net():
    for nc in (net_3d(), narrow_net_config()):
        assert stream_eligible(unet_config(nc)) == JZ.stream_eligible(JM.Model(nc).unet_config)
    assert not stream_eligible(unet_config(net_3d()))


# -- the net ---------------------------------------------------------------------


@pytest.fixture(scope="module", params=["3d", "2d"])
def net(request):
    """A transposed net, numpy-seeded params, an input, and the JAX model's
    fp32 and bf16 forwards of it."""
    nc = NETS[request.param]()
    params = init_params_numpy(nc, 3)
    x = _input(nc, 4)
    ref = {
        dt: {k: np.asarray(v, np.float32) for k, v in jax.jit(JM.Model(nc, compute_dtype=dt).apply)(params, x).items()}
        for dt in (jnp.float32, jnp.bfloat16)
    }
    return nc, params, x, ref


def test_forward_matches_jax_fp32(net):
    nc, params, x, ref = net
    model = load_params(Model(nc, compute_dtype=torch.float32), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k, want in ref[jnp.float32].items():
        assert tuple(got[k].shape) == want.shape
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_forward_matches_jax_bf16(net):
    """Both packages in bf16: convs and the upsample rounded per op, each
    in its own summation order (bf16 noise on sigmoid outputs)."""
    nc, params, x, ref = net
    model = load_params(Model(nc), params).to_compute("cpu", torch.bfloat16).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k, want in ref[jnp.bfloat16].items():
        np.testing.assert_allclose(got[k].numpy(), want, rtol=0, atol=2e-2, err_msg=k)
        assert np.abs(got[k].numpy() - ref[jnp.float32][k]).max() < 2e-2


def test_unet_int8_matches_jax(monkeypatch):
    """The transposed U-Net under ``BS_INT8=1``: every conv on the int8 route
    (the upsamples stay fp32 products), the port against JAX
    ``unet_apply`` within ``test_torch_quant.py``'s atol (1e-6 of the
    largest output), both within 3% of the fp graph."""
    cfg = dict(
        in_channels=1, num_fmaps=4, fmap_inc_factor=3, downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3, kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
        constant_upsample=False,
    )
    jcfg = JU.UNetConfig(**cfg)
    params = _numpy(JU.unet_init(jax.random.PRNGKey(7), jcfg))
    x = np.array(jax.random.uniform(jax.random.PRNGKey(8), (2, 24, 44, 44, 1), jnp.float32))

    def apply():
        return np.asarray(jax.jit(lambda p, x: JU.unet_apply(p, x, jcfg, compute_dtype=jnp.float32)[0])(params, x))

    ref_fp = apply()
    net = U.UNet(U.UNetConfig(**cfg))
    state = W.params_from_jax({"unet": params})
    net.load_state_dict({k[len("unet."):]: v for k, v in state.items()})
    monkeypatch.setenv("BS_INT8", "1")  # read when the graph is traced
    ref = apply()
    before, before_conv = dict(Q.COUNTS), dict(C.COUNTS)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert Q.COUNTS["plain"] - before["plain"] == 3 * 3 + 2 * (2 + 1 + 2)
    assert C.COUNTS == before_conv
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    for out in (got, ref):
        assert np.abs(out - ref_fp).mean() < 0.03 * np.abs(ref_fp).mean()


# -- training --------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_net():
    nc = net_3d()
    jm = JM.Model(nc, compute_dtype=jnp.float32)

    def jloss(p, batch):
        preds = jm.apply(p, batch["input"])
        t = {k: JL._center_crop_like(batch["targets"][k], preds[k]) for k in preds}
        w = {k: JL._center_crop_like(batch["weights"][k], preds[k]) for k in preds}
        return JM.multi_output_loss(preds, t, w)

    return nc, jax.jit(jax.value_and_grad(jloss)), init_params_numpy(nc, 0)


def _batch(nc, seed):
    rng = np.random.default_rng(seed)
    out = (1, nc["output_shape"][0], nc["output_shape"][1] + 2, nc["output_shape"][2] + 2, 9)
    w = (rng.random(out) * 2).astype(np.float32)
    w[w < 0.5] = 0
    return {
        "input": _input(nc, seed),
        "targets": {"3d_affs": (rng.random(out) > 0.5).astype(np.float32)},
        "weights": {"3d_affs": w},
    }


def _port_state(nc, params):
    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    return L.TrainState(0, model, L.make_optimizer(model, LR))


def _jax_step(value_and_grad, tx, params, opt_state, batch):
    loss, grads = value_and_grad(params, jax.tree_util.tree_map(jnp.asarray, batch))
    updates, opt_state = tx.update(grads, opt_state, params)
    return loss, optax.apply_updates(params, updates), opt_state


def _to_torch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


def test_loss_and_gradients_match_jax(train_net):
    nc, value_and_grad, params = train_net
    batch = _batch(nc, 1)
    want_loss, want_grads = value_and_grad(params, jax.tree_util.tree_map(jnp.asarray, batch))
    want = W.params_from_jax(_numpy(want_grads))
    st = _port_state(nc, params)
    loss = L.loss_fn(st.model, _to_torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    names = [n for n, _ in st.model.named_parameters()]
    assert {"unet.r_up.0.0.w", "unet.r_up.0.1.w", "unet.r_up.0.1.b"} <= set(names)
    for name, p in st.model.named_parameters():
        g, wg = p.grad.numpy(), want[name].numpy()
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(g, wg, rtol=1e-4, atol=1e-4 * np.abs(wg).max(), err_msg=name)


#: the port's bf16-against-fp32 gradient distance of a parameter may stand
#: this factor past the JAX package's on the same net and batch, plus the
#: floor (both packages round bf16 convs, each in its own order; on this net
#: the port's stood between 0.21 and 2.16 times the JAX package's, the
#: largest at the deepest decoder pass's first bias, 0.088 against 0.041)
BF16_GRAD_FACTOR = 2.5
BF16_GRAD_FLOOR = 0.02


def test_bf16_gradient_distances_match_jax():
    """The transposed net's bf16 gradients against fp32, per parameter
    (relative L2), in both packages from the same numpy parameters and
    batch: the port's distance within BF16_GRAD_FACTOR of the JAX
    package's plus BF16_GRAD_FLOOR for every parameter, so that the
    distance the card's gradient gate allows is the packages' shared one
    and not the port's own (a narrow net, 4 -> 8 -> 16 channels)."""
    nc = net_3d()
    nc.update(num_fmaps=4, fmap_inc_factor=2)
    params = init_params_numpy(nc, 0)
    batch = _batch(nc, 1)

    def port(dtype):
        m = load_params(Model(nc, compute_dtype=dtype), params)
        L.loss_fn(m, _to_torch(batch)).backward()
        return {n: p.grad.detach().double() for n, p in m.named_parameters()}

    def jax_grads(dtype):
        jm = JM.Model(nc, compute_dtype=dtype)

        def jloss(p, b):
            preds = jm.apply(p, b["input"])
            t = {k: JL._center_crop_like(b["targets"][k], preds[k]) for k in preds}
            w = {k: JL._center_crop_like(b["weights"][k], preds[k]) for k in preds}
            return JM.multi_output_loss(preds, t, w)

        _, g = jax.jit(jax.value_and_grad(jloss))(params, jax.tree_util.tree_map(jnp.asarray, batch))
        return {k: v.double() for k, v in W.params_from_jax(_numpy(g)).items()}

    def rel(g16, g32):
        return {n: float((g16[n] - g32[n]).norm() / g32[n].norm()) for n in g32}

    got = rel(port(torch.bfloat16), port(torch.float32))
    want = rel(jax_grads(jnp.bfloat16), jax_grads(jnp.float32))
    assert sorted(got) == sorted(want) and any(n.startswith("unet.r_up.") for n in got)
    assert max(want.values()) > BF16_GRAD_FLOOR  # bf16 moves the JAX gradients too
    over = {n: (got[n], want[n]) for n in got if got[n] > BF16_GRAD_FACTOR * want[n] + BF16_GRAD_FLOOR}
    assert not over, over


def test_train_steps_match_jax(train_net):
    """Three Adam steps of each package from the same parameters: each
    step's loss within rtol 1e-4, and every ``r_up`` weight moved."""
    nc, value_and_grad, params = train_net
    tx = optax.adam(LR)
    jparams, opt_state = params, tx.init(params)
    st = _port_state(nc, params)
    step = L.make_train_step()
    for seed in (2, 3, 4):
        batch = _batch(nc, seed)
        loss, jparams, opt_state = _jax_step(value_and_grad, tx, jparams, opt_state, batch)
        st, m = step(st, _to_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-4)
    start = W.params_from_jax(params)
    for name, p in st.model.named_parameters():
        if name.startswith("unet.r_up"):
            assert not torch.equal(p.detach(), start[name]), name


def test_checkpoints_cross_between_the_packages(train_net, tmp_path):
    """A JAX checkpoint with Adam state resumes in the port (params and
    moments equal, ``r_up`` leaves in the JAX leaf order); the port's
    checkpoint loads in the JAX package and gives the port's forward."""
    nc, value_and_grad, params = train_net
    tx = optax.adam(LR)
    jparams, opt_state = params, tx.init(params)
    for seed in (5, 6):
        _, jparams, opt_state = _jax_step(value_and_grad, tx, jparams, opt_state, _batch(nc, seed))
    path = JL.save_checkpoint(str(tmp_path / "jax"), JL.TrainState(jnp.asarray(2, jnp.int32), jparams, opt_state), 2)
    st = _port_state(nc, params)
    L.load_checkpoint(path, st)
    assert st.step == 2
    want_params = W.params_from_jax(_numpy(jparams))
    for name, p in st.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want_params[name].numpy())
    want = jax.tree_util.tree_leaves(opt_state)
    got = W.opt_leaves_to_jax(st.model, st.optimizer)
    assert len(got) == len(want) and int(got[0]) == 2
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w))

    st, _ = L.make_train_step()(st, _to_torch(_batch(nc, 7)))
    path = L.save_checkpoint(str(tmp_path / "port"), st, st.step)
    js = JL.load_checkpoint(path, tx)
    assert int(js.step) == 3 and int(js.opt_state[0].count) == 3
    x = _input(nc, 8)
    want = np.asarray(jax.jit(JM.Model(nc, compute_dtype=jnp.float32).apply)(js.params, x)["3d_affs"])
    with torch.no_grad():
        got = st.model.eval()(torch.from_numpy(x))["3d_affs"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# -- prediction ------------------------------------------------------------------


def test_run_prediction_matches_jax_within_one(tmp_path):
    """Two output slices deep, one more than a tiled pass: a resize net
    would stream (``test_torch_slice.py``); the transposed net is tiled,
    within +-1 of the JAX ``Predictor``."""
    nc = narrow_net_config()
    nc.update(constant_upsample=False, num_fmaps=2, fmap_inc_factor=2, shape_increase=[0, 0, 0])
    params = init_params_numpy(nc, 1)
    out_z, out_y, out_x = nc["output_shape"]
    shape = (2 * out_z, out_y + 4, out_x)
    raw_path = str(tmp_path / "vol.zarr" / "raw")
    ds = A.prepare_ds(raw_path, shape, (0, 0, 0), VOXEL, np.uint8)
    ds[ds.roi] = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)

    jm = JM.Model(nc)
    jp = JPredictor(jm, params, VOXEL, compute_dtype=jnp.float32)
    jraw = jax_open_ds(raw_path)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jraw.roi, VOXEL, predictor=jp)
    jp.predict(jraw, jouts)

    setup = tmp_path / "setup"
    setup.mkdir()
    (setup / "net_config.json").write_text(json.dumps(nc))
    save_checkpoint(str(setup), params, 5)
    tomlio.dump(
        {"predict": {"v": {
            "raw_dataset": raw_path, "output_container": str(tmp_path / "port.zarr"),
            "chain": [{"setup_dir": str(setup), "output_prefix": "pred"}],
        }}},
        str(tmp_path / "predict.toml"),
    )
    stats = run_prediction(str(tmp_path / "predict.toml"), device="cpu", compute_dtype=torch.float32)
    assert "steps_per_column" not in stats["v/pred"] and stats["v/pred"]["tiles"] == 4
    got = A.open_ds(str(tmp_path / "port.zarr" / "pred" / "3d_affs")).to_ndarray()
    want = jouts["3d_affs"].to_ndarray()
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sharded_predictors_take_the_net(tmp_path):
    """``tests/test_torch_spatial_predict.py``'s tiny net with transposed
    upsampling, over four logical CPU devices: a batch of tiles equal to the
    one-device ``Predictor``; the (12,152,48) tile split in y into four slabs
    equal to the whole tile's forward everywhere."""
    from test_torch_spatial_predict import _tiny

    nc = {**_tiny(), "constant_upsample": False}
    params = init_params_numpy(nc, 0)
    vs = (1, 1, 1)

    def model():
        return load_params(Model(nc, compute_dtype=torch.float32), params)

    shape = (16, 40, 40)
    raw = A.prepare_ds(str(tmp_path / "t.zarr" / "raw"), shape, (0, 0, 0), vs, np.uint8)
    raw[raw.roi] = np.random.default_rng(3).integers(0, 255, shape, dtype=np.uint8)
    got = {}
    for name, make in (
        ("sharded", lambda m: ShardedPredictor(m, vs, devices=["cpu"] * 4, compute_dtype=torch.float32)),
        ("one", lambda m: Predictor(m, vs, batch_tiles=1, device="cpu", compute_dtype=torch.float32)),
    ):
        m = model()
        p = make(m)
        outs = prepare_prediction_outputs(str(tmp_path / f"{name}.zarr"), m, raw.roi, vs, p)
        p.predict(raw, outs)
        got[name] = outs["3d_affs"].to_ndarray()
    np.testing.assert_array_equal(got["sharded"], got["one"])

    sp = S.SpatialShardedPredictor(model(), vs, devices=["cpu"] * 4, shape_increase=[0, 104, 0],
                                   compute_dtype=torch.float32)
    assert (sp.in_tile, sp.out_tile, sp.shard_axis) == ((12, 152, 48), (4, 112, 8), 1)
    x = np.random.default_rng(1).integers(0, 255, (12, sp.in_padded, 48, 1), dtype=np.uint8)
    split = sp.gather(sp.dispatch(x))["3d_affs"]
    whole = Predictor(model(), vs, shape_increase=[0, 104, 0], device="cpu", compute_dtype=torch.float32)
    ref = whole.forward(torch.from_numpy(x[None, :, : sp.in_tile[1]]))["3d_affs"].numpy()
    np.testing.assert_array_equal(split, ref)
