"""The port's int8 inference (``BS_INT8=1``, ``ops/quant.py``) against the
JAX package's (``bootstrapper_tpu/ops/quant.py`` and its callers), in fp32
on the CPU, from the same numpy inputs and parameters.

Tolerances: the quantized operands and scales are equal bit for bit (the
same fp32 divisions and roundings); a conv's int32 sums are exact in both
packages (the port's plain version sums the integers in float64), so its
outputs agree to fp32 rounding (rtol 1e-6), a conv pass's and a U-Net's
too (atol 1e-6 of the largest output; on these inputs no value lands on
the other side of a rounding tie in either package), and both stay within
3% of the fp graph (``tests/test_quant.py``'s bound).  Through the
predictors, which quantize each layer's input anew over many more values,
XLA's compiled graph puts some values a rounding step from where the
port's (and the JAX package's own op-by-op graph) puts them: on a batch of
two tiles of the predictors' net below, the JAX package's jitted and
op-by-op outputs differ by up to 2.7e-3 on 42% of voxels.  So uint8
predictions agree within +-1 on under 1% of voxels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models import unet as U
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_torch.ops import quant as Q
from bootstrapper_torch.predict import spatial as S
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs
from bootstrapper_torch.predict.zstream import ZStreamPredictor
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models import unet as JU
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.ops import quant as JQ
from bootstrapper_tpu.predict import spatial as JS
from bootstrapper_tpu.predict import zstream as JZ
from bootstrapper_tpu.predict.scan import Predictor as JPredictor
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs

VOXEL = (40, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU thread(s): the test run uses
    several worker processes at once, and torch's thread pools in
    all of them oversubscribe the cores; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def int8(monkeypatch):
    monkeypatch.setenv("BS_INT8", "1")


def _jax_operands(x, w):
    """The quantized operands and scales as ``JQ.qconv`` computes them."""
    xf, wf = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-30) / 127.0
    sw = jnp.maximum(jnp.max(jnp.abs(wf), axis=tuple(range(w.ndim - 1))), 1e-30) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    wq = jnp.clip(jnp.round(wf / sw), -127, 127).astype(jnp.int8)
    return [np.asarray(a) for a in (xq, sx, wq, sw)]


def _qconv_case(name):
    rng = np.random.default_rng(0)
    if name == "per_channel":
        # tests/test_quant.py's case: a channel of tiny weights beside one
        # of huge weights keeps its own scale
        x = np.ones((1, 3, 3, 3, 2), np.float32)
        w = np.zeros((3, 3, 3, 2, 2), np.float32)
        w[..., 0], w[..., 1] = 100.0, 0.01
        return x, w
    x_shape, w_shape = {
        "normal": ((1, 6, 10, 12, 5), (3, 3, 3, 5, 7)),
        "one_channel": ((1, 5, 7, 6, 1), (3, 3, 3, 1, 12)),
        "lifted_2d": ((3, 1, 9, 8, 3), (1, 3, 3, 3, 4)),
        "wide": ((1, 4, 6, 5, 40), (3, 3, 3, 40, 9)),
    }[name]
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (rng.normal(size=w_shape) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("name", ["normal", "per_channel", "one_channel", "lifted_2d", "wide"])
def test_qconv_matches_jax(name):
    x, w = _qconv_case(name)
    xq, sx, wq, sw = _jax_operands(x, w)
    got_xq, got_sx = Q.quantize(torch.from_numpy(x))
    got_wq, got_sw = Q.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(got_xq.numpy(), xq)
    np.testing.assert_array_equal(got_wq.numpy(), wq)
    assert float(got_sx) == float(sx)
    np.testing.assert_array_equal(got_sw.numpy(), sw)

    ref = np.asarray(JQ.qconv(jnp.asarray(x), jnp.asarray(w), out_dtype=jnp.float32))
    before = Q.COUNTS["plain"]
    got = Q.qconv(torch.from_numpy(x), torch.from_numpy(w), out_dtype=torch.float32).numpy()
    assert Q.COUNTS["plain"] == before + 1
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    if name == "per_channel":
        np.testing.assert_allclose(got[0, 0, 0, 0], [100.0 * 54, 0.01 * 54], rtol=0.02)


@pytest.mark.parametrize(
    "ci,co,cp,kp",
    [(1, 7, 16, 16), (12, 7, 16, 16), (40, 9, 48, 64), (60, 7, 64, 64), (130, 16, 144, 256), (300, 9, 304, 384)],
)
def test_packed_weights_hold_each_tap_at_the_channel_pitch(ci, co, cp, kp):
    """The kernel's layout: K is ``tap * kp + c`` (8, 4 or 2 taps to a
    128-byte row up to a pitch of 64, else whole 128-channel chunks a tap),
    padded to 128; each 128-byte K chunk a block of Co padded to 8 rows of
    128 s8, K-major under the 128-byte swizzle (16-byte group g of row r at
    g ^ r % 8), zero past Ci and Co; the activations' pitch is Ci rounded up
    to 16."""
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 3, 3, ci, co)).astype(np.float32))
    qw = Q.pack_qweights(w)
    co8, chunks = -(-co // 8) * 8, -(-27 * kp // Q.CHUNK)
    assert (qw.cp, qw.kp) == (cp, kp) == (Q.channel_pitch(ci), Q.k_pitch(ci))
    assert qw.data.shape == (chunks, co8 // 8, 8, 8, 16) and qw.data.dtype == torch.int8
    np.testing.assert_array_equal(Q.unpack_qweights(qw).numpy(), qw.wq.numpy())
    # one element by hand: tap 5, channel c, output channel n
    c, n = ci - 1, co - 1
    k = 5 * kp + c
    row, group = n % 8, (k % Q.CHUNK) // 16
    byte = qw.data[k // Q.CHUNK, n // 8, row].reshape(Q.ROW_BYTES)[16 * (group ^ row) + k % 16]
    assert int(byte) == int(qw.wq.reshape(27, ci, co)[5, c, n])
    rows = Q._swizzle(qw.data).permute(0, 3, 4, 1, 2).reshape(chunks * Q.CHUNK, co8)
    taps = rows[: 27 * kp].reshape(27, kp, co8)
    assert int(taps[:, ci:].abs().sum()) == 0 and int(rows[27 * kp :].abs().sum()) == 0
    assert int(rows[:, co:].abs().sum()) == 0


def test_generated_s8_wgmma_header_is_current():
    """``wgmma_s8_sm90.cuh`` is what ``gen_wgmma.py`` writes, for exactly the
    tile widths the int8 kernel plans with, and the kernel includes it."""
    import importlib.util
    import os

    from bootstrapper_torch.ops import _build

    spec = importlib.util.spec_from_file_location("gen_wgmma", os.path.join(_build.CSRC, "gen_wgmma.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert tuple(gen.S8_WIDTHS) == tuple(Q.TILE_WIDTHS)
    with open(os.path.join(_build.CSRC, "wgmma_s8_sm90.cuh")) as f:
        assert f.read() == gen.render_s8()
    assert all(f"m64n{n}k32.s32.s8.s8" in gen.render_s8() for n in gen.S8_WIDTHS)
    assert sorted(os.path.basename(f) for f in _build.source_files("qconv3d")) == ["qconv3d.cu", "wgmma_s8_sm90.cuh"]


def _conv(kernel, ci, co, rng):
    conv = U.Conv(kernel, ci, co)
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy((rng.normal(size=(*kernel, ci, co)) * 0.2).astype(np.float32)))
        conv.b.copy_(torch.from_numpy(rng.normal(size=co).astype(np.float32)))
    return conv


def _jax_params(conv):
    return jnp.asarray(conv.w.detach().numpy()), jnp.asarray(conv.b.detach().numpy())


def test_split_conv_quantizes_each_part(int8):
    """A conv over an implicit concat: each part its own activation scale
    and its own Ci-slice of the weights, as ``_conv_split``; one scale over
    the concat would be another result."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(1, 5, 8, 8, 3)).astype(np.float32) * 50.0  # its amax would swamp b's
    b = rng.normal(size=(1, 5, 8, 8, 4)).astype(np.float32)
    conv = _conv((3, 3, 3), 7, 5, rng)
    w, bias = _jax_params(conv)
    ref = np.asarray(JU._conv_split([jnp.asarray(a), jnp.asarray(b)], w, bias, compute_dtype=jnp.float32))
    with torch.no_grad():
        got = U.conv_split([torch.from_numpy(a), torch.from_numpy(b)], conv).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    one = Q.qconv(torch.from_numpy(np.concatenate([a, b], -1)), conv.w.detach(), conv.b.detach()).numpy()
    assert np.abs(one - ref).max() > 100 * np.abs(got - ref).max()


def test_residual_takes_its_scale_before_the_crop(int8):
    """The 1x1 residual of a conv pass quantizes its input uncropped and is
    cropped after (JAX ``conv_pass_apply``); the port crops first, so its
    scale must still come from the uncropped input: the input's largest
    value lies outside the crop here."""
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(1, 7, 9, 9, 3)).astype(np.float32), rng.normal(size=(1, 7, 9, 9, 2)).astype(np.float32)]
    xs[0][0, 0, 0, 0, 0] = 40.0
    xs[1][0, -1, -1, -1, 1] = -25.0
    cp = U.ConvPass(5, 4, [(3, 3, 3), (3, 3, 3)])
    with torch.no_grad():
        for conv in [*cp.layers, cp.residual]:
            kernel, ci, co = tuple(conv.w.shape[:3]), conv.w.shape[3], conv.w.shape[4]
            src = _conv(kernel, ci, co, rng)
            conv.w.copy_(src.w)
            conv.b.copy_(src.b)
    params = {
        "layers": [dict(zip("wb", _jax_params(c))) for c in cp.layers],
        "residual": dict(zip("wb", _jax_params(cp.residual))),
    }
    ref = np.asarray(
        JU.conv_pass_apply(params, [jnp.asarray(x) for x in xs], [(3, 3, 3)] * 2, compute_dtype=jnp.float32)
    )
    with torch.no_grad():
        got = cp([torch.from_numpy(x) for x in xs]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # the scale of the cropped input instead: another result
    crop = [U.center_crop(torch.from_numpy(x), got.shape[1:4]) for x in xs]
    with torch.no_grad():
        wrong = U.conv_split(crop, cp.residual).numpy()
        right = U.conv_split([Q.quantize_input(torch.from_numpy(x)).cropped(got.shape[1:4]) for x in xs],
                             cp.residual).numpy()
    assert np.abs(wrong - right).max() > 1e-3


@pytest.mark.parametrize("n_layers", [1, 2])
def test_conv_pass_quantizes_each_part_once(int8, n_layers):
    """A conv pass over two concat parts quantizes each part once: its first
    conv reads the s8 parts, its 1x1 residual their centre crops (the same
    scales), and each later conv its own input; against JAX
    ``conv_pass_apply``, which quantizes the parts for both convs."""
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(1, 7, 9, 9, 3)).astype(np.float32), rng.normal(size=(1, 7, 9, 9, 2)).astype(np.float32)]
    xs[0][0, 0, 0, 0, 0] = 30.0  # the largest values lie outside the crop
    xs[1][0, -1, -1, -1, 1] = -20.0
    kernels = [(3, 3, 3)] * n_layers
    cp = U.ConvPass(5, 4, kernels, parts=(3, 2))
    with torch.no_grad():
        for conv in [*cp.layers, cp.residual]:
            src = _conv(tuple(conv.w.shape[:3]), conv.w.shape[3], conv.w.shape[4], rng)
            conv.w.copy_(src.w)
            conv.b.copy_(src.b)
    params = {
        "layers": [dict(zip("wb", _jax_params(c))) for c in cp.layers],
        "residual": dict(zip("wb", _jax_params(cp.residual))),
    }
    ref = np.asarray(JU.conv_pass_apply(params, [jnp.asarray(x) for x in xs], kernels, compute_dtype=jnp.float32))
    before = dict(Q.COUNTS)
    with torch.no_grad():
        got = cp([torch.from_numpy(x) for x in xs]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert Q.COUNTS["quantize_plain"] - before["quantize_plain"] == len(xs) + n_layers - 1
    assert Q.COUNTS["plain"] - before["plain"] == 2 * len(xs) + n_layers - 1


def _fp32_slices(model, nc):
    """Every conv's fp32 weights and the input-channel slices the U-Net cuts
    them into (a decoder pass's first conv and residual read its skip and
    its upsampled input), by module name."""
    nf, inc = nc["num_fmaps"], nc["fmap_inc_factor"]
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, U.Conv):
            ci = m.w.shape[3]
            parts = name.split(".")
            if "r_conv" in parts and (parts[-1] == "residual" or parts[-2:] == ["layers", "0"]):
                skip = nf * inc ** int(parts[parts.index("r_conv") + 2])
                slices = [(0, skip), (skip, ci)]
            else:
                slices = [(0, ci)]
            out[name] = (m.w.detach().clone().numpy(), slices)
    return out


def _assert_int8_weights_from_fp32(model, want):
    """Each conv's int8 weights and scales, bit for bit, as JAX ``qconv``
    quantizes the fp32 parameters."""
    convs = dict(model.named_modules())
    for name, (wf, slices) in want.items():
        for lo, hi in slices:
            qw = convs[name].packed(torch.int8, lo, hi)
            part = jnp.asarray(wf[..., lo:hi, :])
            sw = jnp.maximum(jnp.max(jnp.abs(part), axis=(0, 1, 2, 3)), 1e-30) / 127.0
            wq = jnp.clip(jnp.round(part / sw), -127, 127).astype(jnp.int8)
            np.testing.assert_array_equal(qw.sw.cpu().numpy(), np.asarray(sw), err_msg=f"{name}[{lo}:{hi}]")
            np.testing.assert_array_equal(qw.wq.cpu().numpy(), np.asarray(wq), err_msg=f"{name}[{lo}:{hi}]")


def test_int8_weights_come_from_the_fp32_parameters(monkeypatch):
    """A predictor casts its model to bf16 (``Lane``, ``Model.replicate``);
    under ``BS_INT8=1`` the int8 weights and per-channel scales are still
    the JAX package's quantization of the fp32 parameters, bit for bit (the
    amax of the bf16-rounded weights would move nearly every scale), made
    before the cast, and a forward packs nothing."""
    from bootstrapper_torch.predict._pipeline import Lane

    nc = _net_config()
    params = init_params_numpy(nc, 0)
    monkeypatch.setenv("BS_INT8", "1")
    cpu = torch.device("cpu")
    model = load_params(Model(nc), params)
    want = _fp32_slices(model, nc)
    replica = Lane(model, cpu, torch.bfloat16).model  # Model.replicate from fp32
    lane = Lane.adopt(model, cpu, torch.bfloat16)  # the model itself, cast
    again = Lane(lane.model, cpu, torch.bfloat16).model  # a replica of a cast model
    for m in (replica, lane.model, again):
        assert all(c.w.dtype == torch.bfloat16 for c in m.modules() if isinstance(c, U.Conv))
        _assert_int8_weights_from_fp32(m, want)
    x = torch.from_numpy(np.random.default_rng(5).random((1, *nc["input_shape"], 1), np.float32))
    before = Q.COUNTS["pack"]
    with torch.no_grad():
        out = lane.model(x)["3d_affs"]
    assert Q.COUNTS["pack"] == before and bool(torch.isfinite(out).all())


def test_int8_after_the_cast_raises(monkeypatch):
    """``BS_INT8=1`` set after a predictor cast the model to bf16: its fp32
    parameters are gone, so a forward refuses rather than quantize the
    bf16 weights."""
    from bootstrapper_torch.predict._pipeline import Lane

    nc = _net_config()
    monkeypatch.delenv("BS_INT8", raising=False)
    lane = Lane.adopt(load_params(Model(nc), init_params_numpy(nc, 0)), torch.device("cpu"), torch.bfloat16)
    monkeypatch.setenv("BS_INT8", "1")
    x = torch.zeros((1, *nc["input_shape"], 1))
    with torch.no_grad(), pytest.raises(RuntimeError, match="fp32 parameters"):
        lane.model(x)


def _unet_cfg():
    """``tests/test_quant.py``'s end-to-end U-Net."""
    return dict(
        in_channels=1, num_fmaps=4, fmap_inc_factor=3,
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3,
        kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
    )


def test_unet_int8_matches_jax(monkeypatch):
    """The whole U-Net under ``BS_INT8=1`` on a batch of two: every conv on
    the int8 route (none on the conv kernel's or the library's), one scale
    per conv over the batch, the port against JAX ``unet_apply`` in fp32,
    and both within 3% of the fp graph."""
    cfg = _unet_cfg()
    jcfg = JU.UNetConfig(**cfg)
    params = jax.tree_util.tree_map(np.asarray, JU.unet_init(jax.random.PRNGKey(7), jcfg))
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(8), (2, 24, 44, 44, 1), jnp.float32))
    apply = jax.jit(lambda p, x: JU.unet_apply(p, x, jcfg, compute_dtype=jnp.float32)[0])
    ref_fp = np.asarray(apply(params, jnp.asarray(x)))
    net = U.UNet(U.UNetConfig(**cfg))
    state = {}
    for name, levels in (("l_conv", params["l_conv"]), ("r_conv.0", params["r_conv"][0])):
        for i, lp in enumerate(levels):
            for j, layer in enumerate(lp["layers"]):
                state[f"{name}.{i}.layers.{j}.w"], state[f"{name}.{i}.layers.{j}.b"] = layer["w"], layer["b"]
            state[f"{name}.{i}.residual.w"], state[f"{name}.{i}.residual.b"] = lp["residual"]["w"], lp["residual"]["b"]
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})

    monkeypatch.setenv("BS_INT8", "1")  # read when the graph is traced
    ref = np.asarray(jax.jit(lambda p, x: JU.unet_apply(p, x, jcfg, compute_dtype=jnp.float32)[0])(params, x))
    before, before_conv = dict(Q.COUNTS), dict(C.COUNTS)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        one = net(torch.from_numpy(x[:1])).numpy()
    # 3 levels down, 2 up: 2 convs and a residual each, the decoder's first
    # conv and residual over 2 parts; twice (the batch, then one sample)
    assert Q.COUNTS["plain"] - before["plain"] == 2 * (3 * 3 + 2 * (2 + 1 + 2))
    assert C.COUNTS == before_conv
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert np.abs(one - got[:1]).max() > 1e-4  # one sample alone takes other scales
    for out in (got, ref):
        assert np.abs(out - ref_fp).mean() < 0.03 * np.abs(ref_fp).mean()
    # with grad enabled the flag is ignored (the bf16/fp32 routes), as in training
    with torch.enable_grad():
        net(torch.from_numpy(x[:1]))
    assert Q.COUNTS["plain"] - before["plain"] == 2 * (3 * 3 + 2 * (2 + 1 + 2))


def _net_config():
    """``tests/test_zstream_predict.py``'s tiny 3d_affs net."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=2, fmap_inc_factor=2, input_shape=[24, 48, 48], output_shape=[4, 8, 8],
        shape_increase=[0, 0, 0], downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3, kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
    )
    nc["outputs"] = {
        "3d_affs": {"dtype": "uint8", "dims": 3, "neighborhood": [[-1, 0, 0], [0, -1, 0], [0, 0, -1]],
                    "grow_boundary": 1}
    }
    return nc


def _model(nc, params):
    return load_params(Model(nc, compute_dtype=torch.float32), params)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8")
    shape = (22, 60, 40)
    raw = A.prepare_ds(str(tmp / "v.zarr" / "raw"), shape, (0, 0, 0), VOXEL, np.uint8)
    raw[raw.roi] = np.random.default_rng(22).integers(0, 255, shape, dtype=np.uint8)
    nc = _net_config()
    return tmp, raw, nc, init_params_numpy(nc, 0)


def _assert_close_uint8(a, b):
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-2, (diff.max(), (diff != 0).mean())


def _run_port(tmp, name, predictor, model, raw):
    outs = prepare_prediction_outputs(str(tmp / f"{name}.zarr"), model, raw.roi, VOXEL, predictor)
    predictor.predict(raw, outs)
    return outs["3d_affs"].to_ndarray()


def _run_jax(tmp, name, jm, predictor, raw):
    jraw = jax_open_ds(raw.path)
    outs = jax_outputs(str(tmp / f"{name}.zarr"), jm, jraw.roi, VOXEL, predictor=predictor)
    predictor.predict(jraw, outs)
    return outs["3d_affs"].to_ndarray()


def test_tiled_predictor_batch_tiles_2_matches_jax(volume, monkeypatch):
    """Two tiles a batch: each scale over the whole batch, as the JAX
    package's jitted batch takes it; within ``tests/test_quant.py``'s
    bounds of the fp run."""
    tmp, raw, nc, params = volume
    m = _model(nc, params)
    fp = _run_port(tmp, "fp", Predictor(m, VOXEL, batch_tiles=2, device="cpu", compute_dtype=torch.float32), m, raw)
    monkeypatch.setenv("BS_INT8", "1")
    m = _model(nc, params)
    got = _run_port(tmp, "q", Predictor(m, VOXEL, batch_tiles=2, device="cpu", compute_dtype=torch.float32), m, raw)
    jm = JModel(nc)
    want = _run_jax(tmp, "jq", jm, JPredictor(jm, params, VOXEL, batch_tiles=2, compute_dtype=jnp.float32), raw)
    _assert_close_uint8(got, want)
    diff = np.abs(got.astype(int) - fp.astype(int))
    assert diff.mean() < 1.5 and diff.max() <= 12
    # a scale per batch: one tile a batch quantizes otherwise
    m = _model(nc, params)
    single = _run_port(tmp, "q1", Predictor(m, VOXEL, batch_tiles=1, device="cpu", compute_dtype=torch.float32), m, raw)
    assert (single != got).any()


def test_zstream_int8_matches_jax(volume, monkeypatch):
    """Each stream step quantizes what its convs see (the cached z context
    and the new slices), as the JAX package's steps do."""
    tmp, raw, nc, params = volume
    monkeypatch.setenv("BS_INT8", "1")
    m = _model(nc, params)
    zp = ZStreamPredictor(m, VOXEL, device="cpu", compute_dtype=torch.float32, step_z=7)
    got = _run_port(tmp, "zs", zp, m, raw)
    jm = JModel(nc)
    want = _run_jax(tmp, "jzs", jm, JZ.ZStreamPredictor(jm, params, VOXEL, compute_dtype=jnp.float32, step_z=7), raw)
    _assert_close_uint8(got, want)


def test_sharded_lanes_share_every_scale(volume, monkeypatch):
    """``ShardedPredictor`` over two logical CPU devices under ``BS_INT8=1``
    with the recorder on: at every quantization point both lanes quantize
    with one scale, bit for bit ``max(lane amaxes) / 127`` as the plain
    version computes it; the lanes run as many convs, each of its own tile;
    and the affinities are the one-device two-tile batch's, uint8 for
    uint8 (the scale over the pair, which a scale per lane would not give)."""
    from bootstrapper_torch.predict.sharded import ShardedPredictor

    tmp, raw, nc, params = volume
    monkeypatch.setenv("BS_INT8", "1")
    roi = A.Roi((0, 0, 0), (8 * VOXEL[0], 16 * VOXEL[1], 24 * VOXEL[2]))  # 2 x 2 x 3 tiles
    m = _model(nc, params)
    sp = ShardedPredictor(m, VOXEL, devices=["cpu", "cpu"], compute_dtype=torch.float32)
    outs = prepare_prediction_outputs(str(tmp / "shared.zarr"), m, roi, VOXEL, sp)
    with Q.record_scales() as groups:
        stats = sp.predict(raw, outs, roi)
    got = outs["3d_affs"].to_ndarray()
    assert stats["tiles"] == 12 and len(groups) == 6  # a group per step of two tiles
    points = 0
    for g in groups:
        assert g.plain[0] == g.plain[1] > 0 and g.launches == [0, 0]
        for amaxes, scales in g.scales():
            assert scales[0] == scales[1] == Q.shared_scale(amaxes)
            points += 1
    assert points == 6 * len(groups[0].scales()) and len(groups[0].scales()) > 10
    assert any(a[0] != a[1] for g in groups for a, _ in g.scales())  # the lanes' own amaxes differ
    m = _model(nc, params)
    one = Predictor(m, VOXEL, batch_tiles=2, device="cpu", compute_dtype=torch.float32)
    ref = prepare_prediction_outputs(str(tmp / "pair.zarr"), m, roi, VOXEL, one)
    one.predict(raw, ref, roi)
    np.testing.assert_array_equal(got, ref["3d_affs"].to_ndarray())
    assert Q.SCALE_RECORD is None  # off again


def _tiny_spatial():
    """``tests/test_spatial_predict.py``'s tiny 3D net."""
    nc = _net_config()
    nc.update(
        input_shape=[12, 48, 48],
        kernel_size_down=[[[1, 3, 3], [1, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
        kernel_size_up=[[[1, 3, 3], [1, 3, 3]], [[1, 3, 3], [1, 3, 3]]],
    )
    return nc


def test_spatial_slab_scales_match_jax(monkeypatch):
    """A tile split over four devices quantizes per slab: each slab's output
    is the int8 forward of a tile the slab's size (bit for bit), as the JAX
    package's ``shard_map`` takes its scales per shard
    (``tests/test_quant.py:test_int8_under_spatial_sharding``)."""
    nc = _tiny_spatial()
    params = init_params_numpy(nc, 0)
    monkeypatch.setenv("BS_INT8", "1")
    n = 4
    sp = S.SpatialShardedPredictor(
        _model(nc, params), (1, 1, 1), devices=["cpu"] * n, shape_increase=[0, 104, 0], compute_dtype=torch.float32
    )
    x = np.random.default_rng(1).integers(0, 255, (12, sp.in_padded, 48, 1), dtype=np.uint8)
    got = sp.gather(sp.dispatch(x))["3d_affs"]
    one = Predictor(_model(nc, params), (1, 1, 1), shape_increase=[0, 20, 0], device="cpu", compute_dtype=torch.float32)
    own, rows = sp.own_out, sp.slab_rows
    slabs = [one.forward(torch.from_numpy(x[None, :, k * own : k * own + rows]))["3d_affs"] for k in range(n)]
    np.testing.assert_array_equal(got, torch.cat(slabs, dim=2).numpy())
    jsp = JS.SpatialShardedPredictor(
        JModel(nc), params, (1, 1, 1), devices=jax.devices()[:n], shape_increase=[0, 104, 0],
        compute_dtype=jnp.float32,
    )
    want = np.asarray(jsp._forward(jsp.params, jnp.asarray(x[None]))["3d_affs"])
    _assert_close_uint8(got, want)


def test_smoke_checks_every_int8_conv_of_a_tile():
    """``chip_smoke.py`` holds K4 at the convs a full-width 3d_affs tile
    hands to ``qconv`` under ``BS_INT8=1`` (traced on the ``meta`` device):
    each level's two convs and residual, each decoder level's first conv and
    residual over two parts, the head's conv and residual; the residuals
    scaled over their uncropped inputs; the flag restored after."""
    import os

    import chip_smoke as cs

    before = os.environ.get("BS_INT8")
    cases = cs.trace_int8_convs(get_net_config("3d_affs"), cs.TILED_INPUT)
    assert os.environ.get("BS_INT8") == before
    assert len(cases) == 4 * 3 + 3 * 5 + 2
    assert {c[4][3] for c in cases} == {1, 12, 60, 300, 1500}
    assert cases[0][3] == (1, *cs.TILED_INPUT, 1) and cases[-1][4] == (1, 1, 1, 12, 9)
    residuals = [c for c in cases if c[2] is not None]
    assert len(residuals) == 4 + 3 * 2 + 1 and all(c[4][:3] == (1, 1, 1) for c in residuals)
    for _, base, scale, x, _, _, _ in residuals:
        assert all(b >= s >= v for b, s, v in zip(base[1:4], scale[1:4], x[1:4]))
    # every residual but the head's is cropped after its scale is taken
    assert sum(c[2][1:4] != c[3][1:4] for c in residuals) == 4 + 3 * 2


def test_smoke_checks_every_int8_conv_of_a_stream_step():
    """``chip_smoke.py`` holds K4 at the convs of the z stream's warm and
    steady steps under ``BS_INT8=1`` too (traced on the ``meta`` device at
    the (130,640,640) volume's plan): each step the tile's convs in the
    tile's order, a steady step of s slices every conv s slices deep, each
    input a crop of the tensor its scale is taken over, within the
    storage it was cut from (a permuted base read as NDHWC)."""
    import chip_smoke as cs

    nc = get_net_config("3d_affs")
    tile = cs.trace_int8_convs(nc, cs.TILED_INPUT)
    cases = cs.trace_int8_convs(nc, stream=([64, 732, 732], 4))
    assert [c[0] for c in cases] == [f"{p}_{c[0]}" for p in ("warm", "steady") for c in tile]
    assert [c[4:] for c in cases] == [c[4:] for c in tile] * 2
    steady = {c[0]: c for c in cases if c[0].startswith("steady_")}
    assert steady["steady_c00_1to12_k333"][3] == (1, 64 + 4, 732, 732, 1)
    assert steady["steady_c27_12to9_k111"][3] == (1, 64, 640, 640, 12)
    assert steady["steady_c23_60to12_k333"][1] == (1, 68, 648, 648, 60)
    for _, base, scale, x, _, _, _ in cases:
        assert all(b >= s >= v for b, s, v in zip(base[1:4], (scale or x)[1:4], x[1:4]))


def test_training_ignores_int8(monkeypatch):
    """``run_training`` turns ``BS_INT8`` off for its whole run (snapshots
    included: round and clip have zero gradient) and back on after, for a
    prediction that follows in the same process, as the JAX package does."""
    import os

    from bootstrapper_torch.workflows import train as T

    seen = []
    monkeypatch.setattr(T, "setup_train", lambda config_file, **kw: {"setup_dir": config_file})
    monkeypatch.setattr(T, "_train", lambda cfg, device, dtype: seen.append(os.environ["BS_INT8"]) or {})
    monkeypatch.setenv("BS_INT8", "1")
    T.run_training("setup", device="cpu")
    assert seen == ["0"] and os.environ["BS_INT8"] == "1"
