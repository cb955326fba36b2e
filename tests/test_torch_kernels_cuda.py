"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every case carries the ``cuda`` marker and skips without a GPU.
This file imports no JAX, so it also runs on the GPU host:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch
from _torch_seed_cases import EDGE_CASES, scipy_seeds, seed_stack

from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models.unet import center_crop
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_torch.ops import quant as Q
from bootstrapper_torch.ops import seeds as S
from bootstrapper_torch.predict._pipeline import DeviceIO


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided when the test runs, never at
    import or collection time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    return torch.device("cuda")


F32, BF16 = torch.float32, torch.bfloat16

CUDA_CASES = [
    # (x shape, w shape, dtype, crop)
    # fp32, the FMA kernel: 16- and 8-byte copies
    ((1, 5, 9, 10, 128), (3, 3, 3, 128, 64), F32, None),
    ((1, 4, 9, 8, 130), (3, 3, 3, 130, 48), F32, None),
    ((1, 8, 12, 12, 300), (1, 1, 1, 300, 60), F32, (4, 8, 8)),
    # bf16, the wgmma kernel: the eleven convs of one U-Net tile with
    # their channel counts, kernels and crops, at few voxels
    ((1, 6, 12, 12, 300), (3, 3, 3, 300, 300), BF16, None),  # enc2.c1
    ((1, 4, 7, 7, 300), (3, 3, 3, 300, 1500), BF16, None),  # enc3.c0
    ((1, 4, 6, 6, 1500), (3, 3, 3, 1500, 1500), BF16, None),  # enc3.c1
    ((1, 6, 10, 10, 300), (1, 1, 1, 300, 1500), BF16, (4, 8, 8)),  # enc3.res
    ((1, 8, 12, 12, 300), (3, 3, 3, 300, 300), BF16, (6, 10, 10)),  # dec2.c0 skip
    ((1, 5, 9, 9, 1500), (3, 3, 3, 1500, 300), BF16, None),  # dec2.c0 up
    ((1, 5, 20, 20, 300), (3, 3, 3, 300, 300), BF16, None),  # dec2.c1, 4 M tiles
    ((1, 8, 12, 12, 300), (1, 1, 1, 300, 300), BF16, (4, 8, 8)),  # dec2.res skip
    ((2, 5, 7, 9, 1500), (1, 1, 1, 1500, 300), BF16, (3, 5, 7)),  # dec2.res up, batch 2
    ((1, 6, 11, 9, 300), (3, 3, 3, 300, 60), BF16, None),  # dec1.c0 up
    ((1, 8, 12, 12, 300), (1, 1, 1, 300, 60), BF16, (4, 8, 8)),  # dec1.res up
    # copy widths: 16 bytes; scalar loads (odd Ci), Co padded to 8
    ((1, 5, 9, 10, 128), (3, 3, 3, 128, 64), BF16, None),
    ((1, 4, 9, 8, 129), (3, 3, 3, 129, 70), BF16, None),
    # Ci 130: a last chunk of 2 channels in one k16 step; Co 9; a crop
    # whose first voxel is only 4-byte aligned; batch 2
    ((2, 6, 9, 9, 130), (3, 3, 3, 130, 9), BF16, (4, 7, 7)),
    # a window wider than a tensor map's 16: 16-byte cp.async on voxel lines
    ((1, 2, 5, 40, 128), (1, 2, 17, 128, 16), BF16, None),
    # the 2D nets, lifted to a unit z: batches of sections, D = 1, kd = 1,
    # so M tiles run across sections (the predictor's 32, at few voxels)
    ((32, 1, 14, 14, 300), (1, 3, 3, 300, 300), BF16, None),
    ((32, 1, 8, 8, 1500), (1, 3, 3, 1500, 1500), BF16, None),
    ((32, 1, 12, 12, 300), (1, 3, 3, 300, 300), BF16, (1, 8, 8)),
    ((10, 1, 9, 9, 1500), (1, 1, 1, 1500, 300), BF16, (1, 5, 5)),
    # the 3d_affs_from_2d_* refiners' 243 channels: an odd count (a padded
    # pitch on voxel lines, 8-byte copies dense) and a ragged last K chunk
    ((1, 6, 10, 10, 243), (3, 3, 3, 243, 243), BF16, None),
    ((1, 6, 10, 10, 243), (3, 3, 3, 243, 81), BF16, None),
    ((1, 6, 10, 10, 243), (1, 1, 1, 243, 81), BF16, (4, 8, 8)),
]


def _conv_inputs(cuda, x_shape, w_shape, dtype, crop, layout="dense"):
    """``layout`` "dense": voxels of C * itemsize bytes, whatever their
    alignment (cp.async copies of 16, 8 or 4 bytes, or scalar loads);
    "lines": as the U-Net's ops lay their outputs out, every voxel on a
    16-byte line (bf16: the TMA im2col load)."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(x_shape, generator=gen).to(cuda, dtype)
    if layout == "lines":
        lines = C.empty_channels_last(x_shape, dtype, cuda)
        lines.copy_(x)
        x = lines
    if crop is not None:
        x = center_crop(x, crop)
    fan_in = w_shape[0] * w_shape[1] * w_shape[2] * w_shape[3]
    w = (torch.randn(w_shape, generator=gen) / fan_in**0.5).to(cuda, dtype)
    b = torch.randn(w_shape[-1], generator=gen).to(cuda, dtype)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "lines"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("x_shape,w_shape,dtype,crop", CUDA_CASES)
def test_conv3d_kernel_matches_plain(cuda, x_shape, w_shape, dtype, crop, relu, layout):
    """fp32: FMAs in another order (atol 1e-4 at outputs of O(5)); bf16:
    one rounding of fp32 sums taken in another order (rtol = atol = 2^-6,
    about two bf16 ulps)."""
    x, w, b = _conv_inputs(cuda, x_shape, w_shape, dtype, crop, layout)
    before = C.COUNTS["kernel"]
    got = C.conv3d(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert C.COUNTS["kernel"] == before + 1
    ref = C.conv3d_plain(x, w, b, relu=relu)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    np.testing.assert_allclose(
        got.float().cpu().numpy(), ref.float().cpu().numpy(), rtol=tol, atol=tol
    )


QCONV_CASES = [
    # (x shape, w shape, crop, output dtype): the int8 kernel (K4) at the
    # convs of a 3d_affs tile with their channel counts, at few voxels; the
    # tile width follows Co: 9, 12 -> 16; 60 -> 64; 300 -> 2 x 160; 1500 -> 6 x 256;
    # Ci up to 64 gathers 8 or 2 taps a K row, wider Ci comes by tensor map
    ((1, 8, 12, 12, 1), (3, 3, 3, 1, 12), None, BF16),  # enc0.c0: Ci 1 at pitch 16
    ((1, 6, 10, 10, 12), (3, 3, 3, 12, 12), None, BF16),  # enc0.c1: Ci 12
    ((1, 8, 12, 12, 1), (1, 1, 1, 1, 12), (6, 8, 8), BF16),  # enc0.res: a crop of the s8 input
    ((1, 6, 10, 10, 12), (3, 3, 3, 12, 60), None, BF16),  # enc1.c0: BN 64, one run per warpgroup
    ((1, 6, 10, 10, 60), (3, 3, 3, 60, 60), None, F32),
    ((1, 6, 12, 12, 60), (3, 3, 3, 60, 300), None, BF16),  # BN 160, 16-byte lines
    ((1, 5, 9, 9, 300), (3, 3, 3, 300, 300), None, F32),
    ((1, 4, 6, 6, 300), (3, 3, 3, 300, 1500), None, BF16),  # BN 256
    ((1, 4, 6, 6, 1500), (3, 3, 3, 1500, 1500), None, BF16),  # a last chunk of 3 k32 steps
    ((1, 6, 10, 10, 300), (1, 1, 1, 300, 1500), (4, 8, 8), BF16),  # enc3.res
    ((1, 5, 9, 9, 1500), (3, 3, 3, 1500, 300), None, F32),  # dec2.c0 up part
    ((1, 8, 12, 12, 1500), (1, 1, 1, 1500, 300), (4, 6, 8), BF16),  # dec2.res up part
    ((1, 5, 9, 9, 12), (1, 1, 1, 12, 9), None, F32),  # a head: Co 9, fp32 out
    ((32, 1, 20, 20, 5), (1, 3, 3, 5, 12), None, BF16),  # a 2D net's first conv, batch 32
    ((2, 5, 40, 37, 60), (3, 3, 3, 60, 12), None, F32),  # many ragged M tiles
    # ragged Co: 70 on 2 x 64 with a voxel pitch off 16 bytes (single
    # values); Ci 130: a last chunk of one k32 step
    ((1, 5, 13, 11, 130), (3, 3, 3, 130, 70), None, BF16),
    ((1, 7, 9, 9, 300), (1, 1, 1, 300, 81), (3, 5, 5), F32),  # Co 81 on 2 x 64, a crop
    # Ci 40: a pitch of 48 in a K pitch of 64 (2 taps a row, zeros between)
    ((1, 6, 10, 10, 40), (3, 3, 3, 40, 24), None, BF16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("x_shape,w_shape,crop,out_dtype", QCONV_CASES)
def test_qconv_kernel_matches_plain(cuda, x_shape, w_shape, crop, out_dtype, relu):
    """K4 (amax, quantization, s8 wgmma conv) against ``qconv_plain``, whose
    sums are exact: the same fp32 rescale, so at most one ulp of the output
    type apart.  A crop reads the centre of the s8 tensor quantized whole
    (a strided view with the shared scale), as a conv pass's residual does,
    and equals the crop quantized on its own with the whole's scale."""
    x, w, b = _conv_inputs(cuda, x_shape, w_shape, BF16, None, "lines")
    xc = x if crop is None else center_crop(x, crop)
    qw = Q.pack_qweights(w.float())
    before = dict(Q.COUNTS)
    q = Q.quantize_input(x)
    got = Q.qconv_quantized(q if crop is None else q.cropped(crop), qw, b, relu=relu, out_dtype=out_dtype)
    one = Q.qconv_quantized(Q.quantize_pass_cuda(xc, Q.amax_cuda(x)), qw, b, relu=relu, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert Q.COUNTS["kernel"] == before["kernel"] + 2 and Q.COUNTS["quantize"] == before["quantize"] + 1
    assert got.dtype == out_dtype and torch.equal(got, one)
    ref = Q.qconv_plain(xc, w, b, relu=relu, out_dtype=out_dtype, qw=qw, sx=Q.activation_scale(x)).float()
    got = got.float()
    ulp = torch.finfo(out_dtype).eps * torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))))
    assert bool(((got - ref).abs() <= ulp).all()), float((got - ref).abs().max())


QUANTIZE_CASES = [
    # (shape, dtype, layout, crop): what the load width follows
    ((1, 9, 20, 20, 1), BF16, "dense", None),  # 2-byte voxels: single loads
    ((1, 6, 14, 14, 12), BF16, "dense", None),  # 24-byte voxels: 8-byte loads
    ((1, 6, 14, 14, 60), BF16, "dense", (4, 10, 12)),  # 120-byte voxels, a crop
    ((1, 5, 12, 12, 300), BF16, "lines", (3, 8, 8)),  # padded to 16-byte lines
    ((2, 4, 9, 11, 1500), BF16, "lines", None),  # a last group of 12 channels
    ((1, 5, 9, 9, 9), F32, "dense", None),  # 36-byte voxels: single loads
    ((1, 5, 9, 9, 12), F32, "dense", (3, 5, 7)),  # 48-byte voxels: 16-byte loads
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,layout,crop", QUANTIZE_CASES)
def test_amax_pass_matches_plain(cuda, shape, dtype, layout, crop):
    """The amax pass: the bits of ``max |x|`` over a strided view, equal to
    PyTorch's amax."""
    x, _, _ = _conv_inputs(cuda, shape, (1, 1, 1, shape[-1], 1), dtype, crop, layout)
    amax = Q.amax_cuda(x)
    torch.cuda.synchronize()
    assert int(amax) == int(x.abs().amax().float().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,layout,crop", QUANTIZE_CASES)
def test_quantize_pass_matches_plain(cuda, shape, dtype, layout, crop):
    """The quantization pass against ``quantize`` bit for bit, with the
    scale of the tensor the view is a crop of: the s8 view of a buffer at
    the channel pitch, zeros past Ci."""
    x, _, _ = _conv_inputs(cuda, shape, (1, 1, 1, shape[-1], 1), dtype, None, layout)
    xc = x if crop is None else center_crop(x, crop)
    q = Q.quantize_pass_cuda(xc, Q.amax_cuda(x))
    torch.cuda.synchronize()
    want, sx = Q.quantize(xc, Q.activation_scale(x))
    assert float(q.sx) == float(sx) and q.dtype == dtype
    assert torch.equal(q.xq, want)
    buf = q.xq._base
    assert buf.shape[-1] == Q.channel_pitch(shape[-1]) and buf.is_contiguous()
    assert int(buf[..., shape[-1]:].abs().sum()) == 0


@pytest.mark.cuda
def test_conv3d_cuda_refuses_where_a_gradient_is_needed(cuda):
    """``conv3d_cuda`` gives no gradient: with grad enabled and an input that
    requires grad it raises; ``conv3d`` routes such calls through
    ``Conv3dFunction``, whose gradients reach every input."""
    x, w, b = _conv_inputs(cuda, (1, 6, 12, 12, 300), (3, 3, 3, 300, 300), BF16, None, "lines")
    w = w.float().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        C.conv3d_cuda(x, w, b)
    with torch.no_grad():
        C.conv3d_cuda(x, w, b)
    xg = x.detach().requires_grad_(True)
    y = C.conv3d(xg, w, b.float().requires_grad_(True), relu=True)
    y.float().sum().backward()
    assert xg.grad is not None and float(w.grad.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "x_shape,w_shape,relu,crop",
    [
        ((1, 7, 12, 12, 300), (3, 3, 3, 300, 150), True, None),
        ((1, 7, 12, 12, 300), (3, 3, 3, 300, 150), False, (4, 8, 8)),
        # a 2D training batch of 10, lifted: D = 1, kd = 1
        ((10, 1, 12, 12, 300), (1, 3, 3, 300, 300), True, None),
    ],
)
def test_conv3d_function_gradients_match_plain_fp32(cuda, x_shape, w_shape, relu, crop):
    """fp32 with TF32 off: the kernel forward and cuDNN's backward against
    autograd through the plain version, within 1e-4 of each reference's
    largest value (fp32 sums in other orders)."""
    x, w, b = _conv_inputs(cuda, x_shape, w_shape, F32, crop, "lines")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = [t.detach().requires_grad_(True) for t in (x, w, b)]
        ref = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
        y = C.conv3d(*got, relu=relu)
        r = C.conv3d_plain(*ref, relu=relu)
        g = torch.randn(r.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
        (y * g).sum().backward()
        (r * g).sum().backward()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for a, want in [(y.detach(), r.detach())] + [(t.grad, u.grad) for t, u in zip(got, ref)]:
        assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_conv3d_kernel_chains_on_16_byte_voxels(cuda, dtype):
    """A kernel output (300 channels: 600-byte voxels in bf16) is laid
    out on 16-byte lines, so the next conv gathers it with 16-byte
    copies; crops of it stay aligned."""
    x, w, b = _conv_inputs(cuda, (1, 7, 12, 12, 300), (3, 3, 3, 300, 300), dtype, None)
    y = C.conv3d(x, w, b, relu=True)
    assert C._copy_bytes(x) == (8 if dtype == BF16 else 16)
    assert C._copy_bytes(y) == 16 and C._copy_bytes(center_crop(y, (3, 7, 7))) == 16
    w2 = w[:1, :1, :1]
    got = C.conv3d(center_crop(y, (3, 7, 7)), w2, None)
    ref = C.conv3d_plain(center_crop(y, (3, 7, 7)), w2, None)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == F32 else 2.0**-6
    np.testing.assert_allclose(
        got.float().cpu().numpy(), ref.float().cpu().numpy(), rtol=tol, atol=tol
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,size,kind",
    [
        pytest.param(shape, size, "uniform", id=f"{'x'.join(map(str, shape))}-s{size}")
        for shape in [(3, 33, 70), (8, 640, 640)]
        for size in [3, 4, 7, 10, 11, 33]
    ]
    + EDGE_CASES
    + [
        # enough warps for row blocks of 128, 64 and 32 rows, with 8-byte
        # and 16-byte rows; the general body on a stack of many row blocks
        pytest.param((40, 700, 1250), 10, "normal", id="40x700x1250-s10-normal"),
        # a blockwise ws block with its context at the pipeline's defaults
        pytest.param((36, 320, 320), 10, "normal", id="36x320x320-s10-normal"),
        pytest.param((12, 700, 1250), 16, "normal", id="12x700x1250-s16-normal"),
        pytest.param((16, 500, 640), 9, "negative", id="16x500x640-s9-negative"),
        pytest.param((8, 640, 640), 17, "neginf", id="8x640x640-s17-neginf"),
        # a window so large that one warp's rows fill a CTA's shared memory
        pytest.param((2, 200, 300), 150, "normal", id="2x200x300-s150-normal"),
    ],
)
def test_seed_kernel_matches_plain(cuda, shape, size, kind):
    """Bit-exact against the plain version and scipy: max and >= do not
    round."""
    dist, mask = seed_stack(size, shape, kind)
    d = torch.from_numpy(dist).to(cuda)  # a crop stays a strided view
    m = torch.from_numpy(mask > 0).to(cuda)
    before = S.COUNTS["kernel"]
    got = S.seed_maxima_3d(d, m, size)
    torch.cuda.synchronize()
    assert S.COUNTS["kernel"] == before + 1
    assert S.LAST_PLAN["body"] == ("registers" if size <= 16 else "general")
    assert torch.equal(got, S.seed_maxima_plain(d, m, size))
    np.testing.assert_array_equal(got.cpu().numpy(), scipy_seeds(dist, mask, size))


@pytest.mark.cuda
@pytest.mark.parametrize("offset,copy_bytes", [(0, 16), (2, 8), (1, 4)])
def test_seed_kernel_copy_width_follows_alignment(cuda, offset, copy_bytes):
    """A stack that starts 0, 8 or 4 bytes past a 16-byte boundary (a
    contiguous slice of a larger buffer) takes 16-, 8- or 4-byte copies;
    the seeds are the same."""
    shape, size = (3, 24, 136), 10
    dist, mask = seed_stack(offset, shape, "normal")
    n = dist.size
    buf = torch.empty(n + 4, device=cuda)
    d = buf[offset : offset + n].view(shape).copy_(torch.from_numpy(dist))
    mbuf = torch.empty(n + 4, dtype=torch.bool, device=cuda)
    m = mbuf[offset : offset + n].view(shape).copy_(torch.from_numpy(mask > 0))
    got = S.seed_maxima_3d(d, m, size)
    torch.cuda.synchronize()
    assert S.LAST_PLAN["copy_bytes"] == copy_bytes
    np.testing.assert_array_equal(got.cpu().numpy(), scipy_seeds(dist, mask, size))


@pytest.mark.cuda
def test_seed_kernel_raises_for_a_window_beyond_shared_memory(cuda):
    """The general body keeps `size` rows of maxima per warp in shared
    memory; a window that cannot fit is refused before any launch."""
    d = torch.zeros((1, 64, 64), device=cuda)
    before = S.COUNTS["kernel"]
    with pytest.raises(RuntimeError, match="seed kernel launch failed"):
        S.seed_maxima_3d(d, d > -1, 1000)
    assert S.COUNTS["kernel"] == before


def _stream_net_config():
    """A narrow 3d_affs net, 4 -> 24 -> 144 channels (the 144-channel
    convs take the kernel, the rest the library), z context 20."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=4, fmap_inc_factor=6, input_shape=[24, 48, 48], output_shape=[4, 8, 8],
        shape_increase=[0, 0, 0], downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3, kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
    )
    return nc


@pytest.mark.cuda
def test_stream_step_matches_forward_bf16(cuda):
    """On the card in bf16: a warm step of 2 output slices and three
    steady steps of 3 against the forward on the concatenated input.  The
    kernel sums each output voxel in the same order whatever the tile; the
    library's narrow convs may pick other algorithms at other shapes, so a
    bf16 rounding may flip and carry through the later layers (atol 2^-5 on
    sigmoid outputs, a few uint8 steps)."""
    nc = _stream_net_config()
    model = load_params(Model(nc), init_params_numpy(nc, 0)).to(cuda, torch.bfloat16).eval()
    x = np.random.default_rng(0).uniform(-1, 1, (1, 31, 56, 56, 1)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    before = C.COUNTS["kernel"]
    with torch.no_grad():
        full = model(x)
        parts, state = [], None
        for a, b in [(0, 22), (22, 25), (25, 28), (28, 31)]:
            outs, state = model.forward_stream(x[:, a:b], state)
            parts.append(outs)
    torch.cuda.synchronize()
    assert C.COUNTS["kernel"] > before
    for name in full:
        got = torch.cat([p[name] for p in parts], dim=1)
        assert got.shape == full[name].shape
        np.testing.assert_allclose(got.cpu().numpy(), full[name].cpu().numpy(), atol=2.0**-5, rtol=0)


@pytest.mark.cuda
def test_transposed_net_bf16_matches_fp32(cuda):
    """A transposed-upsample net (``constant_upsample = false``, 4 -> 24 ->
    144 -> 864 channels: the wide convs after each upsample on the kernel)
    in bf16 against its fp32 forward on the card: the upsample a bf16
    product, the convs bf16 (sigmoid outputs within 0.05, the smoke's
    gate)."""
    nc = get_net_config("3d_affs")
    nc.update(num_fmaps=4, fmap_inc_factor=6, constant_upsample=False)
    params = init_params_numpy(nc, 0)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 29, 100, 100, 1)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    outs = {}
    before = C.COUNTS["kernel"]
    for dtype in (F32, BF16):
        model = load_params(Model(nc, compute_dtype=dtype), params).to_compute(cuda, dtype).eval()
        with torch.no_grad():
            outs[dtype] = model(x)["3d_affs"].float().cpu().numpy()
    assert C.COUNTS["kernel"] > before
    assert outs[BF16].shape == (1, 1, 8, 8, 9) and np.isfinite(outs[BF16]).all()
    np.testing.assert_allclose(outs[BF16], outs[F32], atol=0.05, rtol=0)


@pytest.mark.cuda
def test_device_io_keeps_a_pinned_buffer_per_shape(cuda):
    """Items of two shapes in any order: each slot pins one buffer per
    (name, shape) at first use and reuses it; outputs stay right."""
    io = DeviceIO(cuda)
    shapes = [(1, 6, 8, 8, 1), (1, 2, 8, 8, 1), (1, 2, 8, 8, 1), (1, 6, 8, 8, 1)] * 2
    for i, shape in enumerate(shapes):
        event, outs = io.run(np.full(shape, i, np.uint8), lambda t: {"y": t + 1})
        event.synchronize()
        assert outs["y"].is_pinned() and (outs["y"].numpy() == i + 1).all()
    for slot in io._slots:
        assert len(slot._bufs) == 4  # ("in", "y") x two shapes


@pytest.mark.cuda
def test_compute_aff_errors_cuda_matches_cpu(cuda, tmp_path):
    """The prediction-error map on the card against its CPU route, on ids
    past 2^32 and uint8 predictions: the map within 1e-6 (nine fp32 squares
    summed in another order), the masks equal except where the error lies
    within 1e-6 of a threshold, the counts equal."""
    from bootstrapper_torch.core.arrays import open_ds, prepare_ds
    from bootstrapper_torch.eval import compute_aff_errors

    nbhd = get_net_config("3d_affs")["outputs"]["3d_affs"]["neighborhood"]
    rng = np.random.default_rng(0)
    shape = (12, 70, 66)
    seg = (rng.integers(1, 6, (3, 7, 6)).astype(np.uint64) << np.uint64(33)).repeat(4, 0).repeat(10, 1).repeat(11, 2)
    seg[:, :, :5] = 0
    pred = rng.integers(0, 256, (len(nbhd), *shape)).astype(np.uint8)
    arrays = {}
    for name, a in (("seg", seg), ("pred", pred)):
        ds = prepare_ds(str(tmp_path / "e.zarr" / name), a.shape, (0, 0, 0), (40, 4, 4), a.dtype)
        ds[ds.roi] = a
        arrays[name] = ds
    runs = {
        dev: compute_aff_errors(arrays["seg"], arrays["pred"], nbhd, str(tmp_path / f"{dev}.zarr"),
                                block_shape=(8, 32, 32), device=dev)
        for dev in (cuda, "cpu")
    }
    got, want = runs[cuda], runs["cpu"]
    gm, wm = open_ds(got["error_map"]).to_ndarray(), open_ds(want["error_map"]).to_ndarray()
    np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-6)
    tie = (np.abs(wm - 0.1) <= 1e-6) | (np.abs(wm - 1.0) <= 1e-6)
    differs = open_ds(got["error_mask"]).to_ndarray() != open_ds(want["error_mask"]).to_ndarray()
    assert not differs[~tie].any()
    assert abs(got["nonzero_voxels"] - want["nonzero_voxels"]) <= int(differs[tie].sum())
    assert got["total_voxels"] == want["total_voxels"] == seg.size


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", ["default", "on"])
def test_lsds_and_lsd_errors_cuda_match_cpu(cuda, tmp_path, tf32):
    """LSDs and the LSD error map on the card against their CPU route, with
    TF32 left at its default or turned on for both cuBLAS and cuDNN: the LSD
    route runs its blurs in fp32 itself (TF32 would move the descriptors by
    up to ~7e-4), so both agree within 1e-5, and the caller's TF32 setting
    is back after the call."""
    from bootstrapper_torch.core.arrays import open_ds, prepare_ds
    from bootstrapper_torch.eval import compute_lsd_errors
    from bootstrapper_torch.ops.lsd import lsd_descriptors_downsampled

    rng = np.random.default_rng(0)
    seg = rng.integers(0, 70, (4, 13, 13)).repeat(2, 1).repeat(2, 2)[:, :26, :25].astype(np.int64)
    pred = rng.integers(0, 256, (10, *seg.shape)).astype(np.uint8)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        if tf32 == "on":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        got = lsd_descriptors_downsampled(torch.from_numpy(seg).to(cuda), 80, (40, 4, 4), downsample=2, max_labels=64)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
        want = lsd_descriptors_downsampled(seg, 80, (40, 4, 4), downsample=2, max_labels=64)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5)
        arrays = {}
        for name, a in (("seg", seg.astype(np.uint64)), ("pred", pred)):
            ds = prepare_ds(str(tmp_path / "l.zarr" / name), a.shape, (0, 0, 0), (40, 4, 4), a.dtype)
            ds[ds.roi] = a
            arrays[name] = ds
        runs = {
            dev: compute_lsd_errors(arrays["seg"], arrays["pred"], 80, str(tmp_path / f"{dev}.zarr"),
                                    block_shape=(2, 16, 16), device=dev)
            for dev in (cuda, "cpu")
        }
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    got, want = runs[cuda], runs["cpu"]
    gm, wm = open_ds(got["error_map"]).to_ndarray(), open_ds(want["error_map"]).to_ndarray()
    np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-5)
    tie = (np.abs(wm - 0.1) <= 1e-5) | (np.abs(wm - 1.0) <= 1e-5)
    differs = open_ds(got["error_mask"]).to_ndarray() != open_ds(want["error_mask"]).to_ndarray()
    assert not differs[~tie].any()
    assert abs(got["nonzero_voxels"] - want["nonzero_voxels"]) <= int(differs[tie].sum())
    assert got["total_voxels"] == want["total_voxels"] == seg.size
