"""The host side of the port's bf16 conv kernel, on the CPU: the weight
layout it reads (``pack_weights`` and its inverse), the tile plan fitted to
the net's channel counts, the activations' 16-byte voxel lines, the
U-Net's packed-weight cache, and the build's view of the kernel sources.

``test_torch_kernels_cuda.py`` holds the kernel itself against its plain
version on the card; here the plain version on unpacked weights is held
against the JAX package's Pallas kernel (interpret mode).
"""

import importlib.util
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import _build
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_tpu.ops.pallas_conv import pallas_conv3d

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU thread(s): the test run uses
    six worker processes at once, and torch's thread pools in all
    of them oversubscribe the cores (each op waits on threads that are not
    scheduled); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _weights(kernel, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((*kernel, ci, co)).astype(np.float32))


# (kernel, Ci, input-channel slice as conv_split cuts it, or None)
SLICES = [
    ((3, 1, 2), 130, None),
    ((3, 1, 2), 300, None),
    ((1, 1, 1), 1500, None),
    ((1, 2, 1), 360, (0, 60)),  # [skip, up] of a decoder conv: the skip...
    ((1, 2, 1), 360, (60, 360)),  # ...and the upsampled part
    ((1, 1, 2), 1800, (300, 1800)),
]


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("co", [9, 60, 300])
@pytest.mark.parametrize("kernel,ci,cut", SLICES)
def test_unpack_inverts_pack(kernel, ci, cut, co, dtype):
    """Exact, for full weights and for strided channel slices."""
    w = _weights(kernel, ci, co)
    if cut is not None:
        w = w[..., cut[0] : cut[1], :]
        assert not w.is_contiguous()
    packed = C.pack_weights(w, dtype)
    assert packed.shape == tuple(w.shape) and packed.data.dtype == dtype
    assert packed.data.is_contiguous()
    assert torch.equal(C.unpack_weights(packed), w.to(dtype))


@pytest.mark.parametrize("ci,co", [(130, 9), (300, 60), (200, 300)])
def test_packed_layout_is_what_the_kernel_reads(ci, co):
    """Element (tap, k, n) sits in the 1024-byte block (tap, k // 64,
    n // 8), at row n % 8, in the 16-byte group (k % 64 // 8) ^ (n % 8):
    K-major rows of 128 bytes under the 128-byte swizzle.  The rest of the
    blocks (channels past Ci, past Co up to a multiple of 8) is zero, and a
    tile of BN output channels of one (tap, chunk) is one contiguous run."""
    w = _weights((2, 1, 1), ci, co, seed=1).to(BF16)
    flat = C.pack_weights(w, BF16).data.reshape(-1)
    chunks, co8 = -(-ci // 64), -(-co // 8) * 8
    assert flat.numel() == 2 * chunks * co8 * 64
    rng = np.random.default_rng(2)
    for _ in range(400):
        tap, k, n = int(rng.integers(2)), int(rng.integers(chunks * 64)), int(rng.integers(co8))
        block = (tap * chunks + k // 64) * (co8 // 8) + n // 8
        row, kk = n % 8, k % 64
        offset = block * 512 + row * 64 + ((kk // 8) ^ row) * 8 + kk % 8
        want = float(w[tap, 0, 0, k, n]) if k < ci and n < co else 0.0
        assert float(flat[offset]) == want


def test_fp32_rows_layout_pads_co_to_8():
    w = _weights((1, 1, 2), 130, 9)
    packed = C.pack_weights(w, F32)
    assert packed.layout == "rows" and tuple(packed.data.shape) == (2 * 130, 16)
    assert torch.equal(packed.data[:, :9], w.reshape(260, 9))
    assert not packed.data[:, 9:].any()


def test_pack_refuses_other_dtypes():
    with pytest.raises(TypeError):
        C.pack_weights(_weights((1, 1, 1), 128, 8), torch.float16)


PALLAS_SHAPES = [
    ((6, 12, 10, 128), (3, 3, 3, 128, 64)),
    ((4, 9, 8, 130), (3, 3, 3, 130, 48)),
    ((3, 6, 7, 128), (1, 3, 3, 128, 128)),
    ((5, 8, 6, 256), (3, 1, 1, 256, 32)),
]


@pytest.mark.parametrize("shape,kernel", PALLAS_SHAPES)
def test_plain_on_unpacked_weights_matches_pallas(shape, kernel):
    """What the kernel is given (the packed weights, unpacked again) makes
    the conv the JAX package's kernel makes: fp32, atol 2e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, *shape)).astype(np.float32)
    w = (rng.standard_normal(kernel) * 0.05).astype(np.float32)
    b = rng.standard_normal(kernel[-1]).astype(np.float32)
    ref = np.asarray(
        pallas_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True, interpret=True)
    )
    unpacked = C.unpack_weights(C.pack_weights(torch.from_numpy(w), F32))
    got = C.conv3d_plain(torch.from_numpy(x), unpacked, torch.from_numpy(b), relu=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


# -- the tile plan ------------------------------------------------------------


@pytest.mark.parametrize("ci", [300, 1500])
@pytest.mark.parametrize("co,bn,n_tiles", [(60, 64, 1), (300, 152, 2), (1500, 152, 10)])
def test_tile_plan_fits_the_nets_channel_counts(ci, co, bn, n_tiles):
    plan = C.tile_plan(ci, co)
    assert (plan.bn, plan.n_tiles) == (bn, n_tiles)
    assert plan.n_tiles * plan.bn >= co  # the tiles cover Co
    assert plan.bn % 8 == 0 and plan.bn <= 256  # what wgmma takes as N
    assert plan.waste < 0.08
    assert plan.co8 % 8 == 0 and co <= plan.co8 < co + 8
    # K: 64-channel chunks, and only the k16 steps that hold channels
    assert plan.chunks == -(-ci // 64)
    assert plan.k16_steps == -(-ci // 16)
    assert plan.k16_steps <= 4 * plan.chunks < plan.k16_steps + 4
    # the ring fits the shared memory a block can opt in to, three deep or more
    assert plan.stages >= 3
    assert C.smem_bytes(plan.bn, plan.stages) <= C.SMEM_OPTIN
    assert C.smem_bytes(plan.bn, plan.stages + 1) > C.SMEM_OPTIN or plan.stages == C.MAX_STAGES


@pytest.mark.parametrize("co", [8, 9, 48, 64, 70, 128, 152, 256, 304, 512, 1000])
def test_tile_plan_covers_any_co(co):
    plan = C.tile_plan(128, co)
    assert plan.bn in C.TILE_WIDTHS and plan.bm == C.TILE_WIDTHS[plan.bn]
    assert (plan.n_tiles - 1) * plan.bn < co <= plan.n_tiles * plan.bn
    # no other instantiated width pads less
    assert all(plan.n_tiles * plan.bn <= -(-co // n) * n for n in C.TILE_WIDTHS)


# -- the activations' layout ----------------------------------------------------


@pytest.mark.parametrize(
    "c,dtype,pitch",
    [
        (300, BF16, 304),  # 600-byte voxels -> 608
        (1500, BF16, 1504),
        (304, BF16, 304),
        (300, F32, 300),  # 1200 bytes: already on 16-byte lines
        (130, F32, 132),
        (60, BF16, 60),  # below what the kernel takes as input: dense
        (9, F32, 9),
    ],
)
def test_empty_channels_last_puts_voxels_on_16_byte_lines(c, dtype, pitch):
    t = C.empty_channels_last((2, 3, 4, 5, c), dtype, "cpu")
    assert tuple(t.shape) == (2, 3, 4, 5, c) and t.dtype == dtype
    assert t.stride() == (60 * pitch, 20 * pitch, 5 * pitch, pitch, 1)
    if c >= 128:
        assert C._copy_bytes(t) == 16 and C._copy_bytes(t[:, 1:, 1:, 1:]) == 16


@pytest.mark.parametrize("c", [60, 300])
def test_to_channels_last_keeps_the_values(c):
    y = torch.from_numpy(np.random.default_rng(0).standard_normal((1, c, 2, 3, 4)))
    y = y.to(BF16)
    out = C.to_channels_last(y)
    assert tuple(out.shape) == (1, 2, 3, 4, c)
    assert out.stride(-1) == 1 and out.stride(3) == (304 if c == 300 else 60)
    assert torch.equal(out, y.permute(0, 2, 3, 4, 1))


# -- the U-Net packs once ---------------------------------------------------------


def _narrow_model():
    """144- and 864-channel levels: some convs take the kernel route."""
    nc = get_net_config("3d_affs")
    nc.update(num_fmaps=4, fmap_inc_factor=6)
    params = init_params_numpy(nc, seed=0)
    return nc, params, load_params(Model(nc, compute_dtype=F32), params).eval()


def _as_on_the_card(x, w, b=None, *, relu=False, pack=None):
    """``conv3d`` as it routes a CUDA tensor, run on the CPU: where the
    kernel would launch, its plain version on the very weights the kernel
    would be handed (the caller's packed form, unpacked again)."""
    if not C.conv3d_supported(tuple(x.shape), tuple(w.shape)):
        return C.conv3d_library(x, w, b, relu=relu)
    return C.conv3d_plain(x, C.unpack_weights(pack()), b, relu=relu)


def test_unet_packs_each_conv_part_once_and_repacks_changed_parameters(monkeypatch):
    nc, params, model = _narrow_model()
    x = torch.from_numpy(
        np.random.default_rng(0).uniform(-1, 1, (1, 29, 100, 100, 1)).astype(np.float32)
    )
    before = dict(C.COUNTS)
    with torch.no_grad():
        on_cpu = model(x)["3d_affs"]
        parts = C.COUNTS["plain"] - before["plain"]  # kernel-route conv parts
        assert parts > 0
        assert C.COUNTS["pack"] == before["pack"]  # the CPU route packs nothing

        monkeypatch.setattr("bootstrapper_torch.models.unet.conv3d", _as_on_the_card)
        first = model(x)["3d_affs"]
        assert C.COUNTS["pack"] - before["pack"] == parts
        # the packed weights are the conv's (strided and dense weights
        # take other matmul routes, hence not bit-equal)
        torch.testing.assert_close(first, on_cpu, rtol=0, atol=1e-6)
        second = model(x)["3d_affs"]
        assert C.COUNTS["pack"] - before["pack"] == parts  # none per call
        assert torch.equal(first, second)

        load_params(model, params)  # the same values, written in place
        model(x)
        assert C.COUNTS["pack"] - before["pack"] == 2 * parts

        model.double()  # new storage and dtype
        model.compute_dtype = torch.float64
        model.float()
        model.compute_dtype = F32
        model(x)
        assert C.COUNTS["pack"] - before["pack"] == 3 * parts


def test_packed_weights_follow_the_parameter():
    """A repack after ``load_params`` holds the new values; slices are kept
    apart; the state dict holds only the JAX-layout parameters."""
    nc, params, model = _narrow_model()
    conv = model.unet.r_conv[0][0].layers[0]  # over [skip 24, up 144] channels
    skip, up = conv.packed(F32, 0, 24), conv.packed(F32, 24, 168)
    assert conv.packed(F32, 24, 168) is up and skip is not up
    assert torch.equal(C.unpack_weights(up), conv.w.detach()[..., 24:168, :])
    with torch.no_grad():
        conv.w.mul_(2.0)
    assert torch.equal(C.unpack_weights(conv.packed(F32, 24, 168)), conv.w.detach()[..., 24:168, :])
    assert all("packed" not in k for k in model.state_dict())


# -- the build -------------------------------------------------------------------


def test_build_sees_the_headers_a_source_includes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint k;\n')
    (csrc / "a.cuh").write_text('  #  include "sub/b.cuh"\n')
    (csrc / "sub").mkdir()
    (csrc / "sub" / "b.cuh").write_text('#include "../a.cuh"\n')  # a cycle
    (csrc / "other.cuh").write_text("")
    files = _build.source_files("k", str(csrc))
    assert sorted(os.path.relpath(f, csrc) for f in files) == ["a.cuh", "k.cu", "sub/b.cuh"]

    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "_build"))
    assert _build._stale("k")  # never built
    os.makedirs(_build.BUILD)
    with open(_build.lib_path("k"), "w"):
        pass
    now = time.time()
    for f in files:
        os.utime(f, (now - 100, now - 100))
    os.utime(_build.lib_path("k"), (now - 50, now - 50))
    assert not _build._stale("k")
    os.utime(csrc / "sub" / "b.cuh", (now, now))  # an edited header rebuilds
    assert _build._stale("k")
    os.utime(csrc / "sub" / "b.cuh", (now - 100, now - 100))
    os.utime(csrc / "other.cuh", (now, now))  # one that is not included does not
    assert not _build._stale("k")


def test_conv3d_source_includes_the_generated_wgmma_header():
    names = [os.path.basename(f) for f in _build.source_files("conv3d")]
    assert sorted(names) == ["conv3d.cu", "wgmma_sm90.cuh"]
    assert [os.path.basename(f) for f in _build.source_files("seed_maxima")] == ["seed_maxima.cu"]


def test_generated_wgmma_header_is_current():
    """``wgmma_sm90.cuh`` is what ``gen_wgmma.py`` writes, for exactly the
    tile widths the host plans with."""
    path = os.path.join(_build.CSRC, "gen_wgmma.py")
    spec = importlib.util.spec_from_file_location("gen_wgmma", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert tuple(gen.WIDTHS) == tuple(C.TILE_WIDTHS)
    with open(os.path.join(_build.CSRC, "wgmma_sm90.cuh")) as f:
        assert f.read() == gen.render()
    for n in gen.WIDTHS:
        assert f"m64n{n}k16" in gen.render()
