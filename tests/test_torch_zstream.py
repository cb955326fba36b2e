"""Overlap-save z streaming in the port (``models/zstream.py``,
``Model.forward_stream``, ``predict/zstream.py:plan_stream``) on the CPU.

- The stream equals the port's own forward on the concatenated input:
  valid convs are exact under concatenation, so only float reassociation
  separates them (fp32, atol 2e-6, the JAX package's own bound in
  ``tests/test_zstream.py``); a window or FIFO off by one slice shows up
  as an O(1) error.
- The stream equals the JAX package's ``unet_stream_step`` step by step,
  state extents included (fp32, the tolerance of the JAX parity in
  ``tests/test_torch_unet.py``).
- ``plan_stream`` computes no more than the JAX function's plan (the
  widest tile that fits), and equals it where that tile covers the volume
  evenly; its tile never overhangs the volume.

Both packages get the same numpy-made params (``init_params_numpy``).
Nets: 2 -> 4 -> 8 channels (every conv on the library route) and
4 -> 24 -> 144 (the 144-channel convs on the kernel route, which runs its
plain version here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.models.zstream import stream_eligible, unet_stream_step, z_context
from bootstrapper_torch.ops import launch_counts, reset_launch_counts
from bootstrapper_torch.predict.zstream import default_budget, plan_stream
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.models.zstream import stream_eligible as jax_stream_eligible
from bootstrapper_tpu.models.zstream import unet_stream_step as jax_unet_stream_step
from bootstrapper_tpu.predict.zstream import plan_stream as jax_plan_stream

ATOL_STREAM = 2e-6


def _net_config(num_fmaps=2, inc=2, levels=3, z_kernels=True):
    ks = [3, 3, 3] if z_kernels else [1, 3, 3]
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=num_fmaps,
        fmap_inc_factor=inc,
        input_shape=[24, 48, 48],
        output_shape=[4, 8, 8],
        shape_increase=[0, 0, 0],
        downsample_factors=[[1, 2, 2]] * (levels - 1),
        kernel_size_down=[[ks, ks]] * levels,
        kernel_size_up=[[ks, ks]] * (levels - 1),
    )
    return nc


NETS = {
    "narrow": _net_config(),
    "wide": _net_config(num_fmaps=4, inc=6),
}


def _model(nc, seed=0):
    params = init_params_numpy(nc, seed)
    return load_params(Model(nc, compute_dtype=torch.float32), params).eval(), params


def _input(z, xy=48, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (1, z, xy, xy, 1)).astype(np.float32)


def _steps(ctx, s, warm_s, z_total):
    """[(start, stop)] of the stream's inputs: a warm step of warm_s output
    slices, then steps of s that consume the input exactly."""
    bounds = [(0, warm_s + ctx)]
    while bounds[-1][1] < z_total:
        bounds.append((bounds[-1][1], bounds[-1][1] + s))
    assert bounds[-1][1] == z_total, "test shapes must consume the input exactly"
    return bounds


@pytest.mark.parametrize(
    "net,s,warm_s,z_total",
    [
        ("narrow", 5, 5, 40),  # warm + 3 steady
        ("narrow", 1, 1, 25),  # single-slice steps
        ("narrow", 4, 1, 33),  # a warm step smaller than the steady ones
        ("wide", 3, 2, 31),
    ],
)
def test_stream_matches_forward_on_concatenation(net, s, warm_s, z_total):
    model, _ = _model(NETS[net])
    ctx = z_context(model.unet_config)
    assert ctx == 20
    x = torch.from_numpy(_input(z_total))
    reset_launch_counts()
    with torch.no_grad():
        full = model.unet(x)
        parts, state = [], None
        for a, b in _steps(ctx, s, warm_s, z_total):
            (out,), state = unet_stream_step(model.unet, x[:, a:b], state)
            parts.append(out)
    counts = launch_counts()
    assert counts["conv3d.kernel"] == 0
    assert (counts["conv3d.plain"] > 0) == (net == "wide")
    got = torch.cat(parts, dim=1)
    assert got.shape == full.shape
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL_STREAM, rtol=0)


def test_forward_stream_matches_forward():
    """Model level: warm and steady steps through the sigmoid heads."""
    model, _ = _model(NETS["wide"])
    x = torch.from_numpy(_input(28))
    with torch.no_grad():
        full = model(x)
        outs0, st = model.forward_stream(x[:, :24], None)
        outs1, st = model.forward_stream(x[:, 24:26], st)
        outs2, _ = model.forward_stream(x[:, 26:28], st)
    for name in full:
        got = torch.cat([outs0[name], outs1[name], outs2[name]], dim=1)
        np.testing.assert_allclose(got.numpy(), full[name].numpy(), atol=ATOL_STREAM, rtol=0)


@pytest.mark.parametrize("fold_xy", [False, True])
@pytest.mark.parametrize("net", ["narrow", "wide"])
def test_stream_step_matches_jax(net, fold_xy):
    """Every step's output, and the z extent of every state entry, against
    the JAX package's ``unet_stream_step`` (plain or folded: the fold is
    exact up to reassociation)."""
    nc = dict(NETS[net], fold_xy=fold_xy)
    model, params = _model(nc)
    jcfg = JModel(nc, compute_dtype=jnp.float32).unet_config
    x = _input(31)
    jstate = state = None
    for a, b in _steps(20, 5, 1, 31):
        with torch.no_grad():
            (out,), state = unet_stream_step(model.unet, torch.from_numpy(x[:, a:b]), state)
        jouts, jstate = jax_unet_stream_step(
            params["unet"], jnp.asarray(x[:, a:b]), jstate, jcfg, compute_dtype=jnp.float32
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(jouts[0]), rtol=1e-4, atol=1e-6)
        for key in ("enc", "dec_f"):
            assert [t.shape[1] for t in state[key]] == [t.shape[1] for t in jstate[key]]
        assert [t.shape[1] for t in state["dec_g"][0]] == [t.shape[1] for t in jstate["dec_g"][0]]


def test_stream_state_is_copies():
    """Cached tails hold only their own slices (no view keeps a step's
    activations alive), and the enc caches are the inputs' last slices."""
    model, _ = _model(NETS["narrow"])
    x = torch.from_numpy(_input(25))
    with torch.no_grad():
        _, state = unet_stream_step(model.unet, x, None)
    for t in state["enc"] + state["dec_f"] + state["dec_g"][0]:
        assert t._base is None and t.untyped_storage().nbytes() == t.numel() * t.element_size()
    np.testing.assert_array_equal(state["enc"][0].numpy(), x[:, -4:].numpy())


def test_stream_eligibility_matches_jax():
    flat = _net_config(z_kernels=False)
    pooled = dict(_net_config(), downsample_factors=[[2, 2, 2], [1, 2, 2]])
    for nc in (NETS["narrow"], NETS["wide"], flat):
        assert stream_eligible(Model(nc).unet_config)
        assert jax_stream_eligible(JModel(nc).unet_config)
    assert not stream_eligible(Model(pooled).unet_config)
    assert not jax_stream_eligible(JModel(pooled).unet_config)
    with pytest.raises(ValueError, match="not eligible"):
        unet_stream_step(Model(pooled).unet, torch.zeros(1, 24, 48, 48, 1), None)


def _plan_cost(nc, vol, plan):
    """Input voxels a plan computes: xy columns x input xy area x the z
    slices its steps cover (``plan_stream``'s own measure)."""
    inc, s, warm_s = plan
    t = nc["output_shape"][1] + inc[1]
    columns = -(-vol[1] // t) * (-(-vol[2] // t))
    z = warm_s + max(0, -(-(vol[0] - warm_s) // s)) * s
    return columns * (nc["input_shape"][1] + inc[1]) * (nc["input_shape"][2] + inc[2]) * z


def _check_plan(nc, vol, budget, plan):
    """A plan's invariants: square xy, within the budget, the steady step
    on the warm step's grid, the output tile no wider than the volume."""
    inc, s, warm_s = plan
    assert inc[0] == 0 and inc[1] == inc[2] and inc[1] % 8 == 0
    assert (s + 8) * (nc["input_shape"][1] + inc[1]) * (nc["input_shape"][2] + inc[2]) <= budget
    assert s % warm_s == 0
    assert nc["output_shape"][1] + inc[1] <= min(vol[1], vol[2])


#: cases whose JAX tile already covers the volume evenly (no narrower tile
#: on the pooling grid keeps its columns) at a step that covers the fewest
#: slices: there the port's plan is the JAX package's
SAME_AS_JAX = {
    ((8, 640, 640), 18_900_000, 1),
    ((130, 640, 640), 18_900_000, 1),
    ((130, 640, 640), 160_000_000, 1),
    ((1000, 2000, 2000), 18_900_000, 1),
    ((40, 200, 200), 18_900_000, 1),
}


@pytest.mark.parametrize(
    "vol,budget,min_columns",
    [
        ((8, 640, 640), 18_900_000, 1),  # shallow: the step capped at z/2
        ((130, 640, 640), 18_900_000, 1),  # deep: width capped by the volume
        ((130, 640, 640), 160_000_000, 1),
        ((1000, 2000, 2000), 18_900_000, 1),  # the budget binds
        ((1000, 2000, 2000), 100_000_000, 1),
        ((1000, 2000, 2000), 400_000_000, 1),
        ((1000, 2000, 2000), 100_000_000, 4),  # at least four columns
        ((125, 1250, 1250), 100_000_000, 8),
        ((40, 200, 200), 18_900_000, 1),  # narrower than one tile
        ((3, 1200, 900), 18_900_000, 1),
    ],
)
def test_plan_stream_matches_jax(vol, budget, min_columns):
    """The port's plan computes no more than the JAX package's (the
    widest tile that fits), and is the JAX plan where that tile already
    covers the volume evenly."""
    nc = get_net_config("3d_affs")
    got = plan_stream(nc, vol, max_eff_voxels=budget, min_columns=min_columns)
    want = jax_plan_stream(nc, vol, max_eff_voxels=budget, min_columns=min_columns)
    _check_plan(nc, vol, budget, got)
    inc, s, warm_s = got
    t = nc["output_shape"][1] + inc[1]
    assert -(-vol[1] // t) * (-(-vol[2] // t)) >= min_columns
    assert _plan_cost(nc, vol, got) <= _plan_cost(nc, vol, want)
    if (vol, budget, min_columns) in SAME_AS_JAX:
        assert tuple(got) == tuple(want)


def test_plan_stream_at_the_cremi_volume():
    """CREMI's (125,1250,1250) on one H100: two columns an axis of the
    narrowest tile on the grid that covers the volume with them (632, not
    the widest that fits, 1248, which overhangs by 2 and so needs two an
    axis as well), and the benchmark's ``computed_voxels`` reads at most
    1.08 voxels computed per voxel written (4.21 at the widest tile)."""
    import os
    import sys
    from types import SimpleNamespace

    from bootstrapper_torch.core.geometry import Roi
    from bootstrapper_torch.predict.scan import tile_rois

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
    sys.path.insert(0, bench)
    try:
        from bmk.predict import computed_voxels
    finally:
        sys.path.remove(bench)

    nc = get_net_config("3d_affs")
    vol = (125, 1250, 1250)
    inc, s, warm_s = plan_stream(nc, vol, device="cpu")
    assert (inc, s, warm_s) == ([0, 528, 528], 32, 4)
    tile = (s, *(o + i for o, i in zip(nc["output_shape"][1:], inc[1:])))
    columns = len(tile_rois(Roi((0, 0), vol[1:]), tile[1:]))
    stats = {
        "columns": columns,
        "z_segments": 1,
        "warm_step_z": warm_s,
        "steps_per_column": 1 + -(-(vol[0] - warm_s) // s),
        "step_z": s,
    }
    ratio = computed_voxels(SimpleNamespace(output_tile=tile), stats) / np.prod(vol)
    assert columns == 4 and ratio <= 1.08


def test_plan_stream_picks_z_with_xy():
    """At CREMI's volume the narrower tile frees memory for a step of up to
    62 (half the volume's z); the widest step on the warm step's grid, 60,
    would cover 4 + 3 x 60 = 184 slices for 125.  The plan's step covers
    132, and no step the budget allows there covers fewer."""
    nc = get_net_config("3d_affs")
    vol = (125, 1250, 1250)
    budget = default_budget("cpu")
    inc, s, warm_s = plan_stream(nc, vol, device="cpu")
    xy_in = nc["input_shape"][1] + inc[1]

    def covered(step):
        return warm_s + -(-(vol[0] - warm_s) // step) * step

    allowed = [a for a in range(24, min(64, vol[0] // 2) + 1, warm_s) if (a + 8) * xy_in**2 <= budget]
    assert max(allowed) == 60 and covered(60) == 184
    assert covered(s) == 132 == min(covered(a) for a in allowed)


@pytest.mark.parametrize("z", [3, 40, 125, 1000])
@pytest.mark.parametrize("yx", [(200, 200), (200, 2600), (900, 1200), (1250, 1250), (2600, 2600)])
def test_plan_stream_tile_within_the_volume(z, yx):
    """Over deep and shallow, narrow and wide volumes, at the default
    budget: the tile never overhangs the volume, the plan keeps its
    invariants and computes no more than the JAX package's."""
    nc = get_net_config("3d_affs")
    vol = (z, *yx)
    budget = default_budget("cpu")
    got = plan_stream(nc, vol, device="cpu")
    _check_plan(nc, vol, budget, got)
    want = jax_plan_stream(nc, vol, max_eff_voxels=budget)
    assert _plan_cost(nc, vol, got) <= _plan_cost(nc, vol, want)


def test_default_budget_on_the_cpu():
    """The CPU reports no device memory: plans assume one H100's."""
    assert default_budget("cpu") == default_budget(torch.device("cpu")) > 0
    nc = get_net_config("3d_affs")
    assert plan_stream(nc, (130, 640, 640), device="cpu") == plan_stream(
        nc, (130, 640, 640), max_eff_voxels=default_budget("cpu")
    )


def test_smoke_traces_the_stream_convs():
    """``chip_smoke.py`` names and checks K1 at the shapes the stream
    launches by tracing the steps on the ``meta`` device: a tile's trace
    gives the eleven shapes of ``conv_cases`` (the views the kernel gets,
    weights and bias), and each stream step the same convs in the same
    order; a steady step of s slices runs every conv s slices deep."""
    import chip_smoke as cs

    nc = get_net_config("3d_affs")
    with torch.device("meta"):
        model = Model(nc).eval()
    x = torch.empty((1, *cs.TILED_INPUT, 1), device="meta")
    with torch.no_grad():
        _, traced = cs.trace_kernel_convs(lambda: model(x))

    def view(xs, crop):
        return tuple(xs[:1]) + tuple(crop or xs[1:4]) + tuple(xs[4:])

    want = [(view(c[1], c[2]), c[3], c[4]) for c in cs.conv_cases()]
    assert [(view(c[0], c[1]), c[2], c[3]) for c in traced] == want

    cases = cs.stream_conv_cases(nc, (64, 732, 732), 4)
    assert [c[0] for c in cases] == [f"{p}_{c[0]}" for p in ("warm", "steady") for c in cs.conv_cases()]
    steady = {c[0]: view(c[1], c[2]) for c in cases if c[0].startswith("steady_")}
    assert steady["steady_enc3_c1_1500to1500_k3"][1] == 64 + 2
    assert steady["steady_dec1_res_up300to60_k1"][1:4] == (64, 324, 324)
    warm = {c[0]: view(c[1], c[2]) for c in cases if c[0].startswith("warm_")}
    assert warm["warm_dec1_res_up300to60_k1"][1] == 4 + 4


def test_smoke_flops_per_output_voxel():
    """Tiled (32,412,412) against a steady step at the same xy and at the
    (130,640,640) volume's plan (xy 732): 24.5, 6.40 and 5.85 MFLOP."""
    import chip_smoke as cs

    nc = get_net_config("3d_affs")
    tiled = cs.per_voxel(cs.tile_flops(nc, cs.TILED_INPUT))
    assert abs(tiled - 24.47e6) < 0.01e6
    assert abs(cs.stream_step_flops(nc, (24, 412, 412))["per_output_voxel"] - 6.40e6) < 0.01e6
    steady = cs.stream_step_flops(nc, (64, 732, 732))
    assert abs(steady["per_output_voxel"] - 5.85e6) < 0.01e6
    assert steady["output_voxels"] == 64 * 640 * 640
    inc, s, warm_s = plan_stream(nc, cs.ZSTREAM_SHAPE, device="cpu")
    assert (inc, s, warm_s) == ([0, 536, 536], 64, 4)


def test_smoke_widest_stream_step():
    """The smoke profiles the widest steady step the default budget admits:
    the JAX package's plan (the widest tile that fits) over a volume far
    wider than any tile."""
    import chip_smoke as cs

    nc = get_net_config("3d_affs")
    budget = default_budget("cpu")
    inc, s, _ = jax_plan_stream(nc, (10_000, 20_000, 20_000), max_eff_voxels=budget)
    want = [s, nc["input_shape"][1] + inc[1], nc["input_shape"][2] + inc[2]]
    assert cs.widest_stream_step(nc, budget) == want == [24, 1516, 1516]
