"""Device-side augmentations on tensors: the augments of the JAX package's
``pipeline/augment.py`` that the training transform reaches (the
per-section shift only for 2D setups).

Each augment is a *draw* and an *apply*:

- the draw takes a ``Generators``: scalars (coins, angles, scales, per-slab
  factors) come from its ``host`` generator as Python numbers, so that no
  draw waits for the card; dense fields (noise, impulse masks, the flow's
  control grid) come from its ``dense`` generator on the card;
- the apply is deterministic given the draws, and computes what the JAX
  function computes from the same numbers (``tests/test_torch_augment.py``
  feeds it the draws the JAX function makes from its key).

The public function (``noise_augment(gen, raw, ...)``) is the apply of a
fresh draw, with a ``Generators`` in place of the JAX key.  ``jax.random``
and ``torch.Generator`` never give the same numbers, so the draws match
the JAX package in distribution only.

Arrays are unbatched ``(*spatial,)``: fp32 raw in [0, 1], int labels.
Per-slab scalars go to the card in one pinned copy (``host_to``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F


class Generators:
    """The two generators of a draw: ``host`` (CPU) for scalars and
    ``dense`` for dense fields on ``device``."""

    def __init__(self, seed: int, device="cpu"):
        self.device = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed))
        self.dense = torch.Generator(device=self.device).manual_seed(int(seed) + 1)

    def uniform(self, low=0.0, high=1.0, n=None):
        """Python float(s) uniform in ``[low, high)`` (fp32 draws)."""
        u = torch.rand(1 if n is None else n, generator=self.host) * (high - low) + low
        return float(u[0]) if n is None else u.tolist()

    def coin(self, p: float) -> bool:
        return bool(torch.rand(1, generator=self.host)[0] < p)

    def normal_field(self, shape):
        return torch.randn(shape, generator=self.dense, device=self.device)

    def uniform_field(self, shape):
        return torch.rand(shape, generator=self.dense, device=self.device)


def host_to(values, device, dtype=torch.float32):
    """A small host list as a tensor on ``device``: one copy from pinned
    memory, queued without waiting for the card."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# ---------------------------------------------------------------------------
# geometric
# ---------------------------------------------------------------------------


def draw_simple(gen: Generators, n_mirror: int) -> dict:
    return {"flips": [gen.coin(0.5) for _ in range(n_mirror)], "transpose": gen.coin(0.5)}


def apply_simple(arrays: dict, flips, transpose, mirror_axes=None, transpose_axes=(-2, -1)) -> dict:
    """Mirror along ``mirror_axes[i]`` where ``flips[i]``, then swap the two
    (equal-sized) ``transpose_axes`` where ``transpose``; the same for every
    array."""
    dims = next(iter(arrays.values())).dim()
    mirror_axes = tuple(range(dims)) if mirror_axes is None else mirror_axes
    flip_axes = [ax for ax, f in zip(mirror_axes, flips) if f]
    a, b = [ax % dims for ax in transpose_axes]

    def apply(x):
        if flip_axes:
            x = torch.flip(x, flip_axes)
        return x.transpose(a, b) if transpose else x

    return {k: apply(v) for k, v in arrays.items()}


def simple_augment(gen: Generators, arrays: dict, mirror_axes=None, transpose_axes=(-2, -1)):
    """Random mirrors along each axis and a random transpose
    (SimpleAugment)."""
    dims = next(iter(arrays.values())).dim()
    n = dims if mirror_axes is None else len(mirror_axes)
    return apply_simple(arrays, **draw_simple(gen, n), mirror_axes=mirror_axes, transpose_axes=transpose_axes)


def _keys_cubic(x):
    """Keys' cubic kernel (a = -0.5), as ``jax.image`` evaluates it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    """The linear kernel ``max(0, 1 - x)``, as ``jax.image`` evaluates it."""
    return torch.clamp(1.0 - x, min=0.0)


_RESIZE_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_matrix(m: int, n: int, method: str, device=None):
    """``(m, n)`` fp32 weights of ``jax.image.resize(..., method)`` along one
    axis from ``m`` to ``n`` samples (``jax.image.scale_and_translate``,
    ``method`` "cubic" or "linear"): half-pixel centres, the kernel scaled
    by the step when downsampling (antialiasing), the taps that fall
    outside dropped and the rest renormalised."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.0 - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = _RESIZE_KERNELS[method](x)
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x, shape, method: str):
    """``jax.image.resize(x, shape, method)`` for fp32 ``x``: the weight
    matrix of each axis that changes, applied axis by axis."""
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = resize_matrix(m, n, method, x.device)
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x


def _grids(shape, device):
    return torch.stack(
        torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=device) for s in shape], indexing="ij")
    )


def control_shape(shape, control_spacing) -> tuple:
    return tuple(max(2, -(-s // c)) + 1 for s, c in zip(shape, control_spacing))


def draw_flow(gen: Generators, shape, control_spacing, rotation_max, scale_range) -> dict:
    """The draws of ``_sample_flow``: unit normal noise on the control grid
    (on the card), a rotation angle and a scale."""
    return {
        "noise": gen.normal_field((len(shape), *control_shape(shape, control_spacing))),
        "angle": gen.uniform(-rotation_max, rotation_max),
        "scale": gen.uniform(scale_range[0], scale_range[1]),
    }


def apply_flow(shape, jitter_sigma, noise, angle, scale):
    """Dense ``(dims, *shape)`` displacement: the control grid's jitter
    (``noise`` times ``jitter_sigma``) resized by cubic interpolation, plus
    the rotation by ``angle`` in the last two axes about the centre and the
    isotropic ``scale`` (an inverse map)."""
    dims = len(shape)
    device = noise.device
    sigma = host_to(list(jitter_sigma), device).reshape((dims,) + (1,) * dims)
    flow = resize(noise * sigma, (dims, *shape), "cubic")
    grids = _grids(shape, device)
    cy = (shape[-2] - 1) / 2.0
    cx = (shape[-1] - 1) / 2.0
    y = grids[-2] - cy
    x = grids[-1] - cx
    a = torch.tensor(angle, dtype=torch.float32)
    cos, sin = float(torch.cos(a)), float(torch.sin(a))
    src_y = (cos * y + sin * x) / scale + cy
    src_x = (-sin * y + cos * x) / scale + cx
    rot_flow = torch.zeros_like(grids)
    rot_flow[-2] = src_y - grids[-2]
    rot_flow[-1] = src_x - grids[-1]
    return flow + rot_flow


def map_linear_nearest(x, coords):
    """``jax.scipy.ndimage.map_coordinates(x, coords, order=1,
    mode="nearest")``: each corner index clamped into the array, weights
    from the unclamped coordinate, the corners summed in the same order."""
    shape = x.shape
    nodes = []
    for c, s in zip(coords, shape):
        lower = torch.floor(c)
        upper_w = c - lower
        lower_w = 1 - upper_w
        index = lower.to(torch.int64)
        nodes.append(
            [(index.clamp(0, s - 1), lower_w), ((index + 1).clamp(0, s - 1), upper_w)]
        )
    out = None
    for corner in itertools.product(*nodes):
        idx = tuple(i for i, _ in corner)
        w = corner[0][1]
        for _, wk in corner[1:]:
            w = w * wk
        term = w * x[idx]
        out = term if out is None else out + term
    return out


def apply_elastic(arrays: dict, interp: dict, flow) -> dict:
    """Resample every array at ``grid + flow``: trilinear with clamped
    corners where ``interp[name]`` is 1, nearest (round half to even,
    clipped) where 0."""
    shape = next(iter(arrays.values())).shape
    coords = _grids(shape, flow.device) + flow
    out = {}
    for name, x in arrays.items():
        if interp.get(name, 1) == 0:
            ci = tuple(
                torch.clamp(torch.round(c).to(torch.int64), 0, s - 1) for c, s in zip(coords, shape)
            )
            out[name] = x[ci]
        else:
            out[name] = map_linear_nearest(x.float(), coords)
    return out


def elastic_deform(
    gen: Generators,
    arrays: dict,
    interp: dict,
    control_spacing=(8, 32, 32),
    jitter_sigma=(0.0, 2.0, 2.0),
    rotation_max=np.pi / 2,
    scale_range=(0.9, 1.1),
):
    """Elastic deformation, rotation and scale (DeformAugment);
    ``interp[name]``: 1 linear (raw), 0 nearest (labels, masks)."""
    shape = tuple(next(iter(arrays.values())).shape)
    dims = len(shape)
    draws = draw_flow(gen, shape, tuple(control_spacing[-dims:]), rotation_max, scale_range)
    return apply_elastic(arrays, interp, apply_flow(shape, tuple(jitter_sigma[-dims:]), **draws))


def draw_shift(gen: Generators, n_sections: int, max_shift: int = 4, prob: float = 0.05) -> dict:
    """Per z section: a coin of ``prob`` and, where it falls, a (y, x) shift
    uniform in ``[-max_shift, max_shift]``; (0, 0) elsewhere."""
    hit = [gen.coin(prob) for _ in range(n_sections)]
    shifts = torch.randint(-max_shift, max_shift + 1, (n_sections, 2), generator=gen.host).tolist()
    return {"shifts": [tuple(s) if h else (0, 0) for h, s in zip(hit, shifts)]}


def apply_shift(arrays: dict, shifts) -> dict:
    """Roll each z section of every array by its (y, x) shift, wrapping
    around as ``jnp.roll`` does (no padding); only the shifted sections are
    touched."""

    def apply(x):
        moved = [(z, s) for z, s in enumerate(shifts) if any(s)]
        if not moved:
            return x
        out = x.clone()
        for z, s in moved:
            out[z] = torch.roll(x[z], tuple(s), dims=(0, 1))
        return out

    return {k: apply(v) for k, v in arrays.items()}


def shift_augment(gen: Generators, arrays: dict, interp=None, max_shift: int = 4, prob: float = 0.05):
    """Per-section random xy shifts, "slip" (ShiftAugment): each section
    shifts with probability ``prob``.  ``interp`` is taken for the JAX
    signature; a roll moves whole voxels, so it needs none."""
    n = next(iter(arrays.values())).shape[0]
    return apply_shift(arrays, **draw_shift(gen, n, max_shift, prob))


# ---------------------------------------------------------------------------
# intensity
# ---------------------------------------------------------------------------


def _per_slab(x, fn, params: dict, slab_axis):
    """``fn(x, **params)`` with each param a tensor broadcast over the slab
    axis (one value per index of ``slab_axis``), or over the whole array
    when ``slab_axis`` is None (Python scalars)."""
    if slab_axis is None:
        return fn(x, **params)
    xs = torch.movedim(x, slab_axis, 0)
    view = (-1,) + (1,) * (xs.dim() - 1)
    out = fn(xs, **{k: v.reshape(view) for k, v in params.items()})
    return torch.movedim(out, 0, slab_axis)


def _slab_mean(x):
    """Mean over all axes but the first, kept for broadcasting."""
    return x.mean(tuple(range(1, x.dim())), keepdim=True)


def _slab_values(gen, x, slab_axis, low, high):
    """One uniform draw per slab (or one for the whole array)."""
    if slab_axis is None:
        return gen.uniform(low, high)
    return host_to(gen.uniform(low, high, x.shape[slab_axis]), x.device)


def draw_intensity(gen, x, scale_range=(0.9, 1.1), shift_range=(-0.1, 0.1), slab_axis=0):
    return {
        "scale": _slab_values(gen, x, slab_axis, *scale_range),
        "shift": _slab_values(gen, x, slab_axis, *shift_range),
    }


def apply_intensity(raw, scale, shift, slab_axis=0):
    """``clip(mean + (raw - mean) * scale + shift, 0, 1)`` per slab."""

    def fn(x, scale, shift):
        mean = _slab_mean(x) if slab_axis is not None else x.mean()
        return torch.clamp(mean + (x - mean) * scale + shift, 0.0, 1.0)

    return _per_slab(raw, fn, {"scale": scale, "shift": shift}, slab_axis)


def intensity_augment(gen, raw, scale_range=(0.9, 1.1), shift_range=(-0.1, 0.1), slab_axis=0):
    """raw -> mean + (raw - mean) * scale + shift, per slab
    (IntensityAugment)."""
    return apply_intensity(raw, **draw_intensity(gen, raw, scale_range, shift_range, slab_axis), slab_axis=slab_axis)


def draw_noise(gen, shape, sigma_max=0.05):
    return {"sigma": gen.uniform(0.0, sigma_max), "noise": gen.normal_field(shape)}


def apply_noise(raw, sigma, noise):
    return torch.clamp(raw + sigma * noise, 0.0, 1.0)


def noise_augment(gen, raw, sigma_max=0.05):
    """Gaussian noise of a random sigma in ``[0, sigma_max)``."""
    return apply_noise(raw, **draw_noise(gen, tuple(raw.shape), sigma_max))


def draw_gamma(gen, x, gamma_range=(0.8, 1.25), slab_axis=None):
    low, high = float(np.log(gamma_range[0])), float(np.log(gamma_range[1]))
    return {"log_gamma": _slab_values(gen, x, slab_axis, low, high)}


def apply_gamma(raw, log_gamma, slab_axis=None):
    """``clip(clip(raw, 1e-6, 1) ** exp(log_gamma), 0, 1)`` per slab."""
    if slab_axis is None:
        log_gamma = torch.tensor(log_gamma, dtype=torch.float32)

    def fn(x, log_gamma):
        return torch.clamp(torch.pow(torch.clamp(x, 1e-6, 1.0), torch.exp(log_gamma)), 0.0, 1.0)

    return _per_slab(raw, fn, {"log_gamma": log_gamma}, slab_axis)


def gamma_augment(gen, raw, gamma_range=(0.8, 1.25), slab_axis=None):
    """Symmetric log-uniform gamma (GammaAugment)."""
    return apply_gamma(raw, **draw_gamma(gen, raw, gamma_range, slab_axis), slab_axis=slab_axis)


def draw_impulse(gen, shape, prob=0.01):
    return {"hit": gen.uniform_field(shape) < prob, "values": gen.uniform_field(shape)}


def apply_impulse(raw, hit, values):
    return torch.where(hit, values, raw)


def impulse_noise_augment(gen, raw, prob=0.01):
    """Each voxel replaced by a uniform value with probability ``prob``."""
    return apply_impulse(raw, **draw_impulse(gen, tuple(raw.shape), prob))


def _gaussian_taps(sigma, radius: int):
    """Normalised gaussian taps ``(..., 2*radius+1)`` for ``sigma`` (a
    tensor), as ``_gaussian_blur_fixed_radius`` makes them."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    g = torch.exp(-0.5 * (offs / torch.clamp(sigma[..., None], min=1e-3)) ** 2)
    return g / g.sum(-1, keepdim=True)


def _blur_slabs(x, taps):
    """Separable blur of each slab ``x[i]`` (all axes but the first) with
    its own taps ``taps[i]`` and zero padding."""
    n, k = taps.shape
    r = k // 2
    for ax in range(1, x.dim()):
        moved = torch.movedim(x, ax, -1)
        shape = moved.shape
        # (rows, slabs, length): one group per slab
        rows = torch.movedim(moved, 0, -2).reshape(-1, n, shape[-1])
        out = F.conv1d(rows, taps[:, None, :], padding=r, groups=n)
        out = torch.movedim(out.reshape(*shape[1:-1], n, shape[-1]), -2, 0)
        x = torch.movedim(out, -1, ax)
    return x


def _gaussian_blur_fixed_radius(x, sigma, radius: int):
    """Separable gaussian blur of ``x`` over all its axes with a static
    radius (zero padding)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(1)
    return _blur_slabs(x[None], _gaussian_taps(sigma, radius))[0]


def draw_smooth(gen, x, sigma_range=(0.0, 1.5), slab_axis=0):
    return {"sigma": _slab_values(gen, x, slab_axis, *sigma_range)}


def apply_smooth(raw, sigma, slab_axis=0, radius=4):
    """Blur each slab with its sigma where that sigma exceeds 0.05."""
    if slab_axis is None:
        return _gaussian_blur_fixed_radius(raw, sigma, radius) if sigma > 0.05 else raw
    xs = torch.movedim(raw, slab_axis, 0)
    sigma = sigma.to(raw.device)
    blurred = _blur_slabs(xs, _gaussian_taps(sigma, radius))
    keep = (sigma > 0.05).reshape((-1,) + (1,) * (xs.dim() - 1))
    return torch.movedim(torch.where(keep, blurred, xs), 0, slab_axis)


def smooth_augment(gen, raw, sigma_range=(0.0, 1.5), slab_axis=0, radius=4):
    """Per-slab random-sigma gaussian blur (SmoothAugment)."""
    return apply_smooth(raw, **draw_smooth(gen, raw, sigma_range, slab_axis), slab_axis=slab_axis, radius=radius)


def draw_defect(gen, n_sections: int) -> dict:
    """Per section: the uniform that picks its defect, and the blend alpha
    used where no artifact mask is given."""
    return {"u": gen.uniform(0.0, 1.0, n_sections), "alpha": gen.uniform(0.3, 0.9, n_sections)}


def apply_defect(
    raw, u, alpha, prob_missing=0.05, prob_low_contrast=0.05, prob_artifact=0.0,
    contrast_scale=0.1, artifact=None, artifact_mask=None, missing_fill=0.0,
):
    """Per z section by its ``u``: filled (``u < prob_missing``), low
    contrast (the next ``prob_low_contrast``), or blended with ``artifact``
    (the next ``prob_artifact``) by ``artifact_mask`` or the section's
    ``alpha``.  Only the sections hit are touched."""
    out = raw.clone()
    p_art = prob_artifact if (artifact is not None and prob_artifact > 0) else 0.0
    # the thresholds in fp32, as the JAX package compares its fp32 draws
    t_missing, t_low, t_art = np.float32(
        [prob_missing, prob_missing + prob_low_contrast, prob_missing + prob_low_contrast + p_art]
    )
    for z, uz in enumerate(np.float32(u)):
        if uz < t_missing:
            out[z] = missing_fill
        elif uz < t_low:
            mean = raw[z].mean()
            out[z] = mean + (raw[z] - mean) * contrast_scale
        elif uz < t_art:
            a = alpha[z] if artifact_mask is None else artifact_mask[z].to(raw.dtype)
            out[z] = out[z] * (1 - a) + artifact[z] * a
    return out


def defect_augment(
    gen, raw, prob_missing=0.05, prob_low_contrast=0.05, prob_artifact=0.0,
    contrast_scale=0.1, artifact=None, artifact_mask=None, missing_fill=0.0,
):
    """Per-z-section defects: fill-out, low contrast, artifact blend
    (DefectAugment, the ``artifacts_mask`` alpha where given)."""
    return apply_defect(
        raw, **draw_defect(gen, raw.shape[0]), prob_missing=prob_missing,
        prob_low_contrast=prob_low_contrast, prob_artifact=prob_artifact,
        contrast_scale=contrast_scale, artifact=artifact, artifact_mask=artifact_mask,
        missing_fill=missing_fill,
    )

