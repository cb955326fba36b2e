"""bootstrapper_torch ``post/fragments.py:watershed_from_affinities``
against the JAX package's (which takes its scipy seed branch on the CPU):
fragments, their count and the labelled seeds are equal, with affinities
in [0, 1] and in [0, 255].  Labels are integers: the comparison is exact.
"""

import numpy as np
import pytest
from scipy import ndimage

from bootstrapper_torch.post.fragments import watershed_from_affinities
from bootstrapper_tpu.post.fragments import watershed_from_affinities as jax_watershed


def _affs(seed, max_value, shape=(3, 4, 48, 56)):
    rng = np.random.default_rng(seed)
    a = ndimage.gaussian_filter(rng.uniform(size=shape), sigma=(0, 0, 3, 3))
    a = (a - a.min()) / (a.max() - a.min())
    return (a * max_value).astype(np.float32)


@pytest.mark.parametrize("min_seed_distance", [10, 5])
@pytest.mark.parametrize("max_affinity_value", [1.0, 255.0])
@pytest.mark.parametrize("fragments_in_xy", [True, False])
def test_fragments_count_and_seeds_match_jax(
    fragments_in_xy, max_affinity_value, min_seed_distance
):
    affs = _affs(7, max_affinity_value)
    kwargs = dict(
        fragments_in_xy=fragments_in_xy,
        min_seed_distance=min_seed_distance,
        max_affinity_value=max_affinity_value,
    )
    got = watershed_from_affinities(affs, return_seeds=True, device="cpu", **kwargs)
    want = jax_watershed(affs, return_seeds=True, **kwargs)
    assert len(got) == len(want) == 3
    assert got[1] == want[1] > 1
    for g, w in zip((got[0], got[2]), (want[0], want[2])):
        assert g.dtype == w.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
    # every fragment grows from its seed and keeps the seed's id
    seeds = got[2]
    np.testing.assert_array_equal(got[0][seeds != 0], seeds[seeds != 0])
    # without return_seeds the first two items come back alone
    frags, n = watershed_from_affinities(affs, device="cpu", **kwargs)
    assert n == got[1]
    np.testing.assert_array_equal(frags, got[0])


def test_threshold_scales_with_max_affinity_value():
    """Affinities in [0, 255] read with the default scale lie all above
    0.5: one boundary mask, other fragments than with the scale stated."""
    affs = _affs(3, 255.0)
    scaled, n_scaled = watershed_from_affinities(
        affs, fragments_in_xy=True, max_affinity_value=255.0, device="cpu"
    )
    unit, n_unit = watershed_from_affinities(
        affs / 255.0, fragments_in_xy=True, device="cpu"
    )
    assert n_scaled == n_unit
    np.testing.assert_array_equal(scaled, unit)
    _, n_default = watershed_from_affinities(affs, fragments_in_xy=True, device="cpu")
    assert n_default != n_scaled
