"""Port parity for ops/knn.py: Morton codes and the 3-NN scale-init distance.

Morton codes must match exactly.  ``mean_sq_dist_to_3nn`` is the same
windowed Morton algorithm as the JAX package's, so it must agree point by
point, not only approximate the exact KNN: 1e-5 relative at ≥ 99 % of the
points (the rotated passes' fp32 products may round a coordinate across a
10-bit quantisation step and move a point in the Morton order), and within
1e-3 on the median.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import knn as jknn
from seganygaussians_torch.ops import knn as tknn


def clouds():
    rng = np.random.default_rng(21)
    gauss = rng.normal(scale=0.5, size=(900, 3)).astype(np.float32)
    clustered = np.concatenate([
        rng.normal(loc=c, scale=0.05, size=(150, 3)) for c in rng.uniform(-2, 2, (5, 3))
    ]).astype(np.float32)
    return {"gaussian": gauss, "clustered": clustered}


@pytest.mark.parametrize("kind", ["gaussian", "clustered"])
def test_morton_codes_exact(kind):
    xyz = clouds()[kind]
    want = np.asarray(jknn.morton_codes(jnp.asarray(xyz)))
    got = tknn.morton_codes(torch.from_numpy(xyz)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fixed_rotations_match():
    for a, b in zip(tknn._fixed_rotations(4), jknn._fixed_rotations(4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["gaussian", "clustered"])
def test_mean_sq_dist_to_3nn_matches_jax(kind):
    xyz = clouds()[kind]
    want = np.asarray(jknn.mean_sq_dist_to_3nn(jnp.asarray(xyz)))
    got = tknn.mean_sq_dist_to_3nn(torch.from_numpy(xyz)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(want, 1e-12)
    assert np.mean(rel <= 1e-5) >= 0.99, np.sort(rel)[-10:]
    assert np.median(rel) <= 1e-3
