"""Port parity for ops/quantile.py and seg/scale_gate.py.

Seeded numpy scales go through the JAX package's quantile transform and the
port's: the fitted quantiles and the transformed values agree to 1e-6
(float32 interpolation in the same order), including tied values and values
outside the fitted range.  The scale gate agrees to 1e-6, and a gate saved by
either package loads in the other bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import quantile as jq
from seganygaussians_tpu.seg import scale_gate as jgate
from seganygaussians_torch.ops import quantile as tq
from seganygaussians_torch.seg import scale_gate as tgate

TOL = 1e-6


def seeded_scales(n=700, ties=True):
    rng = np.random.default_rng(5)
    s = rng.gamma(2.0, 0.6, n).astype(np.float32)
    if ties:
        s[::7] = s[3]  # a run of equal values in the middle
        s[::11] = s.max()  # and one at the top
    return s


@pytest.mark.parametrize("n_quantiles", [1000, 64])
@pytest.mark.parametrize("ties", [False, True])
def test_fit_quantile_transform_matches_jax(n_quantiles, ties):
    s = seeded_scales(ties=ties)
    want = jq.fit_quantile_transform(jnp.asarray(s), n_quantiles=n_quantiles)
    got = tq.fit_quantile_transform(torch.from_numpy(s), n_quantiles=n_quantiles)
    assert got.quantiles.shape == want.quantiles.shape
    np.testing.assert_allclose(got.quantiles.numpy(), np.asarray(want.quantiles), atol=TOL, rtol=0)
    assert got.normal == bool(want.normal)


@pytest.mark.parametrize("output", ["uniform", "normal"])
@pytest.mark.parametrize("ties", [False, True])
def test_apply_quantile_transform_matches_jax(output, ties):
    s = seeded_scales(ties=ties)
    rng = np.random.default_rng(6)
    x = np.concatenate([
        rng.uniform(s.min(), s.max(), 200), s[:50],  # inside, and exactly on knots
        [s.min(), s.max(), s.min() - 1.0, s.max() + 3.0, 0.0, -5.0, 1e6],  # ends and outside
    ]).astype(np.float32).reshape(-1, 1)
    jqt = jq.fit_quantile_transform(jnp.asarray(s), output=output)
    tqt = tq.fit_quantile_transform(torch.from_numpy(s), output=output)
    # the same fitted knots on both sides, so only the interpolation is compared
    tqt = tqt._replace(quantiles=torch.from_numpy(np.asarray(jqt.quantiles)))
    want = np.asarray(jq.apply_quantile_transform(jqt, jnp.asarray(x)))
    got = tq.apply_quantile_transform(tqt, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    # the normal branch maps u → ndtri(u), whose slope near the clipped ends
    # (u = 1e-7) is ~1e6: compare it relative to the value
    tol = TOL if output == "uniform" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol if output == "normal" else 0)


def test_interp_clamps_like_numpy():
    xp = torch.tensor([0.0, 1.0, 1.0, 2.0, 4.0])
    fp = torch.linspace(0.0, 1.0, 5)
    x = torch.tensor([-3.0, 0.0, 0.5, 1.0, 1.5, 3.0, 4.0, 9.0])
    want = np.asarray(jnp.interp(jnp.asarray(x.numpy()), jnp.asarray(xp.numpy()),
                                 jnp.asarray(fp.numpy())))
    np.testing.assert_allclose(tq.interp(x, xp, fp).numpy(), want, atol=TOL, rtol=0)


def gate_arrays(d=32):
    rng = np.random.default_rng(8)
    return rng.uniform(-1, 1, (1, d)).astype(np.float32), rng.uniform(-1, 1, d).astype(np.float32)


def test_apply_scale_gate_matches_jax():
    w, b = gate_arrays()
    scales = np.random.default_rng(9).uniform(0, 1, (10, 1)).astype(np.float32)
    want = np.asarray(jgate.apply_scale_gate(
        jgate.ScaleGateParams(jnp.asarray(w), jnp.asarray(b)), jnp.asarray(scales)))
    got = tgate.apply_scale_gate(
        tgate.ScaleGateParams(torch.from_numpy(w), torch.from_numpy(b)), torch.from_numpy(scales))
    assert got.shape == (10, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_init_scale_gate_is_seeded_and_in_range():
    a = tgate.init_scale_gate(torch.Generator().manual_seed(3), 32, device="cpu")
    b = tgate.init_scale_gate(torch.Generator().manual_seed(3), 32, device="cpu")
    assert a.w.shape == (1, 32) and a.b.shape == (32,)
    assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
    assert float(a.w.abs().max()) <= 1.0 and float(a.b.abs().max()) <= 1.0
    assert float(a.w.std()) > 0.2


@pytest.mark.parametrize("dim", [4, 31])
def test_fixed_scale_gate_exact(dim):
    np.testing.assert_array_equal(
        tgate.fixed_scale_gate(dim, 32, device="cpu").numpy(), np.asarray(jgate.fixed_scale_gate(dim, 32)))


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_scale_gate_file_round_trip_across_packages(direction, tmp_path):
    w, b = gate_arrays()
    path = str(tmp_path / "scale_gate.pt")
    if direction == "torch_to_jax":
        tgate.save_scale_gate(path, tgate.ScaleGateParams(torch.from_numpy(w), torch.from_numpy(b)))
        back = jgate.load_scale_gate(path)
        got_w, got_b = np.asarray(back.w), np.asarray(back.b)
    else:
        jgate.save_scale_gate(path, jgate.ScaleGateParams(jnp.asarray(w), jnp.asarray(b)))
        back = tgate.load_scale_gate(path, device="cpu")
        got_w, got_b = back.w.numpy(), back.b.numpy()
    sd = torch.load(path, map_location="cpu", weights_only=False)
    assert set(sd) == {"0.weight", "0.bias"} and tuple(sd["0.weight"].shape) == (32, 1)
    np.testing.assert_array_equal(got_w, w)
    np.testing.assert_array_equal(got_b, b)


def test_scale_gate_from_jax():
    w, b = gate_arrays()
    got = tgate.scale_gate_from_jax(
        jgate.ScaleGateParams(np.asarray(jnp.asarray(w)), np.asarray(jnp.asarray(b))), device="cpu")
    np.testing.assert_array_equal(got.w.numpy(), w)
    np.testing.assert_array_equal(got.b.numpy(), b)
