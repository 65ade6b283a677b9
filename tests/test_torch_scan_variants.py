"""``scan_variants_plain`` (the plain PyTorch version beside the Hopper scan
kernel) against the JAX package's Pallas kernel in interpret mode.

The same seeded (256, 256) block goes through ``tools/bench_scan_variants.py``'s
``kernel`` for each of its five variants, at 3 chunks, and through the port's
plain loop.  1e-5 relative to the block's largest value: float32 products and
sums of ≤ 256 terms in another order (Hillis-Steele against
``torch.cumprod``; ``log1p``/``exp`` of two libraries).  ``seq_march``, which
the TPU tool does not have, computes ``roll_lane``'s function.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from tools import bench_scan_variants as jtool
from seganygaussians_torch.tools import bench_scan_variants as ttool

N_CHUNK = 3
TPU_VARIANTS = ["exp_only", "log_tri", "log_tri_hs", "roll_lane", "roll_sub"]


def seeded_block():
    return np.random.default_rng(0).uniform(-8, -0.5, (jtool.P, jtool.K)).astype(np.float32)


def jax_kernel(s, variant, monkeypatch):
    monkeypatch.setattr(jtool, "N_CHUNK", N_CHUNK)  # the module's loop count, for this test
    call = pl.pallas_call(
        functools.partial(jtool.kernel, variant=variant),
        out_shape=jax.ShapeDtypeStruct((jtool.P, jtool.K), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(s)))


@pytest.mark.parametrize("variant", TPU_VARIANTS)
def test_scan_variants_plain_matches_the_pallas_kernel(variant, monkeypatch):
    s = seeded_block()
    want = jax_kernel(s, variant, monkeypatch)
    got = ttool.scan_variants_plain(torch.from_numpy(s), variant, N_CHUNK).numpy()
    assert got.shape == want.shape == (256, 256) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if variant != "exp_only":
        # Σ_k alpha_k·T_before_k telescopes to 1 − Π(1 − alpha): each row (each
        # column for roll_sub) adds just under 1 per chunk.
        sums = got.sum(axis=0 if variant == "roll_sub" else 1)
        np.testing.assert_allclose(sums, N_CHUNK, atol=1e-3)


def test_seq_march_computes_roll_lane(monkeypatch):
    s = seeded_block()
    want = jax_kernel(s, "roll_lane", monkeypatch)
    got = ttool.scan_variants_plain(torch.from_numpy(s), "seq_march", N_CHUNK).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # and differs from the scan down the rows
    sub = ttool.scan_variants_plain(torch.from_numpy(s), "roll_sub", N_CHUNK).numpy()
    assert np.abs(got - sub).max() > 1e-2


def test_cpu_tensors_take_the_plain_version_and_unknown_variants_raise():
    s = torch.from_numpy(seeded_block())
    assert torch.equal(ttool.scan_variants(s, "roll_lane", 2),
                       ttool.scan_variants_plain(s, "roll_lane", 2))
    assert ttool.SCAN.launches == 0  # no kernel launch for a CPU tensor
    with pytest.raises(ValueError):
        ttool.scan_variants_plain(s, "bogus", 1)
    with pytest.raises(ValueError):
        ttool.SCAN(s, "roll_lane", 1)  # the kernel refuses a CPU tensor
    with pytest.raises(ValueError):
        ttool.run("roll_lane", 1, device="cpu")  # the tool's timing is the card's


def test_tf32_rounding_and_its_effect_on_log_tri():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -(1.0 + 3 * 2.0**-11), 0.3])
    r = ttool.round_to_tf32(x)
    # 10 mantissa bits, ties away from zero
    np.testing.assert_array_equal(
        r[:4].numpy(), np.float32([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-9)]))
    assert abs(float(r[4]) - 0.3) <= 0.3 * 2.0**-11
    s = torch.from_numpy(seeded_block())
    exact = ttool.scan_variants_plain(s, "log_tri", N_CHUNK)
    rounded = ttool.scan_variants_plain(s, "log_tri", N_CHUNK, tf32=True)
    err = float((exact - rounded).abs().max())
    assert 0 < err < 5e-3  # TF32's three digits, through exp
    assert torch.equal(ttool.scan_variants_plain(s, "log_tri_hs", N_CHUNK, tf32=True),
                       ttool.scan_variants_plain(s, "log_tri_hs", N_CHUNK))


def test_bound_counts_operations_on_the_sms_the_grid_fills():
    # The bound is the whole card's, whatever grid the kernel chose, and it
    # counts the function's work, not the variant's way to it: 65,536
    # elements × (4 for the exp at the quarter-rate unit + the scan's one
    # multiply + the accumulate's multiply and add) over 67 TFLOP/s, the same
    # for every variant that computes T_before.  exp_only: the exp alone.
    assert ttool.bound_us("exp_only") == pytest.approx(65536 * 4 / 67e12 * 1e6)
    for v in ttool.VARIANTS[1:]:
        assert ttool.bound_us(v) == pytest.approx(65536 * 7 / 67e12 * 1e6), v
    # The feedback chain's latency floor is an estimate from its
    # instructions (40-60 cycles at 1.98 GHz), above every bound.
    low, high = ttool.latency_floor_us()
    assert (low, high) == pytest.approx((40 / 1.98e3, 60 / 1.98e3))
    assert low > 2 * max(ttool.bound_us(v) for v in ttool.VARIANTS)
    # The figure for the SMs the grid fills is a separate, larger one.
    for v in ttool.VARIANTS:
        us, sms = ttool.bound_us_on_grid_sms(v)
        assert sms == min(ttool.GRID_BLOCKS[v], ttool.NUM_SMS)
        assert us == pytest.approx(ttool.bound_us(v) * 132 / sms) and us >= ttool.bound_us(v)
    assert ttool.bound_us_on_grid_sms("seq_march")[1] == 8
    assert ttool.bound_us_on_grid_sms("roll_lane")[0] == ttool.bound_us("roll_lane")
