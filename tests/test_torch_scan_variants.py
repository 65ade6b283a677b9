"""``scan_variants_plain`` (the plain PyTorch version beside the Hopper scan
kernel) against the JAX package's Pallas kernel in interpret mode.

The same seeded (256, 256) block goes through ``tools/bench_scan_variants.py``'s
``kernel`` for each of its five variants, at 3 chunks, and through the port's
plain loop.  1e-5 relative to the block's largest value: float32 products and
sums of ≤ 256 terms in another order (Hillis-Steele against
``torch.cumprod``; ``log1p``/``exp`` of two libraries).  ``seq_march``, which
the TPU tool does not have, computes ``roll_lane``'s function.

The kernel's decomposition is held here too: ``feedback_chain_plain`` (the
chain launch's table) against the Pallas kernel's ``acc[:, 0]``, and the
range partials (one work block's share each) against the whole run.
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


def jax_kernel(s, variant, monkeypatch, n_chunk=N_CHUNK):
    monkeypatch.setattr(jtool, "N_CHUNK", n_chunk)  # the module's loop count, for this test
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


@pytest.mark.parametrize("variant", TPU_VARIANTS)
def test_feedback_chain_plain_matches_the_pallas_kernel(variant, monkeypatch):
    # chain[i] is acc[:, 0] after i chunks.  1e-6 relative: the row variants'
    # recurrence is the plain loop's column 0 exactly (T_before is 1 there),
    # exp of two libraries; roll_sub multiplies column 0's 255 factors with
    # torch.cumprod, the Pallas kernel in its own order.
    s = seeded_block()
    chain = ttool.feedback_chain_plain(torch.from_numpy(s), variant, N_CHUNK).numpy()
    assert chain.shape == (N_CHUNK, 256)
    for n in range(N_CHUNK):
        want = jax_kernel(s, variant, monkeypatch, n_chunk=n)[:, 0]
        np.testing.assert_allclose(chain[n], want, rtol=1e-6, atol=0)
    other = "roll_lane" if variant == "roll_sub" else "roll_sub"
    assert np.abs(chain[2] - ttool.feedback_chain_plain(
        torch.from_numpy(s), other, N_CHUNK).numpy()[2]).max() > 1e-2


@pytest.mark.parametrize("variant", ttool.VARIANTS)
def test_range_partials_add_up_to_the_whole_run(variant):
    s = torch.from_numpy(seeded_block())
    chain = ttool.feedback_chain_plain(s, variant, N_CHUNK)
    whole = ttool.scan_variants_plain(s, variant, N_CHUNK, tf32=True)
    parts = [ttool.scan_variants_plain(s, variant, N_CHUNK, tf32=True, chunk_range=r, chain=chain)
             for r in ((0, 1), (1, 3))]
    rel = ((parts[0] + parts[1] - whole).abs() / whole.abs().clamp_min(1e-30)).max()
    assert float(rel) <= 1e-6
    assert torch.equal(parts[0], ttool.scan_variants_plain(s, variant, 1, tf32=True))
    with pytest.raises(ValueError):
        ttool.scan_variants_plain(s, variant, N_CHUNK, chunk_range=(1, 3))  # no chain


def test_chunk_range_count():
    # One chunk range (and partial) a chunk up to 33, and one (empty) range
    # for no chunk: the partials' scratch the wrapper allocates.
    assert [ttool.n_ranges(n) for n in (0, 1, 3, 200, 1000, 1001)] == [1, 1, 3, 33, 33, 33]


def test_tf32_split_reproduces_fp32_log1p():
    s = torch.from_numpy(seeded_block())
    log1m = torch.log1p(-torch.clamp_max(torch.exp(s), 0.99))
    hi, lo = ttool.split_tf32(log1m)
    assert torch.equal(hi, ttool.round_to_tf32(hi)) and torch.equal(lo, ttool.round_to_tf32(lo))
    assert float(((hi + lo - log1m).abs() / log1m.abs()).max()) <= 2.0**-20
    assert float(((hi - log1m).abs() / log1m.abs()).max()) > 2.0**-13  # hi alone: TF32's 11 bits


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
    # Every work launch fills the card's 132 SMs at the tool's 1000 chunks
    # (the grid is the built library's, held to that on the card by
    # test_torch_cuda.py::test_scan_work_grid_fills_the_card), so the
    # card's bound is also the bound on the SMs the grid fills: 1000 chunks
    # make the most chunk ranges, and the bound is the whole card's rate.
    assert ttool.n_ranges(ttool.N_CHUNK) == ttool.MAX_RANGES
    assert ttool.NUM_SMS == 132
    assert ttool.PEAK_FP32_PER_S == 67e12


def test_kernel_comparison_needs_the_card(tmp_path):
    # The comparison times two builds of the CUDA kernel; on the CPU it
    # refuses before it builds anything.
    from seganygaussians_torch.tools import compare_scan_kernels

    with pytest.raises(ValueError, match="CUDA"):
        compare_scan_kernels.compare(tmp_path / "scan_variants.cu", 1, device="cpu")
