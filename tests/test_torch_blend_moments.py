"""The backward kernel's way of summing, on the CPU.

``csrc/blend_bwd.cu`` sums an instance's gradient over a tile's pixels as two
small products: W·G for the color rows and six moments of d_s over the pixel
coordinates inside the tile for the geometry rows, expanded as the Pallas
kernel expands them (``blend_pallas.py:563-570``).  The kernel runs only on a
card (``tests/test_torch_cuda.py``); ``blend_cuda.blend_backward_moments``
repeats its arithmetic in float32 PyTorch, and here that function is held
against ``blend_backward_plain`` (autograd through ``ops/blend.py``; 1e-5 of
each column's largest value: the same sums in another order) and against the
JAX package's Pallas ``_bwd_kernel`` in interpret mode followed by
``segment_reduce_by_rank`` (2e-4 of each column's largest value, the bound
the JAX package holds Pallas against XLA to), from numpy-seeded inputs.

Also here: the build digest of a kernel covers the headers its source
includes (no compiler needed).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from seganygaussians_tpu.ops import blend_pallas
from seganygaussians_torch.ops import blend_cuda
from tests.test_torch_blend import _binned_inputs
from tests.test_torch_blend_grad import assert_cols_close, cotangents
from tests.test_torch_geometry import t


def _table(a):
    return np.concatenate([a["means2d"], a["conics"], a["opacities"][:, None], a["colors"]],
                          axis=1).astype(np.float32)


def _pallas_grads(a, grid, g_tiles, g_final_t):
    """d_table, d_bg from jax.grad of blend_pallas.blend (the Pallas
    ``_bwd_kernel`` in interpret mode + ``segment_reduce_by_rank``)."""
    keys = ("means2d", "conics", "opacities", "colors", "bg")

    def loss(*args):
        out = blend_pallas.blend(jnp.asarray(a["gauss_id"]), jnp.asarray(a["tile_id"]),
                                 jnp.asarray(a["tile_starts"]), *args, *grid)
        return jnp.sum(out.tiles * g_tiles) + jnp.sum(out.final_t * g_final_t)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*(jnp.asarray(a[k]) for k in keys))
    d_table = np.concatenate([np.asarray(grads[0]), np.asarray(grads[1]),
                              np.asarray(grads[2])[:, None], np.asarray(grads[3])], axis=1)
    return d_table, np.asarray(grads[4])


def _strip_at(x0_tile, c, seed, num_tiles=82):
    """Seeded sorted instances that all lie in tile ``x0_tile`` of a one-row
    strip of 16×16 tiles: at tile 80 the pixel coordinates are ≈ 1280."""
    rng = np.random.default_rng(seed)
    n = 48
    sx, sy = rng.uniform(2, 8, n), rng.uniform(2, 8, n)
    rho = rng.uniform(-0.6, 0.6, n)
    det = 1.0 - rho * rho
    a = dict(
        means2d=np.stack([16 * x0_tile + rng.uniform(-4, 20, n), rng.uniform(-4, 20, n)], 1),
        conics=np.stack([1 / (sx * sx * det), -rho / (sx * sy * det), 1 / (sy * sy * det)], 1),
        opacities=rng.uniform(0.05, 0.5, n), colors=rng.uniform(size=(n, c)),
        bg=np.linspace(0.1, 0.9, c),
    )
    a = {k: v.astype(np.float32) for k, v in a.items()}
    starts = np.zeros(num_tiles + 1, np.int32)
    starts[x0_tile + 1:] = n
    a.update(gauss_id=np.arange(n, dtype=np.int32), tile_id=np.full(n, x0_tile, np.int32),
             tile_starts=starts)
    return a, (num_tiles, 1, 16)


def _moments(a, grid, g_tiles, g_final_t, **kwargs):
    return blend_cuda.blend_backward_moments(
        t(a["gauss_id"]).long(), t(a["tile_starts"]), t(_table(a)), t(a["bg"]),
        t(g_tiles), t(g_final_t), grid, **kwargs)


def _plain(a, grid, g_tiles, g_final_t):
    return blend_cuda.blend_backward_plain(
        t(a["gauss_id"]).long(), t(a["tile_starts"]), t(_table(a)), t(a["bg"]),
        t(g_tiles), t(g_final_t), grid)


@pytest.mark.parametrize("c", [3, 5, 32])
def test_moments_match_plain_backward(rng, c):
    a, grid = _binned_inputs(rng, c)
    g_tiles, g_final_t = cotangents(20 + c, grid[0] * grid[1], grid[2] ** 2, c)
    got = _moments(a, grid, g_tiles, g_final_t)
    want = _plain(a, grid, g_tiles, g_final_t)
    assert want[0][:, :6].abs().amax(dim=0).min() > 0  # every geometry column is live
    assert_cols_close(got[0], want[0], "d_table", tol=1e-5)
    assert_cols_close(got[1][None], want[1][None], "d_bg", tol=1e-5)


@pytest.mark.parametrize("c", [3, 5, 32])
def test_moments_match_pallas_bwd_kernel(rng, c):
    a, grid = _binned_inputs(rng, c)
    g_tiles, g_final_t = cotangents(30 + c, grid[0] * grid[1], grid[2] ** 2, c)
    got = _moments(a, grid, g_tiles, g_final_t)
    want = _pallas_grads(a, grid, g_tiles, g_final_t)
    assert_cols_close(got[0], want[0], "d_table")
    assert_cols_close(got[1][None], want[1][None], "d_bg")


@pytest.mark.parametrize("c", [3, 32])
def test_tile_local_moments_hold_at_x_1280(c):
    """In tile 80 of a strip the pixels' x is ≈ 1280.  With coordinates
    inside the tile the expansion gx²·m0 − 2gx·mx + mxx stays within 1e-5 of
    the plain gradient (and within 2e-4 of the Pallas kernel's); with
    absolute coordinates its terms are ≈ 1.6e6·m0 against a result of
    ≈ dx²·m0, and float32 loses the conic columns."""
    a, grid = _strip_at(80, c, seed=c)
    g_tiles, g_final_t = cotangents(40 + c, grid[0], 256, c)
    want = _plain(a, grid, g_tiles, g_final_t)
    assert want[0][:, :6].abs().amax(dim=0).min() > 0
    local = _moments(a, grid, g_tiles, g_final_t)
    assert_cols_close(local[0], want[0], "d_table, tile-local", tol=1e-5)
    pallas = _pallas_grads(a, grid, g_tiles, g_final_t)
    assert_cols_close(local[0], pallas[0], "d_table against Pallas")
    absolute = _moments(a, grid, g_tiles, g_final_t, tile_local=False)
    scale = want[0].abs().amax(dim=0)
    worst = ((absolute[0] - want[0]).abs().amax(dim=0) / scale)[:6].max()
    assert float(worst) > 2e-4, f"absolute coordinates kept {float(worst):.2g}"
    # The same instances at the strip's first tile: absolute = tile-local there.
    a0, grid0 = _strip_at(0, c, seed=c)
    near = _moments(a0, grid0, g_tiles, g_final_t, tile_local=False)
    assert_cols_close(near[0], _plain(a0, grid0, g_tiles, g_final_t)[0], "d_table at x = 0",
                      tol=1e-5)


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("c", [3, 32])
def test_moments_on_edge_strips(c, opaque):
    """The strips the card tests run (ranges of 0..200 instances, pixels that
    saturate inside a range when ``opaque``), summed the kernel's way."""
    d = chip_smoke.edge_case_frame(c, 40 + c, torch.device("cpu"), opaque=opaque)
    g_tiles, g_final_t = chip_smoke.grad_inputs(d, 7 + c)
    got = blend_cuda.blend_backward_moments(d["gauss_s"], d["tile_starts"], d["table"], d["bg"],
                                            g_tiles, g_final_t, d["grid"])
    want = chip_smoke.run_backward_plain(d, d["gauss_s"], d["tile_starts"], g_tiles, g_final_t)
    assert_cols_close(got[0], want[0], "d_table", tol=1e-5)
    # d_bg is the wrapper's einsum over T·P pixels, not the kernel's: a
    # float32 sum of thousands of terms of both signs in another order than
    # autograd's, so it is held to the largest channel, not to each.
    assert_cols_close(got[1][:, None], want[1][:, None], "d_bg", tol=1e-4)


# --------------------------------------------------------------------------
# The build digest
# --------------------------------------------------------------------------


def _write_sources(root):
    (root / "kernel.cu").write_text('#include "common.cuh"\n  #  include "sub/other.cuh"\nint k;\n')
    (root / "common.cuh").write_text('#pragma once\n#include "nested.cuh"\n#include <cuda.h>\n')
    (root / "nested.cuh").write_text("// nested\n")
    (root / "sub").mkdir()
    (root / "sub" / "other.cuh").write_text('#include "../nested.cuh"\n')
    (root / "unrelated.cuh").write_text("// not included\n")


@pytest.mark.parametrize("changed, moves", [
    ("kernel.cu", True), ("common.cuh", True), ("nested.cuh", True), ("sub/other.cuh", True),
    ("unrelated.cuh", False),
])
def test_build_digest_covers_included_headers(tmp_path, changed, moves):
    _write_sources(tmp_path)
    flags = ("-O3",)
    before = blend_cuda.build_digest(tmp_path / "kernel.cu", flags)
    assert before == blend_cuda.build_digest(tmp_path / "kernel.cu", flags)
    path = tmp_path / changed
    path.write_text(path.read_text() + "// edited\n")
    after = blend_cuda.build_digest(tmp_path / "kernel.cu", flags)
    assert (after != before) == moves
    assert blend_cuda.build_digest(tmp_path / "kernel.cu", ("-O2",)) != after


def test_kernel_libraries_are_named_by_source_headers_and_flags(tmp_path):
    """Both blend sources include the shared header, so an edit of it renames
    both libraries; so does another compiler flag."""
    names = {path.name for path in blend_cuda.source_closure(blend_cuda.BACKWARD.source)}
    assert names == {"blend_bwd.cu", "blend_common.cuh"}
    names = {path.name for path in blend_cuda.source_closure(blend_cuda.FORWARD.source)}
    assert names == {"blend_fwd.cu", "blend_common.cuh"}
    for name in ("blend_fwd.cu", "blend_bwd.cu", "blend_common.cuh"):
        (tmp_path / name).write_bytes((blend_cuda.CSRC / name).read_bytes())
    sources = [tmp_path / "blend_fwd.cu", tmp_path / "blend_bwd.cu"]
    flags = blend_cuda.NVCC_FLAGS
    before = [blend_cuda.build_digest(source, flags) for source in sources]
    assert before == [blend_cuda.build_digest(k.source, flags)
                      for k in (blend_cuda.FORWARD, blend_cuda.BACKWARD)]
    with open(tmp_path / "blend_common.cuh", "a") as f:
        f.write("// edited\n")
    after = [blend_cuda.build_digest(source, flags) for source in sources]
    assert before[0] != after[0] and before[1] != after[1]
    assert blend_cuda.build_digest(sources[0], (*flags, "-DNDEBUG")) != after[0]


@pytest.mark.parametrize("c, tile_size, name", [
    (3, 16, "C=3"), (5, 8, "C=5"), (1, 16, "C=8"), (6, 16, "C=8"), (9, 16, "C=16"),
    (24, 8, "C=24"), (32, 16, "C=32"), (3, 32, "C=3,32x32"), (6, 32, "C=8,32x32"),
    (32, 32, "C=32,32x32"),
])
def test_instance_names_count_launches_by_instance(c, tile_size, name):
    """A launch is counted under the instance that runs it: C rounded up to
    the next instance (the zero-padded columns), and the tile size where it
    is 32 (four blocks a tile), as ``chip_smoke.py`` names its entries."""
    assert blend_cuda.instance_name(c, tile_size) == name
    assert int(name.split(",")[0][2:]) == blend_cuda.instance_channels(c)


@pytest.mark.parametrize("c, groups, names", [
    (33, [(0, 32), (32, 33)], ["C=32", "C=8"]),
    (40, [(0, 32), (32, 40)], ["C=32", "C=8"]),
    (64, [(0, 32), (32, 64)], ["C=32", "C=32"]),
    (100, [(0, 32), (32, 64), (64, 96), (96, 100)], ["C=32", "C=32", "C=32", "C=4"]),
])
def test_more_than_32_channels_have_no_instance(c, groups, names):
    """No instance runs more than 32 channels: such a count runs in groups of
    32 and a last group of the rest, each on the instance of its width."""
    with pytest.raises(ValueError, match="1..32 channels"):
        blend_cuda.instance_name(c, 16)
    assert blend_cuda.channel_groups(c) == groups
    assert [blend_cuda.instance_name(hi - lo, 16) for lo, hi in groups] == names
    assert blend_cuda.channel_groups(32) == [(0, 32)]


class _PlainForward(blend_cuda.ForwardKernel):
    """The forward wrapper with each group's launch replaced by the plain
    blend on CPU tensors; counts groups by instance."""

    def _check(self, tensors, dtypes, device):
        pass

    def _group(self, gauss_s, tile_starts, table, bg, grid_x, tile_size):
        c = table.shape[1] - 6
        assert c <= 32
        name = blend_cuda.instance_name(c, tile_size)
        self.launches_by_instance[name] = self.launches_by_instance.get(name, 0) + 1
        out = _plain_forward(gauss_s, tile_starts, table, bg, grid_x, tile_size)
        return out.tiles, out.final_t, out.n_contrib


class _PlainBackward(blend_cuda.BackwardKernel):
    def _check(self, tensors, dtypes, device):
        pass

    def _group(self, gauss_s, tile_starts, table, bg, g_tiles, g_final_t, tiles, final_t,
               grid_x, tile_size):
        assert table.shape[1] - 6 <= 32
        grid = (grid_x, (tile_starts.shape[0] - 1) // grid_x, tile_size)
        return blend_cuda.blend_backward_plain(gauss_s, tile_starts, table, bg, g_tiles,
                                               g_final_t, grid)[0]


def _plain_forward(gauss_s, tile_starts, table, bg, grid_x, tile_size):
    from seganygaussians_torch.ops import blend as tblend

    starts = tile_starts.long()
    num_tiles = starts.shape[0] - 1
    tile_s = torch.repeat_interleave(torch.arange(num_tiles), starts[1:] - starts[:-1])
    return tblend.blend(gauss_s[:int(starts[-1])], tile_s, tile_starts, table[:, 0:2],
                        table[:, 2:5], table[:, 5], table[:, 6:], bg, grid_x,
                        num_tiles // grid_x, tile_size)


@pytest.mark.parametrize("c", [40, 64])
def test_channel_groups_give_the_whole_blend(rng, c):
    """The wrappers' split of C > 32 into groups, with each group's launch
    replaced by the plain version: the forward's tiles, final_t and
    n_contrib, and the backward's d_table (the geometry rows summed over the
    groups, g_final_t counted once), equal the plain version on all C
    channels."""
    a, grid = _binned_inputs(rng, c)
    gauss_s, starts = t(a["gauss_id"]).long(), t(a["tile_starts"])
    table, bg = t(_table(a)), t(a["bg"])
    fwd = _PlainForward()
    got = fwd(gauss_s, starts, table, bg, grid[0], grid[2])
    want = _plain_forward(gauss_s, starts, table, bg, grid[0], grid[2])
    assert fwd.launches_by_instance["C=32"] == c // 32
    torch.testing.assert_close(got[0], want.tiles, atol=1e-6, rtol=0)
    assert torch.equal(got[1], want.final_t) and torch.equal(got[2], want.n_contrib)
    g_tiles, g_final_t = (t(x) for x in cotangents(c, grid[0] * grid[1], grid[2] ** 2, c))
    d_table = _PlainBackward()(gauss_s, starts, table, bg, g_tiles, g_final_t, got[0], got[1],
                               grid[0], grid[2])
    want_d = blend_cuda.blend_backward_plain(gauss_s, starts, table, bg, g_tiles, g_final_t,
                                             grid)[0]
    assert_cols_close(d_table.numpy(), want_d.numpy(), "d_table", tol=1e-5)
