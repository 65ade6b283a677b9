"""The feature smoothing's kernel pair (``ops/smooth_cuda.py``,
``csrc/smooth.cu``): the map's reverse and the backward's sum through it on
the CPU, the kernels against the plain path on the card.

The CPU tests hold :func:`smooth_cuda.reverse_map` to its definition on maps
with repeated indices, self columns and skewed in-degrees, and
:func:`smooth_cuda.smooth_backward_plain` (the backward kernel's arithmetic:
the sum through the reverse map with the drawn columns' counts, then the
normalisation's Jacobian) to autograd through the plain path.  The card tests
need an NVIDIA GPU and ``nvcc`` and skip without one; the file imports
nothing of JAX, so on a machine with a card it runs alone:

    python -m pytest --noconftest -q tests/test_torch_smooth.py

Tolerances: the forward within 2e-6 (means of at most 16 unit rows, float32
sums in another order, the card's ``rsqrtf`` against the CPU's); gradients
within 1e-5 of each column's largest absolute value, over the all-zero rows
and over the others apart (an all-zero row's gradient is 1e6 or 1e9 times
its upstream sum).  On the card the
gradient is held to the plain path's in float64, within 1e-5 of each
column's largest value or within 4 times the float32 plain path's own gap,
whichever is larger: a row that thousands of positions name (a hub) sums
thousands of terms that cancel, and float32 sums in any order land 1e-4 of
the column's largest value apart there.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.ops import smooth_cuda
from seganygaussians_torch.utils import tracing

D = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def make_map(kind: str, n: int, k: int, seed: int = 0) -> torch.Tensor:
    """(n, k) int64 maps with what a kNN map or a level holds: ``knn`` self at
    column 0 and repeated indices in a row; ``hubs`` most entries on three
    rows; ``subsample`` every entry in a tenth of the rows (a coarse level);
    ``uniform`` no structure."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        m = rng.integers(0, n, (n, k))
    elif kind == "knn":
        m = rng.integers(0, n, (n, k))
        m[:, 0] = np.arange(n)
        m[::3, 2] = m[::3, 1]  # a neighbour twice in a row
    elif kind == "hubs":
        m = rng.integers(0, n, (n, k))
        hub = rng.random((n, k)) < 0.7
        m[hub] = rng.choice([0, n // 2, n - 1], size=int(hub.sum()))
    elif kind == "subsample":
        sources = rng.choice(n, size=max(n // 10, 1), replace=False)
        m = sources[rng.integers(0, len(sources), (n, k))]
    else:
        raise ValueError(kind)
    return torch.as_tensor(m, dtype=torch.int64)


def features(n: int, seed: int = 0, zero_rows=(1, 5)) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    pf = torch.randn(n, D, generator=g) * 0.3
    pf[list(zero_rows)] = 0.0  # all-zero rows: finite values and gradients
    return pf


def state_of(pf: torch.Tensor, smooth_map: torch.Tensor) -> fgm.FeatureState:
    n = pf.shape[0]
    g = torch.Generator().manual_seed(11)
    xyz = torch.rand(n, 3, generator=g).to(pf.device)
    zeros = torch.zeros(n, 3, device=pf.device)
    geom = fgm.FrozenGeometry(xyz=xyz, scaling=zeros, rotation=torch.zeros(n, 4, device=pf.device),
                              opacity=torch.zeros(n, 1, device=pf.device),
                              alive=torch.ones(n, dtype=torch.bool, device=pf.device))
    return fgm.FeatureState(geom=geom, point_features=pf, smooth_map=smooth_map, opt=None)


class PlainKernel:
    """A smoothing kernel stood in by its plain version, counting launches."""

    def __init__(self, backward: bool):
        self.backward, self.launches = backward, 0

    def __call__(self, *args, accumulate: bool):
        self.launches += 1
        if self.backward:
            pf, grad_out, nbrs, reverse, cols, out, norm = args
            val = smooth_cuda.smooth_backward_plain(pf, grad_out, nbrs.shape[1], reverse, cols, norm)
        else:
            pf, nbrs, cols, out, norm = args
            val = smooth_cuda.smooth_forward_plain(pf, nbrs, cols, norm)
        out.copy_(out + val if accumulate else val)


def stand_in_kernels(monkeypatch) -> tuple:
    fwd, bwd = PlainKernel(False), PlainKernel(True)
    monkeypatch.setattr(smooth_cuda, "FORWARD", fwd)
    monkeypatch.setattr(smooth_cuda, "BACKWARD", bwd)
    return fwd, bwd


def _row_groups(n, pf):
    """Row masks taken apart: the all-zero rows of ``pf`` and the others.  An
    all-zero row's gradient is its upstream sum times the normalisation's
    1/ε (1e6 or 1e9), so on a scale shared with them every other row's gap
    would vanish."""
    if pf is None:
        return [torch.ones(n, dtype=torch.bool)]
    zero = (pf.detach().cpu() == 0).all(dim=1)
    return [m for m in (zero, ~zero) if bool(m.any())]


def col_gap(got, want, pf=None) -> float:
    """The largest gap over each column's largest absolute value of ``want``,
    in each group of rows that :func:`_row_groups` makes of ``pf``."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return max(float(((got[m] - want[m]).abs() / (want[m].abs().amax(dim=0) + 1e-12)).max())
               for m in _row_groups(len(want), pf))


def assert_cols_close(got, want, tol=1e-5, pf=None):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    for m in _row_groups(len(want), pf):
        scale = want[m].abs().amax(dim=0) + 1e-12
        torch.testing.assert_close(got[m] / scale, want[m] / scale, atol=tol, rtol=0)


# --- The reverse map, on the CPU -------------------------------------------


@pytest.mark.parametrize("kind,n,k", [("uniform", 200, 8), ("knn", 150, 16), ("hubs", 300, 4),
                                      ("subsample", 400, 4), ("uniform", 1, 1)])
def test_reverse_map_lists_every_position_once_in_order(kind, n, k):
    nbrs = make_map(kind, n, k, seed=n + k)
    rev = smooth_cuda.reverse_map(nbrs)
    assert rev.offsets.dtype == rev.entries.dtype == torch.int32
    assert rev.offsets.shape == (n + 1,) and rev.entries.shape == (n * k,)
    off, ent = rev.offsets.long(), rev.entries.long()
    assert off[0] == 0 and off[-1] == n * k and bool((torch.diff(off) >= 0).all())
    assert torch.equal(torch.sort(ent).values, torch.arange(n * k))  # each position once
    flat = nbrs.reshape(-1)
    for j in range(n):
        pos = ent[off[j]:off[j + 1]]
        assert bool((flat[pos] == j).all())  # every position of row j names j
        assert bool((torch.diff(pos) > 0).all())  # in (i, c) order
        assert len(pos) == int((flat == j).sum())


def _plain_grad(pf, kind, maps, cols, g_out):
    """autograd through the plain path (CPU tensors)."""
    x = pf.clone().requires_grad_(True)
    if kind == "traditional":
        out = fgm.smoothed_point_features(state_of(x, maps[0]), cols)
    else:
        out = fgm.multi_res_smoothed_features(state_of(x, maps[0]), maps)
    (grad,) = torch.autograd.grad(out, x, g_out)
    return out.detach(), grad


def _cases(n):
    """(normalisation, maps, cols): a K = 16 kNN-like map with 8 drawn
    columns, with a column drawn twice, with all K; hub-heavy; the three
    multi-resolution levels at K 4/4/16."""
    knn = make_map("knn", n, 16, seed=3)
    drawn = torch.randperm(16, generator=torch.Generator().manual_seed(4))[:8]
    levels = (make_map("subsample", n, 4, seed=5), make_map("uniform", n, 4, seed=6),
              make_map("knn", n, 16, seed=7))
    return {
        "drawn": ("traditional", (knn,), drawn),
        "drawn_twice": ("traditional", (knn,), torch.tensor([3, 3, 9])),
        "all": ("traditional", (knn,), None),
        "hubs": ("traditional", (make_map("hubs", n, 16, seed=8),), drawn),
        "multi_res": ("multi_res", levels, None),
    }


CASES = ("drawn", "drawn_twice", "all", "hubs", "multi_res")


@pytest.mark.parametrize("case", CASES)
def test_sum_through_the_reverse_equals_autograd(case):
    n = 120
    norm, maps, cols = _cases(n)[case]
    pf = features(n)
    g_out = torch.randn(n, D, generator=torch.Generator().manual_seed(9))
    _, want = _plain_grad(pf, norm, maps, cols, g_out)
    got = sum(smooth_cuda.smooth_backward_plain(pf, g_out, m.shape[1], smooth_cuda.reverse_map(m),
                                                cols, norm) for m in maps)
    assert bool(torch.isfinite(got).all())
    assert_cols_close(got, want, tol=2e-6, pf=pf)


@pytest.mark.parametrize("norm", smooth_cuda.NORMS)
def test_normalise_backward_is_autograds_at_zero_and_tiny_rows(norm):
    """The Jacobian the backward kernel applies, on an all-zero row, a row
    under the multi-resolution clamp (1e-9) and ordinary rows."""
    pf = torch.randn(6, D, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    pf[0] = 0.0
    pf[1] = 1e-12
    gy = torch.randn(6, D, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    x = pf.clone().requires_grad_(True)
    if norm == "traditional":
        y = x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
    else:
        y = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-9)
    (want,) = torch.autograd.grad(y, x, gy)
    torch.testing.assert_close(smooth_cuda.normalise_backward_plain(pf, gy, norm), want,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("given", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_smooth_mean_adds_the_levels_and_their_gradients(monkeypatch, case, given):
    """``smooth_mean``'s autograd Function with the kernels stood in by their
    plain versions: the first map's launch writes and the later ones add, one
    launch a map each way, the reverse maps given or built at the call."""
    _check_smooth_mean(monkeypatch, case, given, D)


@pytest.mark.parametrize("case", ["drawn", "multi_res"])
def test_smooth_mean_pads_rows_of_six_floats(monkeypatch, case):
    """A session at C = 6: the kernels take rows of a multiple of 4 floats, so
    ``smooth_mean`` runs them on the rows padded with zero columns and gives
    back the first 6, and the gradient of those."""
    _check_smooth_mean(monkeypatch, case, False, 6)


def _check_smooth_mean(monkeypatch, case, given, width):
    fwd, bwd = stand_in_kernels(monkeypatch)
    n = 120
    norm, maps, cols = _cases(n)[case]
    pf = features(n)[:, :width].contiguous()
    g_out = torch.randn(n, width, generator=torch.Generator().manual_seed(9))
    want_out, want_grad = _plain_grad(pf, norm, maps, cols, g_out)
    reverse = tuple(smooth_cuda.reverse_map(m) for m in maps) if given else None
    x = pf.clone().requires_grad_(True)
    out = smooth_cuda.smooth_mean(x, maps, norm, cols, reverse)
    (grad,) = torch.autograd.grad(out, x, g_out)
    assert out.shape == grad.shape == (n, width)
    assert (fwd.launches, bwd.launches) == (len(maps), len(maps))
    torch.testing.assert_close(out.detach(), want_out, atol=1e-6, rtol=0)
    assert_cols_close(grad, want_grad, tol=2e-6, pf=pf)
    with torch.no_grad():
        assert torch.equal(smooth_cuda.smooth_mean(x, maps, norm, cols), out.detach())
    assert (fwd.launches, bwd.launches) == (2 * len(maps), len(maps))


def test_kernels_refuse_cpu_tensors_and_cpu_features_need_no_reverse():
    pf = features(8)
    nbrs = make_map("knn", 8, 4)
    with pytest.raises(ValueError, match="not CUDA"):
        smooth_cuda.FORWARD(pf, nbrs, None, torch.empty_like(pf), "traditional", False)
    with pytest.raises(ValueError, match="not CUDA"):
        smooth_cuda.BACKWARD(pf, pf, nbrs, smooth_cuda.reverse_map(nbrs), None,
                             torch.empty_like(pf), "multi_res", False)
    state = state_of(pf, nbrs)
    assert fgm.reverse_maps(state, "traditional") == ()
    assert fgm.reverse_maps(state, "multi_res", (nbrs,)) == ()


# --- The kernels on the card ------------------------------------------------


def _on(device, maps, cols):
    return tuple(m.to(device) for m in maps), None if cols is None else cols.to(device)


@pytest.mark.parametrize("case", CASES)
def test_kernels_match_the_plain_path(cuda, case):
    n = 5000
    norm, maps, cols = _cases(n)[case]
    pf = features(n, zero_rows=(1, 5, 4999))
    g_out = torch.randn(n, D, generator=torch.Generator().manual_seed(9))
    want_out, want_grad = _plain_grad(pf, norm, maps, cols, g_out)
    dmaps, dcols = _on(cuda, maps, cols)
    reverse = tuple(smooth_cuda.reverse_map(m) for m in dmaps)
    f0, b0 = smooth_cuda.FORWARD.launches, smooth_cuda.BACKWARD.launches
    x = pf.to(cuda).requires_grad_(True)
    if norm == "traditional":
        out = fgm.smoothed_point_features(state_of(x, dmaps[0]), dcols, reverse)
    else:
        out = fgm.multi_res_smoothed_features(state_of(x, dmaps[0]), dmaps, reverse=reverse)
    (grad,) = torch.autograd.grad(out, x, g_out.to(cuda))
    torch.cuda.synchronize()
    assert smooth_cuda.FORWARD.launches - f0 == len(maps)
    assert smooth_cuda.BACKWARD.launches - b0 == len(maps)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(grad).all())
    torch.testing.assert_close(out.detach().cpu(), want_out, atol=2e-6, rtol=0)
    _, exact = _plain_grad(pf.double(), norm, maps, cols, g_out.double())
    assert col_gap(grad, exact, pf) <= max(1e-5, 4 * col_gap(want_grad, exact, pf))
    # Deterministic: the same call gives the same floats.
    (again,) = torch.autograd.grad(
        fgm.smoothed_point_features(state_of(x, dmaps[0]), dcols, reverse)
        if norm == "traditional" else
        fgm.multi_res_smoothed_features(state_of(x, dmaps[0]), dmaps, reverse=reverse),
        x, g_out.to(cuda))
    assert torch.equal(again, grad)


@pytest.mark.parametrize("case", ["drawn", "multi_res"])
def test_kernels_take_a_session_of_six_channels(cuda, case):
    n = 3000
    norm, maps, cols = _cases(n)[case]
    pf = features(n)[:, :6].contiguous()
    g_out = torch.randn(n, 6, generator=torch.Generator().manual_seed(9))
    want_out, want_grad = _plain_grad(pf, norm, maps, cols, g_out)
    dmaps, dcols = _on(cuda, maps, cols)
    x = pf.to(cuda).requires_grad_(True)
    out = smooth_cuda.smooth_mean(x, dmaps, norm, dcols)
    (grad,) = torch.autograd.grad(out, x, g_out.to(cuda))
    assert out.shape == grad.shape == (n, 6)
    torch.testing.assert_close(out.detach().cpu(), want_out, atol=2e-6, rtol=0)
    _, exact = _plain_grad(pf.double(), norm, maps, cols, g_out.double())
    assert col_gap(grad, exact, pf) <= max(1e-5, 4 * col_gap(want_grad, exact, pf))


def test_weighted_levels_on_the_card_raise(cuda):
    n = 500
    _, maps, _ = _cases(n)["multi_res"]
    dmaps, _ = _on(cuda, maps, None)
    state = state_of(features(n).to(cuda), dmaps[0])
    with pytest.raises(NotImplementedError, match="level weights"):
        fgm.multi_res_smoothed_features(state, dmaps, torch.ones(n, 3, device=cuda))


def test_reverse_map_on_the_card_is_the_cpus(cuda):
    nbrs = make_map("hubs", 3000, 16, seed=2)
    rev, want = smooth_cuda.reverse_map(nbrs.to(cuda)), smooth_cuda.reverse_map(nbrs)
    assert torch.equal(rev.offsets.cpu(), want.offsets)
    assert torch.equal(rev.entries.cpu(), want.entries)


@pytest.mark.parametrize("case", ["drawn", "multi_res"])
def test_a_step_through_the_kernels_waits_for_nothing(cuda, case):
    """With the reverse maps given, forward and gradient never read the
    device back to the host."""
    n = 2000
    norm, maps, cols = _cases(n)[case]
    dmaps, dcols = _on(cuda, maps, cols)
    reverse = tuple(smooth_cuda.reverse_map(m) for m in dmaps)
    x = features(n).to(cuda).requires_grad_(True)
    g_out = torch.randn(n, D, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = smooth_cuda.smooth_mean(x, dmaps, norm, dcols, reverse)
        (grad,) = torch.autograd.grad(out, x, g_out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert grad.shape == x.shape


def test_reverse_maps_built_at_the_call_are_counted(cuda):
    n = 1000
    norm, maps, _ = _cases(n)["multi_res"]
    dmaps, _ = _on(cuda, maps, None)
    x = features(n).to(cuda).requires_grad_(True)
    counts = []
    for reverse in (None, tuple(smooth_cuda.reverse_map(m) for m in dmaps)):
        with profile(activities=[ProfilerActivity.CPU]):
            smooth_cuda.smooth_mean(x, dmaps, norm, reverse=reverse).sum().backward()
            counts.append(tracing.summary()["counters"]["smoothing.reverse_builds"])
    assert counts == [3, 0]
