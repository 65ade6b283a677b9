"""Blend on Hopper: the hand-written CUDA kernels and their wrappers.

Counterpart of ``seganygaussians_tpu/ops/blend_pallas.py`` (``blend_fused``,
which launches the Pallas ``_fwd_kernel`` and, for its gradient,
``_bwd_kernel`` followed by ``segment_reduce_by_rank``).  The kernels live in
``csrc/blend_fwd.cu`` and ``csrc/blend_bwd.cu`` (both on
``csrc/blend_common.cuh``); each is compiled with
``nvcc`` for ``sm_90a`` at first use into ``build/torch_ext/`` and bound
through ``ctypes`` (a plain C interface, so a build takes seconds, not the
minutes a source including PyTorch's headers takes).

A CUDA tensor goes through the kernels or raises: a failed build, a refused
launch or a tile size other than 8, 16 and 32 all raise.  The kernels have
instances for C = 3, 4, 5, 8, 16, 24 and 32; any other C ≤ 32 runs through
the next larger instance on zero-padded color columns, as ``blend_pallas.py``
pads C to a multiple of 8, and the padding is cut off the outputs (and off
the gradients).  More than 32 channels run in groups of at most 32
(:func:`channel_groups`), one launch a group: the forward's color tiles are
concatenated and its ``final_t`` and ``n_contrib``, which depend on the
geometry alone, are the first group's; the backward sums the groups'
geometry rows and gives ``g_final_t`` to the first group only.  A CPU tensor
takes the plain version in ``ops/blend.py``, which is differentiable.  The
CUDA path is a ``torch.autograd.Function`` whose forward is the forward kernel
and whose backward is the backward kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from seganygaussians_torch.ops import blend as blend_torch
from seganygaussians_torch.ops.binning import sort_instances

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
CHANNELS = (3, 4, 5, 8, 16, 24, 32)  # kernel instances in csrc/blend_{fwd,bwd}.cu
MAX_CHANNELS = CHANNELS[-1]
TILE_SIZES = (8, 16, 32)  # 32: four blocks a tile, one on each 16×16 quadrant
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in build_log
)
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_closure(source: Path) -> list[Path]:
    """``source`` and every file it includes with ``#include "..."``, directly
    or through another such file (paths relative to the including file)."""
    seen, todo = [], [Path(source).resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            todo.append((path.parent / name).resolve())
    return seen


def build_digest(source: Path, flags) -> str:
    """What names a built library: the source, the headers it includes and the
    compiler flags.  A changed header must not load a stale library."""
    h = hashlib.sha256()
    for path in sorted(source_closure(source)):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the blend kernels cannot be built")
    return found


class _CudaKernel:
    """One ``csrc`` source: its build, its library and its launch count.

    ``launches`` goes up by one each time the kernel is launched, and nowhere
    else, so a caller can show that a run went through the kernel;
    ``launches_by_channels`` splits the same count by the launch's first
    argument (``count_keys``: for the blend kernels the channel count of the
    instance launched, :func:`instance_channels`), and the blend kernels
    split it again by :func:`instance_name` in ``launches_by_instance``
    (which also tells the tile sizes apart).
    """

    name = ""  # C entry point prefix, and source stem unless ``stem`` names one
    stem = ""  # the source a kernel shares with another (one library for both)
    argtypes: list = []
    count_keys: tuple = CHANNELS

    def __init__(self):
        self.source = CSRC / f"{self.stem or self.name}.cu"
        self.launches = 0
        self.launches_by_channels = dict.fromkeys(self.count_keys, 0)
        self.launches_by_instance: dict[str, int] = {}
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_channels = dict.fromkeys(self.count_keys, 0)
        self.launches_by_instance = {}

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def build(self) -> Path:
        """Compile the source (once per content and flag set); return the .so."""
        digest = build_digest(self.source, NVCC_FLAGS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"lib{self.stem or self.name}_{digest}.so"
        if lib_path.exists():
            return lib_path
        # Kernels that share a source may build at once, in threads of one process.
        tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {self.source}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        self.build_log = proc.stderr
        return lib_path

    def library(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                fn = getattr(lib, f"{self.name}_launch")
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                self._lib = lib
            return self._lib

    def _check(self, tensors: dict, dtypes: dict, device: torch.device) -> None:
        for name, x in tensors.items():
            if not x.is_cuda:
                raise ValueError(f"{self.name} kernel: {name} is on {x.device}, not CUDA")
            if x.device != device:
                raise ValueError(f"{self.name} kernel: {name} on {x.device}, table on {device}")
            if not x.is_contiguous():
                raise ValueError(f"{self.name} kernel: {name} is not contiguous")
            if x.dtype != dtypes.get(name, torch.float32):
                raise TypeError(
                    f"{self.name} kernel: {name} is {x.dtype}, "
                    f"needs {dtypes.get(name, torch.float32)}"
                )

    def _channels(self, table: torch.Tensor, bg: torch.Tensor, tile_size: int) -> int:
        """C, after the checks that raise on what the kernel does not take."""
        if table.dim() != 2 or table.shape[1] < 7:
            raise ValueError(f"{self.name} kernel: table shape {tuple(table.shape)}")
        c = table.shape[1] - 6
        if bg.shape != (c,):
            raise ValueError(f"{self.name} kernel: bg shape {tuple(bg.shape)}, needs ({c},)")
        if tile_size not in TILE_SIZES:
            raise ValueError(
                f"{self.name} kernel: tile_size {tile_size} unsupported (takes {TILE_SIZES})"
            )
        return c

    def _launch(self, c: int, num_tiles: int, device: torch.device, *args,
                instance: Optional[str] = None) -> None:
        lib = self.library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, f"{self.name}_launch")(c, *args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError {err}")
        if num_tiles:
            self.launches += 1
            self.launches_by_channels[c] += 1
            if instance is not None:
                self.launches_by_instance[instance] = self.launches_by_instance.get(instance, 0) + 1


_RANKS = {"gauss_s": torch.int64, "tile_starts": torch.int32}


def instance_channels(c: int) -> int:
    """The channel count of the kernel instance that runs C channels: C
    itself where there is one, else C rounded up to a multiple of 8."""
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the blend kernels take 1..{MAX_CHANNELS} channels, got C={c}")
    return c if c in CHANNELS else -(-c // 8) * 8


def channel_groups(c: int) -> list[tuple[int, int]]:
    """The color columns [lo, hi) of the launches that run C channels: one
    launch for C ≤ 32, else groups of 32 and a last group of the rest."""
    if c < 1:
        raise ValueError(f"the blend kernels need at least one channel, got C={c}")
    return [(lo, min(lo + MAX_CHANNELS, c)) for lo in range(0, c, MAX_CHANNELS)]


def _group_table(table: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The geometry columns and color columns [lo, hi) of a blend table."""
    return torch.cat([table[:, :6], table[:, 6 + lo:6 + hi]], dim=1)


def instance_name(c: int, tile_size: int) -> str:
    """The kernel instance that runs C channels on ``tile_size`` tiles, as
    ``launches_by_instance`` names it: ``C=8`` for C = 6 on 16×16 (or 8×8)
    tiles, ``C=32,32x32`` for C = 32 on 32×32 tiles."""
    quad = "" if tile_size in (8, 16) else f",{tile_size}x{tile_size}"
    return f"C={instance_channels(c)}{quad}"


def _pad_channels(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x`` with zero columns appended to its last axis up to ``c``."""
    return torch.nn.functional.pad(x, (0, c - x.shape[-1])).contiguous()


class ForwardKernel(_CudaKernel):
    """``csrc/blend_fwd.cu``: the Pallas ``_fwd_kernel``."""

    name = "blend_fwd"
    argtypes = [_INT] + [_PTR] * 7 + [_INT, _INT, _INT, _PTR]

    def __call__(
        self,
        gauss_s: torch.Tensor,  # (M,) int64 depth rank per sorted instance
        tile_starts: torch.Tensor,  # (T+1,) int32
        table: torch.Tensor,  # (N, 6 + C) float32 depth-ranked rows
        bg: torch.Tensor,  # (C,) float32
        grid_x: int,
        tile_size: int,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Launch the kernel; returns tiles (T, P, C), final_t (T, P),
        n_contrib (T, P) int32."""
        tensors = {"gauss_s": gauss_s, "tile_starts": tile_starts, "table": table, "bg": bg}
        self._check(tensors, _RANKS, table.device)
        c = self._channels(table, bg, tile_size)
        groups = channel_groups(c)
        if len(groups) == 1:
            return self._group(gauss_s, tile_starts, table, bg, grid_x, tile_size)
        outs = [self._group(gauss_s, tile_starts, _group_table(table, lo, hi),
                            bg[lo:hi].contiguous(), grid_x, tile_size) for lo, hi in groups]
        return torch.cat([o[0] for o in outs], dim=-1), outs[0][1], outs[0][2]

    def _group(self, gauss_s, tile_starts, table, bg, grid_x, tile_size):
        """One launch, at most 32 channels."""
        c = table.shape[1] - 6
        ci = instance_channels(c)
        if ci != c:
            table, bg = _pad_channels(table, 6 + ci), _pad_channels(bg, ci)
        p = tile_size * tile_size
        num_tiles = tile_starts.shape[0] - 1
        dev = table.device
        tiles = torch.empty((num_tiles, p, ci), dtype=torch.float32, device=dev)
        final_t = torch.empty((num_tiles, p), dtype=torch.float32, device=dev)
        n_contrib = torch.empty((num_tiles, p), dtype=torch.int32, device=dev)
        self._launch(
            ci, num_tiles, dev,
            gauss_s.data_ptr(), tile_starts.data_ptr(), table.data_ptr(), bg.data_ptr(),
            tiles.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
            num_tiles, grid_x, tile_size, instance=instance_name(c, tile_size),
        )
        if ci != c:
            tiles = tiles[..., :c].contiguous()
        return tiles, final_t, n_contrib


class BackwardKernel(_CudaKernel):
    """``csrc/blend_bwd.cu``: the Pallas ``_bwd_kernel`` and the
    ``segment_reduce_by_rank`` after it."""

    name = "blend_bwd"
    argtypes = [_INT] + [_PTR] * 9 + [_INT, _INT, _INT, _PTR]

    def __call__(
        self,
        gauss_s: torch.Tensor,  # (M,) int64
        tile_starts: torch.Tensor,  # (T+1,) int32
        table: torch.Tensor,  # (N, 6 + C) float32
        bg: torch.Tensor,  # (C,)
        g_tiles: torch.Tensor,  # (T, P, C) dL/d tiles
        g_final_t: torch.Tensor,  # (T, P) dL/d final_t
        tiles: torch.Tensor,  # (T, P, C) forward residual
        final_t: torch.Tensor,  # (T, P) forward residual
        grid_x: int,
        tile_size: int,
    ) -> torch.Tensor:
        """Launch the kernel; returns d_table (N, 6 + C)."""
        tensors = {"gauss_s": gauss_s, "tile_starts": tile_starts, "table": table, "bg": bg,
                   "g_tiles": g_tiles, "g_final_t": g_final_t, "tiles": tiles,
                   "final_t": final_t}
        self._check(tensors, _RANKS, table.device)
        c = self._channels(table, bg, tile_size)
        p = tile_size * tile_size
        num_tiles = tile_starts.shape[0] - 1
        for name, shape in (("g_tiles", (num_tiles, p, c)), ("tiles", (num_tiles, p, c)),
                            ("g_final_t", (num_tiles, p)), ("final_t", (num_tiles, p))):
            if tuple(tensors[name].shape) != shape:
                raise ValueError(
                    f"{self.name} kernel: {name} shape {tuple(tensors[name].shape)}, "
                    f"needs {shape}"
                )
        groups = channel_groups(c)
        if len(groups) == 1:
            return self._group(gauss_s, tile_starts, table, bg, g_tiles, g_final_t, tiles,
                               final_t, grid_x, tile_size)
        # The geometry rows are linear in the cotangents: each group adds its
        # colors' share, and the final_t term counts once.
        d_table = torch.empty_like(table)
        no_final_t = torch.zeros_like(g_final_t)
        for i, (lo, hi) in enumerate(groups):
            d = self._group(gauss_s, tile_starts, _group_table(table, lo, hi),
                            bg[lo:hi].contiguous(), g_tiles[..., lo:hi].contiguous(),
                            g_final_t if i == 0 else no_final_t,
                            tiles[..., lo:hi].contiguous(), final_t, grid_x, tile_size)
            if i == 0:
                d_table[:, :6] = d[:, :6]
            else:
                d_table[:, :6] += d[:, :6]
            d_table[:, 6 + lo:6 + hi] = d[:, 6:]
        return d_table

    def _group(self, gauss_s, tile_starts, table, bg, g_tiles, g_final_t, tiles, final_t,
               grid_x, tile_size):
        """One launch, at most 32 channels."""
        c = table.shape[1] - 6
        num_tiles = tile_starts.shape[0] - 1
        ci = instance_channels(c)
        if ci != c:
            table, bg = _pad_channels(table, 6 + ci), _pad_channels(bg, ci)
            g_tiles, tiles = _pad_channels(g_tiles, ci), _pad_channels(tiles, ci)
        d_table = torch.zeros_like(table)
        self._launch(
            ci, num_tiles, table.device,
            gauss_s.data_ptr(), tile_starts.data_ptr(), table.data_ptr(), bg.data_ptr(),
            g_tiles.data_ptr(), g_final_t.data_ptr(), tiles.data_ptr(), final_t.data_ptr(),
            d_table.data_ptr(), num_tiles, grid_x, tile_size,
            instance=instance_name(c, tile_size),
        )
        return d_table[:, : 6 + c].contiguous() if ci != c else d_table


FORWARD = ForwardKernel()
BACKWARD = BackwardKernel()


def blend_backward(
    gauss_s, tile_starts, table, bg, tiles, final_t,
    g_tiles: Optional[torch.Tensor], g_final_t: Optional[torch.Tensor],
    grid_x: int, tile_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's (d_table (N, 6 + C), d_bg (C,)).  ``None``
    cotangents are zeros, as in ``blend_pallas._fused_bwd``."""
    if g_tiles is None:
        g_tiles, d_bg = torch.zeros_like(tiles), torch.zeros_like(bg)
    else:
        d_bg = torch.einsum("tpc,tp->c", g_tiles, final_t)
    if g_final_t is None:
        g_final_t = torch.zeros_like(final_t)
    d_table = BACKWARD(gauss_s, tile_starts, table, bg, g_tiles.float().contiguous(),
                       g_final_t.float().contiguous(), tiles, final_t, grid_x, tile_size)
    return d_table, d_bg


class _BlendForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, bg, gauss_s, tile_starts, grid_x, tile_size):
        tiles, final_t, n_contrib = FORWARD(
            gauss_s, tile_starts, table, bg, grid_x, tile_size
        )
        ctx.mark_non_differentiable(n_contrib)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gauss_s, tile_starts, table, bg, tiles, final_t)
        ctx.grid = (grid_x, tile_size)
        return tiles, final_t, n_contrib

    @staticmethod
    def backward(ctx, g_tiles, g_final_t, _g_n_contrib):
        gauss_s, tile_starts, table, bg, tiles, final_t = ctx.saved_tensors
        d_table, d_bg = blend_backward(
            gauss_s, tile_starts, table, bg, tiles, final_t, g_tiles, g_final_t, *ctx.grid
        )
        return d_table, d_bg, None, None, None, None


def blend_backward_plain(
    gauss_s: torch.Tensor,  # (M,) depth rank per sorted instance (n = padding)
    tile_starts: torch.Tensor,  # (T+1,)
    table: torch.Tensor,  # (N, 6 + C)
    bg: torch.Tensor,  # (C,)
    g_tiles: Optional[torch.Tensor],  # (T, P, C) or None (zeros)
    g_final_t: Optional[torch.Tensor],  # (T, P) or None (zeros)
    grid: tuple[int, int, int],  # (grid_x, grid_y, tile_size)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch: ``torch.autograd.grad``
    through ``ops/blend.py:blend``, on any device.  Returns (d_table, d_bg)."""
    grid_x, grid_y, tile_size = grid
    n = table.shape[0]
    starts = tile_starts.long()
    live = int(starts[-1])
    counts = starts[1:] - starts[:-1]
    tile_s = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=table.device), counts
    )
    with torch.enable_grad():
        table_ = table.detach().requires_grad_(True)
        bg_ = bg.detach().requires_grad_(True)
        out = blend_torch.blend(
            gauss_s[:live].clamp_max(max(n - 1, 0)), tile_s, tile_starts,
            table_[:, 0:2], table_[:, 2:5], table_[:, 5], table_[:, 6:], bg_,
            grid_x, grid_y, tile_size,
        )
        pairs = [(o, g) for o, g in ((out.tiles, g_tiles), (out.final_t, g_final_t))
                 if g is not None]
        if not pairs:
            return torch.zeros_like(table), torch.zeros_like(bg)
        d_table, d_bg = torch.autograd.grad(
            [o for o, _ in pairs], (table_, bg_), [g for _, g in pairs], allow_unused=True
        )
    return (
        torch.zeros_like(table) if d_table is None else d_table,
        torch.zeros_like(bg) if d_bg is None else d_bg,
    )


def blend_backward_moments(
    gauss_s: torch.Tensor,  # (M,) depth rank per sorted instance
    tile_starts: torch.Tensor,  # (T+1,)
    table: torch.Tensor,  # (N, 6 + C)
    bg: torch.Tensor,  # (C,)
    g_tiles: torch.Tensor,  # (T, P, C)
    g_final_t: torch.Tensor,  # (T, P)
    grid: tuple[int, int, int],  # (grid_x, grid_y, tile_size)
    tile_local: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``d_table`` summed the way ``csrc/blend_bwd.cu`` sums it, in float32
    PyTorch on any device; for the tests (the CUDA kernel cannot run without
    a card, its arithmetic can).  Per instance: the color rows are W·G (each
    pixel's weight times its cotangent), the geometry rows come from the six
    moments of d_s over the pixel coordinates inside the tile,
    Σ d_s·[1, qx, qy, qx², qy², qx·qy], through the expansion of
    ``blend_pallas.py:563-570`` with the mean taken relative to the tile's
    corner.  ``tile_local=False`` takes absolute pixel coordinates instead,
    which is what the expansion cannot afford in float32.  Returns
    (d_table, d_bg)."""
    grid_x, grid_y, ts = grid
    n = table.shape[0]
    num_tiles = grid_x * grid_y
    starts = tile_starts.long()
    live = int(starts[-1])
    tile_s = torch.repeat_interleave(
        torch.arange(num_tiles, device=table.device), starts[1:] - starts[:-1]
    )
    gid = gauss_s[:live].long().clamp_max(max(n - 1, 0))
    means2d, conics, opacity, colors = table[:, 0:2], table[:, 2:5], table[:, 5], table[:, 6:]

    # The march, as ops/blend.py runs it.
    alpha = blend_torch.instance_alphas(gid, tile_s, means2d, conics, opacity, grid_x, ts)
    log1m = torch.log1p(-alpha)
    seg_start = starts[tile_s]

    def exclusive_prefix(x):  # per tile segment, in float64
        cum = torch.cumsum(x.double(), dim=0)
        base = torch.where((seg_start > 0)[:, None], cum[(seg_start - 1).clamp_min(0)],
                           torch.zeros_like(cum[:1]))
        return cum - x.double() - base

    t_before = torch.exp(exclusive_prefix(log1m).float())
    include = (t_before * (1.0 - alpha) >= blend_torch.T_EPS) & (alpha > 0.0)
    w = torch.where(include, alpha * t_before, torch.zeros_like(alpha))  # (M, P)

    def per_tile(x):  # (M, P, ...) summed over each tile's instances
        return torch.zeros((num_tiles, *x.shape[1:]), dtype=x.dtype,
                           device=x.device).index_add_(0, tile_s, x)

    final_t = torch.exp(per_tile(torch.where(include, log1m, torch.zeros_like(log1m))))
    tiles = per_tile(w[:, :, None] * colors[gid][:, None, :]) + final_t[:, :, None] * bg
    g_dot_bg = (g_tiles * bg).sum(-1)
    u_total = (g_tiles * tiles).sum(-1) - final_t * g_dot_bg
    tail_const = (g_dot_bg + g_final_t) * final_t

    g = g_tiles[tile_s]  # (M, P, C)
    g_dot_c = torch.einsum("mpc,mc->mp", g, colors[gid])
    u = g_dot_c * w
    suffix = u_total[tile_s] - (exclusive_prefix(u).float() + u)
    d_alpha = g_dot_c * t_before - (suffix + tail_const[tile_s]) / (1.0 - alpha).clamp_min(1e-6)
    d_s = torch.where(include & (alpha < blend_torch.ALPHA_MAX), d_alpha * alpha,
                      torch.zeros_like(alpha))

    # The kernel's two products over a tile's pixels, then the expansion.
    d_colors = torch.einsum("mp,mpc->mc", w, g)
    local = torch.arange(ts * ts, device=table.device)
    qx = (local % ts).float()[None, :]
    qy = torch.div(local, ts, rounding_mode="floor").float()[None, :]
    tile_x0 = ((tile_s % grid_x) * ts).float()
    tile_y0 = (torch.div(tile_s, grid_x, rounding_mode="floor") * ts).float()
    gx, gy = means2d[gid, 0], means2d[gid, 1]
    if tile_local:
        gx, gy = gx - tile_x0, gy - tile_y0
    else:
        qx, qy = qx + tile_x0[:, None], qy + tile_y0[:, None]
    m0, mx, my, mxx, myy, mxy = (
        (d_s * basis).sum(dim=1)
        for basis in (torch.ones_like(qx), qx, qy, qx * qx, qy * qy, qx * qy)
    )
    ca, cb, cc = conics[gid, 0], conics[gid, 1], conics[gid, 2]
    d_inst = torch.cat([
        torch.stack([
            -(ca * (gx * m0 - mx) + cb * (gy * m0 - my)),
            -(cc * (gy * m0 - my) + cb * (gx * m0 - mx)),
            -0.5 * (gx * gx * m0 - 2.0 * gx * mx + mxx),
            -(gx * gy * m0 - gx * my - gy * mx + mxy),
            -0.5 * (gy * gy * m0 - 2.0 * gy * my + myy),
            m0 / opacity[gid].clamp_min(1e-12),
        ], dim=1),
        d_colors,
    ], dim=1)
    d_table = torch.zeros_like(table).index_add_(0, gid, d_inst)
    return d_table, torch.einsum("tpc,tp->c", g_tiles, final_t)


def blend_fused_plain(
    slot_rank: torch.Tensor,
    slot_tile: torch.Tensor,
    fields,
    bg: torch.Tensor,
    grid_x: int,
    grid_y: int,
    tile_size: int,
) -> blend_torch.BlendOutput:
    """:func:`blend_fused` through the plain version, on any device."""
    fields = tuple(fields)
    gauss_s, _, tile_starts = sort_instances(slot_rank, slot_tile, fields[0].shape[0],
                                             grid_x * grid_y)
    return blend_sortfree_plain(gauss_s, tile_starts, fields, bg, grid_x, grid_y, tile_size)


def blend_fused(
    slot_rank: torch.Tensor,
    slot_tile: torch.Tensor,
    fields,
    bg: torch.Tensor,
    grid_x: int,
    grid_y: int,
    tile_size: int,
) -> blend_torch.BlendOutput:
    """(tile, depth) sort + forward blend, differentiable.

    ``fields`` is a sequence of (N,) f32 columns in DEPTH-SORTED Gaussian
    order: (mean_x, mean_y, conic_a, conic_b, conic_c, opacity, color_0, ...);
    ``slot_rank``/``slot_tile`` come from ``binning.expand_slots``.  CUDA
    tensors run the Hopper kernels (the backward one for the gradient);
    CPU tensors run ``ops/blend.py``.
    """
    fields = tuple(fields)
    gauss_s, _, tile_starts = sort_instances(slot_rank, slot_tile, fields[0].shape[0],
                                             grid_x * grid_y)
    return blend_sortfree(gauss_s, tile_starts, fields, bg, grid_x, grid_y, tile_size)


def blend_sortfree_plain(
    sorted_gauss: torch.Tensor,
    tile_starts: torch.Tensor,
    fields,
    bg: torch.Tensor,
    grid_x: int,
    grid_y: int,
    tile_size: int,
) -> blend_torch.BlendOutput:
    """:func:`blend_sortfree` through the plain version, on any device."""
    fields = tuple(fields)
    n = fields[0].shape[0]
    starts = tile_starts.long()
    live = int(starts[-1])
    tile_s = torch.repeat_interleave(
        torch.arange(grid_x * grid_y, device=starts.device), starts[1:] - starts[:-1]
    )
    return blend_torch.blend(
        torch.clamp_max(sorted_gauss[:live], max(n - 1, 0)),
        tile_s,
        tile_starts,
        torch.stack(fields[0:2], dim=-1),
        torch.stack(fields[2:5], dim=-1),
        fields[5],
        torch.stack(fields[6:], dim=-1),
        bg,
        grid_x,
        grid_y,
        tile_size,
    )


def blend_sortfree(
    sorted_gauss: torch.Tensor,
    tile_starts: torch.Tensor,
    fields,
    bg: torch.Tensor,
    grid_x: int,
    grid_y: int,
    tile_size: int,
) -> blend_torch.BlendOutput:
    """Forward blend of instances already in (tile, depth) order,
    differentiable.

    Counterpart of ``blend_pallas.py:blend_sortfree``: ``sorted_gauss`` and
    ``tile_starts`` come from ``binning.plan_instances`` (or, in
    :func:`blend_fused`, from the sort), ``fields`` as in :func:`blend_fused`.
    CUDA tensors run the two Hopper kernels; CPU tensors run
    ``ops/blend.py``."""
    fields = tuple(fields)
    device = fields[0].device
    if device.type == "cpu":
        return blend_sortfree_plain(sorted_gauss, tile_starts, fields, bg, grid_x, grid_y,
                                    tile_size)
    if device.type != "cuda":
        raise ValueError(f"blend_sortfree: no kernel for device {device}")
    table = torch.stack(fields, dim=-1).float().contiguous()
    tiles, final_t, n_contrib = _BlendForward.apply(
        table, bg.float().contiguous(), sorted_gauss.contiguous(),
        tile_starts.contiguous(), grid_x, tile_size,
    )
    return blend_torch.BlendOutput(tiles, final_t, n_contrib)
