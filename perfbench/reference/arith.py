"""The reference's matrix products, in IEEE float32 or in emulated TF32.

Every product of the reference (projection, covariances, SH, the SSIM
window, correlations, similarities) goes through an :class:`Arith`.  With
``tf32=False`` it is IEEE float32: the card's TF32 switches are turned off
around it.  With ``tf32=True`` the operands are first rounded to TF32's
10-bit mantissa (round to nearest even) and then multiplied in float32, which
is what a TF32 tensor core does; that is the benchmark's control, the
reference one precision step below what the configurations state.
Emulating the rounding makes the control the same on every card and every
library version, where a TF32 switch leaves the choice to the library.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits), still float32."""
    i = x.contiguous().view(torch.int32)
    rounding = ((i >> 13) & 1) + 0xFFF
    return ((i + rounding) & -8192).view(torch.float32)


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


class Arith:
    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """The operand as the product reads it; the rounding passes the
        gradient straight through, so a TF32 step differentiates too."""
        if not self.tf32:
            return x
        return x + (to_tf32(x.detach()) - x.detach())

    def mm(self, a, b):
        with ieee_fp32():
            return torch.matmul(self._in(a), self._in(b))

    def einsum(self, spec, *xs):
        with ieee_fp32():
            return torch.einsum(spec, *(self._in(x) for x in xs))

    def conv2d(self, x, w, **kw):
        with ieee_fp32():
            return F.conv2d(self._in(x), self._in(w), **kw)
