"""IEEE fp32 matrix products on the card, whatever the caller's settings."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32_matmul():
    """Turn TF32 off for fp32 matrix products inside the block (autograd's
    products too, when the backward runs inside it) and restore the caller's
    setting after it."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
