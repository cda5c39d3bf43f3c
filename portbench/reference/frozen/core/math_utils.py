# Frozen copy of visfly_tpu_torch/core/math_utils.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
"""Small math helpers shared by reward/observation code."""
from __future__ import annotations

import torch
from torch import Tensor


def safe_norm(x: Tensor, dim: int = -1, keepdim: bool = False) -> Tensor:
    """L2 norm with a zero (instead of NaN) gradient at x == 0.

    Forward values equal ``torch.linalg.vector_norm``; the ``where`` guard
    keeps the backward finite at exactly-zero inputs (spawn states with zero
    body rate), as ``visfly_tpu.core.math_utils.safe_norm`` does.
    """
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    is_zero = sq == 0
    safe = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(safe))


def full_fp32_matmul() -> None:
    """Keep float32 matrix products in full float32 on the card.

    TF32 keeps about three decimal digits, which rounds geometry (ray
    directions, thrust allocation); the TPU version needed
    ``Precision.HIGHEST`` for the same reason."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
