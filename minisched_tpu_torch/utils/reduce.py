"""Reductions that eager PyTorch runs slowly in their plain form.

``any_last_axis`` is ``x.any(dim=-1)`` for a bool tensor.  Over a short
innermost axis of many rows (the 8 port or image slots of every (pod,
node) pair) torch's reduce kernel reaches about a tenth of the card's
memory rate.  When the axis holds 8 contiguous bools, the row is read as
one int64 instead: a bool is stored as a 0 or 1 byte, so the int64 is
non-zero exactly when one of the 8 is true, and the reduce becomes one
elementwise compare.  The result is the same bit for bit.  Any other
layout is refused rather than reduced slowly.
"""

from __future__ import annotations

import torch


def any_last_axis(x: torch.Tensor) -> torch.Tensor:
    """``x.any(dim=-1)`` for a contiguous bool tensor ``x`` whose last
    axis holds 8 slots and starts on an 8-byte boundary."""
    if not (x.dtype == torch.bool and x.shape[-1] == 8 and x.is_contiguous()
            and x.storage_offset() % 8 == 0):
        raise ValueError(
            f"any_last_axis needs a contiguous, 8-byte-aligned bool tensor "
            f"with 8 slots last; got {x.dtype} {tuple(x.shape)} "
            f"(contiguous {x.is_contiguous()}, offset {x.storage_offset()})")
    return x.view(torch.int64).squeeze(-1) != 0
