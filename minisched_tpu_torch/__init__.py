"""tpu-minisched's device half in PyTorch, with hand-written Hopper kernels.

The JAX package ``minisched_tpu`` is the reference; this package mirrors
its module names (``models/tables.py``, ``ops/fused.py``, ``ops/state.py``,
``plugins/*``) so each function has an obvious counterpart.  It imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of
``minisched_tpu``: what it needs from the host side is copied here.

Routing is decided by the tensor's device, never by a global flag: a
CUDA tensor goes to the hand-written kernel (``ops/kernels.py``,
``csrc/*.cu``) or the call raises; a CPU tensor takes the kernel's plain
PyTorch twin.  Entry points take ``device=None``, which means the card.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises ``RuntimeError`` when no card is present and the caller did not
    ask for the CPU explicitly — an entry point never carries on quietly
    on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch twins on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
