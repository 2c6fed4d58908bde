"""Device choice and the hash representation shared by the whole port.

**Device rule.** Every entry point takes ``device=None``, which means
``"cuda"``. Without a card the call raises unless the caller asked for the
host (``device="cpu"``, as the tests do); nothing carries on quietly on the
CPU.

**Hashes.** A 32-bit value hash is a ``torch.int64`` tensor holding the
uint32 value inside the port's torch code: torch's ``uint32`` lacks ``min``,
``+``, ``isin`` and ``searchsorted``, while in int64 every order and
sentinel compare is exact and ``a·v+b mod 2^32`` is a masked product. At the
package boundary hashes are uint32 numpy arrays (what ``repro`` and the
catalog use); a kernel receives them as an int32 bit-view.
"""
from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run on the host")
    return dev


def hashes_to_torch(a, device) -> torch.Tensor:
    """uint32 numpy (or any integer array) -> int64 tensor on ``device``."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)).to(device)


def hashes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor holding uint32 values -> uint32 numpy."""
    return t.cpu().numpy().astype(np.uint32)


def to_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 -> contiguous int32 with the same 32 bits (kernel
    input; a column slice of a numpy array arrives with Fortran strides)."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32).contiguous()


def from_bits(t: torch.Tensor) -> torch.Tensor:
    """int32 bit-view -> int64 holding the uint32 value (kernel output)."""
    return t.to(torch.int64) & U32_MASK
