"""Device (PyTorch/CUDA) stages of the search and the index build, and
their device selection.

The device is CUDA unless the caller asks for the CPU.  On the CPU every
kernel wrapper runs its plain PyTorch twin (that is how the tests run);
on CUDA it launches the hand-written kernel or raises, and a device stage
that fails (out of device memory included) raises too: nothing moves to
the host on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`cuda` unless `device` says `cpu`.  Raises when CUDA is asked for
    (explicitly or by default) and no CUDA device is present: the port never
    falls back to the CPU on its own."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lexicmap_tpu_torch: no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
