"""The kernel wrappers' one way to the card.

`Library` is one `csrc/<name>.cu`: built, loaded and its C signatures bound
at its first use (`build.bind`, one cache whatever the threads), and each
launch made with the tensors' device current, on its current stream,
raising `RuntimeError("<fn> launch failed: <the library's error string>")`
on a nonzero return.  `require` and `cuda_ptrs` check tensors before their
pointers go to native code.  `fetch_numpy` brings kernel outputs back to
the host as one wait on the card.

Every library exports `<name>_error_string(int) -> const char *`.  On the
CPU no library is loaded: the wrappers run their plain twins.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.spans import card_wait
from .build import bind


class Library:
    """`csrc/<name>.cu` with `signatures` (a function's name -> (argtypes,
    restype)); nothing is built until `lib()` or `launch` is called."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self._error = f"{name}_error_string"
        self._signatures = {**signatures, self._error: ([ctypes.c_int], ctypes.c_char_p)}

    def lib(self) -> ctypes.CDLL:
        """The bound library, built on first use."""
        return bind(self.name, self._signatures)

    def launch(self, fn: str, dev: torch.device, *args):
        """lib.<fn>(*args, stream) with `dev` current (switching devices
        only if it is not), `stream` its current stream; raises on the
        kernel's error."""
        lib = self.lib()
        call = getattr(lib, fn)
        if dev.index == torch.cuda.current_device():
            err = call(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(dev):
                err = call(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{fn} launch failed: {getattr(lib, self._error)(err).decode()}")


def require(name, t, dtype, dev, shape=None):
    """Raises unless `t` is a contiguous `dtype` tensor on `dev` (of
    `shape`, where given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_ptrs(**tensors):
    """The kernels' pointer arguments, in the order given; raises unless
    every tensor is contiguous on a CUDA device (the caller has checked that
    they share one)."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return [t.data_ptr() for t in tensors.values()]


def fetch_numpy(label: str, *ts) -> list:
    """Host numpy copies of tensors, timed as one wait on the card
    (utils.spans.card_wait, `label` the transfer's stage).  Contiguous
    views of one buffer (the kernel wrappers' outputs on the card) come back
    in a single copy of that buffer."""
    st = ts[0].untyped_storage()
    if len(ts) > 1 and all(t.is_contiguous() and t.untyped_storage().data_ptr() == st.data_ptr()
                           for t in ts):
        with card_wait(label):
            raw = torch.empty(0, dtype=torch.uint8, device=ts[0].device).set_(
                st, 0, (st.nbytes(),)).cpu().numpy()
        out = []
        for t in ts:
            at = t.storage_offset() * t.element_size()
            part = raw[at: at + t.numel() * t.element_size()]
            out.append(part.view(torch.empty(0, dtype=t.dtype).numpy().dtype).reshape(t.shape))
        return out
    with card_wait(label):
        return [t.cpu().numpy() for t in ts]
