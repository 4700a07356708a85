"""Device (PyTorch/CUDA) runtime: device selection and per-stage transfer
accounting.

The device is CUDA unless the caller asks for the CPU.  On the CPU every
kernel wrapper runs its plain PyTorch twin (that is how the tests run);
on CUDA it launches the hand-written kernel or raises, and a device stage
that fails (out of device memory included) raises too: nothing moves to
the host on its own.
"""

from __future__ import annotations

import torch

from ..utils.spans import card_wait


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


# ---------------------------------------------------------------------------
# Per-stage transfer accounting: label -> {fetches, d2h_bytes, h2d_bytes}.
# h2d is counted by count_h2d() at each upload site, d2h by count_d2h() at
# each fetch; every fetch of the search path goes through fetch_numpy, which
# also times the host's wait.

transport: dict = {}


def _tacc(label: str) -> dict:
    return transport.setdefault(label, {"fetches": 0, "d2h_bytes": 0, "h2d_bytes": 0})


def count_h2d(label: str, *arrays) -> int:
    """Record host->device upload bytes (numpy arrays or tensors) for a
    stage label; returns bytes."""
    n = sum(int(a.nbytes) for a in arrays)
    _tacc(label)["h2d_bytes"] += n
    return n


def count_d2h(label: str, *arrays) -> int:
    """Record one device->host fetch for a stage label; returns bytes."""
    n = sum(int(a.nbytes) for a in arrays)
    acc = _tacc(label)
    acc["fetches"] += 1
    acc["d2h_bytes"] += n
    return n


def fetch_numpy(label: str, *ts) -> list:
    """Host numpy copies of tensors, counted as one fetch under `label` and
    timed as one wait on the card (utils.spans.card_wait).  Contiguous
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
    else:
        with card_wait(label):
            out = [t.cpu().numpy() for t in ts]
    count_d2h(label, *out)
    return out


def transport_summary() -> dict:
    """Snapshot of per-stage transport counters (plus process totals)."""
    tot = {"fetches": 0, "d2h_bytes": 0, "h2d_bytes": 0}
    out = {}
    for k, v in transport.items():
        out[k] = dict(v)
        for f in tot:
            tot[f] += v[f]
    out["TOTAL"] = tot
    return out
