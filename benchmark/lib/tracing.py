"""The traced run: spans around the calls into each layer, from the
benchmark's own files, and the reduction of a torch.profiler trace to
device intervals, kernel times and idle gaps.

The spans wrap the program's methods for the length of the window and
are taken off after it.  A wrapper whose target is missing raises: a
traced run never silently loses a layer.
"""

from __future__ import annotations

import functools
import importlib
from contextlib import contextmanager
from dataclasses import dataclass, field

# (module, attribute path, span name): the calls into each layer
SPANS = (
    ("lexicmap_tpu_torch.index.search", "IndexSearcher._mask_query", "bench.mask"),
    ("lexicmap_tpu_torch.parallel.engine", "match_phase", "bench.match"),
    ("lexicmap_tpu_torch.index.search", "IndexSearcher._collect_anchors", "bench.anchors"),
    ("lexicmap_tpu_torch.parallel.pseudo_device", "DevicePseudoAligner.run_batch", "bench.pseudo"),
    ("lexicmap_tpu_torch.parallel.engine", "DeviceSearchEngine.finish_batch", "bench.finish"),
)
WINDOW = "bench.window"
REQUEST = "bench.request"


def _owner(module: str, path: str):
    obj = importlib.import_module(module)
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    if not hasattr(obj, parts[-1]):
        raise AttributeError(f"span target {module}.{path} is missing")
    return obj, parts[-1]


@contextmanager
def layer_spans():
    """Wrap every SPANS target in torch.profiler.record_function."""
    import torch

    undo = []
    try:
        for module, path, name in SPANS:
            owner, attr = _owner(module, path)
            orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)

            def wrapped(*a, __orig=orig, __name=name, **kw):
                with torch.profiler.record_function(__name):
                    return __orig(*a, **kw)

            functools.update_wrapper(wrapped, orig)
            setattr(owner, attr, wrapped)
            undo.append((owner, attr, orig))
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


@dataclass
class Trace:
    window: tuple  # (start, end), us
    device: list = field(default_factory=list)  # [(name, start, end)] every op on the card, us
    host: list = field(default_factory=list)  # [(name, start, end, thread)] the benchmark's spans, us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self) -> list:
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> list:
        """The union of the device ops' intervals, clipped to the window."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device if e > w0 and s < w1)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """[(start, end)] of the window not covered by any device op."""
        w0, w1 = self.window
        gaps, cur = [], w0
        for s, e in self.busy_intervals():
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if w1 > cur:
            gaps.append((cur, w1))
        return gaps

    def host_activity(self, s: float, e: float) -> str:
        """What the client's thread (the window span's) was doing over
        [s, e]: the layer whose spans overlap it most, summed by name;
        else "request, between layers" inside a request; else "client"."""
        main = next((t for name, _, _, t in self.host if name == WINDOW), None)
        by_name: dict[str, float] = {}
        in_request = False
        for name, hs, he, t in self.host:
            ov = min(e, he) - max(s, hs)
            if ov <= 0 or t != main or name == WINDOW:
                continue
            if name == REQUEST:
                in_request = True
            else:
                by_name[name] = by_name.get(name, 0.0) + ov
        if by_name:
            return max(by_name, key=by_name.get).removeprefix("bench.")
        return "request, between layers" if in_request else "client"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        w0, w1 = self.window
        for name, s, e in self.device:
            if e > w0 and s < w1:
                by_name[name] = by_name.get(name, 0.0) + (min(e, w1) - max(s, w0)) / 1e6
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self.host_activity(s, e), (e - s) / 1e6] for s, e in gaps]}


def from_profiler(prof) -> Trace:
    """The window, the card's ops and the benchmark's spans of a finished
    torch.profiler.profile."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a record_function span shows on the device's timeline too, as a
            # user annotation: it is the host's, not an op that ran there
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                device.append((e.name, tr.start, tr.end))
        elif e.name.startswith("bench."):
            host.append((e.name, tr.start, tr.end, e.thread))
            if e.name == WINDOW:
                window = (tr.start, tr.end)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(window=window, device=device, host=host)
