"""device_memory_peak_mib: the most device memory the run held at once,
from set-up through the window (the CUDA caching allocator's peak,
`torch.cuda.max_memory_allocated`, read by the harness once the window
has closed).  Nothing on a run without a card."""


def read(run):
    return run.memory_peak_bytes / 2**20 if run.memory_peak_bytes > 0 else None
