"""Device LexicHash capture for the index BUILD side (`index --engine
device`).

The host build capture is a C++ trie co-descent (native capture_native,
mirroring lexichash MaskKnownDistinctPrefixes at lib-index-build.go:1026).
Here one call of the capture kernels (`kernels/capture.py`, B10) covers a
whole genome: the mask table stays on the device, each genome's codes and
exclusion bytes go up once, and the kmers, counts and sorted positions come
back in one copy.  There are no slabs, no output cap and no host combine:
the result is exact for any genome, a mask that wins at millions of
locations included.  Desert filling and the reversed-k-mer (suffix)
dispatch stay on the host, as in the reference build.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.capture import bucket_table, capture
from ..kernels.runtime import fetch_numpy
from . import resolve_device


class DeviceCaptureEngine:
    """Per-genome LexicHash capture on `device` (CUDA unless told "cpu",
    where the kernels' plain twin runs), bit-exact with the host trie
    co-descent."""

    @staticmethod
    def supported(mask_set) -> bool:
        """The kernels take a distinct prefix of p bases with 2p < 32 (the
        JAX engine's key width); a wider one is the host capture's."""
        return 2 * mask_set.distinct_prefix_len < 32

    def __init__(self, mask_set, device: str | torch.device | None = None):
        if not self.supported(mask_set):
            raise ValueError("distinct prefix beyond the device key width")
        self.ms = mask_set
        self.k = mask_set.k
        self.p = mask_set.distinct_prefix_len
        self.device = resolve_device(device)
        table = bucket_table(mask_set.masks, self.k, self.p)
        masks = mask_set.masks.view(np.int64)
        self.table = torch.from_numpy(table).to(self.device)
        self.masks = torch.from_numpy(masks).to(self.device)

    def capture(self, codes: np.ndarray, exclude: np.ndarray | None):
        """codes uint8 [L]; exclude bool [L-k+1] or None.
        Returns (kmers [m] u64, counts [m] i64, pos_flat u32 sorted per mask)
        exactly like native capture_native(check_shorter=False), or None for
        a genome shorter than k."""
        if codes.shape[0] < self.k:
            return None
        c = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)).to(self.device)
        e = None if exclude is None else torch.from_numpy(
            np.ascontiguousarray(exclude, dtype=bool)).to(self.device)
        kmers, counts, pos = fetch_numpy(
            "device capture", *capture(c, e, self.table, self.masks, self.k, self.p))
        return kmers.view(np.uint64), counts, pos.view(np.uint32)
