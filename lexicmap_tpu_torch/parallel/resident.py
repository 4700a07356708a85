"""Device-resident genome store: phase-4 windows are read on the card from
geometry instead of being packed and uploaded per batch.

Twin of lexicmap_tpu/parallel/resident.py.  Every pseudo-alignment window
is a subsequence of the 2-bit genome store the index already owns, so the
card holds the packed store ONCE and the host hands it a few ints per
window.

Layout (the same as the JAX package's):
  - each genome-store batch's `seq2bit` byte blob (4 codes/byte, MSB-first
    per byte; index/store.py:pack_2bit) is NORMALIZED on the host to
    LSB-first 32-bit words (code i of a word at bits 2i, the layout of
    pseudo_device.pack_codes_2bit) via a 256-entry byte LUT, padded to a
    word boundary, and copied into one int32 tensor on the device.  The
    tensor is allocated once at its full size and filled one store batch at
    a time, so host memory holds one normalized batch, not the whole store
    again.
  - a window is addressed by its GLOBAL CODE INDEX
    base = (store_code_base[batch] + byte_offsets[gidx] * 4) + position;
    the host hands over (word_base = base >> 4, phase = base & 15, length,
    rc).
  - reverse-complement windows are addressed from their END:
    base = global_end - (16*words_out - 1), so the span occupies codes
    [0, length) after the in-block reversal, matching the host's
    `(3 - codes)[::-1]` window construction (index/search.py:_path_windows).

The window's extraction is fused into the probe kernel on the card; its
plain form, `extract_packed_plain` (the JAX package's `extract_packed`),
is in kernels/pseudo_align.py with the probe's plain twin.  The engine
builds a blob only for a store that fits the device budget (`store_bytes`
against device_search.default_budget, parallel/engine.py); an allocation
that fails all the same raises its out-of-memory error.

ref: lib-index-search.go:1997 (SubSeq3 target extraction); genome.go:1472
(2-bit packing).
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

# byte LUT: reverse the four 2-bit groups of a byte (MSB-first per byte ->
# LSB-first), so a little-endian u32 view has code i at bits 2i
_LUT = np.array(
    [
        ((b >> 6) & 3) | (((b >> 4) & 3) << 2) | (((b >> 2) & 3) << 4) | ((b & 3) << 6)
        for b in range(256)
    ],
    dtype=np.uint8,
)


def normalize_blob(seq2bit: np.ndarray) -> np.ndarray:
    """MSB-first-per-byte 2-bit blob -> LSB-first u32 words (host, once)."""
    nb = _LUT[np.asarray(seq2bit, dtype=np.uint8)]
    pad = (-nb.shape[0]) % 4
    if pad:
        nb = np.concatenate([nb, np.zeros(pad, dtype=np.uint8)])
    return nb.view("<u4")


def _store_words(genome_stores) -> list[int]:
    return [(int(np.asarray(s.seq2bit).shape[0]) + 3) // 4 for s in genome_stores]


def store_bytes(genome_stores) -> int:
    """Device bytes a DeviceGenomeBlob of these store batches takes."""
    return max(1, sum(_store_words(genome_stores))) * 4


class DeviceGenomeBlob:
    """All genome-store batches of an index, resident on the device as one
    normalized int32 word tensor, plus the host-side geometry arithmetic."""

    def __init__(self, genome_stores, device=None):
        self.device = resolve_device(device)
        n_words = _store_words(genome_stores)
        self.n_words = max(1, sum(n_words))
        self.hbm_bytes = self.n_words * 4
        # one allocation at full size (raises when the card cannot hold it),
        # then one store batch normalized and copied at a time
        self.words = torch.zeros(self.n_words, dtype=torch.int32, device=self.device)
        self.store_code_base = []  # per batch: global code index of byte 0
        off = 0
        for store, nw in zip(genome_stores, n_words):
            self.store_code_base.append(off * 16)
            if nw:
                norm = normalize_blob(np.asarray(store.seq2bit))
                self.words[off: off + nw].copy_(torch.from_numpy(norm.view(np.int32)))
            off += nw
        self._byte_offsets = [np.asarray(s.byte_offsets) for s in genome_stores]

    def code_base(self, batch: int, gidx: int) -> int:
        """Global code index of position 0 of a genome (host arithmetic)."""
        return self.store_code_base[batch] + int(self._byte_offsets[batch][gidx]) * 4

    def geometry(self, batch: int, gidx: int, t_begin: int, t_end: int,
                 rc: bool, words_out: int):
        """(word_base, phase, length) for the probe kernel and its plain twin
        kernel; t_begin/t_end are inclusive concatenated-genome positions
        (already clipped)."""
        gb = self.code_base(batch, gidx)
        length = t_end - t_begin + 1
        base = gb + t_end - (16 * words_out - 1) if rc else gb + t_begin
        return base >> 4, base & 15, length
