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

`extract_packed_plain` is the plain PyTorch form of the JAX package's
`extract_packed`; on the card the extraction is fused into the probe kernel
(kernels/pseudo_align.py).  The engine builds a blob only for a store that
fits the device budget (`store_bytes` against device_search.default_budget,
parallel/engine.py); an allocation that fails all the same raises its
out-of-memory error.

ref: lib-index-search.go:1997 (SubSeq3 target extraction); genome.go:1472
(2-bit packing).
"""

from __future__ import annotations

import numpy as np
import torch

from . import count_h2d, resolve_device

# byte LUT: reverse the four 2-bit groups of a byte (MSB-first per byte ->
# LSB-first), so a little-endian u32 view has code i at bits 2i
_LUT = np.array(
    [
        ((b >> 6) & 3) | (((b >> 4) & 3) << 2) | (((b >> 2) & 3) << 4) | ((b & 3) << 6)
        for b in range(256)
    ],
    dtype=np.uint8,
)

_U32 = 0xFFFFFFFF


def normalize_blob(seq2bit: np.ndarray) -> np.ndarray:
    """MSB-first-per-byte 2-bit blob -> LSB-first u32 words (host, once)."""
    nb = _LUT[np.asarray(seq2bit, dtype=np.uint8)]
    pad = (-nb.shape[0]) % 4
    if pad:
        nb = np.concatenate([nb, np.zeros(pad, dtype=np.uint8)])
    return nb.view("<u4")


def _rev_pairs32(x):
    """Reverse the 16 2-bit groups of each 32-bit word (int64 holding u32)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _U32


def extract_packed_plain(blob, word_base, phase, length, rc, words_out: int):
    """[B] geometry -> [B, words_out] int32 (u32 bits) LSB-first packed codes.

    blob int32 [NW] (normalized words); word_base int64 [B]; phase, length
    int32 [B]; rc bool [B].  Codes at positions >= length are 0 (the
    pack_codes_2bit pad value).  Bit-identical to the JAX package's
    extract_packed."""
    dev = blob.device
    j = torch.arange(words_out + 1, device=dev)[None, :]
    wi = torch.clamp(word_base.to(torch.int64)[:, None] + j, 0, blob.shape[0] - 1)
    raw = blob[wi].to(torch.int64) & _U32  # [B, words_out+1]
    sh = (2 * phase.to(torch.int64))[:, None]
    hi = torch.where(sh > 0, (raw[:, 1:] << ((32 - sh) & 31)) & _U32, 0)
    a = (raw[:, :-1] >> sh) | hi  # [B, words_out], phase-aligned
    a_rc = (_rev_pairs32(a) ^ _U32).flip(1)
    a = torch.where(rc.to(torch.bool)[:, None], a_rc, a)
    jj = torch.arange(words_out, device=dev)[None, :]
    lw = (length.to(torch.int64) >> 4)[:, None]
    pmask = (1 << (2 * (length.to(torch.int64) & 15))[:, None]) - 1
    wmask = torch.where(jj < lw, _U32, torch.where(jj == lw, pmask, 0))
    a = a & wmask
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


def unpack_codes(packed):
    """[B, W] int32 (u32 bits) LSB-first packed -> [B, 16*W] int64 codes 0..3."""
    B, W = packed.shape
    shifts = 2 * torch.arange(16, device=packed.device)
    return ((packed.to(torch.int64)[:, :, None] >> shifts) & 3).reshape(B, 16 * W)


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
                count_h2d("resident genome blob", norm)
                self.words[off: off + nw].copy_(torch.from_numpy(norm.view(np.int32)))
            off += nw
        self._byte_offsets = [np.asarray(s.byte_offsets) for s in genome_stores]

    def code_base(self, batch: int, gidx: int) -> int:
        """Global code index of position 0 of a genome (host arithmetic)."""
        return self.store_code_base[batch] + int(self._byte_offsets[batch][gidx]) * 4

    def geometry(self, batch: int, gidx: int, t_begin: int, t_end: int,
                 rc: bool, words_out: int):
        """(word_base, phase, length) for extract_packed_plain and the probe
        kernel; t_begin/t_end are inclusive concatenated-genome positions
        (already clipped)."""
        gb = self.code_base(batch, gidx)
        length = t_end - t_begin + 1
        base = gb + t_end - (16 * words_out - 1) if rc else gb + t_begin
        return base >> 4, base & 15, length
