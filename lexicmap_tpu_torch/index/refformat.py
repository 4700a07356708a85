"""Reference LexicMap on-disk format (.lmi): readers, writers, converters.

Implements the reference's binary index format so existing LexicMap indexes
can be IMPORTED into this engine (`utils import-index`) and indexes built
here can be EXPORTED for the reference tool (`utils export-index`).

Format sources (all layouts re-implemented from the reference code):
- kv seed files: header/pair/varint-GB layout, kv-data.go:70-137,268-545;
  group-varint codec util/varint-GB.go:28-105; 7-byte seed positions
  kv-encoding.go:29-47
- genome store: genome.go:184-355 (records) and 381-470 (.idx)
- genomes.map.bin: lib-index-build.go:1967-2010; genomes.chunks.bin:
  lib-index-build.go:1784-1806; info.toml: lib-index-build.go:1912-1947

masks.bin belongs to the external lexichash module whose serialization is
not part of the reference tree; import reads it with a validated
tail-heuristic (header + m big-endian uint64 masks) and falls back to a
masks text file exported by `lexicmap utils masks`.
"""

from __future__ import annotations

import os
import struct

import numpy as np

KV_MAGIC = b".kv-data"
KV_IDX_MAGIC = b".kvindex"
GENOME_MAGIC = b".genomes"
GENOME_IDX_MAGIC = b".genomei"
MAIN_VERSION = 3
MINOR_VERSION = 4


# --------------------------------------------------------------------------
# group-varint (VARINT-GB) codec for uint64 pairs


def put_uint64s(v1: int, v2: int) -> tuple[int, bytes]:
    """(ref: util.PutUint64s, varint-GB.go:28-44)"""
    b1 = max((v1.bit_length() + 7) // 8, 1)
    b2 = max((v2.bit_length() + 7) // 8, 1)
    ctrl = ((b1 - 1) << 3) | (b2 - 1)
    return ctrl, v1.to_bytes(b1, "big") + v2.to_bytes(b2, "big")


def get_uint64s(ctrl: int, buf: bytes, off: int) -> tuple[int, int, int]:
    """(ref: util.Uint64s, varint-GB.go:84-105); returns (v1, v2, nbytes)."""
    b1 = ((ctrl >> 3) & 7) + 1
    b2 = (ctrl & 7) + 1
    v1 = int.from_bytes(buf[off : off + b1], "big")
    v2 = int.from_bytes(buf[off + b1 : off + b1 + b2], "big")
    return v1, v2, b1 + b2


# --------------------------------------------------------------------------
# kv seed files


def read_kv_chunk(path: str):
    """Parse one chunk_XXX.bin; returns (mask_offset, per-mask list of
    (kmers uint64 array, list of value-arrays))."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != KV_MAGIC:
        raise ValueError(f"not a kv-data file: {path}")
    main_ver, _minor, k, config1 = data[8], data[9], data[10], data[11]
    if main_ver != MAIN_VERSION:
        raise ValueError(f"kv main version mismatch: {main_ver}")
    use3 = bool(config1 & 1)
    vw = 7 if use3 else 8
    mask_offset, chunk_size = struct.unpack(">QQ", data[16:32])
    off = 32
    masks = []
    for _mi in range(chunk_size):
        (n_kmers,) = struct.unpack(">Q", data[off : off + 8])
        off += 8
        kmers = np.empty(n_kmers, dtype=np.uint64)
        values: list[np.ndarray] = []
        got = 0
        prev = 0
        while got < n_kmers:
            ctrl = data[off]
            off += 1
            last_pair = bool(ctrl & 128)
            has_kmer2 = not (ctrl & 64)
            v1, v2, nb = get_uint64s(ctrl & 63, data, off)
            off += nb
            k1 = prev + v1
            k2 = k1 + v2
            prev = k2
            ctrl2 = data[off]
            off += 1
            l1, l2, nb = get_uint64s(ctrl2, data, off)
            off += nb
            # values of kmer1
            vals1 = _read_vals(data, off, l1, vw)
            off += l1 * vw
            kmers[got] = k1
            values.append(vals1)
            got += 1
            if has_kmer2:
                vals2 = _read_vals(data, off, l2, vw)
                off += l2 * vw
                kmers[got] = k2
                values.append(vals2)
                got += 1
            if last_pair:
                break
        if got != n_kmers:
            raise ValueError(f"kv parse mismatch in {path}: {got} != {n_kmers}")
        masks.append((kmers, values))
    return int(mask_offset), masks


def _read_vals(data: bytes, off: int, n: int, vw: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    if vw == 8:
        return np.frombuffer(data, dtype=">u8", count=n, offset=off).astype(np.uint64)
    out = np.empty(n, dtype=np.uint64)
    for i in range(n):
        out[i] = int.from_bytes(data[off + i * 7 : off + (i + 1) * 7], "big")
    return out


def write_kv_chunk(path: str, mask_offset: int, per_mask, k: int,
                   mask_prefix: int, anchor_prefix: int, use3: bool = False):
    """Write one chunk_XXX.bin + .idx (ref: kv-data.go WriteKVData)."""
    vw = 7 if use3 else 8
    config1 = 1 if use3 else 0
    out = bytearray()
    out += KV_MAGIC
    out += bytes([MAIN_VERSION, MINOR_VERSION, k, config1, 0, 0, 0, 0])
    out += struct.pack(">QQ", mask_offset, len(per_mask))

    idx_out = bytearray()
    idx_out += KV_IDX_MAGIC
    idx_out += bytes([MAIN_VERSION, MINOR_VERSION, k, mask_prefix, anchor_prefix, config1, 0, 0])
    idx_out += struct.pack(">QQ", mask_offset, len(per_mask))

    shift = (k - mask_prefix - anchor_prefix) * 2
    amask = (1 << (anchor_prefix * 2)) - 1
    n_anchors = (1 << (anchor_prefix * 2))

    for kmers, values in per_mask:
        n_kmers = len(kmers)
        out += struct.pack(">Q", n_kmers)
        if n_kmers == 0:
            idx_out += struct.pack(">Q", 0)
            continue
        # anchor table: (kmer, offset<<1|is2nd) per anchor prefix
        p2o = [(0, 0)] * n_anchors
        p2o_set = [False] * n_anchors
        first_offset = len(out)

        prev = 0
        i = 0
        prefix_pre = -1
        while i < n_kmers:
            k1 = int(kmers[i])
            v1 = values[i]
            single = i == n_kmers - 1
            pos_here = len(out)
            # anchors
            pfx = (k1 >> shift) & amask
            if pfx != prefix_pre:
                if not p2o_set[pfx]:
                    p2o[pfx] = (k1, pos_here << 1)
                    p2o_set[pfx] = True
                prefix_pre = pfx
            if not single:
                k2 = int(kmers[i + 1])
                v2 = values[i + 1]
                pfx2 = (k2 >> shift) & amask
                if pfx2 != prefix_pre:
                    if not p2o_set[pfx2]:
                        p2o[pfx2] = (k2, pos_here << 1 | 1)
                        p2o_set[pfx2] = True
                    prefix_pre = pfx2
                ctrl, kb = put_uint64s(k1 - prev, k2 - k1)
                if i + 2 >= n_kmers:
                    ctrl |= 1 << 7
                out.append(ctrl)
                out += kb
                ctrl2, lb = put_uint64s(len(v1), len(v2))
                out.append(ctrl2)
                out += lb
                for v in v1:
                    out += int(v).to_bytes(vw, "big")
                for v in v2:
                    out += int(v).to_bytes(vw, "big")
                prev = k2
                i += 2
            else:
                ctrl, kb = put_uint64s(k1 - prev, 0)
                ctrl |= (1 << 7) | (1 << 6)
                out.append(ctrl)
                out += kb
                ctrl2, lb = put_uint64s(len(v1), 0)
                out.append(ctrl2)
                out += lb
                for v in v1:
                    out += int(v).to_bytes(vw, "big")
                i += 1

        # index record: SPARSE anchors (offset > 0 only), first pair is
        # (nRecords, offset of the first k-mer) (ref: kv-data.go:566-598)
        present = [(km, offv) for (km, offv) in p2o if offv > 0]
        n_records = len(present) + 1  # + the first special pair
        idx_out += struct.pack(">Q", n_records)
        idx_out += struct.pack(">QQ", n_records, first_offset << 1)
        for km, offv in present:
            idx_out += struct.pack(">QQ", km, offv)

    with open(path, "wb") as fh:
        fh.write(out)
    with open(path + ".idx", "wb") as fh:
        fh.write(idx_out)


# --------------------------------------------------------------------------
# genome store files


def read_genome_file(path: str):
    """Parse genomes.bin (+ .idx); yields per genome:
    (gid, packed2bit bytes, n_bases, genome_size, seq_sizes, seq_ids)."""
    with open(path + ".idx", "rb") as fh:
        idx_data = fh.read()
    if idx_data[:8] != GENOME_IDX_MAGIC:
        raise ValueError(f"not a genome index file: {path}.idx")
    batch, n_recs = struct.unpack(">II", idx_data[16:24])
    offsets = []
    for i in range(n_recs):
        o, b = struct.unpack(">QI", idx_data[24 + 12 * i : 24 + 12 * i + 12])
        offsets.append((o, b))

    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != GENOME_MAGIC:
        raise ValueError(f"not a genomes file: {path}")

    out = []
    for off, _bases in offsets:
        p = off
        (id_len,) = struct.unpack(">H", data[p : p + 2])
        p += 2
        gid = data[p : p + id_len]
        p += id_len
        genome_size, clen, n_seqs = struct.unpack(">III", data[p : p + 12])
        p += 12
        seq_sizes = []
        seq_ids = []
        for _ in range(n_seqs):
            (size,) = struct.unpack(">I", data[p : p + 4])
            p += 4
            (sl,) = struct.unpack(">H", data[p : p + 2])
            p += 2
            seq_ids.append(data[p : p + sl])
            p += sl
            seq_sizes.append(size)
        nbytes, nbases = struct.unpack(">II", data[p : p + 8])
        p += 8
        packed = data[p : p + nbytes]
        out.append((gid, packed, nbases, genome_size, seq_sizes, seq_ids))
    return batch, out


def write_genome_file(path: str, batch: int, genomes) -> None:
    """genomes: iterable of (gid, packed2bit, n_bases, genome_size,
    seq_sizes, seq_ids)."""
    out = bytearray()
    out += GENOME_MAGIC
    out += bytes([MAIN_VERSION, MINOR_VERSION, 0, 0, 0, 0, 0, 0])
    index = []
    for gid, packed, nbases, gsize, seq_sizes, seq_ids in genomes:
        index.append((len(out), nbases))
        out += struct.pack(">H", len(gid))
        out += gid
        out += struct.pack(">III", gsize, nbases, len(seq_sizes))
        for size, sid in zip(seq_sizes, seq_ids):
            out += struct.pack(">I", size)
            out += struct.pack(">H", len(sid))
            out += sid
        out += struct.pack(">II", len(packed), nbases)
        out += packed
    with open(path, "wb") as fh:
        fh.write(out)
    idx = bytearray()
    idx += GENOME_IDX_MAGIC
    idx += bytes([MAIN_VERSION, MINOR_VERSION, 0, 0, 0, 0, 0, 0])
    idx += struct.pack(">II", batch, len(index))
    for off, b in index:
        idx += struct.pack(">QI", off, b)
    with open(path + ".idx", "wb") as fh:
        fh.write(idx)


# --------------------------------------------------------------------------
# maps, chunks, info


def read_ref_genome_map(path: str):
    """(ref: readGenomeMapIdx2Name, lib-index-build.go:1967-2010)"""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    p = 0
    while p < len(data):
        (id_len,) = struct.unpack(">H", data[p : p + 2])
        p += 2
        gid = data[p : p + id_len]
        p += id_len
        (code,) = struct.unpack(">Q", data[p : p + 8])
        p += 8
        out.append((gid, int(code)))
    return out


def write_ref_genome_map(path: str, entries) -> None:
    with open(path, "wb") as fh:
        for gid, code in entries:
            fh.write(struct.pack(">H", len(gid)) + gid + struct.pack(">Q", code))


def read_ref_genome_chunks(path: str):
    """(ref: lib-index-build.go:1784-1806 writer)"""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        data = fh.read()
    out = []
    p = 0
    while p + 8 <= len(data):
        (n,) = struct.unpack(">Q", data[p : p + 8])
        p += 8
        lst = [struct.unpack(">Q", data[p + 8 * i : p + 8 * i + 8])[0] for i in range(n)]
        p += 8 * n
        out.append([int(x) for x in lst])
    return out


def read_ref_info(path: str) -> dict:
    import tomllib

    with open(path, "rb") as fh:
        return tomllib.load(fh)


def write_ref_info(path: str, info: dict) -> None:
    with open(path, "w") as fh:
        for key, val in info.items():
            if isinstance(val, bool):
                fh.write(f"{key} = {'true' if val else 'false'}\n")
            elif isinstance(val, str):
                fh.write(f"{key} = '{val}'\n")
            else:
                fh.write(f"{key} = {val}\n")


def read_ref_masks_bin(path: str, k: int, m: int) -> np.ndarray | None:
    """Tail-heuristic parse of lexichash masks.bin: the file is assumed to
    end with m big-endian uint64 masks.  Returns None when validation fails
    (use a masks TEXT file then)."""
    size = os.path.getsize(path)
    if size < 8 * m:
        return None
    with open(path, "rb") as fh:
        fh.seek(size - 8 * m)
        arr = np.frombuffer(fh.read(), dtype=">u8").astype(np.uint64)
    limit = np.uint64(1 << (2 * k)) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    if k < 32 and (arr >= limit).any():
        return None
    if np.unique(arr).shape[0] != m:
        return None
    # all p-prefixes must be covered (property of the generation scheme)
    p = 1
    while 1 << ((p + 1) * 2) <= m:
        p += 1
    prefs = np.unique(arr >> np.uint64(2 * (k - p)))
    if prefs.shape[0] != (1 << (2 * p)):
        return None
    return arr
