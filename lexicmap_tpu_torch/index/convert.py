"""Index conversion between this engine's columnar format and the reference
LexicMap binary format (.lmi).

- import_reference_index: point the engine at an existing LexicMap index.
  Masks come from masks.bin (validated tail parse) or a masks text file
  (`lexicmap utils masks -d ref.lmi -o masks.tsv`).  Because this engine
  keeps masks SORTED, postings are re-tagged through the old->sorted mask
  permutation during conversion.
- export_reference_index: write a reference-layout index from a native one.
  Every file matches the reference's documented binary format; masks.bin is
  written as header-less big-endian masks (the lexichash serialization is
  not public — the reference tool may need the accompanying masks.tsv).
"""

from __future__ import annotations

import os

import numpy as np

from ..masks import MaskSet
from .store import (
    DIR_GENOMES,
    DIR_SEEDS,
    FILE_GENOME_CHUNKS,
    FILE_GENOME_MAP,
    FILE_INFO,
    FILE_MASKS,
    GenomeStoreReader,
    GenomeStoreWriter,
    IndexInfo,
    SeedChunkReader,
    SeedChunkWriter,
    batch_dir,
    chunk_dir,
    pack_2bit,
    read_genome_chunks,
    read_genome_map,
    unpack_2bit,
    write_genome_chunks,
    write_genome_map,
)
from . import refformat as rf


def import_reference_index(src: str, dst: str, masks_text: str | None = None,
                           verbose: bool = False) -> None:
    info_t = rf.read_ref_info(os.path.join(src, "info.toml"))
    k = int(info_t["max-K"])
    m = int(info_t["masks"])
    n_batches = int(info_t["genome-batches"])

    # ---- masks + permutation old->sorted ----
    masks_arr = None
    if masks_text:
        ms_txt = MaskSet.load_text(masks_text)
        if ms_txt.m != m or ms_txt.k != k:
            raise ValueError("masks text file does not match info.toml")
        # text file preserves the reference's original mask ORDER (1-based
        # index column); reconstruct original order from the file directly
        masks_arr = _read_masks_text_ordered(masks_text, k, m)
    else:
        masks_arr = rf.read_ref_masks_bin(os.path.join(src, "masks.bin"), k, m)
        if masks_arr is None:
            raise ValueError(
                "could not parse masks.bin; export the masks as text with "
                "`lexicmap utils masks` and pass them via -M"
            )
    order = np.argsort(masks_arr, kind="stable")
    new_of_old = np.empty(m, dtype=np.int64)
    new_of_old[order] = np.arange(m)

    os.makedirs(dst, exist_ok=True)
    mask_set = MaskSet(masks_arr, k, int(info_t.get("rand-seed", 0)))
    mask_set.save(os.path.join(dst, FILE_MASKS))

    # ---- genomes ----
    genomes_dir = os.path.join(src, DIR_GENOMES)
    n_genome_files = 0
    for b in range(n_batches):
        path = os.path.join(genomes_dir, batch_dir(b), "genomes.bin")
        batch, recs = rf.read_genome_file(path)
        gw = GenomeStoreWriter(os.path.join(dst, DIR_GENOMES, batch_dir(b)), b)
        for gid, packed, nbases, gsize, seq_sizes, seq_ids in recs:
            codes = unpack_2bit(np.frombuffer(packed, dtype=np.uint8), 0, nbases)
            gw.write(gid, codes, seq_sizes, seq_ids)
            n_genome_files += 1
        gw.close()
        if verbose:
            print(f"  imported genome batch {b} ({len(recs)} genomes)")

    # ---- seeds ----
    seeds_dir = os.path.join(src, DIR_SEEDS)
    chunk_files = sorted(
        os.path.join(seeds_dir, f)
        for f in os.listdir(seeds_dir)
        if f.endswith(".bin") and not f.endswith(".idx")
    )
    n_chunks = len(chunk_files)
    all_masks = []
    all_kmers = []
    all_values = []
    all_orders = []
    seqno = 0
    for cf in chunk_files:
        mask_offset, per_mask = rf.read_kv_chunk(cf)
        for rel, (kmers, values) in enumerate(per_mask):
            old = mask_offset + rel
            new = int(new_of_old[old])
            for kmi, vals in zip(kmers, values):
                nv = vals.shape[0]
                all_masks.append(np.full(nv, new, dtype=np.int64))
                all_kmers.append(np.full(nv, kmi, dtype=np.uint64))
                all_values.append(vals)
                all_orders.append(np.arange(seqno, seqno + nv, dtype=np.int64))
                seqno += nv
        if verbose:
            print(f"  imported seed chunk {cf}")

    mask_ids = np.concatenate(all_masks) if all_masks else np.empty(0, np.int64)
    kmers = np.concatenate(all_kmers) if all_kmers else np.empty(0, np.uint64)
    values = np.concatenate(all_values) if all_values else np.empty(0, np.uint64)
    orders = np.concatenate(all_orders) if all_orders else np.empty(0, np.int64)

    chunk_size = (m + n_chunks - 1) // n_chunks
    os.makedirs(os.path.join(dst, DIR_SEEDS), exist_ok=True)
    for c in range(n_chunks):
        begin = c * chunk_size
        end = min(begin + chunk_size, m)
        sel = (mask_ids >= begin) & (mask_ids < end)
        w = SeedChunkWriter(os.path.join(dst, DIR_SEEDS, chunk_dir(c)), begin, end)
        w.write(mask_ids[sel], kmers[sel], values[sel], orders[sel])

    # ---- maps, chunks, info ----
    gmap = rf.read_ref_genome_map(os.path.join(src, "genomes.map.bin"))
    write_genome_map(os.path.join(dst, FILE_GENOME_MAP), gmap)
    gchunks = rf.read_ref_genome_chunks(os.path.join(src, "genomes.chunks.bin"))
    write_genome_chunks(os.path.join(dst, FILE_GENOME_CHUNKS), gchunks)

    info = IndexInfo(
        k=k,
        masks=m,
        rand_seed=int(info_t.get("rand-seed", 0)),
        max_desert=int(info_t.get("max-seed-dist", 100)),
        seed_dist_in_desert=int(info_t.get("seed-dist-in-desert", 50)),
        chunks=n_chunks,
        partitions=int(info_t.get("index-partitions", 4096)),
        input_genomes=int(info_t.get("input-genomes", 0)),
        input_bases=int(info_t.get("input-bases", 0)),
        genomes=int(info_t.get("genomes", n_genome_files)),
        genome_batch_size=int(info_t.get("genome-batch-size", 0)),
        genome_batches=n_batches,
        contig_interval=int(info_t.get("contig-interval", 1000)),
        soft_masking=bool(info_t.get("soft-masking", False)),
        max_kmer_freq=int(info_t.get("max-kmer-freq", 0)),
    )
    info.save(os.path.join(dst, FILE_INFO))


def _read_masks_text_ordered(path: str, k: int, m: int) -> np.ndarray:
    """Masks in the text file's ORIGINAL order (1-based index column)."""
    from ..utils.kmers import seq_to_codes

    arr = np.zeros(m, dtype=np.uint64)
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            idx = int(parts[0]) - 1
            code = 0
            for c in seq_to_codes(parts[-1].encode()):
                code = (code << 2) | int(c)
            arr[idx] = np.uint64(code)
    return arr


def export_reference_index(src: str, dst: str, verbose: bool = False) -> None:
    info = IndexInfo.load(os.path.join(src, FILE_INFO))
    mask_set = MaskSet.load(os.path.join(src, FILE_MASKS))
    k = mask_set.k
    m = mask_set.m
    os.makedirs(dst, exist_ok=True)

    # masks: text (authoritative) + header-less big-endian bin (best effort)
    mask_set.save_text(os.path.join(dst, "masks.tsv"))
    with open(os.path.join(dst, "masks.bin"), "wb") as fh:
        fh.write(mask_set.masks.astype(">u8").tobytes())

    # mask prefix / anchor prefix like the reference derives them
    # (ref: lib-index-build.go:246-264)
    mask_prefix = 1
    while 1 << ((mask_prefix + 1) * 2) <= m:
        mask_prefix += 1
    anchor_prefix = max((info.partitions.bit_length() - 1) // 2, 1)

    # seeds
    seeds_dir = os.path.join(src, DIR_SEEDS)
    os.makedirs(os.path.join(dst, DIR_SEEDS), exist_ok=True)
    for ci, name in enumerate(sorted(os.listdir(seeds_dir))):
        rdr = SeedChunkReader(os.path.join(seeds_dir, name), mmap=False)
        per_mask = []
        off = np.asarray(rdr.mask_offsets)
        eoff = np.asarray(rdr.entry_offsets)
        for mi in range(rdr.mask_end - rdr.mask_begin):
            e0, e1 = int(off[mi]), int(off[mi + 1])
            kmers = np.asarray(rdr.kmers[e0:e1])
            values = [np.asarray(rdr.values[eoff[e] : eoff[e + 1]]) for e in range(e0, e1)]
            per_mask.append((kmers, values))
        rf.write_kv_chunk(
            os.path.join(dst, DIR_SEEDS, f"chunk_{ci:03d}.bin"),
            rdr.mask_begin, per_mask, k, mask_prefix, anchor_prefix,
            use3=info.genome_batches <= 512,
        )
        if verbose:
            print(f"  exported seed chunk {ci}")

    # genomes
    for b in range(info.genome_batches):
        st = GenomeStoreReader(os.path.join(src, DIR_GENOMES, batch_dir(b)))
        recs = []
        for gi in range(len(st)):
            nbases = int(st.lens[gi])
            codes = st.subseq_codes(gi, 0, nbases - 1)
            packed = pack_2bit(codes).tobytes()
            recs.append(
                (st.ids[gi], packed, nbases, int(st.gsizes[gi]),
                 st.seq_sizes(gi), st.seq_ids[gi])
            )
        outdir = os.path.join(dst, DIR_GENOMES, batch_dir(b))
        os.makedirs(outdir, exist_ok=True)
        rf.write_genome_file(os.path.join(outdir, "genomes.bin"), b, recs)

    # maps, chunks, info.toml
    gmap = read_genome_map(os.path.join(src, FILE_GENOME_MAP))
    rf.write_ref_genome_map(os.path.join(dst, "genomes.map.bin"), gmap)
    gchunks = read_genome_chunks(os.path.join(src, FILE_GENOME_CHUNKS))
    with open(os.path.join(dst, "genomes.chunks.bin"), "wb") as fh:
        import struct

        for lst in gchunks:
            fh.write(struct.pack(">Q", len(lst)))
            for code in lst:
                fh.write(struct.pack(">Q", code))
    rf.write_ref_info(
        os.path.join(dst, "info.toml"),
        {
            "main-version": rf.MAIN_VERSION,
            "minor-version": rf.MINOR_VERSION,
            "max-K": k,
            "masks": m,
            "rand-seed": info.rand_seed,
            "max-seed-dist": info.max_desert,
            "seed-dist-in-desert": info.seed_dist_in_desert,
            "chunks": info.chunks,
            "index-partitions": info.partitions,
            "input-genomes": info.input_genomes,
            "input-bases": info.input_bases,
            "genomes": info.genomes,
            "genome-batch-size": info.genome_batch_size,
            "genome-batches": info.genome_batches,
            "contig-interval": info.contig_interval,
            "soft-masking": info.soft_masking,
            "max-kmer-freq": info.max_kmer_freq,
        },
    )
