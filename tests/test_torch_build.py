"""The port's index build (its own copy of the host build code) writes the
same bytes as the JAX package's, file by file.  No field is exempt: the
index names neither package."""

import pytest

from torch_parity import tree_bytes, write_genomes

from lexicmap_tpu.index.build import BuildOptions as JaxBuildOptions
from lexicmap_tpu.index.build import build_index as jax_build_index
from lexicmap_tpu_torch.index.build import BuildOptions, build_index


ONE_BATCH = {"n_masks": 512, "chunks": 2}
MERGED = {"n_masks": 256, "chunks": 3, "batch_size": 2, "save_seed_pos": True}


@pytest.mark.parametrize("opts, engine", [
    (ONE_BATCH, "host"), (MERGED, "host"), (ONE_BATCH, "device"), (MERGED, "device"),
], ids=["one_batch", "merged_batches_seed_pos", "one_batch_device",
        "merged_batches_seed_pos_device"])
def test_port_build_is_byte_identical(tmp_path, monkeypatch, opts, engine):
    """engine="device": the port's capture kernels' plain twin on the CPU
    (device="cpu"), held against the JAX host build and the JAX device build
    (its capture over small slabs, for a short CPU compile)."""
    files, _ = write_genomes(tmp_path, n=3, length=30000, seed=21)
    a, b = str(tmp_path / "jax.lmt"), str(tmp_path / "port.lmt")
    jax_build_index(a, files, JaxBuildOptions(k=31, verbose=False, **opts))
    port = {"engine": "device", "device": "cpu"} if engine == "device" else {}
    build_index(b, files, BuildOptions(k=31, verbose=False, **opts, **port))
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert sorted(ta) == sorted(tb)
    assert len(ta) > 5
    for name in ta:
        assert ta[name] == tb[name], name
    if engine == "device":
        from lexicmap_tpu.parallel import build_device as JBD

        monkeypatch.setattr(JBD, "SLAB", 1 << 15)
        c = str(tmp_path / "jax_device.lmt")
        jax_build_index(c, files, JaxBuildOptions(k=31, verbose=False, engine="device", **opts))
        assert tree_bytes(c) == tb


def test_capture_error_propagates_out_of_build(tmp_path, monkeypatch):
    """Only a mask set beyond the key width (and a genome shorter than k)
    sends a genome to the host capture: a ValueError raised inside the
    device capture call propagates out of build_index."""
    from lexicmap_tpu_torch.parallel import build_device as BD

    def fail(self, codes, exclude):
        raise ValueError("raised by the capture kernel's wrapper")

    monkeypatch.setattr(BD.DeviceCaptureEngine, "capture", fail)
    files, _ = write_genomes(tmp_path, n=1, length=5000, seed=3)
    with pytest.raises(ValueError, match="capture kernel"):
        build_index(str(tmp_path / "x.lmt"), files,
                    BuildOptions(k=31, n_masks=64, engine="device", device="cpu", verbose=False))


def test_device_build_without_a_card_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    files, _ = write_genomes(tmp_path, n=1, length=5000, seed=3)
    out = tmp_path / "x.lmt"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index(str(out), files, BuildOptions(k=31, n_masks=64, engine="device",
                                                  verbose=False))
    assert not out.exists()
