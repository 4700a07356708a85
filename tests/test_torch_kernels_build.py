"""kernels/build.py names each library by a hash of its source, the local
headers the source includes and the flags, so that an edited header never
loads a stale library.  Needs no nvcc: only the names are computed."""

import shutil

import pytest

from lexicmap_tpu_torch.kernels import build


@pytest.mark.parametrize("name, includes", [("seed_locate", True), ("seed_match", True),
                                            ("pseudo_align", False), ("capture", False),
                                            ("seed_compact", False)])
def test_library_name_follows_the_shared_header(tmp_path, monkeypatch, name, includes):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = build._lib_path(name)
    with open(csrc / "seed_search.cuh", "a") as fh:
        fh.write("// edited\n")
    assert (build._lib_path(name) != before) == includes
    with open(csrc / f"{name}.cu", "a") as fh:
        fh.write("// edited\n")
    assert build._lib_path(name) != before
