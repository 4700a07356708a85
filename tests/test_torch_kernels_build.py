"""kernels/build.py names each library by a hash of its source, the local
headers the source includes and the flags, so that an edited header never
loads a stale library; kernels/runtime.py launches through the bound
library and raises its error.  Needs no nvcc: only the names are computed,
and the launch goes to a stand-in library."""

import ctypes
import shutil
from types import SimpleNamespace

import pytest
import torch

from lexicmap_tpu_torch.kernels import build, runtime


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


class _StandIn:
    """A bound library whose one kernel returns `err`."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def kern(self, *args):
        self.calls.append(args)
        return self.err

    def fake_error_string(self, err):
        return f"error {err}".encode()


@pytest.mark.parametrize("err", [0, 7])
def test_launch_passes_the_stream_and_raises_the_library_error(monkeypatch, err):
    """Library.launch: the kernel gets its arguments and then the device's
    current stream; a nonzero return raises "<fn> launch failed: <the
    library's error string>", whose signature Library binds with the rest."""
    lib, bound = _StandIn(err), {}

    def bind(name, signatures):
        bound[name] = signatures
        return lib

    monkeypatch.setattr(runtime, "bind", bind)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=99))
    fake = runtime.Library("fake", {"kern": ([ctypes.c_int], ctypes.c_int)})
    assert bound == {}  # nothing is built or bound before the first use
    if err:
        with pytest.raises(RuntimeError, match="^kern launch failed: error 7$"):
            fake.launch("kern", torch.device("cuda", 0), 5)
    else:
        fake.launch("kern", torch.device("cuda", 0), 5)
    assert lib.calls == [(5, 99)]
    assert bound["fake"] == {"kern": ([ctypes.c_int], ctypes.c_int),
                             "fake_error_string": ([ctypes.c_int], ctypes.c_char_p)}
