"""Build the hand-written CUDA kernels at first use.

Each `csrc/<name>.cu` compiles with `nvcc` for sm_90a into a shared library
with a plain C interface, loaded with ctypes.  Libraries land in
`kernels/_build/` (listed in .gitignore), named by a hash of the source, the
local headers it includes (`#include "x.cuh"`, from `csrc/`) and the flags,
so an edited source or header never loads a stale library.  Every source
gets its own `nvcc`, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
_bound: set[str] = set()
_load_lock = threading.Lock()  # one build, load and binding per library, whatever the threads


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        src = fh.read()
    h = hashlib.sha1(src)
    for header in _LOCAL_INCLUDE.findall(src):
        with open(os.path.join(CSRC, header.decode()), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:16]}.so")


def build(names: list[str]) -> dict[str, str]:
    """Compile every `csrc/<name>.cu` whose library is missing, one nvcc
    each, all in parallel.  Returns name -> library path; raises with the
    compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = []
    for n, lib in paths.items():
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(build([name])[name])
    return lib


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """`load(name)` with its C signatures set once: `signatures` maps a
    function's name to (argtypes, restype)."""
    lib = load(name)
    if name not in _bound:
        with _load_lock:
            if name not in _bound:
                for fn, (args, res) in signatures.items():
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = res
                _bound.add(name)
    return lib
