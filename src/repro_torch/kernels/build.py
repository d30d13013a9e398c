"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``.cu`` source with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``<repo>/build/kernels``
(listed in ``.gitignore``), in a directory named by a hash of the source,
every local header it includes (``#include "..."``, found beside the
source or in ``INCLUDE_DIRS``, such as ``kernels/csrc/hopper.cuh``) and
the flags: an edited source or header builds anew, an unchanged one is
loaded from the cache. The ``-Xptxas -v`` report (registers, shared memory
and spills of every kernel instance) is kept beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Iterable, NamedTuple, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "kernels"
#: where ``#include "..."`` finds the headers shared by several kernels
INCLUDE_DIRS = (Path(__file__).resolve().parent / "csrc",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


class Built(NamedTuple):
    path: Path          # the shared library
    seconds: float      # compile time of this build (0.0 when cached)
    ptxas_report: str   # nvcc's -Xptxas -v output


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def local_headers(source: Path,
                  include_dirs: Sequence[Path] = INCLUDE_DIRS) -> list:
    """Every header that ``source`` includes with quotes, directly or
    through another such header, each once, in the order first met. A
    header is looked up beside the file that includes it, then in
    ``include_dirs``, as nvcc does; one found in neither raises."""
    found, todo = [], [Path(source)]
    while todo:
        cur = todo.pop(0)
        for name in _LOCAL_INCLUDE.findall(cur.read_text()):
            for d in (cur.parent, *include_dirs):
                cand = (Path(d) / name).resolve()
                if cand.is_file():
                    break
            else:
                raise FileNotFoundError(f"{cur}: #include \"{name}\" not "
                                        f"found beside it or in "
                                        f"{list(map(str, include_dirs))}")
            if cand not in found:
                found.append(cand)
                todo.append(cand)
    return found


def source_digest(source: Path, flags: Iterable[str] = NVCC_FLAGS,
                  include_dirs: Sequence[Path] = INCLUDE_DIRS) -> str:
    """The build's cache key: a hash of the source, of each local header
    it includes (``local_headers``) and of the flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in local_headers(source, include_dirs):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(name: str, source: Path) -> Built:
    """Compile ``source`` into ``lib<name>.so`` unless an identical build
    exists. Concurrent builders each compile into a temp directory and
    install with an atomic rename, so no one loads a half-written file."""
    source = Path(source)
    digest = source_digest(source)
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    report = out_dir / "ptxas.txt"
    if lib.is_file():
        return Built(lib, 0.0, report.read_text() if report.is_file() else "")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{name}-", dir=BUILD_ROOT))
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS,
             *(f"-I{d}" for d in INCLUDE_DIRS), "-o", str(tmp / lib.name),
             str(source)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                               f"\n{proc.stderr}")
        (tmp / report.name).write_text(proc.stdout + proc.stderr)
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not lib.is_file():  # not a lost race with another builder
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Built(lib, seconds, report.read_text())


def load(name: str, source: Path) -> ctypes.CDLL:
    """Build if needed, then load with ``ctypes``."""
    return ctypes.CDLL(str(build(name, source).path))
