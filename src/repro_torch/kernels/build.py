"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and becomes
`build/kernels/lib<name>-<hash>.so` at the repository root, compiled for
Hopper only (`sm_90a`), with ptxas's report of registers, shared memory
and spills beside it (`.log`, `ptxas_report`).  The hash covers the
source, every header of `csrc/` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  Nothing is
compiled at import time: the first use of a kernel builds it, or
`build_all()` builds every source at once, one nvcc each, in parallel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("sign_pack", "topk_pack", "flash_attention",
           "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives, named by the hash of
    the source, the headers of `csrc/` and the flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc_build(src: Path, target: Path, defines: tuple = ()) -> None:
    """Compile `src` into the library `target` (into a temporary file
    renamed atomically, so a reader never sees half a library; ptxas's
    report is written beside it, before the rename).  `defines` are extra
    `-D` flags such as "NAME=VALUE"."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
                        "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{r.stdout}"
                           f"{r.stderr}")
    target.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, target)


def _compile(name: str) -> Path:
    """Path of the built library of `csrc/<name>.cu`, compiled first if
    missing."""
    target = _target(name)
    if not target.exists():
        _nvcc_build(CSRC / f"{name}.cu", target)
    return target


def library_of_file(src: Path, name: str,
                    defines: tuple = ()) -> ctypes.CDLL:
    """Another CUDA source (such as an earlier version of a kernel, for a
    comparison in one run, or a variant built with `defines`) built with
    the same flags into `build/kernels/lib<name>.so`, rebuilt on every
    call, and loaded; ptxas's report is `lib<name>.log` beside it."""
    target = BUILD_DIR / f"lib{name}.so"
    _nvcc_build(Path(src), target, defines)
    return ctypes.CDLL(str(target))


def ptxas_report(name: str) -> str:
    """nvcc's output for `csrc/<name>.cu` (ptxas -v: each kernel's
    registers, shared memory and spill stores and loads), building it
    first if needed."""
    return _compile(name).with_suffix(".log").read_text()


def build_all() -> None:
    """Compile every source not yet built, one nvcc each, all at once."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_compile, SOURCES))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(str(_compile(name)))
