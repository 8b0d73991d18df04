"""The port's one build route for its hand-written CUDA kernels.

Every kernel library is CUDA C++ for ``sm_90a`` with a plain C interface,
compiled by ``nvcc`` into a shared library at first use (never at import)
and loaded with ``ctypes``. ``LIBRARIES`` lists them all; ``build()``
starts one ``nvcc`` per library that is not built yet, all together, and
loads every library. Each ``.so`` lands in ``build/`` at the repository
root under a name keyed on its source, its headers and its flags, so an
edited file never reuses a stale library. Each kernel module keeps its own
``ctypes`` structures and sets its functions' ``argtypes`` on the loaded
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build"
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_SHARED = ("-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# the camera kernels round each operation on its own (no fused
# multiply-add), which keeps their HSV bins and sums bit-stable
HSV_FLAGS = _COMMON + ("-fmad=false",) + _SHARED
FLASH_FLAGS = _COMMON + _SHARED


@dataclass(frozen=True)
class Library:
    """One shared library: its source and headers (relative to
    ``kernels/``) and its ``nvcc`` flags."""
    source: str
    headers: Tuple[str, ...]
    flags: Tuple[str, ...]


LIBRARIES: Dict[str, Library] = {
    "ingest": Library("hsv_features/csrc/ingest.cu",
                      ("hsv_features/csrc/hsv_common.cuh",), HSV_FLAGS),
    "hist": Library("hsv_features/csrc/hist.cu",
                    ("hsv_features/csrc/hsv_common.cuh",), HSV_FLAGS),
    "flash": Library("flash_attention/csrc/flash.cu",
                     ("flash_attention/csrc/flash_mma.cuh",), FLASH_FLAGS),
}


class BUILD:
    """The loaded libraries, built once per process at first use, and the
    compiler's output for each (kept beside its ``.so``, so a library
    built by an earlier process still has its ``ptxas`` report)."""
    libs: Dict[str, ctypes.CDLL] = {}
    seconds: float = 0.0
    log: str = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str, root: Path = KERNELS) -> Path:
    """Where library ``name`` is built: keyed by a hash of its flags and
    of every file it compiles (under ``root``)."""
    lib = LIBRARIES[name]
    h = hashlib.sha256(" ".join(lib.flags).encode())
    for f in (lib.source, *lib.headers):
        h.update(Path(f).name.encode() + b"\0" + (root / f).read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _log_path(so: Path) -> Path:
    return so.with_suffix(".log")


def _read_log(so: Path) -> str:
    log = _log_path(so)
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Registers and spill bytes of every kernel in ``nvcc -Xptxas -v``
    output, keyed by the kernel's mangled name."""
    usage: Dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            usage[entry] = {}
        elif entry is None:
            continue
        elif m := _SPILL.search(line):
            usage[entry].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        elif m := _REGS.search(line):
            usage[entry]["registers"] = int(m.group(1))
    return usage


def build() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library: one ``nvcc`` per
    library, all started together. Each ``.so`` is written under a
    temporary name and moved into place, so concurrent builds never see a
    partial file. A failed build raises with the compiler's output."""
    if BUILD.libs:
        return BUILD.libs
    t0 = time.perf_counter()
    paths = {name: library_path(name) for name in LIBRARIES}
    procs = {}
    for name, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.so"
        lib = LIBRARIES[name]
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *lib.flags, "-o", str(tmp), str(KERNELS / lib.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {LIBRARIES[name].source}\n{out}")
        if proc.returncode != 0:
            failed.append(LIBRARIES[name].source)
        else:
            tmp.with_suffix(".log").write_text(out)
            os.replace(tmp.with_suffix(".log"), _log_path(paths[name]))
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    BUILD.log = "\n".join(f"== {LIBRARIES[name].source}\n{_read_log(so)}"
                          for name, so in paths.items())
    BUILD.libs = {name: ctypes.CDLL(str(so)) for name, so in paths.items()}
    BUILD.seconds = time.perf_counter() - t0
    return BUILD.libs


__all__ = ["BUILD", "BUILD_DIR", "LIBRARIES", "Library", "build",
           "library_path", "ptxas_usage"]
