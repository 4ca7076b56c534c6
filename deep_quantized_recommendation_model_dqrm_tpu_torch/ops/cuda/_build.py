"""Build the CUDA sources under the package's `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/torch_kernels/lib<name>_<hash>.so` (one
`nvcc` per source, all started together), keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once. The
libraries have a plain C interface: pointers and the stream travel as
`ctypes.c_void_p`, and each entry returns `cudaGetLastError()`.

Importing this module needs neither `nvcc` nor a card; the first kernel
launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source built by
# this process, for the record of the run that built it.
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every `csrc/*.cu` that has no current library, in parallel.
    Returns the seconds spent; raises with nvcc's output on a failure."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            out = _lib_path(src.stem)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src.stem, proc, tmp, out))
        failed = []
        for name, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built on first use, with
    `argtypes` set from `signatures` and every entry returning an int."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
