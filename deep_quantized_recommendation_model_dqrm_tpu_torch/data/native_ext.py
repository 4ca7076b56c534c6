"""ctypes bindings for the native C++ Criteo parser (`native/criteo_preprocess.cpp`
at the repository root): TSV parsing and first-appearance categorical
dictionaries at C speed, replacing the reference's Cython-compiled
data_utils (cython/cython_compile.py:14-26).

Port of the JAX package's data/native_ext.py, with the same functions and
the same C ABI. The source is read, never written: it is compiled with
`g++ -O3 -shared -fPIC` into `build/native/libcriteo_preprocess_<hash>.so`,
keyed by a hash of the source and the flags, so a changed source rebuilds
and an unchanged one loads at once. Nothing under `native/` is written or
loaded (its committed `.so` was built on another host). Without a compiler
or the source, `available()` is false and the callers parse with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC = _REPO_ROOT / "native" / "criteo_preprocess.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return Path(BUILD_DIR) / f"libcriteo_preprocess_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: concurrent builders each publish whole files
        return True
    except Exception:
        if tmp.exists():
            tmp.unlink()
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SRC.exists():
            return None
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.criteo_parse_buffer.restype = ctypes.c_int64
        lib.criteo_parse_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                            i32p, i32p, i64p]
        lib.criteo_parse_file.restype = ctypes.c_int64
        lib.criteo_parse_file.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p, i64p]
        lib.criteo_dicts_new.restype = ctypes.c_void_p
        lib.criteo_dicts_new.argtypes = [ctypes.c_int32]
        lib.criteo_dicts_free.argtypes = [ctypes.c_void_p]
        lib.criteo_dicts_map.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int32, i32p]
        lib.criteo_dicts_size.restype = ctypes.c_int64
        lib.criteo_dicts_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.criteo_dicts_items.restype = ctypes.c_int64
        lib.criteo_dicts_items.argtypes = [ctypes.c_void_p, ctypes.c_int32, i64p, i32p, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    return lib


def _outputs(n: int):
    y = np.zeros(n, np.int32)
    xi = np.zeros((n, 13), np.int32)
    xc = np.zeros((n, 26), np.int64)
    ptrs = (y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            xi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            xc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return (y, xi, xc), ptrs


def parse_buffer(chunk: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a raw text chunk (complete lines) -> (y, X_int, raw X_cat).

    The streaming preprocessor's fast path: the chunk goes straight to the
    C parser, with no per-line Python objects."""
    lib = _require()
    n_max = chunk.count(b"\n")
    if not chunk.endswith(b"\n"):
        n_max += 1
    (y, xi, xc), ptrs = _outputs(n_max)
    got = lib.criteo_parse_buffer(chunk, len(chunk), n_max, *ptrs)
    return y[:got], xi[:got], xc[:got]


def parse_lines(lines: List[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse raw TSV lines -> (y[n] int32, X_int[n,13] int32, X_cat[n,26]
    int64 raw hex values)."""
    lib = _require()
    buf = b"".join(l if l.endswith(b"\n") else l + b"\n" for l in lines)
    n = len(lines)
    out, ptrs = _outputs(n)
    got = lib.criteo_parse_buffer(buf, len(buf), n, *ptrs)
    assert got == n, f"parsed {got} of {n} lines"
    return out


def parse_file(path: str, max_rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse up to max_rows of a raw Criteo file at C speed."""
    lib = _require()
    (y, xi, xc), ptrs = _outputs(max_rows)
    got = lib.criteo_parse_file(path.encode(), max_rows, *ptrs)
    if got < 0:
        raise IOError(f"native parser failed to read {path}")
    return y[:got], xi[:got], xc[:got]


class NativeCatDicts:
    """C++ first-appearance categorical dictionaries (int64 raw -> int32 id):
    open-addressing hash maps in place of the per-row Python dict build,
    the reference's Terabyte preprocessing bottleneck (data_utils.py:967-1080)."""

    def __init__(self, ncols: int):
        self._lib = _require()
        self.ncols = ncols
        self._h = self._lib.criteo_dicts_new(ncols)

    def map(self, raw: np.ndarray) -> np.ndarray:
        """raw [n, ncols] int64 -> ids [n, ncols] int32 (inserting new keys)."""
        raw = np.ascontiguousarray(raw, np.int64)
        n = raw.shape[0]
        out = np.empty((n, self.ncols), np.int32)
        self._lib.criteo_dicts_map(self._h, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                                   self.ncols, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def sizes(self) -> np.ndarray:
        return np.array([self._lib.criteo_dicts_size(self._h, j) for j in range(self.ncols)], np.int64)

    def items(self, col: int):
        n = int(self._lib.criteo_dicts_size(self._h, col))
        keys = np.empty(n, np.int64)
        ids = np.empty(n, np.int32)
        got = self._lib.criteo_dicts_items(self._h, col, keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                           ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
        return keys[:got], ids[:got]

    def __del__(self):
        try:
            self._lib.criteo_dicts_free(self._h)
        except Exception:
            pass
