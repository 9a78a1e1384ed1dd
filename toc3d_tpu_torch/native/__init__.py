"""Native (C++) host components of the port, built with g++ at first use and
bound with ctypes (the twin of toc3d_tpu/native/__init__.py).

liblap: rectangular linear sum assignment (lap.cpp, a verbatim copy of
toc3d_tpu/native/lap.cpp: ``solve_lap`` :18, ``solve_lap_batched`` :108),
the host matcher of the training losses (core/assigner.lsa_host) and of
the tracking metrics (tracking/metrics._hungarian): one C call for a whole
batch of problems.

The library is built into ``<repo>/build/native/`` (which ``.gitignore``
lists), its file name keyed by a hash of the source and the flags, as
ops/cuda/build.py keys the CUDA libraries. A build that fails raises with
the compiler's log; nothing falls back to scipy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "lap.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"liblap-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile lap.cpp into ``out``; raise with the compiler's output if it
    cannot."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                           capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {SRC.name}: {CXX} not found") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed for {SRC.name} (exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    tmp.replace(out)


def get_lap_lib() -> ctypes.CDLL:
    """The compiled LAP library, built at first use; raises if it cannot be
    built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.solve_lap.restype = ctypes.c_int
        lib.solve_lap.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.solve_lap_batched.restype = ctypes.c_int
        lib.solve_lap_batched.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
        return _LIB


def lap_batched(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """cost: (B, R, C) float32, rows = GTs (R <= C); n_valid: (B,) int, the
    rows used per item. Returns (B, R) int32, the column matched to each
    row (-1 for rows past n_valid). Raises when the solver reports an
    error (more rows than columns, or no finite augmenting path)."""
    lib = get_lap_lib()
    cost = np.ascontiguousarray(cost, np.float32)
    b, r, c = cost.shape
    nv = np.ascontiguousarray(n_valid, np.int32)
    out = np.empty((b, r), np.int32)
    rc = lib.solve_lap_batched(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, r, c,
        nv.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        raise RuntimeError(f"solve_lap_batched: error {rc} on a "
                           f"({b}, {r}, {c}) cost")
    return out
