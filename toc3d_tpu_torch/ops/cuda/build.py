"""Build and bind the port's CUDA kernels.

Each ``toc3d_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. Builds happen at first use (or all at once, in parallel, through
``build_all``) into ``<repo>/build/kernels/``, which ``.gitignore`` lists. A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded.

Every C entry point returns ``cudaGetLastError()``; ``call`` raises if it is
not 0. Nothing here is imported or built when a module of the package is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
HEADERS = ("common.cuh", "gemm.cuh", "gemm_sm90.cuh")
# -fvisibility=hidden: only the TOC3D_EXPORT entry points leave a library, so
# two libraries that instantiate the same launch template keep their own
# function-local statics (the once-per-kernel shared-memory attribute)
# instead of sharing one through the dynamic linker
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xcompiler",
              "-fvisibility=hidden", "-Xptxas", "-v", "-lineinfo")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library -> {C function: argtypes}; the last argument is always the stream
SIGNATURES = {
    "patch_embed": {
        "toc3d_patchify": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "toc3d_patch_im2col": [_P, _P, _I, _I, _I, _I, _P],
    },
    "vit_block": {
        "toc3d_layernorm": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P, _P,
                            _P, _I, _I, _I, _I, _F, _I, _P],
        "toc3d_rowquant": [_P, _I, _I, _I, _P, _P, _I, _P, _P],
        "toc3d_gemm": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                       _I, _P],
        "toc3d_gemm_s8": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I,
                          _I, _I, _I, _I, _I, _I, _P],
        "toc3d_gemm_s8_sm90": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P,
                               _I, _I, _I, _I, _I, _I, _P],
        "toc3d_gemm_qkv": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P,
                           _P, _I, _I, _I, _I, _I, _I, _P],
        "toc3d_gemm_s8_sm90_qkv": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I,
                                   _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _P],
        "toc3d_window_attention": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P],
        "toc3d_gather_merge": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P],
        "toc3d_scatter_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P],
    },
    "cross_attn": {
        "toc3d_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _P],
    },
    "int8_linear": {
        "toc3d_int8_linear": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P],
    },
    "auction": {
        "toc3d_auction": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "stamp": {
        "toc3d_stamp": [_P, _P, _I, _I, _P],
    },
}

# libraries that only a stage timer on the card loads (runtime/timer.py):
# built at its first use, never by build_all's default, so a run without a
# timer builds nothing for them
ON_USE = ("stamp",)

# entry points that return a count (>= 0) or -(CUDA error), not an error
# code; they launch nothing and take no stream (see ``occupancy``)
QUERIES = {
    "vit_block": {"toc3d_window_attention_occupancy": [_I, _I],
                  "toc3d_window_attention_slots": [_I]},
    "cross_attn": {"toc3d_flash_occupancy": [_I]},
}

_LIBS: dict = {}


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile the named libraries (default: all but ON_USE) that are not
    built yet, one nvcc per source, all started together. Returns {name:
    seconds} (0.0 for a library already built). Raises with nvcc's output
    if any build fails."""
    names = [n for n in SIGNATURES if n not in ON_USE] if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times = {n: 0.0 for n in names}
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        times[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in {**SIGNATURES[name], **QUERIES.get(name, {})}.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.toc3d_error_string.argtypes = [ctypes.c_int]
    lib.toc3d_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def call(name: str, fn: str, *args) -> None:
    """Call C entry point ``fn`` of library ``name``; raise on a CUDA
    error."""
    lib = load(name)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.toc3d_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")


def occupancy(name: str, fn: str, *args) -> int:
    """The count that query ``fn`` of library ``name`` reports for a
    kernel (resident blocks per SM; the window attention's ring slots);
    raises on a CUDA error."""
    lib = load(name)
    n = getattr(lib, fn)(*args)
    if n < 0:
        raise RuntimeError(f"{fn}: CUDA error {-n} "
                           f"({lib.toc3d_error_string(-n).decode()})")
    return n


def stream_of(t) -> int:
    """PyTorch's current stream on t's device, as the raw cudaStream_t the C
    entry points launch on (the internal getter: current_stream(device)
    builds a Stream object and costs a few microseconds a launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())
