"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` source becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use into
``blobstreamx_tpu_torch/build/`` and loaded with ``ctypes``. The library
name carries a hash of the sources, so an edited kernel is rebuilt.
``build_all()`` starts one ``nvcc`` per source at once and waits for all.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD = os.path.join(HERE, "build")

# kernel library -> its source; the shared header goes into every
# library's hash, so an edit to it rebuilds them all
SOURCES = {"ntt": "ntt.cu", "poseidon": "poseidon.cu", "sha256": "sha256.cu"}
_SHARED = ("goldilocks.cuh",)

_P = ctypes.c_void_p
_SIGNATURES = {
    "ntt": {
        # in, out, twiddles, batch, log_n, plan (host int32 triples),
        # passes, inverse, n_inv, stream
        "bsx_ntt": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_int,
                    ctypes.c_int, ctypes.c_uint64, _P],
    },
    "poseidon": {
        # full, first, scalars, cols, mds, init, rows: host u64 arrays
        # (ops/poseidon.py:kernel_constants)
        "bsx_poseidon_set_constants": [_P] * 7,
        # in, out, batch, row_stride, col_stride, stream
        "bsx_poseidon_permute": [_P, _P, ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_longlong, _P],
        # in, out, batch, n_in, row_stride, col_stride, stream
        "bsx_poseidon_hash_no_pad": [_P, _P, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_longlong, _P],
    },
    "sha256": {
        # msgs, out, batch, len, stream
        "bsx_sha256_fixed_len": [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P],
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + _SHARED:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD, f"libbsx_{name}_{h.hexdigest()[:12]}.so")


def _command(name: str, out: str) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", out, os.path.join(CSRC, SOURCES[name])]


def build_all(names=tuple(SOURCES)) -> dict:
    """Compile every missing library, one nvcc per source in parallel.
    Returns {name: seconds} (0 for a library that was already built);
    raises with the compiler's output if any build fails."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        log = open(f"{path}.log", "w")
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=log,
                                        stderr=subprocess.STDOUT), tmp, path, log)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, path, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, path)
    if failed:
        msgs = []
        for name in failed:
            with open(f"{_lib_path(name)}.log") as fh:
                msgs.append(f"--- {name} ---\n{fh.read()}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return seconds


def build_log(name: str) -> str:
    """What nvcc printed for a library (ptxas register and spill lines)."""
    path = f"{_lib_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


@functools.lru_cache(maxsize=None)
def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first when missing."""
    build_all((name,))
    handle = ctypes.CDLL(_lib_path(name))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(handle, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return handle


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {rc}")
