"""Build and load the port's CUDA kernels.

Each ``.cu`` source under ``csrc/`` has a plain C interface (``.cuh`` files
are headers the sources share).  It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under ``_build/`` (one
``nvcc`` per source, started together by ``start_all`` or ``build_all``)
and loaded with ``ctypes``.  A library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale one is never
loaded.  Nothing is built when this module is imported: the kernels'
wrappers ask for their library at their first launch on a CUDA tensor.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "start_all", "build_all", "library", "cuda_error"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
# library name -> (the thread waiting for its nvcc, {"rc", "seconds"}, log,
# the nvcc process)
_BUILDS = {}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# library name -> (source file, nvcc -D defines, {C function: (argtypes,
# restype)}).  Kernels K1 (fused_pic.cu, 3D) and K2 (fused_pic_2d.cu, 2D)
# are built once per (type, shape order), so the twelve builds run side by
# side.


def _fused_funcs(stem):
    return {
        # (const FusedPicArgs*, galerkin, int* wide_tiles, cudaStream_t)
        f"{stem}_launch": ([_P, _I, _P, _P], _I),
        # (mxu) -> resident blocks per SM
        f"{stem}_blocks_per_sm": ([_I], _I),
        f"{stem}_error_string": ([_I], ctypes.c_char_p),
    }


SOURCES = {
    f"{stem}_{tn}_o{order}": (
        f"{stem}.cu", (f"FP_REAL={ct}", f"FP_ORDER={order}"),
        _fused_funcs(stem))
    for stem in ("fused_pic", "fused_pic_2d")
    for tn, ct in (("f32", "float"), ("f64", "double"))
    for order in (1, 2, 3)
}
SOURCES["ragged_expand"] = ("ragged_expand.cu", (), {
    # (is_f64, src, cap_in, offsets, counts, fill, out,
    #  n_attr, n_tiles, p_max, stream)
    "ragged_expand_launch": ([_I, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _P],
                             _I),
    "ragged_expand_error_string": ([_I], ctypes.c_char_p),
})
# The Hopper labs (warpx_tpu_torch/tools/): one library each, every mode a
# runtime argument, so each holds one or two template instantiations.
SOURCES["slot_copy"] = ("slot_copy.cu", (), {
    # (psp, row_len, offsets, counts, out, n_rows, n_tiles, pmax, stream)
    "slot_copy_launch": ([_P, _LL, _P, _P, _P, _I, _I, _I, _P], _I),
    # (n_rows, pmax) -> resident blocks per SM
    "slot_copy_blocks_per_sm": ([_I, _I], _I),
    "slot_copy_error_string": ([_I], ctypes.c_char_p),
})
SOURCES["tile_dot"] = ("tile_dot.cu", (), {
    # (nn, a, b, out, scratch, batch, m, k, n, in_bf16, mode, reps, path,
    #  tr, tc, rm, kw, wb, kb, stream): layout NN where nn, else NT
    "tile_dot_launch": ([_I] + [_P] * 4 + [_I] * 14 + [_P], _I),
    # either layout: (m, n, mode, path, tr, tc, rm, kw, wb)
    "tile_dot_smem": ([_I] * 9, _LL),
    # resident blocks per SM, either layout: (m, n, in_bf16, mode, path,
    #  tr, tc, rm, kw, wb)
    "tile_dot_blocks_per_sm": ([_I] * 10, _I),
    "tile_dot_error_string": ([_I], ctypes.c_char_p),
})
SOURCES["lab_widelane"] = ("lab_widelane.cu", (), {
    # (const LabWidelaneArgs*, stream)
    "lab_widelane_launch": ([_P, _P], _I),
    "lab_widelane_blocks_per_sm": ([_I, _I], _I),  # (w, dep_f32)
    "lab_widelane_error_string": ([_I], ctypes.c_char_p),
})
SOURCES["lab_fused"] = ("lab_fused.cu", (), {
    # (const LabFusedArgs*, stream)
    "lab_fused_launch": ([_P, _P], _I),
    # the chunk; (w, kind, gather, deposit) -> shared memory, and resident
    # blocks per SM
    "lab_fused_chunk": ([], _I),
    "lab_fused_smem": ([_I] * 4, _I),
    "lab_fused_blocks_per_sm": ([_I] * 4, _I),
    "lab_fused_error_string": ([_I], ctypes.c_char_p),
})


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str):
    return (*NVCC_FLAGS, *(f"-D{d}" for d in SOURCES[name][1]))


def _lib_path(name: str) -> Path:
    # the source and every header beside it that it may include
    src = (_CSRC / SOURCES[name][0]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()
    return _BUILD / f"lib{name}-{digest[:12]}.so"


def _start(name: str, nice: int = 0):
    """Start nvcc for ``name`` unless its library exists or its build is
    under way; a thread waits for it, moves the library into place and
    records its seconds.  ``nice``: the compiler's priority increment."""
    out = _lib_path(name)
    if out.exists() or name in _BUILDS:
        return
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = _BUILD / f"{name}.log"
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
           str(_CSRC / SOURCES[name][0])]
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        # a session of its own, so that stop_all reaches nvcc's children
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                start_new_session=True)
    if nice:
        os.setpriority(os.PRIO_PROCESS, proc.pid, nice)
    done = {}

    def wait():
        done["rc"] = proc.wait()
        done["seconds"] = time.perf_counter() - t0
        if done["rc"] == 0:
            os.replace(tmp, out)

    thread = threading.Thread(target=wait, daemon=True)
    thread.start()
    _BUILDS[name] = (thread, done, log, proc)


def start_all(names=None, nice: int = 0) -> None:
    """Start compiling every library in ``names`` (default: all), one nvcc
    each, all at once, and return at once; ``build_all`` or a library's
    first use waits for them, and the builds still running when the
    process exits are stopped."""
    for nm in (SOURCES if names is None else names):
        _start(nm, nice)


@atexit.register
def stop_all() -> None:
    """Stop every nvcc still running, with the processes it started."""
    for _, _, _, proc in _BUILDS.values():
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass


def build_all(names=None) -> dict:
    """Compile every library in ``names`` (default: all) in parallel, or
    wait for the builds ``start_all`` began.  Returns {name: seconds from
    the start of its nvcc to its end} (0 for a library built before this
    process); raises with the compiler's output if one fails."""
    names = list(SOURCES if names is None else names)
    start_all(names)
    secs = {}
    failures = []
    for nm in names:
        if nm not in _BUILDS:
            secs[nm] = 0.0
            continue
        thread, done, log, _ = _BUILDS[nm]
        thread.join()
        secs[nm] = done["seconds"]
        if done["rc"] != 0:
            failures.append(f"{nm}: nvcc exit {done['rc']}\n"
                            f"{log.read_text()}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return secs


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` (register and
    shared-memory use from ``-Xptxas -v``), or "" if it was not built here."""
    log = _BUILD / f"{name}.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every C
    function's argtypes and restype declared."""
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, (argtypes, restype) in SOURCES[name][2].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def cuda_error(name: str, fn: str, code: int) -> str:
    """CUDA's description of error ``code`` from ``fn`` in library
    ``name`` (codes above 1000 carry the failing stage in their
    thousands)."""
    msg = getattr(library(name), fn)(code)
    return f"{code} ({msg.decode()})"
