"""Build and load the CUDA kernels (the joins and flash attention).

Each kernel source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded with
``ctypes``.  All sources compile in parallel (one ``nvcc`` each, started
together) at first use, into ``build/repro_torch_ext/`` at the root of
the checkout; a library's file name carries a hash of its source, the
headers and the flags, so an edited kernel or header is never served
from a stale build.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"

#: kernel name -> its source file in ``csrc/``
SOURCES = {"join_count": "join_count.cu",
           "pair_semijoin": "pair_semijoin.cu",
           "dedup_rows": "dedup_rows.cu",
           "fused_join": "fused_join.cu",
           "semijoin": "semijoin.cu",
           "flash_attention": "flash_attention.cu"}

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
#: C entry point and argument types of each kernel (pointers and the
#: stream as void*, sizes as int, strides as long long); every entry
#: point returns the cudaError_t of its launches
SIGNATURES = {
    "join_count": ("rt_join_count", (_P, _I, _P, _I, _P, _P, _I, _P, _P)),
    "pair_semijoin": ("rt_pair_semijoin",
                      (_P, _L, _L, _P, _L, _L, _I, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P, _P, _P)),
    "dedup_rows": ("rt_dedup_rows", (_P, _P, _I, _I, _P, _I, _P, _P, _P)),
    "fused_join": ("rt_fused_join",
                   (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                    _L, _P, _P, _P, _P, _P)),
    "semijoin": ("rt_semijoin", (_P, _I, _P, _I, _P, _I, _P, _P)),
    "flash_attention": ("rt_flash_attention",
                        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                         _I, _I, _F, _I, _P)),
}

_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are "
                           "built from source and need the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source,
    every header in ``csrc/`` (a kernel may include any of them) and
    the full flag list."""
    h = hashlib.sha256()
    for f in [CSRC / SOURCES[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel whose library is missing, all ``nvcc``
    processes started together.  Returns the build seconds per kernel
    (0 for one already built); raises ``RuntimeError`` with the
    compiler's output if any build fails.  ``ptxas`` register and
    shared-memory reports land in ``<library>.log`` beside each
    library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    secs = {name: 0.0 for name in SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for the CUDA kernels:\n"
                           + "\n".join(failed))
    return secs


def kernel(name: str) -> ctypes._CFuncPtr:
    """The C entry point of kernel ``name``, building the libraries on
    first use."""
    fn = _LOADED.get(name)
    if fn is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        sym, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn
