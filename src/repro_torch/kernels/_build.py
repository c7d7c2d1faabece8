"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into ``build/<name>-<hash>.so`` at the repository root (the hash is of the
source, the headers of ``csrc/`` and the flags, so an edited source or
header rebuilds), then loads with ``ctypes``. ``cim_adc_free_mma.cu`` and
``cim_matmul_mma.cu`` both include the tensor-core core ``cim_mma.cuh``
and build in parallel: ``build()`` starts one ``nvcc`` per missing
library, all at once, and waits for them. Nothing is built or loaded at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("cim_matmul", "cim_adc_free_mma", "cim_matmul_mma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PLL = ctypes.POINTER(ctypes.c_longlong)
# argtypes/restype of every exported C function, per library
_SIGNATURES = {
    "cim_matmul": {
        "cim_float_workspace": ([_I] * 5, _LL),
        "cim_matmul_launch": ([_P] * 7 + [_LL, _LL] + [_I] * 7 + [_P], _I),
        "cim_matmul_adc_free_launch": ([_P] * 6 + [_LL, _LL] + [_I] * 5
                                       + [_P], _I),
        "cim_conv_float_implicit_launch": ([_P] * 7 + [_LL] + [_I] * 19
                                           + [_P], _I),
        "cim_matmul_error_string": ([_I], ctypes.c_char_p),
    },
    "cim_adc_free_mma": {
        "cim_adc_free_mma_workspace": ([_I] * 5, _LL),
        "cim_matmul_adc_free_mma_launch": ([_P] * 6 + [_LL, _PLL, _LL]
                                           + [_I] * 6 + [_P], _I),
        "cim_conv_adc_free_implicit_launch": ([_P] * 6 + [_LL, _PLL]
                                              + [_I] * 17 + [_P], _I),
        "cim_adc_free_mma_error_string": ([_I], ctypes.c_char_p),
    },
    "cim_matmul_mma": {
        "cim_matmul_mma_workspace": ([_I] * 6, _LL),
        "cim_matmul_mma_terms_bytes": ([_LL] + [_I] * 4, _LL),
        "cim_matmul_mma_launch": ([_P] * 7 + [_LL, _PLL, _P, _LL, _LL]
                                  + [_I] * 8 + [_P], _I),
        "cim_matmul_experts_mma_launch": ([_P] * 8 + [_LL, _PLL, _LL]
                                          + [_I] * 9 + [_P], _I),
        "cim_conv_mma_implicit_launch": ([_P] * 7 + [_LL, _PLL] + [_I] * 19
                                         + [_P], _I),
        "cim_conv_mma_window_mode": ([_I] * 15, _I),
        "cim_matmul_mma_error_string": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's messages (registers, shared memory, spills) per built library
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, in parallel. Raises with nvcc's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, library_path(name))   # atomic: no half-built .so
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib
