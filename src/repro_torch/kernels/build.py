"""Build the CUDA kernels from the repository's sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with one
``nvcc -shared`` for ``sm_90a`` into ``build/kernels/`` at the repository
root, then loaded with ``ctypes``.  The library's file name carries a hash
of its source, so an edited source is rebuilt and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
_PACKAGE = Path(__file__).resolve().parents[1]
_ROOT = _PACKAGE.parents[1]           # the checkout holding src/repro_torch
SOURCES = ("ring_decode", "mla_ring_decode", "bgmv", "lora_matmul",
           "flash_attention", "adapter_gram", "wkv6")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
ARGTYPES = {
    "ring_decode_launch": [_P, _I, _L, _L, _L, _P, _P, _I, _L, _L, _L,
                           _P, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mla_ring_decode_launch": [_P, _L, _L, _L, _P, _L, _L, _P, _L, _L, _I,
                               _P, _P, _L, _L, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                               _P],
    "mla_ring_decode_max_clusters": [_I, _P],
    "bgmv_launch": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P],
    "lora_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _P],
    "adapter_gram_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "wkv6_launch": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout.  The kernels build
    only from a source checkout: a package imported from anywhere else
    (an installed copy) raises rather than write beside it."""
    if _ROOT / "src" / "repro_torch" != _PACKAGE:
        raise RuntimeError(f"repro_torch is imported from {_PACKAGE}, not from "
                           "a checkout's src/repro_torch: the CUDA kernels "
                           "build only in a source checkout")
    return _ROOT / "build" / "kernels"


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, build_dir() / f"lib{name}-{digest}.so"


def build_all(names: Tuple[str, ...] = SOURCES) -> Dict[str, str]:
    """Compile every source of ``names`` that has no up-to-date library,
    one ``nvcc`` process per source, all started together.  Returns the compiler's
    output per source built (``-Xptxas -v``: registers, shared memory,
    spills); raises with that output if a build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed)."""
    if name not in _LIBS:
        _, lib_path = _target(name)
        if not lib_path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(lib_path))
        for sym, argtypes in ARGTYPES.items():
            if sym.startswith(f"{name}_"):
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]
