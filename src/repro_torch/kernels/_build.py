"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles every source for ``sm_90a`` in parallel (one process
per file) and links them into one shared library with a plain C
interface, which ``ctypes`` loads.  The library lives under ``build/``
beside this file, named by a digest of the flags and of every ``*.cu``
and ``*.cuh`` under ``csrc/`` (the sources and the Hopper primitives of
``hopper.cuh`` they include), so a changed file rebuilds and an
unchanged tree is reused.  Nothing here runs at import: this module is
imported on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention.cu", "decode_attention.cu", "grouped_ffn.cu",
           "ssd_scan.cu", "rmsnorm.cu", "fused_add_rmsnorm.cu",
           "flash_attention_bwd.cu", "rmsnorm_bwd.cu", "adamw.cu",
           "grouped_ffn_bwd.cu", "ssd_scan_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "repro_flash_attention_fwd": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         ctypes.POINTER(_LL), _I, _F, _P], _I),
    "repro_flash_attention_info": ([_I, _P, _P, _P], _I),
    "repro_flash_attention_bwd": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _I, _I, ctypes.POINTER(_LL), _I, _F, _I, _P], _I),
    "repro_flash_attention_bwd_info": ([_I, _I, _P, _P, _P], _I),
    "repro_rmsnorm_bwd": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _LL, _F, _I, _I, _I, _P],
        _I),
    "repro_fused_add_rmsnorm_bwd": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _LL, _LL, _F, _I, _I,
         _I, _P], _I),
    "repro_norm_bwd_info": ([_I, _I, _I, _P, _P, _P, _P, _P], _I),
    "repro_decode_attention_fwd": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.POINTER(_LL), _F, _P], _I),
    "repro_rmsnorm_fwd": (
        [_P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I, _F, _P], _I),
    "repro_fused_add_rmsnorm_fwd": (
        [_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _I,
         _I, _I, _F, _P], _I),
    "repro_fused_add_rmsnorm_info": (
        [_I, _I, _I, _I, _I, _I, _P, _P, _P], _I),
    "repro_grouped_ffn_fwd": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P], _I),
    "repro_grouped_ffn_info": ([_I, _P, _P, _P], _I),
    "repro_grouped_ffn_gate_bwd": ([_P, _P, _P, _P, _P, _P, _LL, _P], _I),
    "repro_grouped_ffn_gate_bwd_info": ([_P, _P, _P], _I),
    "repro_ssd_scan_fwd": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         ctypes.POINTER(_LL), _P, _P], _I),
    "repro_ssd_scan_info": ([_I, _P, _P, _P], _I),
    "repro_ssd_scan_bwd": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _I, _I, _I, _I, ctypes.POINTER(_LL), _P, _P], _I),
    "repro_ssd_scan_bwd_info": ([_I, _I, _P, _P, _P], _I),
    "repro_adamw": (
        [_P, ctypes.POINTER(_P), _I, _LL, _P, _P, _P, _P, _F, _F, _F, _F, _F,
         _F, _I, _P], _I),
    "repro_adamw_info": ([_P, _P, _P], _I),
    "repro_adamw_limits": ([_P, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_LIB = None
BUILD_LOG = ""     # nvcc/ptxas output of the last build (registers, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``csrc`` lives: named by a digest of
    the flags and of each ``*.cu`` / ``*.cuh`` file's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return build_dir / f"librepro_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (if their digest is new) and return the .so."""
    global BUILD_LOG
    srcs = [CSRC / s for s in SOURCES]
    lib = library_path(CSRC, BUILD_DIR)
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = [subprocess.Popen(
                     [nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                      str(tmp / (s.stem + ".o"))],
                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                     text=True) for s in srcs]
        logs = [p.communicate()[0] for p in procs]
        BUILD_LOG = "\n".join(logs)
        bad = [s.name for s, p in zip(srcs, procs) if p.returncode]
        if bad:
            raise RuntimeError(f"nvcc failed on {bad}:\n{BUILD_LOG}")
        out = tmp / lib.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *[str(tmp / (s.stem + ".o")) for s in srcs], "-o", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out, lib)        # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _LIB = lib
    return _LIB


def check(rc: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if rc:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def strides_arg(*strides) -> ctypes.Array:
    return (ctypes.c_longlong * len(strides))(*[int(s) for s in strides])


def kernel_info(fn, variant: int) -> dict:
    """Registers a thread, local (spill) bytes and dynamic shared memory a
    block of one compiled kernel, from ``repro_<kernel>_info``."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check(fn(variant, ctypes.byref(regs), ctypes.byref(local),
             ctypes.byref(smem)), fn.__name__)
    return {"registers": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}
