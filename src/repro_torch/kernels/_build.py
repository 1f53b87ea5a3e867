"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` at the
first kernel launch. Nothing here runs at import time: the CPU path
never needs ``nvcc``.

The library goes to ``build/repro_torch/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the sources and flags,
so an unchanged tree reuses it and a changed one rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: atan2f/sinf/cosf stay the accurate ones, and the
# kernels spell out __fmul_rn/__fadd_rn wherever a product feeds a
# comparison, so nvcc cannot contract it into an FMA
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (all return cudaGetLastError())
SIGNATURES = {
    "fe_detect_launch": [_P, _I, _I, _P, _I, _F, _I, _I, _P, _P, _P, _P],
    "fc_describe_launch": [_P, _I, _I, _P, _I, _P, _P, _I, _P, _I, _F, _F,
                           _P, _P, _P],
    "mo_match_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                        _P],
    "cov_update_launch": [_P, _P, _P, _P, _I, _I, _P, _P],
    "cov_update_smem_bytes": [_I],
}

_LIB = None
BUILD_SECONDS = None      # wall time of the build this process ran, if any


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/csrc on a machine with the CUDA "
                       "toolkit")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link one .so; returns its
    path (a no-op when the hashed library already exists)."""
    global BUILD_SECONDS
    out_dir = build_dir()
    lib = out_dir / f"librepro_torch_{_digest()}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [cc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        errors = []
        for src, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            elif verbose:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / lib.name
        subprocess.run([cc, *ARCH, "-shared", "-o", str(tmp_lib), *objs],
                       check=True, capture_output=True, text=True)
        os.replace(tmp_lib, lib)          # atomic: readers never see a
        #                                   half-written library
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.cuda_error_string.argtypes = [_I]
        handle.cuda_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        msg = lib().cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({msg})")
