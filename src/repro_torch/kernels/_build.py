"""Build and load the port's CUDA kernels.

Every ``kernels/<name>/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), with the shared headers of ``kernels/include`` on its include
path, into a shared library with a plain C interface under
``build/kernels/`` at the repository root, at first use, and loaded with
``ctypes``.  The library name carries a hash of the source, the headers
and the flags, so an edited source is rebuilt, never served stale.
Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict = {}


def sources() -> dict:
    """name -> .cu source path, for every kernel of the port."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels are built from source at first use")
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(sources()[name].read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns name -> the compiler's report (``-Xptxas=-v``: each
    kernel's registers and shared memory); raises if any build fails."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(reports[n] for n in failed))
    return reports


def function(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of kernel library ``name``, built if needed,
    with ``argtypes`` set and an int (``cudaError_t``) result."""
    key = (name, symbol)
    if key not in _libs:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[key] = fn
    return _libs[key]


def check(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_grad(what: str, *tensors):
    """Raises where autograd would need a gradient through kernel ``what``,
    which has no backward kernel: its output, filled through ctypes, would
    carry no ``grad_fn`` and silently give zero gradients below it.  Call
    on the CUDA path only; the plain versions on the CPU stay
    differentiable."""
    import torch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{what} has no backward kernel: call it under "
                           "torch.no_grad(), or on CPU tensors")
