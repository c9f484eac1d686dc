"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds.  The build runs at first use, from the
checkout's sources only, into ``build/repro_torch_kernels/`` at the
repository root; one ``nvcc`` per source, all started together.  A
library is named by the hash of its source, the shared headers beside
it (``csrc/*.cuh``, included by relative path) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin); the CUDA kernels need "
                       "the CUDA toolkit to build")


def _target(src: Path) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's hash
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every missing library in parallel; return name -> path.

    The compiler's report (registers, shared memory and spills from
    ``-Xptxas -v``) goes to ``<name>.log`` beside each library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    todo = {n: st for n, st in targets.items() if not st[1].exists()}
    procs = {}
    if todo:
        nvcc = _nvcc()
        for name, (src, out) in todo.items():
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            log = open(BUILD_DIR / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {n: out for n, (_, out) in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        if name not in paths:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        lib = _LIBS[name] = ctypes.CDLL(str(paths[name]))
    return lib


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would record through a kernel that has no
    backward: its output would carry no gradient, silently."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward yet (training "
            f"through it comes with a later slice of the port); call it "
            f"under torch.no_grad() or on inputs that do not require grad")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
