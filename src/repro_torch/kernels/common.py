"""Device and kernel dispatch policy shared by every kernel of the port.

Three decisions live here, once:

  device      `resolve_device(None)` is CUDA.  With no CUDA device it
              raises and tells the caller to pass ``device="cpu"``: the
              port never drops to the CPU on its own.
  dispatch    a wrapper whose tensors lie on the CPU runs the kernel's
              plain PyTorch version; a wrapper whose tensors lie on a CUDA
              device launches the kernel or raises (`on_cuda`,
              `launch`).  There is no fallback from a failed build or
              launch to the plain version.
  build       CUDA sources under ``kernels/*/csrc`` are compiled with nvcc
              at first use into a shared library with a plain C interface,
              cached under ``build/repro_torch/`` at the repository root
              and keyed by a hash of the sources and flags, then loaded
              with ctypes (`load_library`, `build_all`).

`SMEM_BUDGET` is the shared memory one thread block may use on Hopper
(227 KB); the kernels' layout tables size against it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

#: dynamic shared memory one thread block may use on sm_90 (232,448 bytes)
SMEM_BUDGET = 227 * 1024
#: threads one thread block may hold
MAX_THREADS = 1024

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent
#: kernel name -> its CUDA sources (one nvcc invocation, one library each)
KERNEL_SOURCES: Dict[str, Sequence[Path]] = {
    name: (_PKG / name / "csrc" / f"{name}.cu",)
    for name in ("fused_superstep", "mj_spmm", "priority_pairs")
}
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"

_LIBS: Dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA.  A CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True when every tensor lies on a CUDA device
    (launch the kernel), False when every one lies on the CPU (run the
    plain version).  Mixed placements raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs on mixed devices: {sorted(kinds)}")


def threads(rows: int, vb: int) -> int:
    """Threads of one thread block of `rows` rows of Vb threads:
    warp-rounded."""
    return -(-rows * vb // 32) * 32


def checked(name: str, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` if it has `dtype`, is contiguous and 16-byte aligned (what a
    kernel reads through a raw pointer), else raise."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def launch(fn, device: torch.device, error_string, *args) -> None:
    """fn(*args, stream) on `device`'s current stream, entering the device
    only when it is not the current one; raise with `error_string(rc)`
    (the library's decoder of its return code) if the launch failed.
    The stream handle comes from `torch._C._cuda_getCurrentRawStream`
    (what torch's own generated kernels launch on), which skips building
    a `torch.cuda.Stream` per call."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           f"{error_string(rc).decode()}")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where `name`'s library lives: keyed by sources + flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in KERNEL_SOURCES[name]:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, KERNEL_SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish_build(name: str, job) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: Sequence[str] = ()) -> Dict[str, Path]:
    """Build every named kernel library (all by default), one nvcc per
    library, all started together.  Returns name -> library path."""
    names = list(names) or list(KERNEL_SOURCES)
    jobs = {n: _start_build(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use and cached."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers / shared memory / spills) of the
    current build of `name`, or "" before it is built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
