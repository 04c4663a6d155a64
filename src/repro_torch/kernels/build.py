"""Builds the port's CUDA kernels and loads them with ctypes.

The sources under ``src/repro_torch/csrc/`` have a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds.  At first CUDA use
``library()`` compiles every ``.cu`` file to an object — one ``nvcc`` per
source, all started together — links them into one shared library, and
loads it.  The build lands in ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and flags, so a
change to any source rebuilds and an unchanged tree reuses the library.

Nothing builds at import time: the CPU never needs the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# IEEE expf/tanhf/division (no --use_fast_math): keeps the kernels close
# to their plain PyTorch versions.  -Xptxas -v records registers, shared
# memory and spills in the build log.
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built on this machine")


def build() -> Path:
    """Compiles the kernels if the library for these sources is missing;
    returns its path.  Raises with nvcc's output when a source fails."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        log = out_dir / f"{src.stem}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)], stdout=f, stderr=subprocess.STDOUT)
        jobs.append((src, obj, log, proc))
    failed = []
    for src, _obj, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"--- {src.name}\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _, _ in jobs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    for _, obj, _, _ in jobs:
        obj.unlink()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def ptxas_usage(stem: str, log: Optional[Path] = None) -> Dict[str, Dict]:
    """Each kernel's registers, spill bytes, stack frame (local memory:
    arrays the compiler did not keep in registers) and static shared
    memory as ``-Xptxas -v`` printed them in the build log of ``csrc/<stem>.cu``
    (or in ``log``), by mangled name."""
    text = (log or build_dir() / f"{stem}.log").read_text()
    out: Dict[str, Dict] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"(\d+) bytes stack frame", line)
            cur["stack_frame"] = int(m.group(1)) if m else 0
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def set_pdl(on: bool) -> None:
    """Programmatic dependent launch on (the default) or off for every
    kernel launched with it (``launch_pdl`` in ``csrc/common.cuh``): to
    time a kernel both ways."""
    fn = library().repro_set_pdl
    fn.argtypes = [ctypes.c_int]
    fn.restype = None
    fn(int(on))


def check(err: int, name: str) -> None:
    """Raises if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def dtype_code(dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
