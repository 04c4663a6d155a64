"""Device resolution: the port runs on the card unless told otherwise;
and the determinism settings of the train step."""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Union

import torch

# cuBLAS picks its reduction order by workspace: a fixed workspace keeps a
# GEMM's bits the same from call to call.  Read when cuBLAS first starts,
# so it is set before any CUDA work (``resolve_device``).
CUBLAS_WORKSPACE = ":4096:8"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card: returns ``cuda`` when one is present and
    raises when none is — the port never quietly takes the CPU.  Pass
    ``"cpu"`` to run the plain PyTorch versions of the kernels.

    On the card, float32 matmuls and convolutions are pinned to full
    float32 (no TF32), so float32 runs keep their stated tolerances."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        dev = torch.device("cuda")
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available")
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@contextlib.contextmanager
def deterministic_algorithms(device: torch.device):
    """On the card, PyTorch's deterministic implementations (the
    embedding and gather backward passes sort instead of adding with
    atomics; ops without one raise) for the duration of a train step: a
    recovered run must equal an uninterrupted one bit for bit.  The port's
    own kernels are deterministic by design.  The previous mode is
    restored on exit, so serving keeps PyTorch's defaults."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)
