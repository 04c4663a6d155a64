"""Device resolution: the port runs on the card unless told otherwise."""
from __future__ import annotations

from typing import Optional, Union

import torch


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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
