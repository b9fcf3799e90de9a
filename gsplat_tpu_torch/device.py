"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default. Asking for CUDA where
``torch.cuda.is_available()`` is false raises: the port never carries on
on the CPU unless the caller passes ``device="cpu"`` (as the tests do).

On the first CUDA request this also turns TF32 off for matrix products
and cuDNN convolutions, so every float32 product the port leaves to a
library runs in full float32 (the JAX package passes
``precision="highest"`` for the same reason).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
