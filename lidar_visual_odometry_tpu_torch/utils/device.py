"""Device selection for the port's entry points.

The caller chooses the device; the default is ``"cuda"``. Asking for CUDA on a
machine without a usable card raises ``RuntimeError``: nothing falls back to
the CPU on its own. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate ``device`` and fix full-float32 geometry.

    TF32 keeps about three decimal digits; lidar coordinates at 100 m need
    float32's full mantissa, so matrix products and convolutions are held to
    full float32 (the GPU form of the JAX package's ``Precision.HIGHEST``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
