"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with
``device=None`` they take ``cuda`` and raise when no GPU is visible —
never a silent drop to the CPU, where the kernels' plain versions would
stand in for the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else
    ``cuda``; raises when ``cuda`` is asked for (or defaulted to) and no
    GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vearch_tpu_torch runs on a CUDA device by default and none is "
            "visible; pass device='cpu' to run on the CPU"
        )
    return dev
