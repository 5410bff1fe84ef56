"""Device policy: the port runs on the caller's device, the card by default.

There is no CPU fallback.  ``device=None`` means the first CUDA card, and
a CUDA device raises when there is no card; the CPU runs only when the
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device raises without a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return device
