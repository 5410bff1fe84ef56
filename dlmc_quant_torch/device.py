"""Device policy: the port runs on the caller's device, the card by default.

There is no CPU fallback.  ``device=None`` means the first CUDA card and
raises when there is none; the CPU runs only when the caller asks for it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
