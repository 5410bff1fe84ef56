"""Model registry: name → factory(**kwargs) → ``nn.Module``.

Counterpart of ``dlmc_quant_tpu/models/registry.py``.  :func:`get_model`
also places the model: on the card unless the caller passes a device.
"""

from __future__ import annotations

from typing import Callable, Dict

from dlmc_quant_torch.device import DeviceLike, resolve_device

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate model name {name!r}")
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model(name: str, device: DeviceLike = None, **kwargs):
    """Build ``name`` on ``device`` (default ``cuda``; raises without a
    card), in eval mode like the JAX models' ``train=False`` default."""
    device = resolve_device(device)
    from dlmc_quant_torch.models import (  # noqa: F401  (they register)
        efficientnet, ghostnet, mobilenetv2, mobileone, repvgg,
        resnet_cifar)
    folded = {k.lower(): k for k in _REGISTRY}
    if name.lower() not in folded:
        raise ValueError(
            f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[folded[name.lower()]](**kwargs).to(device).eval()

