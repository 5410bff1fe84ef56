"""Model zoo (RepVGG-A0, the ResNets, MobileNetV2, MobileOne) and
reparameterization."""

from dlmc_quant_torch.models.registry import get_model, register

__all__ = ["get_model", "register"]
