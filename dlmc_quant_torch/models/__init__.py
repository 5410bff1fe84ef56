"""Model zoo (the RepVGGs, the ResNets, MobileNetV2, MobileOne, GhostNet,
EfficientNet) and reparameterization."""

from dlmc_quant_torch.models.registry import get_model, register

__all__ = ["get_model", "register"]
