"""Model zoo (RepVGG-A0, the CIFAR ResNets) and reparameterization."""

from dlmc_quant_torch.models.registry import get_model, register

__all__ = ["get_model", "register"]
