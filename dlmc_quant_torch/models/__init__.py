"""Model zoo (RepVGG-A0 in this slice) and reparameterization."""

from dlmc_quant_torch.models.registry import get_model, register

__all__ = ["get_model", "register"]
