"""Host-side numpy datasets and batch loaders."""

from dlmc_quant_torch.data.loaders import get_dataloader

__all__ = ["get_dataloader"]
