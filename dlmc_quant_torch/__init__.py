"""dlmc_quant_torch: the PyTorch / CUDA port of dlmc_quant_tpu for an H100.

Imports ``torch`` only, never JAX or the JAX package.  Entry points run on
the card unless the caller passes ``device="cpu"``; without a card and
without that request they raise.
"""

from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.models.registry import get_model
from dlmc_quant_torch.quant.config import QuantScheme, scheme_from_dict
from dlmc_quant_torch.quant.deploy import make_serving_fn, prepare_deploy
from dlmc_quant_torch.quant.layers import attach_scheme, calibrate
from dlmc_quant_torch.training.fsptq import FSPTQTrainer, reconstruct_block
from dlmc_quant_torch.training.ptq import evaluate

__all__ = ["FSPTQTrainer", "QuantScheme", "attach_scheme", "calibrate",
           "evaluate", "get_dataloader", "get_model", "make_serving_fn",
           "prepare_deploy", "reconstruct_block", "resolve_device",
           "scheme_from_dict"]
