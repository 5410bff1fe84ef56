"""PTQ entry point: calibrate a model's quantizers and evaluate.

    python -m dlmc_quant_torch.examples.post_training_quantization \
        -c examples/configs/PTQ_resnet18_cifar10_w8a8.yaml [--device cpu]

Counterpart of ``examples/post_training_quantization.py``: runs
:func:`dlmc_quant_torch.training.ptq.run_ptq` on the card unless
``--device cpu`` is given; without a card it raises.  ``eval_int: true``
in the YAML adds an evaluation through the real integer path.
"""

from __future__ import annotations

import sys
import time

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.training.ptq import run_ptq
from dlmc_quant_torch.utils.config import ConfigParser
from dlmc_quant_torch.utils.logging import setup_logging


def main(args=None) -> int:
    t0 = time.perf_counter()
    config = ConfigParser.from_args(args)
    device = resolve_device(config.device)
    logger = setup_logging(config.log_dir)
    results = run_ptq(config, logger)
    logger.info("== PTQ summary ==")
    logger.info("fp32 : %s", results["fp32"])
    logger.info("quant: %s", results["quant"])
    if results["int"] is not None:
        logger.info("int  : %s", results["int"])
    logger.info("PTQ done in %.1f s on %s", time.perf_counter() - t0,
                torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
