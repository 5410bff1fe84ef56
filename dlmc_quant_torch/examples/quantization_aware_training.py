"""QAT entry point: LSQ or RootQ, as the YAML's
``quantization.quantization_type`` says.

    python -m dlmc_quant_torch.examples.quantization_aware_training \
        -c examples/configs/RootQ_resnet20_cifar10_w4a4.yaml [--device cpu] \
        [-r <run dir>/checkpoint-epoch<n>]

Counterpart of ``examples/quantization_aware_training.py`` (ref:
RootQ_train.py:23-106): ``alpha_lr`` gives RootQ's ``wt_alpha`` its own
rate, ``n_runs`` repeats the run; each run builds the model with the
scheme (``examples/classification.py: build_common``), calibrates it on
the first training batch and trains it with :class:`QATTrainer`.  Runs on
the card unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import sys

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.examples.classification import (build_common,
                                                      trainer_kwargs)
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.layers import calibrate
from dlmc_quant_torch.training.qat import QATTrainer
from dlmc_quant_torch.utils.config import ConfigParser
from dlmc_quant_torch.utils.logging import setup_logging


def build_trainer(config, device, logger, run: int = 0) -> QATTrainer:
    """The run's QAT trainer, its model calibrated on the first batch."""
    scheme = scheme_from_dict(config["quantization"])
    alpha_lr = config.get("alpha_lr")
    if alpha_lr and not config["optimizer"].get("param_groups"):
        # ref: RootQ_train.py:65-74
        config.config["optimizer"] = {
            **config["optimizer"],
            "param_groups": [("wt_alpha", {"lr": float(alpha_lr)})]}
    model, optimizer, sched, train_l, valid_l = build_common(
        config, device, scheme=scheme)
    x0, _ = next(iter(train_l))
    calibrate(model, [torch.from_numpy(x0).to(device)])
    return QATTrainer(model, optimizer, sched, train_l, valid_l,
                      **trainer_kwargs(config, run, logger))


def main(args=None) -> int:
    config = ConfigParser.from_args(args)
    device = resolve_device(config.device)
    logger = setup_logging(config.log_dir)
    for run in range(int(config.get("n_runs", 1))):
        result = build_trainer(config, device, logger, run).train()
        logger.info("run %d final: %s", run, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
