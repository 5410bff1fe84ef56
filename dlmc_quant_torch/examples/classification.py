"""Baseline classification training.

    python -m dlmc_quant_torch.examples.classification \
        -c examples/configs/baseline_resnet20_cifar10.yaml [--device cpu] \
        [-r <run dir>/checkpoint-epoch<n>]

Counterpart of ``examples/classification.py`` (ref:
example/baseline/classification.py:22-77, with its ``n_runs`` repeat
loop).  :func:`build_common` is the setup every training entry shares:
loaders (the validation loader from ``valid_loader`` or the training
loader's ``validation_split``), the model on the device from the seed,
the schedule and the optimizer.  Runs on the card unless ``--device cpu``
is given; without a card it raises.
"""

from __future__ import annotations

import sys

import torch

from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.training.optimizers import build_optimizer
from dlmc_quant_torch.training.schedulers import get_scheduler
from dlmc_quant_torch.training.trainer import Trainer
from dlmc_quant_torch.utils.config import ConfigParser
from dlmc_quant_torch.utils.logging import setup_logging


def build_common(config, device, scheme=None):
    """(model, optimizer, schedule, train loader, valid loader) of a run;
    the model's weights come from ``config.seed``."""
    train_loader = config.init_obj("train_loader", get_dataloader)
    if "valid_loader" in config:
        valid_loader = config.init_obj("valid_loader", get_dataloader)
    else:
        valid_loader = train_loader.split_validation()
    model = config.init_obj(
        "arch", get_model, device=device, scheme=scheme,
        generator=torch.Generator().manual_seed(config.seed))
    sched_spec = config["lr_scheduler"]
    sched = get_scheduler(sched_spec["type"],
                          steps_per_epc=len(train_loader),
                          **(sched_spec.get("args") or {}))
    opt_spec = config["optimizer"]
    opt_args = dict(opt_spec.get("args") or {})
    opt_args.pop("lr", None)
    optimizer = build_optimizer(
        model.named_parameters(), opt_spec["type"], sched,
        grad_clip=config.get("trainer", {}).get("grad_clip_param"),
        param_groups=opt_spec.get("param_groups"), **opt_args)
    return model, optimizer, sched, train_loader, valid_loader


def trainer_kwargs(config, run: int, logger):
    """The trainer's arguments from the config, for run ``run``."""
    return dict(
        config={**config["trainer"], "random_seed": config.seed + run},
        loss=config.get("loss", "cross_entropy"),
        metrics=config.get("metrics", ["accuracy"]),
        save_dir=config.save_dir, log_dir=config.log_dir, logger=logger,
        resume=config.resume)


def build_trainer(config, device, logger, run: int = 0) -> Trainer:
    model, optimizer, sched, train_l, valid_l = build_common(config, device)
    return Trainer(model, optimizer, sched, train_l, valid_l,
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
