"""RepAPQ / FSPTQ entry point: branch-fuse → calibrate → per-block
reconstruction → evaluate → save.

    python -m dlmc_quant_torch.examples.FSPTQuant \
        -c examples/configs/FSPTQ_repvgg_a0_w8a8.yaml [--device cpu]

Counterpart of ``examples/FSPTQuant.py``.  The teacher is the fused FP
model; the student a copy with the config's quantization scheme,
calibrated with one observe pass per calibration batch.  Runs on the card
unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import copy
import sys
import time

import torch

from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import repvgg_fuse
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.layers import attach_scheme, calibrate
from dlmc_quant_torch.training.fsptq import FSPTQTrainer
from dlmc_quant_torch.training.losses import get_loss
from dlmc_quant_torch.training.metrics import get_metric
from dlmc_quant_torch.training.ptq import evaluate
from dlmc_quant_torch.utils.checkpoint import save_checkpoint
from dlmc_quant_torch.utils.config import ConfigParser
from dlmc_quant_torch.utils.logging import setup_logging

# train form → deploy form, by model class (ref: FSPTQuant.py:65-67)
FUSERS = {"RepVGG": repvgg_fuse}


def to_deploy(model, logger):
    """The model's fused deploy form (BN folded, branches merged)."""
    family = type(model).__name__
    if family not in FUSERS:
        raise NotImplementedError(
            f"{family}: only RepVGG has a deploy conversion in the port "
            "(merge_bn: ROADMAP Queue A, PTQ E2E (item 4); the other "
            "families: rest of the zoo (item 7))")
    if model.deploy:
        return model
    logger.info("converted %s to deploy form", family)
    return FUSERS[family](model)


def main(args=None) -> int:
    t0 = time.perf_counter()
    config = ConfigParser.from_args(args)
    device = resolve_device(config.device)
    logger = setup_logging(config.log_dir)

    loaders = {n: get_dataloader(s["type"], **(s.get("args") or {}))
               for n, s in config["dataloaders"].items()}
    train_l, eval_l = loaders["train"], loaders.get("eval")

    gen = torch.Generator().manual_seed(config.seed)
    model = config.init_obj("arch", get_model, device=device, generator=gen)
    fp_model = to_deploy(model, logger)

    qmodel = attach_scheme(copy.deepcopy(fp_model),
                           scheme_from_dict(config["quantization"]))

    # calibration sample (ref: FSPTQuant.py:26-33,93 get_train_sample)
    n_cal = int(config.get("train_sample_num", 1024))
    cal_batches, n = [], 0
    for x, _ in train_l:
        cal_batches.append(torch.from_numpy(x).to(device))
        n += len(x)
        if n >= n_cal:
            break
    calibrate(qmodel, cal_batches, observe_passes=len(cal_batches))

    tcfg = config.get("trainer", {})
    trainer = FSPTQTrainer(
        qmodel, fp_model, cal_batches,
        iters=int(tcfg.get("epochs", 2000)),
        batch_size=int(tcfg.get("recon_batch", 64)),
        lrs=tcfg.get("lrs"), logger=logger,
        # ref: fsptq_trainer.py:155-161, act quant off on the first conv
        disable_first_act_quant=bool(
            tcfg.get("disable_first_act_quant", True)))
    out = trainer.train()

    loss_fn = get_loss(config.get("loss", "cross_entropy"))
    metric_fns = {m: get_metric(m)
                  for m in config.get("metrics", ["accuracy"])}
    if eval_l is not None:
        fp_m = evaluate(fp_model, eval_l, loss_fn, metric_fns, qmode="fp")
        q_m = evaluate(qmodel, eval_l, loss_fn, metric_fns, qmode="eval")
        logger.info("FP teacher: %s", fp_m)
        logger.info("RepAPQ quantized: %s", q_m)

    if config.save_dir is not None:
        save_checkpoint(config.save_dir / "fsptq_model", qmodel.state_dict(),
                        metadata={"block_losses": out["block_losses"]})
        logger.info("saved to %s", config.save_dir)
    logger.info("FSPTQuant done in %.1f s on %s", time.perf_counter() - t0,
                torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
