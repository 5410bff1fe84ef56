"""RepAPQ / FSPTQ entry point: branch-fuse → calibrate → per-block
reconstruction → evaluate → save → prepare_deploy → evaluate in ``intc``.

    python -m dlmc_quant_torch.examples.FSPTQuant \
        -c examples/configs/FSPTQ_repvgg_a0_w8a8.yaml [--device cpu]
    python -m dlmc_quant_torch.examples.FSPTQuant \
        -c examples/configs/FSPTQ_mobileone_s1_w4a8.yaml [--device cpu]

Counterpart of ``examples/FSPTQuant.py``.  The teacher is the fused FP
model; the student a copy with the config's quantization scheme,
calibrated with one observe pass per calibration batch.  After the
checkpoint is written, a copy of the student is prepared for integer
execution and evaluated chained int8 (``qmode='intc'``), W4 layers
through the kernels' nibble-packed weights.  Two config grammars: the
flagship's (``dataloaders.train``, ``trainer: {epochs, recon_batch,
lrs}``) and config #4's (``dataloaders.calibration``, ``reconstruction:
{epochs, batch_size, lr_scales, lr_weight, loss: l2_loss}``).  Runs on the
card unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import copy
import sys
import time

import torch

from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import (mobilenet_deploy, repvgg_fuse,
                                          resnet_deploy)
from dlmc_quant_torch.models.mobileone import mobileone_fuse
from dlmc_quant_torch.quant.deploy import prepare_deploy
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
FUSERS = {"RepVGG": repvgg_fuse, "MobileOne": mobileone_fuse,
          "CifarResNet": resnet_deploy, "CifarResNetLarge": resnet_deploy,
          "MobileNetV2": mobilenet_deploy}


def to_deploy(model, logger):
    """The model's fused deploy form (BN folded, branches merged)."""
    family = type(model).__name__
    if family not in FUSERS:
        raise NotImplementedError(
            f"{family}: only {sorted(FUSERS)} have a deploy conversion in "
            "the port (the JAX package's merge_bn for the others: ROADMAP "
            "Queue A, merge_bn (item 4))")
    if model.deploy:
        return model
    logger.info("converted %s to deploy form", family)
    return FUSERS[family](model)


def trainer_options(config) -> dict:
    """The reconstruction's options: the flagship's ``trainer`` section, or
    config #4's ``reconstruction`` section in the same terms (its weight
    rate for kernels and biases, its scale rate for the scale-like
    parameters and AdaRound's alpha)."""
    if "trainer" in config:
        return dict(config["trainer"] or {})
    rcfg = dict(config.get("reconstruction") or {})
    if rcfg.get("loss", "l2_loss") != "l2_loss":
        raise NotImplementedError(
            f"reconstruction loss {rcfg['loss']!r}: the reconstruction "
            "minimises l2_loss")
    lrs = {}
    if "lr_weight" in rcfg:
        lrs["kernel"] = lrs["bias"] = float(rcfg["lr_weight"])
    if "lr_scales" in rcfg:
        lrs["scale_like"] = float(rcfg["lr_scales"])
    out = {"lrs": lrs or None}
    for key, name in (("epochs", "epochs"), ("batch_size", "recon_batch")):
        if key in rcfg:
            out[name] = rcfg[key]
    return out


def main(args=None) -> int:
    t0 = time.perf_counter()
    config = ConfigParser.from_args(args)
    device = resolve_device(config.device)
    logger = setup_logging(config.log_dir)

    loaders = {n: get_dataloader(s["type"], **(s.get("args") or {}))
               for n, s in config["dataloaders"].items()}
    # the calibration set: the flagship's "train", config #4's "calibration"
    train_l = loaders["train"] if "train" in loaders \
        else loaders["calibration"]
    eval_l = loaders.get("eval")

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

    tcfg = trainer_options(config)
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
    if eval_l is not None:
        int_model = prepare_deploy(copy.deepcopy(qmodel).eval())
        int_m = evaluate(int_model, eval_l, loss_fn, metric_fns,
                         qmode="intc")
        logger.info("RepAPQ chained int8 (intc): %s", int_m)
    logger.info("FSPTQuant done in %.1f s on %s", time.perf_counter() - t0,
                torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
