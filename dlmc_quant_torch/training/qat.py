"""QAT trainer: LSQ and RootQ quantization-aware training.

Counterpart of ``dlmc_quant_tpu/training/qat.py`` (ref:
trainer/quantization_aware_training_trainer.py).  Beside the base
trainer: periodic recalibration of the quantizers on the live batch, and
TensorBoard scalars of the quantizers.  ``freeze_bn`` is the base
trainer's; gradient clipping is the optimizer's (``grad_clip_param``).
"""

from __future__ import annotations

from dlmc_quant_torch.parallel import mesh as mesh_lib
from dlmc_quant_torch.quant.layers import calibrate
from dlmc_quant_torch.training.trainer import Trainer

QUANT_SCALARS = ("in_scale", "wt_scale", "wt_upper", "wt_lower", "wt_alpha")


class QATTrainer(Trainer):
    """Config extra (trainer section): ``update_qparams_period`` (steps;
    0, the default, never recalibrates)."""

    train_qmode = "train"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.update_qparams_period = int(
            self.cfg.get("update_qparams_period", 0) or 0)

    def _on_step(self, epoch: int, batch_idx: int, batch) -> None:
        """Every ``update_qparams_period`` steps, recalibrate on the batch
        about to be stepped on (ref: qat trainer:43-48); ``calibrate``
        runs the model in eval mode and restores its modes.  Under a data
        mesh it calibrates on the global batch, gathered, so that every
        rank gets the same quantizer parameters."""
        if (self.update_qparams_period and self.step > 0
                and self.step % self.update_qparams_period == 0):
            calibrate(self.model,
                      [mesh_lib.all_gather_rows(batch[0], self.mesh)])
            self.logger.info("re-calibrated quantizers at step %d",
                             self.step)

    def _log_quant_scalars(self) -> None:
        """The quantizers' scalars (ref: qat trainer:91-93,138-140)."""
        if self.writer.writer is None:
            return
        for name, p in self.model.named_parameters():
            if name.rpartition(".")[2] in QUANT_SCALARS and p.numel() == 1:
                self.writer.add_scalar(name.replace(".", "/"), float(p))
