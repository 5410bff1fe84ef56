"""The classification trainer: epoch loop, monitor and early stop,
checkpoints and resume, mid-epoch validation, log densities, metric
tracking and TensorBoard.

Counterpart of ``dlmc_quant_tpu/training/trainer.py`` (ref:
base/base_trainer.py:14-279, trainer/classification_trainer.py).  The
model holds its own state (parameters, BN statistics, quantizer buffers),
so a step is a forward, a backward and an optimizer step in place:

* per-epoch seeds ``default_rng(random_seed).integers(0, 2**31 − 1,
  epochs + 1)`` go to ``train_loader.set_epoch``;
* a step runs the model in train mode with ``qmode=train_qmode``
  (``'train'``); ``freeze_bn`` keeps the BatchNorms in eval mode (their
  affine parameters still learn); ``kurtosis`` adds that weight times the
  mean kurtosis term of the 4-D conv weights;
* validation runs in eval mode with ``qmode='eval'`` (``'fp'`` for an fp
  trainer);
* checkpoints hold the model's state dict, the optimizer's state and the
  step (and ReduceLROnPlateau's state); ``resume`` also takes a
  weights-only checkpoint (a module's state dict), with a fresh optimizer.

Data parallelism (``mesh``, a data mesh from ``parallel.mesh.make_mesh``):
each rank steps on its own loader's batch, its slice of the global batch,
and the update is the one JAX's SPMD step makes on the whole global batch.
The train forward runs inside ``parallel.mesh.data_parallel``, so the BN
statistics and the quantizers' gradient scales are the global batch's; the
gradients are averaged over the ranks before the optimizer clips and
steps; the logged loss and metrics are the ranks' mean.  Validation pads
each batch to a multiple of the ranks, each rank runs its slice, and the
gathered logits of the real rows are scored.  Logging, TensorBoard and
checkpoints are rank 0's.  The model is broadcast from rank 0 at the
start, the ranks must have as many batches an epoch, and a BatchNorm
whose class does not set ``reduces_over_data`` (torch's ``BatchNorm2d``,
RepVGG's train form) takes its statistics over the local batch and
trains only under ``freeze_bn``.  With ``mesh=None`` and no process group
the trainer is the one-device one.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from dlmc_quant_torch.parallel import mesh as mesh_lib
from dlmc_quant_torch.training.losses import get_loss, kurtosis
from dlmc_quant_torch.training.metrics import get_metric
from dlmc_quant_torch.training.schedulers import ReduceLROnPlateau
from dlmc_quant_torch.utils.checkpoint import CheckpointManager, \
    load_checkpoint
from dlmc_quant_torch.utils.logging import TensorboardWriter, get_logger
from dlmc_quant_torch.utils.metric_tracker import MetricTracker


def _parse_monitor(spec: str):
    """'max val_accuracy' → (mode, metric).  ref: base_trainer.py:53-62"""
    if not spec or spec == "off":
        return None, None
    mode, metric = spec.split()
    if mode not in ("min", "max"):
        raise ValueError(f"monitor mode {mode!r}: min or max")
    return mode, metric


class Trainer:
    """Classification trainer (ref: trainer/classification_trainer.py).

    ``optimizer`` is a :class:`~dlmc_quant_torch.training.optimizers.
    Optimizer` over ``model``'s parameters; ``lr_schedule`` what it was
    built with (a float, a schedule or a ReduceLROnPlateau).  ``config``
    keys (the YAML's trainer section): epochs, save_period, monitor,
    early_stop, train_log_density, valid_log_density, kurtosis, freeze_bn,
    detect_anomalies, random_seed.  ``mesh``: see the module docstring.
    """

    train_qmode = "train"

    def __init__(self, model: nn.Module, optimizer, lr_schedule,
                 train_loader, valid_loader=None,
                 config: Optional[Dict] = None, loss: str = "cross_entropy",
                 metrics=("accuracy",), mesh=None, save_dir=None,
                 log_dir=None, logger=None, resume: Optional[str] = None):
        self.model = model
        self.mesh = mesh
        self.ranks = mesh_lib.axis_size(mesh)
        self.process_index = mesh_lib.rank()
        self.device = next(model.parameters()).device
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        cfg = dict(config or {})
        self.epochs = int(cfg.get("epochs", 1))
        self.save_period = int(cfg.get("save_period", self.epochs))
        self.monitor_mode, self.monitor_metric = _parse_monitor(
            cfg.get("monitor", "off"))
        self.early_stop = int(cfg.get("early_stop", 0) or 0)
        self.kurtosis_weight = float(cfg.get("kurtosis", 0) or 0)
        self.freeze_bn = bool(cfg.get("freeze_bn", False))
        self.cfg = cfg

        self.loss_fn = get_loss(loss)
        self.metric_fns = {m: get_metric(m) for m in metrics}
        self.logger = logger or get_logger("trainer", self.process_index)
        self.writer = TensorboardWriter(
            log_dir, self.logger,
            enabled=log_dir is not None and self.process_index == 0)
        self.ckpt = CheckpointManager(save_dir, self.monitor_metric or "loss") \
            if save_dir else None

        # log steps as fractions of an epoch (ref: base_trainer.py:35-40)
        spe = max(len(train_loader), 1)
        self.train_log_step = max(
            int(spe * float(cfg.get("train_log_density", 1.0))), 1)
        self.valid_log_step = max(
            int(spe * float(cfg.get("valid_log_density", 1.0))), 1)

        self.plateau = (lr_schedule
                        if isinstance(lr_schedule, ReduceLROnPlateau)
                        else None)
        self.start_epoch = 1
        self.monitor_best = (math.inf if self.monitor_mode == "min"
                             else -math.inf)
        self.not_improved = 0
        if resume:
            self._resume(resume)

        # per-epoch fixed seeds (ref: base_trainer.py:50-51,92-96)
        rng = np.random.default_rng(int(cfg.get("random_seed", 0)))
        self.epoch_seeds = rng.integers(0, 2 ** 31 - 1, self.epochs + 1)
        self.kernels = [p for name, p in model.named_parameters()
                        if p.dim() == 4 and name.rpartition(".")[2]
                        == "weight"]
        self.tracker = MetricTracker("loss", *self.metric_fns,
                                     writer=self.writer)
        if self.ranks > 1:
            self._check_data_parallel()
            mesh_lib.replicate_tree(model, mesh)

    def _check_data_parallel(self) -> None:
        """Refuse what would make the ranks part: BN statistics that are
        not reduced, and epochs of unequal length (a collective would
        wait forever)."""
        unreduced = [name for name, m in self.model.named_modules()
                     if isinstance(m, nn.modules.batchnorm._BatchNorm)
                     and not getattr(m, "reduces_over_data", False)]
        if unreduced and not self.freeze_bn:
            raise NotImplementedError(
                f"{unreduced[0]}: this BatchNorm takes its statistics "
                "over the local batch; data-parallel training needs one "
                "that sets reduces_over_data, or freeze_bn")
        counts = mesh_lib.all_gather_rows(torch.tensor(
            [len(self.train_loader)], device=self.device), self.mesh)
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"the ranks' epochs have {counts.tolist()} "
                             "batches: they must be equal")

    def _global(self, t: torch.Tensor) -> torch.Tensor:
        """A per-batch value (loss, metric) as the mean over the ranks."""
        return mesh_lib.all_reduce_mean(t, self.mesh)

    @property
    def step(self) -> int:
        """Updates made so far (optax's count)."""
        return self.optimizer.count

    @property
    def eval_qmode(self) -> str:
        return "fp" if self.train_qmode == "fp" else "eval"

    # ------------------------------------------------------------------
    def _set_train_mode(self) -> None:
        self.model.train()
        if self.freeze_bn:
            for m in self.model.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()

    def _to_device(self, x, y):
        return (torch.as_tensor(x).to(self.device),
                torch.as_tensor(y).to(self.device).long())

    def train_step(self, x: torch.Tensor, y: torch.Tensor):
        """One update on a device batch; returns (loss, logits), detached.
        Nothing in it waits for the device."""
        self._set_train_mode()
        with mesh_lib.data_parallel(self.mesh):
            logits = self.model(x, qmode=self.train_qmode)
        loss = self.loss_fn(logits, y)
        if self.kurtosis_weight and self.kernels:
            # kurtosis regularizer of the conv kernels
            # (ref: classification_trainer.py:20-30,49-50)
            loss = loss + self.kurtosis_weight * torch.stack(
                [kurtosis(k) for k in self.kernels]).mean()
        self.optimizer.zero_grad()
        loss.backward()
        if self.ranks > 1:
            mesh_lib.all_reduce_grads(self.optimizer.params, self.mesh)
        self.optimizer.step()
        return loss.detach(), logits.detach()

    def _sync_plateau_lr(self, result: Dict[str, float]) -> None:
        """Feed the epoch's metric to ReduceLROnPlateau, whose rate the
        optimizer reads at its next step."""
        metric = result.get("val_loss", result.get("loss"))
        if metric is None:
            return
        self.plateau.record(metric)
        self.plateau.epoch_end()

    def train(self) -> Dict[str, float]:
        """Epoch loop with monitor and early stop; returns the last epoch's
        results.  ref: base_trainer.py:86-111"""
        last = {}
        for epoch in range(self.start_epoch, self.epochs + 1):
            result = self._train_epoch(epoch)
            last = result
            if self.plateau is not None:
                self._sync_plateau_lr(result)
            if self.monitor_mode:
                current = result.get(self.monitor_metric)
                if current is not None:
                    improved = (current < self.monitor_best
                                if self.monitor_mode == "min"
                                else current > self.monitor_best)
                    if improved:
                        self.monitor_best = current
                        self.not_improved = 0
                        if self.ckpt and self.process_index == 0:
                            self.ckpt.save_best(
                                self._resume_tree(),
                                {"epoch": epoch,
                                 self.monitor_metric: current})
                    else:
                        self.not_improved += 1
                    if self.early_stop and self.not_improved >= self.early_stop:
                        self.logger.info(
                            "early stop at epoch %d (no improvement in %d)",
                            epoch, self.early_stop)
                        break
            if (self.ckpt and self.process_index == 0
                    and epoch % self.save_period == 0):
                self.ckpt.save_epoch(epoch, self._resume_tree(),
                                     {"epoch": epoch, **result,
                                      "monitor_best": self.monitor_best})
        return last

    def _on_step(self, epoch: int, batch_idx: int, batch) -> None:
        """Subclass hook before each step; ``batch`` is the (x, y) about to
        be stepped on, on the device."""

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(int(self.epoch_seeds[epoch % len(
            self.epoch_seeds)]))
        self.tracker.reset()
        t0 = time.time()
        n_batches = len(self.train_loader)
        result: Dict[str, float] = {}
        for i, (x, y) in enumerate(self.train_loader):
            batch = self._to_device(x, y)
            self._on_step(epoch, i, batch)
            loss, logits = self.train_step(*batch)
            if self.cfg.get("detect_anomalies"):
                # a non-finite loss stops training before it can poison
                # the parameters (the reference has no such check)
                loss_val = float(self._global(loss))
                if not math.isfinite(loss_val):
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at epoch {epoch} "
                        f"step {i} — aborting (set detect_anomalies: false "
                        f"to disable)")
            if (i + 1) % self.train_log_step == 0 or i + 1 == n_batches:
                self.writer.set_step((epoch - 1) * n_batches + i)
                self.tracker.update("loss", float(self._global(loss)))
                for name, fn in self.metric_fns.items():
                    self.tracker.update(name, float(self._global(
                        fn(logits, batch[1]))))
                self._log_quant_scalars()
                self.logger.info(
                    "epoch %d [%d/%d] loss=%.4f lr=%.2e",
                    epoch, i + 1, n_batches, self.tracker.avg("loss"),
                    self.optimizer.lr())
            # mid-epoch validation (ref: trainer:72-85)
            if (self.valid_loader is not None
                    and (i + 1) % self.valid_log_step == 0
                    and i + 1 < n_batches):
                result.update(self._valid_epoch(epoch))
        result = {**{k: self.tracker.avg(k)
                     for k in ["loss", *self.metric_fns]}, **result}
        if self.valid_loader is not None:
            result.update(self._valid_epoch(epoch))
        self.logger.info("epoch %d done in %.1fs: %s", epoch,
                         time.time() - t0, _fmt(result))
        return result

    def _valid_epoch(self, epoch: int) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        n = 0
        self.model.eval()           # a step sets its own modes
        with torch.no_grad():
            for x, y in self.valid_loader:
                bs = len(y)
                x = np.asarray(x)
                pad = (-bs) % self.ranks
                if pad:     # the last batch may not divide over the ranks
                    x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
                xb, yb = self._to_device(
                    x[mesh_lib.data_sharding(self.mesh, len(x))], y)
                logits = mesh_lib.all_gather_rows(
                    self.model(xb, qmode=self.eval_qmode), self.mesh)[:bs]
                m = {"loss": self.loss_fn(logits, yb)}
                for name, fn in self.metric_fns.items():
                    m[name] = fn(logits, yb)
                for k, v in m.items():
                    totals[k] = totals.get(k, 0.0) + float(v) * len(yb)
                n += len(yb)
        out = {f"val_{k}": v / max(n, 1) for k, v in totals.items()}
        self.writer.set_step(self.step, "valid")
        for k, v in out.items():
            self.writer.add_scalar(k, v)
        return out

    def _log_quant_scalars(self) -> None:
        """Subclass hook: QAT logs the quantizer scalars."""

    # ------------------------------------------------------------------
    def _resume_tree(self):
        """What epoch and best checkpoints store, so that ``resume``
        restores the optimizer and the step too (ref:
        base_trainer.py:261-273)."""
        tree = {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}
        if self.plateau is not None:
            tree["plateau"] = self.plateau.state_dict()
        return tree

    def _resume(self, path) -> None:
        """ref: base_trainer.py:182-228"""
        tree, meta = load_checkpoint(path)
        if "model" in tree and "optimizer" in tree:
            self.model.load_state_dict(tree["model"])
            self.optimizer.load_state_dict(tree["optimizer"])
            if self.plateau is not None and "plateau" in tree:
                self.plateau.load_state_dict(tree["plateau"])
        else:
            # weights only (a quantized_model, a best file): fresh optimizer
            self.model.load_state_dict(tree)
            self.logger.info("weights-only checkpoint; optimizer state "
                             "re-initialized")
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        if "monitor_best" in meta:
            self.monitor_best = float(meta["monitor_best"])
        self.logger.info("resumed from %s at epoch %d", path,
                         self.start_epoch)


def _fmt(d: Dict[str, float]) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in d.items())
