"""FSPTQ / RepAPQ reconstruction trainer.

Counterpart of ``dlmc_quant_tpu/training/fsptq.py``.  Per block, in call
order: cache the quantized student's block inputs and the FP teacher's
block outputs over the calibration set, then run a short Adam + cosine loop
that trains the block's parameters (quantizer scales and AdaRound alphas at
1e-3, weights and biases at 1e-5) against the l2 reconstruction objective.
Later blocks reconstruct against the already-quantized earlier ones.

Blocks are found with forward pre-hooks and their I/O captured with
forward hooks; a block is trained in place.  The minibatches are drawn
from the same numpy stream as in the JAX package, so both see the same
minibatches iterate by iterate.  Capture and reconstruction run in full
f32 (``full_f32``), as calibration does: TF32 would move the cached
targets.
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from dlmc_quant_torch.ops.numerics import clip
from dlmc_quant_torch.quant.config import _freeze
from dlmc_quant_torch.quant.layers import (ADAROUND_GAMMA, ADAROUND_ZETA,
                                           QLayer, calibrate, full_f32)
from dlmc_quant_torch.training.losses import l2_loss
from dlmc_quant_torch.training.ptq import bn_recalibrate
from dlmc_quant_torch.training.schedulers import CosineAnnealingLR
from dlmc_quant_torch.utils.logging import get_logger

# per-param-group LRs (ref: fsptq_trainer.py:136-152 generate_optimizer)
DEFAULT_GROUP_LRS = {
    "kernel": 1e-5,
    "bias": 1e-5,
    "scale_like": 1e-3,      # wt_scale / in_scale / alpha
    "bn": 0.1,               # BatchNorm weight
}

DEFAULT_BLOCK_TYPES = ("RepVGGBlock", "BasicBlock", "Bottleneck",
                       "MobileOneBlock")
DEFAULT_LAYER_NAMES = ("conv1", "linear", "reparam")


def _call_order(model, sample_x, names: Sequence[str]) -> List[str]:
    """``names`` (module paths) in the order an fp forward first calls
    them."""
    order: List[str] = []

    def hook_for(name):
        def hook(_module, _args):
            if name not in order:
                order.append(name)
        return hook

    handles = [model.get_submodule(n).register_forward_pre_hook(hook_for(n))
               for n in names]
    try:
        with torch.no_grad(), full_f32():
            model(sample_x, qmode="fp")
    finally:
        for h in handles:
            h.remove()
    return order


def discover_blocks(model, sample_x,
                    block_types: Sequence[str] = DEFAULT_BLOCK_TYPES,
                    layer_names: Sequence[str] = DEFAULT_LAYER_NAMES
                    ) -> List[Tuple[str, nn.Module]]:
    """Reconstruction targets: the outermost modules whose type name is in
    ``block_types`` or whose name is in ``layer_names``, as (path, module)
    in call order.  ref: fsptq_trainer.py:37-45 + FSPTQuant.py:102
    """
    names = [n for n, m in model.named_modules() if n and (
        type(m).__name__ in block_types
        or n.rsplit(".", 1)[-1] in layer_names)]
    found: List[str] = []
    for n in _call_order(model, sample_x, names):
        # a pre-hook fires on the parent first: keep only outermost ones
        if not any(n.startswith(p + ".") for p in found):
            found.append(n)
    return [(n, model.get_submodule(n)) for n in found]


def first_quant_path(model, sample_x) -> Optional[str]:
    """Path of the first quantized layer (call order) whose activation
    quantizer is enabled, or None.  ref: fsptq_trainer.py:155-161"""
    names = [n for n, m in model.named_modules()
             if isinstance(m, QLayer) and m.cfg is not None
             and m.cfg.input.enable]
    order = _call_order(model, sample_x, names)
    return order[0] if order else None


def disable_act_quant_on(model, path: str):
    """Disable input quantization of layer ``path``, in place.

    Prepends to ``model.scheme`` an override carrying the layer's resolved
    config with ``input.enable`` off (resolution stops at the first match,
    so the layer's other options stay), and gives the layer that config.
    The layer keeps its calibrated parameters.  Returns ``model``.
    """
    scheme = model.scheme
    cfg = scheme.resolve(path)
    if cfg is None:
        return model
    opts = cfg.to_dict()
    opts["input"]["enable"] = False
    scheme = dataclasses.replace(scheme, override_options=(
        ((re.escape(path) + "$",), _freeze(opts)),) + scheme.override_options)
    model.scheme = scheme
    model.get_submodule(path).cfg = scheme.resolve(path)
    return model


def capture_block_io(model, batches, target: str, qmode: str):
    """(inputs, outputs) of module ``target`` over ``batches``, each
    concatenated over the batch.  ref: fsptq_trainer.py:46-67"""
    cap = {}

    def hook(_module, args, out):
        cap["in"], cap["out"] = args[0], out

    handle = model.get_submodule(target).register_forward_hook(hook)
    ins, outs = [], []
    try:
        with torch.no_grad(), full_f32():
            for xb in batches:
                model(xb, qmode=qmode)
                ins.append(cap["in"])
                outs.append(cap["out"])
    finally:
        handle.remove()
    return torch.cat(ins), torch.cat(outs)


def _group_label(name: str, module: nn.Module) -> str:
    """Optimizer group of parameter ``name`` (relative to the block) of
    ``module``, as the JAX package labels the flax leaf: ``kernel``,
    ``bias``, ``bn`` (BatchNorm scale) or ``scale_like``.  Like there, a
    BatchNorm bias whose path says "bn" lands in ``scale_like``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight":
        return "bn" if isinstance(module, nn.BatchNorm2d) else "kernel"
    if leaf == "bias" and "bn" not in name.lower():
        return "bias"
    return "scale_like"          # wt_scale / in_scale / alpha


def _alphas(block: nn.Module):
    return [p for n, p in block.named_parameters()
            if n.rsplit(".", 1)[-1] == "alpha"]


def _round_reg(block: nn.Module, beta: float):
    """AdaRound rounding regularizer: Σ 1 − |2·h(α) − 1|^β over every
    ``alpha`` of ``block``, h(α) the rectified-sigmoid soft target.

    Pushes soft targets to {0, 1} as β anneals down, so that the hard
    (α ≥ 0) decision matches what reconstruction optimized (AdaRound paper
    Eq. 24).
    """
    reg = 0.0
    for alpha in _alphas(block):
        h = clip(torch.sigmoid(alpha) * (ADAROUND_ZETA - ADAROUND_GAMMA)
                 + ADAROUND_GAMMA, 0.0, 1.0)
        reg = reg + torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
    return reg


def _has_alpha(block: nn.Module) -> bool:
    return bool(_alphas(block))


def reconstruct_block(block: nn.Module, x_cache, y_fp, iters: int = 2000,
                      batch_size: int = 64,
                      lrs: Optional[Dict[str, float]] = None,
                      seed: int = 0, round_reg_lambda: float = 0.01,
                      holdout_frac: float = 0.25,
                      record: Optional[Dict] = None) -> float:
    """Adam + cosine reconstruction of ``block`` (in place) against cached
    FP outputs; returns the held-out l2 of the iterate it keeps.

    ref: fsptq_trainer.py:76-103.  A ``holdout_frac`` slice of the cache is
    never trained on; the block is left at the iterate with the best
    held-out l2 (scored every ``eval_every`` iterations in ``'eval'``
    qmode, so AdaRound's hard decision is what counts), the calibrated
    parameters being iterate 0.  Blocks with AdaRound ``alpha`` add the
    rounding regularizer: none for the first 20 % of the iterations, then
    β anneals 20 → 2.  Without a holdout the block keeps its last iterate
    and the last minibatch loss is returned.  ``record``, where given,
    gets ``best_iter``: the iteration whose parameters the block keeps (0
    for the calibrated ones).
    """
    lrs = {**DEFAULT_GROUP_LRS, **(lrs or {})}
    named = list(block.named_parameters())
    groups: Dict[str, list] = {}
    for name, p in named:
        owner = block.get_submodule(name.rpartition(".")[0])
        groups.setdefault(_group_label(name, owner), []).append(p)
    sched = {g: CosineAnnealingLR(lrs[g], cycle_steps=iters) for g in groups}
    opt = torch.optim.Adam([{"params": ps, "lr": lrs[g], "label": g}
                            for g, ps in groups.items()])
    params = [p for _, p in named]
    device = x_cache.device

    # the JAX package's numpy stream, draw for draw: holdout split, then
    # one minibatch of distinct training rows per iteration
    n_total = x_cache.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_total)
    n_hold = max(int(holdout_frac * n_total), 1) if holdout_frac > 0 else 0
    hold_idx = torch.as_tensor(perm[:n_hold], device=device)
    train_idx = perm[n_hold:]
    n = len(train_idx)
    bs = min(batch_size, n)
    idx_all = torch.as_tensor(
        np.stack([train_idx[rng.choice(n, bs, replace=False)]
                  for _ in range(iters)]), device=device)
    use_reg = round_reg_lambda > 0 and _has_alpha(block)
    warmup = int(0.2 * iters)
    eval_every = max(min(50, iters // 4), 1)
    it_ar = np.arange(iters, dtype=np.float32)
    t_ar = np.clip((it_ar - warmup) / max(iters - warmup, 1), 0.0, None)
    lam_all = np.where(it_ar >= warmup, round_reg_lambda, 0.0) \
        .astype(np.float32)
    beta_all = (20.0 - 18.0 * t_ar).astype(np.float32)

    def hold_l2() -> float:
        with torch.no_grad():
            out = block(x_cache[hold_idx], qmode="eval")
            return float(l2_loss(out, y_fp[hold_idx]))

    with full_f32():
        best_l2 = hold_l2() if n_hold else math.inf
        best = [p.detach().clone() for p in params]
        best_it = 0
        for it in range(iters):
            for group in opt.param_groups:
                group["lr"] = sched[group["label"]](it)
            idx = idx_all[it]
            loss = l2_loss(block(x_cache[idx], qmode="train"), y_fp[idx])
            if use_reg and lam_all[it]:
                loss = loss + float(lam_all[it]) * _round_reg(
                    block, float(beta_all[it]))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if n_hold and (it + 1) % eval_every == 0:
                cur = hold_l2()
                if cur < best_l2:
                    best_l2, best_it = cur, it + 1
                    best = [p.detach().clone() for p in params]
        if record is not None:
            record["best_iter"] = best_it if n_hold else iters
        if not n_hold:
            return float(loss)
        with torch.no_grad():
            for p, b in zip(params, best):
                p.copy_(b)
    return best_l2


class FSPTQTrainer:
    """RepAPQ reconstruction over all blocks of a calibrated student.

    ref: trainer/fsptq_trainer.py:28-161.  ``model`` is the student, already
    calibrated; ``fp_model`` the FP teacher (same module paths).  Blocks are
    reconstructed in place.  With ``disable_first_act_quant`` the first
    layer's input stays unquantized (ref: fsptq_trainer.py:155-161), set on
    ``model`` itself.  A model with BatchNorm has its statistics
    re-estimated by ``bn_recalibrate`` and its quantizers re-calibrated
    (:meth:`refresh_bn`) before the gate first scores it.
    """

    def __init__(self, model, fp_model, cal_batches, iters: int = 2000,
                 batch_size: int = 64,
                 lrs: Optional[Dict[str, float]] = None,
                 block_types: Sequence[str] = DEFAULT_BLOCK_TYPES,
                 layer_names: Sequence[str] = DEFAULT_LAYER_NAMES,
                 logger=None, disable_first_act_quant: bool = False):
        self.model = model
        self.fp_model = fp_model
        self.cal_batches = list(cal_batches)
        self.iters = iters
        self.batch_size = batch_size
        self.lrs = lrs
        self.block_types = block_types
        self.layer_names = layer_names
        self.logger = logger or get_logger("fsptq")
        if disable_first_act_quant:
            path = first_quant_path(model, self.cal_batches[0])
            if path is not None:
                disable_act_quant_on(model, path)
                self.logger.info(
                    "disabled activation quant on first layer %s", path)

    def refresh_bn(self) -> None:
        """BN statistics re-estimated under quantization, then the
        quantizers re-calibrated with one observe pass a batch: their
        scales were observed under the stale statistics.  The JAX
        package's ``_refresh_bn(recalibrate_quantizers=True)`` before
        reconstruction; its refresh after the gate (ROADMAP hazard C6) is
        not copied."""
        bn_recalibrate(self.model, self.cal_batches)
        calibrate(self.model, self.cal_batches,
                  observe_passes=len(self.cal_batches))

    def _teacher_preds(self):
        """FP teacher's argmax on the calibration batches (the label-free
        acceptance signal; ref: fsptq_trainer.py:104-132)."""
        with torch.no_grad():
            return [self.fp_model(b, qmode="fp").argmax(-1)
                    for b in self.cal_batches]

    def _agreement(self, teacher_preds) -> float:
        hits = tot = 0
        with torch.no_grad():
            for b, t in zip(self.cal_batches, teacher_preds):
                pred = self.model(b, qmode="eval").argmax(-1)
                hits += int((pred == t).sum())
                tot += t.numel()
        return hits / max(tot, 1)

    def train(self) -> Dict:
        """Reconstruct every block; returns ``block_losses`` (held-out l2
        by path), ``blocks`` (per block: path, capture and reconstruction
        ms, l2, kept) and ``agreement`` (after calibration, at the end)."""
        t0 = time.perf_counter()
        with full_f32():
            if any(isinstance(m, nn.BatchNorm2d)
                   for m in self.model.modules()):
                self.refresh_bn()
            targets = discover_blocks(self.model, self.cal_batches[0],
                                      self.block_types, self.layer_names)
            self.logger.info("reconstructing %d blocks: %s", len(targets),
                             [p for p, _ in targets])
            # Per-block acceptance: a block's reconstruction is kept only
            # if the student's agreement with the FP teacher does not drop,
            # so reconstruction is never worse than calibration, block by
            # block, without labels.
            teacher_preds = self._teacher_preds()
            agree0 = agree = self._agreement(teacher_preds)
            self.logger.info("teacher agreement after calibration: %.4f",
                             agree)
            losses, blocks = {}, []
            for path, block in targets:
                t = time.perf_counter()
                x_cache, _ = capture_block_io(
                    self.model, self.cal_batches, path, qmode="eval")
                _, y_fp = capture_block_io(
                    self.fp_model, self.cal_batches, path, qmode="fp")
                if y_fp.is_cuda:
                    torch.cuda.synchronize(y_fp.device)
                t_cap = time.perf_counter()
                old = [p.detach().clone() for p in block.parameters()]
                record = {"best_iter": None}
                loss = reconstruct_block(block, x_cache, y_fp, self.iters,
                                         self.batch_size, self.lrs,
                                         record=record)
                t_rec = time.perf_counter()
                # whether the iterate the block keeps left its calibrated
                # parameters (bit for bit)
                moved = any(not torch.equal(p, o)
                            for p, o in zip(block.parameters(), old))
                del x_cache, y_fp
                new_agree = self._agreement(teacher_preds)
                kept = new_agree >= agree
                ms = {"capture_ms": 1e3 * (t_cap - t),
                      "recon_ms": 1e3 * (t_rec - t_cap)}
                if kept:
                    agree = new_agree
                    self.logger.info("block %-16s recon l2=%.5f kept "
                                     "(agreement %.4f; best iterate %s, "
                                     "moved %s; capture %.0f ms, recon "
                                     "%.0f ms)", path, loss, agree,
                                     record["best_iter"], moved,
                                     ms["capture_ms"], ms["recon_ms"])
                else:
                    with torch.no_grad():
                        for p, o in zip(block.parameters(), old):
                            p.copy_(o)
                    self.logger.info(
                        "block %-16s recon l2=%.5f REVERTED "
                        "(agreement %.4f -> %.4f; best iterate %s, moved "
                        "%s; capture %.0f ms, recon %.0f ms)", path, loss,
                        agree, new_agree, record["best_iter"], moved,
                        ms["capture_ms"], ms["recon_ms"])
                losses[path] = loss
                blocks.append({"block": path, "l2": loss, "kept": kept,
                               "best_iter": record["best_iter"],
                               "moved": moved, **ms})
        self.logger.info("reconstruction done in %.1fs (final teacher "
                         "agreement %.4f)", time.perf_counter() - t0, agree)
        return {"block_losses": losses, "blocks": blocks,
                "agreement": (agree0, agree)}
