"""End-to-end accuracy protocol on the port: fp32 training → PTQ and QAT →
top-1 deltas, and the chained int8 path.

    python -m dlmc_quant_torch.tools.accuracy_protocol [--epochs 30] \
        [--qat-epochs 20] [--batch 256] [--recon-iters 800] [--seed 0] \
        [--skip-resnet] [--skip-repvgg] [--skip-qat] [--device cpu] \
        [--out RESULTS_torch.md]

Counterpart of ``tools/accuracy_protocol.py``, with its names as plain
functions on the port's modules (``w_scheme``, ``qat_scheme``, ``qat``,
``train_fp``, ``ptq``, ``cal_set``; ``main`` runs ``section_resnet``,
``section_qat`` and ``section_repvgg``, each on the loaders it is given):

* Section 1, cifar_resnet20: fp32 training (SGD, momentum 0.9, weight
  decay 1e-4, lr 0.1 cosine with one epoch of warmup) → 1024 calibration
  images → FSPTQ at W8A8, W4A8 (minmax, rounding) and W4A8 (l2loss clip
  + AdaRound), each reconstructed with the first layer's activation
  quant off → top-1 in fake quant;
* its QAT rows: LSQ and RootQ W4A4 from the fp32 weights and BN
  statistics, calibrated on the first batch, the ``wt_alpha`` group on
  its own rate and without weight decay;
* Section 2, RepVGG-A0 at 32×32: the train form trained as above →
  ``repvgg_fuse`` → FSPTQ W8A8 → top-1 in fake quant, then
  ``prepare_deploy`` and top-1 in ``int`` and chained ``intc`` (on the
  card the 21 reconstructed 3×3 convs run in ``int8_conv3x3.cu``, the
  stem weight-only).

The data is the JAX package's seeded synthetic 100-class "hard" CIFAR
(10,000 training and 2,000 held-out images, array for array the same).
Training runs at PyTorch's default precision (cuDNN convs in TF32 on the
card) with cuDNN's deterministic algorithms, so that a seed gives one model;
calibration, reconstruction and every evaluation in full f32
(``quant.layers.full_f32``).  ``--seed`` draws the models' initial
weights (default 0, as the JAX tool's ``PRNGKey(0)``; the two RNGs give
different weights); the data's seed is the JAX package's.  Other seeds
measure how far a row spreads from one fp32 training to the next.

Beside the JAX tool, each PTQ row gives the blocks the teacher-agreement
gate kept and the agreement before and after reconstruction; Section 2
gives the conv kernel's launches a batch of the ``intc`` evaluation; on
the card both sections give card-against-CPU relative L2 of the eval
logits on 8 images (the reconstructed A0, the RootQ model), and the worst
quantized layer of the CPU copy fed the card's input to it.  The tables
carry RESULTS.md's Δ for the same row (the JAX package on a TPU).

``ptq_retry`` of the JAX tool is left out: it retries a TPU remote-compile
error, which cannot happen here.  Results are appended to ``--out``
(default ``RESULTS_torch.md``), never to ``RESULTS.md``.  Runs on the card
unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import math
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

from dlmc_quant_torch.data.loaders import CIFAR10
from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import repvgg_fuse
from dlmc_quant_torch.ops.cuda import int8_conv
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import (QLayer, attach_scheme, calibrate,
                                           full_f32)
from dlmc_quant_torch.training.fsptq import FSPTQTrainer
from dlmc_quant_torch.training.losses import get_loss
from dlmc_quant_torch.training.metrics import get_metric
from dlmc_quant_torch.training.optimizers import build_optimizer
from dlmc_quant_torch.training.ptq import evaluate
from dlmc_quant_torch.training.qat import QATTrainer
from dlmc_quant_torch.training.schedulers import CosineDecayLR
from dlmc_quant_torch.training.trainer import Trainer
from dlmc_quant_torch.utils.launches import LaunchRecorder
from dlmc_quant_torch.utils.logging import setup_logging
from dlmc_quant_torch.utils.profiling import card_line

# RESULTS.md's Δ for each row (the JAX package, 30 fp32 epochs, 20 QAT
# epochs, 800 iterations a block; RESULTS.md:18-23,39-41,58-61)
REFERENCE = {"fp32_resnet": 90.45, "W8A8": 0.20, "W4A8": -0.85,
             "W4A8 AdaRound": -0.50, "LSQ": -5.05, "RootQ": -5.15,
             "fp32_repvgg": 87.05, "eval": -0.35, "int": 0.00,
             "intc": -0.05}
DATASET = ("the JAX package's seeded synthetic 100-class 'hard' CIFAR "
           "(10,000 training and 2,000 held-out images; no real dataset "
           "is read)")
CAL_IMAGES = 1024
COMPARE_IMAGES = 8


def w_scheme(bits: int, recon=None, wtype: str = "minmax_channel"):
    """FSPTQ: per-channel ``wtype`` weights of ``bits``, unsigned 8-bit
    ``minmax_tensor`` inputs; below 8 bits the first conv, RepVGG's
    ``stage0`` and the head stay at 8 bits (without ``recon_type``)."""
    wargs = {"enable": True, "type": wtype,
             "args": {"n_bits": bits, "signed": True}}
    if recon:
        wargs["recon_type"] = recon
    return scheme_from_dict({
        "quantization_type": "FSPTQ",
        "weight": wargs,
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}},
        "override_options": [
            {"layers": ["conv1$", r"stage0\.", "linear$"],
             "options": {"weight": {"args": {"n_bits": 8},
                                    **({"recon_type": None}
                                       if recon else {})}}},
        ] if bits < 8 else [],
    })


def qat_scheme(family, bits: int = 4):
    """LSQ (``family=None``) or RootQ W{bits}A{bits}; the first conv and
    the head at 8 bits."""
    obs = "LSQ" if family is None else "minmax_tensor"
    return scheme_from_dict({
        "quantization_type": family,
        "momentum": 0.001,
        "weight": {"enable": True, "type": obs,
                   "args": {"n_bits": bits, "signed": True}},
        "input": {"enable": True, "type": obs,
                  "args": {"n_bits": bits, "signed": False}},
        "override_options": [
            {"layers": ["conv1$", "linear$"],
             "options": {"weight": {"args": {"n_bits": 8}},
                         "input": {"args": {"n_bits": 8}}}}],
    })


def qat_optimizer(model, steps_per_epoch: int, epochs: int,
                  lr: float = 0.01, alpha_lr: float = 0.01):
    """optax's ``multi_transform`` of the JAX tool: the main group SGD
    (momentum 0.9, weight decay 1e-4, lr cosine with half an epoch of
    warmup), RootQ's ``wt_alpha`` SGD (momentum 0.9, no weight decay, its
    own cosine, no warmup).  Returns (optimizer, main schedule)."""
    steps = steps_per_epoch * epochs
    sched = CosineDecayLR(lr, total_steps=steps,
                          warmup_steps=steps_per_epoch // 2)
    alpha_sched = CosineDecayLR(alpha_lr, total_steps=steps)
    opt = build_optimizer(
        model.named_parameters(), "sgd", sched,
        param_groups=[("(^|/)wt_alpha$",
                       {"lr": alpha_sched, "weight_decay": 0.0})],
        momentum=0.9, weight_decay=1e-4)
    return opt, sched


def _first_batch(loader, device) -> torch.Tensor:
    return torch.from_numpy(next(iter(loader))[0]).to(device)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / (want.norm() + 1e-12))


def card_vs_cpu(model, x: torch.Tensor):
    """``model``'s eval forward of ``x`` against a CPU copy of the model,
    both in full f32: (relative L2 of the logits, the worst relative L2
    of a quantized layer of the copy fed the card's input to it).  The
    second is free of the codes that flip upstream."""
    cpu = copy.deepcopy(model).cpu()
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: seen.__setitem__(
            name, (args[0], out)))
        for name, m in model.named_modules() if isinstance(m, QLayer)]
    with torch.no_grad(), full_f32():
        try:
            got = model(x, qmode="eval")
        finally:
            for h in hooks:
                h.remove()
        want = cpu(x.cpu(), qmode="eval")
        worst = max(_rel_l2(cpu.get_submodule(name)(inp.cpu(), qmode="eval"),
                            out) for name, (inp, out) in seen.items())
    return _rel_l2(got, want), worst


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms, at the default precision (TF32
    convs on the card): a rerun with the same seed trains the same model.
    Without it the card's fp32 A0 reached 86.45 and 82.75 % top-1 from
    one seed."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def qat(model, train_l, eval_l, family, epochs, loss_fn, metrics,
        lr: float = 0.01, alpha_lr: float = 0.01, logger=None):
    """QAT from the fp32 model (its weights and BN statistics; fresh
    quantizers calibrated on the first batch); returns (eval metrics, the
    trained model).  ref: example/quantization/RootQ_train.py:23-106."""
    device = next(model.parameters()).device
    qmodel = attach_scheme(copy.deepcopy(model).eval(), qat_scheme(family))
    calibrate(qmodel, [_first_batch(train_l, device)])
    opt, sched = qat_optimizer(qmodel, len(train_l), epochs, lr, alpha_lr)
    with deterministic():
        QATTrainer(qmodel, opt, sched, train_l, eval_l,
                   config={"epochs": epochs, "monitor": "max val_accuracy",
                           "update_qparams_period": 0},
                   loss="cross_entropy", metrics=("accuracy",),
                   logger=logger).train()
    return evaluate(qmodel, eval_l, loss_fn, metrics, qmode="eval"), qmodel


def train_fp(model, train_l, eval_l, epochs: int, lr: float = 0.1,
             logger=None):
    """fp32 training in place; returns (model, seconds)."""
    steps = len(train_l) * epochs
    sched = CosineDecayLR(lr, total_steps=steps, warmup_steps=len(train_l))
    opt = build_optimizer(model.named_parameters(), "sgd", sched,
                          momentum=0.9, weight_decay=1e-4)
    trainer = Trainer(model, opt, sched, train_l, eval_l,
                      config={"epochs": epochs,
                              "monitor": "max val_accuracy"},
                      loss="cross_entropy", metrics=("accuracy",),
                      logger=logger)
    t0 = time.perf_counter()
    with deterministic():
        trainer.train()
    _sync(model)
    return model.eval(), time.perf_counter() - t0


def ptq(model, cal_batches, eval_loader, bits, loss_fn, metrics,
        recon_iters, recon=None, fp_model=None, wtype="minmax_channel",
        logger=None):
    """A copy of ``model`` under :func:`w_scheme`, calibrated with one
    observe pass a batch, reconstructed with the first layer's activation
    quant off, evaluated in fake quant.  Returns (metrics, quantized
    model, the trainer's result with ``calibrated``: the metrics of the
    calibrated model with the first layer's activation quant off, before
    any BN refresh and reconstruction)."""
    qmodel = attach_scheme(copy.deepcopy(model).eval(),
                           w_scheme(bits, recon, wtype))
    calibrate(qmodel, cal_batches, observe_passes=len(cal_batches))
    trainer = FSPTQTrainer(qmodel, fp_model or model, cal_batches,
                           iters=recon_iters, disable_first_act_quant=True,
                           logger=logger)
    calibrated = evaluate(qmodel, eval_loader, loss_fn, metrics, qmode="eval")
    out = trainer.train()
    m = evaluate(qmodel, eval_loader, loss_fn, metrics, qmode="eval")
    return m, qmodel, {**out, "calibrated": calibrated}


def fp_model(name: str, train_l, eval_l, args, device, n_classes: int,
             logger=None):
    """The section's fp32 model from ``--seed``, trained by
    :func:`train_fp`; returns (model, its training seconds)."""
    model = get_model(name, device=device, num_classes=n_classes,
                      generator=torch.Generator().manual_seed(args.seed))
    return train_fp(model, train_l, eval_l, args.epochs, logger=logger)


def cal_set(train_l, device) -> List[torch.Tensor]:
    """The training loader's first batches, until ``CAL_IMAGES`` images."""
    batches, seen = [], 0
    for x, _ in train_l:
        batches.append(torch.from_numpy(x).to(device))
        seen += len(x)
        if seen >= CAL_IMAGES:
            break
    return batches


def _sync(model) -> None:
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pct(m: Dict) -> float:
    return 100.0 * m["accuracy"]


def _gate(out: Dict) -> Dict:
    blocks = out["blocks"]
    return {"kept": sum(b["kept"] for b in blocks), "blocks": len(blocks),
            "agreement": tuple(out["agreement"]),
            "calibrated": _pct(out["calibrated"])}


def section_resnet(train_l, eval_l, args, device, n_classes: int,
                   logger=None) -> Dict:
    """Section 1: cifar_resnet20 fp32 → W8A8, W4A8, W4A8 + AdaRound."""
    loss_fn, metrics = get_loss("cross_entropy"), {
        "accuracy": get_metric("accuracy")}
    model, train_s = fp_model("cifar_resnet20", train_l, eval_l, args,
                              device, n_classes, logger)
    fp = _pct(evaluate(model, eval_l, loss_fn, metrics, qmode="fp"))
    cal = cal_set(train_l, device)
    rows = []
    for label, ref, bits, recon, wtype in (
            ("W8A8 FSPTQ", "W8A8", 8, None, "minmax_channel"),
            ("W4A8 FSPTQ (minmax, round)", "W4A8", 4, None,
             "minmax_channel"),
            ("W4A8 FSPTQ (l2loss clip + AdaRound)", "W4A8 AdaRound", 4,
             "adaround", "l2loss_channel")):
        t0 = time.perf_counter()
        m, _, out = ptq(model, cal, eval_l, bits, loss_fn, metrics,
                        args.recon_iters, recon=recon, wtype=wtype,
                        logger=logger)
        _sync(model)
        rows.append({"label": label, "ref": REFERENCE[ref], "top1": _pct(m),
                     "seconds": time.perf_counter() - t0, **_gate(out)})
    return {"model": model, "fp32": fp, "train_s": train_s, "rows": rows}


def section_qat(resnet: Dict, train_l, eval_l, args, device,
                logger=None) -> Dict:
    """Section 1's QAT rows: LSQ and RootQ W4A4 from its fp32 model."""
    loss_fn, metrics = get_loss("cross_entropy"), {
        "accuracy": get_metric("accuracy")}
    rows, models = [], {}
    for label, family in (("LSQ W4A4 QAT", None),
                          ("RootQ W4A4 QAT", "RootQ")):
        t0 = time.perf_counter()
        m, qmodel = qat(resnet["model"], train_l, eval_l, family,
                        args.qat_epochs, loss_fn, metrics, logger=logger)
        _sync(qmodel)
        rows.append({"label": label, "ref": REFERENCE[family or "LSQ"],
                     "top1": _pct(m),
                     "seconds": time.perf_counter() - t0})
        models[family or "LSQ"] = qmodel
    out = {"rows": rows, "models": models}
    if device.type == "cuda":
        x = _first_batch(eval_l, device)[:COMPARE_IMAGES]
        out["rootq_card_vs_cpu"] = card_vs_cpu(models["RootQ"], x)
    return out


def section_repvgg(train_l, eval_l, args, device, n_classes: int,
                   logger=None) -> Dict:
    """Section 2: RepVGG-A0 fp32 → repvgg_fuse → W8A8 FSPTQ, then
    ``prepare_deploy`` and the integer paths."""
    loss_fn, metrics = get_loss("cross_entropy"), {
        "accuracy": get_metric("accuracy")}
    model, train_s = fp_model("RepVGG_A0", train_l, eval_l, args, device,
                              n_classes, logger)
    dmodel = repvgg_fuse(model).eval()
    fp = _pct(evaluate(dmodel, eval_l, loss_fn, metrics, qmode="fp"))
    cal = cal_set(train_l, device)
    t0 = time.perf_counter()
    m8, qmodel, out = ptq(dmodel, cal, eval_l, 8, loss_fn, metrics,
                          args.recon_iters, logger=logger)
    _sync(qmodel)
    recon_s = time.perf_counter() - t0
    x8 = cal[0][:COMPARE_IMAGES]
    res = {"fp32": fp, "train_s": train_s, "recon_s": recon_s, "x8": x8,
           **_gate(out)}
    if device.type == "cuda":
        res["card_vs_cpu"] = card_vs_cpu(qmodel, x8)
    prepare_deploy(qmodel)
    with torch.inference_mode(), LaunchRecorder() as rec:
        qmodel(x8, qmode="intc")
    res["conv_calls"] = rec.counts()["conv"]
    rows = [{"label": "W8A8 FSPTQ (fake-quant eval)", "ref": REFERENCE["eval"],
             "top1": _pct(m8), "calibrated": res["calibrated"]}]
    for label, qmode in (("W8A8 FSPTQ (real int8 execution, 'int')", "int"),
                         ("W8A8 FSPTQ (chained int8-resident, 'intc')",
                          "intc")):
        before = int8_conv.int8_conv3x3.launches
        t0 = time.perf_counter()
        m = evaluate(qmodel, eval_l, loss_fn, metrics, qmode=qmode)
        _sync(qmodel)
        rows.append({"label": label, "ref": REFERENCE[qmode],
                     "top1": _pct(m), "seconds": time.perf_counter() - t0,
                     "launches": int8_conv.int8_conv3x3.launches - before})
    res["batches"] = len(eval_l)
    res["rows"] = rows
    res["qmodel"] = qmodel
    return res


def _table(fp: float, ref_fp: float, rows, extra=()) -> str:
    """Markdown rows: top-1, Δ, RESULTS.md's Δ, and ``extra`` columns."""
    head = "| model | top-1 % | Δ vs fp32 | RESULTS.md Δ (JAX) |"
    head += "".join(f" {name} |" for name, _ in extra)
    lines = [head, "|---" * (4 + len(extra)) + "|",
             f"| fp32 | {fp:.2f} | — | — (fp32 {ref_fp:.2f}) |"
             + " — |" * len(extra)]
    for r in rows:
        lines.append(f"| {r['label']} | {r['top1']:.2f} | "
                     f"{r['top1'] - fp:+.2f} | {r['ref']:+.2f} |"
                     + "".join(f" {fn(r)} |" for _, fn in extra))
    return "\n".join(lines)


def _criterion(delta: float) -> str:
    return "**met**" if delta >= -0.5 else "**not met**"


def render(results: Dict, args, backend: str, stamp: str) -> str:
    """The Markdown sections of ``results`` (RESULTS.md's layout)."""
    out = []
    if "resnet" in results:
        r = results["resnet"]
        gate = ("gate kept", lambda row: f"{row['kept']}/{row['blocks']}")
        agree = ("agreement", lambda row: "{:.4f} → {:.4f}".format(
            *row["agreement"]))
        secs = ("s", lambda row: f"{row['seconds']:.1f}")
        cal = ("calibrated, before recon", lambda row:
               f"{row['calibrated']:.2f}")
        w8 = r["rows"][0]["top1"] - r["fp32"]
        out.append(f"""
## cifar_resnet20 — fp32 vs FSPTQ PTQ, PyTorch port ({stamp})

Dataset: {DATASET}.
Backend: {backend}.
Protocol: {args.epochs}-epoch fp32 train (SGD, momentum 0.9, cosine
decay, 1-epoch warmup, wd 1e-4, batch {args.batch}, default precision:
TF32 convs on the card; {r['train_s']:.1f} s) → {CAL_IMAGES}-image
calibration → BN statistics re-estimated under quantization and the
quantizers re-calibrated → FSPTQ block reconstruction ({args.recon_iters}
iterations a block, first-conv act quant off, 25 % held-out best iterate,
per-block teacher-agreement gate) → top-1 on the held-out split, in full
f32.  Each row's seconds: calibration, reconstruction, evaluation; its
top-1 after calibration, before the BN refresh and reconstruction, beside
it.  Initial weights from seed {args.seed}.

{_table(r['fp32'], REFERENCE['fp32_resnet'], r['rows'],
        (cal, gate, agree, secs))}

North-star criterion: W8A8 Δ ≥ -0.50 → {_criterion(w8)}.
""")
    if "qat" in results:
        q = results["qat"]
        fp = results["resnet"]["fp32"]
        secs = ("s", lambda row: f"{row['seconds']:.1f}")
        card = ("" if "rootq_card_vs_cpu" not in q else
                "\nRootQ W4A4 eval logits, card against CPU on {} held-out "
                "images: relative L2 {:.3e}; the worst quantized layer fed "
                "the card's input {:.3e}.\n".format(
                    COMPARE_IMAGES, *q["rootq_card_vs_cpu"]))
        out.append(f"""
## cifar_resnet20 — QAT W4A4: LSQ vs RootQ, PyTorch port ({stamp})

Dataset: {DATASET}.
Backend: {backend}.
Protocol: warm start from the Section-1 fp32 model → calibrate on the
first batch → {args.qat_epochs}-epoch QAT (SGD, momentum 0.9, lr 0.01
cosine with half an epoch of warmup, wd 1e-4; wt_alpha group lr 0.01
cosine, no wd), final model → top-1 on the held-out split (eval, full
f32).  W4A4: first conv and head at 8 bits.

{_table(fp, REFERENCE['fp32_resnet'], q['rows'], (secs,))}
{card}""")
    if "repvgg" in results:
        r = results["repvgg"]
        secs = ("s", lambda row: "{:.1f}".format(row["seconds"])
                if "seconds" in row else "—")
        launches = ("conv launches a batch", lambda row: "—"
                    if "launches" not in row
                    else f"{row['launches'] / r['batches']:g}")
        card = ("" if "card_vs_cpu" not in r else
                " Reconstructed model's eval logits, card against CPU on {} "
                "calibration images: relative L2 {:.3e}; the worst "
                "quantized layer fed the card's input {:.3e}.".format(
                    COMPARE_IMAGES, *r["card_vs_cpu"]))
        cal = ("calibrated, before recon", lambda row:
               f"{row['calibrated']:.2f}" if "calibrated" in row else "—")
        w8 = min(row["top1"] for row in r["rows"]) - r["fp32"]
        out.append(f"""
## RepVGG_A0 — branch-fuse → FSPTQ W8A8, PyTorch port ({stamp})

Dataset: {DATASET}.  Input 32×32.
Backend: {backend}.
Protocol: {args.epochs}-epoch fp32 train of the 3-branch train form
(as Section 1; {r['train_s']:.1f} s) → repvgg_fuse → {CAL_IMAGES}-image
calibration → FSPTQ block reconstruction ({args.recon_iters} iterations
a block, the stem weight-only; {r['recon_s']:.1f} s with the fake-quant
evaluation) → top-1 (full f32).  The gate kept {r['kept']}/{r['blocks']}
blocks; teacher agreement {r['agreement'][0]:.4f} →
{r['agreement'][1]:.4f}.{card}  prepare_deploy, then the same model in
real int8 ('int') and chained int8 ('intc'): {r['conv_calls']} int8 3×3
conv calls a forward; on the card each is a launch of
int8_conv3x3.cu.  Initial weights from seed {args.seed}.

{_table(r['fp32'], REFERENCE['fp32_repvgg'], r['rows'],
        (cal, launches, secs))}

North-star criterion: W8A8 Δ ≥ -0.50 in every row → {_criterion(w8)}.
""")
    return "".join(out)


def table_values(results: Dict) -> List[float]:
    """Every number of the tables (top-1s and agreements)."""
    vals = []
    for key in ("resnet", "repvgg"):
        if key in results:
            vals.append(results[key]["fp32"])
            vals += [row["top1"] for row in results[key]["rows"]]
            vals += [row["calibrated"] for row in results[key]["rows"]
                     if "calibrated" in row]
            if key == "resnet":
                vals += [a for row in results[key]["rows"]
                         for a in row["agreement"]]
            else:
                vals += list(results[key]["agreement"])
    if "qat" in results:
        vals += [row["top1"] for row in results["qat"]["rows"]]
    return vals


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--qat-epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--recon-iters", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0,
                    help="the models' initial weights (the data's seed "
                         "stays the JAX package's)")
    ap.add_argument("--out", default="RESULTS_torch.md")
    ap.add_argument("--skip-resnet", action="store_true")
    ap.add_argument("--skip-repvgg", action="store_true")
    ap.add_argument("--skip-qat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    return ap.parse_args(argv)


def loaders(args):
    """The hard synthetic CIFAR's training and held-out loaders."""
    kw = {"synthetic_profile": "hard", "_n_classes": 100}
    return (CIFAR10(batch_size=args.batch, training=True, **kw),
            CIFAR10(batch_size=args.batch, training=False, **kw))


def run(args, train_l, eval_l, logger=None) -> Dict:
    """The sections ``args`` asks for, on the given loaders."""
    device = resolve_device(args.device)
    results = {}
    if not args.skip_resnet:
        results["resnet"] = section_resnet(train_l, eval_l, args, device,
                                           100, logger)
        if not args.skip_qat:
            results["qat"] = section_qat(results["resnet"], train_l, eval_l,
                                         args, device, logger)
    if not args.skip_repvgg:
        results["repvgg"] = section_repvgg(train_l, eval_l, args, device,
                                           100, logger)
    return results


def write(results: Dict, args, backend: str) -> str:
    """Append the sections to ``args.out``; returns them."""
    text = render(results, args, backend, time.strftime("%Y-%m-%d %H:%M"))
    out = Path(args.out)
    header = ("# RESULTS_torch — measured accuracy evidence of the PyTorch "
              "port\n")
    out.write_text((out.read_text() if out.exists() else header) + text)
    return text


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if Path(args.out).resolve().name == "RESULTS.md":
        raise SystemExit("RESULTS.md holds the JAX package's results; "
                         "write the port's elsewhere (--out)")
    logger = setup_logging(None, name="accuracy_protocol")
    backend = card_line() if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    results = run(args, *loaders(args), logger=logger)
    text = write(results, args, backend)
    print(text)
    bad = [v for v in table_values(results) if not math.isfinite(v)]
    print(f"appended to {args.out} ({time.perf_counter() - t0:.1f} s on "
          f"{backend})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
