"""Bounds of the launch groups of PERF.md's kernel table that no phase of
``chip_smoke.py`` prints, and ``torch._int_mm`` beside ResNet-50's codes
and residual GEMMs.

    python -m dlmc_quant_torch.tools.row_bounds [--device cpu] [--size 224]
        [--r50-batch 256] [--rootq-batch 128] [--r20-batch 256]

A bound depends on the shapes, the weight's bits and whether a row term is
added, not on the weights' values: each model is built from seeded
weights, calibrated on 8 seeded images, its RootQ bounds moved apart (a
weight offset, so every layer carries the row term), prepared, and one
request is recorded (``utils.launches.LaunchRecorder``).  Each group sums
``utils.launches.launch_bound`` (each input read and each output written
once; int8 operations at 1,979 TOP/s, bytes at 3.35 TB/s):

* BASELINE config #5: RootQ W4A4 ResNet-50 (the scheme of
  ``examples/configs/RootQ_resnet50_imagenet_w4a4.yaml``), train form in
  ``'intc'`` (run as ``'int'``: f32 epilogues) at ``--rootq-batch``: its
  16 convs and 36 GEMMs with the term, its 52 window sums;
* RootQ W4A4 cifar_resnet20 (``RootQ_resnet20_cifar10_w4a4.yaml``),
  ``'intc'`` at ``--r20-batch``, 32×32: its 18 convs with the term;
* MobileOne-S1's deploy form under the all-W4 scheme (bench.py's
  ``mobileone_s1_w4a8``), ``'intc'`` at ``--r50-batch``: its 21 depthwise
  and 21 GEMM launches;
* ResNet-50's deploy form under the W8A8 scheme, ``'intc'`` at
  ``--r50-batch``: its 16 residual, 16 codes and 4 int32 GEMMs, and on the
  card ``torch._int_mm`` at each group's (M, K, N), the product alone with
  an int32 out (CUDA events, the median of 20 runs of the group).

Prints one line a group, the card's name and power limit first, and a JSON
line last.  ``--device cpu`` (a small ``--size`` and batches) checks the
path; its bounds are of those shapes, and no time is taken.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "examples" / "configs"
SEED = 0


def _images(n, size, device, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, size, size, 3), generator=g).to(device)


def _prepared(model, size, device, spread=False):
    from dlmc_quant_torch.quant.deploy import prepare_deploy
    from dlmc_quant_torch.quant.layers import calibrate

    calibrate(model, [_images(8, size, device)])
    if spread:
        with torch.no_grad():
            for m in model.modules():
                if hasattr(m, "wt_run_upper"):
                    m.wt_run_upper.mul_(1.2)
                    m.wt_run_lower.mul_(0.7)
    return prepare_deploy(model)


def _calls(model, x):
    from dlmc_quant_torch.utils.launches import LaunchRecorder

    with torch.inference_mode(), LaunchRecorder() as rec:
        model(x, qmode="intc")
    return rec.calls


def _group(kind, kw) -> str:
    if kind == "gemm":
        if kw.get("residual") is not None:
            return "gemm residual"
        return f"gemm {kw.get('mode', 'int32')}"
    return kind


def _sums(calls, term: bool = False):
    """{group: (launches, bound ms)}; ``term`` marks the groups of
    launches with a row term."""
    from dlmc_quant_torch.utils.launches import launch_bound

    out = {}
    for kind, a, kw, o in calls:
        name = _group(kind, kw)
        if term and kw.get("row") is not None:
            name += " +row"
        n, ms = out.get(name, (0, 0.0))
        out[name] = (n + 1, ms + launch_bound(kind, a, kw, o)[0])
    return out


def _int_mm_ms(calls, group: str):
    """``torch._int_mm`` at the (M, K, N) of each launch of ``group``:
    the median ms of the group's products run back to back."""
    from dlmc_quant_torch.tools.gemm_sweep import col_major
    from dlmc_quant_torch.utils.profiling import event_ms

    mats = [(a[0], col_major(a[1], a[0].shape[1])) for kind, a, kw, _ in calls
            if kind == "gemm" and _group(kind, kw) == group]
    return event_ms(lambda: [torch._int_mm(x, w) for x, w in mats], 20)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--r50-batch", type=int, default=256)
    p.add_argument("--rootq-batch", type=int, default=128)
    p.add_argument("--r20-batch", type=int, default=256)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass --device cpu to run on the CPU")
    sys.path.insert(0, str(ROOT))
    from dlmc_quant_torch.examples.serve_benchmark import scheme
    from dlmc_quant_torch.models import get_model
    from dlmc_quant_torch.quant.config import scheme_from_dict
    from dlmc_quant_torch.tools.model_axis_2proc import resnet50_deploy_form
    from dlmc_quant_torch.utils.config import read_yaml
    from dlmc_quant_torch.utils.profiling import card_line

    dev = torch.device(args.device)
    card = dev.type == "cuda"
    if card:
        print(card_line(), flush=True)
    gen = torch.Generator().manual_seed(SEED)
    rows = {}

    def report(what, sums):
        for group, (n, bound) in sums.items():
            print(f"{what}: {group}: {n} launches, bound {bound:.4f} ms",
                  flush=True)
        rows[what] = {g: {"launches": n, "bound_ms": b}
                      for g, (n, b) in sums.items()}

    rootq = scheme_from_dict(read_yaml(
        CONFIGS / "RootQ_resnet50_imagenet_w4a4.yaml")["quantization"])
    model = _prepared(get_model("resnet50", device=dev, num_classes=1000,
                                scheme=rootq, generator=gen),
                      args.size, dev, spread=True)
    report(f"config #5 RootQ W4A4 ResNet-50 train form, batch "
           f"{args.rootq_batch}",
           _sums(_calls(model, _images(args.rootq_batch, args.size, dev,
                                       SEED + 1)), term=True))
    del model
    r20 = scheme_from_dict(read_yaml(
        CONFIGS / "RootQ_resnet20_cifar10_w4a4.yaml")["quantization"])
    model = _prepared(get_model("cifar_resnet20", device=dev, num_classes=10,
                                scheme=r20, generator=gen), 32, dev,
                      spread=True)
    report(f"RootQ W4A4 cifar_resnet20, batch {args.r20_batch}",
           _sums(_calls(model, _images(args.r20_batch, 32, dev, SEED + 2)),
                 term=True))
    del model
    model = _prepared(get_model("MobileOne_S1", device=dev, deploy=True,
                                scheme=scheme(4, 8), generator=gen),
                      args.size, dev)
    report(f"MobileOne-S1 all-W4 deploy form, batch {args.r50_batch}",
           _sums(_calls(model, _images(args.r50_batch, args.size, dev,
                                       SEED + 3))))
    del model
    model = resnet50_deploy_form(dev, args.size, SEED, 8)
    calls = _calls(model, _images(args.r50_batch, args.size, dev, SEED + 4))
    what = f"ResNet-50 W8A8 deploy form, batch {args.r50_batch}"
    report(what, _sums(calls))
    if card:
        for group in ("gemm residual", "gemm codes", "gemm int32"):
            ms = _int_mm_ms(calls, group)
            rows[what][group]["int_mm_ms"] = ms
            print(f"{what}: {group}: torch._int_mm at the same (M, K, N), "
                  f"int32 out, {ms:.4f} ms", flush=True)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
