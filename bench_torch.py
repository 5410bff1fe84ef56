#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one CUDA card: int8 images/s
of RepVGG-A0 (deploy form) against float forwards of the same model.

    python3 bench_torch.py

The counterpart of ``bench.py`` (same model, scheme, batch, calibration and
keys).  Prints ONE JSON line:

    {"metric": "...", "value": N, "unit": "images/sec/chip",
     "vs_baseline": N, "extra": {...}}

``value`` is the chained int8 path (the faster of ``make_serving_fn``'s
``"intc"`` and ``"int"``) at batch 512; ``vs_baseline`` divides it by the
same deploy-form model's ``"fp"`` forward at PyTorch's defaults (cuDNN
convs in TF32).  Every form is served as ``bench.py`` jits it: through
``make_serving_fn``'s graphed function, one CUDA graph a form captured at
its first request and replayed after (the float forms' settings, strict
float32 or bf16 autocast, in force at their capture).  ``extra`` sets it beside strict float32 (``full_f32``:
TF32 off, deterministic cuDNN) and bf16 autocast, carries ResNet-50 at
batch 256 (``resnet50_int8_*``, bench.py's second headline), bench.py's
extras MobileOne-S1 and MobileNetV2 at batch 256 (``mobileone_s1_int8_*``,
``mobilenet_v2_int8_*``: the deploy form, as bench.py benches it),
MobileOne-S1 with every weight at 4 bits (``mobileone_s1_w4a8_*``:
bench.py's ``_scheme(w_bits=4)``, the weights nibble-packed in device
memory and unpacked in the kernels) and RepVGG-D2se at batch 64
(``repvgg_d2se_int8_*``: its 48 convs in f32 mode, each closed by its SE
block, whose two dense layers are ``torch._int_mm``).

The float baseline is not handicapped: the activations stay NHWC, whose
NCHW view is channels_last, and the fp model's weights are converted to
channels_last once, so cuDNN runs each conv on them as they lie; one fp
request is profiled and the layout-transform kernels it runs are counted
(``fp32_layout_kernels``).  Before any timing every launch of one int8
request of each model is held against its plain version (tolerance 0);
a mismatch exits non-zero.  Those launches are then replayed back to back
in a CUDA graph: ``int8_kernels_ms`` (A0's 22 convs at batch 512) and
``<key>_kernels_ms`` of the other models are their device ms.

Timing: per form, 3 warm-up requests, then interleaved rounds (int8, fp32,
strict f32, bf16) of 30 back-to-back requests between two CUDA events, best
of 3 rounds per form.  There is no fence to subtract.
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
import sys

import torch

from dlmc_quant_torch import (calibrate, get_model, make_serving_fn,
                              prepare_deploy, scheme_from_dict)
from dlmc_quant_torch.quant.layers import full_f32
from dlmc_quant_torch.utils.launches import KERNELS, check_request
from dlmc_quant_torch.utils.profiling import card_line, graph_ms

BATCH = 512          # bench.py:50
ITERS, WARMUP, ROUNDS = 30, 3, 3
SIZE, CLASSES, SEED = 224, 1000, 0
RESNET50_BATCH = 256  # bench.py:189-190
# bench.py's other models (bench.py:186-207): key, registry name, weight
# bits, batch, the launches of one int8 request (3x3 convs, GEMMs,
# im2cols, stem convs + pools, depthwise convs, window sums)
LAUNCHES = dict(conv=0, gemm=0, im2col=0, stem_pool=0, dwconv=0,
                window_sum=0)
EXTRAS = (("resnet50_int8", "resnet50", 8, RESNET50_BATCH,
           dict(LAUNCHES, conv=16, gemm=36, stem_pool=2)),
          ("mobileone_s1_int8", "mobileone_s1", 8, 256,
           dict(LAUNCHES, conv=1, gemm=21, dwconv=21)),
          ("mobileone_s1_w4a8", "mobileone_s1", 4, 256,
           dict(LAUNCHES, conv=1, gemm=21, dwconv=21)),
          ("repvgg_d2se_int8", "RepVGG_D2se", 8, 64,
           dict(LAUNCHES, conv=48)),
          ("mobilenet_v2_int8", "mobilenet_v2", 8, 256,
           dict(LAUNCHES, conv=1, gemm=39, dwconv=17)))
LAYOUT_KERNEL = re.compile(r"nchwToNhwc|nhwcToNchw|copy|transpose", re.I)


def scheme(w_bits: int = 8):
    """bench.py:_scheme: FSPTQ, per-channel ``w_bits`` weights, per-tensor
    unsigned int8 activations."""
    return scheme_from_dict({
        "quantization_type": "FSPTQ",
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": w_bits, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}}})


def prep(name: str, batch: int, device, w_bits: int = 8):
    """bench.py:_prep: the deploy form with seeded weights, uniform inputs,
    calibrated on the first 8 images, prepared for integer execution."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model(name, device=device, num_classes=CLASSES, deploy=True,
                      scheme=scheme(w_bits), generator=gen)
    x = torch.rand((batch, SIZE, SIZE, 3), generator=gen).to(device)
    calibrate(model, [x[:8]])
    return prepare_deploy(model), x


def one_round(fn, x, iters: int = ITERS) -> float:
    """images/s of ``iters`` back-to-back requests between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    end.synchronize()
    return x.shape[0] * iters / (start.elapsed_time(end) * 1e-3)


def best_of_rounds(fns, x):
    """Interleaved best-of-ROUNDS images/s for each of ``fns`` (a dict)."""
    for fn in fns.values():
        for _ in range(WARMUP):
            fn(x)
    torch.cuda.synchronize()
    best = dict.fromkeys(fns, 0.0)
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            best[name] = max(best[name], one_round(fn, x))
    return best


class Under(torch.nn.Module):
    """``model``'s forward under ``settings()`` (a context manager): a
    graph captures the settings in force while it is captured."""

    def __init__(self, model, settings):
        super().__init__()
        self.model, self.settings = model, settings

    def forward(self, x, qmode: str = "fp"):
        with self.settings():
            return self.model(x, qmode=qmode)


def float_forms(model, device, graph=None):
    """The fp forwards of ``model``, each graphed unless ``graph=False``:
    PyTorch's defaults, strict float32 and bf16 autocast, on a copy whose
    weights are channels_last."""
    fp_model = copy.deepcopy(model).to(memory_format=torch.channels_last)
    # autocast's cache of cast weights is off: a graph keeps no tensor
    # that the end of its capture frees
    settings = {"fp32": contextlib.nullcontext, "fp32_strict": full_f32,
                "bf16": lambda: torch.autocast("cuda", dtype=torch.bfloat16,
                                               cache_enabled=False)}
    return {name: make_serving_fn(Under(fp_model, ctx), qmode="fp",
                                  device=device, graph=graph)
            for name, ctx in settings.items()}


def layout_kernels(fn, x):
    """Kernels of one request whose names say they move a layout, by name
    with their counts (torch.profiler on the card)."""
    fn(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(x)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    print(f"# fp request kernels ({len(kernels)} names): " + "; ".join(
        f"{k[:60]} x{n}" for k, n in sorted(kernels.items(),
                                            key=lambda kv: -kv[1])[:12]),
          file=sys.stderr)
    if not kernels:
        raise RuntimeError("the profiler saw no CUDA kernel")
    return {k: n for k, n in kernels.items() if LAYOUT_KERNEL.search(k)}


def replay(calls):
    for kind, args, kw, _ in calls:
        KERNELS[kind][0](*args, **kw)


def bench_model(name: str, batch: int, device, expect, w_bits: int = 8):
    """(images/s by form, int8 qmode, layout kernels of one fp request,
    device ms of one int8 request's launches)."""
    model, x = prep(name, batch, device, w_bits)
    calls = check_request(model, x, expect)
    with torch.inference_mode():
        kernels_ms = graph_ms(lambda _: replay(calls), 4)
    del calls
    print(f"# {name} W{w_bits}: the {sum(expect.values())} launches of one "
          "int8 "
          f"request at batch {batch} each equal their plain version; "
          f"{kernels_ms:.4f} ms back to back", file=sys.stderr)
    int_fns = {qm: make_serving_fn(model, qmode=qm, device=device)
               for qm in ("intc", "int")}
    # graphed == eager, bit for bit, before any timing
    for qm, fn in int_fns.items():
        eager = make_serving_fn(model, qmode=qm, device=device, graph=False)
        if not torch.equal(fn(x), eager(x)):
            raise RuntimeError(f"{name}: the graphed {qm} request differs "
                               "from the eager one")
    for fn in int_fns.values():
        fn(x)
    qmode = max(int_fns, key=lambda qm: one_round(int_fns[qm], x, 16))
    fns = {"int8": int_fns[qmode], **float_forms(model, device)}
    # the kernels one fp request runs, as the host enqueues them eagerly
    layout = layout_kernels(float_forms(model, device, graph=False)["fp32"],
                            x)
    ips = best_of_rounds(fns, x)
    print(f"# {name} batch {batch}: images/s {ips} (int8 = {qmode})",
          file=sys.stderr)
    return ips, qmode, layout, kernels_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    ips, qmode, layout, conv_ms = bench_model(
        "RepVGG_A0", BATCH, device, dict(LAUNCHES, conv=22))
    extra = {"batch": BATCH, "int8_qmode": qmode,
             "fp32_ips": round(ips["fp32"], 1),
             "fp32_strict_ips": round(ips["fp32_strict"], 1),
             "vs_fp32_strict": round(ips["int8"] / ips["fp32_strict"], 3),
             "bf16_ips": round(ips["bf16"], 1),
             "vs_bf16": round(ips["int8"] / ips["bf16"], 3),
             "fp32_layout_kernels": layout,
             "int8_kernels_ms": round(conv_ms, 4)}
    for key, name, w_bits, batch, expect in EXTRAS:
        r_ips, r_qmode, r_layout, r_ms = bench_model(
            name, batch, device, expect, w_bits)
        extra.update({
            f"{key}_ips": round(r_ips["int8"], 1),
            f"{key}_fp32_ips": round(r_ips["fp32"], 1),
            f"{key}_vs_fp32": round(r_ips["int8"] / r_ips["fp32"], 3),
            f"{key}_fp32_strict_ips": round(r_ips["fp32_strict"], 1),
            f"{key}_vs_fp32_strict": round(
                r_ips["int8"] / r_ips["fp32_strict"], 3),
            f"{key}_bf16_ips": round(r_ips["bf16"], 1),
            f"{key}_vs_bf16": round(r_ips["int8"] / r_ips["bf16"], 3),
            f"{key}_batch": batch, f"{key}_qmode": r_qmode,
            f"{key}_fp32_layout_kernels": r_layout,
            f"{key}_kernels_ms": round(r_ms, 4)})
    extra["card"] = card_line()
    extra["timing"] = (f"CUDA events around {ITERS} back-to-back requests, "
                       f"{WARMUP} warm-ups, best of {ROUNDS} interleaved "
                       "rounds")
    print(json.dumps({
        "metric": "repvgg_a0_int8_images_per_sec_per_chip",
        "value": round(ips["int8"], 1),
        "unit": "images/sec/chip",
        "vs_baseline": round(ips["int8"] / ips["fp32"], 3),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
