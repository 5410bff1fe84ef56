#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: RepVGG-A0 chained int8.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   the int8 3x3 conv kernel from dlmc_quant_torch/ops/cuda/csrc
             with nvcc (prints the build seconds and ptxas' report);
  2. kernel  RepVGG-A0 deploy form at 224x224, full width, seeded random
             weights, calibrated on one seeded batch (FSPTQ W8A8 with
             AdaRound decisions) and prepared for integer execution.  At
             batch 8 and at the serving batch, every one of the 22 convs
             runs through the kernel and through its plain PyTorch version
             on the same input codes; codes and f32 outputs must be equal
             (tolerance 0: both compute an exact int32 accumulator and the
             same two f32 ops).  Per conv: shape, max |diff|, kernel ms
             (CUDA events, median of 20), bound ms, plain ms;
  3. serve   make_serving_fn(model, qmode="intc") answers 6 requests of
             256 random images; the logits must be finite, (256, 1000),
             agree with the same model run on the CPU (plain path) on 8
             images, and the kernel must have launched 22 times a request.
The last lines: one JSON line of kernel figures, the card's name and power
limit, and {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from dlmc_quant_torch import (calibrate, get_model, make_serving_fn,
                              prepare_deploy, scheme_from_dict)
from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.quant.chain import fold_params, qrelu

SIZE, CLASSES, SEED = 224, 1000, 0
CAL_BATCH, SERVE_BATCH, REQUESTS, REPS = 32, 256, 6, 20
PEAK_INT8_OPS, PEAK_BYTES = 1979e12, 3.35e12   # H100 SXM data sheet
SCHEME = {
    "quantization_type": "FSPTQ",
    "weight": {"enable": True, "type": "minmax_channel",
               "recon_type": "adaround",
               "args": {"n_bits": 8, "signed": True}},
    "input": {"enable": True, "type": "minmax_tensor",
              "args": {"n_bits": 8, "signed": False}},
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def images(n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, SIZE, SIZE, 3), generator=g).to(device)


def event_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def conv_calls(model, x):
    """The 22 conv launches of one chained forward of ``x``, each as
    (name, args, kwargs), with the kernel's own output as the next input."""
    convs = [getattr(model, n).reparam for n in model.block_names]
    codes = convs[0]._input_codes(x)
    calls = []
    for i, conv in enumerate(convs):
        de = qrelu(conv.deferred(codes))
        if i + 1 < len(convs):
            h = convs[i + 1].plan_scalars
            a, b, lo, hi = fold_params(de, h["in_inv_scale"], h["in_qbias"],
                                       -128, 127)
            kw = dict(lo=lo, hi=hi, mode="codes")
        else:
            a, b, kw = de.scale, de.bias, dict(mode="f32", relu=True)
        kw.update(stride=de.acc.stride, pad=de.acc.pad)
        args = (de.acc.x, de.acc.weight, a.contiguous(), b.contiguous())
        calls.append((model.block_names[i], args, kw))
        if i + 1 < len(convs):
            codes = K.int8_conv3x3(*args, **kw)
    return calls


def bound(args, kw):
    """(bound ms, ops ms, bytes ms) of one conv: int8 MACs over the peak
    int8 rate, bytes (inputs read once, output written once) over HBM."""
    x, w, a, _ = args
    n, h, wd, c = x.shape
    o = a.shape[0]
    ho, wo = K.out_hw(h, wd, kw["stride"])
    macs = n * ho * wo * o * 9 * c
    out_bytes = n * ho * wo * o * (1 if kw["mode"] == "codes" else 4)
    nbytes = x.numel() + 9 * c * o + 8 * o + out_bytes
    t_ops = 2 * macs / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def kernel_phase(model, batch: int, device):
    """Kernel vs plain on every conv of one forward; returns the totals."""
    print(f"# kernel vs plain, batch {batch}: name in-shape C->O s | "
          "max|dcode| max|df32| | kernel_ms bound_ms plain_ms "
          "bf16_conv_ms(context, not the same function)")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
               bytes_ms=0.0, err=0.0, context_ms=0.0)
    with torch.inference_mode():
        calls = conv_calls(model, images(batch, SEED + 1, device))
        for name, args, kw in calls:
            got = K.int8_conv3x3(*args, **kw)
            want = K.int8_conv3x3_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            # the f32 epilogue on the same accumulator
            x, w, _, _ = args
            conv = getattr(model, name).reparam
            f32 = dict(stride=kw["stride"], pad=kw["pad"], mode="f32",
                       relu=True)
            f32_args = (x, w, conv.epi_scale, conv.bias_eff)
            err_f = float((K.int8_conv3x3(*f32_args, **f32)
                           - K.int8_conv3x3_plain(*f32_args, **f32))
                          .abs().max())
            ms = event_ms(lambda: K.int8_conv3x3(*args, **kw), REPS)
            plain_ms = event_ms(lambda: K.int8_conv3x3_plain(*args, **kw),
                                REPS)
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            wb = conv.weight.to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            context_ms = event_ms(
                lambda: F.conv2d(xb, wb, stride=kw["stride"], padding=1),
                REPS)
            b_ms, t_ops, t_bytes = bound(args, kw)
            print(f"{name:10s} {tuple(x.shape)} {x.shape[-1]}->"
                  f"{args[2].shape[0]} s{kw['stride']} {kw['mode']:5s} | "
                  f"{err:g} {err_f:g} | {ms:.4f} {b_ms:.4f} {plain_ms:.4f} "
                  f"{context_ms:.4f}")
            if err != 0 or err_f != 0:
                raise RuntimeError(f"{name}: kernel and plain version differ "
                                   f"(codes {err}, f32 {err_f})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b_ms), ("ops_ms", t_ops),
                             ("bytes_ms", t_bytes),
                             ("context_ms", context_ms)):
                tot[key] += val
            tot["err"] = max(tot["err"], err, err_f)
    print(f"# batch {batch} totals over 22 convs: kernel {tot['ms']:.4f} ms, "
          f"bound {tot['bound_ms']:.4f} ms (ops {tot['ops_ms']:.4f}, bytes "
          f"{tot['bytes_ms']:.4f}), plain {tot['plain_ms']:.4f} ms, "
          f"bf16 conv context {tot['context_ms']:.4f} ms")
    print(f"# library_ms: none - no PyTorch call computes an int8 conv on "
          f"CUDA; a bf16 F.conv2d of the same shapes takes "
          f"{tot['context_ms']:.4f} ms (context only, not the same function)")
    return tot


def serve_phase(model, device, card: str):
    """The main path: chained int8 serving through make_serving_fn."""
    cpu_model = copy.deepcopy(model).cpu()
    serve = make_serving_fn(model, qmode="intc", device=device)
    x = images(SERVE_BATCH, SEED + 2, device)
    K.int8_conv3x3.launches = 0
    torch.cuda.synchronize()
    times = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        y = serve(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = K.int8_conv3x3.launches
    if launches != 22 * REQUESTS:
        raise RuntimeError(f"{launches} kernel launches for {REQUESTS} "
                           f"requests, expected {22 * REQUESTS}")
    if y.shape != (SERVE_BATCH, CLASSES) or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"bad logits: {tuple(y.shape)}")
    with torch.inference_mode():
        ref = cpu_model(x[:8].cpu(), qmode="intc")
    rel = float((y[:8].cpu() - ref).norm() / (ref.norm() + 1e-9))
    print(f"# serve: logits {tuple(y.shape)} finite; vs CPU plain path on 8 "
          f"images: rel L2 {rel:.3e}; launches {launches} = 22 x {REQUESTS}")
    if rel >= 2e-2:
        raise RuntimeError(f"GPU and CPU logits differ: rel L2 {rel}")
    steady = statistics.median(times[1:])
    print(f"# serve: batch {SERVE_BATCH} request {steady * 1e3:.3f} ms "
          f"median (first {times[0] * 1e3:.1f} ms); "
          f"{SERVE_BATCH / steady:.1f} images/s on {card}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    K.build(verbose=True)
    print(f"# build: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model = get_model("RepVGG_A0", device=device, num_classes=CLASSES,
                      deploy=True, scheme=scheme_from_dict(SCHEME),
                      generator=torch.Generator().manual_seed(SEED))
    calibrate(model, [images(CAL_BATCH, SEED, device)])
    prepare_deploy(model)
    print(f"# model: RepVGG-A0 deploy form, calibrate (batch {CAL_BATCH}) + "
          f"prepare_deploy in {time.perf_counter() - t0:.2f} s")

    err8 = kernel_phase(model, 8, device)["err"]
    tot = kernel_phase(model, SERVE_BATCH, device)
    launches = serve_phase(model, device, card)

    print(json.dumps({"kernels": [{
        "name": "int8_conv3x3", "route": "cuda",
        "source": "dlmc_quant_torch/ops/cuda/csrc/int8_conv3x3.cu",
        "replaces": "dlmc_quant_tpu/ops/pallas/rpconv.py:200",
        "launches": launches, "max_abs_err": max(err8, tot["err"]),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                     else "bytes"),
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
