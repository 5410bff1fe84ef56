#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: RepVGG-A0 chained int8,
FSPTQ reconstruction served through the conv kernel, chained int8
cifar_resnet18, BASELINE config #1's PTQ entry, chained int8 ResNet-50,
the training path (LSQ and RootQ QAT, fp32, QAT -> deploy, ResNet-50 RootQ),
then the two int8 GEMM tools.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   the four kernels from dlmc_quant_torch/ops/cuda/csrc (int8
             3x3 conv, int8 GEMM, int8 im2col, int8 MMA probe), one nvcc
             each, all at once (prints the build seconds, ptxas' report of
             registers and spills, and the dynamic shared memory of every
             GEMM tile and of the probe's ring); then the card tests of the
             conv at ragged shapes, the SAME stride-2 geometry, the
             residual epilogue, the GEMM at the ResNet-18 shortcut shapes
             and the GEMM's epilogue modes and the im2col at ragged M,
             every epilogue tile and residual dtype
             (tests/test_torch_int8_conv.py, tests/test_torch_resnet_conv.py
             and tests/test_torch_gemm_epilogue.py, -m cuda), before any
             timing;
  2. kernel  RepVGG-A0 deploy form at 224x224, full width, seeded random
             weights, calibrated on one seeded batch (FSPTQ W8A8 with
             AdaRound decisions) and prepared for integer execution.  At
             batch 8 and at the serving batch, every one of the 22 convs
             runs through the kernel and through its plain PyTorch version
             on the same input codes; codes and f32 outputs must be equal
             (tolerance 0: both compute an exact int32 accumulator and the
             same two f32 ops).  Per conv: shape, tile plan, max |diff|,
             kernel ms (per launch of a CUDA graph of 16, median of 5
             replays: a conv takes about as long as its launch from Python),
             bound ms, kernel / bound, plain ms;
  3. serve   make_serving_fn(model, qmode="intc") answers 6 requests of
             256 random images; the logits must be finite, (256, 1000),
             agree with the same model run on the CPU (plain path) on 8
             images, and the kernel must have launched 22 times a request;
             then the device time of the request's three parts (input
             quantize, the 22 convs, pool + head; CUDA graphs) and what is
             left of the request: host and gaps;
  recon    the flagship's main path: RepVGG-A0 in train form at full width
           (seeded weights, BN statistics from a train-mode forward of the
           first batch, then perturbed), repvgg_fuse, the
           FSPTQ W8A8 scheme attached to a copy, calibrate with one observe
           pass per batch over 256 images of the synthetic ImageNet
           fallback (seed 123, training, batch 64), FSPTQTrainer with its
           defaults but 40 iterations a block and the flagship's
           disable_first_act_quant (the stem weight-only; per target: capture and
           reconstruction ms, steps/s, held-out l2, kept or reverted; the
           teacher agreement before and after, which may not drop; the
           blocks kept with moved parameters); eval-mode logits on 8
           images within relative L2 2e-2 of the same model on the CPU;
           prepare_deploy (the stem's plan: int8 weights only), the 21
           reconstructed convs behind it kernel == plain (tolerance 0,
           batch 8), and one make_serving_fn(qmode="intc") request of 256
           images with 21 launches and one bf16 stem conv (f32 out);
  resnet   cifar_resnet18 at full width (stem 3->64, stages 64/128/256/512,
           10 classes), 32x32: train form with seeded weights and perturbed
           BN statistics -> resnet_deploy -> config #1's scheme
           (examples/configs/PTQ_resnet18_cifar10_w8a8.yaml) -> calibrate
           on one seeded batch -> prepare_deploy.  At batch 8 and 256 every
           conv and GEMM launch of one chained request (the stem in codes
           and in f32, the SAME stride-2 convs, the residual epilogues with
           int8, int32 and f32 shortcuts, the three 1x1 shortcut GEMMs) is
           recorded and held against its plain version on the same inputs
           (tolerance 0); per launch kernel us (CUDA graph of 16), bound us,
           kernel / bound.  Then make_serving_fn(qmode="intc") answers 6
           requests of 256 images: logits finite, (256, 10), within
           relative L2 2e-2 of the CPU plain path on 8 images, 18 conv and
           3 GEMM launches a request (the 512->10 head is torch._int_mm);
           median request ms, images/s, and the request's split into input
           quantize, the 21 kernels, pool + head (CUDA graphs) and the
           rest (host, gaps and the small per-request ops);
  resnet50 ResNet-50 at full width (7x7/s2 stem 3->64, max-pool,
           Bottleneck stages 64/128/256/512 x 4, 1000 classes), 224x224:
           train form with seeded weights and perturbed BN statistics ->
           resnet_deploy -> the bench's W8A8 scheme -> calibrate on one
           seeded batch of 32 -> prepare_deploy.  At batch 8 and 256 every
           launch of one chained request (the stem's im2col and its GEMM
           in int32 mode, the 16 3x3 convs, the 36 1x1 GEMMs in codes,
           residual and int32 modes) against its plain version, tolerance
           0; per launch kernel us (CUDA graph of 16), bound us, kernel /
           bound, and the sums by launch group.  Then
           make_serving_fn(qmode="intc") answers 6 requests of 256 images:
           logits finite, (256, 1000), within relative L2 2e-2 of the CPU
           plain path on 8 images, 16 conv + 37 GEMM + 1 im2col launches a
           request; median request ms, images/s and the request's split
           (input quantize, stem + pool, the 52 other kernels, pool +
           head; CUDA graphs) and the rest (host and gaps);
  qat      the training path (examples/configs): (a) both QAT configs
           (LSQ and RootQ W4A4) at full width through the QAT entry's
           build_trainer (classification's build_common -> calibrate on the
           first batch -> QATTrainer), cut to one epoch over 2048 synthetic
           CIFAR-10 images at the config's batch 128 (14 steps after the
           10 % validation split), one run, nothing saved, under full_f32:
           every step's loss finite, the quantizer parameters (LSQ
           wt_scale; RootQ wt_upper, wt_alpha) moved, the first step's loss
           within 1e-2 relative of the same model and batch on the CPU, and
           after training, in eval mode on 64 validation images, every
           quantized layer fed the card's input to it within relative L2
           1e-4 of its CPU copy (the logits' relative L2 is printed: at 4
           bits a code that flips on a float difference moves every layer
           after it); then ms a step at the default precision (cuDNN TF32)
           split into device time (CUDA events over a CUDA graph of the
           step; the profiler's kernel sum beside it) and host and gaps,
           images/s, peak memory.  (b) the fp32 baseline
           config through the classification entry, the same way.  (c) the
           deploy leg: the LSQ config at 8 bits (weights and inputs; W4 has
           no integer path yet), trained the same way, prepare_deploy, every
           one of the 18 conv launches of a request == plain at batch 8 and
           256, one make_serving_fn(qmode="intc") request of 256 training
           images under full_f32 (the float stem and head): finite
           (256, 10) logits, 18 launches, within relative L2 2e-2 of the
           same deployed model on the CPU plain path; top-1
           agreement with the fake-quant eval forward printed.  (d) BASELINE
           config #5's training leg (RootQ W4A4 ResNet-50 at full width on
           the synthetic ImageNet fallback, 224x224) at batch 64 (the
           config's 256: r50_training_leg(256), by hand): ms a step and
           peak memory;
  ptq      python -m dlmc_quant_torch.examples.post_training_quantization
           on config #1 with eval_int: true (nothing else changed): fp32,
           fake-quant and integer metrics, which must be finite, the
           integer loss within 5 % of the fake-quant one; both kernels
           must have launched; wall time;
  4. gemm    the GEMM-sweep tool's path (gemm_sweep.main: every shape at
             every compiled tile, the default tile marked *,
             each result equal to torch._int_mm's), which must launch the
             GEMM kernel; then at every sweep shape (default tile, printed
             per shape) the kernel against its plain version and
             torch._int_mm, tolerance 0 (integer results are exact).  Per
             shape: kernel ms and library ms (the tool's CUDA-graph
             medians), bound ms, plain ms (CUDA events, median of 3);
  5. probe   the same for the MMA-rate probe's path (mma_probe.main) and
             its shapes, the library call being torch._int_mm on the
             concatenated operands.
The last lines: one JSON line of kernel figures, the card's name and power
limit, and {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from dlmc_quant_torch import (FSPTQTrainer, attach_scheme, calibrate,
                              get_dataloader, get_model, make_serving_fn,
                              prepare_deploy, scheme_from_dict)
from dlmc_quant_torch.examples import classification as fp_entry
from dlmc_quant_torch.examples import post_training_quantization as ptq_entry
from dlmc_quant_torch.examples import quantization_aware_training as qat_entry
from dlmc_quant_torch.models.fuse import repvgg_fuse, resnet_deploy
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.ops.cuda import int8_mma_probe as P
from dlmc_quant_torch.quant.chain import (fold_params, materialize, qmaxpool,
                                          qrelu)
from dlmc_quant_torch.quant.layers import full_f32
from dlmc_quant_torch.tools import gemm_sweep, mma_probe
from dlmc_quant_torch.utils.profiling import (PEAK_BYTES, PEAK_INT8_OPS,
                                              bound_by, card_line, event_ms,
                                              graph_ms, step_split)
from dlmc_quant_torch.utils.checkpoint import load_checkpoint
from dlmc_quant_torch.utils.launches import (KERNELS, LaunchRecorder,
                                             max_diff_to_plain)
from dlmc_quant_torch.utils.config import ConfigParser, read_yaml, write_yaml
from dlmc_quant_torch.utils.logging import get_logger

SIZE, CLASSES, SEED = 224, 1000, 0
CAL_BATCH, SERVE_BATCH, REQUESTS, REPS = 32, 256, 6, 20
PLAIN_REPS = 3
RECON_SAMPLES, RECON_BATCH, RECON_SEED, RECON_ITERS = 256, 64, 123, 40
GRAPH_LAUNCHES = 16
REPO = pathlib.Path(__file__).resolve().parent
CONFIGS = REPO / "examples" / "configs"
CONFIG_1 = CONFIGS / "PTQ_resnet18_cifar10_w8a8.yaml"
CIFAR_SIZE, CIFAR_CLASSES = 32, 10
# launches of one chained request: 3x3 convs, GEMMs, im2cols
RESNET18_LAUNCHES = {"conv": 18, "gemm": 3, "im2col": 0}
RESNET50_LAUNCHES = {"conv": 16, "gemm": 37, "im2col": 1}
# the training path: configs, cuts and what must move
QAT_CONFIGS = {"lsq": "QAT_lsq_resnet20_cifar10_w4a4",
               "rootq": "RootQ_resnet20_cifar10_w4a4"}
QAT_MOVED = {"lsq": ("wt_scale",), "rootq": ("wt_upper", "wt_alpha")}
FP_CONFIG, R50_CONFIG = ("baseline_resnet20_cifar10",
                         "RootQ_resnet50_imagenet_w4a4")
QAT_IMAGES, TIMED_STEPS, EVAL_IMAGES = 2048, 20, 64
R50_BATCH, R50_STEPS = 64, 4
QAT_W8A8_LAUNCHES = {"conv": 18, "gemm": 0, "im2col": 0}
SCHEME = {
    "quantization_type": "FSPTQ",
    "weight": {"enable": True, "type": "minmax_channel",
               "recon_type": "adaround",
               "args": {"n_bits": 8, "signed": True}},
    "input": {"enable": True, "type": "minmax_tensor",
              "args": {"n_bits": 8, "signed": False}},
}
# the bench's W8A8 scheme (bench.py:_scheme): no AdaRound
BENCH_SCHEME = {**SCHEME, "weight": {"enable": True, "type": "minmax_channel",
                                     "args": {"n_bits": 8, "signed": True}}}


def images(n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, SIZE, SIZE, 3), generator=g).to(device)


def card_tests():
    """The conv's and the ResNet path's card tests (ragged shapes, every
    compiled tile, both modes, SAME stride 2, the residual epilogue, the
    shortcut GEMMs, the GEMM's epilogue modes, the im2col), in a process
    of their own; fatal unless all pass."""
    tests = REPO / "tests"
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", str(tests / "test_torch_int8_conv.py"),
         str(tests / "test_torch_resnet_conv.py"),
         str(tests / "test_torch_gemm_epilogue.py")],
        capture_output=True, text=True)
    tail = run.stdout.strip().splitlines()[-1:] or [run.stderr.strip()[-300:]]
    print(f"# card tests of int8_conv3x3 and the ResNet path: {tail[0]}")
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
        raise RuntimeError("the ResNet path's card tests failed")


def conv_calls(model, x):
    """The conv launches of one chained forward of ``x`` (22, or 21 behind
    a weight-only stem, whose bf16 conv runs here), each as (name, args,
    kwargs), with the kernel's own output as the next input."""
    names = list(model.block_names)
    convs = [getattr(model, n).reparam for n in names]
    if convs[0].weight_only:
        x = qrelu(convs[0](x, qmode="intc"))
        names, convs = names[1:], convs[1:]
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
        calls.append((names[i], args, kw))
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
    print(f"# kernel vs plain, batch {batch}: name in-shape C->O s mode "
          "plan(BN x rows, stages, weight) | max|dcode| max|df32| | "
          "kernel_ms bound_ms(by) kernel/bound plain_ms "
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
            ms = graph_ms(lambda i: K.int8_conv3x3(*args, **kw),
                          GRAPH_LAUNCHES)
            plain_ms = event_ms(lambda: K.int8_conv3x3_plain(*args, **kw),
                                PLAIN_REPS)
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            wb = conv.weight.to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            context_ms = event_ms(
                lambda: F.conv2d(xb, wb, stride=kw["stride"], padding=1),
                REPS)
            b_ms, t_ops, t_bytes = bound(args, kw)
            got_hw = got.shape[1] * got.shape[2]
            plan = K.tile_plan(x.shape[0] * got_hw, x.shape[-1],
                               args[2].shape[0], kw["mode"],
                               stride=kw["stride"], width=x.shape[2])
            print(f"{name:10s} {tuple(x.shape)} {x.shape[-1]}->"
                  f"{args[2].shape[0]} s{kw['stride']} {kw['mode']:5s} "
                  f"{plan.bn}x128,{plan.stages},"
                  f"{'resident' if plan.resident else 'streamed'},"
                  f"halo{plan.halo_bufs} | "
                  f"{err:g} {err_f:g} | {ms:.4f} {b_ms:.4f}"
                  f"({bound_by(t_ops, t_bytes)}) {ms / b_ms:.2f} "
                  f"{plain_ms:.4f} {context_ms:.4f}")
            if err != 0 or err_f != 0:
                raise RuntimeError(f"{name}: kernel and plain version differ "
                                   f"(codes {err}, f32 {err_f})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b_ms), ("ops_ms", t_ops),
                             ("bytes_ms", t_bytes),
                             ("context_ms", context_ms)):
                tot[key] += val
            tot["err"] = max(tot["err"], err, err_f)
    print(f"# batch {batch} totals over {len(calls)} convs: kernel "
          f"{tot['ms']:.4f} ms, "
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
    times, enqueue = [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        y = serve(x)
        enqueue.append(time.perf_counter() - t0)   # the host's part
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
          f"{SERVE_BATCH / steady:.1f} images/s on {card}; the host has "
          f"enqueued a request after {statistics.median(enqueue[1:]) * 1e3:.3f}"
          f" ms")
    split_phase(model, x, steady * 1e3)
    return launches


def split_phase(model, x, request_ms: float):
    """Device ms of the request's three parts, each as a CUDA graph (no
    host gaps inside), and what the request takes beyond their sum."""
    convs = [getattr(model, n).reparam for n in model.block_names]
    with torch.inference_mode():
        calls = conv_calls(model, x)

        def run_convs(_):
            for _, args, kw in calls:
                out = K.int8_conv3x3(*args, **kw)
            return out

        feat = run_convs(0)
        quant_ms = graph_ms(lambda i: convs[0]._input_codes(x), 4)
        convs_ms = graph_ms(run_convs, 4)
        head_ms = graph_ms(lambda i: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    rest = request_ms - quant_ms - convs_ms - head_ms
    print(f"# serve split (device ms, CUDA graphs): input quantize "
          f"{quant_ms:.4f}, 22 convs {convs_ms:.4f}, pool + head "
          f"{head_ms:.4f}; request {request_ms:.4f} - their sum = host and "
          f"gaps {rest:.4f} ({100 * rest / request_ms:.1f} % of the request)")


def perturbed_a0(device, x):
    """RepVGG-A0 in train form with seeded weights, BatchNorm statistics
    taken from one train-mode forward of ``x`` (so that every branch's
    output is normalized, as in a trained model) and then perturbed, and
    BN affine parameters moved off their initial values."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model("RepVGG_A0", device=device, num_classes=CLASSES,
                      generator=gen)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 1.0
        model.train()(x, qmode="fp")
        model.eval()
        for bn in bns:
            bn.momentum = 0.1
            for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias):
                t += 0.1 * torch.rand(t.shape, generator=gen).to(device)
    return model


def recon_phase(device, card: str):
    """Calibrate with observe passes → reconstruct → deploy → serve; returns
    the conv launches of the served request and the largest kernel-vs-plain
    difference."""
    t0 = time.perf_counter()
    loader = get_dataloader("ImageNet", data_dir="data/imagenet",
                            batch_size=RECON_BATCH, training=True,
                            n_samples=RECON_SAMPLES, seed=RECON_SEED)
    batches = [torch.from_numpy(x).to(device) for x, _ in loader]
    teacher = repvgg_fuse(perturbed_a0(device, batches[0]))
    student = attach_scheme(copy.deepcopy(teacher), scheme_from_dict(SCHEME))
    t1 = time.perf_counter()
    calibrate(student, batches, observe_passes=len(batches))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"# recon: A0 train form -> repvgg_fuse + {RECON_SAMPLES} synthetic "
          f"images in {t1 - t0:.2f} s; calibrate ({len(batches)} observe "
          f"passes + 1, batch {RECON_BATCH}) {1e3 * (t2 - t1):.1f} ms")
    before = {k: v.clone() for k, v in student.state_dict().items()}
    # the flagship's setting: the stem runs weight-only
    res = FSPTQTrainer(student, teacher, batches, iters=RECON_ITERS,
                       disable_first_act_quant=True).train()
    print(f"# recon: {len(res['blocks'])} targets, {RECON_ITERS} iterations "
          f"each: block capture_ms recon_ms steps/s held-out-l2 kept")
    for b in res["blocks"]:
        print(f"{b['block']:10s} {b['capture_ms']:9.2f} {b['recon_ms']:9.2f} "
              f"{RECON_ITERS / (b['recon_ms'] / 1e3):8.1f} {b['l2']:.6g} "
              f"{'kept' if b['kept'] else 'REVERTED'}")
    cap = sum(b["capture_ms"] for b in res["blocks"])
    rec = sum(b["recon_ms"] for b in res["blocks"])
    print(f"# recon: trainer {time.perf_counter() - t2:.2f} s (capture "
          f"{cap / 1e3:.2f} s, reconstruction {rec / 1e3:.2f} s, "
          f"{len(res['blocks']) * RECON_ITERS / (rec / 1e3):.1f} steps/s) on "
          f"{card}; teacher agreement {res['agreement'][0]:.4f} -> "
          f"{res['agreement'][1]:.4f}")
    state = student.state_dict()
    moved = [b["block"] for b in res["blocks"] if b["kept"] and any(
        not torch.equal(state[k], before[k]) for k in state
        if k.startswith(b["block"] + "."))]
    print(f"# recon: kept and moved: {moved}")
    agree0, agree1 = res["agreement"]
    losses = torch.tensor([b["l2"] for b in res["blocks"]])
    if not (any(b["kept"] for b in res["blocks"]) and agree1 >= agree0
            and bool(torch.isfinite(losses).all())):
        raise RuntimeError("reconstruction broke the gate's contract: "
                           f"agreement {agree0} -> {agree1}, l2 {losses}")

    x8 = batches[0][:8]
    with torch.no_grad(), full_f32():
        y = student(x8, qmode="eval")
        ref = copy.deepcopy(student).cpu()(x8.cpu(), qmode="eval")
    rel = float((y.cpu() - ref).norm() / (ref.norm() + 1e-9))
    print(f"# recon: eval-mode logits, card vs CPU on 8 images: rel L2 "
          f"{rel:.3e}")
    if not rel < 2e-2:
        raise RuntimeError(f"card and CPU eval logits differ: rel L2 {rel}")

    prepare_deploy(student)
    stem = getattr(student, student.block_names[0]).reparam
    if not stem.weight_only:
        raise RuntimeError("the stem is not weight-only after "
                           "disable_first_act_quant")
    err = kernel_phase(student, 8, device)["err"]
    serve = make_serving_fn(student, qmode="intc", device=device)
    x = images(SERVE_BATCH, SEED + 3, device)
    stem_calls = []
    hook = stem.register_forward_hook(
        lambda mod, args, out: stem_calls.append(out.dtype))
    K.int8_conv3x3.launches = 0
    y = serve(x)
    torch.cuda.synchronize()
    launches = K.int8_conv3x3.launches
    hook.remove()
    if launches != 21 or stem_calls != [torch.float32]:
        raise RuntimeError(f"{launches} conv launches and stem outputs "
                           f"{stem_calls} for one request of the "
                           "reconstructed model, expected 21 and one f32")
    if y.shape != (SERVE_BATCH, CLASSES) or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"bad logits: {tuple(y.shape)}")
    print(f"# recon: served the reconstructed model: logits "
          f"{tuple(y.shape)} finite, {launches} conv launches and one bf16 "
          "stem conv (weight-only, f32 out)")
    return launches, err


def cifar_images(n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, CIFAR_SIZE, CIFAR_SIZE, 3), generator=g).to(device)


def resnet18_deployed(device):
    """cifar_resnet18 train form (seeded weights, BN statistics and affine
    perturbed) -> resnet_deploy -> config #1's scheme -> calibrate on one
    seeded batch of 256 -> prepare_deploy."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model("cifar_resnet18", device=device,
                      num_classes=CIFAR_CLASSES, generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                for t, lo in ((bn.running_mean, -0.1), (bn.running_var, 0.7),
                              (bn.weight, 0.8), (bn.bias, -0.1)):
                    t.copy_(lo + 0.3 * torch.rand(t.shape, generator=gen))
    scheme = scheme_from_dict(read_yaml(CONFIG_1)["quantization"])
    deploy = attach_scheme(resnet_deploy(model), scheme)
    calibrate(deploy, [cifar_images(SERVE_BATCH, SEED, device)])
    return prepare_deploy(deploy)


def launch_bound(kind, args, kw, out):
    """(bound ms, ops ms, bytes ms) of one recorded launch: inputs read and
    the output written once (a residual and the epilogue's per-column
    affines read once too)."""
    nbytes = out.numel() * out.element_size()
    r = kw.get("residual")
    if r is not None:
        nbytes += r[0].numel() * r[0].element_size() + 8 * out.shape[-1]
    if kind == "im2col":
        return bound_of(0, args[0].numel() + nbytes)
    if kind == "gemm":
        x, w = args[:2]
        m, k = x.shape
        n = w.shape[0]
        epi = 8 * n if kw.get("mode", "int32") != "int32" else 0
        return bound_of(2 * m * n * k, m * k + n * k + epi + nbytes)
    x, w, a, _ = args
    n, h, wd, c = x.shape
    o = a.shape[0]
    m = out.numel() // o
    return bound_of(2 * m * o * 9 * c, x.numel() + 9 * c * o + 8 * o + nbytes)


def bound_of(ops: int, nbytes: int):
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def launch_label(kind, args, kw) -> str:
    x = args[0]
    r = kw.get("residual")
    extra = f" +r {str(r[0].dtype).split('.')[-1]}" if r is not None else ""
    if kind == "im2col":
        return (f"im2col {tuple(x.shape)} {kw['kernel']}x{kw['kernel']} "
                f"s{kw['stride']} pads {kw['pads'][0]}")
    if kind == "gemm":
        m, k = x.shape
        return (f"gemm ({m},{k})x({k},{args[1].shape[0]}) "
                f"{kw.get('mode', 'int32')}{extra}")
    return (f"conv {tuple(x.shape)}->{args[2].shape[0]} s{kw['stride']} "
            f"pad_lo {kw.get('pad_lo', 1)} {kw['mode']}"
            f"{' relu' if kw.get('relu') else ''}{extra}")


def launch_group(kind, kw) -> str:
    """The launch's group in the per-group sums."""
    if kind != "gemm":
        return "3x3 conv" if kind == "conv" else "stem im2col"
    mode = kw.get("mode", "int32")
    return f"gemm {mode}" + (" + residual" if kw.get("residual") else "")


def resnet_kernel_phase(what, model, x, expect):
    """Every conv, GEMM and im2col launch of one chained request of ``x``,
    kernel vs plain (tolerance 0), timed per launch; returns the totals
    and, under "im2col", the im2col launches' ms, plain ms, bound ms, ops
    and bytes ms (its entry in the kernels line)."""
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        torch.cuda.synchronize()
        if rec.counts() != expect:
            raise RuntimeError(f"{what}: a request made {rec.counts()} "
                               f"launches, expected {expect}")
        print(f"# {what} kernel vs plain, batch {x.shape[0]}: launch | "
              "max|diff| | kernel_us bound_us (by) kernel/bound")
        tot = dict(ms=0.0, bound_ms=0.0, err=0.0)
        groups = {}
        stem = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                    bytes_ms=0.0)
        for i, (kind, args, kw, out) in enumerate(rec.calls):
            run, plain_fn = KERNELS[kind]
            err = max_diff_to_plain(kind, args, kw, out)
            ms = graph_ms(lambda _: run(*args, **kw), GRAPH_LAUNCHES)
            b_ms, t_ops, t_bytes = launch_bound(kind, args, kw, out)
            print(f"{i:2d} {launch_label(kind, args, kw):62s} | {err:g} | "
                  f"{ms * 1e3:8.2f} {b_ms * 1e3:8.2f} "
                  f"({bound_by(t_ops, t_bytes)}) {ms / b_ms:.2f}")
            if err != 0:
                raise RuntimeError(f"{what} launch {i} "
                                   f"({launch_label(kind, args, kw)}): "
                                   f"kernel and plain differ by {err}")
            tot["ms"] += ms
            tot["bound_ms"] += b_ms
            tot["err"] = max(tot["err"], err)
            g = groups.setdefault(launch_group(kind, kw), [0, 0.0, 0.0])
            g[0] += 1
            g[1] += ms
            g[2] += b_ms
            if kind == "im2col":
                for key, val in (("ms", ms), ("bound_ms", b_ms),
                                 ("ops_ms", t_ops), ("bytes_ms", t_bytes)):
                    stem[key] += val
                stem["plain_ms"] += event_ms(lambda: plain_fn(*args, **kw),
                                             PLAIN_REPS)
    print(f"# {what} batch {x.shape[0]}: {len(rec.calls)} launches, kernels "
          f"{tot['ms']:.4f} ms against a bound of {tot['bound_ms']:.4f} ms; "
          "by group (launches, ms, bound ms): " + "; ".join(
              f"{name} {n}, {ms:.4f}, {b:.4f}"
              for name, (n, ms, b) in groups.items()))
    tot["im2col"] = stem
    return tot


def serve_requests(what, model, x, expect, classes):
    """make_serving_fn(qmode="intc") on ``x``, REQUESTS times: checks the
    launches a request, the logits' shape and finiteness and the CPU plain
    path on 8 images; returns (median request ms, launches by kind)."""
    cpu_model = copy.deepcopy(model).cpu()
    serve = make_serving_fn(model, qmode="intc", device=x.device)
    counters = {kind: KERNELS[kind][0] for kind in expect}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    times = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        y = serve(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {kind: fn.launches for kind, fn in counters.items()}
    if launches != {kind: n * REQUESTS for kind, n in expect.items()}:
        raise RuntimeError(f"{what}: {launches} launches for {REQUESTS} "
                           f"requests, expected {expect} a request")
    if y.shape != (x.shape[0], classes) \
            or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: bad logits: {tuple(y.shape)}")
    with torch.inference_mode():
        ref = cpu_model(x[:8].cpu(), qmode="intc")
    rel = float((y[:8].cpu() - ref).norm() / (ref.norm() + 1e-9))
    steady = statistics.median(times[1:])
    print(f"# {what} serve: logits {tuple(y.shape)} finite; vs CPU plain "
          f"path on 8 images: rel L2 {rel:.3e}; launches {launches} = "
          f"{expect} x {REQUESTS}")
    if not rel < 2e-2:
        raise RuntimeError(f"{what}: GPU and CPU logits differ: rel L2 {rel}")
    print(f"# {what} serve: batch {x.shape[0]} request {steady * 1e3:.3f} "
          f"ms median of {REQUESTS - 1} (first {times[0] * 1e3:.1f} ms); "
          f"{x.shape[0] / steady:.1f} images/s on {card_line()}")
    return steady * 1e3, launches


def recorded_calls(model, x, skip: int = 0):
    """The kernel calls of one chained request of ``x``, as (kernel, args,
    keywords), without the first ``skip``; and the last block's output."""
    last = {}
    hook = getattr(model, model.block_names[-1]).register_forward_hook(
        lambda mod, args, out: last.__setitem__("out", out))
    with LaunchRecorder() as rec:
        model(x, qmode="intc")
    hook.remove()
    return ([(KERNELS[kind][0], a, kw) for kind, a, kw, _ in rec.calls[skip:]],
            materialize(last["out"]))


def run_calls(calls):
    for run, a, kw in calls:
        run(*a, **kw)


def split_line(what, request_ms, parts):
    rest = request_ms - sum(parts.values())
    print(f"# {what} serve split (device ms, CUDA graphs): " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in parts.items())
        + f"; request {request_ms:.4f} - their sum = host, gaps and small "
        f"ops {rest:.4f} ({100 * rest / request_ms:.1f} % of the request)")


def resnet_serve_phase(model, device):
    """Chained int8 cifar_resnet18 through make_serving_fn; returns the
    launches by kind."""
    x = cifar_images(SERVE_BATCH, SEED + 2, device)
    request_ms, launches = serve_requests("resnet18", model, x,
                                          RESNET18_LAUNCHES, CIFAR_CLASSES)
    # the request's split: device parts as CUDA graphs, the rest is host,
    # gaps and the small per-request ops (grid-adapted epilogues)
    with torch.inference_mode():
        calls, feat = recorded_calls(model, x)
        quant_ms = graph_ms(lambda _: model.conv1._input_codes(x), 4)
        kernels_ms = graph_ms(lambda _: run_calls(calls), 4)
        head_ms = graph_ms(lambda _: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    split_line("resnet18", request_ms, {
        "input quantize": quant_ms, f"{len(calls)} kernels": kernels_ms,
        "pool + head": head_ms})
    return launches


def resnet50_deployed(device):
    """ResNet-50 train form at full width (seeded weights, BN statistics
    and affine perturbed) -> resnet_deploy -> the bench's W8A8 scheme ->
    calibrate on one seeded batch of CAL_BATCH -> prepare_deploy."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model("resnet50", device=device, num_classes=CLASSES,
                      generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                for t, lo in ((bn.running_mean, -0.1), (bn.running_var, 0.7),
                              (bn.weight, 0.8), (bn.bias, -0.1)):
                    t.copy_(lo + 0.3 * torch.rand(t.shape, generator=gen))
    deploy = attach_scheme(resnet_deploy(model),
                           scheme_from_dict(BENCH_SCHEME))
    calibrate(deploy, [images(CAL_BATCH, SEED, device)])
    return prepare_deploy(deploy)


def resnet50_serve_phase(model, device):
    """Chained int8 ResNet-50 through make_serving_fn; returns the launches
    by kind."""
    x = images(SERVE_BATCH, SEED + 2, device)
    request_ms, launches = serve_requests("resnet50", model, x,
                                          RESNET50_LAUNCHES, CLASSES)
    with torch.inference_mode():
        # the stem's im2col and GEMM are the request's first two launches
        calls, feat = recorded_calls(model, x, skip=2)
        codes = model.conv1._input_codes(x)
        first = getattr(model, model.block_names[0])

        def stem_pool(_):
            de = qmaxpool(qrelu(model.conv1.deferred(codes)), (3, 3),
                          (2, 2), ((1, 1), (1, 1)))
            return (first.conv1._input_codes(de),
                    first.downsample._input_codes(de))

        quant_ms = graph_ms(lambda _: model.conv1._input_codes(x), 4)
        stem_ms = graph_ms(stem_pool, 4)
        kernels_ms = graph_ms(lambda _: run_calls(calls), 4)
        head_ms = graph_ms(lambda _: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    split_line("resnet50", request_ms, {
        "input quantize": quant_ms,
        "stem + pool (im2col, GEMM, pool, 2 folded quantizes)": stem_ms,
        f"{len(calls)} kernels": kernels_ms, "pool + head": head_ms})
    return launches


def training_config(name: str, **loader_args) -> ConfigParser:
    """``examples/configs/<name>.yaml`` cut for the smoke run: one epoch,
    one run, the training loader's ``loader_args``, nothing saved."""
    cfg = read_yaml(CONFIGS / f"{name}.yaml")
    cfg["train_loader"]["args"].update(loader_args)
    cfg["n_runs"] = 1
    cfg["trainer"]["epochs"] = 1
    return ConfigParser(cfg, "cuda", save_to_disk=False)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).norm() / (want.norm() + 1e-12))


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def eval_modules(model, x, qmode: str):
    """Forward of ``x`` in ``qmode`` on the card and on a CPU copy: (logits
    relative L2, {module: the worst relative L2 of its CPU copy run on the
    card's inputs to it, with the outputs of its own submodules replaced by
    the card's}).  That holds every op once on its own, free of the codes
    that flip upstream: the layers and BatchNorms as wholes, and the code
    between submodules (ReLUs, option-A shortcuts, residual sums, pooling)
    on its output and on each submodule's input."""
    cpu = copy.deepcopy(model).cpu()      # before the hooks: not copied
    caps = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, kwargs, out, name=name: caps.__setitem__(
            name, (_to_cpu(args), _to_cpu(kwargs), _to_cpu(out))),
        with_kwargs=True) for name, m in model.named_modules()]
    with torch.no_grad():
        y = model(x, qmode=qmode)
        for h in hooks:
            h.remove()
        ref = cpu(x.cpu(), qmode=qmode)
        worst = {}
        for name, (args, kwargs, out) in caps.items():
            mod, fed = cpu.get_submodule(name), {}
            subs = [c.register_forward_hook(
                lambda c_, a, o, sub=sub: (fed.__setitem__(sub, a[0]),
                                           caps[sub][2])[1])
                for child, c in mod.named_children()
                for sub in [f"{name}.{child}" if name else child]
                if sub in caps]
            errs = [rel_l2(mod(*args, **kwargs), out)] + [
                rel_l2(inp, caps[sub][0][0]) for sub, inp in fed.items()]
            for h in subs:
                h.remove()
            worst[name or "(model)"] = max(errs)
    return rel_l2(y, ref), worst


def train_gated(what: str, trainer, moved=(), chain_gate: bool = True):
    """One epoch of ``trainer.train()`` under full_f32, then the gates:
    every step's loss finite, the parameters named ``moved`` changed, the
    first step's loss within 1e-2 of the same model and batch on the CPU,
    in eval mode every module and the code between them, fed the card's
    inputs, within relative L2 1e-4 of its CPU copy (``eval_modules``),
    and, with ``chain_gate``, the eval logits within relative L2 2e-2 of the
    CPU's.  Without it the logits' reading is printed only: RootQ at 4 bits
    read 4.97e-2 with every layer within 4.4e-6, a code that flips on a
    float difference moving the layers after it.  Returns the first batch
    (on the card)."""
    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.rpartition(".")[2] in moved}
    rec = {"losses": []}

    def recorded_step(x, y):
        if "x" not in rec:      # the model and batch of the first step
            rec.update(x=x, y=y, model=copy.deepcopy(model).cpu())
        loss, logits = type(trainer).train_step(trainer, x, y)
        rec["losses"].append(loss)
        return loss, logits

    trainer.train_step = recorded_step
    t0 = time.perf_counter()
    with full_f32():
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del trainer.train_step
        losses = torch.stack(rec["losses"]).cpu()
        twin = rec["model"].train()
        cpu_loss = float(trainer.loss_fn(
            twin(rec["x"].cpu(), qmode=trainer.train_qmode), rec["y"].cpu()))
        x_eval = torch.from_numpy(next(iter(trainer.valid_loader))[0][
            :EVAL_IMAGES]).to(rec["x"].device)
        rel_eval, layers = eval_modules(model.eval(), x_eval,
                                        trainer.eval_qmode)
    rel_loss = abs(float(losses[0]) - cpu_loss) / abs(cpu_loss)
    worst = max(layers.items(), key=lambda kv: kv[1], default=("-", 0.0))
    shifts = {n: float(((p.detach() - before[n]).abs().max()
                        / (before[n].abs().max() + 1e-12)))
              for n, p in model.named_parameters() if n in before}
    print(f"# {what}: {len(losses)} steps of batch {len(rec['y'])} in "
          f"{wall:.2f} s (full_f32; train loader, host batches); losses "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, epoch "
          f"{ {k: round(v, 4) for k, v in result.items()} }; first loss card "
          f"vs CPU rel {rel_loss:.2e}; eval on {len(x_eval)} images, card "
          f"vs CPU: logits rel L2 {rel_eval:.2e}"
          f"{' (gated at 2e-2)' if chain_gate else ' (printed only)'}, "
          f"{len(layers)} modules each fed the card's inputs: worst rel L2 "
          f"{worst[1]:.2e} ({worst[0]})"
          + (f"; {len(shifts)} quantizer parameters moved, relative shift "
             f"{min(shifts.values()):.2e}..{max(shifts.values()):.2e}"
             if moved else ""))
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"{what}: a loss is not finite: {losses}")
    if moved and not (len(shifts) and min(shifts.values()) > 0):
        raise RuntimeError(f"{what}: quantizer parameters did not move: "
                           f"{shifts}")
    if not rel_loss < 1e-2:
        raise RuntimeError(f"{what}: first loss card vs CPU rel {rel_loss}")
    if not worst[1] < 1e-4:
        raise RuntimeError(f"{what}: eval module {worst[0]} card vs CPU rel "
                           f"{worst[1]}")
    if chain_gate and not rel_eval < 2e-2:
        raise RuntimeError(f"{what}: eval logits card vs CPU rel {rel_eval}")
    return rec["x"], rec["y"]


def time_steps(what: str, trainer, x, y, steps: int = TIMED_STEPS,
               graph_steps: int = 4):
    """ms a step at the default precision (cuDNN TF32), split into device
    time and host and gaps; returns the split."""
    torch.cuda.reset_peak_memory_stats()
    split = step_split(lambda: trainer.train_step(x, y), steps, graph_steps)
    peak = torch.cuda.max_memory_allocated()
    n = x.shape[0]
    print(f"# {what} step, batch {n}, default precision: "
          f"{split['wall_ms']:.3f} ms ({n / split['wall_ms'] * 1e3:.1f} "
          f"images/s); device {split['device_ms']:.3f} ms (CUDA events over "
          f"a CUDA graph of {graph_steps} steps), {split['kernels']:.0f} "
          f"kernels a step taking {split['busy_ms']:.3f} ms (profiler); host "
          f"and gaps "
          f"{split['host_gap_ms']:.3f} ms "
          f"({100 * split['host_gap_ms'] / split['wall_ms']:.1f} % of the "
          f"step); peak memory {peak / 2 ** 30:.2f} GiB; {card_line()}")
    return split


def qat_deploy_leg(device):
    """LSQ QAT at 8 bits → prepare_deploy → chained int8 through the conv
    kernel; returns the served request's conv launches and the largest
    kernel-vs-plain difference."""
    config = training_config(QAT_CONFIGS["lsq"], n_samples=QAT_IMAGES)
    for role in ("weight", "input"):
        config["quantization"][role]["args"]["n_bits"] = 8
    trainer = qat_entry.build_trainer(config, device, get_logger("qat"))
    train_gated("qat lsq w8a8", trainer, QAT_MOVED["lsq"])
    model = prepare_deploy(trainer.model.eval())
    batches = [torch.from_numpy(b) for b, _ in trainer.train_loader]
    x256 = torch.cat(batches[:2]).to(device)
    err = max(resnet_kernel_phase("qat lsq w8a8", model, xb,
                                  QAT_W8A8_LAUNCHES)["err"]
              for xb in (x256[:8], x256))
    serve = make_serving_fn(model, qmode="intc", device=device)
    # the float stem conv and head in strict f32, as on the CPU (cuDNN's
    # TF32 default moves them by ~1e-3, and the codes after them with it)
    K.int8_conv3x3.launches = 0
    with full_f32():
        y = serve(x256)
        torch.cuda.synchronize()
    launches = K.int8_conv3x3.launches
    y_tf32 = serve(x256)
    with torch.inference_mode():
        ref = copy.deepcopy(model).cpu()(x256.cpu(), qmode="intc")
        fake = model(x256, qmode="eval")
    rel = rel_l2(y, ref)
    agree = float((y.argmax(-1) == fake.argmax(-1)).float().mean())
    print(f"# qat lsq w8a8 serve: logits {tuple(y.shape)}, {launches} conv "
          f"launches; vs the CPU plain path on {len(ref)} images rel L2 "
          f"{rel:.3e} (full_f32; {rel_l2(y_tf32, ref):.3e} with the float "
          f"stem and head at the default TF32); top-1 agreement with the "
          f"fake-quant eval forward {agree:.4f}")
    if launches != QAT_W8A8_LAUNCHES["conv"] \
            or y.shape != (SERVE_BATCH, CIFAR_CLASSES) \
            or not bool(torch.isfinite(y).all()) or not rel < 2e-2:
        raise RuntimeError("the QAT model's int8 request is off")
    return launches, err


def r50_training_leg(batch: int = R50_BATCH, steps: int = R50_STEPS):
    """BASELINE config #5's training leg: RootQ W4A4 ResNet-50 through the
    QAT entry's build_trainer on the synthetic ImageNet fallback, one
    checked step and ``steps`` timed ones at ``batch``.  By hand for the
    config's batch 256: ``python3 -c 'import chip_smoke as s;
    s.r50_training_leg(256, 2)'``."""
    device = torch.device("cuda")
    n = -(-(steps + 2) * batch * 100 // 96)     # after the 4 % split
    config = training_config(R50_CONFIG, batch_size=batch, n_samples=n)
    t0 = time.perf_counter()
    trainer = qat_entry.build_trainer(config, device, get_logger("qat"))
    x, y = (torch.from_numpy(a).to(device) for a in
            next(iter(trainer.train_loader)))
    print(f"# r50 rootq w4a4: build_trainer (synthetic ImageNet, {n} images "
          f"at 224x224) + calibrate in {time.perf_counter() - t0:.2f} s")
    loss, _ = trainer.train_step(x, y.long())
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"r50 rootq w4a4: loss {float(loss)}")
    return time_steps("r50 rootq w4a4", trainer, x, y.long(), steps,
                      graph_steps=1)


def qat_phase(device):
    """(a) both QAT configs, (b) the fp32 baseline, (c) the deploy leg, (d)
    ResNet-50 RootQ training; returns the deploy leg's (launches, err)."""
    for family, name in QAT_CONFIGS.items():
        trainer = qat_entry.build_trainer(
            training_config(name, n_samples=QAT_IMAGES), device,
            get_logger("qat"))
        # RootQ's chain is chaotic across devices (see train_gated)
        x, y = train_gated(f"qat {family} w4a4", trainer, QAT_MOVED[family],
                           chain_gate=family != "rootq")
        time_steps(f"qat {family} w4a4", trainer, x, y)
    trainer = fp_entry.build_trainer(
        training_config(FP_CONFIG, n_samples=QAT_IMAGES), device,
        get_logger("fp"))
    x, y = train_gated("fp32 baseline", trainer)
    time_steps("fp32 baseline", trainer, x, y)
    launches, err = qat_deploy_leg(device)
    r50_training_leg()
    return launches, err


def ptq_phase():
    """BASELINE config #1 through the PTQ entry, with eval_int: true;
    returns the conv and GEMM launches of the run."""
    cfg = read_yaml(CONFIG_1)
    cfg["eval_int"] = True
    run_dir = REPO / "saved" / "chip_smoke"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg["save_dir"] = str(run_dir)
    path = run_dir / "PTQ_resnet18_cifar10_w8a8_eval_int.yaml"
    write_yaml(cfg, path)
    print(f"# ptq: config #1 with eval_int: true, nothing cut (calibration "
          f"{cfg['dataloaders']['calibration']['args']['n_samples']} images, "
          f"eval the synthetic fallback's 2000)")
    K.int8_conv3x3.launches = G.int8_gemm.launches = 0
    t0 = time.perf_counter()
    if ptq_entry.main(["-c", str(path)]) != 0:
        raise RuntimeError("the PTQ entry failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    convs, gemms = K.int8_conv3x3.launches, G.int8_gemm.launches
    (ckpt,) = sorted((run_dir / "models").glob("*/*/quantized_model"))[-1:]
    _, meta = load_checkpoint(ckpt)
    fp, quant, real = meta["fp32"], meta["quant"], meta["int"]
    print(f"# ptq: fp32 {fp}; fake quant {quant}; int {real}; "
          f"{convs} conv and {gemms} GEMM launches; wall {wall:.2f} s")
    losses = torch.tensor([fp["loss"], quant["loss"], real["loss"]])
    if not (bool(torch.isfinite(losses).all()) and convs and gemms
            and abs(real["loss"] - quant["loss"]) < 0.05 * quant["loss"]):
        raise RuntimeError("the PTQ entry's results are off")
    return convs, gemms


def tool_path(drive, wrapper, what: str):
    """Run a tool's main path with ``wrapper``'s launch count set to 0;
    returns the tool's rows and the launches of that run."""
    wrapper.launches = 0
    rows = drive()
    torch.cuda.synchronize()
    launches = wrapper.launches
    if launches == 0:
        raise RuntimeError(f"{what} never launched its kernel")
    return rows, launches


def max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def gemm_calls(row, gen):
    """(kernel, plain, library) calls on fresh operands of a sweep row."""
    m, k, n = row["m"], row["k"], row["n"]
    x, w = gemm_sweep.operands(m, k, n, gen)
    wp = G.pack_b(w)
    wc = gemm_sweep.col_major(wp, k)
    return (lambda: G.int8_gemm(x, wp), lambda: G.int8_gemm_plain(x, wp),
            lambda: torch._int_mm(x, wc))


def probe_calls(row, gen):
    """(kernel, plain, library) calls on fresh operands of a probe row."""
    x, wp = mma_probe.operands(row["m"], row["k"], row["n"], gen)
    rolls = row["rolls"]
    xc, wc = mma_probe.concat_operands(x, wp, rolls)
    return (lambda: P.int8_mma_probe(x, wp, rolls),
            lambda: P.int8_mma_probe_plain(x, wp, rolls),
            lambda: torch._int_mm(xc, wc))


def exact_phase(what: str, rows, calls):
    """Kernel vs plain vs torch._int_mm at each row's shape (tolerance 0);
    returns totals of the tool's times, the bounds and the plain times."""
    print(f"# {what} vs plain and torch._int_mm: (M,K,N) plan | max|d plain| "
          "max|d _int_mm| | kernel_ms bound_ms (by) plain_ms library_ms")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               library_ms=0.0, err=0)
    for row in rows:
        kernel, plain, library = calls(row)
        got = kernel()
        err_plain = max_abs(got, plain())
        err_lib = max_abs(got, library())
        plain_ms = event_ms(plain, PLAIN_REPS)
        b_ms = max(row["ops_ms"], row["bytes_ms"])
        plan = (f"tile {row['tile'][0]}x{row['tile'][1]}" if "tile" in row
                else f"split {row['split']}")
        print(f"({row['m']},{row['k']},{row['n']}) {plan} | {err_plain} "
              f"{err_lib} | "
              f"{row['ms']:.5f} {b_ms:.5f} "
              f"({bound_by(row['ops_ms'], row['bytes_ms'])}) {plain_ms:.4f} "
              f"{row['library_ms']:.5f}")
        if err_plain or err_lib:
            raise RuntimeError(f"{what} at ({row['m']},{row['k']},"
                               f"{row['n']}): differs from plain by "
                               f"{err_plain}, from torch._int_mm by {err_lib}")
        for key, val in (("ms", row["ms"]), ("plain_ms", plain_ms),
                         ("bound_ms", b_ms), ("ops_ms", row["ops_ms"]),
                         ("bytes_ms", row["bytes_ms"]),
                         ("library_ms", row["library_ms"])):
            tot[key] += val
    print(f"# {what} totals over {len(rows)} shapes: kernel {tot['ms']:.4f} "
          f"ms, bound {tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
          f"ms, torch._int_mm {tot['library_ms']:.4f} ms")
    return tot


def kernel_entry(name, replaces, launches, tot, library_ms):
    return {"name": name, "route": "cuda",
            "source": f"dlmc_quant_torch/ops/cuda/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by(tot["ops_ms"], tot["bytes_ms"]),
            "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    build.build("int8_conv3x3", "int8_gemm", "int8_im2col", "int8_mma_probe",
                verbose=True)
    print(f"# build: {time.perf_counter() - t0:.2f} s")
    card_tests()
    print("# int8_gemm dynamic shared memory by tile (BM x BN: stages, "
          "bytes): " + ", ".join(
              f"{bm}x{bn}: {G.TILE_STAGES[bm, bn]}, "
              f"{G.tile_smem_bytes((bm, bn))}" for bm, bn in G.TILES))
    print(f"# int8_mma_probe dynamic shared memory: 3-4 stages of (rolls + "
          f"nbufs) tiles of 8192 bytes, at most {P.MAX_TILES} tiles a stage, "
          f"{G.MAX_SMEM} bytes a block")

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
    recon_launches, recon_err = recon_phase(device, card)
    launches += recon_launches

    t0 = time.perf_counter()
    resnet = resnet18_deployed(device)
    print(f"# resnet18: train form -> resnet_deploy -> config #1 scheme -> "
          f"calibrate (batch {SERVE_BATCH}) + prepare_deploy in "
          f"{time.perf_counter() - t0:.2f} s")
    res_err = max(resnet_kernel_phase(
        "resnet18", resnet, cifar_images(b, SEED + 1, device),
        RESNET18_LAUNCHES)["err"] for b in (8, SERVE_BATCH))
    served = resnet_serve_phase(resnet, device)
    del resnet
    ptq_convs, ptq_gemms = ptq_phase()

    t0 = time.perf_counter()
    r50 = resnet50_deployed(device)
    print(f"# resnet50: train form -> resnet_deploy -> bench W8A8 scheme -> "
          f"calibrate (batch {CAL_BATCH}) + prepare_deploy in "
          f"{time.perf_counter() - t0:.2f} s")
    r50_err = resnet_kernel_phase("resnet50", r50, images(8, SEED + 1, device),
                                  RESNET50_LAUNCHES)["err"]
    r50_tot = resnet_kernel_phase("resnet50", r50,
                                  images(SERVE_BATCH, SEED + 1, device),
                                  RESNET50_LAUNCHES)
    served50 = resnet50_serve_phase(r50, device)
    del r50
    t0 = time.perf_counter()
    qat_launches, qat_err = qat_phase(device)
    print(f"# qat phase: {time.perf_counter() - t0:.2f} s")
    launches += served["conv"] + ptq_convs + served50["conv"] + qat_launches
    tot["err"] = max(err8, tot["err"], recon_err, res_err, r50_err,
                     r50_tot["err"], qat_err)
    stem = dict(r50_tot["im2col"], err=max(r50_err, r50_tot["err"]))

    gemm_rows, gemm_launches = tool_path(gemm_sweep.main, G.int8_gemm,
                                         "gemm_sweep")
    gemm_launches += served["gemm"] + ptq_gemms + served50["gemm"]
    probe_rows, probe_launches = tool_path(lambda: mma_probe.main([]),
                                           P.int8_mma_probe, "mma_probe")
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    gemm_tot = exact_phase(
        "int8_gemm (default tile)", [r for r in gemm_rows if r["default"]],
        lambda row: gemm_calls(row, gen))
    probe_tot = exact_phase("int8_mma_probe", probe_rows,
                            lambda row: probe_calls(row, gen))

    print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        kernel_entry("int8_conv3x3", "dlmc_quant_tpu/ops/pallas/rpconv.py:200",
                     launches, tot, None),
        kernel_entry("int8_gemm", "tools/pallas_gemm_sweep.py:37",
                     gemm_launches, gemm_tot, gemm_tot["library_ms"]),
        kernel_entry("int8_mma_probe", "tools/vmem_gemm_probe.py:33",
                     probe_launches, probe_tot, probe_tot["library_ms"]),
        kernel_entry("int8_im2col", "dlmc_quant_tpu/quant/layers.py:721-728",
                     served50["im2col"], stem, None)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
