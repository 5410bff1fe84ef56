#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: RepVGG-A0 chained int8,
FSPTQ reconstruction served through the conv kernel, chained int8
cifar_resnet18 and BASELINE config #1's PTQ entry, then the two int8 GEMM
tools.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   the three kernels from dlmc_quant_torch/ops/cuda/csrc (int8
             3x3 conv, int8 GEMM, int8 MMA probe), one nvcc each, all at
             once (prints the build seconds, ptxas' report of registers and
             spills, and the dynamic shared memory of every GEMM tile and
             of the probe's ring); then the conv's card tests at ragged
             shapes, the SAME stride-2 geometry, the residual epilogue and
             the GEMM at the ResNet-18 shortcut shapes
             (tests/test_torch_int8_conv.py and
             tests/test_torch_resnet_conv.py, -m cuda), before any timing;
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
           defaults but 40 iterations a block (per target: capture and
           reconstruction ms, steps/s, held-out l2, kept or reverted; the
           teacher agreement before and after, which may not drop; the
           blocks kept with moved parameters); eval-mode logits on 8
           images within relative L2 2e-2 of the same model on the CPU;
           prepare_deploy, the 22 reconstructed convs kernel == plain
           (tolerance 0, batch 8), and one make_serving_fn(qmode="intc")
           request of 256 images with 22 launches;
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
from dlmc_quant_torch.examples import post_training_quantization as ptq_entry
from dlmc_quant_torch.models.fuse import repvgg_fuse, resnet_deploy
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.ops.cuda import int8_mma_probe as P
from dlmc_quant_torch.quant import chain, layers
from dlmc_quant_torch.quant.chain import fold_params, materialize, qrelu
from dlmc_quant_torch.quant.layers import full_f32
from dlmc_quant_torch.tools import gemm_sweep, mma_probe
from dlmc_quant_torch.utils.profiling import (PEAK_BYTES, PEAK_INT8_OPS,
                                              bound_by, card_line, event_ms,
                                              graph_ms)
from dlmc_quant_torch.utils.checkpoint import load_checkpoint
from dlmc_quant_torch.utils.config import read_yaml, write_yaml

SIZE, CLASSES, SEED = 224, 1000, 0
CAL_BATCH, SERVE_BATCH, REQUESTS, REPS = 32, 256, 6, 20
PLAIN_REPS = 3
RECON_SAMPLES, RECON_BATCH, RECON_SEED, RECON_ITERS = 256, 64, 123, 40
GRAPH_LAUNCHES = 16
REPO = pathlib.Path(__file__).resolve().parent
CONFIG_1 = REPO / "examples" / "configs" / "PTQ_resnet18_cifar10_w8a8.yaml"
CIFAR_SIZE, CIFAR_CLASSES, RESNET_CONVS, RESNET_GEMMS = 32, 10, 18, 3
SCHEME = {
    "quantization_type": "FSPTQ",
    "weight": {"enable": True, "type": "minmax_channel",
               "recon_type": "adaround",
               "args": {"n_bits": 8, "signed": True}},
    "input": {"enable": True, "type": "minmax_tensor",
              "args": {"n_bits": 8, "signed": False}},
}


def images(n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, SIZE, SIZE, 3), generator=g).to(device)


def card_tests():
    """The conv's and the ResNet path's card tests (ragged shapes, every
    compiled tile, both modes, SAME stride 2, the residual epilogue, the
    shortcut GEMMs), in a process of their own; fatal unless all pass."""
    tests = REPO / "tests"
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", str(tests / "test_torch_int8_conv.py"),
         str(tests / "test_torch_resnet_conv.py")],
        capture_output=True, text=True)
    tail = run.stdout.strip().splitlines()[-1:] or [run.stderr.strip()[-300:]]
    print(f"# card tests of int8_conv3x3 and the ResNet path: {tail[0]}")
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
        raise RuntimeError("the conv's card tests failed")


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
    res = FSPTQTrainer(student, teacher, batches, iters=RECON_ITERS).train()
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
    err = kernel_phase(student, 8, device)["err"]
    serve = make_serving_fn(student, qmode="intc", device=device)
    x = images(SERVE_BATCH, SEED + 3, device)
    K.int8_conv3x3.launches = 0
    y = serve(x)
    torch.cuda.synchronize()
    launches = K.int8_conv3x3.launches
    if launches != 22:
        raise RuntimeError(f"{launches} conv launches for one request of the "
                           "reconstructed model, expected 22")
    if y.shape != (SERVE_BATCH, CLASSES) or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"bad logits: {tuple(y.shape)}")
    print(f"# recon: served the reconstructed model: logits "
          f"{tuple(y.shape)} finite, {launches} conv launches")
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


class LaunchRecorder:
    """Records every conv and GEMM launch the port makes while it is
    entered (arguments, keywords and the kernel's output), by wrapping the
    wrappers where the chain and the layers call them; each wrapper still
    counts its own launches."""

    def __enter__(self):
        self.calls = []
        self._saved = (chain.int8_conv3x3, layers.int8_gemm)

        def record(kind, fn):
            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                self.calls.append((kind, args, kw, out))
                return out
            return wrapped

        chain.int8_conv3x3 = record("conv", self._saved[0])
        layers.int8_gemm = record("gemm", self._saved[1])
        return self

    def __exit__(self, *exc):
        chain.int8_conv3x3, layers.int8_gemm = self._saved


def launch_bound(kind, args, kw, out):
    """(bound ms, ops ms, bytes ms) of one recorded launch: inputs read and
    the output written once (a residual read once too)."""
    if kind == "gemm":
        x, w = args
        m, k = x.shape
        n = w.shape[0]
        return bound_of(2 * m * n * k, m * k + n * k + 4 * m * n)
    x, w, a, _ = args
    n, h, wd, c = x.shape
    o = a.shape[0]
    m = out.numel() // o
    nbytes = x.numel() + 9 * c * o + 8 * o + out.numel() * out.element_size()
    if kw.get("residual") is not None:
        r = kw["residual"][0]
        nbytes += r.numel() * r.element_size() + 8 * o
    return bound_of(2 * m * o * 9 * c, nbytes)


def bound_of(ops: int, nbytes: int):
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def launch_label(kind, args, kw) -> str:
    x = args[0]
    if kind == "gemm":
        m, k = x.shape
        return f"gemm ({m},{k})x({k},{args[1].shape[0]})"
    r = kw.get("residual")
    extra = f" +r {str(r[0].dtype).split('.')[-1]}" if r is not None else ""
    return (f"conv {tuple(x.shape)}->{args[2].shape[0]} s{kw['stride']} "
            f"pad_lo {kw.get('pad_lo', 1)} {kw['mode']}"
            f"{' relu' if kw.get('relu') else ''}{extra}")


def resnet_kernel_phase(model, batch: int, device):
    """Every conv and GEMM launch of one chained request, kernel vs plain
    (tolerance 0), timed per launch; returns the totals."""
    x = cifar_images(batch, SEED + 1, device)
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        torch.cuda.synchronize()
        kinds = [c[0] for c in rec.calls]
        if (kinds.count("conv"), kinds.count("gemm")) != (RESNET_CONVS,
                                                          RESNET_GEMMS):
            raise RuntimeError(f"a request made {kinds.count('conv')} conv "
                               f"and {kinds.count('gemm')} GEMM launches")
        print(f"# resnet18 kernel vs plain, batch {batch}: launch | "
              "max|diff| | kernel_us bound_us (by) kernel/bound")
        tot = dict(ms=0.0, bound_ms=0.0, err=0.0)
        for i, (kind, args, kw, out) in enumerate(rec.calls):
            if kind == "conv":
                plain = K.int8_conv3x3_plain(*args, **kw)
                run = K.int8_conv3x3
            else:
                plain = G.int8_gemm_plain(*args)
                run = G.int8_gemm
            err = float((out.double() - plain.double()).abs().max())
            ms = graph_ms(lambda _: run(*args, **kw), GRAPH_LAUNCHES)
            b_ms, t_ops, t_bytes = launch_bound(kind, args, kw, out)
            print(f"{i:2d} {launch_label(kind, args, kw):58s} | {err:g} | "
                  f"{ms * 1e3:8.2f} {b_ms * 1e3:8.2f} "
                  f"({bound_by(t_ops, t_bytes)}) {ms / b_ms:.2f}")
            if err != 0:
                raise RuntimeError(f"resnet18 launch {i} "
                                   f"({launch_label(kind, args, kw)}): "
                                   f"kernel and plain differ by {err}")
            tot["ms"] += ms
            tot["bound_ms"] += b_ms
            tot["err"] = max(tot["err"], err)
    print(f"# resnet18 batch {batch}: {len(rec.calls)} launches, kernels "
          f"{tot['ms']:.4f} ms against a bound of {tot['bound_ms']:.4f} ms")
    return tot


def resnet_serve_phase(model, device, card: str):
    """Chained int8 cifar_resnet18 through make_serving_fn; returns the
    conv and GEMM launches."""
    cpu_model = copy.deepcopy(model).cpu()
    serve = make_serving_fn(model, qmode="intc", device=device)
    x = cifar_images(SERVE_BATCH, SEED + 2, device)
    K.int8_conv3x3.launches = G.int8_gemm.launches = 0
    torch.cuda.synchronize()
    times = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        y = serve(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    convs, gemms = K.int8_conv3x3.launches, G.int8_gemm.launches
    if (convs, gemms) != (RESNET_CONVS * REQUESTS, RESNET_GEMMS * REQUESTS):
        raise RuntimeError(f"{convs} conv and {gemms} GEMM launches for "
                           f"{REQUESTS} requests, expected "
                           f"{RESNET_CONVS} and {RESNET_GEMMS} a request")
    if y.shape != (SERVE_BATCH, CIFAR_CLASSES) \
            or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"bad logits: {tuple(y.shape)}")
    with torch.inference_mode():
        ref = cpu_model(x[:8].cpu(), qmode="intc")
    rel = float((y[:8].cpu() - ref).norm() / (ref.norm() + 1e-9))
    steady = statistics.median(times[1:])
    print(f"# resnet18 serve: logits {tuple(y.shape)} finite; vs CPU plain "
          f"path on 8 images: rel L2 {rel:.3e}; launches {convs} conv + "
          f"{gemms} GEMM = ({RESNET_CONVS} + {RESNET_GEMMS}) x {REQUESTS}")
    if not rel < 2e-2:
        raise RuntimeError(f"GPU and CPU logits differ: rel L2 {rel}")
    print(f"# resnet18 serve: batch {SERVE_BATCH} request {steady * 1e3:.3f} "
          f"ms median of {REQUESTS - 1} (first {times[0] * 1e3:.1f} ms); "
          f"{SERVE_BATCH / steady:.1f} images/s on {card}")

    # the request's split: device parts as CUDA graphs, the rest is host,
    # gaps and the small per-request ops (grid-adapted epilogues)
    last = {}
    hook = model.layer4_1.register_forward_hook(
        lambda mod, args, out: last.__setitem__("out", out))
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        hook.remove()
        calls = [(K.int8_conv3x3 if kind == "conv" else G.int8_gemm, a, kw)
                 for kind, a, kw, _ in rec.calls]

        def kernels(_):
            for run, a, kw in calls:
                run(*a, **kw)

        feat = materialize(last["out"])
        quant_ms = graph_ms(lambda _: model.conv1._input_codes(x), 4)
        kernels_ms = graph_ms(kernels, 4)
        head_ms = graph_ms(lambda _: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    request_ms = steady * 1e3
    rest = request_ms - quant_ms - kernels_ms - head_ms
    print(f"# resnet18 serve split (device ms, CUDA graphs): input quantize "
          f"{quant_ms:.4f}, {len(calls)} kernels {kernels_ms:.4f}, pool + "
          f"head {head_ms:.4f}; request {request_ms:.4f} - their sum = host, "
          f"gaps and small ops {rest:.4f} ({100 * rest / request_ms:.1f} % "
          f"of the request)")
    return convs, gemms


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
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    build.build("int8_conv3x3", "int8_gemm", "int8_mma_probe", verbose=True)
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
    res_err = max(resnet_kernel_phase(resnet, b, device)["err"]
                  for b in (8, SERVE_BATCH))
    serve_convs, serve_gemms = resnet_serve_phase(resnet, device, card)
    ptq_convs, ptq_gemms = ptq_phase()
    launches += serve_convs + ptq_convs
    tot["err"] = max(err8, tot["err"], recon_err, res_err)

    gemm_rows, gemm_launches = tool_path(gemm_sweep.main, G.int8_gemm,
                                         "gemm_sweep")
    gemm_launches += serve_gemms + ptq_gemms
    probe_rows, probe_launches = tool_path(lambda: mma_probe.main([]),
                                           P.int8_mma_probe, "mma_probe")
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    gemm_tot = exact_phase(
        "int8_gemm (default tile)", [r for r in gemm_rows if r["default"]],
        lambda row: gemm_calls(row, gen))
    probe_tot = exact_phase("int8_mma_probe", probe_rows,
                            lambda row: probe_calls(row, gen))

    print(json.dumps({"kernels": [
        kernel_entry("int8_conv3x3", "dlmc_quant_tpu/ops/pallas/rpconv.py:200",
                     launches, tot, None),
        kernel_entry("int8_gemm", "tools/pallas_gemm_sweep.py:37",
                     gemm_launches, gemm_tot, gemm_tot["library_ms"]),
        kernel_entry("int8_mma_probe", "tools/vmem_gemm_probe.py:33",
                     probe_launches, probe_tot, probe_tot["library_ms"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
