"""Two ranks of one model group: RepVGG-A0 and ResNet-50 at full width,
224×224, their int8 plans sharded over output channels on a 2-rank
``'model'`` axis, the codes gathered between layers.

    python -m dlmc_quant_torch.tools.model_axis_2proc [--device cpu]
        [--port N] [--a0-batch 64] [--r50-batch 16] [--size 224]
        [--reps 5]

Built as ``tools/lockstep_2proc.py`` is: two OS processes joined by
``torch.distributed`` on ``localhost``; on the card both drive card 0, so
the group is gloo and the gathers go through host memory
(``parallel.mesh.model_transport`` says so, printed first).  Each rank
builds both models from the same seeds (A0's deploy form as
``examples/serve_benchmark.py`` builds it; ResNet-50's train form with its
BatchNorm statistics perturbed, ``resnet_deploy``, the same W8A8 scheme,
calibrated on one seeded batch of 32) and runs one batch in ``'intc'``
replicated, then the same batch with the plans sharded
(``parallel.sharding_rules.shard_params`` over the mesh (1, 2)).  Each
rank checks, and fails unless:

* the logits (``'intc'`` and ``'int'``) and the int8 codes at every layer
  boundary (each quantized layer's input codes, each block's output
  codes) of the sharded batch equal the replicated ones (``torch.equal``);
* every kernel launch of the sharded batch (conv, GEMM, stem + pool,
  im2col) equals its plain version on the same arguments.

It prints the request's ms (median of ``--reps``, replicated and sharded;
both ranks at once on the one card), the gathers' count, bytes and ms
(host clock, the card synchronized around each), and each kernel's
sharded launches beside the whole layers' launches of the replicated
batch: count, device ms (a CUDA graph of the recorded calls, one rank at
a time) and bound (``utils.launches.launch_bound``).  Each rank ends with
one line ``MODEL_AXIS {json}``; the tool prints ``MODEL AXIS 2-PROC:
PASS`` and exits 0, or ``FAIL`` and 1.  ``--device cpu`` runs the same
checks on the kernels' plain versions (use a small ``--size``; no device
times).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

TIMEOUT_S = 600     # both children, together
ROOT = Path(__file__).resolve().parents[2]
SEED, CLASSES, CAL = 0, 1000, 32
KINDS = ("conv", "gemm", "stem_pool", "im2col")


def images(n: int, seed: int, size: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, size, size, 3), generator=g).to(device)


def resnet50_deploy_form(device, size: int = 224, seed: int = SEED,
                         cal: int = CAL):
    """ResNet-50's train form at full width (seeded weights, BatchNorm
    statistics and affine perturbed) → ``resnet_deploy`` → the bench's
    W8A8 scheme → calibrated on one seeded batch of ``cal`` →
    ``prepare_deploy``."""
    from dlmc_quant_torch.examples.serve_benchmark import scheme
    from dlmc_quant_torch.models import get_model
    from dlmc_quant_torch.models.fuse import resnet_deploy
    from dlmc_quant_torch.models.resnet_cifar import BatchNorm
    from dlmc_quant_torch.quant.deploy import prepare_deploy
    from dlmc_quant_torch.quant.layers import attach_scheme, calibrate

    gen = torch.Generator().manual_seed(seed)
    model = get_model("resnet50", device=device, num_classes=CLASSES,
                      generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                for t, lo in ((bn.running_mean, -0.1), (bn.running_var, 0.7),
                              (bn.weight, 0.8), (bn.bias, -0.1)):
                    t.copy_(lo + 0.3 * torch.rand(t.shape, generator=gen))
    deploy = attach_scheme(resnet_deploy(model), scheme(8, 8))
    calibrate(deploy, [images(cal, seed, size, device)])
    return prepare_deploy(deploy)


@contextlib.contextmanager
def boundary_codes(codes: list):
    """Append the int8 codes at every layer boundary of the forwards run
    inside: each quantized layer's input codes (``QLayer._input_codes``)
    and each block's output codes (``QBlockOutput``)."""
    from dlmc_quant_torch.quant.chain import QuantizedTensor
    from dlmc_quant_torch.quant.layers import QBlockOutput, QLayer

    own = QLayer._input_codes
    block = QBlockOutput.forward

    def input_codes(self, x):
        q = own(self, x)
        codes.append(q)
        return q

    def block_forward(self, *args, **kw):
        out = block(self, *args, **kw)
        if isinstance(out, QuantizedTensor):
            codes.append(out.q)
        return out

    QLayer._input_codes, QBlockOutput.forward = input_codes, block_forward
    try:
        yield codes
    finally:
        QLayer._input_codes, QBlockOutput.forward = own, block


def sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def request_ms(model, x, reps: int) -> float:
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        model(x, qmode="intc")
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def timed_gathers(stats: dict):
    """Time every ``gather_channels`` on the host clock, the card
    synchronized before and after it."""
    from dlmc_quant_torch.parallel import mesh as mesh_lib

    own = mesh_lib.gather_channels

    def timed(x, mesh, axis="model"):
        sync()
        t0 = time.perf_counter()
        out = own(x, mesh, axis)
        sync()
        stats["ms"] += (time.perf_counter() - t0) * 1e3
        stats["calls"] += 1
        stats["bytes"] += out.numel() * out.element_size()
        return out

    mesh_lib.gather_channels = timed
    try:
        yield stats
    finally:
        mesh_lib.gather_channels = own


def kernel_sums(calls, check: bool):
    """By kind: launches, device ms of the calls replayed in a CUDA graph
    (None on the CPU), bound ms, and with ``check`` the largest difference
    from the plain version."""
    from dlmc_quant_torch.utils.launches import (KERNELS, launch_bound,
                                                 max_diff_to_plain)
    from dlmc_quant_torch.utils.profiling import graph_ms

    out = {}
    for kind in KINDS:
        mine = [c for c in calls if c[0] == kind]
        if not mine:
            continue
        run = KERNELS[kind][0]

        def replay(_, mine=mine, run=run):
            for _, a, kw, _ in mine:
                run(*a, **kw)

        out[kind] = {
            "launches": len(mine),
            "ms": graph_ms(replay, 2, 5) if mine[0][3].is_cuda else None,
            "bound_ms": sum(launch_bound(kind, a, kw, o)[0]
                            for _, a, kw, o in mine),
            "err": max(max_diff_to_plain(kind, a, kw, o)
                       for _, a, kw, o in mine) if check else None}
    return out


def one_model(what, model, x, mesh, reps: int, rank: int) -> dict:
    """The replicated batch, then the sharded one; the checks and the
    numbers of the module docstring."""
    from dlmc_quant_torch.parallel.sharding_rules import shard_params
    from dlmc_quant_torch.utils.launches import KERNELS, LaunchRecorder

    res = {"model": what, "batch": x.shape[0]}
    with torch.inference_mode():
        with boundary_codes([]) as ref_codes, LaunchRecorder() as whole:
            ref = model(x, qmode="intc")
        ref_int = model(x, qmode="int")
        res["replicated_ms"] = request_ms(model, x, reps)
        shard_params(model, mesh)
        res["sharded_layers"] = sum(getattr(m, "shard", None) is not None
                                    for m in model.modules())
        for kind in KINDS:
            KERNELS[kind][0].launches = 0
        with boundary_codes([]) as codes, LaunchRecorder() as rec:
            got = model(x, qmode="intc")
        res["launches"] = {kind: KERNELS[kind][0].launches for kind in KINDS}
        res["logits_equal"] = torch.equal(got, ref)
        res["int_logits_equal"] = torch.equal(model(x, qmode="int"),
                                              ref_int)
        res["boundaries"] = len(codes)
        res["boundaries_equal"] = len(codes) == len(ref_codes) and all(
            torch.equal(a, b) for a, b in zip(codes, ref_codes))
        res["sharded_ms"] = request_ms(model, x, reps)
        with timed_gathers({"calls": 0, "bytes": 0, "ms": 0.0}) as g:
            model(x, qmode="intc")
        res["gathers"] = g
        # kernels timed one rank at a time: the two share the card
        for turn in range(2):
            dist.barrier()
            if turn == rank:
                res["sharded"] = kernel_sums(rec.calls, check=True)
                res["whole"] = kernel_sums(whole.calls, check=False)
        dist.barrier()
    res["ok"] = (res["logits_equal"] and res["int_logits_equal"]
                 and res["boundaries_equal"]
                 and all(k["err"] == 0 for k in res["sharded"].values()))
    return res


def print_model(rank: int, res: dict) -> None:
    g = res["gathers"]
    print(f"# rank {rank} {res['model']} batch {res['batch']}: "
          f"{res['sharded_layers']} layers sharded; request "
          f"{res['sharded_ms']:.3f} ms sharded against "
          f"{res['replicated_ms']:.3f} replicated; {g['calls']} gathers "
          f"{g['bytes'] / 1e6:.3f} MB, {g['ms']:.3f} ms; logits "
          f"equal {res['logits_equal']} (int {res['int_logits_equal']}), "
          f"{res['boundaries']} boundaries' codes equal "
          f"{res['boundaries_equal']}", flush=True)
    for kind, s in res["sharded"].items():
        w = res["whole"].get(kind, {})
        print(f"#   {kind}: {s['launches']} sharded launches {s['ms']} ms "
              f"(bound {s['bound_ms']:.4f}, |plain| {s['err']}) beside the "
              f"whole layers' {w.get('launches')} {w.get('ms')} ms (bound "
              f"{w.get('bound_ms', float('nan')):.4f})", flush=True)


def child(pid: int, port: int, device: str, opts) -> bool:
    from dlmc_quant_torch.examples import serve_benchmark as serve_bench
    from dlmc_quant_torch.parallel import mesh as mesh_lib

    dev = mesh_lib.init_distributed(f"localhost:{port}", 2, pid, device)
    mesh = mesh_lib.make_mesh(axes=("data", "model"), shape=(1, 2))
    if pid == 0:
        print(f"# model axis: 2 ranks, backend {dist.get_backend()}, "
              f"gathers by {mesh_lib.model_transport(mesh)}", flush=True)
    results = []
    for what, build, batch, seed in (
            ("RepVGG_A0", lambda: serve_bench.build("RepVGG_A0", 8, 8, dev),
             opts.a0_batch, SEED + 1),
            ("resnet50", lambda: resnet50_deploy_form(dev, opts.size),
             opts.r50_batch, SEED + 2)):
        t0 = time.perf_counter()
        model = build()
        res = one_model(what, model, images(batch, seed, opts.size, dev),
                        mesh, opts.reps, pid)
        res["seconds"] = time.perf_counter() - t0
        print_model(pid, res)
        results.append(res)
        del model
    print("MODEL_AXIS " + json.dumps({"rank": pid, "models": results}),
          flush=True)
    mesh_lib.shutdown()
    return all(r["ok"] for r in results)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--a0-batch", type=int, default=64)
    p.add_argument("--r50-batch", type=int, default=16)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--child", type=int, default=None)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass --device cpu to run on the CPU")
    if args.child is not None:
        return 0 if child(args.child, args.port, args.device, args) else 1
    port = args.port or free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in vars(args).items()
             if k not in ("child", "port") and v is not None]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dlmc_quant_torch.tools.model_axis_2proc",
         "--child", str(i), "--port", str(port), *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for i in range(2)]
    ok = True
    deadline = time.monotonic() + TIMEOUT_S
    for i, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            ok = False
        lines = out.strip().splitlines()
        keep = [ln for ln in lines if ln.startswith(("# ", "MODEL_AXIS "))]
        print(f"--- rank {i} (rc={proc.returncode}) ---")
        print("\n".join(keep if proc.returncode == 0 else lines[-40:]))
        ok = ok and proc.returncode == 0
    print("MODEL AXIS 2-PROC:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
