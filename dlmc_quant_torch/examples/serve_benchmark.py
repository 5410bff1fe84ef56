"""Quantized-serving throughput: images/s of one replica, and summed over
the ranks of a launched world with its scaling efficiency.

    python -m dlmc_quant_torch.examples.serve_benchmark \
        [model] [batch] [w_bits] [a_bits] [--device cpu] \
        [--coordinator HOST:PORT --num-hosts N --host-id I]

Counterpart of ``examples/serve_benchmark.py`` (the defaults: RepVGG_A0,
batch 128, W8A8; 224×224 images, 32×32 for ``cifar*``): the FSPTQ scheme
with per-channel min/max weights and per-tensor min/max inputs, RepVGG and
MobileOne in their deploy form; one seeded batch of 8 calibrates, then
``prepare_deploy``, an ``InferenceEngine`` with ``qmode='int'`` and
``measure_throughput`` over 20 batches.

Under a launched world of N ranks (one invocation a rank, as
``distributed_training``) the mesh is JAX's choice: ``('data', 'model')``
of shape (N/2, 2) where N is even, else (N, 1).  Rank 0 first measures
the replicated model alone while the others wait; then the engine shards
the int8 plans over the model axis (``parallel.sharding_rules``), every
rank measures at once, and the rates are summed over the rows of the
data axis (a model group's ranks serve the same images).  On a card the
replicated engine replays a CUDA graph of its step
(``parallel.serving.InferenceEngine``); a model group's runs eagerly.  The line's
``model_axis`` gives the axis' size, the transport of its gathers
(``parallel.mesh.model_transport``: NCCL between cards, gloo through host
memory where ranks share a card) and the ranks a card.  Rank 0 prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.distributed as dist

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.examples.distributed_training import dist_args, join
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.parallel import mesh as mesh_lib
from dlmc_quant_torch.parallel.serving import (InferenceEngine,
                                               measure_throughput)
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import calibrate

N_BATCHES = 20


def image_shape(model_name: str):
    return (32, 32, 3) if "cifar" in model_name else (224, 224, 3)


def scheme(w_bits: int, a_bits: int):
    """FSPTQ with per-channel min/max weights and per-tensor min/max
    inputs (``examples/serve_benchmark.py``'s)."""
    return scheme_from_dict({
        "quantization_type": "FSPTQ",
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": w_bits, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": a_bits, "signed": False}},
    })


def build(model_name: str, w_bits: int, a_bits: int, device):
    """The model at ``w_bits``/``a_bits``, calibrated on one seeded batch
    of 8 and prepared for integer execution."""
    kwargs = ({"deploy": True}
              if model_name.lower().startswith(("repvgg", "mobileone"))
              else {})
    model = get_model(model_name, device=device,
                      scheme=scheme(w_bits, a_bits),
                      generator=torch.Generator().manual_seed(1), **kwargs)
    x = torch.rand((8,) + image_shape(model_name),
                   generator=torch.Generator().manual_seed(0)).to(device)
    calibrate(model, [x])
    return prepare_deploy(model)


def _sum_over_ranks(value: float) -> float:
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, group=mesh_lib.vote_group())
    return float(t)


def main(argv=None) -> int:
    ns, rest = dist_args(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model", nargs="?", default="RepVGG_A0")
    p.add_argument("batch", nargs="?", type=int, default=128)
    p.add_argument("w_bits", nargs="?", type=int, default=8)
    p.add_argument("a_bits", nargs="?", type=int, default=8)
    p.add_argument("-d", "--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(rest)
    device = join(ns, resolve_device(args.device))
    try:
        ranks = mesh_lib.world_size()
        n_model = 2 if ranks % 2 == 0 else 1
        mesh = mesh_lib.make_mesh(axes=("data", "model"),
                                  shape=(ranks // n_model, n_model))
        rank = mesh_lib.rank()
        transport = mesh_lib.model_transport(mesh)
        if rank == 0 and n_model > 1:
            print(f"model axis: {n_model} ranks a group, gathers by "
                  f"{transport}", flush=True)
        model = build(args.model, args.w_bits, args.a_bits, device)
        image = image_shape(args.model)
        what = f"{args.model} W{args.w_bits}A{args.a_bits}"
        results = {}
        ips = measure_throughput(
            InferenceEngine(model, None, batch_size=args.batch, qmode="int",
                            device=device),
            image, N_BATCHES) if rank == 0 else 0.0
        results["1_devices"] = round(ips, 1)
        if rank == 0:
            print(f"{what} on 1 device: {ips:.1f} img/s", flush=True)
        if ranks > 1:
            # a model group's forward gathers over gloo or NCCL: eager
            eng = InferenceEngine(model, mesh, batch_size=args.batch,
                                  qmode="int", device=device,
                                  graph=None if n_model == 1 else False)
            dist.barrier(group=mesh_lib.vote_group())
            total = _sum_over_ranks(measure_throughput(eng, image,
                                                       N_BATCHES)) / n_model
            results[f"{ranks}_devices"] = round(total, 1)
            results["scaling_efficiency"] = round(total / (ips * ranks), 3) \
                if rank == 0 else None
            if rank == 0:
                print(f"{what} on {ranks} devices (mesh {ranks // n_model} "
                      f"x {n_model}): {total:.1f} img/s", flush=True)
        results["model_axis"] = f"{n_model} ({transport})" if n_model > 1 \
            else "1"
        if rank == 0:
            print(json.dumps(results), flush=True)
    finally:
        mesh_lib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
