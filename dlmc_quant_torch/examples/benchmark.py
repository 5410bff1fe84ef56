"""Throughput harness: images/s per model and round, training or
inference, on synthetic data, over the data mesh.

    python -m dlmc_quant_torch.examples.benchmark \
        [-c examples/configs/benchmark.yaml] [--device cpu] \
        [--coordinator HOST:PORT --num-hosts N --host-id I]

Counterpart of ``examples/benchmark.py`` (ref:
example/benchmark/benchmark.py:35-215).  The YAML names the models,
``batch_size`` (the global batch), ``image_size``, ``mode`` (``inference``
or ``train``), ``warmup``, ``steps``, ``rounds`` and ``num_classes``.  A
seeded global batch is split over the data mesh (each rank its contiguous
slice) and the model is broadcast from rank 0.  Inference is a float
forward of the module as it sits on the device; training is SGD at rate
0.1 with momentum 0.9 on the cross-entropy, the BN statistics of the
flax-style BatchNorm and the gradients reduced over the ranks (a torch
``BatchNorm2d``, RepVGG's train form, keeps its rank's statistics: the
harness times the step, it does not train).  Rank 0 prints one JSON line
of images/s (the global batch over the step time).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.examples.distributed_training import dist_args, join
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.parallel import mesh as mesh_lib
from dlmc_quant_torch.utils.config import read_yaml


def bench_model(name: str, batch_size: int, image_size: int, mode: str,
                warmup: int, steps: int, mesh, device,
                num_classes: int = 1000) -> float:
    """Images/s of ``steps`` timed steps after ``warmup`` ones."""
    model = get_model(name, device=device, num_classes=num_classes,
                      generator=torch.Generator().manual_seed(2))
    x = torch.rand((batch_size, image_size, image_size, 3),
                   generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, num_classes, (batch_size,),
                      generator=torch.Generator().manual_seed(1))
    x, y = (a.to(device) for a in mesh_lib.shard_batch((x, y), mesh))
    mesh_lib.replicate_tree(model, mesh)
    ranks = mesh_lib.axis_size(mesh)

    if mode == "train":
        model.train()
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

        def step():
            with mesh_lib.data_parallel(mesh):
                logits = model(x)
            loss = F.cross_entropy(logits, y)
            opt.zero_grad()
            loss.backward()
            if ranks > 1:
                mesh_lib.all_reduce_grads(model.parameters(), mesh)
            opt.step()
            return loss
    else:
        def step():
            with torch.inference_mode():
                return model(x)

    for _ in range(warmup):
        out = step()
    float(out.sum())            # fence
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step()
    float(out.sum())
    return batch_size * steps / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ns, rest = dist_args(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-c", "--config", default="examples/configs/benchmark.yaml")
    p.add_argument("-d", "--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(rest)
    cfg = read_yaml(args.config)
    device = join(ns, resolve_device(args.device))
    try:
        mesh = mesh_lib.make_mesh()
        rank = mesh_lib.rank()
        mode = cfg.get("mode", "inference")
        results = {}
        for name in cfg["models"]:
            for r in range(int(cfg.get("rounds", 1))):
                ips = bench_model(
                    name, int(cfg.get("batch_size", 64)),
                    int(cfg.get("image_size", 224)), mode,
                    int(cfg.get("warmup", 2)), int(cfg.get("steps", 20)),
                    mesh, device, int(cfg.get("num_classes", 1000)))
                results.setdefault(name, []).append(round(ips, 1))
                if rank == 0:
                    print(f"{name} round {r}: {ips:.1f} img/s ({mode})",
                          flush=True)
        if rank == 0:
            print(json.dumps(results), flush=True)
    finally:
        mesh_lib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
