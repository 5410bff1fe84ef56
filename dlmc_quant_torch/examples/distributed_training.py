"""Data-parallel training over several processes (baseline or QAT).

    python -m dlmc_quant_torch.examples.distributed_training \
        -c <config.yaml> [--device cpu] \
        [--coordinator HOST:PORT --num-hosts N --host-id I]

One invocation per rank, each with its own ``--host-id``; without
``--coordinator`` and with one host it is the single-process run.

Counterpart of ``examples/distributed_training.py`` (ref:
example/baseline/DDP_classification.py:26-77 and
example/quantization/DDP_RootQ_train.py:30-120):
``parallel.mesh.init_distributed`` joins the ranks (NCCL between cards,
rank r on card r; gloo with ``--device cpu``), ``DataLoader.shard`` gives
each rank its share of the training set, a 1-D data mesh spans the ranks,
and ``QATTrainer`` (a config with a ``quantization`` section) or
``Trainer`` steps each rank on its local batch, averaging the gradients and
reducing the BN statistics over the ranks.  The rest of the arguments go
to ``ConfigParser``; rank 0 alone writes the run directory, logs and saves
checkpoints.  A quantized config is calibrated on the global first batch,
gathered from every rank, so that the ranks start from the same quantizer
parameters (the JAX entry calibrates each host on its own first batch:
ROADMAP hazard C19).  At the end every rank checks that it holds the same
parameters and buffers as the others.
"""

from __future__ import annotations

import argparse
import sys

import torch

from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.examples.classification import (build_common,
                                                      trainer_kwargs)
from dlmc_quant_torch.parallel import mesh as mesh_lib
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.layers import calibrate
from dlmc_quant_torch.training.qat import QATTrainer
from dlmc_quant_torch.training.trainer import Trainer
from dlmc_quant_torch.utils.config import ConfigParser
from dlmc_quant_torch.utils.logging import get_logger, setup_logging


def dist_args(argv):
    """Split off the distributed flags; the rest goes to the entry's own
    parser."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--coordinator", default=None,
                   help="address of rank 0, host:port (several hosts)")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    return p.parse_known_args(argv)


def join(ns, device) -> torch.device:
    """Join the process group the flags name, if any; returns this rank's
    device."""
    if ns.coordinator is None and ns.num_hosts == 1:
        return device
    if ns.coordinator is None:
        raise ValueError("--num-hosts > 1 needs --coordinator")
    return mesh_lib.init_distributed(ns.coordinator, ns.num_hosts,
                                     ns.host_id, device)


def build_trainer(config, device, logger, mesh) -> Trainer:
    """This rank's trainer: the model from the config's seed, the training
    loader's share of this rank, a quantized model calibrated on the global
    first batch."""
    scheme = (scheme_from_dict(config["quantization"])
              if config.get("quantization") else None)
    model, optimizer, sched, train_l, valid_l = build_common(
        config, device, scheme=scheme)
    # each rank's share of the training set (ref: DistributedSampler,
    # DDP_RootQ_train.py:81-97)
    train_l = train_l.shard(mesh_lib.rank(), mesh_lib.world_size())
    if scheme is not None:
        x0, _ = next(iter(train_l))
        calibrate(model, [mesh_lib.all_gather_rows(
            torch.from_numpy(x0).to(device), mesh)])
    cls = QATTrainer if scheme is not None else Trainer
    return cls(model, optimizer, sched, train_l, valid_l, mesh=mesh,
               **trainer_kwargs(config, 0, logger))


def main(argv=None) -> int:
    ns, rest = dist_args(sys.argv[1:] if argv is None else argv)
    config = ConfigParser.from_args(rest, save_to_disk=ns.host_id == 0)
    device = join(ns, resolve_device(config.device))
    try:
        rank = mesh_lib.rank()
        logger = (setup_logging(config.log_dir) if rank == 0
                  else get_logger("dlmc", rank))
        logger.info("ranks=%d rank=%d device=%s backend=%s",
                    mesh_lib.world_size(), rank, device,
                    torch.distributed.get_backend()
                    if torch.distributed.is_initialized() else "none")
        mesh = mesh_lib.make_mesh()       # 1-D data mesh over every rank
        trainer = build_trainer(config, device, logger, mesh)
        result = trainer.train()
        logger.info("final: %s", result)
        digest = mesh_lib.check_replicas(trainer.model, mesh)
        logger.info("replicas: %d ranks hold the same state, sha256 %s",
                    mesh_lib.world_size(), digest)
    finally:
        mesh_lib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
