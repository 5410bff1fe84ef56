"""ms a QAT step of cifar_resnet20 W4A4 at batch 128, split into device
time and host and gaps; on this tree or on another.

    python dlmc_quant_torch/tools/step_time.py [--root DIR] [--steps N] [lsq|rootq ...]

Each family's trainer is the QAT entry's ``build_trainer`` on the
family's config in ``examples/configs`` (``CONFIGS``), cut to one epoch
of 2048 synthetic images, its model calibrated on the first batch, as
``chip_smoke.py``'s qat phase builds it.  The step is ``train_step`` on the
first training batch at the default precision, timed by
``utils.profiling.step_split``: wall ms over ``--steps`` steps, device ms
over a CUDA graph of 4 steps, the profiler's kernels a step, host and
gaps.

``--root DIR`` imports ``dlmc_quant_torch`` from DIR instead of this tree,
so that two trees' steps can be timed on one card in one call, turn about
(run the file as a script for that, not with ``-m``).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

IMAGES = 2048
CONFIGS = {"lsq": "QAT_lsq_resnet20_cifar10_w4a4",
           "rootq": "RootQ_resnet20_cifar10_w4a4"}


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--root", default=None,
                      help="the tree whose dlmc_quant_torch is timed")
    args.add_argument("--steps", type=int, default=20)
    args.add_argument("family", nargs="*", default=list(CONFIGS),
                      help="lsq, rootq or both")
    opts = args.parse_args(argv)
    root = pathlib.Path(opts.root or pathlib.Path(__file__).parents[2])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch
    from dlmc_quant_torch.examples import quantization_aware_training as qat
    from dlmc_quant_torch.utils.config import ConfigParser, read_yaml
    from dlmc_quant_torch.utils.logging import get_logger
    from dlmc_quant_torch.utils.profiling import card_line, step_split
    if not torch.cuda.is_available():
        raise SystemExit("step_time: no CUDA device")
    rows = {}
    for family in opts.family:
        cfg = read_yaml(root / "examples" / "configs"
                        / f"{CONFIGS[family]}.yaml")
        cfg["train_loader"]["args"]["n_samples"] = IMAGES
        cfg["n_runs"], cfg["trainer"]["epochs"] = 1, 1
        trainer = qat.build_trainer(
            ConfigParser(cfg, "cuda", save_to_disk=False), "cuda",
            get_logger("step_time"))
        x, y = next(iter(trainer.train_loader))
        x = torch.as_tensor(x).to("cuda")
        y = torch.as_tensor(y).to("cuda").long()
        split = step_split(lambda: trainer.train_step(x, y), opts.steps)
        rows[family] = split
        print(f"# step_time {family} w4a4, batch {len(x)}, tree {root}: "
              f"{split['wall_ms']:.3f} ms a step; device "
              f"{split['device_ms']:.3f} ms, {split['kernels']:.0f} kernels "
              f"a step, host and gaps {split['host_gap_ms']:.3f} ms; "
              f"{card_line()}", flush=True)
    return rows


if __name__ == "__main__":
    main()
