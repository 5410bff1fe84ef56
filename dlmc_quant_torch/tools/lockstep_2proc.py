"""Two-process lockstep serving: two OS processes joined by
``torch.distributed``, each driving a lockstep ``InferenceEngine`` with
unequal request streams (process 0 submits 4× what process 1 submits).

    python -m dlmc_quant_torch.tools.lockstep_2proc [--device cpu] [--port N]

The port of ``tools/lockstep_2proc.py``.  The lockstep protocol
(``parallel/serving.py``) exists for several ranks: every rank must run
the same sequence of steps.  Each process checks that every future
resolves with the right shape, that its engine exits by consensus (no
deadlock, no straggler) and that both processes count the same steps,
gathered at the end.  The processes join over gloo on ``localhost`` (a
free port unless ``--port`` is given) and carry only votes; the engines
run on ``--device``: both on card 0 by default (two processes on one card
cannot form an NCCL group, so the votes go over gloo there too).  Prints
``LOCKSTEP 2-PROC: PASS`` and exits 0, or ``FAIL`` and 1.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120     # both children, together
ROOT = Path(__file__).resolve().parents[2]


class Tiny(torch.nn.Module):
    """A dense head over the flattened image (the JAX tool's ``Tiny``)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.dense = torch.nn.Linear(8 * 8 * 3, 10)

    def forward(self, x, qmode: str = "fp"):
        return self.dense(x.reshape(x.shape[0], -1))


def child(pid: int, port: int, device: str) -> None:
    from dlmc_quant_torch.parallel import mesh as mesh_lib
    from dlmc_quant_torch.parallel.serving import InferenceEngine

    # the group carries votes only: gloo, whatever the engines run on
    mesh_lib.init_distributed(f"localhost:{port}", 2, pid, device="cpu")
    assert dist.get_world_size() == 2
    eng = InferenceEngine(Tiny(), mesh=None, batch_size=8, qmode="fp",
                          tick_ms=5.0, consensus_every=4,
                          device=torch.device(device, 0)
                          if device == "cuda" else device)
    assert eng.lockstep, "two ranks must turn lockstep on"
    eng.warmup((8, 8, 3))
    eng.start()

    n_req = 16 if pid == 0 else 4          # unequal streams
    futs = [eng.submit(np.random.default_rng(pid * 100 + i)
                       .random((2, 8, 8, 3), np.float32))
            for i in range(n_req)]
    if pid == 1:
        time.sleep(0.05)                   # extra desync
    for f in futs:
        out = f.result(timeout=60)
        assert out.shape == (2, 10), out.shape
    eng.stop(timeout=60)
    if eng._thread.is_alive():
        raise RuntimeError("dispatcher failed to exit")

    steps = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
    dist.all_gather(steps, torch.tensor([eng.steps]))
    if steps[0] != steps[1]:
        raise RuntimeError(f"step counts diverged: {steps}")
    print(f"proc {pid}: {n_req} requests resolved on {eng.device}, "
          f"steps={eng.steps}, pad_waste={eng.stats['pad_waste']}, "
          f"consensus shutdown ok", flush=True)
    mesh_lib.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--child", type=int, default=None)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass --device cpu to run on the CPU")
    if args.child is not None:
        child(args.child, args.port, args.device)
        return 0
    port = args.port or free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dlmc_quant_torch.tools.lockstep_2proc",
         "--child", str(i), "--port", str(port), "--device", args.device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
        for i in range(2)]
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
        tail = "\n".join(out.strip().splitlines()[-3:])
        print(f"--- proc {i} (rc={proc.returncode}) ---\n{tail}")
        ok = ok and proc.returncode == 0
    print("LOCKSTEP 2-PROC:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
