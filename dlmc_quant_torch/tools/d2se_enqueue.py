"""The host's part of a RepVGG-D2se request, split by what enqueues it; on
this tree or on another.

    python dlmc_quant_torch/tools/d2se_enqueue.py [--root DIR] [--requests N] [--batch B]

The model and images are ``bench_torch.py``'s ``prep`` of
``repvgg_d2se_int8`` (deploy form, seeded weights, the bench's W8A8
scheme), served eagerly through ``make_serving_fn(qmode="intc",
graph=False)`` (a tree older than the graphed serving function takes no
``graph``, and serves eagerly without it).  A request is
timed on the host's clock from its call to its return (the enqueue: the
card runs behind the host) and to the card's end (the wall).  Then the
same requests again with forward hooks and a wrapper on the SE block's
``materialize``, each reading the host's clock, and nothing synced, so
that each part's enqueue time adds up to the request's:

* ``conv``: the blocks' ``reparam`` convs, the input's quantize and the
  pending conv (no launch);
* ``conv_launch``: the SE blocks' ``materialize`` of that pending conv,
  its f32-mode launch of ``int8_conv3x3``;
* ``se_dense``: the SE blocks' ``down`` and ``up`` dense layers, each its
  input's quantize, the pad of its codes, ``torch._int_mm`` and the
  epilogue;
* ``se_rest``: the rest of the SE blocks (the spatial mean, the ReLU, the
  sigmoid and the gate's product);
* ``block_rest``: the rest of the blocks (the ReLU after the SE);
* ``head``: the rest of the request (the pool, the head, the call).

Prints one line for each part and the hooks' own cost (the request's
enqueue with them less without).  ``--root DIR`` imports
``dlmc_quant_torch`` and ``bench_torch`` from DIR instead of this tree, so
that two trees can be timed on one card in one call, turn about (run the
file as a script for that, not with ``-m``).
"""

from __future__ import annotations

import argparse
import collections
import inspect
import pathlib
import statistics
import sys
import time


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--root", default=None,
                      help="the tree whose dlmc_quant_torch is timed")
    args.add_argument("--requests", type=int, default=12)
    args.add_argument("--batch", type=int, default=64)
    opts = args.parse_args(argv)
    root = pathlib.Path(opts.root or pathlib.Path(__file__).parents[2])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch
    import bench_torch
    from dlmc_quant_torch import make_serving_fn
    from dlmc_quant_torch.models import repvgg
    from dlmc_quant_torch.utils.profiling import card_line
    if not torch.cuda.is_available():
        raise SystemExit("d2se_enqueue: no CUDA device")
    model, x = bench_torch.prep("RepVGG_D2se", opts.batch,
                                torch.device("cuda"))
    eager = ({"graph": False} if "graph" in inspect.signature(
        make_serving_fn).parameters else {})
    serve = make_serving_fn(model, qmode="intc", device=x.device, **eager)

    def requests():
        """(enqueue ms, wall ms) medians over the requests after the
        first."""
        enq, wall = [], []
        for _ in range(opts.requests + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(x)
            enq.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        return (statistics.median(enq[1:]) * 1e3,
                statistics.median(wall[1:]) * 1e3)

    plain_enq, plain_wall = requests()
    spent = collections.defaultdict(float)   # seconds by part, all requests
    started = {}
    handles = []
    in_se = [False]   # the head's materialize is not an SE block's

    def timed(module, part):
        def pre(mod, args):
            in_se[0] |= part == "se"
            started[id(mod)] = time.perf_counter()

        def post(mod, args, out):
            spent[part] += time.perf_counter() - started.pop(id(mod))
            in_se[0] &= part != "se"
        handles.append(module.register_forward_pre_hook(pre))
        handles.append(module.register_forward_hook(post))

    for name in model.block_names:
        block = getattr(model, name)
        timed(block, "blocks")
        timed(block.reparam, "conv")
        timed(block.se, "se")
        timed(block.se.down, "se_dense")
        timed(block.se.up, "se_dense")
    inner = repvgg.materialize

    def materialize(t):
        t0 = time.perf_counter()
        out = inner(t)
        if in_se[0]:
            spent["conv_launch"] += time.perf_counter() - t0
        return out

    repvgg.materialize = materialize
    try:
        serve(x)
        torch.cuda.synchronize()
        spent.clear()
        enq = 0.0
        for _ in range(opts.requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(x)
            enq += time.perf_counter() - t0
            torch.cuda.synchronize()
    finally:
        repvgg.materialize = inner
        for h in handles:
            h.remove()
    per = {k: v / opts.requests * 1e3 for k, v in spent.items()}
    enq_ms = enq / opts.requests * 1e3
    parts = {
        "conv": per["conv"],
        "conv_launch": per["conv_launch"],
        "se_dense": per["se_dense"],
        "se_rest": per["se"] - per["conv_launch"] - per["se_dense"],
        "block_rest": per["blocks"] - per["conv"] - per["se"],
        "head": enq_ms - per["blocks"],
    }
    print(f"# d2se_enqueue, batch {opts.batch}, tree {root}: request "
          f"{plain_wall:.3f} ms wall, enqueued after {plain_enq:.3f} ms "
          f"(medians of {opts.requests}); with the hooks enqueued after "
          f"{enq_ms:.3f} ms (mean), the hooks' cost "
          f"{enq_ms - plain_enq:.3f} ms; {card_line()}", flush=True)
    print("# d2se_enqueue parts, host ms a request: " + "; ".join(
        f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    return {"enqueue_ms": plain_enq, "wall_ms": plain_wall,
            "hooked_enqueue_ms": enq_ms, **parts}


if __name__ == "__main__":
    main()
