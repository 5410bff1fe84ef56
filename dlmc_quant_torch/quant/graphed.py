"""A served forward captured once a batch shape in a CUDA graph and replayed.

The port's counterpart of ``jax.jit`` on a serving forward
(``dlmc_quant_tpu/quant/deploy.py: make_serving_fn``, the JAX engine's
jitted ``_fwd``): JAX traces ``model.apply`` once a batch shape, with the
variables frozen in, and dispatches the compiled program as a whole.
Here :class:`GraphedForward` runs ``model(x, qmode=qmode)`` once a
(shape, dtype) of ``x`` under a CUDA graph capture and afterwards only
replays that graph: the host no longer walks the layers, derives the folded
boundaries or launches the kernels one by one on every request.

Per new (shape, dtype):

1. two forwards on a side stream, outside the capture: the first builds
   what is built at first use (nvcc, the kernels' shared-memory opt-ins,
   the tensor-map encoder's entry point, cuDNN's choice for a float layer,
   plans made lazily); the second runs with ``torch.cuda.
   set_sync_debug_mode("error")``, so a forward that makes the host wait
   for the card (an ``.item()``, a ``bool`` of a tensor, a copy to the
   host) raises there, naming its line, and never reaches the capture;
2. the capture of one forward into a static input and output, the kernel
   wrappers' launch counts recorded by kind (they count on the host, so
   they move only here, never on a replay);
3. each call copies ``x`` into the static input (zeros below its rows,
   where it has fewer), replays, and returns a clone of the static
   output: a later call does not overwrite what an earlier one returned.
   The three are one step under the graph's lock, so that two threads
   never interleave their inputs and replays.

A capture that fails raises :class:`CaptureError`; nothing falls back to
the eager forward.  What the graph holds is fixed at capture: the plans'
tensors (their addresses), the settings in force then (TF32 flags,
autocast) and the forward's control flow.  Re-planning a layer after a
capture (``prepare_deploy``, ``shard_params``) needs a new serving
function.  A model whose plans are sharded over a model axis is refused:
its gathers are collectives, through host memory on gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import traceback
from typing import Dict, Tuple

import torch

from dlmc_quant_torch.ops.cuda import int8_conv as _conv
from dlmc_quant_torch.ops.cuda import int8_dwconv as _dwconv
from dlmc_quant_torch.ops.cuda import int8_gemm as _gemm
from dlmc_quant_torch.ops.cuda import int8_im2col as _im2col
from dlmc_quant_torch.ops.cuda import int8_stem_pool as _stem
from dlmc_quant_torch.ops.cuda import int8_window_sum as _window

# kind → (module, wrapper, its counter): every launch count a served
# forward moves, the sub-counts (grouped, 5x5, ragged, 1x1) beside their
# kernel's
COUNTERS = {"conv": (_conv, "int8_conv3x3", "launches"),
            "conv_grouped": (_conv, "int8_conv3x3", "grouped_launches"),
            "gemm": (_gemm, "int8_gemm", "launches"),
            "im2col": (_im2col, "int8_im2col", "launches"),
            "stem_pool": (_stem, "int8_stem_pool", "launches"),
            "dwconv": (_dwconv, "int8_dwconv3x3", "launches"),
            "dwconv_5x5": (_dwconv, "int8_dwconv3x3", "launches_5x5"),
            "dwconv_ragged": (_dwconv, "int8_dwconv3x3", "launches_ragged"),
            "dwconv_1x1": (_dwconv, "int8_dwconv3x3", "launches_1x1"),
            "window_sum": (_window, "int8_window_sum", "launches"),
            "window_sum_grouped": (_window, "int8_window_sum",
                                   "launches_grouped")}

Key = Tuple[Tuple[int, ...], torch.dtype]


class CaptureError(RuntimeError):
    """A forward that cannot be captured in a CUDA graph."""


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count now, by kind (:data:`COUNTERS`)."""
    return {kind: getattr(getattr(mod, fn), attr)
            for kind, (mod, fn, attr) in COUNTERS.items()}


def sharded_layers(model: torch.nn.Module) -> list:
    """Names of the modules whose integer plan is sharded over a model
    axis (``QLayer.shard_plan``)."""
    return [name for name, m in model.named_modules()
            if getattr(m, "shard", None) is not None]


def culprit(exc: BaseException) -> str:
    """Where ``exc`` (or the exception it was raised from, innermost
    first) came from: its innermost frame outside torch and this module,
    as ``file:line in function: code``."""
    chain = []
    while exc is not None and exc not in chain:
        chain.append(exc)
        exc = exc.__cause__ or exc.__context__
    skip = (os.path.dirname(torch.__file__), __file__)
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if not f.filename.startswith(skip)]
        if frames:
            f = frames[-1]
            return f"{f.filename}:{f.lineno} in {f.name}: {f.line}"
    return "an op inside torch"


@contextlib.contextmanager
def no_host_syncs():
    """Any op that makes the host wait for the card raises inside."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@dataclasses.dataclass
class Captured:
    """One shape's graph, its static input and output, the launches
    recorded at its capture and the seconds the capture took (both
    forwards before it included)."""
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    y: torch.Tensor
    launches: Dict[str, int]
    capture_s: float
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` into the first rows of the static input, zeros in the
        rest, a replay on the current stream; a clone of the static
        output."""
        n = x.shape[0]
        with self.lock:
            self.x[:n].copy_(x)
            self.x[n:].zero_()
            self.graph.replay()
            return self.y.clone()


class GraphedForward:
    """``fn(x) -> logits``: ``model(x, qmode=qmode)`` on ``device`` (a
    CUDA device), captured once a (shape, dtype) of ``x`` and replayed
    (module docstring).

    ``launches[(shape, dtype)]`` holds the launches by kind recorded at
    that shape's capture, ``capture_s[(shape, dtype)]`` its seconds;
    :meth:`reset` drops every graph and frees their memory pools.
    """

    def __init__(self, model: torch.nn.Module, qmode: str,
                 device: torch.device):
        sharded = sharded_layers(model)
        if sharded:
            raise ValueError(
                f"a model whose plans are sharded over a model axis "
                f"({', '.join(sharded[:3])}, ...) cannot be captured in a "
                f"CUDA graph (its gathers are collectives); pass "
                f"graph=False")
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{device}; pass graph=False (the eager "
                             f"forward)")
        self.model, self.qmode, self.device = model, qmode, device
        self._graphs: Dict[Key, Captured] = {}
        self._lock = threading.Lock()       # one capture at a time

    @property
    def launches(self) -> Dict[Key, Dict[str, int]]:
        return {k: g.launches for k, g in self._graphs.items()}

    @property
    def capture_s(self) -> Dict[Key, float]:
        return {k: g.capture_s for k, g in self._graphs.items()}

    def captured(self, shape, dtype, capture: bool = True) -> Captured:
        """The graph of ``(shape, dtype)``, captured first where there is
        none (with ``capture=False`` a missing one raises)."""
        key = (tuple(shape), dtype)
        with self._lock:
            if key not in self._graphs:
                if not capture:
                    raise RuntimeError(f"no CUDA graph captured for input "
                                       f"{key}, and none may be captured "
                                       f"now")
                self._graphs[key] = self._capture(*key)
            return self._graphs[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.cuda.device(self.device), torch.inference_mode():
            return self.captured(x.shape, x.dtype).run(x)

    def reset(self) -> None:
        with self._lock:
            self._graphs.clear()

    def _capture(self, shape, dtype) -> Captured:
        t0 = time.perf_counter()
        with torch.cuda.device(self.device), torch.inference_mode():
            x = torch.zeros(shape, dtype=dtype, device=self.device)

            def run():
                return self.model(x, qmode=self.qmode)

            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                run()
                try:
                    with no_host_syncs():
                        run()
                except RuntimeError as e:
                    raise CaptureError(
                        f"the forward at {shape} {dtype} makes the host "
                        f"wait for the card at {culprit(e)}: {e}") from e
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            try:
                with torch.cuda.graph(graph):
                    with no_host_syncs():
                        y = run()
            except RuntimeError as e:
                # a failed capture_end leaves the capture stream current
                torch.cuda.set_stream(stream)
                raise CaptureError(
                    f"the CUDA graph capture of the forward at {shape} "
                    f"{dtype} failed at {culprit(e)}: {e}") from e
            after = launch_counts()
            if not isinstance(y, torch.Tensor):
                raise CaptureError(f"the forward returned "
                                   f"{type(y).__name__}, not a tensor")
        return Captured(graph, x, y,
                        {k: after[k] - before[k] for k in after},
                        time.perf_counter() - t0)
