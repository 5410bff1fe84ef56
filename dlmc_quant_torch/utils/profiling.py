"""Profiling helpers: torch.profiler traces, card timing and rooflines.

The port of ``dlmc_quant_tpu/utils/profiling.py`` and, for timing, of
``tools/tpu_timing.py``.  :func:`trace` wraps a region in a
``torch.profiler`` trace; :class:`StepTimer` times host steps fenced by
``torch.cuda.synchronize()``; :func:`event_ms` and :func:`graph_ms` time
device work with CUDA events; :func:`roofline` and :func:`roof_ms` hold a
time against the card's published peaks, :func:`copy_rate` measures the
memory rate a device copy reaches.  Timing needs a CUDA card: with
none these raise, they never time the CPU instead.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional

import torch

# Published dense peaks (NVIDIA data sheets, SXM parts, full power limit),
# keyed on torch.cuda.get_device_name().  A card not listed raises.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8": 1979e12, "bf16": 989e12,
                              "bytes": 3.35e12},
}
PEAK_INT8_OPS = PEAKS["NVIDIA H100 80GB HBM3"]["int8"]
PEAK_BYTES = PEAKS["NVIDIA H100 80GB HBM3"]["bytes"]


def card_peaks(name: Optional[str] = None) -> Dict[str, float]:
    """Peaks of the card called ``name`` (default: CUDA device 0)."""
    name = name if name is not None else torch.cuda.get_device_name(0)
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}; known: "
                       f"{sorted(PEAKS)}")
    return PEAKS[name]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(path: str):
    """``with trace("run.json") as prof: ...`` → Chrome trace at ``path``.

    Records the CPU and, where there is a card, CUDA activity; the
    profiler is yielded so the caller can read ``key_averages()``.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


class StepTimer:
    """Host-clock step timer; :meth:`stop` first waits for the card."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def event_ms(fn: Callable[[], object], reps: int) -> float:
    """Median device ms of ``fn()`` over ``reps`` runs, each between two
    CUDA events (host gaps between runs are not counted, launch costs
    inside one run are)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn: Callable[[int], object], launches: int = 32,
             reps: int = 5) -> float:
    """Device ms per call of ``fn(i)``, without host gaps between calls.

    Captures ``fn(0) … fn(launches - 1)`` back to back in one CUDA graph
    and times ``reps`` replays with CUDA events; returns the median replay
    over ``launches``.  Kernels of a few µs then cost what the card takes,
    not what the host takes to launch them (the counterpart of the TPU
    tools' ``lax.scan`` of dispatches).  ``fn`` is called ``launches``
    times once before the capture (warm-up, first builds).
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(launches):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(i)
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def copy_rate(nbytes: int = 2 ** 28, reps: int = 10) -> float:
    """Bytes/s (read + written) of a device-to-device copy of ``nbytes``:
    the memory rate a plain streaming kernel reaches on this card, to set
    beside the data sheet's rate that the byte bounds use."""
    src = torch.zeros(nbytes, dtype=torch.int8, device="cuda")
    dst = torch.empty_like(src)
    return 2 * nbytes / (event_ms(lambda: dst.copy_(src), reps) * 1e-3)


def roof_ms(ops: float, nbytes: float):
    """(ops ms, bytes ms): ``ops`` int8 operations at the H100 SXM's peak
    rate, ``nbytes`` at its memory rate.  The larger is the least time the
    card could take, the bound."""
    return ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_by(ops_ms: float, bytes_ms: float) -> str:
    """Which of the two :func:`roof_ms` times bounds."""
    return "operations" if ops_ms >= bytes_ms else "bytes"


def roofline(macs: int, seconds: float, dtype: str = "int8",
             name: Optional[str] = None) -> Dict:
    """Achieved TOP/s and share of the peak of the card called ``name``
    (default: CUDA device 0)."""
    achieved = 2.0 * macs / seconds
    peak = card_peaks(name)[dtype]
    return {"achieved_tops": achieved / 1e12,
            "peak_tops": peak / 1e12,
            "utilization": achieved / peak}
