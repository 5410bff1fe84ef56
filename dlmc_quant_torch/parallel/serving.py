"""Quantized inference serving: continuous batching of requests into
fixed-shape device steps, and the multi-host lockstep protocol.

Counterpart of ``dlmc_quant_tpu/parallel/serving.py``.  Requests (single
images or micro-batches, NHWC float32) are queued; a dispatcher thread
packs them into batches of ``batch_size`` (zeros pad the tail), runs the
deploy-form module on the card and resolves one future a request.

Several ranks: each row of the mesh's data axis serves its own request
stream.  With a ``'model'`` axis larger than 1 the ranks of a row form a
model group: the engine shards the module's int8 plans over it
(``parallel.sharding_rules.shard_params``), every forward gathers each
layer's blocks of channels over the group, and so the group's ranks must
run the same batches.  JAX's single controller gives them one array;
here the group's first rank (its lead) takes the requests, and each
lockstep step broadcasts its padded batch to the other ranks of the
group before the forward; the lead resolves the futures with the
gathered logits.  ``submit`` on any other rank raises.  A collective
forward needs every rank to run the same sequence of steps: the protocol
below, as JAX's.

Lockstep (``lockstep=True``, the default when the process group has more
than one rank): batching on the timing of the local queue would desync
the ranks, so the dispatcher steps **unconditionally** on a fixed tick.
Each step drains at most one device batch from the local queue (an empty
queue pads a zero batch) and always runs the forward, so rank k's Nth
forward pairs with every other rank's Nth.  Shutdown is by consensus at
deterministic step indices: every ``consensus_every`` steps the ranks
gather a local ``want_stop`` flag (set by :meth:`stop` once the local
queue is drained) over the gloo vote group (``mesh.vote_group``), and
exit together when it is unanimous; the step count is then the same on
every rank.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dlmc_quant_torch.device import DeviceLike, resolve_device
from dlmc_quant_torch.parallel import mesh as mesh_lib
from dlmc_quant_torch.parallel.sharding_rules import shard_params
from dlmc_quant_torch.quant.graphed import GraphedForward


class InferenceEngine:
    """Continuous-batching engine over a deploy-form module.

    ``model`` has had ``prepare_deploy``; it is moved to ``device`` (the
    card unless the caller passes ``'cpu'``) and run in eval mode under
    ``torch.inference_mode`` with ``qmode``.  ``mesh`` is a mesh
    (``parallel.mesh.make_mesh``) or None.  Its ranks decide the lockstep
    default and the votes; where it has a ``'model'`` axis, the module's
    plans are sharded over that axis in place (module docstring), and
    ``forward`` must be called with the same batch on every rank of a
    model group.

    On a CUDA device the steps are graphed by default (``graph=None``), as
    JAX's engine calls its jitted forward: :meth:`warmup`, on the caller's
    thread and before :meth:`start`, captures the padded ``batch_size``
    forward in a CUDA graph (``quant.graphed.GraphedForward``, kept as
    :attr:`graphed`), and every step copies its batch into the graph's
    input and replays it; no capture runs once the dispatcher does.  The
    weights are then constants of the graph, as JAX freezes the variables
    into its program: a layer re-planned after the capture needs a new
    engine.  A capture that fails raises; nothing serves eagerly instead.
    ``graph=False`` and ``device="cpu"`` run the module eagerly each step
    (``graph=True`` on the CPU raises), and so must a model group: a
    sharded model refuses a graph (its gathers are collectives).

    There is no ``weight_resident`` argument: the module's integer plans
    already live on the device, so nothing is marshalled per call.  A
    kernel that fails raises in the step; its error goes to that step's
    futures, never a plain version in the kernel's place.
    """

    def __init__(self, model: torch.nn.Module, mesh=None,
                 batch_size: int = 64, qmode: str = "int",
                 max_wait_ms: float = 2.0, lockstep: Optional[bool] = None,
                 tick_ms: float = 5.0, consensus_every: int = 8,
                 device: DeviceLike = None, graph: Optional[bool] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.qmode = qmode
        self.max_wait = max_wait_ms / 1e3
        self.ranks = mesh_lib.world_size()
        self.lockstep = self.ranks > 1 if lockstep is None else bool(lockstep)
        self.mesh = mesh
        self.model_ranks = mesh_lib.axis_size(mesh, "model")
        self.lead = mesh_lib.axis_rank(mesh, "model") == 0
        if self.model_ranks > 1:
            if not self.lockstep:
                raise ValueError("a model group steps in lockstep: its "
                                 "ranks must run the same batches")
            shard_params(self.model, mesh, "model")
        if graph is None:
            graph = self.device.type == "cuda"
        self.graphed = (GraphedForward(self.model, qmode, self.device)
                        if graph else None)
        self.tick = tick_ms / 1e3
        self.consensus_every = max(int(consensus_every), 1)
        self.steps = 0                  # lockstep: local dispatch count
        self._image_shape = None        # set by warmup()
        self._queue: "queue.Queue" = queue.Queue()
        self._carry = None              # request deferred to the next batch
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"batches": 0, "images": 0, "pad_waste": 0}

    # -- synchronous API ---------------------------------------------------

    def _on_device(self):
        """The device as the calling thread's current one: a new thread's
        current CUDA device is 0, and the kernels launch on the current
        device's stream."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def forward(self, x) -> torch.Tensor:
        """Direct fixed-batch forward: ``x`` (n, H, W, C), numpy or a
        tensor, padded with zeros to ``batch_size`` rows; returns the first
        ``n`` rows of the logits, on the device.  Graphed, the rows go
        straight into the graph's static input and the graph is replayed;
        a batch shape without a graph is captured first, unless the
        dispatcher runs (then it raises)."""
        n = x.shape[0]
        x = torch.as_tensor(x)
        with self._on_device(), torch.inference_mode():
            if self.graphed is not None:
                g = self.graphed.captured(
                    (max(n, self.batch_size),) + tuple(x.shape[1:]), x.dtype,
                    capture=self._thread is None
                    or not self._thread.is_alive())
                return g.run(x)[:n]
            if n < self.batch_size:
                xb = torch.zeros((self.batch_size,) + tuple(x.shape[1:]),
                                 dtype=x.dtype, device=self.device)
                xb[:n].copy_(x)
            else:
                xb = x.to(self.device)
            return self.model(xb, qmode=self.qmode)[:n]

    def warmup(self, image_shape):
        """One padded step on the caller's thread: it builds the kernels
        and, graphed, captures the step's CUDA graph there, not on first
        use in the dispatcher."""
        self._image_shape = tuple(image_shape)
        x = np.zeros((self.batch_size,) + self._image_shape, np.float32)
        self.forward(x).cpu()

    # -- continuous batching ----------------------------------------------

    def start(self):
        if self.lockstep and self._image_shape is None:
            raise RuntimeError(
                "lockstep engines must warmup(image_shape) before start():"
                " empty steps need the padded batch shape")
        if self.graphed is not None and self._image_shape is None:
            raise RuntimeError(
                "graphed engines must warmup(image_shape) before start(): "
                "the step's CUDA graph is captured there")
        self._stop.clear()
        target = self._lockstep_loop if self.lockstep else self._loop
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 60):
        """Signal shutdown.  Lockstep mode keeps stepping until every rank's
        queue is drained and the stop consensus is unanimous, so the step
        count matches across ranks."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def submit(self, images: np.ndarray) -> Future:
        """Enqueue a request (K, H, W, C); the future resolves to a numpy
        (K, classes) array.

        A request larger than the device batch is split into chunks and
        put back together before the future resolves.  Under a model axis
        only the group's first rank takes requests: on the others this
        raises (they run the lead's batches)."""
        if not self.lead:
            raise RuntimeError("submit to the model group's first rank: "
                               "the other ranks run its batches")
        images = np.asarray(images)
        if images.shape[0] <= self.batch_size:
            fut: Future = Future()
            self._queue.put((images, fut))
            return fut
        chunks = [images[i:i + self.batch_size]
                  for i in range(0, images.shape[0], self.batch_size)]
        parts = [Future() for _ in chunks]
        for c, f in zip(chunks, parts):
            self._queue.put((c, f))
        out: Future = Future()

        def _gather():
            try:
                out.set_result(np.concatenate([f.result() for f in parts]))
            except Exception as e:   # noqa: BLE001 — surfaced via the future
                out.set_exception(e)

        threading.Thread(target=_gather, daemon=True).start()
        return out

    def _shared_batch(self, batch, n: int) -> np.ndarray:
        """The model group lead's padded float32 batch on every rank of the
        group (a broadcast over the group; on the host for gloo)."""
        x = np.zeros((self.batch_size,) + self._image_shape, np.float32)
        if n:
            x[:n] = np.concatenate(batch)
        group = mesh_lib.axis_group(self.mesh, "model")
        t = torch.from_numpy(x)
        if dist.get_backend(group) == "nccl":
            t = t.to(self.device)
        dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
        return t.cpu().numpy()

    def _run(self, batch, n: int):
        """One step: (numpy logits of the ``n`` real rows, None) or (None,
        the error)."""
        try:
            if self.model_ranks > 1:
                x = self._shared_batch(batch, n)
            elif n:
                x = np.concatenate(batch)
            else:   # an empty lockstep step: the forward must still run
                x = np.zeros((self.batch_size,) + self._image_shape,
                             np.float32)
            out, err = self.forward(x).cpu().numpy(), None
        except Exception as e:   # noqa: BLE001 — surfaced via the futures
            out, err = None, e
        self.stats["batches"] += 1
        self.stats["images"] += n
        self.stats["pad_waste"] += self.batch_size - n
        return out, err

    @staticmethod
    def _resolve(futs, sizes, out, err):
        off = 0
        for f, k in zip(futs, sizes):
            if err is None:
                f.set_result(out[off:off + k])
            else:
                f.set_exception(err)
            off += k

    def _loop(self):
        while not self._stop.is_set():
            batch, futs, sizes = [], [], []
            total = 0
            deadline = None
            while total < self.batch_size:
                if self._carry is not None:
                    imgs, fut = self._carry
                    self._carry = None
                else:
                    timeout = (self.max_wait if deadline is None
                               else max(deadline - time.perf_counter(), 0))
                    try:
                        imgs, fut = self._queue.get(timeout=timeout)
                    except queue.Empty:
                        break
                if total + len(imgs) > self.batch_size:
                    # would overflow the fixed device batch: the whole
                    # request goes to the next step (each future's result
                    # stays whole)
                    self._carry = (imgs, fut)
                    break
                if deadline is None:
                    deadline = time.perf_counter() + self.max_wait
                batch.append(imgs)
                futs.append(fut)
                sizes.append(len(imgs))
                total += len(imgs)
            if not batch:
                continue
            self._resolve(futs, sizes, *self._run(batch, total))

    # -- lockstep dispatcher (multi-rank collective-safe) -------------------

    def _collect_until(self, deadline: float):
        """Drain up to one device batch from the local queue, never
        blocking past ``deadline``.  Returns (arrays, futures, sizes)."""
        batch, futs, sizes = [], [], []
        total = 0
        while total < self.batch_size:
            if self._carry is not None:
                imgs, fut = self._carry
                self._carry = None
            else:
                timeout = deadline - time.perf_counter()
                try:
                    # behind schedule (slow forward): still drain what is
                    # already queued, without blocking
                    imgs, fut = (self._queue.get_nowait() if timeout <= 0
                                 else self._queue.get(timeout=timeout))
                except queue.Empty:
                    break
            if total + len(imgs) > self.batch_size:
                self._carry = (imgs, fut)
                break
            batch.append(imgs)
            futs.append(fut)
            sizes.append(len(imgs))
            total += len(imgs)
        return batch, futs, sizes

    def _unanimous(self, want: bool) -> bool:
        """Every rank's ``want`` gathered over the gloo vote group."""
        if self.ranks == 1:
            return want
        group = mesh_lib.vote_group()
        votes = [torch.zeros(1, dtype=torch.int32)
                 for _ in range(self.ranks)]
        dist.all_gather(votes, torch.tensor([int(want)], dtype=torch.int32),
                        group=group)
        return all(bool(v) for v in votes)

    def _lockstep_loop(self):
        """Fixed-cadence stepping (the module docstring's protocol): every
        rank runs the same number of forwards."""
        next_tick = time.perf_counter()
        while True:
            next_tick += self.tick
            batch, futs, sizes = self._collect_until(next_tick)
            self._resolve(futs, sizes, *self._run(batch, sum(sizes)))
            self.steps += 1
            # consensus shutdown at deterministic step indices
            if self.steps % self.consensus_every == 0:
                want = (self._stop.is_set() and self._queue.empty()
                        and self._carry is None)
                if self._unanimous(want):
                    return
            now = time.perf_counter()
            if next_tick > now:
                time.sleep(next_tick - now)
            else:       # cadence slipped (slow step): don't accumulate lag
                next_tick = now


def measure_throughput(engine: InferenceEngine, image_shape,
                       n_batches: int = 20) -> float:
    """Images/s through the engine's fixed-batch forward: the same
    ``default_rng(0)`` batch each step, fenced by the card's synchronize."""
    x = np.random.default_rng(0).random(
        (engine.batch_size,) + tuple(image_shape), np.float32)
    engine.warmup(image_shape)
    t0 = time.perf_counter()
    out = None
    for _ in range(n_batches):
        out = engine.forward(x)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    float(out.sum())
    dt = time.perf_counter() - t0
    return engine.batch_size * n_batches / dt
