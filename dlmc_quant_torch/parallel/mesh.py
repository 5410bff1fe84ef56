"""Process groups, the data mesh and the reductions of data-parallel
training.

Counterpart of ``dlmc_quant_tpu/parallel/mesh.py``.  JAX runs one
program over every device and XLA SPMD inserts the collectives; here one
process drives one card (or the CPU), the processes are joined by
``torch.distributed`` (NCCL between cards, gloo on the CPU), and the
collectives are explicit:

* :func:`init_distributed` is ``jax.distributed.initialize``: it joins the
  process group and opens a gloo group for host-side votes (the serving
  lockstep), whatever backend carries the tensors;
* :func:`make_mesh` is the ``('data',)`` mesh over every rank, a
  ``DeviceMesh``; without a process group it starts a one-rank gloo group
  on an in-process store (JAX's single-device case);
* :func:`shard_batch` and :func:`data_sharding` give this rank the rows
  that ``P('data')`` gives a device: a contiguous slice of the global
  batch; :func:`replicate_tree` broadcasts from rank 0;
* inside :func:`data_parallel` every statistic that the train forward takes
  over the batch (:func:`batch_mean`, :func:`batch_numel`) is the global
  batch's, so that N ranks compute what one process computes on the whole
  batch; :func:`all_reduce_grads` takes the mean of the gradients.

The model axis (``parallel.sharding_rules``: the int8 plans sharded over
output channels on ``'model'``): :func:`gather_channels` puts the ranks'
blocks of a layer's output side by side on the channel axis, and
:func:`model_transport` says how.  The transport is the default group's,
chosen once by :func:`init_distributed`: NCCL where each rank has a card
of its own, gloo where ranks share a card (two processes on one card
cannot form an NCCL group).  Gloo takes CUDA tensors in its all-gather
on the card's torch (2.11) and stages them through host memory itself,
as fast as an explicit copy to pinned memory and back (a 2 × 64 MiB
gather 207.1 and 190.7 ms on an H100's host: gloo's TCP loopback, 0.36
GB/s, bounds both).  Nothing switches from one to the other after a
failure, and the kernels are the same either way.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dlmc_quant_torch.device import DeviceLike, resolve_device

# Process-wide, as torch.distributed's default group is: the gloo group of
# host-side votes, and (group, ranks) inside data_parallel(), which the
# BatchNorms and quantizers deep in a model's forward read.
_VOTES = None
_DATA = None


def init_distributed(coordinator: str, num_hosts: int, host_id: int,
                     device: DeviceLike = None) -> torch.device:
    """Join the process group of ``num_hosts`` processes at ``coordinator``
    (``host:port`` or ``tcp://host:port``) as rank ``host_id``; returns
    this rank's device.

    A CUDA device: rank r drives card ``r % device_count`` (the ranks are
    the processes of one machine).  Where each rank has a card of its own
    the group is NCCL (raising where NCCL is missing); where ranks share a
    card (more ranks than cards) it is gloo, since two processes on one
    card cannot form an NCCL group.  The CPU takes gloo.  There is no
    switch from one to the other.  With NCCL a gloo group over the same
    ranks carries the votes (:func:`vote_group`): a vote is a host value.
    """
    global _VOTES
    device = resolve_device(device)
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", host_id % cards)
        torch.cuda.set_device(device)
        if num_hosts <= cards:
            if not dist.is_nccl_available():
                raise RuntimeError("a CUDA device needs NCCL, and this "
                                   "torch has none")
            backend = "nccl"
    init_method = coordinator if "://" in coordinator \
        else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_hosts, rank=host_id)
    _VOTES = dist.new_group(backend="gloo") if backend != "gloo" else None
    return device


def shutdown() -> None:
    """Leave the process group (the vote group with it), if there is one."""
    global _VOTES
    if dist.is_initialized():
        dist.destroy_process_group()
    _VOTES = None


def vote_group():
    """The gloo group over every rank that carries host-side votes (None:
    the default group, itself gloo)."""
    if dist.get_backend() != "gloo" and _VOTES is None:
        raise RuntimeError("the default group is not gloo: join it with "
                           "init_distributed, which opens the vote group")
    return _VOTES


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("data",),
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over the ranks of the process group, named by ``axes``.

    The default is the 1-D ``data`` mesh over every rank; ``shape`` splits
    the ranks over several axes, e.g. ``axes=('data', 'model')``,
    ``shape=(N, 2)``: a rank's model group is the ranks of its row.  A
    mesh spans every rank (``n_devices`` may only repeat the world size).
    Without a process group this starts a one-rank gloo group on an
    in-process store.
    """
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(),
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"a mesh spans every rank: {n_devices} of {world}")
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes} does not "
                         f"hold {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axes))


def axis_size(mesh: Optional[DeviceMesh], axis: str = "data") -> int:
    """Ranks along ``axis`` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str = "data") -> int:
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str = "data"):
    return mesh.get_group(axis)


def data_sharding(mesh: Optional[DeviceMesh], n: int,
                  axis: str = "data") -> slice:
    """The rows of an ``n``-row global batch that ``P(axis)`` gives this
    rank: a contiguous slice; ``n`` must divide evenly, as in JAX."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"a batch of {n} does not split over {size} ranks")
    per = n // size
    r = axis_rank(mesh, axis)
    return slice(r * per, (r + 1) * per)


def shard_batch(batch, mesh: Optional[DeviceMesh], axis: str = "data"):
    """This rank's rows of every array of ``batch`` (a tuple)."""
    return tuple(a[data_sharding(mesh, len(a), axis)] for a in batch)


def replicate_tree(module: torch.nn.Module, mesh: Optional[DeviceMesh],
                   axis: str = "data") -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the axis' first
    rank, in place."""
    if axis_size(mesh, axis) == 1:
        return module
    group = axis_group(mesh, axis)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src, group=group)
    return module


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "data") -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated in rank order: the
    global batch of the local ones."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=axis_group(mesh, axis))
    return torch.cat(parts)


def model_transport(mesh: Optional[DeviceMesh],
                    axis: str = "model") -> str:
    """How :func:`gather_channels` moves the blocks over ``axis``: the
    backend, and for gloo whether the codes pass through host memory,
    with the ranks a card carries."""
    if axis_size(mesh, axis) == 1:
        return "none"
    if dist.get_backend() == "nccl":
        return "nccl, 1 rank per card"
    if not torch.cuda.is_available():
        return "gloo on the CPU"
    per_card = -(-world_size() // torch.cuda.device_count())
    return f"gloo through host memory, {per_card} ranks per card"


def gather_channels(x: torch.Tensor, mesh: Optional[DeviceMesh],
                    axis: str = "model") -> torch.Tensor:
    """Every rank's ``x`` (equal shapes, channels last) side by side on
    the last axis, in rank order along ``axis``: a sharded layer's blocks
    of output channels as the whole output, on ``x``'s device.

    The all-gather stacks the blocks on a new leading axis, (n, …, c), so
    an interleave copy follows, (…, n, c) → (…, n·c): one more read and
    write of the gathered bytes, on ``x``'s device.  Under gloo a CUDA
    ``x`` goes through host memory (module docstring)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    group = axis_group(mesh, axis)
    x = x.contiguous()
    stack = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(stack, x, group=group)
    else:
        dist.all_gather(list(stack.unbind(0)), x, group=group)
    return stack.movedim(0, -2).reshape(tuple(x.shape[:-1])
                                        + (n * x.shape[-1],))


def all_reduce_mean(t: torch.Tensor, mesh: Optional[DeviceMesh],
                    axis: str = "data") -> torch.Tensor:
    """The mean of ``t`` over the axis' ranks (no gradient)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=axis_group(mesh, axis))
    return t / size


def all_reduce_grads(params, mesh: DeviceMesh, axis: str = "data") -> None:
    """Replace every gradient by its mean over the axis' ranks, in one
    flat all-reduce (JAX's gradient of the global mean loss).  A parameter
    without a gradient keeps none: the optimizer steps it on zeros on every
    rank alike."""
    size = axis_size(mesh, axis)
    grads = [p.grad for p in params if p.grad is not None]
    if size == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis_group(mesh, axis))
    flat.div_(size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@contextlib.contextmanager
def data_parallel(mesh: Optional[DeviceMesh], axis: str = "data"):
    """Within this context the train forward's batch statistics are the
    global batch's (the data axis' ranks hold equal local batches)."""
    global _DATA
    size = axis_size(mesh, axis)
    saved = _DATA
    _DATA = (axis_group(mesh, axis), size) if size > 1 else None
    try:
        yield
    finally:
        _DATA = saved


class _GlobalSum(torch.autograd.Function):
    """The sum over the group's ranks; its gradient is the sum of the
    ranks' gradients (every rank's loss depends on every rank's term)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_mean(*local: torch.Tensor):
    """Means over this rank's batch → the means over the global batch
    (inside :func:`data_parallel`; else ``local`` as it is), one tensor for
    one and a tuple for several.  Several tensors (of one shape) share one
    all-reduce; the gradient flows through it to every rank's batch."""
    if _DATA is None:
        return local[0] if len(local) == 1 else local
    group, size = _DATA
    out = _GlobalSum.apply(torch.stack(local), group) / size
    return out[0] if len(local) == 1 else out.unbind()


def batch_numel(x: torch.Tensor) -> int:
    """Elements of the global batch of which ``x`` is this rank's part."""
    return x.numel() * (_DATA[1] if _DATA is not None else 1)


def check_replicas(module: torch.nn.Module, mesh: DeviceMesh,
                   axis: str = "data") -> str:
    """The sha256 of ``module``'s parameters and buffers (bytes, in name
    order); raises unless every rank of the axis holds the same bytes."""
    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    digest = h.hexdigest()
    size = axis_size(mesh, axis)
    if size > 1:
        digests = [None] * size
        dist.all_gather_object(digests, digest,
                               group=axis_group(mesh, axis))
        if len(set(digests)) != 1:
            raise RuntimeError(f"the replicas differ: {digests}")
    return digest
