"""Parameter sharding rules for the model axis: the int8 plans sharded
over output channels.

Counterpart of ``dlmc_quant_tpu/parallel/sharding_rules.py``.  JAX puts
every leaf whose last axis (the output channels of an HWIO or IO kernel,
and of every per-channel vector) divides by the ``'model'`` axis on that
axis, and XLA SPMD inserts the gathers.  Here one process is one rank,
so :func:`shard_params` rebuilds each quantized layer's integer plan at
this rank's block of output channels (``QLayer.shard_plan``), and the
chain gathers the blocks over the model group where a consumer needs all
the channels (``quant.chain.Shard``):

* the plan is cut from the unpacked int8 weights and the per-channel
  vectors (``w_scale``, ``colsum``, ``bias0``, ``bias_eff``,
  ``epi_scale``, ``w_offset``, ``off_scale``), and the kernels' packed
  forms (``w_packed``, ``w_gemm``, ``w_dw``, ``w_stem``, ``w_mm``, the
  W4 nibbles) are packed again from the block: their layouts are not
  row-major over O;
* a grouped conv keeps whole groups on a rank (G % n == 0, else it is
  replicated) and reads its groups' input channels; a depthwise conv
  reads its own block of channels;
* what JAX's rule replicates, the port replicates: a layer whose O does
  not divide by n or is smaller than n.  A layer without a plan (no
  quantizer, or not prepared) stays replicated too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from dlmc_quant_torch.parallel import mesh as mesh_lib

Spec = Tuple[Optional[str], ...]


def param_pspec(shape_or_tensor: Union[Sequence[int], torch.Tensor],
                n_shards: int, axis: str = "model") -> Spec:
    """The partition of a leaf of this shape (JAX's layout, output
    channels last) as a tuple of axis names, one an axis (JAX's
    ``PartitionSpec``): the last axis on ``axis`` where it divides by
    ``n_shards`` and is at least ``n_shards``, else ``()``, replicated;
    a scalar is replicated."""
    shape = tuple(shape_or_tensor.shape
                  if isinstance(shape_or_tensor, torch.Tensor)
                  else shape_or_tensor)
    if not shape:
        return ()
    if shape[-1] % n_shards == 0 and shape[-1] >= n_shards:
        return (None,) * (len(shape) - 1) + (axis,)
    return ()


def shardable(layer, n_shards: int, axis: str = "model") -> bool:
    """Whether :func:`param_pspec` splits the layer's kernel (its output
    channels, the last axis of JAX's HWIO or IO layout) and, for a
    grouped conv, whole groups fall on each rank."""
    groups = getattr(layer, "groups", 1)
    return bool(param_pspec((layer.weight.shape[0],), n_shards, axis)) \
        and (groups == 1 or groups % n_shards == 0)


def shard_params(module: torch.nn.Module, mesh, axis: str = "model"):
    """Slice, in place, every prepared quantized layer's integer plan to
    this rank's block of output channels along ``axis``; returns
    ``module``.  A mesh without ``axis``, or with one rank on it, leaves
    the module as it is; so does a layer that :func:`shardable` refuses
    (replicated).  Each layer's plan is rebuilt from its float weight and
    quantizers, so calling this again, or after ``prepare_deploy``, is
    safe."""
    from dlmc_quant_torch.quant.chain import Shard
    from dlmc_quant_torch.quant.layers import QLayer

    n = mesh_lib.axis_size(mesh, axis)
    if n == 1:
        return module
    rank = mesh_lib.axis_rank(mesh, axis)
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, QLayer) or m.cfg is None \
                    or not m.cfg.weight.enable or m.plan_scalars is None \
                    or not shardable(m, n, axis):
                continue
            full = m.weight.shape[0]
            per = full // n
            m.shard_plan(Shard(rank * per, (rank + 1) * per, full, mesh,
                               axis))
    return module
