"""Reparameterization: BN folding and RepVGG branch fusion.

Counterpart of ``dlmc_quant_tpu/models/fuse.py``, on OIHW kernels.
:func:`repvgg_fuse` turns a train-form RepVGG into its deploy form, one
3×3 conv per block (grouped where the block is, its SE block carried
over); :func:`resnet_deploy`, :func:`mobilenet_deploy`,
:func:`ghostnet_deploy` and :func:`efficientnet_deploy` fold a train-form
ResNet's, MobileNetV2's, GhostNet's or EfficientNet's BatchNorms into
their convs
(``models/mobileone.py`` has MobileOne's fuser, as in the JAX package).
The deploy model's quantizer parameters are fresh: calibrate after
fusing, as the JAX package does.  :func:`merge_bn` folds every conv→BN
pair that the traced compute graph shows, for any model, and keeps the
model's structure.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlmc_quant_torch.models.repvgg import RepVGG, RepVGGBlock
from dlmc_quant_torch.quant.layers import QConv, QDense
from dlmc_quant_torch.utils.count_ops import (BATCHNORMS, CONVS, DENSES,
                                              get_compute_graph)

BN_EPS = 1e-5


def fold_conv_bn(kernel, bias, gamma, beta, mean, var, eps: float = BN_EPS):
    """Fold BatchNorm(γ, β, μ, σ²) into an OIHW kernel and bias:
    ``k' = k·γ/σ`` per output channel, ``b' = β + (b − μ)·γ/σ``."""
    std = torch.sqrt(var + eps)
    t = gamma / std
    kernel = kernel * t.reshape((-1,) + (1,) * (kernel.dim() - 1))
    if bias is None:
        bias = torch.zeros_like(mean)
    return kernel, beta + (bias - mean) * t


def _bn_only_to_conv(gamma, beta, mean, var, in_features: int, groups: int,
                     eps: float = BN_EPS):
    """An identity-BN branch as an equivalent 3×3 conv (OIHW)."""
    out_features = gamma.shape[0]
    ig = in_features // groups
    kernel = torch.zeros((out_features, ig, 3, 3), dtype=gamma.dtype,
                         device=gamma.device)
    o = torch.arange(out_features, device=gamma.device)
    kernel[o, o % ig, 1, 1] = 1.0
    return fold_conv_bn(kernel, None, gamma, beta, mean, var, eps)


def _pad_1x1_to_3x3(kernel):
    """Center a 1×1 kernel in a 3×3 (OIHW)."""
    return F.pad(kernel, (1, 1, 1, 1))


def _bn_args(bn):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


@torch.no_grad()
def fuse_repvgg_block(block: RepVGGBlock, in_features: int, groups: int = 1):
    """Fuse one train-form block's three branches into (kernel3x3, bias)."""
    k3, b3 = fold_conv_bn(block.rbr_dense.weight, None,
                          *_bn_args(block.rbr_dense_bn))
    k1, b1 = fold_conv_bn(_pad_1x1_to_3x3(block.rbr_1x1.weight), None,
                          *_bn_args(block.rbr_1x1_bn))
    kernel, bias = k3 + k1, b3 + b1
    if hasattr(block, "rbr_identity"):
        kid, bid = _bn_only_to_conv(*_bn_args(block.rbr_identity),
                                    in_features, groups)
        kernel, bias = kernel + kid, bias + bid
    return kernel, bias


@torch.no_grad()
def repvgg_fuse(model: RepVGG) -> RepVGG:
    """Train-form RepVGG → deploy-form RepVGG on the same device."""
    device = model.linear.weight.device
    deploy = RepVGG(num_blocks=model.num_blocks,
                    width_multiplier=model.width_multiplier,
                    num_classes=model.num_classes,
                    override_groups_map=model.override_groups_map,
                    use_se=model.use_se, deploy=True, scheme=model.scheme,
                    in_features=model.in_features).to(device)
    prev = model.in_features
    for name in model.block_names:
        block = getattr(model, name)
        k, b = fuse_repvgg_block(block, prev, block.rbr_dense.groups)
        twin = getattr(deploy, name)
        twin.reparam.weight.copy_(k)
        twin.reparam.bias.copy_(b)
        if hasattr(block, "se"):      # as dlmc_quant_tpu/models/fuse.py:94-95
            twin.se.load_state_dict(block.se.state_dict())
        prev = k.shape[0]
    deploy.linear.weight.copy_(model.linear.weight)
    deploy.linear.bias.copy_(model.linear.bias)
    return deploy.train(model.training)


# a conv's BatchNorm, by each zoo family's fixed naming
RESNET_BN_PARTNERS = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
                      "downsample": "downsample_bn"}
MOBILENET_BN_PARTNERS = {"expand": "expand_bn", "depthwise": "depthwise_bn",
                         "project": "project_bn", "conv_stem": "bn_stem",
                         "conv_head": "bn_head"}
GHOSTNET_BN_PARTNERS = {"primary": "primary_bn", "cheap": "cheap_bn",
                        "dw": "dw_bn", "shortcut_dw": "shortcut_dw_bn",
                        "shortcut_pw": "shortcut_pw_bn",
                        "conv_stem": "bn_stem", "conv_head": "bn_head"}


@torch.no_grad()
def fold_bn_deploy(model, partners):
    """Train-form model → its BN-free deploy twin on the same device
    (``type(model)(**model.twin_args(), deploy=True)``): every conv
    absorbs its BatchNorm partner, named by ``partners`` (conv leaf name →
    BN leaf name beside it), exactly as :func:`fold_conv_bn` does; the
    dense layers (the head, GhostNet's ``fc1``, the SE blocks') are
    copied; the twin's block-output quantizers are fresh.
    Calibrate (and ``prepare_deploy``) after conversion."""
    device = model.linear.weight.device
    deploy = type(model)(**model.twin_args(), deploy=True,
                         scheme=model.scheme).to(device)
    for path, conv in deploy.named_modules():
        if isinstance(conv, QConv):
            parent, _, leaf = path.rpartition(".")
            src = model.get_submodule(path)
            bn = model.get_submodule(
                ".".join(filter(None, (parent, partners[leaf]))))
            k, b = fold_conv_bn(src.weight, src.bias, *_bn_args(bn), bn.eps)
            conv.weight.copy_(k)
            conv.bias.copy_(b)
        elif isinstance(conv, QDense):
            src = model.get_submodule(path)
            conv.weight.copy_(src.weight)
            conv.bias.copy_(src.bias)
    return deploy.train(model.training)


def resnet_deploy(model):
    """Train-form ResNet (any factory of ``models/resnet_cifar.py``, BasicBlock
    or Bottleneck, either stem) → its BN-free deploy form on the same device:
    ``conv1↔bn1``, ``conv2↔bn2``, ``conv3↔bn3``, ``downsample↔downsample_bn``
    folded; each block gains its ``out_q`` output quantizer."""
    return fold_bn_deploy(model, RESNET_BN_PARTNERS)


def mobilenet_deploy(model):
    """Train-form MobileNetV2 → its BN-free deploy form on the same device:
    ``expand``/``depthwise``/``project``↔``*_bn``, ``conv_stem↔bn_stem`` and
    ``conv_head↔bn_head`` folded; each linear-bottleneck block gains its
    ``out_q`` (``QBlockOutput(relu=False)``)."""
    return fold_bn_deploy(model, MOBILENET_BN_PARTNERS)


def ghostnet_deploy(model):
    """Train-form GhostNet → its BN-free deploy form on the same device:
    ``primary``/``cheap``/``dw``/``shortcut_dw``/``shortcut_pw``↔``*_bn``,
    ``conv_stem↔bn_stem`` and ``conv_head↔bn_head`` folded; ``fc1``, the
    head and the SE blocks' dense layers copied; each bottleneck gains its
    ``out_q`` (``QBlockOutput(relu=False)``)."""
    return fold_bn_deploy(model, GHOSTNET_BN_PARTNERS)


def efficientnet_deploy(model):
    """Train-form EfficientNet (any factory) → its BN-free deploy form on
    the same device, with MobileNetV2's naming; each BatchNorm folds at
    its own ε (1e-3)."""
    return fold_bn_deploy(model, MOBILENET_BN_PARTNERS)



@torch.no_grad()
def merge_bn(model: nn.Module, example_input, allow_missing: bool = True):
    """Fold every conv→BatchNorm pair's scale into the conv's weight
    (``dlmc_quant_tpu/models/fuse.py:75-129``).

    The pairs come from the compute graph of one forward of
    ``example_input`` (:func:`~dlmc_quant_torch.utils.count_ops.
    get_compute_graph`, top style): a conv (or dense layer) whose single
    tracked BatchNorm consumer keeps running statistics absorbs γ/σ into
    its weight, its bias (if any) becomes 0, and the BatchNorm becomes a
    bias-add: scale 1, mean 0, variance 1 − ε, bias β + (b − μ)·γ/σ, with
    ε the BatchNorm's own (1e-5 in the zoo, the JAX package's fixed
    ``BN_EPS``).  Numerically exact, so quantizers observe the folded
    weights.  Returns a new model; ``model`` is left as it was, as the
    JAX package returns new variables.  Raises where nothing folds and
    ``allow_missing`` is False.
    """
    model = copy.deepcopy(model)
    graph = get_compute_graph(model, example_input, style="top")
    n_folded = 0
    for path, consumers in graph.items():
        conv = model.get_submodule(path)
        if not isinstance(conv, CONVS + DENSES):
            continue
        bns = [c for c in consumers
               if isinstance(model.get_submodule(c), BATCHNORMS)
               and model.get_submodule(c).running_mean is not None]
        if len(bns) != 1:
            continue
        bn = model.get_submodule(bns[0])
        k, b = fold_conv_bn(conv.weight, conv.bias, *_bn_args(bn), bn.eps)
        conv.weight.copy_(k)
        if conv.bias is not None:
            conv.bias.zero_()
        bn.weight.fill_(1.0)
        bn.bias.copy_(b)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
        n_folded += 1
    if n_folded == 0 and not allow_missing:
        raise ValueError("merge_bn found no conv→BN pairs to fold")
    return model
