"""Reparameterization: BN folding and RepVGG branch fusion.

Counterpart of ``dlmc_quant_tpu/models/fuse.py:21-179,193-321``, on OIHW
kernels.  :func:`repvgg_fuse` turns a train-form RepVGG into its deploy
form, one 3×3 conv per block; :func:`resnet_deploy` and
:func:`mobilenet_deploy` fold a train-form ResNet's or MobileNetV2's
BatchNorms into their convs (``models/mobileone.py`` has MobileOne's
fuser, as in the JAX package).  The deploy model's quantizer
parameters are fresh: calibrate after fusing, as the JAX package does.
``merge_bn`` (the fold in place, for other families) is not ported yet
(ROADMAP Queue A, merge_bn (item 4)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlmc_quant_torch.models.repvgg import RepVGG, RepVGGBlock
from dlmc_quant_torch.quant.layers import QConv, QDense

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
                    deploy=True, scheme=model.scheme,
                    in_features=model.in_features).to(device)
    prev = model.in_features
    for name in model.block_names:
        block = getattr(model, name)
        k, b = fuse_repvgg_block(block, prev, block.rbr_dense.groups)
        getattr(deploy, name).reparam.weight.copy_(k)
        getattr(deploy, name).reparam.bias.copy_(b)
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


@torch.no_grad()
def fold_bn_deploy(model, partners):
    """Train-form model → its BN-free deploy twin on the same device
    (``type(model)(**model.twin_args(), deploy=True)``): every conv
    absorbs its BatchNorm partner, named by ``partners`` (conv leaf name →
    BN leaf name beside it), exactly as :func:`fold_conv_bn` does; the
    dense head is copied; the twin's block-output quantizers are fresh.
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
