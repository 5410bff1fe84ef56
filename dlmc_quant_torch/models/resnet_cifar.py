"""CIFAR ResNets, NHWC activations: cifar_resnet20..110 and cifar_resnet18/34.

Counterpart of ``dlmc_quant_tpu/models/resnet_cifar.py``, with the same
child names (``conv1``, ``bn1``, ``layer2_0.downsample``,
``layer2_0.out_q``, ``linear``), so one scheme resolves the same way in
both packages and ``utils.jax_bridge`` carries the JAX variables over.

* :class:`CifarResNet`: 3 stages of 16/32/64 channels, ``6n+2`` layers,
  option-A (parameter-free) or option-B (1×1 conv) shortcuts.
* :class:`CifarResNetLarge`: the ImageNet stage layout (64/128/256/512)
  with the CIFAR 3×3 stem, BasicBlocks.
* Every conv is flax's SAME: a stride-2 3×3 conv on an even map pads 0 at
  the top and left and 1 at the bottom and right.
* BatchNorm is flax's: momentum 0.9, eps 1e-5, the running variance from
  the biased batch variance (:class:`BatchNorm`).
* The deploy form (``deploy=True``, made by
  :func:`dlmc_quant_torch.models.fuse.resnet_deploy`) folds every BN into
  its conv and closes each block with a :class:`QBlockOutput`, which in
  ``qmode='intc'`` keeps the block boundaries int8 codes.  A train-form
  model runs ``'intc'`` as ``'int'``, as the JAX models do.

Not ported yet: the Bottleneck blocks (cifar_resnet50/101/152), the
ImageNet 7×7 stem with its chained max-pool, and ``qrelu6`` (ROADMAP Queue
A, residual int8 chain (item 5)); their factories raise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlmc_quant_torch.models.registry import register
from dlmc_quant_torch.quant.chain import QuantizedTensor, materialize, qrelu
from dlmc_quant_torch.quant.layers import (QBlockOutput, QConv, QDense,
                                           attach_scheme)

RESIDUAL_ITEM = "ROADMAP Queue A, residual int8 chain (item 5)"


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm`` on NHWC activations.

    ``y = (x − μ)·(γ/√(σ² + ε)) + β``; in training mode μ and σ² are the
    batch's (σ² as E[x²] − E[x]², clipped at 0, as flax computes it) and the
    running statistics move as ``r = 0.9·r + 0.1·batch`` with the *biased*
    batch variance, where ``nn.BatchNorm2d`` would use the unbiased one.
    The parameter and buffer names are ``nn.BatchNorm2d``'s.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 1, 2))
            var = torch.clamp_min((x * x).mean(dim=(0, 1, 2)) - mean * mean,
                                  0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) \
            + self.bias


class BasicBlock(nn.Module):
    """3×3 + 3×3 residual block (ref: cifarresnet.py BasicBlock)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 option: str = "B", deploy: bool = False, generator=None):
        super().__init__()
        self.deploy, self.option, self.stride = deploy, option, stride
        self.pad_channels = features - in_features
        self.conv1 = QConv(in_features, features, 3, stride, "SAME",
                           use_bias=deploy, generator=generator)
        self.conv2 = QConv(features, features, 3, 1, "SAME", use_bias=deploy,
                           generator=generator)
        if not deploy:
            self.bn1, self.bn2 = BatchNorm(features), BatchNorm(features)
        self.shortcut = stride != 1 or in_features != features
        if self.shortcut and option == "B":
            self.downsample = QConv(in_features, features, 1, stride, "SAME",
                                    use_bias=deploy, generator=generator)
            if not deploy:
                self.downsample_bn = BatchNorm(features)
        if deploy:
            self.out_q = QBlockOutput()

    def _option_a(self, x):
        """Parameter-free shortcut: subsample, pad channels with real 0 (on
        codes: with the zero code, so the shortcut stays int8)."""
        s, p = self.stride, self.pad_channels
        pads = (p // 2, p - p // 2)
        if isinstance(x, QuantizedTensor):
            q = F.pad(x.q[:, ::s, ::s, :], pads, value=x.zero_code())
            return QuantizedTensor(q.contiguous(), x.scale, x.bias)
        return F.pad(materialize(x)[:, ::s, ::s, :], pads)

    def forward(self, x, qmode: str = "eval"):
        if not self.deploy and qmode == "intc":
            qmode = "int"       # chaining needs the BN-folded form
        y = self.conv1(x, qmode=qmode)
        if not self.deploy:
            y = self.bn1(y)
        y = self.conv2(qrelu(y), qmode=qmode)
        if not self.deploy:
            y = self.bn2(y)
        residual = x
        if self.shortcut and self.option == "A":
            residual = self._option_a(x)
        elif self.shortcut:
            residual = self.downsample(x, qmode=qmode)
            if not self.deploy:
                residual = self.downsample_bn(residual)
        if self.deploy:
            return self.out_q(y, residual, qmode=qmode)
        return torch.relu(materialize(y) + materialize(residual))


class _ResNet(nn.Module):
    """Stem conv (+BN) and ReLU, named blocks, global average pool, head."""

    def _build(self, stem: int, stages, num_classes: int, option: str,
               deploy: bool, scheme, generator):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.deploy, self.num_classes = deploy, num_classes
        self.conv1 = QConv(3, stem, 3, 1, "SAME", use_bias=deploy,
                           generator=generator)
        if not deploy:
            self.bn1 = BatchNorm(stem)
        self.block_names = []
        prev = stem
        for si, (n, w) in enumerate(stages, start=1):
            for bi in range(n):
                name = f"layer{si}_{bi}"
                setattr(self, name, BasicBlock(
                    prev, w, 2 if (bi == 0 and si > 1) else 1, option,
                    deploy, generator))
                self.block_names.append(name)
                prev = w
        self.linear = QDense(prev, num_classes, generator=generator)
        attach_scheme(self, scheme)

    def forward(self, x, qmode: str = "eval"):
        """``x`` (N, H, W, 3) float32 → logits (N, num_classes)."""
        if not self.deploy and qmode == "intc":
            qmode = "int"       # chaining needs the BN-folded form
        x = self.conv1(x, qmode=qmode)
        if not self.deploy:
            x = self.bn1(x)
        x = qrelu(x)
        for name in self.block_names:
            x = getattr(self, name)(x, qmode=qmode)
        x = materialize(x).mean(dim=(1, 2))
        return materialize(self.linear(x, qmode=qmode))


class CifarResNet(_ResNet):
    """3-stage CIFAR ResNet, widths 16/32/64, ``depth_n`` blocks a stage."""

    def __init__(self, depth_n: int = 3, num_classes: int = 10,
                 option: str = "A", deploy: bool = False, scheme=None,
                 generator=None):
        super().__init__()
        self.depth_n, self.option = depth_n, option
        self._build(16, [(depth_n, w) for w in (16, 32, 64)], num_classes,
                    option, deploy, scheme, generator)

    def twin_args(self):
        return dict(depth_n=self.depth_n, num_classes=self.num_classes,
                    option=self.option)


class CifarResNetLarge(_ResNet):
    """ImageNet-style ResNet with the CIFAR 3×3 stem (BasicBlocks)."""

    def __init__(self, stage_sizes: Tuple[int, ...] = (2, 2, 2, 2),
                 bottleneck: bool = False, num_classes: int = 10,
                 imagenet_stem: bool = False, deploy: bool = False,
                 scheme=None, generator=None):
        super().__init__()
        if bottleneck or imagenet_stem:
            raise NotImplementedError(
                "Bottleneck blocks and the ImageNet 7x7 stem with its "
                f"max-pool are not ported yet ({RESIDUAL_ITEM})")
        self.stage_sizes = tuple(stage_sizes)
        self._build(64, list(zip(self.stage_sizes, (64, 128, 256, 512))),
                    num_classes, "B", deploy, scheme, generator)

    def twin_args(self):
        return dict(stage_sizes=self.stage_sizes,
                    num_classes=self.num_classes)


def _small(name: str, n: int):
    @register(name)
    def fn(num_classes: int = 10, scheme=None, option: str = "A", **kw):
        return CifarResNet(depth_n=n, num_classes=num_classes, option=option,
                           scheme=scheme, **kw)
    fn.__name__ = name
    return fn


def _large(name: str, sizes, bottleneck: bool = False,
           imagenet_stem: bool = False, classes: int = 10):
    @register(name)
    def fn(num_classes: int = classes, scheme=None, **kw):
        return CifarResNetLarge(stage_sizes=sizes, bottleneck=bottleneck,
                                num_classes=num_classes,
                                imagenet_stem=imagenet_stem, scheme=scheme,
                                **kw)
    fn.__name__ = name
    return fn


cifar_resnet20 = _small("cifar_resnet20", 3)
cifar_resnet32 = _small("cifar_resnet32", 5)
cifar_resnet44 = _small("cifar_resnet44", 7)
cifar_resnet56 = _small("cifar_resnet56", 9)
cifar_resnet110 = _small("cifar_resnet110", 18)

cifar_resnet18 = _large("cifar_resnet18", (2, 2, 2, 2))
cifar_resnet34 = _large("cifar_resnet34", (3, 4, 6, 3))
# not ported yet: each raises, naming its ROADMAP item
cifar_resnet50 = _large("cifar_resnet50", (3, 4, 6, 3), bottleneck=True)
cifar_resnet101 = _large("cifar_resnet101", (3, 4, 23, 3), bottleneck=True)
cifar_resnet152 = _large("cifar_resnet152", (3, 8, 36, 3), bottleneck=True)
resnet18 = _large("resnet18", (2, 2, 2, 2), imagenet_stem=True, classes=1000)
resnet34 = _large("resnet34", (3, 4, 6, 3), imagenet_stem=True, classes=1000)
resnet50 = _large("resnet50", (3, 4, 6, 3), True, True, 1000)
resnet101 = _large("resnet101", (3, 4, 23, 3), True, True, 1000)
resnet152 = _large("resnet152", (3, 8, 36, 3), True, True, 1000)
