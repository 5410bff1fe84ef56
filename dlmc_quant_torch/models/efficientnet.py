"""EfficientNet-B0…B7, NHWC activations: MBConv + SE + swish +
drop-connect, and the CIFAR factories.

Counterpart of ``dlmc_quant_tpu/models/efficientnet.py``, with the same
child names (``conv_stem``, ``bn_stem``, ``block2_0.expand``,
``block2_0.depthwise_bn``, ``block2_0.se_reduce``, ``block2_0.project``,
``conv_head``, ``linear``), so one scheme resolves the same way in both
packages and ``utils.jax_bridge`` carries the JAX variables over.

* MBConv: expand 1×1 (unless the ratio is 1) → depthwise k×k (3 or 5,
  pads ``k // 2``) → squeeze-excite (swish between its dense layers, a
  sigmoid gate) → project 1×1, swish after the first two, and a residual
  add where the shape allows, with drop-connect in training.
* BatchNorm is flax's (``models.resnet_cifar.BatchNorm``) at ε 1e-3 and
  momentum 0.9.
* Swish closes every chain, so ``qmode='intc'`` runs as ``'int'``: each
  quantized conv's kernel ends in its ``"f32"`` epilogue.  The deploy form
  (``deploy=True``, made by
  :func:`dlmc_quant_torch.models.fuse.efficientnet_deploy`) folds every BN
  into its conv.
* Drop-connect and the head's dropout draw their masks, in training only,
  from ``drop_generator``, a CPU ``torch.Generator`` (seed 0 unless the
  caller gives one), as the JAX model draws from its ``dropout`` RNG.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlmc_quant_torch.models.registry import register
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.quant.layers import QConv, QDense, attach_scheme

BN_EPS = 1e-3


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS)


def _round_filters(filters, width_mult, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats, depth_mult) -> int:
    return int(math.ceil(depth_mult * repeats))


def _keep_mask(shape, rate: float, generator, device) -> torch.Tensor:
    """A Bernoulli(1 − rate) mask of ``shape``, drawn on the CPU."""
    return (torch.rand(shape, generator=generator) < 1.0 - rate).to(device)


class MBConv(nn.Module):
    """Expand 1×1 → depthwise → SE → project 1×1 (+ the input)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, stride: int = 1,
                 expand_ratio: int = 6, se_ratio: float = 0.25,
                 drop_rate: float = 0.0, deploy: bool = False,
                 generator=None):
        super().__init__()
        self.deploy, self.drop_rate = deploy, drop_rate
        hidden = in_features * expand_ratio
        if expand_ratio != 1:
            self.expand = QConv(in_features, hidden, 1, 1, "SAME",
                                use_bias=deploy, generator=generator)
            if not deploy:
                self.expand_bn = _bn(hidden)
        k = kernel_size
        self.depthwise = QConv(hidden, hidden, k, stride, k // 2,
                               groups=hidden, use_bias=deploy,
                               generator=generator)
        if not deploy:
            self.depthwise_bn = _bn(hidden)
        if se_ratio > 0:
            red = max(1, int(in_features * se_ratio))
            self.se_reduce = QDense(hidden, red, generator=generator)
            self.se_expand = QDense(red, hidden, generator=generator)
        self.project = QConv(hidden, features, 1, 1, "SAME", use_bias=deploy,
                             generator=generator)
        if not deploy:
            self.project_bn = _bn(features)
        self.residual = stride == 1 and in_features == features

    def forward(self, x, qmode: str = "eval", drop_generator=None):
        y = x
        if hasattr(self, "expand"):
            y = self.expand(y, qmode=qmode)
            y = F.silu(y if self.deploy else self.expand_bn(y))
        y = self.depthwise(y, qmode=qmode)
        y = F.silu(y if self.deploy else self.depthwise_bn(y))
        if hasattr(self, "se_reduce"):
            s = y.mean(dim=(1, 2))
            s = F.silu(self.se_reduce(s, qmode=qmode))
            s = torch.sigmoid(self.se_expand(s, qmode=qmode))
            y = y * s[:, None, None, :]
        y = self.project(y, qmode=qmode)
        if not self.deploy:
            y = self.project_bn(y)
        if not self.residual:
            return y
        if self.training and self.drop_rate > 0:
            mask = _keep_mask((y.shape[0], 1, 1, 1), self.drop_rate,
                              drop_generator, y.device)
            y = y * mask / (1.0 - self.drop_rate)
        return y + x


class EfficientNet(nn.Module):
    """Stem 3×3 conv (stride 2, 1 on CIFAR), seven stages of MBConv blocks,
    1×1 head conv, global average pool, dropout and the dense head.

    Weights are drawn from ``generator`` (a ``torch.Generator``; seed 0 if
    none is given), on the CPU; move the model with ``.to(device)``.
    """

    # (expand, channels, repeats, stride, kernel)
    CFG = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
           (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
           (6, 320, 1, 1, 3))

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 dropout: float = 0.2, num_classes: int = 1000,
                 cifar: bool = False, deploy: bool = False, scheme=None,
                 generator=None, drop_generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.width_mult, self.depth_mult = width_mult, depth_mult
        self.dropout, self.num_classes = dropout, num_classes
        self.cifar, self.deploy = cifar, deploy
        self.drop_generator = drop_generator or \
            torch.Generator().manual_seed(0)
        stem = _round_filters(32, width_mult)
        self.conv_stem = QConv(3, stem, 3, 1 if cifar else 2, "SAME",
                               use_bias=deploy, generator=generator)
        if not deploy:
            self.bn_stem = _bn(stem)
        total = sum(_round_repeats(r, depth_mult) for _, _, r, _, _ in
                    self.CFG)
        self.block_names = []
        prev = stem
        for si, (t, c, r, s, k) in enumerate(self.CFG):
            c = _round_filters(c, width_mult)
            if cifar and si == 1:
                s = 1
            for j in range(_round_repeats(r, depth_mult)):
                name = f"block{si}_{j}"
                drop = dropout * len(self.block_names) / max(total, 1)
                setattr(self, name, MBConv(
                    prev, c, k, s if j == 0 else 1, t, drop_rate=drop,
                    deploy=deploy, generator=generator))
                self.block_names.append(name)
                prev = c
        head = _round_filters(1280, width_mult)
        self.conv_head = QConv(prev, head, 1, 1, "SAME", use_bias=deploy,
                               generator=generator)
        if not deploy:
            self.bn_head = _bn(head)
        self.linear = QDense(head, num_classes, generator=generator)
        attach_scheme(self, scheme)

    def twin_args(self):
        return dict(width_mult=self.width_mult, depth_mult=self.depth_mult,
                    dropout=self.dropout, num_classes=self.num_classes,
                    cifar=self.cifar)

    def forward(self, x, qmode: str = "eval"):
        """``x`` (N, H, W, 3) float32 → logits (N, num_classes)."""
        if qmode == "intc":
            qmode = "int"       # swish closes every chain anyway
        x = self.conv_stem(x, qmode=qmode)
        x = F.silu(x if self.deploy else self.bn_stem(x))
        for name in self.block_names:
            x = getattr(self, name)(x, qmode=qmode,
                                    drop_generator=self.drop_generator)
        x = self.conv_head(x, qmode=qmode)
        x = F.silu(x if self.deploy else self.bn_head(x))
        x = x.mean(dim=(1, 2))
        if self.training and self.dropout > 0:
            keep = _keep_mask(x.shape, self.dropout, self.drop_generator,
                              x.device)
            x = torch.where(keep, x / (1.0 - self.dropout),
                            torch.zeros_like(x))
        return self.linear(x, qmode=qmode)


# (width, depth, dropout) per variant
_COEFFS = {
    "b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2), "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3), "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5),
}


def _factories(variant: str, width: float, depth: float, dropout: float):
    @register(f"cifar_efficientnet{variant}")
    def cifar_fn(num_classes: int = 10, scheme=None, **kw):
        return EfficientNet(width, depth, dropout, num_classes, cifar=True,
                            scheme=scheme, **kw)

    @register(f"efficientnet{variant}")
    def fn(num_classes: int = 1000, scheme=None, **kw):
        return EfficientNet(width, depth, dropout, num_classes,
                            scheme=scheme, **kw)


for _variant, _coeffs in _COEFFS.items():
    _factories(_variant, *_coeffs)
