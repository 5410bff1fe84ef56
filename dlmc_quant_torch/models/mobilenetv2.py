"""MobileNetV2, NHWC activations: the CIFAR and ImageNet/PROFIT variants.

Counterpart of ``dlmc_quant_tpu/models/mobilenetv2.py``, with the same
child names (``conv_stem``, ``bn_stem``, ``block1_0.expand``,
``block1_0.depthwise_bn``, ``block1_1.out_q``, ``conv_head``, ``linear``),
so one scheme resolves the same way in both packages and
``utils.jax_bridge`` carries the JAX variables over.

* Inverted-residual blocks: expand 1×1 → depthwise 3×3 → project 1×1,
  ReLU6 after the first two (ReLU in the PROFIT variant), a residual add
  with no activation where the shape allows (a linear bottleneck).
* Every conv is flax's SAME (a stride-2 3×3 conv on an even map pads 0 at
  the top and left and 1 at the bottom and right); BatchNorm is flax's
  (``models.resnet_cifar.BatchNorm``).
* The deploy form (``deploy=True``, made by
  :func:`dlmc_quant_torch.models.fuse.mobilenet_deploy`) folds every BN
  into its conv, keeps the activations lazy on the chain
  (``quant.chain.qrelu6``: the upper clamp folds into the consumer's
  quantize) and closes each linear-bottleneck add with
  ``QBlockOutput(relu=False)``, so ``qmode='intc'`` stays int8 from the
  stem to the head.  A train-form model runs ``'intc'`` as ``'int'``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dlmc_quant_torch.models.registry import register
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.quant.chain import materialize, qrelu, qrelu6
from dlmc_quant_torch.quant.layers import (QBlockOutput, QConv, QDense,
                                           attach_scheme)


def _make_divisible(v, divisor: int = 8, min_value=None) -> int:
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """Expand 1×1 (unless the ratio is 1) → depthwise 3×3 → project 1×1."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 expand_ratio: int = 6, relu6: bool = True,
                 deploy: bool = False, generator=None):
        super().__init__()
        self.deploy, self.relu6 = deploy, relu6
        hidden = in_features * expand_ratio
        if expand_ratio != 1:
            self.expand = QConv(in_features, hidden, 1, 1, "SAME",
                                use_bias=deploy, generator=generator)
            if not deploy:
                self.expand_bn = BatchNorm(hidden)
        self.depthwise = QConv(hidden, hidden, 3, stride, "SAME",
                               groups=hidden, use_bias=deploy,
                               generator=generator)
        self.project = QConv(hidden, features, 1, 1, "SAME", use_bias=deploy,
                             generator=generator)
        if not deploy:
            self.depthwise_bn = BatchNorm(hidden)
            self.project_bn = BatchNorm(features)
        self.residual = stride == 1 and in_features == features
        if deploy and self.residual:
            self.out_q = QBlockOutput(relu=False)

    def forward(self, x, qmode: str = "eval"):
        act = qrelu6 if self.relu6 else qrelu
        y = x
        if hasattr(self, "expand"):
            y = self.expand(y, qmode=qmode)
            y = act(y if self.deploy else self.expand_bn(y))
        y = self.depthwise(y, qmode=qmode)
        y = act(y if self.deploy else self.depthwise_bn(y))
        y = self.project(y, qmode=qmode)
        if not self.deploy:
            y = self.project_bn(y)
        if not self.residual:
            return y
        if self.deploy:
            # linear bottleneck: the add has no activation
            return self.out_q(y, x, qmode=qmode)
        return y + x


class MobileNetV2(nn.Module):
    """Stem 3×3 conv, seven stages of inverted residuals, 1×1 head conv,
    global average pool, dense head.

    Weights are drawn from ``generator`` (a ``torch.Generator``; seed 0 if
    none is given), on the CPU; move the model with ``.to(device)``.
    """

    # (expansion, channels, repeats, stride)
    CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 cifar: bool = False, relu6: bool = True,
                 deploy: bool = False, scheme=None, generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_classes, self.width_mult = num_classes, width_mult
        self.cifar, self.relu6, self.deploy = cifar, relu6, deploy
        stem = _make_divisible(32 * width_mult)
        # stride-1 stem and first stage for 32×32 inputs
        self.conv_stem = QConv(3, stem, 3, 1 if cifar else 2, "SAME",
                               use_bias=deploy, generator=generator)
        if not deploy:
            self.bn_stem = BatchNorm(stem)
        self.block_names = []
        prev = stem
        for si, (t, c, n, s) in enumerate(self.CFG):
            c = _make_divisible(c * width_mult)
            if cifar and si == 1:
                s = 1
            for bi in range(n):
                name = f"block{si}_{bi}"
                setattr(self, name, InvertedResidual(
                    prev, c, s if bi == 0 else 1, t, relu6, deploy,
                    generator))
                self.block_names.append(name)
                prev = c
        head = _make_divisible(1280 * max(1.0, width_mult))
        self.conv_head = QConv(prev, head, 1, 1, "SAME", use_bias=deploy,
                               generator=generator)
        if not deploy:
            self.bn_head = BatchNorm(head)
        self.linear = QDense(head, num_classes, generator=generator)
        attach_scheme(self, scheme)

    def twin_args(self):
        return dict(num_classes=self.num_classes, width_mult=self.width_mult,
                    cifar=self.cifar, relu6=self.relu6)

    def forward(self, x, qmode: str = "eval"):
        """``x`` (N, H, W, 3) float32 → logits (N, num_classes)."""
        if not self.deploy and qmode == "intc":
            qmode = "int"       # chaining needs the BN-folded form
        act = qrelu6 if self.relu6 else qrelu
        x = self.conv_stem(x, qmode=qmode)
        x = act(x if self.deploy else self.bn_stem(x))
        for name in self.block_names:
            x = getattr(self, name)(x, qmode=qmode)
        x = self.conv_head(x, qmode=qmode)
        x = act(x if self.deploy else self.bn_head(x))
        x = materialize(x).mean(dim=(1, 2))
        return materialize(self.linear(x, qmode=qmode))


@register("cifar_mobilenet_v2")
def cifar_mobilenet_v2(num_classes: int = 10, width_mult: float = 1.0,
                       scheme=None, **kw):
    return MobileNetV2(num_classes=num_classes, width_mult=width_mult,
                       cifar=True, scheme=scheme, **kw)


@register("mobilenet_v2")
def mobilenet_v2(num_classes: int = 1000, width_mult: float = 1.0,
                 scheme=None, **kw):
    return MobileNetV2(num_classes=num_classes, width_mult=width_mult,
                       scheme=scheme, **kw)


@register("profit_mobilenet_v2")
def profit_mobilenet_v2(num_classes: int = 1000, width_mult: float = 1.0,
                        scheme=None, **kw):
    """ReLU (not ReLU6), for quantization friendliness."""
    return MobileNetV2(num_classes=num_classes, width_mult=width_mult,
                       relu6=False, scheme=scheme, **kw)
