"""GhostNet, NHWC activations (GhostNet-1.0 and its width multiples).

Counterpart of ``dlmc_quant_tpu/models/ghostnet.py``, with the same child
names (``conv_stem``, ``bn_stem``, ``block3.ghost1.primary``,
``block3.ghost1.cheap_bn``, ``block3.dw``, ``block3.se.reduce``,
``block3.shortcut_pw``, ``block3.out_q``, ``conv_head``, ``fc1``,
``linear``), so one scheme resolves the same way in both packages and
``utils.jax_bridge`` carries the JAX variables over.

* A ghost module makes half its features with a 1×1 conv (``primary``)
  and the rest with a cheap depthwise 3×3 conv over them (``cheap``),
  then concatenates the two: the concat closes the chain (two grids), so
  both halves are materialized in float32.
* A bottleneck: ghost module (ReLU) → depthwise ``dw`` at stride 2 (3×3
  or 5×5) → squeeze-excite → ghost module (no ReLU), plus a shortcut
  (identity, or a depthwise ``shortcut_dw`` and a 1×1 ``shortcut_pw``
  where the shape changes); no activation after the add.
* Squeeze-excite materializes its input, runs its two dense layers in
  ``'int'`` where the model runs ``'intc'``, ReLU between them and the
  hard sigmoid ``clip(x/6 + 1/2, 0, 1)`` after.
* Convs pad ``k // 2`` on every side (the stem and the head: flax's
  SAME); BatchNorm is flax's (``models.resnet_cifar.BatchNorm``).
* The deploy form (``deploy=True``, made by
  :func:`dlmc_quant_torch.models.fuse.ghostnet_deploy`) folds every BN
  into its conv and closes each bottleneck's add with
  ``QBlockOutput(relu=False)``, whose trunk is the float32 concat
  (``quant.chain.fold_sum_quantize``), so ``qmode='intc'`` hands int8
  codes from block to block.  A train-form model runs ``'intc'`` as
  ``'int'``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dlmc_quant_torch.models.mobilenetv2 import _make_divisible
from dlmc_quant_torch.models.registry import register
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.quant.chain import materialize, qrelu
from dlmc_quant_torch.quant.layers import (QBlockOutput, QConv, QDense,
                                           attach_scheme)


def _hard_sigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


class SqueezeExcite(nn.Module):
    """Global average pool → ``reduce`` → ReLU → ``expand`` → hard sigmoid,
    the gate multiplying the (materialized) input."""

    def __init__(self, channels: int, se_ratio: float = 0.25,
                 generator=None):
        super().__init__()
        red = _make_divisible(channels * se_ratio, 4)
        self.reduce = QDense(channels, red, generator=generator)
        self.expand = QDense(red, channels, generator=generator)

    def forward(self, x, qmode: str = "eval"):
        x = materialize(x)          # the gate needs concrete values
        qmode = "int" if qmode == "intc" else qmode
        s = x.mean(dim=(1, 2))
        s = torch.relu(self.reduce(s, qmode=qmode))
        s = _hard_sigmoid(self.expand(s, qmode=qmode))
        return x * s[:, None, None, :]


class GhostModule(nn.Module):
    """``primary`` (k×k) → ``cheap`` (depthwise dw_size², over the primary's
    output), each with its BN and the ReLU where ``relu``; the two halves
    concatenated and cut to ``features``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 ratio: int = 2, dw_size: int = 3, stride: int = 1,
                 relu: bool = True, deploy: bool = False, generator=None):
        super().__init__()
        self.features, self.relu, self.deploy = features, relu, deploy
        init_ch = -(-features // ratio)
        new_ch = init_ch * (ratio - 1)
        k, d = kernel_size, dw_size
        self.primary = QConv(in_features, init_ch, k, stride, k // 2,
                             use_bias=deploy, generator=generator)
        if not deploy:
            self.primary_bn = BatchNorm(init_ch)
        self.cheap = QConv(init_ch, new_ch, d, 1, d // 2, groups=init_ch,
                           use_bias=deploy, generator=generator)
        if not deploy:
            self.cheap_bn = BatchNorm(new_ch)

    def forward(self, x, qmode: str = "eval"):
        y1 = self.primary(x, qmode=qmode)
        if not self.deploy:
            y1 = self.primary_bn(y1)
        if self.relu:
            y1 = qrelu(y1)
        y2 = self.cheap(y1, qmode=qmode)
        if not self.deploy:
            y2 = self.cheap_bn(y2)
        if self.relu:
            y2 = qrelu(y2)
        # the concat closes the chain (two independent grids)
        return torch.cat([materialize(y1), materialize(y2)],
                         dim=-1)[..., :self.features]


class GhostBottleneck(nn.Module):
    """Ghost module → (``dw`` at stride 2) → (SE) → ghost module, plus the
    shortcut; the add closed by ``out_q`` in the deploy form."""

    def __init__(self, in_features: int, mid_features: int,
                 out_features: int, dw_kernel_size: int = 3,
                 stride: int = 1, se_ratio: float = 0.0,
                 deploy: bool = False, generator=None):
        super().__init__()
        self.deploy, self.stride = deploy, stride
        k = dw_kernel_size
        self.ghost1 = GhostModule(in_features, mid_features, relu=True,
                                  deploy=deploy, generator=generator)
        if stride != 1:
            self.dw = QConv(mid_features, mid_features, k, stride, k // 2,
                            groups=mid_features, use_bias=deploy,
                            generator=generator)
            if not deploy:
                self.dw_bn = BatchNorm(mid_features)
        if se_ratio > 0:
            self.se = SqueezeExcite(mid_features, se_ratio, generator)
        self.ghost2 = GhostModule(mid_features, out_features, relu=False,
                                  deploy=deploy, generator=generator)
        if in_features != out_features or stride != 1:
            self.shortcut_dw = QConv(in_features, in_features, k, stride,
                                     k // 2, groups=in_features,
                                     use_bias=deploy, generator=generator)
            self.shortcut_pw = QConv(in_features, out_features, 1, 1, 0,
                                     use_bias=deploy, generator=generator)
            if not deploy:
                self.shortcut_dw_bn = BatchNorm(in_features)
                self.shortcut_pw_bn = BatchNorm(out_features)
        if deploy:
            self.out_q = QBlockOutput(relu=False)

    def forward(self, x, qmode: str = "eval"):
        y = self.ghost1(x, qmode=qmode)
        if hasattr(self, "dw"):
            y = self.dw(y, qmode=qmode)
            if not self.deploy:
                y = self.dw_bn(y)
        if hasattr(self, "se"):
            y = self.se(y, qmode=qmode)
        y = self.ghost2(y, qmode=qmode)
        shortcut = x
        if hasattr(self, "shortcut_dw"):
            shortcut = self.shortcut_dw(x, qmode=qmode)
            if not self.deploy:
                shortcut = self.shortcut_dw_bn(shortcut)
            shortcut = self.shortcut_pw(shortcut, qmode=qmode)
            if not self.deploy:
                shortcut = self.shortcut_pw_bn(shortcut)
        if self.deploy:
            # the ghost modules materialized their concat, the shortcut may
            # be pending: the block output quantizer closes both onto one
            # grid (no activation on the add)
            return self.out_q(y, shortcut, qmode=qmode)
        return y + shortcut


class GhostNet(nn.Module):
    """Stem 3×3/s2 conv, 16 ghost bottlenecks, 1×1 head conv, global average
    pool, ``fc1`` (→ 1280, ReLU) and the dense head.

    Weights are drawn from ``generator`` (a ``torch.Generator``; seed 0 if
    none is given), on the CPU; move the model with ``.to(device)``.
    """

    # (dw_kernel, mid, out, se_ratio, stride): the GhostNet-1.0 table
    CFG = (
        ((3, 16, 16, 0, 1),),
        ((3, 48, 24, 0, 2),),
        ((3, 72, 24, 0, 1),),
        ((5, 72, 40, 0.25, 2),),
        ((5, 120, 40, 0.25, 1),),
        ((3, 240, 80, 0, 2),),
        ((3, 200, 80, 0, 1), (3, 184, 80, 0, 1), (3, 184, 80, 0, 1),
         (3, 480, 112, 0.25, 1), (3, 672, 112, 0.25, 1)),
        ((5, 672, 160, 0.25, 2),),
        ((5, 960, 160, 0, 1), (5, 960, 160, 0.25, 1),
         (5, 960, 160, 0, 1), (5, 960, 160, 0.25, 1)),
    )

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 deploy: bool = False, scheme=None, generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_classes, self.width, self.deploy = num_classes, width, deploy
        stem = _make_divisible(16 * width, 4)
        self.conv_stem = QConv(3, stem, 3, 2, "SAME", use_bias=deploy,
                               generator=generator)
        if not deploy:
            self.bn_stem = BatchNorm(stem)
        self.block_names = []
        prev = stem
        for stage in self.CFG:
            for (k, mid, out, se, s) in stage:
                name = f"block{len(self.block_names)}"
                out = _make_divisible(out * width, 4)
                setattr(self, name, GhostBottleneck(
                    prev, _make_divisible(mid * width, 4), out, k, s, se,
                    deploy, generator))
                self.block_names.append(name)
                prev = out
        head = _make_divisible(960 * width, 4)
        self.conv_head = QConv(prev, head, 1, 1, "SAME", use_bias=deploy,
                               generator=generator)
        if not deploy:
            self.bn_head = BatchNorm(head)
        self.fc1 = QDense(head, 1280, generator=generator)
        self.linear = QDense(1280, num_classes, generator=generator)
        attach_scheme(self, scheme)

    def twin_args(self):
        return dict(num_classes=self.num_classes, width=self.width)

    def forward(self, x, qmode: str = "eval"):
        """``x`` (N, H, W, 3) float32 → logits (N, num_classes)."""
        if not self.deploy and qmode == "intc":
            qmode = "int"       # chaining needs the BN-folded form
        x = self.conv_stem(x, qmode=qmode)
        x = qrelu(x if self.deploy else self.bn_stem(x))
        for name in self.block_names:
            x = getattr(self, name)(x, qmode=qmode)
        x = self.conv_head(x, qmode=qmode)
        x = qrelu(x if self.deploy else self.bn_head(x))
        x = materialize(x).mean(dim=(1, 2))
        x = qrelu(self.fc1(x, qmode=qmode))
        return materialize(self.linear(x, qmode=qmode))


@register("ghostnet")
def ghostnet(num_classes: int = 1000, width: float = 1.0, scheme=None,
             **kw):
    return GhostNet(num_classes=num_classes, width=width, scheme=scheme,
                    **kw)
