"""RepVGG: reparameterizable VGG-style network, NHWC activations.

Counterpart of ``dlmc_quant_tpu/models/repvgg.py``, with the same child
names, so the module paths (``stage0.reparam``, ``stage3_7.rbr_dense``, …)
match the JAX package's and one scheme resolves the same way in both.
Train form: every block is 3×3 conv+BN ∥ 1×1 conv+BN ∥ identity BN, summed,
then (with ``use_se``) a squeeze-and-excitation block and ReLU.  Deploy
form: one fused 3×3 conv per block, made by
:func:`dlmc_quant_torch.models.fuse.repvgg_fuse`.

Every factory of the JAX package is registered, with its width
multipliers and its grouped-conv maps: A0–A2, B0–B3, the g2/g4 variants
(``groups`` 2 or 4 at global block indices 2, 4, …, 26) and D2se.  In
``'int'`` and ``'intc'`` the deploy form chains its convs (grouped ones
through the grouped int8 conv kernel), and an SE block closes the chain
before it; the train form runs ``'intc'`` as ``'int'``, as the JAX
package does: each branch's integer conv materialized, its BatchNorm in
float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from dlmc_quant_torch.models.registry import register
from dlmc_quant_torch.quant.chain import materialize, qrelu
from dlmc_quant_torch.quant.layers import QConv, QDense, attach_scheme

# global block indices using grouped convs in the g2/g4 variants
# (dlmc_quant_tpu/models/repvgg.py:27-31)
_OPTIONAL_GROUPWISE_LAYERS = [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26]
_G2_MAP = {l: 2 for l in _OPTIONAL_GROUPWISE_LAYERS}
_G4_MAP = {l: 4 for l in _OPTIONAL_GROUPWISE_LAYERS}


def _bn_nhwc(bn: nn.BatchNorm2d, x):
    return bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SEBlock(nn.Module):
    """Squeeze-and-excitation: ``x · sigmoid(up(relu(down(mean(x)))))``
    (``dlmc_quant_tpu/models/repvgg.py:34-52``).  ``down`` and ``up`` are
    quantized dense layers; the block materializes its input (the gate
    needs values), runs ``'intc'`` as ``'int'`` and gates in float32."""

    def __init__(self, channels: int, ratio: int = 16, generator=None):
        super().__init__()
        self.down = QDense(channels, channels // ratio, generator=generator)
        self.up = QDense(channels // ratio, channels, generator=generator)

    def forward(self, x, qmode: str = "eval"):
        x = materialize(x)
        qmode = "int" if qmode == "intc" else qmode
        s = torch.relu(self.down(x.mean(dim=(1, 2)), qmode=qmode))
        s = torch.sigmoid(self.up(s, qmode=qmode))
        return x * s[:, None, None, :]


class RepVGGBlock(nn.Module):
    """3×3 ∥ 1×1 ∥ identity branches (train form) or one fused conv, then
    the SE block (``se``) where there is one."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 groups: int = 1, deploy: bool = False, use_se: bool = False,
                 generator=None):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.reparam = QConv(in_features, features, 3, stride, 1, groups,
                                 use_bias=True, generator=generator)
        else:
            self.rbr_dense = QConv(in_features, features, 3, stride, 1,
                                   groups, use_bias=False,
                                   generator=generator)
            self.rbr_dense_bn = nn.BatchNorm2d(features, eps=1e-5,
                                               momentum=0.1)
            self.rbr_1x1 = QConv(in_features, features, 1, stride, 0, groups,
                                 use_bias=False, generator=generator)
            self.rbr_1x1_bn = nn.BatchNorm2d(features, eps=1e-5,
                                             momentum=0.1)
            if in_features == features and stride == 1:
                self.rbr_identity = nn.BatchNorm2d(features, eps=1e-5,
                                                   momentum=0.1)
        if use_se:
            self.se = SEBlock(features, generator=generator)

    def forward(self, x, qmode: str = "eval"):
        if self.deploy:
            out = self.reparam(x, qmode=qmode)
        else:
            if qmode == "intc":
                qmode = "int"    # the branches' sum needs their values
            out = _bn_nhwc(self.rbr_dense_bn, self.rbr_dense(x, qmode=qmode))
            out = out + _bn_nhwc(self.rbr_1x1_bn,
                                 self.rbr_1x1(x, qmode=qmode))
            if hasattr(self, "rbr_identity"):
                out = out + _bn_nhwc(self.rbr_identity, x)
        if hasattr(self, "se"):
            out = self.se(out, qmode=qmode)
        # lazy on a chained deferred output: the consumer folds it
        return qrelu(out)


class RepVGG(nn.Module):
    """Stages of RepVGG blocks, global average pool, dense head.

    Weights are drawn from ``generator`` (a ``torch.Generator``; seed 0 if
    none is given), on the CPU; move the model with ``.to(device)``.
    """

    def __init__(self, num_blocks: Tuple[int, ...] = (2, 4, 14, 1),
                 width_multiplier: Tuple[float, ...] = (0.75, 0.75, 0.75, 2.5),
                 num_classes: int = 1000,
                 override_groups_map: Optional[Dict[int, int]] = None,
                 use_se: bool = False, deploy: bool = False, scheme=None,
                 in_features: int = 3, generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_blocks = tuple(num_blocks)
        self.width_multiplier = tuple(width_multiplier)
        self.num_classes = num_classes
        self.override_groups_map = dict(override_groups_map or {})
        self.use_se = use_se
        self.deploy, self.scheme, self.in_features = deploy, scheme, in_features
        gmap = self.override_groups_map
        widths = [int(64 * width_multiplier[0]), int(128 * width_multiplier[1]),
                  int(256 * width_multiplier[2]), int(512 * width_multiplier[3])]
        stage0_w = min(64, int(64 * width_multiplier[0]))

        self.block_names = ["stage0"]
        self.stage0 = RepVGGBlock(in_features, stage0_w, 2, deploy=deploy,
                                  use_se=use_se, generator=generator)
        prev, layer_idx = stage0_w, 1
        for si, (n, w) in enumerate(zip(num_blocks, widths), start=1):
            for bi in range(n):
                name = f"stage{si}_{bi}"
                setattr(self, name, RepVGGBlock(
                    prev, w, 2 if bi == 0 else 1, gmap.get(layer_idx, 1),
                    deploy=deploy, use_se=use_se, generator=generator))
                self.block_names.append(name)
                prev, layer_idx = w, layer_idx + 1
        self.linear = QDense(prev, num_classes, generator=generator)
        attach_scheme(self, scheme)

    def forward(self, x, qmode: str = "eval"):
        """``x`` (N, H, W, C) float32 → logits (N, num_classes)."""
        for name in self.block_names:
            x = getattr(self, name)(x, qmode=qmode)
        x = materialize(x).mean(dim=(1, 2))
        return materialize(self.linear(x, qmode=qmode))


def _factory(name, num_blocks, widths, gmap=None, use_se=False):
    @register(name)
    def fn(num_classes: int = 1000, deploy: bool = False, scheme=None,
           **kw):
        return RepVGG(num_blocks=num_blocks, width_multiplier=widths,
                      num_classes=num_classes, override_groups_map=gmap,
                      use_se=use_se, deploy=deploy, scheme=scheme, **kw)
    fn.__name__ = name
    return fn


# the JAX package's factories (dlmc_quant_tpu/models/repvgg.py:149-163)
RepVGG_A0 = _factory("RepVGG_A0", (2, 4, 14, 1), (0.75, 0.75, 0.75, 2.5))
RepVGG_A1 = _factory("RepVGG_A1", (2, 4, 14, 1), (1.0, 1.0, 1.0, 2.5))
RepVGG_A2 = _factory("RepVGG_A2", (2, 4, 14, 1), (1.5, 1.5, 1.5, 2.75))
RepVGG_B0 = _factory("RepVGG_B0", (4, 6, 16, 1), (1.0, 1.0, 1.0, 2.5))
RepVGG_B1 = _factory("RepVGG_B1", (4, 6, 16, 1), (2.0, 2.0, 2.0, 4.0))
RepVGG_B1g2 = _factory("RepVGG_B1g2", (4, 6, 16, 1), (2.0, 2.0, 2.0, 4.0),
                       _G2_MAP)
RepVGG_B1g4 = _factory("RepVGG_B1g4", (4, 6, 16, 1), (2.0, 2.0, 2.0, 4.0),
                       _G4_MAP)
RepVGG_B2 = _factory("RepVGG_B2", (4, 6, 16, 1), (2.5, 2.5, 2.5, 5.0))
RepVGG_B2g2 = _factory("RepVGG_B2g2", (4, 6, 16, 1), (2.5, 2.5, 2.5, 5.0),
                       _G2_MAP)
RepVGG_B2g4 = _factory("RepVGG_B2g4", (4, 6, 16, 1), (2.5, 2.5, 2.5, 5.0),
                       _G4_MAP)
RepVGG_B3 = _factory("RepVGG_B3", (4, 6, 16, 1), (3.0, 3.0, 3.0, 5.0))
RepVGG_B3g2 = _factory("RepVGG_B3g2", (4, 6, 16, 1), (3.0, 3.0, 3.0, 5.0),
                       _G2_MAP)
RepVGG_B3g4 = _factory("RepVGG_B3g4", (4, 6, 16, 1), (3.0, 3.0, 3.0, 5.0),
                       _G4_MAP)
RepVGG_D2se = _factory("RepVGG_D2se", (8, 14, 24, 1), (2.5, 2.5, 2.5, 5.0),
                       use_se=True)
