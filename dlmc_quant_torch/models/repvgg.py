"""RepVGG: reparameterizable VGG-style network, NHWC activations.

Counterpart of ``dlmc_quant_tpu/models/repvgg.py``, with the same child
names, so the module paths (``stage0.reparam``, ``stage3_7.rbr_dense``, …)
match the JAX package's and one scheme resolves the same way in both.
Train form: every block is 3×3 conv+BN ∥ 1×1 conv+BN ∥ identity BN, summed,
then ReLU.  Deploy form: one fused 3×3 conv per block, made by
:func:`dlmc_quant_torch.models.fuse.repvgg_fuse`.

Only RepVGG-A0 is registered in this slice; the SE variant (D2se) and the
integer path of the grouped variants wait for ROADMAP Queue A item 12.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from dlmc_quant_torch.models.registry import register
from dlmc_quant_torch.quant.chain import materialize, qrelu
from dlmc_quant_torch.quant.layers import QConv, QDense, attach_scheme


def _bn_nhwc(bn: nn.BatchNorm2d, x):
    return bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class RepVGGBlock(nn.Module):
    """3×3 ∥ 1×1 ∥ identity branches (train form) or one fused conv."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 groups: int = 1, deploy: bool = False, generator=None):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.reparam = QConv(in_features, features, 3, stride, 1, groups,
                                 use_bias=True, generator=generator)
            return
        self.rbr_dense = QConv(in_features, features, 3, stride, 1, groups,
                               use_bias=False, generator=generator)
        self.rbr_dense_bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.rbr_1x1 = QConv(in_features, features, 1, stride, 0, groups,
                             use_bias=False, generator=generator)
        self.rbr_1x1_bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        if in_features == features and stride == 1:
            self.rbr_identity = nn.BatchNorm2d(features, eps=1e-5,
                                               momentum=0.1)

    def forward(self, x, qmode: str = "eval"):
        if self.deploy:
            return qrelu(self.reparam(x, qmode=qmode))
        if qmode in ("int", "intc"):
            raise NotImplementedError(
                "integer qmodes run the deploy form: fuse the model with "
                "models.fuse.repvgg_fuse first")
        out = _bn_nhwc(self.rbr_dense_bn, self.rbr_dense(x, qmode=qmode))
        out = out + _bn_nhwc(self.rbr_1x1_bn, self.rbr_1x1(x, qmode=qmode))
        if hasattr(self, "rbr_identity"):
            out = out + _bn_nhwc(self.rbr_identity, x)
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
        if use_se:
            raise NotImplementedError(
                "RepVGG SE blocks (D2se) are not ported yet "
                "(ROADMAP Queue A item 12)")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_blocks = tuple(num_blocks)
        self.width_multiplier = tuple(width_multiplier)
        self.num_classes = num_classes
        self.override_groups_map = dict(override_groups_map or {})
        self.deploy, self.scheme, self.in_features = deploy, scheme, in_features
        gmap = self.override_groups_map
        widths = [int(64 * width_multiplier[0]), int(128 * width_multiplier[1]),
                  int(256 * width_multiplier[2]), int(512 * width_multiplier[3])]
        stage0_w = min(64, int(64 * width_multiplier[0]))

        self.block_names = ["stage0"]
        self.stage0 = RepVGGBlock(in_features, stage0_w, 2, deploy=deploy,
                                  generator=generator)
        prev, layer_idx = stage0_w, 1
        for si, (n, w) in enumerate(zip(num_blocks, widths), start=1):
            for bi in range(n):
                name = f"stage{si}_{bi}"
                setattr(self, name, RepVGGBlock(
                    prev, w, 2 if bi == 0 else 1, gmap.get(layer_idx, 1),
                    deploy=deploy, generator=generator))
                self.block_names.append(name)
                prev, layer_idx = w, layer_idx + 1
        self.linear = QDense(prev, num_classes, generator=generator)
        attach_scheme(self, scheme)

    def forward(self, x, qmode: str = "eval"):
        """``x`` (N, H, W, C) float32 → logits (N, num_classes)."""
        if qmode in ("int", "intc") and self.override_groups_map:
            raise NotImplementedError(
                "grouped RepVGG variants have no integer path yet "
                "(ROADMAP Queue A item 12)")
        for name in self.block_names:
            x = getattr(self, name)(x, qmode=qmode)
        x = materialize(x).mean(dim=(1, 2))
        return materialize(self.linear(x, qmode=qmode))


@register("RepVGG_A0")
def RepVGG_A0(num_classes: int = 1000, deploy: bool = False, scheme=None,
              **kw):
    return RepVGG(num_blocks=(2, 4, 14, 1),
                  width_multiplier=(0.75, 0.75, 0.75, 2.5),
                  num_classes=num_classes, deploy=deploy, scheme=scheme, **kw)
