"""MobileOne, NHWC activations: a reparameterizable depthwise-separable
network (MobileOne_S0…S4).

Counterpart of ``dlmc_quant_tpu/models/mobileone.py``, with the same
child names (``stage0.reparam``, ``stage1_0_dw.conv0``,
``stage1_0_dw.conv0_bn``, ``stage1_0_dw.scale_branch``,
``stage2_3_pw.identity_bn``, ``linear``), so one scheme resolves the same
way in both packages and ``utils.jax_bridge`` carries the JAX variables
over.

* Each stage alternates a depthwise 3×3 block and a pointwise 1×1 block.
  Train form: ``num_conv_branches`` conv + BN branches, a 1×1 scale branch
  (+ BN) beside a 3×3, and an identity BN where in = out and stride 1,
  summed, then ReLU.  Deploy form: one conv with bias a block
  (:func:`mobileone_fuse`), whose ReLU stays lazy on the chain.
* BatchNorm is flax's (``models.resnet_cifar.BatchNorm``); convs pad
  ``k // 2`` on every side.
* The integer qmodes: the deploy form chains ``'intc'``; the train form
  runs ``'int'``, and ``'intc'`` as ``'int'`` (as the JAX package does:
  chaining needs the fused single-conv form), a depthwise block's 1×1
  scale branch on the depthwise kernel's 1×1 window.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from dlmc_quant_torch.models.fuse import (_bn_args, _bn_only_to_conv,
                                          _pad_1x1_to_3x3, fold_conv_bn)
from dlmc_quant_torch.models.registry import register
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.quant.chain import materialize, qrelu
from dlmc_quant_torch.quant.layers import QConv, QDense, attach_scheme


class MobileOneBlock(nn.Module):
    """One reparam conv block, depthwise 3×3 or pointwise 1×1."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, stride: int = 1, groups: int = 1,
                 num_conv_branches: int = 1, deploy: bool = False,
                 generator=None):
        super().__init__()
        self.deploy = deploy
        k, pad = kernel_size, kernel_size // 2
        if deploy:
            self.reparam = QConv(in_features, features, k, stride, pad,
                                 groups, use_bias=True, generator=generator)
            return
        self.num_conv_branches = num_conv_branches
        for b in range(num_conv_branches):
            setattr(self, f"conv{b}", QConv(
                in_features, features, k, stride, pad, groups,
                use_bias=False, generator=generator))
            setattr(self, f"conv{b}_bn", BatchNorm(features))
        if k > 1:
            self.scale_branch = QConv(in_features, features, 1, stride, 0,
                                      groups, use_bias=False,
                                      generator=generator)
            self.scale_branch_bn = BatchNorm(features)
        if in_features == features and stride == 1:
            self.identity_bn = BatchNorm(features)

    def forward(self, x, qmode: str = "eval"):
        if self.deploy:
            # lazy on a chained (intc) deferred epilogue
            return qrelu(self.reparam(x, qmode=qmode))
        if qmode == "intc":
            qmode = "int"       # chaining needs the fused single-conv form
        out = 0.0
        for b in range(self.num_conv_branches):
            y = getattr(self, f"conv{b}")(x, qmode=qmode)
            out = out + getattr(self, f"conv{b}_bn")(y)
        if hasattr(self, "scale_branch"):
            out = out + self.scale_branch_bn(
                self.scale_branch(x, qmode=qmode))
        if hasattr(self, "identity_bn"):
            out = out + self.identity_bn(materialize(x))
        return torch.relu(out)


class MobileOne(nn.Module):
    """A 3×3/s2 stem block, then per stage depthwise + pointwise blocks,
    global average pool, dense head.

    Weights are drawn from ``generator`` (a ``torch.Generator``; seed 0 if
    none is given), on the CPU; move the model with ``.to(device)``.
    """

    BASE = (64, 128, 256, 512)

    def __init__(self, num_blocks: Tuple[int, ...] = (2, 8, 10, 1),
                 width_multipliers: Tuple[float, ...] = (1.5, 1.5, 2.0, 2.5),
                 num_conv_branches: int = 1, num_classes: int = 1000,
                 deploy: bool = False, scheme=None, in_features: int = 3,
                 generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_blocks = tuple(num_blocks)
        self.width_multipliers = tuple(width_multipliers)
        self.num_conv_branches, self.num_classes = num_conv_branches, \
            num_classes
        self.deploy, self.in_features = deploy, in_features
        widths = [min(64, int(64 * width_multipliers[0]))] + [
            int(b * m) for b, m in zip(self.BASE, width_multipliers)]
        self.stage0 = MobileOneBlock(in_features, widths[0], 3, 2,
                                     deploy=deploy, generator=generator)
        self.block_names = ["stage0"]
        cur = widths[0]
        for si, (n, w) in enumerate(zip(num_blocks, widths[1:]), start=1):
            for bi in range(n):
                dw, pw = f"stage{si}_{bi}_dw", f"stage{si}_{bi}_pw"
                setattr(self, dw, MobileOneBlock(
                    cur, cur, 3, 2 if bi == 0 else 1, groups=cur,
                    num_conv_branches=num_conv_branches, deploy=deploy,
                    generator=generator))
                setattr(self, pw, MobileOneBlock(
                    cur, w, 1, 1, num_conv_branches=num_conv_branches,
                    deploy=deploy, generator=generator))
                self.block_names += [dw, pw]
                cur = w
        self.linear = QDense(cur, num_classes, generator=generator)
        attach_scheme(self, scheme)

    def twin_args(self):
        return dict(num_blocks=self.num_blocks,
                    width_multipliers=self.width_multipliers,
                    num_conv_branches=self.num_conv_branches,
                    num_classes=self.num_classes,
                    in_features=self.in_features)

    def forward(self, x, qmode: str = "eval"):
        """``x`` (N, H, W, C) float32 → logits (N, num_classes)."""
        for name in self.block_names:
            x = getattr(self, name)(x, qmode=qmode)
        x = materialize(x).mean(dim=(1, 2))
        return materialize(self.linear(x, qmode=qmode))


@torch.no_grad()
def fuse_mobileone_block(block: MobileOneBlock, in_features: int,
                         kernel_size: int, groups: int,
                         num_conv_branches: int):
    """Fuse a train-form block's branches into (kernel, bias), OIHW."""
    kernel, bias = None, None
    for b in range(num_conv_branches):
        kb, bb = fold_conv_bn(getattr(block, f"conv{b}").weight, None,
                              *_bn_args(getattr(block, f"conv{b}_bn")))
        kernel = kb if kernel is None else kernel + kb
        bias = bb if bias is None else bias + bb
    if kernel_size > 1 and hasattr(block, "scale_branch"):
        ks, bs = fold_conv_bn(_pad_1x1_to_3x3(block.scale_branch.weight),
                              None, *_bn_args(block.scale_branch_bn))
        kernel, bias = kernel + ks, bias + bs
    if hasattr(block, "identity_bn"):
        kid, bid = _bn_only_to_conv(*_bn_args(block.identity_bn),
                                    in_features, groups)
        if kernel_size == 1:
            kid = kid[:, :, 1:2, 1:2]    # the identity is the centre tap
        kernel, bias = kernel + kid, bias + bid
    return kernel, bias


@torch.no_grad()
def mobileone_fuse(model: MobileOne) -> MobileOne:
    """Train-form MobileOne → deploy-form MobileOne on the same device."""
    device = model.linear.weight.device
    deploy = MobileOne(**model.twin_args(), deploy=True,
                       scheme=model.scheme).to(device)
    cur = model.in_features
    for name in model.block_names:
        block = getattr(model, name)
        conv0 = block.conv0
        # the stem block has one conv branch whatever the model says
        k, b = fuse_mobileone_block(block, cur, conv0.kernel_size,
                                    conv0.groups, block.num_conv_branches)
        getattr(deploy, name).reparam.weight.copy_(k)
        getattr(deploy, name).reparam.bias.copy_(b)
        cur = k.shape[0]
    deploy.linear.weight.copy_(model.linear.weight)
    deploy.linear.bias.copy_(model.linear.bias)
    return deploy.train(model.training)


def _factory(name, blocks, widths, k):
    @register(name)
    def fn(num_classes: int = 1000, deploy: bool = False, scheme=None,
           **kw):
        return MobileOne(num_blocks=blocks, width_multipliers=widths,
                         num_conv_branches=k, num_classes=num_classes,
                         deploy=deploy, scheme=scheme, **kw)
    fn.__name__ = name
    return fn


MobileOne_S0 = _factory("MobileOne_S0", (2, 8, 10, 1),
                        (0.75, 1.0, 1.0, 2.0), 4)
MobileOne_S1 = _factory("MobileOne_S1", (2, 8, 10, 1),
                        (1.5, 1.5, 2.0, 2.5), 1)
MobileOne_S2 = _factory("MobileOne_S2", (2, 8, 10, 1),
                        (1.5, 2.0, 2.5, 4.0), 1)
MobileOne_S3 = _factory("MobileOne_S3", (2, 8, 10, 1),
                        (2.0, 2.5, 3.0, 4.0), 1)
MobileOne_S4 = _factory("MobileOne_S4", (2, 8, 10, 1),
                        (3.0, 3.5, 3.5, 4.0), 1)
