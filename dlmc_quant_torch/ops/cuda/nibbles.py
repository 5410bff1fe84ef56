"""Two signed 4-bit values a byte: the W4 weight layouts of the kernels.

A weight of 4 bits or fewer stays packed in device memory and is unpacked
to int8 inside each kernel's weight load.  Every W4 layout here is its
kernel's int8 layout packed along its last axis, K (or C for the
depthwise conv): byte ``j`` holds element ``2j`` in its low nibble and
element ``2j + 1`` in its high nibble, an odd length padded with a zero.
A kernel unpacks a byte as ``(v ^ 8) - 8`` on each nibble; the plain
versions call :func:`unpack_nibbles` and run their int8 route.

The packed tensors are ``uint8``; the int8 layouts stay ``int8``, so a
kernel wrapper tells the two apart by the dtype.
"""

from __future__ import annotations

import torch

W4 = torch.uint8          # the dtype of every nibble-packed layout
INT4_MIN, INT4_MAX = -8, 7


def pack_nibbles(w: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] → uint8, two a byte along the last axis
    (even index in the low nibble; an odd length padded with a zero)."""
    if w.dtype != torch.int8:
        raise ValueError(f"expected int8 values, got {w.dtype}")
    if w.numel() and (int(w.min()) < INT4_MIN or int(w.max()) > INT4_MAX):
        raise ValueError("int4 packing takes values in [-8, 7], got "
                         f"[{int(w.min())}, {int(w.max())}]")
    if w.shape[-1] % 2:
        w = torch.cat([w, w.new_zeros(w.shape[:-1] + (1,))], dim=-1)
    u = w.to(torch.int16) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(W4).contiguous()


def unpack_nibbles(p: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles` → int8, the last axis cut to ``n``."""
    if p.dtype != W4:
        raise ValueError(f"expected nibble-packed uint8, got {p.dtype}")
    lo = (p & 0xF).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    both = torch.stack([(lo ^ 8) - 8, (hi ^ 8) - 8], dim=-1)
    return both.reshape(p.shape[:-1] + (2 * p.shape[-1],))[..., :n] \
        .contiguous()
