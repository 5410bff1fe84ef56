"""W4 weights in the port's four kernels that take a weight: the
nibble-packed layouts and each kernel's unpack.

A weight of 4 bits or fewer stays packed two values a byte in device
memory (``ops/cuda/nibbles.py``) and each kernel unpacks it where it
reads its weight.  On the CPU, tile-faithful numpy emulations of those
unpacks, with the device's own bit operations (the sign-extending
multiply, ``__byte_perm``), hold each against the int8 layout the W8
kernel reads:

* the GEMM: a packed B box of BN × 64 bytes loaded by TMA (unswizzled,
  zero past the tensor), each 8 bytes expanded to a 16-byte chunk stored
  at ``swizzle128`` — equal to the swizzled BN × 128 tile TMA writes for
  the int8 weight, at every W4 tile and a ragged N and K;
* the conv: its B tile built by 8-byte loads from the (O, Kp/2) layout
  (rows past O and bytes past Kp zero), also where Kp/2 is 8 mod 16 (C =
  3, 16, 48) — equal to the W8 tile;
* the depthwise conv: ``load_weights``' tap words from 16-bit words of
  nibbles — equal to W8's 32-bit words;
* the stem: the resident cells from 8 packed bytes — equal to W8's.

Each ``pack_*_int4`` round-trips through the plain versions' unpack, and
each plain version at W4 equals itself at W8 on the same values.
``cuda``-marked tests hold each kernel at W4 against its plain version on
the card (tolerance 0: exact integers and the same float epilogue) at
small and ragged shapes, every W4 GEMM tile and mode, the conv's odd
packed pitch, resident and streamed weights; they skip here:
``python -m pytest --noconftest tests/test_torch_int4_kernels.py -m cuda``.
"""

import re

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.ops.cuda import int8_dwconv as D
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.ops.cuda import int8_im2col as I
from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
from dlmc_quant_torch.ops.cuda.nibbles import (W4, pack_nibbles,
                                               unpack_nibbles)

torch.set_num_threads(1)
TILE_K = 128


def _w4(rng, shape):
    return torch.from_numpy(rng.integers(-8, 8, shape, dtype=np.int8))


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


# ----------------------------------------------- the device's bit operations

def _bytes(words):
    w = np.asarray(words, np.uint32).astype(np.int64)
    return [(w >> (8 * i)) & 0xFF for i in range(4)]


def _word(bs):
    return sum(np.asarray(b, np.uint32) << np.uint32(8 * i)
               for i, b in enumerate(bs)).astype(np.uint32)


def byte_perm(x, y, sel):
    """``__byte_perm`` (default mode): byte k of the result is byte
    (sel >> 4k) & 7 of the 8 bytes of (x, y)."""
    src = _bytes(x) + _bytes(y)
    return _word([src[(sel >> (4 * k)) & 7] for k in range(4)])


def sext(v):
    """``sext_nibbles``: v | ((v & 0x08080808) * 0x1E), in 32 bits."""
    v = np.asarray(v, np.uint32)
    return v | ((v & np.uint32(0x08080808)) * np.uint32(0x1E))


def unpack_nibbles16(p0, p1):
    """``unpack_nibbles16`` of csrc/wgmma_s8.cuh: 8 packed bytes → 4 words."""
    out = []
    for p in (np.asarray(p0, np.uint32), np.asarray(p1, np.uint32)):
        lo = sext(p & np.uint32(0x0F0F0F0F))
        hi = sext((p >> np.uint32(4)) & np.uint32(0x0F0F0F0F))
        out += [byte_perm(lo, hi, 0x5140), byte_perm(lo, hi, 0x7362)]
    return out


def unpack_pair(u):
    """``unpack_pair`` of csrc/int8_dwconv.cuh: 2 packed bytes → 1 word."""
    u = np.asarray(u, np.uint32)
    lo = sext(u & np.uint32(0x0F0F))
    hi = sext((u >> np.uint32(4)) & np.uint32(0x0F0F))
    return byte_perm(lo, hi, 0x5140)


def swizzle128(row, byte):
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def _expand_chunks(packed8):
    """(…, 8) uint8 → (…, 16) uint8 through unpack_nibbles16."""
    packed8 = np.ascontiguousarray(packed8)
    words = packed8.astype(np.uint8).view("<u4")
    out = unpack_nibbles16(words[..., 0], words[..., 1])
    return np.stack(out, axis=-1).astype("<u4").view(np.uint8)


def _store_chunks(chunks, bn):
    """A (BN · 8, 16) chunk list stored as the kernels do: chunk i at
    swizzle128(i / 8, 16 (i % 8))."""
    i = np.arange(bn * 8)
    tile = np.zeros(bn * 128, np.uint8)
    tile[swizzle128(i // 8, 16 * (i % 8))[:, None] + np.arange(16)] = chunks
    return tile


def _swizzled(rows):
    """A (BN, 128) byte tile in the 128-byte swizzle, as bytes."""
    bn = rows.shape[0]
    tile = np.zeros(bn * 128, np.uint8)
    r, k = np.meshgrid(np.arange(bn), np.arange(128), indexing="ij")
    tile[swizzle128(r, k)] = rows
    return tile


def _box(t, y0, x0, rows, cols):
    """A TMA box of ``rows`` × ``cols`` bytes at (x0, y0), zero outside."""
    out = np.zeros((rows, cols), np.uint8)
    part = t[y0:y0 + rows, x0:x0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


# --------------------------------------------------- emulations on the CPU

@pytest.mark.parametrize("tile", list(G.W4_TILE_STAGES),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_gemm_b_tile_unpack_equals_w8_tma_tile(tile):
    """The W4 producer warp: the packed BN × 64 box that TMA stages, each
    lane's 8 bytes at 8 i expanded and stored at swizzle128(i / 8,
    16 (i % 8)), against the W8 TMA box of the same K chunk."""
    bn = tile[1]
    rng = np.random.default_rng(bn)
    k, n = 200, bn + 37                      # ragged N and last K chunk
    w = _w4(rng, (k, n))
    w8 = G.pack_b(w).numpy().view(np.uint8)
    w4 = G.pack_b_int4(w).numpy()
    assert w4.shape[1] % 16 == 0              # TMA's pitch
    for n0 in (0, bn):
        for kc in range(-(-G.packed_k(k) // TILE_K)):
            staged = _box(w4, n0, kc * TILE_K // 2, bn, TILE_K // 2)
            chunks = _expand_chunks(staged.reshape(-1, 8))
            got = _store_chunks(chunks, bn)
            want = _swizzled(_box(w8, n0, kc * TILE_K, bn, TILE_K))
            assert np.array_equal(got, want), (n0, kc)


@pytest.mark.parametrize("c,o", [(3, 64), (16, 24), (48, 40), (20, 200),
                                 (64, 64)])
def test_conv_b_tile_unpack_equals_w8_tile(c, o):
    """The conv's unpack_b_tile: chunk i of the tile from the 8 packed
    bytes at o · Kp/2 + kbyte/2 (zero past O and Kp), 8-byte aligned also
    where Kp/2 is 8 mod 16, against the tile TMA writes from the W8
    layout."""
    rng = np.random.default_rng(c * o)
    w = _w4(rng, (3, 3, c, o))
    w8 = K.pack_weight(w).numpy().view(np.uint8)
    wp = K.pack_weight_int4(w).numpy()
    kp = K.packed_shape(c, o)[1]
    assert wp.shape == K.packed_shape_int4(c, o) and (kp // 2) % 8 == 0
    assert ((kp // 2) % 16 == 8) == (K.padded_run(c) // 16 % 2 == 1)
    flat = np.concatenate([wp.reshape(-1), np.zeros(8, np.uint8)])
    for bn in K.WIDTHS:
        i = np.arange(bn * 8)
        for n0 in range(0, o, bn):
            for kc in range(-(-kp // TILE_K)):
                oo, kbyte = n0 + i // 8, kc * TILE_K + 16 * (i % 8)
                live = (oo < o) & (kbyte < kp)
                at = np.where(live, oo * (kp // 2) + kbyte // 2, flat.size - 8)
                assert (at % 8 == 0).all()
                v = flat[at[:, None] + np.arange(8)]
                got = _store_chunks(_expand_chunks(v), bn)
                want = _swizzled(_box(w8, n0, kc * TILE_K, bn, TILE_K))
                assert np.array_equal(got, want), (bn, n0, kc)


@pytest.mark.parametrize("c", [8, 24, 144])
def test_dwconv_load_weights_words_equal_w8(c):
    """load_weights: the 16-bit word of a thread's 4 channels at tap t
    (uint16 index (t C + ch) / 4), unpacked, against W8's 32-bit word."""
    rng = np.random.default_rng(c)
    w = _w4(rng, (3, 3, 1, c))
    w8 = D.pack_weight(w).numpy().view(np.uint8).reshape(-1)
    w4 = D.pack_weight_int4(w).numpy().reshape(-1)
    assert D.pack_weight_int4(w).shape == (9, c // 2)
    halves = w4.view("<u2")
    words8 = w8.view("<u4")
    for tap in range(9):
        for ch in range(0, c, 4):
            at = tap * c + ch
            assert at % 4 == 0
            assert int(unpack_pair(halves[at // 4])) == int(words8[at // 4])


@pytest.mark.parametrize("c,o", [(3, 64), (4, 128), (1, 16)])
def test_stem_resident_cells_equal_w8(c, o):
    """The stem's resident weight: cell (k, o) from 8 packed bytes,
    unpacked, against W8's 16-byte cell."""
    rng = np.random.default_rng(c + o)
    w = _w4(rng, (7, 7, c, o))
    w8 = S.pack_weight(w).numpy().view(np.uint8)
    w4 = S.pack_weight_int4(w).numpy()
    assert w4.shape == (16, o, 8)
    assert np.array_equal(_expand_chunks(w4), w8)


def test_gemm_w4_tiles_are_the_sources():
    """The W4 instantiations compiled into csrc/int8_gemm.cu are
    W4_TILE_STAGES, each within a block's shared memory with its two
    staging slots."""
    text = (build.CSRC / "int8_gemm.cu").read_text()
    compiled = {(int(a), int(b)): int(c) for a, b, c in re.findall(
        r"DLMCQ_W4_TILE\((\d+), (\d+), (\d+)\)", text)}
    assert compiled == G.W4_TILE_STAGES
    assert set(compiled) == set(G.EPILOGUE_TILES)
    for tile in compiled:
        assert G.tile_smem_bytes(tile, int4=True) <= G.MAX_SMEM
        assert G.tile_smem_bytes(tile, int4=True) > G.tile_smem_bytes(tile)


def test_pack_nibbles_round_trips_every_value():
    v = torch.arange(-8, 8, dtype=torch.int8)
    for n in (15, 16):          # an odd and an even last axis
        w = v.repeat(3, 2)[:, :n]
        p = pack_nibbles(w)
        assert p.dtype == W4 and p.shape == (3, -(-n // 2))
        assert torch.equal(unpack_nibbles(p, n), w)
        # even index in the low nibble
        assert int(p[0, 0]) == ((int(w[0, 1]) & 0xF) << 4) | (int(w[0, 0])
                                                                & 0xF)
    with pytest.raises(ValueError, match=r"\[-8, 7\]"):
        pack_nibbles(torch.tensor([8], dtype=torch.int8))


def test_each_pack_int4_round_trips():
    rng = np.random.default_rng(4)
    w = _w4(rng, (3, 3, 20, 24))
    assert torch.equal(K.unpack_weight(K.pack_weight_int4(w), 20, 24), w)
    wg = _w4(rng, (40, 24))
    assert torch.equal(G.unpack_b(G.pack_b_int4(wg), 40), wg)
    wd = _w4(rng, (3, 3, 1, 24))
    assert torch.equal(D.unpack_weight(D.pack_weight_int4(wd), 24), wd)
    ws = _w4(rng, (7, 7, 3, 64))
    assert torch.equal(S.unpack_weight(S.pack_weight_int4(ws), 3), ws)
    assert torch.equal(I.pack_weight_int4(ws),
                       G.pack_b_int4(G.unpack_b(I.pack_weight(ws), 160)))


def test_plain_versions_at_w4_equal_w8():
    """The plain versions unpack and run their int8 routes: at W4 they
    equal themselves at W8 on the same values."""
    rng = np.random.default_rng(5)
    w = _w4(rng, (3, 3, 16, 24))
    x = _codes(rng, (2, 7, 9, 16))
    a, b = torch.rand(24), torch.randn(24)
    for s in (1, 2):
        assert torch.equal(
            K.int8_conv3x3(x, K.pack_weight(w), a, b, stride=s, pad=5),
            K.int8_conv3x3(x, K.pack_weight_int4(w), a, b, stride=s, pad=5))
    wg = _w4(rng, (48, 40))
    xg = _codes(rng, (33, 48))
    assert torch.equal(G.int8_gemm(xg, G.pack_b(wg)),
                       G.int8_gemm(xg, G.pack_b_int4(wg)))
    wd = _w4(rng, (3, 3, 1, 24))
    xd = _codes(rng, (2, 9, 8, 24))
    a, b = torch.rand(24), torch.randn(24)
    assert torch.equal(
        D.int8_dwconv3x3(xd, D.pack_weight(wd), a, b, stride=2, pad=0,
                         mode="f32"),
        D.int8_dwconv3x3(xd, D.pack_weight_int4(wd), a, b, stride=2, pad=0,
                         mode="f32"))
    ws = _w4(rng, (7, 7, 3, 32))
    xs = _codes(rng, (1, 21, 19, 3))
    pads = ((3, 3), (3, 3))
    assert torch.equal(S.int8_stem_pool(xs, S.pack_weight(ws), pads=pads,
                                        pad=1),
                       S.int8_stem_pool(xs, S.pack_weight_int4(ws),
                                        pads=pads, pad=1))


def test_wrappers_refuse_a_packed_weight_of_the_wrong_shape():
    rng = np.random.default_rng(6)
    x = _codes(rng, (2, 5, 5, 16))
    a, b = torch.rand(8), torch.rand(8)
    wrong = torch.zeros((8, 64), dtype=W4)       # Kp/2 is 72 for C = 16
    with pytest.raises(ValueError, match=r"pack_weight_int4"):
        K.int8_conv3x3(x, wrong, a, b, stride=1, pad=0)
    with pytest.raises(ValueError, match=r"pack_b_int4"):
        G.int8_gemm(_codes(rng, (4, 32)), torch.zeros((8, 32), dtype=W4))
    with pytest.raises(ValueError, match=r"pack_weight_int4"):
        D.int8_dwconv3x3(x, torch.zeros((9, 16), dtype=W4), torch.rand(16),
                         torch.rand(16), stride=1, pad=0)


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _dev(g, shape, lo, hi, dev):
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int8).to(dev)


# (n, h, w, c, o, plan override): the stem, the odd packed pitch (C = 16,
# 48), a byte-gathered C, a streamed weight (two tiles of O, or forced)
CONV_CASES = [(2, 17, 19, 3, 64, None), (2, 14, 14, 16, 24, None),
              (1, 15, 13, 48, 40, None), (2, 9, 11, 20, 200, None),
              (2, 12, 12, 64, 64, dict(resident=False)),
              (1, 16, 16, 16, 96, dict(resident=False))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=["x".join(map(str, c[:5])) for c in CONV_CASES])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_kernel_w4_matches_plain(case, stride):
    dev = _card()
    n, h, w, c, o, override = case
    g = torch.Generator().manual_seed(c * o + stride)
    x = _dev(g, (n, h, w, c), -128, 128, dev)
    wp = K.pack_weight_int4(_dev(g, (3, 3, c, o), -8, 8, dev))
    a = (torch.rand(o, generator=g) * 1e-2 + 1e-4).to(dev)
    b = (torch.randn(o, generator=g) * 4).to(dev)
    r = _dev(g, (n, -(-h // stride), -(-w // stride), o), -128, 128, dev)
    ar, br = torch.rand(o, device=dev), torch.randn(o, device=dev)
    for kw in (dict(mode="codes", lo=-5, hi=100), dict(mode="f32", relu=True),
               dict(mode="codes", residual=(r, ar, br), qb=0.5)):
        got = K.int8_conv3x3(x, wp, a, b, stride=stride, pad=-7, _plan=override,
                             **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, K.int8_conv3x3_plain(
            x, wp, a, b, stride=stride, pad=-7, **kw)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("tile", list(G.W4_TILE_STAGES),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("mkn", [(300, 48, 24), (1000, 432, 300),
                                 (77, 1280, 1000), (4099, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gemm_kernel_w4_matches_plain(tile, mkn):
    dev = _card()
    m, k, n = mkn
    g = torch.Generator().manual_seed(m + k + n + tile[1])
    x = _dev(g, (m, k), -128, 128, dev)
    wp = G.pack_b_int4(_dev(g, (k, n), -8, 8, dev))
    a = (torch.rand(n, generator=g) * 1e-3 + 1e-5).to(dev)
    b = (torch.randn(n, generator=g) * 4).to(dev)
    r = _dev(g, (m, n), -128, 128, dev)
    ar, br = torch.rand(n, device=dev), torch.randn(n, device=dev)
    for kw in (dict(), dict(a=a, b=b, mode="codes", lo=-9, hi=88),
               dict(a=a, b=b, mode="f32", relu=True),
               dict(a=a, b=b, mode="codes", residual=(r, ar, br), qb=-1.5)):
        got = G.int8_gemm(x, wp, tile=tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, G.int8_gemm_plain(x, wp, **kw)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3, 13, 11, 8, 1, 1), (2, 12, 9, 96, 2, 0),
                                  (2, 28, 28, 144, 1, 1),
                                  (8, 56, 56, 64, 2, 1)],
                         ids=["s1_c8", "s2_c96", "s1_c144", "s2_c64"])
def test_dwconv_kernel_w4_matches_plain(case):
    dev = _card()
    n, h, w, c, stride, pad_lo = case
    g = torch.Generator().manual_seed(c + h)
    x = _dev(g, (n, h, w, c), -128, 128, dev)
    wp = D.pack_weight_int4(_dev(g, (3, 3, 1, c), -8, 8, dev))
    a = (torch.rand(c, generator=g) * 1e-2 + 1e-4).to(dev)
    b = (torch.randn(c, generator=g) * 4).to(dev)
    for kw in (dict(mode="codes", lo=-3, hi=90), dict(mode="f32", relu=True)):
        got = D.int8_dwconv3x3(x, wp, a, b, stride=stride, pad=-11,
                               pad_lo=pad_lo, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, D.int8_dwconv3x3_plain(
            x, wp, a, b, stride=stride, pad=-11, pad_lo=pad_lo, **kw)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 37, 50, 3, 64), (1, 9, 260, 4, 128),
                                  (2, 64, 64, 3, 16)],
                         ids=lambda c: "x".join(map(str, c)))
def test_stem_kernel_w4_matches_plain(case):
    dev = _card()
    n, h, w, c, o = case
    g = torch.Generator().manual_seed(h * w)
    x = _dev(g, (n, h, w, c), -128, 128, dev)
    wp = S.pack_weight_int4(_dev(g, (7, 7, c, o), -8, 8, dev))
    pads = ((2, 3), (2, 3))
    got = S.int8_stem_pool(x, wp, pads=pads, pad=-99)
    torch.cuda.synchronize()
    assert torch.equal(got, S.int8_stem_pool_plain(x, wp, pads=pads,
                                                   pad=-99))
