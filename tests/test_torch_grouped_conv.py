"""Grouped 3×3 convs through the int8 conv kernel
(``ops/cuda/csrc/int8_conv3x3.cu``, ``ops/cuda/int8_conv.py``): RepVGG's
g2/g4 variants.

* The plain version in ``groups`` groups equals the JAX package's integer
  route for such a conv (``jax.lax.conv_general_dilated`` with
  ``feature_group_count``, an int32 accumulator, the pad code, then the
  same epilogue), exactly.
* The grouped weight layout (each tap's Cg channels padded to
  Tp = roundup(Cg, 16)) packs and unpacks, at W8 and W4.
* The plan: widths by the group's columns, no resident weight, halo
  buffers only where Cg % 16 == 0.
* A tile-faithful CPU emulation of the kernel's grouped path on its own
  plans: the walk over (group, tile of the group, M tile), each 16-byte
  chunk of the im2col tile read as the producer reads it (the halo or the
  aligned copy where Cg % 16 == 0, checked 16-byte aligned; two 8-byte
  copies where Cg % 8 == 0, checked 8-byte aligned; else five aligned
  words shifted into place; the bytes past a tap's run being x's next
  bytes, or zero past x), the B tile's rows from the group's first
  row (rows past O zero, TMA's fill; the next group's rows beside them),
  a and b staged tile by tile, the columns stored only inside the group.
  Equal to the plain version (tolerance 0) at every (Cg, Og) of the g2/g4
  variants, strides 1 and 2, ragged maps, both modes.
* The grouped build (``csrc/int8_conv3x3_grouped.cu``, the same source
  with its group code compiled in) is named after what it includes.
* ``_int8_matmul`` with a weight padded once (``pad_mm_weight``, a W8
  ``QDense``'s ``w_mm``) == the unpadded product.
* On the card (``cuda``, skipped here): the kernel == plain at the same
  (Cg, Og), both strides, both modes, the residual epilogue, W4, and
  ``_int8_matmul`` at the SE blocks' K = 4, 10, 20, padded here or once
  before, == the CPU product.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.ops.cuda.epilogue import epilogue_plain
from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.quant.layers import _int8_matmul, pad_mm_weight

torch.set_num_threads(1)

JUNK = 0x5A


def _zoo_groups():
    """(Cg, G) of every grouped conv of the g2/g4 variants: stage widths
    64·m, 128·m, 256·m for m = 2, 2.5, 3 (the B1, B2, B3 families)."""
    out = set()
    for m in (2.0, 2.5, 3.0):
        for w in (int(64 * m), int(128 * m), int(256 * m)):
            for g in (2, 4):
                out.add((w // g, g))
    return sorted(out)


ZOO = _zoo_groups()   # Cg = Og ∈ {32, 40, 48, 64, 80, 96, 128, 160, 192,
#                       256, 320, 384}


def _inputs(seed, n, h, w, c, o, groups):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wk = rng.integers(-128, 128, (3, 3, c // groups, o), dtype=np.int8)
    a = (np.abs(rng.standard_normal(o)) * 1e-4 + 1e-5).astype(np.float32)
    b = (rng.standard_normal(o) * 2.0).astype(np.float32)
    return x, wk, a, b


def _acc_ref(x, wk, stride, pad, pad_lo, groups):
    """The exact int32 accumulator of a grouped conv over the padded map."""
    n, h, w, c = x.shape
    ho, wo = K.out_hw(h, w, stride)
    pad_h = (ho - 1) * stride + 3 - h - pad_lo
    pad_w = (wo - 1) * stride + 3 - w - pad_lo
    xp = torch.nn.functional.pad(
        torch.from_numpy(x).permute(0, 3, 1, 2).double(),
        (pad_lo, max(pad_w, 0), pad_lo, max(pad_h, 0)), value=float(pad))
    acc = torch.nn.functional.conv2d(
        xp, torch.from_numpy(wk).permute(3, 2, 0, 1).double(), stride=stride,
        groups=groups)
    return acc.permute(0, 2, 3, 1).numpy().astype(np.int64)


class TestAgainstJax:
    @pytest.mark.parametrize("n,h,w,cg,og,g,stride,pad_lo", [
        (2, 7, 7, 10, 10, 4, 1, 1),
        (2, 8, 8, 20, 20, 4, 2, 0),    # SAME at stride 2 on an even map
        (1, 9, 6, 40, 40, 4, 2, 1),
        (2, 6, 6, 8, 8, 2, 1, 1),
        (1, 5, 7, 16, 24, 2, 1, 1),    # Og != Cg
    ])
    def test_codes_and_f32_equal(self, n, h, w, cg, og, g, stride, pad_lo):
        import jax
        import jax.numpy as jnp
        x, wk, a, b = _inputs(1, n, h, w, cg * g, og * g, g)
        pad = -9
        ho, wo = K.out_hw(h, w, stride)
        pads = ((pad_lo, (ho - 1) * stride + 3 - h - pad_lo),
                (pad_lo, (wo - 1) * stride + 3 - w - pad_lo))
        xp = jnp.pad(jnp.asarray(x), ((0, 0),) + pads + ((0, 0),),
                     constant_values=jnp.int8(pad))
        acc = jax.lax.conv_general_dilated(
            xp, jnp.asarray(wk), (stride, stride), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=g, preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * jnp.asarray(a) + jnp.asarray(b)
        wp = K.pack_weight(torch.from_numpy(wk), g)
        args = (torch.from_numpy(x), wp, torch.from_numpy(a),
                torch.from_numpy(b))
        got = K.int8_conv3x3(*args, stride=stride, pad=pad, pad_lo=pad_lo,
                             lo=pad, hi=127, groups=g)
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jnp.clip(jnp.round(y), pad, 127).astype(jnp.int8)))
        got = K.int8_conv3x3(*args, stride=stride, pad=pad, pad_lo=pad_lo,
                             mode="f32", relu=True, groups=g)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.maximum(y, 0.0)))


class TestLayout:
    @pytest.mark.parametrize("cg,og,g", [(10, 10, 4), (40, 40, 4),
                                         (32, 48, 2), (3, 5, 3)])
    def test_pack_roundtrip(self, cg, og, g):
        rng = np.random.default_rng(2)
        wk = torch.from_numpy(rng.integers(-8, 8, (3, 3, cg, og * g),
                                           dtype=np.int8))
        wp = K.pack_weight(wk, g)
        assert tuple(wp.shape) == K.packed_shape(cg * g, og * g, g) \
            == (og * g, 9 * K.tap_run(cg))
        assert torch.equal(K.unpack_weight(wp, cg * g, og * g, g), wk)
        w4 = K.pack_weight_int4(wk, g)
        assert tuple(w4.shape) == K.packed_shape_int4(cg * g, og * g, g)
        assert torch.equal(K.unpack_weight(w4, cg * g, og * g, g), wk)
        # each tap's run: Cg bytes of the weight, then zeros up to Tp
        runs = wp.reshape(og * g, 9, K.tap_run(cg))
        assert not runs[:, :, cg:].any()

    @pytest.mark.parametrize("cg,g", ZOO)
    def test_plan(self, cg, g):
        c = cg * g
        for stride in (1, 2):
            for mode in ("codes", "f32"):
                p = K.tile_plan(64 * 56 * 56 // stride ** 2, c, c, mode,
                                stride=stride, width=56, groups=g)
                assert not p.resident and p.smem <= K.MAX_SMEM
                assert p.n_tiles == g * -(-cg // p.bn)
                assert p.bn == min(w for w in K.WIDTHS if w >= min(cg, 256)) \
                    or (mode == "codes" and p.bn == K.WIDTHS[-2])
                # halo buffers where they fit, and only there
                assert not p.halo_bufs or (stride == 1 and cg % 16 == 0)

    def test_raises_on_groups_not_dividing(self):
        x, wk, a, b = _inputs(3, 1, 5, 5, 40, 40, 4)
        wp = K.pack_weight(torch.from_numpy(wk), 4)
        args = (torch.from_numpy(x), wp, torch.from_numpy(a),
                torch.from_numpy(b))
        with pytest.raises(ValueError):
            K.int8_conv3x3(*args, stride=1, pad=0, groups=3)
        with pytest.raises(ValueError):      # the ungrouped layout's shape
            K.int8_conv3x3(*args, stride=1, pad=0, groups=1)


def emulate(x, wp, a, b, *, stride, pad, pad_lo, groups, mode, lo=-128,
            hi=127, plan=None, x_offset=0):
    """The kernel's grouped path, tile by tile, on ``plan`` (default: the
    wrapper's).  ``x_offset`` models x's address mod 16 (a word-aligned
    tensor: a multiple of 4)."""
    n, h, w, c = x.shape
    o = a.shape[0]
    ho, wo = K.out_hw(h, w, stride)
    m_total = n * ho * wo
    cg, og = c // groups, o // groups
    tp, kp = K.tap_run(cg), K.packed_shape(c, o, groups)[1]
    plan = plan or K.tile_plan(m_total, c, o, mode, stride=stride, width=w,
                               groups=groups)
    bm, bn = K.BM, plan.bn
    assert not plan.resident
    ntg = -(-og // bn)
    assert plan.n_tiles == groups * ntg
    flat = x.reshape(-1).view(np.uint8)
    x_bytes = flat.size
    wpn = wp.numpy().view(np.uint8)
    # a and b staged tile by tile, zero past the group's end
    sa = np.zeros(plan.n_tiles * bn, np.float32)
    sb = np.zeros_like(sa)
    for i in range(sa.size):
        t = i // bn
        grp = t // ntg
        local = (t - grp * ntg) * bn + i % bn
        if local < og:
            sa[i], sb[i] = a[grp * og + local], b[grp * og + local]
    vec = cg % 16 == 0
    pad_u8 = np.uint8(pad & 0xFF)
    out = np.full((m_total, o), 77, np.float32)   # junk: every output set
    written = np.zeros((m_total, o), np.int32)
    k_chunks = -(-kp // K.TILE_K)
    for tile in range(plan.m_tiles * plan.n_tiles):
        n_tile, m_tile = divmod(tile, plan.m_tiles)
        m0 = m_tile * bm
        grp, nt = divmod(n_tile, ntg)
        n0, goff = grp * og + nt * bn, grp * cg
        ncols = min(bn, og - nt * bn)
        # the table of the tile's rows: (pixel of tap (0, 0), flags)
        rows = []
        for r in range(bm):
            m = m0 + r
            if m >= m_total:
                rows.append(None)
                continue
            nn_, rem = divmod(m, ho * wo)
            oh, ow = divmod(rem, wo)
            ih0, iw0 = oh * stride - pad_lo, ow * stride - pad_lo
            ins = [(0 <= ih0 + d < h, 0 <= iw0 + d < w) for d in range(3)]
            rows.append(((nn_ * h + ih0) * w + iw0, ins))
        a_tile = np.full((bm, k_chunks * K.TILE_K), JUNK, np.uint8)
        for r, e in enumerate(rows):
            if e is None:
                continue                   # left as it is: never stored
            pix0, ins = e
            for kb in range(0, min(kp, k_chunks * K.TILE_K), 16):
                tap, coff = divmod(kb, tp)
                dy, dx = divmod(tap, 3)
                if not (ins[dy][0] and ins[dx][1]):
                    a_tile[r, kb:kb + 16] = pad_u8
                    continue
                off = (pix0 + dy * w + dx) * c + goff + coff
                if vec:
                    # the halo (stride 1) holds whole pixels; either way a
                    # 16-byte aligned run of x
                    assert (x_offset + off) % 16 == 0 or plan.halo_bufs
                    assert off % 16 == 0
                    chunk = flat[off:off + 16]
                    assert chunk.size == 16
                elif cg % 8 == 0 and x_offset % 8 == 0:
                    # two 8-byte copies, the second zero past the end of x
                    assert (x_offset + off) % 8 == 0 and off + 8 <= x_bytes
                    chunk = np.zeros(16, np.uint8)
                    chunk[:8] = flat[off:off + 8]
                    if off + 16 <= x_bytes:
                        chunk[8:] = flat[off + 8:off + 16]
                else:
                    word0 = (x_offset + off) & ~3
                    if word0 - x_offset + 20 <= x_bytes and x_offset % 4 == 0:
                        words = flat[word0 - x_offset:word0 - x_offset + 20]
                        sh = (x_offset + off) & 3
                        chunk = words[sh:sh + 16]
                    else:
                        chunk = np.zeros(16, np.uint8)
                        tail = flat[off:off + 16]
                        chunk[:tail.size] = tail
                a_tile[r, kb:kb + 16] = chunk
        # B: the tile's BN rows from n0 (TMA: zero past O and past Kp)
        b_tile = np.zeros((bn, k_chunks * K.TILE_K), np.uint8)
        rows_b = wpn[n0:n0 + bn]
        b_tile[:rows_b.shape[0], :kp] = rows_b
        acc = a_tile.view(np.int8).astype(np.int64) \
            @ b_tile.view(np.int8).astype(np.int64).T
        live = min(bm, m_total - m0)
        for col in range(bn):
            if col >= ncols:
                continue                   # past the group: not stored
            y = epilogue_plain(
                torch.from_numpy(acc[:live, col:col + 1].astype(np.float64)),
                torch.from_numpy(sa[n_tile * bn + col:n_tile * bn + col + 1]),
                torch.from_numpy(sb[n_tile * bn + col:n_tile * bn + col + 1]),
                mode=mode, lo=lo, hi=hi).numpy()
            out[m0:m0 + live, n0 + col] = y[:, 0]
            written[m0:m0 + live, n0 + col] += 1
    assert (written == 1).all(), "an output stored twice or never"
    out = out.reshape(n, ho, wo, o)
    return out.astype(np.int8) if mode == "codes" else out


# ragged maps (M not a multiple of 128), both strides, SAME at stride 2
EMU_MAPS = [((1, 9, 7), 1, 1), ((2, 8, 6), 2, 0), ((1, 11, 5), 2, 1)]


@pytest.mark.parametrize("cg,g", ZOO, ids=[f"cg{c}-g{g}" for c, g in ZOO])
@pytest.mark.parametrize("shape,stride,pad_lo", EMU_MAPS,
                         ids=["9x7-s1", "8x6-s2-same", "11x5-s2"])
def test_emulation_matches_plain(cg, g, shape, stride, pad_lo):
    n, h, w = shape
    x, wk, a, b = _inputs(cg + g, n, h, w, cg * g, cg * g, g)
    wp = K.pack_weight(torch.from_numpy(wk), g)
    pad = -3
    for mode in ("codes", "f32"):
        kw = dict(stride=stride, pad=pad, pad_lo=pad_lo, groups=g, mode=mode)
        if mode == "codes":
            kw.update(lo=pad, hi=127)
        want = K.int8_conv3x3_plain(
            torch.from_numpy(x), wp, torch.from_numpy(a),
            torch.from_numpy(b), **kw).numpy()
        got = emulate(x, wp, a, b, **kw)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x_offset", [0, 4, 8, 12])
def test_emulation_small_channels_and_alignment(x_offset):
    """Cg = 10 and 20 (the tiny test models at g4), 8 and 40 (the 8-byte
    copies), Og != Cg, every word alignment of x."""
    for cg, og, g in ((10, 10, 4), (20, 12, 4), (8, 8, 2), (40, 24, 2)):
        x, wk, a, b = _inputs(5, 2, 7, 9, cg * g, og * g, g)
        wp = K.pack_weight(torch.from_numpy(wk), g)
        kw = dict(stride=1, pad=4, pad_lo=1, groups=g, mode="codes")
        want = K.int8_conv3x3_plain(
            torch.from_numpy(x), wp, torch.from_numpy(a),
            torch.from_numpy(b), **kw).numpy()
        np.testing.assert_array_equal(
            emulate(x, wp, a, b, x_offset=x_offset, **kw), want)
    # the acc alone against a direct grouped conv
    x, wk, a, b = _inputs(6, 1, 5, 5, 40, 40, 4)
    wp = K.pack_weight(torch.from_numpy(wk), 4)
    acc = _acc_ref(x, wk, 1, 0, 1, 4)
    got = emulate(x, wp, np.ones(40, np.float32), np.zeros(40, np.float32),
                  stride=1, pad=0, pad_lo=1, groups=4, mode="f32")
    np.testing.assert_array_equal(got, acc.astype(np.float32))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cg,g", ZOO, ids=[f"cg{c}-g{g}" for c, g in ZOO])
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_matches_plain_on_card(cg, g, stride):
    dev = _cuda()
    for n, h, w in ((2, 14, 14), (3, 9, 7)):
        x, wk, a, b = (torch.from_numpy(t).to(dev) for t in
                       _inputs(cg * g + n, n, h, w, cg * g, cg * g, g))
        wp = K.pack_weight(wk, g)
        w4 = K.pack_weight_int4(torch.clamp(wk, -8, 7), g)
        ho, wo = K.out_hw(h, w, stride)
        rng = np.random.default_rng(cg)
        res = (torch.from_numpy(rng.integers(-128, 128, (n, ho, wo, cg * g),
                                             dtype=np.int8)).to(dev),
               torch.full((cg * g,), 0.5, device=dev),
               torch.full((cg * g,), -1.0, device=dev))
        for weight in (wp, w4):
            for mode, extra in (("codes", dict(lo=-3, hi=127)),
                                ("f32", dict(relu=True)),
                                ("codes", dict(lo=-3, hi=127, residual=res,
                                               qb=0.25))):
                kw = dict(stride=stride, pad=-3, groups=g, mode=mode, **extra)
                got = K.int8_conv3x3(x, weight, a, b, **kw)
                torch.cuda.synchronize()
                want = K.int8_conv3x3_plain(x, weight, a, b, **kw)
                assert torch.equal(got, want), (n, h, w, mode, weight.dtype)


@pytest.mark.cuda
def test_kernel_small_groups_on_card():
    """The tiny models' Cg = 10, 20 and Og != Cg, SAME at stride 2, a
    streamed weight at every plan depth."""
    dev = _cuda()
    for cg, og, g, stride, pad_lo in ((10, 10, 4, 1, 1), (20, 20, 4, 2, 0),
                                      (20, 12, 4, 1, 1), (8, 8, 2, 2, 1),
                                      (40, 40, 4, 1, 1)):
        x, wk, a, b = (torch.from_numpy(t).to(dev) for t in
                       _inputs(7, 2, 10, 10, cg * g, og * g, g))
        wp = K.pack_weight(wk, g)
        for stages in (4, 5):
            kw = dict(stride=stride, pad=5, pad_lo=pad_lo, lo=5, hi=127,
                      groups=g)
            got = K.int8_conv3x3(x, wp, a, b, _plan=dict(stages=stages), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, K.int8_conv3x3_plain(x, wp, a, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 10, 20])
def test_se_int8_matmul_on_card(k):
    """RepVGG-D2se's SE ``up`` layers: K = C/16 is not a multiple of 8."""
    dev = _cuda()
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.integers(-128, 128, (64, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (16 * k, k),
                                      dtype=np.int8))
    want = _int8_matmul(x, w)
    for weight, n in ((w, None), (pad_mm_weight(w), 16 * k)):
        got = _int8_matmul(x.to(dev), weight.to(dev), n)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,k,n", [(2, 4, 64), (64, 10, 160), (3, 20, 10),
                                   (8, 16, 16)])
def test_int8_matmul_padded_weight(m, k, n):
    """``pad_mm_weight`` pads N and K to multiples of 8 with zeros (no copy
    where both are), and the product with it is the unpadded one, exactly,
    on the CPU route as on the card's."""
    rng = np.random.default_rng(m * k)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (n, k), dtype=np.int8))
    wp = pad_mm_weight(w)
    assert wp.shape == (-(-n // 8) * 8, -(-k // 8) * 8)
    assert torch.equal(wp[:n, :k], w) and int(wp.abs().sum()) == int(
        w.abs().sum())
    want = (x.long() @ w.long().t()).int()
    assert torch.equal(_int8_matmul(x, wp, n), want)
    assert torch.equal(_int8_matmul(x, w), want)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_dense_plan_pads_its_weight_once(w_bits):
    """A W8 ``QDense`` plan keeps ``w_mm``, its weight padded once by
    ``prepare_deploy`` (an SE ``up`` layer: K = 10, N = 160), and its
    integer forward equals the float64 product of its codes with
    ``w_int``; a W4 plan keeps no int8 weight."""
    from dlmc_quant_torch.quant.config import scheme_from_dict
    from dlmc_quant_torch.quant.layers import QDense, attach_scheme
    torch.manual_seed(0)
    dense = QDense(10, 160)
    attach_scheme(dense, scheme_from_dict({
        "quantization_type": "LSQ",
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": w_bits, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}}}))
    x = torch.from_numpy(np.random.default_rng(3).random(
        (5, 10), dtype=np.float32))
    with torch.no_grad():
        dense(x, qmode="calibrate")
        dense.prepare_deploy()
        got = dense(x, qmode="int")
    if w_bits == 4:
        assert not hasattr(dense, "w_mm") and not hasattr(dense, "w_int")
        return
    assert dense.w_mm.shape == (160, 16)
    assert torch.equal(dense.w_mm[:, :10], dense.w_int)
    assert not dense.w_mm[:, 10:].any()
    codes, epi_scale, bias_eff, _ = dense._int_input(x)
    acc = codes.double() @ dense.w_int.double().t()
    assert torch.equal(got, acc.float() * epi_scale + bias_eff)


def test_grouped_build_hashes_what_it_includes(tmp_path, monkeypatch):
    """The grouped build is ``int8_conv3x3.cu`` compiled again: its library
    name follows that source and the header it includes, and an edit to
    the grouped source alone leaves the ungrouped build as it is."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    for edited in ("int8_conv3x3.cu", "wgmma_s8.cuh",
                   "int8_conv3x3_grouped.cu"):
        before = (build.library_path("int8_conv3x3_grouped").name,
                  build.library_path("int8_conv3x3").name)
        (csrc / edited).write_bytes((csrc / edited).read_bytes()
                                    + b"\n// edited\n")
        after = (build.library_path("int8_conv3x3_grouped").name,
                 build.library_path("int8_conv3x3").name)
        assert after[0] != before[0], edited
        assert (after[1] == before[1]) == (edited ==
                                           "int8_conv3x3_grouped.cu")
    assert "int8_conv3x3_grouped" in build.SOURCES


def _grouped_layer(w_bits, family="LSQ"):
    """A 3×3 conv in 4 groups (Cg = 10) under a per-channel minmax scheme,
    calibrated on a seeded batch."""
    from dlmc_quant_torch.quant.config import scheme_from_dict
    from dlmc_quant_torch.quant.layers import QConv, attach_scheme
    torch.manual_seed(0)
    conv = QConv(40, 40, 3, 1, 1, groups=4, use_bias=True)
    attach_scheme(conv, scheme_from_dict({
        "quantization_type": family,
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": w_bits, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}}}))
    x = torch.from_numpy(np.random.default_rng(4).random(
        (2, 6, 6, 40), dtype=np.float32))
    with torch.no_grad():
        conv(x, qmode="calibrate")
    return conv, x


@pytest.mark.parametrize("w_bits", [8, 4])
def test_grouped_layer_int_matches_its_plan(w_bits):
    """A grouped QConv's integer forward (its plan packed group by group,
    nibble-packed at W4) equals a float64 grouped conv of its plan's input
    codes and int8 weights with the plan's epilogue, exactly; and its
    fake-quant ``'eval'`` within relative L2 1e-3 (C2: an input code may
    sit one away at a tie)."""
    from dlmc_quant_torch.quant.chain import materialize
    conv, x = _grouped_layer(w_bits, "FSPTQ")
    conv.prepare_deploy()
    assert conv.w_packed.dtype == (torch.uint8 if w_bits == 4
                                   else torch.int8)
    with torch.no_grad():
        de = conv(x, qmode="intc")
        assert de.acc.groups == 4
        got = materialize(de)
        assert torch.equal(conv(x, qmode="int"), got)
        codes = conv._input_codes(x)
        w_int = conv.w_int if w_bits == 8 else torch.from_numpy(
            K.unpack_weight(conv.w_packed, 40, 40, 4).permute(3, 2, 0, 1)
            .numpy())
        xp = torch.nn.functional.pad(
            codes.permute(0, 3, 1, 2).double(), (1, 1, 1, 1),
            value=float(conv.plan_scalars["pad_val"]))
        acc = torch.nn.functional.conv2d(xp, w_int.double(), groups=4)
        want = (acc.permute(0, 2, 3, 1).float() * conv.epi_scale
                + conv.bias_eff)
        assert torch.equal(got, want)
        fq = conv(x, qmode="eval")
    assert float((got - fq).norm() / fq.norm()) <= 1e-3


def test_grouped_layer_with_weight_offset_raises():
    """A weight offset's row term needs window sums per group (ROADMAP item
    7b): a grouped conv with one raises rather than dropping it."""
    conv, x = _grouped_layer(8)
    with torch.no_grad():
        conv.wt_offset.fill_(1e-3)
    conv.prepare_deploy()
    with pytest.raises(NotImplementedError, match="item 7b"):
        with torch.no_grad():
            conv(x, qmode="int")
