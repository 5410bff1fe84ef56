"""The int8 3x3 conv kernel's plan and data movement, on the CPU.

The kernel (dlmc_quant_torch/ops/cuda/csrc/int8_conv3x3.cu, on the header
wgmma_s8.cuh) runs only on the card; what surrounds its wgmmas is checked
here with a tile-faithful copy in torch and numpy:

- ``pack_weight``'s K order (window row, tap, channel) and its round trip;
- ``tile_plan`` at all 22 layer shapes of RepVGG-A0 at batch 256: the tile
  is as wide as the layer, the shared memory fits a block, the ring has at
  least as many stages as producer warps, stride-1 layers get a halo;
- the producers' ring: every producer warp owns every fourth stage; the
  hand-over runs to its end, and a barrier's parity stays unambiguous with
  4 or more stages but not with 3;
- ``emulate_conv``: persistent blocks walk the tiles; per stage the table of
  where each pixel reads, the chunk -> (window row, tap, channel, source
  pixel or pad code) map written through ``swizzle128`` into a buffer that
  starts as garbage and is never cleared, from the halo buffer or from x,
  read back per tile and multiplied against the zero-filled weight tile;
  the epilogue in float32.  Equal to ``int8_conv3x3_plain``, tolerance 0
  (both sides hold an exact integer accumulator and do the same float32
  operations).  The ResNets' widths too: the two warpgroups' turns (each
  one's slots and full-barrier parities against the barriers' phases),
  the A tiles as TMA boxes of consecutive pixels with the rows outside
  the image padded, the A fragments gathered from a 64-byte-swizzled halo,
  a 256-wide tile's codes in two passes, and the staged residual's r boxes
  and boxes of codes in TMA's swizzle of their row width through two slots
  a warpgroup; at C = 64, 128 and 256 in codes, f32 with ReLU, r of each
  dtype, the row term and W4;
- ``tile_plan`` at ResNet-50's, cifar_resnet18's and config #5's launches;
- the ring in turns: at 4 or 8 stages no producer waits for a release
  while the one before is due, at other depths one can (``turns_run``).
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_conv as K

torch.set_num_threads(1)
TILE_K = K.TILE_K
GARBAGE = 0x5B      # what shared memory holds before anything is written


def swizzle128(row, byte):
    """Copy of ``swizzle128`` in csrc/wgmma_s8.cuh."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def _inputs(seed, n, h, w, c, o):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wk = rng.integers(-128, 128, (3, 3, c, o), dtype=np.int8)
    a = (np.abs(rng.standard_normal(o)) * 1e-3 + 1e-4).astype(np.float32)
    b = (rng.standard_normal(o) * 2.0).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, wk, a, b)]


def fastdiv(d):
    """(mul, shift) of the kernel's FastDiv for divisor d."""
    l = 0
    while (1 << l) < d:
        l += 1
    shift = 31 + l
    return (1 << shift) // d + 1, shift


def _div(n, magic):
    return (n * magic[0]) >> magic[1]


def tile_table(m0, m, h, w, ho, wo, stride, pad_lo=1):
    """(pixel index of tap (0, 0), flags) of the tile's rows, as the
    producer writes them (``row_entry``): bit dy / 3 + dx for a window row
    / column inside the image, bit 6 for a row before M."""
    by_hw, by_wo = fastdiv(ho * wo), fastdiv(wo)
    table = []
    for r in range(K.BM):
        row = m0 + r
        if row >= m:
            table.append((0, 0))
            continue
        n = _div(row, by_hw)
        rem = row - n * ho * wo
        oh = _div(rem, by_wo)
        ow = rem - oh * wo
        assert (n, oh, ow) == (row // (ho * wo), rem // wo, rem % wo)
        ih0, iw0 = oh * stride - pad_lo, ow * stride - pad_lo
        flags = 1 << 6
        for d in range(3):
            flags |= (0 <= ih0 + d < h) << d
            flags |= (0 <= iw0 + d < w) << (3 + d)
        table.append(((n * h + ih0) * w + iw0, flags))
    return table


def fill_stage(buf, table, xf, halo, kc, c, w, pad, kp):
    """One stage's A tile: ``buf`` (BM·128 int8, swizzled, stale) gets every
    chunk a producer warp writes; chunks past K and rows past M stay."""
    rp = K.padded_run(c)
    pad = np.int8(pad)
    for row, (pix0, flags) in enumerate(table):
        if not flags >> 6 & 1:
            continue
        for q in range(TILE_K // 16):
            kbyte = kc * TILE_K + 16 * q
            if kbyte >= kp:
                continue
            at = swizzle128(row, 16 * q)
            if c % 16 == 0:             # a chunk lies inside one tap
                tap, coff = divmod(kbyte, c)
                dy, dx = divmod(tap, 3)
                need = (1 << dy) | (8 << dx)
                if flags & need != need:
                    buf[at:at + 16] = pad
                elif halo is not None:  # pixel row + dy W + dx of the run
                    src = (row + dy * w + dx) * c + coff
                    buf[at:at + 16] = halo[src:src + 16]
                else:
                    src = (pix0 + dy * w + dx) * c + coff
                    buf[at:at + 16] = xf[src:src + 16]
                continue
            dy, roff = divmod(kbyte, rp)  # 16 bytes of a window row's run
            for i in range(min(16, 3 * c - roff)):
                dx = (roff + i) // c
                inside = flags >> dy & 1 and flags >> (3 + dx) & 1
                src = (pix0 + dy * w) * c + roff + i
                buf[at + i] = xf[src] if inside else pad


def swizzled_halo(xm, first, w):
    """halo_a's halo buffer: the tile's run of pixels from ``first`` as
    TMA's boxes of at most 256 pixels write it, 64-byte rows in the 64-byte
    swizzle (zeros before and past x)."""
    rows = K.BM + 2 * w + 2
    box = min(rows, 256)
    return np.concatenate([tma_load(xm, 0, first + k * box, box, 64)
                           for k in range(-(-rows // box))]).view(np.int8)


def gather_tile(halo, table, kc, c, w, kp, pad):
    """halo_a: the A tile of chunk kc (BM rows x 128 bytes, row-major) as
    the consumers' ldmatrix gathers it: row r's 16 bytes at K byte kbyte
    from pixel r + dy W + dx of the swizzled halo (``swizzled_halo``), or
    the pad block where the tap lies outside the image, the row past M or
    the bytes past K."""
    tile = np.empty((K.BM, TILE_K), dtype=np.int8)
    for r, (_, flags) in enumerate(table):
        for q in range(TILE_K // 16):
            kbyte = kc * TILE_K + 16 * q
            tap, coff = divmod(kbyte, c)
            dy, dx = divmod(tap, 3)
            need = (1 << dy) | (8 << dx)
            if kbyte < kp and flags & need == need:
                at = swizzle_box((r + dy * w + dx) * 64 + coff, 64)
                tile[r, 16 * q:16 * q + 16] = halo[at:at + 16]
            else:
                tile[r, 16 * q:16 * q + 16] = np.int8(pad)
    return tile


def swizzle_box(offset, row_bytes):
    """Copy of ``swizzle_box`` in csrc/wgmma_s8.cuh: TMA's swizzle of a box
    of rows ``row_bytes`` long (32, 64 or 128; at 128 it is swizzle128)."""
    return offset ^ (((offset >> 7) & (row_bytes // 16 - 1)) << 4)


def wnp_tile(wnp, n0, kc, bn, o, kp):
    """The weight tile of chunk kc: zero past O and past Kp, as TMA fills
    it."""
    bt = np.zeros((bn, TILE_K), dtype=np.int64)
    cols = min(bn, o - n0)
    take = min(TILE_K, kp - kc * TILE_K)
    bt[:cols, :take] = wnp[n0:n0 + cols, kc * TILE_K:kc * TILE_K + take]
    return bt


def tma_load(mat, x0, y0, rows, row_bytes):
    """The box of ``mat`` (a 2-D uint8 array) at byte x0 of row y0, as TMA
    writes it into shared memory: zeros outside ``mat`` (y0 may be
    negative), laid out with the swizzle of its row width."""
    box = np.zeros((rows, row_bytes), dtype=np.uint8)
    ys = np.arange(y0, y0 + rows)
    ok = (ys >= 0) & (ys < mat.shape[0])
    take = max(0, min(row_bytes, mat.shape[1] - x0))
    box[ok, :take] = mat[ys[ok], x0:x0 + take]
    out = np.empty(rows * row_bytes, dtype=np.uint8)
    out[swizzle_box(np.arange(rows * row_bytes), row_bytes)] = box.reshape(-1)
    return out


def tma_store(out, box, x0, y0, rows, row_bytes):
    """The TMA store of a swizzled box into ``out`` (2-D uint8): rows and
    bytes past ``out`` clipped."""
    flat = box[swizzle_box(np.arange(rows * row_bytes), row_bytes)]
    flat = flat.reshape(rows, row_bytes)
    nr = max(0, min(rows, out.shape[0] - y0))
    nb = max(0, min(row_bytes, out.shape[1] - x0))
    out[y0:y0 + nr, x0:x0 + nb] = flat[:nr, :nb]


def epilogue_f32(acc, a, b, mode, lo, hi, relu, r=None, ar=None, br=None,
                 qb=0.0, s=None, c=None):
    """The kernel's epilogue on a block of accumulators, one rounded
    float32 op at a time (numpy float32 never fuses), in its order."""
    f = np.float32
    y = acc.astype(f) * a.astype(f)
    if s is not None:
        y = y + s.astype(f)[:, None] * c.astype(f)
    if r is not None:
        y = (f(qb) + y) + b.astype(f)
        y = (y + r.astype(f) * ar.astype(f)) + br.astype(f)
    else:
        y = y + b.astype(f)
    if mode == "codes":
        return np.clip(np.rint(y), lo, hi).astype(np.int64)
    return np.maximum(y, f(0)) if relu else y


def turns_bookkeeping(tiles, k_chunks, stages, turns):
    """Each consumer warpgroup's slot and full-barrier parity at every chunk
    of the tiles it owns, as the kernel steps them: the ring's (stage,
    parity) over the block's sequence where both warpgroups read every
    tile; in turns a warpgroup skips the other's tiles and waits on full
    barriers of its own, whose parity flips at each of its uses of the
    slot.  Held against the barriers' phases: the fills of each (barrier,
    slot) in the ring's order.  Returns each tile's warpgroups."""
    state = [[0, 0, 0], [0, 0, 0]]        # stage, ring parity, own bits
    fills = {}                            # (barrier, slot) -> phases done
    owners = []
    for walked, _ in enumerate(tiles):
        mine = [walked % 2] if turns else [0, 1]
        owners.append(mine)
        bar = walked % 2 if turns else 0
        for wg in (0, 1):
            if wg not in mine:
                stage, parity, own = state[wg]
                seq = stage + k_chunks
                state[wg] = [seq % stages, parity ^ (seq // stages) & 1, own]
        for kc in range(k_chunks):
            seq = walked * k_chunks + kc
            slot = seq % stages
            for wg in mine:
                stage, parity, own = state[wg]
                assert (stage, parity) == (slot, (seq // stages) & 1)
                # the wait's parity is that of the phase it waits for
                assert ((own >> stage) & 1 if turns else parity) \
                    == fills.get((bar, slot), 0) & 1
                own ^= 1 << stage
                stage += 1
                if stage == stages:
                    stage, parity = 0, parity ^ 1
                state[wg] = [stage, parity, own]
            fills[bar, slot] = fills.get((bar, slot), 0) + 1
    return owners


def emulate_conv(x, wp, a, b, *, stride, pad, pad_lo=1, lo=-128, hi=127,
                 mode="codes", relu=False, residual=None, qb=0.0, row=None,
                 groups=1, blocks=3, **overrides):
    """int8_conv3x3.cu's walk on the CPU (see the module docstring); the
    ungrouped build."""
    assert groups == 1
    from dlmc_quant_torch.ops.cuda.nibbles import W4, unpack_nibbles
    n, h, w, c = x.shape
    o = a.shape[0]
    ho, wo = K.out_hw(h, w, stride)
    m = n * ho * wo
    plan = K.launch_plan(x, o, mode, stride, 1, residual, overrides or None)
    kp = K.packed_shape(c, o)[1]
    wnp = (unpack_nibbles(wp, kp) if wp.dtype == W4 else wp).numpy()
    xf = x.reshape(-1).numpy()
    xm = x.reshape(-1, c).numpy().view(np.uint8)      # (pixels, C) for TMA
    turns = plan.bn in K.TURN_WIDTHS
    rows_wg = 128 if turns else 64
    staged = residual is not None and turns
    tma = K.tma_rows(c, stride) and plan.halo_bufs == 0
    # the consumers gather A from the halo (turns, a resident weight): each
    # warpgroup waits on the buffers of its own tiles, 2 or 4 of them
    halo_a = K.halo_gathered(plan.bn, c, plan.resident) and plan.halo_bufs
    assert not halo_a or plan.halo_bufs in (2, 4)
    a_np, b_np = a.numpy(), b.numpy()
    r_np = ar_np = br_np = None
    if residual is not None:
        r_np = residual[0].reshape(m, o).numpy()
        ar_np, br_np = residual[1].numpy(), residual[2].numpy()
    s_np = c_np = None
    if row is not None:
        s_np, c_np = row[0].reshape(m).numpy(), row[1].numpy()
    grid = min(blocks, plan.m_tiles * plan.n_tiles)
    out = np.full((m, o), 99, dtype=np.float64)
    out_codes = np.full((m, o), 0x63, dtype=np.uint8)   # the TMA stores'
    written = np.zeros((m, o), dtype=np.int64)
    rows_cols = swizzle128(np.arange(K.BM)[:, None], np.arange(TILE_K)[None])
    sw = 128 if plan.bn == 256 else plan.bn
    pitch = sw if sw == 48 else sw + 16
    if staged:
        rb = residual[0].element_size()
        cw = min(plan.bn, TILE_K // rb)
        r_row, o_row = cw * rb, cw
        r_mat = residual[0].reshape(m, o).numpy().view(np.uint8) \
            .reshape(m, o * rb)
    for block in range(grid):
        ring = [np.full(K.BM * TILE_K, GARBAGE, dtype=np.int8)
                for _ in range(plan.stages)]
        halos = [np.full(K.halo_bytes(w, c), GARBAGE, dtype=np.int8)
                 for _ in range(plan.halo_bufs)]
        staging = [np.full((rows_wg, pitch), GARBAGE, dtype=np.uint8)
                   for _ in range(2)]
        slots = [[np.full(rows_wg * TILE_K * 2, GARBAGE, dtype=np.uint8)
                  for _ in range(K.R_SLOTS)] for _ in range(2)]
        ch = [0, 0]
        stage = 0
        tiles = list(range(block, plan.m_tiles * plan.n_tiles, grid))
        owners = turns_bookkeeping(tiles, plan.k_chunks, plan.stages, turns)
        for walked, tile in enumerate(tiles):
            m0 = (tile % plan.m_tiles) * K.BM
            n0 = (tile // plan.m_tiles) * plan.bn
            halo = None
            if plan.halo_bufs:        # one bulk copy of the tile's pixels
                halo = halos[walked % plan.halo_bufs]
                first = m0 - w - 1
                lo_px = max(first, 0)
                hi_px = min(first + K.BM + 2 * w + 2, n * h * w)
                halo[(lo_px - first) * c:(hi_px - first) * c] = \
                    xf[lo_px * c:hi_px * c]
            table = tile_table(m0, m, h, w, ho, wo, stride, pad_lo)
            acc = np.zeros((K.BM, plan.bn), dtype=np.int64)
            for kc in range(plan.k_chunks):
                buf = ring[stage]
                stage = (stage + 1) % plan.stages
                if halo_a:
                    a_rows = gather_tile(swizzled_halo(xm, m0 - w - 1, w),
                                         table, kc, c, w, kp, pad)
                    acc += a_rows.astype(np.int64) @ wnp_tile(
                        wnp, n0, kc, plan.bn, o, kp).T
                    continue
                if tma:
                    # one TMA box: 128 pixels from m0 + (dy-1) W + (dx-1),
                    # 128 channels; the consumers pad rows outside the image
                    tap, cq = divmod(kc, c // TILE_K)
                    dy, dx = divmod(tap, 3)
                    buf[:] = tma_load(xm, cq * TILE_K,
                                      m0 + (dy - 1) * w + dx - 1, K.BM,
                                      TILE_K).view(np.int8)
                    need = (1 << dy) | (8 << dx)
                    for r, (_, flags) in enumerate(table):
                        if flags >> 6 & 1 and flags & need != need:
                            buf[r * TILE_K:(r + 1) * TILE_K] = np.int8(pad)
                else:
                    fill_stage(buf, table, xf, halo, kc, c, w, pad, kp)
                acc += buf[rows_cols].astype(np.int64) @ wnp_tile(
                    wnp, n0, kc, plan.bn, o, kp).T
            cols = min(plan.bn, o - n0)
            for wg in owners[walked]:
                r_lo = 0 if turns else 64 * wg
                rm = m0 + r_lo                     # the warpgroup's row 0
                nr = max(0, min(rows_wg, m - rm))
                if not nr:
                    continue
                take = slice(rm, rm + nr)
                sl = slice(n0, n0 + cols)
                a_acc = acc[r_lo:r_lo + rows_wg]
                sv = None
                if s_np is not None:
                    sv = np.zeros(rows_wg, dtype=np.int64)
                    sv[:nr] = s_np[take]
                pa = np.zeros(plan.bn, np.float32)
                pb = np.zeros(plan.bn, np.float32)
                pa[:cols], pb[:cols] = a_np[sl], b_np[sl]
                pc = None
                if c_np is not None:
                    pc = np.zeros(plan.bn, np.float32)
                    pc[:cols] = c_np[sl]
                if staged:
                    # chunks of cw columns through the warpgroup's slots: r
                    # by TMA (the first two at the tile's start, chunk k + 2
                    # once chunk k is stored), codes written in the lane
                    # map at their swizzled place, the box stored by TMA
                    n_chunks = min(plan.bn // cw, -(-(o - n0) // cw))
                    par = np.zeros(plan.bn, np.float32)
                    pbr = np.zeros(plan.bn, np.float32)
                    par[:cols], pbr[:cols] = ar_np[sl], br_np[sl]

                    def load(u, k):
                        slots[wg][u % K.R_SLOTS][:rows_wg * r_row] = \
                            tma_load(r_mat, (n0 + k * cw) * rb, rm, rows_wg,
                                     r_row)
                    for k in range(min(K.R_SLOTS, n_chunks)):
                        load(ch[wg] + k, k)
                    for k in range(n_chunks):
                        slot = slots[wg][ch[wg] % K.R_SLOTS]
                        o_at = 0 if rb == 1 else rows_wg * r_row
                        rr = np.arange(rows_wg)[:, None]
                        cc = np.arange(cw)[None]
                        rv = slot[swizzle_box(rr * r_row + rb * cc, r_row)
                                  [..., None] + np.arange(rb)]
                        rv = rv.copy().view(residual[0].numpy().dtype)[..., 0]
                        ks = slice(k * cw, (k + 1) * cw)
                        code = epilogue_f32(
                            a_acc[:, ks], pa[ks], pb[ks], mode, lo, hi,
                            relu, rv, par[ks], pbr[ks], qb, sv,
                            None if pc is None else pc[ks])
                        slot[o_at + swizzle_box(rr * o_row + cc, o_row)] = \
                            code.astype(np.int8).view(np.uint8)
                        tma_store(out_codes, slot[o_at:o_at + rows_wg * o_row],
                                  n0 + k * cw, rm, rows_wg, o_row)
                        ch[wg] += 1
                        if k + K.R_SLOTS < n_chunks:
                            load(ch[wg] - 1 + K.R_SLOTS, k + K.R_SLOTS)
                    written[take, sl] += 1
                    continue
                rv = par = pbr = None
                if residual is not None:     # the register route
                    rv = np.zeros((rows_wg, plan.bn))
                    rv[:nr, :cols] = r_np[take, sl]
                    par = np.zeros(plan.bn, np.float32)
                    pbr = np.zeros(plan.bn, np.float32)
                    par[:cols], pbr[:cols] = ar_np[sl], br_np[sl]
                y = epilogue_f32(a_acc, pa, pb, mode, lo, hi, relu, rv, par,
                                 pbr, qb, sv, pc)
                if mode == "codes":
                    # staged by each warp in passes of sw columns, read out
                    # row by row where the row is before M and the column
                    # before O
                    stg = staging[wg]
                    for p in range(plan.bn // sw):
                        stg[:, :sw] = y[:, p * sw:(p + 1) * sw].astype(
                            np.int8).view(np.uint8)
                        pc0 = n0 + p * sw
                        pw_ = max(0, min(sw, o - pc0))
                        out_codes[take, pc0:pc0 + pw_] = stg[:nr, :pw_]
                else:
                    out[take, sl] = y[:nr, :cols]
                written[take, sl] += 1
    assert (written == 1).all()
    if mode == "codes":
        got = torch.from_numpy(out_codes.view(np.int8).copy())
    else:
        got = torch.from_numpy(out).to(torch.float32)
    return got.reshape(n, ho, wo, o), plan


class TestPackedWeight:
    @pytest.mark.parametrize("c,o", [(3, 48), (5, 8), (13, 70), (16, 16),
                                     (20, 8), (48, 96), (192, 300)])
    def test_round_trip_and_k_order(self, c, o):
        wk = _inputs(c + o, 1, 1, 1, c, o)[1]
        wp = K.pack_weight(wk)
        rp = K.padded_run(c)
        assert wp.dtype == torch.int8 and tuple(wp.shape) == (o, 3 * rp)
        assert K.packed_shape(c, o) == (o, 3 * rp)
        assert rp % 16 == 0 and 0 <= rp - 3 * c < 16
        assert torch.equal(K.unpack_weight(wp, c, o), wk)
        runs = wp.reshape(o, 3, rp)
        assert not runs[:, :, 3 * c:].any()          # zero past a run
        for dy, dx, ch in ((0, 0, 0), (1, 2, c - 1), (2, 1, c // 2)):
            assert torch.equal(runs[:, dy, dx * c + ch], wk[dy, dx, ch])

    @pytest.mark.parametrize("c", [16, 48, 96, 192])
    def test_whole_chunks_are_tap_major(self, c):
        """With C % 16 == 0 nothing is padded: K index = tap·C + channel,
        so every 16-byte chunk lies inside one tap."""
        wk = _inputs(c, 1, 1, 1, c, 8)[1]
        wp = K.pack_weight(wk)
        assert wp.shape[1] == 9 * c
        assert torch.equal(wp, wk.reshape(9 * c, 8).t())

    @pytest.mark.parametrize("d", [1, 2, 3, 7, 14, 49, 196, 3136, 12544,
                                   2 ** 20, 2 ** 31 - 1])
    def test_fast_division_is_exact(self, d):
        magic = fastdiv(d)
        assert magic[0] < 2 ** 32
        rng = np.random.default_rng(d % 1000)
        for v in [0, 1, d - 1, d, d + 1, 2 ** 31 - 1] + \
                rng.integers(0, 2 ** 31, 200).tolist():
            if 0 <= v < 2 ** 31:
                assert _div(int(v), magic) == int(v) // d


# RepVGG-A0 at 224 x 224: (name, input H = W, C, O, stride, mode), 22 layers
A0_LAYERS = (
    [("stage0", 224, 3, 48, 2, "codes"), ("stage1_0", 112, 48, 48, 2, "codes"),
     ("stage1_1", 56, 48, 48, 1, "codes"), ("stage2_0", 56, 48, 96, 2, "codes")]
    + [(f"stage2_{i}", 28, 96, 96, 1, "codes") for i in range(1, 4)]
    + [("stage3_0", 28, 96, 192, 2, "codes")]
    + [(f"stage3_{i}", 14, 192, 192, 1, "codes") for i in range(1, 14)]
    + [("stage4_0", 14, 192, 1280, 2, "f32")])


class TestTilePlan:
    @pytest.mark.parametrize("name,h,c,o,stride,mode", A0_LAYERS,
                             ids=[layer[0] for layer in A0_LAYERS])
    def test_plan_at_a0_layers(self, name, h, c, o, stride, mode):
        ho, wo = K.out_hw(h, h, stride)
        m = 256 * ho * wo
        plan = K.tile_plan(m, c, o, mode, stride=stride, width=h)
        assert plan.bn in K.WIDTHS
        if o in (48, 96, 192):                 # the tile is the layer's width
            assert plan.bn == o and plan.n_tiles == 1
        else:
            assert (plan.bn, plan.n_tiles) == (256, 5)     # 1280 = 5 x 256
        assert plan.m_tiles == -(-m // K.BM)
        assert plan.k_chunks == -(-3 * K.padded_run(c) // TILE_K)
        assert K.PRODUCER_WARPS <= plan.stages <= K.MAX_STAGES
        assert plan.smem <= K.MAX_SMEM == 232448
        halo = plan.halo_bufs * K.halo_bytes(h, c)
        assert plan.smem == K.plan_smem(plan.bn, mode == "codes", plan.stages,
                                        plan.resident, plan.k_chunks,
                                        plan.n_tiles, halo)
        # the weight is resident where C <= 96, streamed for C = 192
        assert plan.resident == (c <= 96 and o <= 96)
        # stride 1 builds its tiles from a halo, stride 2 gathers from x
        assert (plan.halo_bufs > 0) == (stride == 1)
        if plan.bn == 48:                      # two blocks share an SM
            assert 2 * (plan.smem + 1024) <= K.MAX_SMEM + 1024

    @pytest.mark.parametrize("model", ["resnet50", "resnet18", "config5"])
    def test_plan_at_resnet_layers(self, model):
        """ResNet-50's 16 and cifar_resnet18's 18 launches at batch 256
        (config #5's 16 at W4, batch 128): the tile as wide as the layer up
        to 256, two 256-wide tiles for 512 (a residual: 128-wide tiles that
        stage it; config #5's W4 may take 128 where that gives fewer waves;
        the stem's C = 3 keeps RepVGG-A0's rule, 96),
        the 64 and 128 widths in turns, the A tiles by TMA at stride 1 and
        C % 128 == 0, a halo at C = 64, and the plan fits."""
        import argparse
        from dlmc_quant_torch.tools import conv_launches as T
        opts = argparse.Namespace(models=model, batch=0, grouped_batch=0,
                                  resnet_batch=256, config5_batch=128)
        specs = T.launch_specs(opts)
        assert len(specs) == (18 if model == "resnet18" else 16)
        for s in specs:
            h, w, c, o = s["shape"]
            ho, wo = K.out_hw(h, w, s["stride"])
            r_bytes = {None: 0, "int8": 1}.get(s["r"], 4)
            plan = K.tile_plan(s["batch"] * ho * wo, c, o, s["mode"],
                               stride=s["stride"], width=w, r_bytes=r_bytes,
                               w4=s["w4"])
            want = min(o, 128 if r_bytes else 256)
            if c % 16:              # the stem's ragged C: A0's rule
                want = 96
            if s["w4"] and o >= 256:
                assert plan.bn in (128, 256)
            else:
                assert plan.bn == want, s
            assert plan.n_tiles == -(-o // plan.bn)
            if o == 512 and not r_bytes and not s["w4"]:
                assert plan.n_tiles == 2
            assert K.PRODUCER_WARPS <= plan.stages <= K.MAX_STAGES
            assert plan.smem <= K.MAX_SMEM
            assert plan.smem == K.plan_smem(
                plan.bn, s["mode"] == "codes", plan.stages, plan.resident,
                plan.k_chunks, plan.n_tiles,
                plan.halo_bufs * K.halo_bytes(
                    w, c, K.halo_gathered(plan.bn, c, plan.resident)),
                r_bytes)
            tma = K.tma_rows(c, s["stride"]) and plan.halo_bufs == 0
            assert tma == (s["stride"] == 1 and c % 128 == 0)
            if s["stride"] == 1 and c == 64:
                assert plan.halo_bufs > 0

    def test_ragged_channels_never_get_a_halo(self):
        assert K.tile_plan(500, 13, 8, stride=1, width=9).halo_bufs == 0
        with pytest.raises(ValueError, match="halo_bufs"):
            K.tile_plan(500, 13, 8, stride=1, width=9, halo_bufs=1)
        with pytest.raises(ValueError, match="halo_bufs"):
            K.tile_plan(500, 16, 8, stride=2, width=9, halo_bufs=2)

    def test_wide_codes_get_192_wide_tiles(self):
        """Codes 256 wide leave no room for staging beside 4 stages."""
        assert K.tile_plan(98, 192, 300, "f32").bn == 256
        plan = K.tile_plan(98, 192, 300, "codes")
        assert (plan.bn, plan.n_tiles) == (192, 2)
        assert K.tile_plan(98, 8, 70).bn == 96

    def test_resnet_rule_falls_back_where_nothing_fits(self):
        """RepVGG-B2g4's 640 -> 2560 in codes: 10 tiles of 256 leave no room
        beside the ring, so A0's rule (192-wide tiles) takes it; f32 (no
        staging tile) keeps 256."""
        m = 64 * 7 * 7
        assert K.tile_plan(m, 640, 2560, "codes", width=14).bn == 192
        assert K.tile_plan(m, 640, 2560, "f32", width=14).bn == 256
        with pytest.raises(ValueError, match="no plan fits"):
            K.tile_plan(m, 640, 2560, "codes", width=14, stages=4, bn=256)

    @pytest.mark.parametrize("override", [dict(stages=3), dict(stages=9),
                                          dict(stages=8, resident=False)])
    def test_plans_that_do_not_fit_raise(self, override):
        with pytest.raises(ValueError, match="no plan fits"):
            K.tile_plan(50176, 192, 192, stride=1, width=14, **override)

    def test_a_resident_weight_needs_one_tile(self):
        with pytest.raises(ValueError, match="resident"):
            K.tile_plan(98, 16, 300, resident=True)


def producers_run(stages, chunks, warps=K.PRODUCER_WARPS):
    """Step the conv's ring: producer warp p fills stages p, p + warps, ...
    of ``chunks`` stages, each once its slot's previous stage is released,
    and signals it at once; the consumers take stages in order and release
    stage s once they hold stage s + 1 (the last after their loop).  The
    consumers move only when no producer can, the laziest they may be.
    Returns (both reach their end, some producer waited at a parity that
    an mbarrier cannot tell from the one two phases back).
    """
    nxt = list(range(warps))        # each warp's next stage
    full, released = set(), [0] * stages     # released: phases done a slot
    taken, hazard = 0, False
    while taken < chunks or any(s < chunks for s in nxt):
        moved = False
        for p in range(warps):
            s = nxt[p]
            if s >= chunks:
                continue
            slot, use = s % stages, s // stages
            # waits for phase use - 1 of the slot's empty barrier; a parity
            # wait passes at released == use, and wrongly at use - 2
            if use >= 2 and released[slot] <= use - 2:
                hazard = True
            if released[slot] >= use:
                full.add(s)
                nxt[p] = s + warps
                moved = True
        if not moved and taken < chunks and taken in full:
            if taken > 0:
                released[(taken - 1) % stages] += 1
            taken += 1
            if taken == chunks:
                released[(taken - 1) % stages] += 1
            moved = True
        if not moved:
            return False, hazard
    return True, hazard


class TestProducerRing:
    @pytest.mark.parametrize("chunks", [1, 2, 3, 4, 5, 7, 14, 56, 190])
    @pytest.mark.parametrize("stages", [4, 5, 6, 8])
    def test_ring_runs_to_its_end(self, stages, chunks):
        assert producers_run(stages, chunks) == (True, False)

    @pytest.mark.parametrize("chunks", [7, 14, 56])
    def test_three_stages_would_confuse_a_barrier(self, chunks):
        """Why MIN_STAGES is the number of producer warps: with 3 stages the
        warp that owns stage 6 comes to wait for slot 0's second release
        while the first is still due, which a parity cannot tell apart."""
        assert K.MIN_STAGES == K.PRODUCER_WARPS == 4
        assert producers_run(3, chunks)[1]


def turns_run(stages, k_chunks, tiles=12, seed=0, warps=K.PRODUCER_WARPS):
    """Step the ring at random with the two consumer warpgroups in turns:
    warpgroup w takes tiles w, w + 2, ..., each of ``k_chunks`` stages in
    order, and releases a stage once it holds the next of its tile (the
    last at the tile's end); producer warp p fills stages p, p + warps, ...
    once the slot's previous use is released.  Returns whether some
    producer came to wait for a slot's release while the release before
    it was still due (a parity wait could not tell the two apart)."""
    rng = np.random.default_rng(seed)
    total = tiles * k_chunks
    nxt = list(range(warps))
    released = [0] * stages
    filled = set()
    mine = [[s for s in range(total) if s // k_chunks % 2 == w]
            for w in (0, 1)]
    at = [0, 0]

    def starts_waiting(s):
        use = s // stages
        return use >= 2 and released[s % stages] <= use - 2

    hazard = any(starts_waiting(s) for s in nxt if s < total)
    while at[0] < len(mine[0]) or at[1] < len(mine[1]):
        moves = [("p", p) for p in range(warps) if nxt[p] < total
                 and released[nxt[p] % stages] >= nxt[p] // stages]
        moves += [("c", w) for w in (0, 1) if at[w] < len(mine[w])
                  and mine[w][at[w]] in filled]
        assert moves, "the ring stalled"
        kind, i = moves[rng.integers(len(moves))]
        if kind == "p":
            filled.add(nxt[i])
            nxt[i] += warps
            if nxt[i] < total:
                hazard |= starts_waiting(nxt[i])
        else:
            s = mine[i][at[i]]
            at[i] += 1
            if s % k_chunks:                  # the stage before is released
                released[(s - 1) % stages] += 1
            if s % k_chunks == k_chunks - 1:  # the tile's last: at its end
                released[s % stages] += 1
    return hazard


class TestTurnsRing:
    @pytest.mark.parametrize("k_chunks", [1, 2, 5, 9, 18, 36])
    @pytest.mark.parametrize("stages", K.TURN_STAGES)
    def test_turns_stages_never_confuse_a_barrier(self, stages, k_chunks):
        assert not any(turns_run(stages, k_chunks, seed=seed)
                       for seed in range(40))

    @pytest.mark.parametrize("stages,k_chunks", [(6, 5), (5, 9), (6, 9)])
    def test_other_depths_would(self, stages, k_chunks):
        """Why the turns widths take 4 or 8 stages: at other depths a warp
        owns parts of several slots, and the other warpgroup's releases of
        one slot can lag the releases it saw of another."""
        assert any(turns_run(stages, k_chunks, seed=seed)
                   for seed in range(200))
        with pytest.raises(ValueError, match="no plan fits"):
            K.tile_plan(802816, 64, 64, stride=1, width=56, stages=stages)


EMULATED = [
    # n, h, w, c, o, stride, pad, lo, plan overrides
    (2, 7, 7, 3, 8, 2, -128, -128, {}),            # stem-like, odd size
    (3, 9, 7, 3, 48, 1, 5, -128, {}),              # ragged C at stride 1
    (2, 9, 6, 13, 70, 2, -3, -3, {}),              # C and O ragged
    (5, 7, 5, 13, 8, 1, 0, 0, {}),                 # tiles span images
    (2, 11, 9, 16, 48, 1, -3, -3, {}),             # halo, M % 64 != 0
    (2, 11, 9, 16, 48, 1, -3, -128, dict(halo_bufs=1, stages=6)),
    (2, 11, 9, 16, 48, 1, 7, -128, dict(halo_bufs=0)),
    (3, 8, 8, 16, 300, 2, 5, -128, {}),            # O over one tile
    (4, 7, 7, 48, 48, 1, -128, -128, {}),          # 196 pixels: 2 tiles
    (4, 7, 7, 48, 70, 2, 3, -128, dict(resident=False)),
    (1, 13, 5, 48, 8, 1, -3, -3, dict(halo_bufs=2, resident=False)),
]


class TestEmulatedKernel:
    @pytest.mark.parametrize("mode", ["codes", "f32"])
    @pytest.mark.parametrize(
        "case", EMULATED,
        ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{c[4]}-s{c[5]}"
             + "".join(f"-{k}{int(v)}" for k, v in c[8].items())
             for c in EMULATED])
    def test_equals_plain(self, case, mode):
        n, h, w, c, o, stride, pad, lo, overrides = case
        x, wk, a, b = _inputs(11, n, h, w, c, o)
        wp = K.pack_weight(wk)
        kw = dict(stride=stride, pad=pad, mode=mode)
        if mode == "codes":
            kw.update(lo=lo, hi=127)
        else:
            kw.update(relu=lo == pad)
        got, plan = emulate_conv(x, wp, a, b, **kw, **overrides)
        want = K.int8_conv3x3_plain(x, wp, a, b, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)
        for key, value in overrides.items():
            assert getattr(plan, key) == value

    def test_cases_cover_what_they_claim(self):
        """Two blocks' worth of tiles, a ring that wraps, both sources."""
        plans = [K.tile_plan(
            c[0] * np.prod(K.out_hw(c[1], c[2], c[5])), c[3], c[4],
            stride=c[5], width=c[2], **c[8]) for c in EMULATED]
        assert any(p.m_tiles >= 2 for p in plans)
        assert any(p.n_tiles >= 2 for p in plans)
        assert any(p.m_tiles * p.k_chunks > p.stages for p in plans)
        assert {p.halo_bufs for p in plans} == {0, 1, 2}
        assert {p.resident for p in plans} == {True, False}


# The ResNets' widths on small maps: (n, h, w, c, o, stride, overrides)
RESNET_EMULATED = [
    (2, 9, 9, 64, 64, 1, {}),              # 64 wide in turns, a halo
    (3, 7, 7, 128, 128, 1, {}),            # the A tiles by TMA, 128 wide
    (2, 5, 5, 256, 256, 1, {}),            # TMA rows at 256 channels
    (2, 6, 6, 128, 256, 2, {}),            # stride 2: the gather
    (1, 8, 8, 128, 256, 1, dict(bn=256)),  # codes 256 wide in two passes
    (3, 9, 7, 64, 320, 1, {}),             # O = 320: a ragged last tile
    (3, 9, 7, 64, 320, 1, dict(bn=128)),   # turns, the producers' halo
]
VARIANTS = ["codes", "f32_relu", "r_int8", "r_int32", "r_f32", "term", "w4"]


def _variant_kwargs(variant, n, ho, wo, o, seed):
    """The epilogue of a variant: mode, residual, row term (numpy-seeded)."""
    rng = np.random.default_rng(seed)
    kw = dict(mode="f32", relu=True) if variant == "f32_relu" else \
        dict(mode="codes", lo=-100, hi=110)
    if variant.startswith("r_"):
        shape = (n, ho, wo, o)
        r = (rng.standard_normal(shape).astype(np.float32) * 30
             if variant == "r_f32" else
             rng.integers(-128, 128, shape).astype(
                 np.int8 if variant == "r_int8" else np.int32))
        kw.update(residual=(torch.from_numpy(r),
                            torch.from_numpy((rng.random(o) * 0.05)
                                             .astype(np.float32)),
                            torch.from_numpy(rng.standard_normal(o)
                                             .astype(np.float32))),
                  qb=-3.5)
    if variant == "term":
        kw["row"] = (torch.from_numpy(rng.integers(
            -3000, 3000, (n, ho, wo)).astype(np.int32)),
            torch.from_numpy((rng.standard_normal(o) * 1e-3)
                             .astype(np.float32)))
    return kw


class TestEmulatedResNetTiles:
    @pytest.mark.parametrize("variant", VARIANTS)
    @pytest.mark.parametrize(
        "case", RESNET_EMULATED,
        ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{c[4]}-s{c[5]}"
             + "".join(f"-{k}{v}" for k, v in c[6].items())
             for c in RESNET_EMULATED])
    def test_equals_plain(self, case, variant):
        """The walk of the turns widths, the A tiles by TMA with their
        padded rows, the staged residual's boxes and swizzle, codes in
        passes: == int8_conv3x3_plain, tolerance 0."""
        n, h, w, c, o, stride, overrides = case
        x, wk, a, b = _inputs(13, n, h, w, c, o)
        wp = K.pack_weight_int4(wk // 16) if variant == "w4" else \
            K.pack_weight(wk)
        ho, wo = K.out_hw(h, w, stride)
        kw = dict(stride=stride, pad=-6,
                  **_variant_kwargs(variant, n, ho, wo, o, 14))
        if "residual" in kw and overrides.get("bn") == 256:
            with pytest.raises(ValueError, match="256-wide"):
                emulate_conv(x, wp, a, b, **kw, **overrides)
            return
        got, plan = emulate_conv(x, wp, a, b, **kw, **overrides)
        want = K.int8_conv3x3_plain(x, wp, a, b, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)
        if variant.startswith("r_"):       # the staged route's widths
            assert plan.bn in K.TURN_WIDTHS

    def test_cases_cover_what_they_claim(self):
        """Both turns widths, 256 in passes, TMA rows and a halo, a
        staged residual of several chunks and a ragged last tile."""
        plans = []
        for n, h, w, c, o, stride, over in RESNET_EMULATED:
            x = torch.zeros((n, h, w, c), dtype=torch.int8)
            plans.append((c, o, stride, K.launch_plan(x, o, "codes", stride,
                                                      1, None, over or None),
                          K.launch_plan(x, o, "codes", stride, 1, None, None)
                          if over else None))
        widths = {p.bn for _, _, _, p, _ in plans}
        assert {64, 128, 256} <= widths
        assert any(K.tma_rows(c, s) and p.halo_bufs == 0
                   for c, _, s, p, _ in plans)
        assert any(p.halo_bufs > 0 for *_, p, _ in plans)
        # the consumers' gather from the halo, and the producers' build
        assert any(K.halo_gathered(p.bn, c, p.resident) and p.halo_bufs
                   for c, _, _, p, _ in plans)
        assert any(p.bn in K.TURN_WIDTHS and not p.resident and p.halo_bufs
                   for *_, p, _ in plans)
        assert any(o % p.bn for _, o, _, p, _ in plans)
        assert any(p.m_tiles * p.k_chunks > p.stages for *_, p, _ in plans)
        # an int32 r at 64 and 128 columns: two and four 32-column chunks
        assert {p.bn for c, o, s, p, _ in plans if p.bn in K.TURN_WIDTHS} \
            == {64, 128}


@pytest.mark.parametrize("k_chunks,stages", [(5, 6), (9, 4), (18, 4),
                                             (36, 5)])
def test_turns_need_a_full_barrier_a_warpgroup(k_chunks, stages):
    """Why the warpgroups that take turns wait on full barriers of their
    own: on one barrier a slot, a warpgroup's first use of a slot after
    the other's (whose fill it never waited for) may meet that fill still
    due, a phase its parity cannot tell from the one it waits for."""
    seqs = range(8 * k_chunks)
    owner = [seq // k_chunks % 2 for seq in seqs]
    assert any(s >= stages and owner[s] != owner[s - stages] for s in seqs)
    turns_bookkeeping(range(8), k_chunks, stages, turns=True)
