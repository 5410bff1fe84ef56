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
  (both sides hold an exact integer accumulator and do the same two
  float32 operations).
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


def tile_table(m0, m, h, w, ho, wo, stride):
    """(pixel index of tap (0, 0), flags) of the tile's rows, as the
    producer writes them: bit dy / 3 + dx for a window row / column inside
    the image, bit 6 for a row before M."""
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
        ih0, iw0 = oh * stride - 1, ow * stride - 1
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


def emulate_conv(x, wp, a, b, *, stride, pad, lo=-128, hi=127, mode="codes",
                 relu=False, blocks=3, **overrides):
    """int8_conv3x3.cu's plan on the CPU (see the module docstring)."""
    n, h, w, c = x.shape
    o = a.shape[0]
    ho, wo = K.out_hw(h, w, stride)
    m, kp = n * ho * wo, wp.shape[1]
    plan = K.tile_plan(m, c, o, mode, stride=stride, width=w, **overrides)
    xf = x.reshape(-1).numpy()
    wnp = wp.numpy()
    grid = min(blocks, plan.m_tiles * plan.n_tiles)
    out = np.full((m, o), 99, dtype=np.float64)
    written = np.zeros((m, o), dtype=np.int64)
    rows_cols = swizzle128(np.arange(K.BM)[:, None], np.arange(TILE_K)[None])
    for block in range(grid):
        ring = [np.full(K.BM * TILE_K, GARBAGE, dtype=np.int8)
                for _ in range(plan.stages)]
        halos = [np.full(K.halo_bytes(w, c), GARBAGE, dtype=np.int8)
                 for _ in range(plan.halo_bufs)]
        stage = 0
        tiles = range(block, plan.m_tiles * plan.n_tiles, grid)
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
            table = tile_table(m0, m, h, w, ho, wo, stride)
            acc = np.zeros((K.BM, plan.bn), dtype=np.int64)
            for kc in range(plan.k_chunks):
                buf = ring[stage]
                stage = (stage + 1) % plan.stages
                fill_stage(buf, table, xf, halo, kc, c, w, pad, kp)
                # the weight tile: zero past O and past Kp, as TMA fills it
                bt = np.zeros((plan.bn, TILE_K), dtype=np.int64)
                cols = min(plan.bn, o - n0)
                take = min(TILE_K, kp - kc * TILE_K)
                bt[:cols, :take] = wnp[n0:n0 + cols,
                                       kc * TILE_K:kc * TILE_K + take]
                acc += buf[rows_cols].astype(np.int64) @ bt.T
            rows = min(K.BM, m - m0)
            cols = min(plan.bn, o - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
            written[m0:m0 + rows, n0:n0 + cols] += 1
    assert (written == 1).all()
    y = torch.from_numpy(out).to(torch.float32) * a
    y = y + b
    if mode == "codes":
        y = torch.round(y).clamp_(lo, hi).to(torch.int8)
    elif relu:
        y = torch.clamp_min(y, 0.0)
    return y.reshape(n, ho, wo, o), plan


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
