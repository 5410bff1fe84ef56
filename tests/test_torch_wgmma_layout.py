"""The layout and block plans of the port's wgmma kernels, on the CPU.

The kernels (dlmc_quant_torch/ops/cuda/csrc/int8_gemm.cu and
int8_mma_probe.cu, on the header wgmma_s8.cuh; the conv on the same header
has tests/test_torch_conv_plan.py) run only on the card; what
surrounds their arithmetic is checked here with pure-torch copies:

- the header's 128-byte swizzle address function: a bijection on a tile,
  conflict-free over the 8 rows of a 16-byte column, and equal to XORing
  address bits [4:6] with bits [7:9], which is what TMA and wgmma do;
- ``default_tile`` at every shape of the GEMM sweep and ``block_plan`` at
  every shape of the probe: the tiles cover the output, the shared memory
  fits a block, the blocks are counted;
- the hand-over of ring stages between producer and consumer, stepped as
  two waiting parties: it runs to its end at every stage count the kernels
  use and stalls with fewer;
- tile-faithful emulations of both kernels' block plans (persistent tile
  walk with zero-filled edges; 64 x 64 tiles with K split over blocks and
  partial sums added, operand tiles written to and read from a swizzled
  byte buffer), equal to the plain versions.  Tolerance: exact, integers.
"""

import re

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.ops.cuda import int8_mma_probe as P
from dlmc_quant_torch.tools import gemm_sweep, mma_probe

torch.set_num_threads(1)
TILE_K = G.TILE_K


def swizzle128(row, byte):
    """Pure-torch copy of ``swizzle128`` in csrc/wgmma_s8.cuh."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


def _grid(rows):
    row = torch.arange(rows)[:, None].expand(rows, 128)
    byte = torch.arange(128)[None, :].expand(rows, 128)
    return row, byte


class TestSwizzle:
    def test_a_producer_thread_writes_whole_16_byte_chunks(self):
        """A cp.async of 16 bytes to swizzle128(row, 16·c) fills exactly the
        bytes that bytes 16·c .. 16·c + 15 of the row map to."""
        row, byte = _grid(64)
        off = swizzle128(row, byte)
        start = swizzle128(row, byte & ~15)
        assert torch.equal(off, start + (byte & 15))
        assert (start % 16 == 0).all()

    @pytest.mark.parametrize("rows", [8, 48, 64, 96, 128, 192, 256])
    def test_bijection_on_a_tile(self, rows):
        off = swizzle128(*_grid(rows))
        assert off.min() == 0 and off.max() == rows * 128 - 1
        assert off.flatten().unique().numel() == rows * 128
        # a row stays within its own 128 bytes, a 16-byte chunk stays whole
        assert torch.equal(off // 128, _grid(rows)[0])
        assert torch.equal(off % 16, _grid(rows)[1] % 16)

    @pytest.mark.parametrize("rows", [8, 64, 256])
    def test_column_of_8_rows_hits_8_bank_groups(self, rows):
        """The 8 rows of an atom at one 16-byte column (what a k32 slice of
        wgmma reads together) lie on 8 distinct 16-byte bank groups."""
        row, byte = _grid(rows)
        group = (swizzle128(row, byte) // 16) % 8
        for chunk in range(8):
            col = group[:, 16 * chunk].reshape(rows // 8, 8)
            assert (col.sort(dim=1).values == torch.arange(8)).all()

    def test_is_the_hardware_xor_of_address_bits(self):
        """TMA and wgmma XOR address bits [4:6] with bits [7:9] of the
        unswizzled address; with a 1024-byte aligned base that is this."""
        row, byte = _grid(64)
        linear = row * 128 + byte
        assert torch.equal(swizzle128(row, byte),
                           linear ^ (((linear >> 7) & 7) << 4))

    def test_k_slice_is_a_plain_offset_before_the_xor(self):
        """The descriptor of the k-th 32-byte slice adds 32·k to the start
        address and the hardware swizzles after: slice k of row r holds
        bytes 32·k .. 32·k + 31."""
        row = torch.arange(64)[:, None]
        for k in range(4):
            inner = torch.arange(32)[None, :]
            linear = row * 128 + 32 * k + inner
            hw = linear ^ (((linear >> 7) & 7) << 4)
            assert torch.equal(hw, swizzle128(row, 32 * k + inner))


def _stage_tile(src_rows, k0, k_valid):
    """A (rows, 128) tile as shared memory holds it: byte k0 + b of source
    row r at swizzle128(r, b), zero past ``k_valid`` bytes and for rows
    given as None; returned as the flat byte buffer."""
    rows = len(src_rows)
    buf = torch.zeros(rows * 128, dtype=torch.int8)
    for r, src in enumerate(src_rows):
        if src is None:
            continue
        take = max(0, min(128, k_valid - k0))
        b = torch.arange(take)
        buf[swizzle128(torch.tensor(r), b)] = src[k0:k0 + take]
    return buf


def _read_tile(buf, rows):
    """What wgmma reads through the descriptor: the tile unswizzled."""
    return buf[swizzle128(*_grid(rows))]


def _rows(mat, r0, count):
    return [mat[r] if r < mat.shape[0] else None
            for r in range(r0, r0 + count)]


def emulate_gemm(x, wp, tile, sms=3):
    """int8_gemm.cu's plan: ``sms`` persistent blocks walk the tiles, M
    fastest; per 128-byte K chunk a BM and a BN row tile, zero past the
    edges; the accumulator stored where row < M and column < N."""
    (m, k), n = x.shape, wp.shape[0]
    bm, bn = tile
    m_tiles = G._cdiv(m, bm)
    tiles = G.tile_count(tile, m, n)
    out = torch.full((m, n), -7, dtype=torch.int64)
    written = torch.zeros((m, n), dtype=torch.int64)
    for block in range(min(sms, tiles)):
        for t in range(block, tiles, min(sms, tiles)):
            m0, n0 = (t % m_tiles) * bm, (t // m_tiles) * bn
            acc = torch.zeros((bm, bn), dtype=torch.int64)
            for kc in range(G._cdiv(k, TILE_K)):
                a = _read_tile(_stage_tile(_rows(x, m0, bm), kc * TILE_K, k),
                               bm)
                b = _read_tile(_stage_tile(_rows(wp, n0, bn), kc * TILE_K,
                                           wp.shape[1]), bn)
                acc += a.long() @ b.long().t()
            mm, nn = min(bm, m - m0), min(bn, n - n0)
            out[m0:m0 + mm, n0:n0 + nn] = acc[:mm, :nn]
            written[m0:m0 + mm, n0:n0 + nn] += 1
    assert (written == 1).all()
    return out.to(torch.int32)


def emulate_probe(x, wp, rolls, split):
    """int8_mma_probe.cu's plan: a block per 64 x 64 tile and share of the K
    chunks; the rolled x rows gathered row by row, the weight tiles cut
    from w seen as (nbufs·N, Kp); partial sums added into zeros."""
    (m, k), (nbufs, n, kp) = x.shape, wp.shape
    flat = wp.reshape(nbufs * n, kp)
    m_tiles, n_tiles = G._cdiv(m, P.BM), G._cdiv(n, P.BN)
    out = torch.zeros((m, n), dtype=torch.int64)
    for mt in range(m_tiles):
        for nt in range(n_tiles):
            for z in range(split):
                m0, n0 = mt * P.BM, nt * P.BN
                acc = torch.zeros((P.BM, P.BN), dtype=torch.int64)
                for kc in range(*P.chunk_range(z, split, k)):
                    for r in range(rolls):
                        shift = P.roll_shift(r, m)
                        src = [x[(m0 + i - shift) % m] if m0 + i < m else None
                               for i in range(P.BM)]
                        a = _read_tile(_stage_tile(src, kc * TILE_K, k), P.BM)
                        for j in range(nbufs):
                            b = _read_tile(_stage_tile(
                                _rows(flat, j * n + n0, P.BN), kc * TILE_K,
                                kp), P.BN)
                            acc += a.long() @ b.long().t()
                mm, nn = min(P.BM, m - m0), min(P.BN, n - n0)
                out[m0:m0 + mm, n0:n0 + nn] += acc[:mm, :nn]
    return out.to(torch.int32)


class TestGemmPlan:
    @pytest.mark.parametrize("name,m,k,n", gemm_sweep.SHAPES,
                             ids=[s[0] for s in gemm_sweep.SHAPES])
    def test_default_tile_at_sweep_shapes(self, name, m, k, n):
        tile = G.default_tile(m, n)
        assert tile in G.TILES
        bm, bn = tile
        # covers the output with less than one tile of overhang each way
        assert 0 <= G._cdiv(m, bm) * bm - m < bm
        assert 0 <= G._cdiv(n, bn) * bn - n < bn
        assert G.tile_count(tile, m, n) == G._cdiv(m, bm) * G._cdiv(n, bn)
        if n in (48, 96, 192):        # RepVGG-A0's widths: a tile exactly N
            assert bn == n
        if m < 64:
            assert bm == 64
        for t in G.TILES:
            assert G.tile_smem_bytes(t) <= G.MAX_SMEM
            assert G.tile_cost(t, m, n) >= G.tile_cost(tile, m, n)

    def test_tiles_are_the_sources(self):
        text = (build.CSRC / "int8_gemm.cu").read_text()
        compiled = {(int(a), int(b)): int(c) for a, b, c in re.findall(
            r"DLMCQ_TILE\((\d+), (\d+), (\d+)\)", text)}
        assert compiled == G.TILE_STAGES
        for (bm, bn), stages in G.TILE_STAGES.items():
            assert bm in (64, 128) and bn % 8 == 0 and bn <= 256
            assert stages >= 3 and G.tile_smem_bytes((bm, bn)) <= G.MAX_SMEM

    def test_default_tile_follows_the_sm_count(self):
        for m, n in ((3, 1), (1, 16384), (63, 8), (200, 200)):
            assert G.default_tile(m, n) in G.TILES
        assert G.sm_count("cpu") == G.SMS
        # 4096 x 4096: 512 tiles of 128 x 256 are 3.9 waves on 132 SMs; a
        # card with 4 SMs runs either tile in full waves and takes the
        # larger, a card with 1024 takes the tile that fills it
        assert G.default_tile(4096, 4096, 4) == (128, 256)
        assert G.default_tile(4096, 4096, 1024) == (128, 128)

    @pytest.mark.parametrize("tile", G.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
    def test_emulated_plan_equals_plain(self, tile):
        rng = np.random.default_rng(tile[0] + tile[1])
        m, k, n = 150, 432, 2 * tile[1] + 8     # ragged M, N and last K chunk
        x, wp = _codes(rng, (m, k)), G.pack_b(_codes(rng, (k, n)))
        assert torch.equal(emulate_gemm(x, wp, tile), G.int8_gemm_plain(x, wp))


class TestProbePlan:
    @pytest.mark.parametrize("m,k,n", mma_probe.SHAPES)
    def test_block_plan_at_probe_shapes(self, m, k, n):
        nbufs, rolls = mma_probe.plan(m, k, n)
        m_tiles, n_tiles, split = P.block_plan(m, n, k)
        assert m_tiles * P.BM >= m > (m_tiles - 1) * P.BM
        assert n_tiles * P.BN >= n > (n_tiles - 1) * P.BN
        chunks = G._cdiv(k, TILE_K)
        assert 1 <= split <= chunks
        blocks = m_tiles * n_tiles * split
        assert blocks <= G.SMS or split == 1      # one wave unless unsplit
        if split > 1:      # over half the card, and worth its zeroing
            assert blocks > G.SMS // 2
            assert chunks - G._cdiv(chunks, split) >= P.SPLIT_SAVES
        else:              # no split would have saved enough chunks
            best = max(1, min(chunks, G.SMS // (m_tiles * n_tiles)))
            assert chunks - G._cdiv(chunks, best) < P.SPLIT_SAVES
        # every block has K chunks, and together they have each chunk once
        ranges = [P.chunk_range(z, split, k) for z in range(split)]
        assert all(b < e for b, e in ranges)
        assert [c for b, e in ranges for c in range(b, e)] == list(
            range(chunks))
        assert rolls + nbufs <= P.MAX_TILES

    def test_block_plan_follows_the_sm_count(self):
        # 32 tiles, 7 chunks: 4 blocks a tile on 132 SMs, none to spare on 32
        assert P.block_plan(1024, 128, 864, 132) == (16, 2, 4)
        assert P.block_plan(1024, 128, 864, 32) == (16, 2, 1)
        # 64 tiles, 4 chunks: halving them saves 2 chunks, not enough
        assert P.block_plan(512, 512, 512, 132) == (8, 8, 1)

    @pytest.mark.parametrize("tiles", range(2, P.MAX_TILES + 1))
    def test_ring_fits_a_block_at_every_tile_count(self, tiles):
        """MAX_TILES is what the source's least stage count leaves room for,
        and every allowed rolls + nbufs gets 3 or 4 stages."""
        text = (build.CSRC / "int8_mma_probe.cu").read_text()
        min_stages = int(re.search(r"MIN_STAGES = (\d+);", text).group(1))
        room = (G.MAX_SMEM - 2 * 4 * 8) // (P.BM * TILE_K)
        assert P.MAX_TILES == room // min_stages
        stages = min(4, room // tiles)
        assert stages >= min_stages >= PROBE_MIN_STAGES
        assert stages * tiles * P.BM * TILE_K + 64 <= G.MAX_SMEM

    @pytest.mark.parametrize("m,k,n,nbufs,rolls,split", [
        (64, 160, 48, 2, 2, 1),      # the roll is the identity
        (192, 432, 72, 2, 3, 2),     # shift 128: a partial wrap; K split
        (256, 272, 64, 1, 3, 3),     # full wrap; one chunk a block
        (100, 48, 72, 2, 4, 1),      # wraps inside a swizzle atom
    ])
    def test_emulated_plan_equals_plain(self, m, k, n, nbufs, rolls, split):
        rng = np.random.default_rng(m + k)
        x = _codes(rng, (m, k))
        wp = torch.stack([G.pack_b(_codes(rng, (k, n))) for _ in range(nbufs)])
        want = P.int8_mma_probe_plain(x, wp, rolls)
        assert torch.equal(emulate_probe(x, wp, rolls, split), want)
        assert torch.equal(P.int8_mma_probe(x, wp, rolls, _split=split), want)

    @pytest.mark.parametrize("split", [0, 3, 1.0])
    def test_split_out_of_range_raises(self, split):
        x = torch.zeros((64, 256), dtype=torch.int8)
        w = torch.zeros((1, 8, 256), dtype=torch.int8)
        with pytest.raises(ValueError, match="split"):
            P.int8_mma_probe(x, w, 1, _split=split)


def ring_runs_to_its_end(stages, chunks, producer_late):
    """Step the two parties of a ring of ``stages`` over ``chunks`` K chunks.

    The producer fills chunk c once the consumer has released chunk
    c - stages, and signals it as full at once (``producer_late`` 0: TMA
    completes the barrier itself) or while at chunk c + 1 (1: a cp.async
    producer waits for its copies one chunk behind), and after its loop.
    The consumer takes chunk c once it is full, and releases chunk c - 1
    then (its wgmma group is done once the next is queued), and the last
    after its loop.  Returns whether both reach their end.
    """
    full, released = set(), set()
    p = c = 0                     # the chunk each party is at
    while p < chunks or c < chunks:
        moved = False
        if p < chunks and (p < stages or p - stages in released):
            full.add(p - producer_late)
            p += 1
            if p == chunks:
                full.add(chunks - 1)
            moved = True
        if c < chunks and c in full:
            released.add(c - 1)
            c += 1
            if c == chunks:
                released.add(chunks - 1)
            moved = True
        if not moved:
            return False
    return True


PROBE_MIN_STAGES = 3


class TestRingHandOver:
    @pytest.mark.parametrize("chunks", [1, 2, 3, 4, 5, 14])
    @pytest.mark.parametrize("stages", [3, 4])
    def test_probe_ring_runs_to_its_end(self, stages, chunks):
        assert ring_runs_to_its_end(stages, chunks, producer_late=1)

    @pytest.mark.parametrize("chunks", [3, 4, 14])
    def test_probe_ring_of_two_stages_would_stall(self, chunks):
        """Why the probe never runs 2 stages: both parties signal one chunk
        late, so from 3 chunks on each waits for the other."""
        assert ring_runs_to_its_end(2, 2, producer_late=1)
        assert not ring_runs_to_its_end(2, chunks, producer_late=1)

    @pytest.mark.parametrize("tile", G.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
    def test_gemm_ring_runs_to_its_end(self, tile):
        """The GEMM's TMA producer signals by itself; its ring walks many
        tiles' chunks in one sequence."""
        for chunks in (1, 2, 3, 4, 14, 64):
            assert ring_runs_to_its_end(G.TILE_STAGES[tile], chunks,
                                        producer_late=0)


class TestSources:
    def test_no_source_keeps_the_old_header(self):
        assert not (build.CSRC / "mma_s8.cuh").exists()
        for src in build.CSRC.glob("*.cu*"):
            text = src.read_text()
            assert "mma_s8.cuh" not in text.replace("wgmma_s8.cuh", "")
            assert "mma.sync" not in text

    def test_conv_is_a_wgmma_kernel_on_the_shared_header(self):
        """Every MAC of the conv goes through the header's wgmma; the
        CUDA-core body (__dp4a) is gone, not kept beside it."""
        text = (build.CSRC / "int8_conv3x3.cu").read_text()
        assert '#include "wgmma_s8.cuh"' in text
        assert "Wgmma<BN>::mma(" in text
        assert "__dp4a" not in text and "dp4a" not in text
        assert "cudnn" not in text.lower()

    @pytest.mark.parametrize("name", ["int8_gemm", "int8_mma_probe",
                                      "int8_conv3x3"])
    def test_kernels_call_no_library(self, name):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert "cublas" not in text.lower() and "cutlass" not in text.lower()
        assert build.library_path(name).name.startswith(f"lib{name}_")
