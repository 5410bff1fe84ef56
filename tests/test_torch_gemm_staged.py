"""The int8 GEMM's staged epilogue route (``csrc/int8_gemm_staged.cu``):
the residual staged by TMA into shared memory, the output stored through
it.

* ``int8_gemm.staged_emulated`` walks the route's tiles, warpgroups,
  chunks, slots, swizzled boxes and lane map on the CPU as the kernel
  does; it equals the plain epilogue exactly at ragged M and N, at every
  staged tile, in every mode (int32, codes, f32 with and without the
  ReLU, codes with an int8, int32 or f32 residual), with the row term and
  at W4, and it equals JAX's ``fold_sum_quantize`` on the GEMM a residual
  block's close makes.
* ``int8_gemm.route`` takes the staged route exactly where TMA can
  describe the output's and r's rows; the register route keeps the rest
  (MobileNetV2's N = 24).
* The staged tiles, stage counts and shared memory are the source's.
* ``cuda``-marked tests hold the staged kernel against the plain version
  on the card (tolerance 0) at ResNet-50's residual and downsample shapes
  with M cut, at W4 and with the row term, at every staged tile, and the
  register route at N = 24; they skip here:
  ``python -m pytest --noconftest tests/test_torch_gemm_staged.py -m cuda``.
"""

import re

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_gemm as G

torch.set_num_threads(1)

STAGED = tuple(G.STAGED_TILE_STAGES)
# the modes of a launch: (mode, residual dtype or None, ReLU)
MODES = [("int32", None, False), ("codes", None, False),
         ("f32", None, False), ("f32", None, True),
         ("codes", torch.int8, False), ("codes", torch.int32, False),
         ("codes", torch.float32, False)]
MODE_IDS = ["int32", "codes", "f32", "f32_relu", "r_int8", "r_int32",
            "r_f32"]


def _launch(seed, m, k, n, mode, rdtype=None, relu=False, term=False,
            w4=False, device="cpu"):
    """Seeded operands and keywords of one launch (numpy's generator)."""
    rng = np.random.default_rng(seed)
    lim = 8 if w4 else 128
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-lim, lim, (k, n), dtype=np.int8))
    wp = G.pack_b_int4(w) if w4 else G.pack_b(w)
    if mode == "int32":
        return [t.to(device) for t in (x, wp)] + [None, None], dict(mode=mode)
    a = torch.from_numpy((np.abs(rng.standard_normal(n)) * 1e-3 + 1e-5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 4).astype(np.float32))
    kw = (dict(mode="codes", lo=-100, hi=120) if mode == "codes"
          else dict(mode="f32", relu=relu))
    if rdtype is not None:
        if rdtype == torch.float32:
            r = rng.random((m, n)).astype(np.float32) * 3
        elif rdtype == torch.int32:
            r = rng.integers(-40000, 40000, (m, n)).astype(np.int32)
        else:
            r = rng.integers(-128, 128, (m, n), dtype=np.int8)
        kw.update(residual=(torch.from_numpy(r).to(device),
                            torch.from_numpy(rng.random(n).astype(np.float32)
                                             * 0.05).to(device),
                            torch.from_numpy(rng.standard_normal(n).astype(
                                np.float32)).to(device)),
                  qb=-130.25)
    if term:
        kw["row"] = (torch.from_numpy(rng.integers(-3000, 3000, m)
                                      .astype(np.int32)).to(device),
                     torch.from_numpy((rng.standard_normal(n) * 1e-3)
                                      .astype(np.float32)).to(device))
    return [t.to(device) for t in (x, wp, a, b)], kw


# --- the emulated walk against the plain version ----------------------------

@pytest.mark.parametrize("mode,rdtype,relu", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("tile", STAGED, ids=lambda t: f"{t[0]}x{t[1]}")
def test_emulated_walk_equals_plain(tile, mode, rdtype, relu):
    """Ragged M (a last tile whose second warpgroup has no rows) and N (a
    last chunk partly past N), two tiles of columns."""
    n = 2 * tile[1] + 16 + (16 if mode in ("codes",) and rdtype is None
                            else 0)
    args, kw = _launch(tile[0] + tile[1], tile[0] + 2, 96, n, mode, rdtype,
                       relu)
    want = G.int8_gemm_plain(*args, **kw)
    got = G.staged_emulated(*args, tile=tile, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if mode == "codes":
        assert len(torch.unique(want)) > 50       # not all clamps


@pytest.mark.parametrize("mode,rdtype", [("codes", None), ("f32", None),
                                         ("codes", torch.int8),
                                         ("codes", torch.int32)],
                         ids=["codes", "f32", "r_int8", "r_int32"])
@pytest.mark.parametrize("w4", [False, True], ids=["w8", "w4"])
def test_emulated_walk_with_row_term(mode, rdtype, w4):
    """The row term (a weight offset's S and c) on the staged walk, W8 and
    W4 (the nibble-packed weight unpacked into the same accumulator)."""
    args, kw = _launch(11, 200, 64, 80, mode, rdtype, term=True, w4=w4)
    for tile in ((128, 256), (64, 64)):
        got = G.staged_emulated(*args, tile=tile, **kw)
        assert torch.equal(got, G.int8_gemm_plain(*args, **kw)), tile


def test_emulated_slots_start_as_noise():
    """Nothing the walk writes depends on what its slots held before."""
    args, kw = _launch(3, 300, 32, 256, "codes", torch.int32)
    first = G.staged_emulated(*args, tile=(128, 256), seed=1, **kw)
    assert torch.equal(first, G.staged_emulated(*args, tile=(128, 256),
                                                seed=2, sms=1, **kw))


def _jax():
    import jax.numpy as jnp
    from dlmc_quant_tpu.quant import chain as jchain
    return jnp, jchain


@pytest.mark.parametrize("kind", ["int8", "int32", "f32"])
def test_staged_walk_equals_jax_fold_sum_quantize(kind):
    """A Bottleneck's conv3 closing its block, the shortcut term of each
    kind: the GEMM that the port's fold_sum_quantize makes, walked as the
    staged kernel walks it, gives JAX's fold_sum_quantize."""
    from test_torch_gemm_epilogue import _acc, _operands, _shortcut, _t
    from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingGemm,
                                              fold_sum_quantize)
    from dlmc_quant_torch.utils.launches import LaunchRecorder
    jnp, jchain = _jax()
    n = 48                              # whole 16 bytes: the staged route
    x, w, a, b = _operands(13, 300, 96, n)
    rng = np.random.default_rng(14)
    term_j, term_p = _shortcut(kind, rng, (2, 10, 15, n))
    inv, qbias, lo = np.float32(1 / 3.71), np.float32(-13.37), -40
    y_j = jchain.DeferredEpilogue(
        jnp.asarray(_acc(x, w)).reshape(2, 10, 15, n), jnp.asarray(a),
        jnp.asarray(b))
    want = np.asarray(jchain.fold_sum_quantize([y_j, term_j], inv, qbias, lo,
                                               127))
    x_t, w_t, a_t, b_t = _t(x, w, a, b)
    y_p = DeferredEpilogue(PendingGemm(x_t, G.pack_b(w_t), (2, 10, 15)), a_t,
                           b_t)
    with LaunchRecorder() as rec:
        fold_sum_quantize([y_p, term_p], float(inv), float(qbias), lo, 127)
    (kind_, args, kw, out), = rec.calls
    assert kind_ == "gemm" and kw["residual"] is not None
    r = kw["residual"][0]
    assert G.route(n, "codes", (128, 256), r.reshape(-1, n)) == "staged"
    for tile in STAGED:
        got = G.staged_emulated(*args, tile=tile, **kw)
        assert np.array_equal(got.reshape(want.shape).numpy(), want), tile
    assert len(np.unique(want)) > 50


# --- the route ----------------------------------------------------------------

@pytest.mark.parametrize("n", [24, 48, 64, 256, 2048])
@pytest.mark.parametrize("mode,rdtype,relu", MODES, ids=MODE_IDS)
def test_route_by_shape_and_dtype(n, mode, rdtype, relu):
    """Staged exactly where the output's row (n × its bytes) and r's row
    are whole 16 bytes, at a staged tile; the register route elsewhere:
    N = 24 in codes (MobileNetV2's linear bottleneck) or with an int8 r,
    every tile that the staged build does not have."""
    r = torch.zeros((4, n), dtype=rdtype) if rdtype is not None else None
    rows = [n * G.OUT_BYTES[mode]] + ([n * r.element_size()] if r is not None
                                      else [])
    aligned = all(b % 16 == 0 for b in rows)
    staged = G.STAGED_INT32_TILES if mode == "int32" else G.STAGED_TILE_STAGES
    for tile in G.TILES:
        want = "staged" if aligned and tile in staged else "register"
        assert G.route(n, mode, tile, r) == want
    assert G.route(24, "codes", (128, 256)) == "register"
    assert G.route(24, "f32", (128, 256)) == "staged"     # 96-byte rows


def test_an_unaligned_residual_takes_the_register_route():
    """r one byte into its buffer: TMA needs a 16-byte aligned base, so the
    host routes the launch to the register epilogue before it starts."""
    buf = torch.zeros(4 * 64 + 1, dtype=torch.int8)
    r = buf[1:].view(4, 64)
    assert r.data_ptr() % 16 != 0
    assert G.route(64, "codes", (64, 64), r) == "register"
    assert G.route(64, "codes", (64, 64), buf[:-1].view(4, 64)) == "staged"


# --- the source ---------------------------------------------------------------

def test_staged_tiles_are_the_sources():
    text = (build.CSRC / "int8_gemm.cu").read_text()
    compiled = {(int(a), int(b)): int(c) for a, b, c in re.findall(
        r"DLMCQ_STAGED_TILE\((\d+), (\d+), (\d+)\)", text)}
    assert compiled == G.STAGED_TILE_STAGES
    assert set(compiled) == set(G.EPILOGUE_TILES)
    staged = (build.CSRC / "int8_gemm_staged.cu").read_text()
    assert "#define DLMCQ_GEMM_STAGED 1" in staged
    assert '#include "int8_gemm.cu"' in staged
    assert "int8_gemm_staged" in build.SOURCES


@pytest.mark.parametrize("tile", STAGED, ids=lambda t: f"{t[0]}x{t[1]}")
def test_every_staged_instantiation_fits_a_block(tile):
    """Each mode (by r's width) at W8 and W4: the ring, W4's staging, each
    warpgroup's two slots and parameters and the barriers within a block's
    shared memory, three stages at least at W4, and 128 x 128 at W8 two
    blocks an SM."""
    for mode, rb in (("int32", 0), ("codes", 0), ("f32", 0), ("codes", 1),
                     ("codes", 4)):
        if mode == "int32" and tile not in G.STAGED_INT32_TILES:
            continue
        for int4 in (False, True):
            smem = G.staged_smem_bytes(tile, mode, rb, int4)
            stages = G.staged_stages(tile, mode, rb, int4)
            assert smem <= G.MAX_SMEM and stages >= (3 if int4 else 2)
            assert stages <= max(G.STAGED_TILE_STAGES[tile], 3)
    two = G.staged_smem_bytes((128, 128), "codes", 1)
    assert 2 * (two + 1024) <= G.MAX_SMEM + 1024
    # at 128 x 256 two slots and 5 KB of parameters a warpgroup leave room
    # for 3 stages in an epilogue mode, int32's three slots too
    assert G.staged_stages((128, 256), "codes", 4) == 3
    assert G.staged_stages((128, 256), "codes", 1) == 3
    assert G.staged_stages((128, 256), "int32", 0) == 3
    assert G.staged_slots("int32") == 3 and G.staged_slots("codes") == 2
    # 128 x 128: two blocks an SM in every mode, an int32 r's too
    for mode, rb in (("codes", 0), ("codes", 1), ("codes", 4), ("f32", 0)):
        assert 2 * (G.staged_smem_bytes((128, 128), mode, rb) + 1024) \
            <= G.MAX_SMEM + 1024


@pytest.mark.parametrize("mode,rb", [("codes", 0), ("codes", 1),
                                     ("codes", 4), ("f32", 0),
                                     ("int32", 0)])
@pytest.mark.parametrize("bn", [64, 128, 256])
def test_chunk_geometry(bn, mode, rb):
    """A chunk is 128 bytes of the widest row (or BN columns), its boxes
    1024-byte multiples, an int8 r overwritten in place by its codes."""
    cw, chunks, r_row, o_row, in_place, slot = G.staged_geometry(bn, mode, rb)
    assert cw * chunks == bn and max(r_row, o_row) == min(128, bn * max(
        rb, G.OUT_BYTES[mode]))
    assert o_row in (32, 64, 128) and r_row in (0, 32, 64, 128)
    assert slot % 1024 == 0 and in_place == (rb == G.OUT_BYTES[mode])
    assert slot == 64 * (r_row + (0 if in_place else o_row))


@pytest.mark.parametrize("row_bytes", [32, 64, 128])
def test_swizzled_box_is_a_bijection_without_bank_conflicts(row_bytes):
    """swizzle_box permutes the 16-byte chunks within each 1024 bytes, and
    a warp's column pairs (8 rows, lane / 4, of 4 pairs, lane % 4) fall in
    distinct banks where they are 2 bytes (codes, an int8 r) at every row
    width; 8-byte pairs (int32, f32: 128-byte rows) meet at most two to a
    bank in each half-warp (rows r and r ^ 1 share a 32-byte group: the
    XOR's low bit only swaps a pair's two chunks)."""
    off = np.arange(64 * row_bytes)
    sw = G.swizzle_box(off, row_bytes)
    assert np.array_equal(np.sort(sw), off)
    assert np.array_equal(sw // 1024, off // 1024)
    lane = np.arange(32)
    for width in (2, 8) if row_bytes == 128 else (2,):
        for j in range(row_bytes // (4 * width)):
            addr = G.swizzle_box((lane // 4) * row_bytes
                                 + width * (4 * j + lane % 4), row_bytes)
            for half in ((lane,) if width == 2 else (lane[:16], lane[16:])):
                words = np.unique(np.concatenate(
                    [addr[half] // 4 + k for k in range(max(width // 4, 1))]))
                ways = np.bincount(words % 32).max()
                assert ways == (1 if width == 2 else 2)


# --- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# ResNet-50's residual (and downsample) GEMMs, M cut to a few tiles with a
# ragged end: (M, K, N)
R50_RESIDUAL = [(4096 + 37, 64, 256), (2048 + 99, 128, 512),
                (1024 + 3, 256, 1024), (512 + 65, 512, 2048)]
R50_DOWNSAMPLE = [(4096 + 37, 64, 256), (2048 + 99, 256, 512),
                  (1024 + 3, 512, 1024), (512 + 65, 1024, 2048)]


def _on_card(args, kw, dev):
    x, wp, a, b = args
    kw = {k: (tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
                    for t in v) if isinstance(v, tuple) else v)
          for k, v in kw.items()}
    return [t.to(dev) if t is not None else None for t in args], kw


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rdtype,relu", MODES[1:], ids=MODE_IDS[1:])
@pytest.mark.parametrize("case", R50_RESIDUAL,
                         ids=["x".join(map(str, c)) for c in R50_RESIDUAL])
def test_staged_kernel_at_resnet50_shapes(case, mode, rdtype, relu):
    dev = _card()
    args, kw = _on_card(*_launch(sum(case), *case, mode, rdtype, relu), dev)
    want = G.int8_gemm_plain(*args, **kw)
    before = G.int8_gemm.launches_staged
    got = G.int8_gemm(*args, **kw)
    torch.cuda.synchronize()
    assert G.int8_gemm.launches_staged == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", R50_DOWNSAMPLE,
                         ids=["x".join(map(str, c)) for c in R50_DOWNSAMPLE])
def test_staged_int32_at_downsample_shapes(case):
    dev = _card()
    args, kw = _on_card(*_launch(sum(case), *case, "int32"), dev)
    want = G.int8_gemm_plain(*args)
    before = G.int8_gemm.launches_staged
    for tile in G.STAGED_INT32_TILES:
        got = G.int8_gemm(*args, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile
    assert G.int8_gemm.launches_staged == before + len(G.STAGED_INT32_TILES)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rdtype,relu", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("tile", STAGED, ids=lambda t: f"{t[0]}x{t[1]}")
def test_staged_kernel_every_tile(tile, mode, rdtype, relu):
    """Ragged M and N at every staged tile: a last chunk partly past N,
    a warpgroup with no rows, tiles walked by a persistent grid."""
    dev = _card()
    if mode == "int32" and tile not in G.STAGED_INT32_TILES:
        tile = G.STAGED_INT32_TILES[0]
    n = 2 * tile[1] + 16
    args, kw = _on_card(*_launch(7 * tile[1], 3 * tile[0] + 2, 96, n, mode,
                                 rdtype, relu), dev)
    want = G.int8_gemm_plain(*args, **kw)
    before = G.int8_gemm.launches_staged
    got = G.int8_gemm(*args, tile=tile, **kw)
    torch.cuda.synchronize()
    assert G.int8_gemm.launches_staged == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rdtype", [("codes", None), ("f32", None),
                                         ("codes", torch.int8),
                                         ("codes", torch.int32),
                                         ("int32", None)],
                         ids=["codes", "f32", "r_int8", "r_int32", "int32"])
@pytest.mark.parametrize("term", [False, True], ids=["", "term"])
@pytest.mark.parametrize("w4", [False, True], ids=["w8", "w4"])
def test_staged_kernel_w4_and_row_term(w4, term, mode, rdtype):
    dev = _card()
    if term and mode == "int32":
        pytest.skip("int32 mode has no epilogue")
    args, kw = _on_card(*_launch(21, 1000, 256, 512, mode, rdtype,
                                 term=term, w4=w4), dev)
    want = G.int8_gemm_plain(*args, **kw)
    tiles = G.STAGED_INT32_TILES if mode == "int32" else STAGED
    before = G.int8_gemm.launches_staged
    for tile in tiles:
        got = G.int8_gemm(*args, tile=tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile
    assert G.int8_gemm.launches_staged == before + len(tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rdtype", [("codes", None),
                                         ("codes", torch.int8)],
                         ids=["codes", "r_int8"])
def test_n24_takes_the_register_route(mode, rdtype):
    """MobileNetV2's 24-channel blocks: rows TMA cannot describe."""
    dev = _card()
    args, kw = _on_card(*_launch(24, 6272, 144, 24, mode, rdtype), dev)
    want = G.int8_gemm_plain(*args, **kw)
    before = G.int8_gemm.launches_staged
    for tile in G.EPILOGUE_TILES:
        assert G.route(24, mode, tile, kw.get("residual", (None,))[0]) == \
            "register"
        got = G.int8_gemm(*args, tile=tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile
    assert G.int8_gemm.launches_staged == before
