"""The port's int8 GEMM and MMA-rate probe (dlmc_quant_torch/ops/cuda/
int8_gemm.py and int8_mma_probe.py), their tools and the timing helpers.

On the CPU each wrapper runs its plain version; it must give exactly the
int32 results of the JAX tools' own Pallas kernels (``make_pallas_gemm`` of
``tools/pallas_gemm_sweep.py`` and ``make_probe`` of
``tools/vmem_gemm_probe.py``, in interpret mode) on numpy-seeded inputs,
and of ``torch._int_mm``.  Tolerance: exact equality, since every side
computes an exact integer sum.  The GEMM cases use tiles that divide the
shape, because the TPU kernel writes nothing past ``(m // bm)·bm`` rows or
``(n // bn)·bn`` columns; the probe cases have m = 64, 192 and 256, where
the 128-row roll is the identity, wraps partly and wraps fully.  The
kernels themselves run only on the card: the tests marked ``cuda`` hold
them against the plain versions there and skip here
(``python -m pytest --noconftest tests/test_torch_gemm_tools.py -m cuda``).
"""

import contextlib
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda.int8_gemm import (TILES, int8_gemm,
                                                 int8_gemm_plain, pack_b,
                                                 packed_k, unpack_b)
from dlmc_quant_torch.ops.cuda.int8_mma_probe import (int8_mma_probe,
                                                      int8_mma_probe_plain)
from dlmc_quant_torch.tools import gemm_ceiling, gemm_sweep, mma_probe
from dlmc_quant_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


@contextlib.contextmanager
def _jax_tool(name):
    """The JAX tool module ``tools/<name>.py``, run in Pallas interpret mode.

    Importing a tool points JAX's compilation cache at the repo's TPU cache;
    the setting in force before is put back.
    """
    import jax
    from jax.experimental.pallas import tpu as pltpu
    cache = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, str(REPO / "tools"))
    try:
        module = importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / "tools"))
        jax.config.update("jax_compilation_cache_dir", cache)
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams()):
        yield module


def _codes(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _probe_operands(seed, m, k, n, nbufs):
    rng = np.random.default_rng(seed)
    x, w = _codes(rng, (m, k)), _codes(rng, (nbufs, k, n))
    wp = torch.stack([pack_b(torch.from_numpy(wj)) for wj in w])
    return x, w, wp


class TestAgainstJaxTools:
    @pytest.mark.parametrize("m,k,n,bm,bn", [
        (256, 128, 128, 128, 64),
        (96, 432, 256, 48, 128),     # K = 432 is not a multiple of 32
        (64, 48, 96, 32, 32),
    ])
    def test_gemm_equals_pallas(self, m, k, n, bm, bn):
        rng = np.random.default_rng(m + k + n)
        x, w = _codes(rng, (m, k)), _codes(rng, (k, n))
        with _jax_tool("pallas_gemm_sweep") as tool:
            want = np.asarray(tool.make_pallas_gemm(m, k, n, bm=bm, bn=bn)(x, w))
        got = int8_gemm(torch.from_numpy(x), pack_b(torch.from_numpy(w)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("m,k,n,nbufs,rolls", [
        (64, 32, 32, 1, 2),      # 128·r mod 64 = 0: the roll is the identity
        (192, 96, 64, 2, 3),     # shift 128: a partial wrap
        (256, 64, 32, 1, 3),     # shifts 128, then 256 ≡ 0: a full wrap
    ])
    def test_probe_equals_pallas(self, m, k, n, nbufs, rolls):
        x, w, wp = _probe_operands(m, m, k, n, nbufs)
        with _jax_tool("vmem_gemm_probe") as tool:
            want = np.asarray(tool.make_probe(m, k, n, nbufs, rolls)(x, w))
        got = int8_mma_probe(torch.from_numpy(x), wp, rolls)
        np.testing.assert_array_equal(got.numpy(), want)
        ref = sum(np.roll(x, 128 * r, 0).astype(np.int64)
                  @ w[j].astype(np.int64)
                  for r in range(rolls) for j in range(nbufs))
        np.testing.assert_array_equal(got.numpy(), ref)


class TestGemmWrapper:
    @pytest.mark.parametrize("m,k,n", [(17, 48, 8), (40, 432, 48),
                                       (33, 64, 24), (5, 16, 3)])
    def test_plain_equals_int_mm(self, m, k, n):
        rng = np.random.default_rng(k)
        x = torch.from_numpy(_codes(rng, (m, k)))
        w = torch.from_numpy(_codes(rng, (k, n)))
        got = int8_gemm(x, pack_b(w))
        assert torch.equal(got, torch._int_mm(x, w))
        assert torch.equal(int8_gemm_plain(x, pack_b(w)), got)

    def test_pack_roundtrip(self):
        rng = np.random.default_rng(1)
        for k, n in ((48, 8), (432, 48), (64, 64), (16, 1)):
            w = torch.from_numpy(_codes(rng, (k, n)))
            wp = pack_b(w)
            assert wp.shape == (n, packed_k(k)) and packed_k(k) % 32 == 0
            assert not wp[:, k:].any()
            assert torch.equal(unpack_b(wp, k), w)

    @pytest.mark.parametrize("bad", [
        "x_dtype", "x_dim", "k_not_16", "unpacked_w", "w_dtype", "w_3d",
        "x_noncontig", "k_overflow", "tile"])
    def test_raises(self, bad):
        rng = np.random.default_rng(2)
        x = torch.from_numpy(_codes(rng, (32, 48)))
        w = torch.from_numpy(_codes(rng, (48, 80)))
        wp, kw = pack_b(w), {}
        if bad == "x_dtype":
            x = x.to(torch.int32)
        elif bad == "x_dim":
            x = x[0]
        elif bad == "k_not_16":
            x, wp = x[:, :40].contiguous(), pack_b(w[:40])
        elif bad == "unpacked_w":
            wp = w
        elif bad == "w_dtype":
            wp = wp.to(torch.int32)
        elif bad == "w_3d":
            wp = wp[None]
        elif bad == "x_noncontig":
            x = torch.from_numpy(_codes(rng, (96, 64))).t()[:, :48]
        elif bad == "k_overflow":
            x = torch.zeros((1, 2 ** 17), dtype=torch.int8)
            wp = torch.zeros((8, 2 ** 17), dtype=torch.int8)
        elif bad == "tile":
            kw["tile"] = (32, 32)
        with pytest.raises(ValueError):
            int8_gemm(x, wp, **kw)

    def test_cpu_counts_no_launch(self):
        before = int8_gemm.launches
        x = torch.ones((4, 16), dtype=torch.int8)
        int8_gemm(x, pack_b(torch.ones((16, 8), dtype=torch.int8)))
        assert int8_gemm.launches == before


class TestProbeWrapper:
    def test_library_operands(self):
        """torch._int_mm on the concatenated operands is the probe's sum."""
        x, _, wp = _probe_operands(7, 192, 96, 64, 2)
        x = torch.from_numpy(x)
        xc, wc = mma_probe.concat_operands(x, wp, 3)
        assert xc.shape == (192, 3 * 2 * 96) and wc.shape == (3 * 2 * 96, 64)
        assert torch.equal(torch._int_mm(xc, wc), int8_mma_probe(x, wp, 3))
        assert torch.equal(int8_mma_probe_plain(x, wp, 3),
                           int8_mma_probe(x, wp, 3))

    @pytest.mark.parametrize("bad", ["rolls_zero", "w_2d", "overflow",
                                     "tiles", "x_dtype"])
    def test_raises(self, bad):
        x = torch.zeros((64, 32), dtype=torch.int8)
        w = torch.zeros((2, 16, 32), dtype=torch.int8)
        rolls = 2
        if bad == "rolls_zero":
            rolls = 0
        elif bad == "w_2d":
            w = w[0]
        elif bad == "overflow":     # 8 · 8 · 2048 · 128² = 2³¹
            x = torch.zeros((1, 2048), dtype=torch.int8)
            w, rolls = torch.zeros((8, 1, 2048), dtype=torch.int8), 8
        elif bad == "tiles":        # 20 + 3 operand tiles > MAX_TILES = 9
            w, rolls = torch.zeros((3, 16, 32), dtype=torch.int8), 20
        elif bad == "x_dtype":
            x = x.to(torch.uint8)
        with pytest.raises(ValueError):
            int8_mma_probe(x, w, rolls)

    def test_cpu_counts_no_launch(self):
        before = int8_mma_probe.launches
        int8_mma_probe(torch.ones((4, 16), dtype=torch.int8),
                       torch.ones((1, 8, 32), dtype=torch.int8), 2)
        assert int8_mma_probe.launches == before


class TestTools:
    def test_probe_plan_is_the_tpu_tools(self):
        # tools/vmem_gemm_probe.py:60-61 on a few of its shapes
        assert mma_probe.plan(512, 512, 512) == (8, 1)
        assert mma_probe.plan(1024, 1728, 512) == (7, 1)
        assert mma_probe.plan(192, 1728, 1024) == (3, 2)
        assert len(mma_probe.SHAPES) == 9

    def test_shapes_fit_the_kernels(self):
        for _, m, k, n in gemm_sweep.SHAPES:
            assert k % 16 == 0 and m > 16 and n % 8 == 0
        a0 = {(m, k, n) for name, m, k, n in gemm_sweep.SHAPES
              if name.startswith("A0")}
        assert a0 == {(802816, 432, 48), (200704, 864, 96),
                      (50176, 1728, 192)}
        for m, k, n in mma_probe.SHAPES:
            nbufs, rolls = mma_probe.plan(m, k, n)
            assert k % 16 == 0 and rolls * nbufs * k * 128 ** 2 < 2 ** 31

    def test_gemm_sweep_operands_on_cpu(self):
        gen = torch.Generator().manual_seed(0)
        x, w = gemm_sweep.operands(24, 48, 16, gen)
        wp = pack_b(w)
        wc = gemm_sweep.col_major(wp, 48)
        assert wc.shape == (48, 16) and wc.stride() == (1, 48)
        assert torch.equal(int8_gemm(x, wp), torch._int_mm(x, wc))
        assert gemm_sweep.cost(24, 48, 16) == (2 * 24 * 48 * 16,
                                                24 * 48 + 48 * 16 + 4 * 24 * 16)

    @pytest.mark.parametrize("entry", ["gemm_sweep", "mma_probe",
                                       "gemm_ceiling"])
    def test_tools_need_a_card(self, entry, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        main = {"gemm_sweep": gemm_sweep.main,
                "mma_probe": lambda: mma_probe.main([]),
                "gemm_ceiling": gemm_ceiling.main}[entry]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()

    def test_import_leaves_out_jax(self):
        code = ("import sys, dlmc_quant_torch.tools.gemm_sweep, "
                "dlmc_quant_torch.tools.mma_probe, "
                "dlmc_quant_torch.tools.gemm_ceiling\n"
                "bad = [m for m in sys.modules if m == 'jax' or "
                "m.startswith(('jax.', 'flax', 'dlmc_quant_tpu'))]\n"
                "assert not bad, bad\n")
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                       timeout=120)


class TestProfilingAndBuild:
    def test_peaks_are_keyed_on_the_card(self):
        h100 = profiling.card_peaks("NVIDIA H100 80GB HBM3")
        assert h100 == {"int8": 1979e12, "bf16": 989e12, "bytes": 3.35e12}
        assert (profiling.PEAK_INT8_OPS, profiling.PEAK_BYTES) == (
            1979e12, 3.35e12)
        with pytest.raises(KeyError):
            profiling.card_peaks("NVIDIA A100-SXM4-80GB")

    def test_roofline_and_bound(self):
        r = profiling.roofline(1979e9 / 2, 1e-3, "int8",
                               name="NVIDIA H100 80GB HBM3")
        assert r["achieved_tops"] == pytest.approx(1979)
        assert r["utilization"] == pytest.approx(1.0)
        ops_ms, bytes_ms = profiling.roof_ms(1979e9, 3.35e9 * 2)
        assert (ops_ms, bytes_ms) == (pytest.approx(1.0), pytest.approx(2.0))
        assert profiling.bound_by(ops_ms, bytes_ms) == "bytes"

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        path = tmp_path / "trace.json"
        with profiling.trace(str(path)) as prof:
            torch.ones(8).sum()
        assert path.stat().st_size > 0 and prof.key_averages()

    def test_library_name_follows_source_and_header(self, tmp_path,
                                                    monkeypatch):
        names = {build.library_path(n).name
                 for n in ("int8_conv3x3", "int8_gemm", "int8_mma_probe")}
        assert len(names) == 3
        before = build.library_path("int8_gemm")
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for f in build.CSRC.iterdir():
            (csrc / f.name).write_bytes(f.read_bytes())
        (csrc / "wgmma_s8.cuh").write_bytes(
            (csrc / "wgmma_s8.cuh").read_bytes() + b"\n// edited\n")
        monkeypatch.setattr(build, "CSRC", csrc)
        assert build.library_path("int8_gemm").name != before.name
        # the conv is built on the same header; an edit to one kernel's
        # source leaves the other kernels' builds as they are
        conv = build.library_path("int8_conv3x3").name
        assert conv not in names
        (csrc / "int8_gemm.cu").write_bytes(
            (csrc / "int8_gemm.cu").read_bytes() + b"\n// edited\n")
        assert build.library_path("int8_conv3x3").name == conv

    def test_build_raises_without_nvcc(self, tmp_path, monkeypatch):
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(build.shutil, "which", lambda _: None)
        monkeypatch.setattr(build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build("int8_gemm", "int8_mma_probe")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


EDGE_SHAPES = [(m, k, n) for k in (16, 48, 432) for m in (3, 63, 65, 200)
               for n in (1, 8, 48, 96, 192, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(48, 432, 200), (1000, 64, 48),
                                   (130, 1024, 130), (3, 16, 1),
                                   (300, 2048, 520)] + EDGE_SHAPES)
def test_gemm_kernel_matches_plain_on_card(card, m, k, n):
    """Every compiled tile at ragged M, N and K: K below one 128-byte
    stage, K = 432 with a partly empty last stage, M and N around the
    64-row and 8-column granules, and enough K to wrap every ring."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(_codes(rng, (m, k))).to(card)
    wp = pack_b(torch.from_numpy(_codes(rng, (k, n))).to(card))
    want = int8_gemm_plain(x, wp)
    for tile in TILES:
        got = int8_gemm(x, wp, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,nbufs,rolls", [
    (192, 96, 64, 2, 3), (100, 48, 72, 2, 4), (256, 1728, 192, 8, 1),
    (64, 432, 48, 3, 1), (64, 432, 48, 3, 2), (64, 432, 48, 3, 3),
    (192, 432, 200, 2, 1), (192, 432, 200, 2, 2), (192, 432, 200, 2, 3),
    (256, 1024, 96, 1, 1), (256, 1024, 96, 1, 2), (256, 1024, 96, 1, 3),
    (3, 16, 1, 1, 2), (65, 48, 8, 6, 3),
    # the most tiles a stage holds, on the shallowest ring, over many chunks
    (130, 1024, 72, 8, 1), (130, 640, 72, 1, 8), (200, 1728, 64, 4, 5)])
def test_probe_kernel_matches_plain_on_card(card, m, k, n, nbufs, rolls):
    """M = 64, 192, 256 with rolls 1-3 (identity, partial and full wrap), a
    wrap in the middle of a swizzle atom (M = 100), rolls + nbufs at its
    most with K of 5 to 14 chunks, every split of K."""
    x, _, wp = _probe_operands(m, m, k, n, nbufs)
    x, wp = torch.from_numpy(x).to(card), wp.to(card)
    want = int8_mma_probe_plain(x, wp, rolls)
    chunks = -(-k // 128)
    for split in (None, *sorted({1, min(2, chunks), chunks})):
        got = int8_mma_probe(x, wp, rolls, _split=split)
        torch.cuda.synchronize()
        assert torch.equal(got, want), split


@pytest.mark.cuda
def test_trace_sees_the_kernel_on_card(card, tmp_path):
    x, _, wp = _probe_operands(0, 256, 64, 64, 1)
    x, wp = torch.from_numpy(x).to(card), wp.to(card)
    int8_mma_probe(x, wp, 1)
    with profiling.trace(str(tmp_path / "trace.json")) as prof:
        int8_mma_probe(x, wp, 1)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if "int8_mma_probe_kernel" in e.key)
    assert device_us > 0
