"""The model axis on the CPU: int8 plans sharded over output channels,
the blocks gathered between layers, held against the JAX package's
sharded forward and against the port's replicated one.

* ``param_pspec`` mirrors ``tests/test_parallel.py:33-45`` (the last axis
  split where it divides by the axis and is at least its size, else
  replicated; scalars replicated), and the port's per-layer rule on top of
  it (a grouped conv keeps whole groups a rank).
* Ranks: this file run as a script is one rank (``python
  tests/test_torch_sharding.py --rank R WORLD PORT DIR``), joined over
  gloo on ``localhost``; a 2-rank world (mesh (1, 2)) and a 4-rank one
  (mesh (2, 2)) run side by side, each child with ``OMP_NUM_THREADS=1``.
* cifar_resnet20 W8A8 ``int`` (``tests/test_parallel.py``'s
  ``TestTensorShardedInference``: JAX's init, calibrate and
  ``prepare_deploy``; the port takes JAX's calibrated variables through
  ``load_jax_variables`` and builds its own plan): on every rank the
  sharded logits equal the port's replicated ones (``torch.equal``, in
  ``int`` and ``intc``), and hold JAX's (4, 2)-sharded forward to its own
  test's classes and band, ``0.05·max|y| + 1e-4``.
* The model axis has 2 ranks in both worlds (the 4-rank world has two
  model groups on its data axis).  Tiny nets at 12×12, sharded against
  replicated exactly, ``int`` and ``intc``: a weight-only stem, a
  depthwise 3×3 at SAME/s2, a grouped 3×3 (G = 4: two groups a rank), a
  grouped 1×1 (G = 2: one group a rank, run as an ungrouped GEMM), a 5×5
  past 2,048 bytes of K (runs of channels), a W4 1×1 and a 36-way head
  (18 a rank, padded to 24 for ``torch._int_mm``);
  the same net under RootQ W8A8 with its bounds spread, so every layer
  carries the row term ``s_x·o_w·S`` (``S`` whole, ``off_scale`` cut).
* ``gather_channels`` puts the blocks in rank order; ``make_mesh`` builds
  a ``('data', 'model')`` mesh; ``shard_params`` places each layer's block.
* ``InferenceEngine`` on the mesh: ``forward`` pads (5 images at batch 8),
  and in lockstep the model group's first rank takes the requests, the
  others run its batches (their ``submit`` raises), and its futures
  resolve with the gathered logits, equal to the replicated forward's.
* ``cuda``-marked tests (skipped here) hold the kernels at the widths two
  ranks give them against their plain versions, tolerance 0: the conv at
  O = 8, 24, 48, 96, 640 (cifar_resnet20's and RepVGG-A0's halves: a
  48-wide tile partly empty below 48) and ResNet-50's 32…256, in codes,
  f32, codes with an int8, int32 and f32 residual and codes with the row
  term; the GEMM at N = 128…1024 in int32, codes, f32 and with a
  residual; the stem + pool at O = 32 in each mode:
  ``python -m pytest --noconftest tests/test_torch_sharding.py -m cuda``.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:        # run as a script: one rank
    sys.path.insert(0, str(REPO))

from dlmc_quant_torch.models import get_model  # noqa: E402
from dlmc_quant_torch.ops.cuda import int8_conv as K  # noqa: E402
from dlmc_quant_torch.ops.cuda import int8_gemm as G  # noqa: E402
from dlmc_quant_torch.ops.cuda import int8_stem_pool as SP  # noqa: E402
from dlmc_quant_torch.parallel import mesh as mesh_lib  # noqa: E402
from dlmc_quant_torch.parallel.serving import InferenceEngine  # noqa: E402
from dlmc_quant_torch.parallel.sharding_rules import (  # noqa: E402
    param_pspec, shard_params, shardable)
from dlmc_quant_torch.quant.chain import materialize, qrelu  # noqa: E402
from dlmc_quant_torch.quant.config import scheme_from_dict  # noqa: E402
from dlmc_quant_torch.quant.deploy import prepare_deploy  # noqa: E402
from dlmc_quant_torch.quant.layers import (QConv, QDense,  # noqa: E402
                                           attach_scheme, calibrate)
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables  # noqa

torch.set_num_threads(1)

W8A8 = {"quantization_type": "FSPTQ",
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": 8, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}}}
TINY_SCHEMES = {
    # the stem weight-only, the 1x1 at W4
    "fsptq": dict(W8A8, override_options=[
        {"layers": ["^stem$"], "options": {"input": {"enable": False}}},
        {"layers": ["^pw$"], "options": {"weight": {"args": {"n_bits": 4}}}}]),
    "rootq": {"quantization_type": "RootQ", "momentum": 0.1,
              "weight": {"enable": True, "type": "minmax_channel",
                         "args": {"n_bits": 8, "signed": True}},
              "input": {"enable": True, "type": "minmax_tensor",
                        "args": {"n_bits": 8, "signed": False}}},
}
WORLDS = (2, 4)
QMODES = ("int", "intc")
TIMEOUT_S = 240


class Tiny(nn.Module):
    """A chain of every layer kind the model axis cuts."""

    def __init__(self, gen):
        super().__init__()
        self.stem = QConv(3, 16, 3, 1, 1, generator=gen)
        self.dw = QConv(16, 16, 3, 2, "SAME", groups=16, generator=gen)
        self.grouped = QConv(16, 32, 3, 1, 1, groups=4, generator=gen)
        self.g2 = QConv(32, 32, 1, 1, 0, groups=2, generator=gen)
        self.wide = QConv(32, 96, 1, 1, 0, generator=gen)
        self.chunked = QConv(96, 24, 5, 1, 2, generator=gen)
        self.pw = QConv(24, 40, 1, 1, 0, generator=gen)
        self.head = QDense(40, 36, generator=gen)

    def forward(self, x, qmode="eval"):
        for name in ("stem", "dw", "grouped", "g2", "wide", "chunked", "pw"):
            x = qrelu(getattr(self, name)(x, qmode=qmode))
        x = materialize(x).mean(dim=(1, 2))
        return materialize(self.head(x, qmode=qmode))


def tiny(kind: str):
    """The tiny net under ``kind``'s scheme, biases seeded, calibrated on
    one seeded batch and prepared; RootQ's bounds moved apart (``o_w ≠
    0``)."""
    gen = torch.Generator().manual_seed(3)
    model = attach_scheme(Tiny(gen), scheme_from_dict(TINY_SCHEMES[kind]))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (QConv, QDense)):
                m.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.rand((2, 12, 12, 3), generator=gen)
    calibrate(model, [x])
    if kind == "rootq":
        with torch.no_grad():
            for m in model.modules():
                if hasattr(m, "wt_run_upper"):
                    m.wt_run_upper.mul_(1.2)
                    m.wt_run_lower.mul_(0.7)
    return prepare_deploy(model), x


def _r20(variables):
    return load_jax_variables(get_model(
        "cifar_resnet20", device="cpu", num_classes=10,
        scheme=scheme_from_dict(W8A8)), variables)


def _forwards(model, x):
    with torch.no_grad():
        return {q: model(x, qmode=q) for q in QMODES}


def _engine(variables, x, mesh, res):
    """The engine's padded forward and a lockstep stream on the mesh."""
    model = prepare_deploy(_r20(variables))
    with torch.no_grad():
        want = model(x, qmode="int")
    eng = InferenceEngine(model, mesh, batch_size=8, qmode="int",
                          device="cpu", consensus_every=2)
    res["engine_pads"] = tuple(eng.forward(x[:5].numpy()).shape)
    eng.warmup((32, 32, 3))
    eng.start()
    if eng.lead:
        sizes = (2, 3, 1, 2)
        starts = np.cumsum((0,) + sizes[:-1])
        futs = [eng.submit(x[s:s + k].numpy()) for s, k in zip(starts, sizes)]
        got = np.concatenate([f.result(timeout=60) for f in futs])
        res["engine_futures"] = torch.equal(torch.from_numpy(got),
                                            want[:sum(sizes)])
    else:
        try:
            eng.submit(x[:1].numpy())
            res["engine_submit_raises"] = False
        except RuntimeError:
            res["engine_submit_raises"] = True
    eng.stop(timeout=60)
    res["engine_exited"] = not eng._thread.is_alive()


def rank_main(rank: int, world: int, port: int, out: Path) -> None:
    mesh_lib.init_distributed(f"localhost:{port}", world, rank, "cpu")
    shape = (world // 2, 2)
    mesh = mesh_lib.make_mesh(axes=("data", "model"), shape=shape)
    res = {"mesh": (tuple(mesh.mesh.shape), mesh.mesh_dim_names),
           "model_rank": mesh_lib.axis_rank(mesh, "model")}
    code = torch.full((2, 3, 4), float(res["model_rank"]))
    res["gathered"] = mesh_lib.gather_channels(code, mesh)[0, 0].tolist()

    with open(out / "r20.pkl", "rb") as f:
        variables = pickle.load(f)
    x = torch.from_numpy(np.load(out / "x.npy"))
    model = prepare_deploy(_r20(variables))
    res["r20_replicated"] = _forwards(model, x)
    shard_params(model, mesh)
    res["r20_sharded"] = _forwards(model, x)
    res["r20_blocks"] = {name: (m.shard.lo, m.shard.hi, tuple(m.w_scale.shape))
                         for name, m in model.named_modules()
                         if getattr(m, "shard", None) is not None}
    for kind in TINY_SCHEMES:
        model, xt = tiny(kind)
        res[f"{kind}_replicated"] = _forwards(model, xt)
        shard_params(model, mesh)
        res[f"{kind}_sharded"] = _forwards(model, xt)
        res[f"{kind}_local_groups"] = {
            name: m.local_groups for name, m in model.named_modules()
            if isinstance(m, QConv)}
        res[f"{kind}_sharded_layers"] = sum(
            getattr(m, "shard", None) is not None for m in model.modules())
    _engine(variables, x, mesh, res)
    torch.save(res, out / f"rank{rank}.pt")
    mesh_lib.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's cifar_resnet20 W8A8 (the spec test's), its replicated and
    (4, 2)-sharded ``int`` logits; the 2- and 4-rank worlds' results."""
    import flax
    import jax
    from dlmc_quant_tpu.models import get_model as jax_get_model
    from dlmc_quant_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dlmc_quant_tpu.parallel.sharding_rules import \
        shard_params as jax_shard
    from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
    from dlmc_quant_tpu.quant.deploy import prepare_deploy as jax_prepare
    from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate

    m = jax_get_model("cifar_resnet20", num_classes=10,
                      scheme=jax_scheme(W8A8))
    x = jax.nn.relu(jax.random.normal(jax.random.PRNGKey(0),
                                      (8, 32, 32, 3)))
    v = m.init(jax.random.PRNGKey(1), x)
    v_cal = jax_calibrate(m, v, [x])
    dirs = {}
    procs = []
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        with open(out / "r20.pkl", "wb") as f:
            pickle.dump(jax.tree_util.tree_map(
                np.asarray, flax.core.unfreeze(v_cal)), f)
        np.save(out / "x.npy", np.asarray(x))
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), str(world),
             str(port), str(out)], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        dirs[world] = out
    v_dep = jax_prepare(m, v_cal, sample_input=x)
    y_ref = np.asarray(m.apply(v_dep, x, qmode="int"))
    v_sh = jax_shard(v_dep, jax_make_mesh(8, axes=("data", "model"),
                                          shape=(4, 2)))
    y_sh = np.asarray(jax.jit(
        lambda v, x: m.apply(v, x, qmode="int"))(v_sh, x))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return {"jax_replicated": y_ref, "jax_sharded": y_sh,
            **{world: [torch.load(dirs[world] / f"rank{r}.pt")
                       for r in range(world)] for world in WORLDS}}


# ------------------------------------------------------------ the rules

def test_pspec_inference():
    """tests/test_parallel.py:33-38, as tuples of axis names."""
    assert param_pspec(np.zeros((3, 3, 4, 16)).shape, 2) == \
        (None, None, None, "model")
    assert param_pspec((16,), 2) == ("model",)
    assert param_pspec((3,), 2) == ()            # not divisible
    assert param_pspec((), 2) == ()
    assert param_pspec(torch.zeros(3, 3, 4, 16), 2) == \
        (None, None, None, "model")
    assert param_pspec((1,), 2) == ()            # smaller than the axis


@pytest.mark.parametrize("layer,n,want", [
    (lambda: QConv(8, 16, 3), 2, True),
    (lambda: QConv(8, 6, 3), 4, False),          # 6 % 4
    (lambda: QConv(16, 32, 3, groups=4), 4, True),
    (lambda: QConv(16, 32, 3, groups=2), 4, False),    # 2 groups, 4 ranks
    (lambda: QConv(16, 16, 3, groups=16), 4, True),    # depthwise
    (lambda: QDense(40, 10), 2, True),
    (lambda: QDense(40, 10), 4, False),
])
def test_shardable_layers(layer, n, want):
    assert shardable(layer(), n) is want


def test_shard_params_without_model_axis_is_a_noop():
    model, x = tiny("fsptq")
    with torch.no_grad():
        before = model(x, qmode="intc")
        assert shard_params(model, None) is model
        assert all(getattr(m, "shard", None) is None
                   for m in model.modules())
        assert torch.equal(model(x, qmode="intc"), before)


# ------------------------------------------------------------ the ranks

@pytest.mark.parametrize("world", WORLDS)
def test_mesh_and_gather_order(runs, world):
    for r, res in enumerate(runs[world]):
        assert res["mesh"] == ((world // 2, 2), ("data", "model"))
        assert res["model_rank"] == r % 2
        assert res["gathered"] == [0.0] * 4 + [1.0] * 4


@pytest.mark.parametrize("world", WORLDS)
def test_shard_params_places_blocks(runs, world):
    for r, res in enumerate(runs[world]):
        blocks = res["r20_blocks"]
        # every conv and the head: 19 convs of 16/32/64 and a 10-way head
        assert len(blocks) == 20
        lo, hi, shape = blocks["linear"]
        assert (lo, hi, shape) == (5 * (r % 2), 5 * (r % 2 + 1), (5,))
        for name, (lo, hi, shape) in blocks.items():
            assert shape == (hi - lo,) and lo == (r % 2) * (hi - lo), name


@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("world", WORLDS)
def test_resnet20_sharded_equals_replicated(runs, world, qmode):
    for res in runs[world]:
        assert torch.equal(res["r20_sharded"][qmode],
                           res["r20_replicated"][qmode])


@pytest.mark.parametrize("world", WORLDS)
def test_resnet20_matches_jax_sharded(runs, world):
    """tests/test_parallel.py:67-87's classes and band, the port's sharded
    logits against JAX's (4, 2)-sharded forward (and its replicated)."""
    for want in (runs["jax_sharded"], runs["jax_replicated"]):
        band = 0.05 * np.abs(want).max() + 1e-4
        for res in runs[world]:
            got = res["r20_sharded"]["int"].numpy()
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            np.testing.assert_allclose(got, want, atol=band, rtol=0)


@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("kind", list(TINY_SCHEMES))
@pytest.mark.parametrize("world", WORLDS)
def test_tiny_sharded_equals_replicated(runs, world, kind, qmode):
    for res in runs[world]:
        got, want = res[f"{kind}_sharded"][qmode], \
            res[f"{kind}_replicated"][qmode]
        assert got.shape == (2, 36) and torch.isfinite(got).all()
        assert torch.equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_tiny_groups_a_rank(runs, world):
    for res in runs[world]:
        groups = res["fsptq_local_groups"]
        assert groups["grouped"] == 4 // 2 and groups["dw"] == 16 // 2
        assert groups["g2"] == groups["stem"] == groups["chunked"] == 1
        # the 8 layers, the weight-only stem and the W4 1x1 among them
        assert res["fsptq_sharded_layers"] == res["rootq_sharded_layers"] \
            == 8


@pytest.mark.parametrize("world", WORLDS)
def test_engine_on_the_model_axis(runs, world):
    for r, res in enumerate(runs[world]):
        assert res["engine_pads"] == (5, 10)
        assert res["engine_exited"]
        if r % 2 == 0:
            assert res["engine_futures"]
        else:
            assert res["engine_submit_raises"]


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _epilogue(mode, out_shape, gen, dev):
    """The keywords of an epilogue ``mode`` for an output of
    ``out_shape``: codes, f32, codes with a residual of a dtype, codes
    with a row term."""
    o = out_shape[-1]
    if mode == "f32":
        return dict(mode="f32", relu=True)
    kw = dict(mode="codes", lo=-100, hi=120)
    if mode.startswith("res_"):
        dtype = {"res_int8": torch.int8, "res_int32": torch.int32,
                 "res_f32": torch.float32}[mode]
        r = (torch.rand(out_shape, generator=gen) * 3
             if dtype == torch.float32 else
             torch.randint(-128, 128, out_shape, generator=gen).to(dtype))
        kw["residual"] = tuple(t.to(dev).contiguous() for t in (
            r, torch.rand(o, generator=gen) * 0.05, torch.randn(o,
                                                                generator=gen)))
        kw["qb"] = -130.25
    elif mode == "row":
        sums = torch.randint(-3000, 3000, out_shape[:-1], generator=gen,
                             dtype=torch.int32)
        kw["row"] = (sums.to(dev), (torch.randn(o, generator=gen)
                                    * 1e-4).to(dev))
    return kw


EPILOGUES = ("codes", "f32", "res_int8", "res_int32", "res_f32", "row")
# (n, h, w, c, o, stride): the 3x3 convs' blocks of output channels on two
# ranks: cifar_resnet20 (16 -> 8), RepVGG-A0 (48, 96, 192, 1280 -> 24, 48,
# 96, 640; its stem 3 -> 24), ResNet-50 (64..512 -> 32..256)
SHARD_CONVS = [(4, 32, 32, 16, 8, 1), (2, 56, 56, 3, 24, 2),
               (2, 28, 28, 48, 24, 1), (2, 28, 28, 96, 48, 1),
               (2, 14, 14, 96, 96, 2), (2, 7, 7, 192, 640, 1),
               (2, 56, 56, 64, 32, 1), (2, 28, 28, 128, 64, 1),
               (2, 14, 14, 256, 128, 1), (2, 7, 7, 512, 256, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", EPILOGUES)
@pytest.mark.parametrize("case", SHARD_CONVS,
                         ids=["x".join(map(str, c)) for c in SHARD_CONVS])
def test_card_conv_at_shard_widths(case, mode):
    dev = _card()
    n, h, w, c, o, s = case
    gen = torch.Generator().manual_seed(n * h + c + o)
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8,
                      generator=gen).to(dev)
    wp = K.pack_weight(torch.randint(-128, 128, (3, 3, c, o),
                                     dtype=torch.int8, generator=gen)).to(dev)
    a = (torch.rand(o, generator=gen) * 1e-3 + 1e-4).to(dev)
    b = (torch.randn(o, generator=gen) * 2).to(dev)
    out = (n, -(-h // s), -(-w // s), o)
    kw = dict(stride=s, pad=-3, **_epilogue(mode, out, gen, dev))
    got = K.int8_conv3x3(x, wp, a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, K.int8_conv3x3_plain(x, wp, a, b, **kw))


# ResNet-50's 1x1 convs at batch 2 on two ranks: N = 128..1024
SHARD_GEMMS = [(6272, 64, 128), (1568, 128, 256), (392, 256, 512),
               (98, 512, 1024), (98, 2048, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("int32",) + EPILOGUES)
@pytest.mark.parametrize("case", SHARD_GEMMS,
                         ids=["x".join(map(str, c)) for c in SHARD_GEMMS])
def test_card_gemm_at_shard_widths(case, mode):
    dev = _card()
    m, k, n = case
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8,
                      generator=gen).to(dev)
    wp = G.pack_b(torch.randint(-128, 128, (k, n), dtype=torch.int8,
                                generator=gen)).to(dev)
    if mode == "int32":
        a = b = None
        kw = dict(mode="int32")
    else:
        a = (torch.rand(n, generator=gen) * 1e-3 + 1e-4).to(dev)
        b = (torch.randn(n, generator=gen) * 2).to(dev)
        kw = _epilogue(mode, (m, n), gen, dev)
    got = G.int8_gemm(x, wp, a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, G.int8_gemm_plain(x, wp, a, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("int32", "codes", "f32"))
def test_card_stem_pool_at_shard_width(mode):
    """ResNet-50's stem on two ranks: 64 -> 32 columns."""
    dev = _card()
    gen = torch.Generator().manual_seed(32)
    x = torch.randint(-128, 128, (4, 224, 224, 3), dtype=torch.int8,
                      generator=gen).to(dev)
    wp = SP.pack_weight(torch.randint(-128, 128, (7, 7, 3, 32),
                                      dtype=torch.int8, generator=gen)).to(dev)
    kw = dict(pads=((3, 3), (3, 3)), pad=-7, mode=mode)
    a = b = None
    if mode != "int32":
        a = (torch.rand(32, generator=gen) * 1e-3 + 1e-4).to(dev)
        b = (torch.randn(32, generator=gen) * 2).to(dev)
        if mode == "codes":
            kw.update(lo=-100, hi=120)
    got = SP.int8_stem_pool(x, wp, a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, SP.int8_stem_pool_plain(x, wp, a, b, **kw))


if __name__ == "__main__":
    rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
              Path(sys.argv[5]))
