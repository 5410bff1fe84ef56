"""The graphed serving function and engine (``quant/graphed.py``,
``quant/deploy.py: make_serving_fn``, ``parallel/serving.py:
InferenceEngine``) against the JAX package's jitted ones.

On the CPU (the serving function's and the engine's eager forward, the
only one there):

* ``make_serving_fn(model, device="cpu")`` on an A0-shaped toy (RepVGG's
  deploy form, one or two blocks a stage at a quarter of A0's widths) and
  a toy ResNet (``CifarResNet(depth_n=1)``'s deploy form) equals JAX's
  jitted ``make_serving_fn`` on the same bridged weights within relative
  L2 2e-2: the bound at which ``tests/test_torch_repvgg_slice.py`` and
  ``tests/test_torch_resnet.py`` hold chained int8 logits (XLA's jit
  contracts a folded quantize into an fma, which can move a tie by a
  code);
* ``InferenceEngine.forward`` at a padded batch equals JAX's engine
  ``forward`` within the same bound;
* ``graph=True`` on the CPU raises; a sharded model refuses a graph; a
  failed capture names the line that broke it.

On the card (``cuda``-marked, skipped here; run with ``python -m pytest
--noconftest tests/test_torch_graphed_serving.py -m cuda``): the graphed
logits bit-equal to the eager ones at two batch shapes, one graph each; a
second call leaves the first call's logits as they were; the launches
recorded at capture equal one eager request's; a forward that syncs the
host raises instead of serving eagerly; a sharded model refuses a graph;
the graphed engine's steps bit-equal to the eager engine's.

The card's machine has no JAX: it is imported inside the fixture that
compares with it, never at the top.
"""

import copy

import numpy as np
import pytest
import torch

from dlmc_quant_torch.models.repvgg import RepVGG
from dlmc_quant_torch.models.resnet_cifar import CifarResNet
from dlmc_quant_torch.parallel.serving import InferenceEngine
from dlmc_quant_torch.quant import graphed
from dlmc_quant_torch.quant.chain import Shard
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.deploy import make_serving_fn, prepare_deploy
from dlmc_quant_torch.quant.layers import calibrate

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 4, 16, 10
ENGINE_BATCH = 8
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}
# A0's stages at one or two blocks and a quarter of its widths (16, 32,
# 64, 320)
A0_TOY = dict(num_blocks=(1, 2, 2, 1),
              width_multiplier=(0.25, 0.25, 0.25, 0.625),
              num_classes=CLASSES, deploy=True)
ARCHS = ["a0_toy", "resnet_toy"]
REL = 2e-2


def _images(seed, n=BATCH):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3),
                                              dtype=np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9))


def _port_model(arch, generator=None):
    if arch == "a0_toy":
        return RepVGG(**A0_TOY, scheme=scheme_from_dict(SCHEME),
                      generator=generator)
    return CifarResNet(depth_n=1, num_classes=CLASSES, deploy=True,
                       scheme=scheme_from_dict(SCHEME), generator=generator)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """JAX's toy initialised (seeded non-zero conv biases, as a fused model
    has), calibrated and deployed; the port's twin on JAX's calibrated
    variables, its plans built by its own ``prepare_deploy``."""
    import flax
    import jax
    import jax.numpy as jnp

    from dlmc_quant_tpu.models.repvgg import RepVGG as JRepVGG
    from dlmc_quant_tpu.models.resnet_cifar import CifarResNet as JResNet
    from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
    from dlmc_quant_tpu.quant.deploy import prepare_deploy as jax_prepare
    from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
    from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

    arch = request.param
    jm = (JRepVGG(**A0_TOY, scheme=jax_scheme(SCHEME)) if arch == "a0_toy"
          else JResNet(depth_n=1, num_classes=CLASSES, deploy=True,
                       scheme=jax_scheme(SCHEME)))
    x = jnp.asarray(_images(0))
    v = jax.tree_util.tree_map(
        np.asarray, flax.core.unfreeze(
            jax.jit(jm.init)(jax.random.PRNGKey(1), x)))
    rng = np.random.default_rng(4)
    for leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        path, value = leaf
        if getattr(path[-1], "key", None) == "bias" and value.ndim == 1:
            node = v["params"]
            for p in path[:-1]:
                node = node[p.key]
            node["bias"] = (0.1 + 0.2 * rng.standard_normal(value.shape)) \
                .astype(np.float32)
    v = jax_calibrate(jm, jax.tree_util.tree_map(jnp.asarray, v), [x])
    cal = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(v))
    jv = jax_prepare(jm, v, sample_input=x)
    port = prepare_deploy(load_jax_variables(_port_model(arch), cal))
    return {"arch": arch, "jm": jm, "jv": jv, "port": port}


def test_cpu_serving_fn_matches_jax_jit(case):
    """The eager serving function on the CPU against JAX's jitted one on
    two batches, the second of another size."""
    from dlmc_quant_tpu.quant.deploy import make_serving_fn as jax_serving

    jax_fn = jax_serving(case["jm"], case["jv"], qmode="intc")
    serve = make_serving_fn(case["port"], qmode="intc", device="cpu")
    assert not isinstance(serve, graphed.GraphedForward)
    for seed, n in ((5, BATCH), (6, 2)):
        x = _images(seed, n)
        got = serve(torch.from_numpy(x)).numpy()
        want = np.asarray(jax_fn(x))
        assert got.shape == (n, CLASSES) and np.isfinite(got).all()
        assert _rel(got, want) < REL, (case["arch"], n)


def test_cpu_engine_forward_matches_jax_engine(case):
    """A padded batch (5 of ENGINE_BATCH rows) through both engines."""
    from dlmc_quant_tpu.parallel.serving import \
        InferenceEngine as JInferenceEngine

    x = _images(7, 5)
    eng = InferenceEngine(case["port"], batch_size=ENGINE_BATCH,
                          qmode="intc", device="cpu")
    assert eng.graphed is None
    got = eng.forward(x).numpy()
    want = np.asarray(JInferenceEngine(
        case["jm"], case["jv"], mesh=None, qmode="intc",
        batch_size=ENGINE_BATCH).forward(x))
    assert got.shape == (5, CLASSES)
    assert _rel(got, want) < REL, case["arch"]
    # the padded rows change nothing: the rows alone, eagerly
    with torch.inference_mode():
        alone = case["port"](torch.from_numpy(x), qmode="intc").numpy()
    assert _rel(got, alone) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_on_the_cpu_raises(arch):
    model = _port_model(arch)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_serving_fn(model, device="cpu", graph=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        InferenceEngine(model, batch_size=ENGINE_BATCH, device="cpu",
                        graph=True)
    # graph=False on the CPU is the eager forward, as the default is there
    assert not isinstance(make_serving_fn(model, device="cpu", graph=False),
                          graphed.GraphedForward)


def _sharded(model):
    """A copy of ``model`` whose first quantized layer's plan reads as
    sharded over a two-rank model axis."""
    model = copy.deepcopy(model)
    name, layer = next((n, m) for n, m in model.named_modules()
                       if hasattr(m, "shard"))
    layer.shard = Shard(0, 8, 16, mesh=None)
    return model, name


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_model_refuses_a_graph(arch):
    model, name = _sharded(_port_model(arch))
    assert graphed.sharded_layers(model) == [name]
    assert graphed.sharded_layers(_port_model(arch)) == []
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="sharded over a model axis"):
            graphed.GraphedForward(model, "intc", torch.device(device))
    with pytest.raises(ValueError, match="pass graph=False"):
        make_serving_fn(model, device="cpu", graph=True)


def test_culprit_names_the_line():
    def forward(x):
        return float(x)          # the op that breaks a capture

    try:
        try:
            forward(torch.ones(2))
        except (RuntimeError, ValueError, TypeError) as e:
            raise graphed.CaptureError("capture failed") from e
    except graphed.CaptureError as e:
        where = graphed.culprit(e)
    assert __file__ in where and "in forward: return float(x)" in where


def test_launch_counts_read_every_counter():
    for kind, (mod, fn, attr) in graphed.COUNTERS.items():
        wrapper = getattr(mod, fn)
        saved = getattr(wrapper, attr)
        try:
            setattr(wrapper, attr, saved + 7)
            assert graphed.launch_counts()[kind] == saved + 7, kind
        finally:
            setattr(wrapper, attr, saved)
    assert set(graphed.launch_counts()) == set(graphed.COUNTERS)


# -- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_model():
    """The A0-shaped toy on the card at 32x32: seeded weights, calibrated
    on seeded images, deployed."""
    device = _card()
    model = _port_model("a0_toy", torch.Generator().manual_seed(0)) \
        .to(device)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (16, 32, 32, 3), dtype=np.float32)).to(device)
    calibrate(model, [x[:8]])
    return prepare_deploy(model), x


@pytest.mark.cuda
def test_graphed_equals_eager_at_two_shapes(card_model):
    model, x = card_model
    serve = make_serving_fn(model, qmode="intc")
    eager = make_serving_fn(model, qmode="intc", graph=False)
    assert isinstance(serve, graphed.GraphedForward)
    for n in (8, 16, 8):
        assert torch.equal(serve(x[:n]), eager(x[:n])), n
    assert sorted(k[0][0] for k in serve.launches) == [8, 16]
    assert all(s > 0 for s in serve.capture_s.values())
    serve.reset()
    assert serve.launches == {}


@pytest.mark.cuda
def test_second_call_keeps_the_first_logits(card_model):
    model, x = card_model
    serve = make_serving_fn(model, qmode="intc")
    first = serve(x[:8])
    kept = first.clone()
    second = serve(x[8:16])
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


@pytest.mark.cuda
def test_capture_launches_equal_an_eager_request(card_model):
    model, x = card_model
    eager = make_serving_fn(model, qmode="intc", graph=False)
    before = graphed.launch_counts()
    eager(x[:8])
    after = graphed.launch_counts()
    one = {k: after[k] - before[k] for k in after}
    assert one["conv"] == sum(A0_TOY["num_blocks"]) + 1
    serve = make_serving_fn(model, qmode="intc")
    serve(x[:8])
    counted = graphed.launch_counts()
    assert serve.launches[((8, 32, 32, 3), torch.float32)] == one
    serve(x[:8])                 # a replay launches nothing on the host
    assert graphed.launch_counts() == counted


class _Syncing(torch.nn.Module):
    """The model, then a scale read back to the host: a host sync."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x, qmode="intc"):
        y = self.inner(x, qmode=qmode)
        return y / y.abs().max().item()


@pytest.mark.cuda
def test_host_sync_raises_and_serves_nothing(card_model):
    model, x = card_model
    serve = make_serving_fn(_Syncing(model), qmode="intc")
    with pytest.raises(graphed.CaptureError, match=r"\.item\(\)"):
        serve(x[:8])
    assert serve.launches == {}
    # the eager forward of the same module still runs where asked for
    y = make_serving_fn(_Syncing(model), qmode="intc", graph=False)(x[:8])
    assert y.shape == (8, CLASSES)


@pytest.mark.cuda
def test_sharded_model_refuses_a_graph_on_the_card(card_model):
    model, _ = _sharded(card_model[0])
    with pytest.raises(ValueError, match="pass graph=False"):
        make_serving_fn(model, qmode="intc")
    with pytest.raises(ValueError, match="pass graph=False"):
        InferenceEngine(model, batch_size=ENGINE_BATCH, qmode="intc")


@pytest.mark.cuda
def test_graphed_engine_equals_eager_engine(card_model):
    model, x = card_model
    eng = InferenceEngine(model, batch_size=ENGINE_BATCH, qmode="intc")
    eager = InferenceEngine(model, batch_size=ENGINE_BATCH, qmode="intc",
                            graph=False)
    assert eng.graphed is not None and eager.graphed is None
    with pytest.raises(RuntimeError, match="warmup"):
        eng.start()
    eng.warmup((32, 32, 3))
    assert len(eng.graphed.launches) == 1
    host = x.cpu().numpy()
    for n in (5, ENGINE_BATCH):
        assert torch.equal(eng.forward(host[:n]), eager.forward(host[:n]))
    eng.start()
    try:
        got = eng.submit(host[:3]).result(timeout=60)
    finally:
        eng.stop()
    assert np.array_equal(got, eager.forward(host[:3]).cpu().numpy())
    assert len(eng.graphed.launches) == 1
