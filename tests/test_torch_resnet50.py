"""The port's Bottleneck and ImageNet-stem ResNets against the JAX package,
on the same weights (carried over by ``load_jax_variables``) and the same
seeded numpy images: ``cifar_resnet50`` at 32×32 and ``resnet18`` (the
ImageNet 7×7/s2 stem and its max-pool) at 64×64, batch 2, the bench's
W8A8 scheme (FSPTQ, per-channel int8 weights, per-tensor unsigned int8
activations).

* ``load_jax_variables`` leaves no JAX leaf unused (it raises otherwise)
  and ``resnet_deploy`` folds ``conv3↔bn3`` as JAX does: deploy-form fp
  logits within rtol 2e-4 (atol 2e-4 of the largest logit: float sums in
  another order), BN statistics perturbed (ROADMAP C8).
* ``intc`` on JAX's calibrated and prepared variables, layer by layer fed
  JAX's inputs (quantized nets are chaotic across frameworks at depth):
  every conv's int32 accumulator on JAX's input codes equal to JAX's;
  its f32 epilogue equal where the port's plan values equal JAX's bit for
  bit, else within 1e-6 relative; its input codes at most one code apart
  (C2), equal where the folded affine is identical; the pooled stem
  accumulator equal; each block's output codes at most one code apart on
  at most 0.1 % of the values; logits within relative L2 2e-2.
* The launches of one port ``intc`` request (wrapper calls, counted on the
  CPU as on the card): the ImageNet stem and its pool stay pending on the
  chain, and each of the first block's two consumers runs them with its
  own epilogue in one ``int8_stem_pool`` launch.
* The 7×7/s2 stem's SAME pads equal flax's; the ``resnet50`` parameter
  count equals JAX's (``jax.eval_shape``, no init).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.models.fuse import resnet_deploy as jax_resnet_deploy
from dlmc_quant_tpu.quant import chain as jchain
from dlmc_quant_tpu.quant import deploy as jdp
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.deploy import prepare_deploy as jax_prepare
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import resnet_deploy
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingGemm,
                                          PendingWideConv, QuantizedTensor,
                                          qmaxpool, qrelu)
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

BATCH = 2
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}
# arch → (image size, classes, launches of one intc request: 3x3 convs,
# GEMMs, im2cols, stem convs + pools).  cifar_resnet50: the 3x3 stem runs
# for each of its two consumers, 16 conv2s; 16 conv1 + 16 conv3 + 4
# downsample GEMMs.  resnet18: 16 3x3 convs; 3 downsample GEMMs; the 7x7
# stem and its pool in an int8_stem_pool launch for each of its two
# consumers (layer1_0's conv1, codes; its identity shortcut, f32).
ARCHS = {"cifar_resnet50": (32, 10, (18, 36, 0, 0)),
         "resnet18": (64, 1000, (16, 3, 0, 2))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _images(seed, size):
    return np.random.default_rng(seed).random((BATCH, size, size, 3),
                                              dtype=np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _node(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


@pytest.fixture(scope="module", params=list(ARCHS))
def case(request):
    """JAX train form (BN statistics perturbed) → resnet_deploy →
    calibrate → prepare_deploy; the port's deploy twin on JAX's variables
    (and its own resnet_deploy of the bridged train form)."""
    arch = request.param
    size, classes, launches = ARCHS[arch]
    jm = jax_get_model(arch, num_classes=classes, scheme=jax_scheme(SCHEME))
    x = jnp.asarray(_images(0, size))
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(1), x))
    rng = np.random.default_rng(2)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.random(a.shape, dtype=np.float32),
        v["batch_stats"])
    jdm, dv = jax_resnet_deploy(jm, v, jnp.zeros((1, size, size, 3)))
    dv = jax_prepare(jdm, jax_calibrate(jdm, dv, [x]), sample_input=x)
    train = load_jax_variables(
        get_model(arch, device="cpu", num_classes=classes,
                  scheme=port_scheme(SCHEME)), _np(v))
    port = load_jax_variables(
        get_model(arch, device="cpu", num_classes=classes, deploy=True,
                  scheme=port_scheme(SCHEME)),
        _np({k: t for k, t in dv.items() if k != "qint"}))
    prepare_deploy(port)
    return dict(arch=arch, size=size, launches=launches, jdm=jdm, v=v,
                dv=dv, qint=_np(dv["qint"]), train=train, port=port)


def test_deploy_fp_matches_jax(case):
    """resnet_deploy on both sides (conv3↔bn3 included): fp logits."""
    x = _images(3, case["size"])
    want = np.asarray(case["jdm"].apply(case["dv"], jnp.asarray(x),
                                        qmode="fp"))
    dep = resnet_deploy(case["train"])
    with torch.no_grad():
        got = dep(torch.from_numpy(x), qmode="fp").numpy()
        train = case["train"](torch.from_numpy(x), qmode="fp").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())
    np.testing.assert_allclose(got, train, rtol=2e-4,
                               atol=2e-4 * np.abs(train).max())
    n_bn3 = sum(name.endswith("bn3") for name, _ in
                case["train"].named_modules())
    assert n_bn3 == (16 if case["arch"] == "cifar_resnet50" else 0)


def _jax_intc(case, x):
    """JAX's intc forward of ``x``: logits, and every QConv's and block's
    (input, output) by module path."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            path = ".".join(context.module.scope.path)
            if isinstance(context.module, JQConv) or path.startswith(
                    "layer") and "." not in path:
                seen[path] = (args[0], out)
        return out

    with flax.linen.intercept_methods(grab):
        logits = case["jdm"].apply(case["dv"], jnp.asarray(x), qmode="intc")
    return np.asarray(logits), seen


def _to_port(t):
    """A JAX chain value as the port's."""
    if isinstance(t, jchain.QuantizedTensor):
        return QuantizedTensor(torch.from_numpy(np.array(t.q)),
                               float(t.scale), float(t.bias))
    if isinstance(t, jchain.DeferredEpilogue):
        return DeferredEpilogue(
            torch.from_numpy(np.array(t.acc)),
            torch.from_numpy(np.array(t.scale)).reshape(-1),
            torch.from_numpy(np.array(t.bias)).reshape(-1), t.relu)
    return torch.from_numpy(np.array(t))


def _jax_codes(x, plan):
    """The int8 codes JAX's QConv computed from its input ``x``."""
    if isinstance(x, jchain.QuantizedTensor):
        return np.asarray(x.q)
    if isinstance(x, jchain.DeferredEpilogue):
        return np.asarray(jchain.fold_quantize(
            x, plan["in_inv_scale"], plan["in_qbias"], -128, 127))
    q, _ = jdp.act_to_int8(x, plan["in_scale"], plan["in_offset"], 0, 255,
                           inv_s_x=plan["in_inv_scale"],
                           qbias=plan["in_qbias"])
    return np.asarray(q)


def test_intc_convs_match_jax_on_its_inputs(case):
    _, seen = _jax_intc(case, _images(3, case["size"]))
    port, qint = case["port"], case["qint"]
    convs = [(p, m) for p, m in port.named_modules() if isinstance(m, QConv)]
    assert len(convs) == (53 if case["arch"] == "cifar_resnet50" else 20)
    same_params = 0
    for path, m in convs:
        x_j, y_j = seen[path]
        codes_j = _jax_codes(x_j, _node(qint, path))
        with torch.no_grad():
            codes, epi_scale, bias_eff, pad = m._int_input(_to_port(x_j))
            # the input codes: C2's one code, none where the fold is the same
            dq = np.abs(codes.numpy().astype(int) - codes_j.astype(int))
            assert dq.max() <= 1, path
            if isinstance(x_j, jchain.QuantizedTensor):
                assert dq.max() == 0, path
            de = m.deferred(torch.from_numpy(np.array(codes_j)), epi_scale,
                            bias_eff, pad)
            acc_j = np.asarray(y_j.acc)
            if isinstance(de.acc, (PendingGemm, PendingWideConv)):
                acc = de.acc.run(mode="int32").numpy()
                assert np.array_equal(acc, acc_j), path
            else:   # the conv kernel has no int32 mode: f32(acc) exactly
                ones = torch.ones_like(epi_scale)
                acc = de.acc.run(ones, torch.zeros_like(ones), mode="f32")
                assert np.array_equal(acc.numpy(), acc_j.astype(np.float32)), \
                    path
            got = chain.materialize(de).numpy()
        want = np.asarray(jchain.materialize(y_j))
        scale_j = np.asarray(y_j.scale).reshape(-1)
        bias_j = np.asarray(y_j.bias).reshape(-1)
        if np.array_equal(epi_scale.numpy(), scale_j) and np.array_equal(
                bias_eff.numpy(), bias_j):
            same_params += 1
            assert np.array_equal(got, want), path
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=path)
    # most plans agree bit for bit (XLA's jitted prepare_deploy may
    # contract an fma and move an ulp)
    assert same_params >= len(convs) // 2, (same_params, len(convs))


@pytest.mark.parametrize("case", ["resnet18"], indirect=True)
def test_pooled_stem_matches_jax(case):
    """The stem on JAX's input codes, ReLU-flagged and pooled on the
    chain (int8_stem_pool's conv + pool): its int32 run equals the pooled
    accumulator JAX hands the first block, and the first conv's codes,
    folded in the stem's launch, equal JAX's fold_quantize of it."""
    _, seen = _jax_intc(case, _images(3, case["size"]))
    x_j, _ = seen["conv1"]
    codes_j = _jax_codes(x_j, case["qint"]["conv1"])
    stem = case["port"].conv1
    want = seen["layer1_0"][0]
    assert isinstance(want, jchain.DeferredEpilogue) and want.relu
    with torch.no_grad():
        de = stem.deferred(torch.from_numpy(np.array(codes_j)))
        assert isinstance(de.acc, PendingWideConv)
        pooled = qmaxpool(qrelu(de), (3, 3), (2, 2), ((1, 1), (1, 1)))
        acc = pooled.acc.run(mode="int32")
        codes = case["port"].layer1_0.conv1._input_codes(pooled)
    assert pooled.relu and acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), np.asarray(want.acc))
    want_codes = _jax_codes(want, _node(case["qint"], "layer1_0.conv1"))
    assert codes.dtype == torch.int8
    assert np.array_equal(codes.numpy(), want_codes)


def test_intc_blocks_and_logits_match_jax(case):
    """Every block fed JAX's input: output codes on JAX's grid, at most one
    code apart (C2) on at most 0.1 % of the values; the logits."""
    x = _images(3, case["size"])
    want, seen = _jax_intc(case, x)
    port = case["port"]
    total = differ = 0
    for name in port.block_names:
        x_j, y_j = seen[name]
        with torch.no_grad():
            out = getattr(port, name)(_to_port(x_j), qmode="intc")
        assert isinstance(out, QuantizedTensor) and out.q.dtype == torch.int8
        assert (out.scale, out.bias) == (float(y_j.scale), float(y_j.bias))
        diff = np.abs(out.q.numpy().astype(int) - np.asarray(y_j.q, int))
        assert diff.max() <= 1, name
        total += diff.size
        differ += int((diff > 0).sum())
    assert differ <= 1e-3 * total, (differ, total)
    with torch.no_grad():
        got = port(torch.from_numpy(x), qmode="intc")
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) < 2e-2


class _Counter:
    """Counts calls of the kernel wrappers where the chain reaches them
    (on the CPU they run the plain versions)."""

    KINDS = {"conv": "int8_conv3x3", "gemm": "int8_gemm",
             "im2col": "int8_im2col", "stem_pool": "int8_stem_pool"}

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.KINDS, 0)
        for kind, attr in self.KINDS.items():
            monkeypatch.setattr(chain, attr, self._wrap(kind,
                                                        getattr(chain, attr)))

    def _wrap(self, kind, fn):
        def wrapped(*args, **kw):
            self.n[kind] += 1
            return fn(*args, **kw)
        return wrapped


def test_intc_request_launches(case, monkeypatch):
    count = _Counter(monkeypatch)
    with torch.no_grad():
        case["port"](torch.from_numpy(_images(4, case["size"])),
                     qmode="intc")
    assert tuple(count.n.values()) == case["launches"]


@pytest.mark.parametrize("size", [224, 64, 65])
def test_stem_same_pads_equal_flax(size):
    want = jax.lax.padtype_to_pads((size, size), (7, 7), (2, 2), "SAME")
    stem = QConv(3, 64, 7, 2, "SAME")
    assert stem.spatial_pads(size, size) == tuple(map(tuple, want))
    if size == 224:
        assert stem.spatial_pads(size, size) == ((2, 3), (2, 3))


def test_resnet50_parameter_count_equals_jax():
    jm = jax_get_model("resnet50", num_classes=1000)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    want = sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model("resnet50", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == 25557032
