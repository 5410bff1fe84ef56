"""The port's ``BiDict`` and checkpoint import
(``dlmc_quant_torch/utils/{bidict,torch_import}.py``) against the JAX
package's (``dlmc_quant_tpu/utils/{bidict,torch_import}.py``, whose own
test is tests/test_torch_import.py), on ``.pth`` files the tests write
with ``torch.save``.

* ``BiDict``: the reverse lookup ``d[:value]`` and every update, as the
  JAX package's ``BiDict`` does them.
* A plain PyTorch conv/BN/linear net saved as ``{"state_dict": ...}``:
  the port's twin (``QConv``, the NHWC ``BatchNorm``, ``QDense``) loads it
  and gives the source net's outputs (rtol 1e-4, atol 1e-5, as the JAX
  test), and JAX's import of the same file gives the port's outputs; the
  name map is JAX's and works in both directions.
* A stream mismatch raises (strict), a shape mismatch raises, and
  ``strict=False`` loads what matches.
* The port's own cifar_resnet20 state_dict, a reference-style checkpoint
  (OIHW, (out, in), ``module.`` prefixes), loads into a fresh port model
  and into JAX's, with equal outputs; the zoo's module order, which the
  import's streams follow, is its forward's call order (forward pre-hooks
  through ``count_ops.traced``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.utils.bidict import BiDict as JBiDict
from dlmc_quant_tpu.utils.torch_import import \
    build_name_mapping as jax_name_mapping
from dlmc_quant_tpu.utils.torch_import import \
    import_torch_checkpoint as jax_import
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.repvgg import RepVGG
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.quant.layers import QConv, QDense
from dlmc_quant_torch.utils.bidict import BiDict
from dlmc_quant_torch.utils.count_ops import (BATCHNORMS, CONVS, DENSES,
                                              traced)
from dlmc_quant_torch.utils.torch_import import (_port_streams,
                                                 build_name_mapping,
                                                 import_torch_checkpoint)

torch.set_num_threads(1)


def test_bidict_as_jax():
    ops = [("set", "c", 3), ("set", "a", 5), ("del", "b", None),
           ("set", "d", 2)]
    ours, theirs = BiDict({"a": 1, "b": 2}), JBiDict({"a": 1, "b": 2})
    assert ours[:2] == theirs[:2] == "b"
    for op, k, v in ops:
        for d in (ours, theirs):
            if op == "set":
                d[k] = v
            else:
                del d[k]
        assert dict(ours) == dict(theirs)
        for value in dict(ours).values():
            assert ours[:value] == theirs[:value] == ours.inverse(value)
    with pytest.raises(KeyError):
        ours[:1]                       # "a" moved from 1 to 5
    with pytest.raises(TypeError):
        ours[:3] = "x"


class TorchNet(nn.Module):
    """The JAX test's torch net (NCHW)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(8)
        self.conv2 = nn.Conv2d(8, 16, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(16)
        self.fc = nn.Linear(16, 10)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        return self.fc(x.mean(dim=(2, 3)))


class PortNet(nn.Module):
    """Its twin in the port's modules (NHWC)."""

    def __init__(self):
        super().__init__()
        self.conv1 = QConv(3, 8, 3, 1, 1, use_bias=False)
        self.bn1 = BatchNorm(8)
        self.conv2 = QConv(8, 16, 3, 1, 1, use_bias=False)
        self.bn2 = BatchNorm(16)
        self.fc = QDense(16, 10)

    def forward(self, x, qmode="eval"):
        x = torch.relu(self.bn1(self.conv1(x, qmode=qmode)))
        x = torch.relu(self.bn2(self.conv2(x, qmode=qmode)))
        return self.fc(x.mean(dim=(1, 2)), qmode=qmode)


def _flax_net():
    import flax.linen as fnn

    from dlmc_quant_tpu.quant.layers import QConv as JQConv
    from dlmc_quant_tpu.quant.layers import QDense as JQDense

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False, qmode="eval"):
            x = JQConv(8, (3, 3), use_bias=False, name="conv1")(x)
            x = fnn.relu(fnn.BatchNorm(use_running_average=not train,
                                       name="bn1")(x))
            x = JQConv(16, (3, 3), use_bias=False, name="conv2")(x)
            x = fnn.relu(fnn.BatchNorm(use_running_average=not train,
                                       name="bn2")(x))
            return JQDense(10, name="fc")(jnp.mean(x, axis=(1, 2)))

    return Net()


def _saved(tmp_path, wrap=True):
    torch.manual_seed(0)
    tnet = TorchNet().eval()
    with torch.no_grad():
        tnet.bn1.running_mean.uniform_(-0.5, 0.5)
        tnet.bn1.running_var.uniform_(0.5, 1.5)
        tnet.bn2.weight.uniform_(0.5, 1.5)
    path = tmp_path / "m.pth"
    sd = tnet.state_dict()
    torch.save({"state_dict": sd} if wrap else sd, path)
    return tnet, path


def test_outputs_match_torch_and_jax(tmp_path):
    tnet, path = _saved(tmp_path)
    port = import_torch_checkpoint(path, PortNet().eval())
    x = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        want = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    fnet = _flax_net()
    v = jax_import(path, fnet, fnet.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    np.testing.assert_allclose(got, np.asarray(fnet.apply(v, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_name_mapping_bidirectional(tmp_path):
    tnet, _ = _saved(tmp_path)
    sd = {k: v.detach() for k, v in tnet.state_dict().items()}
    m = build_name_mapping(PortNet(), sd)
    assert m["conv1"] == "conv1" and m["fc"] == "fc"
    assert m[:"conv2"] == "conv2" and m[:"bn1"] == "bn1"
    fnet = _flax_net()
    want = jax_name_mapping(
        fnet.init(jax.random.PRNGKey(0), jnp.ones((1, 16, 16, 3))),
        {k: v.numpy() for k, v in sd.items()})
    assert dict(m) == dict(want)


def test_stream_mismatch_raises(tmp_path):
    _, path = _saved(tmp_path, wrap=False)
    model = get_model("cifar_resnet20", device="cpu")
    with pytest.raises(ValueError, match="stream mismatch"):
        import_torch_checkpoint(path, model)
    # not strict: the streams zip, and the first conv's shape differs
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch_checkpoint(path, model, strict=False)


def test_not_strict_loads_what_matches(tmp_path):
    tnet, path = _saved(tmp_path)

    class Longer(PortNet):
        def __init__(self):
            super().__init__()
            self.extra = QConv(16, 16, 3, 1, 1)

    port = import_torch_checkpoint(path, Longer(), strict=False)
    assert torch.equal(port.conv2.weight, tnet.conv2.weight)
    assert torch.equal(port.bn2.running_var, tnet.bn2.running_var)
    with pytest.raises(ValueError, match="stream mismatch"):
        import_torch_checkpoint(path, Longer())


def test_resnet20_checkpoint_round_trip(tmp_path):
    src = get_model("cifar_resnet20", device="cpu", num_classes=10,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for bn in src.modules():
            if isinstance(bn, nn.BatchNorm2d):
                bn.running_mean.uniform_(-0.2, 0.2)
                bn.running_var.uniform_(0.5, 1.5)
    path = tmp_path / "r20.pth"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in src.state_dict().items()}}, path)
    dst = import_torch_checkpoint(path, get_model(
        "cifar_resnet20", device="cpu", num_classes=10))
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = src(torch.from_numpy(x)).numpy()
        got = dst(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    jm = jax_get_model("cifar_resnet20", num_classes=10)
    v = jax_import(path, jm, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["cifar_resnet20", "cifar_mobilenet_v2",
                                  "MobileOne_S0", "repvgg", "repvgg_g4"])
def test_module_order_is_call_order(name):
    if name == "repvgg":
        model = RepVGG(num_blocks=(1, 2, 2, 1), width_multiplier=(0.5,) * 4,
                       num_classes=10, use_se=True).eval()
    elif name == "repvgg_g4":
        model = RepVGG(num_blocks=(1, 2, 2, 1), width_multiplier=(0.625,) * 4,
                       num_classes=10,
                       override_groups_map={i: 4 for i in (2, 4)}).eval()
    else:
        model = get_model(name, device="cpu", num_classes=10)
    x = torch.zeros(1, 32, 32, 3)
    streams = [p for s in _port_streams(model) for p, _ in s]
    called = []

    def pre(path, module, args):
        if path not in called:
            called.append(path)

    with traced(model, CONVS + DENSES + BATCHNORMS, pre=pre):
        model(x)
    assert sorted(streams) == sorted(called)
    for kind in _port_streams(model):
        paths = [p for p, _ in kind]
        assert paths == [p for p in called if p in paths], name
