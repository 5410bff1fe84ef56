"""The port's serving engine (``dlmc_quant_torch.parallel.serving``) on the
CPU, case for case ``tests/test_parallel.py: TestServing``, held against
the JAX package's ``InferenceEngine``.

The model is cifar_resnet20 at W8A8 (FSPTQ, per-channel min/max weights,
per-tensor min/max inputs): JAX initialises, calibrates and deploys it on
seeded images (ReLU of a normal draw, as in the JAX tests), and the port
takes JAX's calibrated variables (``utils.jax_bridge.load_jax_variables``)
and builds its own integer plans.

* Every resolved future equals the rows of the port engine's direct
  ``forward`` of the same images bit for bit (asserted exactly, tighter
  than a 1e-6 relative bound): a step is a padded batch of the same
  shape, and the int path treats rows independently.
* The port engine's logits are within relative L2 2e-2 of the JAX
  engine's (``mesh=None``) on the same requests: the tolerance at which
  ``tests/test_torch_resnet.py`` holds the ``int`` logits.
* Lockstep: two in-process engines with unequal streams step only at
  multiples of ``consensus_every`` and the light one pads empty steps.
* An engine asked for ``cuda`` without a card raises.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.parallel import mesh as mesh_lib
from dlmc_quant_torch.parallel.serving import (InferenceEngine,
                                               measure_throughput)
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

W8A8 = {"quantization_type": "FSPTQ",
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": 8, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}}}
IMAGE = (32, 32, 3)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9))


@pytest.fixture(scope="module")
def w8a8():
    """JAX's calibrated and deployed cifar_resnet20 W8A8, and the port's
    model from JAX's calibrated variables."""
    import flax
    import jax
    import jax.numpy as jnp

    from dlmc_quant_tpu.models import get_model as jax_get_model
    from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
    from dlmc_quant_tpu.quant.deploy import prepare_deploy as jax_prepare
    from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate

    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((16,) + IMAGE), 0).astype(np.float32)
    jm = jax_get_model("cifar_resnet20", num_classes=10,
                       scheme=jax_scheme(W8A8))
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:8]))
    v = jax_calibrate(jm, v, [jnp.asarray(x[:8])])
    cal = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(v))
    jv = jax_prepare(jm, v, sample_input=jnp.asarray(x[:8]))
    port = get_model("cifar_resnet20", device="cpu", num_classes=10,
                     scheme=scheme_from_dict(W8A8))
    prepare_deploy(load_jax_variables(port, cal))
    return {"x": x, "jm": jm, "jv": jv, "port": port}


def _jax_engine(case, **kw):
    from dlmc_quant_tpu.parallel.serving import \
        InferenceEngine as JInferenceEngine
    return JInferenceEngine(case["jm"], case["jv"], mesh=None, qmode="int",
                            **kw)


def test_engine_forward_pads(w8a8):
    x = w8a8["x"]
    mesh = mesh_lib.make_mesh(1, axes=("data", "model"), shape=(1, 1))
    try:
        eng = InferenceEngine(w8a8["port"], mesh, batch_size=8, qmode="int",
                              device="cpu")
        assert not eng.lockstep
        out = eng.forward(x[:5])
    finally:
        mesh_lib.shutdown()
    assert out.shape == (5, 10)
    want = np.asarray(_jax_engine(w8a8, batch_size=8).forward(x[:5]))
    assert _rel(out, want) < 2e-2


def test_continuous_batching_resolves_futures(w8a8):
    x = w8a8["x"]
    eng = InferenceEngine(w8a8["port"], batch_size=8, qmode="int",
                          max_wait_ms=20, device="cpu")
    eng.warmup(IMAGE)
    eng.start()
    try:
        futs = [eng.submit(x[i:i + 2]) for i in range(0, 8, 2)]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    assert not eng._thread.is_alive()
    assert all(o.shape == (2, 10) for o in outs)
    assert eng.stats["batches"] <= 2         # batched together
    direct = eng.forward(x[:8]).numpy()
    np.testing.assert_array_equal(np.concatenate(outs), direct)
    jeng = _jax_engine(w8a8, batch_size=8, max_wait_ms=20)
    jeng.warmup(IMAGE)
    jeng.start()
    try:
        jouts = [jeng.submit(x[i:i + 2]).result(timeout=120)
                 for i in range(0, 8, 2)]
    finally:
        jeng.stop()
    assert _rel(np.concatenate(outs), np.concatenate(jouts)) < 2e-2


def test_throughput_measure_runs():
    model = get_model("cifar_resnet20", device="cpu", num_classes=10)
    eng = InferenceEngine(model, batch_size=4, qmode="fp", device="cpu")
    assert measure_throughput(eng, IMAGE, n_batches=3) > 0


def test_oversize_and_overflow_requests(w8a8):
    """A request above the device batch is chunked; one that would
    overflow the current batch is deferred whole, never truncated."""
    x = w8a8["x"]
    eng = InferenceEngine(w8a8["port"], batch_size=8, qmode="int",
                          max_wait_ms=10, device="cpu")
    eng.warmup(IMAGE)
    eng.start()
    try:
        f_big = eng.submit(x[:12])                       # > batch_size
        f_mix = [eng.submit(x[12 + i:12 + i + 2]) for i in range(0, 4, 2)]
        big = f_big.result(timeout=120)
        mix = [f.result(timeout=120) for f in f_mix]
    finally:
        eng.stop()
    assert big.shape == (12, 10)
    assert all(o.shape == (2, 10) for o in mix)
    np.testing.assert_array_equal(big[:8], eng.forward(x[:8]).numpy())
    np.testing.assert_array_equal(big[8:], eng.forward(x[8:12]).numpy())
    np.testing.assert_array_equal(np.concatenate(mix),
                                  eng.forward(x[12:16]).numpy())
    want = np.asarray(_jax_engine(w8a8, batch_size=8).forward(x[:8]))
    assert _rel(big[:8], want) < 2e-2


def test_lockstep_unequal_streams_no_deadlock(w8a8):
    """Two lockstep engines fed unequal streams both step unconditionally
    (empty steps padded), resolve every future and exit at a consensus
    step index (serving.py's module docstring)."""
    x = w8a8["x"]
    model = get_model("cifar_resnet20", device="cpu", num_classes=10,
                      generator=torch.Generator().manual_seed(1))
    engines = [InferenceEngine(model, batch_size=4, qmode="fp",
                               lockstep=True, tick_ms=5, consensus_every=4,
                               device="cpu") for _ in range(2)]
    for e in engines:
        e.warmup(IMAGE)
        e.start()
    try:
        futs0 = [engines[0].submit(x[i:i + 3]) for i in range(0, 9, 3)]
        futs1 = [engines[1].submit(x[:2])]
        outs0 = [f.result(timeout=120) for f in futs0]
        outs1 = [f.result(timeout=120) for f in futs1]
    finally:
        for e in engines:
            e.stop()
    assert all(o.shape == (3, 10) for o in outs0)
    assert outs1[0].shape == (2, 10)
    for e in engines:
        assert not e._thread.is_alive()
        # consensus exit only at multiples of consensus_every
        assert e.steps % e.consensus_every == 0 and e.steps > 0
    # the light engine padded empty steps rather than blocking
    assert engines[1].stats["pad_waste"] > 0
    np.testing.assert_array_equal(outs0[0], engines[0].forward(x[:3]).numpy())


def test_dispatcher_error_reaches_the_futures(w8a8):
    """A failing step resolves its futures with the error; the engine
    serves nothing in its place."""
    eng = InferenceEngine(w8a8["port"], batch_size=8, qmode="int",
                          max_wait_ms=5, device="cpu")
    eng.warmup(IMAGE)
    eng.start()
    try:
        # images of rank 2 where the model takes (H, W, C)
        fut = eng.submit(np.zeros((2, 32, 96), np.float32))
        with pytest.raises(Exception):
            fut.result(timeout=120)
        good = eng.submit(w8a8["x"][:2]).result(timeout=120)
    finally:
        eng.stop()
    np.testing.assert_array_equal(good, eng.forward(w8a8["x"][:2]).numpy())


def test_engine_asked_for_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model("cifar_resnet20", device="cpu", num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, batch_size=4, device="cuda")
