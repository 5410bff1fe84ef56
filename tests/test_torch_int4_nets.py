"""W4 execution of whole nets in the port against the JAX package, on the
CPU at toy size (the kernels' plain versions), and BASELINE config #4's
entry through to chained int8.

* A narrow MobileOne (one block a stage, widths 16…128, deploy form,
  nonzero biases: hazard C8) under bench.py's all-W4 scheme (per-channel
  4-bit weights on every layer, the stem and the head too; per-tensor
  unsigned 8-bit inputs), calibrated and prepared by JAX, carried into
  the port: every conv fed JAX's input gives codes at most one code from
  JAX's (C2) and, on JAX's codes, JAX's int32 accumulator exactly; every
  weight stays nibble-packed; the ``intc`` and ``int`` logits within
  relative L2 5e-2 of JAX's (C14's bound for whole nets at random
  weights, where one flipped code moves every layer after it).
* A one-block-a-stage CifarResNet under the LSQ W4A4 config's scheme
  (``conv1`` and ``linear`` excluded), after 3 SGD steps of JAX's
  ``'train'`` forward from its LSQ calibration, prepared by both: each of
  the 6 quantized convs fed JAX's input gives codes at most one code from
  JAX's and, on JAX's codes, JAX's output within 1e-6 (its accumulator
  exact: one code of error is a scale step, far above 1e-6); the
  ``int`` logits within relative L2 5e-2 of JAX's (4-bit codes flip on
  float differences and move the layers after them).
* ``python -m dlmc_quant_torch.examples.FSPTQuant`` on config #4 cut to
  32×32, 8 calibration and 8 eval images and one iteration a block, in a
  subprocess on one thread: the stage0 and linear overrides resolve to 8
  bits, the rest to 4, and the run reaches the chained int8 evaluation.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dlmc_quant_tpu.models.mobileone import MobileOne as JMobileOne
from dlmc_quant_tpu.models.resnet_cifar import CifarResNet as JCifarResNet
from dlmc_quant_tpu.quant import chain as jchain
from dlmc_quant_tpu.quant import deploy as jdp
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_tpu.training.losses import cross_entropy
from dlmc_quant_torch.models.mobileone import MobileOne
from dlmc_quant_torch.models.resnet_cifar import CifarResNet
from dlmc_quant_torch.ops.cuda.nibbles import W4
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv, QLayer
from dlmc_quant_torch.utils.config import read_yaml, write_yaml
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG_4 = REPO / "examples" / "configs" / "FSPTQ_mobileone_s1_w4a8.yaml"
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
BENCH_W4 = {"quantization_type": "FSPTQ",
            "weight": {"enable": True, "type": "minmax_channel",
                       "args": {"n_bits": 4, "signed": True}},
            "input": {"enable": True, "type": "minmax_tensor",
                      "args": {"n_bits": 8, "signed": False}}}
LSQ_W4A4 = {"quantization_type": None,
            "weight": {"enable": True, "type": "LSQ",
                       "args": {"n_bits": 4, "signed": True}},
            "input": {"enable": True, "type": "LSQ",
                      "args": {"n_bits": 4, "signed": False}},
            "exclude_layers": ["conv1", "linear"]}
MOBILEONE_SMALL = dict(num_blocks=(1, 1, 1, 1),
                       width_multipliers=(0.25, 0.25, 0.25, 0.25),
                       num_conv_branches=2, num_classes=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _images(seed, n, size):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def _jax_conv_inputs(jm, v, x, qmode):
    """Every JAX QConv's (input, output) of one forward, by module path."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JQConv) \
                and context.method_name == "__call__":
            seen[".".join(context.module.scope.path)] = (args[0], out)
        return out

    with flax.linen.intercept_methods(grab):
        logits = jm.apply(v, jnp.asarray(x), qmode=qmode)
    return np.asarray(logits), seen


def _jax_codes(x, plan, qmin, qmax):
    """The int8 codes a JAX QConv computes from its input ``x``."""
    if isinstance(x, jchain.QuantizedTensor):
        return np.asarray(x.q)
    if isinstance(x, jchain.DeferredEpilogue):
        return np.asarray(jchain.fold_quantize(
            x, plan["in_inv_scale"], plan["in_qbias"], qmin, qmax))
    q, _ = jdp.act_to_int8(jnp.asarray(x), plan["in_scale"],
                           plan["in_offset"], qmin, qmax,
                           inv_s_x=plan["in_inv_scale"],
                           qbias=plan["in_qbias"])
    return np.asarray(q)


def _to_port(t):
    if isinstance(t, jchain.DeferredEpilogue):
        return chain.DeferredEpilogue(
            torch.from_numpy(np.array(t.acc)),
            torch.from_numpy(np.array(t.scale)).reshape(-1),
            torch.from_numpy(np.array(t.bias)).reshape(-1), t.relu,
            t.clamp_hi)
    return torch.from_numpy(np.array(t))


def _plan(qint, path):
    node = qint
    for part in path.split("."):
        node = node[part]
    return node


def _check_convs(port, qint, seen, act_range):
    """Each port conv fed JAX's input: codes within one of JAX's, and on
    JAX's codes its output (the accumulator's epilogue) within 1e-6 of
    JAX's.  Returns the number of convs checked."""
    n = 0
    for path, m in port.named_modules():
        if not (isinstance(m, QConv) and m.cfg is not None
                and path in seen):
            continue
        x_j, y_j = seen[path]
        plan = _plan(qint, path)
        qmin, qmax = act_range
        codes_j = _jax_codes(x_j, plan, qmin, qmax)
        with torch.no_grad():
            codes = m._input_codes(_to_port(x_j)).numpy()
            assert np.abs(codes.astype(int) - codes_j.astype(int)).max() \
                <= 1, path
            de = m.deferred(torch.from_numpy(np.array(codes_j)))
            assert de.acc.int4 and de.acc.weight.dtype == W4, path
            got = chain.materialize(de).numpy()
        if isinstance(y_j, jchain.DeferredEpilogue):
            if isinstance(de.acc, chain.PendingGemm):
                acc = de.acc.run(mode="int32").numpy()
            else:
                ones = torch.ones_like(de.scale)
                acc = de.acc.run(ones, torch.zeros_like(ones),
                                 mode="f32").numpy()
            assert np.array_equal(acc, np.asarray(y_j.acc).astype(
                acc.dtype)), path
            y_j = jchain.materialize(y_j)
        want = np.asarray(y_j)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=path)
        n += 1
    return n


def test_mobileone_all_w4_matches_jax():
    size, batch = 64, 2
    x = _images(0, batch, size)
    jm = JMobileOne(**MOBILEONE_SMALL, scheme=jax_scheme(BENCH_W4),
                    deploy=True)
    v = flax.core.unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                            jnp.asarray(x)))
    rng = np.random.default_rng(2)
    flat = flax.traverse_util.flatten_dict(v["params"])
    for k, leaf in flat.items():
        if k[-1] == "bias":               # a fused model's biases (C8)
            flat[k] = (0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
    v["params"] = flax.traverse_util.unflatten_dict(flat)
    v = jax_calibrate(jm, v, [jnp.asarray(_images(1, batch, size)),
                              jnp.asarray(x)], observe_passes=2)
    vd = jdp.prepare_deploy(jm, v, sample_input=jnp.asarray(x))
    port = load_jax_variables(
        MobileOne(**MOBILEONE_SMALL, scheme=port_scheme(BENCH_W4),
                  deploy=True).eval(),
        _np({k: t for k, t in vd.items() if k != "qint"}))
    prepare_deploy(port)
    for m in port.modules():
        if isinstance(m, QLayer):
            assert not hasattr(m, "w_int"), m.path
    xt = _images(3, batch, size)
    want, seen = _jax_conv_inputs(jm, vd, xt, "intc")
    assert _check_convs(port, _np(vd["qint"]), seen, (-128, 127)) == 9
    with torch.no_grad():
        got = port(torch.from_numpy(xt), qmode="intc")
        got_int = port(torch.from_numpy(xt), qmode="int")
    assert got.shape == (batch, 10) and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 5e-2
    want_int = np.asarray(jm.apply(vd, jnp.asarray(xt), qmode="int"))
    assert _rel(got_int, want_int) <= 5e-2


def test_lsq_w4a4_resnet_after_steps_matches_jax():
    size, batch = 32, 8
    x = _images(0, batch, size)
    y = np.random.default_rng(1).integers(0, 10, batch)
    jm = JCifarResNet(depth_n=1, scheme=jax_scheme(LSQ_W4A4))
    v = flax.core.unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    v = flax.core.unfreeze(jax_calibrate(jm, v, [jnp.asarray(x)]))

    @jax.jit
    def step(params, rest):
        def loss(p):
            out, upd = jm.apply({"params": p, **rest}, jnp.asarray(x),
                                train=True, qmode="train",
                                mutable=["batch_stats", "qstate"])
            return cross_entropy(out, jnp.asarray(y)), upd
        (_, upd), g = jax.value_and_grad(loss, has_aux=True)(params)
        params = jax.tree_util.tree_map(lambda p, d: p - 0.05 * d, params, g)
        return params, {**rest, **upd}

    params = v.pop("params")
    for _ in range(3):
        params, v = step(params, v)
    v = flax.core.unfreeze({"params": params, **v})
    vd = jdp.prepare_deploy(jm, v, sample_input=jnp.asarray(x))
    port = load_jax_variables(
        CifarResNet(depth_n=1, scheme=port_scheme(LSQ_W4A4)).eval(),
        _np({k: t for k, t in vd.items() if k != "qint"}))
    prepare_deploy(port)
    xt = _images(3, batch, size)
    want, seen = _jax_conv_inputs(jm, vd, xt, "int")
    assert _check_convs(port, _np(vd["qint"]), seen, (0, 15)) == 6
    with torch.no_grad():
        got = port(torch.from_numpy(xt), qmode="int")
        assert torch.equal(port(torch.from_numpy(xt), qmode="intc"), got)
    assert got.shape == (batch, 10) and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 5e-2


def test_config_4_entry_reaches_chained_int8(tmp_path):
    cfg = read_yaml(CONFIG_4)
    cfg["save_dir"] = str(tmp_path / "saved")
    for name in ("calibration", "eval"):
        cfg["dataloaders"][name]["args"].update(
            data_dir=str(tmp_path / "no_imagenet"), n_samples=8,
            batch_size=8, size=32)
    cfg["reconstruction"].update(epochs=1, batch_size=8)
    path = tmp_path / "cfg.yaml"
    write_yaml(cfg, path)
    scheme = port_scheme(cfg["quantization"])
    bits = {p: scheme.resolve(p).weight.n_bits
            for p in ("stage0.reparam", "linear", "stage1_0_dw.reparam",
                      "stage4_0_pw.reparam")}
    assert bits == {"stage0.reparam": 8, "linear": 8,
                    "stage1_0_dw.reparam": 4, "stage4_0_pw.reparam": 4}
    run = subprocess.run(
        [sys.executable, "-m", "dlmc_quant_torch.examples.FSPTQuant",
         "-c", str(path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=ONE_THREAD)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout + run.stderr
    assert "converted MobileOne to deploy form" in out
    assert "reconstructing 44 blocks" in out, out[-2000:]
    assert "RepAPQ chained int8 (intc): {" in out, out[-2000:]
