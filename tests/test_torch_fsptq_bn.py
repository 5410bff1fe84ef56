"""``FSPTQTrainer.refresh_bn`` against the JAX package's
``FSPTQTrainer._refresh_bn(recalibrate_quantizers=True)``: what both
trainers do to a model with BatchNorm before reconstruction (the
accuracy protocol's cifar_resnet20 rows).

``CifarResNet(depth_n=1)`` (cifar_resnet20's stages, one block each) at
16×16, batch 4, the protocol's W8A8 FSPTQ scheme, BN statistics
perturbed; the port takes JAX's calibrated variables.  After the
refresh (BN statistics re-estimated in fake quant, then the quantizers
re-calibrated with one observe pass a batch):

* the running statistics within relative L2 1e-2 of JAX's, the stem's
  BN within 1e-4 (as ``tests/test_torch_resnet.py`` holds
  ``bn_recalibrate`` in ``'eval'``);
* every layer's ``wt_scale`` within 1e-6 of JAX's (the weights did not
  move), every conv's ``in_scale`` within 1e-4 and the head's within
  3e-2 of JAX's (its input, the pooled last block, moves with every BN
  statistic before it), while the refresh moved each of the seven input
  scales behind a BatchNorm by a factor of 1.7–3.8 (measured): without
  the re-calibration they would not meet JAX's.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dlmc_quant_tpu.models.resnet_cifar import CifarResNet as JCifarResNet
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_tpu.training import fsptq as jax_fsptq
from dlmc_quant_torch.models.resnet_cifar import BatchNorm, CifarResNet
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.layers import QLayer
from dlmc_quant_torch.training.fsptq import FSPTQTrainer
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

BATCH, SIZE = 4, 16
# the accuracy protocol's W8A8 (tools/accuracy_protocol.py: w_scheme(8))
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _images(seed):
    return np.random.default_rng(seed).random((BATCH, SIZE, SIZE, 3),
                                              dtype=np.float32)


def _leaf(tree, path, name):
    node = tree
    for part in path.split("."):
        node = node[part]
    return np.asarray(node[name])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_refresh_bn_matches_jax():
    jm = JCifarResNet(depth_n=1, scheme=jax_scheme(SCHEME))
    x = jnp.asarray(_images(0))
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(1), x))
    rng = np.random.default_rng(2)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.random(a.shape, dtype=np.float32),
        v["batch_stats"])
    batches = [_images(0), _images(1)]
    v_cal = _np(jax_calibrate(jm, v, [jnp.asarray(b) for b in batches],
                              observe_passes=2))
    tr = jax_fsptq.FSPTQTrainer(jm, v_cal, jm, v,
                                [jnp.asarray(b) for b in batches], iters=1)
    tr._refresh_bn(recalibrate_quantizers=True)
    want = _np(tr.variables)

    port = load_jax_variables(
        CifarResNet(depth_n=1, scheme=port_scheme(SCHEME)).eval(), v_cal)
    teacher = load_jax_variables(
        CifarResNet(depth_n=1, scheme=port_scheme(SCHEME)).eval(), _np(v))
    FSPTQTrainer(port, teacher, [torch.from_numpy(b) for b in batches],
                 iters=1).refresh_bn()

    got_all, want_all = [], []
    for path, m in port.named_modules():
        if isinstance(m, BatchNorm):
            for name, key in (("running_mean", "mean"),
                              ("running_var", "var")):
                w = _leaf(want["batch_stats"], path, key)
                got_all.append(getattr(m, name).numpy())
                want_all.append(w)
                if path == "bn1":
                    np.testing.assert_allclose(
                        got_all[-1], w, rtol=1e-4,
                        atol=1e-4 * np.abs(w).max(), err_msg=path)
    assert len(got_all) == 14
    assert _rel(np.concatenate(got_all), np.concatenate(want_all)) < 1e-2
    moved = 0
    for path, m in port.named_modules():
        if isinstance(m, QLayer):
            np.testing.assert_allclose(
                m.wt_scale.detach(), _leaf(want["params"], path, "wt_scale"),
                rtol=1e-6, err_msg=path)
            s_new = _leaf(want["params"], path, "in_scale")
            s_old = _leaf(v_cal["params"], path, "in_scale")
            # the head's input, the pooled output of the last block, moves
            # with every BN statistic before it
            np.testing.assert_allclose(
                m.in_scale.detach(), s_new,
                rtol=3e-2 if path == "linear" else 1e-4, err_msg=path)
            moved += float(s_new) / float(s_old) > 1.5
    assert moved == 7
