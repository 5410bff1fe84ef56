"""ROADMAP C14 on trained weights: ``cifar_mobilenet_v2`` at
``tests/test_torch_mobile.py``'s width (1.0, 32×32, 10 classes) trained by
the JAX package's fp32 ``Trainer``, then the integer paths of both
packages compared, as that file's ``make_case`` does at random weights.

* Training: 96 SGD steps (batch 16, momentum 0.9, weight decay 1e-4, lr
  0.05 cosine after 16 warmup steps) on the seeded synthetic 10-class
  "hard" CIFAR, read at two stages of the one run: after 48 steps
  ("partly") and at the end ("trained").  Top-1 on 500 held-out images
  (the port's fp forward of the bridged weights, which agrees with JAX's
  within 1e-4): 15.2 % and 40.0 % measured, chance 10 %; the trained
  stage is held at 30 %.
* Both packages from each stage, as in ``make_case``: bench's W8A8
  scheme on the variables, JAX's calibration of the train form (two
  training batches, two observe passes), ``mobilenet_deploy``, the deploy
  form's calibration and ``prepare_deploy``; the port takes JAX's
  variables through ``load_jax_variables`` and runs its own
  ``prepare_deploy``.  On 8 held-out images, the deploy form's ``intc``
  and ``int`` logits and the train form's ``int`` logits are held within
  relative L2 2e-2 of JAX's: 3.61e-3, 1.68e-3, 2.32e-3 (partly) and
  7.33e-3, 7.95e-3, 5.80e-3 (trained) measured here, where
  ``tests/test_torch_mobile.py`` holds ``intc`` and train-form ``int`` at
  5e-2 at random weights (3.19e-2 and 2.02e-2 measured there).  The gap
  depends on the weights, not on how far they are trained: with STEPS =
  64 and WARMUP = 8 (14.0 % top-1) this file read 1.95e-2, 1.83e-2 and
  2.62e-2, with LR = 0.02 (26.2 %) 2.61e-2, 2.23e-2 and 1.73e-2.
* Where the gap starts: every deploy conv fed JAX's input is exact (no
  input code one apart, accumulators equal, epilogues within 1e-6) at
  both stages; every block fed JAX's input is within relative L2 2e-4
  (1.0e-4 measured) or, for a linear bottleneck's codes, at most one code
  apart on at most 2 of 49,152 values: a float tie inside a block.  Along
  the port's own chain the blocks' relative L2 from JAX's grows with
  depth, 4.2e-8 → 1.0e-4 (second block) → 3.7e-2 (last block) at the
  trained stage, and pooling brings the logits to 7.3e-3: ties amplified
  through the depth, no layer that departs.
"""
import numpy as np
import pytest
import torch

from dlmc_quant_torch.data.loaders import CIFAR10, CIFAR_MEAN, CIFAR_STD
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.chain import DeferredEpilogue, QuantizedTensor
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

from test_torch_mobile import (_jax, _jax_codes, _jax_intc, _jax_model, _np,
                               _port_model, _rel, _to_port)

torch.set_num_threads(1)

STEPS, BATCH, LR, WARMUP = 96, 16, 0.05, 16
CAL, COMPARE = 16, 8
HARD = {"synthetic_profile": "hard", "_n_classes": 10}
# the two stages of the one training: after HALF steps and after STEPS
HALF = 48
STAGES = ("partly", "trained")


@pytest.fixture(scope="module")
def stages():
    """One JAX training of the train form; at step HALF and at the end,
    the train-form variables, calibrated, and the deploy form calibrated
    and prepared in JAX and in the port; held-out images."""
    j = _jax()
    import optax
    from dlmc_quant_tpu.models import get_model as jax_get_model
    from dlmc_quant_tpu.parallel.mesh import make_mesh
    from dlmc_quant_tpu.training.schedulers import CosineDecayLR
    from dlmc_quant_tpu.training.trainer import Trainer

    class Snapshot(Trainer):
        def _on_step(self, epoch, batch_idx, batch=None):
            if batch_idx == HALF:
                # the step donates the state: copy it now
                self.half = _np(self.state.variables())

    train_l = CIFAR10(batch_size=BATCH, training=True,
                      n_samples=STEPS * BATCH, **HARD)
    fp = jax_get_model("cifar_mobilenet_v2", num_classes=10)
    x0 = j.jnp.asarray(next(iter(train_l))[0])
    v0 = j.jax.jit(fp.init)(j.jax.random.PRNGKey(0), x0)
    sched = CosineDecayLR(LR, total_steps=STEPS, warmup_steps=WARMUP)
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(sched, momentum=0.9))
    trainer = Snapshot(fp, v0, tx, sched, train_l, None,
                       config={"epochs": 1}, mesh=make_mesh(1))
    trainer.train()
    snapshots = {"partly": trainer.half,
                 "trained": _np(trainer.state.variables())}

    jm = _jax_model("mobilenet")
    fresh = _np(j.flax.core.unfreeze(j.jax.jit(jm.init)(
        j.jax.random.PRNGKey(1), x0)))
    cal = [x for _, (x, _) in zip(range(2), CIFAR10(
        batch_size=CAL, training=True, shuffle=False, **HARD))]
    eval_l = CIFAR10(batch_size=500, training=False, n_samples=500, **HARD)
    x_eval, y_eval = next(iter(eval_l))
    x_cal = j.jnp.asarray(cal[0])
    out = {}
    for stage, fp_vars in snapshots.items():
        # the JAX tool's warm start: the trained leaves over the fresh ones
        flat = j.flax.traverse_util.flatten_dict(fresh["params"])
        flat.update(j.flax.traverse_util.flatten_dict(fp_vars["params"]))
        v = {**fresh, "params": j.flax.traverse_util.unflatten_dict(flat),
             "batch_stats": fp_vars["batch_stats"]}
        v_cal = j.jax_calibrate(jm, v, [j.jnp.asarray(b) for b in cal],
                                observe_passes=2)
        jdm, dv = j.jax_mn_deploy(jm, v, j.jnp.zeros((1, 32, 32, 3)))
        dv = j.jdp.prepare_deploy(jdm, j.jax_calibrate(jdm, dv, [x_cal]),
                                  sample_input=x_cal)
        port = prepare_deploy(load_jax_variables(
            _port_model("mobilenet", deploy=True),
            _np({k: t for k, t in dv.items() if k != "qint"})))
        case = dict(stage=stage, j=j, jm=jm, v=v, v_cal=v_cal, jdm=jdm,
                    dv=dv, qint=_np(dv["qint"]), port=port,
                    x=x_eval[:COMPARE], x_eval=x_eval, y_eval=y_eval)
        x = j.jnp.asarray(case["x"])
        case["want_intc"], case["seen"] = _jax_intc(case, case["x"])
        case["want_int"] = np.asarray(jdm.apply(dv, x, qmode="int"))
        out[stage] = case
    return out


@pytest.fixture(scope="module")
def trained(stages):
    return stages["trained"]


def _top1(case) -> float:
    """The port's fp forward of the bridged train-form weights on the
    held-out images (agrees with JAX's within 1e-4)."""
    port = load_jax_variables(_port_model("mobilenet"), case["v"])
    with torch.no_grad():
        logits = port(torch.from_numpy(case["x_eval"]), qmode="fp")
    return float((logits.argmax(-1).numpy() == case["y_eval"]).mean())


def _deploy_rels(case):
    """Relative L2 of the port's deploy-form intc and int logits from
    JAX's on ``COMPARE`` held-out images."""
    x, port = case["x"], case["port"]
    rels = {}
    for qmode in ("intc", "int"):
        want = case[f"want_{qmode}"]
        with torch.no_grad():
            got = port(torch.from_numpy(x), qmode=qmode)
        assert got.shape == (COMPARE, 10) and bool(torch.isfinite(got).all())
        rels[qmode] = _rel(got, want)
    print(f"{case['stage']} cifar_mobilenet_v2, deploy form against JAX: "
          f"relative L2 intc {rels['intc']:.3e}, int {rels['int']:.3e}")
    return rels


def _train_form_rel(case) -> float:
    """Relative L2 of the port's train-form int logits from JAX's."""
    j, x = case["j"], case["x"]
    port = prepare_deploy(load_jax_variables(_port_model("mobilenet"),
                                             _np(case["v_cal"])))
    jv = j.jdp.prepare_deploy(case["jm"], case["v_cal"],
                              sample_input=j.jnp.asarray(x))
    want = case["jm"].apply(jv, j.jnp.asarray(x), qmode="int")
    with torch.no_grad():
        got = port(torch.from_numpy(x), qmode="int")
    rel = _rel(got, want)
    print(f"{case['stage']} cifar_mobilenet_v2, train form 'int' against "
          f"JAX: relative L2 {rel:.3e}")
    return rel


def test_trained_weights_are_above_chance(trained):
    top1 = _top1(trained)
    print(f"cifar_mobilenet_v2 after {STEPS} JAX SGD steps: held-out top-1 "
          f"{100 * top1:.1f} % (chance 10 %)")
    assert top1 >= 0.3
    # the images are the normalized hard CIFAR, not the uniform noise of
    # tests/test_torch_mobile.py
    assert np.allclose(trained["x_eval"].mean((0, 1, 2)),
                       ((0.5 - CIFAR_MEAN) / CIFAR_STD), atol=0.3)


def test_deploy_int_and_intc_logits_match_jax(trained):
    rels = _deploy_rels(trained)
    assert rels["intc"] < 2e-2 and rels["int"] < 2e-2


def test_train_form_int_logits_match_jax(trained):
    assert _train_form_rel(trained) < 2e-2


def test_partly_trained_logits_match_jax(stages):
    """The same net after HALF of its steps: its top-1 printed, its three
    logit gaps held as the trained stage's."""
    case = stages["partly"]
    print(f"cifar_mobilenet_v2 after {HALF} of {STEPS} JAX SGD steps: "
          f"held-out top-1 {100 * _top1(case):.1f} %")
    rels = _deploy_rels(case)
    assert rels["intc"] < 2e-2 and rels["int"] < 2e-2
    assert _train_form_rel(case) < 2e-2


@pytest.mark.parametrize("stage", STAGES)
def test_intc_convs_match_jax_on_its_inputs(stages, stage):
    """Every deploy conv of the trained net fed JAX's input, held as
    ``tests/test_torch_mobile.py`` holds them at random weights: its codes
    at most one code from JAX's (C2) and equal on codes inputs, its
    accumulator on JAX's codes exact, its epilogue exact on codes inputs
    and within 1e-6 elsewhere.  Prints how many codes each conv flips."""
    case = stages[stage]
    j, port, qint = case["j"], case["port"], case["qint"]
    seen = case["seen"]
    flips = {}
    for path, m in port.named_modules():
        if not isinstance(m, QConv):
            continue
        x_j, y_j = seen[path]
        node = qint
        for part in path.split("."):
            node = node[part]
        codes_j = _jax_codes(x_j, node)
        with torch.no_grad():
            codes, epi_scale, bias_eff, pad = m._int_input(_to_port(x_j))
            dq = np.abs(codes.numpy().astype(int) - codes_j.astype(int))
            assert dq.max() <= 1, path
            on_codes = isinstance(x_j, j.jchain.QuantizedTensor)
            if on_codes:
                assert dq.max() == 0, path
            flips[path] = int((dq > 0).sum())
            de = m.deferred(torch.from_numpy(np.array(codes_j)), epi_scale,
                            bias_eff, pad)
            if isinstance(de.acc, chain.PendingGemm):
                acc = de.acc.run(mode="int32").numpy()
            else:
                ones = torch.ones_like(epi_scale)
                acc = de.acc.run(ones, torch.zeros_like(ones),
                                 mode="f32").numpy()
            assert np.array_equal(acc, np.asarray(y_j.acc).astype(acc.dtype)
                                  ), path
            got = chain.materialize(de).numpy()
        want = np.asarray(j.jchain.materialize(
            j.jchain.DeferredEpilogue(y_j.acc, y_j.scale, y_j.bias)))
        assert np.array_equal(epi_scale.numpy(),
                              np.asarray(y_j.scale).reshape(-1)), path
        if on_codes:
            assert np.array_equal(got, want), path
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=path)
    print(f"{stage} cifar_mobilenet_v2, input codes one code from JAX's: "
          + ", ".join(f"{p} {n}" for p, n in flips.items() if n))


@pytest.mark.parametrize("stage", STAGES)
def test_intc_blocks_match_jax_on_its_inputs(stages, stage):
    """Every block fed JAX's input: a linear bottleneck's output codes at
    most one code from JAX's on at most 0.1 % of the values, any other
    block's deferred output within relative L2 2e-4 (a tie inside the
    block; module docstring).  Then the port's own chained forward block
    by block against JAX's, printed: where the whole-net gap starts and
    how it grows."""
    case = stages[stage]
    j, x, port, seen = case["j"], case["x"], case["port"], case["seen"]
    total = differ = 0
    worst = 0.0
    for name in port.block_names:
        x_j, y_j = seen[name]
        with torch.no_grad():
            out = getattr(port, name)(_to_port(x_j), qmode="intc")
        if isinstance(y_j, j.jchain.QuantizedTensor):
            assert isinstance(out, QuantizedTensor), name
            diff = np.abs(out.q.numpy().astype(int) - np.asarray(y_j.q, int))
            assert diff.max() <= 1, name
            total += diff.size
            differ += int((diff > 0).sum())
        else:
            assert isinstance(out, DeferredEpilogue), name
            with torch.no_grad():
                rel = _rel(chain.materialize(out),
                           j.jchain.materialize(y_j))
            assert rel <= 2e-4, (name, rel)
            worst = max(worst, rel)
    assert differ <= 1e-3 * total, (differ, total)
    outs = {}
    hooks = [getattr(port, name).register_forward_hook(
        lambda mod, args, out, name=name: outs.__setitem__(name, out))
        for name in port.block_names]
    with torch.no_grad():
        try:
            port(torch.from_numpy(x), qmode="intc")
        finally:
            for h in hooks:
                h.remove()
        drift = [(name, _rel(chain.materialize(outs[name]),
                             j.jchain.materialize(seen[name][1])))
                 for name in port.block_names]
    print(f"{stage} cifar_mobilenet_v2 blocks fed JAX's inputs: deferred "
          f"outputs within {worst:.2e}, {differ} of {total} codes one "
          "apart; the port's own chain against JAX's, block by block "
          "(relative L2): " + ", ".join(f"{name} {rel:.2e}"
                                         for name, rel in drift))
