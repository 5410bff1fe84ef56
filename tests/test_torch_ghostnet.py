"""GhostNet in the port against the JAX package, on the same weights and
images (numpy seeds), with bench.py's W8A8 scheme (FSPTQ, per-channel
int8 weights, per-tensor unsigned int8 activations), 64×64, batch 2, 10
classes.

JAX's variable trees come from ``jax.eval_shape`` of its ``init`` (no
JAX init runs: an eager one takes ~100 s on the CPU), every leaf drawn
from a numpy seed (kernels He-normal, BN affine and statistics
perturbed, the quantizer state as JAX initializes it), and are carried
into the port by ``load_jax_variables``.  JAX's forwards are jitted.

* Parameter counts equal JAX's (GhostNet-1.0 in (4e6, 6.5e6)).
* Width 0.5 and 1.0, train form: ``fp`` logits and, after JAX's
  calibration, ``eval`` logits within rtol 1e-4, atol 1e-5 of the largest
  logit.
* Width 0.5, deploy form: ``ghostnet_deploy`` gives JAX's
  ``ghostnet_deploy`` kernels and biases within 1e-6 (relative to each
  tensor's largest value) and the train form's ``fp`` logits within rtol
  2e-3, atol 3e-5 of the largest logit (tests/test_chain.py:232-235);
  after JAX's calibration and ``prepare_deploy``: every conv and dense
  layer fed JAX's ``intc`` input gives JAX's input codes within one code
  (C2; the count of codes one apart printed, 0 expected), its int32
  accumulator exactly and its output within 1e-6 relative; each block's
  ``QBlockOutput`` with a float32 trunk, fed JAX's terms, JAX's codes
  within one, for each shortcut kind (a pending ReLU-free 1×1, a
  ``QuantizedTensor``, the stem's ReLU-flagged output); each block fed
  JAX's input to it, its output codes within one of JAX's on at most
  0.1 % of them; ``int`` and ``intc`` logits within relative L2 2e-2 of
  JAX's; JAX's own criterion ``rel_intc < max(1.5·rel_int, 0.02)``
  against ``fp`` (tests/test_chain.py:241-247) on the port's logits; and
  one ``intc`` request's launches: 2 conv (the stem, for the first
  block's codes and for its shortcut's f32 value), 70 GEMM (32 primaries
  twice: folded into ``cheap``'s codes and in f32 for the concat; 5
  ``shortcut_pw`` in int32 mode; ``conv_head``) and 41 depthwise (4 of
  them 5×5).
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models.fuse import ghostnet_deploy as jax_ghostnet_deploy
from dlmc_quant_tpu.models.ghostnet import GhostNet as JGhostNet
from dlmc_quant_tpu.ops.observers import StreamingState
from dlmc_quant_tpu.quant import chain as jchain
from dlmc_quant_tpu.quant import deploy as jdeploy
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import QBlockOutput as JQBlockOutput
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import QDense as JQDense
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_torch.models.fuse import ghostnet_deploy
from dlmc_quant_torch.models.ghostnet import GhostNet
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingDwConv,
                                          PendingGemm, QuantizedTensor)
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv, QDense
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables
from dlmc_quant_torch.utils.launches import LaunchRecorder

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 2, 64, 10
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}
LAUNCHES = dict(conv=2, gemm=70, im2col=0, stem_pool=0, dwconv=41,
                window_sum=0)


def images(seed, size=SIZE):
    return np.random.default_rng(seed).random((BATCH, size, size, 3),
                                              dtype=np.float32)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def variables(model, size, seed):
    """``model``'s variable tree at ``size``², its shapes from
    ``jax.eval_shape`` and its leaves from a numpy seed: kernels
    He-normal, conv and dense biases and BN offsets N(0, 0.1²), BN scales
    in [0.8, 1.2], BN means N(0, 0.1²) and variances in [0.5, 1.5], the
    quantizers' scales 1 and their state as JAX's ``init`` gives it."""
    shapes = flax.core.unfreeze(jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)))
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict

    def param(path, leaf):
        name, shape = path[-1], leaf.shape
        if name == "kernel":
            std = np.sqrt(1.0 / np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if name == "scale":
            return (0.8 + 0.4 * rng.random(shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return np.ones(shape, np.float32)     # in_scale, wt_scale, out_scale

    def stat(path, leaf):
        if path[-1] == "mean":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.5 + rng.random(leaf.shape)).astype(np.float32)

    def state(leaf):
        if isinstance(leaf, StreamingState):
            shape = leaf.min.shape
            return StreamingState(np.full(shape, np.inf, np.float32),
                                  np.full(shape, -np.inf, np.float32),
                                  np.zeros(shape, np.float32),
                                  np.zeros((), np.int32))
        return np.zeros(leaf.shape, leaf.dtype)

    unflat = flax.traverse_util.unflatten_dict
    out = {"params": unflat({p: param(p, l) for p, l in
                             flat(shapes["params"]).items()})}
    if "batch_stats" in shapes:
        out["batch_stats"] = unflat({p: stat(p, l) for p, l in
                                     flat(shapes["batch_stats"]).items()})
    if "qstate" in shapes:
        out["qstate"] = unflat({p: state(l) for p, l in
                                flat(shapes["qstate"]).items()})
    return out


def capture(model, qmode: str, kinds, jit: bool = True):
    """A forward of ``model`` in ``qmode``, jitted unless ``jit`` is False:
    the logits, and every module of ``kinds``' (or named ``blockN``'s)
    call arguments and output by module path.  An integer forward whose
    layers are compared with the port's runs eagerly: XLA's jit contracts
    the folded quantize into a fused multiply-add, and the codes then
    differ from the eager ``fold_quantize`` that the tests recompute."""
    def run(variables, x):
        seen = {}

        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            path = ".".join(context.module.scope.path)
            if context.method_name == "__call__" and (
                    isinstance(context.module, kinds)
                    or (path.startswith("block") and "." not in path)):
                seen[path] = (args, out)
            return out

        with flax.linen.intercept_methods(grab):
            logits = model.apply(variables, x, qmode=qmode)
        return logits, seen
    return jax.jit(run) if jit else run


def to_port(t):
    """A JAX chain value as the port's."""
    if isinstance(t, jchain.QuantizedTensor):
        return QuantizedTensor(torch.from_numpy(np.array(t.q)),
                               float(t.scale), float(t.bias))
    if isinstance(t, jchain.DeferredEpilogue):
        return DeferredEpilogue(
            torch.from_numpy(np.array(t.acc)),
            torch.from_numpy(np.array(t.scale)).reshape(-1),
            torch.from_numpy(np.array(t.bias)).reshape(-1), t.relu,
            t.clamp_hi)
    return torch.from_numpy(np.array(t))


def node(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def jax_codes(x, plan):
    """The int8 codes a JAX layer computed from its input ``x``."""
    if isinstance(x, jchain.QuantizedTensor):
        return np.asarray(x.q)
    if isinstance(x, jchain.DeferredEpilogue):
        return np.asarray(jchain.fold_quantize(
            x, plan["in_inv_scale"], plan["in_qbias"], -128, 127))
    q, _ = jdeploy.act_to_int8(jnp.asarray(x), plan["in_scale"],
                               plan["in_offset"], 0, 255,
                               inv_s_x=plan["in_inv_scale"],
                               qbias=plan["in_qbias"])
    return np.asarray(q)


def materialized(t):
    return np.asarray(jchain.materialize(t))


@functools.lru_cache(maxsize=None)
def train_form(width: float):
    """JAX's train form at ``width`` on seeded variables: its ``fp``
    logits, its calibration on the first images and its ``eval``
    logits."""
    jm = JGhostNet(num_classes=CLASSES, width=width,
                   scheme=jax_scheme(SCHEME))
    v = variables(jm, SIZE, seed=int(10 * width))
    x = jnp.asarray(images(0))
    fp = jax.jit(lambda v, x: jm.apply(v, x, qmode="fp"))(v, x)
    v_cal = jax_calibrate(jm, v, [x])
    ev = jax.jit(lambda v, x: jm.apply(v, x, qmode="eval"))(v_cal, x)
    return dict(width=width, jm=jm, v=v, x=images(0), fp=np.asarray(fp),
                v_cal=np_tree(v_cal), eval=np.asarray(ev))


def port_model(width, deploy=False):
    return GhostNet(num_classes=CLASSES, width=width, deploy=deploy,
                    scheme=port_scheme(SCHEME)).eval()


@pytest.fixture(scope="module")
def ghost():
    return deploy_case()


@functools.lru_cache(maxsize=None)
def deploy_case():
    """Width 0.5: JAX's ghostnet_deploy of the train form, calibrated and
    prepared; its jitted ``fp``, ``int`` and ``intc`` forwards with every
    layer's and block's inputs and outputs; the port's twin on the same
    variables, prepared."""
    t = train_form(0.5)
    x = jnp.asarray(t["x"])
    dm, dv = jax_ghostnet_deploy(t["jm"], t["v"], example_input=x[:1])
    fp = jax.jit(lambda v, x: dm.apply(v, x, qmode="fp"))(dv, x)
    dv = jdeploy.prepare_deploy(dm, jax_calibrate(dm, dv, [x]),
                                sample_input=x)
    kinds = (JQConv, JQDense, JQBlockOutput)
    logits_int, _ = capture(dm, "int", kinds)(dv, x)
    logits_intc, seen = capture(dm, "intc", kinds, jit=False)(dv, x)
    port = load_jax_variables(port_model(0.5, deploy=True),
                              np_tree({k: t for k, t in dv.items()
                                       if k != "qint"}))
    prepare_deploy(port)
    return dict(t=t, dm=dm, dv=np_tree({k: t for k, t in dv.items()
                                        if k != "qint"}),
                qint=np_tree(dv["qint"]), fp=np.asarray(fp),
                int=np.asarray(logits_int), intc=np.asarray(logits_intc),
                seen=seen, port=port)


@pytest.mark.parametrize("width", [0.5, 1.0])
def test_parameter_counts_match_jax(width):
    j = JGhostNet(num_classes=1000, width=width)
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, SIZE, SIZE, 3),
                                                 jnp.float32))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        got = sum(p.numel() for p in GhostNet(width=width).parameters())
    assert got == want
    if width == 1.0:
        assert 4e6 < got < 6.5e6, got


def close(got, want, rtol=1e-4, atol=1e-5) -> bool:
    """Within ``rtol``, and ``atol`` of the largest value."""
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and bool(np.allclose(
        got, want, rtol=rtol, atol=atol * np.abs(want).max()))


def port_layers(port, x, qmode):
    """The port's logits of its own forward, and each quantized layer's
    (input, output), in forward order."""
    seen, hooks = {}, []
    for name, m in port.named_modules():
        if isinstance(m, (QConv, QDense)):
            hooks.append(m.register_forward_hook(
                lambda mod, a, o, name=name: seen.__setitem__(
                    name, (chain.materialize(a[0]).numpy().copy(),
                           chain.materialize(o).numpy().copy()))))
    try:
        with torch.no_grad():
            logits = port(torch.from_numpy(x), qmode=qmode).numpy()
    finally:
        for h in hooks:
            h.remove()
    return logits, seen


def hold_eval(port, model, variables, x, want):
    """The ``eval`` logits within rtol 1e-4, atol 1e-5 of the largest of
    JAX's; else a tie flipped (C14), and it is named: every quantized
    layer fed JAX's input to it (JAX's jitted forward) gives JAX's output
    within 1e-5 of its largest value, or, where that input has values
    within 1e-3 of a step of a rounding midpoint (a tie that the two
    compilers' float ops may round either way), within relative L2 1e-3;
    and the first layer whose own input codes differ from those of JAX's
    input to it has them at most one apart, each within 1e-3 of a step of
    a rounding midpoint.  Returns the flip or None."""
    logits, own = port_layers(port, x, "eval")
    if close(logits, want):
        return None
    _, seen = capture(model, "eval", (JQConv, JQDense))(variables,
                                                         jnp.asarray(x))

    def ties(path, x):
        v = np.asarray(x, np.float64) / float(
            port.get_submodule(path).in_scale.detach())
        return np.abs(v - np.floor(v) - 0.5) < 1e-3

    for path in own:
        (x_j, *_), y_j = seen[path]
        with torch.no_grad():
            got = port.get_submodule(path)(to_port(x_j), qmode="eval")
        want_j = np.asarray(y_j)
        if np.abs(got.numpy() - want_j).max() > 1e-5 * np.abs(want_j).max():
            assert ties(path, x_j).any() and rel(got, want_j) <= 1e-3, path
    for path in own:
        m = port.get_submodule(path)
        s = float(m.in_scale.detach())
        mine = np.round(own[path][0] / np.float32(s))
        theirs = np.round(np.asarray(seen[path][0][0]) / np.float32(s))
        differ = mine != theirs
        if differ.any():
            assert np.abs(mine - theirs).max() <= 1, path
            assert ties(path, seen[path][0][0])[differ].all(), path
            return path, int(differ.sum())
    raise AssertionError(f"eval logits differ by {rel(logits, want)} and "
                         "no tie flipped")


@pytest.mark.parametrize("width", [0.5, 1.0])
def test_train_form_fp_and_eval_match_jax(width):
    """The train form's ``fp`` logits, and its ``eval`` logits after JAX's
    calibration (or, where a tie flips, the layers one by one: at width
    0.5 one input code of block1.ghost2.primary lies on a tie and moves the
    logits by ~1e-2, measured on the CPU)."""
    t = train_form(width)
    x = torch.from_numpy(t["x"])
    with torch.no_grad():
        fp = load_jax_variables(port_model(width), t["v"])(x, qmode="fp")
    assert fp.shape == (BATCH, CLASSES) and close(fp, t["fp"])
    flip = hold_eval(load_jax_variables(port_model(width), t["v_cal"]),
                     t["jm"], t["v_cal"], t["x"], t["eval"])
    print(f"ghostnet x{width} eval: tie flipped at {flip}")


def test_deploy_fold_matches_jax(ghost):
    t = ghost["t"]
    train = load_jax_variables(port_model(0.5), t["v"])
    dep = ghostnet_deploy(train)
    jparams = ghost["dv"]["params"]
    n = 0
    for path, m in dep.named_modules():
        if isinstance(m, (QConv, QDense)):
            kern = node(jparams, path)["kernel"]
            kern = np.transpose(kern, (3, 2, 0, 1) if kern.ndim == 4
                                else (1, 0))
            for got, want in ((m.weight, kern),
                              (m.bias, node(jparams, path)["bias"])):
                np.testing.assert_allclose(
                    got.detach().numpy(), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max(), err_msg=path)
            n += 1
    assert n == 96
    x = torch.from_numpy(t["x"])
    with torch.no_grad():
        got = dep(x, qmode="fp").numpy()
    for want in (t["fp"], ghost["fp"]):
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=3e-5 * np.abs(want).max())


def test_layers_fed_jax_inputs(ghost):
    """Every conv and dense layer of the deploy form fed JAX's ``intc``
    input: its input codes within one of JAX's (0 expected), its int32
    accumulator on JAX's codes exact, its output within 1e-6 relative."""
    port, seen, qint = ghost["port"], ghost["seen"], ghost["qint"]
    layers = [(p, m) for p, m in port.named_modules()
              if isinstance(m, (QConv, QDense))]
    off_by_one = total = 0
    dw = 0
    for path, m in layers:
        (x_j, *_), y_j = seen[path]
        if isinstance(m, QDense):
            with torch.no_grad():
                qmode = "int" if ".se." in path else "intc"
                got = chain.materialize(m(to_port(x_j), qmode=qmode))
            assert rel(got, materialized(y_j)) <= 1e-6, path
            continue
        codes_j = jax_codes(x_j, node(qint, path))
        with torch.no_grad():
            codes, epi_scale, bias_eff, pad = m._int_input(to_port(x_j))
            dq = np.abs(codes.numpy().astype(int) - codes_j.astype(int))
            assert dq.max() <= 1, path
            off_by_one += int((dq > 0).sum())
            total += dq.size
            de = m.deferred(torch.from_numpy(np.array(codes_j)), epi_scale,
                            bias_eff, pad)
            if isinstance(de.acc, PendingGemm):
                acc = de.acc.run(mode="int32").numpy()
            else:
                dw += isinstance(de.acc, PendingDwConv)
                ones = torch.ones_like(epi_scale)
                acc = de.acc.run(ones, torch.zeros_like(ones),
                                 mode="f32").numpy()
            assert np.array_equal(acc, np.asarray(y_j.acc).astype(acc.dtype)
                                  ), path
            got = chain.materialize(de).numpy()
        want = materialized(jchain.DeferredEpilogue(y_j.acc, y_j.scale,
                                                    y_j.bias))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=path)
    print(f"ghostnet x0.5: {off_by_one} of {total} input codes one apart")
    assert dw == 41 and len(layers) == 96


def test_block_outputs_with_a_float_trunk(ghost):
    """Each block's QBlockOutput fed JAX's terms (the ghost module's f32
    concat and the shortcut) and each block fed JAX's input to it."""
    port, seen = ghost["port"], ghost["seen"]
    kinds = set()
    total = differ = 0
    for name in port.block_names:
        (y_j, r_j), q_j = seen[f"{name}.out_q"]
        assert isinstance(q_j, jchain.QuantizedTensor)
        assert not isinstance(y_j, (jchain.DeferredEpilogue,
                                    jchain.QuantizedTensor))
        if isinstance(r_j, jchain.QuantizedTensor):
            kinds.add("codes")
        else:
            kinds.add("stem" if r_j.relu else "1x1")
        block = getattr(port, name)
        with torch.no_grad():
            out = block.out_q(to_port(y_j), to_port(r_j), qmode="intc")
        assert (out.scale, out.bias) == (float(q_j.scale), float(q_j.bias))
        assert np.abs(out.q.numpy().astype(int)
                      - np.asarray(q_j.q, int)).max() <= 1, name
        (x_j,), b_j = seen[name]
        with torch.no_grad():
            whole = block(to_port(x_j), qmode="intc")
        diff = np.abs(whole.q.numpy().astype(int) - np.asarray(b_j.q, int))
        assert diff.max() <= 1, name
        total += diff.size
        differ += int((diff > 0).sum())
    assert kinds == {"codes", "1x1", "stem"}
    assert differ <= 1e-3 * total, (differ, total)


def test_int_and_intc_logits_match_jax(ghost):
    x = torch.from_numpy(ghost["t"]["x"])
    port = ghost["port"]
    with torch.no_grad():
        got = {q: port(x, qmode=q).numpy() for q in ("fp", "int", "intc")}
    for qmode in ("int", "intc"):
        assert np.isfinite(got[qmode]).all()
        assert rel(got[qmode], ghost[qmode]) < 2e-2, qmode
    # tests/test_chain.py:241-247's criterion, on the port's logits
    rel_int, rel_c = rel(got["int"], got["fp"]), rel(got["intc"], got["fp"])
    assert rel_c < max(1.5 * rel_int, 0.02), (rel_c, rel_int)


def test_request_launches(ghost):
    with torch.no_grad(), LaunchRecorder() as rec:
        ghost["port"](torch.from_numpy(images(4)), qmode="intc")
    assert rec.counts() == LAUNCHES
    windows = [args[1].shape[0] for kind, args, _, _ in rec.calls
               if kind == "dwconv"]
    assert windows.count(25) == 4 and windows.count(9) == 37
