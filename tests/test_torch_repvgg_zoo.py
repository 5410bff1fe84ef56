"""The rest of the RepVGG family against the JAX package: the grouped
g2/g4 variants and D2se's SE blocks, at toy sizes (32×32, batch 2, 10
classes), weights and inputs from numpy seeds, JAX's variables bridged.

Models: ``num_blocks=(1, 2, 2, 1)`` at widths 0.625 with the g4 map (the
grouped blocks 2, 4 and 6 have Cg = 10, 20, 40: Cg % 16 != 0) and at 0.25
with the g2 map (Cg = 8, 16, 32); ``num_blocks=(1, 1, 1, 1)`` at widths
0.5 with SE blocks (C/16 = 2, 2, 4, 8, 16).  The BN statistics, scales
and biases are perturbed, as in tests/test_torch_repvgg_slice.py.

* train form, fp: within rtol 1e-5 (atol 1e-5 for entries near 0);
* ``repvgg_fuse``: kernels and biases (grouped, SE) within 1e-6 relative
  (atol 1e-6 near 0);
* the FSPTQ W8A8 scheme calibrated by JAX (deploy form after JAX's
  ``repvgg_fuse``; and the train form), bridged, ``prepare_deploy`` on
  both sides: the train form's fake-quant ``'eval'`` within rtol 1e-5,
  and its ``'int'`` (JAX's runs ``'intc'`` as ``'int'``, each branch's
  conv materialized, BN in float32) and the deploy form's ``'int'`` and
  ``'intc'`` logits within relative L2 1e-4 of JAX's ``'int'``;
* each grouped conv of the deploy form fed JAX's own input codes: the
  int32 accumulator exact, the f32 output within 1e-5 relative, the next
  layer's codes equal where both plans' epilogue values are equal, else
  at most one apart (hazard C2);
* all fourteen factories registered, and the parameter counts of A1,
  B1g2 and D2se equal JAX's (JAX's through ``jax.eval_shape`` at 32×32,
  the port's on the ``meta`` device): no full-size model is built.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.models.fuse import repvgg_fuse as jax_repvgg_fuse
from dlmc_quant_tpu.models.repvgg import (RepVGG as JRepVGG,
                                          _G2_MAP as J_G2, _G4_MAP as J_G4)
from dlmc_quant_tpu.quant import chain as jchain
from dlmc_quant_tpu.quant import deploy as jdeploy
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import repvgg_fuse
from dlmc_quant_torch.models.registry import _REGISTRY
from dlmc_quant_torch.models.repvgg import _G2_MAP, _G4_MAP, RepVGG
from dlmc_quant_torch.ops.cuda.int8_conv import int8_conv3x3_plain
from dlmc_quant_torch.quant.chain import materialize, qrelu
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv, QDense
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 2, 32, 10
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}
CASES = {
    "g4": dict(num_blocks=(1, 2, 2, 1), width_multiplier=(0.625,) * 4,
               gmap="g4"),
    "g2": dict(num_blocks=(1, 2, 2, 1), width_multiplier=(0.25,) * 4,
               gmap="g2"),
    "se": dict(num_blocks=(1, 1, 1, 1), width_multiplier=(0.5,) * 4,
               use_se=True),
}
# JAX's calibrate caches its jitted passes by model: a hashable map
J_MAPS = {"g2": flax.core.FrozenDict(J_G2), "g4": flax.core.FrozenDict(J_G4)}
P_MAPS = {"g2": _G2_MAP, "g4": _G4_MAP}
NEW_FACTORIES = ("RepVGG_A1", "RepVGG_A2", "RepVGG_B0", "RepVGG_B1",
                 "RepVGG_B1g2", "RepVGG_B1g4", "RepVGG_B2", "RepVGG_B2g2",
                 "RepVGG_B2g4", "RepVGG_B3", "RepVGG_B3g2", "RepVGG_B3g4",
                 "RepVGG_D2se")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _kwargs(case, maps):
    kw = dict(CASES[case])
    gmap = kw.pop("gmap", None)
    if gmap:
        kw["override_groups_map"] = maps[gmap]
    return kw


def _jax_model(case, **kw):
    return JRepVGG(num_classes=CLASSES, **_kwargs(case, J_MAPS), **kw)


def _port_model(case, **kw):
    return RepVGG(num_classes=CLASSES, **_kwargs(case, P_MAPS),
                  **kw).eval()


def _images(seed):
    return np.random.default_rng(seed).random((BATCH, SIZE, SIZE, 3),
                                              dtype=np.float32)


def _perturbed(v, seed):
    """BN statistics, scales and biases moved off their initial values."""
    rng = np.random.default_rng(seed)
    perturb = lambda a: (a + 0.3 * rng.random(a.shape)).astype(np.float32)
    v["batch_stats"] = jax.tree_util.tree_map(perturb, v["batch_stats"])
    for blk in v["params"].values():
        for bn in blk.values():
            if "scale" in bn:
                bn["scale"], bn["bias"] = perturb(bn["scale"]), \
                    perturb(bn["bias"])
    return v


def _overlay(tmpl, src):
    """``src``'s leaves over ``tmpl`` (a quantized model's fresh variables:
    its quantizer leaves stay)."""
    out = dict(tmpl)
    for k, v in src.items():
        out[k] = _overlay(tmpl.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _grouped_blocks(case):
    model = _port_model(case, deploy=True)
    return [n for n in model.block_names
            if getattr(model, n).reparam.groups > 1]


def _jax_layers(model, variables, x, qmode):
    """JAX's logits, and every QConv's, QDense's and BatchNorm's (input,
    output) by module path, eager (as the JAX package's own parity tests
    run it)."""
    from dlmc_quant_tpu.quant.layers import QConv as JQConv, QDense as JQDense
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and isinstance(
                context.module, (JQConv, JQDense, flax.linen.BatchNorm)):
            seen[".".join(context.module.scope.path)] = (
                np.array(jchain.materialize(args[0])),
                np.array(jchain.materialize(out)))
        return out

    with flax.linen.intercept_methods(grab):
        logits = model.apply(variables, x, qmode=qmode)
    return np.asarray(logits), seen


@pytest.fixture(scope="module", params=sorted(CASES))
def zoo(request):
    """JAX's side of one tiny model: the train form with perturbed BN, its
    fp and fused forms; the scheme calibrated and prepared on the train
    form (``'eval'`` and ``'int'`` logits) and on the fused deploy form
    (``'int'`` logits and the ``'intc'`` forward with every block's output
    captured, and each conv's input codes)."""
    case = request.param
    x = jnp.asarray(_images(0))
    train = _jax_model(case)
    v = _perturbed(_np(jax.jit(train.init)(jax.random.PRNGKey(1), x)), 2)
    fp = np.asarray(train.apply(v, x, qmode="fp"))
    dmodel, dv = jax_repvgg_fuse(train, v, x)
    dv = _np(dv)

    scheme = jax_scheme(SCHEME)
    qtrain = dataclasses.replace(train, scheme=scheme)
    tv = _np(qtrain.init(jax.random.PRNGKey(0), x))
    tv["params"] = _overlay(tv["params"], v["params"])
    tv["batch_stats"] = v["batch_stats"]
    tv = _np(jax_calibrate(qtrain, jax.tree_util.tree_map(jnp.asarray, tv),
                           [x]))
    t_eval, t_eval_io = _jax_layers(qtrain, tv, x, "eval")
    tq = jdeploy.prepare_deploy(qtrain, tv, sample_input=x)
    t_int, t_int_io = _jax_layers(qtrain, tq, x, "int")

    qdeploy = dataclasses.replace(dmodel, scheme=scheme)
    qv = _np(qdeploy.init(jax.random.PRNGKey(0), x))
    qv["params"] = _overlay(qv["params"], dv["params"])
    qv = jax_calibrate(qdeploy, jax.tree_util.tree_map(jnp.asarray, qv), [x])
    qi = jdeploy.prepare_deploy(qdeploy, qv, sample_input=x)
    d_int = np.asarray(qdeploy.apply(qi, x, qmode="int"))
    y, state = qdeploy.apply(qi, x, qmode="intc",
                             capture_intermediates=True,
                             mutable=["intermediates"])
    port = _port_model(case, deploy=True)
    names = list(port.block_names)
    qint = qi["qint"]
    p0 = qint["stage0"]["reparam"]
    codes = [jdeploy.act_to_int8(x, p0["in_scale"], p0["in_offset"], 0, 255,
                                 inv_s_x=p0["in_inv_scale"],
                                 qbias=p0["in_qbias"])[0]]
    outs = [state["intermediates"][name]["__call__"][0] for name in names]
    for de, name in zip(outs, names[1:]):
        p = qint[name]["reparam"]
        if isinstance(de, jchain.DeferredEpilogue):
            codes.append(jchain.fold_quantize(de, p["in_inv_scale"],
                                              p["in_qbias"], -128, 127))
        else:      # an SE block closed the chain: its f32 output
            codes.append(jdeploy.act_to_int8(
                de, p["in_scale"], p["in_offset"], 0, 255,
                inv_s_x=p["in_inv_scale"], qbias=p["in_qbias"])[0])
    return {"case": case, "x": np.array(x), "v": v, "fp": fp, "dv": dv,
            "tv": tv, "t_eval": t_eval, "t_int": t_int,
            "io": {"eval": t_eval_io, "int": t_int_io},
            "qv": _np(qv), "qint": _np(qint), "d_int": d_int,
            "d_intc": np.asarray(y), "names": names,
            "codes": [np.asarray(c) for c in codes],
            # each conv's own deferred output (its int32 accumulator)
            "acc": [jax.tree_util.tree_map(
                np.asarray, state["intermediates"][n]["reparam"]["__call__"][0])
                for n in names]}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


def test_train_form_fp_matches_jax(zoo):
    port = load_jax_variables(_port_model(zoo["case"]), zoo["v"])
    with torch.no_grad():
        y = port(torch.from_numpy(zoo["x"]), qmode="fp").numpy()
    np.testing.assert_allclose(y, zoo["fp"], rtol=1e-5, atol=1e-5)


def test_fuse_matches_jax(zoo):
    port = load_jax_variables(_port_model(zoo["case"]), zoo["v"])
    fused = repvgg_fuse(port)
    assert fused.deploy and fused.use_se == port.use_se
    for name in port.block_names:
        blk, ref = getattr(fused, name), zoo["dv"]["params"][name]
        np.testing.assert_allclose(
            blk.reparam.weight.detach().numpy(),
            np.transpose(ref["reparam"]["kernel"], (3, 2, 0, 1)),
            rtol=1e-6, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(blk.reparam.bias.detach().numpy(),
                                   ref["reparam"]["bias"], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        if "se" in ref:
            for leaf in ("down", "up"):
                np.testing.assert_array_equal(
                    getattr(blk.se, leaf).weight.detach().numpy(),
                    ref["se"][leaf]["kernel"].T)
    with torch.no_grad():
        y = fused(torch.from_numpy(zoo["x"]), qmode="fp").numpy()
    np.testing.assert_allclose(y, zoo["fp"], rtol=1e-4, atol=1e-5)


def _train_port(zoo):
    port = _port_model(zoo["case"], scheme=port_scheme(SCHEME))
    return load_jax_variables(port, zoo["tv"])


def _port_layers(port, x, qmode):
    """The port's logits of its own forward, and each tracked module's
    (input, output) in JAX's layout."""
    seen, hooks = {}, []
    for name, m in port.named_modules():
        if isinstance(m, (QConv, QDense, torch.nn.BatchNorm2d)):
            hooks.append(m.register_forward_hook(
                lambda mod, a, o, name=name: seen.__setitem__(
                    name, (_nhwc(mod, a[0]), _nhwc(mod, materialize(o))))))
    try:
        with torch.no_grad():
            logits = port(torch.from_numpy(x), qmode=qmode).numpy()
    finally:
        for h in hooks:
            h.remove()
    return logits, seen


def _nhwc(module, t):
    t = materialize(t)
    if isinstance(module, torch.nn.BatchNorm2d):
        t = t.permute(0, 2, 3, 1)
    return t.numpy().copy()


def _run_module(module, xin, qmode):
    """One module on JAX's input (NHWC), its output in JAX's layout."""
    x = torch.from_numpy(xin)
    with torch.no_grad():
        if isinstance(module, torch.nn.BatchNorm2d):
            return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        return materialize(module(x, qmode=qmode)).numpy()


def _codes(module, x, qmode):
    """The input codes a quantized layer takes of ``x`` (``'eval'``: the
    fake quantizer's, ``round(x/s)``; ``'int'``: the plan's), and the
    distance of each value from the rounding midpoint, in steps."""
    x = torch.from_numpy(x)
    if qmode == "int":
        h = module.plan_scalars
        v = x.double() * h["in_inv_scale"] + h["in_qbias"]
        codes = module._input_codes(x)
    else:
        s = module.in_scale.detach()
        v = x.double() / s.double()
        codes = torch.round(x / s)
    return codes.numpy(), (v - torch.floor(v) - 0.5).abs().numpy()


def _hold_layers(zoo, port, qmode, want, tol):
    """Every tracked module fed JAX's own input gives JAX's output (within
    1e-5 relative of the output's largest value); the whole model's logits
    within ``tol`` (relative L2) of ``want``, unless a tie flipped: then
    the first quantized layer whose own input codes differ from those of
    JAX's input is named, and each of its differing codes must lie within
    1e-3 of a step of a rounding midpoint (C14: float noise puts a value on
    the other side of a tie, and the flip grows through the depth).
    Returns the layers where a tie flipped."""
    jio = zoo["io"]["int" if qmode == "intc" else qmode]
    for path, (xin, out) in jio.items():
        got = _run_module(port.get_submodule(path), xin, qmode)
        err = np.abs(got - out).max() / (np.abs(out).max() + 1e-12)
        assert err <= 1e-5, (qmode, path, err)
    logits, own = _port_layers(port, zoo["x"], qmode)
    if _rel(logits, want) <= tol:
        return []
    flipped = []
    for path, (xin, _) in jio.items():
        m = port.get_submodule(path)
        if not isinstance(m, (QConv, QDense)) or m.cfg is None:
            continue
        mine, _ = _codes(m, own[path][0], qmode)
        theirs, dist = _codes(m, xin, qmode)
        differ = mine != theirs
        if differ.any():
            assert np.abs(mine - theirs).max() <= 1, path
            assert (dist[differ] < 1e-3).all(), (path, dist[differ].max())
            flipped.append((path, int(differ.sum())))
            break
    assert flipped, (qmode, _rel(logits, want), "no tie flipped")
    return flipped


def test_train_form_eval_and_int_match_jax(zoo):
    """The train form with JAX's calibration: ``'eval'`` within rtol 1e-5
    (relative L2), ``'int'`` and ``'intc'`` within 1e-4 of JAX's ``'int'``,
    every module fed JAX's input within 1e-5.  In the SE model a tie flips
    in ``'eval'`` (stage2_0.rbr_dense's input, the second image: the port's
    stage1_0 output is 4e-7 from JAX's) and moves those logits by 1e-2."""
    port = _train_port(zoo)
    flips = {"eval": _hold_layers(zoo, port, "eval", zoo["t_eval"], 1e-5)}
    prepare_deploy(port)
    for qmode in ("int", "intc"):
        flips[qmode] = _hold_layers(zoo, port, qmode, zoo["t_int"], 1e-4)
    assert all(len(f) <= 1 for f in flips.values()), flips


def _deploy_port(zoo):
    port = _port_model(zoo["case"], deploy=True, scheme=port_scheme(SCHEME))
    return prepare_deploy(load_jax_variables(port, zoo["qv"]))


def test_deploy_int_and_intc_match_jax(zoo):
    port = _deploy_port(zoo)
    x = torch.from_numpy(zoo["x"])
    with torch.no_grad():
        for qmode in ("int", "intc"):
            got = port(x, qmode=qmode).numpy()
            assert np.isfinite(got).all() and got.shape == (BATCH, CLASSES)
            assert _rel(got, zoo["d_int"]) <= 1e-4, (qmode, _rel(
                got, zoo["d_int"]))
    # JAX's own chained logits agree with its int ones
    assert _rel(zoo["d_intc"], zoo["d_int"]) <= 1e-4


def test_convs_fed_jax_codes(zoo):
    """Each deploy conv fed JAX's own input codes (the grouped ones of the
    g2/g4 models through the grouped layout; the SE model's after each SE
    block closed the chain)."""
    port = _deploy_port(zoo)
    names = zoo["names"]
    grouped = _grouped_blocks(zoo["case"])
    assert grouped == ([] if zoo["case"] == "se"
                       else ["stage2_0", "stage3_0", "stage4_0"])
    for name in names:
        i = names.index(name)
        conv = getattr(port, name).reparam
        codes = torch.from_numpy(np.array(zoo["codes"][i]))
        de = conv.deferred(codes)
        pc = de.acc
        assert pc.groups == conv.groups == (
            1 if name not in grouped else 2 if zoo["case"] == "g2" else 4)
        assert pc.weight.shape == conv.w_packed.shape
        o = conv.weight.shape[0]
        # the int32 accumulator: f32 mode with a = 1, b = 0 (|acc| < 2^24)
        acc = int8_conv3x3_plain(pc.x, pc.weight, torch.ones(o),
                                 torch.zeros(o), stride=pc.stride,
                                 pad=pc.pad, pad_lo=pc.pad_lo, mode="f32",
                                 groups=pc.groups).numpy()
        jde = zoo["acc"][i]
        np.testing.assert_array_equal(acc, jde.acc.astype(np.float32),
                                      err_msg=name)
        np.testing.assert_allclose(
            materialize(de).numpy(), np.asarray(jchain.materialize(jde)),
            rtol=1e-5, atol=1e-5 * float(np.abs(jchain.materialize(jde))
                                         .max()), err_msg=name)
        if i + 1 < len(names) and zoo["case"] != "se":
            nxt = getattr(port, names[i + 1]).reparam
            got = nxt._input_codes(qrelu(de)).numpy().astype(np.int32)
            want = zoo["codes"][i + 1].astype(np.int32)
            jq = zoo["qint"][names[i + 1]]["reparam"]
            jp = zoo["qint"][name]["reparam"]
            same = (np.array_equal(conv.bias_eff.numpy(), jp["bias_eff"])
                    and np.float32(nxt.plan_scalars["in_inv_scale"])
                    == jq["in_inv_scale"]
                    and np.float32(nxt.plan_scalars["in_qbias"])
                    == jq["in_qbias"])
            diff = np.abs(got - want)
            assert diff.max() <= (0 if same else 1), (name, same, diff.max())


def test_factories_registered():
    assert set(NEW_FACTORIES) | {"RepVGG_A0"} <= set(_REGISTRY)
    for name in NEW_FACTORIES:
        # the port's factory builds the JAX factory's configuration
        j = jax_get_model(name)
        with torch.device("meta"):
            p = _REGISTRY[name]()
        assert p.num_blocks == tuple(j.num_blocks), name
        assert p.width_multiplier == tuple(j.width_multiplier), name
        assert p.override_groups_map == dict(j.override_groups_map or {})
        assert p.use_se == j.use_se, name


@pytest.mark.parametrize("name", ["RepVGG_A1", "RepVGG_B1g2", "RepVGG_D2se"])
def test_parameter_counts_match_jax(name):
    j = jax_get_model(name)
    shapes = jax.eval_shape(lambda x: j.init(jax.random.PRNGKey(0), x),
                            jax.ShapeDtypeStruct((1, SIZE, SIZE, 3),
                                                 jnp.float32))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        port = _REGISTRY[name]()
    got = sum(p.numel() for p in port.parameters())
    assert got == want, (name, got, want)
    if name == "RepVGG_D2se":
        assert 120e6 < got < 140e6
        assert all(hasattr(getattr(port, n), "se") for n in port.block_names)
