"""The port's FSPTQ reconstruction against the JAX package's, on the fused
RepVGG of tests/test_fsptq.py (blocks (1,1,1,1), width 0.25, 10 classes,
32×32, batch 8) with seeded non-zero biases (ROADMAP hazard C8).  Both
start from JAX's variables carried across by ``load_jax_variables``
(hazard C7) and see the same numpy inputs.

Tolerances, each measured on this fixture with a margin:
* ``'train'`` forward atol 1e-5 (conv sums in another order), gradients
  rtol 1e-5 (atol 1e-5 of the leaf's largest gradient), but ``in_scale``'s
  1e-4: it sums over every input element, and JAX's f32 sum is 5.8e-5 from
  float64 (the port's 2.3e-6; the test holds both); the gradient of the
  clamps at ``qmin``/``qmax`` is ``jnp.clip``'s, split 0.5/0.5 at a tie;
* streamed calibration: every ``in_scale``/``in_offset`` rtol 1e-6;
* ``_round_reg`` value and gradient rtol 1e-6; the cosine lr within 1e-7;
* ``reconstruct_block`` from the same minibatch stream: each parameter
  within 2 % of how far JAX's moved (L2 norms), held-out l2 rtol 2e-3,
  AdaRound's hard decisions equal on ≥ 99.9 % of entries (see
  ``RECON_CASES``);
* ``FSPTQTrainer``, 20 iterations a block: the same blocks in the same
  order, the same kept/reverted decisions, eval logits relative L2 < 1e-3.
"""

import copy
import dataclasses
import logging

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlmc_quant_torch.training.fsptq as port_fsptq
from dlmc_quant_tpu.data import get_dataloader as jax_dataloader
from dlmc_quant_tpu.models.fuse import repvgg_fuse as jax_repvgg_fuse
from dlmc_quant_tpu.models.repvgg import RepVGG as JRepVGG
from dlmc_quant_tpu.ops import numerics as jax_numerics
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_tpu.training import fsptq as jax_fsptq
from dlmc_quant_tpu.training.schedulers import \
    CosineAnnealingLR as JCosineAnnealingLR
from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.models.repvgg import RepVGG
from dlmc_quant_torch.ops import numerics as port_numerics
from dlmc_quant_torch.quant import layers as port_layers
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.layers import calibrate
from dlmc_quant_torch.training.fsptq import (FSPTQTrainer, _round_reg,
                                             capture_block_io,
                                             discover_blocks,
                                             reconstruct_block)
from dlmc_quant_torch.training.schedulers import CosineAnnealingLR
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

ARCH = dict(num_blocks=(1, 1, 1, 1), width_multiplier=(0.25,) * 4,
            num_classes=10)
BATCH, SIZE, N_BATCHES = 8, 32, 3
SCHEMES = {"adaround_w8": (8, "adaround"), "adaround_w4": (4, "adaround"),
           "nearest_w4": (4, None)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _scheme(name):
    n_bits, recon = SCHEMES[name]
    return {"quantization_type": "FSPTQ",
            "weight": {"enable": True, "type": "minmax_channel",
                       "recon_type": recon,
                       "args": {"n_bits": n_bits, "signed": True}},
            "input": {"enable": True, "type": "minmax_tensor",
                      "args": {"n_bits": 8, "signed": False}}}


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BATCH, SIZE, SIZE, 3), dtype=np.float32)
            for _ in range(N_BATCHES)]


def _fused():
    """JAX fused FP model and its variables (BN statistics from a train
    forward, then seeded biases)."""
    m = JRepVGG(**ARCH)
    x = jnp.asarray(_batches()[0])
    v = m.init(jax.random.PRNGKey(1), x)
    _, upd = m.apply(v, x, train=True, mutable=["batch_stats"])
    dm, dv = jax_repvgg_fuse(m, {**v, "batch_stats": upd["batch_stats"]}, x)
    dv = _np(dv)
    rng = np.random.default_rng(4)
    for blk in dv["params"].values():
        if "reparam" in blk:
            shape = blk["reparam"]["bias"].shape
            blk["reparam"]["bias"] = (0.1 + 0.2 * rng.standard_normal(shape)
                                      ).astype(np.float32)
    return dm, dv


@pytest.fixture(scope="module")
def fused():
    return _fused()


def _jax_student(fused, name, observe_passes=N_BATCHES):
    """JAX student: the scheme attached, fused params copied in,
    calibrated with observe passes over the three batches."""
    dm, dv = fused
    qm = dataclasses.replace(dm, scheme=jax_scheme(_scheme(name)))
    xs = [jnp.asarray(b) for b in _batches()]
    qv = flax.core.unfreeze(qm.init(jax.random.PRNGKey(2), xs[0]))
    flat = flax.traverse_util.flatten_dict(qv["params"])
    flat.update(flax.traverse_util.flatten_dict(
        jax.tree_util.tree_map(jnp.asarray, dv["params"])))
    qv["params"] = flax.traverse_util.unflatten_dict(flat)
    init = _np(qv)
    return qm, init, _np(jax_calibrate(qm, qv, xs,
                                       observe_passes=observe_passes))


@pytest.fixture(scope="module", params=["adaround_w8", "nearest_w4"])
def student(request, fused):
    qm, init, cal = _jax_student(fused, request.param)
    return {"name": request.param, "model": qm, "init": init, "cal": cal}


def _port(name=None, variables=None):
    scheme = port_scheme(_scheme(name)) if name else None
    model = RepVGG(**ARCH, deploy=True, scheme=scheme).eval()
    return load_jax_variables(model, variables) if variables else model


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_layout(a, leaf):
    """A port array of leaf ``leaf`` in the JAX package's layout."""
    if leaf in ("kernel", "alpha") and a.ndim == 4:
        return np.transpose(a, (2, 3, 1, 0))          # OIHW → HWIO
    if leaf in ("kernel", "alpha") and a.ndim == 2:
        return a.T
    return a


def _tensor(module, leaf):
    return module.weight if leaf == "kernel" else getattr(module, leaf)


def _port_leaf(module, leaf):
    return _jax_layout(_tensor(module, leaf).detach().numpy(), leaf)


def _jax_block(student, path):
    targets = jax_fsptq.discover_blocks(student["model"], student["cal"],
                                        jnp.asarray(_batches()[0]))
    return dict(((".".join(p), b) for p, b in targets))[path]


# --- 'train' qmode: forward and gradients -------------------------------

def _grads_port(port_block, x, target):
    port_block.zero_grad(set_to_none=True)
    xt = _t(x).requires_grad_(True)
    out = port_block(xt, qmode="train")
    ((out - _t(target)) ** 2).sum().backward()
    layer = port_block.reparam
    grads = {leaf: _jax_layout(_tensor(layer, leaf).grad.numpy(), leaf)
             for leaf in ("kernel", "bias", "in_scale", "wt_scale", "alpha")
             if leaf == "kernel" or hasattr(layer, leaf)}
    return out.detach().numpy(), grads, xt.grad.numpy()


@pytest.fixture(scope="module")
def train_case(student):
    """stage1_0 in 'train' mode on its calibration input (post-ReLU: zeros
    at qmin, the batch maximum at qmax), against jax.grad."""
    path = "stage1_0"
    block = _jax_block(student, path)
    x, _ = jax_fsptq.capture_block_io(
        student["model"], student["cal"], [jnp.asarray(_batches()[0])],
        (path,), qmode="eval")
    # a few entries at the streamed maximum of the calibration batches,
    # which lands exactly on qmax
    x = np.array(x)
    x[0, :2, :2] = student["cal"]["qstate"][path]["reparam"]["in_stream"].max
    target = np.random.default_rng(7).standard_normal(
        block.apply({"params": student["cal"]["params"][path],
                     "qstate": student["cal"]["qstate"][path]},
                    jnp.asarray(x), qmode="fp").shape).astype(np.float32)
    bv = {"params": student["cal"]["params"][path],
          "qstate": student["cal"]["qstate"][path]}

    def loss(p, xx):
        out = block.apply({**bv, "params": p}, xx, qmode="train")
        return jnp.sum((out - target) ** 2), out

    (_, out), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(
        bv["params"], jnp.asarray(x))
    port = _port(student["name"], student["cal"])
    return {"x": x, "target": target, "out": np.asarray(out),
            "grads": _np(g)["reparam"], "gx": np.asarray(gx),
            "block": port.stage1_0, "scale": port.stage1_0.reparam}


def test_train_mode_matches_jax_grad(train_case):
    c = train_case
    s = c["scale"].in_scale.detach().numpy()
    n_lo = int((np.round(c["x"] / s) == 0).sum())
    n_hi = int((np.round(c["x"] / s) == 255).sum())
    assert n_lo > 0 and n_hi > 0         # ties at both ends of the grid
    out, grads, gx = _grads_port(c["block"], c["x"], c["target"])
    np.testing.assert_allclose(out, c["out"], rtol=1e-5, atol=1e-5)
    assert set(grads) == set(c["grads"])
    for leaf, want in c["grads"].items():
        want = np.asarray(want)
        np.testing.assert_allclose(grads[leaf], want,
                                   rtol=1e-4 if leaf == "in_scale" else 1e-5,
                                   atol=1e-5 * np.abs(want).max() + 1e-30,
                                   err_msg=leaf)
    np.testing.assert_allclose(gx, c["gx"], rtol=1e-5,
                               atol=1e-5 * np.abs(c["gx"]).max())
    # in_scale's looser tolerance is JAX's f32 sum: against float64 the
    # port holds 1e-5, JAX 1e-4
    _, g64, _ = _grads_port(copy.deepcopy(c["block"]).double(),
                            c["x"].astype(np.float64),
                            c["target"].astype(np.float64))
    np.testing.assert_allclose(grads["in_scale"], g64["in_scale"], rtol=1e-5)
    np.testing.assert_allclose(c["grads"]["in_scale"], g64["in_scale"],
                               rtol=1e-4)


def test_torch_clamp_gradient_would_differ(train_case, monkeypatch):
    """The same case with torch.clamp's tie gradient misses JAX's
    ``in_scale`` gradient by far more than the tolerance above."""
    c = train_case
    monkeypatch.setattr(port_layers, "clip",
                        lambda x, lo, hi: torch.clamp(x, lo, hi))
    _, grads, _ = _grads_port(c["block"], c["x"], c["target"])
    want = float(np.asarray(c["grads"]["in_scale"]))
    assert abs(float(grads["in_scale"]) - want) > 1e-3 * abs(want)


# --- multi-batch calibration ----------------------------------------------

def _layers(model):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, port_layers.QLayer)]


def test_calibrate_observe_passes_matches_jax(student):
    """calibrate(observe_passes=3) from the same fused weights: the
    streamed min/max of all three batches sets every input scale."""
    port = _port(student["name"], student["init"])
    calibrate(port, [_t(b) for b in _batches()], observe_passes=N_BATCHES)
    single = _port(student["name"], student["init"])
    calibrate(single, [_t(_batches()[0])])
    moved = 0
    for (path, layer), (_, one) in zip(_layers(port), _layers(single)):
        node = path.split(".")
        jp = student["cal"]["params"]
        jq = student["cal"]["qstate"]
        for k in node:
            jp, jq = jp[k], jq[k]
        np.testing.assert_allclose(layer.in_scale.item(), jp["in_scale"],
                                   rtol=1e-6, err_msg=path)
        np.testing.assert_allclose(float(layer.in_offset), jq["in_offset"],
                                   rtol=1e-6, err_msg=path)
        assert int(layer.in_stream_count) == N_BATCHES
        moved += layer.in_scale.item() != one.in_scale.item()
    assert moved > 0      # the stream, not the first batch, set the scales


# --- regularizer, schedule and straight-through estimators -----------------

@pytest.mark.parametrize("name", ["round_pass", "floor_pass", "clip"])
def test_ste_matches_jax(name):
    """Values and gradients, bit for bit, halves and bounds included."""
    x = np.array([-3.5, -2.5, -0.5, 0.0, 0.49, 0.5, 1.5, 2.5, 3.0, 7.2,
                  -127.0, 127.0, 130.4], np.float32)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    port_fn = getattr(port_numerics, name)
    jax_fn = jnp.clip if name == "clip" else getattr(jax_numerics, name)
    args = (-127.0, 127.0) if name == "clip" else ()
    jval, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(jax_fn(v, *args) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    val = (port_fn(xt, *args) * _t(w)).sum()
    val.backward()
    np.testing.assert_array_equal(port_fn(_t(x), *args).numpy(),
                                  np.asarray(jax_fn(jnp.asarray(x), *args)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))
    assert float(val) == pytest.approx(float(jval), rel=1e-6)


@pytest.mark.parametrize("beta", [20.0, 11.0, 2.0])
def test_round_reg_matches_jax(beta):
    rng = np.random.default_rng(3)
    alpha = rng.normal(0.0, 3.0, (6, 4, 3, 3)).astype(np.float32)
    alpha[0, 0, 0] = [-30.0, 30.0, 0.0]          # saturated soft targets
    jval, jgrad = jax.value_and_grad(
        lambda p: jax_fsptq._round_reg(p, jnp.float32(beta)))(
        {"a": {"alpha": jnp.asarray(alpha)}})
    layer = torch.nn.Module()
    layer.alpha = torch.nn.Parameter(_t(alpha))
    val = _round_reg(layer, beta)
    val.backward()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    np.testing.assert_allclose(layer.alpha.grad.numpy(),
                               np.asarray(jgrad["a"]["alpha"]), rtol=1e-6,
                               atol=1e-6 * float(jnp.abs(
                                   jgrad["a"]["alpha"]).max()))


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=5),
                                dict(min_lr=1e-4, t_mult=2.0)],
                         ids=["plain", "warmup", "t_mult"])
def test_cosine_schedule_matches_jax(kw):
    """Every step of a 50-step run, read at optax's update count."""
    for lr in (1e-3, 0.1):
        port = CosineAnnealingLR(lr, cycle_steps=13, **kw)
        jsched = JCosineAnnealingLR(lr, cycle_steps=13, **kw)
        for step in range(50):
            assert abs(port(step) - float(jsched(step))) <= 1e-7, step


# --- reconstruct_block ------------------------------------------------------

# (scheme, target, iterations, holdout): three runs of 30 iterations with
# the 25 % holdout where JAX's best held-out iterate is a trained one, and
# the flagship scheme's AdaRound conv block without a holdout, whose
# trajectory is held for 5 iterations.  Quantization makes the trajectory
# chaotic: rounding decisions flip with the scales, and JAX's f32
# ``in_scale`` gradient is itself 6e-5 from float64 (the port's 2e-6), so
# the two runs drift apart as they go; measured at most 1.6 % of the
# distance moved and l2 rtol 1.1e-3 (nearest_w4 on stage1_0).
RECON_CASES = [("nearest_w4", "stage1_0", 30, 0.25),
               ("nearest_w4", "linear", 30, 0.25),
               ("adaround_w4", "linear", 30, 0.25),
               ("adaround_w8", "stage1_0", 5, 0.0)]


@pytest.fixture(scope="module", params=RECON_CASES,
                ids=["-".join(map(str, c)) for c in RECON_CASES])
def recon_case(request, fused):
    name, path, iters, holdout = request.param
    qm, _, cal = _jax_student(fused, name)
    xs = [jnp.asarray(b) for b in _batches()]
    x_cache, _ = jax_fsptq.capture_block_io(qm, cal, xs, (path,),
                                            qmode="eval")
    _, y_fp = jax_fsptq.capture_block_io(
        dataclasses.replace(qm, scheme=None), cal, xs, (path,), qmode="fp")
    block = _jax_block({"model": qm, "cal": cal}, path)
    bv = {"params": cal["params"][path], "qstate": cal["qstate"][path]}
    kw = dict(iters=iters, batch_size=BATCH, holdout_frac=holdout)
    new, l2 = jax_fsptq.reconstruct_block(block, bv, x_cache, y_fp, **kw)
    return {"name": name, "path": path, "kw": kw, "cal_vars": cal,
            "x": np.asarray(x_cache), "y": np.asarray(y_fp),
            "cal": flax.traverse_util.flatten_dict(_np(bv["params"])),
            "new": flax.traverse_util.flatten_dict(_np(new)), "l2": l2}


def test_reconstruct_block_matches_jax(recon_case):
    c = recon_case
    port = _port(c["name"], c["cal_vars"])
    block = port.get_submodule(c["path"])
    l2 = reconstruct_block(block, _t(c["x"]), _t(c["y"]), **c["kw"])
    np.testing.assert_allclose(l2, c["l2"], rtol=2e-3)
    moved_any = False
    for key, want in c["new"].items():
        layer = block if c["path"] == "linear" \
            else block.get_submodule(".".join(key[:-1]))
        got = _port_leaf(layer, key[-1])
        moved = np.linalg.norm(want - c["cal"][key])
        moved_any |= moved > 0
        assert np.linalg.norm(got - want) <= 0.02 * moved, (key, moved)
        if key[-1] == "alpha":
            agree = np.mean((got >= 0) == (want >= 0))
            assert agree >= 0.999, agree
    assert moved_any


# --- the trainer ----------------------------------------------------------

class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _decisions(lines):
    return [(ln.split()[1], "REVERTED" not in ln) for ln in lines
            if ln.startswith("block ")]


@pytest.mark.parametrize("name,iters", [("adaround_w8", 20),
                                        ("adaround_w4", 8)])
def test_trainer_matches_jax(fused, name, iters):
    """The flagship scheme at 20 iterations a block (every block keeps its
    calibrated iterate, held out), and W4 AdaRound at 8, where the head is
    reconstructed and kept.  At W4 with nearest rounding the runs drift
    apart block by block (see ``RECON_CASES``), and a gate that counts 24
    images then decides differently by one image."""
    dm, dv = fused
    qm, _, cal = _jax_student(fused, name)
    student = {"name": name, "model": qm, "cal": cal}
    xs = _batches()
    rec = _Records()
    jlog = logging.getLogger(f"jax_fsptq_{student['name']}")
    jlog.addHandler(rec)
    jlog.setLevel(logging.INFO)
    tr = jax_fsptq.FSPTQTrainer(
        student["model"], jax.tree_util.tree_map(jnp.asarray, student["cal"]),
        dm, jax.tree_util.tree_map(jnp.asarray, dv),
        [jnp.asarray(b) for b in xs], iters=iters, batch_size=BATCH,
        logger=jlog)
    out = tr.train()
    want = np.asarray(student["model"].apply(out["variables"],
                                             jnp.asarray(xs[0]),
                                             qmode="eval"))

    port = _port(student["name"], student["cal"])
    teacher = load_jax_variables(_port(), dv)
    res = FSPTQTrainer(port, teacher, [_t(b) for b in xs], iters=iters,
                       batch_size=BATCH).train()
    assert list(res["block_losses"]) == list(out["block_losses"])
    assert [(b["block"], b["kept"]) for b in res["blocks"]] == \
        _decisions(rec.lines)
    with torch.no_grad():
        got = port(_t(xs[0]), qmode="eval").numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel


def test_harmful_recon_is_reverted(fused, monkeypatch):
    """A reconstruction that zeroes a block's parameters destroys teacher
    agreement, so every block is restored to its calibrated state
    (mirrors tests/test_fsptq.py's gate test)."""
    _, _, cal = _jax_student(fused, "adaround_w8")
    port = _port("adaround_w8", cal)
    teacher = load_jax_variables(_port(), fused[1])

    def garbage_recon(block, *a, **k):
        with torch.no_grad():
            for p in block.parameters():
                p.zero_()
        return 0.0

    monkeypatch.setattr(port_fsptq, "reconstruct_block", garbage_recon)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    res = FSPTQTrainer(port, teacher, [_t(b) for b in _batches()],
                       iters=2).train()
    assert not any(b["kept"] for b in res["blocks"])
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_discover_and_capture():
    """Blocks in call order, outermost only; captured I/O shapes."""
    model = _port()
    x = _t(_batches()[0])
    names = [p for p, _ in discover_blocks(model, x)]
    assert names == ["stage0", "stage1_0", "stage2_0", "stage3_0",
                     "stage4_0", "linear"]
    xin, xout = capture_block_io(model, [x, x], "stage0", "fp")
    assert xin.shape == (16, SIZE, SIZE, 3) and xout.shape[-1] == 16


# --- data -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(training=True, n_samples=40, random_sample=True, batch_size=8,
         seed=123),
    dict(training=False, n_samples=20, batch_size=8)],
    ids=["train", "eval"])
def test_imagenet_fallback_matches_jax(tmp_path, monkeypatch, kw):
    """Bit for bit, batch for batch, augmentation included, two epochs,
    against the JAX package's numpy batch assembly.  Its native C++ pass
    normalizes as ``(x - mean) * (1/std)``, one ulp from numpy's
    ``(x - mean) / std`` (ROADMAP hazard C10), so it is held to that."""
    from dlmc_quant_tpu.data import native

    args = dict(data_dir=str(tmp_path / "none"), size=16, **kw)
    port = get_dataloader("ImageNet", **args)
    with_native = jax_dataloader("ImageNet", **args)
    monkeypatch.setattr(native, "available", lambda: False)
    ref = jax_dataloader("ImageNet", **args)
    assert len(port) == len(ref) > 0
    for epoch in (0, 1):
        for loader in (port, ref, with_native):
            loader.set_epoch(epoch)
        for (x, y), (rx, ry), (nx, ny) in zip(port, ref, with_native):
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)
            np.testing.assert_array_equal(y, ny)
            np.testing.assert_array_max_ulp(x, nx, maxulp=1)
