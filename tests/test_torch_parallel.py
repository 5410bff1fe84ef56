"""The port's data parallelism on the CPU: processes joined by
``torch.distributed`` over gloo, held against the JAX package's mesh.

* ``python -m dlmc_quant_torch.tools.lockstep_2proc --device cpu``: two
  lockstep engines with unequal streams resolve every future, exit by
  consensus and count the same steps.
* ``DataLoader.shard`` gives JAX's indices, seeds and batches.
* Data-parallel training: two ranks (this file run as a script, one
  process a rank) each train on their shard of the synthetic CIFAR-10
  fallback (48 images after 16 held out, 8 a rank a step: 3 steps of a
  global batch of 16) from the same weights, a ``CifarResNet(depth_n=1)``
  as in ``tests/test_torch_qat.py``.  LSQ W4A4 (from JAX's variables,
  calibrated on the global first batch): after every step rank 0's
  parameters, BN statistics and quantizer leaves are held against JAX's
  ``QATTrainer(mesh=make_mesh(2))`` stepping on the global batch (the two
  shards' batches, concatenated) at ``tests/test_torch_qat.py``'s per-step
  tolerances, and both ranks hold the same bytes.  fp32 (no quantizers):
  rank 0 against the port's one-process ``Trainer`` on the global batch,
  within 1e-5 (relative L2, the norm floored at 1, as there).
* The entries at two ranks, ``--device cpu``: ``distributed_training``
  (LSQ W4A4, cut) ends with the same state on both ranks;
  ``serve_benchmark`` reports 1 and 2 devices and the scaling efficiency;
  ``benchmark`` trains on the sharded global batch.
"""

import copy
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:        # run as a script: one rank
    sys.path.insert(0, str(REPO))

from dlmc_quant_torch.data import get_dataloader  # noqa: E402
from dlmc_quant_torch.models.resnet_cifar import CifarResNet  # noqa: E402
from dlmc_quant_torch.parallel import mesh as mesh_lib  # noqa: E402
from dlmc_quant_torch.quant.config import scheme_from_dict  # noqa: E402
from dlmc_quant_torch.training import schedulers as tsched  # noqa: E402
from dlmc_quant_torch.training.optimizers import build_optimizer  # noqa
from dlmc_quant_torch.training.qat import QATTrainer  # noqa: E402
from dlmc_quant_torch.training.trainer import Trainer  # noqa: E402
from dlmc_quant_torch.utils.config import read_yaml, write_yaml  # noqa

torch.set_num_threads(1)

N_SAMPLES, N_VAL, LOCAL, SEED, RANKS = 64, 16, 8, 5, 2
LSQ_W4A4 = {"quantization_type": None, "momentum": 0.001,
            "weight": {"enable": True, "type": "LSQ",
                       "args": {"n_bits": 4, "signed": True}},
            "input": {"enable": True, "type": "LSQ",
                      "args": {"n_bits": 4, "signed": False}},
            "exclude_layers": []}
# tests/test_torch_qat.py's TRAINERS: scheme, optimizer, schedule (from the
# port's or JAX's module), trainer config
CASES = {
    "fp": (None, dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4),
           lambda m: m.MultiStepLR(0.1, [1], 2), {"kurtosis": 0.01}),
    "lsq_w4a4": (LSQ_W4A4, dict(opt_type="SGD", momentum=0.9,
                                weight_decay=1e-4, grad_clip=5.0),
                 lambda m: m.CosineDecayLR(0.01, total_steps=8,
                                           warmup_steps=2), {}),
}
# against JAX's mesh trainer after 0..3 steps, and each quantizer leaf by
# its own norm (tests/test_torch_qat.py: TRAINERS, QTOL)
LSQ_TOLS = (1e-6, 5e-3, 1e-2, 2e-2)
LSQ_QTOL = {"in_scale": 1e-4, "wt_scale": 2e-3}
FP_TOL = 1e-5
TIMEOUT_S = 240


def _loaders(get):
    """(the shards of every rank, the held-out loader) of the base
    loader."""
    base = get("CIFAR10", data_dir="data", batch_size=LOCAL,
               n_samples=N_SAMPLES, validation_split=N_VAL, seed=SEED)
    return [base.shard(r, RANKS) for r in range(RANKS)], \
        base.split_validation()


class GlobalLoader:
    """The global batch: every rank's shard batch, concatenated in rank
    order (the rows ``P('data')`` gives each device)."""

    def __init__(self, shards):
        self.shards = shards

    def set_epoch(self, epoch):
        for s in self.shards:
            s.set_epoch(epoch)

    def __len__(self):
        return len(self.shards[0])

    def __iter__(self):
        for parts in zip(*self.shards):
            yield tuple(np.concatenate(a) for a in zip(*parts))


def _model(case):
    scheme = CASES[case][0]
    return CifarResNet(depth_n=1, scheme=scheme_from_dict(scheme)
                       if scheme else None).eval()


def _port_trainer(case, model, train, valid, mesh=None):
    """The port's trainer of ``case``, recording the model's state before
    every step and after the last (``snaps``)."""
    scheme, kw, sched, cfg = CASES[case]
    base = QATTrainer if scheme else Trainer

    class Snap(base):
        def _on_step(self, epoch, batch_idx, batch=None):
            self.snaps.append({k: v.detach().clone() for k, v in
                               self.model.state_dict().items()})
            super()._on_step(epoch, batch_idx, batch)

    opt_kw = dict(kw)
    schedule = sched(tsched)
    opt = build_optimizer(model.named_parameters(), lr=schedule, **opt_kw)
    tr = Snap(model, opt, schedule, train, valid,
              config={"epochs": 1, "random_seed": SEED, **cfg},
              metrics=("accuracy",), mesh=mesh)
    tr.snaps = []
    return tr


def _train(tr):
    result = tr.train()
    tr.snaps.append({k: v.detach().clone()
                     for k, v in tr.model.state_dict().items()})
    return result


def rank_main(rank: int, port: int, out: Path) -> None:
    """One rank: each case from its saved initial state, on this rank's
    shard, under a 2-rank data mesh; saves the snapshots and the result."""
    mesh_lib.init_distributed(f"localhost:{port}", RANKS, rank, "cpu")
    mesh = mesh_lib.make_mesh()
    for case in CASES:
        model = _model(case)
        model.load_state_dict(torch.load(out / f"{case}_init.pt"))
        shards, valid = _loaders(get_dataloader)
        tr = _port_trainer(case, model, shards[rank], valid, mesh)
        result = _train(tr)
        try:
            digest = mesh_lib.check_replicas(model, mesh)
        except RuntimeError as e:      # held by the test
            digest = str(e)
        torch.save({"snaps": tr.snaps, "result": result, "digest": digest},
                   out / f"{case}_rank{rank}.pt")
    mesh_lib.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def _start_ranks(argvs, paths=()):
    """One process a rank, ``paths`` first on its ``PYTHONPATH``."""
    return [subprocess.Popen(argv, cwd=REPO, env=_env(
        PYTHONPATH=os.pathsep.join(filter(None, [
            *map(str, paths), str(REPO), os.environ.get("PYTHONPATH")]))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for argv in argvs]


def _wait_ranks(procs, timeout=TIMEOUT_S):
    """Wait for every rank; returns their stdouts."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _np(tree):
    import flax
    import jax
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank port runs of both cases, JAX's 2-device mesh run of the
    LSQ case and the port's one-process run of the fp case."""
    import jax
    import jax.numpy as jnp

    from dlmc_quant_tpu.data import get_dataloader as jax_get_dataloader
    from dlmc_quant_tpu.models.resnet_cifar import CifarResNet as JResNet
    from dlmc_quant_tpu.parallel.mesh import make_mesh
    from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
    from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
    from dlmc_quant_tpu.training import schedulers as jsched
    from dlmc_quant_tpu.training.optimizers import \
        build_optimizer as jax_build_optimizer
    from dlmc_quant_tpu.training.qat import QATTrainer as JQATTrainer
    from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

    out = tmp_path_factory.mktemp("dp")
    jshards, jvalid = _loaders(jax_get_dataloader)
    jshards[0].dataset.use_native = False   # the numpy path the port copies
    jvalid.dataset.use_native = False
    jglobal = GlobalLoader(jshards)
    x0 = next(iter(jglobal))[0]
    variables = {}
    for case, (scheme, *_rest) in CASES.items():
        jm = JResNet(depth_n=1, scheme=jax_scheme(scheme) if scheme
                     else None)
        v = jm.init(jax.random.PRNGKey(SEED), jnp.asarray(x0))
        if scheme:
            v = jax_calibrate(jm, v, [jnp.asarray(x0)])
        variables[case] = (jm, v)
        model = load_jax_variables(_model(case), _np(v))
        torch.save(model.state_dict(), out / f"{case}_init.pt")
    port = _free_port()
    ranks = _start_ranks([[sys.executable, str(Path(__file__).resolve()),
                           "--rank", str(r), str(port), str(out)]
                          for r in range(RANKS)])

    # JAX's SPMD trainer on the global batch, over a 2-device mesh
    jm, v = variables["lsq_w4a4"]
    _, kw, sched, cfg = CASES["lsq_w4a4"]

    class JSnap(JQATTrainer):
        def _on_step(self, epoch, batch_idx, batch=None):
            self.snaps.append(_np(self.state.variables()))
            super()._on_step(epoch, batch_idx, batch)

    opt_kw = dict(kw)
    tx = jax_build_optimizer(opt_kw.pop("opt_type"), sched(jsched), **opt_kw)
    jtr = JSnap(jm, v, tx, sched(jsched), jglobal, jvalid,
                config={"epochs": 1, "random_seed": SEED, **cfg},
                metrics=("accuracy",), mesh=make_mesh(RANKS))
    jtr.snaps = []
    jax_result = jtr.train()
    jtr.snaps.append(_np(jtr.state.variables()))

    _wait_ranks(ranks)
    # the port's one-process trainer on the global batch
    single = {}
    for case in CASES:
        shards, valid = _loaders(get_dataloader)
        model = _model(case)
        model.load_state_dict(torch.load(out / f"{case}_init.pt"))
        tr = _port_trainer(case, model, GlobalLoader(shards), valid)
        single[case] = (tr.snaps, _train(tr))
    return {"dir": out, "jax": (jtr.snaps, jax_result), "single": single,
            "ranks": {case: [torch.load(out / f"{case}_rank{r}.pt")
                             for r in range(RANKS)] for case in CASES},
            "twin": _model("lsq_w4a4")}


def _rel(a: torch.Tensor, b: np.ndarray, floor: float = 1.0) -> float:
    a = a.double().numpy()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def test_lockstep_two_processes():
    run = subprocess.run(
        [sys.executable, "-m", "dlmc_quant_torch.tools.lockstep_2proc",
         "--device", "cpu"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "LOCKSTEP 2-PROC: PASS" in run.stdout
    steps = re.findall(r"steps=(\d+)", run.stdout)
    assert len(steps) == 2 and steps[0] == steps[1] and int(steps[0]) > 0


def test_shard_matches_jax():
    from dlmc_quant_tpu.data import get_dataloader as jax_get_dataloader
    (j0, j1), _ = _loaders(jax_get_dataloader)
    (t0, t1), _ = _loaders(get_dataloader)
    j0.dataset.use_native = False
    for j, t in ((j0, t0), (j1, t1)):
        assert np.array_equal(j.indices, t.indices) and j.seed == t.seed
        assert len(j) == len(t) == 3
        j.set_epoch(11)
        t.set_epoch(11)
        for (jx, jy), (tx, ty) in zip(j, t):
            assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
    # the shards split the training indices between them
    assert sorted(np.concatenate([t0.indices, t1.indices]).tolist()) == \
        sorted(_loaders(get_dataloader)[0][0].indices.tolist()
               + _loaders(get_dataloader)[0][1].indices.tolist())
    assert not set(t0.indices) & set(t1.indices)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_hold_the_same_state(runs, case):
    r0, r1 = runs["ranks"][case]
    assert r0["digest"] == r1["digest"]
    assert re.fullmatch("[0-9a-f]{64}", r0["digest"]), r0["digest"]
    assert r0["result"] == r1["result"]
    for a, b in zip(r0["snaps"], r1["snaps"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_two_ranks_lsq_match_jax_mesh_trainer(runs):
    """Per step at ``tests/test_torch_qat.py``'s tolerances, the quantizer
    leaves' change since step 0 against JAX's too (its ``DTOL``); of the
    epoch's results the losses (the accuracies count argmaxes of 16
    images, which a code flipped by the 4-bit chaos moves by 1/16)."""
    from test_torch_qat import _assert_quantizer_changes

    from dlmc_quant_torch.utils.jax_bridge import load_jax_variables
    jsnaps, jres = runs["jax"]
    snaps = runs["ranks"]["lsq_w4a4"][0]["snaps"]
    assert len(snaps) == len(jsnaps) == len(LSQ_TOLS)
    twin = copy.deepcopy(runs["twin"])
    wants = []
    for step, (got, jv) in enumerate(zip(snaps, jsnaps)):
        want = {k: t.double().numpy().copy() for k, t in
                load_jax_variables(twin, jv).state_dict().items()}
        wants.append(want)
        for name, t in got.items():
            b = want[name]
            if not np.isfinite(b).all():    # an empty stream's ±inf
                assert np.array_equal(t.double().numpy(), b), (step, name)
                continue
            assert _rel(t, b) <= LSQ_TOLS[step], (step, name, _rel(t, b))
            kind = name.rsplit(".", 1)[-1]
            if step and kind in LSQ_QTOL:
                rel = _rel(t, b, 0.0)
                assert rel <= LSQ_QTOL[kind], (step, name, rel)
    _assert_quantizer_changes(snaps, wants, LSQ_QTOL)
    res = runs["ranks"]["lsq_w4a4"][0]["result"]
    assert res.keys() == jres.keys()
    for k in ("loss", "val_loss"):
        assert res[k] == pytest.approx(jres[k], rel=LSQ_TOLS[-1]), k


def test_two_ranks_lsq_match_one_process_first_step(runs):
    """Before the 4-bit chaos sets in, the 2-rank LSQ step is the
    one-process step on the global batch: every tensor, and each quantizer
    leaf by its own norm (the gradient scales count the global batch)."""
    snaps, _ = runs["single"]["lsq_w4a4"]
    got = runs["ranks"]["lsq_w4a4"][0]["snaps"]
    for step in (0, 1):
        for name, t in got[step].items():
            want = snaps[step][name].double().numpy()
            if not np.isfinite(want).all():    # an empty stream's ±inf
                assert np.array_equal(t.double().numpy(), want), (step, name)
                continue
            assert _rel(t, want) <= 1e-6, (step, name)
            if name.rsplit(".", 1)[-1] in LSQ_QTOL:
                assert _rel(t, want, 0.0) <= 1e-6, (step, name)


def test_two_ranks_fp32_match_one_process(runs):
    """The BN statistics and the gradients reduced over the ranks give the
    one-process update on the global batch."""
    snaps, result = runs["single"]["fp"]
    got = runs["ranks"]["fp"][0]
    assert len(got["snaps"]) == len(snaps) == 4
    for step, (a, b) in enumerate(zip(got["snaps"], snaps)):
        for name in a:
            rel = _rel(a[name], b[name].double().numpy())
            assert rel <= FP_TOL, (step, name, rel)
    for k in result:
        assert got["result"][k] == pytest.approx(result[k], rel=FP_TOL,
                                                 abs=FP_TOL), k


def _cut_config(tmp_path: Path) -> Path:
    cfg = read_yaml(REPO / "examples" / "configs"
                    / "QAT_lsq_resnet20_cifar10_w4a4.yaml")
    cfg["train_loader"]["args"].update(batch_size=8, n_samples=64)
    cfg["trainer"].update(epochs=1, save_period=1)
    cfg["save_dir"] = str(tmp_path / "saved")
    path = tmp_path / "lsq_cut.yaml"
    write_yaml(cfg, path)
    return path


def _entry_ranks(module: str, *args, paths=()):
    port = _free_port()
    return _wait_ranks(_start_ranks([[
        sys.executable, "-m", f"dlmc_quant_torch.examples.{module}", *args,
        "--device", "cpu", "--coordinator", f"localhost:{port}",
        "--num-hosts", str(RANKS), "--host-id", str(r)]
        for r in range(RANKS)], paths))


def test_distributed_training_two_ranks(tmp_path):
    """LSQ W4A4 cut to 3 steps of 2 × 8 images: both ranks end with the
    same parameters and buffers, and rank 0 alone saves."""
    stub = tmp_path / "stub" / "tensorboard"      # TensorFlow takes ~17 s
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("stubbed out")\n')
    out0, out1 = _entry_ranks("distributed_training", "-c",
                              str(_cut_config(tmp_path)),
                              paths=[stub.parent])
    assert "ranks=2 rank=0 device=cpu backend=gloo" in out0
    assert re.search(r"replicas: 2 ranks hold the same state, sha256 "
                     r"[0-9a-f]{64}", out0)
    assert "final:" not in out1            # rank 1 logs nothing
    assert len(list((tmp_path / "saved" / "models").glob(
        "*/*/checkpoint-epoch1"))) == 1


def test_serve_benchmark_two_ranks():
    out0, _ = _entry_ranks("serve_benchmark", "cifar_resnet20", "4")
    line = json.loads(out0.strip().splitlines()[-1])
    assert line["1_devices"] > 0 and line["2_devices"] > 0
    assert line["scaling_efficiency"] > 0
    assert line["model_axis"].startswith("2")


def test_benchmark_trains_on_the_sharded_batch(tmp_path):
    cfg = {"models": ["cifar_resnet20"], "batch_size": 4, "image_size": 16,
           "mode": "train", "warmup": 1, "steps": 2, "rounds": 1,
           "num_classes": 10}
    path = tmp_path / "bench.yaml"
    write_yaml(cfg, path)
    out0, _ = _entry_ranks("benchmark", "-c", str(path))
    line = json.loads(out0.strip().splitlines()[-1])
    assert len(line["cifar_resnet20"]) == 1
    assert line["cifar_resnet20"][0] > 0


def test_entries_need_a_card_or_cpu(monkeypatch, tmp_path):
    """Without a card, each entry raises unless it is given the CPU."""
    from dlmc_quant_torch.examples import (benchmark, distributed_training,
                                           serve_benchmark)
    from dlmc_quant_torch.tools import lockstep_2proc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench = tmp_path / "bench.yaml"
    write_yaml({"models": ["cifar_resnet20"]}, bench)
    for call in (lambda: serve_benchmark.main(["cifar_resnet20", "4"]),
                 lambda: benchmark.main(["-c", str(bench)]),
                 lambda: distributed_training.main(
                     ["-c", str(_cut_config(tmp_path))]),
                 lambda: lockstep_2proc.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


if __name__ == "__main__":
    rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
