"""The port's training path against the reference on the CPU: the
dense and MoE families' loss and gradients, ``remat``, three train
steps, ``make_batch``, the trainer and its checkpoints, and the entry
points.

The reference's parameters are carried across bit for bit
(``interop.params_from_arrays``) and the reference runs op by op
(``jax.disable_jit``), as ``tests/test_torch_families.py`` runs it:
under ``jit`` XLA fuses bf16 ops and a MoE router's input moves by an
ulp (C13).  The MoE inputs are seeded with no near-tie among a token's
top k + 1 router probabilities (the gaps are printed).  Tolerances:
float32, the loss, ``nll`` and ``aux`` ``rtol 1e-5`` and each gradient
(by exported key) normwise ``|g - g_ref| / |g_ref| <= 1e-4``; bfloat16,
the loss ``1e-2`` and the gradients normwise ``5e-2``.

Three train steps: the losses within ``1e-5``, and each parameter's
update held normwise within ``1e-3``.  Adam's ``m / sqrt(v)`` turns a
gradient an ulp apart at a near-zero gradient into a whole ``lr`` step,
so an element-wise bound there would test noise.  The schedule keeps
the lr near 1e-3 over the three steps (``total_steps=100``): at a lr
decayed tenfold, one embedding row whose gradient of 1e-9 flips sign
is 3e-3 of that leaf's whole, tenfold smaller update.  The trainer: its loss
history within ``1e-4`` of the reference trainer's on the same weights
(float32, 3 steps); its checkpoint restores in the reference, and the
reference's in the port, bitwise.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.data import pipeline
from repro.models import model as M
from repro.optim import adamw
from repro.train import checkpoint as ck
from repro.train import steps as RS
from repro.train import trainer as RT
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import steps as TS
from repro_torch.train import trainer as TT
from torch_parity import (GapSpy, normwise, port_loss_and_grads,
                          reference_loss_and_grads, reference_param_arrays)

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["deepseek-coder-33b", "gemma-7b", "qwen3-4b", "stablelm-3b"]
MOE = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
TOLS = {"float32": (jnp.float32, 1e-5, 1e-4),
        "bfloat16": (jnp.bfloat16, 1e-2, 5e-2)}
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: the suite runs files side by side in
    worker processes, where torch's eight threads a process contend and
    its eager CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(t) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=[(a, d) for a in DENSE + MOE
                                        for d in TOLS],
                ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    arch, dtype = request.param
    cfg, tcfg = configs.get(arch).reduced(), tconfigs.get(arch).reduced()
    params = M.init_params(jax.random.PRNGKey(0), cfg,
                           dtype=TOLS[dtype][0])
    batch = {k: np.asarray(v) for k, v in pipeline.make_batch(
        cfg, B, S, seed=0).items()}
    return dict(arch=arch, dtype=dtype, cfg=cfg, tcfg=tcfg, batch=batch,
                model=interop.params_from_arrays(
                    reference_param_arrays(params), tcfg, device="cpu"),
                want=reference_loss_and_grads(params, cfg, batch))


def test_loss_and_gradients_match_reference(case, monkeypatch):
    _, loss_tol, grad_tol = TOLS[case["dtype"]]
    spy = GapSpy(monkeypatch)
    loss, nll, aux, grads = port_loss_and_grads(case["model"], case["tcfg"],
                                                case["batch"])
    w_loss, w_nll, w_aux, w_grads = case["want"]
    if spy.gaps:
        print(f"{case['arch']}: smallest router gap {min(spy.gaps):.2e}")
    np.testing.assert_allclose([loss, nll, aux], [w_loss, w_nll, w_aux],
                               rtol=loss_tol, atol=1e-7)
    assert set(grads) == set(w_grads)
    worst = {k: normwise(grads[k], w_grads[k].astype(np.float32))
             for k in w_grads}
    key = max(worst, key=worst.get)
    print(f"{case['arch']} {case['dtype']}: worst gradient {key} "
          f"{worst[key]:.2e}")
    assert worst[key] <= grad_tol, (key, worst[key])


def test_make_batch_is_bitwise_the_reference(case):
    got = tpipeline.make_batch(case["tcfg"], B, S, seed=0, device="cpu")
    assert set(got) == set(case["batch"]) == {"tokens", "labels"}
    for k, want in case["batch"].items():
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), want), k


def test_remat_is_bitwise_no_remat(case):
    """Each layer recomputed in backward gives the same loss and
    gradients, bit for bit, as keeping its activations."""
    on = port_loss_and_grads(case["model"], case["tcfg"], case["batch"],
                             remat=True)
    off = port_loss_and_grads(case["model"], case["tcfg"], case["batch"],
                              remat=False)
    assert on[:3] == off[:3]
    for k in on[3]:
        assert np.array_equal(on[3][k], off[3][k]), k


def test_training_leaves_serving_as_it_was():
    """``trainable`` hands the flags back, and ``prefill`` after a
    forward with gradients is bitwise what it was."""
    cfg = tconfigs.get("qwen3-4b").reduced()
    model = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    batch = tpipeline.make_batch(cfg, B, S, seed=1, device="cpu")
    before = TM.prefill(model, cfg, {"tokens": batch["tokens"]})
    with TM.trainable(model):
        assert all(p.requires_grad for p in model.parameters())
        loss, _ = TM.forward(model, cfg, batch)
        assert loss.requires_grad
    assert not any(p.requires_grad for p in model.parameters())
    after = TM.prefill(model, cfg, {"tokens": batch["tokens"]})
    assert not after.requires_grad and torch.equal(before, after)


def test_flash_path_trains_as_the_dense_path(monkeypatch):
    """Past 2,048 positions self-attention takes the flash loop, a
    checkpoint a query chunk: at S = 4,096 its loss and gradients agree
    with the dense softmax's (1e-6 relative, 1e-5 normwise), and with
    deterministic algorithms (the CPU's embedding backward accumulates in
    parallel otherwise) remat on and off are bitwise."""
    from repro_torch.models import attention as TA
    cfg = dataclasses.replace(tconfigs.get("qwen3-4b").reduced(), n_heads=2,
                              n_kv_heads=1)
    model = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    batch = {k: v.numpy() for k, v in tpipeline.make_batch(
        cfg, 1, 4096, seed=0, device="cpu").items()}
    torch.use_deterministic_algorithms(True)
    try:
        flash = port_loss_and_grads(model, cfg, batch)
        flash_off = port_loss_and_grads(model, cfg, batch, remat=False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert flash[:3] == flash_off[:3]
    assert all(np.array_equal(flash[3][k], flash_off[3][k])
               for k in flash[3])
    monkeypatch.setattr(TA, "_FLASH_THRESHOLD", 1 << 30)
    dense = port_loss_and_grads(model, cfg, batch)
    np.testing.assert_allclose(flash[0], dense[0], rtol=1e-6)
    assert max(normwise(flash[3][k], dense[3][k]) for k in dense[3]) <= 1e-5


# ----------------------------------------------------------------------
# three train steps, the trainer, the checkpoints
# ----------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b"])
def test_three_train_steps_match_reference(arch, monkeypatch):
    cfg, tcfg = configs.get(arch).reduced(), tconfigs.get(arch).reduced()
    params = M.init_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    model = interop.params_from_arrays(reference_param_arrays(params), tcfg,
                                       device="cpu")
    state = adamw.init(params)
    tstate = tadamw.init(TS.param_dict(model))
    step = RS.make_train_step(cfg, adamw.AdamWConfig(**OPT))
    tstep = TS.make_train_step(tcfg, tadamw.AdamWConfig(**OPT))
    spy = GapSpy(monkeypatch)
    for i in range(3):
        batch = pipeline.make_batch(cfg, B, S, seed=100003 + i)
        tbatch = tpipeline.make_batch(tcfg, B, S, seed=100003 + i,
                                      device="cpu")
        before = reference_param_arrays(params)
        tbefore = {k: _f32(v).copy() for k, v in
                   interop.params_to_arrays(model, tcfg).items()}
        with jax.disable_jit():
            params, state, mets = step(params, state, batch)
        model, tstate, tmets = tstep(model, tstate, tbatch)
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmets[k]), float(mets[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        assert int(tstate.step) == int(state.step) == i + 1
        got = interop.params_to_arrays(model, tcfg)
        after = reference_param_arrays(params)
        worst = max((normwise(_f32(got[k]) - tbefore[k],
                              after[k] - before[k]), k) for k in after)
        print(f"{arch} step {i}: loss {float(tmets['loss']):.6f}, worst "
              f"update {worst[1]} {worst[0]:.2e}")
        assert worst[0] <= 1e-3, worst
    if spy.gaps:
        print(f"{arch}: smallest router gap {min(spy.gaps):.2e}")


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The reference's trainer and the port's from the same float32
    weights, 3 steps, each writing its checkpoint."""
    cfg, tcfg = configs.get("qwen3-4b").reduced(), \
        tconfigs.get("qwen3-4b").reduced()
    weights = M.init_params(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    d = tmp_path_factory.mktemp("ckpt")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(RT.model_lib, "init_params", lambda key, cfg_: weights)
        mp.setattr(TT.model_lib, "init_params",
                   lambda cfg_, seed, device: interop.params_from_arrays(
                       reference_param_arrays(weights), cfg_, device=device))
        run = lambda tr, c, path, **kw: tr.train(c, tr.TrainerConfig(
            steps=3, batch=B, seq_len=S, log_every=1, ckpt_path=str(path),
            opt=tr.adamw.AdamWConfig(**OPT)), **kw)
        ref = run(RT, cfg, d / "ref.npz")
        port = run(TT, tcfg, d / "port.npz", device="cpu")
    finally:
        mp.undo()
    return dict(cfg=cfg, tcfg=tcfg, weights=weights, ref=ref, port=port,
                dir=d)


def test_trainer_loss_history_matches_reference(trainers):
    ref, port = trainers["ref"][2], trainers["port"][2]
    assert [s for s, _ in port] == [s for s, _ in ref] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in port], [v for _, v in ref],
                               rtol=1e-4)


def test_port_checkpoint_restores_in_the_reference(trainers):
    like = M.init_params(jax.random.PRNGKey(0), trainers["cfg"],
                         dtype=jnp.float32)
    tree, step = ck.restore(str(trainers["dir"] / "port.npz"), like)
    assert step == 3
    got = reference_param_arrays(tree)
    want = interop.params_to_arrays(trainers["port"][0], trainers["tcfg"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy()), k


def test_reference_checkpoint_restores_in_the_port(trainers):
    model, step = TT.restore_params(str(trainers["dir"] / "ref.npz"),
                                    trainers["tcfg"], dtype=torch.float32,
                                    device="cpu")
    assert step == 3
    want = reference_param_arrays(trainers["ref"][0])
    got = interop.params_to_arrays(model, trainers["tcfg"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k


def test_bf16_checkpoint_roundtrip_in_the_port(tmp_path):
    """bf16 parameters go to the file as float32 and come back bitwise,
    with the hybrid's and the encoder's stacks."""
    for arch in ("jamba-1.5-large-398b", "seamless-m4t-medium"):
        cfg = tconfigs.get(arch).reduced()
        model = TM.init_params(cfg, seed=3, device="cpu")
        TT.save_params(str(tmp_path / arch), model, cfg, step=5)
        back, step = TT.restore_params(str(tmp_path / arch), cfg,
                                       device="cpu")
        assert step == 5
        for (k, a), (k2, b) in zip(model.state_dict().items(),
                                   back.state_dict().items()):
            assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_points_run_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "falcon-mamba-7b", "--steps", "2", "--batch",
                  "2", "--seq", "16", "--device", "cpu", "--ckpt",
                  str(tmp_path / "launch.npz")])
    _example().main(["--device", "cpu", "--steps", "3", "--ckpt",
                     str(tmp_path / "lm.npz")])
    out = capsys.readouterr().out
    assert "falcon-mamba-7b (reduced)" in out and "step     1 loss" in out
    assert "loss " in out.splitlines()[-1]
    assert (tmp_path / "launch.npz").exists() and (tmp_path / "lm.npz").exists()


def test_entry_points_need_a_gpu_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen3-4b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example().main(["--steps", "1", "--ckpt", str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "qwen3-4b", "--full", "--device", "cpu"])
