"""The port's AdamW (``repro_torch.optim.adamw``) against the
reference's on the CPU, and the optimizer driving each family's loss
down on a fixed batch.

Given the same gradients and an unclipped norm, ``update`` gives the
reference's moments bitwise and its parameters to one ulp of their
dtype (float32 and bfloat16), at step 1 and past it, where a reference
state is carried across (``interop.opt_state_from_arrays``).  Where
the norm is clipped, the clip scale comes from a global norm summed in
another order (``grad_norm`` within 2e-6 relative), so the moments and
each update are held normwise, to 5e-6 and 1e-5.  The schedule's cosine
rounds an ulp apart, up to 3 ulps of the lr (held to 1e-6 relative over
0..total).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import model as M
from repro.optim import adamw as RA
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.train.steps import make_train_step, param_dict
from torch_parity import normwise, reference_param_arrays

CFG = dict(lr=1e-3, warmup_steps=10, total_steps=100)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: the suite runs files side by side in
    worker processes, where torch's eight threads a process contend and
    its eager CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def ulps_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in ulps of ``got``'s dtype (float32 or
    bfloat16) between two tensors, element by element."""
    bits, mask = {torch.float32: (torch.int32, 0x7FFFFFFF),
                  torch.bfloat16: (torch.int16, 0x7FFF)}[got.dtype]
    key = lambda t: (lambda i: torch.where(i < 0, -(i & mask), i))(
        t.contiguous().view(bits).long())
    return int((key(got) - key(want)).abs().max()) if got.numel() else 0


def _grads(rng, params, scale):
    return {k: jnp.asarray(rng.normal(size=v.shape) * scale, v.dtype)
            for k, v in params.items()}


@pytest.mark.parametrize("clip", [1e9, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_update_matches_reference(dtype, clip):
    """Six updates of a small tree from the same inputs in both, the
    first with a gradient norm ~450.  Unclipped, the scale is 1 in both:
    the moments are bitwise and the parameters within one ulp.  Clipped
    (every step here), the scale ``min(1, clip / (gnorm + 1e-9))`` comes
    from norms summed in other orders (2e-6 apart): the moments are held
    normwise to 5e-6 (``v`` goes with the scale squared) and each update
    ``new - old`` normwise to 1e-5."""
    rng = np.random.default_rng(0)
    params = {"a": jnp.asarray(rng.normal(size=(64, 32)), dtype),
              "b": jnp.asarray(rng.normal(size=(7,)), dtype)}
    cfg = RA.AdamWConfig(**CFG, grad_clip=clip)
    tcfg = TA.AdamWConfig(**CFG, grad_clip=clip)
    state = RA.init(params)
    for i in range(6):
        grads = _grads(rng, params, 10.0 if i == 0 else 0.1)
        tstate = TA.AdamWState({k: _t(v) for k, v in state.m.items()},
                               {k: _t(v) for k, v in state.v.items()},
                               _t(state.step))
        old = {k: _t(v) for k, v in params.items()}
        got, tnew, tmets = TA.update(
            tcfg, {k: _t(v) for k, v in grads.items()}, tstate, old)
        with jax.disable_jit():
            params, state, mets = RA.update(cfg, grads, state, params)
        for k, v in params.items():
            want = _t(v)
            assert got[k].dtype == want.dtype
            if clip > 1:
                assert ulps_apart(got[k], want) <= 1, (i, k)
            else:
                step = lambda t: (t.float() - old[k].float()).numpy()
                assert normwise(step(got[k]), step(want)) <= 1e-5, (i, k)
            for mine, ref in ((tnew.m[k], state.m[k]), (tnew.v[k],
                                                        state.v[k])):
                assert mine.dtype == torch.float32
                if clip > 1:
                    assert np.array_equal(mine.numpy(), np.asarray(ref))
                else:
                    assert normwise(mine.numpy(), np.asarray(ref)) <= 5e-6
        assert tnew.step.dtype == torch.int32 and int(tnew.step) == i + 1
        np.testing.assert_allclose(float(tmets["grad_norm"]),
                                   float(mets["grad_norm"]), rtol=2e-6)
        assert float(tmets["lr"]) == float(mets["lr"])
        assert int(tstate.step) == i        # the inputs are not modified


def test_in_place_update_is_bitwise_the_functional_one():
    """``update_`` writes ``update``'s numbers into the parameters and the
    state, leaf by leaf (bf16 parameters, float32 moments)."""
    cfg = tconfigs.get("qwen3-4b").reduced()
    model = TM.init_params(cfg, seed=0, device="cpu")
    params = param_dict(model)
    g = torch.Generator().manual_seed(0)
    state = TA.init(params)
    opt = TA.AdamWConfig(**CFG)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g).to(v.dtype)
                 for k, v in params.items()}
        want, want_state, want_mets = TA.update(opt, grads, state, params)
        copy = TA.AdamWState(dict(state.m), dict(state.v), state.step)
        got_state, mets = TA.update_(opt, grads, copy, params)
        assert got_state is copy and int(copy.step) == int(state.step) + 1
        for k in params:
            assert torch.equal(params[k], want[k]), k
            assert torch.equal(copy.m[k], want_state.m[k])
            assert torch.equal(copy.v[k], want_state.v[k])
        assert all(torch.equal(mets[k], want_mets[k]) for k in mets)
        state = copy
    assert torch.equal(dict(model.named_parameters())["embed"],
                       params["embed"])


def test_carried_model_state_updates_as_the_reference():
    """A reference state two updates in, on qwen3-4b's parameter tree
    (bf16), carried across: the third update within one bf16 ulp."""
    cfg, tcfg = configs.get("qwen3-4b").reduced(), \
        tconfigs.get("qwen3-4b").reduced()
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    opt = RA.AdamWConfig(**CFG)
    like = lambda p: jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape) * 0.1, x.dtype), p)
    state = RA.init(params)
    with jax.disable_jit():
        for _ in range(2):
            params, state, _ = RA.update(opt, like(params), state, params)
    grads = like(params)
    model = interop.params_from_arrays(reference_param_arrays(params), tcfg,
                                       device="cpu")
    arrays = {f"{part}.{k}": v for part in ("m", "v") for k, v in
              reference_param_arrays(getattr(state, part)).items()}
    arrays["step"] = np.asarray(state.step)
    tstate = interop.opt_state_from_arrays(arrays, model)
    assert int(tstate.step) == 2 and set(tstate.m) == set(param_dict(model))
    tgrads = interop.params_from_arrays(reference_param_arrays(grads), tcfg,
                                        device="cpu")
    new, _, _ = TA.update(TA.AdamWConfig(**CFG), param_dict(tgrads), tstate,
                          param_dict(model))
    with jax.disable_jit():
        want, _, _ = RA.update(opt, grads, state, params)
    got = interop.params_to_arrays(new, tcfg)
    for k, v in reference_param_arrays(want).items():
        assert ulps_apart(got[k], _t(v)) <= 1, k


def test_opt_state_from_arrays_takes_the_exported_layout():
    """The hybrid's and the encoder's stacks: the port's moments exported
    with ``params_to_arrays`` come back under the port's names; a missing
    key or a wrong step raises."""
    for arch in ("jamba-1.5-large-398b", "seamless-m4t-medium"):
        cfg = tconfigs.get(arch).reduced()
        model = TM.init_params(cfg, seed=0, device="cpu")
        state = TA.init(param_dict(model))
        state.m = {k: torch.randn(v.shape) for k, v in state.m.items()}
        arrays = {f"{part}.{k}": v.numpy() for part in ("m", "v")
                  for k, v in interop.params_to_arrays(
                      getattr(state, part), cfg).items()}
        back = interop.opt_state_from_arrays(
            dict(arrays, step=np.asarray(7, np.int32)), model)
        assert int(back.step) == 7 and back.step.dtype == torch.int32
        for k, v in state.m.items():
            assert torch.equal(back.m[k], v), k
        with pytest.raises(ValueError, match="missing"):
            interop.opt_state_from_arrays(
                {k: v for k, v in arrays.items() if k != "m.embed"}
                | {"step": np.asarray(7, np.int32)}, model)
        with pytest.raises(ValueError, match="int32 scalar"):
            interop.opt_state_from_arrays(dict(arrays, step=np.asarray(7)),
                                          model)


def test_schedule_global_norm_and_clip_match_reference():
    cfg, tcfg = RA.AdamWConfig(**CFG), TA.AdamWConfig(**CFG)
    want = np.asarray([RA.schedule(cfg, jnp.asarray(i, jnp.int32))
                       for i in range(101)], np.float32)
    got = torch.stack([TA.schedule(tcfg, torch.tensor(i, dtype=torch.int32))
                       for i in range(101)])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got[0]) == 0.0 and float(got[10]) == pytest.approx(1e-3)
    assert float(got[100]) <= 1e-4 * (1 + 1e-6)
    rng = np.random.default_rng(3)
    tree = {k: rng.normal(size=s).astype(np.float32)
            for k, s in (("x", (300, 7)), ("a", (11,)), ("m", ()))}
    np.testing.assert_allclose(
        float(TA.global_norm({k: torch.from_numpy(v)
                              for k, v in tree.items()})),
        float(RA.global_norm({k: jnp.asarray(v) for k, v in tree.items()})),
        rtol=2e-6)
    # a huge gradient is clipped to the same step; grad_norm is pre-clip
    params = {"w": torch.tensor([1.0])}
    new, _, mets = TA.update(TA.AdamWConfig(lr=0.1, weight_decay=0.0,
                                            warmup_steps=0),
                             {"w": torch.tensor([1e6])},
                             TA.init(params), params)
    ref, _, rmets = RA.update(RA.AdamWConfig(lr=0.1, weight_decay=0.0,
                                             warmup_steps=0),
                              {"w": jnp.asarray([1e6])},
                              RA.init({"w": jnp.asarray([1.0])}),
                              {"w": jnp.asarray([1.0])})
    assert float(mets["grad_norm"]) == float(rmets["grad_norm"]) == 1e6
    assert float(new["w"][0]) == float(ref["w"][0])


def test_adamw_minimizes_quadratic():
    """The reference's ``test_adamw_minimizes_quadratic``, in the port."""
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    cfg = TA.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                         total_steps=200, grad_clip=10.0)
    state = TA.init(params)

    def loss_fn(p):
        return (p["w"] ** 2).sum() + p["b"] ** 2
    for _ in range(150):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        g = torch.autograd.grad(loss_fn(p), list(p.values()))
        params, state, _ = TA.update(cfg, dict(zip(p, g)), state, params)
    assert float(loss_fn(params)) < 1e-2


# ----------------------------------------------------------------------
# a fixed batch is memorised, every family (``tests/test_models.py:84``)
# ----------------------------------------------------------------------

def _fixed_batch(cfg, b, s, seed):
    """The reference test's batch: uniform tokens and labels (and
    frames or patches), drawn as it draws them."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a))
    if cfg.arch_type == "audio":
        return {"frames": t(rng.normal(size=(b, s // 2, cfg.d_model))
                            .astype(np.float32)),
                "tokens": t(rng.integers(0, cfg.vocab, (b, s // 2))),
                "labels": t(rng.integers(0, cfg.vocab, (b, s // 2)))}
    if cfg.arch_type == "vlm":
        p = cfg.n_frontend_tokens
        return {"patches": t(rng.normal(size=(b, p, cfg.d_model))
                             .astype(np.float32)),
                "tokens": t(rng.integers(0, cfg.vocab, (b, s - p))),
                "labels": t(rng.integers(0, cfg.vocab, (b, s - p)))}
    return {"tokens": t(rng.integers(0, cfg.vocab, (b, s))),
            "labels": t(rng.integers(0, cfg.vocab, (b, s)))}


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b", "falcon-mamba-7b",
                                  "jamba-1.5-large-398b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_tiny_training_reduces_loss(arch):
    """15 steps on one batch of 64 labels (vocab 64, bf16): the loss
    falls below 0.8 of its start.  The vlm's sequence is 32, 16 patches
    and 16 tokens."""
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(), vocab=64)
    params = TM.init_params(cfg, seed=1, device="cpu")
    opt = TA.init(param_dict(params))
    step = make_train_step(cfg, TA.AdamWConfig(lr=3e-3, warmup_steps=2,
                                               total_steps=30))
    batch = _fixed_batch(cfg, 4, 32 if cfg.arch_type == "vlm" else 16, 3)
    losses = []
    for _ in range(15):
        params, opt, mets = step(params, opt, batch)
        losses.append(float(mets["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, losses
    assert not any(p.requires_grad for p in params.parameters())
