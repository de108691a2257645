"""The port's dense LLM serving path against the reference, on the CPU.

The reference's parameters (``repro.models.model.init_params``) are
carried across bit for bit (``repro_torch.interop.params_from_arrays``),
and the same numpy tokens and caches go through both.  Tolerances:

* float32 parameters: 1e-4 on the logits (XLA's and torch's CPU
  matmuls sum in other orders; measured ~1e-6);
* bfloat16 parameters: 3e-2, the reference's own decode-vs-prefill
  tolerance.  The reference's decode rounds the attention scores and
  probabilities to bf16 (``repro/models/attention.py:241-247``); the
  port's kernel keeps them in float32, as the reference's TPU kernel
  does (measured: <= 1.6e-2 over 12 steps);
* at positions near 524,288 (the long_500k shape) float32 logits are
  held to 5e-3: under ``jit`` XLA rewrites rope's ``1 / theta**y`` as
  ``theta**-y``, which moves some of the 64 inverse frequencies by an ulp,
  and at that position the roped q and k by up to 0.1 (measured: 1.7e-3
  on the logits; ROADMAP queue C), so the inserted K rows are held to
  0.2 there.  The port's rope agrees with the reference's eager rope to
  1.6e-5 at those positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import model as M
from repro.serve import engine as S
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.serve import engine as TS
from torch_parity import reference_param_arrays

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pair(arch="qwen3-4b", dtype=jnp.float32, seed=0, **changes):
    """(cfg, reference params, port cfg, port Model) on the same values."""
    cfg = dataclasses.replace(configs.get(arch).reduced(), **changes)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), **changes)
    params = M.init_params(jax.random.PRNGKey(seed), cfg, dtype=dtype)
    model = interop.params_from_arrays(reference_param_arrays(params), tcfg,
                                       device="cpu")
    return cfg, params, tcfg, model


def _close(got, want, tol, vocab):
    np.testing.assert_allclose(got.float().numpy()[:, :vocab],
                               np.asarray(want)[:, :vocab], rtol=tol,
                               atol=tol)


def test_configs_match_reference():
    assert tconfigs.ARCHS == configs.ARCHS
    for name in configs.ARCHS:
        ref, port = configs.get(name), tconfigs.get(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(ref.reduced())
        assert port.param_count() == ref.param_count()
        assert (port.dh, port.d_inner) == (ref.dh, ref.d_inner)
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.INPUT_SHAPES
            .items()} == {k: dataclasses.asdict(v)
                          for k, v in configs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-7b"])
def test_parameters_carry_across_bitwise(arch):
    """bfloat16 weights and float32 norms, bit for bit, with the stacked
    ``[L, ...]`` axis split into the port's layers (gemma: tied
    embeddings, no ``out``)."""
    cfg, params, tcfg, model = _pair(arch, jnp.bfloat16)
    arrays = reference_param_arrays(params)
    state = model.state_dict()
    assert len(state) == sum(cfg.n_layers if k.startswith("layers.") else 1
                             for k in arrays)
    for key, a in arrays.items():
        want = _t(a)
        got = ([state[f"layers.{i}.{key[7:]}"] for i in range(cfg.n_layers)]
               if key.startswith("layers.") else [state[key]])
        for i, g in enumerate(got):
            w = want[i] if key.startswith("layers.") else want
            assert g.dtype == w.dtype, key
            if g.dtype == torch.bfloat16:
                g, w = g.view(torch.int16), w.view(torch.int16)
            assert torch.equal(g, w), key


def test_params_from_arrays_rejects_a_mismatch():
    cfg, params, tcfg, _ = _pair()
    arrays = reference_param_arrays(params)
    with pytest.raises(ValueError, match="missing"):
        interop.params_from_arrays(
            {k: v for k, v in arrays.items() if k != "out"}, tcfg,
            device="cpu")
    bad = dict(arrays, **{"layers.mix.wq": arrays["layers.mix.wq"][:, :-1]})
    with pytest.raises(ValueError, match="layers.0.mix.wq"):
        interop.params_from_arrays(bad, tcfg, device="cpu")


def test_init_params_draws_the_reference_distributions():
    """Shapes and dtypes equal the reference's, and the draws have its
    scales (embed 0.02, Glorot-normal weights, unit norms); the values
    come from torch's generator, so they are not the reference's."""
    cfg = configs.get("qwen3-4b").reduced()
    tcfg = tconfigs.get("qwen3-4b").reduced()
    ref = reference_param_arrays(M.init_params(jax.random.PRNGKey(0), cfg))
    model = TM.init_params(tcfg, seed=0, device="cpu")
    again = TM.init_params(tcfg, seed=0, device="cpu")
    state = model.state_dict()
    for key, a in ref.items():
        got = (torch.stack([state[f"layers.{i}.{key[7:]}"]
                            for i in range(cfg.n_layers)])
               if key.startswith("layers.") else state[key])
        assert tuple(got.shape) == a.shape and got.dtype == _t(a).dtype, key
        std = float(got.float().std())
        np.testing.assert_allclose(std, float(np.asarray(a, np.float32).std()),
                                   rtol=0.1, err_msg=key)
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


def test_cache_width_matches_reference():
    for name in configs.ARCHS:
        for seq in (64, 32_768, 524_288):
            assert TS.cache_width(tconfigs.get(name), seq) == \
                S.cache_width(configs.get(name), seq)


def _run_both(cfg, params, tcfg, model, dtype, tdtype, b, seq_len, cache_len,
              tokens, fill_seed=None):
    """Decode ``tokens`` [b, n] one by one through both engines from the
    same starting cache; returns each step's (reference, port) logits
    and the final states."""
    state = S.init_cache(cfg, b, seq_len, dtype=dtype)
    tstate = TS.init_cache(tcfg, b, seq_len, dtype=tdtype, device="cpu")
    if fill_seed is not None:
        rng = np.random.default_rng(fill_seed)
        ck = jnp.asarray(rng.normal(size=state.cache_k.shape), dtype)
        cv = jnp.asarray(rng.normal(size=state.cache_v.shape), dtype)
        state = dataclasses.replace(state, cache_k=ck, cache_v=cv)
        tstate.cache_k.copy_(_t(ck))
        tstate.cache_v.copy_(_t(cv))
    if cache_len is not None:
        state = dataclasses.replace(state,
                                    cache_len=jnp.asarray(cache_len,
                                                          jnp.int32))
        tstate.cache_len.copy_(torch.tensor(cache_len, dtype=torch.int32))
    fn = jax.jit(lambda p, t, st: S.decode_step(p, cfg, t, st))
    steps = []
    for i in range(tokens.shape[1]):
        tok = tokens[:, i:i + 1]
        lg, state = fn(params, jnp.asarray(tok, jnp.int32), state)
        tlg, tstate = TS.decode_step(model, tcfg, torch.from_numpy(tok),
                                     tstate)
        steps.append((lg, tlg))
    return steps, state, tstate


# (case, batch, seq_len, cache_len or None for init_cache's, fill seed,
#  steps, float32 logits tolerance): "full" starts at cache_len =
# seq_len = W (the ring wraps on the first step), "empty" is
# teacher-forced from cache_len = 0, "ragged" mixes mid-window requests,
# "wrap" runs past W several times, "long_500k" is that shape (W =
# serve_window, 64 reduced) at its positions
CASES = {
    "full": (2, 48, None, 1, 4, 1e-4),
    "empty": (2, 12, [0, 0], None, 12, 1e-4),
    "ragged": (3, 40, [0, 17, 39], 2, 4, 1e-4),
    "wrap": (2, 64, [64 * 5 + 17, 64 * 3], 3, 4, 1e-4),
    "long_500k": (2, 524_288, [524_288, 524_288 + 69], 4, 4, 5e-3),
}
# the cache rows the steps insert: float32 as the logits (0.2 at the
# long_500k positions, whose K rows carry XLA's rope frequencies);
# bfloat16 6e-2, two bf16 ulps at the rows' magnitudes (2 to 4): layer
# 1's rows are projections of layer 0's output, which differs at 3e-2
CACHE_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_reference(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    b, seq_len, cache_len, fill, n, tol32 = CASES[case]
    tol = max(tol, tol32)
    cache_tol = 0.2 if case == "long_500k" else CACHE_TOL[dtype]
    cfg, params, tcfg, model = _pair(dtype=jdt)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (b, n))
    steps, state, tstate = _run_both(cfg, params, tcfg, model, jdt, tdt, b,
                                     seq_len, cache_len, tokens, fill)
    for lg, tlg in steps:
        assert tlg.dtype == torch.float32
        assert tlg.shape == (b, TM.vocab_padded(tcfg))
        _close(tlg, lg, tol, cfg.vocab)
        assert bool((tlg[:, cfg.vocab:] == -1e9).all())
    assert tstate.cache_len.tolist() == np.asarray(state.cache_len).tolist()
    assert tstate.cache_k.shape == state.cache_k.shape
    w = state.cache_k.shape[2]
    start = np.asarray(state.cache_len) - n
    inserted = np.zeros((b, w), bool)
    for i in range(n):
        inserted[np.arange(b), (start + i) % w] = True
    for got, want in ((tstate.cache_k, state.cache_k),
                      (tstate.cache_v, state.cache_v)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.array_equal(got[:, ~inserted], want[:, ~inserted])
        np.testing.assert_allclose(got[:, inserted], want[:, inserted],
                                   rtol=cache_tol, atol=cache_tol)


def test_decode_step_with_two_kv_heads_matches_reference():
    """GQA with n_rep = 2 through the whole step, float32 parameters."""
    cfg, params, tcfg, model = _pair(n_kv_heads=2)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 4))
    steps, _, _ = _run_both(cfg, params, tcfg, model, jnp.float32,
                            torch.float32, 2, 70, [70, 9], tokens, 4)
    for lg, tlg in steps:
        _close(tlg, lg, 1e-4, cfg.vocab)


def test_decode_step_consumes_its_state_in_place():
    _, _, tcfg, model = _pair()
    state = TS.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    ck, cv = state.cache_k, state.cache_v
    _, new = TS.decode_step(model, tcfg, torch.zeros((2, 1), dtype=torch.int32),
                            state)
    assert new.cache_k is ck and new.cache_v is cv
    assert bool(ck[:, :, 0].abs().sum() > 0)      # slot 16 % 16 written
    assert bool((ck[:, :, 1:] == 0).all())
    assert new.cache_len.tolist() == [17, 17]
    assert state.cache_len.tolist() == [16, 16]


@pytest.mark.parametrize("dtype,s", [("float32", 64), ("float32", 4096),
                                     ("bfloat16", 64)])
def test_prefill_matches_reference(dtype, s):
    """Both arms of ``self_attention``: the dense softmax (S <= 2048) and
    ``flash_attention`` (S = 4096)."""
    jdt, _, tol = DTYPES[dtype]
    cfg, params, tcfg, model = _pair(dtype=jdt, seed=1)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1 if s > 2048
                                                           else 2, s))
    want = M.prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    got = TM.prefill(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, tol, cfg.vocab)


def test_teacher_forced_decode_matches_prefill():
    """The reference's invariant ``test_decode_matches_forward_logits`` in
    the port alone: decoding 12 tokens from an empty cache reproduces
    prefill's last-token logits (bfloat16, 3e-2)."""
    _, _, tcfg, model = _pair(dtype=jnp.bfloat16)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 12))
    want = TM.prefill(model, tcfg, {"tokens": torch.from_numpy(toks)})
    state = TS.init_cache(tcfg, 2, 12, device="cpu")
    state.cache_len.zero_()
    for i in range(12):
        logits, state = TS.decode_step(model, tcfg,
                                       torch.from_numpy(toks[:, i:i + 1]),
                                       state)
    np.testing.assert_allclose(logits[:, :tcfg.vocab].numpy(),
                               want[:, :tcfg.vocab].numpy(), rtol=3e-2,
                               atol=3e-2)


def test_generate_matches_reference_greedy_loop():
    """The launcher's greedy loop picks the reference loop's tokens
    (float32 parameters: the argmaxes agree)."""
    cfg, params, tcfg, model = _pair(seed=2)
    b, ctx, n = 2, 32, 6
    first = np.random.default_rng(0).integers(0, cfg.vocab, (b, 1))
    state = S.init_cache(cfg, b, ctx, dtype=jnp.float32)
    fn = jax.jit(lambda p, t, st: S.decode_step(p, cfg, t, st))
    tok = jnp.asarray(first, jnp.int32)
    want = [np.asarray(tok)]
    logits, state = fn(params, tok, state)
    for _ in range(n - 1):
        tok = jnp.argmax(logits[:, :cfg.vocab], axis=-1)[:, None].astype(
            jnp.int32)
        logits, state = fn(params, tok, state)
        want.append(np.asarray(tok))
    tstate = TS.init_cache(tcfg, b, ctx, dtype=torch.float32, device="cpu")
    seqs, tlogits, tstate, seconds = tlaunch.generate(
        model, tcfg, torch.from_numpy(first.astype(np.int32)), tstate, n)
    assert np.array_equal(seqs.numpy(), np.concatenate(want, axis=1))
    assert len(seconds) == n and tstate.cache_len.tolist() == [ctx + n] * b
    _close(tlogits, logits, 1e-4, cfg.vocab)


def test_serve_launcher_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "qwen3-4b", "--device", "cpu", "--batch", "2",
                  "--context", "16", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "qwen3-4b: batch=2 context=16 -> 4 tokens/request" in out
    assert "tok/s on cpu (reduced config)" in out
    assert "sampled ids:" in out
