"""Every model family of the port against the reference, on the CPU:
prefill, decode from a carried serving state, the cross-attention, the
hybrid's row mapping, and the launcher.

The reference's parameters are carried across bit for bit
(``interop.params_from_arrays``), and so is its serving state
(``interop.serve_state_from_arrays``): each decode step starts both
engines from the reference's state before that step, so a comparison
covers one step's function.  (The Mamba conv tail is bfloat16 in both,
and an input a float32 ulp apart can round to the neighbouring
bfloat16; carried over several steps such a flip moves the logits by
~3e-4.  The tail is held to one bfloat16 ulp beyond the rows'
tolerance.)  Tolerances: float32 parameters 1e-4 on the logits and on
the state; bfloat16 3e-2 on the logits, as ``tests/test_torch_serve.py``
(the reference rounds decode attention scores to bf16, the port's
kernel keeps float32), and 6e-2 on the rows a step writes (two bf16 ulps
at their magnitudes).

The reference runs op by op (``jax.disable_jit``), once a family and
dtype (module-scoped fixtures).  Under ``jit`` XLA fuses the bf16 ops
and keeps some intermediates in float32, which moves a MoE router's
input by bf16 ulps: phi3.5-moe's jitted prefill differs from its own
op-by-op run by 0.22 on the logits for one seed, an expert picked the
other way.  Op by op, the reference rounds where torch rounds.  The
experts picked are a discrete choice, and no tolerance covers a
near-tie resolved the other way on inputs an ulp apart, so the MoE
families' inputs are seeded to have none; the tests print the smallest
gap among a token's top k + 1 router probabilities.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import attention as RA
from repro.models import model as M
from repro.models.layers import rmsnorm as ref_rmsnorm
from repro.serve import engine as S
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.serve import engine as TS
from torch_parity import reference_param_arrays, reference_state_arrays

FAMILIES = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
            "jamba-1.5-large-398b", "llava-next-34b", "seamless-m4t-medium"]
DTYPES = {"float32": (jnp.float32, 1e-4, 1e-4),
          "bfloat16": (jnp.bfloat16, 3e-2, 6e-2)}
B, S_LEN, CTX, STEPS = 2, 16, 40, 3
# seeds of the inputs (prefill batch, decode tokens and state) whose MoE
# routing has no near-tie in bfloat16 (the gaps are printed).  jamba's
# seeds 0, 2, 4, 5 and 6 each have a token whose experts flip in some
# layer (0.27 to 0.54 on the logits; seed 0's smallest gap is 1.6e-5)
SEEDS = {"jamba-1.5-large-398b": 1}


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a) -> np.ndarray:
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else a, np.float32)


def _batch(cfg, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S_LEN))}
    if cfg.arch_type == "audio":
        # bf16 values: the reference takes frames in bf16
        batch["frames"] = np.asarray(jnp.asarray(rng.normal(
            size=(B, 24, cfg.d_model)), jnp.bfloat16).astype(jnp.float32))
    if cfg.arch_type == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _reference_prefill(params, cfg, batch):
    if cfg.arch_type == "audio" and params["embed"].dtype == jnp.float32:
        # the reference's prefill casts frames to bf16, and its layer scan
        # then refuses a float32 model (the carry changes dtype): run its
        # arm's pieces on the same (bf16-valued) frames
        def fn(p, b):
            mem = M._encode(p, cfg, b["frames"])
            x = M._embed_tokens(p, cfg, b["tokens"])
            x, _ = M._trunk(p, cfg, x, jnp.arange(x.shape[1])[None],
                            mem=mem)
            x = ref_rmsnorm(x[:, -1:], p["final_norm"], cfg.norm_eps)
            return M._logits(p, cfg, x)[:, 0]
        return fn(params, batch)
    return M.prefill(params, cfg, batch)


def _random_state(cfg, dtype, rng):
    """A reference serving state with every part random."""
    st = S.init_cache(cfg, B, CTX, dtype=dtype)
    fill = lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype)
    parts = {n: fill(getattr(st, n)) for n in ("cache_k", "cache_v",
                                              "mem_k", "mem_v")
             if not isinstance(getattr(st, n), dict)}
    if st.mamba_state:
        parts["mamba_state"] = {k: fill(v) for k, v in
                                st.mamba_state.items()}
    lens = [0, 5] if cfg.enc_dec else [CTX, 7]
    return dataclasses.replace(st, cache_len=jnp.asarray(lens, jnp.int32),
                               **parts)


@pytest.fixture(scope="module", params=[(a, d) for a in FAMILIES
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def family(request):
    """The reference's prefill and decode steps of one family and dtype,
    with the port's model on the same parameters."""
    arch, dtype = request.param
    jdt = DTYPES[dtype][0]
    cfg, tcfg = configs.get(arch).reduced(), tconfigs.get(arch).reduced()
    params = M.init_params(jax.random.PRNGKey(0), cfg, dtype=jdt)
    model = interop.params_from_arrays(reference_param_arrays(params), tcfg,
                                       device="cpu")
    rng = np.random.default_rng(SEEDS.get(arch, 0))
    batch = _batch(cfg, rng)
    state = _random_state(cfg, jdt, rng)
    steps = []
    with jax.disable_jit():
        want = _reference_prefill(params, cfg, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
        for _ in range(STEPS):
            tok = rng.integers(0, cfg.vocab, (B, 1))
            before = reference_state_arrays(state)
            logits, state = S.decode_step(params, cfg,
                                          jnp.asarray(tok, jnp.int32), state)
            steps.append((before, tok, np.asarray(logits),
                          reference_state_arrays(state)))
    return dict(arch=arch, dtype=dtype, cfg=cfg, tcfg=tcfg, model=model,
                batch=batch, prefill=np.asarray(want, np.float32),
                steps=steps)


class _GapSpy:
    """Records the smallest gap among each token's top k + 1 router
    probabilities of the port's MoE layers."""

    def __init__(self, monkeypatch):
        self.gap = np.inf
        real = TMoE.route

        def route(p, cfg, x):
            out = real(p, cfg, x)
            probs = torch.softmax(out[0], dim=-1).sort(dim=-1).values
            k = cfg.moe.top_k
            self.gap = min(self.gap, float(probs[..., -(k + 1):].diff(
                dim=-1).min()))
            return out
        monkeypatch.setattr(TMoE, "route", route)


def _close(got, want, tol, vocab):
    np.testing.assert_allclose(_f32(got)[:, :vocab], want[:, :vocab],
                               rtol=tol, atol=tol)


def test_prefill_matches_reference(family, monkeypatch):
    cfg, tol = family["cfg"], DTYPES[family["dtype"]][1]
    spy = _GapSpy(monkeypatch)
    got = TM.prefill(family["model"], family["tcfg"],
                     {k: torch.from_numpy(v)
                      for k, v in family["batch"].items()})
    if cfg.moe is not None:
        print(f"{family['arch']}: smallest router gap {spy.gap:.2e}")
    assert got.dtype == torch.float32
    assert got.shape == (B, TM.vocab_padded(cfg))
    _close(got, family["prefill"], tol, cfg.vocab)


def test_decode_step_from_a_carried_state(family, monkeypatch):
    cfg, tcfg = family["cfg"], family["tcfg"]
    _, tol, cache_tol = DTYPES[family["dtype"]]
    spy = _GapSpy(monkeypatch)
    for before, tok, want, after in family["steps"]:
        state = interop.serve_state_from_arrays(before, tcfg, device="cpu")
        logits, new = TS.decode_step(family["model"], tcfg,
                                     torch.from_numpy(tok), state)
        _close(logits, want, tol, cfg.vocab)
        assert bool((logits[:, cfg.vocab:] == -1e9).all())
        assert new.cache_len.tolist() == after["cache_len"].tolist()
        got = {"cache_k": new.cache_k, "cache_v": new.cache_v,
               "mem_k": new.mem_k, "mem_v": new.mem_v}
        if new.mamba_state is not None:
            got.update({f"mamba_state.{k}": v
                        for k, v in new.mamba_state.items()})
        assert {k for k, v in got.items() if v is not None} == \
            set(after) - {"cache_len"}
        for key, want_part in after.items():
            if key == "cache_len":
                continue
            g, w = _f32(got[key]), _f32(want_part)
            if key.startswith("mem"):          # read, never written
                assert np.array_equal(g, w), key
            elif key == "mamba_state.conv":    # bf16: one ulp beyond tol
                np.testing.assert_allclose(g, w, rtol=cache_tol + 2.0 ** -7,
                                           atol=cache_tol, err_msg=key)
            else:
                tol_part = cache_tol if key.startswith("cache") else tol
                np.testing.assert_allclose(g, w, rtol=tol_part,
                                           atol=tol_part, err_msg=key)
    if cfg.moe is not None:
        print(f"{family['arch']}: smallest router gap {spy.gap:.2e}")


# ----------------------------------------------------------------------
# cross-attention and the decode slot
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s,t", [(8, 40), (4, 4096)])
def test_cross_attention_and_mem_kv_match_reference(s, t):
    """The dense side (a ragged ``[B, T]`` memory mask) and the flash side
    (T past 2,048: the memory taken as all valid), float32, qk_norm on."""
    cfg = dataclasses.replace(configs.get("seamless-m4t-medium").reduced(),
                              qk_norm=True, n_kv_heads=2)
    tcfg = dataclasses.replace(tconfigs.get("seamless-m4t-medium").reduced(),
                               qk_norm=True, n_kv_heads=2)
    p = RA.cross_attention_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    layer = TA.cross_attention_init(tcfg, dtype=torch.float32, device="cpu")
    p["k_norm"] = p["k_norm"] * 1.5
    layer.load_state_dict({k: _t(v) for k, v in p.items()})
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    mask = np.ones((2, t), bool)
    if t <= 2048:
        mask[1, t // 2:] = False
    mk, mv = RA.mem_kv(p, cfg, jnp.asarray(mem))
    tmk, tmv = TA.mem_kv(layer, tcfg, torch.from_numpy(mem))
    np.testing.assert_allclose(tmk.numpy(), np.asarray(mk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tmv.numpy(), np.asarray(mv), rtol=1e-5,
                               atol=1e-5)
    want = RA.cross_attention(p, cfg, jnp.asarray(x), mk, mv,
                              jnp.asarray(mask))
    got = TA.cross_attention(layer, tcfg, torch.from_numpy(x), _t(mk),
                             _t(mv), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # one query token against the whole memory: the kernel's function
    one = RA.cross_attention(p, cfg, jnp.asarray(x[:, :1]), mk, mv,
                             jnp.ones((2, t), bool))
    got1 = TA.cross_attention_decode(layer, tcfg, torch.from_numpy(x[:, :1]),
                                     _t(mk), _t(mv))
    np.testing.assert_allclose(got1.numpy(), np.asarray(one), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("slots", [[20, 10], [3, 10]])
def test_decode_attention_with_a_slot_matches_reference(slots):
    """``slot=`` overrides ``cache_len % W``; a slot past the valid prefix
    (request 0 at 20, kv_len 6) makes the valid set a prefix plus one
    row, which the port runs as a masked softmax."""
    cfg = configs.get("qwen3-4b").reduced()
    tcfg = tconfigs.get("qwen3-4b").reduced()
    p = RA.init(jax.random.PRNGKey(4), cfg, jnp.float32)
    layer = TA.Attention(tcfg, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: _t(v) for k, v in p.items()})
    rng = np.random.default_rng(5)
    w = 40
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(2, w, cfg.n_kv_heads, cfg.dh)).astype(np.float32)
    cv = rng.normal(size=(2, w, cfg.n_kv_heads, cfg.dh)).astype(np.float32)
    clen = np.asarray([5, 30], np.int32)
    slot = np.asarray(slots, np.int32)
    want, wk, wv = RA.decode_attention(p, cfg, jnp.asarray(x),
                                       jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(clen), jnp.asarray(slot))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = TA.decode_attention(layer, tcfg, torch.from_numpy(x), tck, tcv,
                              torch.from_numpy(clen), torch.from_numpy(slot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tck.numpy(), np.asarray(wk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# the hybrid's rows, the state export, construction, the launcher
# ----------------------------------------------------------------------

def test_hybrid_rows_map_as_the_reference_reshapes_them(monkeypatch):
    """Two periods of jamba (reduced widths): every cache and Mamba state
    row holds its own value, and one step reads and writes the rows the
    reference's reshape into periods gives each layer."""
    cfg = dataclasses.replace(configs.get("jamba-1.5-large-398b").reduced(),
                              n_layers=16)
    tcfg = dataclasses.replace(
        tconfigs.get("jamba-1.5-large-398b").reduced(), n_layers=16)
    params = M.init_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    model = interop.params_from_arrays(reference_param_arrays(params), tcfg,
                                       device="cpu")
    st = S.init_cache(cfg, 2, 24, dtype=jnp.float32)
    rows = lambda a: jnp.asarray(np.broadcast_to(np.arange(
        1, a.shape[0] + 1, dtype=np.float32).reshape(
            (-1,) + (1,) * (a.ndim - 1)) / a.shape[0], a.shape), a.dtype)
    st = dataclasses.replace(
        st, cache_k=rows(st.cache_k), cache_v=-rows(st.cache_v),
        mamba_state={k: rows(v) for k, v in st.mamba_state.items()})
    assert st.cache_k.shape[0] == 2 and st.mamba_state["h"].shape[0] == 14
    tst = interop.serve_state_from_arrays(reference_state_arrays(st), tcfg,
                                          device="cpu")
    seen = []
    real_attn, real_mamba = TS._decode_layer, TS._decode_mamba_layer
    h0 = tst.mamba_state["h"].data_ptr()
    row = tst.mamba_state["h"][0].numel() * 4
    k0, krow = tst.cache_k.data_ptr(), tst.cache_k[0].numel() * 4

    def attn(lp, cfg_, x, ck, cv, clen):
        seen.append(("attn", (ck.data_ptr() - k0) // krow))
        return real_attn(lp, cfg_, x, ck, cv, clen)

    def mamba(lp, cfg_, x, ms):
        seen.append(("mamba", (ms["h"].data_ptr() - h0) // row))
        return real_mamba(lp, cfg_, x, ms)
    monkeypatch.setattr(TS, "_decode_layer", attn)
    monkeypatch.setattr(TS, "_decode_mamba_layer", mamba)
    tok = np.asarray([[3], [9]])
    logits, st = jax.jit(lambda p, t, s: S.decode_step(p, cfg, t, s))(
        params, jnp.asarray(tok, jnp.int32), st)
    tlogits, tst = TS.decode_step(model, tcfg, torch.from_numpy(tok), tst)
    assert seen == [("attn", 0)] + [("mamba", j) for j in range(7)] + \
        [("attn", 1)] + [("mamba", 7 + j) for j in range(7)]
    _close(tlogits, np.asarray(logits), 1e-4, cfg.vocab)
    for key, want in reference_state_arrays(st).items():
        got = {"cache_k": tst.cache_k, "cache_v": tst.cache_v,
               "cache_len": tst.cache_len,
               "mamba_state.h": tst.mamba_state["h"],
               "mamba_state.conv": tst.mamba_state["conv"]}[key]
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4,
                                   atol=1e-4 if key != "mamba_state.conv"
                                   else 2 ** -7, err_msg=key)


def test_serve_state_from_arrays_rejects_a_mismatch():
    cfg = configs.get("jamba-1.5-large-398b").reduced()
    tcfg = tconfigs.get("jamba-1.5-large-398b").reduced()
    arrays = reference_state_arrays(S.init_cache(cfg, 2, 8))
    with pytest.raises(ValueError, match="missing"):
        interop.serve_state_from_arrays(
            {k: v for k, v in arrays.items() if k != "mamba_state.h"}, tcfg,
            device="cpu")
    with pytest.raises(ValueError, match="extra"):
        interop.serve_state_from_arrays(dict(arrays, mem_k=arrays["cache_k"]),
                                        tcfg, device="cpu")
    with pytest.raises(ValueError, match="6 layers, the config has 7"):
        interop.serve_state_from_arrays(
            dict(arrays, **{"mamba_state.h": arrays["mamba_state.h"][1:]}),
            tcfg, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_and_cache_have_the_reference_layout(arch):
    """``init_params`` builds the parameters ``params_from_arrays`` fills
    from the reference's (names, shapes, dtypes), and ``init_cache`` the
    reference's state parts, shapes and dtypes."""
    cfg, tcfg = configs.get(arch).reduced(), tconfigs.get(arch).reduced()
    carried = interop.params_from_arrays(reference_param_arrays(
        M.init_params(jax.random.PRNGKey(0), cfg)), tcfg, device="cpu")
    drawn = TM.init_params(tcfg, seed=0, device="cpu")
    want = {k: (v.shape, v.dtype) for k, v in carried.state_dict().items()}
    assert {k: (v.shape, v.dtype) for k, v in
            drawn.state_dict().items()} == want
    ref = reference_state_arrays(S.init_cache(cfg, 2, 24))
    st = TS.init_cache(tcfg, 2, 24, device="cpu")
    got = {"cache_k": st.cache_k, "cache_v": st.cache_v,
           "cache_len": st.cache_len, "mem_k": st.mem_k, "mem_v": st.mem_v}
    if st.mamba_state is not None:
        got.update({f"mamba_state.{k}": v for k, v in
                    st.mamba_state.items()})
    got = {k: v for k, v in got.items() if v is not None}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == _t(v).dtype
        assert np.array_equal(_f32(got[k]), _f32(v)), k


def test_an_unknown_arch_type_raises_value_error():
    cfg = dataclasses.replace(tconfigs.get("qwen3-4b").reduced(),
                              arch_type="retnet")
    with pytest.raises(ValueError, match="retnet"):
        TM.init_params(cfg, device="cpu")
    model = TM.init_params(tconfigs.get("qwen3-4b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="retnet"):
        TS.decode_step(model, cfg, torch.zeros((1, 1), dtype=torch.int32),
                       TS.init_cache(cfg, 1, 8, device="cpu"))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_serve_launcher_runs_every_arch_on_the_cpu(arch, capsys):
    tlaunch.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                  "--context", "16", "--tokens", "3"])
    out = capsys.readouterr().out
    assert f"batch=2 context=16 -> 3 tokens/request" in out
    assert "tok/s on cpu (reduced config)" in out
    assert "sampled ids:" in out
