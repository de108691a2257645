"""The port's MoE layer against the reference's, on the CPU.

The reference's parameters (``repro.models.moe.init``) are carried
across bit for bit and the same numpy input goes through both.  The
routing is integers: the experts picked (``eidx``), each assignment's
place in its expert and whether it is kept are held bitwise, in the
prefill grouping (one group a batch row) and the decode grouping (the
whole batch one group), with and without overflow past ``cap``.  The
reference's internals are read by a spy on its ``jax.vmap``, whose
first call is the dispatch.  ``lax.top_k`` and ``torch.topk`` may break
a tie differently, so the inputs are ones whose router probabilities
have no near-tie (the smallest gap among a token's top k + 1 is
printed and held above 1e-6, ten times the two routers' float32
difference).
Floats: ``y`` and ``aux`` within 1e-5 in float32; bfloat16 ``y`` within
3e-2.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import moe as RM
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TM

ARCH = "phi3.5-moe-42b-a6.6b"


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pair(dtype=jnp.float32, seed=0, **moe_changes):
    """(cfg, reference params, port cfg, port MoE) on the same values."""
    cfg, tcfg = configs.get(ARCH).reduced(), tconfigs.get(ARCH).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **moe_changes))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             **moe_changes))
    p = RM.init(jax.random.PRNGKey(seed), cfg, dtype=dtype)
    layer = TM.MoE(tcfg, dtype=_t(p["w_gate"]).dtype, device="cpu")
    layer.load_state_dict({k: _t(v) for k, v in p.items()})
    return cfg, p, tcfg, layer


def _reference_apply(p, cfg, x):
    """The reference's ``apply`` with its dispatch's inputs and outputs
    (``(x, eidx)`` and ``(buf, pos, keep)``) read by a spy on
    ``jax.vmap``."""
    calls = []

    def vmap(fn):
        def run(*args):
            out = jax.vmap(fn)(*args)
            calls.append((args, out))
            return out
        return run
    spy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                   if not k.startswith("__")})
    spy.vmap = vmap
    real = RM.jax
    RM.jax = spy
    try:
        y, aux = RM.apply(p, cfg, jnp.asarray(x))
    finally:
        RM.jax = real
    (_, eidx), (buf, pos, keep) = calls[0]
    return y, aux, np.asarray(eidx), np.asarray(buf), np.asarray(pos), \
        np.asarray(keep)


def _smallest_gap(p, x, k=2):
    """The smallest gap between neighbouring router probabilities among
    any token's largest ``k + 1`` (the ones whose order decides top-k and
    the dispatch order), float32, from the reference's router."""
    logits = np.asarray(x, np.float32).reshape(-1, x.shape[-1]) \
        @ np.asarray(p["router"])
    probs = np.sort(np.asarray(jax.nn.softmax(logits, axis=-1)), axis=-1)
    return float(np.diff(probs[:, -(k + 1):], axis=-1).min())


# (batch, seq, capacity factor): the prefill grouping at the config's
# factor and at one that overflows; the decode grouping (seq 1: the batch
# is one group) likewise
CASES = {
    "prefill": (2, 48, 1.25),
    "prefill_overflow": (2, 48, 0.5),
    "decode": (12, 1, 1.25),
    "decode_overflow": (12, 1, 0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_and_dispatch_bitwise(case):
    b, s, cf = CASES[case]
    cfg, p, tcfg, layer = _pair(capacity_factor=cf)
    x = np.random.default_rng(7).normal(size=(b, s, cfg.d_model)).astype(
        np.float32)
    gap = _smallest_gap(p, x)
    print(f"{case}: smallest router probability gap {gap:.2e}")
    assert gap > 1e-6
    y, aux, eidx, buf, pos, keep = _reference_apply(p, cfg, x)
    xt = torch.from_numpy(x)
    if s == 1:
        xt = xt.reshape(1, b, -1)
    logits, gate, teidx, taux = TM.route(layer, tcfg, xt)
    cap = TM.capacity(tcfg, xt.shape[1])
    tbuf, tpos, tkeep = TM.dispatch(xt, teidx, tcfg.moe.n_experts, cap)
    assert buf.shape[2] == cap
    assert np.array_equal(teidx.numpy(), eidx)
    assert np.array_equal(tpos.numpy(), pos)
    assert np.array_equal(tkeep.numpy(), keep)
    assert np.array_equal(tbuf.numpy(), buf)
    dropped = int((~keep).sum())
    print(f"{case}: cap {cap}, {dropped} of {keep.size} assignments dropped")
    if "overflow" in case:
        assert dropped > 0
    ty, taux2 = TM.apply(layer, tcfg, torch.from_numpy(x))
    assert ty.shape == (b, s, cfg.d_model) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5, atol=1e-5)
    assert float(taux2) == float(taux)


def test_bf16_apply_matches_reference():
    cfg, p, tcfg, layer = _pair(jnp.bfloat16, seed=1)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 32, cfg.d_model)), jnp.bfloat16)
    print(f"smallest router probability gap {_smallest_gap(p, x):.2e}")
    y, aux = RM.apply(p, cfg, x)
    ty, taux = TM.apply(layer, tcfg, _t(x))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(y, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5, atol=1e-5)


def test_capacity_is_the_reference_arithmetic():
    for arch in ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                 "jamba-1.5-large-398b"):
        cfg = tconfigs.get(arch)
        for s in (1, 4, 7, 128, 4096):
            m = cfg.moe
            want = int(max(1, min(s, (s * m.top_k * m.capacity_factor)
                                  // m.n_experts + 1)))
            assert TM.capacity(cfg, s) == want
    # decode_32k at batch 4: phi's 16 experts take one slot each
    assert TM.capacity(tconfigs.get("phi3.5-moe-42b-a6.6b"), 4) == 1


def test_stable_sort_gives_earlier_assignments_the_slots():
    """Every token picks experts 0 and 1: with cap 2 the first two tokens
    keep their slots and the later ones drop, in token order."""
    x = torch.zeros((1, 4, 3))
    eidx = torch.tensor([[[0, 1], [0, 1], [1, 0], [0, 1]]])
    buf, pos, keep = TM.dispatch(x + torch.arange(4.0)[None, :, None],
                                 eidx, 3, 2)
    assert pos.tolist() == [[0, 0, 1, 1, 2, 2, 3, 3]]
    assert keep.tolist() == [[True] * 4 + [False] * 4]
    assert buf[0, :, :, 0].tolist() == [[0.0, 1.0], [0.0, 1.0], [0.0, 0.0]]


def test_init_draws_the_reference_shapes_and_scales():
    cfg = configs.get(ARCH).reduced()
    ref = RM.init(jax.random.PRNGKey(0), cfg)
    gen = torch.Generator().manual_seed(0)
    layer = TM.MoE(tconfigs.get(ARCH).reduced(), gen)
    for name, a in ref.items():
        got = getattr(layer, name)
        assert tuple(got.shape) == a.shape and got.dtype == _t(a).dtype, name
        np.testing.assert_allclose(float(got.float().std()),
                                   float(np.asarray(a, np.float32).std()),
                                   rtol=0.05, err_msg=name)
