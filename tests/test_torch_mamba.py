"""The port's Mamba block against the reference's, on the CPU.

The reference's parameters (``repro.models.mamba.init``) are carried
across bit for bit.  Tolerances:

* ``apply_train`` in float32: 1e-4 (the port's Hillis-Steele scan and
  the reference's ``lax.associative_scan`` compose the chunk's steps in
  other orders; measured ~1e-6), at S = 300, across a chunk boundary;
  bfloat16: 3e-2;
* ``apply_decode`` step by step from the same state: the output and
  ``h`` within 1e-4 in float32.  The conv tail is bfloat16 in both
  (``mamba.py:133``), and a float32 input an ulp apart can round to the
  neighbouring bfloat16, so each step starts both from the reference's
  state and the tail is held to one bfloat16 ulp (and bitwise in most
  entries);
* the reference's own invariant ``test_mamba_decode_matches_train_scan``
  inside the port, at its 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import mamba as RM
from repro_torch import configs as tconfigs
from repro_torch.models import mamba as TM

ARCH = "falcon-mamba-7b"


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pair(dtype=jnp.float32, seed=2):
    cfg, tcfg = configs.get(ARCH).reduced(), tconfigs.get(ARCH).reduced()
    p = RM.init(jax.random.PRNGKey(seed), cfg, dtype=dtype)
    layer = TM.Mamba(tcfg, dtype=_t(p["in_proj"]).dtype, device="cpu")
    layer.load_state_dict({k: _t(v) for k, v in p.items()})
    return cfg, p, tcfg, layer


@pytest.mark.parametrize("dtype,s,tol", [("float32", 300, 1e-4),
                                         ("float32", 9, 1e-4),
                                         ("bfloat16", 300, 3e-2)])
def test_apply_train_matches_reference(dtype, s, tol):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg, p, tcfg, layer = _pair(jdt)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(2, s, cfg.d_model)), jdt)
    want = jax.jit(lambda p_, x_: RM.apply_train(p_, cfg, x_))(p, x)
    got = TM.apply_train(layer, tcfg, _t(x))
    assert got.dtype == _t(want).dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=tol, atol=tol)


def test_apply_decode_matches_reference_step_by_step():
    cfg, p, tcfg, layer = _pair()
    rng = np.random.default_rng(1)
    b, n = 3, 6
    state = {"h": jnp.asarray(rng.normal(size=(b, cfg.d_inner,
                                               cfg.ssm.d_state)),
                              jnp.float32),
             "conv": jnp.asarray(rng.normal(size=(b, cfg.ssm.d_conv - 1,
                                                  cfg.d_inner)),
                                 jnp.bfloat16)}
    step = jax.jit(lambda p_, x_, s_: RM.apply_decode(p_, cfg, x_, s_))
    flips = 0
    for i in range(n):
        x = jnp.asarray(rng.normal(size=(b, 1, cfg.d_model)), jnp.float32)
        tstate = {k: _t(v) for k, v in state.items()}
        y, state = step(p, x, state)
        ty = TM.apply_decode(layer, tcfg, _t(x), tstate)
        assert ty.shape == (b, 1, cfg.d_model)
        assert tstate["conv"].dtype == torch.bfloat16
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tstate["h"].numpy(),
                                   np.asarray(state["h"]), rtol=1e-4,
                                   atol=1e-4)
        got = tstate["conv"].float().numpy()
        want = np.asarray(state["conv"], np.float32)
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert (np.abs(got - want) <= ulp).all()
        flips += int((got != want).sum())
    print(f"conv tail entries a bf16 ulp apart: {flips} of "
          f"{n * got.size}")
    assert flips <= n * got.size // 100


def test_decode_matches_train_scan_in_the_port():
    """The reference's ``test_mamba_decode_matches_train_scan``, on the
    port alone: the O(1) decode equals the chunked scan (bf16, 5e-2)."""
    _, _, tcfg, layer = _pair(jnp.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 9, tcfg.d_model))).to(torch.bfloat16)
    y_train = TM.apply_train(layer, tcfg, x)
    state = TM.init_decode_state(tcfg, 2)
    y_dec = torch.cat([TM.apply_decode(layer, tcfg, x[:, i:i + 1], state)
                       for i in range(9)], dim=1)
    np.testing.assert_allclose(y_train.float().numpy(),
                               y_dec.float().numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("c", [1, 2, 5, 256])
def test_scan_chunk_equals_the_sequential_recurrence(c):
    gen = torch.Generator().manual_seed(c)
    a = torch.rand((2, c, 3, 4), generator=gen, dtype=torch.float64)
    b = torch.randn((2, c, 3, 4), generator=gen, dtype=torch.float64)
    h, hs, prod, prods = torch.zeros((2, 3, 4), dtype=torch.float64), [], \
        torch.ones((2, 3, 4), dtype=torch.float64), []
    for t in range(c):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        hs.append(h)
        prods.append(prod)
    aa, bb = TM.scan_chunk(a.clone(), b.clone())
    torch.testing.assert_close(bb, torch.stack(hs, 1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(aa, torch.stack(prods, 1), rtol=1e-12,
                               atol=1e-12)


def test_init_and_decode_state_match_the_reference():
    cfg = configs.get(ARCH).reduced()
    tcfg = tconfigs.get(ARCH).reduced()
    ref = RM.init(jax.random.PRNGKey(0), cfg)
    layer = TM.Mamba(tcfg, torch.Generator().manual_seed(0))
    for name, a in ref.items():
        got = getattr(layer, name)
        assert tuple(got.shape) == a.shape and got.dtype == _t(a).dtype, name
        if name in ("dt_bias", "A_log", "D", "conv_b"):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(a, np.float32), rtol=1e-6)
        else:
            np.testing.assert_allclose(float(got.float().std()),
                                       float(np.asarray(a, np.float32).std()),
                                       rtol=0.1, err_msg=name)
    # the conv tail is bfloat16 whatever the model's dtype
    want = RM.init_decode_state(cfg, 3)
    got = TM.init_decode_state(tcfg, 3)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == _t(want[k]).dtype
        assert not bool(got[k].float().abs().sum())
