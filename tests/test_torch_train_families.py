"""The training forward of the ssm, hybrid, vlm and audio families
against the reference on the CPU, and the Mamba scan's out-of-place
repair.

The reference's parameters are carried across bit for bit
(``interop.params_from_arrays``) and both packages take the reference's
``make_batch`` (the port's is bitwise the same).  The reference runs op
by op (``jax.disable_jit``), as ``tests/test_torch_families.py`` runs
it.  Tolerances: float32, the loss, ``nll`` and ``aux`` ``rtol 1e-5``
and each gradient (by exported key) normwise ``|g - g_ref| / |g_ref| <=
1e-4``; bfloat16 (the vlm), the loss ``1e-2`` and the gradients
normwise ``5e-2``.  The reference's float32 audio forward refuses its
own bf16 frames under a compiled scan, so the audio arm is held to its
pieces (``torch_parity.reference_forward``).  jamba's MoE layers print
the smallest gap among a token's top k + 1 router probabilities.

The scan repair: ``scan_chunk`` now builds each round's tensors anew
so autograd can go through it.  It and ``apply_train`` are held
bitwise to a frozen copy of the in-place version they replace.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs
from repro.data import pipeline
from repro.models import model as M
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import pipeline as tpipeline
from repro_torch.models import mamba as TMamba
from torch_parity import (GapSpy, normwise, port_loss_and_grads,
                          reference_loss_and_grads, reference_param_arrays)

CASES = [("falcon-mamba-7b", "float32"), ("jamba-1.5-large-398b", "float32"),
         ("llava-next-34b", "float32"), ("llava-next-34b", "bfloat16"),
         ("seamless-m4t-medium", "float32")]
TOLS = {"float32": (jnp.float32, 1e-5, 1e-4),
        "bfloat16": (jnp.bfloat16, 1e-2, 5e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: the suite runs files side by side in
    worker processes, where torch's eight threads a process contend and
    its eager CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_seq(cfg) -> int:
    """16 text positions a row: the vlm's sequence also holds its
    patches."""
    return 16 + (cfg.n_frontend_tokens if cfg.arch_type == "vlm" else 0)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    arch, dtype = request.param
    cfg, tcfg = configs.get(arch).reduced(), tconfigs.get(arch).reduced()
    params = M.init_params(jax.random.PRNGKey(0), cfg,
                           dtype=TOLS[dtype][0])
    batch = {k: np.asarray(v) for k, v in pipeline.make_batch(
        cfg, 2, train_seq(cfg), seed=0).items()}
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
    got = tpipeline.make_batch(case["tcfg"], 2, train_seq(case["cfg"]),
                               seed=0, device="cpu")
    assert set(got) == set(case["batch"])
    for k, want in case["batch"].items():
        assert got[k].dtype == {"int32": torch.int32,
                                "float32": torch.float32}[str(want.dtype)]
        assert np.array_equal(got[k].numpy(), want), k


def test_remat_is_bitwise_no_remat(case):
    """Each layer recomputed in backward (and each Mamba chunk, and the
    encoder's layers) gives the same loss and gradients, bit for bit."""
    on = port_loss_and_grads(case["model"], case["tcfg"], case["batch"],
                             remat=True)
    off = port_loss_and_grads(case["model"], case["tcfg"], case["batch"],
                              remat=False)
    assert on[:3] == off[:3]
    for k in on[3]:
        assert np.array_equal(on[3][k], off[3][k]), k


# ----------------------------------------------------------------------
# the scan repair, against a frozen copy of the in-place version
# ----------------------------------------------------------------------

def inplace_scan_chunk(a, b):
    """``scan_chunk`` as it was: each round updates a and b in place."""
    c = a.shape[1]
    for r in range(math.ceil(math.log2(c)) if c > 1 else 0):
        o = 1 << r
        b[:, o:] += b[:, :-o] * a[:, o:]
        a[:, o:] = a[:, :-o] * a[:, o:]
    return a, b


def inplace_apply_train(p, cfg, x):
    """``apply_train`` as it was, over ``inplace_scan_chunk``."""
    b, s, _ = x.shape
    di, ds = cfg.d_inner, cfg.ssm.d_state
    xc, z, dt, bmat, cmat = TMamba._ssm_inputs(p, cfg,
                                               *TMamba._in_proj(p, cfg, x))
    a = -torch.exp(p.A_log)
    xf = xc.float()
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, 256):
        sl = slice(c0, c0 + 256)
        dtk = dt[:, sl]
        da = torch.exp(dtk[..., None] * a)
        dbx = (dtk * xf[:, sl])[..., None] * bmat[:, sl, None, :]
        aa, hh = inplace_scan_chunk(da, dbx)
        hh = hh + aa * h[:, None]
        ys.append(torch.einsum("bcdn,bcn->bcd", hh, cmat[:, sl]))
        h = hh[:, -1]
    y = torch.cat(ys, dim=1) + xf * p.D
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p.out_proj


@pytest.mark.parametrize("c", [1, 2, 3, 7, 64, 256])
def test_scan_chunk_is_bitwise_the_in_place_version(c):
    g = torch.Generator().manual_seed(c)
    a = torch.rand((2, c, 5, 3), generator=g)
    b = torch.randn((2, c, 5, 3), generator=g)
    got_a, got_b = TMamba.scan_chunk(a, b)
    want_a, want_b = inplace_scan_chunk(a.clone(), b.clone())
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    # the inputs are left as they were
    assert torch.equal(a, torch.rand((2, c, 5, 3), generator=torch.Generator()
                                     .manual_seed(c)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_train_is_bitwise_the_in_place_version(dtype):
    """S = 300 crosses a chunk boundary; with and without autograd (a
    checkpoint a chunk where it records); and its gradient flows."""
    cfg = tconfigs.get("falcon-mamba-7b").reduced()
    layer = TMamba.Mamba(cfg, torch.Generator().manual_seed(1), dtype=dtype)
    x = torch.randn((2, 300, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(dtype)
    with torch.no_grad():
        want = inplace_apply_train(layer, cfg, x)
        assert torch.equal(TMamba.apply_train(layer, cfg, x), want)
    layer.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    got = TMamba.apply_train(layer, cfg, xg)
    assert torch.equal(got.detach(), want)
    got.float().square().sum().backward()
    for t in [xg.grad] + [p.grad for p in layer.parameters()]:
        assert t is not None and bool(torch.isfinite(t).all())
    assert float(layer.A_log.grad.abs().sum()) > 0
