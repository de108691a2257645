"""The port's attention against the reference's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function
and its counterpart in ``repro_torch``.  On a CPU tensor the port's
window-attention wrapper runs its plain version (the CUDA kernel runs
only on the card, ``tests/test_torch_cuda.py``); the reference's Pallas
kernel runs in interpret mode, as its own tests run it.  Tolerances:

* window attention, float32: 1e-5 absolute.  Both compute in float32;
  the reference's online softmax over 512-row tiles and the port's one
  softmax sum in other orders (measured: <= 2e-7).
* rmsnorm and rope: float32 1e-6 (XLA's and torch's rsqrt, cos and sin
  round differently in the last bit); bfloat16 bitwise.  At positions
  near 524,288 rope is held to 1e-4: one of the 64 inverse frequencies
  at theta = 1e6 differs by an ulp between XLA's and torch's float32
  pow, which moves that angle by ~3e-5 rad (ROADMAP queue C).
* ``decode_attention`` with float32 parameters: 1e-5, and 1e-5 in the
  cache rows it inserts (both project, normalize and rope the new
  token); every other cache row is untouched, bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.kernels import ops, ref
from repro.models import attention as A
from repro.models import layers as L
from repro_torch import configs as tconfigs
from repro_torch.kernels import ref as tref
from repro_torch.kernels import window_attention as twa
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

SWEEP = [(1, 8, 16), (4, 100, 32), (6, 1000, 64), (3, 513, 128),
         (2, 2048, 64)]           # (bh, w, dh) of the reference's sweep


def _t(a) -> torch.Tensor:
    """A CPU tensor of a numpy or JAX array; bfloat16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("bh,w,dh", SWEEP)
def test_kernel_function_matches_reference_kernel(bh, w, dh):
    rng = np.random.default_rng(bh * 31 + w)
    q = rng.normal(size=(bh, dh)).astype(np.float32)
    k = rng.normal(size=(bh, w, dh)).astype(np.float32)
    v = rng.normal(size=(bh, w, dh)).astype(np.float32)
    kvl = rng.integers(1, w + 1, bh).astype(np.int32)
    kvl[0] = w
    if bh > 1:
        kvl[1] = 1
    got = twa.decode_window_attention(*map(_t, (q, k, v, kvl)))
    assert got.dtype == torch.float32 and got.shape == (bh, dh)
    want = ops.decode_window_attention(*map(jnp.asarray, (q, k, v, kvl)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    oracle = ref.decode_window_attention_ref(*map(jnp.asarray, (q, k, v, kvl)))
    np.testing.assert_allclose(_np(got), np.asarray(oracle), rtol=0,
                               atol=1e-5)


def test_kernel_function_bf16_cache_matches_reference_kernel():
    """The reference's bf16-cache case: K/V upcast exactly, float32 math
    on both sides, so float32's tolerance holds."""
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(4, 700, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(4, 700, 64)), jnp.bfloat16)
    kvl = jnp.asarray([1, 10, 300, 700], jnp.int32)
    want = ops.decode_window_attention(q, k, v, kvl)
    got = twa.decode_window_attention(*map(_t, (q, k, v, kvl)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)


def _reference_grouped_attention(q, k, v, kv_len):
    """The attention inside the reference's ``decode_attention``
    (``repro/models/attention.py:236-248``), in float32: q [B,H,dh],
    k/v [B,W,Hkv,dh], valid rows t < kv_len."""
    b, h, dh = q.shape
    w, hkv = k.shape[1], k.shape[2]
    t = jnp.arange(w)[None, :]
    valid = t < kv_len[:, None]
    qg = q.reshape(b, hkv, h // hkv, dh)
    s = jnp.einsum("bgrd,btgd->bgrt", qg, k).astype(jnp.float32) * dh ** -0.5
    s = jnp.where(valid[:, None, None, :], s, -jnp.inf)
    m = s.max(axis=-1, keepdims=True)
    pr = jnp.exp(s - m)
    pr = pr / pr.sum(axis=-1, keepdims=True)
    return jnp.einsum("bgrt,btgd->bgrd", pr, v).reshape(b, h, dh)


@pytest.mark.parametrize("b,h,hkv,w,dh", [
    (2, 4, 4, 64, 64),
    (3, 4, 2, 100, 64),
    (2, 8, 2, 513, 32),
    (1, 32, 8, 300, 128),        # qwen3-4b's heads
    (2, 7, 1, 40, 16),
])
def test_gqa_form_matches_reference_decode_attention(b, h, hkv, w, dh):
    rng = np.random.default_rng(b * 100 + h * 10 + hkv)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    kvl = rng.integers(1, w + 1, b).astype(np.int32)
    kvl[0] = w
    got = twa.window_attention(*map(_t, (q, k, v, kvl)))
    want = _reference_grouped_attention(*map(jnp.asarray, (q, k, v, kvl)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    # and head by head through the reference kernel's own signature
    n_rep = h // hkv
    for hh in range(h):
        one = ops.decode_window_attention(
            jnp.asarray(q[:, hh]), jnp.asarray(k[:, :, hh // n_rep]),
            jnp.asarray(v[:, :, hh // n_rep]), jnp.asarray(kvl))
        np.testing.assert_allclose(_np(got[:, hh]), np.asarray(one), rtol=0,
                                   atol=1e-5)


def test_gqa_form_reads_a_strided_layer_slice_in_place():
    """A layer's slice of the stacked [L, B, W, Hkv, dh] cache, and the
    reference signature's [BH, W, 1, dh] view, give what contiguous
    copies give."""
    rng = np.random.default_rng(3)
    cache = _t(rng.normal(size=(3, 2, 50, 2, 32)).astype(np.float32))
    q = _t(rng.normal(size=(2, 4, 32)).astype(np.float32))
    kvl = torch.tensor([50, 7], dtype=torch.int32)
    got = twa.window_attention(q, cache[1], cache[2], kvl)
    want = twa.window_attention(q, cache[1].contiguous(),
                                cache[2].contiguous(), kvl)
    assert torch.equal(got, want)


def test_plain_version_takes_q_of_any_float_dtype():
    rng = np.random.default_rng(5)
    q = _t(rng.normal(size=(2, 2, 16)).astype(np.float32))
    k = _t(rng.normal(size=(2, 9, 1, 16)).astype(np.float32))
    kvl = torch.tensor([9, 4], dtype=torch.int32)
    a = tref.decode_window_attention_ref(q.to(torch.bfloat16), k, k, kvl)
    b = tref.decode_window_attention_ref(q.to(torch.bfloat16).float(), k, k,
                                         kvl)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["shape", "heads", "dtype", "kv_len",
                                 "kv_len_dtype", "q_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    kvl = torch.ones(2, dtype=torch.int32)
    args = dict(q=q, k=k, v=k, kv_len=kvl)
    if bad == "shape":
        args["v"] = torch.zeros(2, 9, 2, 16)
    elif bad == "heads":
        args["k"] = args["v"] = torch.zeros(2, 8, 3, 16)
    elif bad == "dtype":
        args["k"] = args["v"] = k.half()
    elif bad == "kv_len":
        args["kv_len"] = torch.ones(3, dtype=torch.int32)
    elif bad == "kv_len_dtype":
        args["kv_len"] = torch.ones(2, dtype=torch.int64)
    elif bad == "q_dim":
        args["q"] = torch.zeros(2, 16)
    with pytest.raises(ValueError):
        twa.window_attention(**args)


@pytest.mark.parametrize("groups,w,n_rep,dh,dtype", [
    (32, 32768, 4, 128, torch.bfloat16),      # decode_32k, qwen3-4b
    (8, 8192, 4, 128, torch.bfloat16),        # long_500k's ring
    (8, 8192, 7, 128, torch.bfloat16),        # deepseek-coder-33b's group
    (16, 8192, 1, 256, torch.bfloat16),       # gemma-7b
    (32, 32768, 4, 128, torch.float32),
    (128, 32768, 1, 128, torch.float32),      # the reference signature
    (128, 513, 1, 128, torch.float32),
    (1, 1, 1, 16, torch.bfloat16),
    (4, 100, 2, 64, torch.bfloat16),
    (1, 524288, 8, 128, torch.bfloat16),
    (2048, 64, 1, 64, torch.float32),
    (2, 8191, 16, 64, torch.bfloat16),
])
def test_split_rows_covers_w_and_fills_the_card(groups, w, n_rep, dh, dtype):
    n_sms, resident = 132, (1 if dh > 128 else 2)
    chunk, n = twa.split_rows(groups, w, n_sms, n_rep, dh, dtype, resident)
    # every row in exactly one split, each split whole tiles
    assert chunk % twa._TILE_ROWS[dtype] == 0
    assert chunk * (n - 1) < w <= chunk * n
    assert 1 <= n <= twa._MAX_SPLITS
    if n > 1:
        # the float32 partials (m, l, acc) each split writes and the merge
        # reads, against the K and V rows the splits read
        part = groups * n * n_rep * (dh + 2) * 4 * 2
        kv = groups * w * 2 * dh * dtype.itemsize
        assert part <= twa._PART_SHARE * kv
        assert chunk >= twa._MIN_SPLIT_ROWS
    if dtype == torch.float32:
        # short splits: the blocks fill the card many times over
        if w >= 4 * twa._MIN_SPLIT_ROWS * twa._F32_BLOCKS_PER_SM * n_sms \
                / groups:
            assert groups * n >= twa._F32_BLOCKS_PER_SM * n_sms // 2
    else:
        # whole waves: the last one at least 90 % full where W has the rows
        slots = resident * n_sms
        blocks = groups * n
        fill = blocks / (-(-blocks // slots) * slots)
        if w >= 2 * twa._MIN_SPLIT_ROWS * slots / groups:
            assert fill >= twa._WAVE_FILL
        # and no fewer splits would fill them as well
        for m in range(1, n):
            c = -(-(-(-w // m)) // 64) * 64
            other = -(-w // c) * groups
            assert other / (-(-other // slots) * slots) < min(
                twa._WAVE_FILL, fill) or -(-w // c) == n


def _mma_emulation(q, k, v, kv_len, chunk, two_terms=True):
    """The tensor-core body's arithmetic in plain torch: K and V in bf16
    (exact operands), q and p each as bf16 hi + lo terms (one term with
    ``two_terms=False``), every sum in float32; per split, 4 warps of 16
    rows a 64-row tile, each with its own online softmax, merged in the
    block and then across splits as the kernel merges them."""
    bf, f32 = torch.bfloat16, torch.float32
    b, h, dh = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    scale = 1.0 / dh ** 0.5

    def terms(x):
        hi = x.to(bf).to(f32)
        return (hi, (x - hi).to(bf).to(f32)) if two_terms else (hi,)

    def merge(states):
        mx = torch.stack([m for m, _, _ in states]).amax(0)
        wts = [torch.where(m == -torch.inf, 0.0, torch.exp(m - mx))
               for m, _, _ in states]
        return (mx, sum(w_ * l for w_, (_, l, _) in zip(wts, states)),
                sum(w_[..., None] * a for w_, (_, _, a) in zip(wts, states)))

    qt = terms(q.to(f32).reshape(b, hkv, n_rep, dh))
    out = torch.empty(b, h, dh, dtype=f32)
    for bi in range(b):
        n = int(kv_len[bi])
        splits = []
        for s0 in range(0, n, chunk):
            end = min(s0 + chunk, n)
            warps = []
            for wi in range(4):
                m = torch.full((hkv, n_rep), -torch.inf)
                l = torch.zeros(hkv, n_rep)
                acc = [torch.zeros(hkv, n_rep, dh) for _ in qt]
                for t0 in range(s0 + 16 * wi, end, 64):
                    kt = k[bi, t0:min(t0 + 16, end)].to(f32).transpose(0, 1)
                    vt = v[bi, t0:min(t0 + 16, end)].to(f32).transpose(0, 1)
                    s = sum(qq[bi] @ kt.mT for qq in qt) * scale
                    mn = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - mn)
                    p = torch.exp(s - mn[..., None])
                    l = l * alpha + p.sum(-1)
                    acc = [a * alpha[..., None] + pp @ vt
                           for a, pp in zip(acc, terms(p))]
                    m = mn
                warps.append((m, l, sum(acc)))
            splits.append(merge(warps))
        _, l, acc = merge(splits)
        out[bi] = (acc / l[..., None]).reshape(h, dh)
    return out


@pytest.mark.parametrize("n_rep", [1, 4, 7])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_split_precision_tensor_core_arithmetic_meets_the_gate(n_rep, dh):
    """q and p as two bf16 terms each with float32 sums stay within the
    kernel's 1e-5 of the float32 plain version, at qwen3-4b's 8 KV heads
    cut to 2, W = 513 (not whole tiles) in three splits and ragged
    kv_len; one bf16 term each does not."""
    rng = np.random.default_rng(10 * n_rep + dh)
    b, hkv, w = 3, 2, 513
    q = torch.from_numpy(rng.normal(size=(b, hkv * n_rep, dh))
                         .astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, w, hkv, dh))
                         .astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.normal(size=(b, w, hkv, dh))
                         .astype(np.float32)).to(torch.bfloat16)
    kvl = torch.tensor([w, 1, int(rng.integers(2, w))], dtype=torch.int32)
    chunk = 3 * 64              # three splits over W, the last ragged
    want = tref.decode_window_attention_ref(q, k, v, kvl)
    got = _mma_emulation(q, k, v, kvl, chunk)
    assert float((got - want).abs().max()) <= 1e-5
    one_term = _mma_emulation(q, k, v, kvl, chunk, two_terms=False)
    assert float((one_term - want).abs().max()) > 1e-5


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 5, 4, 64)), dtype)
    scale = rng.normal(size=(64,)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5))
    got_n = TL.rmsnorm(_t(x), _t(scale), 1e-6)
    want_n = L.rmsnorm(x, jnp.asarray(scale), 1e-6)
    got_r = TL.rope(_t(x), _t(pos), 1e6)
    want_r = L.rope(x, jnp.asarray(pos), 1e6)
    for got, want in ((got_n, want_n), (got_r, want_r)):
        assert got.dtype == _t(want).dtype
        if dtype == jnp.bfloat16:
            assert torch.equal(got, _t(want))
        else:
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=1e-6)


def test_rope_at_long_context_positions():
    """Near position 524,288 the port agrees with the reference's eager
    rope to 1e-4 (measured 1.6e-5).  The reference's jitted rope is
    another function there (ROADMAP queue C): XLA computes the inverse
    frequencies as ``theta**-y``, each within an ulp of ``1 / theta**y``,
    and at these positions an ulp of a frequency moves its angle by up
    to ~0.03 rad (measured: the jitted and eager ropes differ by 0.105)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 4, 2, 128)).astype(np.float32)
    pos = np.array([[524288, 524289, 524300, 530000]])
    got = TL.rope(_t(x), _t(pos), 1e6)
    want = L.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4)
    jitted = jax.jit(lambda a, p: L.rope(a, p, 1e6))(jnp.asarray(x),
                                                     jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), np.asarray(jitted), rtol=0,
                               atol=0.2)
    half = 64
    freqs = lambda: 1.0 / (1e6 ** (jnp.arange(half, dtype=jnp.float32)
                                   / half))
    eager = np.asarray(freqs())
    port = (1.0 / (1e6 ** (torch.arange(half, dtype=torch.float32)
                           / half))).numpy()
    assert np.all(np.abs(np.asarray(jax.jit(freqs)()) - eager)
                  <= np.spacing(eager))
    assert np.all(np.abs(port - eager) <= np.spacing(eager))


def test_act_fn_matches_reference():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    for name in ("silu", "gelu", "relu"):
        got = TL.act_fn(name)(_t(x))
        want = L.act_fn(name)(jnp.asarray(x))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-6)


def _attention_pair(cfg, tcfg, seed):
    """The reference's attention parameters (float32) and the port's
    Attention module holding the same values."""
    p = A.init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    mix = TA.Attention(tcfg, dtype=torch.float32, device="cpu")
    mix.load_state_dict({k: _t(v) for k, v in p.items()})
    return p, mix


@pytest.mark.parametrize("n_kv", [None, 2])
def test_decode_attention_matches_reference(n_kv):
    """``decode_attention`` at n_rep 1 (qwen3-4b reduced: 4 query and 4
    KV heads) and n_rep 2 (2 KV heads): the output and the cache after
    the insert, over requests that start empty, mid-window, at W - 1,
    at W (the first wrap) and far past it."""
    cfg = configs.get("qwen3-4b").reduced()
    tcfg = tconfigs.get("qwen3-4b").reduced()
    if n_kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=n_kv)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=n_kv)
    p, mix = _attention_pair(cfg, tcfg, 0)
    rng = np.random.default_rng(7)
    b, w = 5, 32
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(b, w, cfg.n_kv_heads, cfg.dh)).astype(np.float32)
    cv = rng.normal(size=(b, w, cfg.n_kv_heads, cfg.dh)).astype(np.float32)
    clen = np.array([0, 13, w - 1, w, 5 * w + 17], np.int32)
    out, nck, ncv = A.decode_attention(p, cfg, jnp.asarray(x),
                                       jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(clen))
    tck, tcv = _t(ck), _t(cv)
    tout = TA.decode_attention(mix, tcfg, _t(x), tck, tcv, _t(clen))
    # the caches are updated in place
    np.testing.assert_allclose(_np(tout), np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tck), np.asarray(nck), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tcv), np.asarray(ncv), rtol=0, atol=1e-5)
    untouched = np.ones((b, w), bool)
    untouched[np.arange(b), clen % w] = False
    assert np.array_equal(_np(tck)[untouched], ck[untouched])
    assert np.array_equal(_np(tcv)[untouched], cv[untouched])


@pytest.mark.parametrize("window", [None, 256])
def test_flash_attention_matches_reference(window):
    """The plain-torch flash loop against the reference's jnp one (the
    long-prefill arm, S > 2048) and against the port's dense softmax."""
    rng = np.random.default_rng(1)
    b, s, h, dh = 1, 2048, 4, 32
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, h // 2, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, h // 2, dh)).astype(np.float32)
    got = TA.flash_attention(_t(q), _t(k), _t(v), True, window, 2)
    want = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, n_rep=2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    dense = TA._sdpa(_t(q), _t(k), _t(v), TA.causal_mask(s, window), 2)
    np.testing.assert_allclose(_np(got), _np(dense), rtol=2e-3, atol=2e-3)


def test_self_attention_matches_reference_dense_arm():
    cfg = configs.get("qwen3-4b").reduced()
    tcfg = tconfigs.get("qwen3-4b").reduced()
    p, mix = _attention_pair(cfg, tcfg, 1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40)[None]
    got = TA.self_attention(mix, tcfg, _t(x), _t(pos))
    want = A.self_attention(p, cfg, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
