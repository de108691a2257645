"""The partitioned dry run: specs as DTensor placements, the hints, the
op walker's per-device counts and collectives, the sharded B4 and its
merge, DTensor steps on a 2 x 2 gloo mesh against the unsharded port
and against the fake group's counts, and the reference's collectives
for the same tiny steps on a 2 x 4 mesh printed beside the port's.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_spmd_jobs as jobs
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.data import pipeline
from repro_torch.kernels import window_attention_spmd as spmd
from repro_torch.kernels.ref import (decode_window_attention_partial_ref,
                                     decode_window_attention_ref)
from repro_torch.kernels.window_attention import window_attention_partial
from repro_torch.launch import dryrun, sharding, shardctx
from repro_torch.launch.mesh import DeviceMesh, parse_mesh, torch_mesh
from repro_torch.roofline import op_walk

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eager CPU ops beside other test workers: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def replicated():
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def _leaves_match(tree, specs, mesh, tm):
    dt = sharding.distribute_tree(tree, specs, tm)
    got = sharding.flatten(dict(dt.named_parameters())
                           if isinstance(dt, torch.nn.Module) else dt)
    spec_leaves = sharding.flatten(specs)
    assert got
    for k, t in got.items():
        assert shardctx.is_distributed(t), k
        assert tuple(t._local_tensor.shape) == sharding.shard_shape(
            t.shape, spec_leaves[k], mesh), k
        assert tuple(t.placements) == sharding.placements(spec_leaves[k],
                                                          mesh), k
    return len(got)


@pytest.mark.parametrize("mesh_name", ["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_distribute_tree_gives_each_leaf_its_shard_shape(arch, mesh_name):
    """Every leaf of the parameter (FSDP and serving layouts), batch and
    serving-state specs, at the published sizes on meta: the DTensor's
    local block is ``shard_shape`` of its spec, its placements the
    spec's."""
    mesh = parse_mesh(mesh_name)
    cfg = configs.get(arch)
    n = 0
    with torch_mesh(mesh) as tm:
        for fsdp in (True, False):
            params = pipeline.param_specs_struct(cfg)
            n += _leaves_match(params, sharding.param_specs(
                params, cfg, mesh, fsdp=fsdp), mesh, tm)
        shape = INPUT_SHAPES["train_4k"]
        batch = pipeline.train_input_specs(cfg, shape)
        n += _leaves_match(batch, sharding.batch_specs(cfg, shape, mesh,
                                                       batch), mesh, tm)
        for name in ("decode_32k", "long_500k"):
            shape = INPUT_SHAPES[name]
            _, state = pipeline.decode_input_specs(cfg, shape)
            n += _leaves_match(state, sharding.serve_state_specs(
                cfg, shape, mesh, state), mesh, tm)
    assert n > 0


def test_placements_of_a_bundle_and_of_a_resolved_spec():
    from torch.distributed.tensor import Replicate, Shard
    three = parse_mesh("2x2x2")
    assert sharding.placements((("pod", "data"), None, "model"), three) == (
        Shard(0), Shard(0), Shard(2))
    two = parse_mesh("2x4")
    # "model" does not divide 6: resolved away, as the reference's hint
    assert sharding.placements((None, "model"), two, (8, 6)) == (
        Replicate(), Replicate())
    assert sharding.placements((shardctx.DP, "model"), two, (8, 12)) == (
        Shard(0), Shard(1))


def test_torch_mesh_refuses_a_second_group_and_the_one_card_mesh():
    mesh = parse_mesh("1x4")
    with torch_mesh(mesh):
        with pytest.raises(RuntimeError):
            with torch_mesh(mesh):
                pass
    with pytest.raises(ValueError):
        with torch_mesh(parse_mesh("1")):
            pass
    assert not torch.distributed.is_initialized()


def test_hint_is_the_identity_on_plain_tensors():
    x = torch.empty((8, 4, 16), device="meta")
    with shardctx.use_mesh(parse_mesh("2x4")), op_walk.OpWalk() as w:
        assert shardctx.hint(x, shardctx.DP, None, shardctx.TP) is x
        assert shardctx.residual_hint(x) is x
        assert shardctx.heads_hint(x, 4) is x
    assert not w.records


def test_per_device_counts_of_sharded_matmuls(replicated):
    """On 1 x 4: a column-sharded product counts a quarter of the global
    FLOPs and moves nothing; a row-sharded one a quarter too, and making
    its partial output whole is one all-reduce of the output's bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    m, k, n = 8, 64, 128
    with torch_mesh(parse_mesh("1x4")) as tm:
        x = distribute_tensor(torch.empty((m, k), device="meta"), tm,
                              [Replicate(), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty((k, n), device="meta"), tm,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with op_walk.OpWalk() as walk:
            y = x @ w
        c = walk.cost()
        assert c.flops == 2 * m * k * n / 4 and c.coll_bytes == 0
        assert c.bytes == 4 * (m * k + k * n / 4 + m * n / 4)
        xs = distribute_tensor(torch.empty((m, k), device="meta"), tm,
                               [Replicate(), Shard(1)], src_data_rank=None)
        ws = distribute_tensor(torch.empty((k, n), device="meta"), tm,
                               [Replicate(), Shard(0)], src_data_rank=None)
        with op_walk.OpWalk() as walk:
            y = (xs @ ws).redistribute(tm, [Replicate(), Replicate()])
        c = walk.cost()
        assert c.flops == 2 * m * (k / 4) * n
        assert c.breakdown()["counts"]["all-reduce"] == 1
        assert c.coll_bytes == c.coll_by_kind["all-reduce"] == 4 * m * n
        assert tuple(y._local_tensor.shape) == (m, n)


def test_a_dense_decode_step_collectives_by_hand(replicated):
    """One tiny dense decode step on 1 x 4 under the serving layout
    (``fsdp=False``: weights over ``"model"`` only), its cache rows over
    ``"model"`` (4,096 rows).  The collectives written out from the
    layer's shapes and specs (per device, bytes of each output):

    * the tokens looked up in each rank's block of the vocabulary-sharded
      embedding, the partial ``[B, 1, d]`` reduce-scattered to d over
      ``"model"`` (the residual stream's layout);
    * each rmsnorm (two a layer, one final) of the d-sharded residual:
      its mean is a partial, reduce-scattered over the batch ``[B/4, 1,
      1]`` float32 and gathered back ``[B, 1, 1]``;
    * the residual ``[B, d]`` gathered whole before each column-sharded
      product (wq, wk, wv, w_gate, w_up): five all-gathers of ``B d``
      bf16;
    * the new K and V rows ``[B, 1, Hkv, dh]`` and the query ``[B, H,
      dh]`` gathered over the heads for the row-sharded B4 (three);
    * B4's merge: all-reduces of m and l ``[B, H]`` and o ``[B, H, dh]``
      float32;
    * the row-sharded products (wo, w_down): partial ``[B, 1, d]``
      reduce-scattered to d over ``"model"`` (two more);
    * the final residual gathered whole for the vocabulary-sharded
      logits, which stay sharded (one all-gather of ``B d`` bf16)."""
    cfg = dataclasses.replace(configs.get("qwen3-4b").reduced(), n_layers=1,
                              qk_norm=False)
    mesh = DeviceMesh(("data", "model"), (1, 4))
    tp, b, d = 4, 4, cfg.d_model
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    bf, f32 = 2, 4
    want = {
        "all-to-all": [],
        "reduce-scatter": [(3, b // tp * f32), (3, b * d // tp * bf)],
        "all-gather": [(3, b * f32), (5, b * d * bf), (2, b * hkv * dh * bf),
                       (1, b * h * dh * bf), (1, b * d * bf)],
        "all-reduce": [(2, b * h * f32), (1, b * h * dh * f32)],
        "collective-permute": [],
    }
    shape = InputShape("d", 4096, b, "decode")
    with shardctx.use_mesh(mesh), torch_mesh(mesh) as tm:
        walked, _ = dryrun.walk_step(cfg, shape, tm=tm, fsdp=False)
    got = op_walk.cost_from_records(walked.trace).breakdown()
    for kind, parts in want.items():
        assert got["counts"][kind] == sum(n for n, _ in parts), kind
        assert got[kind] == sum(n * nb for n, nb in parts), kind


# ----------------------------------------------------------------------
# the sharded B4
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 16])
def test_row_shard_partials_merge_to_the_whole(n_shards):
    """qwen3-4b's decode heads at a small ring: each shard's partial (the
    wrapper's CPU form, the plain version) at its own lengths, merged,
    against the whole attention, within 1e-6 relative; requests end
    inside a shard and cover less than one, so some shards are empty."""
    gen = torch.Generator().manual_seed(0)
    b, h, hkv, dh, w = 4, 32, 8, 128, 2048
    q = torch.randn((b, h, dh), generator=gen)
    k = torch.randn((b, w, hkv, dh), generator=gen).to(torch.bfloat16)
    v = torch.randn((b, w, hkv, dh), generator=gen).to(torch.bfloat16)
    kv_len = torch.tensor([w, 700, w // n_shards - 5, 1], dtype=torch.int32)
    rows = w // n_shards
    parts = [window_attention_partial(
        q, k[:, s * rows:(s + 1) * rows], v[:, s * rows:(s + 1) * rows],
        torch.clamp(kv_len - s * rows, 0, rows).to(torch.int32))
        for s in range(n_shards)]
    o, m, l = (torch.stack(t) for t in zip(*parts))
    assert bool(torch.isinf(m).any()) and bool((l == 0).any())
    got = spmd.merge_partials(o, m, l)
    want = decode_window_attention_ref(q, k, v, kv_len)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-6, err


def test_a_partial_with_no_row_is_zero_with_minus_inf():
    q = torch.randn((2, 4, 8))
    k = torch.randn((2, 16, 2, 8))
    o, m, l = decode_window_attention_partial_ref(
        q, k, k, torch.tensor([0, 16], dtype=torch.int32))
    assert (o[0] == 0).all() and torch.isinf(m[0]).all() and (l[0] == 0).all()
    np.testing.assert_allclose(
        (o[1] / l[1][..., None]).numpy(),
        decode_window_attention_ref(q, k, k, torch.tensor(
            [16, 16], dtype=torch.int32))[1].numpy(), rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------
# gloo against the unsharded port and the fake group; the reference
# ----------------------------------------------------------------------

CASES = [(name, kind) for name in jobs.TINY for kind in jobs.SHAPES]

_REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.configs.base import InputShape
from repro.data import pipeline
from repro.launch import sharding, shardctx
from repro.optim import adamw
from repro.roofline import analysis
from repro.serve import engine
from repro.train.steps import make_serve_step, make_train_step

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
ns = lambda tree: jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                               is_leaf=lambda x: isinstance(x, P))
shard = lambda tree, specs: jax.tree.map(lambda s, sp: jax.ShapeDtypeStruct(
    s.shape, s.dtype, sharding=NamedSharding(mesh, sp)), tree, specs)
shardctx.set_mesh(mesh)
out = {}
for name, arch, kind, seq, batch in json.loads(sys.argv[2]):
    cfg = configs.get(arch).reduced()
    params = pipeline.param_specs_struct(cfg, jnp.float32)
    ps = sharding.param_specs(params, cfg, mesh, fsdp=True)
    shape = InputShape("x", seq, batch, kind)
    with mesh:
        if kind == "train":
            b = pipeline.train_input_specs(cfg, shape)
            bs = sharding.batch_specs(cfg, shape, mesh, b)
            opt = jax.eval_shape(adamw.init, params)
            os_ = type(opt)(m=ps, v=ps, step=P())
            fn = jax.jit(make_train_step(cfg, adamw.AdamWConfig()),
                         in_shardings=(ns(ps), ns(os_), ns(bs)),
                         out_shardings=(ns(ps), ns(os_), None))
            args = (shard(params, ps), type(opt)(
                m=shard(opt.m, ps), v=shard(opt.v, ps), step=opt.step),
                shard(b, bs))
        else:
            token = jax.ShapeDtypeStruct((batch, 1), jnp.int32)
            state = jax.eval_shape(lambda: engine.init_cache(
                cfg, batch, seq, dtype=jnp.float32))
            ss = sharding.serve_state_specs(cfg, shape, mesh, state)
            ts = sharding.batch_specs(cfg, shape, mesh, {"t": token})["t"]
            fn = jax.jit(make_serve_step(cfg),
                         in_shardings=(ns(ps), ns(ts), ns(ss)),
                         out_shardings=(None, ns(ss)))
            args = (shard(params, ps), jax.ShapeDtypeStruct(
                token.shape, token.dtype, sharding=NamedSharding(mesh, ts)),
                shard(state, ss))
        hlo = fn.lower(*args).compile().as_text()
    first = {}
    for ln in hlo.splitlines():
        for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute"):
            if f" {k}(" in ln or f" {k}-start(" in ln:
                first.setdefault(k, ln.strip().split(", metadata")[0])
    out[f"{name}.{kind}"] = {
        "bytes": analysis.collective_bytes(hlo), "first": first,
        "all_reduce": [ln.split("=")[1].split("all-reduce(")[0].strip()
                       for ln in hlo.splitlines() if " all-reduce(" in ln]}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The DTensor steps on a 2 x 2 gloo mesh (four processes; rank 0 then
    walks them on meta over a fake group of four), and beside them the
    reference compiling the same float32 steps for 2 x 2 host devices
    with its own sharding rules, in a subprocess started first."""
    tmp = tmp_path_factory.mktemp("spmd")
    cases = [(name, jobs.TINY[name], kind, jobs.SHAPES[kind].seq_len,
              jobs.SHAPES[kind].global_batch) for name, kind in CASES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF_SCRIPT),
         str(tmp / "ref.json"), json.dumps(cases)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = jobs.run_gloo(tmp)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return out, json.loads((tmp / "ref.json").read_text())


def _port(out, name, kind, which):
    return {k: tuple(int(x) for x in out[f"{name}.{kind}.{which}.{k}"])
            for k in op_walk.COLLECTIVES}


@pytest.mark.distributed
@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_gloo_steps_equal_the_unsharded_port(gloo, case):
    """The training step's loss and the decode step's logits and caches
    (the ring insert into row shards) within 1e-5 relative of the same
    step unsharded."""
    out, _ = gloo
    name, kind = case
    keys = ["loss"] if kind == "train" else ["logits", "cache_k", "cache_v"]
    for k in keys:
        got, want = out[f"{name}.{kind}.{k}"], out[f"{name}.{kind}.{k}.plain"]
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (k, err)


@pytest.mark.distributed
@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_gloo_collectives_equal_the_fake_groups(gloo, case):
    """Rank 0's collectives under gloo, kind by kind and byte for byte,
    are the fake group's: the dry run counts what a real group runs."""
    out, _ = gloo
    got = _port(out, *case, "coll")
    assert got == _port(out, *case, "fake")
    assert sum(n for n, _ in got.values()) > 0


def _shape_of(hlo_type: str) -> tuple:
    """``f32[2,4,1]{...}`` -> ``("f32", (2, 4, 1))``."""
    dt, _, rest = hlo_type.partition("[")
    dims = rest.split("]")[0]
    return dt, tuple(int(x) for x in dims.split(",") if x)


@pytest.mark.distributed
@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_reference_collectives_beside_the_ports(gloo, case):
    """The reference's ``collective_bytes`` by kind for the same step,
    printed beside the port's (one device's).  Both programs merge the
    decode attention's row shards alike: per layer an all-reduce max of
    m and sums of l (``[B/2, H]`` float32; XLA's ``[B/2, Hkv, n_rep]``)
    and of o (and ``dh``) over ``"model"``, which is asserted.  The other
    differences are standing items of ROADMAP.md's queue C (XLA gathers
    FSDP weights where DTensor contracts over the data axis; it all-gathers
    the embedding where DTensor exchanges it all-to-all; ``collective_bytes``
    counts the scanned layer's ops once)."""
    out, ref = gloo
    name, kind = case
    mine = ref[f"{name}.{kind}"]["bytes"]
    port = _port(out, name, kind, "fake")
    print(f"{name} {kind}: " + ", ".join(
        f"{k} ref {mine[k]} ({mine['counts'][k]}) / port {port[k][1]} "
        f"({port[k][0]})" for k in op_walk.COLLECTIVES))
    for k, line in ref[f"{name}.{kind}"]["first"].items():
        print(f"  the reference's first {k}: {line}")
    assert mine["total"] > 0
    if kind != "decode":
        return
    cfg = jobs.tiny(name)
    bl, h, hkv = jobs.SHAPES[kind].global_batch // 2, cfg.n_heads, \
        cfg.n_kv_heads
    grouped = (bl, hkv, h // hkv)
    want = [("f32", grouped)] * 2 + [("f32", grouped + (cfg.dh,))]
    seen = [_shape_of(t) for t in ref[f"{name}.{kind}"]["all_reduce"]]
    for w in want:
        assert w in seen, (w, seen)
    merged = json.loads(str(out[f"{name}.{kind}.fake.all_reduce"]))
    layers = {n for op, shp, n in merged if shp[:2] == [bl, h]}
    got = sorted((op, math.prod(shp) * 4) for op, shp, _ in merged
                 if shp[:2] == [bl, h])
    assert layers == {cfg.n_layers}
    assert got == sorted([("max", 4 * bl * h), ("sum", 4 * bl * h),
                          ("sum", 4 * bl * h * cfg.dh)])
