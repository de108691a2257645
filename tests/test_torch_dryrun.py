"""The port's dry run: the op walker (``roofline.op_walk``) on known
answers, the walk on meta tensors equal to the same walk on CPU tensors
for every architecture's reduced config and step kind, the prefill's
depth extrapolation equal to a walk of every layer, ``model_flops``
equal to the reference's, the CLI on full-size combinations of the
16x16 mesh and of one card, and ``reanalyze`` reproducing the rows from
the cached op traces.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.data import pipeline
from repro_torch.kernels import window_attention as wa
from repro_torch.launch import dryrun, shardctx
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.roofline import analysis, op_walk, reanalyze
from repro_torch.serve import engine as serve_engine
from repro_torch.train.steps import param_dict


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eager CPU ops beside other test workers: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(fn):
    with op_walk.OpWalk() as w:
        out = fn()
    return w, out


# ----------------------------------------------------------------------
# known answers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_product_costs_2mnk(device):
    m, k, n = 48, 32, 20
    a = torch.empty((m, k), device=device)
    b = torch.empty((k, n), device=device)
    w, _ = _walk(lambda: a @ b)
    c = w.cost()
    assert c.flops == 2 * m * n * k
    assert c.bytes == 4 * (m * k + k * n + m * n)
    x = torch.empty((3, m, k), device=device)
    w, _ = _walk(lambda: torch.einsum("bmk,kn->bmn", x, b))
    assert w.cost().flops == 2 * 3 * m * n * k


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_elementwise_ops_count_per_element(device):
    x = torch.empty((64, 16), device=device)
    s = torch.empty((1, 16), device=device)
    w, _ = _walk(lambda: x + s)
    c = w.cost()
    assert c.flops == 64 * 16
    # the broadcast operand is read once: its 16 values, not 64 x 16
    assert c.bytes == 4 * (64 * 16 + 16 + 64 * 16)
    w, _ = _walk(lambda: torch.exp(x))
    assert w.cost().flops == 4 * 64 * 16
    w, _ = _walk(lambda: torch.rsqrt(x))
    assert w.cost().flops == 2 * 64 * 16
    w, _ = _walk(lambda: x.sum(-1))
    assert w.cost().flops == 64 * 16


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_views_cost_nothing(device):
    x = torch.empty((8, 6, 4), device=device)
    w, _ = _walk(lambda: x[2:5].reshape(3, 24).transpose(0, 1)[:, :2]
                 .unsqueeze(0).expand(5, 24, 2))
    c = w.cost()
    assert (c.flops, c.bytes) == (0, 0)
    assert w.peak_bytes == 0
    # a reshape that must copy is a copy: read and written once
    w, _ = _walk(lambda: x[2:5].transpose(0, 1).reshape(6, 12))
    assert w.cost().bytes == 2 * 3 * 6 * 4 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_in_place_slice_writes_cost_the_bytes_written(device):
    buf = torch.zeros((1000, 8), device=device)
    v = torch.ones((4, 8), device=device)

    def write():
        buf[3:7] = v
    w, _ = _walk(write)
    assert w.cost().bytes == 2 * 4 * 8 * 4       # not the 32,000-byte buffer
    idx = torch.tensor([5, 9, 700], device=device)
    vals = torch.ones((3, 8), device=device)

    def put():
        buf[idx] = vals
    w, _ = _walk(put)
    assert w.cost().bytes == 2 * 3 * 8 * 4 + 3 * 8


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_follows_storages_until_freed(device):
    a = torch.empty((256,), device=device)

    def run():
        b = a * 2                 # 1,024 bytes
        c = b.exp()               # 2,048 live
        del b
        d = c + 1                 # 2,048 live again
        return d
    w, d = _walk(run)
    assert w.peak_bytes == 2048
    assert w.live_bytes == 1024


def test_adopted_arguments_stop_counting_when_replaced():
    state = {"m": torch.empty((100,), device="meta"),
             "v": torch.empty((100,), device="meta")}
    with op_walk.OpWalk() as w:
        w.adopt(state.values())
        for _ in range(3):
            for k in state:
                # the new moment exists beside the old one, then the old
                # one is freed: one leaf above the arguments at most
                state[k] = state[k] * 0.9
    assert w.base_bytes == 800
    assert w.temp_bytes == 400
    assert w.live_bytes == 800


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_attention_kernel_counts_its_own_work(device):
    """B4 is one record with ``attention_work`` at the full window on the
    CPU (its plain version) and on meta (its meta form), the same."""
    b, h, hkv, w_, dh = 2, 4, 2, 16, 8
    q = torch.zeros((b, h, dh), device=device)
    k = torch.zeros((b, w_, hkv, dh), dtype=torch.bfloat16, device=device)
    lens = torch.full((b,), w_, dtype=torch.int32, device=device)
    w, out = _walk(lambda: wa.window_attention(q, k, k, lens))
    assert out.shape == (b, h, dh) and out.dtype == torch.float32
    assert out.device.type == device
    nbytes, flops = wa.attention_work(b * w_, b, h, hkv, dh, 2)
    c = w.cost()
    assert (c.flops, c.bytes) == (flops, nbytes)
    assert [r[0] for r, _ in w.trace()] == ["kernel.window_attention"]
    assert w.peak_bytes == b * h * dh * 4


def test_meta_attention_takes_the_reference_signature():
    q = torch.empty((6, 32), device="meta")
    k = torch.empty((6, 100, 32), device="meta")
    lens = torch.empty((6,), dtype=torch.int32, device="meta")
    out = wa.decode_window_attention(q, k, k, lens)
    assert out.shape == (6, 32) and out.device.type == "meta"
    assert wa.window_attention.launches == 0


# ----------------------------------------------------------------------
# meta equals CPU, step by step
# ----------------------------------------------------------------------

SMALL = {"train": InputShape("t", 64, 2, "train"),
         "prefill": InputShape("p", 64, 2, "prefill"),
         "decode": InputShape("d", 128, 2, "decode")}


def _cpu_args(cfg, shape):
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    if shape.kind == "decode":
        token = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
        state = serve_engine.init_cache(cfg, shape.global_batch,
                                        shape.seq_len, device="cpu")
        return {"params": params, "token": token, "state": state}
    batch = pipeline.make_batch(cfg, shape.global_batch, shape.seq_len,
                                device="cpu")
    if shape.kind == "prefill":
        batch.pop("labels")
        return {"params": params, "batch": batch}
    return {"params": params, "opt": adamw.init(param_dict(params)),
            "batch": batch}


def _run(cfg, shape, args):
    from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                         make_train_step)
    if shape.kind == "train":
        step = make_train_step(cfg, adamw.AdamWConfig())
        return dryrun.walk(lambda: step(args["params"], args["opt"],
                                        args["batch"]), args)
    if shape.kind == "prefill":
        return dryrun.walk(lambda: make_prefill_step(cfg)(
            args["params"], args["batch"]), args)
    return dryrun.walk(lambda: make_serve_step(cfg)(
        args["params"], args["token"], args["state"]), args)


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("kind", list(SMALL))
def test_meta_walk_equals_cpu_walk(arch, kind):
    """The same step on meta inputs and on real CPU inputs: the same op
    records with the same counts, so the same FLOPs and bytes, and the
    same peak and output bytes."""
    cfg = configs.get(arch).reduced()
    shape = SMALL[kind]
    meta, _ = dryrun.walk_step(cfg, shape, extrapolate_prefill=False)
    cpu = _run(cfg, shape, _cpu_args(cfg, shape))
    assert dict(meta.trace) == dict(cpu.trace)
    cm, cc = (op_walk.cost_from_records(w.trace) for w in (meta, cpu))
    assert (cm.flops, cm.bytes) == (cc.flops, cc.bytes) and cm.flops > 0
    assert (meta.peak_bytes, meta.output_bytes) == (cpu.peak_bytes,
                                                    cpu.output_bytes)


@pytest.mark.parametrize("arch, seq", [("qwen3-4b", 3072),
                                       ("falcon-mamba-7b", 512)])
def test_meta_walk_equals_cpu_walk_on_the_long_paths(arch, seq):
    """A training step past the flash threshold (each query chunk
    checkpointed) and over two Mamba scan chunks: the same FLOPs, bytes
    and peak on meta and on the CPU (a few intermediate strides differ
    between the two, not the counts)."""
    cfg = configs.get(arch).reduced()
    shape = InputShape("t", seq, 1, "train")
    meta, _ = dryrun.walk_step(cfg, shape)
    cpu = _run(cfg, shape, _cpu_args(cfg, shape))
    cm, cc = (op_walk.cost_from_records(w.trace) for w in (meta, cpu))
    assert (cm.flops, cm.bytes) == (cc.flops, cc.bytes)
    assert (meta.peak_bytes, meta.output_bytes) == (cpu.peak_bytes,
                                                    cpu.output_bytes)


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-1.5-large-398b"])
def test_prefill_extrapolated_in_depth_equals_every_layer(arch):
    """A prefill walked at two and three periods and extrapolated equals
    the walk of all of them: each record's count and the peak."""
    base = configs.get(arch).reduced()
    period = base.attn_every if base.arch_type == "hybrid" else 1
    cfg = dataclasses.replace(base, n_layers=5 * period)
    shape = InputShape("p", 64, 2, "prefill")
    direct, _ = dryrun.walk_step(cfg, shape, extrapolate_prefill=False)
    extra, _ = dryrun.walk_step(cfg, shape)
    assert extra.layers == (2 * period, 3 * period)
    assert dict(extra.trace) == dict(direct.trace)
    assert extra.peak_bytes == direct.peak_bytes


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_model_flops_equal_the_reference(arch, shape_name):
    from repro import configs as ref_configs
    from repro.roofline import analysis as ref_analysis
    assert analysis.model_flops(configs.get(arch), INPUT_SHAPES[shape_name]) \
        == ref_analysis.model_flops(ref_configs.get(arch),
                                    ref_configs.INPUT_SHAPES[shape_name])


def test_roofline_terms_on_the_h100():
    rf = analysis.Roofline("x", "1", 1, hlo_flops=989e12, hlo_bytes=6.7e12,
                           coll_bytes=0.0, model_flops=494.5e12,
                           bytes_per_chip=1e9)
    assert (rf.t_compute, rf.t_memory, rf.t_collective) == (1.0, 2.0, 0.0)
    assert rf.bottleneck == "memory" and rf.usefulness == 0.5
    assert set(rf.row()) == {
        "name", "mesh", "chips", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "model_flops", "hlo_flops",
        "usefulness", "hbm_per_chip_gb"}
    pod = analysis.Roofline("x", "16x16", 256, hlo_flops=256 * 989e12,
                            hlo_bytes=256 * 3.35e12,
                            coll_bytes=256 * 3 * 450e9, model_flops=1.0,
                            bytes_per_chip=1.0)
    assert (pod.t_compute, pod.t_memory, pod.t_collective) == (1.0, 1.0, 3.0)
    assert pod.bottleneck == "collective"


# ----------------------------------------------------------------------
# the CLI at full size, and reanalyze
# ----------------------------------------------------------------------

CLI_CASES = [("stablelm-3b", "decode_32k", "16x16"),
             ("falcon-mamba-7b", "prefill_32k", "16x16"),
             ("qwen3-4b", "long_500k", "1")]


@pytest.fixture(scope="module")
def cli_rows(tmp_path_factory):
    """The dry-run CLI on each case, traces under a temporary results
    directory; returns (rows, stdout per case, the directory)."""
    import contextlib
    import io
    import os
    out_dir = tmp_path_factory.mktemp("dryrun")
    prev = os.environ.get("REPRO_TORCH_RESULTS_DIR")
    os.environ["REPRO_TORCH_RESULTS_DIR"] = str(out_dir)
    rows, logs = {}, {}
    try:
        for arch, shape, mesh in CLI_CASES:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                                  mesh, "--out",
                                  str(out_dir / f"rows_{mesh}.jsonl")])
            logs[(arch, shape, mesh)] = (rc, buf.getvalue())
        for mesh in ("16x16", "1"):
            with open(out_dir / f"rows_{mesh}.jsonl") as f:
                for line in f:
                    row = json.loads(line)
                    rows[(row["name"], row["mesh"])] = row
    finally:
        if prev is None:
            os.environ.pop("REPRO_TORCH_RESULTS_DIR")
        else:
            os.environ["REPRO_TORCH_RESULTS_DIR"] = prev
    return rows, logs, out_dir


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: "-".join(c))
def test_cli_dry_runs_a_full_size_combination(cli_rows, case):
    rows, logs, out_dir = cli_rows
    arch, shape, mesh = case
    rc, text = logs[case]
    assert rc == 0 and "1/1 combinations dry-run successfully" in text, text
    row = rows[(f"{arch}:{shape}", mesh)]
    assert "error" not in row
    cfg, sh = configs.get(arch), INPUT_SHAPES[shape]
    assert row["model_flops"] == analysis.model_flops(cfg, sh)
    assert row["hlo_flops"] > 0 and row["t_memory_s"] > 0
    assert row["hlo"]["flops"] == int(row["hlo_flops"])
    mem = row["memory"]
    assert row["hbm_per_chip_gb"] == pytest.approx(mem["argument_gb"]
                                                   + mem["temp_gb"])
    assert (out_dir / "optrace" / f"{arch}__{shape}__{mesh}.jsonl.gz").exists()
    if mesh == "1":
        assert row["chips"] == 1 and row["t_collective_s"] == 0.0
        assert row["hlo"]["coll_bytes"] == 0
        assert "coll_breakdown" not in row["hlo"]
        # one card holds every argument whole
        model = pipeline.param_specs_struct(cfg)
        params = sum(p.numel() * p.element_size() for p in model.parameters())
        assert mem["argument_gb"] * 1e9 > params
    else:
        # one device's walk of the partitioned step, times the chips
        assert row["chips"] == 256 and row["t_collective_s"] > 0
        br = row["hlo"]["coll_breakdown"]
        assert row["hlo"]["coll_bytes"] == br["total"] > 0
        assert set(br) == set(op_walk.COLLECTIVES) | {"counts", "total"}
        assert sum(br[k] for k in op_walk.COLLECTIVES) == br["total"]
        assert row["t_collective_s"] == pytest.approx(
            br["total"] / (256 * analysis.LINK_BW))
        assert row["bottleneck"] in ("compute", "memory", "collective")


def test_cli_decode_counts_the_attention_kernel(cli_rows):
    rows, _, _ = cli_rows
    row = rows[("stablelm-3b:decode_32k", "16x16")]
    assert row["bytes_by_op"]["kernel.window_attention"] > 0


@pytest.mark.parametrize("mesh", ["16x16", "1"])
def test_reanalyze_reproduces_the_rows(cli_rows, mesh):
    rows, _, out_dir = cli_rows
    out = out_dir / f"re_{mesh}.jsonl"
    reanalyze.main(["--trace-dir", str(out_dir / "optrace"), "--mesh", mesh,
                    "--out", str(out), "--merge-from",
                    str(out_dir / f"rows_{mesh}.jsonl")])
    with open(out) as f:
        again = [json.loads(line) for line in f]
    assert len(again) == sum(1 for c in CLI_CASES if c[2] == mesh)
    for row in again:
        want = rows[(row["name"], row["mesh"])]
        for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                    "bottleneck", "model_flops", "hlo_flops", "usefulness",
                    "hbm_per_chip_gb", "hlo", "bytes_by_op", "memory",
                    "ops"):
            assert row[key] == want[key], key


@pytest.mark.parametrize("arch, kind", [("qwen3-moe-235b-a22b", "train"),
                                        ("qwen3-4b", "decode"),
                                        ("falcon-mamba-7b", "prefill")])
def test_one_card_rows_do_not_see_the_hints(arch, kind, monkeypatch):
    """On one card the hints add nothing: the row's FLOPs, bytes and peak
    equal a walk of the same step with ``shardctx``'s hints replaced by
    the identity, and the walk has no collective record."""
    cfg = configs.get(arch).reduced()
    shape = SMALL[kind]
    row = dryrun.dry_run(cfg, shape, parse_mesh("1"), verbose=False)
    with_hints, _ = dryrun.walk_step(cfg, shape)
    for name in ("hint", "residual_hint", "heads_hint"):
        monkeypatch.setattr(shardctx, name, lambda x, *a: x)
    without, _ = dryrun.walk_step(cfg, shape)
    assert dict(with_hints.trace) == dict(without.trace)
    assert with_hints.peak_bytes == without.peak_bytes
    cost = op_walk.cost_from_records(without.trace)
    assert (row["hlo_flops"], row["hlo"]["hbm_bytes"]) == (
        cost.flops, int(cost.bytes))
    assert row["memory"]["temp_gb"] == without.peak_bytes / 1e9
    assert not any(rec[0].startswith("c10d.") for rec, _ in without.trace)
    assert row["t_collective_s"] == 0.0 and cost.coll_bytes == 0


def test_cli_needs_a_combination():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-4b"])
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--mesh", "1", "--multi-pod"])


def test_dry_run_of_a_custom_config_on_one_card():
    """``dry_run`` takes any config and shape (the card's phase 23 uses
    its own): on one card the arguments are every tensor's bytes."""
    cfg = dataclasses.replace(configs.get("qwen3-4b").reduced(), n_layers=1)
    shape = InputShape("b4", 256, 4, "decode")
    row = dryrun.dry_run(cfg, shape, parse_mesh("1"), name="x:b4",
                         verbose=False)
    token, state = pipeline.decode_input_specs(cfg, shape)
    model = pipeline.param_specs_struct(cfg)
    want = sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + [token] + [
                   v for v in dryrun._tensors(state)])
    assert row["memory"]["argument_gb"] * 1e9 == pytest.approx(want)
    assert row["name"] == "x:b4" and row["layers_walked"] == [1]
