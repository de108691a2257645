"""The port's sharding rules and dry-run input specs against the
reference's, for every architecture (full and reduced), input shape and
mesh.

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a ``SimpleNamespace`` with an empty array of
the mesh's shape stands in for its 256- and 512-device meshes (no host
devices needed).  Its specs see layers stacked on a leading axis; the
port's see one module a layer, so a stacked leaf's spec is compared
without its leading entry (always replicated), through
``interop._stacked_name``.  Serving states are stacked in both packages
and compare directly.
"""
import functools
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro import configs as ref_configs                       # noqa: E402
from repro.data import pipeline as ref_pipeline                # noqa: E402
from repro.launch import mesh as ref_mesh                      # noqa: E402
from repro.launch import sharding as ref_sharding              # noqa: E402

from repro_torch import configs                                # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES              # noqa: E402
from repro_torch.data import pipeline                          # noqa: E402
from repro_torch.interop import _stacked_name                  # noqa: E402
from repro_torch.launch import mesh as port_mesh               # noqa: E402
from repro_torch.launch import sharding, shardctx              # noqa: E402

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4))}
SIZES = ("full", "reduced")


def _ref_mesh(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _port_mesh(name):
    return port_mesh.DeviceMesh(*MESHES[name])


def _cfgs(arch, size):
    ref, port = ref_configs.get(arch), configs.get(arch)
    return (ref.reduced(), port.reduced()) if size == "reduced" else (ref,
                                                                     port)


@functools.lru_cache(maxsize=None)
def _params(arch, size):
    ref_cfg, port_cfg = _cfgs(arch, size)
    return (ref_pipeline.param_specs_struct(ref_cfg),
            pipeline.param_specs_struct(port_cfg))


def _flat(tree):
    """A reference pytree's leaves keyed by their dotted dict path."""
    import jax
    from jax.sharding import PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {".".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf for path, leaf in flat}


def _entry(e):
    return tuple(e) if isinstance(e, (list, tuple)) else e


def _spec(p):
    return tuple(_entry(e) for e in p)


def _unstacked(ref_spec, stacked: bool):
    """The reference's spec of a stacked leaf without its layer axis."""
    spec = _spec(ref_spec)
    if stacked and spec:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("size", SIZES)
def test_param_struct_matches_reference(arch, size):
    """``param_specs_struct``: every reference leaf, and each port
    parameter with the reference's shape (less the stack axis) and
    dtype, on meta."""
    ref, port = _params(arch, size)
    ref_flat = _flat(ref)
    seen = set()
    for name, p in port.named_parameters():
        key, stack, _ = _stacked_name(name)
        want = ref_flat[key]
        shape = want.shape[1:] if stack is not None else want.shape
        assert tuple(p.shape) == tuple(shape), name
        assert str(p.dtype).split(".")[-1] == str(want.dtype), name
        assert p.device.type == "meta"
        seen.add(key)
    assert seen == set(ref_flat)


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "serving"])
def test_param_specs_match_reference(arch, size, mesh, fsdp):
    ref, port = _params(arch, size)
    ref_cfg, port_cfg = _cfgs(arch, size)
    want = _flat(ref_sharding.param_specs(ref, ref_cfg, _ref_mesh(mesh),
                                          fsdp=fsdp))
    got = sharding.param_specs(port, port_cfg, _port_mesh(mesh), fsdp=fsdp)
    assert set(got) == {n for n, _ in port.named_parameters()}
    for name, spec in got.items():
        key, stack, _ = _stacked_name(name)
        assert spec == _unstacked(want[key], stack is not None), name


# ----------------------------------------------------------------------
# batches and serving states
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs(arch, size, shape_name):
    ref_cfg, port_cfg = _cfgs(arch, size)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "decode":
        return (ref_pipeline.decode_input_specs(ref_cfg, shape),
                pipeline.decode_input_specs(port_cfg, shape))
    ref_b = ref_pipeline.train_input_specs(ref_cfg, shape)
    port_b = pipeline.train_input_specs(port_cfg, shape)
    if shape.kind == "prefill":
        ref_b.pop("labels")
        port_b.pop("labels")
    return ref_b, port_b


def _same_struct(ref_leaf, port_leaf, what):
    assert tuple(port_leaf.shape) == tuple(ref_leaf.shape), what
    assert str(port_leaf.dtype).split(".")[-1] == str(ref_leaf.dtype), what
    assert port_leaf.device.type == "meta", what


def _state_leaves(state):
    """A reference ``ServeState``'s leaves by field (``{}`` parts left
    out), in the port's ``sharding.flatten`` keys."""
    out = {}
    for f in ("cache_k", "cache_v", "cache_len", "mem_k", "mem_v"):
        part = getattr(state, f)
        if not isinstance(part, dict):
            out[f] = part
    out.update({f"mamba_state.{k}": v for k, v in state.mamba_state.items()})
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_input_specs_match_reference(arch, size, shape_name):
    """``train_input_specs`` / ``decode_input_specs``: the reference's
    keys, shapes and dtypes, as meta tensors."""
    ref, port = _inputs(arch, size, shape_name)
    if INPUT_SHAPES[shape_name].kind == "decode":
        (ref_tok, ref_state), (port_tok, port_state) = ref, port
        _same_struct(ref_tok, port_tok, "token")
        want, got = _state_leaves(ref_state), sharding.flatten(port_state)
    else:
        want, got = ref, port
    assert set(got) == set(want)
    for k in want:
        _same_struct(want[k], got[k], k)


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_state_specs_match_reference(arch, size, shape_name,
                                               mesh):
    ref_cfg, port_cfg = _cfgs(arch, size)
    shape = INPUT_SHAPES[shape_name]
    ref_shape = ref_configs.INPUT_SHAPES[shape_name]
    rm, pm = _ref_mesh(mesh), _port_mesh(mesh)
    ref, port = _inputs(arch, size, shape_name)
    if shape.kind == "decode":
        (ref_tok, ref_state), (port_tok, port_state) = ref, port
        want = {"t": _spec(ref_sharding.batch_specs(
            ref_cfg, ref_shape, rm, {"t": ref_tok})["t"])}
        want.update({k: _spec(v) for k, v in _state_leaves(
            ref_sharding.serve_state_specs(ref_cfg, ref_shape, rm,
                                           ref_state)).items()})
        got = {"t": sharding.batch_specs(port_cfg, shape, pm,
                                         {"t": port_tok})["t"]}
        got.update(sharding.flatten(sharding.serve_state_specs(
            port_cfg, shape, pm, port_state)))
    else:
        want = {k: _spec(v) for k, v in ref_sharding.batch_specs(
            ref_cfg, ref_shape, rm, ref).items()}
        got = sharding.batch_specs(port_cfg, shape, pm, port)
    assert got == want


# ----------------------------------------------------------------------
# meshes, resolution and per-device sizes
# ----------------------------------------------------------------------

def test_production_meshes_are_the_references():
    one = port_mesh.make_production_mesh()
    two = port_mesh.make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.size, one.name) == (
        ("data", "model"), (16, 16), 256, "16x16")
    assert (two.axis_names, two.shape, two.size, two.name) == (
        ("pod", "data", "model"), (2, 16, 16), 512, "2x16x16")
    card = port_mesh.parse_mesh("1")
    assert (card.axis_names, card.size, card.name) == ((), 1, "1")
    assert port_mesh.parse_mesh("2x16x16") == two
    for name in MESHES:
        assert port_mesh.data_axes(_port_mesh(name)) == \
            ref_mesh.data_axes(_ref_mesh(name))
    with pytest.raises(ValueError):
        port_mesh.parse_mesh("4x4x4x4")


def test_one_card_mesh_replicates_everything():
    cfg = configs.get("qwen3-4b").reduced()
    model = pipeline.param_specs_struct(cfg)
    card = port_mesh.parse_mesh("1")
    specs = sharding.param_specs(model, cfg, card)
    assert all(ax is None for s in specs.values() for ax in s)
    full = sum(p.numel() * p.element_size() for p in model.parameters())
    assert sharding.tree_bytes(model, specs, card) == full


@pytest.mark.parametrize("shape, spec, want", [
    ((256, 4096, 2560), (shardctx.DP, None, shardctx.TP),
     ("data", None, "model")),
    ((1, 4096, 2560), (shardctx.DP, None, shardctx.TP), (None, None, "model")),
    ((256, 4096, 100), (shardctx.DP, shardctx.TP, None),
     ("data", "model", None)),
    ((8, 7, 30), (shardctx.DP, shardctx.TP, None), (None, None, None)),
    ((64, 2), ("absent", None), (None, None)),
])
def test_resolve_drops_missing_and_non_dividing_axes(shape, spec, want):
    """The reference's ``shardctx.hint`` rule on the 16x16 mesh."""
    assert sharding.resolve(shape, spec, _port_mesh("16x16")) == want


def test_resolve_keeps_the_bundle_on_two_pods():
    two = _port_mesh("2x16x16")
    assert sharding.resolve((256, 8, 32), (shardctx.DP, None, shardctx.TP),
                            two) == (("pod", "data"), None, "model")
    assert sharding.shard_factor((("pod", "data"), None, "model"), two) == 512
    assert sharding.shard_shape((256, 8, 32),
                                (("pod", "data"), None, "model"), two) == (
        8, 8, 2)


def test_residual_layout_sets_the_spec():
    try:
        assert shardctx.residual_spec() == (shardctx.DP, None, shardctx.TP)
        shardctx.set_residual_layout("seq")
        assert shardctx.residual_spec() == (shardctx.DP, shardctx.TP, None)
        with pytest.raises(ValueError):
            shardctx.set_residual_layout("heads")
    finally:
        shardctx.set_residual_layout("d")
    mesh = _port_mesh("2x4")
    with shardctx.use_mesh(mesh):
        assert shardctx.get_mesh() is mesh
    assert shardctx.get_mesh() is None


def test_shard_bytes_divide_by_the_spec():
    t = torch.empty((32, 64, 8), dtype=torch.bfloat16, device="meta")
    mesh = _port_mesh("2x4")
    assert sharding.shard_bytes(t, ("data", "model", None), mesh) == \
        16 * 16 * 8 * 2
    assert sharding.shard_bytes(t, (), mesh) == 32 * 64 * 8 * 2
