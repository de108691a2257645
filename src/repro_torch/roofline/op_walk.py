"""The op walker: FLOPs, HBM bytes and peak live bytes of a step, counted
op by op as the step runs (the counterpart of the reference's
``roofline.hlo_parse``, which walks compiled HLO text).

The port has no compiler between the model code and the card: every
eager ATen op is a kernel launch.  So ``OpWalk``, a
``TorchDispatchMode``, sees exactly the port's kernels and counts them:

* matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, attention) by the formulas registered in
  ``torch.utils.flop_counter``, read directly;
* elementwise arithmetic at 1 FLOP an output element, transcendentals
  at the reference's per-element counts (``exp`` 4, ``rsqrt`` 2,
  ``tanh`` 6, ...), activations as their parts (``silu`` = logistic +
  multiply), reductions at their per-input-element counts; data
  movement at 0;
* bytes as each op's operands plus its outputs (a tensor's bytes are
  its view's: a broadcast dimension is read once); views and
  allocations cost 0; a gather charges the rows it reads (2 x output +
  indices), and an in-place write into a slice the bytes written
  (``index_put_``: 2 x values + indices), as the reference's
  ``dynamic-update-slice`` rule does;
* peak bytes: every storage an op creates is live until its storage is
  freed (a ``weakref.finalize`` on it), so autograd's saved tensors
  count as long as autograd holds them.  The step's arguments are
  adopted before it runs (``adopt``): they are live from the start, and
  an argument the step replaces (AdamW's moments) stops counting when
  it is freed.  ``temp_bytes`` is the peak above them.

A hand-written kernel is counted by its own work, not by the ops its
wrapper issues around the launch: the wrapper calls ``kernel(...)``,
which pauses the walk for the launch and charges the declared FLOPs and
bytes and the outputs' storages.  Its plain CPU version and its meta
form are counted the same way, so a step counts alike on meta, the CPU
and the card.

Ops run on meta tensors as well as real ones, and identical ops
(name, shapes, dtypes and scalars) are counted once with a count, so a
whole published-size step walks in seconds to minutes; on meta a
functional op seen before at the same specs gets its outputs from
``empty_strided`` instead of its (Python) meta kernel.  The records
(``OpWalk.trace()``) are the op trace ``reanalyze`` re-walks.

On DTensors (the partitioned dry run) the walk counts one device's
program, as the reference walks one device's HLO: an op on DTensors is
handed back to DTensor (``NotImplemented``), which runs it on the local
shards -- those ops, at their local shapes, are what is counted, and
the local storages are what is live -- and each collective DTensor
issues (a ``_c10d_functional`` op) is a record of its own: its output
bytes, one device's, in ``coll_bytes`` and ``coll_breakdown`` under the
reference's five kinds, and its operands and output in the HBM bytes
(the reference's rule).  ``wait_tensor`` is free.  DTensor's
``Shard(i) -> Shard(j)`` is recorded as one all-to-all of its bytes,
whatever the process group runs for it (a CPU group runs an all-gather
and a chunk).  One device has no collective, so ``coll_bytes`` is 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# per element of the output
_ARITH_1FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "sign", "floor", "ceil", "round",
    "trunc", "clamp", "clamp_min", "clamp_max", "remainder", "fmod", "pow",
    "atan2", "reciprocal", "masked_fill", "isfinite", "isnan", "isinf",
    "threshold_backward", "relu", "sgn", "hardtanh",
}
_ARITH_XFLOP = {
    "exp": 4, "exp2": 4, "log": 4, "log2": 4, "rsqrt": 2, "sqrt": 2,
    "tanh": 6, "sigmoid": 6, "cos": 4, "sin": 4, "expm1": 4, "log1p": 4,
    "erf": 6, "addcmul": 2, "addcdiv": 2, "lerp": 2,
    # activations and their gradients as their parts
    "silu": 7, "gelu": 9, "softplus": 9, "_softmax": 6, "_log_softmax": 6,
    "silu_backward": 10, "gelu_backward": 14, "sigmoid_backward": 2,
    "tanh_backward": 2, "_softmax_backward_data": 3,
    "_log_softmax_backward_data": 6,
}
# per element of the first input
_REDUCE_FLOP = {
    "sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
    "prod": 1, "argmax": 1, "argmin": 1, "all": 1, "any": 1, "cumsum": 1,
    "cumprod": 1, "logsumexp": 6, "norm": 2, "linalg_vector_norm": 2,
    "var": 3, "std": 3, "var_mean": 3, "topk": 1, "sort": 1,
}
# ops that allocate, alias or describe and move no bytes (not recorded)
_FREE = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_fused_sdp_choice", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_local_scalar_dense",
    "lift_fresh", "detach", "alias", "_unsafe_view", "set_",
    "record_stream", "resize_",
}
# reads indexed rows of a table: charged the rows, not the table
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
# writes indexed rows in place: charged the rows written and read
_SCATTER = {"index_put_", "index_put", "_index_put_impl_", "index_copy_",
            "index_copy", "index_add_", "index_add", "scatter_", "scatter",
            "scatter_add_", "scatter_add", "index_fill_", "masked_scatter_"}
# writes a whole (view of a) tensor without reading it first
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "random_", "bernoulli_"}
# the reference's five collective kinds (``collective_bytes``), by the
# ``_c10d_functional`` op that issues each
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
# collective namespaces, and their ops that move nothing
_COLL_NAMESPACES = ("_c10d_functional", "_dtensor")
_COLL_FREE = {"wait_tensor", "_wrap_tensor_autograd"}

# ----------------------------------------------------------------------
# Records: an op's name and its arguments with tensors as specs
# ----------------------------------------------------------------------

_DTYPE_NAME = {getattr(torch, n): n for n in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "bool", "complex64", "complex128", "float8_e4m3fn",
    "float8_e5m2", "uint16", "uint32", "uint64")}
_ITEMSIZE = {n: d.itemsize for d, n in _DTYPE_NAME.items()}


def _view_bytes(spec) -> int:
    """The bytes of the elements a view addresses (a stride-0 dimension,
    a broadcast, counts once)."""
    _, shape, stride, dtype = spec
    n = 1
    for d, st in zip(shape, stride):
        if d == 0:
            return 0
        if st != 0:
            n *= d
    return n * _ITEMSIZE[dtype]


def _encode(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), _DTYPE_NAME[x.dtype])
    if isinstance(x, (list, tuple)):
        return tuple([_encode(y) for y in x])
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.device):
        return "device"      # a record is the same on every device
    return str(x)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 4 and x[0] == "T"


def _specs(x):
    """Every tensor spec in an encoded argument, depth first."""
    if _is_spec(x):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _specs(y)


def _numel(spec) -> int:
    return math.prod(spec[1])


def _shapes(x):
    """An encoded argument with each tensor spec as a ``torch.Size`` (what
    the ``flop_counter`` formulas take)."""
    if _is_spec(x):
        return torch.Size(x[1])
    if isinstance(x, tuple):
        return [_shapes(y) for y in x]
    return x


@functools.lru_cache(maxsize=None)
def _schema(name: str):
    """The schema of ``aten.<packet>.<overload>``, or None."""
    packet, _, overload = name.partition(".")
    try:
        return getattr(getattr(torch.ops.aten, packet),
                       overload or "default")._schema
    except AttributeError:
        return None


@functools.lru_cache(maxsize=None)
def _written_args(name: str) -> tuple:
    """Positions of the arguments the op writes (``Tensor(a!)``)."""
    s = _schema(name)
    if s is None:
        return ()
    return tuple(i for i, a in enumerate(s.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


@functools.lru_cache(maxsize=None)
def _views_only(name: str) -> bool:
    """Every output of the op is a view of an input, nothing written."""
    s = _schema(name)
    return (s is not None and len(s.returns) > 0
            and all(r.alias_info is not None and not r.alias_info.is_write
                    for r in s.returns))


def _flop_formula(packet: str):
    from torch.utils.flop_counter import flop_registry
    op = getattr(torch.ops.aten, packet, None)
    return flop_registry.get(op) if op is not None else None


@functools.lru_cache(maxsize=None)
def cost_of(record: tuple) -> tuple:
    """``(flops, bytes, kind)`` of one op record ``(name, args, kwargs,
    outs)`` (``kind`` the bucket of ``Cost.bytes_by_op``).  A kernel's
    record is ``("kernel.<name>", flops, bytes, outs)``."""
    name, args, kwargs, outs = record
    if name.startswith("kernel."):
        return float(args), float(kwargs), name
    if name.startswith("c10d."):
        moved = sum(_view_bytes(t) for t in
                    list(_specs(args)) + list(_specs(outs)))
        return 0.0, float(moved), "collective"
    packet = name.partition(".")[0]
    base = packet.rstrip("_") if not packet.startswith("_") else packet
    if packet in _FREE or _views_only(name):
        return 0.0, 0.0, "view"
    in_specs = list(_specs(args)) + list(_specs(tuple(v for _, v in kwargs)))
    ins = [_view_bytes(t) for t in in_specs]
    out_specs = list(_specs(outs))
    out_b = sum(_view_bytes(t) for t in out_specs)
    written = _written_args(name)
    formula = _flop_formula(packet)
    flops, kind = 0.0, "data-move"
    if formula is not None:
        flops = float(formula(*_shapes(args), **{k: _shapes(v)
                                                 for k, v in kwargs},
                              out_val=_shapes(outs)))
        kind = "matmul"
    elif base in _ARITH_1FLOP or packet in _ARITH_XFLOP or base in \
            _ARITH_XFLOP:
        k = _ARITH_XFLOP.get(packet, _ARITH_XFLOP.get(base, 1))
        flops = float(k * (_numel(out_specs[0]) if out_specs else 0))
        kind = "elementwise"
    elif base in _REDUCE_FLOP:
        flops = float(_REDUCE_FLOP[base] * (_numel(in_specs[0])
                                            if in_specs else 0))
        kind = "reduction"
    if packet in _GATHER:
        return flops, float(2 * out_b + sum(ins[1:])), "gather"
    if packet in _SCATTER:
        # self (written in place) is not read whole: the rows written
        # are read and written once each, plus the indices
        upd = max(ins[1:], default=0)
        return flops, float(upd + sum(ins[1:])), "scatter"
    if packet in _WRITE_ONLY and written:
        # the destination (a view) written once, the sources read
        return flops, float(sum(ins)), "copy"
    if written:
        # in place / out=: the written arguments are the outputs
        out_b = 0
    return flops, float(sum(ins) + out_b), kind


@functools.lru_cache(maxsize=None)
def collective_of(record: tuple):
    """``(kind, bytes)`` of a collective's record (``bytes`` its output's,
    one device's, as the reference's ``collective_bytes``), else None."""
    name, _, _, outs = record
    if not name.startswith("c10d."):
        return None
    return (_COLL_KIND[name.split(".")[1]],
            sum(_view_bytes(t) for t in _specs(outs)))


# ----------------------------------------------------------------------
# Cost: the sums, and the records they came from
# ----------------------------------------------------------------------

def _zero_kinds() -> dict:
    return {k: 0.0 for k in COLLECTIVES}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    bytes_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    flops_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    coll_by_kind: dict = dataclasses.field(default_factory=_zero_kinds)
    coll_counts: dict = dataclasses.field(default_factory=_zero_kinds)

    def add(self, record: tuple, n: int = 1) -> None:
        f, b, kind = cost_of(record)
        self.flops += n * f
        self.bytes += n * b
        self.bytes_by_op[kind] += n * b
        self.flops_by_op[kind] += n * f
        coll = collective_of(record)
        if coll is not None:
            self.coll_bytes += n * coll[1]
            self.coll_by_kind[coll[0]] += n * coll[1]
            self.coll_counts[coll[0]] += n

    def scaled(self, k: float) -> "Cost":
        """Every sum times ``k`` (one device's walk times the chips, as
        the reference scales its walk); the collectives' counts stay one
        device's."""
        c = Cost(self.flops * k, self.bytes * k, self.coll_bytes * k)
        for mine, theirs in ((self.bytes_by_op, c.bytes_by_op),
                             (self.flops_by_op, c.flops_by_op),
                             (self.coll_by_kind, c.coll_by_kind)):
            theirs.update({kk: v * k for kk, v in mine.items()})
        c.coll_counts = dict(self.coll_counts)
        return c

    def breakdown(self) -> dict:
        """The collectives' bytes by the reference's five kinds, with
        ``counts`` (one device's ops of each kind) and ``total``, the
        keys of the reference's ``collective_bytes``."""
        return {**{k: int(v) for k, v in self.coll_by_kind.items()},
                "counts": {k: int(v) for k, v in self.coll_counts.items()},
                "total": int(self.coll_bytes)}

    def counts(self, collectives: bool) -> dict:
        """This cost in the shared trace schema (the ``"hlo"`` dict of
        ``repro_torch.profile.trace``), with ``coll_breakdown`` where
        ``collectives`` is set (a production mesh)."""
        from repro_torch.profile.trace import hlo_counts
        d = hlo_counts(self)
        if collectives:
            d["coll_breakdown"] = self.breakdown()
        return d


def cost_from_records(records) -> Cost:
    """Re-walk an op trace: ``records`` are ``(record, count)`` pairs."""
    c = Cost()
    for rec, n in records:
        c.add(rec, n)
    return c


# ----------------------------------------------------------------------
# The mode
# ----------------------------------------------------------------------

_ACTIVE: list = []


def walking() -> bool:
    """An ``OpWalk`` is counting (a kernel wrapper then declares its
    work through ``kernel``)."""
    return bool(_ACTIVE)


def _dtensor_type():
    """DTensor's class, or None where torch has no distributed package."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return None
    return DTensor


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _storage_key(t: torch.Tensor):
    return _local(t).untyped_storage()._cdata


class OpWalk(TorchDispatchMode):
    """Counts every ATen op run inside it (see the module's docstring).

    ``cost()`` gives the sums, ``records`` the op trace (record ->
    count), ``peak_bytes`` the most bytes the step's own storages held at
    once and ``live_bytes`` what they hold now."""

    def __init__(self):
        super().__init__()
        self.records: dict = defaultdict(int)
        self.outs: dict = {}
        self._names: dict = {}
        self._fresh: dict = {}
        self.live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.base_bytes = 0
        self.adopted: set = set()
        self._paused = 0
        self._lock = threading.Lock()
        self._dtensor = _dtensor_type()
        self._patched: list = []

    def __enter__(self):
        _ACTIVE.append(self)
        self._patch_dtensor()
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        for owner, name, orig in reversed(self._patched):
            setattr(owner, name, orig)
        self._patched = []
        return super().__exit__(*exc)

    def _patch(self, owner, name, wrap) -> None:
        orig = getattr(owner, name, None)
        if orig is not None:
            self._patched.append((owner, name, orig))
            setattr(owner, name, wrap(orig))

    def _patch_dtensor(self) -> None:
        """While walking: DTensor's ``Shard(i) -> Shard(j)`` is counted as
        the one all-to-all it is, not as what the process group runs for
        it (a CPU group: an all-gather and a chunk); and the ops DTensor
        runs at global shapes to decide an op's sharding by its
        decomposition are not counted (as those on fake tensors are
        not, ``__torch_dispatch__``)."""
        if self._dtensor is None:
            return
        from torch.distributed.tensor import placement_types as pt

        def alltoall(orig):
            def shard_dim_alltoall(input, *args, **kwargs):
                if self._paused:
                    return orig(input, *args, **kwargs)
                with self.paused():
                    out = orig(input, *args, **kwargs)
                    if out.untyped_storage().nbytes() > \
                            out.numel() * out.element_size():
                        out = out.clone()       # an all-to-all's own output
                key = ("c10d.all_to_all_single.default", (_encode(input),),
                       ())
                self.records[key] += 1
                self.outs.setdefault(key, _encode(out))
                self.track(out, {_storage_key(input)})
                return out
            return shard_dim_alltoall

        def paused(orig):
            def deciding(*args, **kwargs):
                with self.paused():
                    return orig(*args, **kwargs)
            return deciding
        self._patch(pt, "shard_dim_alltoall", alltoall)
        try:
            from torch.distributed.tensor._decompositions import \
                DecompShardingStrategy
        except ImportError:
            return
        self._patch(DecompShardingStrategy, "propagate_strategy", paused)

    # live storages ---------------------------------------------------
    def _free(self, key) -> None:
        with self._lock:
            n = self.live.pop(key, 0)
            self.live_bytes -= n
            self.adopted.discard(key)

    def created(self, tensors) -> int:
        """Bytes of the live storages of ``tensors`` the step created
        (not adopted)."""
        keys = {_storage_key(t) for t in tensors} - self.adopted
        return sum(self.live.get(k, 0) for k in keys)

    def track(self, t: torch.Tensor, inputs=()) -> None:
        """Count ``t``'s storage as created by the step, unless it is
        already counted or is one of ``inputs``' (a view); a DTensor's is
        its local shard's."""
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self.live or key in inputs:
            return
        n = st.nbytes()
        with self._lock:
            self.live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def adopt(self, tensors) -> None:
        """Count ``tensors``' storages (the step's arguments) as live
        before the step: ``temp_bytes`` is the peak above them."""
        for t in tensors:
            self.track(t)
            self.adopted.add(_storage_key(t))
        self.base_bytes = self.live_bytes

    @property
    def temp_bytes(self) -> int:
        """The most bytes the step's own storages held at once, above
        the adopted arguments."""
        return self.peak_bytes - self.base_bytes

    # ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and self._dtensor in types:
            # DTensor runs the op on the local shards, and the walk
            # counts those ops and the collectives it issues
            return NotImplemented
        if self._paused or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs each new op once on
            # fake tensors of the global shapes: not the step's work
            return func(*args, **kwargs)
        name = self._names.get(func)
        if name is None:
            packet = func._overloadpacket.__name__
            # allocations and descriptions are not recorded: they cost
            # nothing, and how a device makes a constant differs
            if func.namespace in _COLL_NAMESPACES:
                name = (None if packet in _COLL_FREE
                        else f"c10d.{packet}.{func._overloadname}")
            else:
                name = (None if packet in _FREE
                        else f"{packet}.{func._overloadname}")
            self._names[func] = name
        if name is None:
            out = func(*args, **kwargs)
            for o in _flat_tensors(out):
                self.track(o, {_storage_key(a) for a in _flat_tensors(args)})
            return out
        key = (name, _encode(args),
               tuple(sorted((k, _encode(v)) for k, v in kwargs.items()))
               if kwargs else ())
        self.records[key] += 1
        made = self._fresh.get(key)
        if made is not None and _on_meta(args):
            # a functional op seen before at these specs: on meta its
            # outputs are known, so make them without the op's meta kernel
            out = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                   for sh, st, dt in made[1]]
            for o in out:
                self.track(o)
            return out[0] if made[0] else out
        out = func(*args, **kwargs)
        if key not in self.outs:
            self.outs[key] = _encode(out)
        if _views_only(name):
            return out
        outs = list(_flat_tensors(out))
        if not outs:
            return out
        inputs = {_storage_key(a) for a in _flat_tensors(args)}
        inputs.update(_storage_key(a) for a in
                      _flat_tensors(tuple(kwargs.values())))
        fresh = True
        for o in outs:
            if o.untyped_storage()._cdata in inputs:
                fresh = False
            self.track(o, inputs)
        if (fresh and not _written_args(name) and outs[0].device.type
                == "meta" and (isinstance(out, torch.Tensor)
                               or len(outs) == len(out))):
            self._fresh[key] = (isinstance(out, torch.Tensor),
                                [(o.shape, o.stride(), o.dtype)
                                 for o in outs])
        return out

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def trace(self) -> list:
        """The op trace: ``((name, args, kwargs, outs), count)`` pairs."""
        return [(k + (self.outs.get(k, ()),), n)
                for k, n in self.records.items()]

    def cost(self) -> Cost:
        return cost_from_records(self.trace())


def _on_meta(args) -> bool:
    for a in _flat_tensors(args):
        return a.device.type == "meta"
    return False


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _flat_tensors(y)


class _KernelCall:
    """What ``kernel`` yields: ``outputs(*tensors)`` names the launch's
    results, whose storages count as the step's."""

    def __init__(self, walk):
        self.walk = walk
        self.outs: list = []

    def outputs(self, *tensors) -> None:
        self.outs.extend(tensors)


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float):
    """Around a hand-written kernel's launch (or its plain or meta
    stand-in): inside an ``OpWalk`` the ops in the block are not
    counted, the launch is charged ``flops`` and ``nbytes``, and the
    storages given to ``outputs`` are counted live.  Outside a walk it
    does nothing."""
    walk = _ACTIVE[-1] if _ACTIVE else None
    call = _KernelCall(walk)
    if walk is None:
        yield call
        return
    with walk.paused():
        yield call
    key = (f"kernel.{name}", float(flops), float(nbytes))
    walk.records[key] += 1
    walk.outs.setdefault(key, tuple(_encode(t) for t in call.outs))
    for t in call.outs:
        walk.track(t)
