"""Per-device costs of a ``meta`` run (port of ``repro.launch.hlo_cost``).

``repro`` walks the optimized HLO of each SPMD-partitioned program. The
port has neither HLO nor a partitioner: :class:`CostCounter` (a
``TorchDispatchMode``) sees every ATen op of a run on the ``meta`` device,
which allocates nothing, and counts the work of one device as the port's
eager program does it:

* products: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (the ops that
  ``FlopCounterMode`` counts, and what the reference lowers to ``dot``),
  ``2 * batch * m * k * n``; the flash-attention wrappers' meta route
  reports its own (:mod:`repro_torch.kernels.meta`: the reference's
  chunked form, full tiles, and the causal useful share apart);
* ``flops``: the products plus one operation an output element of the
  elementwise ops, as ``repro``'s ``Cost.flops`` counts; ``transcendentals``
  the outputs of ``exp``, ``log``, ``tanh``, ``rsqrt``, ... (also in
  ``flops``, as there);
* bytes: every op's operand and result bytes (views move none): the eager
  port does not fuse, so this is what it moves;
* collectives, by kind and by mesh axis, in ring-formula wire bytes
  (:func:`repro_torch.launch.hlo_text.ring_wire_bytes`).

**The per-device rule.** The batch axes (the rules' ``"batch"``: ``pod``
and ``data``) split the batch: the run is one data shard's batch (the
caller makes it so). The ``model`` axis is followed through the run: every
tensor carries the dim the ``model`` axis splits (or none). Parameters,
moments and caches take theirs from their partition specs
(:func:`repro_torch.models.spec.partition_spec`); ``runtime.constrain``
sets it at the reference's call sites. Then:

* a view carries its input's split to the dim it maps to; an elementwise
  op carries its inputs' split (broadcast from the right);
* a product with one split operand is split (its FLOPs divided by the
  axis size): along the batch dim, or the free dim, of that operand; a
  product whose contracted dim is split is a partial sum: its output is
  all-reduced over ``model`` (Megatron's all-reduce) and whole after it;
* where the two operands are split on dims that do not meet, the operand
  derived from a parameter keeps its split and the other is all-gathered
  over ``model`` first, once: later uses read the gathered copy (so a
  sequence-parallel residual is gathered at a block's first product,
  the queries'); between two activations the larger one keeps its
  split; keys and values split along another dim than the queries'
  heads are gathered before attention;
* a reduction or a gather along the split dim is a partial result,
  all-reduced (the gather's backward, zeros of its input's shape
  scattered into, is split like its input); so is a lookup in a table
  split along its rows (the vocab-parallel embedding);
* so ``kv_heads -> None`` leaves the k/v projections whole on every
  ``model`` rank, and the attention over the (split) query heads split.

The FSDP axes (a parameter's spec axes other than ``model``: ``embed ->
data``) shard storage, not compute: a parameter is all-gathered over them
at each use in a product, a lookup or a cast to a 16-bit dtype (the
forward, the recompute and the backward each read it), in the dtype it is
held in; under the rules' ``_gather_weights`` lever in the compute dtype
(cast first, then gathered: ZeRO-3). Each gradient is reduce-scattered
over them (all-reduced over the batch axes that do not shard its
parameter) once a microbatch, in float32, as it accumulates; the dry run
adds the ``pod`` axis's all-reduce of the gradient shards once a step.
The optimizer's elementwise work on parameters, moments and gradients
runs on each device's shard of them. Small all-reduces of per-row
statistics (a softmax over a split dim) are not counted.

:class:`CostCounter` also tracks the live bytes of the tensors the run
makes, a device's share of each (parameters and train state are counted
exactly apart, by the dry run), and keeps their peak: an estimate of the
activation memory (tensors saved for the backward are kept alive through
saved-tensor hooks while autograd holds them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch.hlo_text import TORCH_DTYPE_BYTES, ring_wire_bytes
from repro_torch.models import spec as spec_lib

MODEL = "model"


@dataclasses.dataclass
class Cost:
    """``repro``'s ``Cost`` fields, and the port's extras: the products'
    FLOPs alone, attention's FLOPs and its causal useful share, and the
    collectives' wire bytes by mesh axis."""
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    product_flops: float = 0.0
    attention_flops: float = 0.0
    attention_useful_flops: float = 0.0
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        for f in ("flops", "bytes", "transcendentals", "coll_wire_bytes",
                  "product_flops", "attention_flops",
                  "attention_useful_flops"):
            setattr(self, f, getattr(self, f) + getattr(o, f))
        for mine, theirs in ((self.coll_by_kind, o.coll_by_kind),
                             (self.coll_by_axis, o.coll_by_axis)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + v
        return self


def _cost_delta(after: Cost, before: Cost) -> Cost:
    out = Cost()
    for f in dataclasses.fields(Cost):
        a, b = getattr(after, f.name), getattr(before, f.name)
        setattr(out, f.name, {k: v - b.get(k, 0.0) for k, v in a.items()}
                if isinstance(a, dict) else a - b)
    return out


# ---------------------------------------------------------------------------
# layouts carried by the run's tensors

@dataclasses.dataclass(frozen=True)
class Shard:
    """A tensor's layout: the dim the ``model`` axis splits (None: whole
    on every rank), the storage-only factor of its other axes (a
    parameter's FSDP axes; 1 for activations), and whether it derives
    from a parameter by views and casts."""
    mdim: Optional[int] = None
    dfac: int = 1
    weight: bool = False
    daxes: tuple = ()


WHOLE = Shard()


def shard_of(t) -> Shard:
    return getattr(t, "_shard", WHOLE)


def set_shard(t: torch.Tensor, s: Shard) -> None:
    t._shard = s


def state_shard(spec: spec_lib.Spec, mesh, weight: bool) -> Shard:
    """The layout of a parameter, moment or cache of partition ``spec``:
    its ``model`` dim and (for train state) the factor of its other
    axes."""
    sizes = spec_lib.mesh_sizes(mesh)
    mdim, dfac, daxes = None, 1, []
    for i, axes in enumerate(spec_lib.spec_axes(spec)):
        for a in axes:
            if a == MODEL:
                mdim = i
            else:
                dfac *= sizes[a]
                daxes.append(a)
    if not weight:
        dfac, daxes = 1, []
    return Shard(mdim, dfac, weight, tuple(daxes))


@dataclasses.dataclass(frozen=True)
class _Entry:
    """One op's memoised accounting and, for an op that returns fresh
    tensors, their shapes, strides and dtypes (so that a repeat of it
    skips the meta kernel)."""
    deltas: tuple
    colls: tuple
    shards: Optional[list]
    view: bool
    inplace: bool
    outs: Any
    product: Optional[tuple] = None
    regather: tuple = ()

    def build(self):
        kind, metas = self.outs
        made = [torch.empty_strided(shape, stride, dtype=dtype,
                                    device="meta")
                for shape, stride, dtype in metas]
        if kind == "one":
            return made[0]
        return tuple(made) if kind == "tuple" else made


def _out_meta(out):
    """``(kind, [(shape, strides, dtype)])`` of an op's tensor result."""
    outs = [out] if isinstance(out, torch.Tensor) else list(out)
    kind = ("one" if isinstance(out, torch.Tensor) else
            "tuple" if isinstance(out, tuple) else "list")
    return kind, [(tuple(o.shape), tuple(o.stride()), o.dtype)
                  for o in outs]


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _sig(x):
    """A hashable signature of an op's arguments: each tensor's device,
    shape, strides, dtype and layout tag; plain values with their type."""
    if isinstance(x, torch.Tensor):
        return (x.device.type, tuple(x.shape), tuple(x.stride()), x.dtype,
                getattr(x, "_shard", WHOLE))
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise TypeError(type(x))


def _name(func) -> str:
    return func.overloadpacket.__name__


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> float:
    return t.numel() * t.element_size()


def _dim(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


def map_reshape(in_shape, out_shape, d: int) -> Optional[int]:
    """The output dim that input dim ``d`` of a reshape lands in: its
    group of merged or split dims, at the output dim holding the group's
    outer part."""
    i = j = 0
    while i < len(in_shape) and j < len(out_shape):
        gi, gj = [i], [j]
        pi, pj = in_shape[i], out_shape[j]
        while pi != pj:
            if pi < pj:
                i += 1
                if i >= len(in_shape):
                    return None
                gi.append(i)
                pi *= in_shape[i]
            else:
                j += 1
                if j >= len(out_shape):
                    return None
                gj.append(j)
                pj *= out_shape[j]
        if d in gi:
            outer = math.prod(in_shape[k] for k in gi if k < d)
            acc = 1
            for k in gj:
                acc *= out_shape[k]
                if acc > outer:
                    return k
            return gj[-1]
        i += 1
        j += 1
    return None


# ops whose output is their input reshaped, or of its shape
_RESHAPES = {"view", "_unsafe_view", "reshape", "_reshape_alias", "view_as",
             "alias", "detach", "lift_fresh", "clone", "contiguous", "copy",
             "fill", "zero", "zeros_like", "ones_like", "empty_like",
             "full_like", "_to_dense"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "logsumexp", "var", "std", "prod", "any", "all", "norm",
           "linalg_vector_norm", "nansum", "var_mean", "std_mean"}
_PARTIAL_REDUCE = {"sum", "mean", "logsumexp", "nansum", "norm",
                   "linalg_vector_norm", "amax", "amin", "max", "min"}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log1p", "expm1", "tanh",
                   "rsqrt", "sqrt", "pow", "sigmoid", "sin", "cos", "erf",
                   "atan2", "logaddexp", "_softmax", "_log_softmax",
                   "softplus", "silu", "gelu"}
_ALIASING = {"_unsafe_view", "_reshape_alias", "alias"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_local_scalar_dense", "resize_", "set_"}


class CostCounter(TorchDispatchMode):
    """Counts one device's work of the ops run under it (see the module
    docstring): ``cost``, and the live and ``peak`` bytes of the tensors
    they make. ``mesh`` and ``rules`` give the axis sizes and the
    lever."""

    def __init__(self, mesh, rules: Mapping[str, Any]):
        super().__init__()
        self.mesh, self.rules = mesh, rules
        self.sizes = spec_lib.mesh_sizes(mesh)
        self.tp = self.sizes.get(MODEL, 1)
        self.gather_cast = bool(rules.get("_gather_weights"))
        self.cost = Cost()
        self.live = 0.0
        self.peak = 0.0
        self.products: Optional[list] = None     # a list: log them
        self._memo: Dict[tuple, _Entry] = {}
        self._regions: Dict[tuple, tuple] = {}
        self._storages: Dict[int, list] = {}     # bytes, tensors alive
        self._scattered: Dict[tuple, Shard] = {}
        self._pending: Optional[list] = None
        self._regathered: list = []

    # -- bookkeeping --------------------------------------------------------
    def share(self, t: torch.Tensor, s: Optional[Shard] = None) -> float:
        """One device's bytes of ``t``."""
        s = s or shard_of(t)
        div = (self.tp if s.mdim is not None else 1) * s.dfac
        return _nbytes(t) / div

    def collective(self, kind: str, axes: Sequence[str],
                   nbytes: float) -> None:
        """A collective over ``axes`` (a ring over their product) whose
        result (all-gather), shard (reduce-scatter) or operand holds
        ``nbytes`` on each device."""
        if self._pending is not None:       # an op's rules: _apply adds it
            self._pending.append((kind, tuple(axes), nbytes))
            return
        self._collect(kind, tuple(axes), nbytes)

    def _collect(self, kind, axes, nbytes) -> None:
        n = math.prod(self.sizes.get(a, 1) for a in axes)
        if n <= 1 or nbytes <= 0:
            return
        wire = ring_wire_bytes(kind, nbytes, n)
        c = self.cost
        c.coll_wire_bytes += wire
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + wire
        key = "+".join(axes)
        c.coll_by_axis[key] = c.coll_by_axis.get(key, 0.0) + wire

    def _track(self, t: torch.Tensor, view: bool = False) -> None:
        """Count the storage of a tensor the run made live (a device's
        share of it) while any tensor over it (``t``, its views) is alive;
        a view of a storage made before the run (parameters, moments,
        caches) is not counted."""
        if getattr(t, "_storage", None) is not None:
            return
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None and view:
            return
        t._storage = key
        if entry is None:
            n = t.untyped_storage().nbytes() / self._div(shard_of(t))
            entry = self._storages[key] = [n, 0]
            self.live += n
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _div(self, s: Shard) -> float:
        return (self.tp if s.mdim is not None else 1) * s.dfac

    def retag(self, t: torch.Tensor, s: Shard) -> None:
        """Give ``t`` the layout ``s``, its storage's live bytes with it."""
        set_shard(t, s)
        entry = self._storages.get(getattr(t, "_storage", None))
        if entry is not None:
            new = t.untyped_storage().nbytes() / self._div(s)
            self.live += new - entry[0]
            entry[0] = new

    def gathered(self, t: torch.Tensor) -> None:
        """``t`` (and the tensor it views) was all-gathered over ``model``
        for a use: later uses read the gathered copy, whole."""
        owner = getattr(t, "_owner", None)
        for x in (t, owner() if owner is not None else None):
            if x is not None:
                s = shard_of(x)
                self.retag(x, Shard(None, s.dfac, s.weight, s.daxes))

    # -- the listeners' side ------------------------------------------------
    def constrain(self, x: torch.Tensor, spec) -> None:
        """``runtime.constrain``: the layout the model asks for. A tensor
        split where it is asked whole is all-gathered; one asked split is
        sliced (free)."""
        want = state_shard(spec, self.mesh, weight=False)
        have = shard_of(x)
        if have.mdim is not None and want.mdim != have.mdim:
            self.collective("all-gather", (MODEL,), _nbytes(x))
        self.retag(x, Shard(want.mdim, have.dfac, have.weight, have.daxes))

    def kernel(self, work: "kernel_meta.Work") -> None:
        """A kernel wrapper's meta route: its products (divided where the
        queries are split) and bytes; its outputs' layouts."""
        q = work.inputs[0]
        split = shard_of(q).mdim is not None
        div = self.tp if split else 1
        c = self.cost
        c.product_flops += work.flops / div
        c.flops += work.flops / div
        c.attention_flops += work.flops / div
        c.attention_useful_flops += work.useful_flops / div
        if self.products is not None:
            self.products.append((work.name, tuple(
                tuple(t.shape) for t in work.inputs[:3]), (),
                work.flops / div))
        qs = shard_of(q)
        for t in work.inputs[1:3]:
            ts = shard_of(t)
            if ts.mdim is not None and ts.mdim != qs.mdim:
                # keys and values split along another dim than the
                # queries' heads (a sequence-parallel projection): whole
                # rows gathered first
                self.collective("all-gather", (MODEL,), _nbytes(t))
                self.gathered(t)
        c.bytes += sum(self.share(t) for t in work.inputs)
        for role, t in zip(work.roles, work.outputs):
            if role == "lse":       # (B, H, S): heads at dim 1
                s = Shard(1 if qs.mdim == 2 else None)
            else:
                s = Shard(shard_of(work.inputs["qkv".index(role)]).mdim)
                if role != "q" and split and s.mdim is None:
                    # whole k, v read by split query heads: each rank
                    # holds a partial sum of their gradients
                    self.collective("all-reduce", (MODEL,), _nbytes(t))
            self.retag(t, s)
            c.bytes += self.share(t)

    def repeatable(self, fn, args):
        """``kernel_meta.repeatable``: the first call of ``fn`` at these
        argument layouts runs and its cost and transient live bytes are
        kept; a repeat adds them and returns a fresh output of the same
        shape and layout."""
        try:
            key = (fn, _sig(args))
        except TypeError:
            return fn(*args)
        rec = self._regions.get(key)
        if rec is None:
            before = dataclasses.replace(
                self.cost, coll_by_kind=dict(self.cost.coll_by_kind),
                coll_by_axis=dict(self.cost.coll_by_axis))
            live, peak = self.live, self.peak
            self.peak = live
            out = fn(*args)
            rec = (_cost_delta(self.cost, before), self.peak - live,
                   None if out is None else (_out_meta(out), shard_of(out)))
            self.peak = max(self.peak, peak)
            self._regions[key] = rec
            return out
        delta, excess, made = rec
        self.cost += delta
        self.peak = max(self.peak, self.live + excess)
        if made is None:
            return None
        out = _Entry((), (), None, False, False, made[0]).build()
        set_shard(out, made[1])
        self._track(out)
        return out

    def grad_accumulated(self, param: torch.Tensor) -> None:
        """A parameter's gradient has accumulated: it takes its
        parameter's layout and is reduce-scattered over the FSDP axes
        (all-reduced over the batch axes that do not shard it)."""
        g = param.grad
        s = shard_of(param)
        self.retag(g, Shard(s.mdim, s.dfac, False, s.daxes))
        shard = _nbytes(g) / ((self.tp if s.mdim is not None else 1)
                              * s.dfac)
        if s.daxes:
            self.collective("reduce-scatter", s.daxes, shard)
        rest = tuple(a for a in self.batch_axes() if a not in s.daxes
                     and a != "pod")
        if rest:
            self.collective("all-reduce", rest, shard)

    def batch_axes(self):
        axes = self.rules.get("batch")
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in axes if a in self.sizes)

    # -- the dispatch -------------------------------------------------------
    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            lambda t: t, lambda t: t)
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._hooks.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            key = (func, _sig(args), _sig(kwargs))
        except TypeError:
            key = None
        entry = self._memo.get(key) if key is not None else None
        if entry is not None and entry.outs is not None:
            out = entry.build()
        else:
            out = func(*args, **kwargs)
        ins = [t for t in _tensors(args) if t.device.type == "meta"]
        outs = [t for t in _tensors([out]) if t.device.type == "meta"]
        if not ins and not outs:
            return out
        name = _name(func)
        if entry is None:
            try:
                entry = self._rules(func, name, args, kwargs, ins, outs, out)
            except Exception as e:
                raise RuntimeError(f"cost count at aten.{name}: {e}") from e
            if key is not None:
                self._memo[key] = entry
        self._apply(entry, name, ins, outs)
        return out

    def _rules(self, func, name, args, kwargs, ins, outs, out) -> "_Entry":
        """The op's accounting (memoised by its arguments' shapes,
        dtypes and layouts): its cost deltas, collectives and outputs'
        layouts."""
        before = (self.cost.bytes, self.cost.flops,
                  self.cost.transcendentals, self.cost.product_flops)
        self._pending, self._regathered = [], []
        # in place, or into an ``out=`` tensor: the outputs exist already
        inplace = bool(outs) and (func._schema.is_mutable or any(
            o is i for o in outs for i in ins))
        if name in _PRODUCTS:
            out_shard = self._product(name, args, outs[0])
        elif inplace:
            out_shard = None
        else:
            out_shard = self._layout(func, name, args, kwargs, ins, outs)
        if out_shard is not None and not isinstance(out_shard, list):
            out_shard = [out_shard] * len(outs)
        # a view's outputs alias its input (autograd marks them views only
        # after the dispatch returns); _unsafe_view shares it too
        returns = func._schema.returns
        is_view = bool(outs) and not inplace and (name in _ALIASING or (
            not func._schema.is_mutable
            and any(r.alias_info is not None for r in returns)))
        c = self.cost
        if not is_view:
            shards = out_shard or [shard_of(o) for o in outs]
            if name not in _NO_BYTES:
                c.bytes += sum(self.share(t) for t in ins)
                c.bytes += sum(self.share(t, s) for t, s in zip(outs, shards))
            if name not in _PRODUCTS and torch.Tag.pointwise in func.tags:
                n = sum(o.numel() / (self.tp if s.mdim is not None else 1)
                        for o, s in zip(outs, shards))
                c.flops += n
                if name.rstrip("_") in _TRANSCENDENTAL:
                    c.transcendentals += n
            elif name in _TRANSCENDENTAL:
                n = sum(o.numel() for o in outs)
                c.flops += n
                c.transcendentals += n
        after = (c.bytes, c.flops, c.transcendentals, c.product_flops)
        # the deltas are applied by _apply, like a memoised entry's
        c.bytes, c.flops, c.transcendentals, c.product_flops = before
        colls, self._pending = self._pending, None
        fresh = not is_view and not inplace and all(
            isinstance(o, torch.Tensor) for o in _tensors([out]))
        regather = tuple(i for i, t in enumerate(ins)
                         if any(t is g for g in self._regathered))
        product = None
        if name in _PRODUCTS:
            product = (name, tuple(tuple(t.shape) for t in ins),
                       tuple(outs[0].shape), after[3] - before[3])
        return _Entry(
            deltas=tuple(a - b for a, b in zip(after, before)),
            colls=tuple(colls), shards=out_shard, view=is_view,
            inplace=inplace,
            outs=_out_meta(out) if fresh and outs else None,
            product=product, regather=regather)

    def _apply(self, entry: "_Entry", name, ins, outs) -> None:
        c = self.cost
        db, df, dt, dp = entry.deltas
        c.bytes += db
        c.flops += df
        c.transcendentals += dt
        c.product_flops += dp
        for kind, axes, nbytes in entry.colls:
            self._collect(kind, axes, nbytes)
        if self.products is not None and entry.product is not None:
            self.products.append(entry.product)
        for i in entry.regather:
            self.gathered(ins[i])
        if entry.shards is not None:
            for o, s in zip(outs, entry.shards):
                set_shard(o, s)
        if name == "new_zeros" and self._scattered:
            s = self._scattered.get((tuple(outs[0].shape), outs[0].dtype))
            if s is not None:
                set_shard(outs[0], s)
        if entry.view and ins:
            base = getattr(ins[0], "_owner", None) or weakref.ref(ins[0])
            for o in outs:
                o._owner = base
        if not entry.inplace:
            for o in outs:
                self._track(o, entry.view)

    # -- layout rules -------------------------------------------------------
    def _use(self, t: torch.Tensor, dtype: torch.dtype) -> Shard:
        """A compute use of ``t``: FSDP-sharded state is all-gathered
        (over its storage axes, in ``dtype``); returns its compute-time
        layout."""
        s = shard_of(t)
        if s.dfac > 1:
            per = t.numel() / (self.tp if s.mdim is not None else 1)
            self.collective("all-gather", s.daxes,
                            per * TORCH_DTYPE_BYTES.get(dtype, 4))
        return Shard(s.mdim, 1, s.weight)

    def _product(self, name: str, args, out: torch.Tensor) -> Shard:
        if name in ("addmm", "baddbmm"):
            a, b = args[1], args[2]
        else:
            a, b = args[0], args[1]
        sa, sb = self._use(a, a.dtype), self._use(b, b.dtype)
        batched = name in ("bmm", "baddbmm")
        # roles of each operand's split dim: batch, free or contracted
        if name == "mv":
            ra = {0: "m", 1: "k"}.get(sa.mdim)
            rb = {0: "k"}.get(sb.mdim)
            m, k, n, nb = a.shape[0], a.shape[1], 1, 1
        elif name == "dot":
            ra = "k" if sa.mdim is not None else None
            rb = "k" if sb.mdim is not None else None
            m, k, n, nb = 1, a.shape[0], 1, 1
        elif batched:
            ra = {0: "b", 1: "m", 2: "k"}.get(sa.mdim)
            rb = {0: "b", 1: "k", 2: "n"}.get(sb.mdim)
            nb, m, k = a.shape
            n = b.shape[2]
        else:
            ra = {0: "m", 1: "k"}.get(sa.mdim)
            rb = {0: "k", 1: "n"}.get(sb.mdim)
            m, k = a.shape
            n, nb = b.shape[1], 1
        compatible = (ra is None or rb is None or ra == rb
                      and ra in ("b", "k"))
        if not compatible:
            # keep the parameter's split (else the larger operand's);
            # gather the other
            keep_a = (sa.weight and not sb.weight) or (
                sa.weight == sb.weight and a.numel() >= b.numel())
            gone = b if keep_a else a
            self.collective("all-gather", (MODEL,), _nbytes(gone))
            self._regathered.append(gone)
            if keep_a:
                rb = None
            else:
                ra = None
        role = ra or rb
        flops = 2.0 * nb * m * k * n / (self.tp if role else 1)
        c = self.cost
        c.product_flops += flops
        c.flops += flops
        if role == "k":
            self.collective("all-reduce", (MODEL,), _nbytes(out))
            return WHOLE
        if role is None:
            return WHOLE
        ndim = out.ndim
        return Shard({"b": 0, "m": ndim - 2 if ndim >= 2 else 0,
                      "n": ndim - 1}[role])

    def _layout(self, func, name, args, kwargs, ins, outs):
        if not ins or not outs:
            return None
        x = ins[0]
        s = shard_of(x)
        if name == "_to_copy":
            dtype = kwargs.get("dtype", x.dtype)
            if s.dfac > 1 and dtype is not None and \
                    TORCH_DTYPE_BYTES.get(dtype, 4) == 2:
                return self._use(x, dtype if self.gather_cast else x.dtype)
            return s
        if name in ("index", "embedding", "index_select"):
            return self._lookup(name, args, x, outs[0])
        d = s.mdim
        if d is None:
            if torch.Tag.pointwise in func.tags or name in ("where", "cat",
                                                           "stack"):
                return self._pointwise(ins, outs[0])
            same = [shard_of(t) for t in ins if t.shape == outs[0].shape]
            if same and any(t.mdim is not None or t.dfac > 1 for t in same):
                return next(t for t in same
                            if t.mdim is not None or t.dfac > 1)
            return WHOLE if s.dfac == 1 else Shard(None, s.dfac, False,
                                                   s.daxes)
        out = outs[0]
        nd_in, nd_out = x.ndim, out.ndim
        keep = Shard(None, s.dfac, s.weight, s.daxes)

        def at(dim):
            return Shard(dim, s.dfac, s.weight, s.daxes) if dim is not None \
                else keep
        if name in _RESHAPES or name == "expand":
            if tuple(out.shape) == tuple(x.shape):
                return s
            if name == "expand":
                return at(d + nd_out - nd_in)
            return at(map_reshape(tuple(x.shape), tuple(out.shape), d))
        if name == "permute":
            dims = [_dim(p, nd_in) for p in args[1]]
            return at(dims.index(d))
        if name in ("transpose", "swapaxes"):
            d0, d1 = _dim(args[1], nd_in), _dim(args[2], nd_in)
            return at(d1 if d == d0 else d0 if d == d1 else d)
        if name in ("t", "numpy_T"):
            return at(1 - d if nd_in == 2 else d)
        if name == "unsqueeze":
            u = _dim(args[1], nd_out)
            return at(d + 1 if u <= d else d)
        if name == "squeeze":
            gone = [i for i in range(nd_in) if x.shape[i] == 1]
            if len(args) > 1:
                dims = args[1] if isinstance(args[1], (list, tuple)) \
                    else [args[1]]
                gone = [i for i in gone if i in [_dim(v, nd_in)
                                                 for v in dims]]
            return at(d - sum(1 for i in gone if i < d))
        if name == "select":
            sel = _dim(args[1], nd_in)
            return at(None if sel == d else d - (sel < d))
        if name in ("sort", "topk"):
            along = kwargs.get("dim", -1)
            if name == "topk" and len(args) > 2:
                along = args[2]
            if _dim(along, nd_in) == d:     # whole rows, gathered first
                self.collective("all-gather", (MODEL,), _nbytes(x))
                return [keep] * len(outs)
            return [s] * len(outs)
        if name in ("slice", "narrow", "constant_pad_nd") or (
                name in ("roll", "flip", "cumsum", "cumprod", "_softmax",
                         "_log_softmax", "tril", "triu", "clamp",
                         "masked_fill", "scatter", "scatter_add",
                         "index_put", "index_copy", "masked_scatter")
                and tuple(out.shape) == tuple(x.shape)):
            return [s] * len(outs)
        if name in ("split", "split_with_sizes", "chunk", "unbind",
                    "unsafe_split", "split_with_sizes_copy"):
            along = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0),
                         nd_in) if name != "unbind" else _dim(
                args[1] if len(args) > 1 else 0, nd_in)
            if name == "unbind":
                return [at(None if along == d else d - (along < d))] \
                    * len(outs)
            return [s] * len(outs)
        if name in _REDUCE:
            return self._reduce(name, args, kwargs, x, out, s)
        if name == "gather":
            along = _dim(args[1], nd_in)
            if along == d:
                self.collective("all-reduce", (MODEL,), _nbytes(out))
                # its backward scatters into zeros of x's shape
                self._scattered[(tuple(x.shape), x.dtype)] = s
                return keep
            return s
        if torch.Tag.pointwise in func.tags or name in ("where", "cat",
                                                       "stack"):
            return self._pointwise(ins, out, name, args)
        same = [shard_of(t) for t in ins if t.shape == out.shape]
        if same:
            return same[0]
        return keep

    def _reduce(self, name, args, kwargs, x, out, s):
        d, nd_in = s.mdim, x.ndim
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        if isinstance(dims, int):
            dims = [dims]
        keepdim = bool(args[2]) if len(args) > 2 and isinstance(
            args[2], bool) else bool(kwargs.get("keepdim", False))
        keep = Shard(None, s.dfac, False, s.daxes)
        if not dims:
            if name in _PARTIAL_REDUCE:
                self.collective("all-reduce", (MODEL,), _nbytes(out))
            return keep
        dims = [_dim(v, nd_in) for v in dims]
        if d in dims:
            if name in _PARTIAL_REDUCE:
                self.collective("all-reduce", (MODEL,), _nbytes(out))
            return keep
        return Shard(d if keepdim else d - sum(1 for v in dims if v < d),
                     s.dfac, False, s.daxes)

    def _pointwise(self, ins, out, name="", args=()):
        """Broadcast from the right; the first split input's dim wins; a
        cat or stack keeps its inputs' common split."""
        nd = out.ndim
        dfac, daxes = 1, ()
        mdim = None
        for t in ins:
            s = shard_of(t)
            if s.dfac > dfac:
                dfac, daxes = s.dfac, s.daxes
            if s.mdim is None or mdim is not None:
                continue
            if name == "stack":
                along = _dim(args[1] if len(args) > 1 else 0, nd)
                mdim = s.mdim + (1 if along <= s.mdim else 0)
                continue
            if name == "cat":
                mdim = s.mdim
                continue
            cand = s.mdim + nd - t.ndim
            if 0 <= cand < nd and t.shape[s.mdim] == out.shape[cand]:
                mdim = cand
        return Shard(mdim, dfac, False, daxes)

    def _lookup(self, name, args, table, out):
        """A lookup in ``table``: a compute use of a stored table; rows of
        a table split along them give a partial result, all-reduced."""
        s = self._use(table, table.dtype)
        if name == "index":
            idx = args[1]
            lead = [i for i, v in enumerate(idx) if v is not None]
            if s.mdim is None:
                return WHOLE
            if s.mdim in lead:
                self.collective("all-reduce", (MODEL,), _nbytes(out))
                return WHOLE
            if lead == [0]:
                return Shard(s.mdim - 1 + idx[0].ndim)
            return WHOLE
        if name == "embedding":
            if s.mdim == 0:
                self.collective("all-reduce", (MODEL,), _nbytes(out))
                return WHOLE
            return Shard(out.ndim - 1) if s.mdim == 1 else WHOLE
        along = _dim(args[1], table.ndim)
        if s.mdim == along:
            self.collective("all-reduce", (MODEL,), _nbytes(out))
            return WHOLE
        return Shard(s.mdim)


@contextlib.contextmanager
def counting(mesh, rules: Mapping[str, Any]):
    """A :class:`CostCounter` over the block, the listener of a runtime
    context (``runtime.sharding_ctx``): the layouts the model names and
    the kernels' meta-route reports go to it."""
    from repro_torch.models import runtime
    counter = CostCounter(mesh, rules)
    with runtime.sharding_ctx(mesh, rules, listener=counter), counter:
        yield counter


def analyze(fn, *args, mesh=None, rules: Optional[Mapping[str, Any]] = None,
            **kwargs) -> Cost:
    """The per-device :class:`Cost` of ``fn(*args, **kwargs)`` run on
    ``meta`` tensors (``mesh`` a logical mesh, one position by default;
    ``rules`` the logical axis rules, the defaults by default)."""
    from repro_torch.launch.mesh import LogicalMesh
    mesh = mesh or LogicalMesh(("data", "model"), (1, 1))
    with counting(mesh, spec_lib.resolve_rules(rules)) as counter:
        fn(*args, **kwargs)
    return counter.cost


def tag_state(tensors: Mapping[str, torch.Tensor],
              logical: Mapping[str, tuple], mesh, rules,
              weight: bool = True) -> None:
    """Give each of ``tensors`` (parameters, moments: ``weight``; caches:
    not) the layout of its partition spec."""
    for name, t in tensors.items():
        spec = spec_lib.partition_spec(logical[name], tuple(t.shape), mesh,
                                       rules)
        set_shard(t, state_shard(spec, mesh, weight))
