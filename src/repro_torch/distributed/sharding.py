"""Logical-axis sharding rules and the tensor-parallel forward's context
(port of repro/distributed/sharding.py).

Params are trees of dicts and lists (repro_torch/tree.py); a *rule table*
maps path regexes to tuples of logical axis names, and a MeshRules table
maps logical names to mesh axes. repro stacks a segment's layers, so its
leaves may carry a leading layer dim (a spec entry None); the port keeps a
list of per-layer dicts, whose leaves match a rule with ndim == len(axes).

Logical axes used across the model zoo:
  batch      global batch              -> ("pod", "data")
  seq        sequence                  -> None (SP optional)
  vocab      vocabulary                -> "model"
  embed      model width (residual)    -> None  ("data" when fsdp)
  mlp        FFN hidden                -> "model"
  heads      flattened attention heads -> "model"
  kv         head_dim / per-head       -> None
  expert     MoE expert                -> "model"
  kv_lora    MLA compressed dim        -> None
  state      SSM state dims            -> None
  dconv      conv channels             -> "model"

A spec is a tuple with one entry per dim of the leaf: a mesh axis name, a
tuple of axis names, or None (replicated along that dim); () replicates
the whole leaf. It is repro's PartitionSpec as a plain tuple.
``placements`` turns one into DTensor placements for a
``torch.distributed.device_mesh.DeviceMesh``; ``local_shard`` cuts a rank's
shard of a tensor by it. The placements are metadata: the forward runs on
plain rank-local tensors with explicit collectives, never on DTensors (a
DTensor does not reach a kernel wrapper's ctypes call, and gloo on CUDA
tensors has no all_gather for DTensor's redistributions).

A mesh here is anything with axis names and sizes: a DeviceMesh
(``mesh_dim_names``, ``shape``), or a stand-in with ``axis_names`` and a
``shape`` dict, as repro's tests use.

What became of repro's activation constraints: there is no GSPMD to steer,
so ``with_logical_constraint`` (a sharding hint inside jit) has no
counterpart and is gone. ``set_logical_rules`` / ``get_logical_rules`` /
``active_mesh``, which repro's engines flip around every jitted call,
become ``tensor_parallel(tp)``, a scope the engines open around every
model call, and ``active_tp()``, which the forward reads: its collectives
(after the row-parallel products, the embedding and the head) and its
rank-local head counts. Outside a scope the forward is the single-device
one, untouched.

Training on a mesh (launch/specs.TrainPlan, train/step.py) runs the same
forward under autograd: ``TensorParallel``'s collectives then carry their
gradients (Megatron's copy / reduce pair, built from all_reduce alone),
and ``DataParallel`` holds a rank's place on the ``data`` axis: its rows
of each batch and the f32 bucketed mean of the ranks' gradients.

Every collective goes through distributed/collectives.py, which counts it
per mesh axis and, inside its ``recording()`` scope, records it in place
of issuing it (the dry run, launch/dryrun.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import re
from dataclasses import dataclass, field

import torch

from repro_torch.distributed import collectives

DEFAULT_MESH_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "vocab": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",     # flattened KV projection dim (may differ: GQA)
    "cache_heads": "model",  # kv-cache head axis (needs head divisibility)
    "cache_seq": None,       # kv-cache sequence axis ("model" = flash-
                             # decoding-style sequence-parallel attention)
    "kv": None,
    "expert": "model",
    "kv_lora": None,
    "state": None,
    "dconv": "model",
    "fsdp": "data",
}


@dataclass
class MeshRules:
    """The logical -> mesh table (``rules``) and ``cuts``: [(path regex,
    segments)], where a leaf's split dim is not cut contiguously
    (``local_shard``); launch/specs.serving_plan sets them."""
    rules: dict = field(default_factory=lambda: dict(DEFAULT_MESH_RULES))
    fsdp: bool = False
    cuts: list = field(default_factory=list)

    def segments(self, path: str):
        """The segments of the first cut whose regex ``path`` matches, else
        None (the spec's contiguous cut)."""
        for rx, segs in self.cuts:
            if re.search(rx, path):
                return segs
        return None

    def mesh_axes(self, logical, axis_names):
        """logical axis name -> mesh axis entry valid for this mesh."""
        m = self.rules.get(logical)
        if m is None:
            return None
        if isinstance(m, tuple):
            got = tuple(a for a in m if a in axis_names)
            return got if got else None
        return m if m in axis_names else None


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a stand-in."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def logical_to_spec(axes, mesh, mesh_rules: MeshRules) -> tuple:
    names = axis_names(mesh)
    return tuple(mesh_rules.mesh_axes(a, names) for a in axes)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def partition_specs(params, rules, mesh, mesh_rules: MeshRules):
    """A spec tree of ``params``' structure.

    rules: list of (path_regex, (logical_axis, ...)). First match wins.
    Unmatched leaves are replicated (and flagged when > 1 MiB, so that a
    big tensor is never replicated unnoticed). Leaves need only ``shape``
    and ``dtype`` (fake or meta tensors do)."""
    from repro_torch.tree import tree_leaves_with_path, tree_unflatten_like
    compiled = [(re.compile(rx), axes) for rx, axes in rules]
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    specs = []
    for pstr, leaf in tree_leaves_with_path(params):
        spec = ()
        shape = tuple(leaf.shape)
        for rx, axes in compiled:
            if rx.search(pstr):
                core = [mesh_rules.mesh_axes(a, names) for a in axes]
                extra = len(shape) - len(axes)
                if extra not in (0, 1, 2):
                    raise ValueError(f"rule {rx.pattern} axes {axes} vs leaf {pstr} "
                                     f"shape {shape}")
                # FSDP (ZeRO-3): shard the first unsharded *matrix* dim over
                # "data": never 1-D params, never a layer-stack prefix, and
                # only where that dim divides evenly
                if mesh_rules.fsdp and len(axes) >= 2 and "data" in names:
                    used = {x for e in core for x in _entry_axes(e)}
                    if "data" not in used:
                        for i, e in enumerate(core):
                            if e is None and shape[extra + i] % sizes["data"] == 0:
                                core[i] = "data"
                                break
                spec = tuple([None] * extra + core)
                break
        else:
            nbytes = leaf.numel() * leaf.element_size()
            if nbytes > (1 << 20):
                logging.getLogger(__name__).warning(
                    "replicating large unmatched param %s (%s)", pstr, shape)
        specs.append(spec)
    return tree_unflatten_like(params, specs)


def placements(spec: tuple, mesh) -> list:
    """A spec -> one DTensor placement per mesh dim: Shard(d) where the
    leaf's dim d names that axis, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec) if name in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _shard_index(entry, coords: dict, sizes: dict) -> tuple[int, int]:
    """(this rank's index, the number of shards) along one dim; a tuple of
    axes counts row-major, the first axis outermost."""
    idx, n = 0, 1
    for a in _entry_axes(entry):
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def _pieces(size: int, segments, idx: int, n: int, where) -> list[tuple[int, int]]:
    """[(start, length)] of shard ``idx`` of ``n`` along a dim of ``size``:
    one contiguous block, or with ``segments`` ([(length, split)] covering
    the dim) each split segment's block and each other segment whole."""
    segments = segments if segments is not None else ((size, True),)
    if sum(length for length, _ in segments) != size:
        raise ValueError(f"segments {segments} do not cover {size} ({where})")
    out, off = [], 0
    for length, split in segments:
        if split and length % n:
            raise ValueError(f"{length} of {size} does not split {n} ways ({where})")
        out.append((off + idx * (length // n), length // n) if split else (off, length))
        off += length
    return out


def shard_shape(shape, spec: tuple, mesh, segments=None) -> tuple:
    """The shape each device holds of a leaf of ``shape`` under ``spec``
    (``segments``: local_shard's)."""
    if segments == ():
        return tuple(shape)
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        _, n = _shard_index(e, {a: 0 for a in sizes}, sizes)
        if n > 1:
            out[d] = sum(k for _, k in _pieces(out[d], segments, 0, n, spec))
    return tuple(out)


def local_shard(t: torch.Tensor, spec: tuple, mesh, coords: dict,
                segments=None) -> torch.Tensor:
    """The shard of ``t`` at mesh coordinates ``coords`` ({axis: index}),
    in an allocation of its own (never an offset view: the kernel wrappers
    refuse a base pointer off 16-byte alignment). A replicated leaf is
    ``t`` itself. ``segments`` (MeshRules.segments) replaces the split
    dim's contiguous cut: [(length, split)] along it, each split segment
    cut as that dim would be and the others kept whole (Mamba2's packed
    [z | x] takes the rank's heads of each half); () keeps ``t`` whole."""
    sizes = axis_sizes(mesh)
    if segments == () or not any(_entry_axes(e) for e in spec):
        return t
    out = t
    for d, e in enumerate(spec):
        if not _entry_axes(e):
            continue
        idx, n = _shard_index(e, coords, sizes)
        parts = [out.narrow(d, start, k)
                 for start, k in _pieces(out.shape[d], segments, idx, n, spec)]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
    return out.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# the tensor-parallel forward's context
# ---------------------------------------------------------------------------

def _recorded(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` here (training); the serving
    forward runs under no_grad and never is."""
    return torch.is_grad_enabled() and x.requires_grad


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the group into a new tensor; the gradient passes through
    unchanged, since every rank already holds the whole sum's gradient
    (torch.distributed.nn's all_reduce would sum it again: N x)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        return collectives.all_reduce(y, axis="model", group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    """The identity into a split region; the gradient, this rank's part of
    the sum over the ranks' splits, is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return collectives.all_reduce(g, axis="model", group=ctx.group), None


class _GatherLast(torch.autograd.Function):
    """TensorParallel.gather_last with its gradient: this rank's columns."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.cols = (tp.rank * x.shape[-1], x.shape[-1])
        return tp.gather_last(x)

    @staticmethod
    def backward(ctx, g):
        start, n = ctx.cols
        return g.narrow(-1, start, n).contiguous(), None


@dataclass(frozen=True)
class TensorParallel:
    """One rank's place on the ``model`` axis, and what the forward splits
    there (launch/specs.serving_plan / train_plan decide it from the mesh
    rules):

      attn     attention heads: wq / wk / wv column-parallel, wo
               row-parallel, each rank attending with its heads against its
               own cache heads; MLA's w_uq / w_uk / w_uv column-parallel
               by heads and wo row-parallel, its down projections and its
               compressed cache whole on every rank; else the attention
               block runs whole on every rank
      ffn      the FFN hidden width: w_gate / w_up / bin_in column-parallel,
               w_down / bin_out row-parallel (a MoE layer's shared experts
               too)
      vocab    embedding rows and head columns
      experts  the routed expert stacks of a MoE layer: a rank holds
               E / N whole experts and runs their slots of the dispatch,
               which every rank computes whole; ``gather_pairs`` sums the
               ranks' gated pair rows
      mixer    a recurrent family's heads: Mamba2's (its z and x columns
               of in_zx, their conv channels beside the shared B and C
               whole, its state heads, gnorm over the split width through
               ``sum_last``, out row-parallel) or RWKV6's time-mix heads
               (w_r / w_k / w_v / w_g columns, the WKV state, y and g
               gathered for gn, the rank's output columns of w_o and c_r
               gathered)

    Each row-parallel product is summed over the axis with one all_reduce;
    the embedding, the logits and the MoE pair rows are gathered by an
    all_reduce of zero-filled buffers, which is exact (gloo carries only
    broadcast and all_reduce for CUDA tensors).

    Training (Megatron's pair): where autograd records the forward, each
    split region's input goes through ``copy`` (identity; its gradient is
    summed over the axis), each sum through ``all_reduce`` (its gradient
    passes unchanged) and the gathered logits' gradient is cut back to
    this rank's columns. Under no_grad (serving) ``copy`` is a no-op and
    the sums run in place: the same collectives in the same order."""
    size: int
    rank: int
    group: object = None           # a torch.distributed ProcessGroup (None: the world)
    attn: bool = False
    ffn: bool = False
    vocab: bool = False
    experts: bool = False
    mixer: bool = False

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the axis: in place, or into a new tensor where
        autograd records ``x``."""
        if _recorded(x):
            return _ReduceFromTP.apply(x, self.group)
        return collectives.all_reduce(x, axis="model", group=self.group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated) into a split region: itself; where autograd
        records it, its gradient is summed over the axis."""
        return _CopyToTP.apply(x, self.group) if _recorded(x) else x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n) rank-local columns -> (..., n * size), rank r's at
        r * n, through one all_reduce of a zero-filled buffer (adding zeros
        is exact, so every rank holds the same bits)."""
        if _recorded(x):
            return _GatherLast.apply(x, self)
        n = x.shape[-1]
        full = x.new_zeros((*x.shape[:-1], n * self.size))
        full[..., self.rank * n:(self.rank + 1) * n] = x
        return self.all_reduce(full)

    def sum_last(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n) rank-local columns of a split axis -> (..., 1) f32, the
        sum over the whole axis: each rank's partial sum, one all_reduce (a
        norm's statistic; only its order differs from one device's)."""
        return self.all_reduce(x.to(torch.float32).sum(dim=-1, keepdim=True))

    def gather_pairs(self, rows: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
        """A MoE layer's gated pair rows (T k, d), this rank's where ``mine``
        (T k,) holds (the pairs routed to its experts), from every rank:
        one all_reduce of the rows zero-filled elsewhere. Each pair is one
        rank's, so the sum adds only zeros to it: exact, every rank holds
        the same bits in any dtype. Serving only: its backward, a gradient
        cut to the rank's own pairs, is ROADMAP A9 (l)."""
        return self.all_reduce(torch.where(mine[:, None], rows, rows.new_zeros(())))


# elements in one all_reduce of DataParallel.mean: 256 MiB of f32
MEAN_BUCKET = 1 << 26


@dataclass(frozen=True)
class DataParallel:
    """One rank's place on the ``data`` axis of a training mesh: its rows
    of every global batch, and the sums of what the ranks computed on
    theirs (under no_grad, in place)."""
    size: int = 1
    rank: int = 0
    group: object = None

    @classmethod
    def on_axis(cls, mesh, axis: str = "data") -> DataParallel:
        """This process's place on ``axis`` of a DeviceMesh."""
        return cls(size=mesh.shape[mesh.mesh_dim_names.index(axis)],
                   rank=mesh.get_local_rank(axis), group=mesh.get_group(axis))

    def rows(self, x):
        """This rank's rows (dim 0) of a global batch leaf."""
        if x.shape[0] % self.size:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split {self.size} ways")
        n = x.shape[0] // self.size
        return x[self.rank * n:(self.rank + 1) * n]

    def mean(self, tensors: list) -> list:
        """The mean over the ranks of each tensor: summed in f32 in flat
        buckets of at most MEAN_BUCKET elements (one all_reduce each; a
        larger tensor goes alone), divided by the size, cast back to its
        dtype."""
        out, i = [], 0
        while i < len(tensors):
            j, n = i + 1, tensors[i].numel()
            while j < len(tensors) and n + tensors[j].numel() <= MEAN_BUCKET:
                n += tensors[j].numel()
                j += 1
            flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors[i:j]])
            collectives.all_reduce(flat, axis="data", group=self.group)
            flat /= self.size
            for t, part in zip(tensors[i:j], flat.split([t.numel() for t in tensors[i:j]])):
                out.append(part.view(t.shape).to(t.dtype))
            i = j
        return out


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("tensor_parallel", default=None)


def active_tp() -> TensorParallel | None:
    """The TensorParallel of the enclosing ``tensor_parallel`` scope, or None
    (the single-device forward)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def tensor_parallel(tp: TensorParallel | None):
    """Run the enclosed model calls as rank ``tp.rank`` of ``tp``. The scope
    is the calling thread's (a context variable) and restores the one it
    replaced, so mesh and plain engines can alternate in one process."""
    token = _ACTIVE.set(tp)
    try:
        yield tp
    finally:
        _ACTIVE.reset(token)


def scoped_api(api, tp: TensorParallel):
    """``api`` (models.ModelApi) with every function run inside
    ``tensor_parallel(tp)``: init_cache then allocates the rank's own cache
    heads, and prefill / decode run the sharded forward."""
    def wrap(fn):
        def call(*args, **kw):
            with tensor_parallel(tp):
                return fn(*args, **kw)
        return call
    return api._replace(**{f: wrap(getattr(api, f)) for f in api._fields
                           if f != "cfg" and callable(getattr(api, f))})
