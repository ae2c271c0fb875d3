"""The central weighted mean over the stacked client axis, through the
compressed aggregation wires (counterpart of
``neuroimagedisttraining_tpu/parallel/collectives.py``, its off-mesh half).

* **bucketed** (f32): the ``[C, N]`` client matrix cut into fixed-size
  buckets and reduced bucket by bucket — element for element the dense
  reduction.
* **low-precision wire**: each client's values are cast to bf16, or
  stochastically rounded to int8 with a per-bucket max-abs scale, and
  accumulated in f32 (the int8 wire is one fused quantize-reduce kernel).
* **mask-aware sparse**: a :class:`SparsePlan` built from a static mask
  gathers only the live coordinates of each kernel leaf before the reduce
  and scatters the result back.
* **error-feedback top-k**: per leaf-group top-k magnitude selection of the
  clients' compensated deltas (:func:`topk_sparsify`), then the reduce; the
  residual bookkeeping lives in ``algorithms/base.py``.
* **hier**: off the mesh there is one slice, so the two-stage reduce is the
  exact f32 bucketed reduce.

A tree is a ``dict`` of name -> tensor with a leading client axis. Every
flattening here is the reference's: leaves in its ``tree_leaves`` order,
each in its layout (``convert.py``), so the ``[C, N]`` matrix, the int8
buckets and the top-k leaf groups are the reference's, element for element.

The random draws of the int8 wire are an argument (``uniforms``, the
``[C, nb, b]`` uniforms of its stochastic rounding), as at every seam of
this package. Every contraction is the weighted-sum kernel
(``ops.kernels.fused_weighted_sum``, plain version
:func:`core.state.weighted_sum`): one rounding per multiply and per add in
static client order, so no global setting (TF32) can touch it, and
"bucketed" equals "dense" bit for bit.

**On a client mesh** (``mesh=``, a ``parallel.mesh.ClientMesh``; the
reference's shard_map halves) each rank holds its block of the client axis
(``stacked`` its ``[C/D, ...]`` rows, ``weights`` the whole ``[C]`` vector)
and contracts it leaf group by leaf group with the weighted-sum kernel, one
launch a group, each group's collective issued right after its own
contraction: the f32 wire is one ``all_reduce`` of the group's partials (the
reference's ``psum``); bf16 and int8 are one ``all_gather`` of the cast or
quantized partials (int8: and one of its scales), summed in f32 in rank
order. The int8 wire quantizes each rank's partial (never a client's row):
its uniforms are ``uniforms(d, i, (nb, b))``, a callable in the place of the
reference's ``fold_in(fold_in(key, d), i)`` for rank ``d`` (under "hier" its
slice ``d // inner``) and payload leaf ``i``. "hier" reduces within slices
of ``inner`` ranks at full precision, then across slices on the wire, over
sub-groups the mesh makes once. Where the mesh has one rank, or ``C`` does
not divide over it, the reduce is the off-mesh one on all ``C`` rows, which
every rank then holds.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import (
    from_reference_layout,
    reference_leaf_order,
    to_reference_layout,
)
from ..core.state import Tree, row_sum
from ..ops import kernels

#: 256k f32 = 1 MiB per bucket
DEFAULT_BUCKET_SIZE = 1 << 18

WIRE_FORMATS = ("f32", "bf16", "int8")

#: the ``agg_impl`` hyperparameter surface (algorithms/base.py)
AGG_IMPLS = ("dense", "bucketed", "bf16", "int8", "sparse", "topk", "hier")

#: cross-slice wire choices of the hierarchical reduce ("sparse" =
#: compressed-plan f32 across slices — SalientGrads only)
HIER_WIRES = ("f32", "bf16", "int8", "sparse")


class FlatSpec(NamedTuple):
    """What rebuilds a tree from its flat vector."""

    #: the tree's own key order (that of the rebuilt tree)
    keys: Tuple[str, ...]
    #: the keys in the reference's leaf order (that of the flat vector)
    names: Tuple[str, ...]
    #: per name, its shape in this package's layout
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    dtypes: Tuple[Any, ...]
    total: int


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _ref_shape(name: str, shape) -> Tuple[int, ...]:
    """``shape`` (this package's layout) in the reference's layout."""
    return tuple(to_reference_layout(
        name, torch.empty(shape, device="meta")).shape)


def flat_spec(tree: Tree, stacked: bool = False) -> FlatSpec:
    """Describe ``tree``'s leaves; ``stacked=True`` strips the leading
    client axis."""
    names = tuple(reference_leaf_order(tree))
    shapes = tuple(tuple(tree[k].shape[1:] if stacked else tree[k].shape)
                   for k in names)
    sizes = tuple(_numel(s) for s in shapes)
    return FlatSpec(tuple(tree), names, shapes, sizes,
                    tuple(tree[k].dtype for k in names), sum(sizes))


def tree_to_vec(tree: Tree) -> torch.Tensor:
    """Flatten a tree into one vector, the reference's way."""
    return torch.cat([to_reference_layout(k, tree[k]).reshape(-1)
                      for k in reference_leaf_order(tree)])


def _from_ref_flat(name: str, flat: torch.Tensor, shape, lead=()):
    """A flat block in the reference's layout (``lead`` axes in front) ->
    the leaf of ``shape`` in this package's layout, contiguous."""
    ref = flat.reshape(tuple(lead) + _ref_shape(name, shape))
    return from_reference_layout(name, ref, lead=len(lead)).contiguous()


def vec_to_tree(vec: torch.Tensor, spec: FlatSpec) -> Tree:
    """Rebuild the tree described by ``spec`` from its flat vector."""
    out = {}
    off = 0
    for name, shape, size, dtype in zip(spec.names, spec.shapes, spec.sizes,
                                        spec.dtypes):
        out[name] = _from_ref_flat(name, vec[off:off + size],
                                   shape).to(dtype)
        off += size
    return {k: out[k] for k in spec.keys}


def stacked_to_mat(stacked: Tree) -> torch.Tensor:
    """``[C, ...]``-stacked tree -> one ``[C, N]`` f32 matrix, the
    reference's (same column order, same values)."""
    names = reference_leaf_order(stacked)
    c = stacked[names[0]].shape[0]
    return torch.cat([to_reference_layout(k, stacked[k], lead=1)
                      .reshape(c, -1).to(torch.float32) for k in names],
                     dim=1)


# ---------------------------------------------------------------------------
# wire formats
# ---------------------------------------------------------------------------

def bucket_shape(n: int, bucket_size: int = DEFAULT_BUCKET_SIZE
                 ) -> Tuple[int, int]:
    """``(nb, b)``: the wire's buckets of an ``n``-column row — ``b =
    min(bucket_size, n)`` values each, the last one zero-padded. The int8
    wire's uniforms for ``C`` clients have shape ``[C, nb, b]``."""
    b = min(int(bucket_size), max(int(n), 1))
    return -(-int(n) // b), b


def _check_wire(wire: str, uniforms) -> None:
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire {wire!r} not in {WIRE_FORMATS}")
    if wire == "int8" and uniforms is None:
        raise ValueError("wire='int8' needs the uniforms of its stochastic "
                         "rounding")


#: 1/127, which a float32 multiply rounds to float32. The reference's round
#: body is jitted, and XLA rewrites its ``amax / 127.0`` into a multiply by
#: this reciprocal (one ulp off the divide for some amax;
#: tests/test_torch_port_collectives.py pins that the multiply, and not the
#: divide, gives the jitted scales bit for bit). The quantize's own
#: ``x / scale`` stays a divide there.
_INV_127 = 1.0 / 127.0


def _int8_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-bucket (last-axis) max-abs/127 scale, keepdims; 1.0 for an
    all-zero bucket. A max is exact in any order, so the scale is the same
    bits on every device."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return torch.where(amax > 0, amax * _INV_127,
                       torch.ones_like(amax))


def _quantize_int8(x: torch.Tensor, uniforms: torch.Tensor,
                   scale: Optional[torch.Tensor] = None):
    """Per-bucket (last-axis) max-abs scaling + stochastic rounding on the
    given uniforms: ``clip(floor(y) + (u < y - floor(y)), -127, 127)`` for
    ``y = x / scale``. Returns (int8 payload, f32 scale broadcastable
    against it); ``scale`` defaults to :func:`_int8_scale`."""
    if scale is None:
        scale = _int8_scale(x)
    y = x / scale
    f = torch.floor(y)
    q = torch.clamp(f + (uniforms < (y - f)).to(y.dtype), -127.0, 127.0)
    return q.to(torch.int8), scale


def _buckets(mat: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """``[C, n]`` -> ``[C, nb, b]``, the tail bucket zero-padded."""
    c, n = mat.shape
    nb, b = bucket_shape(n, bucket_size)
    pad = nb * b - n
    if pad:
        mat = torch.nn.functional.pad(mat, (0, pad))
    return mat.reshape(c, nb, b)


def wire_roundtrip_mat(mat: torch.Tensor, wire: str, *,
                       bucket_size: int = DEFAULT_BUCKET_SIZE,
                       uniforms: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Encode and decode each row of an ``[S, N]`` matrix through the
    ``wire`` format — what the server would see after the hop, unreduced.
    bf16 is the double cast; int8 quantizes per (row, bucket) with the
    spelling the reducing wire uses, so a row decoded here equals its
    contribution there given the same uniforms; f32 is the identity."""
    _check_wire(wire, uniforms)
    if wire == "f32":
        return mat
    if wire == "bf16":
        return mat.to(torch.bfloat16).to(torch.float32)
    n = mat.shape[1]
    q, scale = _quantize_int8(_buckets(mat, bucket_size), uniforms)
    deq = q.to(torch.float32) * scale
    return deq.reshape(mat.shape[0], -1)[:, :n]


# ---------------------------------------------------------------------------
# leaf-group buckets
# ---------------------------------------------------------------------------

def _leaf_groups(sizes: Sequence[int], bucket_size: int) -> List[List[int]]:
    """Greedy partition of the leaf list (reference leaf order) into
    contiguous groups of >= ``bucket_size`` elements: the top-k selection's
    segments."""
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += int(s)
        if acc >= bucket_size:
            groups.append(cur)
            cur, acc = [], 0
    if cur:
        groups.append(cur)
    return groups


def _mesh_axis_rows(mesh, axis_name: str, c: int) -> int:
    """Usable rank count along ``axis_name`` for a C-row client axis; 0
    takes the off-mesh path (no mesh, axis missing, one rank, or C not
    divisible — e.g. a partial-participation round on a wider mesh)."""
    if mesh is None or axis_name not in getattr(mesh, "axis_names", ()):
        return 0
    d = int(mesh.shape[axis_name])
    if d <= 1 or c % d:
        return 0
    return d


def _group_vals(payload, g: Sequence[int]) -> List[torch.Tensor]:
    """One group's flat payload vectors: ``payload`` is a list of vectors,
    or a callable of the group that makes them (each group's local
    contraction made right before its own collective)."""
    if callable(payload):
        return list(payload(g))
    return [payload[i] for i in g]


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """``flat`` cut back into vectors of the sizes of ``like``."""
    return list(torch.split(flat, [int(v.numel()) for v in like]))


def _int8_leaf_payload(v: torch.Tensor, u: torch.Tensor, bucket_size: int):
    """One flat partial's int8 payload: padded to ``(nb, b)`` buckets and
    quantized per bucket on the uniforms ``u`` (``[nb, b]``). Returns the
    int8 payload and the f32 scales, ``[nb, 1]``."""
    n = int(v.numel())
    nb, b = bucket_shape(n, bucket_size)
    if tuple(u.shape) != (nb, b):
        raise ValueError(f"int8 wire: uniforms {tuple(u.shape)} for a "
                         f"payload of {n} values in ({nb}, {b}) buckets")
    vb = torch.nn.functional.pad(v.reshape(-1), (0, nb * b - n)) \
        .reshape(nb, b)
    return _quantize_int8(vb, u.to(device=v.device, dtype=torch.float32))


def _int8_reduce_vals(vals, idx, wid: int, mesh, uniforms: Callable,
                      bucket_size: int, group=None) -> List[torch.Tensor]:
    """The int8 wire of one group: each partial ``vals[j]`` (payload leaf
    ``idx[j]``) quantized on ``uniforms(wid, idx[j], (nb, b))``, the
    group's payloads and scales gathered over ``group`` (two collectives),
    dequantized and summed in f32 in rank order."""
    qs, ss = [], []
    for i, v in zip(idx, vals):
        nb, b = bucket_shape(int(v.numel()), bucket_size)
        q, s = _int8_leaf_payload(v, uniforms(wid, i, (nb, b)), bucket_size)
        qs.append(q.reshape(-1))
        ss.append(s.reshape(-1))
    gq = mesh.all_gather(torch.cat(qs), group)
    gs = mesh.all_gather(torch.cat(ss), group)
    out, oq, os_ = [], 0, 0
    for v in vals:
        n = int(v.numel())
        nb, b = bucket_shape(n, bucket_size)
        q = gq[:, oq:oq + nb * b].reshape(-1, nb, b)
        s = gs[:, os_:os_ + nb].reshape(-1, nb, 1)
        out.append(row_sum(q.to(torch.float32) * s)
                   .reshape(-1)[:n])
        oq += nb * b
        os_ += nb
    return out


def _wire_reduce_groups(payload, groups, *, mesh, wire: str,
                        uniforms: Optional[Callable] = None,
                        bucket_size: int = DEFAULT_BUCKET_SIZE
                        ) -> List[torch.Tensor]:
    """Each rank's flat f32 partials (``payload``, see :func:`_group_vals`)
    reduced across the mesh, one collective per leaf group: an
    ``all_reduce`` of the group's concatenated partials for f32; an
    ``all_gather`` of the wire-cast payload and an f32 sum in rank order for
    bf16 and int8 (int8 on ``uniforms(rank, i, (nb, b))``)."""
    if wire == "int8" and uniforms is None:
        raise ValueError("wire='int8' needs the uniforms of its stochastic "
                         "rounding")
    out: List[Optional[torch.Tensor]] = [None] * sum(len(g) for g in groups)
    for g in groups:
        vals = _group_vals(payload, g)
        if wire == "f32":
            red = _split(mesh.all_reduce(torch.cat(vals)), vals)
        elif wire == "bf16":
            gath = mesh.all_gather(torch.cat(vals).to(torch.bfloat16))
            red = _split(row_sum(gath.to(torch.float32)), vals)
        else:
            red = _int8_reduce_vals(vals, g, mesh.rank, mesh, uniforms,
                                    bucket_size)
        for i, r in zip(g, red):
            out[i] = r
    return out


def resolve_hier_inner(n_devices: int, requested: int = 0) -> int:
    """Ranks per intra-slice group of the hierarchical reduce.

    ``requested > 0`` must divide the axis size (a static config error
    otherwise, never silently adjusted); ``requested`` of 1 or >= the axis
    size means one stage, returned as 0 (disabled). ``requested == 0``
    auto-picks the largest divisor d with ``d*d <= n_devices`` (the
    balanced two-stage split: 8 devices -> 2x4, 16 -> 4x4); axes of <= 2
    devices have no second stage."""
    if requested and (requested < 0
                      or (requested > 1 and n_devices % requested)):
        # validated before the small-axis early return: a typo'd inner
        # must fail on the 2-device mesh, not only when promoted
        raise ValueError(
            f"hier_inner {requested} must divide the {n_devices}-"
            "device clients axis (intra-slice groups are equal-size "
            "device blocks)")
    if n_devices <= 2:
        return 0
    if requested:
        return requested if 1 < requested < n_devices else 0
    inner = 1
    for d in range(2, n_devices):
        if n_devices % d == 0 and d * d <= n_devices:
            inner = d
    return inner if inner > 1 else 0


def _hier_index_groups(n_devices: int, inner: int):
    """(intra, inter) rank groups: contiguous ``inner``-rank blocks are one
    slice; position-matched ranks across the ``n_devices // inner`` slices
    form the cross-slice groups."""
    outer = n_devices // inner
    intra = [[s * inner + i for i in range(inner)] for s in range(outer)]
    inter = [[s * inner + i for s in range(outer)] for i in range(inner)]
    return intra, inter


def _hier_reduce_groups(payload, groups, *, mesh, wire: str,
                        uniforms: Optional[Callable] = None,
                        bucket_size: int = DEFAULT_BUCKET_SIZE,
                        n_devices: int, inner: int) -> List[torch.Tensor]:
    """The two-stage hierarchical reduce, one leaf group at a time: a
    full-precision ``all_reduce`` within each ``inner``-rank slice, then
    each slice's partial across the slices on ``wire`` (f32
    ``all_reduce``, or bf16/int8 ``all_gather`` and an f32 sum in slice
    order). The int8 uniforms are the slice's, ``uniforms(rank // inner,
    i, (nb, b))``: every rank of a slice holds the same partial and must
    quantize it the same way. Every rank ends with the whole sum."""
    if n_devices != mesh.size:
        raise ValueError(f"hier over {n_devices} ranks on a "
                         f"{mesh.size}-rank mesh")
    if wire == "int8" and uniforms is None:
        raise ValueError("wire='int8' needs the uniforms of its stochastic "
                         "rounding")
    intra, inter = mesh.hier_groups(inner)
    out: List[Optional[torch.Tensor]] = [None] * sum(len(g) for g in groups)
    for g in groups:
        vals = _group_vals(payload, g)
        part = _split(mesh.all_reduce(torch.cat(vals), intra), vals)
        if wire == "f32":
            red = _split(mesh.all_reduce(torch.cat(part), inter), vals)
        elif wire == "bf16":
            gath = mesh.all_gather(torch.cat(part).to(torch.bfloat16), inter)
            red = _split(row_sum(gath.to(torch.float32)), vals)
        else:
            red = _int8_reduce_vals(part, g, mesh.rank // inner, mesh,
                                    uniforms, bucket_size, inter)
        for i, r in zip(g, red):
            out[i] = r
    return out


# ---------------------------------------------------------------------------
# mask-aware sparse plan
# ---------------------------------------------------------------------------

class SparsePlan(NamedTuple):
    """Per leaf, in the reference's leaf order, the int64 flat live indices
    in the reference's layout (None = a dense leaf: non-kernel leaves and
    kernels with no dead coordinate). Valid while the mask it was built from
    is the live one (SalientGrads' SNIP mask is fixed for the run)."""

    names: Tuple[str, ...]
    idx: Tuple[Optional[torch.Tensor], ...]
    dense_size: int
    compressed_size: int

    @property
    def density(self) -> float:
        return self.compressed_size / max(self.dense_size, 1)


def build_sparse_plan(mask: Tree, stacked: bool = False) -> SparsePlan:
    """Gather plan from a concrete mask tree; ``stacked=True`` takes the
    union of live coordinates over the leading client axis."""
    from ..ops.sparsity import host_live_indices

    names = tuple(reference_leaf_order(mask))
    idx = tuple(host_live_indices(mask, stacked=stacked))
    dense = comp = 0
    for k, ix in zip(names, idx):
        size = _numel(mask[k].shape[1:] if stacked else mask[k].shape)
        dense += size
        comp += size if ix is None else int(ix.numel())
    return SparsePlan(names, idx, dense, comp)


def _plan_check(stacked: Tree, plan: SparsePlan) -> List[str]:
    names = reference_leaf_order(stacked)
    if tuple(names) != plan.names:
        raise ValueError(
            f"sparse plan has {len(plan.names)} leaves {plan.names[:3]}..., "
            f"tree has {len(names)} {tuple(names[:3])}... — the plan was "
            "built for a different tree")
    return names


def _expand_leaf(red: torch.Tensor, ix: Optional[torch.Tensor], name: str,
                 shape, dtype, lead=()) -> torch.Tensor:
    """Compressed reduced leaf (``lead`` axes in front) -> the dense leaf in
    this package's layout; dead coordinates are 0."""
    if ix is not None:
        dense = red.new_zeros(tuple(lead) + (_numel(shape),))
        red = dense.index_copy_(len(lead), ix, red)
    return _from_ref_flat(name, red, shape, lead).to(dtype)


def _compress(stacked: Tree, plan: SparsePlan) -> torch.Tensor:
    """``[C, ...]``-stacked tree -> ``[C, M]`` f32 matrix holding each dense
    leaf in full and each sparse leaf's live coordinates."""
    names = _plan_check(stacked, plan)
    c = stacked[names[0]].shape[0]
    cols = []
    for k, ix in zip(names, plan.idx):
        flat = to_reference_layout(k, stacked[k], lead=1).reshape(c, -1) \
            .to(torch.float32)
        cols.append(flat if ix is None else flat.index_select(1, ix))
    return torch.cat(cols, dim=1)


def _expand_vec(vec: torch.Tensor, stacked: Tree, plan: SparsePlan) -> Tree:
    """Inverse of :func:`_compress` for the reduced ``[M]`` vector."""
    out = {}
    off = 0
    for k, ix in zip(plan.names, plan.idx):
        shape = stacked[k].shape[1:]
        n = _numel(shape) if ix is None else int(ix.numel())
        out[k] = _expand_leaf(vec[off:off + n], ix, k, shape,
                              stacked[k].dtype)
        off += n
    return {k: out[k] for k in stacked}


def plan_dead_select(stacked: Tree, plan: SparsePlan) -> Tree:
    """Zero the dead coordinates of a ``[C, ...]``-stacked tree by a select
    against the plan's live mask (never arithmetic, so NaN rows cannot
    smear)."""
    _plan_check(stacked, plan)
    out = dict(stacked)
    for k, ix in zip(plan.names, plan.idx):
        if ix is None:
            continue
        x = stacked[k]
        # index_fill_ takes its value by value (a CUDA graph can hold it;
        # an indexed assignment copies a host scalar to the card)
        live = torch.zeros(_numel(x.shape[1:]), dtype=torch.bool,
                           device=x.device).index_fill_(0, ix, True)
        live = _from_ref_flat(k, live, x.shape[1:])
        out[k] = torch.where(live, x, torch.zeros_like(x))
    return out


# ---------------------------------------------------------------------------
# error-feedback top-k selection
# ---------------------------------------------------------------------------

def topk_count(n: int, k_frac: float) -> int:
    """Selected-coordinate count for a segment of ``n`` coordinates at
    fraction ``k_frac``: ``min(n, max(1, ceil(k_frac * n)))``."""
    if not 0.0 < k_frac <= 1.0:
        raise ValueError(f"topk density {k_frac} not in (0, 1]")
    return min(max(int(n), 1), max(1, int(math.ceil(k_frac * n))))


def topk_groups(stacked: Tree, bucket_size: int = DEFAULT_BUCKET_SIZE,
                plan: Optional[SparsePlan] = None) -> List[Tuple[int, int]]:
    """The top-k selection's segments ``(start, end)`` of the (compressed,
    with a plan) ``[C, M]`` matrix: one per leaf group."""
    names = reference_leaf_order(stacked)
    idxs = plan.idx if plan is not None else (None,) * len(names)
    sizes = [_numel(stacked[k].shape[1:]) if ix is None else int(ix.numel())
             for k, ix in zip(names, idxs)]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    return [(offs[g[0]], offs[g[-1] + 1])
            for g in _leaf_groups(sizes, bucket_size)]


def topk_sparsify(stacked: Tree, k_frac: float, *,
                  plan: Optional[SparsePlan] = None,
                  bucket_size: int = DEFAULT_BUCKET_SIZE,
                  sample: int = 0) -> Tree:
    """Per leaf-group top-k magnitude selection over a ``[C, ...]``-stacked
    tree: within each leaf group (:func:`_leaf_groups`), each client keeps
    its ``topk_count(group_size, k_frac)`` largest-|value| coordinates and
    zeroes the rest. With a ``plan`` the selection runs on the compressed
    live coordinates. Coordinates tying the threshold are all kept.

    The threshold is the exact k-th largest magnitude per (client, group)
    (``ops.topk_select.select_threshold``: the threshold kernel on the GPU,
    one launch per group), or the strided ``sample`` estimate."""
    from ..ops.topk_select import select_threshold

    if plan is not None:
        _plan_check(stacked, plan)
    mat = _compress(stacked, plan) if plan is not None \
        else stacked_to_mat(stacked)
    cols = []
    for start, end in topk_groups(stacked, bucket_size, plan):
        seg = mat[:, start:end]
        av = torch.abs(seg)
        thr = select_threshold(av, topk_count(end - start, k_frac),
                               sample=sample)
        cols.append(torch.where(av >= thr, seg, torch.zeros_like(seg)))
    sp_mat = torch.cat(cols, dim=1)
    c = sp_mat.shape[0]
    out = {}
    off = 0
    names = reference_leaf_order(stacked)
    idxs = plan.idx if plan is not None else (None,) * len(names)
    for k, ix in zip(names, idxs):
        shape = stacked[k].shape[1:]
        n = _numel(shape) if ix is None else int(ix.numel())
        out[k] = _expand_leaf(sp_mat[:, off:off + n], ix, k, shape,
                              stacked[k].dtype, lead=(c,))
        off += n
    return {k: out[k] for k in stacked}


def topk_weighted_mean(stacked: Tree, weights: torch.Tensor, k_frac: float,
                       *, plan: Optional[SparsePlan] = None, mesh=None,
                       axis_name: str = "clients",
                       bucket_size: int = DEFAULT_BUCKET_SIZE,
                       sample: int = 0) -> Tuple[Tree, Tree]:
    """The ``agg_impl='topk'`` aggregate: sparsify each client's row, then
    the weighted mean of the sparsified rows (compressed by ``plan`` when
    given). Returns ``(aggregate, sparsified)``; the caller owns the
    error-feedback bookkeeping. The selection is per client, so on a mesh
    each rank sparsifies the rows it holds and only the reduce crosses
    ranks."""
    sp = topk_sparsify(stacked, k_frac, plan=plan, bucket_size=bucket_size,
                       sample=sample)
    kw = dict(mesh=mesh, axis_name=axis_name, bucket_size=bucket_size)
    if plan is not None:
        agg = sparse_weighted_mean(sp, weights, plan, **kw)
    else:
        agg = weighted_mean(sp, weights, **kw)
    return agg, sp


# ---------------------------------------------------------------------------
# the weighted means
# ---------------------------------------------------------------------------

def _reduce_mat(mat: torch.Tensor, weights: torch.Tensor, *,
                bucket_size: int = DEFAULT_BUCKET_SIZE, wire: str = "f32",
                uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[j] = sum_c weights[c] * mat[c, j]`` in bucket layout, the wire
    cast applied per client. The int8 wire is the fused quantize-reduce
    kernel at any bucket size, the others the weighted-sum kernel (each its
    plain version on the CPU); ``uniforms`` is the int8 wire's ``[C, nb,
    b]`` draw."""
    _check_wire(wire, uniforms)
    n = mat.shape[1]
    w = weights.to(torch.float32)
    buckets = _buckets(mat, bucket_size)
    if wire == "int8":
        if tuple(uniforms.shape) != tuple(buckets.shape):
            raise ValueError(f"int8 wire: uniforms {tuple(uniforms.shape)} "
                             f"for buckets {tuple(buckets.shape)}")
        out = kernels.fused_quantize_reduce(
            buckets, w, uniforms.to(torch.float32).contiguous(),
            _int8_scale(buckets)[..., 0].contiguous())
    else:
        if wire == "bf16":
            buckets = buckets.to(torch.bfloat16).to(torch.float32)
        out = kernels.fused_weighted_sum({"buckets": buckets}, w)["buckets"]
    return out.reshape(-1)[:n]


def _off_mesh_wire(wire: str, hier_inner: int) -> str:
    """The wire that fires off the mesh: with ``hier_inner`` (the
    hierarchical reduce) there is one slice, so none but the exact f32."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire {wire!r} not in {WIRE_FORMATS}")
    return "f32" if hier_inner else wire


def _client_rows(stacked: Tree, weights: torch.Tensor, mesh,
                 axis_name: str) -> int:
    """The rank count the reduce shards over (0: off the mesh), checking
    that ``stacked`` holds the rows that path reads: the rank's block of
    the ``len(weights)`` clients on the mesh, all of them off it."""
    c = int(weights.shape[0])
    d = _mesh_axis_rows(mesh, axis_name, c)
    rows = int(next(iter(stacked.values())).shape[0])
    want = c // d if d else c
    if rows != want:
        where = (f"rank {mesh.rank}'s block of the {d}-rank mesh" if d
                 else "the off-mesh reduce")
        raise ValueError(f"{rows} stacked rows for {c} weights: {where} "
                         f"reads {want}")
    return d


def _mesh_reduce_leaves(stacked: Tree, weights: torch.Tensor, *, mesh,
                        axis_name: str = "clients",
                        bucket_size: int = DEFAULT_BUCKET_SIZE,
                        wire: str = "f32",
                        uniforms: Optional[Callable] = None,
                        plan: Optional[SparsePlan] = None,
                        masks: Optional[Tree] = None,
                        hier_inner: int = 0) -> List[torch.Tensor]:
    """The reduce over the mesh-sharded client axis: the flat reduced
    payload per leaf in the reference's leaf order (compressed to the plan's
    live coordinates when given; with ``masks`` the list is the num leaves,
    ``x * m``, then the den leaves, ``m``). Each rank contracts only its
    rows (``stacked``, its block; ``weights`` the whole vector), compressed
    before the contraction on the sparse path, one weighted-sum launch per
    leaf group right before that group's collective; a rank with no row
    contributes f32 zeros.

    ``hier_inner`` nonzero routes each group through the two-stage reduce
    (-1: the balanced auto split, :func:`resolve_hier_inner`); with one
    slice the configured cross-slice wire never fires and the reduce is the
    exact f32 one."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire {wire!r} not in {WIRE_FORMATS}")
    names = reference_leaf_order(stacked)
    idxs = plan.idx if plan is not None else (None,) * len(names)
    lo, hi = mesh.block(int(weights.shape[0]))
    w = weights[lo:hi].to(torch.float32).contiguous()
    rows = hi - lo
    sources = [(stacked, k, ix) for k, ix in zip(names, idxs)]
    if masks is not None:
        xm = {k: stacked[k].to(torch.float32) * masks[k].to(torch.float32)
              for k in names}
        sources = [(xm, k, ix) for k, ix in zip(names, idxs)] + \
            [(masks, k, ix) for k, ix in zip(names, idxs)]
    psizes = [_numel(stacked[k].shape[1:]) if ix is None else int(ix.numel())
              for _, k, ix in sources]
    groups = _leaf_groups(psizes, bucket_size)
    n_devices = int(mesh.shape[axis_name])
    inner = resolve_hier_inner(n_devices, max(hier_inner, 0)) \
        if hier_inner else 0
    if hier_inner and not inner:
        wire = "f32"

    def contract(g):
        if not rows:
            return [torch.zeros(psizes[j], dtype=torch.float32,
                                device=w.device) for j in g]
        mats = {}
        for j in g:
            tree, k, ix = sources[j]
            flat = to_reference_layout(k, tree[k], lead=1) \
                .reshape(rows, -1).to(torch.float32)
            mats[str(j)] = (flat if ix is None
                            else flat.index_select(1, ix)).contiguous()
        out = kernels.fused_weighted_sum(mats, w)
        return [out[str(j)] for j in g]

    if inner:
        return _hier_reduce_groups(
            contract, groups, mesh=mesh, wire=wire, uniforms=uniforms,
            bucket_size=bucket_size, n_devices=n_devices, inner=inner)
    return _wire_reduce_groups(contract, groups, mesh=mesh, wire=wire,
                               uniforms=uniforms, bucket_size=bucket_size)


def weighted_mean(stacked: Tree, weights: torch.Tensor, *, mesh=None,
                  axis_name: str = "clients",
                  bucket_size: int = DEFAULT_BUCKET_SIZE, wire: str = "f32",
                  uniforms=None, hier_inner: int = 0) -> Tree:
    """Weighted mean over the leading client axis through the bucketed
    (optionally low-precision) reduce; callers pass normalized weights.
    Off the mesh ``wire='f32'`` is bit-equal to
    ``core.state.weighted_tree_sum``, and ``hier_inner`` (the hierarchical
    reduce) is the exact f32 reduce, where there is one slice and the
    cross-slice wire never fires (and needs no uniforms); ``uniforms`` is
    the int8 wire's ``[C, nb, b]`` draw. On a usable ``mesh`` (module
    docstring) ``stacked`` is the rank's block, ``uniforms`` the callable
    ``(rank or slice, leaf, shape) -> [nb, b]``, and every rank returns the
    whole mean."""
    if _client_rows(stacked, weights, mesh, axis_name):
        red = _mesh_reduce_leaves(
            stacked, weights, mesh=mesh, axis_name=axis_name,
            bucket_size=bucket_size, wire=wire, uniforms=uniforms,
            hier_inner=hier_inner)
        spec = flat_spec(stacked, stacked=True)
        out = {k: _from_ref_flat(k, r, shape).to(dtype) for k, r, shape, dtype
               in zip(spec.names, red, spec.shapes, spec.dtypes)}
        return {k: out[k] for k in spec.keys}
    wire = _off_mesh_wire(wire, hier_inner)
    _check_wire(wire, uniforms)
    vec = _reduce_mat(stacked_to_mat(stacked), weights,
                      bucket_size=bucket_size, wire=wire, uniforms=uniforms)
    return vec_to_tree(vec, flat_spec(stacked, stacked=True))


def _masked_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den > 0``, else 0 (no client holds the
    coordinate live)."""
    live = den > 0
    return torch.where(live, num / torch.where(live, den,
                                               torch.ones_like(den)),
                       torch.zeros_like(num))


def sparse_weighted_mean(stacked: Tree, weights: torch.Tensor,
                         plan: SparsePlan, *, masks: Optional[Tree] = None,
                         mesh=None, axis_name: str = "clients",
                         bucket_size: int = DEFAULT_BUCKET_SIZE,
                         wire: str = "f32", uniforms=None,
                         hier_inner: int = 0) -> Tree:
    """Mask-aware sparse weighted mean: reduce only the plan's live
    coordinates, then rebuild the dense layout.

    ``masks=None`` (SalientGrads: one global mask, normalized weights) is
    the plain weighted mean of honored-mask locals, bit-equal to the dense
    aggregate. With ``masks`` (``[C, ...]``-stacked per-client masks) it is
    the mask-weighted mean ``sum(w*m*x) / sum(w*m)``, numerator and
    denominator both reduced on the compressed representation (0 where no
    client holds a coordinate live), bit-equal to
    :func:`masked_weighted_mean`; off the mesh the int8 wire then takes a
    pair of draws, ``(num, den)``. The mesh, ``uniforms`` and
    ``hier_inner`` are as in :func:`weighted_mean`."""
    _plan_check(stacked, plan)
    if _client_rows(stacked, weights, mesh, axis_name):
        red = _mesh_reduce_leaves(
            stacked, weights, mesh=mesh, axis_name=axis_name,
            bucket_size=bucket_size, wire=wire, uniforms=uniforms, plan=plan,
            masks=masks, hier_inner=hier_inner)
        n = len(plan.names)
        if masks is not None:
            red = [_masked_ratio(a, b) for a, b in zip(red[:n], red[n:])]
        out = {k: _expand_leaf(r, ix, k, stacked[k].shape[1:],
                               stacked[k].dtype)
               for k, r, ix in zip(plan.names, red, plan.idx)}
        return {k: out[k] for k in stacked}
    wire = _off_mesh_wire(wire, hier_inner)
    _check_wire(wire, uniforms)
    kw = dict(bucket_size=bucket_size, wire=wire)
    if masks is None:
        vec = _reduce_mat(_compress(stacked, plan), weights,
                          uniforms=uniforms, **kw)
        return _expand_vec(vec, stacked, plan)
    u_num, u_den = uniforms if uniforms is not None else (None, None)
    mmat = _compress(masks, plan)
    num = _reduce_mat(_compress(stacked, plan) * mmat, weights,
                      uniforms=u_num, **kw)
    den = _reduce_mat(mmat, weights, uniforms=u_den, **kw)
    return _expand_vec(_masked_ratio(num, den), stacked, plan)


def masked_weighted_mean(stacked: Tree, weights: torch.Tensor,
                         masks: Tree) -> Tree:
    """The dense mask-weighted aggregate: ``sum_c w_c m_c x_c / sum_c w_c
    m_c`` per coordinate, 0 where no client holds the coordinate live (the
    ``sum(masks)`` denominator of the reference's sparse-personalized
    aggregation); numerator and denominator through the weighted-sum
    kernel in one call. :func:`sparse_weighted_mean` with ``masks`` is
    bit-equal to it."""
    w = weights.to(torch.float32).contiguous()
    terms = {}
    for k, x in stacked.items():
        m = masks[k].to(torch.float32)
        terms["num." + k] = (x.to(torch.float32) * m).contiguous()
        terms["den." + k] = m.contiguous()
    red = kernels.fused_weighted_sum(terms, w)
    return {k: _masked_ratio(red["num." + k], red["den." + k]).to(x.dtype)
            for k, x in stacked.items()}


# ---------------------------------------------------------------------------
# micro-bench
# ---------------------------------------------------------------------------

def time_weighted_agg(agg_fn, stacked: Tree, weights: torch.Tensor,
                      iters: int = 8) -> float:
    """Seconds per aggregation of ``agg_fn(stacked, weights, i)``: a loop of
    ``iters`` calls with the weights rolled by ``i`` (no two calls contract
    the same weights), summed into an f32 accumulator that is read at the
    end, run once to warm up and then timed, as the reference times its
    compiled loop after a warm-up run. On the card the timed loop is
    spanned by CUDA events; on the CPU by the host clock."""
    dev = next(iter(stacked.values())).device

    def loop():
        acc = None
        for i in range(iters):
            out = agg_fn(stacked, torch.roll(weights, i), i)
            if acc is None:
                acc = {k: v.to(torch.float32).clone() for k, v in out.items()}
            else:
                for k, v in out.items():
                    acc[k] += v.to(torch.float32)
        return float(sum(float(v.sum()) for v in acc.values()))

    loop()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        loop()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    loop()
    return (time.perf_counter() - t0) / iters


def agg_microbench(mesh=None, n_clients: int = 32, iters: int = 8,
                   dense_ratio: float = 0.5,
                   bucket_size: int = DEFAULT_BUCKET_SIZE,
                   model_key: str = "3dcnn",
                   sample_shape: Tuple[int, ...] = (121, 145, 121, 1),
                   impls: Tuple[str, ...] = AGG_IMPLS,
                   topk_density: float = 0.1, topk_sample: int = 0,
                   hier_inner: int = 0, hier_wire: str = "bf16",
                   device=None) -> dict:
    """Time one weighted-mean aggregation per ``agg_impl`` on the model's
    parameter tree stacked over ``n_clients`` (honored-mask locals at
    ``dense_ratio``: a host-random mask on the kernel leaves), sharded over
    ``mesh`` when given (each rank then holds its block), with
    :func:`time_weighted_agg`. Returns ``{"agg_ms_<impl>": ms, ...}`` and
    the workload's descriptors. The reference also records each impl's
    modeled wire bytes (``wire_bytes_<impl>``, from ``obs.comm``'s
    ``WireCostModel``); the observability tier is not ported, so they are
    left out, as are its ``overlap`` and ``kernels`` knobs (no counterpart
    here)."""
    from .. import resolve_device
    from ..convert import from_reference_layout
    from ..models import create_model
    from ..ops.sparsity import kernel_flags

    dev = mesh.device if mesh is not None else resolve_device(device)
    # the 3D models size their first dense layer by the sample shape
    model = create_model(model_key, num_classes=1,
                         sample_shape=tuple(sample_shape)) \
        if model_key.startswith("3d") else create_model(model_key,
                                                         num_classes=1)
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    flags = kernel_flags(shapes)
    names = reference_leaf_order(shapes)
    n_params = sum(_numel(s) for s in shapes.values())
    rs = np.random.RandomState(0)
    g = torch.Generator(device=dev).manual_seed(0)
    mask, stacked = {}, {}
    for k in names:
        ref = _ref_shape(k, shapes[k])
        m = (rs.rand(*ref) < dense_ratio).astype(np.float32) if flags[k] \
            else np.ones(ref, np.float32)
        mask[k] = from_reference_layout(k, torch.from_numpy(m)) \
            .contiguous().to(dev)
        x = torch.randn((n_clients,) + shapes[k], generator=g, device=dev)
        stacked[k] = x * 0.01 * mask[k][None]
    w = rs.rand(n_clients).astype(np.float32)
    w = torch.from_numpy(w / w.sum()).to(dev)
    plan = build_sparse_plan(mask)
    n_devices = 1
    if mesh is not None:
        from .mesh import shard_over_clients

        stacked = shard_over_clients(stacked, mesh)
        n_devices = mesh.size
    ug = torch.Generator(device=dev)

    def u_off(i):
        n = sum(_numel(s) for s in shapes.values())
        ug.manual_seed(i)
        return torch.rand((n_clients,) + bucket_shape(n, bucket_size),
                          generator=ug, device=dev)

    def u_mesh(i):
        def draw(wid, leaf, shape):
            ug.manual_seed((i << 20) + (wid << 10) + leaf)
            return torch.rand(shape, generator=ug, device=dev)
        return draw

    def u_of(i):
        return u_mesh(i) if _mesh_axis_rows(mesh, "clients",
                                            n_clients) else u_off(i)

    kw = dict(mesh=mesh, bucket_size=bucket_size)
    hw = "f32" if hier_wire == "sparse" else hier_wire
    agg_fns = {
        "dense": lambda st, wv, i: (
            weighted_mean(st, wv, wire="f32", **kw) if mesh is not None
            else kernels.fused_weighted_sum(st, wv)),
        "bucketed": lambda st, wv, i: weighted_mean(st, wv, wire="f32",
                                                    **kw),
        "bf16": lambda st, wv, i: weighted_mean(st, wv, wire="bf16", **kw),
        "int8": lambda st, wv, i: weighted_mean(st, wv, wire="int8",
                                                uniforms=u_of(i), **kw),
        "sparse": lambda st, wv, i: sparse_weighted_mean(st, wv, plan, **kw),
        "topk": lambda st, wv, i: topk_weighted_mean(
            st, wv, topk_density, plan=plan, sample=topk_sample, **kw)[0],
        "hier": lambda st, wv, i: (
            sparse_weighted_mean(st, wv, plan, hier_inner=hier_inner or -1,
                                 **kw)
            if hier_wire == "sparse" else weighted_mean(
                st, wv, wire=hw, hier_inner=hier_inner or -1,
                uniforms=u_of(i) if hw == "int8" else None, **kw)),
    }
    result = {}
    for name in impls:
        if name not in agg_fns:
            raise ValueError(f"unknown agg impl {name!r}; choose from "
                             f"{tuple(agg_fns)}")
        result[f"agg_ms_{name}"] = time_weighted_agg(
            agg_fns[name], stacked, w, iters) * 1e3
    result.update(
        n_params=n_params, n_clients=n_clients, n_devices=n_devices,
        bucket_size=bucket_size, sparse_density=plan.density,
        topk_density=topk_density, topk_sample=topk_sample,
        hier_wire=hier_wire, hier_inner=hier_inner, model_key=model_key,
        iters=iters)
    return result
