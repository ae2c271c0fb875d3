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

The shard_map halves (a multi-GPU reduce over NCCL) are a later slice.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..convert import (
    from_reference_layout,
    reference_leaf_order,
    to_reference_layout,
)
from ..core.state import Tree
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
                       *, plan: Optional[SparsePlan] = None,
                       bucket_size: int = DEFAULT_BUCKET_SIZE,
                       sample: int = 0) -> Tuple[Tree, Tree]:
    """The ``agg_impl='topk'`` aggregate: sparsify each client's row, then
    the weighted mean of the sparsified rows (compressed by ``plan`` when
    given). Returns ``(aggregate, sparsified)``; the caller owns the
    error-feedback bookkeeping."""
    sp = topk_sparsify(stacked, k_frac, plan=plan, bucket_size=bucket_size,
                       sample=sample)
    if plan is not None:
        agg = sparse_weighted_mean(sp, weights, plan,
                                   bucket_size=bucket_size)
    else:
        agg = weighted_mean(sp, weights, bucket_size=bucket_size)
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


def weighted_mean(stacked: Tree, weights: torch.Tensor, *,
                  bucket_size: int = DEFAULT_BUCKET_SIZE, wire: str = "f32",
                  uniforms: Optional[torch.Tensor] = None,
                  hier_inner: int = 0) -> Tree:
    """Weighted mean over the leading client axis through the bucketed
    (optionally low-precision) reduce; callers pass normalized weights.
    ``wire='f32'`` is bit-equal to ``core.state.weighted_tree_sum``.
    ``hier_inner`` (the hierarchical reduce) is the exact f32 reduce off
    the mesh, where there is one slice and the cross-slice wire never
    fires (and needs no uniforms)."""
    wire = _off_mesh_wire(wire, hier_inner)
    _check_wire(wire, uniforms)
    vec = _reduce_mat(stacked_to_mat(stacked), weights,
                      bucket_size=bucket_size, wire=wire, uniforms=uniforms)
    return vec_to_tree(vec, flat_spec(stacked, stacked=True))


def sparse_weighted_mean(stacked: Tree, weights: torch.Tensor,
                         plan: SparsePlan, *,
                         bucket_size: int = DEFAULT_BUCKET_SIZE,
                         wire: str = "f32",
                         uniforms: Optional[torch.Tensor] = None,
                         hier_inner: int = 0) -> Tree:
    """Mask-aware sparse weighted mean under one global mask (SalientGrads):
    reduce only the plan's live coordinates of the honored-mask locals, then
    rebuild the dense layout; bit-equal to the dense aggregate. (The
    reference's per-client-mask form, ``masks=``, and its dense twin
    ``masked_weighted_mean`` have no caller in either package's algorithms,
    and are not ported.)"""
    wire = _off_mesh_wire(wire, hier_inner)
    _check_wire(wire, uniforms)
    _plan_check(stacked, plan)
    vec = _reduce_mat(_compress(stacked, plan), weights,
                      bucket_size=bucket_size, wire=wire, uniforms=uniforms)
    return _expand_vec(vec, stacked, plan)
