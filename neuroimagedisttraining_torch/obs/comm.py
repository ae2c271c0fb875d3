"""Communication observability: the analytical wire-cost model and the
aggregation probe (counterpart of ``neuroimagedisttraining_tpu/obs/comm.py``).

:class:`WireCostModel` prices the aggregation wire *analytically*, per
``agg_impl`` and per top-level leaf group, so every round's JSONL line
carries the modeled bytes-on-the-wire (``comm_*``) and the what-if table
projects every alternative wire at the live mask density. What is modeled
is the per-device transmitted collective payload of ONE central
aggregation, the JAX package's model byte for byte:

* **dense / bucketed** — 4 bytes/param (f32);
* **bf16** — 2 bytes/param;
* **int8** — 1 byte/param on each leaf's padded bucket-row layout plus one
  f32 scale per (leaf, bucket-row);
* **sparse** — 4 bytes per LIVE coordinate of the static mask's gather
  plan (:class:`~..parallel.collectives.SparsePlan`), non-kernel leaves
  dense;
* **topk** — 8 bytes per SELECTED coordinate (f32 value + int32 index,
  ``collectives.topk_count`` of each leaf's live set);
* **hier** — the cross-slice hop at ``hier_wire``'s precision.

The model is static per run, so ``ObsSession`` joins the same values onto
every JSONL line.

:func:`probe_aggregate` adds the measured side: one aggregation of a
shape-matched synthetic cohort through the algorithm's own ``_aggregate``
path (its ``agg_impl``, bucket size and sparse plan), timed by
``collectives.time_weighted_agg`` (CUDA events on the card, the same
harness as ``agg_microbench``), plus the FLOPs and bytes of a weighted sum
counted from the shapes (``obs.compile.agg_cost_analysis``). The cohort
comes from a local generator, so no run state or run RNG is touched (the
bit-inert obs contract). On a client mesh the probe times the aggregate as
one process computes it (every rank alone, no collective).

:func:`message_payload_nbytes` and :func:`topk_payload` are the payload
helpers: the raw bytes a tree (dense, or under a mask: values plus a
packed bitmap) and one client's top-k update carry.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "COMM_PREFIX", "WireCostModel", "message_payload_nbytes",
    "probe_aggregate", "topk_payload",
]

#: every wire-model metric key starts with this (a record carrying any
#: ``comm_*`` key is obs-schema v3)
COMM_PREFIX = "comm_"


def _flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A name -> array tree (nested dicts joined by dots) as one flat
    dict."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _leaves(tree: Any):
    """``(keys, numpy leaves)`` of a name -> array tree (nested or not) in
    the reference's leaf order."""
    from ..convert import reference_leaf_order

    flat = _flat(tree)
    keys = reference_leaf_order(flat)
    return keys, [np.asarray(_host(flat[k])) for k in keys]


def _host(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return v


def message_payload_nbytes(tree: Any, mask: Any = None) -> int:
    """The raw payload bytes of a tree: dense leaf -> ``size *
    itemsize``; under ``mask`` each leaf's ``nnz * itemsize`` values plus
    its ``ceil(size / 8)``-byte packed bitmap."""
    _, leaves = _leaves(tree)
    if mask is None:
        return sum(a.size * a.dtype.itemsize for a in leaves)
    mkeys, mask_leaves = _leaves(mask)
    if len(mask_leaves) != len(leaves):
        raise ValueError(
            f"mask has {len(mask_leaves)} leaves, tree has {len(leaves)}")
    total = 0
    for arr, m in zip(leaves, mask_leaves):
        nnz = int(np.count_nonzero(m))
        total += nnz * arr.dtype.itemsize + (arr.size + 7) // 8
    return total


def topk_payload(tree: Any, k_frac: float, mask: Any = None) -> Any:
    """One client's error-feedback top-k update as it ships: per leaf the
    ``collectives.topk_count`` largest-|value| coordinates of the
    (optionally mask-restricted) flat leaf, an int32 ``idx`` array and a
    values array in the leaf's dtype. ``message_payload_nbytes`` of it is
    ``sum_i topk_count(live_i, k_frac) * (4 + itemsize)``, the model's
    topk bytes for f32 leaves. Host-side (numpy argpartition); ties at the
    k-th magnitude resolve by flat index."""
    from ..parallel.collectives import topk_count

    keys, leaves = _leaves(tree)
    mask_leaves = (_leaves(mask)[1] if mask is not None
                   else [None] * len(leaves))
    if len(mask_leaves) != len(leaves):
        raise ValueError(
            f"mask has {len(mask_leaves)} leaves, tree has {len(leaves)}")
    out = {}
    for key, leaf, m in zip(keys, leaves, mask_leaves):
        flat = leaf.reshape(-1)
        live = np.arange(flat.size)
        if m is not None:
            live = np.flatnonzero(m.reshape(-1))
        k = topk_count(max(int(live.size), 1), k_frac)
        vals = flat[live] if live.size else np.zeros(1, flat.dtype)
        cand = live if live.size else np.zeros(1, np.int64)
        order = np.argpartition(-np.abs(vals), min(k, vals.size) - 1)
        sel = np.sort(cand[order[:k]]).astype(np.int32)
        out[key] = {"idx": sel, "val": flat[sel].astype(flat.dtype)
                    if live.size else vals[:k]}
    return out


#: per-param wire bytes of the non-bucket-dependent impls (int8 and
#: sparse are computed per leaf — see :meth:`WireCostModel.leaf_bytes`)
WIRE_BYTES_PER_PARAM = {"dense": 4.0, "bucketed": 4.0, "bf16": 2.0}

#: one f32 max-abs scale per (leaf, bucket-row) on the int8 wire
INT8_SCALE_BYTES = 4.0


class WireCostModel:
    """Static bytes-on-the-wire model for every ``agg_impl``.

    Built host-side once per run from the parameter shapes (no device
    compute); emits the ``comm_*`` round-metric
    dict :meth:`round_metrics` that ``ObsSession`` joins onto every
    JSONL line and the analyzer's what-if table reads back.
    """

    def __init__(self, leaf_sizes: Tuple[int, ...],
                 leaf_live: Tuple[Optional[int], ...],
                 group_names: Tuple[str, ...],
                 leaf_group_index: Tuple[int, ...], *,
                 agg_impl: str = "dense", bucket_size: int = 0,
                 n_devices: int = 1,
                 density: Optional[float] = None,
                 topk_density: float = 0.1,
                 hier_wire: str = "bf16"):
        from ..parallel.collectives import (
            AGG_IMPLS,
            DEFAULT_BUCKET_SIZE,
            HIER_WIRES,
        )

        if agg_impl not in AGG_IMPLS:
            raise ValueError(f"agg_impl {agg_impl!r} not in {AGG_IMPLS}")
        if hier_wire not in HIER_WIRES:
            raise ValueError(
                f"hier_wire {hier_wire!r} not in {HIER_WIRES}")
        if not 0.0 < topk_density <= 1.0:
            raise ValueError(
                f"topk_density {topk_density} not in (0, 1]")
        if not (len(leaf_sizes) == len(leaf_live)
                == len(leaf_group_index)):
            raise ValueError(
                "leaf_sizes / leaf_live / leaf_group_index lengths differ "
                f"({len(leaf_sizes)}/{len(leaf_live)}/"
                f"{len(leaf_group_index)})")
        self.leaf_sizes = tuple(int(s) for s in leaf_sizes)
        self.leaf_live = tuple(leaf_live)
        self.group_names = tuple(group_names)
        self.leaf_group_index = tuple(leaf_group_index)
        self.agg_impl = agg_impl
        self.bucket_size = int(bucket_size) or DEFAULT_BUCKET_SIZE
        self.n_devices = max(1, int(n_devices))
        self.n_params = sum(self.leaf_sizes)
        #: None = no mask/plan known — the sparse what-if is omitted
        self.density = density
        #: topk's configured shipped fraction (defaulted so the what-if
        #: table can project topk even on runs using another impl)
        self.topk_density = float(topk_density)
        #: hier's cross-slice wire precision (the priced hop)
        self.hier_wire = hier_wire
        self._impls = AGG_IMPLS

    # -- construction ----------------------------------------------------
    @classmethod
    def from_params(cls, params_template: Any, *, agg_impl: str = "dense",
                    bucket_size: int = 0, n_devices: int = 1,
                    plan=None, topk_density: float = 0.1,
                    hier_wire: str = "bf16") -> "WireCostModel":
        """Model from a parameter tree: name -> tensor, or name -> shape.
        ``plan`` is the live-coordinate
        :class:`~..parallel.collectives.SparsePlan` (None = no mask:
        sparse bytes are not projected)."""
        from .numerics import layer_groups

        names, keys, index = layer_groups(params_template)

        def size(v):
            shape = tuple(getattr(v, "shape", v))
            return int(np.prod(shape)) if shape else 1

        sizes = tuple(size(params_template[k]) for k in keys)
        live: Tuple[Optional[int], ...] = (None,) * len(keys)
        density = None
        if plan is not None:
            if len(plan.idx) != len(keys):
                raise ValueError(
                    f"sparse plan has {len(plan.idx)} leaves, params "
                    f"template has {len(keys)} — built for a different "
                    "tree")
            live = tuple(None if ix is None else int(ix.numel())
                         for ix in plan.idx)
            density = float(plan.density)
        return cls(sizes, live, names, index, agg_impl=agg_impl,
                   bucket_size=bucket_size, n_devices=n_devices,
                   density=density, topk_density=topk_density,
                   hier_wire=hier_wire)

    @classmethod
    def from_algorithm(cls, algo, state: Any = None
                       ) -> "WireCostModel":
        """Model for one built algorithm: the model's parameter shapes,
        the live mask density from the algorithm's sparse plan (or, when
        ``state`` carries a ``mask`` tree, a plan built from it — the LIVE
        density, not an assumed one), the device count from its client
        mesh."""
        from ..parallel.collectives import build_sparse_plan

        template = _template(algo)
        _ensure_agg_plan(algo, state)
        plan = getattr(algo, "_agg_sparse_plan", None)
        if plan is None and state is not None:
            mask = getattr(state, "mask", None)
            if mask is not None:
                plan = build_sparse_plan(mask)
        mesh = getattr(algo, "mesh", None)
        return cls.from_params(
            template, agg_impl=algo.agg_impl,
            bucket_size=algo.agg_bucket_size,
            n_devices=mesh.size if mesh is not None else 1, plan=plan,
            topk_density=getattr(algo, "agg_topk_density", 0.1),
            hier_wire=getattr(algo, "agg_hier_wire", "bf16"))

    # -- the model -------------------------------------------------------
    def _int8_bytes(self, n: int) -> float:
        # collectives._wire_reduce_groups int8 layout: the leaf is
        # padded to nb rows of b elements, one f32 scale per row
        b = min(self.bucket_size, max(n, 1))
        nb = -(-n // b) if n else 0
        return float(nb * b) + INT8_SCALE_BYTES * nb

    def leaf_bytes(self, i: int, impl: str) -> float:
        """Modeled wire bytes of leaf ``i`` under ``impl``."""
        n = self.leaf_sizes[i]
        live = self.leaf_live[i]
        if impl == "sparse":
            return 4.0 * (n if live is None else live)
        if impl == "topk":
            # the shipped payload: topk_count of the LIVE set, 4 B f32
            # value + 4 B int32 index each (residual-free — the
            # remainder stays in state, never on the wire). The same
            # topk_count rule builds topk_payload, so this prediction
            # is EXACT against Message serialization.
            from ..parallel.collectives import topk_count

            return 8.0 * topk_count(n if live is None else live,
                                    self.topk_density)
        if impl == "hier":
            # cross-slice hop only (intra-slice psum is the fast
            # domain), at the configured wire precision
            wire = self.hier_wire
            if wire == "sparse":
                return 4.0 * (n if live is None else live)
            if wire == "int8":
                return self._int8_bytes(n)
            return {"f32": 4.0, "bf16": 2.0}[wire] * n
        if impl == "int8":
            return self._int8_bytes(n)
        return WIRE_BYTES_PER_PARAM[impl] * n

    def bytes_for(self, impl: str) -> float:
        """Total modeled per-device wire bytes of one aggregation."""
        if impl not in self._impls:
            raise ValueError(f"impl {impl!r} not in {self._impls}")
        return sum(self.leaf_bytes(i, impl)
                   for i in range(len(self.leaf_sizes)))

    def group_bytes(self, impl: Optional[str] = None) -> Dict[str, float]:
        """Modeled wire bytes per TOP-LEVEL leaf group (the params
        tree's top-level modules — the same grouping obs/numerics.py
        gauges use, so byte and norm attribution line up)."""
        impl = impl or self.agg_impl
        out = {g: 0.0 for g in self.group_names}
        for i, gi in enumerate(self.leaf_group_index):
            out[self.group_names[gi]] += self.leaf_bytes(i, impl)
        return out

    def what_if(self) -> Dict[str, float]:
        """Every ``agg_impl``'s modeled bytes at the current density —
        the mask-dependent wires (sparse; hier's sparse cross-slice
        wire) only when a mask/plan is known. topk projects always (its
        density is a config knob, defaulted when unconfigured)."""
        def known(impl):
            if impl == "sparse" or (impl == "hier"
                                    and self.hier_wire == "sparse"):
                return self.density is not None
            return True

        return {impl: self.bytes_for(impl) for impl in self._impls
                if known(impl)}

    def round_metrics(self) -> Dict[str, float]:
        """The per-round ``comm_*`` metric dict (all floats — static
        per run, joined onto every JSONL line by ``ObsSession``)."""
        m: Dict[str, float] = {
            "comm_bytes_wire": self.bytes_for(self.agg_impl),
            "comm_density": (1.0 if self.density is None
                             else self.density),
            "comm_n_params": float(self.n_params),
            "comm_n_devices": float(self.n_devices),
        }
        for impl, b in self.what_if().items():
            m[f"comm_bytes_{impl}"] = b
        for g, b in self.group_bytes().items():
            m[f"comm_bytes_group/{g}"] = b
        return m


def _template(algo) -> Dict[str, Any]:
    """The model's parameter shapes by name."""
    return {k: tuple(v.shape) for k, v in algo.model.named_parameters()}


def _ensure_agg_plan(algo, state: Any) -> None:
    """SalientGrads builds its sparse gather plan at its first round; the
    wire model and probe run BEFORE any round, so trigger the same
    host-side build here (idempotent, a no-op off the sparse path or
    without a state)."""
    ensure = getattr(algo, "_ensure_agg_plan", None)
    if ensure is not None and state is not None:
        ensure(state)


def _synthetic_cohort(algo):
    """``(stacked, weights, uniforms)``: a shape-matched synthetic cohort
    of ``clients_per_round`` models on the algorithm's device, drawn from a
    local generator (no run state or run RNG touched), equal weights, and
    the int8 wire's uniforms where it draws them."""
    import torch

    dev = algo.device
    s = algo.clients_per_round
    g = torch.Generator(device=dev).manual_seed(0)
    stacked = {k: torch.randn((s,) + shape, generator=g, device=dev) * 0.01
               for k, shape in _template(algo).items()}
    weights = torch.full((s,), 1.0 / s, dtype=torch.float32, device=dev)
    uniforms = None
    if algo._needs_uniforms():
        uniforms = torch.rand(
            algo._uniforms_shape({k: v[0] for k, v in stacked.items()}),
            generator=g, device=dev)
    return stacked, weights, uniforms


def probe_aggregate(algo, state: Any = None, iters: int = 4,
                    timing: bool = True, cost: bool = True,
                    registry=None) -> Dict[str, Any]:
    """Probe ONE central aggregation through the algorithm's own
    ``_aggregate`` (impl, bucket size, sparse plan), on a shape-matched
    synthetic cohort built once and shared by both measurements:

    * ``agg_ms`` (``timing``) — ms per aggregation by
      ``collectives.time_weighted_agg`` (CUDA events on the card), the
      harness ``agg_microbench`` times with;
    * ``flops`` / ``bytes_accessed`` / ``compile_s`` (``cost``) — the
      weighted sum's counts from the shapes
      (``obs.compile.agg_cost_analysis``), the no-trace side of the
      devtrace fallback.

    Pure readout: a local generator makes the cohort, no run state or run
    RNG is touched, so the training trajectory stays bit-identical."""
    _ensure_agg_plan(algo, state)
    stacked, weights, uniforms = _synthetic_cohort(algo)
    out: Dict[str, Any] = {}
    if timing:
        from ..parallel.collectives import time_weighted_agg

        def agg_fn(st, wv, i):
            return algo._aggregate(st, wv, uniforms)

        out["agg_ms"] = time_weighted_agg(agg_fn, stacked, weights,
                                          iters) * 1e3
    if cost:
        from .compile import agg_cost_analysis

        out.update(agg_cost_analysis(stacked, weights, registry=registry,
                                     entry="aggregate"))
    return out

