"""Cost accounting: FLOPs and communication-parameter counters (counterpart
of ``neuroimagedisttraining_tpu/utils/flops.py``, its analytic half).

Per-layer dense FLOPs come from the shapes a forward pass of one sample
gives each parametric layer (forward hooks), for convolutions of any rank
and dense layers alike; the sparsity scaling honors each layer's nonzero
fraction. Training FLOPs are 3x inference (forward + backward), and the
communication count is the number of nonzero values shipped. A tree here is
the model's ``state_dict`` naming; a layer is keyed by its module name (the
parameter name without ``.kernel``).

The reference's ``xla_cost_analysis`` / ``inference_flops_xla`` read XLA's
cost model and have no counterpart here (ROADMAP item 14).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

TRAIN_TO_INFER_RATIO = 3.0  # fwd + bwd ~= 3x fwd (reference convention)

Tree = Dict[str, torch.Tensor]


def _layer(name: str) -> Optional[str]:
    """The layer of a kernel leaf ``<layer>.kernel``, else None."""
    layer, _, leaf = name.rpartition(".")
    return layer if leaf == "kernel" else None


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def per_layer_flops(model: torch.nn.Module, params: Tree,
                    sample_shape: Tuple[int, ...]) -> Dict[str, float]:
    """Per-sample dense FLOPs of every parametric layer (conv of any rank,
    dense), keyed by layer name, from one forward pass of a zero sample run
    on ``params``. A phased stem (``S2DStemConv``, and the fused
    ``S2DStemStage`` whose output is pooled) is counted at its conv
    output's extent, the VALID stride-1 conv over the phased input."""
    from ..models.layers import PhasedStemKernel

    layers = {_layer(k) for k in params} - {None}
    mods = dict(model.named_modules())
    shapes: Dict[str, Tuple[int, ...]] = {}
    handles = []
    for name in layers:
        mod = mods[name]
        if isinstance(mod, PhasedStemKernel):
            def hook(m, inp, out, name=name):
                _, d, h, _, w = inp[0].shape
                r = m.kernel.shape[-1]
                shapes[name] = (d - r + 1, h - r + 1, w - r + 1)
        else:
            def hook(m, inp, out, name=name):
                shapes[name] = tuple(out.shape[2:])  # NC... -> spatial
        handles.append(mod.register_forward_hook(hook))
    try:
        x = torch.zeros((1,) + tuple(sample_shape), dtype=torch.float32,
                        device=next(iter(params.values())).device)
        with torch.no_grad():
            torch.func.functional_call(model, params, (x,),
                                       {"train": False, "rng": None})
    finally:
        for h in handles:
            h.remove()
    out: Dict[str, float] = {}
    for k, leaf in params.items():
        name = _layer(k)
        if name is None:
            continue
        kshape = tuple(leaf.shape)
        yshape = shapes.get(name)
        if len(kshape) >= 3:  # conv kernel: (Cout, Cin/groups, *window)
            if yshape is None:
                continue
            out[name] = 2.0 * _prod(yshape) * float(_prod(kshape))
        elif len(kshape) == 2:  # dense: (out, in)
            mult = float(_prod(yshape)) if yshape else 1.0
            out[name] = 2.0 * mult * float(_prod(kshape))
    return out


def _masked(params: Tree, mask: Optional[Tree], k: str) -> torch.Tensor:
    w = params[k]
    if mask is not None and k in mask:
        w = w * mask[k]
    return w


def nonzero_fraction(params: Tree, mask: Optional[Tree] = None
                     ) -> Dict[str, float]:
    """Per-layer nonzero fraction of kernels (after masking)."""
    fracs: Dict[str, float] = {}
    for k in params:
        name = _layer(k)
        if name is None:
            continue
        w = _masked(params, mask, k)
        fracs[name] = float(torch.count_nonzero(w)) / (w.numel() or 1)
    return fracs


def _scaled_flops(dense: Dict[str, float], fracs: Dict[str, float]) -> float:
    """Sparsity-scaled total of per-layer dense FLOPs (a layer without a
    recorded fraction counts dense)."""
    return float(sum(f * fracs.get(p, 1.0) for p, f in dense.items()))


def inference_flops(model, params: Tree, sample_shape: Tuple[int, ...],
                    mask: Optional[Tree] = None) -> float:
    """Per-sample analytical inference FLOPs, honoring weight sparsity."""
    dense = per_layer_flops(model, params, sample_shape)
    return _scaled_flops(dense, nonzero_fraction(params, mask))


def training_flops(model, params: Tree, sample_shape, mask=None,
                   n_samples: int = 1) -> float:
    return TRAIN_TO_INFER_RATIO * n_samples * inference_flops(
        model, params, sample_shape, mask)


def avg_inference_flops(model, state, sample_shape: Tuple[int, ...],
                        num_clients: int, cost_snapshot_fn) -> float:
    """The cohort-mean per-sample inference FLOPs of the final model(s)
    (the original's ``record_avg_inference_flops``): with one global mask
    (or none), :func:`inference_flops` of the representative model; with
    per-client masks (DisPFL, SubAvg) the mask-aware count averaged over
    every client, each under its own mask, on its personal model (DisPFL)
    or the global one (SubAvg), the dense per-layer FLOPs computed once."""
    masks = getattr(state, "masks", None)
    if masks is None:
        params, mask = cost_snapshot_fn(state)
        if params is None:
            return 0.0
        return inference_flops(model, params, sample_shape, mask=mask)
    stacked = getattr(state, "personal_params", None)
    glob = getattr(state, "global_params", None)

    def params_of(c):
        return glob if stacked is None else {k: v[c] for k, v in
                                             stacked.items()}

    dense = per_layer_flops(model, params_of(0), sample_shape)
    total = 0.0
    for c in range(num_clients):
        total += _scaled_flops(dense, nonzero_fraction(
            params_of(c), {k: v[c] for k, v in masks.items()}))
    return total / max(1, num_clients)


def count_params(params: Tree) -> int:
    return int(sum(v.numel() for v in params.values()))


def count_communication_params(params: Tree,
                               mask: Optional[Tree] = None) -> int:
    """Nonzero values actually shipped."""
    return int(sum(int(torch.count_nonzero(_masked(params, mask, k)))
                   for k in params))


class CostTracker:
    """Cumulative FLOPs/comm counters: ``stat_info``'s
    ``sum_training_flops`` / ``sum_comm_params``."""

    def __init__(self, model=None,
                 sample_shape: Optional[Tuple[int, ...]] = None):
        self.model = model
        self.sample_shape = sample_shape
        self.sum_training_flops = 0.0
        self.sum_comm_params = 0
        self.per_round: list = []
        self._dense_flops = None  # per-layer cache: shapes are static

    def _dense_per_layer(self, params) -> Dict[str, float]:
        if self._dense_flops is None:
            self._dense_flops = per_layer_flops(
                self.model, params, self.sample_shape)
        return self._dense_flops

    def record_round(self, params: Tree, mask: Optional[Tree] = None,
                     n_clients: int = 1,
                     samples_per_client: int = 1) -> Dict[str, float]:
        flops = 0.0
        if self.model is not None and self.sample_shape is not None:
            dense = self._dense_per_layer(params)
            per_sample = _scaled_flops(dense, nonzero_fraction(params, mask))
            flops = (n_clients * TRAIN_TO_INFER_RATIO * samples_per_client
                     * per_sample)
        comm = n_clients * count_communication_params(params, mask)
        self.sum_training_flops += flops
        self.sum_comm_params += comm
        rec = {"training_flops": flops, "comm_params": comm,
               "sum_training_flops": self.sum_training_flops,
               "sum_comm_params": self.sum_comm_params}
        self.per_round.append(rec)
        return rec

    def snapshot_totals(self) -> Dict[str, float]:
        """The totals as the checkpoint's metadata sidecar holds them."""
        last = self.per_round[-1] if self.per_round else None
        return {
            "sum_training_flops": self.sum_training_flops,
            "sum_comm_params": self.sum_comm_params,
            "last_training_flops": last["training_flops"] if last else 0.0,
            "last_comm_params": last["comm_params"] if last else 0,
        }

    def restore_totals(self, meta: Dict[str, float]) -> None:
        """The counters seeded from a checkpoint's sidecar: exact for the
        evolving-mask algorithms too, whose earlier rounds had other
        densities than the restored state's."""
        self.sum_training_flops = float(meta["sum_training_flops"])
        self.sum_comm_params = int(meta["sum_comm_params"])
        self.per_round = [{
            "training_flops": float(meta["last_training_flops"]),
            "comm_params": int(meta["last_comm_params"]),
            "sum_training_flops": self.sum_training_flops,
            "sum_comm_params": self.sum_comm_params,
        }]

    def record_repeat(self) -> Dict[str, float]:
        """Accumulate another round identical to the last recorded one (no
        device-to-host pull when the masks are static)."""
        last = self.per_round[-1]
        self.sum_training_flops += last["training_flops"]
        self.sum_comm_params += last["comm_params"]
        rec = {"training_flops": last["training_flops"],
               "comm_params": last["comm_params"],
               "sum_training_flops": self.sum_training_flops,
               "sum_comm_params": self.sum_comm_params}
        self.per_round.append(rec)
        return rec
