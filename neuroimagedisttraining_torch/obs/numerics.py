"""Training-dynamics telemetry computed inside the round: what happens
numerically in the federated round (counterpart of
``neuroimagedisttraining_tpu/obs/numerics.py``).

The guard quarantines a non-finite client and the watchdog rolls back a
diverged aggregate without either being able to say which layer, which
client, or how many rounds of warning there were. This module computes
that evidence on the round's own tensors on the device, as extra float32
scalars among the round's metrics — so a fused block carries them in its
packed metric stack, inside the captured graph, and they reach the host
at the records' flush like every other per-round metric (no ``.item()``,
no sync).

Per round, a :class:`NumericsPlan` emits:

* ``num_update_norm`` — L2 norm of the realized global update
  ``new_global − old_global``;
* ``num_upd/<group>`` — the same norm restricted to each layer group (the
  top-level module of a parameter name, ``Conv3d_0`` of
  ``Conv3d_0.kernel``: the JAX package's top-level flax scope);
* ``num_gnorm/<group>`` — cohort-mean per-group local-update norm;
* ``num_maxabs/<group>`` — max |value| over the stacked client models as
  they arrived at the server (post-fault, pre-guard);
* ``num_drift_s<j>`` / ``num_cos_s<j>`` — per-cohort-slot client drift
  ``‖local_j − global‖`` and cosine to the realized global update;
* with ``with_mask`` (SalientGrads): ``num_mask_churn`` — the global
  model's nonzero-pattern churn, ``ops.sparsity.mask_distance(new_global,
  old_global)`` — and ``num_mask_agree`` / ``num_mask_dist_max`` —
  ``1 − mean_j mask_distance(local_j, mask)`` and its worst client.

On a client mesh a rank holds only its clients' rows: the per-row terms
(per-group drift², per-group max |value|, the dot with the update, the
mask distance) are gathered into draw order in one ``all_gather``
(:meth:`NumericsPlan.compute`'s ``gather``), and every rank folds the
same ``[S, ...]`` matrix.

Everything is a pure readout: no RNG, no effect on the state — with
``obs_numerics`` off the round is bit-identical, and the flag never
enters run or checkpoint identity.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["DRIFT_KEY_PREFIX", "NUMERICS_PREFIX", "NumericsPlan",
           "drift_slots", "group_of_name", "layer_groups"]

#: every numerics metric name starts with this
NUMERICS_PREFIX = "num_"

#: per-cohort-slot drift keys: ``num_drift_s<j>``
DRIFT_KEY_PREFIX = "num_drift_s"

#: denominator floor for the cosine — only reached when the global
#: update (or a client's drift) is exactly zero, where cosine 0 is the
#: honest answer
_COS_EPS = 1e-30


def drift_slots(record) -> Dict[int, float]:
    """``{slot: drift}`` from one (materialized) round record — the one
    parser of the per-slot drift key format."""
    out = {}
    for k, v in record.items():
        if k.startswith(DRIFT_KEY_PREFIX) and isinstance(
                v, (int, float)):
            try:
                out[int(k[len(DRIFT_KEY_PREFIX):])] = float(v)
            except ValueError:
                continue
    return out


def group_of_name(name: str) -> str:
    """Layer-group label of one parameter name: its top-level module
    (``Conv3d_0`` of ``Conv3d_0.kernel``, ``_Features_0`` of
    ``_Features_0.Conv3d_1.kernel``)."""
    return name.split(".", 1)[0]


def layer_groups(params: Dict[str, torch.Tensor]
                 ) -> Tuple[Tuple[str, ...], Tuple[str, ...],
                            Tuple[int, ...]]:
    """``(group_names, keys, leaf_to_group)``: sorted group labels, the
    parameter names in the reference's leaf order, and each name's group
    index."""
    from ..convert import reference_leaf_order

    keys = tuple(reference_leaf_order(params))
    labels = [group_of_name(k) for k in keys]
    names = tuple(sorted(set(labels)))
    index = {g: i for i, g in enumerate(names)}
    return names, keys, tuple(index[lb] for lb in labels)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


class NumericsPlan:
    """The static layout of one algorithm's in-round numerics telemetry.

    Built host-side once from the model's parameter names, it fixes the
    metric NAMES (joined onto ``_round_metric_names``, so the fused packed
    metric stack sees ordinary float32 scalars) and provides
    :meth:`compute`, which the round body calls on its live tensors.
    """

    def __init__(self, group_names: Sequence[str], keys: Sequence[str],
                 leaf_groups: Sequence[int], slots: int,
                 with_mask: bool = False):
        if slots < 1:
            raise ValueError(f"numerics plan needs >=1 cohort slot, "
                             f"got {slots}")
        if not group_names:
            raise ValueError("numerics plan: empty params template")
        self.group_names = tuple(group_names)
        self.keys = tuple(keys)
        self.leaf_groups = tuple(leaf_groups)
        self.slots = int(slots)
        self.with_mask = bool(with_mask)
        names: List[str] = ["num_update_norm"]
        names += [f"num_upd/{g}" for g in self.group_names]
        names += [f"num_gnorm/{g}" for g in self.group_names]
        names += [f"num_maxabs/{g}" for g in self.group_names]
        names += [f"num_drift_s{j}" for j in range(self.slots)]
        names += [f"num_cos_s{j}" for j in range(self.slots)]
        if self.with_mask:
            names += ["num_mask_churn", "num_mask_agree",
                      "num_mask_dist_max"]
        self.metric_names: Tuple[str, ...] = tuple(names)

    @classmethod
    def from_params(cls, params_template: Dict[str, torch.Tensor],
                    slots: int, with_mask: bool = False) -> "NumericsPlan":
        names, keys, leaf_groups = layer_groups(params_template)
        return cls(names, keys, leaf_groups, slots, with_mask=with_mask)

    def compute(self, old_global: Dict[str, torch.Tensor],
                new_global: Dict[str, torch.Tensor],
                locals_: Dict[str, torch.Tensor],
                mask: Optional[Dict[str, torch.Tensor]] = None,
                gather: Optional[Callable[[torch.Tensor],
                                          torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """The numerics scalars for one round, by ``metric_names``, each a
        0-d float32 tensor on the round's device. ``locals_`` is the
        ``[n, ...]``-stacked client models as they ARRIVED at the server
        (post-fault, pre-guard — poison must show): all ``S`` of them, or
        on a client mesh this rank's ``n``, which ``gather`` (rows ``[n,
        m]`` -> ``[S, m]`` in draw order) completes. Reductions only, on
        tensors the round already holds; nothing leaves the device."""
        if set(locals_) != set(self.keys) or set(old_global) != set(
                self.keys) or set(new_global) != set(self.keys):
            raise ValueError(
                f"numerics plan built for {len(self.keys)} leaves but got "
                f"{len(old_global)}/{len(new_global)}/{len(locals_)} — "
                "rebuild the plan from the live params template")
        g = len(self.group_names)
        first = locals_[self.keys[0]]
        n, dev = int(first.shape[0]), first.device
        upd_sq = [torch.zeros((), dtype=torch.float32, device=dev)
                  for _ in range(g)]
        drift_sq = [torch.zeros(n, dtype=torch.float32, device=dev)
                    for _ in range(g)]
        maxabs = [torch.zeros(n, dtype=torch.float32, device=dev)
                  for _ in range(g)]
        dot = torch.zeros(n, dtype=torch.float32, device=dev)
        for k, gi in zip(self.keys, self.leaf_groups):
            o32 = old_global[k].to(torch.float32)
            u = new_global[k].to(torch.float32) - o32
            s = _rows(locals_[k].to(torch.float32))
            d = s - o32.reshape(1, -1)
            upd_sq[gi] = upd_sq[gi] + torch.sum(u * u)
            drift_sq[gi] = drift_sq[gi] + torch.sum(d * d, dim=1)
            dot = dot + torch.sum(d * u.reshape(1, -1), dim=1)
            maxabs[gi] = torch.maximum(maxabs[gi],
                                       torch.amax(torch.abs(s), dim=1))
        cols = drift_sq + maxabs + [dot]
        if self.with_mask:
            if mask is None:
                raise ValueError(
                    "numerics plan built with_mask=True needs the round's "
                    "mask")
            from ..ops.sparsity import mask_distance

            cols.append(mask_distance(locals_, mask, lead=1))
        rows = torch.stack(cols, dim=1)
        if gather is not None:
            rows = gather(rows)
        if int(rows.shape[0]) != self.slots:
            raise ValueError(
                f"numerics plan built for {self.slots} cohort slots but "
                f"the round has {int(rows.shape[0])}")
        drift_all, max_all, dot_all = rows[:, :g], rows[:, g:2 * g], \
            rows[:, 2 * g]
        upd_norm = torch.sqrt(torch.stack(upd_sq).sum())
        drift = torch.sqrt(drift_all.sum(dim=1))    # [S] total client drift
        cos = dot_all / torch.clamp(drift * upd_norm, min=_COS_EPS)
        out: List[torch.Tensor] = [upd_norm]
        out += [torch.sqrt(sq) for sq in upd_sq]
        out += list(torch.sqrt(drift_all).mean(dim=0).unbind(0))
        out += list(torch.amax(max_all, dim=0).unbind(0))
        out += list(drift.unbind(0))
        out += list(cos.unbind(0))
        if self.with_mask:
            from ..ops.sparsity import mask_distance

            dists = rows[:, 2 * g + 1]
            out += [mask_distance(new_global, old_global),
                    1.0 - dists.mean(), dists.max()]
        return {name: v.to(torch.float32).reshape(())
                for name, v in zip(self.metric_names, out)}
