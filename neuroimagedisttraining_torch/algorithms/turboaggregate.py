"""TurboAggregate: secure aggregation over additive secret shares
(counterpart of ``neuroimagedisttraining_tpu/algorithms/turboaggregate.py``).

Each round the sampled clients train a copy of the global model as FedAvg's
clients do (the masked SGD kernel over an all-ones mask). Each client's
sample-weighted model is then fixed-point quantized into F_p, split into
additive secret shares (one per simulated aggregation group), the shares
are summed share-wise (no party sees a plaintext model), and the
reconstructed field sum is dequantized into the new global model.

The secret-sharing transport is host numpy int64 field arithmetic
(``ops/mpc.py``), as in the reference: the locals come to the host once, as
one ``[S, N]`` matrix in the reference's flat layout, and the sum goes back
to the card as float32. So a round waits on the card, and TurboAggregate
has no fused loop.

On a client mesh each rank trains the sampled clients it holds, the trained
rows are gathered in draw order, and every rank runs the secure sum over
the gathered ``[S, N]`` matrix: its shares come from one generator, client
after client, so the sum cannot be split by rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.state import Tree
from ..core.trainer import make_client_update
from ..ops import mpc
from ..parallel import collectives
from .base import FedAlgorithm, RoundInputs, _to_device


@dataclasses.dataclass
class TurboAggregateState:
    global_params: Tree
    #: the round loop's draws (epoch permutations, dropout masks)
    generator: torch.Generator


class TurboAggregate(FedAlgorithm):
    name = "turboaggregate"
    mesh_supported = True

    def __init__(self, *args, n_groups: int = 3, quant_scale: int = 2 ** 16,
                 prime: int = mpc.DEFAULT_PRIME, **kwargs):
        for opt in ("fault_spec", "robust_agg", "guard"):
            if kwargs.get(opt) not in (None, "", "none", False):
                raise ValueError(
                    f"{opt}: turboaggregate's aggregate is the secure sum "
                    "of shares, which the guard, the faults and the robust "
                    "statistics do not reach")
        if kwargs.get("agg_impl", "dense") != "dense":
            raise ValueError(
                f"agg_impl {kwargs['agg_impl']!r}: turboaggregate "
                "aggregates through its secure sum alone")
        self.n_groups = n_groups
        self.quant_scale = quant_scale
        self.prime = prime
        super().__init__(*args, **kwargs)

    def _build(self) -> None:
        self.client_update = make_client_update(
            self.apply_fn, self.loss_type, self.hp,
            full_batches=self._full_batches(), remat=self.remat_local)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> TurboAggregateState:
        """Fresh parameters (or the given ``params``) as the global model.
        ``generator`` defaults to one seeded by the run seed and drives
        init and every later round."""
        g = generator if generator is not None else self.generator()
        return TurboAggregateState(global_params=self._fresh_params(g, params),
                                   generator=g)

    def _prepare_round(self, state: TurboAggregateState) -> None:
        self._ones_mask(state.global_params)

    def _secure_weighted_sum(self, stacked: Tree,
                             weights: np.ndarray) -> Tree:
        """The sum of the pre-weighted local models through additive secret
        shares, as the reference spells it: per leaf in the reference's
        leaf order, each client's float64 weighted model quantized
        (rounding half to even), shared into ``n_groups`` shares drawn from
        one ``np.random.RandomState(0)`` per call (per client, per leaf),
        the shares summed share-wise mod p, the groups' totals summed and
        dequantized; float32 on the card."""
        p, scale = self.prime, self.quant_scale
        spec = collectives.flat_spec(stacked, stacked=True)
        mat = collectives.stacked_to_mat(stacked).cpu().numpy()
        out = np.empty(spec.total, np.float32)
        rng = np.random.RandomState(0)
        off = 0
        for size in spec.sizes:
            weighted = mat[:, off:off + size].astype(np.float64) \
                * weights.reshape(-1, 1)
            # each client secret-shares its quantized weighted model
            share_sum = np.zeros((self.n_groups, size), np.int64)
            for c in range(weighted.shape[0]):
                q = mpc.quantize(weighted[c], scale, p)
                shares = mpc.additive_shares(q, self.n_groups, p, rng)
                share_sum = np.mod(share_sum + shares, p)
            # groups reveal only their share totals; the sum reconstructs
            total = np.mod(share_sum.sum(axis=0), p)
            out[off:off + size] = mpc.dequantize(total, scale, p)
            off += size
        return collectives.vec_to_tree(_to_device(out, self.device), spec)

    def _round_body(self, state: TurboAggregateState, inp: RoundInputs):
        stacked, mean_loss = self._train_clients(
            state.global_params, self._ones_mask(state.global_params), inp)
        if inp.mesh_rows is not None:  # every sampled client, in draw order
            stacked = self._gather_selected(stacked, inp.mesh_rows)
        w = np.asarray(inp.n_valid, np.float64)
        new_global = self._secure_weighted_sum(stacked, w / w.sum())
        return dataclasses.replace(state, global_params=new_global), \
            {"train_loss": mean_loss}

    def evaluate(self, state: TurboAggregateState) -> Dict[str, Any]:
        ev = self._eval_global(state.global_params)
        return {"global_acc": ev["acc"], "global_loss": ev["loss"],
                "acc_per_client": ev["acc_per_client"]}
