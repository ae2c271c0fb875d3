"""FedFomo: personalized aggregation by first-order model optimization
(counterpart of ``neuroimagedisttraining_tpu/algorithms/fedfomo.py``).

Each round every client (1) trains its personal model, (2) picks a
neighbor set on the host (with probability 1/2 the clients of largest
accumulated helpfulness ``p_choose``, else uniformly; itself always
appended), (3) scores each neighbor j by ``w_ij = (L_i(own pre-round model)
- L_i(model_j)) / ||theta_j - theta_i||`` on its own validation shard (j =
i takes the freshly trained model), and (4) moves its pre-round model by
the positively clipped, normalized weighted deltas (if no neighbor helps,
it keeps its pre-round model). The unclipped weights accumulate into
``p_choose``.

It needs per-client validation shards (``FederatedData.x_val``). The
neighbor choice reads ``p_choose`` back from the card each round, host
work that depends on the state: FedFomo has no fused loop.

On a client mesh each rank holds its block of the personal models and of
``p_choose``'s rows: every rank gathers ``p_choose`` whole and makes the
same neighbor choice, gathers the pre-round and the trained stacks whole
(any client may be drawn), and scores and moves its own clients, on their
own validation shards.
"""
from __future__ import annotations

import dataclasses
import random as _pyrandom
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..convert import reference_leaf_order
from ..core.state import Tree, broadcast_tree
from ..core.trainer import make_client_update
from .base import PersonalAlgorithm, RoundInputs, _row, _stack, _to_device


@dataclasses.dataclass
class FedFomoState:
    #: [C, ...] per leaf: each client's own model
    personal_params: Tree
    #: [C, C] float32: the accumulated helpfulness of client j to client i
    p_choose: torch.Tensor
    #: the round loop's draws (epoch permutations, dropout masks)
    generator: torch.Generator


class FedFomo(PersonalAlgorithm):
    name = "fedfomo"
    mesh_supported = True
    row_fields = ("personal_params", "p_choose")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        d = self.data
        if d.x_val is None:
            raise ValueError(
                "FedFomo needs per-client validation shards "
                "(FederatedData.x_val; see data_val_loader in the reference)")
        self.data = dataclasses.replace(d, x_val=d.x_val.to(self.device),
                                        y_val=d.y_val.to(self.device))
        self._n_val = [int(n) for n in d.n_val]

    def cost_trained_clients_per_round(self) -> int:
        return self.num_clients  # every client trains its own model

    def _build(self) -> None:
        self.client_update = make_client_update(
            self.apply_fn, self.loss_type, self.hp,
            augment_fn=self.augment_fn,
            full_batches=self._full_batches(), remat=self.remat_local)
        self._n_nei = min(self.clients_per_round, self.num_clients - 1)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> FedFomoState:
        """Every client starts from the same fresh parameters (or the given
        ``params``), ``p_choose`` all ones. ``generator`` defaults to one
        seeded by the run seed and drives init and every later round."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        c = self.num_clients
        return FedFomoState(
            personal_params=broadcast_tree(params, self.num_local_clients),
            p_choose=torch.ones((self.num_local_clients, c),
                                dtype=torch.float32, device=self.device),
            generator=g)

    def _selected_client_indexes(self, round_idx: int) -> np.ndarray:
        return np.arange(self.num_clients, dtype=np.int32)

    def _choose_neighbors(self, round_idx: int,
                          p_choose: np.ndarray) -> np.ndarray:
        """Host-side neighbor choice (fedfomo_api.py:130-144): with prob 1/2
        the top-p_choose clients, else uniform (self excluded); self always
        appended."""
        c, k = self.num_clients, self._n_nei
        rng = np.random.RandomState(round_idx)
        coin = _pyrandom.Random(round_idx)
        out = np.zeros((c, k + 1), dtype=np.int32)
        for i in range(c):
            p = p_choose[i].copy()
            p[i] = 0
            if coin.random() >= 0.5:
                idx = np.argsort(p)[-k:]
            else:
                others = np.delete(np.arange(c), i)
                idx = rng.choice(others, k, replace=False)
            out[i, :k] = idx
            out[i, k] = i
        return out

    def run_round(self, state: FedFomoState, round_idx: int, *, perms=None,
                  dropout=None):
        """One round, a pure function of ``state`` (as the base's): the
        neighbor choice on ``p_choose`` read back as float32, then every
        client's training and its neighbors' scores. ``perms`` /
        ``dropout`` (per client) replace the drawn epoch permutations /
        dropout masks. Returns ``(state, {"train_loss"})``."""
        nei = self._choose_neighbors(
            round_idx, self._whole(state.p_choose).cpu().numpy())
        inp, g = self._eager_inputs(state, round_idx,
                                    dict(perms=perms, dropout=dropout))
        new_state, metrics = self._fomo_round(state, inp, nei)
        return dataclasses.replace(new_state, generator=g), metrics

    def _val_loss(self, params: Tree, c: int) -> torch.Tensor:
        """``params``' mean loss on client ``c``'s validation shard (a
        client this rank holds)."""
        d = self.data
        _, loss_sum, total = self.eval_client(
            params, d.x_val[c - self._lo], d.y_val[c - self._lo],
            self._n_val[c])
        return loss_sum / max(total, 1)

    def _fomo_round(self, state: FedFomoState, inp: RoundInputs,
                    nei: np.ndarray):
        """The round on the card for the host's neighbor ids ``nei`` ``[C,
        K + 1]``: per client, its neighbors in turn with one delta live at
        a time (the reference's scan), the positively clipped weighted
        deltas accumulated, then normalized once. On a client mesh the
        clients this rank holds, from the gathered stacks."""
        trained, _, losses = self._train_stacked(
            self.client_update, state.personal_params,
            self._ones_mask(self._template(state)), inp, shared_mask=True)
        # the pre-round snapshot and the trained models of every client
        lstrd = self._whole(state.personal_params)
        trained = self._whole(trained)
        names = reference_leaf_order(lstrd)
        lo, hi = self._lo, self._hi
        rows, weights = [], []
        for i in range(lo, hi):
            base = _row(lstrd, i)
            self_loss = self._val_loss(base, i)
            acc = {k: torch.zeros_like(v) for k, v in base.items()}
            wsum = torch.zeros((), device=self.device)
            ws = []
            for j in (int(j) for j in nei[i]):
                model_j = _row(trained if j == i else lstrd, j)
                delta = {k: model_j[k] - base[k] for k in base}
                l_j = self._val_loss(model_j, i)
                nrm = torch.sqrt(sum(torch.sum(torch.square(delta[k]))
                                     for k in names))
                w = torch.where(nrm > 0, (self_loss - l_j) / torch.clamp(
                    nrm, min=1e-12), torch.zeros_like(nrm))
                w_pos = torch.clamp(w, min=0.0)
                acc = {k: a + w_pos * delta[k] for k, a in acc.items()}
                wsum = wsum + w_pos
                ws.append(w)
            rows.append({k: torch.where(
                wsum > 0, b + acc[k] / torch.clamp(wsum, min=1e-12), b)
                for k, b in base.items()})
            weights.append(torch.stack(ws))
        # the unclipped weights accumulate over the visited neighbors (a
        # neighbor drawn twice adds twice)
        idx = _to_device(nei[lo:hi].astype(np.int64), self.device)
        ii = torch.arange(hi - lo, device=self.device)[:, None].expand_as(idx)
        upd = torch.zeros_like(state.p_choose).index_put(
            (ii, idx), torch.stack(weights), accumulate=True)
        return dataclasses.replace(
            state, personal_params=_stack(rows),
            p_choose=state.p_choose + upd), \
            {"train_loss": self._gather_own(losses, inp).mean()}

    def evaluate(self, state: FedFomoState) -> Dict[str, Any]:
        ev = self._eval_personal(state.personal_params)
        return {"personal_acc": ev["acc"], "personal_loss": ev["loss"],
                "acc_per_client": ev["acc_per_client"]}
