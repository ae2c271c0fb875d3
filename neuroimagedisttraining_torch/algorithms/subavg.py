"""SubAvg: federated averaging with iterative magnitude pruning (counterpart
of ``neuroimagedisttraining_tpu/algorithms/subavg.py``).

Each sampled client starts from the global model under its own mask and
trains with masked gradients (the masked SGD kernel's ``mask_grads``
branch): one epoch, a candidate mask by magnitude prune, the remaining
epochs from the first leg's momentum, a second candidate. It takes the
second candidate only if the two differ by more than ``dist_thresh``, its
weights are denser than ``dense_ratio``, and the pruned model's accuracy on
its own train shard passes ``acc_thresh``. The server then averages each
coordinate over the clients whose mask (from before the round) holds it,
and keeps its previous value where none does. The eval tests the global
model under each client's mask on that client's test shard.

On a client mesh each rank holds its block of the masks and runs the
sampled clients it holds (both legs, the prune and the gates); the trained
rows and the old masks of every sampled client are gathered in draw order,
and every rank takes the same quotient the single process takes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.state import (
    HyperParams,
    Tree,
    broadcast_tree,
    row_sum,
    tree_index,
    tree_scatter_update,
)
from ..core.trainer import make_client_update
from ..ops.sparsity import (
    magnitude_prune_mask,
    mask_density_f32,
    mask_distance,
)
from .base import PersonalAlgorithm, RoundInputs, _personal_metrics, _row


@dataclasses.dataclass
class SubAvgState:
    global_params: Tree
    #: [C, ...] per leaf: each client's binary mask
    masks: Tree
    #: the round loop's draws (epoch permutations, dropout masks)
    generator: torch.Generator


class SubAvg(PersonalAlgorithm):
    name = "subavg"
    supports_fused = True
    mesh_supported = True
    masks_evolve = True
    row_fields = ("masks",)

    def __init__(self, *args, each_prune_ratio: float = 0.2,
                 dist_thresh: float = 0.001, acc_thresh: float = 0.5,
                 dense_ratio: float = 0.5, **kwargs):
        self.each_prune_ratio = each_prune_ratio
        self.dist_thresh = dist_thresh
        self.acc_thresh = acc_thresh
        self.dense_ratio = dense_ratio
        super().__init__(*args, **kwargs)

    def _build(self) -> None:
        hp = self.hp
        self._hp_rest: Optional[HyperParams] = None
        if hp.local_epochs > 1:
            self._hp_rest = dataclasses.replace(
                hp, local_epochs=hp.local_epochs - 1)
        kw = dict(full_batches=self._full_batches(), remat=self.remat_local,
                  mask_grads=True, augment_fn=self.augment_fn)
        self._update_first = make_client_update(
            self.apply_fn, self.loss_type,
            dataclasses.replace(hp, local_epochs=1), **kw)
        self._update_rest = (
            make_client_update(self.apply_fn, self.loss_type, self._hp_rest,
                               **kw)
            if self._hp_rest is not None else None)

    def _second_leg_hp(self) -> Optional[HyperParams]:
        return self._hp_rest

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> SubAvgState:
        """Fresh parameters (or the given ``params``) and an all-ones mask
        for every client. ``generator`` defaults to one seeded by the run
        seed and drives init and every later round."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        masks = broadcast_tree({k: torch.ones_like(v) for k, v in
                                params.items()}, self.num_local_clients)
        return SubAvgState(global_params=params, masks=masks, generator=g)

    def _client_round(self, global_params: Tree, mask: Tree, inp: RoundInputs,
                      i: int, client: torch.Tensor):
        """Selected client ``i`` (its data row ``client``, ``[1]`` on the
        device): both legs, both candidate masks, the accept gates. Returns
        (its model, its new mask, its mean loss)."""
        d = self.data
        n = inp.n_valid[i]
        count = inp.n_sel[i]  # the sample count, on the device
        drop = None if inp.dropout is None else inp.dropout[i]
        start = {k: v * mask[k] for k, v in global_params.items()}
        p1, mom1, loss = self._update_first(
            start, mask, d.x_train, d.y_train, n, client, inp.perms[i],
            inp.lr, drop, n_rows=count,
            augment=None if inp.augment is None else inp.augment[i])
        m1 = magnitude_prune_mask(mask, p1, self.each_prune_ratio)
        p2 = p1
        if self._update_rest is not None:
            drop = None if inp.dropout_2 is None else inp.dropout_2[i]
            p2, _, loss2 = self._update_rest(
                p1, mask, d.x_train, d.y_train, n, client, inp.perms_2[i],
                inp.lr, drop, momentum=mom1, n_rows=count,
                augment=None if inp.augment_2 is None else inp.augment_2[i])
            loss = (loss + loss2) / 2
        m2 = magnitude_prune_mask(mask, p2, self.each_prune_ratio)
        # the accept gates, the accuracy on the client's own train shard
        correct, _, _ = self.eval_client(
            {k: v * m2[k] for k, v in p2.items()},
            d.x_train.index_select(0, client)[0],
            d.y_train.index_select(0, client)[0], count)
        acc = correct.to(torch.float32) / torch.clamp(count, min=1.0)
        accept = ((mask_distance(m1, m2) > self.dist_thresh)
                  & (mask_density_f32(p2) > self.dense_ratio)
                  & (acc > self.acc_thresh))
        new_mask = {k: torch.where(accept, m2[k], mask[k]) for k in mask}
        new_params = {k: torch.where(accept, v * new_mask[k], v)
                      for k, v in p2.items()}
        return new_params, new_mask, loss

    def _round_body(self, state: SubAvgState, inp: RoundInputs):
        own, rows = self._own(inp)
        masks_sel = tree_index(state.masks, rows)
        out = [self._client_round(state.global_params, _row(masks_sel, j),
                                  inp, i, rows[j:j + 1])
               for j, i in enumerate(own)]
        if out:
            trained = {k: torch.stack([r[0][k] for r in out])
                       for k in state.global_params}
            new_masks = {k: torch.stack([r[1][k] for r in out])
                         for k in state.masks}
            losses = torch.stack([r[2] for r in out])
        else:  # a mesh rank that holds none of the sampled clients
            trained = {k: masks_sel[k].clone() for k in state.global_params}
            new_masks = {k: v.clone() for k, v in masks_sel.items()}
            losses = torch.zeros(0, device=self.device)
        masks = tree_scatter_update(state.masks, rows, new_masks)
        mr = inp.mesh_rows
        if mr is not None:  # every sampled client's rows, in draw order
            trained = self._gather_selected(trained, mr)
            masks_sel = self._gather_selected(masks_sel, mr)
        # the counts are the masks from before the round, as the original
        # appends each client's mask before updating it
        new_global = {}
        for k, srv in state.global_params.items():
            c, s = row_sum(masks_sel[k]), row_sum(trained[k])
            new_global[k] = torch.where(c > 0, s / torch.clamp(c, min=1e-9),
                                        srv)
        return dataclasses.replace(state, global_params=new_global,
                                   masks=masks), \
            {"train_loss": self._gather_own(losses, inp).mean()}

    def evaluate(self, state: SubAvgState) -> Dict[str, Any]:
        """The global model under each evaluated client's mask on that
        client's test shard."""
        g, masks, lo = state.global_params, state.masks, self._lo
        correct, loss_sum = self._eval_terms(
            self._eval_rows,
            lambda c: {k: v * masks[k][c - lo] for k, v in g.items()})
        ev = _personal_metrics(correct, loss_sum, self._n_test_eval)
        return {"personal_acc": ev["acc"], "personal_loss": ev["loss"],
                "mean_mask_density": self._mean_mask_density(masks),
                "acc_per_client": ev["acc_per_client"]}
