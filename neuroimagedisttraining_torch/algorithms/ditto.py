"""Ditto: personalized federated learning with a proximal pull toward the
global model (counterpart of ``neuroimagedisttraining_tpu/algorithms/
ditto.py``).

Each sampled client (a) trains a copy of the global model, which enters
the sample-weighted aggregate as in FedAvg (every ``agg_impl`` wire but the
top-k, the guard, the faults and the robust statistics ride it, through
the base class's round), and (b) trains its own personal model with the
pull ``p <- p - lr * lamda * (p - g)`` after every step toward the global
model from before the round. The global leg takes ``hp``, the personal leg
``personal_hp`` (the original's ``--local_epochs``; ``hp`` by default).
Both legs are the masked SGD kernel over an all-ones mask. On a client mesh
the global leg is FedAvg's mesh round (the on-mesh reduce, the robust tier
with it) and each rank trains the personal rows of the sampled clients it
holds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.state import (
    HyperParams,
    Tree,
    broadcast_tree,
    tree_index,
    tree_scatter_update,
)
from ..core.trainer import make_client_update
from .base import FedAlgorithm, RoundInputs


@dataclasses.dataclass
class DittoState:
    global_params: Tree
    #: [C, ...] per leaf: each client's personal model (None with a client
    #: store, which holds the rows)
    personal_params: Optional[Tree]
    #: the round loop's draws (both legs' epoch permutations and dropout
    #: masks, the int8 wire's uniforms)
    generator: torch.Generator


class Ditto(FedAlgorithm):
    name = "ditto"
    supports_fused = True
    store_supported = True
    mesh_supported = True
    _round_metric_names = ("train_loss", "personal_train_loss")
    # the guard protects the global leg's aggregate without reporting
    # its counters, as in the reference
    guard_metrics_supported = False

    def __init__(self, *args, lamda: float = 0.5,
                 personal_hp: Optional[HyperParams] = None, **kwargs):
        self.lamda = lamda
        self._personal_hp = personal_hp
        super().__init__(*args, **kwargs)

    def cost_trained_clients_per_round(self) -> int:
        # each selected client trains a global and a personal leg
        return 2 * self.clients_per_round

    def _build(self) -> None:
        self.client_update = make_client_update(
            self.apply_fn, self.loss_type, self.hp,
            augment_fn=self.augment_fn,
            full_batches=self._full_batches(), remat=self.remat_local,
            label_flip=self.labelflip_fn)
        self.personal_update = make_client_update(
            self.apply_fn, self.loss_type, self._second_leg_hp(),
            augment_fn=self.augment_fn,
            full_batches=self._full_batches(), remat=self.remat_local,
            prox_lambda=self.lamda)

    def _second_leg_hp(self) -> HyperParams:
        return self._personal_hp or self.hp

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> DittoState:
        """Fresh parameters (or the given ``params``) as the global model
        and every client's personal one. ``generator`` defaults to one
        seeded by the run seed and drives init and every later round. With a
        client store the personal rows are the store's (registered here,
        the field None in the state)."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        if self._store is not None:
            self._store_register_fields(params)
            return DittoState(global_params=params, personal_params=None,
                              generator=g)
        return DittoState(
            global_params=params,
            personal_params=broadcast_tree(params, self.num_local_clients),
            generator=g)

    def _round_mask(self, state: DittoState) -> Tree:
        return self._ones_mask(state.global_params)

    def _round_body(self, state: DittoState, inp: RoundInputs):
        ones = self._round_mask(state)
        new_global, _, mean_loss, _, _ = self._train_selected_weighted(
            state.global_params, ones, inp)
        rows = self._own(inp)[1]
        trained, _, p_losses = self._train_stacked(
            self.personal_update, tree_index(state.personal_params, rows),
            ones, inp, leg=2, shared_mask=True,
            prox_target=state.global_params)
        return dataclasses.replace(
            state, global_params=new_global,
            personal_params=tree_scatter_update(
                state.personal_params, rows, trained)), \
            {"train_loss": mean_loss,
             "personal_train_loss": self._gather_own(p_losses, inp).mean()}

    def evaluate(self, state: DittoState) -> Dict[str, Any]:
        ev_g = self._eval_global(state.global_params)
        ev_p = self._eval_personal_state(state)
        return {"global_acc": ev_g["acc"], "global_loss": ev_g["loss"],
                "personal_acc": ev_p["acc"], "personal_loss": ev_p["loss"],
                "acc_per_client": ev_p["acc_per_client"]}
