"""Local-only training, the no-communication baseline (counterpart of
``neuroimagedisttraining_tpu/algorithms/local_only.py``).

Each round the sampled clients continue training their own personal models
on their own shards; nothing is aggregated. The local update is the masked
SGD kernel over an all-ones mask, built once (the reference's fused
spelling of plain SGD). On a client mesh each rank trains the sampled
clients it holds; only the train loss is gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.state import Tree, broadcast_tree, tree_index, tree_scatter_update
from ..core.trainer import make_client_update
from .base import PersonalAlgorithm, RoundInputs


@dataclasses.dataclass
class LocalOnlyState:
    #: [C, ...] per leaf: each client's own model
    personal_params: Tree
    #: the round loop's draws (epoch permutations, dropout masks)
    generator: torch.Generator


class LocalOnly(PersonalAlgorithm):
    name = "local"
    supports_fused = True
    mesh_supported = True

    def _build(self) -> None:
        self.client_update = make_client_update(
            self.apply_fn, self.loss_type, self.hp,
            full_batches=self._full_batches(), remat=self.remat_local)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> LocalOnlyState:
        """Every client starts from the same fresh parameters (or the given
        ``params``). ``generator`` defaults to one seeded by the run seed
        and drives init and every later round."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        return LocalOnlyState(
            personal_params=broadcast_tree(params, self.num_local_clients),
            generator=g)

    def _round_body(self, state: LocalOnlyState, inp: RoundInputs):
        rows = self._own(inp)[1]
        trained, _, losses = self._train_stacked(
            self.client_update, tree_index(state.personal_params, rows),
            self._ones_mask(self._template(state)), inp, shared_mask=True)
        return dataclasses.replace(
            state, personal_params=tree_scatter_update(
                state.personal_params, rows, trained)), \
            {"train_loss": self._gather_own(losses, inp).mean()}

    def evaluate(self, state: LocalOnlyState) -> Dict[str, Any]:
        ev = self._eval_personal(state.personal_params)
        return {"personal_acc": ev["acc"], "personal_loss": ev["loss"],
                "acc_per_client": ev["acc_per_client"]}
