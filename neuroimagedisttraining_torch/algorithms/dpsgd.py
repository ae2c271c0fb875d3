"""DPSGD: decentralized parallel SGD by gossip averaging (counterpart of
``neuroimagedisttraining_tpu/algorithms/dpsgd.py``; not differential
privacy).

Every round each client takes the uniform average of its neighborhood's
personal models (itself included; the neighbors drawn at random, on a ring
or all, ``parallel/topology.py``), then every client trains locally. The
gossip step is one row-normalized adjacency contraction over the stacked
personal models (:func:`core.state.mix_over_clients`). The eval reports the
cohort's average model on every client's test shard besides the personal
models.

On a client mesh every rank gathers the whole personal stack, contracts
the whole ``[C, C]`` matrix against it (the single process's product: a
block of rows could take another matrix-product algorithm, and so other
bits) and keeps its block, whose clients it trains; the eval's average is
over the gathered stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.state import Tree, broadcast_tree, mix_over_clients
from ..core.trainer import make_client_update
from ..parallel.topology import neighbor_adjacency
from .base import PersonalAlgorithm, RoundInputs


@dataclasses.dataclass
class DPSGDState:
    #: [C, ...] per leaf: each client's own model
    personal_params: Tree
    #: the round loop's draws (epoch permutations, dropout masks)
    generator: torch.Generator


class DPSGD(PersonalAlgorithm):
    name = "dpsgd"
    supports_fused = True
    mesh_supported = True

    def __init__(self, *args, neighbor_mode: str = "random", **kwargs):
        self.neighbor_mode = neighbor_mode
        super().__init__(*args, **kwargs)

    def cost_trained_clients_per_round(self) -> int:
        return self.num_clients  # every client trains every round

    def _build(self) -> None:
        self.client_update = make_client_update(
            self.apply_fn, self.loss_type, self.hp,
            full_batches=self._full_batches(), remat=self.remat_local)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> DPSGDState:
        """Every client starts from the same fresh parameters (or the given
        ``params``). ``generator`` defaults to one seeded by the run seed
        and drives init and every later round."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        return DPSGDState(
            personal_params=broadcast_tree(params, self.num_local_clients),
            generator=g)

    def _selected_client_indexes(self, round_idx: int) -> np.ndarray:
        return np.arange(self.num_clients, dtype=np.int32)

    def _host_inputs(self, round_idx):
        return {"adjacency": neighbor_adjacency(
            round_idx, self.num_clients, self.clients_per_round,
            mode=self.neighbor_mode)}

    def _round_body(self, state: DPSGDState, inp: RoundInputs):
        a = inp.adjacency
        mixed = mix_over_clients(
            a / torch.clamp(a.sum(dim=1, keepdim=True), min=1.0),
            self._whole(state.personal_params))
        trained, _, losses = self._train_stacked(
            self.client_update, self._block(mixed),
            self._ones_mask(self._template(state)), inp, shared_mask=True)
        return dataclasses.replace(state, personal_params=trained), \
            {"train_loss": self._gather_own(losses, inp).mean()}

    def evaluate(self, state: DPSGDState) -> Dict[str, Any]:
        """The cohort's average model (the original's global average) and
        every personal model."""
        avg = {k: v.mean(dim=0) for k, v in
               self._whole(state.personal_params).items()}
        ev_g = self._eval_global(avg)
        ev_p = self._eval_personal(state.personal_params)
        return {"global_acc": ev_g["acc"], "global_loss": ev_g["loss"],
                "personal_acc": ev_p["acc"], "personal_loss": ev_p["loss"],
                "acc_per_client": ev_p["acc_per_client"]}
