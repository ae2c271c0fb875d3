"""FedAvg: centralized federated averaging (counterpart of
``neuroimagedisttraining_tpu/algorithms/fedavg.py``).

Each round samples ``frac * N`` clients; each runs local SGD from the global
model, and the server takes the sample-count-weighted mean through the
``agg_impl`` wire ("sparse" needs a static mask, which FedAvg has not, and
is refused at the first aggregate, as in the reference). Each client's last
locally trained weights are kept as its personal model, and both the global
and the personal models are evaluated. After the last round every client
fine-tunes once from the final global model at ``round_idx = -1``
(:meth:`FedAvg.finalize`) and the pair is evaluated one final time.

The local update is the masked SGD kernel with an all-ones mask, which is
the reference's fused spelling of plain SGD (``p * 1`` is ``p``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.state import (
    Tree,
    broadcast_tree,
    clone_generator,
    zeros_like_tree,
)
from ..core.trainer import make_client_update, round_lr
from .base import FedAlgorithm, _to_device


@dataclasses.dataclass
class FedAvgState:
    global_params: Tree
    #: [C, ...] per leaf: each client's last locally trained weights,
    #: initialized to copies of the initial global model; None when
    #: ``track_personal`` is off or a client store holds the rows
    personal_params: Optional[Tree]
    #: the round loop's draws (epoch permutations, dropout masks, the int8
    #: wire's uniforms)
    generator: torch.Generator
    #: [C, ...] error-feedback residual of agg_impl="topk", else None
    agg_residual: Optional[Tree] = None
    #: the personal eval's per-client terms ``{"correct", "loss_sum",
    #: "total"}``, each [C], with ``eval_cache``; else None
    eval_cache: Optional[Dict[str, torch.Tensor]] = None


class FedAvg(FedAlgorithm):
    name = "fedavg"
    topk_supported = True
    supports_fused = True
    store_supported = True
    mesh_supported = True

    def __init__(self, *args, defense=None, track_personal: bool = True,
                 eval_cache: bool = False, **kwargs):
        # an optional robust.RobustAggregator on the aggregate's copy
        self.defense = defense
        # track_personal=False drops the [C, model] personal stack and the
        # final fine-tune that exists to produce it
        self.track_personal = track_personal
        # the in-state personal-eval cache, validated by the base
        self.eval_cache = bool(eval_cache)
        super().__init__(*args, **kwargs)

    def _build(self) -> None:
        self.client_update = make_client_update(
            self.apply_fn, self.loss_type, self.hp,
            augment_fn=self.augment_fn,
            full_batches=self._full_batches(), remat=self.remat_local,
            label_flip=self.labelflip_fn)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None) -> FedAvgState:
        """Fresh parameters (or the given ``params``), personal copies,
        under "topk" a zero residual and, with ``eval_cache``, the cache
        seeded by one full personal eval. ``generator`` defaults to one
        seeded by the run seed and drives init and every later round. With a
        client store the per-client rows are the store's (registered here,
        the fields None in the state)."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        if self._store is not None:
            self._store_register_fields(params)
            return FedAvgState(
                global_params=params, personal_params=None, generator=g,
                eval_cache=self._seed_eval_cache(None, params))
        personal = (broadcast_tree(params, self.num_local_clients)
                    if self.track_personal else None)
        residual = None
        if self.agg_impl == "topk":
            residual = zeros_like_tree(
                broadcast_tree(params, self.num_local_clients))
        return FedAvgState(global_params=params, personal_params=personal,
                           generator=g, agg_residual=residual,
                           eval_cache=self._seed_eval_cache(personal))

    def _prepare_round(self, state: FedAvgState) -> None:
        self._ones_mask(state.global_params)

    def _round_mask(self, state: FedAvgState) -> Tree:
        return self._ones_mask(state.global_params)

    def finalize(self, state: FedAvgState, *, perms=None, dropout=None):
        """Every client fine-tunes once from the final global model at
        ``round_idx = -1``; those become the personal models, and both are
        evaluated. ``perms`` / ``dropout`` (per client) replace the draws.
        Like a round, it leaves its input state as it was. Without personal
        tracking there is nothing to produce. The fine-tune retrains every
        personal row, so it drops the eval cache: the final eval is a full
        pass. With a client store the clients fine-tune in cohorts of
        ``clients_per_round``, each one's data on the card in turn (the
        same draws in the same order), and their rows go to the store."""
        if not self.track_personal:
            return state, None
        g = clone_generator(state.generator)
        lr = _to_device(round_lr(self.hp, -1), self.device)
        ones = self._ones_mask(state.global_params)
        c = self.num_clients
        step = c if self._store is None else self.clients_per_round
        rows = []
        for lo in range(0, c, step):
            sel = np.arange(lo, min(lo + step, c))
            inp = self._round_inputs(
                state.global_params, sel, _to_device(sel, self.device), lr,
                g, dict(perms=None if perms is None else perms[lo:lo + step],
                        dropout=None if dropout is None
                        else dropout[lo:lo + step]), aggregate=False)
            if self._store is None:
                rows.append(self._train_clients(state.global_params, ones,
                                                inp)[0])
                continue
            # on a client mesh each rank fine-tunes the clients it holds
            own = self._store_own(sel)
            inp = self._on_slab(inp, self._data_slab(own), len(own))
            self._store.stage("personal_params", own, self._train_clients(
                state.global_params, ones, inp)[0])
        if self._store is None:
            personal = rows[0]
        else:  # every row retrained: the store eval starts over
            self._store.commit()
            self._store_eval_cache, self._store_eval_dirty = None, []
            personal = None
        state = dataclasses.replace(state, personal_params=personal,
                                    generator=g, eval_cache=None)
        ev = self.evaluate(state)
        return state, {"round": -1, "finetune": True,
                       **{k: v for k, v in ev.items()
                          if not k.startswith("acc_per")}}

    def evaluate(self, state: FedAvgState) -> Dict[str, Any]:
        ev = self._eval_global(state.global_params)
        out = {"global_acc": ev["acc"], "global_loss": ev["loss"],
               "acc_per_client": ev["acc_per_client"]}
        if state.personal_params is not None or self._store_has_personal():
            evp = self._eval_personal_state(state)
            out.update(personal_acc=evp["acc"], personal_loss=evp["loss"])
        return out
