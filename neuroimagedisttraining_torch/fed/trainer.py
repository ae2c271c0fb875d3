"""SiteTrainer: the local-training half of a round, split out so a site
process trains its own clients and ships the results (counterpart of
``neuroimagedisttraining_tpu/fed/trainer.py``).

The in-process round runs broadcast -> every selected client's local SGD
-> the weighted aggregate in one process (``algorithms/base.py``
``_train_selected_weighted``). A federation cuts it at the aggregation
boundary: each site trains ITS slots of the round, and the aggregator owns
the weighted sum. Bit parity with the in-process round rests on two
properties of the port:

* the clients of a round train one after another, each from its own copy
  of the global model (``FedAlgorithm._train_own``), so a site training
  its slots computes exactly those rows of the in-process stack;
* draw slotting: the aggregator draws the whole round from its state's
  generator, as the in-process round does (``FedAlgorithm._eager_inputs``),
  and ships each site the draws of its slots (epoch permutations, dropout
  keep masks); the site feeds them to ``FedAlgorithm._round_inputs`` as
  seams, so every client consumes exactly the draws it would have
  in-process.

In loopback the site threads share one algorithm on one card, whose
kernels' scratch buffers and caches are not thread-safe: every call
serializes on :attr:`SiteTrainer.lock` (the aggregator takes it too).
"""
from __future__ import annotations

import threading
import types
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..algorithms.base import _to_device
from ..comm.message import to_numpy, tree_map
from ..core.trainer import round_lr
from ..ops import kernels
from .protocol import site_round_key


def slot_draws(algo: Any, inp: Any, pos) -> Dict[str, Any]:
    """The draws of the slots ``pos`` of a round's inputs ``inp`` (a
    ``RoundInputs``), as host numpy trees under their ``run_round`` seam
    names (the epoch draws under ``batch_idx`` with replacement batching):
    what a site needs to train those slots as the in-process round does."""
    pos = [int(i) for i in pos]
    key = "batch_idx" if algo.hp.batching == "replacement" else "perms"
    out: Dict[str, Any] = {key: to_numpy(inp.perms[pos])}
    if inp.dropout is not None:
        out["dropout"] = tree_map(to_numpy, [inp.dropout[i] for i in pos])
    if inp.augment is not None:
        out["augment"] = to_numpy(inp.augment[pos])
    return out


class SiteTrainer:
    """A site's local-training entry points over an algorithm's
    ``client_update`` and data (one per site process, shared by the site
    threads of the loopback backend)."""

    def __init__(self, algo: Any):
        self.algo = algo
        self.lock = threading.Lock()
        #: the model's leaf order, the in-process parameter trees' (a frame
        #: decodes a dict by sorted key)
        self.order = [k for k, _ in algo.model.named_parameters()]

    def _params(self, global_params: Any) -> Dict[str, torch.Tensor]:
        """The shipped global model on the card, in the model's leaf order:
        the order the step's global gradient norm (the clip) sums in, so a
        site's step is bitwise the in-process one."""
        dev = self.algo.device
        # writable host copies: a decoded leaf views its frame's bytes
        return {k: torch.from_numpy(np.array(global_params[k],
                                             np.float32)).to(dev)
                for k in self.order}

    def _train(self, params, sel: np.ndarray, round_idx: int,
               generator: torch.Generator, draws: Dict[str, Any]):
        """The clients ``sel`` trained from ``params`` on the round's rate,
        their draws ``draws`` (seams) or else from ``generator``:
        ``(stacked rows, losses, n_sel)`` on the device."""
        algo = self.algo
        dev = algo.device
        # the central round's mask (FedAvg's all-ones)
        view = types.SimpleNamespace(global_params=params)
        algo._prepare_round(view)
        inp = algo._round_inputs(
            params, sel, _to_device(sel.astype(np.int64), dev),
            _to_device(round_lr(algo.hp, round_idx), dev), generator, draws,
            aggregate=False, round_idx=round_idx)
        stacked, losses = algo._train_own(params, algo._round_mask(view),
                                          inp)
        return stacked, losses, inp.n_sel

    # -- sync: the bit-parity path ---------------------------------------
    def train_sync(self, global_params: Any, round_idx: int,
                   client_ids: np.ndarray, draws: Dict[str, Any]
                   ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Train this site's slots of a synchronous round: the clients
        ``client_ids`` (in slot order) on their slots' draws ``draws``
        (:func:`slot_draws`); returns the ``[s]``-stacked trained models
        and their ``[s]`` losses as host numpy (a bit-preserving copy)."""
        with self.lock:
            params = self._params(global_params)
            sel = np.asarray(client_ids, np.int64)
            stacked, losses, _ = self._train(
                params, sel, round_idx, self.algo.generator(), draws)
            return ({k: to_numpy(v) for k, v in stacked.items()},
                    to_numpy(losses))

    # -- buffered: delta extraction --------------------------------------
    def train_delta(self, global_params: Any, seed: int, site_rank: int,
                    version: int, client_ids: np.ndarray
                    ) -> Tuple[Dict[str, np.ndarray], float, float]:
        """Train ALL of this site's clients from ``global_params`` (the
        model at ``version``) on the draws of the generator
        ``protocol.site_round_key(seed, version, site_rank)``; returns
        ``(delta, n_sum, mean_loss)`` as host numpy: the sample-weighted
        mean of the clients' deltas (FedBuff's per-worker update, through
        the weighted-sum kernel on the card), the weight mass it
        represents, the clients' mean loss."""
        with self.lock:
            algo = self.algo
            params = self._params(global_params)
            sel = np.asarray(client_ids, np.int64)
            stacked, losses, n_sel = self._train(
                params, sel, version,
                site_round_key(seed, version, site_rank, algo.device), {})
            w = n_sel / torch.clamp(n_sel.sum(), min=1.0)
            delta = kernels.fused_weighted_sum(
                {k: v - params[k][None] for k, v in stacked.items()}, w)
            return ({k: to_numpy(v) for k, v in delta.items()},
                    float(n_sel.sum()), float(losses.mean()))
