"""The federated round skeleton shared by the central-aggregate algorithms
(counterpart of ``neuroimagedisttraining_tpu/algorithms/base.py``, the parts
the SalientGrads and FedAvg training paths run).

Where the reference vmaps the cohort inside one compiled program, this loops
over the selected clients: each trains a copy of the global model on its own
shard, and the server takes the sample-weighted mean of the local models,
routed by ``agg_impl`` through the aggregation wires
(``parallel/collectives.py``) off the mesh.
"""
from __future__ import annotations

import abc
import dataclasses
import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.state import (
    HyperParams,
    Tree,
    clone_generator,
    clone_tree,
    tree_index,
    tree_scatter_update,
)
from ..core.trainer import make_eval_fn
from ..data.types import FederatedData
from ..models import make_apply_fn
from ..ops import kernels
from ..parallel import collectives

logger = logging.getLogger(__name__)


def _personal_metrics(correct, loss_sum, total) -> Dict[str, torch.Tensor]:
    """Per-client eval terms -> the personal-eval protocol metrics: the mean
    of per-client accuracies and the mean of per-client mean losses."""
    totals = torch.clamp(total, min=1)
    acc = correct.to(torch.float32) / totals
    return {
        "acc_per_client": acc,
        "acc": acc.mean(),
        "loss": (loss_sum / totals).mean(),
        "correct": correct, "loss_sum": loss_sum, "total": total,
    }


def sample_client_indexes(round_idx: int, client_num_in_total: int,
                          client_num_per_round: int) -> np.ndarray:
    """Per-round client sampling with numpy reseeded by the round index, so
    every algorithm (and the reference) draws the same subsets; full
    participation is ``arange``."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int32)
    np.random.seed(round_idx)
    return np.random.choice(range(client_num_in_total), client_num_per_round,
                            replace=False).astype(np.int32)


class FedAlgorithm(abc.ABC):
    """Owns the model, data, hyperparameters and the apply/eval functions.

    ``device`` defaults to CUDA (and raises without it); the data is moved
    there. ``compute_dtype`` (e.g. ``"bfloat16"``) casts parameters and
    inputs for the forward and backward passes; master weights, momentum and
    losses stay float32.

    ``agg_impl`` routes the central aggregate (:meth:`_aggregate`):
    "dense" (the default, the weighted-sum kernel over the parameter tree,
    ``kernels.fused_weighted_sum``), "bucketed", "bf16",
    "int8", "sparse" (static-mask algorithms only), "topk" (error-feedback
    top-k at ``agg_topk_density``, the strided estimator when
    ``agg_topk_sample`` > 0; algorithms that carry the residual only) and
    "hier" (off the mesh the exact f32 bucketed reduce), in buckets of
    ``agg_bucket_size`` values (0 = the default). The reference's
    ``agg_kernels`` and ``agg_overlap`` change no bit and are left out."""

    name = "base"
    #: the algorithm carries the error-feedback residual of agg_impl="topk"
    topk_supported = False

    def __init__(self, model: torch.nn.Module, data: FederatedData,
                 hp: HyperParams, loss_type: str = "bce", frac: float = 1.0,
                 eval_batch: int = 32, seed: int = 0,
                 compute_dtype: Optional[str] = None,
                 agg_impl: str = "dense", agg_bucket_size: int = 0,
                 agg_topk_density: float = 0.1, agg_topk_sample: int = 0,
                 agg_hier_wire: str = "bf16", agg_hier_inner: int = 0,
                 device=None):
        if agg_impl not in collectives.AGG_IMPLS:
            raise ValueError(
                f"agg_impl {agg_impl!r} not in {collectives.AGG_IMPLS}")
        # validated on every impl, as the reference does
        collectives.topk_count(1, agg_topk_density)
        if agg_impl == "topk" and not self.topk_supported:
            raise ValueError(
                f"{self.name}: agg_impl='topk' carries an error-feedback "
                "residual in algorithm state; only the central-aggregate "
                "algorithms that thread it (fedavg/salientgrads) support it")
        if agg_hier_wire not in collectives.HIER_WIRES:
            raise ValueError(f"agg_hier_wire {agg_hier_wire!r} not in "
                             f"{collectives.HIER_WIRES}")
        if int(agg_hier_inner) < 0:
            raise ValueError(f"agg_hier_inner {agg_hier_inner} must be >= 0 "
                             "(0 = balanced auto split)")
        self.agg_impl = agg_impl
        self.agg_bucket_size = (agg_bucket_size
                                or collectives.DEFAULT_BUCKET_SIZE)
        self.agg_topk_density = agg_topk_density
        self.agg_topk_sample = int(agg_topk_sample)
        self.agg_hier_wire = agg_hier_wire
        self.agg_hier_inner = int(agg_hier_inner)
        #: the static-mask gather plan of the sparse wires (SalientGrads
        #: builds it from its SNIP mask before the first round)
        self._agg_sparse_plan: Optional[collectives.SparsePlan] = None
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data = data.to(self.device)
        self.hp = hp
        self.loss_type = loss_type
        self.seed = seed
        self.num_clients = data.num_clients
        self.clients_per_round = max(1, int(round(self.num_clients * frac)))
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype is not None else None)
        self.apply_fn = make_apply_fn(self.model, self.compute_dtype)
        self.eval_client = make_eval_fn(self.apply_fn, loss_type, eval_batch)
        self._n_train = [int(n) for n in data.n_train]
        self._n_test = [int(n) for n in data.n_test]
        self._build()

    @abc.abstractmethod
    def _build(self) -> None:
        """Construct the round and eval functions."""

    @abc.abstractmethod
    def init_state(self, generator: Optional[torch.Generator] = None) -> Any:
        """The initial server state."""

    @abc.abstractmethod
    def run_round(self, state: Any, round_idx: int, **seams) -> Any:
        """One federated round; returns (state, train-metrics dict)."""

    def finalize(self, state: Any):
        """Optional end-of-training pass; returns ``(state, record or
        None)``, the record appended to the history with ``round = -1``."""
        return state, None

    def generator(self, seed: Optional[int] = None) -> torch.Generator:
        """A generator on this algorithm's device, seeded by ``seed`` (the
        run seed by default)."""
        return torch.Generator(device=self.device).manual_seed(
            self.seed if seed is None else seed)

    def clone_state(self, state: Any) -> Any:
        """A deep copy of ``state`` on its device: every tensor (and tree of
        tensors) cloned, the generator copied into a fresh one in the same
        state. :meth:`run_round` leaves its input state as it was, so this
        is for a caller that runs several rounds or cells from one state
        (the reference's ``clone_state`` borrow API)."""
        def copy(v):
            if isinstance(v, torch.Generator):
                return clone_generator(v)
            if isinstance(v, torch.Tensor):
                return v.clone()
            if isinstance(v, dict):
                return clone_tree(v)
            return v

        return dataclasses.replace(state, **{
            f.name: copy(getattr(state, f.name))
            for f in dataclasses.fields(state)})

    # -- shared helpers --------------------------------------------------------
    def _selected_client_indexes(self, round_idx: int) -> np.ndarray:
        return sample_client_indexes(round_idx, self.num_clients,
                                     self.clients_per_round)

    def _full_batches(self) -> bool:
        """Every client's shard covers ``steps_per_epoch * batch_size`` rows,
        so every batch is full and every step active."""
        need = self.hp.steps_per_epoch * self.hp.batch_size
        return all(n >= need for n in self._n_train)

    def _require_plan(self, what: str) -> collectives.SparsePlan:
        if self._agg_sparse_plan is None:
            raise ValueError(
                f"{self.name}: {what} needs a static-mask gather plan "
                "(_agg_sparse_plan) built from the concrete mask — only "
                "fixed-mask algorithms (SalientGrads) support it")
        return self._agg_sparse_plan

    def _aggregate(self, stacked: Tree, weights: torch.Tensor,
                   uniforms: Optional[torch.Tensor] = None) -> Tree:
        """The central weighted mean over the stacked client axis, routed by
        ``agg_impl``. ``uniforms`` is the int8 wire's ``[C, nb, b]``
        stochastic-rounding draw. "topk" here is the wire alone, selection
        and reduce of whatever ``stacked`` holds; the round body's
        :meth:`_topk_aggregate` owns the residual around it."""
        impl = self.agg_impl
        kw = dict(bucket_size=self.agg_bucket_size)
        if impl == "dense":
            return kernels.fused_weighted_sum(stacked, weights)
        if impl == "topk":
            return collectives.topk_weighted_mean(
                stacked, weights, self.agg_topk_density,
                plan=self._agg_sparse_plan, sample=self.agg_topk_sample,
                **kw)[0]
        if impl == "hier":
            if self.agg_hier_wire == "sparse":
                return collectives.sparse_weighted_mean(
                    stacked, weights,
                    self._require_plan("agg_hier_wire='sparse'"),
                    hier_inner=self.agg_hier_inner or -1, **kw)
            return collectives.weighted_mean(
                stacked, weights, wire=self.agg_hier_wire,
                hier_inner=self.agg_hier_inner or -1, uniforms=uniforms,
                **kw)
        if impl == "sparse":
            return collectives.sparse_weighted_mean(
                stacked, weights, self._require_plan("agg_impl='sparse'"),
                **kw)
        wire = {"bucketed": "f32", "bf16": "bf16", "int8": "int8"}[impl]
        return collectives.weighted_mean(stacked, weights, wire=wire,
                                         uniforms=uniforms, **kw)

    def _topk_aggregate(self, locals_: Tree, global_params: Tree,
                        residual: Tree, sel_idx: np.ndarray,
                        weights: torch.Tensor):
        """The ``agg_impl='topk'`` round aggregate with error feedback (Deep
        Gradient Compression on the federated round), guard off:

        1. each selected client's delta, local - global, plus its carried
           residual row (dead coordinates of a sparse plan zeroed);
        2. per leaf-group top-k selection and the weighted mean of the
           sparsified rows;
        3. the unsent remainder becomes the client's new residual row;
        4. ``new_global = global + aggregate``.

        Returns ``(new_global, new_residual)``."""
        if residual is None:
            raise ValueError(
                f"{self.name}: agg_impl='topk' round body called without the "
                "residual stack — init_state must seed State.agg_residual")
        full = self.clients_per_round == self.num_clients
        idx = torch.as_tensor(sel_idx, dtype=torch.int64, device=self.device)
        res_sel = residual if full else tree_index(residual, idx)
        comp = {k: (locals_[k] - global_params[k][None]) + res_sel[k]
                for k in locals_}
        plan = self._agg_sparse_plan
        if plan is not None:
            # dead coordinates never ship, so they must not enter the
            # residual either (round 0's dense init would sit there forever)
            comp = collectives.plan_dead_select(comp, plan)
        update, sp = collectives.topk_weighted_mean(
            comp, weights, self.agg_topk_density, plan=plan,
            bucket_size=self.agg_bucket_size, sample=self.agg_topk_sample)
        new_global = {k: (g + update[k]).to(g.dtype)
                      for k, g in global_params.items()}
        new_rows = {k: comp[k] - sp[k] for k in comp}
        new_residual = new_rows if full else tree_scatter_update(
            residual, idx, new_rows)
        return new_global, new_residual

    def _train_selected_weighted(self, client_update, global_params: Tree,
                                 mask: Tree, sel_idx: np.ndarray,
                                 round_idx: int, generator, perms=None,
                                 dropout=None, residual: Optional[Tree] = None,
                                 agg_uniforms=None):
        """Every selected client trains a copy of the global model on its
        shard; returns (new global, stacked local models, mean loss, new
        error-feedback residual).

        ``perms`` / ``dropout``, when given, hold each selected client's
        epoch permutations / per-step dropout masks (indexed by position in
        ``sel_idx``). ``residual`` is the ``[C, ...]`` error-feedback stack
        (``agg_impl='topk'`` only; returned unchanged otherwise).
        ``agg_uniforms`` is the int8 wire's ``[S, nb, b]`` draw over the
        reference's flat layout (:func:`collectives.bucket_shape`); without
        it the wire draws from ``generator``."""
        d = self.data
        locals_, losses = [], []
        for i, c in enumerate(sel_idx):
            c = int(c)
            params, _, loss = client_update(
                clone_tree(global_params), mask, d.x_train[c], d.y_train[c],
                self._n_train[c], round_idx,
                perms=None if perms is None else perms[i],
                dropout=None if dropout is None else dropout[i],
                generator=generator)
            locals_.append(params)
            losses.append(loss)
        stacked = {k: torch.stack([p[k] for p in locals_])
                   for k in global_params}
        n_sel = torch.tensor([self._n_train[int(c)] for c in sel_idx],
                             dtype=torch.float32, device=self.device)
        weights = n_sel / torch.clamp(n_sel.sum(), min=1.0)
        mean_loss = torch.stack(losses).mean()
        if self.agg_impl == "topk":
            new_global, residual = self._topk_aggregate(
                stacked, global_params, residual, sel_idx, weights)
            return new_global, stacked, mean_loss, residual
        uniforms = None
        if self.agg_impl == "int8":
            uniforms = agg_uniforms
            if uniforms is None:
                n = sum(v[0].numel() for v in stacked.values())
                nb, b = collectives.bucket_shape(n, self.agg_bucket_size)
                uniforms = torch.rand((len(sel_idx), nb, b),
                                      generator=generator,
                                      device=self.device)
            uniforms = torch.as_tensor(uniforms, dtype=torch.float32,
                                       device=self.device)
        new_global = self._aggregate(stacked, weights, uniforms)
        return new_global, stacked, mean_loss, residual

    def _eval_global(self, params: Tree) -> Dict[str, torch.Tensor]:
        """The global model on every client's test shard."""
        d = self.data
        terms = [self.eval_client(params, d.x_test[c], d.y_test[c], n)
                 for c, n in enumerate(self._n_test)]
        correct = torch.stack([t[0] for t in terms])
        loss_sum = torch.stack([t[1] for t in terms])
        total = torch.tensor([t[2] for t in terms], device=self.device)
        acc = correct.to(torch.float32) / torch.clamp(total, min=1)
        return {"acc_per_client": acc, "acc": acc.mean(),
                "loss": loss_sum.sum() / torch.clamp(total.sum(), min=1)}

    def _eval_personal(self, personal: Tree) -> Dict[str, torch.Tensor]:
        """Each client's personal model on its own test shard."""
        d = self.data
        terms = [self.eval_client({k: v[c] for k, v in personal.items()},
                                  d.x_test[c], d.y_test[c], n)
                 for c, n in enumerate(self._n_test)]
        return _personal_metrics(
            torch.stack([t[0] for t in terms]),
            torch.stack([t[1] for t in terms]),
            torch.tensor([t[2] for t in terms], device=self.device))

    @abc.abstractmethod
    def evaluate(self, state: Any) -> Dict[str, Any]:
        """The reference's eval protocol for this algorithm: global and/or
        personal per-client evaluation."""

    # -- driver ----------------------------------------------------------------
    def run(self, comm_rounds: int, eval_every: int = 1, state: Any = None,
            finalize: bool = True):
        """The federated training loop: ``comm_rounds`` rounds, an eval every
        ``eval_every`` rounds, then the algorithm's final pass. Returns
        ``(state, history)``; history values are Python floats.

        Each round's metrics are fetched to the host one round late
        (:class:`utils.records.DeferredRecords`), so the card is never
        idle waiting on the host's conversion; ``round_time_s`` is stamped
        at those flushes, so the sum over the run is its wall time."""
        from ..utils.records import DeferredRecords, to_float

        if state is None:
            state = self.init_state()
        history: List[Dict[str, Any]] = []
        deferred = DeferredRecords(
            log=lambda rec: logger.info(
                "%s round %s: %s", self.name, rec["round"], rec),
            timed=True)
        try:
            for r in range(comm_rounds):
                state, train_metrics = self.run_round(state, r)
                record = {"round": r, **train_metrics}
                if eval_every and (r + 1) % eval_every == 0:
                    ev = self.evaluate(state)
                    record.update({k: v for k, v in ev.items()
                                   if not k.startswith("acc_per")})
                history.append(record)
                deferred.push(record)
        except BaseException:
            deferred.flush_safely()  # emit the last completed round
            raise
        deferred.flush()
        if finalize:
            state, final = self.finalize(state)
            if final is not None:
                record = {k: to_float(v) for k, v in final.items()}
                history.append(record)
                logger.info("%s final: %s", self.name, record)
        return state, history
