"""SalientGrads: SNIP-masked sparse federated training (counterpart of
``neuroimagedisttraining_tpu/algorithms/salientgrads.py``).

1. Before round 0 every client scores SNIP saliency on its own shard; the
   server averages the scores and thresholds one global mask at
   ``dense_ratio`` (the threshold and score-mask kernels on the GPU). With
   ``stratified_sampling`` the scores are class-balanced: "exact" scores
   the train sides of the original's 25 stratified folds, "balanced" 25
   batches of class-balanced draws (``ops/sparsity.py``).
2. Then FedAvg rounds in which every local SGD step re-masks the weights
   (the masked SGD kernel) and the aggregate is the sample-weighted mean,
   through the ``agg_impl`` wire. The sparse wires ("sparse", "topk", the
   "hier" sparse wire) reduce only the mask's live coordinates, by a plan
   built once from the fixed mask; after a "topk" aggregate, or under a
   ``defense`` (whose noise lands on every coordinate), the global model is
   re-masked (the mask-apply kernel).

Each trained client's local weights are kept as its personal model, and the
eval protocol tests the global model and every personal model on each
client's test shard, plus one final eval after the last round.
``track_personal=False`` keeps no personal stack and evaluates the global
model alone; ``snip_mask=False`` is the dense control, an all-ones mask in
place of the SNIP pass; ``eval_cache=True`` keeps the personal eval's
per-client terms in the state (``algorithms/base.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.state import Tree, broadcast_tree, row_sum, zeros_like_tree
from ..core.trainer import make_client_update
from ..data.cifar import crop_flip_draws
from ..ops import kernels
from ..ops.sparsity import (
    balanced_probs,
    make_snip_fold_score_fn,
    make_snip_score_fn,
    mask_density_tensor,
    mask_from_scores,
    stacked_fold_schedules,
)
from .base import FedAlgorithm


@dataclasses.dataclass
class SalientGradsState:
    global_params: Tree
    mask: Tree
    #: [C, ...] per leaf: each client's last locally trained (masked)
    #: weights, initialized to dense copies of the initial global model;
    #: None when ``track_personal`` is off or a client store holds the rows
    personal_params: Optional[Tree]
    #: the round loop's draws (epoch permutations, dropout masks, the int8
    #: wire's uniforms)
    generator: torch.Generator
    #: [C, ...] error-feedback residual of agg_impl="topk", else None. Locals
    #: honor the static mask, so it is zero on dead coordinates.
    agg_residual: Optional[Tree] = None
    #: the personal eval's per-client terms ``{"correct", "loss_sum",
    #: "total"}``, each [C], with ``eval_cache``; else None
    eval_cache: Optional[Dict[str, torch.Tensor]] = None


#: the stratified SNIP's batches per client (the original's n_splits)
STRATIFIED_SPLITS = 25


class SalientGrads(FedAlgorithm):
    name = "salientgrads"
    topk_supported = True
    supports_fused = True
    store_supported = True
    mesh_supported = True

    def __init__(self, *args, dense_ratio: float = 0.5,
                 itersnip_iterations: int = 1, defense=None,
                 snip_mask: bool = True, stratified_sampling: bool = False,
                 stratified_mode: str = "exact",
                 track_personal: bool = True, eval_cache: bool = False,
                 **kwargs):
        # an optional robust.RobustAggregator on the aggregate's copy
        self.defense = defense
        self.stratified_sampling = bool(stratified_sampling)
        if stratified_mode not in ("exact", "balanced"):
            raise ValueError(
                f"stratified_mode {stratified_mode!r} not in "
                "('exact', 'balanced')")
        self.stratified_mode = stratified_mode
        self.dense_ratio = dense_ratio
        self.itersnip_iterations = itersnip_iterations
        # snip_mask=False: all-ones mask, the reference's dense control
        self.snip_mask = snip_mask
        # track_personal=False drops the [C, model] personal stack and the
        # personal half of the eval
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
        #: the exact stratified schedule, ``[C, 25, L]`` row indices and
        #: weights (host arrays), else None
        self._fold_sched = None
        if self.snip_mask and self.stratified_sampling and \
                self.stratified_mode == "exact":
            # every client's labels, on a mesh too (the rank's host copy):
            # the schedule is the single-process one
            d = self.data
            labels = d.y_train if d.y_train_host is None else d.y_train_host
            self._fold_sched = stacked_fold_schedules(
                labels.cpu().numpy(), self._n_train,
                n_splits=STRATIFIED_SPLITS)
            self.snip_fold_scores = make_snip_fold_score_fn(
                self.apply_fn, self.loss_type, augment_fn=self.augment_fn)
        self.snip_scores = make_snip_score_fn(
            self.apply_fn, self.loss_type, self.hp.batch_size,
            stratified=self.stratified_sampling,
            num_classes=self.data.class_num, augment_fn=self.augment_fn)

    def global_mask(self, params: Tree, generator=None,
                    snip_idx=None, snip_augment=None) -> Tree:
        """Every client scores its own shard; mean over clients; global
        top-k. The scoring batches per client: ``itersnip_iterations``
        uniform draws; with ``stratified_sampling`` the 25 fold train sides
        ("exact") or 25 class-balanced draws ("balanced"). ``snip_idx``
        (per client, ``[n_iters, batch]``) replaces the drawn batches and
        ``snip_augment`` (per client, ``[n_iters, 3, batch]``) their
        crop-and-flip draws on an augmented dataset.

        On a client mesh each rank scores its own clients and makes the
        other clients' draws without scoring them (the generator stays the
        single-process run's); the scores are gathered and summed in client
        order, so the mean and the mask are the single-process ones bit for
        bit. The threshold and the score mask then run on every rank."""
        n_iters = (STRATIFIED_SPLITS if self.stratified_sampling
                   else self.itersnip_iterations)
        if self.mesh is not None:
            return mask_from_scores(
                self._mesh_mean_scores(params, generator, snip_idx, n_iters,
                                       snip_augment),
                self.dense_ratio)
        total = None
        for c in range(self.num_clients):
            s = self._client_scores(c, params, generator, snip_idx, n_iters,
                                    snip_augment)
            total = s if total is None else {k: total[k] + s[k] for k in s}
        mean = {k: v / self.num_clients for k, v in total.items()}
        return mask_from_scores(mean, self.dense_ratio)

    def _client_scores(self, c: int, params: Tree, generator, snip_idx,
                       n_iters: int, snip_augment=None) -> Tree:
        """Client ``c``'s SNIP scores on its own shard: the exact
        stratified folds' train sides, else ``n_iters`` batches
        (``snip_idx[c]`` where given, else drawn: uniform, or class-balanced
        with ``stratified_sampling``); on an augmented dataset each batch
        augmented (``snip_augment[c]`` where given, else drawn)."""
        x, y = self._shard(c)
        aug = None if snip_augment is None else snip_augment[c]
        if self._fold_sched is not None:
            idx, w = self._fold_sched
            return self.snip_fold_scores(params, x, y, idx[c], w[c],
                                         rng=generator, augment=aug)
        return self.snip_scores(
            params, x, y, self._n_train[c], n_iters,
            idx=None if snip_idx is None else snip_idx[c], rng=generator,
            augment=aug)

    def _skip_client_draws(self, c: int, params: Tree, generator, snip_idx,
                           n_iters: int, snip_augment=None) -> None:
        """The draws :meth:`_client_scores` of client ``c`` takes from
        ``generator``, made and dropped (a mesh rank that does not hold
        ``c``): per fold its crop-and-flip draws (on an augmented dataset)
        and its dropout masks, at the schedule's batch of rows ("exact");
        else per batch its rows (uniform, or from the class-balanced
        weights of ``c``'s labels, which the rank keeps on the host) unless
        ``snip_idx`` gives them, its crop-and-flip draws unless
        ``snip_augment`` gives them, then its dropout masks."""
        dev = self.device

        def dropout(calls):
            for _, shape, _ in calls:
                torch.rand(shape, generator=generator, device=dev)

        def augment(rows):
            if self.augment_fn is not None and snip_augment is None:
                crop_flip_draws(generator, rows)

        if self._fold_sched is not None:
            rows = self._fold_sched[0].shape[2]
            calls = self._dropout_calls(params, rows)
            for _ in range(STRATIFIED_SPLITS):
                augment(rows)
                dropout(calls)
            return
        calls = self._dropout_calls(params)
        n = self._n_train[c]
        p = None
        if snip_idx is None and self.stratified_sampling:
            p = balanced_probs(self.data.y_train_host[c].to(dev), n,
                               self.data.class_num).to(generator.device)
        for _ in range(n_iters):
            if p is not None:
                torch.multinomial(p, self.hp.batch_size, replacement=True,
                                  generator=generator)
            elif snip_idx is None:
                torch.randint(0, max(n, 1), (self.hp.batch_size,),
                              generator=generator, device=generator.device)
            augment(self.hp.batch_size)
            dropout(calls)

    def _mesh_mean_scores(self, params: Tree, generator, snip_idx,
                          n_iters: int, snip_augment=None) -> Tree:
        """The SNIP mean on a client mesh (:meth:`global_mask`)."""
        mine = []
        for c in range(self.num_clients):
            if self._lo <= c < self._hi:
                mine.append(self._client_scores(c, params, generator,
                                                snip_idx, n_iters,
                                                snip_augment))
            else:
                self._skip_client_draws(c, params, generator, snip_idx,
                                        n_iters, snip_augment)
        keys = list(params)
        sizes = [params[k].numel() for k in keys]
        local = torch.stack([torch.cat([s[k].reshape(-1) for k in keys])
                             for s in mine])
        total = row_sum(self.mesh.all_gather(local).reshape(
            self.num_clients, -1))
        return {k: v.reshape(params[k].shape) / self.num_clients
                for k, v in zip(keys, torch.split(total, sizes))}

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None, snip_idx=None,
                   snip_augment=None) -> SalientGradsState:
        """Fresh parameters (or the given ``params``), the SNIP mask (all
        ones without ``snip_mask``), dense personal copies (none without
        ``track_personal``) and, with ``eval_cache``, the cache seeded by
        one full personal eval. ``generator`` defaults to one seeded by the
        run seed and drives init, SNIP and every later round. With a client
        store the per-client rows are the store's (registered here, the
        fields None in the state)."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        if self.snip_mask:
            mask = self.global_mask(params, g, snip_idx, snip_augment)
        else:
            mask = {k: torch.ones_like(v) for k, v in params.items()}
        if self._store is not None:
            self._store_register_fields(params)
            return SalientGradsState(
                global_params=params, mask=mask, personal_params=None,
                generator=g, eval_cache=self._seed_eval_cache(None, params))
        personal = (broadcast_tree(params, self.num_local_clients)
                    if self.track_personal else None)
        residual = None
        if self.agg_impl == "topk":
            residual = zeros_like_tree(
                broadcast_tree(params, self.num_local_clients))
        return SalientGradsState(
            global_params=params, mask=mask, personal_params=personal,
            generator=g, agg_residual=residual,
            eval_cache=self._seed_eval_cache(personal))

    def _ensure_agg_plan(self, state: SalientGradsState) -> None:
        """Build the sparse wires' gather plan from the concrete mask, once:
        the SNIP mask is fixed for the run, which is why SalientGrads can
        run "sparse", the compressed "topk" selection and the "hier" sparse
        wire."""
        needs_plan = self.agg_impl in ("sparse", "topk") or (
            self.agg_impl == "hier" and self.agg_hier_wire == "sparse")
        if needs_plan and self._agg_sparse_plan is None:
            from ..parallel.collectives import build_sparse_plan

            self._agg_sparse_plan = build_sparse_plan(state.mask)

    def _prepare_round(self, state: SalientGradsState) -> None:
        self._ensure_agg_plan(state)

    def _round_mask(self, state: SalientGradsState) -> Tree:
        return state.mask

    def _post_aggregate(self, new_global: Tree,
                        state: SalientGradsState) -> Tree:
        if self.defense is not None or self.agg_impl == "topk":
            # weak-DP noise lands on every coordinate, and the top-k delta
            # update leaves round 0's dense init on dead ones: re-mask so
            # the global model keeps the SNIP sparsity (p * m, bit-equal to
            # the reference's either backend)
            return kernels.fused_mask_apply(new_global, state.mask)
        return new_global

    def finalize(self, state: SalientGradsState):
        """One final global (and personal) eval after the last round."""
        ev = self.evaluate(state)
        return state, {"round": -1, **{k: v for k, v in ev.items()
                                       if not k.startswith("acc_per")}}

    def evaluate(self, state: SalientGradsState) -> Dict[str, Any]:
        ev = self._eval_global(state.global_params)
        out = {
            "global_acc": ev["acc"],
            "global_loss": ev["loss"],
            "mask_density": mask_density_tensor(state.mask),
            "acc_per_client": ev["acc_per_client"],
        }
        if state.personal_params is not None or self._store_has_personal():
            evp = self._eval_personal_state(state)
            out.update(personal_acc=evp["acc"], personal_loss=evp["loss"])
        return out
