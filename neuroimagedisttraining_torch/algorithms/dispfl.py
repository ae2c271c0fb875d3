"""DisPFL: decentralized sparse personalized federated learning (counterpart
of ``neuroimagedisttraining_tpu/algorithms/dispfl.py``).

* Each client holds a random binary mask at ERK-allocated (or uniform)
  per-layer sparsities, one shared initial mask or one per client
  (``different_initial``; ``diff_spa`` cycles the clients' dense ratios
  0.2 ... 1.0), and a sparse personal model.
* Each round: the clients flip their participation coins (``active``,
  numpy seeded by the round), choose neighbors (random, ring or full,
  ``parallel/topology.py``), and each active client takes the
  mask-count-weighted average of its neighbors' sparse models under its own
  mask (two adjacency contractions, :func:`core.state.mix_over_clients`);
  an inactive client keeps its own model. Every client then trains with
  masked gradients (the masked SGD kernel's ``mask_grads`` branch) and
  evolves its mask: fire the cosine-annealed fraction of its smallest live
  weights, regrow as many dead ones by the magnitude of one dense screening
  gradient (uniform scores with ``dis_gradient_check``), and re-mask.
* With ``record_local_tests`` every client's model is tested on its own
  test shard before and after local training ("new mask" and "old mask"
  series: means of the per-client ratios).

On a client mesh each rank holds its block of the models and the masks:
every rank gathers both stacks whole, contracts the whole ``[C, C]``
adjacency against them (the single process's products) and keeps its
block; it trains, screens and evolves its own clients (reading its rows of
the round's regrow scores), and the per-client terms of the train loss,
the mask change and the local tests are gathered, so every metric is the
single process's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.losses import make_loss_fn
from ..core.state import Tree, broadcast_tree, mix_over_clients
from ..core.trainer import make_client_update
from ..ops.sparsity import (
    cosine_annealing,
    erk_sparsities,
    fire_mask,
    fraction_f32,
    kernel_flags,
    live_counts,
    param_shapes,
    random_masks_from_sparsities,
    regrow_mask,
    uniform_sparsities,
)
from ..parallel.topology import neighbor_adjacency
from .base import PersonalAlgorithm, RoundInputs


@dataclasses.dataclass
class DisPFLState:
    #: [C, ...] per leaf: each client's sparse personal model
    personal_params: Tree
    #: [C, ...] per leaf: each client's binary mask
    masks: Tree
    #: the round loop's draws (epoch permutations, dropout masks, the
    #: screening batches, the regrow scores)
    generator: torch.Generator


#: the dense ratios ``diff_spa`` cycles over the clients
DIFF_SPA_RATIOS = (0.2, 0.4, 0.6, 0.8, 1.0)


class DisPFL(PersonalAlgorithm):
    name = "dispfl"
    supports_fused = True
    mesh_supported = True
    row_fields = ("personal_params", "masks")

    def __init__(self, *args, dense_ratio: float = 0.5,
                 anneal_factor: float = 0.5, neighbor_mode: str = "random",
                 active: float = 1.0, static_masks: bool = False,
                 total_rounds: int = 100, erk_power_scale: float = 1.0,
                 sparsity_distribution: str = "erk",
                 different_initial: bool = False, diff_spa: bool = False,
                 dis_gradient_check: bool = False,
                 record_local_tests: bool = True, **kwargs):
        """``sparsity_distribution`` "erk" or "uniform"; ``different_initial``
        draws each client's initial mask apart (one shared mask by
        default); ``diff_spa`` cycles the clients' dense ratios (and implies
        ``different_initial``); ``static_masks`` freezes the masks;
        ``dis_gradient_check`` regrows uniformly at random among the dead
        weights (no screening batch); ``record_local_tests`` runs the two
        per-round local tests."""
        if sparsity_distribution not in ("erk", "uniform"):
            raise ValueError(
                f"sparsity_distribution {sparsity_distribution!r} not in "
                "('erk', 'uniform')")
        self.dense_ratio = dense_ratio
        self.anneal_factor = anneal_factor
        self.neighbor_mode = neighbor_mode
        self.active = active
        self.static_masks = static_masks
        self.masks_evolve = not static_masks
        self.total_rounds = total_rounds
        self.erk_power_scale = erk_power_scale
        self.sparsity_distribution = sparsity_distribution
        self.different_initial = different_initial or diff_spa
        self.diff_spa = diff_spa
        self.dis_gradient_check = dis_gradient_check
        self.record_local_tests = record_local_tests
        super().__init__(*args, **kwargs)

    @property
    def _round_metric_names(self):
        names = ("train_loss", "mask_change")
        if self.record_local_tests:
            names += ("new_mask_test_acc", "new_mask_test_loss",
                      "old_mask_test_acc", "old_mask_test_loss")
        return names

    def cost_trained_clients_per_round(self) -> int:
        # inactive clients skip only the aggregation; every client trains
        return self.num_clients

    def _build(self) -> None:
        self.client_update = make_client_update(
            self.apply_fn, self.loss_type, self.hp,
            augment_fn=self.augment_fn,
            full_batches=self._full_batches(), remat=self.remat_local,
            mask_grads=True)
        self._loss_fn = make_loss_fn(self.loss_type)
        self._draws_screen = not self.static_masks and \
            not self.dis_gradient_check
        self._draws_regrow = not self.static_masks and \
            self.dis_gradient_check

    # -- state -----------------------------------------------------------------
    def _client_sparsities(self, shapes, client: int) -> Dict[str, float]:
        ratio = self.dense_ratio
        if self.diff_spa:
            ratio = DIFF_SPA_RATIOS[client % len(DIFF_SPA_RATIOS)]
        if self.sparsity_distribution == "uniform":
            return uniform_sparsities(shapes, ratio)
        return erk_sparsities(shapes, ratio, self.erk_power_scale)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[Tree] = None,
                   masks: Optional[Tree] = None) -> DisPFLState:
        """Fresh parameters (or the given ``params``), the initial masks
        (drawn from ``generator``, or the given stacked ``masks``, ``[C,
        ...]`` per leaf), and each client's model masked by its own.
        ``generator`` defaults to one seeded by the run seed and drives init
        and every later round. On a client mesh every rank draws every
        client's mask and keeps its block."""
        g = generator if generator is not None else self.generator()
        params = self._fresh_params(g, params)
        if masks is None:
            shapes = param_shapes(params)
            if self.different_initial:
                rows = [random_masks_from_sparsities(
                    params, lambda n, s, sp=self._client_sparsities(
                        shapes, c): sp[n], g)
                    for c in range(self.num_clients)]
                masks = {k: torch.stack([r[k] for r in rows])
                         for k in params}
            else:
                sp = self._client_sparsities(shapes, 0)
                masks = broadcast_tree(random_masks_from_sparsities(
                    params, lambda n, s: sp[n], g), self.num_clients)
        masks = {k: torch.as_tensor(v).to(self.device, torch.float32)
                 for k, v in self._block(masks).items()}
        personal = {k: v * masks[k] for k, v in
                    broadcast_tree(params, self.num_local_clients).items()}
        return DisPFLState(personal_params=personal, masks=masks,
                           generator=g)

    # -- the round -------------------------------------------------------------
    def _selected_client_indexes(self, round_idx: int) -> np.ndarray:
        return np.arange(self.num_clients, dtype=np.int32)

    def _host_inputs(self, round_idx):
        """The participation coins (numpy seeded by the round), then the
        neighbor matrix (which seeds its own generator by the round), in
        the reference's order; and the fire rate."""
        np.random.seed(round_idx)
        active = np.random.choice([0, 1], size=self.num_clients,
                                  p=[1.0 - self.active, self.active])
        out = {"adjacency": neighbor_adjacency(
                   round_idx, self.num_clients, self.clients_per_round,
                   mode=self.neighbor_mode, active=active),
               "active": active > 0}
        if self.masks_evolve:
            out["anneal_rate"] = cosine_annealing(
                self.anneal_factor, round_idx, self.total_rounds)
        return out

    def _aggregate_neighbors(self, state: DisPFLState,
                             inp: RoundInputs) -> Tree:
        """Each active client's mask-count-weighted average of its
        neighbors' models under its own mask; an inactive client's own
        model (the rank's block on a client mesh, from the contractions of
        the gathered stacks)."""
        params, masks = state.personal_params, state.masks
        counts = self._block(mix_over_clients(inp.adjacency,
                                              self._whole(masks)))
        sums = self._block(mix_over_clients(inp.adjacency,
                                            self._whole(params)))
        active = self._block(inp.active)
        out = {}
        for k, p in params.items():
            c = counts[k]
            inv = torch.where(c != 0, 1.0 / torch.clamp(c, min=1e-9),
                              torch.zeros_like(c))
            agg = sums[k] * inv * masks[k]
            act = active.reshape((-1,) + (1,) * (p.dim() - 1))
            out[k] = torch.where(act, agg, p)
        return out

    def _screen_gradients(self, trained: Tree, inp: RoundInputs) -> Tree:
        """Each client's gradient of one dense batch (its screening rows,
        augmented as training batches are, and its dropout masks) at its
        trained model, stacked (the clients this
        rank trains, :meth:`_own`)."""
        d = self.data
        own, sel = self._own(inp)
        rows = []
        for j, i in enumerate(own):
            names = list(trained)
            leaves = [trained[k][j].detach().requires_grad_(True)
                      for k in names]
            idx = inp.screen_idx[i]
            client = sel[j:j + 1]
            xb, yb = d.x_train[client, idx], d.y_train[client, idx]
            if self.augment_fn is not None:
                xb = self.augment_fn(xb, inp.screen_augment[i])
            drop = (None if inp.screen_dropout is None
                    else inp.screen_dropout[i])
            loss = self._loss_fn(self.apply_fn(
                dict(zip(names, leaves)), xb, train=True, rng=drop), yb)
            rows.append(dict(zip(names, torch.autograd.grad(loss, leaves))))
        return {k: torch.stack([r[k] for r in rows]) for k in trained}

    def _evolve_masks(self, masks: Tree, trained: Tree,
                      inp: RoundInputs) -> Tree:
        """Fire at the round's rate, then regrow as many weights per client
        and leaf, by screening-gradient magnitude or the uniform scores."""
        scores = (self._own_draws(inp.regrow_u, inp)
                  if self.dis_gradient_check
                  else self._screen_gradients(trained, inp))
        before = live_counts(masks, lead=1)
        fired = fire_mask(masks, trained, inp.anneal_rate, lead=1)
        after = live_counts(fired, lead=1)
        return regrow_mask(fired, scores,
                           {k: before[k] - after[k] for k in masks}, lead=1)

    def _round_body(self, state: DisPFLState, inp: RoundInputs):
        masks = state.masks
        w_local = self._aggregate_neighbors(state, inp)
        metrics: Dict[str, torch.Tensor] = {}
        if self.record_local_tests:
            pre = self._local_test(w_local)
            metrics.update(new_mask_test_acc=pre["acc"],
                           new_mask_test_loss=pre["loss"])
        trained, _, losses = self._train_stacked(self.client_update,
                                                 w_local, masks, inp)
        if self.record_local_tests:
            post = self._local_test(trained)
            metrics.update(old_mask_test_acc=post["acc"],
                           old_mask_test_loss=post["loss"])
        new_masks = masks
        if not self.static_masks:
            new_masks = self._evolve_masks(masks, trained, inp)
            trained = {k: v * new_masks[k] for k, v in trained.items()}
        metrics.update(
            train_loss=self._gather_own(losses, inp).mean(),
            mask_change=fraction_f32(
                self._gather_own(_changed_counts(masks, new_masks),
                                 inp).sum(),
                _kernel_size(masks) * self.num_clients))
        return dataclasses.replace(state, personal_params=trained,
                                   masks=new_masks), \
            {k: metrics[k] for k in self._round_metric_names}

    # -- eval ------------------------------------------------------------------
    def evaluate(self, state: DisPFLState) -> Dict[str, Any]:
        ev = self._eval_personal(state.personal_params)
        return {"personal_acc": ev["acc"], "personal_loss": ev["loss"],
                "mean_mask_density": self._mean_mask_density(state.masks),
                "acc_per_client": ev["acc_per_client"]}

    def mask_distance_matrix(self, state: DisPFLState) -> np.ndarray:
        """The pairwise hamming fractions of the clients' masks over the
        kernel leaves, ``[C, C]`` float32 (the original's end-of-run
        diagnostic; on a client mesh of the masks gathered whole, on every
        rank)."""
        masks = self._whole(state.masks)
        flags = kernel_flags(masks)
        live = torch.cat([(m != 0).reshape(m.shape[0], -1)
                          for k, m in masks.items() if flags[k]], dim=1)
        n = live.shape[1]
        rows = [fraction_f32((live[i][None] != live).sum(dim=1), n)
                for i in range(live.shape[0])]
        return torch.stack(rows).cpu().numpy()


def _changed_counts(masks_a: Tree, masks_b: Tree) -> torch.Tensor:
    """Per client (row), the kernel-leaf coordinates whose liveness changed
    (int64; non-kernel leaves never evolve): the mask change is their sum
    over the cohort over its kernel size."""
    flags = kernel_flags(masks_a)
    return sum(((masks_a[k] != 0) != (masks_b[k] != 0))
               .reshape(masks_a[k].shape[0], -1).sum(dim=1)
               for k in masks_a if flags[k])


def _kernel_size(masks: Tree) -> int:
    """One client's kernel-leaf coordinates."""
    flags = kernel_flags(masks)
    return sum(m[0].numel() for k, m in masks.items() if flags[k])
