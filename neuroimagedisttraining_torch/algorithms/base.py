"""The federated round skeleton shared by the algorithms (counterpart of
``neuroimagedisttraining_tpu/algorithms/base.py``, the parts the ported
algorithms run).

Where the reference vmaps the cohort inside one compiled program, this loops
over the selected clients: in the central round each trains a copy of the
global model on its own shard, and the server takes the sample-weighted mean
of the local models, routed by ``agg_impl`` through the aggregation wires
(``parallel/collectives.py``) off the mesh; the personalized and
decentralized algorithms train each client's own row of a stacked model
(:meth:`FedAlgorithm._train_stacked`).

On a client mesh (``data`` sharded by ``parallel.mesh.shard_federated``:
one process a device, each holding its block of the cohort and of every
per-client row field of the state, :attr:`FedAlgorithm.row_fields`) every
rank makes the round's host draws for all selected clients, exactly as off
the mesh, and trains the selected clients it holds (:meth:`FedAlgorithm.
_own`); the central aggregate is the on-mesh reduce of ``collectives``,
over the rows of the selection's rank blocks (with partial participation
the trained models are gathered first, in selection order), and the eval's
per-client sums are gathered in client order (the ``eval_clients``
subset's in its order). An exchange between clients gathers the rows every
client needs, in draw order, and every rank computes on the gathered rows
what the single process computes: DPSGD's and DisPFL's gossip contracts the
whole ``[C, C]`` matrix against the gathered stacks and keeps the rank's
block, SubAvg averages the gathered trained rows over the gathered masks,
FedFomo's clients score the gathered models, TurboAggregate's secure sum
shares the gathered rows in draw order.
The in-state eval cache refreshes each rank's trained rows and gathers their
terms into the replicated ``[C]`` cache. Each client's trained model and
eval sums are the off-mesh run's bit for bit; only the cross-rank sums
reassociate. The robustness tier runs there too: each rank injects the
faults into, and defends, its own rows (reading its rows of the round's
``[S, ...]`` draws), the guard's survivor flags are gathered in draw order
so every rank renormalizes the ``[S]`` weights alike, and a ``robust_agg``
statistic reads every client's wire-decoded delta, gathered in draw order,
so the robust global model is the off-mesh one bit for bit. A checkpoint
holds the state in the single-process layout (:meth:`FedAlgorithm.
state_to_global`, :meth:`FedAlgorithm.state_to_local`), so a step resumes
at any mesh width. With a client store each rank's store holds the rows of
its own block of clients and its host data that block's volumes: a
streamed mesh round is the resident mesh round on a slab of the sampled
clients the rank holds, with the same exchanges.

A round is split in two: what the host decides (the seeded client draw, the
decayed learning rate, the random draws of the generator) and a body that
reads only tensors (:meth:`FedAlgorithm._round_body`). The fused round loop
(:meth:`FedAlgorithm.run_rounds_fused`, the reference's K-round ``lax.scan``)
keeps the body's inputs and the state in buffers that stay put and, on the
card, replays the body from a captured CUDA graph, one replay per round: no
Python between the kernels of a round. On a client mesh over NCCL the graph
holds the round's collectives too (the loss gather, the reduce of each leaf
group, the gather of the trained rows), as the reference's one program
holds its ``psum``; over gloo on the CPU the body runs as it is.

The robustness tier rides the same body: the ``fault_spec`` injector after
local training (its draws keyed by run seed, round and population client id,
``robust/faults.py``), the clip and weak-DP defenses, the guard's
quarantine (``robust/guard.py``, always the select spelling, so a clean
guarded round is bitwise the unguarded one and a graph can hold it) and the
``robust_agg`` estimators (``robust/aggregation.py``) in place of the
weighted mean.
"""
from __future__ import annotations

import abc
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import capture
from ..core.client_store import STORE_MODES, ClientStore
from ..core.state import (
    HyperParams,
    Tree,
    clone_generator,
    clone_tree,
    tree_index,
    tree_scatter_update,
)
from ..core.trainer import (
    active_steps,
    epoch_permutations,
    make_eval_fn,
    replacement_batches,
    round_lr,
)
from ..data.cifar import DRAW_ROWS, CropFlip, crop_flip_draws
from ..data.types import FederatedData
from ..models import init_params, make_apply_fn
from ..models.layers import DropoutProbe
from ..obs import trace as obs_trace
from ..ops import kernels
from ..ops.sparsity import (
    client_mask_densities,
    fraction_f32,
    kernel_flags,
    mean_mask_density,
)
from ..parallel import collectives
from ..parallel.mesh import (
    gather_blocks,
    gather_flags,
    gather_index,
    gather_rows,
    mesh_of,
)
from ..robust import guard as _guard
from ..robust.aggregation import ROBUST_AGGS, robust_combine_mat
from ..robust.faults import (
    DRAW_COLUMNS,
    labelflip_flags,
    make_fault_fn,
    make_labelflip_fn,
    parse_fault_spec,
)

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
                          client_num_per_round: int,
                          retry: int = 0) -> np.ndarray:
    """Per-round client sampling with numpy reseeded by the round index, so
    every algorithm (and the reference) draws the same subsets; full
    participation is ``arange``. ``retry`` > 0 re-samples the cohort for a
    watchdog retry, a pure function of (round, retry): the seed strides by
    the golden ratio, clear of every round index a run reaches."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int32)
    if retry:
        np.random.seed((round_idx + 0x9E3779B1 * retry) % (2 ** 32))
    else:
        np.random.seed(round_idx)
    return np.random.choice(range(client_num_in_total), client_num_per_round,
                            replace=False).astype(np.int32)


class FusedMetrics:
    """A fused block's per-round metric series, fetched lazily in ONE host
    transfer: the block's packed float64 stack, one row per series, which
    the card fills after each round (zeros on a round without eval). Until
    materialized, holding it costs nothing; the block loop dispatches the
    next block first, then materializes the previous one."""

    def __init__(self, names: Sequence[str], eval_names: Sequence[str],
                 packed: torch.Tensor):
        self._names, self._eval_names = list(names), list(eval_names)
        self._packed = packed
        self._host: Optional[Dict[str, Any]] = None

    def materialize(self) -> Dict[str, Any]:
        """``{name: [K] array}`` for each round metric, and under ``eval``
        the same for each eval metric; waits for the block to finish."""
        if self._host is None:
            vals = self._packed.cpu().numpy()  # one transfer for the block
            n = len(self._names)
            self._host = {k: vals[i] for i, k in enumerate(self._names)}
            if self._eval_names:
                self._host["eval"] = {k: vals[n + j] for j, k in
                                      enumerate(self._eval_names)}
            self._packed = None  # free the device stack
        return self._host

    def __getitem__(self, key):
        return self.materialize()[key]

    def __contains__(self, key):
        return key in self.materialize()


@dataclasses.dataclass
class RoundInputs:
    """What a round's body reads besides the state (:meth:`FedAlgorithm.
    _round_body`), per selected client in draw order, made by
    :meth:`FedAlgorithm._round_inputs`.

    ``n_valid`` (host ints) fixes the steps each client runs (through
    ``core.trainer.active_steps`` alone: the fused loop keys a round graph
    by those, :meth:`FedAlgorithm._step_key`). The rest is on the device:
    ``sel`` the rows of the clients in the arrays the body reads (int64;
    the client ids when the rows are resident), ``n_sel`` their sample
    counts (f32: the aggregate's weights and the loss masks read them),
    ``lr`` the round's rate (0-d f32),
    ``perms`` the epoch permutations ``[S, epochs, steps_per_epoch *
    batch]`` (under replacement batching, the with-replacement batch
    indices in the same layout), ``augment`` per client and local step the
    crop-and-flip draws of an augmented dataset (``[S, local_steps, 3,
    batch]``, ``data.cifar.crop_flip_draws``; a step the client does not
    run holds zeros; None without augmentation), ``dropout`` per client
    and local step the dropout keep masks by slot (None for a step the
    client does not run; None for a model without dropout), ``uniforms``
    the int8 wire's ``[S,
    nb, b]`` draw (None where no int8 wire runs), ``faults`` the fault
    injector's ``[S, 8]`` draws (``robust.faults.DRAW_COLUMNS``),
    ``collude`` the colluders' direction tree and ``dp_noise`` the weak-DP
    defense's ``[S, ...]`` standard-normal tree (each None when unused).

    The personalized and decentralized algorithms' inputs (None where
    unused): ``perms_2`` / ``augment_2`` / ``dropout_2`` a second training
    leg's draws, laid out as ``perms`` / ``augment`` / ``dropout`` (SubAvg's
    later epochs, Ditto's personal leg); ``screen_idx`` (``[S, batch]`` row
    indices), ``screen_augment`` (``[S, 3, batch]``) and ``screen_dropout``
    (per client, keep masks by slot) DisPFL's screening batch;
    ``regrow_u`` DisPFL's ``[S, ...]`` uniform regrow scores per kernel
    leaf under ``dis_gradient_check``; and the host inputs of the
    round, a pure function of its index (:meth:`FedAlgorithm.
    _host_inputs`): ``adjacency`` the ``[C, C]`` float32 neighbor matrix
    (DisPFL, DPSGD), ``active`` DisPFL's ``[C]`` participation flags and
    ``anneal_rate`` its 0-d float32 fire rate.

    With a client store (``client_store`` "host" or "disk") the per-client
    rows and the cohort's data are a slab: ``slab`` holds the data rows
    (``x_train``/``y_train``, with the eval cache ``x_test``/``y_test``)
    and ``sel`` the clients' positions in it and in the state's row slabs,
    while ``pop`` holds their population ids, which the ``[C]`` arrays
    that stay resident (the eval cache, the test counts) are indexed by.
    Resident, ``pop`` is ``sel`` and ``slab`` None (the body reads
    ``algo.data``). On a client mesh a rank's slab holds the selected
    clients it holds, and ``mesh_rows.rows`` their positions in it.

    On a client mesh ``mesh_rows`` says which of the selected clients this
    rank trains (:class:`MeshRows`); None off the mesh."""

    n_valid: List[int]
    sel: torch.Tensor
    n_sel: torch.Tensor
    lr: torch.Tensor
    perms: torch.Tensor
    dropout: Optional[List[List[Optional[List[torch.Tensor]]]]] = None
    augment: Optional[torch.Tensor] = None
    uniforms: Optional[torch.Tensor] = None
    faults: Optional[torch.Tensor] = None
    collude: Optional[Tree] = None
    dp_noise: Optional[Tree] = None
    perms_2: Optional[torch.Tensor] = None
    dropout_2: Optional[List[List[Optional[List[torch.Tensor]]]]] = None
    augment_2: Optional[torch.Tensor] = None
    screen_idx: Optional[torch.Tensor] = None
    screen_dropout: Optional[List[Optional[List[torch.Tensor]]]] = None
    screen_augment: Optional[torch.Tensor] = None
    regrow_u: Optional[Tree] = None
    adjacency: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None
    anneal_rate: Optional[torch.Tensor] = None
    pop: Optional[torch.Tensor] = None
    slab: Optional[FederatedData] = None
    mesh_rows: Optional["MeshRows"] = None


class MeshRows(NamedTuple):
    """A round's selected clients as the ranks of a client mesh hold them.
    ``own``: the positions in the draw of the clients this rank holds (and
    trains); ``rows``: their rows in the rank's data and per-client stacks
    (in store mode their positions in the rank's slab; int64, on the
    device); ``counts``: how many each rank holds; ``order``: per position
    in the draw, ``(rank, index among that rank's own)``, the gather's
    order; ``gather_idx``: the gather's row index on
    the device (:func:`~..parallel.mesh.gather_index`), made with the rest
    on the host side of the round; ``own_idx``: ``own`` on the device (the
    rank's rows of the round's ``[S, ...]`` draws are read through it);
    ``uniforms``: the on-mesh int8 wire's
    draw ``(rank or slice, payload leaf, shape) -> [nb, b]`` (None where
    the round does not aggregate)."""

    own: List[int]
    rows: torch.Tensor
    counts: List[int]
    order: List[tuple]
    gather_idx: torch.Tensor
    own_idx: torch.Tensor
    uniforms: Optional[Callable] = None


def mesh_wire_uniforms(seed: int, round_idx: int, device: torch.device
                       ) -> Callable:
    """The on-mesh int8 wire's uniforms of round ``round_idx``: for rank (or
    slice) ``wid`` and payload leaf ``i``, ``[nb, b]`` standard uniforms from
    a generator seeded by ``(seed, round, wid, i)`` alone, so every rank of a
    slice draws the same and no draw touches the round's generator."""
    def draw(wid: int, i: int, shape) -> torch.Tensor:
        key = np.random.SeedSequence(
            [int(seed) % 2 ** 32, int(round_idx) % 2 ** 32, int(wid),
             int(i)]).generate_state(2, np.uint32)
        g = torch.Generator(device=device).manual_seed(
            int(key[0]) << 32 | int(key[1]))
        return torch.rand(tuple(shape), generator=g, device=device)

    return draw


class MeshUniformBuffers:
    """The on-mesh int8 wire's uniforms as a fused block's round graph reads
    them: one buffer per ``(rank or slice, payload leaf, shape)`` the reduce
    asks for, rewritten before each round with that round's draw
    (:meth:`set_round`, from :func:`mesh_wire_uniforms`), so a replay reads
    the values the eager round draws. A key is first met in a warm-up run,
    outside the capture, which allocates its buffer."""

    def __init__(self):
        self.bufs: Dict[tuple, torch.Tensor] = {}
        self._draw: Optional[Callable] = None

    def set_round(self, draw: Callable) -> None:
        """Every buffer overwritten with ``draw``'s values (on the stream,
        before the round's replay)."""
        self._draw = draw
        for (wid, i, shape), buf in self.bufs.items():
            buf.copy_(draw(wid, i, shape))

    def __call__(self, wid: int, i: int, shape) -> torch.Tensor:
        key = (int(wid), int(i), tuple(int(n) for n in shape))
        buf = self.bufs.get(key)
        if buf is None:
            buf = self.bufs[key] = self._draw(*key)
        return buf


#: runs of a body on a side stream before its capture: they set up cuDNN,
#: cuBLAS, autograd and the kernels' launch attributes outside the graph
FUSED_WARMUPS = 2

#: the stream every graph's warm-ups and capture run on, one per device:
#: cuBLAS keeps a workspace per stream for good, so a stream per graph
#: would leave one behind at each capture
_CAPTURE_STREAMS: Dict[torch.device, Any] = {}


class _Graph:
    """``fn(warm)`` replayed from a CUDA graph on the card (after
    FUSED_WARMUPS runs of ``fn(warm=True)`` on a side stream, then the
    capture of ``fn(warm=False)`` on the same stream, in segments at its
    local steps' boundaries: ``core.capture.SegmentedGraph``), or called as
    is on the CPU. Calling it returns ``fn``'s output; on the card that is the
    captured output, which each replay rewrites in place. ``launches``: the
    kernel launches one replay makes, added to ``kernels.LAUNCHES`` per
    replay. The warm-ups and the capture are reported to a live obs
    session (``obs.compile``, ``graph_capture``, with the chain's nodes).

    An error of a warm-up run propagates as it is; an error of the capture
    itself is raised as ``ValueError`` naming ``what``."""

    def __init__(self, fn: Callable, device: torch.device, what: str):
        self.fn, self.launches = fn, {}
        self.graph = self.out = None
        if device.type != "cuda":
            return
        t0 = time.perf_counter()
        caller = torch.cuda.current_stream(device)
        side = _CAPTURE_STREAMS.get(device)
        if side is None:
            side = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            for _ in range(FUSED_WARMUPS):
                fn(warm=True)
        caller.wait_stream(side)
        before = kernels.snapshot_launches()
        try:
            graph = capture.SegmentedGraph(lambda: fn(warm=False), side)
        except RuntimeError as e:
            # a failed capture can leave its stream current
            torch.cuda.set_stream(caller)
            raise ValueError(f"{what} cannot be captured in a CUDA graph: "
                             f"{e}") from e
        finally:
            # a capture queues no work: take back what its wrappers
            # counted, and add it at each replay
            after = kernels.snapshot_launches()
            captured = {k: after[k] - n for k, n in before.items()}
            kernels.restore_launches(before)
        self.graph, self.out = graph, graph.out
        self.launches = {k: n for k, n in captured.items() if n}
        from ..obs.compile import note_compile

        note_compile("graph_capture", time.perf_counter() - t0,
                     nodes=sum(n or 0 for n in graph.nodes), what=what)

    def __call__(self):
        if self.graph is None:
            return self.fn(warm=False)
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.out

    def release(self) -> None:
        """Drop the graph, its output and its private memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.fn = self.graph = self.out = None


def _is_buffer(v) -> bool:
    return isinstance(v, (torch.Tensor, dict))


def _copy_into(dst, src) -> None:
    """``dst`` (a tensor or tree of tensors) overwritten with ``src``'s
    values, leaf by leaf; a leaf that already is its destination is left."""
    if isinstance(dst, dict):
        for k, t in dst.items():
            _copy_into(t, src[k])
    elif src is not dst:
        dst.copy_(src)


def _copy_masks(buf: Sequence[Optional[torch.Tensor]], keep) -> None:
    """One forward's keep masks by slot copied into ``buf``'s (``keep``
    None: a step the client does not run, whose buffers stay)."""
    for b, k in zip(buf, keep or ()):
        if b is not None:
            b.copy_(k)


#: the :class:`RoundInputs` fields the host computes from the round index
#: alone (:meth:`FedAlgorithm._host_inputs`)
_HOST_FIELDS = ("adjacency", "active", "anneal_rate")


def _buffer_fields(state: Any) -> List[str]:
    """The fields of ``state`` that hold a tensor or a tree of tensors."""
    return [f.name for f in dataclasses.fields(state)
            if _is_buffer(getattr(state, f.name))]


def _clone(v):
    return clone_tree(v) if isinstance(v, dict) else v.clone()


def _row(tree: Tree, i: int) -> Tree:
    """Row ``i`` of a stacked tree (views)."""
    return {k: v[i] for k, v in tree.items()}


def _stack(rows: Sequence[Tree]) -> Tree:
    """Trees of one client each, stacked along a new leading axis."""
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A stacked leaf as ``[C, n]``."""
    return t.reshape(t.shape[0], -1)


def _map_field(fn: Callable, v):
    """``fn`` of each leaf of a state field that is a tree, or of the field
    itself where it is a tensor."""
    return {k: fn(t) for k, t in v.items()} if isinstance(v, dict) else fn(v)


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting on the card (through
    pinned memory, for a copy the stream orders)."""
    t = torch.as_tensor(x)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


#: round graphs a fused loop keeps, one per step-count key: past this, the
#: least recently replayed one is released (its memory pool with it)
FUSED_MAX_GRAPHS = 4


class _FusedRounds:
    """What an algorithm's fused blocks run in (:meth:`FedAlgorithm.
    run_rounds_fused`): buffers that stay put, and the graphs that read
    them.

    * ``state``: the state with every tensor and tree of tensors replaced
      by a buffer of its own; a block copies its input state in and clones
      its output state out, so no caller ever holds a buffer.
    * the host inputs of a round (:class:`RoundInputs`): the client ids,
      the learning rate, the epoch permutations (or replacement batches),
      the crop-and-flip draws and the dropout keep masks of every client
      and step, the int8 wire's
      uniforms, the fault draws, the colluders' direction and the weak-DP
      noise; a second leg's permutations and keep masks, DisPFL's
      screening rows and keep masks and its regrow scores; the round's
      pure-host inputs (the neighbor ``adjacency``, DisPFL's ``active``
      flags and ``anneal_rate``), each allocated only where the algorithm
      draws it and rewritten on the card before each round
      (:meth:`write`);
    * a round graph per step-count key (per selected client the batches a
      local epoch runs, :meth:`FedAlgorithm._step_key`: one key at full
      participation, with equal shards, or with unequal ones whose step
      counts agree), at most FUSED_MAX_GRAPHS of them, and one eval graph.
      The sample counts themselves, which set the aggregate's weights and
      the loss masks, are a buffer (``n_sel``) like the client ids.
    * on a client mesh, a round graph's key also holds how the ranks hold
      the draw (:class:`MeshRows`' ``counts`` and ``order``: the same every
      round at full participation, a new key for each new spread at partial
      participation); each key keeps its own buffer of the rank's rows and
      its gather index, and the int8 wire's uniforms are buffers
      (:class:`MeshUniformBuffers`) rewritten before each round. Every rank
      computes the same keys from the same host draws, so every rank warms
      up, captures and evicts in the same rounds.

    ``n_sel`` is the number of clients a round draws (the whole cohort
    for the algorithms that train every client). ``width`` > 0 is the
    client-store mode (:meth:`FedAlgorithm._run_rounds_fused_store`): the
    state's store fields (the personal stack, the top-k residual) and the
    cohort's data (``slab``) are buffers of ``width`` rows, a block's union
    of clients in the first rows and the rest unread, so one graph serves
    every block whatever its union's size; ``pop`` holds the round's
    population ids."""

    def __init__(self, algo: "FedAlgorithm", state: Any, n_sel: int,
                 width: int = 0):
        dev, hp = algo.device, algo.hp
        s = n_sel
        params = algo._template(state)
        self.width = width
        self.store_fields: List[str] = []
        if width:
            self.store_fields = list(algo._store.field_names())
            state = dataclasses.replace(state, **{
                f: {k: torch.zeros((width,) + tuple(v.shape), dtype=v.dtype,
                                   device=dev) for k, v in params.items()}
                for f in self.store_fields})
        self.fields = _buffer_fields(state)
        self.state = dataclasses.replace(state, **{
            f: _clone(getattr(state, f)) for f in self.fields})
        self.sel = torch.zeros(s, dtype=torch.int64, device=dev)
        self.n_sel = torch.zeros(s, dtype=torch.float32, device=dev)
        self.pop, self.slab = self.sel, None
        if width:
            self.pop = torch.zeros(s, dtype=torch.int64, device=dev)
            d = algo.data

            def rows(t):
                return torch.empty((width,) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device=dev)

            test = algo.eval_cache
            self.slab = dataclasses.replace(
                d, x_train=rows(d.x_train), y_train=rows(d.y_train),
                x_test=rows(d.x_test) if test else None,
                y_test=rows(d.y_test) if test else None, x_val=None,
                y_val=None, n_val=None)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        drop_calls = algo._dropout_calls(params)

        def keep_masks():
            return algo._keep_masks(drop_calls, lambda shape, _: torch.ones(
                shape, dtype=torch.bool, device=dev))

        augment = algo.augment_fn is not None

        def leg(leg_hp):
            perms = torch.arange(
                leg_hp.steps_per_epoch * leg_hp.batch_size, device=dev
            ).repeat(s, leg_hp.local_epochs, 1)
            dropout = aug = None
            if drop_calls:
                dropout = [[keep_masks() for _ in range(leg_hp.local_steps)]
                           for _ in range(s)]
            if augment:
                aug = torch.zeros((s, leg_hp.local_steps, DRAW_ROWS,
                                   leg_hp.batch_size), dtype=torch.int64,
                                  device=dev)
            return perms, dropout, aug

        self.perms, self.dropout, self.augment = leg(hp)
        hp_2 = algo._second_leg_hp()
        self.perms_2 = self.dropout_2 = self.augment_2 = None
        if hp_2 is not None:
            self.perms_2, self.dropout_2, self.augment_2 = leg(hp_2)
        self.screen_idx = self.screen_dropout = self.regrow_u = None
        self.screen_augment = None
        if algo._draws_screen:
            self.screen_idx = torch.zeros((s, hp.batch_size),
                                          dtype=torch.int64, device=dev)
            if drop_calls:
                self.screen_dropout = [keep_masks() for _ in range(s)]
            if augment:
                self.screen_augment = torch.zeros(
                    (s, DRAW_ROWS, hp.batch_size), dtype=torch.int64,
                    device=dev)
        if algo._draws_regrow:
            flags = kernel_flags(params)
            self.regrow_u = {k: torch.zeros((s,) + tuple(v.shape),
                                            device=dev)
                             for k, v in params.items() if flags[k]}
        self.uniforms = None
        if algo._needs_uniforms():
            self.uniforms = torch.full(
                algo._uniforms_shape(params), 0.5, device=dev)
        self.faults = self.collude = self.dp_noise = None
        if algo.fault_fn is not None:
            self.faults = torch.zeros((s, len(DRAW_COLUMNS)), device=dev)
            if algo.fault_spec.collude > 0:
                self.collude = {k: torch.zeros_like(v)
                                for k, v in params.items()}
        if algo._needs_dp_noise():
            self.dp_noise = {k: torch.zeros((s,) + tuple(v.shape),
                                            dtype=v.dtype, device=dev)
                             for k, v in params.items()}
        #: the round's pure-host inputs by RoundInputs field, allocated at
        #: the first write (the fields :meth:`FedAlgorithm._host_inputs`
        #: returns)
        self.host: Dict[str, torch.Tensor] = {}
        self.rounds: Dict[tuple, _Graph] = {}  # least recently used first
        #: per round-graph key on a client mesh, the rows the graph reads
        self.mesh_rows: Dict[tuple, MeshRows] = {}
        self.mesh_uniforms = (MeshUniformBuffers() if algo.mesh is not None
                              else None)
        self.evicted = 0
        self.eval: Optional[_Graph] = None
        self.eval_names: List[str] = []

    def load(self, state: Any, rows: Optional[Dict[str, Tree]] = None
             ) -> None:
        """``state`` copied into the buffers; in store mode ``rows`` (by
        store field, the union's rows) into the first rows of theirs."""
        for f in self.fields:
            if f in self.store_fields:
                for k, t in rows[f].items():
                    getattr(self.state, f)[k][:t.shape[0]].copy_(t)
            else:
                _copy_into(getattr(self.state, f), getattr(state, f))

    def export(self, template: Any, generator: torch.Generator,
               n_rows: int = 0) -> Any:
        """The state in the buffers, cloned out (``template``'s other
        fields, the given generator); a store field as its first
        ``n_rows`` rows."""
        def out(f):
            v = getattr(self.state, f)
            if f in self.store_fields:
                return {k: t[:n_rows].clone() for k, t in v.items()}
            return _clone(v)

        return dataclasses.replace(template, generator=generator,
                                   **{f: out(f) for f in self.fields})

    def write(self, inp: RoundInputs) -> None:
        """A round's inputs copied into the buffers the graphs read, on
        the stream (a step a client does not run keeps its old masks)."""
        self.sel.copy_(inp.sel)
        self.n_sel.copy_(inp.n_sel)
        if self.pop is not self.sel:
            self.pop.copy_(inp.pop)
        self.lr.copy_(inp.lr)
        for bufs, legs in ((self.dropout, inp.dropout),
                           (self.dropout_2, inp.dropout_2)):
            if bufs is None:
                continue
            for buf_steps, steps in zip(bufs, legs):
                for buf, keep in zip(buf_steps, steps):
                    _copy_masks(buf, keep)
        if self.screen_dropout is not None:
            for buf, keep in zip(self.screen_dropout, inp.screen_dropout):
                _copy_masks(buf, keep)
        for buf, src in ((self.perms, inp.perms),
                         (self.perms_2, inp.perms_2),
                         (self.augment, inp.augment),
                         (self.augment_2, inp.augment_2),
                         (self.screen_augment, inp.screen_augment),
                         (self.screen_idx, inp.screen_idx),
                         (self.regrow_u, inp.regrow_u),
                         (self.uniforms, inp.uniforms),
                         (self.faults, inp.faults),
                         (self.collude, inp.collude),
                         (self.dp_noise, inp.dp_noise)):
            if buf is not None:
                _copy_into(buf, src)
        for f in _HOST_FIELDS:
            src = getattr(inp, f)
            if src is None:
                continue
            if f not in self.host:
                self.host[f] = torch.empty_like(src)
            self.host[f].copy_(src)
        mr = inp.mesh_rows
        if mr is not None and mr.uniforms is not None:
            self.mesh_uniforms.set_round(mr.uniforms)

    def _graph_mesh_rows(self, key: tuple, mr: Optional[MeshRows]
                         ) -> Optional[MeshRows]:
        """The :class:`MeshRows` the graph of ``key`` reads: its own
        buffers, the round's rows copied into them."""
        if mr is None:
            return None
        mine = self.mesh_rows.get(key)
        if mine is None:
            mine = self.mesh_rows[key] = MeshRows(
                list(mr.own), mr.rows.clone(), list(mr.counts),
                list(mr.order), mr.gather_idx.clone(), mr.own_idx.clone(),
                self.mesh_uniforms if mr.uniforms is not None else None)
        mine.rows.copy_(mr.rows)
        return mine

    def round_graph(self, algo: "FedAlgorithm", inp: RoundInputs) -> _Graph:
        """The round graph of ``inp``'s key (:meth:`FedAlgorithm.
        _graph_key`), captured at the key's first use."""
        key = algo._graph_key(inp)
        steps = algo._step_key(inp.n_valid)
        graph = self.rounds.pop(key, None)
        mr = self._graph_mesh_rows(key, inp.mesh_rows)
        if graph is None:
            if len(self.rounds) >= FUSED_MAX_GRAPHS:
                old = next(iter(self.rounds))
                self.rounds.pop(old).release()
                self.mesh_rows.pop(old, None)
                if not self.evicted:
                    logger.warning(
                        "%s: more than %d round-graph keys; a new one is "
                        "captured anew", algo.name, FUSED_MAX_GRAPHS)
                self.evicted += 1
            # counts with the key's active steps (the body reads the counts
            # themselves from the n_sel buffer)
            inp = RoundInputs(
                n_valid=[b * algo.hp.batch_size for b in steps], sel=self.sel,
                n_sel=self.n_sel, lr=self.lr, pop=self.pop, slab=self.slab,
                perms=self.perms, dropout=self.dropout,
                augment=self.augment, uniforms=self.uniforms,
                faults=self.faults, collude=self.collude,
                dp_noise=self.dp_noise, perms_2=self.perms_2,
                dropout_2=self.dropout_2, augment_2=self.augment_2,
                screen_idx=self.screen_idx,
                screen_dropout=self.screen_dropout,
                screen_augment=self.screen_augment, regrow_u=self.regrow_u,
                mesh_rows=mr, **self.host)

            def body(warm: bool):
                new, metrics = algo._round_body(self.state, inp)
                if not warm:  # a warm-up leaves the state where it was
                    for f in self.fields:
                        _copy_into(getattr(self.state, f), getattr(new, f))
                return torch.stack([metrics[k].double().reshape(())
                                    for k in algo._round_metric_names])

            graph = _Graph(
                body, algo.device,
                f"{algo.name}: the round (agg_impl={algo.agg_impl!r})")
        self.rounds[key] = graph  # now the most recently used
        return graph

    def eval_graph(self, algo: "FedAlgorithm") -> _Graph:
        if self.eval is None:
            def body(warm: bool):
                ev = algo.evaluate(self.state)
                self.eval_names = [k for k in ev
                                   if not k.startswith("acc_per")]
                return torch.stack([torch.as_tensor(ev[k]).double().reshape(
                    ()) for k in self.eval_names])

            self.eval = _Graph(body, algo.device, f"{algo.name}: the eval")
        return self.eval

    def release(self) -> None:
        """Drop every graph (and its memory pool)."""
        for graph in self.rounds.values():
            graph.release()
        if self.eval is not None:
            self.eval.release()
        self.rounds, self.mesh_rows, self.eval = {}, {}, None


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
    ``agg_kernels`` and ``agg_overlap`` change no bit and are left out.

    ``eval_clients`` = K (0 < K < clients) evaluates a fixed seeded subset
    of K clients instead of the whole cohort, its means over the subset.
    ``remat_local`` recomputes each training batch's forward in its
    backward (``core/trainer.py``). ``obs_numerics`` adds the numerics
    telemetry to the round metrics of the algorithms with
    ``numerics_supported`` (:meth:`_numerics_outputs`).

    The robustness tier (the reference's constructor arguments):
    ``fault_spec`` injects deterministic faults after local training
    (``robust/faults.py``); ``guard`` (None: on exactly when faults are
    injected) quarantines the non-finite and dropped clients before the
    aggregate and reports ``clients_dropped`` / ``clients_quarantined``
    per round; ``robust_agg`` (with ``robust_trim``, ``robust_krum_f``,
    ``robust_norm_bound``) replaces the weighted mean by a robust statistic
    of the clients' deltas, on a compressed wire of the decoded rows, under
    "topk" of the sparsified rows. A subclass's ``defense`` (a
    ``robust.RobustAggregator``, set before this constructor) transforms
    the stacked locals before all of that.
    ``channel_inject`` appends the channel axis to each batch at apply time
    (the cohort of ``--layout flat`` is stored channel-less);
    ``init_sample_shape`` is the per-sample shape the model sees.

    ``augment`` is the training-time augmentation every training and SNIP
    batch goes through: "auto" (the default) or True turns on the
    reference's RandomCrop(H, padding=4) and horizontal flip exactly when
    the loader declared the dataset augmentable (``data.aug_pad_value``
    set; the ring takes that value), as the original's train transform
    always runs on CIFAR and Tiny-ImageNet; False turns it off; a callable
    ``(batch, draws) -> batch`` is used as it is, fed ``[3, batch]``
    draws (``data.cifar.crop_flip_draws``). Its draws come from the
    round's generator per active step, before the step's dropout masks.

    An algorithm that sets ``eval_cache`` (before this constructor) keeps
    the personal eval's per-client terms in its state and refreshes the
    trained clients' rows in each round body, so its eval
    (:meth:`evaluate`) runs no personal forward.

    ``client_store`` "host" or "disk" (the algorithms with
    ``store_supported``, at ``frac`` < 1) keeps the per-client rows (the
    personal stack, the top-k residual) in a
    :class:`~..core.client_store.ClientStore` (``store_hot_clients`` rows
    in host memory over memory-mapped files under ``store_dir`` on
    "disk") and the data on the host: between rounds the state holds None
    for those fields, and each round gathers the sampled clients' rows and
    data onto the card, runs the same round body on that slab and stages
    the trained rows back. A streamed run is bitwise the resident one, and
    its device memory does not grow with the population.

    ``data`` sharded over a client mesh (``parallel.mesh.shard_federated``;
    the algorithms with ``mesh_supported``, all nine) runs the round on the
    mesh (module docstring); the device defaults to the mesh's. Its fused
    blocks capture the round's collectives on NCCL (:meth:`run_rounds_
    fused`); the eval cache and subset, stratified SNIP, the robustness
    tier, the checkpoints (:meth:`state_to_global`) and the client store
    (each rank's store holds its block's rows, :meth:`_store_own`) run on
    it as well."""

    name = "base"
    #: the algorithm carries the error-feedback residual of agg_impl="topk"
    topk_supported = False
    #: the algorithm's only per-round host work is the seeded client draw,
    #: the generator's draws and inputs that are a pure function of the
    #: round index (:meth:`_host_inputs`), so its rounds can run as fused
    #: blocks (:meth:`run_rounds_fused`)
    supports_fused = False
    #: the round metrics :meth:`_round_body` returns
    _round_metric_names = ("train_loss",)
    #: the guarded round reports the guard's quarantine counters (Ditto's
    #: global leg is guarded without them, as in the reference)
    guard_metrics_supported = True
    #: the round streams its per-client rows from a client store
    #: (``client_store`` "host" / "disk"): the central-aggregate algorithms
    #: whose rows are indexed by the sampled cohort alone
    store_supported = False
    #: the round runs on a client mesh (each algorithm sets it once its
    #: round and eval run on a rank's block of clients)
    mesh_supported = False
    #: the state's per-client row fields, ``[C, ...]`` in client order (a
    #: tree, per leaf, or a tensor), of which a client mesh's rank holds its
    #: block (:meth:`state_to_global`)
    row_fields = ("personal_params", "agg_residual")
    #: the round body threads the numerics telemetry (``obs_numerics``,
    #: ``obs/numerics.py``) through its metrics: the central-aggregate
    #: rounds of :meth:`_round_body` (FedAvg, SalientGrads)
    numerics_supported = False
    #: the numerics plan also emits the mask's churn and agreement
    #: (SalientGrads' fixed SNIP mask)
    numerics_with_mask = False

    def __init__(self, model: torch.nn.Module, data: FederatedData,
                 hp: HyperParams, loss_type: str = "bce", frac: float = 1.0,
                 eval_batch: int = 32, seed: int = 0,
                 compute_dtype: Optional[str] = None,
                 agg_impl: str = "dense", agg_bucket_size: int = 0,
                 agg_topk_density: float = 0.1, agg_topk_sample: int = 0,
                 agg_hier_wire: str = "bf16", agg_hier_inner: int = 0,
                 eval_clients: int = 0, channel_inject: bool = False,
                 remat_local: bool = False, fault_spec: str = "",
                 guard: Optional[bool] = None, robust_agg: str = "none",
                 robust_trim: float = 0.2, robust_krum_f: int = 0,
                 robust_norm_bound: float = 5.0,
                 client_store: str = "device", store_hot_clients: int = 64,
                 store_dir: Optional[str] = None, augment="auto",
                 obs_numerics: bool = False, device=None):
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
        self.remat_local = bool(remat_local)
        self.defense = getattr(self, "defense", None)
        self.fault_spec = parse_fault_spec(fault_spec)
        self.fault_fn = (make_fault_fn(self.fault_spec, seed)
                         if self.fault_spec is not None
                         and self.fault_spec.any_active else None)
        # the output count, as the reference reads it off its model
        self.labelflip_fn = make_labelflip_fn(
            self.fault_spec, seed,
            int(getattr(model, "num_classes", 2) or 2))
        self.guard_enabled = (bool(guard) if guard is not None
                              else self.fault_fn is not None)
        if self.fault_fn is not None and not self.guard_enabled \
                and self.fault_spec.drop > 0:
            raise ValueError(
                "fault_spec drop=... requires the guard (it is what "
                "excludes dropped clients from the aggregate); don't "
                "pass guard=False, or remove drop from the spec")
        if self.guard_enabled and self.guard_metrics_supported:
            # the guarded round also reports its quarantine counters
            self._round_metric_names = tuple(self._round_metric_names) + (
                "clients_dropped", "clients_quarantined")
        if robust_agg not in ROBUST_AGGS:
            raise ValueError(
                f"robust_agg {robust_agg!r} not in {ROBUST_AGGS}")
        self.robust_agg = robust_agg
        if not 0.0 <= float(robust_trim) < 0.5:
            raise ValueError(
                f"robust_trim {robust_trim} must be in [0, 0.5) — "
                "trimming half or more per side leaves no survivors")
        self.robust_trim = float(robust_trim)
        if int(robust_krum_f) < 0:
            raise ValueError(
                f"robust_krum_f {robust_krum_f} must be >= 0 "
                "(0 = auto ceil(0.2 * cohort))")
        self.robust_krum_f = int(robust_krum_f)
        if float(robust_norm_bound) <= 0:
            raise ValueError(
                f"robust_norm_bound {robust_norm_bound} must be > 0")
        self.robust_norm_bound = float(robust_norm_bound)
        #: the watchdog's cohort re-draw (set_retry_nonce)
        self._retry_nonce = 0
        #: the client mesh the data is sharded over (None off the mesh) and
        #: this rank's block of the cohort, ``[lo, hi)`` (all of it off the
        #: mesh)
        self.mesh = mesh_of(data)
        self._lo, self._hi = (0, data.num_clients) if self.mesh is None \
            else self.mesh.block(data.num_clients)
        #: the mesh's gathers of per-client eval terms, by client list
        #: (:meth:`_mesh_gather_plan`)
        self._gather_plans: Dict[tuple, tuple] = {}
        self.device = (self.mesh.device
                       if self.mesh is not None and device is None
                       else resolve_device(device))
        self.model = model.to(self.device)
        self.hp = hp
        self.loss_type = loss_type
        self.seed = seed
        self.num_clients = data.num_clients
        self.clients_per_round = max(1, int(round(self.num_clients * frac)))
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype is not None else None)
        #: the apply appends the trailing channel axis (``--layout flat``)
        self.channel_inject = bool(channel_inject)
        self.apply_fn = make_apply_fn(self.model, self.compute_dtype,
                                      channel_inject=channel_inject)
        self.eval_client = make_eval_fn(self.apply_fn, loss_type, eval_batch)
        if callable(augment):
            self.augment_fn = augment
        elif augment in ("auto", True, 1) and \
                getattr(data, "aug_pad_value", None) is not None:
            self.augment_fn = CropFlip(data.aug_pad_value, padding=4)
            self.augment_fn.place(self.device)
        else:
            self.augment_fn = None
        #: the per-sample shape the model sees: the stored one, plus the
        #: channel axis the apply injects
        self.init_sample_shape = tuple(data.sample_shape) + (
            (1,) if channel_inject else ())
        # obs_numerics: the round's training-dynamics telemetry
        # (obs/numerics.py) appended to the round metrics as float32
        # scalars, so the eager records and the fused block's packed metric
        # stack carry them with no sync; off (the default) the round is
        # bitwise the same. Like every obs knob it never enters identity.
        self._numerics_plan = None
        if obs_numerics and self.numerics_supported:
            from ..obs.numerics import NumericsPlan

            self._numerics_plan = NumericsPlan.from_params(
                dict(self.model.named_parameters()),
                slots=self.clients_per_round,
                with_mask=self.numerics_with_mask)
            self._round_metric_names = tuple(self._round_metric_names) \
                + self._numerics_plan.metric_names
        self._n_train = [int(n) for n in data.n_train]
        self._n_test = [int(n) for n in data.n_test]
        #: the test shards' row counts on the device
        self._n_test_dev = torch.tensor(self._n_test, device=self.device)
        # the sampled eval: a fixed seeded subset of the clients (its ids
        # on the host, where the eval loops over them, and on the device),
        # or every client
        self._eval_rows = list(range(self.num_clients))
        self._eval_idx: Optional[torch.Tensor] = None
        if eval_clients and eval_clients < self.num_clients:
            rows = np.sort(np.random.RandomState(seed).choice(
                self.num_clients, eval_clients, replace=False))
            self._eval_rows = [int(c) for c in rows]
            self._eval_idx = torch.as_tensor(rows.astype(np.int64),
                                             device=self.device)
        #: the evaluated clients' test row counts: the eval's totals
        self._n_test_eval = (
            self._n_test_dev if self._eval_idx is None
            else self._n_test_dev.index_select(0, self._eval_idx))
        # the in-state personal-eval cache (subclasses that support it set
        # self.eval_cache before this constructor)
        self.eval_cache = bool(getattr(self, "eval_cache", False))
        if self.eval_cache:
            if not getattr(self, "track_personal", True):
                raise ValueError(
                    f"{self.name}: eval_cache caches the per-client "
                    "personal-eval terms — it needs the personal stack "
                    "(track_personal=True)")
            if self._eval_idx is not None:
                raise ValueError(
                    f"{self.name}: eval_cache indexes the full [C] "
                    "cohort; the sampled-eval subset (eval_clients) "
                    "composes poorly with it — use one or the other")
        self.client_store = client_store
        #: the client store (None: every row resident on the device), the
        #: store-backed personal eval's [C] terms and the clients whose rows
        #: changed since (:meth:`_personal_eval_store`)
        self._store: Optional[ClientStore] = None
        self._store_eval_cache: Optional[tuple] = None
        self._store_eval_dirty: List[np.ndarray] = []
        if client_store != "device":
            self._check_store(client_store)
            self._store = ClientStore(
                self.num_clients, mode=client_store,
                hot_clients=store_hot_clients, root=store_dir,
                mesh=self.mesh)
        # store mode keeps the data on the host: each round moves its
        # cohort's rows to the card (_store_gather_rows)
        self.data = data.to(self.device if self._store is None else "cpu")
        if self.mesh is not None:
            self._check_mesh()
        #: the dropout layers a training forward meets, by batch rows
        #: (_dropout_calls)
        self._drop_calls: Dict[int, List[tuple]] = {}
        #: the fused round loop's buffers and graphs (run_rounds_fused)
        self._fused: Optional[_FusedRounds] = None
        #: the round draws DisPFL's mask evolution needs: the screening
        #: batch, the regrow scores (its _build sets them)
        self._draws_screen = self._draws_regrow = False
        self._ones: Optional[Tree] = None
        self._build()

    def _check_store(self, client_store: str) -> None:
        """The reference's refusals of a client store the algorithm or its
        options cannot stream."""
        if client_store not in ("device",) + STORE_MODES:
            raise ValueError(
                f"client_store {client_store!r} not in "
                f"{('device',) + STORE_MODES}")
        if not self.store_supported:
            raise ValueError(
                f"{self.name}: client_store={client_store!r} needs "
                "the store-backed round entry (fedavg/salientgrads/"
                "ditto — the central-aggregate algorithms whose "
                "per-client rows stream by cohort)")
        if self.clients_per_round >= self.num_clients:
            raise ValueError(
                f"{self.name}: client_store streams the SAMPLED "
                "cohort; full participation keeps every row on "
                "device each round, so there is nothing to stream "
                "— use client_store='device' (or frac < 1)")
        if self._eval_idx is not None:
            raise ValueError(
                f"{self.name}: eval_clients indexes the resident "
                "[C] personal stack; with client_store the stack "
                "is not resident — use one or the other")
        if not getattr(self, "track_personal", True) \
                and self.agg_impl != "topk":
            raise ValueError(
                f"{self.name}: client_store={client_store!r} with "
                "track_personal=False and no topk residual has no "
                "per-client rows to stream — drop --client_store "
                "(the run is already O(S) in device memory)")

    def _check_mesh(self) -> None:
        """Refuse on a client mesh the round of an algorithm without
        ``mesh_supported``."""
        if not self.mesh_supported:
            raise ValueError(
                f"{self.name}: its round does not run on a client mesh")

    @property
    def num_local_clients(self) -> int:
        """The clients whose rows this rank holds (all of them off the
        mesh)."""
        return self._hi - self._lo

    @abc.abstractmethod
    def _build(self) -> None:
        """Construct the round and eval functions."""

    @abc.abstractmethod
    def init_state(self, generator: Optional[torch.Generator] = None) -> Any:
        """The initial server state."""

    def run_round(self, state: Any, round_idx: int, *, perms=None,
                  dropout=None, agg_uniforms=None, batch_idx=None,
                  faults=None, collude=None, dp_noise=None, perms_2=None,
                  dropout_2=None, screen_idx=None, screen_dropout=None,
                  regrow_u=None, augment=None, augment_2=None,
                  screen_augment=None):
        """One round, a pure function of ``state``: the input state is left
        as it was (its generator too; the round draws from a copy, which the
        new state carries). ``perms`` / ``batch_idx`` / ``dropout`` /
        ``augment`` (per selected client) replace the drawn epoch
        permutations / with-replacement batch indices (``[local_steps,
        batch]`` each) / dropout masks / crop-and-flip draws
        (``[local_steps, 3, batch]`` each), ``agg_uniforms`` the int8
        wire's draw, ``faults`` the fault draws (``[S, 8]``), ``collude``
        the colluders' direction and ``dp_noise`` the weak-DP noise
        (``[S, ...]`` per leaf);
        ``perms_2`` / ``dropout_2`` / ``augment_2`` the second leg's,
        ``screen_idx`` / ``screen_dropout`` / ``screen_augment`` DisPFL's
        screening batch and ``regrow_u`` its regrow scores
        (:class:`RoundInputs`). Returns ``(state,
        metrics)``: ``train_loss``, under the guard ``clients_dropped`` and
        ``clients_quarantined``, and each algorithm's own. With a client
        store the round streams its cohort (:meth:`_store_round`)."""
        inp, g = self._eager_inputs(state, round_idx, dict(
            perms=perms, dropout=dropout, agg_uniforms=agg_uniforms,
            batch_idx=batch_idx, faults=faults, collude=collude,
            dp_noise=dp_noise, perms_2=perms_2, dropout_2=dropout_2,
            screen_idx=screen_idx, screen_dropout=screen_dropout,
            regrow_u=regrow_u, augment=augment, augment_2=augment_2,
            screen_augment=screen_augment))
        if self._store is not None:
            new_state, metrics = self._store_round(state, round_idx, inp)
        else:
            # the time to queue the round's kernels: the card runs them
            # after the span closes (obs/trace.py)
            with obs_trace.span("dispatch_round"):
                new_state, metrics = self._round_body(state, inp)
        return dataclasses.replace(new_state, generator=g), metrics

    def _eager_inputs(self, state: Any, round_idx: int,
                      seams: Dict[str, Any]):
        """An eager round's inputs, ``(RoundInputs, generator)``: the
        round's client draw, its rate and the draws of a copy of the
        state's generator (which the new state carries), ``seams``
        replacing the draws they name."""
        self._prepare_round(state)
        sel = self._selected_client_indexes(round_idx)
        g = clone_generator(state.generator)
        inp = self._round_inputs(
            self._template(state), sel,
            _to_device(sel.astype(np.int64), self.device),
            _to_device(round_lr(self.hp, round_idx), self.device), g,
            seams, round_idx=round_idx)
        return inp, g

    @staticmethod
    def _template(state: Any) -> Tree:
        """One model's parameters of ``state``: the global model, else the
        first client's personal one (the shapes the draws are made for)."""
        params = getattr(state, "global_params", None)
        if params is not None:
            return params
        return {k: v[0] for k, v in state.personal_params.items()}

    def _prepare_round(self, state: Any) -> None:
        """Host work a round needs once, before any round runs."""

    def _round_mask(self, state: Any) -> Tree:
        """The mask the local SGD of the central round body re-applies
        after each step (the algorithms that run :meth:`_round_body` as it
        is define it)."""
        raise NotImplementedError(
            f"{type(self).__name__} runs a round body of its own")

    def _post_aggregate(self, new_global: Tree, state: Any) -> Tree:
        """The new global model after the aggregate (the identity here)."""
        return new_global

    def _round_body(self, state: Any, inp: RoundInputs):
        """The round on tensors: every selected client trains, the server
        aggregates, the trained rows become the personal models (and, with
        ``eval_cache``, their eval terms the cache's rows; under the guard a
        quarantined or dropped client keeps its previous row). Returns
        ``(state, metrics)`` with the state's generator untouched. It reads
        the host only through ``inp.n_valid``: the body a CUDA graph
        holds."""
        new_global, locals_, mean_loss, fstats, residual = \
            self._train_selected_weighted(
                state.global_params, self._round_mask(state), inp,
                residual=state.agg_residual)
        new_global = self._post_aggregate(new_global, state)
        personal = self._guarded_personal_update(
            state.personal_params, locals_, self._own(inp)[1], fstats)
        cache = state.eval_cache
        if self.eval_cache:
            cache = self._update_eval_cache(cache, personal, inp)
        new_state = dataclasses.replace(state, global_params=new_global,
                                        personal_params=personal,
                                        agg_residual=residual,
                                        eval_cache=cache)
        metrics = {"train_loss": mean_loss}
        if fstats is not None:
            metrics.update(clients_dropped=fstats["clients_dropped"],
                           clients_quarantined=fstats["clients_quarantined"])
        # after the re-mask of _post_aggregate: the norms see the adopted
        # global model
        metrics.update(self._numerics_outputs(
            state.global_params, new_global, locals_, inp,
            self._round_mask(state) if self.numerics_with_mask else None))
        return new_state, metrics

    def _numerics_outputs(self, old_global: Tree, new_global: Tree,
                          locals_: Tree, inp: RoundInputs,
                          mask: Optional[Tree] = None
                          ) -> Dict[str, torch.Tensor]:
        """The numerics telemetry (obs/numerics.py) of this round by metric
        name — empty when ``obs_numerics`` is off. Computed on the round's
        own tensors (``locals_`` the trained rows as they arrived at the
        server, post-fault, pre-guard); on a client mesh the per-row terms
        of the rank's rows are gathered in draw order
        (:meth:`_gather_own`)."""
        if self._numerics_plan is None:
            return {}
        return self._numerics_plan.compute(
            old_global, new_global, locals_, mask=mask,
            gather=lambda rows: self._gather_own(rows, inp))

    def _guarded_personal_update(self, personal: Optional[Tree],
                                 locals_: Tree, sel: torch.Tensor,
                                 fstats: Optional[Dict[str, Any]]):
        """The selected clients' trained models scattered into the [C, ...]
        personal stack; under the guard a quarantined or dropped client
        keeps its previous row (``guard.merge_updates``; on a client mesh
        ``locals_`` and ``sel`` are the rank's own rows, flagged by
        ``fstats["rows_ok"]``)."""
        if personal is None:
            return None
        upd = locals_
        if fstats is not None:
            upd = _guard.merge_updates(fstats["rows_ok"], locals_, personal,
                                       sel)
        return tree_scatter_update(personal, sel, upd)

    def finalize(self, state: Any):
        """Optional end-of-training pass; returns ``(state, record or
        None)``, the record appended to the history with ``round = -1``."""
        return state, None

    # -- the single-process layout of a state (checkpoints) -------------------
    def _row_fields_of(self, state: Any) -> List[str]:
        return [f for f in self.row_fields
                if getattr(state, f, None) is not None]

    def _whole(self, rows):
        """A row field this rank holds its block of (a tree or a tensor)
        whole, ``[C, ...]`` in client order, on every rank (each takes
        part: ``parallel.mesh.gather_blocks``); off the mesh ``rows``
        itself."""
        if self.mesh is None:
            return rows
        if isinstance(rows, dict):
            return gather_blocks(self.mesh, rows)
        return gather_blocks(self.mesh, {"": rows})[""]

    def _block(self, rows):
        """This rank's block ``[lo:hi]`` of a whole ``[C, ...]`` row field
        (a tree or a tensor; views); off the mesh ``rows`` itself."""
        if self.mesh is None:
            return rows
        lo, hi = self._lo, self._hi
        return _map_field(lambda t: t[lo:hi], rows)

    def state_to_global(self, state: Any) -> Any:
        """``state`` in the single-process layout, which a checkpoint
        holds: on a client mesh each row field (:attr:`row_fields`)
        gathered whole, ``[C, ...]`` in client order, on every rank (each
        takes part, :meth:`_whole`); the replicated fields as they are.
        Off the mesh the state itself."""
        if self.mesh is None:
            return state
        return dataclasses.replace(state, **{
            f: self._whole(getattr(state, f))
            for f in self._row_fields_of(state)})

    def state_to_local(self, state: Any) -> Any:
        """A state in the single-process layout (a restored checkpoint, of
        any mesh width) as this rank holds it: each row field cut to the
        rank's block ``[lo:hi]``, fresh on the algorithm's device. Off the
        mesh the state itself."""
        if self.mesh is None:
            return state
        return dataclasses.replace(state, **{
            f: _map_field(lambda t: t.to(self.device).clone(),
                          self._block(getattr(state, f)))
            for f in self._row_fields_of(state)})

    def checkpoint_template(self, state: Any) -> Any:
        """What a checkpoint is restored against (its fields, shapes and
        dtypes, and the devices they load onto): ``state`` (an
        ``init_state``), on a client mesh with each row field's leaves
        empty host tensors of the whole ``[C, ...]`` shape, which
        :meth:`state_to_local` then cuts. Off the mesh the state itself."""
        if self.mesh is None:
            return state
        c = self.num_clients
        return dataclasses.replace(state, **{
            f: _map_field(lambda t: torch.empty(
                (c,) + tuple(t.shape[1:]), dtype=t.dtype), getattr(state, f))
            for f in self._row_fields_of(state)})

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

    # -- cost accounting -------------------------------------------------------
    #: per-client masks change between rounds (DisPFL's fire and regrow,
    #: SubAvg's prune): the runner snapshots the cost after every round
    masks_evolve = False

    def cost_trained_clients_per_round(self) -> int:
        """Client training passes a round runs (the runner's FLOPs and
        communication counters): the sampled clients by default; the
        algorithms that train the whole cohort, or two legs a client,
        say so."""
        return self.clients_per_round

    def cost_snapshot(self, state: Any, whole: bool = False):
        """``(params, mask)`` of one representative client for the
        per-round FLOPs and communication counters: the global model and
        the global mask where the state has them; with per-client masks the
        client whose nonzero count is closest to the cohort's mean (the
        first of a tie), its personal model where there is no global one.
        Waits on the card (the runner calls it between rounds). On a client
        mesh the per-client masks and personal models it reads are
        gathered whole first (every rank calls it), unless ``whole`` says
        the state already is in the single-process layout
        (:meth:`state_to_global`)."""
        if self.mesh is not None and not whole:
            read = [f for f in ("masks", "personal_params")
                    if getattr(state, f, None) is not None
                    and (f == "masks" or getattr(state, "global_params",
                                                 None) is None)]
            state = dataclasses.replace(state, **{
                f: self._whole(getattr(state, f)) for f in read})
        params = getattr(state, "global_params", None)
        mask = getattr(state, "mask", None)
        rep = 0
        masks = getattr(state, "masks", None)
        if mask is None and masks is not None:
            nz = sum(torch.count_nonzero(_rows(m), dim=1).to(torch.float32)
                     for m in masks.values())
            dens = nz / torch.clamp(nz.sum(), min=1.0)
            rep = int(torch.argmin(torch.abs(dens - dens.mean())))
            mask = {k: m[rep] for k, m in masks.items()}
        if params is None and getattr(state, "personal_params",
                                      None) is not None:
            params = {k: v[rep] for k, v in state.personal_params.items()}
        return params, mask

    # -- shared helpers --------------------------------------------------------
    def _fresh_params(self, g: torch.Generator,
                      params: Optional[Tree] = None) -> Tree:
        """``params`` (fresh ones from ``g`` when None) as float32 on this
        algorithm's device: the initial model of ``init_state``."""
        if params is None:
            params = init_params(self.model, g)
        return {k: v.to(self.device, torch.float32) for k, v in
                params.items()}

    def _ones_mask(self, params: Tree) -> Tree:
        """The all-ones mask of plain SGD through the masked SGD kernel
        (``p * 1`` is ``p``), made once."""
        if self._ones is None:
            self._ones = {k: torch.ones_like(v) for k, v in params.items()}
        return self._ones

    def _selected_client_indexes(self, round_idx: int) -> np.ndarray:
        with obs_trace.span("sample"):
            return sample_client_indexes(round_idx, self.num_clients,
                                         self.clients_per_round,
                                         retry=self._retry_nonce)

    def set_retry_nonce(self, nonce: int) -> None:
        """The watchdog's rollback-retry hook: later client draws re-sample
        the cohort with this nonce (0 = the reference's draw). The fused
        loop never retries; the runner keeps the nonce 0 there."""
        self._retry_nonce = int(nonce)

    def _full_batches(self) -> bool:
        """Every batch is full and every step active: every client's shard
        covers ``steps_per_epoch * batch_size`` rows, or the batching is
        "replacement"."""
        if self.hp.batching == "replacement":
            return True
        need = self.hp.steps_per_epoch * self.hp.batch_size
        return all(n >= need for n in self._n_train)

    def _require_plan(self, what: str) -> collectives.SparsePlan:
        if self._agg_sparse_plan is None:
            raise ValueError(
                f"{self.name}: {what} needs a static-mask gather plan "
                "(_agg_sparse_plan) built from the concrete mask — only "
                "fixed-mask algorithms (SalientGrads) support it")
        return self._agg_sparse_plan

    def _own(self, inp: RoundInputs):
        """``(positions in the draw, rows)`` of the selected clients this
        rank trains: all of them, at ``inp.sel``, off the mesh."""
        if inp.mesh_rows is None:
            return range(len(inp.n_valid)), inp.sel
        return inp.mesh_rows.own, inp.mesh_rows.rows

    def _gather_own(self, values: torch.Tensor,
                    inp: RoundInputs) -> torch.Tensor:
        """Per-client values this rank computed for the selected clients it
        trains (``[len(own), ...]``, :meth:`_own`) for every selected
        client, in draw order, on every rank (one ``all_gather``); off the
        mesh ``values`` itself. A mean over the round's clients (the train
        loss) is then the single process's."""
        mr = inp.mesh_rows
        if mr is None:
            return values
        return gather_rows(self.mesh, values, mr.counts, mr.gather_idx)

    @staticmethod
    def _own_draws(x, inp: RoundInputs):
        """The rows of a round's ``[S, ...]`` draw (a tensor or a tree of
        them: the fault draws, the weak-DP noise, the int8 uniforms) at the
        positions of the clients this rank trains, through the prebuilt
        ``MeshRows.own_idx``; all of it off the mesh."""
        mr = inp.mesh_rows
        if x is None or mr is None:
            return x
        if isinstance(x, dict):
            return {k: v.index_select(0, mr.own_idx) for k, v in x.items()}
        return x.index_select(0, mr.own_idx)

    def _mesh_spread(self, ids: Sequence[int]):
        """``(counts, order)`` of the clients ``ids`` (population ids, in
        their order) as the mesh's ranks hold them: per rank how many, per
        client ``(rank, index among that rank's)``."""
        per = self.num_local_clients
        counts = [0] * self.mesh.size
        order = []
        for c in ids:
            d = int(c) // per
            order.append((d, counts[d]))
            counts[d] += 1
        return counts, order

    def _mesh_rows(self, sel: np.ndarray, aggregate: bool,
                   round_idx: Optional[int]) -> MeshRows:
        """The selected clients ``sel`` (population ids, in draw order) as
        the mesh's ranks hold them (:class:`MeshRows`)."""
        counts, order = self._mesh_spread(sel)
        own = [i for i, (d, _) in enumerate(order) if d == self.mesh.rank]
        rows = _to_device(np.asarray([int(sel[i]) - self._lo for i in own],
                                     np.int64), self.device)
        uniforms = (mesh_wire_uniforms(self.seed, round_idx, self.device)
                    if aggregate else None)
        return MeshRows(own, rows, counts, order,
                        _to_device(gather_index(counts, order), self.device),
                        _to_device(np.asarray(own, np.int64), self.device),
                        uniforms)

    def _mesh_gather_plan(self, rows: Sequence[int]):
        """``(counts, index)`` of the gather of the per-client values
        of the clients ``rows`` (population ids, each rank evaluating the
        ones it holds) into the order of ``rows``, made once per distinct
        ``rows`` (the eval's, the cohort's), so a graph's body reads an
        index that stays put."""
        key = tuple(int(c) for c in rows)
        if key not in self._gather_plans:
            counts, order = self._mesh_spread(key)
            self._gather_plans[key] = (counts, _to_device(
                gather_index(counts, order), self.device))
        return self._gather_plans[key]

    def _gather_selected(self, tree: Tree, mr: MeshRows) -> Tree:
        """The selected clients' rows of ``tree`` (each rank holding its
        own, ``[len(mr.own), ...]``) on every rank, in draw order: one
        ``all_gather`` of the rows flattened into one matrix."""
        keys = list(tree)
        n = len(mr.own)
        sizes = [int(np.prod(tree[k].shape[1:], dtype=np.int64))
                 for k in keys]
        mat = torch.cat([tree[k].reshape(n, size).to(torch.float32)
                         for k, size in zip(keys, sizes)], dim=1)
        full = gather_rows(self.mesh, mat, mr.counts, mr.gather_idx)
        out, off = {}, 0
        for k, size in zip(keys, sizes):
            shape = tree[k].shape[1:]
            out[k] = full[:, off:off + size].reshape((-1,) + tuple(shape)) \
                .to(tree[k].dtype)
            off += size
        return out

    def _reduce_rows(self, stacked: Tree, weights: torch.Tensor,
                     uniforms, mr: Optional[MeshRows]):
        """What the aggregate reduces, ``(rows, mesh, uniforms)``: off the
        mesh ``stacked`` itself. On the mesh, at full participation the
        rank's own rows, which are its block of the selection; otherwise
        the trained rows gathered in draw order, then the rank's block of
        them where the selection divides over the mesh, else all of them,
        reduced off the mesh on every rank (``uniforms`` then the drawn
        ``[S, nb, b]``, as in the single-process run)."""
        if mr is None:
            return stacked, None, uniforms
        if self.clients_per_round == self.num_clients:
            return stacked, self.mesh, mr.uniforms
        rows = self._gather_selected(stacked, mr)
        s = int(weights.shape[0])
        if collectives._mesh_axis_rows(self.mesh, "clients", s):
            lo, hi = self.mesh.block(s)
            return ({k: v[lo:hi] for k, v in rows.items()}, self.mesh,
                    mr.uniforms)
        return rows, None, uniforms

    def _aggregate(self, stacked: Tree, weights: torch.Tensor,
                   uniforms: Optional[torch.Tensor] = None,
                   mesh_rows: Optional[MeshRows] = None) -> Tree:
        """The central weighted mean over the stacked client axis, routed by
        ``agg_impl``. ``uniforms`` is the int8 wire's ``[C, nb, b]``
        stochastic-rounding draw. "topk" here is the wire alone, selection
        and reduce of whatever ``stacked`` holds; the round body's
        :meth:`_topk_aggregate` owns the residual around it. On a client
        mesh (``mesh_rows``) ``stacked`` holds the rank's trained rows and
        the reduce is the on-mesh one (:meth:`_reduce_rows`); "dense" there
        is the f32 wire."""
        stacked, mesh, uniforms = self._reduce_rows(stacked, weights,
                                                    uniforms, mesh_rows)
        impl = self.agg_impl
        kw = dict(bucket_size=self.agg_bucket_size, mesh=mesh)
        if impl == "dense":
            if mesh is not None:
                return collectives.weighted_mean(stacked, weights, **kw)
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

    def _robust_wire(self) -> str:
        """The wire whose decode the robust statistic ranks: the
        ``agg_impl``'s payload format (f32 for the exact wires; "topk" has
        its own path in :meth:`_topk_aggregate`)."""
        if self.agg_impl in ("bf16", "int8"):
            return self.agg_impl
        if self.agg_impl == "hier" and \
                self.agg_hier_wire in ("bf16", "int8"):
            return self.agg_hier_wire
        return "f32"

    def _robust_aggregate(self, stacked: Tree, weights: torch.Tensor,
                          global_params: Tree,
                          uniforms: Optional[torch.Tensor] = None,
                          mesh_rows: Optional[MeshRows] = None) -> Tree:
        """The ``robust_agg`` aggregate: the robust statistic of the
        clients' deltas (local - global) in the reference's flat layout,
        each delta row first through the wire's encode and decode
        (``collectives.wire_roundtrip_mat``; int8 on the round's
        ``uniforms``, the reducing wire's draw), then ``global + combined``.
        The same (stacked, weights) signature as :meth:`_aggregate`, so the
        guard's quarantine threads it unchanged. On a client mesh
        (``mesh_rows``) ``stacked`` holds the rank's own rows: each rank
        decodes its rows (on its rows of the ``[S, nb, b]`` uniforms), the
        decoded rows are gathered into ``[S, N]`` in draw order (one
        ``all_gather``), and every rank computes the statistic of the same
        matrix: the single-process aggregate bit for bit."""
        spec = collectives.flat_spec(stacked, stacked=True)
        gvec = collectives.tree_to_vec(global_params).to(torch.float32)
        deltas = collectives.stacked_to_mat(stacked) - gvec[None]
        if mesh_rows is not None and uniforms is not None:
            uniforms = uniforms.index_select(0, mesh_rows.own_idx)
        deltas = collectives.wire_roundtrip_mat(
            deltas, self._robust_wire(), bucket_size=self.agg_bucket_size,
            uniforms=uniforms)
        if mesh_rows is not None:
            deltas = gather_rows(self.mesh, deltas, mesh_rows.counts,
                                 mesh_rows.gather_idx)
        combined = robust_combine_mat(
            deltas, weights, self.robust_agg, trim_frac=self.robust_trim,
            krum_f=self.robust_krum_f, norm_bound=self.robust_norm_bound)
        return collectives.vec_to_tree(gvec + combined, spec)

    def _topk_aggregate(self, locals_: Tree, global_params: Tree,
                        residual: Tree, idx: torch.Tensor,
                        weights: torch.Tensor,
                        ok: Optional[torch.Tensor] = None,
                        mesh_rows: Optional[MeshRows] = None,
                        rows_ok: Optional[torch.Tensor] = None):
        """The ``agg_impl='topk'`` round aggregate with error feedback (Deep
        Gradient Compression on the federated round):

        1. each selected client's delta, local - global, plus its carried
           residual row (dead coordinates of a sparse plan zeroed);
        2. per leaf-group top-k selection and the weighted mean of the
           sparsified rows (with ``robust_agg``, the robust statistic of
           the sparsified rows instead: a rejected client's shipped
           coordinates still leave its residual);
        3. the unsent remainder becomes the client's new residual row;
        4. ``new_global = global + aggregate``.

        Under the guard (``ok``, the ``[S]`` survivor flags; ``rows_ok``
        those of the rows ``locals_`` holds, ``ok`` by default): the
        quarantined rows are select-zeroed before the selection and the
        weights renormalized (``guard.quarantine``), no survivor carries
        the previous global, and a quarantined client's residual row keeps
        its previous value. Always the select spelling, so a clean round is
        bitwise the unguarded one.

        ``idx`` holds the selected clients' ids (int64, on the device). On
        a client mesh (``mesh_rows``) ``locals_``, ``idx`` and the residual
        are the rank's own rows: each rank selects its clients' coordinates
        and only the sparsified rows reach the on-mesh reduce; under
        ``robust_agg`` the sparsified rows are gathered into ``[S, N]`` in
        draw order and every rank computes the statistic of them.
        Returns ``(new_global, new_residual)``."""
        if residual is None:
            raise ValueError(
                f"{self.name}: agg_impl='topk' round body called without the "
                "residual stack — init_state must seed State.agg_residual")
        full = self.clients_per_round == self.num_clients
        res_sel = residual if full else tree_index(residual, idx)
        comp = {k: (locals_[k] - global_params[k][None]) + res_sel[k]
                for k in locals_}
        plan = self._agg_sparse_plan
        if plan is not None:
            # dead coordinates never ship, so they must not enter the
            # residual either (round 0's dense init would sit there forever)
            comp = collectives.plan_dead_select(comp, plan)
        comp_in, w, survivors = comp, weights, None
        rows_ok = ok if rows_ok is None else rows_ok
        if ok is not None:
            comp_in, w, survivors = _guard.quarantine(comp, weights, ok,
                                                      rows_ok)
        kw = dict(plan=plan, bucket_size=self.agg_bucket_size,
                  sample=self.agg_topk_sample)
        if self.robust_agg != "none":
            sp = (collectives.topk_sparsify(comp_in, self.agg_topk_density,
                                            **kw)
                  if mesh_rows is None or len(mesh_rows.own) else comp_in)
            mat = collectives.stacked_to_mat(sp)
            if mesh_rows is not None:
                mat = gather_rows(self.mesh, mat, mesh_rows.counts,
                                  mesh_rows.gather_idx)
            update = collectives.vec_to_tree(
                robust_combine_mat(
                    mat, w, self.robust_agg,
                    trim_frac=self.robust_trim, krum_f=self.robust_krum_f,
                    norm_bound=self.robust_norm_bound),
                collectives.flat_spec(sp, stacked=True))
        elif mesh_rows is not None:
            sp = (collectives.topk_sparsify(comp_in, self.agg_topk_density,
                                            **kw)
                  if len(mesh_rows.own) else comp_in)
            rows, mesh, _ = self._reduce_rows(sp, w, None, mesh_rows)
            mkw = dict(mesh=mesh, bucket_size=self.agg_bucket_size)
            update = (collectives.sparse_weighted_mean(rows, w, plan, **mkw)
                      if plan is not None
                      else collectives.weighted_mean(rows, w, **mkw))
        else:
            update, sp = collectives.topk_weighted_mean(
                comp_in, w, self.agg_topk_density, **kw)
        new_global = {k: (g + update[k]).to(g.dtype)
                      for k, g in global_params.items()}
        new_rows = {k: comp_in[k] - sp[k] for k in comp_in}
        if ok is not None:
            new_global = _guard.carry_if_empty(new_global, global_params,
                                               survivors)
            new_rows = _guard.merge_residual(rows_ok, new_rows, res_sel)
        new_residual = new_rows if full else tree_scatter_update(
            residual, idx, new_rows)
        return new_global, new_residual

    def _train_clients(self, global_params: Tree, mask: Tree,
                       inp: RoundInputs,
                       flips: Optional[torch.Tensor] = None):
        """Every client of ``inp`` trains a copy of the global model on its
        own rows (client ``i`` on flipped labels where ``flips[i]``, the
        ``labelflip`` fault); returns (stacked local models, mean loss)."""
        stacked, lo = self._train_own(global_params, mask, inp, flips)
        # the losses of every selected client, in draw order, then the
        # single-process mean
        return stacked, self._gather_own(lo, inp).mean()

    def _train_own(self, global_params: Tree, mask: Tree, inp: RoundInputs,
                   flips: Optional[torch.Tensor] = None):
        """The clients of ``inp`` this rank trains (:meth:`_own`), each from
        a copy of the global model, one after another: (their stacked local
        models, their ``[len(own)]`` losses). A federation site trains its
        slots of a round through here."""
        d = self._round_data(inp)
        own, rows = self._own(inp)
        locals_, losses = [], []
        for j, i in enumerate(own):
            params, _, loss = self.client_update(
                clone_tree(global_params), mask, d.x_train, d.y_train,
                inp.n_valid[i], rows[j:j + 1], inp.perms[i], inp.lr,
                None if inp.dropout is None else inp.dropout[i],
                None if flips is None else flips[i], n_rows=inp.n_sel[i],
                augment=None if inp.augment is None else inp.augment[i])
            locals_.append(params)
            losses.append(loss)
        # a mesh rank may hold none of the selected clients
        stacked = (_stack(locals_) if locals_ else
                   {k: v.new_empty((0,) + tuple(v.shape))
                    for k, v in global_params.items()})
        lo = torch.stack(losses) if losses else torch.zeros(
            0, device=self.device)
        return stacked, lo

    def _train_stacked(self, client_update, params: Tree, masks: Tree,
                       inp: RoundInputs, *, leg: int = 1,
                       shared_mask: bool = False,
                       prox_target: Optional[Tree] = None):
        """Every client of ``inp`` this rank trains (:meth:`_own`: all of
        them off the mesh) trains its own row of the stacked ``params`` on
        its own shard, from zero momentum, under its row of the stacked
        ``masks`` (the one tree ``masks`` with ``shared_mask``), pulled
        toward ``prox_target`` (one tree) where that is given; ``leg`` 2
        draws from the second leg's inputs. ``params`` and ``masks`` hold
        those clients' rows, in the order of :meth:`_own`. The whole-cohort
        (or sampled-rows) local training of the personalized and
        decentralized algorithms. Returns (stacked params, stacked momenta,
        losses), each a row per client trained here (:meth:`_gather_own`
        makes the losses every selected client's)."""
        d = self._round_data(inp)
        perms, dropout, augment = (
            (inp.perms, inp.dropout, inp.augment) if leg == 1
            else (inp.perms_2, inp.dropout_2, inp.augment_2))
        own, rows = self._own(inp)
        out, moms, losses = [], [], []
        for j, i in enumerate(own):
            p, m, loss = client_update(
                {k: v[j].clone() for k, v in params.items()},
                masks if shared_mask else _row(masks, j), d.x_train,
                d.y_train, inp.n_valid[i], rows[j:j + 1], perms[i], inp.lr,
                None if dropout is None else dropout[i],
                prox_target=prox_target, n_rows=inp.n_sel[i],
                augment=None if augment is None else augment[i])
            out.append(p)
            moms.append(m)
            losses.append(loss)
        if not out:  # a mesh rank that holds none of the selected clients
            empty = {k: v[:0].clone() for k, v in params.items()}
            return empty, clone_tree(empty), torch.zeros(0,
                                                         device=self.device)
        return _stack(out), _stack(moms), torch.stack(losses)

    def _local_test(self, stacked: Tree) -> Dict[str, torch.Tensor]:
        """Every client's row of ``stacked`` (on a client mesh the rank's
        block) on its own test shard (the whole cohort, whatever
        ``eval_clients`` says): DisPFL's local tests around local training,
        the means of the per-client ratios."""
        lo = self._lo  # a client mesh's rank holds the rows [lo, hi)
        correct, loss_sum = self._eval_terms(
            range(self.num_clients), lambda c: _row(stacked, c - lo))
        totals = torch.clamp(self._n_test_dev, min=1)
        # the reference takes these means in its round program, where XLA
        # turns the division by the client count into a product by its
        # float32 reciprocal
        recip = torch.full((), float(np.float32(1.0) / np.float32(
            self.num_clients)), dtype=torch.float32, device=totals.device)
        return {"acc": (correct.to(torch.float32) / totals).sum() * recip,
                "loss": (loss_sum / totals).sum() * recip}

    def _train_selected_weighted(self, global_params: Tree, mask: Tree,
                                 inp: RoundInputs,
                                 residual: Optional[Tree] = None):
        """Every selected client trains a copy of the global model; returns
        (new global, stacked local models, mean loss, fault/guard stats,
        new error-feedback residual). In the reference's order:

        1. the ``labelflip`` fault on the training labels;
        2. local training;
        3. the injector on the trained models (:mod:`robust.faults`): the
           faulted tree is also what the personal stack sees;
        4. the defense (clip, weak-DP noise) on the aggregate's copy;
        5. the guard's screen: ``ok`` = finite and not dropped;
        6. the robust statistic or the plain weighted mean over the wire,
           quarantined under the guard (:mod:`robust.guard`).

        The stats are None without the guard, else ``ok`` ([S] survivor
        flags), ``rows_ok`` (those of the rows this rank trains: all of
        them off the mesh) and the f32 ``clients_dropped`` /
        ``clients_quarantined``. ``inp`` (:class:`RoundInputs`) holds the
        clients, the rate and the draws. ``residual`` is the ``[C, ...]``
        error-feedback stack (``agg_impl='topk'`` only; returned unchanged
        otherwise).

        On a client mesh every step up to the screen acts on the rank's own
        rows (with its rows of the fault draws and the weak-DP noise); the
        screen's flags are gathered in draw order, so ``ok`` and the
        counters cover all ``S`` clients on every rank."""
        flips = None
        if self.labelflip_fn is not None:
            # [S]: _train_clients reads it at the draw positions it trains
            flips = labelflip_flags(self.fault_spec, inp.faults)
        stacked, mean_loss = self._train_clients(global_params, mask, inp,
                                                 flips)
        dropped = None
        if self.fault_fn is not None:
            stacked, dropped = self.fault_fn(
                stacked, global_params, self._own_draws(inp.faults, inp),
                inp.collude)
        defended = stacked
        if self.defense is not None:
            defended = self.defense.apply(
                stacked, global_params, self._own_draws(inp.dp_noise, inp))
        weights = inp.n_sel / torch.clamp(inp.n_sel.sum(), min=1.0)
        fstats = ok = rows_ok = None
        if self.guard_enabled:
            finite = _guard.finite_screen(defended)
            if dropped is None:
                dropped = torch.zeros_like(finite)
            rows_ok = finite & ~dropped
            flags = torch.stack([finite, dropped], dim=1)
            mr = inp.mesh_rows
            if mr is not None:
                flags = gather_flags(self.mesh, flags, mr.counts,
                                     mr.gather_idx)
            finite_all, dropped_all = flags[:, 0], flags[:, 1]
            ok = finite_all & ~dropped_all
            # quarantined: screened out among the clients that reported
            fstats = {"ok": ok, "rows_ok": rows_ok,
                      "clients_dropped": dropped_all.to(torch.float32).sum(),
                      "clients_quarantined": (~finite_all & ~dropped_all)
                      .to(torch.float32).sum()}
        if self.robust_agg != "none" and self.agg_impl != "topk":
            def agg_fn(st, wv):
                return self._robust_aggregate(st, wv, global_params,
                                              inp.uniforms, inp.mesh_rows)
        else:
            def agg_fn(st, wv):
                return self._aggregate(st, wv, inp.uniforms, inp.mesh_rows)
        if self.agg_impl == "topk":
            new_global, residual = self._topk_aggregate(
                defended, global_params, residual, self._own(inp)[1],
                weights, ok, inp.mesh_rows, rows_ok)
        elif self.guard_enabled:
            new_global = _guard.guarded_aggregate(defended, weights, ok,
                                                  agg_fn, global_params,
                                                  rows_ok)
        else:
            new_global = agg_fn(defended, weights)
        return new_global, stacked, mean_loss, fstats, residual

    def _round_data(self, inp: RoundInputs) -> FederatedData:
        """The arrays a round body reads its clients' rows from through
        ``inp.sel``: the store's cohort slab, else the data."""
        return self.data if inp.slab is None else inp.slab

    def _shard(self, c: int, test: bool = False):
        """Client ``c``'s train (or test) rows and labels on the device
        (moved there from the host in store mode)."""
        d = self.data
        c = c - self._lo
        x, y = (d.x_test[c], d.y_test[c]) if test else (d.x_train[c],
                                                         d.y_train[c])
        if self._store is not None:
            x, y = _to_device(x, self.device), _to_device(y, self.device)
        return x, y

    def _eval_terms(self, rows, params_of):
        """``eval_client`` of ``params_of(c)`` on client ``c``'s test shard
        for each client id ``c`` of ``rows``: (correct, loss_sum), each
        stacked over ``rows``. On a client mesh each rank evaluates the
        clients of ``rows`` it holds and the sums are gathered into the order
        of ``rows`` (:meth:`_mesh_gather_plan`)."""
        rows = list(rows)
        terms = [self.eval_client(params_of(c), *self._shard(c, test=True),
                                  self._n_test[c]) for c in rows
                 if self._lo <= c < self._hi]
        correct, loss_sum = self._stack_terms(terms)
        if self.mesh is not None:
            counts, idx = self._mesh_gather_plan(rows)
            correct, loss_sum = (gather_rows(self.mesh, t, counts, idx)
                                 for t in (correct, loss_sum))
        return correct, loss_sum

    def _stack_terms(self, terms):
        """``eval_client`` results stacked: (correct int64, loss_sum f32),
        empty where a mesh rank holds none of the clients."""
        if not terms:
            return (torch.zeros(0, dtype=torch.int64, device=self.device),
                    torch.zeros(0, dtype=torch.float32, device=self.device))
        return (torch.stack([t[0] for t in terms]),
                torch.stack([t[1] for t in terms]))

    def _eval_global(self, params: Tree) -> Dict[str, torch.Tensor]:
        """The global model on every evaluated client's test shard (all,
        or the ``eval_clients`` subset)."""
        correct, loss_sum = self._eval_terms(self._eval_rows,
                                             lambda c: params)
        total = self._n_test_eval
        acc = correct.to(torch.float32) / torch.clamp(total, min=1)
        return {"acc_per_client": acc, "acc": acc.mean(),
                "loss": loss_sum.sum() / torch.clamp(total.sum(), min=1)}

    def _eval_personal(self, personal: Tree) -> Dict[str, torch.Tensor]:
        """Each evaluated client's personal model on its own test shard."""
        lo = self._lo
        correct, loss_sum = self._eval_terms(
            self._eval_rows,
            lambda c: {k: v[c - lo] for k, v in personal.items()})
        return _personal_metrics(correct, loss_sum, self._n_test_eval)

    def _mean_mask_density(self, masks: Tree) -> torch.Tensor:
        """The cohort's mean kernel density of the per-client ``masks``
        (``ops.sparsity.mean_mask_density``); on a client mesh each rank's
        clients' densities gathered first, so every rank takes the single
        process's mean."""
        if self.mesh is None:
            return mean_mask_density(masks)
        dens = self.mesh.all_gather(client_mask_densities(masks))
        return fraction_f32(dens.reshape(-1).sum(), self.num_clients)

    # -- the incremental personal eval, in the state (eval_cache) -------------
    # A round changes only its selected clients' personal models. With
    # eval_cache the per-client terms are state: each round body evaluates
    # the selected clients' new personal rows and writes them into the [C]
    # cache (every row in place at full participation), and an eval
    # re-reduces the three [C] tensors with no personal forward. Each
    # client's terms come from the same eval_client call as in the full
    # pass. The cache is cloned, loaded and exported with the rest of the
    # state, so it rides a fused block.

    def _seed_eval_cache(self, personal: Optional[Tree],
                         params: Optional[Tree] = None) -> Optional[dict]:
        """The initial cache: one full personal eval of the fresh stack
        (None without ``eval_cache`` or a personal stack); in store mode of
        ``params``, which every row of the fresh stack equals."""
        if not self.eval_cache or (personal is None and params is None):
            return None
        if personal is None:
            correct, loss_sum = self._eval_terms(self._eval_rows,
                                                 lambda c: params)
            ev = _personal_metrics(correct, loss_sum, self._n_test_eval)
        else:
            ev = self._eval_personal(personal)
        return {"correct": ev["correct"], "loss_sum": ev["loss_sum"],
                "total": ev["total"].clone()}

    def _update_eval_cache(self, cache: Optional[dict], personal: Tree,
                           inp: RoundInputs) -> Optional[dict]:
        """The round body's refresh: the selected clients' new personal
        rows evaluated, their terms written into the cache, out of place.
        Full participation evaluates every row in place of a gather of the
        stack; otherwise the rows, test shards and counts are gathered
        through the device client ids, so a graph can hold it: the rows and
        test shards at ``inp.sel`` (a store's slab positions), the ``[C]``
        cache and test counts at ``inp.pop`` (the population ids).

        On a client mesh each rank evaluates the trained rows it holds
        (``inp.mesh_rows``), the terms are gathered into draw order and
        written into the replicated cache at the population ids, so every
        rank holds the same cache."""
        if cache is None:
            return None
        lo = self._lo
        if self.clients_per_round == self.num_clients:
            correct, loss_sum = self._eval_terms(
                range(self.num_clients),
                lambda c: {k: v[c - lo] for k, v in personal.items()})
            return {"correct": correct, "loss_sum": loss_sum,
                    "total": cache["total"]}
        d = self._round_data(inp)
        pos, rows = self._own(inp)
        pop = inp.pop
        sub = tree_index(personal, rows)
        xs, ys = d.x_test.index_select(0, rows), d.y_test.index_select(0, rows)
        ns = self._n_test_dev.index_select(0, pop)
        correct, loss_sum = self._stack_terms([
            self.eval_client({k: v[j] for k, v in sub.items()}, xs[j], ys[j],
                             ns[i]) for j, i in enumerate(pos)])
        mr = inp.mesh_rows
        if mr is not None:
            correct, loss_sum = (
                gather_rows(self.mesh, t, mr.counts, mr.gather_idx)
                for t in (correct, loss_sum))
        return {"correct": cache["correct"].index_copy(0, pop, correct),
                "loss_sum": cache["loss_sum"].index_copy(0, pop, loss_sum),
                "total": cache["total"].index_copy(0, pop, ns)}

    def _eval_personal_state(self, state: Any) -> Dict[str, torch.Tensor]:
        """The personal half of the eval: the re-reduce of
        ``state.eval_cache`` where it is live, else the full pass over the
        state's personal stack (FedAvg's finalize drops the cache: the
        fine-tune retrained every row)."""
        cache = getattr(state, "eval_cache", None)
        if self.eval_cache and cache is not None:
            return _personal_metrics(cache["correct"], cache["loss_sum"],
                                     cache["total"])
        if state.personal_params is None and self._store_has_personal():
            return self._personal_eval_store()
        return self._eval_personal(state.personal_params)

    @abc.abstractmethod
    def evaluate(self, state: Any) -> Dict[str, Any]:
        """The reference's eval protocol for this algorithm: global and/or
        personal per-client evaluation, as tensors on the device (no wait
        on the card: the fused loop replays it from a CUDA graph)."""

    # -- the round's host inputs ---------------------------------------------
    def _dropout_calls(self, params: Tree,
                       batch: Optional[int] = None) -> List[tuple]:
        """The dropout layers a training forward of ``batch`` rows (the
        batch size by default) meets, ``(slot, shape, keep_prob)`` in call
        order, from one forward of that many copies of client 0's first row
        (a :class:`~..models.layers.DropoutProbe`), once per algorithm and
        batch."""
        batch = self.hp.batch_size if batch is None else int(batch)
        if batch not in self._drop_calls:
            probe = DropoutProbe()
            x0 = self.data.x_train[0]
            rows = torch.zeros(batch, dtype=torch.int64, device=x0.device)
            with torch.no_grad():
                self.apply_fn(params, x0[rows].to(self.device), train=True,
                              rng=probe)
            self._drop_calls[batch] = probe.calls
        return self._drop_calls[batch]

    @staticmethod
    def _keep_masks(drop_calls, make) -> List[Optional[torch.Tensor]]:
        """One step's keep masks by slot, ``make(shape, keep_prob)`` for
        each dropout call in call order."""
        masks: List[Optional[torch.Tensor]] = \
            [None] * (1 + max(c[0] for c in drop_calls))
        for slot, shape, keep_prob in drop_calls:
            masks[slot] = make(shape, keep_prob)
        return masks

    def _needs_uniforms(self) -> bool:
        """An int8 wire runs: the reducing one, or the robust statistic's
        roundtrip of hier's int8 cross-slice wire."""
        return self.agg_impl == "int8" or (
            self.robust_agg != "none" and self.agg_impl != "topk"
            and self._robust_wire() == "int8")

    def _needs_dp_noise(self) -> bool:
        return self.defense is not None and self.defense.needs_noise

    def _uniforms_shape(self, params: Tree) -> tuple:
        """The int8 wire's draw, ``[S, nb, b]`` over the reference's flat
        layout (:func:`collectives.bucket_shape`)."""
        n = sum(v.numel() for v in params.values())
        return (self.clients_per_round,) + collectives.bucket_shape(
            n, self.agg_bucket_size)

    def _second_leg_hp(self) -> Optional[HyperParams]:
        """The hyperparameters of a second training leg a round runs per
        client (SubAvg's later epochs, Ditto's personal leg), else None."""
        return None

    def _host_inputs(self, round_idx: Optional[int]) -> Dict[str, Any]:
        """The round's inputs the host computes from its index alone, as
        numpy arrays by :class:`RoundInputs` field (DisPFL's and DPSGD's
        neighbor ``adjacency``, DisPFL's ``active`` flags and
        ``anneal_rate``): none by default."""
        return {}

    def _leg_draws(self, hp: HyperParams, n_valid: List[int],
                   g: torch.Generator, drop_calls, given_perms=None,
                   given_drop=None, given_aug=None):
        """One training leg's draws for the clients of ``n_valid``, per
        client in turn: its epoch permutations (or replacement batches),
        then each step it runs its crop-and-flip draws (with an
        augmentation) and its dropout keep masks. Returns ``(perms [S,
        epochs, steps_per_epoch * batch], dropout, augment [S, local_steps,
        3, batch])``; ``given_perms`` / ``given_drop`` / ``given_aug`` (per
        client) replace the draws."""
        dev = self.device
        n_rows = self.data.x_train.shape[1]
        full = self._full_batches()
        replace = hp.batching == "replacement"
        perms, dropout = [], ([] if drop_calls else None)
        augment = None
        if self.augment_fn is not None:
            augment = torch.zeros((len(n_valid), hp.local_steps, DRAW_ROWS,
                                   hp.batch_size), dtype=torch.int64,
                                  device=dev)
            if given_aug is not None:
                augment.copy_(torch.as_tensor(np.asarray(given_aug)))
        for i, n in enumerate(n_valid):
            if given_perms is not None:
                perms.append(torch.as_tensor(
                    given_perms[i], dtype=torch.int64,
                    device=dev).reshape(hp.local_epochs, -1))
            elif replace:
                perms.append(replacement_batches(g, n, hp))
            else:
                perms.append(epoch_permutations(
                    g, n, hp.local_epochs,
                    hp.steps_per_epoch * hp.batch_size, n_rows=n_rows))
            if dropout is None and (augment is None
                                    or given_aug is not None):
                continue
            steps: List[Optional[List]] = [None] * hp.local_steps
            for s in active_steps(hp, n, full):
                if augment is not None and given_aug is None:
                    augment[i, s] = crop_flip_draws(g, hp.batch_size)
                if dropout is not None:
                    steps[s] = self._step_keep_masks(
                        drop_calls, g, None if given_drop is None
                        else given_drop[i][s])
            if dropout is not None:
                dropout.append(steps)
        return torch.stack(perms), dropout, augment

    def _step_keep_masks(self, drop_calls, g: torch.Generator, given=None):
        """One training forward's dropout keep masks by slot: ``given``
        on the device, else drawn from ``g``."""
        dev = self.device
        if given is not None:
            return [torch.as_tensor(m, device=dev) for m in given]
        return self._keep_masks(drop_calls, lambda shape, kp: torch.rand(
            shape, generator=g, device=dev) < kp)

    def _round_inputs(self, params: Tree, sel: np.ndarray,
                      sel_dev: torch.Tensor, lr: torch.Tensor,
                      g: torch.Generator,
                      seams: Optional[Dict[str, Any]] = None,
                      aggregate: bool = True,
                      round_idx: Optional[int] = None,
                      pop_dev: Optional[torch.Tensor] = None) -> RoundInputs:
        """A round's inputs (:class:`RoundInputs`), fresh on the device: the
        clients ``sel`` (``sel_dev`` on the device), the rate ``lr``, then
        the draws of ``g`` in the order the round consumes them: per client
        its epoch permutations (or replacement batches), then each step it
        runs its crop-and-flip draws and its dropout keep masks
        (:meth:`_leg_draws`); the same again for a second leg
        (:meth:`_second_leg_hp`); DisPFL's screening batch (per client its
        rows, its crop-and-flip draws, then its keep masks) and regrow
        scores;
        after all of that, with ``aggregate``, the int8 wire's uniforms and
        the weak-DP noise (per client, per leaf). With ``aggregate`` and
        faults, the fault draws of round ``round_idx`` (from the run seed,
        the round and the population client ids alone:
        ``robust.faults.client_draws``). Last the host inputs of round
        ``round_idx`` (:meth:`_host_inputs`). ``seams`` (``run_round``'s
        ``perms``, ``batch_idx``, ``augment``, ``dropout``,
        ``agg_uniforms``, ``faults``, ``collude``, ``dp_noise``,
        ``perms_2``, ``augment_2``, ``dropout_2``, ``screen_idx``,
        ``screen_augment``, ``screen_dropout``, ``regrow_u``) replace the
        draws they name. ``pop_dev`` (store mode, where ``sel_dev`` holds slab
        positions) the population ids on the device. Both round loops draw
        through here."""
        seams = seams or {}
        hp, dev = self.hp, self.device
        n_valid = [self._n_train[int(c)] for c in sel]
        drop_calls = self._dropout_calls(params)
        replace = hp.batching == "replacement"
        perms, dropout, augment = self._leg_draws(
            hp, n_valid, g, drop_calls,
            seams.get("batch_idx" if replace else "perms"),
            seams.get("dropout"), seams.get("augment"))
        perms_2 = dropout_2 = augment_2 = None
        hp_2 = self._second_leg_hp()
        if hp_2 is not None:
            perms_2, dropout_2, augment_2 = self._leg_draws(
                hp_2, n_valid, g, drop_calls, seams.get("perms_2"),
                seams.get("dropout_2"), seams.get("augment_2"))
        screen_idx = screen_dropout = screen_augment = regrow_u = None
        if self._draws_screen:
            given, given_drop = seams.get("screen_idx"), seams.get(
                "screen_dropout")
            given_aug = seams.get("screen_augment")
            rows, screen_dropout = [], ([] if drop_calls else None)
            augs = []
            for i, n in enumerate(n_valid):
                rows.append(
                    torch.as_tensor(given[i], dtype=torch.int64, device=dev)
                    if given is not None else torch.randint(
                        0, max(n, 1), (hp.batch_size,), generator=g,
                        device=dev))
                if self.augment_fn is not None:
                    augs.append(
                        torch.as_tensor(np.asarray(given_aug[i])).to(dev)
                        if given_aug is not None
                        else crop_flip_draws(g, hp.batch_size))
                if drop_calls:
                    screen_dropout.append(self._step_keep_masks(
                        drop_calls, g,
                        None if given_drop is None else given_drop[i]))
            screen_idx = torch.stack(rows)
            if augs:
                screen_augment = torch.stack(augs)
        if self._draws_regrow:
            regrow_u = seams.get("regrow_u")
            flags = kernel_flags(params)
            regrow_u = (
                {k: torch.rand((len(n_valid),) + tuple(v.shape),
                               generator=g, device=dev)
                 for k, v in params.items() if flags[k]}
                if regrow_u is None else
                {k: torch.as_tensor(regrow_u[k], dtype=torch.float32,
                                    device=dev)
                 for k in params if flags[k]})
        uniforms = dp_noise = faults = collude = None
        if aggregate and self._needs_uniforms():
            u = seams.get("agg_uniforms")
            uniforms = (torch.as_tensor(u, dtype=torch.float32, device=dev)
                        if u is not None else
                        torch.rand(self._uniforms_shape(params), generator=g,
                                   device=dev))
        if aggregate and self._needs_dp_noise():
            dp_noise = seams.get("dp_noise")
            if dp_noise is None:
                rows = [{k: torch.randn(v.shape, generator=g, device=dev,
                                        dtype=v.dtype)
                         for k, v in params.items()} for _ in n_valid]
                dp_noise = {k: torch.stack([r[k] for r in rows])
                            for k in params}
            dp_noise = {k: torch.as_tensor(v, device=dev)
                        for k, v in dp_noise.items()}
        if aggregate and self.fault_fn is not None:
            faults = seams.get("faults")
            if faults is None:
                faults = self.fault_fn.draws(round_idx, sel)
            faults = _to_device(torch.as_tensor(faults, dtype=torch.float32),
                                dev)
            collude = seams.get("collude")
            if collude is None:
                collude = self.fault_fn.direction(round_idx, params)
            if collude is not None:
                collude = {k: _to_device(torch.as_tensor(v), dev)
                           for k, v in collude.items()}
        host = {k: _to_device(v, dev)
                for k, v in self._host_inputs(round_idx).items()}
        if self.mesh is not None:
            host["mesh_rows"] = self._mesh_rows(sel, aggregate, round_idx)
        return RoundInputs(
            n_valid=n_valid, sel=sel_dev,
            n_sel=_to_device(np.asarray(n_valid, np.float32), dev), lr=lr,
            perms=perms, dropout=dropout, augment=augment,
            uniforms=uniforms, faults=faults, collude=collude,
            dp_noise=dp_noise, perms_2=perms_2, dropout_2=dropout_2,
            augment_2=augment_2, screen_idx=screen_idx,
            screen_dropout=screen_dropout, screen_augment=screen_augment,
            regrow_u=regrow_u,
            pop=sel_dev if pop_dev is None else pop_dev, **host)

    # -- the population client store (client_store "host" / "disk") -----------
    # The store-mode round is the resident round body on a slab: the sampled
    # clients' rows of the store fields (the personal stack, the top-k
    # residual) and their data rows gathered onto the card, ``inp.sel`` their
    # positions in the slab and ``inp.pop`` their population ids (which the
    # [C] arrays that stay resident, the eval cache and the test counts, are
    # indexed by). Every gather of the body then reads rows equal to the
    # resident ones, and the per-row math and the reductions run at the same
    # widths, so a streamed run is bitwise the resident one. A quarantined
    # client keeps its previous row in the body (merge_updates,
    # merge_residual) and is staged back unchanged. The fault draws are made
    # on the host from the population ids (_round_inputs), as resident.
    #
    # On a client mesh the store follows the data's owner: each rank's store
    # holds its block's rows and its host data its block's volumes, and a
    # round's slab holds the sampled clients the rank holds (_store_own), in
    # draw order, where the resident mesh round reads its block of the
    # stacks: ``MeshRows.rows`` then holds slab positions (_on_slab). The
    # exchanges are the resident mesh round's (the loss gather, the on-mesh
    # reduce, the gather of the trained rows), so a streamed mesh round is
    # the resident mesh round on a slab, as one process's streamed round is
    # its resident round on a slab.

    def _store_own(self, ids) -> np.ndarray:
        """The clients of ``ids`` (population ids) whose rows this rank
        holds, in their order (all of them off the mesh)."""
        ids = np.asarray(ids, dtype=np.int64)
        return ids[(ids >= self._lo) & (ids < self._hi)]

    def _on_slab(self, inp: RoundInputs, slab: FederatedData,
                 n_own: int) -> RoundInputs:
        """``inp`` reading its clients' rows from a slab whose row ``j``
        holds the ``j``-th selected client this rank holds (``n_own`` of
        them; off the mesh every selected client, at ``inp.sel``)."""
        pos = _to_device(np.arange(n_own, dtype=np.int64), self.device)
        mr = inp.mesh_rows
        if mr is not None:
            mr = mr._replace(rows=pos)
        return dataclasses.replace(inp, sel=pos, slab=slab, mesh_rows=mr)

    def _stage_rows(self, host: torch.Tensor, ids: Sequence[int],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows ``ids`` of the host array ``host`` on the device (into
        ``out`` when given): gathered into a pinned buffer, then copied
        without a wait on the card."""
        pin = self.device.type == "cuda"
        idx = torch.as_tensor(np.asarray(ids, dtype=np.int64))
        buf = torch.empty((len(idx),) + tuple(host.shape[1:]),
                          dtype=host.dtype, pin_memory=pin)
        torch.index_select(host, 0, idx, out=buf)
        if out is None:
            return buf.to(self.device, non_blocking=pin)
        return out.copy_(buf, non_blocking=pin)

    def _store_register_fields(self, params: Tree) -> None:
        """``init_state``'s hook in store mode: the streamed fields
        registered with their default rows (the personal rows the initial
        parameters, as the resident broadcast holds them; the top-k
        residual's zeros), which store nothing until a client trains.
        Registering again resets the store (a fresh ``init_state``)."""
        store = self._store
        if getattr(self, "track_personal", True):
            store.register("personal_params", params)
        if self.agg_impl == "topk":
            store.register("agg_residual",
                           {k: torch.zeros_like(v) for k, v in params.items()})
        self._store_eval_cache = None
        self._store_eval_dirty = []

    def _store_gather_rows(self, ids: Sequence[int]):
        """A round's rows on the card: the store fields' rows of ``ids``
        (the selected clients this rank holds; ``state`` replacements; the
        gather commits staged rows first, so chained rounds read the newest
        adopted ones, and is timed in ``store_gather_ms``) and the clients'
        data rows from the host data (a :class:`FederatedData` slab, the
        test rows too with the eval cache)."""
        with obs_trace.span("store_gather"):
            kw = {name: self._store.gather(name, ids, self.device)
                  for name in self._store.field_names()}
            return kw, self._data_slab(ids, test=self.eval_cache)

    def _data_slab(self, ids: Sequence[int], test: bool = False
                   ) -> FederatedData:
        """The clients ``ids``' train rows (and test rows with ``test``)
        moved from the host data (this rank's block) to the card, as a
        :class:`FederatedData` a round body reads through slab
        positions."""
        d = self.data
        rows = np.asarray(ids, dtype=np.int64) - self._lo
        return dataclasses.replace(
            d, x_train=self._stage_rows(d.x_train, rows),
            y_train=self._stage_rows(d.y_train, rows),
            x_test=self._stage_rows(d.x_test, rows) if test else None,
            y_test=self._stage_rows(d.y_test, rows) if test else None,
            x_val=None, y_val=None, n_val=None)

    def _store_adopt_round(self, new_state: Any, ids: Sequence[int],
                           changed: Sequence[int]) -> Any:
        """After a round or block: its trained row slabs (of the clients
        ``ids`` this rank holds) staged in the store (still on the card:
        the copy to the host waits for the next gather or flush, and a
        watchdog's :meth:`store_discard` drops them first) and dropped from
        the state. ``changed`` (every rank's trained clients) marks the
        rows the store eval evaluates anew."""
        kw = {}
        for name in self._store.field_names():
            self._store.stage(name, ids, getattr(new_state, name))
            kw[name] = None
        if self._store.has_field("personal_params"):
            self._store_eval_dirty.append(np.asarray(changed))
        return dataclasses.replace(new_state, **kw)

    def _store_prefetch_next(self, next_ids, cur_ids) -> None:
        """Warm the next cohort's host rows (those this rank holds) while
        the card runs this one; the rows this cohort dirtied are left out
        (their newest values are the staged slabs the next gather
        commits)."""
        cur = set(int(i) for i in np.asarray(cur_ids))
        ids = [int(i) for i in self._store_own(next_ids) if int(i) not in cur]
        for name in self._store.field_names():
            self._store.prefetch(name, ids)

    def _store_round(self, state: Any, round_idx: int, inp: RoundInputs):
        """One streamed round (``run_round`` in store mode): the rows of
        the sampled clients this rank holds gathered onto the card, the
        round body on that slab, the trained rows staged back, the next
        cohort prefetched."""
        sel = self._selected_client_indexes(round_idx)
        own = self._store_own(sel)
        kw, slab = self._store_gather_rows(own)
        inp = self._on_slab(inp, slab, len(own))
        with obs_trace.span("dispatch_round"):
            new_state, metrics = self._round_body(
                dataclasses.replace(state, **kw), inp)
        new_state = self._store_adopt_round(new_state, own, sel)
        self._store_prefetch_next(
            sample_client_indexes(round_idx + 1, self.num_clients,
                                  self.clients_per_round), own)
        return new_state, metrics

    def _run_rounds_fused_store(self, state: Any, start_round: int,
                                n_rounds: int, eval_every: int, seams,
                                on_first_round=None):
        """A fused block over the store: one gather of the block's union of
        clients (on a client mesh the union of those this rank holds) into
        the first rows of slab buffers of ``min(K * S, C)`` rows (``C /
        D`` on the mesh; so one graph serves every block), round ``i``
        addressing the slab at ``searchsorted(union, sels[i])`` (rows chain
        within the block through the slab as they do through the resident
        stack), one staging of the union's rows at the end. The in-graph
        eval cadence needs the whole cohort resident and is refused."""
        if eval_every:
            raise ValueError(
                f"{self.name}: the fused in-graph eval cadence "
                "(frequency_of_the_test with fuse_rounds>1) evaluates "
                "the full [C] cohort inside the block; with "
                "--client_store the cohort is not resident — evaluate "
                "between blocks (eval_every=0) or run fuse_rounds=1")
        self._prepare_round(state)
        rounds = range(start_round, start_round + n_rounds)
        sels = [self._selected_client_indexes(r) for r in rounds]
        union = np.unique(np.concatenate(
            [self._store_own(s) for s in sels])).astype(np.int64)
        fused = self._get_fused_fn(
            state, len(sels[0]),
            min(n_rounds * len(sels[0]), self.num_local_clients))
        u = len(union)
        rows = {name: self._store.gather(name, union, self.device)
                for name in self._store.field_names()}
        d, slab = self.data, fused.slab
        for f in ("x_train", "y_train", "x_test", "y_test"):
            if getattr(slab, f) is not None:
                self._stage_rows(getattr(d, f), union - self._lo,
                                 getattr(slab, f)[:u])
        fused.load(state, rows)
        del rows
        # per round each selected client's row in the slab (a client
        # another rank holds is never read at its position)
        views = np.stack([np.searchsorted(union, s) for s in sels])
        new_state, ys = self._fused_rounds(
            fused, state, rounds, sels,
            _to_device(views.astype(np.int64), self.device),
            _to_device(np.stack(sels).astype(np.int64), self.device), 0,
            seams, n_rows=u, on_first_round=on_first_round,
            slab_pos=views)
        new_state = self._store_adopt_round(
            new_state, union, np.unique(np.concatenate(sels)))
        nxt = np.unique(np.concatenate([
            sample_client_indexes(r, self.num_clients,
                                  self.clients_per_round)
            for r in range(start_round + n_rounds,
                           start_round + 2 * n_rounds)]))
        self._store_prefetch_next(nxt, union)
        return new_state, ys

    def _store_has_personal(self) -> bool:
        """The personal stack lives in the client store (the state holds
        None between rounds)."""
        return self._store is not None and \
            self._store.has_field("personal_params")

    def store_discard(self) -> None:
        """The watchdog's RETRY and SKIP (the runner calls it on a
        rollback): the rolled-back attempt's staged rows dropped before
        anything commits them, and the store eval's terms invalidated (a
        full pass at the next eval is always right)."""
        if self._store is None:
            return
        self._store.discard()
        self._store_eval_cache = None
        self._store_eval_dirty = []

    def store_flush(self) -> None:
        """Staged rows committed to storage."""
        if self._store is not None:
            self._store.commit()

    def _personal_eval_store(self) -> Dict[str, torch.Tensor]:
        """The personal eval over the store's stack: a full pass over every
        stored row (each client's row moved to the card in turn) when
        there are no terms yet or every client changed (the first eval,
        after a resume or a rollback), else the kept ``[C]`` terms with the
        rows the rounds since changed evaluated anew. Each client's terms
        come from the same ``eval_client`` call on the same row as the
        resident full pass's, so the result is bitwise that pass. On a
        client mesh each rank evaluates the rows it holds and the terms are
        gathered into the order of the rows (:meth:`_eval_terms`; every
        rank knows every trained client, so the ranks agree on the
        rows)."""
        dev, c = self.device, self.num_clients
        dirty = (np.unique(np.concatenate(self._store_eval_dirty))
                 if self._store_eval_dirty else np.zeros((0,), np.int64))
        full = self._store_eval_cache is None or dirty.size >= c
        rows = np.arange(c) if full else dirty
        if rows.size:
            own = self._store_own(rows)
            sub = self._store.gather("personal_params", own)
            pos = {int(r): i for i, r in enumerate(own)}
            c_s, l_s = self._eval_terms(
                rows, lambda r: {k: _to_device(v[pos[int(r)]], dev)
                                 for k, v in sub.items()})
        if full:
            correct, loss_sum = c_s, l_s
        else:
            correct, loss_sum = self._store_eval_cache
            if rows.size:
                idx = _to_device(rows.astype(np.int64), dev)
                correct = correct.index_copy(0, idx, c_s)
                loss_sum = loss_sum.index_copy(0, idx, l_s)
        self._store_eval_cache = (correct, loss_sum)
        self._store_eval_dirty = []
        return _personal_metrics(correct, loss_sum, self._n_test_eval)

    # -- fused multi-round execution -------------------------------------------
    def _get_fused_fn(self, state: Any, n_sel: int,
                      width: int = 0) -> _FusedRounds:
        """The fused loop's buffers and graphs for rounds that draw
        ``n_sel`` clients (in store mode on slabs of at least ``width``
        rows), built at the first block (states of one algorithm share
        their shapes) and anew for a state whose tensor fields are not the
        buffers' (one whose ``eval_cache`` was dropped, as FedAvg's
        finalize does, or is live again) or a wider block."""
        store = set(self._store.field_names()) if width else set()
        fields = [f.name for f in dataclasses.fields(state)
                  if f.name in store or _is_buffer(getattr(state, f.name))]
        fz = self._fused
        if fz is not None and (fz.fields != fields or fz.width < width
                               or bool(fz.width) != bool(width)):
            fz.release()
            self._fused = None
        if self._fused is None:
            self._fused = _FusedRounds(self, state, n_sel, width)
        return self._fused

    def release_graphs(self) -> None:
        """Drop the fused loop's graphs and buffers (the next block builds
        them anew). On a client mesh over NCCL call it before the mesh is
        torn down: NCCL does not destroy a communicator while a graph that
        holds its collectives lives (``ClientMesh.destroy`` hangs)."""
        if self._fused is not None:
            self._fused.release()
            self._fused = None

    def _graph_key(self, inp: RoundInputs) -> tuple:
        """A round graph's key: the step-count key (:meth:`_step_key`), on a
        client mesh followed by how the ranks hold the draw (``counts`` and
        ``order``), which fixes the rows each rank trains and the gathers'
        shapes."""
        key = self._step_key(inp.n_valid)
        mr = inp.mesh_rows
        if mr is None:
            return key
        return key + ((tuple(mr.counts), tuple(mr.order)),)

    def _step_key(self, n_valid: Sequence[int]) -> tuple:
        """A round graph's key: per client the batches a local epoch runs
        (``core.trainer.active_steps``; the steps a second leg runs follow,
        its batch layout is the same), not the sample counts, which the
        graph reads from a buffer. With full batches one key."""
        hp = self.hp
        if self._full_batches():
            return (hp.steps_per_epoch,) * len(n_valid)
        return tuple(min(hp.steps_per_epoch, -(-int(n) // hp.batch_size))
                     for n in n_valid)

    def run_rounds_fused(self, state: Any, start_round: int, n_rounds: int,
                         eval_every: int = 0,
                         seams: Optional[Sequence[Dict[str, Any]]] = None,
                         on_first_round=None):
        """Run rounds ``start_round .. start_round + n_rounds - 1`` as one
        block: on the card each round is one replay of a captured CUDA graph
        of :meth:`_round_body` (captured at the first block of its client-
        draw key, after FUSED_WARMUPS warm-up runs), each eval round
        (``(r + 1) % eval_every == 0``) one replay of the eval's graph; on
        the CPU the same bodies run as they are. Between replays the host
        writes the round's client ids, rate and draws into the buffers the
        graph reads (:meth:`_FusedRounds.write`), drawn from a copy of the
        state's generator by :meth:`_round_inputs`, as :meth:`run_round`
        draws them, so a block equals ``n_rounds`` ``run_round`` calls bit
        for bit. ``on_first_round(state)``, if given, receives a copy of the
        state after the block's first round (the runner prices the run's
        cost from it, as the eager loop prices its first round's state).
        With a client store the block streams its clients' union
        (:meth:`_run_rounds_fused_store`). On a client mesh every rank calls
        it with the same arguments: over NCCL the round graph holds the
        round's collectives (a rank captures, replays and evicts in the
        rounds every other rank does); a gloo group on the card, whose
        collectives run on the host, is refused with ``ValueError``.
        ``seams``, one dict per round of ``run_round``'s seams (``perms``,
        ``batch_idx``, ``augment``, ``dropout``, ``agg_uniforms``,
        ``faults``, ``collude``, ``dp_noise``, ``perms_2``, ``augment_2``,
        ``dropout_2``, ``screen_idx``, ``screen_augment``,
        ``screen_dropout``, ``regrow_u``), replace the draws they name.

        Returns ``(state, ys)``, ``ys`` a :class:`FusedMetrics` whose
        ``train_loss`` is ``[n_rounds]`` and whose ``eval`` (with
        ``eval_every``) holds each eval metric, zero on rounds without eval.
        The input state is left as it was, generator included; the returned
        state is a copy, never the graph's buffers. A round the card cannot
        capture raises ``ValueError``: there is no eager fallback."""
        if not self.supports_fused:  # the reference's words
            raise ValueError(
                f"{self.name}: fused rounds need every per-round host "
                "input to be a pure function of round_idx; this "
                "algorithm's host work is data-DEPENDENT (FedFomo biases "
                "its neighbor draw by accumulated weights read back from "
                "device, fedfomo_api.py:130-144; TurboAggregate's "
                "share/reconstruct protocol is host-interactive) — run it "
                "with fuse_rounds=1")
        if self.mesh is not None and self.device.type == "cuda" \
                and self.mesh.backend != "nccl":
            raise ValueError(
                f"{self.name}: fused rounds on a client mesh capture the "
                "round's collectives in a CUDA graph, which needs the NCCL "
                f"backend; the {self.mesh.backend} group's collectives run "
                "on the host and cannot be captured — make the mesh with "
                "backend='nccl' or run the rounds one at a time")
        if seams is not None and len(seams) != n_rounds:
            raise ValueError(f"seams: {len(seams)} rounds for a block of "
                             f"{n_rounds}")
        if self._store is not None:
            return self._run_rounds_fused_store(state, start_round,
                                                n_rounds, eval_every, seams,
                                                on_first_round)
        self._prepare_round(state)
        rounds = range(start_round, start_round + n_rounds)
        sels = [self._selected_client_indexes(r) for r in rounds]
        fused = self._get_fused_fn(state, len(sels[0]))
        fused.load(state)
        sel_dev = _to_device(np.stack(sels).astype(np.int64), self.device)
        return self._fused_rounds(fused, state, rounds, sels, sel_dev, None,
                                  eval_every, seams,
                                  on_first_round=on_first_round)

    def _fused_rounds(self, fused: _FusedRounds, state: Any, rounds,
                      sels: List[np.ndarray], sel_dev: torch.Tensor,
                      pop_dev: Optional[torch.Tensor], eval_every: int,
                      seams, n_rows: int = 0, on_first_round=None,
                      slab_pos: Optional[np.ndarray] = None):
        """The replays of a block whose state is in ``fused``'s buffers:
        per round its inputs drawn, written and its graph replayed (the
        eval's after an eval round); ``on_first_round`` gets a copy of the
        state after the first. ``slab_pos`` (store mode, ``[K, S]`` on the
        host): per round each client's row in the slab, which a client
        mesh's rank reads its own clients at. Returns ``(state, ys)``."""
        n_rounds = len(rounds)
        g = clone_generator(state.generator)
        template = self._template(state)
        lrs = _to_device(torch.stack([round_lr(self.hp, r) for r in rounds]),
                         self.device)
        names = list(self._round_metric_names)
        rows = torch.zeros((len(names), n_rounds), dtype=torch.float64,
                           device=self.device)
        ev_rows = None
        for k, r in enumerate(rounds):
            inp = self._round_inputs(
                template, sels[k], sel_dev[k], lrs[k], g,
                None if seams is None else seams[k], round_idx=r,
                pop_dev=None if pop_dev is None else pop_dev[k])
            mr = inp.mesh_rows
            if slab_pos is not None and mr is not None:
                inp.mesh_rows = mr._replace(rows=_to_device(
                    slab_pos[k][mr.own].astype(np.int64), self.device))
            fused.write(inp)
            rows[:, k].copy_(fused.round_graph(self, inp)())
            if k == 0 and on_first_round is not None:
                on_first_round(fused.export(state, clone_generator(g),
                                            n_rows))
            if eval_every and (r + 1) % eval_every == 0:
                ev = fused.eval_graph(self)()
                if ev_rows is None:
                    ev_rows = torch.zeros((len(ev), n_rounds),
                                          dtype=torch.float64,
                                          device=self.device)
                ev_rows[:, k].copy_(ev)
        packed = rows if ev_rows is None else torch.cat([rows, ev_rows])
        return (fused.export(state, g, n_rows),
                FusedMetrics(names, fused.eval_names if ev_rows is not None
                             else [], packed))

    def _fused_block_loop(self, state: Any, start_round: int, total: int,
                          block: int, eval_every: int, on_record,
                          timed: bool = False, on_block=None,
                          on_first_round=None):
        """The shared fused-block loop (``run(fuse_rounds=K)`` and the
        CLI's ``--fuse_rounds``): dispatch block b+1, then materialize and
        emit block b's per-round records, so the card's queue never drains.
        ``on_record(round_idx, rec, state_out)`` receives each round's
        record in order with the emitting block's output state;
        ``on_block(end_round, state_out)`` fires once per flushed block,
        after its records (the runner's block-boundary checkpoint);
        ``on_first_round(state)`` once, with the state after the loop's
        first round (:meth:`run_rounds_fused`).

        ``timed=True`` stamps ``round_time_s`` as the block's flush-to-flush
        wall time split evenly: the per-run sum is the wall time, a round's
        share right to within one block. A success-path flush error
        propagates; with an exception already unwinding, the last flush is
        best effort."""
        mark = time.perf_counter()
        pending = None  # the previous block, dispatched, not yet fetched

        def flush(p):
            nonlocal mark
            r0, k, ys, state_out = p
            # the span sits at the one place the fused loop waits on the
            # card (per-round spans would sync inside the block)
            with obs_trace.span("fused_block_flush") as sp:
                sp.add("start_round", r0)
                sp.add("rounds", k)
                host = dict(ys.materialize())  # waits for the block
            now = time.perf_counter()
            wall, mark = now - mark, now
            ev = host.pop("eval", None)
            for i in range(k):
                rec: Dict[str, Any] = {"round": r0 + i}
                for name in self._round_metric_names:
                    rec[name] = float(host[name][i])
                if ev is not None and (r0 + i + 1) % eval_every == 0:
                    rec.update({k2: float(v[i]) for k2, v in ev.items()})
                if timed:
                    rec["round_time_s"] = wall / k
                on_record(r0 + i, rec, state_out)
            if on_block is not None:
                on_block(r0 + k, state_out)

        try:
            for r0 in range(start_round, total, block):
                k = min(block, total - r0)
                with obs_trace.span("fused_block_dispatch") as sp:
                    sp.add("start_round", r0)
                    state, ys = self.run_rounds_fused(
                        state, r0, k, eval_every=eval_every,
                        on_first_round=(on_first_round if r0 == start_round
                                        else None))
                if pending is not None:
                    # cleared before the flush: if it raises mid-way, the
                    # finally must not emit its records again
                    p, pending = pending, None
                    flush(p)
                pending = (r0, k, ys, state)
            if pending is not None:
                p, pending = pending, None
                flush(p)  # success path: a flush error propagates
        finally:
            if pending is not None:  # an exception is unwinding
                try:
                    flush(pending)
                except Exception:
                    logger.exception("fused block metrics lost")
        return state

    def _run_fused(self, comm_rounds: int, eval_every: int, state: Any,
                   finalize: bool, block: int):
        """:meth:`run` with the round loop in fused blocks."""
        if state is None:
            state = self.init_state()
        history: List[Dict[str, Any]] = []

        def on_record(r, rec, _state_out):
            history.append(rec)
            logger.info("%s round %d: %s", self.name, r, rec)

        state = self._fused_block_loop(state, 0, comm_rounds, block,
                                       eval_every, on_record, timed=True)
        return self._finalize_into_history(state, history, finalize)

    def _finalize_into_history(self, state: Any, history: List, finalize:
                               bool):
        """The shared tail of both round loops: the algorithm's final pass, its
        record (round = -1) appended to the history."""
        from ..utils.records import to_float

        if finalize:
            state, final = self.finalize(state)
            if final is not None:
                record = {k: to_float(v) for k, v in final.items()}
                history.append(record)
                logger.info("%s final: %s", self.name, record)
        return state, history

    # -- driver ----------------------------------------------------------------
    def run(self, comm_rounds: int, eval_every: int = 1, state: Any = None,
            finalize: bool = True, fuse_rounds: int = 1):
        """The federated training loop: ``comm_rounds`` rounds, an eval every
        ``eval_every`` rounds, then the algorithm's final pass. Returns
        ``(state, history)``; history values are Python floats.

        Each round's metrics are fetched to the host one round late
        (:class:`utils.records.DeferredRecords`), so the card is never
        idle waiting on the host's conversion; ``round_time_s`` is stamped
        at those flushes, so the sum over the run is its wall time.
        ``fuse_rounds=K`` > 1 runs the rounds in K-round fused blocks
        (:meth:`run_rounds_fused`), the same history but ``round_time_s``
        (a block's time split evenly)."""
        from ..utils.records import DeferredRecords

        if fuse_rounds > 1:
            return self._run_fused(comm_rounds, eval_every, state, finalize,
                                   fuse_rounds)
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
        return self._finalize_into_history(state, history, finalize)


class PersonalAlgorithm(FedAlgorithm):
    """What the algorithms without a central aggregate share (Local, DPSGD,
    DisPFL, SubAvg, FedFomo): a refusal of the central aggregate's
    options."""

    def __init__(self, *args, **kwargs):
        for opt in ("fault_spec", "robust_agg", "guard"):
            if kwargs.get(opt) not in (None, "", "none", False):
                raise ValueError(
                    f"{opt}: {self.name} has no central aggregate to guard "
                    "or robustify")
        super().__init__(*args, **kwargs)
