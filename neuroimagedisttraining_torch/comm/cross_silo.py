"""Cross-silo federated training over a real transport (counterpart of
``neuroimagedisttraining_tpu/comm/cross_silo.py``, over trees of torch
tensors or numpy arrays; updates arrive as numpy leaves).

The deployment adapter SURVEY §5.8/§7.9 calls for: the same FedAvg
aggregation semantics as the in-mesh path (sample-weighted parameter mean,
``fedavg_api.py:102-117``), but with clients on separate processes/hosts
exchanging Messages over a comm backend (native TCP or in-process). In-mesh
SPMD remains the perf path; this layer exists so a real multi-hospital
deployment has a transport with the same math.

Protocol (star topology, server = rank 0):
  server --MSG_TYPE_GLOBAL_MODEL{round}--> each client
  client --MSG_TYPE_LOCAL_UPDATE{round, n_samples, params}--> server
  ... comm_round times ... then server --MSG_TYPE_FINISH--> clients
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .manager import ClientManager, ServerManager
from .message import Message, to_numpy, tree_leaves, tree_map

logger = logging.getLogger(__name__)

# local_train_fn(params, round_idx) -> (new_params, n_samples, train_loss)
LocalTrainFn = Callable[[Any, int], Tuple[Any, int, float]]


@dataclasses.dataclass
class RoundOutcome:
    """Typed result of one cross-silo round — the quorum shortfall that
    used to surface only as an unhandled ``queue.Empty`` is now an
    explicit verdict the caller can branch on.

    ``status``:
      * ``"completed"`` — every client reported; full aggregate applied;
      * ``"quorum"`` — the collect window timed out but at least
        ``quorum`` clients reported; their updates aggregated with
        weights renormalized over the survivors (the guard machinery's
        survivor-renormalization rule, applied at the transport layer);
      * ``"timeout"`` — fewer than ``quorum`` clients reported; the
        global model is left untouched (carry, like a zero-survivor
        guarded round).
    """

    status: str                       # completed | quorum | timeout
    round_idx: int
    received: List[int]               # client ranks that reported in time
    missing: List[int]                # client ranks that did not
    record: Dict[str, float]          # the history record (round, loss, ...)

    @property
    def applied(self) -> bool:
        """Whether this round changed the global model."""
        return self.status in ("completed", "quorum")


class CrossSiloServer(ServerManager):
    """Rank-0 aggregator.

    ``mask``: optional 0/1 pytree — when set, params travel sparse (values
    + bitmap, ``Message.add_masked_tensor``), the communication-efficient
    transport SalientGrads' sparse models enable; clients mirror the mask
    in their replies.
    """

    def __init__(self, comm, world_size: int, global_params: Any,
                 mask: Any = None):
        super().__init__(comm, rank=0, world_size=world_size)
        self.global_params = global_params
        self.mask = mask
        self._updates: "queue.Queue[Message]" = queue.Queue()
        self.register_message_receive_handler(
            Message.MSG_TYPE_LOCAL_UPDATE, self._updates.put)
        self.history: List[Dict[str, float]] = []

    def run_round(self, round_idx: int, timeout_s: float = 120.0,
                  quorum: Optional[int] = None) -> RoundOutcome:
        """Broadcast the global model, collect client updates, aggregate.

        ``timeout_s`` bounds the wait for EACH update; ``quorum``
        (default: all clients) is the minimum number of reporting clients
        needed to apply an aggregate at all. See :class:`RoundOutcome`
        for the completed/quorum/timeout semantics — a shortfall is a
        typed verdict, never a silent return or an unhandled
        ``queue.Empty``."""
        n_clients = self.world_size - 1
        quorum = n_clients if quorum is None else max(1, int(quorum))
        sparse_payload = None
        if self.mask is not None:
            # sparsify once; the identical payload goes to every client
            probe = Message(Message.MSG_TYPE_GLOBAL_MODEL, 0, 0)
            probe.add_masked_tensor("params", self.global_params, self.mask)
            sparse_payload = probe.tensors["params"]
        for dest in range(1, self.world_size):
            msg = Message(Message.MSG_TYPE_GLOBAL_MODEL, 0, dest)
            msg.add("round", round_idx)
            if sparse_payload is not None:
                msg.add("sparse", True)
                msg.tensors["params"] = sparse_payload
            else:
                msg.add_tensor("params", self.global_params)
            self.send_message(msg)
        updates: List[Tuple[Any, float]] = []
        losses: List[float] = []
        seen: set = set()
        timed_out = False
        while len(updates) < n_clients:
            try:
                msg = self._updates.get(timeout=timeout_s)
            except queue.Empty:
                timed_out = True
                break
            # drop stragglers from earlier rounds and duplicate senders —
            # averaging a stale round-r update into round r+1 would silently
            # corrupt the global model (a stale ERROR reply must not abort
            # a later valid round either, so the round filter comes first)
            if int(msg.get("round", -1)) != round_idx:
                logger.warning(
                    "dropping stale update from rank %d (round %s != %d)",
                    msg.sender_id, msg.get("round"), round_idx)
                continue
            if msg.get("error"):
                # a client detected a protocol violation (e.g. off-mask
                # updates under sparse transport) — fail the round with
                # the client's reason instead of timing out opaquely
                raise RuntimeError(
                    f"client {msg.sender_id} aborted round {round_idx}: "
                    f"{msg.get('error')}")
            if msg.sender_id in seen:
                logger.warning("duplicate update from rank %d dropped",
                               msg.sender_id)
                continue
            seen.add(msg.sender_id)
            updates.append((msg.get_tensor("params"),
                            float(msg.get("n_samples"))))
            losses.append(float(msg.get("train_loss", float("nan"))))
        received = sorted(seen)
        missing = [r for r in range(1, self.world_size) if r not in seen]
        if timed_out and len(updates) < quorum:
            # below quorum: carry the previous global model untouched —
            # the zero-survivor rule of robust/guard.guarded_aggregate,
            # applied at the transport layer
            logger.warning(
                "cross-silo round %d TIMEOUT: %d/%d updates (< quorum %d);"
                " global model carried", round_idx, len(updates),
                n_clients, quorum)
            rec = {"round": round_idx, "train_loss": float("nan"),
                   "clients_reported": float(len(updates))}
            self.history.append(rec)
            return RoundOutcome("timeout", round_idx, received, missing,
                                rec)
        total = sum(w for _, w in updates)
        # survivor renormalization: weights sum to 1 over the clients
        # that reported, whether that is all of them or a quorum
        weights = [w / total for _, w in updates]
        # sample-weighted FedAvg sum (fedavg_api.py:102-117)
        self.global_params = tree_map(
            lambda *leaves: sum(
                np.asarray(l) * w for l, w in zip(leaves, weights)),
            *[u for u, _ in updates],
        )
        status = "quorum" if timed_out else "completed"
        if timed_out:
            logger.warning(
                "cross-silo round %d finished with QUORUM %d/%d "
                "(missing ranks %s; weights renormalized)", round_idx,
                len(updates), n_clients, missing)
        rec = {"round": round_idx, "train_loss": float(np.nanmean(losses)),
               "clients_reported": float(len(updates))}
        self.history.append(rec)
        return RoundOutcome(status, round_idx, received, missing, rec)

    def train(self, comm_rounds: int) -> Any:
        for r in range(comm_rounds):
            outcome = self.run_round(r)
            logger.info("cross-silo round %d: %s", r, outcome.record)
        for dest in range(1, self.world_size):
            self.send_message(Message(Message.MSG_TYPE_FINISH, 0, dest))
        return self.global_params


class CrossSiloClient(ClientManager):
    """Rank >=1 local trainer."""

    def __init__(self, comm, rank: int, world_size: int,
                 local_train_fn: LocalTrainFn):
        super().__init__(comm, rank=rank, world_size=world_size)
        self.local_train_fn = local_train_fn
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.register_message_receive_handler(
            Message.MSG_TYPE_GLOBAL_MODEL, self._on_global_model)
        self.register_message_receive_handler(
            Message.MSG_TYPE_FINISH, self._on_finish)

    def _on_global_model(self, msg: Message) -> None:
        round_idx = int(msg.get("round"))
        params = msg.get_tensor("params")
        new_params, n_samples, loss = self.local_train_fn(params, round_idx)
        reply = Message(Message.MSG_TYPE_LOCAL_UPDATE, self.rank, 0)
        reply.add("round", round_idx)
        reply.add("n_samples", int(n_samples))
        reply.add("train_loss", float(loss))
        if msg.get("sparse"):
            # mirror the server's sparsity pattern (recovered from the
            # sparse payload's bitmap). Sparse transport REQUIRES a
            # mask-respecting train_fn (SalientGrads-style: params are
            # re-masked after every step) — silently dropping off-mask
            # updates would corrupt a dense trainer's result, so verify.
            mask = msg.get_tensor_mask("params")
            off = tree_map(
                lambda p, m: bool(np.any(to_numpy(p)[np.asarray(m) == 0])),
                new_params, mask)
            if any(tree_leaves(off)):
                # the receive pump logs-and-continues on handler
                # exceptions, so raising here would be invisible — tell
                # the SERVER, which fails its round with this reason
                err = ("sparse transport: local_train_fn produced nonzero "
                       "off-mask weights; use a mask-respecting trainer "
                       "(e.g. SalientGrads' post-step re-masking) or run "
                       "the server with mask=None")
                self.error = err
                reply.add("error", err)
                self.send_message(reply)
                return
            reply.add("sparse", True)
            reply.add_masked_tensor("params", new_params, mask)
        else:
            reply.add_tensor("params", new_params)
        self.send_message(reply)

    def _on_finish(self, msg: Message) -> None:
        self.done.set()
        self.comm.stop_receive_message()
