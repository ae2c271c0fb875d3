"""Checkpoint publisher: the training-side model push hook (counterpart of
``neuroimagedisttraining_tpu/serve/publisher.py``).

``CheckpointPublisher.publish(params, version)`` does three things in
one deterministic motion:

1. **Encode** the update for the wire. The first publish ships the
   full params dense (nothing exists to delta from); every later one
   ships ``params - base`` in a ``fed/wire`` codec (int8 default,
   ``--serve_wire``), where ``base`` is the previous *reconstructed*
   version.
2. **Reconstruct** the servable model by decoding its own payload:
   ``base' = base + decode(encode(delta))``. The lossy impls lose
   precision exactly once, at encode — so the worker decoding the
   identical payload lands on the identical float32 bytes. This is the
   error-feedback trick from the top-k wire applied to model pushes:
   quantization error is carried in ``params - base`` and re-shipped
   next version, it never compounds silently.
3. **Checkpoint** the reconstruction to disk (atomic tmp+rename,
   ``comm/message.py`` binary tree framing — the same serializer the
   wire uses, so "bit-identical to loading the checkpoint from disk"
   is a structural property, not a numerical hope).

A tree is any nest of dicts (the port's ``state_dict``-named parameter
dict, or a reference-shaped nested one) with torch or numpy leaves; it is
framed in the reference's leaf order (``comm/message.py``), so the same
float32 tree gives the reference's frames and checkpoint files byte for
byte. The host copies are float32 numpy.

The worker ACKs each adopted version (``serve_ack``); ``wait_acked``
is the publisher's pacing/accounting hook and the smoke's proof that
>= N pushes actually landed.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..comm.manager import ServerManager
from ..comm.message import Message, to_numpy, tree_map
from ..fed import protocol, wire
from ..fed.protocol import send_with_retry
from ..obs import xtrace
from ..obs.xtrace import XTracer
from . import (MSG_SERVE_ACK, MSG_SERVE_FINISH, MSG_SERVE_PUSH,
               PUSH_WIRE_IMPLS)

logger = logging.getLogger(__name__)


def _np_f32_tree(tree: Any) -> Any:
    return tree_map(lambda x: np.asarray(to_numpy(x), np.float32), tree)


def _tree_add(a: Any, b: Any) -> Any:
    return tree_map(
        lambda x, y: (np.asarray(x, np.float32)
                      + np.asarray(y, np.float32)), a, b)


def _tree_sub(a: Any, b: Any) -> Any:
    return tree_map(
        lambda x, y: (np.asarray(x, np.float32)
                      - np.asarray(y, np.float32)), a, b)


# -- checkpoint files ----------------------------------------------------

def checkpoint_path(ckpt_dir: str, version: int) -> str:
    return os.path.join(ckpt_dir, f"model_v{int(version):05d}.bin")


def save_checkpoint(ckpt_dir: str, version: int, params: Any) -> str:
    """Write one servable model version (atomic: a concurrent loader
    never sees a torn file)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    msg = Message("serve_ckpt", 0, 0)
    msg.add("version", int(version))
    msg.add_tensor("params", _np_f32_tree(params))
    path = checkpoint_path(ckpt_dir, version)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(msg.to_bytes())
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Tuple[int, Any]:
    """``(version, params)`` — the disk half of the bit-identity
    contract the smoke gates."""
    with open(path, "rb") as f:
        msg = Message.from_bytes(f.read())
    return int(msg.get("version")), msg.get_tensor("params")


class CheckpointPublisher(ServerManager):
    """Rank-0 manager the training loop calls ``publish`` on.

    ``worker_ranks`` is the fan-out set (default ``[worker_rank]``):
    every push/finish broadcasts to each subscribed worker, ACKs keep
    a **per-rank watermark**, and ``wait_acked`` waits for the SLOWEST
    subscriber — pacing degrades to the laggard, never past it.
    ``heartbeat_every > 0`` arms a :class:`obs.live.FleetLedger` over
    the workers (peer ``worker<rank>``), fed by their standalone
    HEARTBEAT frames and the gauge snapshots piggybacked on ACKs.
    """

    def __init__(self, comm, rank: int = 0, world_size: int = 2,
                 worker_rank: int = 1,
                 worker_ranks: Optional[List[int]] = None,
                 ckpt_dir: str = "",
                 wire_impl: str = "int8", retries: int = 2,
                 backoff_s: float = 0.05,
                 tracer: Optional[XTracer] = None,
                 heartbeat_every: float = 0.0):
        super().__init__(comm, rank=rank, world_size=world_size)
        if wire_impl not in PUSH_WIRE_IMPLS:
            raise ValueError(
                f"push wire {wire_impl!r} not in {PUSH_WIRE_IMPLS}")
        self.worker_ranks = [int(r) for r in (
            worker_ranks if worker_ranks else [worker_rank])]
        self.worker_rank = self.worker_ranks[0]
        self.ckpt_dir = ckpt_dir
        self.wire_impl = wire_impl
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.tracer = tracer
        self._base: Optional[Any] = None  # last reconstructed version
        self.pushes = 0
        self.bytes_pushed = 0
        #: version -> SHA-256 of its push frame without the trace headers
        #: (two runs of one training trajectory push equal frames), and the
        #: bytes of the frame sent to each worker
        self.push_digests: Dict[int, str] = {}
        self.push_bytes: Dict[int, int] = {}
        self._ack_cond = threading.Condition()
        self._acked = {r: -1 for r in self.worker_ranks}
        self.ledger = None
        if float(heartbeat_every) > 0:
            from ..obs import live as obs_live

            self.ledger = obs_live.FleetLedger(float(heartbeat_every))
            now = time.monotonic()
            for r in self.worker_ranks:
                self.ledger.register(f"worker{r}", now)
        self._ledger_lock = threading.Lock()
        self.register_message_receive_handler(MSG_SERVE_ACK,
                                              self._on_ack)
        # clock-sync echo for the worker-initiated HELLO (the serving
        # plane's reference clock is the publisher); registered
        # unconditionally, only ever exercised when tracing is on
        self.register_message_receive_handler(
            protocol.MSG_FED_HELLO, self._on_hello)
        # liveness frames: same inert-unless-sent idiom as the HELLO
        self.register_message_receive_handler(
            protocol.MSG_FED_HEARTBEAT, self._on_heartbeat)

    # -- protocol ---------------------------------------------------------
    def _on_hello(self, msg: Message) -> None:
        t1 = self.tracer.wall_ns() if self.tracer is not None \
            else time.time_ns()
        reply = protocol.hello_ack(msg, self.rank, self.rank, t1)
        send_with_retry(self, reply, retries=self.retries,
                        backoff_s=self.backoff_s)

    def _observe_heartbeat(self, msg: Message) -> None:
        if self.ledger is None:
            return
        from ..obs import live as obs_live

        hb = obs_live.extract_heartbeat(msg)
        if hb is None:
            return
        with self._ledger_lock:
            events = self.ledger.observe(
                hb["peer"], time.monotonic(), hb["round"], hb["gauges"])
            events += self.ledger.tick(time.monotonic())
        for ev in events:
            logger.warning("serve fleet: %s %s", ev.type, ev.message)

    def _on_heartbeat(self, msg: Message) -> None:
        self._observe_heartbeat(msg)

    def _on_ack(self, msg: Message) -> None:
        self._observe_heartbeat(msg)
        rank = int(msg.sender_id)
        with self._ack_cond:
            if rank not in self._acked:
                self._acked[rank] = -1  # late subscriber: track anyway
            self._acked[rank] = max(self._acked[rank],
                                    int(msg.get("version")))
            self._ack_cond.notify_all()

    @property
    def acked_version(self) -> int:
        """The fleet watermark: the highest version EVERY worker has
        adopted (the slowest subscriber's ack)."""
        with self._ack_cond:
            return min(self._acked.values())

    def acked_versions(self) -> Dict[int, int]:
        """Per-rank ack watermarks (the fan-out accounting view)."""
        with self._ack_cond:
            return dict(self._acked)

    def wait_acked(self, version: int, timeout_s: float = 30.0) -> bool:
        deadline = time.perf_counter() + float(timeout_s)
        with self._ack_cond:
            while min(self._acked.values()) < int(version):
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._ack_cond.wait(left)
        return True

    # -- the push ---------------------------------------------------------
    def _retarget(self, msg: Message, receiver: int) -> Message:
        """A routing clone: the SAME encoded payload (params copied
        minus the routing triple, tensor trees shared read-only)
        addressed to another subscriber — every worker decodes
        byte-identical wire content, the fan-out's bit-identity
        anchor."""
        out = Message(msg.type, self.rank, int(receiver))
        for k, v in msg.params.items():
            if k not in (Message.ARG_TYPE, Message.ARG_SENDER,
                         Message.ARG_RECEIVER):
                out.params[k] = v
        out.tensors = dict(msg.tensors)
        return out

    def publish(self, params: Any, version: int) -> str:
        """Ship one model version to every subscribed worker and
        checkpoint the reconstruction; returns the checkpoint path (''
        if ckpt_dir is unset). The encode (and the reconstruction-chain
        advance) runs ONCE per version regardless of fan-out width."""
        with xtrace.xspan(self.tracer, "publish",
                          trace_id=f"v{int(version)}",
                          args={"version": int(version)}) as pspan:
            params = _np_f32_tree(params)
            msg = Message(MSG_SERVE_PUSH, self.rank,
                          self.worker_ranks[0])
            msg.add("version", int(version))
            with xtrace.xspan(self.tracer, "encode"):
                if self._base is None:
                    # the baseline: full params, dense — bit-exact by
                    # construction, and the only push that may not be a
                    # delta
                    msg.add("kind", "full")
                    wire.encode_update(msg, params, "dense", key="delta")
                    self._base = wire.decode_update(msg, key="delta")
                else:
                    delta = _tree_sub(params, self._base)
                    msg.add("kind", "delta")
                    wire.encode_update(msg, delta, self.wire_impl,
                                       key="delta")
                    # decode OUR OWN payload: the worker's
                    # reconstruction twin
                    self._base = _tree_add(
                        self._base, wire.decode_update(msg, key="delta"))
            payload = msg.to_bytes()
            self.push_digests[int(version)] = hashlib.sha256(
                payload).hexdigest()
            if self.tracer is not None:
                # the workers' adopt spans parent to THIS publish; the
                # send stamp is their adopt-lag input
                xtrace.inject(msg, pspan.ctx(),
                              wall_ns=self.tracer.wall_ns())
                payload = msg.to_bytes()
            self.bytes_pushed += len(payload) * len(self.worker_ranks)
            self.push_bytes[int(version)] = len(payload)
            send_with_retry(self, msg, retries=self.retries,
                            backoff_s=self.backoff_s)
            for r in self.worker_ranks[1:]:
                send_with_retry(self, self._retarget(msg, r),
                                retries=self.retries,
                                backoff_s=self.backoff_s)
            self.pushes += 1
            path = ""
            if self.ckpt_dir:
                with xtrace.xspan(self.tracer, "checkpoint"):
                    path = save_checkpoint(self.ckpt_dir, version,
                                           self._base)
        if self.ledger is not None:
            with self._ledger_lock:
                self.ledger.note_round(int(version))
                events = self.ledger.tick(time.monotonic())
            for ev in events:
                logger.warning("serve fleet: %s %s", ev.type,
                               ev.message)
        logger.info("serve publish v%d -> %d worker(s): %s wire, %d B%s",
                    version, len(self.worker_ranks), msg.get("kind"),
                    len(payload), f" -> {path}" if path else "")
        return path

    def finish_worker(self) -> None:
        """Tell every worker to drain and exit (``serve_finish``)."""
        with xtrace.xspan(self.tracer, "finish",
                          trace_id="finish") as fin:
            for r in self.worker_ranks:
                msg = Message(MSG_SERVE_FINISH, self.rank, r)
                if self.tracer is not None:
                    xtrace.inject(msg, fin.ctx(),
                                  wall_ns=self.tracer.wall_ns())
                send_with_retry(self, msg, retries=self.retries,
                                backoff_s=self.backoff_s)

    def fleet_snapshot(self) -> Optional[Dict[str, Any]]:
        """The ledger's point-in-time fleet view (None when heartbeats
        are off) — the serve runtime's ``fleet.json`` source."""
        if self.ledger is None:
            return None
        with self._ledger_lock:
            return self.ledger.snapshot(time.monotonic())

    @property
    def servable_params(self) -> Optional[Any]:
        """The current reconstructed model — what the worker serves
        after adopting the latest push (and what the checkpoint
        holds)."""
        return self._base
