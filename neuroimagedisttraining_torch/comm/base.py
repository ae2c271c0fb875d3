"""Backend-neutral comm manager ABC + Observer (counterpart of
``neuroimagedisttraining_tpu/comm/base.py``).

Rebuild of ``fedml_core/distributed/communication/base_com_manager.py:7-27``
and ``observer.py:4-7``.
"""
from __future__ import annotations

import abc
import logging
import queue
import threading
from typing import List, Optional

from .message import Message

logger = logging.getLogger(__name__)


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: str, msg: Message) -> None:
        ...


class CommCounters:
    """Per-manager transport accounting: serialized bytes and message
    counts actually sent/received over the wire (the measured side of
    obs/comm.py's analytical wire-cost model). Updated by every backend
    at its send/receive sites; ``snapshot()`` is what a cross-silo
    round loop folds into its telemetry.

    Thread-safe: the receive pump runs on its own thread while round
    loops send from the caller's thread, so the += pairs are guarded —
    an unsynchronized bytes+=/messages+= pair can tear (lost updates,
    or a snapshot observing bytes from a send whose message count
    hasn't landed)."""

    __slots__ = ("bytes_sent", "bytes_received", "messages_sent",
                 "messages_received", "messages_retried", "_lock")

    def __init__(self):
        self.bytes_sent = 0
        self.bytes_received = 0
        self.messages_sent = 0
        self.messages_received = 0
        # send attempts that failed transiently and were re-issued by
        # fed.protocol.send_with_retry — the degradation signal the fed
        # obs fold surfaces alongside the byte counters
        self.messages_retried = 0
        self._lock = threading.Lock()

    def note_sent(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_sent += int(nbytes)
            self.messages_sent += 1

    def note_received(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_received += int(nbytes)
            self.messages_received += 1

    def note_retry(self) -> None:
        with self._lock:
            self.messages_retried += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"comm_bytes_sent": self.bytes_sent,
                    "comm_bytes_received": self.bytes_received,
                    "comm_messages_sent": self.messages_sent,
                    "comm_messages_received": self.messages_received,
                    "comm_messages_retried": self.messages_retried}


class BaseCommunicationManager(abc.ABC):
    """send/receive + observer dispatch contract."""

    def __init__(self):
        self._observers: List[Observer] = []
        self.counters = CommCounters()

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Run the receive loop, dispatching to observers until stopped."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def _notify(self, msg: Message) -> None:
        for obs in list(self._observers):
            try:
                obs.receive_message(msg.type, msg)
            except Exception:
                # a failing handler must not kill the rank's receive pump —
                # log with traceback and keep serving later messages
                logger.exception(
                    "handler for %r raised; receive loop continues", msg.type)


class PollingReceiveLoopMixin:
    """``handle_receive_message``/``stop_receive_message`` over a blocking
    ``self.recv(timeout_s)`` — the receive pump every backend shares."""

    def _init_pump(self) -> None:
        self._stop = threading.Event()

    def handle_receive_message(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self.recv(timeout_s=0.1)
            except OSError:
                # covers ConnectionError from the inbox mixin and the plain
                # OSError the native TCP backend raises on transport failure
                logger.error("transport lost; receive pump exiting")
                return
            if msg is not None:
                self._notify(msg)

    def stop_receive_message(self) -> None:
        self._stop.set()


class QueueInboxMixin(PollingReceiveLoopMixin):
    """Receive pump fed by an inbound bytes queue (``self._inbox.put(raw)``
    from the backend's reader thread / RPC servicer).

    ``_fail_inbox()`` marks the transport dead: once the queue drains,
    ``recv`` raises ``ConnectionError`` instead of blocking forever.
    """

    def _init_pump(self) -> None:
        super()._init_pump()
        self._inbox: "queue.Queue[bytes]" = queue.Queue()
        self._lost = threading.Event()

    def _fail_inbox(self) -> None:
        self._lost.set()

    def recv(self, timeout_s: float = -1.0) -> Optional[Message]:
        """Blocking receive of one message (None on timeout); raises
        ``ConnectionError`` once the transport is lost and the queue is
        drained."""
        block_forever = timeout_s < 0
        while True:
            try:
                payload = self._inbox.get(
                    timeout=0.5 if block_forever else timeout_s)
            except queue.Empty:
                if self._lost.is_set():
                    # the reader may have enqueued a final message between
                    # our timeout and the _lost check — drain before failing
                    try:
                        payload = self._inbox.get_nowait()
                    except queue.Empty:
                        raise ConnectionError("transport lost") from None
                    self.counters.note_received(len(payload))
                    return Message.from_bytes(payload)
                if block_forever:
                    continue
                return None
            self.counters.note_received(len(payload))
            return Message.from_bytes(payload)
