"""Client/Server managers: per-message-type handler dispatch over any
comm backend.

Rebuild of ``fedml_core/distributed/client/client_manager.py:13-73`` and
``server/server_manager.py:13-68`` (Observer registering handler callbacks
and pumping the backend's receive loop). ``finish()`` stops the loop
cleanly instead of the reference's ``MPI.COMM_WORLD.Abort()``.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict

from .base import BaseCommunicationManager, Observer
from .message import Message

logger = logging.getLogger(__name__)

MessageHandler = Callable[[Message], None]


class DistributedManager(Observer):
    """Shared base for both sides (the reference duplicates this class)."""

    def __init__(self, comm: BaseCommunicationManager, rank: int,
                 world_size: int):
        self.comm = comm
        self.rank = rank
        self.world_size = world_size
        self._handlers: Dict[str, MessageHandler] = {}
        self._thread: threading.Thread | None = None
        comm.add_observer(self)

    # client_manager.py:59-61
    def register_message_receive_handler(self, msg_type: str,
                                         handler: MessageHandler) -> None:
        self._handlers[msg_type] = handler

    def receive_message(self, msg_type: str, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            logger.warning("rank %d: no handler for %r", self.rank, msg_type)
            return
        handler(msg)

    def send_message(self, msg: Message) -> None:
        self.comm.send_message(msg)

    def run(self, background: bool = False) -> None:
        """Pump the receive loop (client_manager.py:36-38); with
        ``background=True`` the loop runs in a daemon thread."""
        if background:
            self._thread = threading.Thread(
                target=self.comm.handle_receive_message, daemon=True)
            self._thread.start()
        else:
            self.comm.handle_receive_message()

    def finish(self) -> None:
        self.comm.stop_receive_message()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # a handler is still running; finalizing the backend under
                # it would hand a freed native handle to live code
                logger.error(
                    "rank %d: receive pump did not stop within 5s "
                    "(handler still running?); leaving backend open",
                    self.rank)
                return
            self._thread = None
        finalize = getattr(self.comm, "finalize", None)
        if finalize is not None:
            finalize()


class ClientManager(DistributedManager):
    pass


class ServerManager(DistributedManager):
    pass
