"""In-process comm backend: per-rank queues in shared memory.

The simulation/test backend — plays the role the reference's MPI backend
plays for its (orphaned) multi-process path, without leaving the process.
Serialization still goes through the binary Message codec so tests exercise
the exact bytes the TCP backend ships.
"""
from __future__ import annotations

import queue
import threading
from typing import List

from .base import BaseCommunicationManager
from .message import Message


class LocalRouter:
    """Shared mailbox set for N in-process ranks."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.queues: List[queue.Queue] = [
            queue.Queue() for _ in range(world_size)]

    def manager(self, rank: int) -> "LocalCommManager":
        return LocalCommManager(self, rank)


class LocalCommManager(BaseCommunicationManager):
    def __init__(self, router: LocalRouter, rank: int):
        super().__init__()
        self.router = router
        self.rank = rank
        self._stop = threading.Event()

    def send_message(self, msg: Message) -> None:
        payload = msg.to_bytes()  # same wire format as the TCP backend
        self.counters.note_sent(len(payload))
        self.router.queues[msg.receiver_id].put(payload)

    def handle_receive_message(self) -> None:
        while not self._stop.is_set():
            try:
                payload = self.router.queues[self.rank].get(timeout=0.1)
            except queue.Empty:
                continue
            self.counters.note_received(len(payload))
            self._notify(Message.from_bytes(payload))

    def stop_receive_message(self) -> None:
        self._stop.set()
