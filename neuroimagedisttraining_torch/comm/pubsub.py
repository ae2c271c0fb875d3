"""Pub/sub comm backend: topic-routed broker + client manager (counterpart
of ``neuroimagedisttraining_tpu/comm/pubsub.py``).

Rebuild of the reference's MQTT backend
(``fedml_core/distributed/communication/mqtt/mqtt_comm_manager.py:14-126``):
same topology — every rank talks only to a broker, the server publishes to
per-client downlink topics and subscribes to per-client uplink topics —
and the same topic scheme (server→client ``fedml0_<cid>``, client→server
``fedml<cid>``). ``paho-mqtt`` and an external Mosquitto broker are not
assumed: :class:`PubSubBroker` is a self-hosted stdlib-socket broker
(thread per connection, length-prefixed frames), and payloads are the
binary ``Message`` framing instead of JSON floats.

Wire frames (all little-endian):
  SUB:    op=1, u16 topic_len, topic
  PUB:    op=2, u16 topic_len, topic, u32 payload_len, payload
  SUBACK: op=3, u16 topic_len, topic
Broker→subscriber deliveries reuse the PUB frame. The broker acks every
SUB once the topic is registered; clients block on the ack during
construction so a publish issued right after a subscriber comes up can
never race past an unregistered subscription.
"""
from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Dict, Set, Tuple

from .base import BaseCommunicationManager, QueueInboxMixin
from .message import Message

logger = logging.getLogger(__name__)

_OP_SUB = 1
_OP_PUB = 2
_OP_SUBACK = 3
MAX_FRAME_BYTES = 1 << 30
# a subscriber that can't drain a delivery within this window is dropped —
# without it one stalled client's full TCP buffer would head-of-line-block
# every other delivery routed by the same publisher thread
SUBSCRIBER_SEND_TIMEOUT_S = 15.0


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _read_frame(sock: socket.socket) -> Tuple[int, str, bytes]:
    (op,) = struct.unpack("<B", _recv_exact(sock, 1))
    (tlen,) = struct.unpack("<H", _recv_exact(sock, 2))
    topic = _recv_exact(sock, tlen).decode()
    payload = b""
    if op == _OP_PUB:
        (plen,) = struct.unpack("<I", _recv_exact(sock, 4))
        if plen > MAX_FRAME_BYTES:
            raise ValueError(f"frame of {plen} bytes exceeds cap")
        payload = _recv_exact(sock, plen)
    return op, topic, payload


def _pub_frame(topic: str, payload: bytes) -> bytes:
    t = topic.encode()
    return b"".join([struct.pack("<B", _OP_PUB),
                     struct.pack("<H", len(t)), t,
                     struct.pack("<I", len(payload)), payload])


class PubSubBroker:
    """Self-hosted topic broker (the Mosquitto stand-in).

    Pass ``port=0`` to bind an ephemeral port (read it from ``.port``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._subs: Dict[str, Set[socket.socket]] = {}
        self._locks: Dict[socket.socket, threading.Lock] = {}
        self._warned_topics: Set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # bound outbound blocking (see SUBSCRIBER_SEND_TIMEOUT_S); recv
            # timeouts are surfaced per-frame in _serve and tolerated there
            sec = int(SUBSCRIBER_SEND_TIMEOUT_S)
            usec = int((SUBSCRIBER_SEND_TIMEOUT_S - sec) * 1e6)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", sec, usec))
            with self._lock:
                self._locks[conn] = threading.Lock()
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                op, topic, payload = _read_frame(conn)
                if op == _OP_SUB:
                    with self._lock:
                        self._subs.setdefault(topic, set()).add(conn)
                        lock = self._locks.get(conn)
                    if lock is not None:
                        t = topic.encode()
                        with lock:
                            conn.sendall(
                                struct.pack("<B", _OP_SUBACK)
                                + struct.pack("<H", len(t)) + t)
                elif op == _OP_PUB:
                    self._route(topic, payload)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self._drop(conn)

    def _route(self, topic: str, payload: bytes) -> None:
        frame = _pub_frame(topic, payload)
        with self._lock:
            targets = list(self._subs.get(topic, ()))
        if not targets:
            # QoS-0 drop (reference MQTT semantics) — but log it, so a
            # publish racing a subscriber's startup is diagnosable from
            # broker logs instead of an opaque receive timeout.
            # Once per topic: steady-state publishes to an unconsumed topic
            # are legitimate and must not flood the log.
            if topic not in self._warned_topics:
                self._warned_topics.add(topic)
                logger.warning(
                    "dropping publish to %r: no subscriber (QoS-0); "
                    "payload %d bytes (warned once per topic)",
                    topic, len(payload))
        for sub in targets:
            lock = self._locks.get(sub)
            if lock is None:
                continue
            try:
                with lock:
                    sub.sendall(frame)
            except OSError:
                self._drop(sub)

    def _drop(self, conn: socket.socket) -> None:
        with self._lock:
            self._locks.pop(conn, None)
            for subs in self._subs.values():
                subs.discard(conn)
        try:
            # shutdown (not just close) — the conn's serve thread is usually
            # blocked in recv holding the fd open, so a bare close() would
            # neither wake it nor send FIN to the peer
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # close live connections too — their serve threads are blocked in
        # _read_frame and would otherwise outlive the broker, leaving
        # clients unaware the broker is gone
        with self._lock:
            conns = list(self._locks)
        for conn in conns:
            self._drop(conn)


def downlink_topic(client_id: int) -> str:
    """Server→client topic (mqtt_comm_manager.py: ``fedml0_<cid>``)."""
    return f"fedml0_{client_id}"


def uplink_topic(client_id: int) -> str:
    """Client→server topic (mqtt_comm_manager.py: ``fedml<cid>``)."""
    return f"fedml{client_id}"


class PubSubCommManager(QueueInboxMixin, BaseCommunicationManager):
    """One rank of the star topology over a broker.

    ``world_size`` counts every rank including the server: rank
    (``client_id``) 0 is the server and subscribes to uplinks
    ``fedml1 .. fedml<world_size-1>``; ranks >=1 are clients and subscribe
    to their own downlink. ``send_message`` derives the topic from the
    Message's receiver id, mirroring ``MqttCommManager.send_message``. A
    lost broker connection fails fast: once queued deliveries drain,
    ``recv`` raises ``ConnectionError``.
    """

    def __init__(self, client_id: int, broker_host: str, broker_port: int,
                 world_size: int):
        super().__init__()
        self.client_id = client_id
        self.world_size = world_size
        self._init_pump()
        self._send_lock = threading.Lock()
        self._sock = socket.create_connection(
            (broker_host, broker_port), timeout=10)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        if client_id == 0:
            topics = [uplink_topic(c) for c in range(1, world_size)]
        else:
            topics = [downlink_topic(client_id)]
        for topic in topics:
            self._subscribe(topic)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _subscribe(self, topic: str) -> None:
        t = topic.encode()
        with self._send_lock:
            self._sock.sendall(
                struct.pack("<B", _OP_SUB) + struct.pack("<H", len(t)) + t)
        # block until the broker acks the registration — a publish issued
        # right after this constructor returns must not race the SUB.
        # Runs before the reader thread starts, so reading inline is safe;
        # deliveries for already-acked topics that interleave are inboxed.
        while True:
            op, got_topic, payload = _read_frame(self._sock)
            if op == _OP_SUBACK and got_topic == topic:
                return
            if op == _OP_PUB:
                self._inbox.put(payload)

    def _read_loop(self) -> None:
        try:
            while not self._stop.is_set():
                op, _topic, payload = _read_frame(self._sock)
                if op == _OP_PUB:
                    self._inbox.put(payload)
        except (ConnectionError, OSError, ValueError):
            if not self._stop.is_set():
                logger.warning(
                    "rank %d: broker connection lost", self.client_id)
        finally:
            self._fail_inbox()

    def send_message(self, msg: Message) -> None:
        receiver = msg.receiver_id
        topic = (downlink_topic(receiver) if self.client_id == 0
                 else uplink_topic(self.client_id))
        payload = msg.to_bytes()
        if len(payload) > MAX_FRAME_BYTES:
            # the broker would kill the connection on an oversized frame;
            # fail here with an actionable error instead (tcp.py does the
            # same for its u32 wire frames)
            raise ValueError(
                f"message payload {len(payload)} bytes exceeds the "
                f"{MAX_FRAME_BYTES}-byte frame cap — shard the pytree "
                "across messages")
        frame = _pub_frame(topic, payload)
        with self._send_lock:
            self._sock.sendall(frame)
        # Message payload bytes, not the framed size — the same
        # serialized-message basis every other backend counts
        self.counters.note_sent(len(payload))

    # recv/pump come from QueueInboxMixin (fed by _read_loop)

    def finalize(self) -> None:
        self.stop_receive_message()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
