"""gRPC comm backend: unary RPC mesh over the ``comm_manager.proto`` IDL
(counterpart of ``neuroimagedisttraining_tpu/comm/grpc_backend.py``).

Every rank runs an insecure server (port ``50000 + rank`` when only hosts
are given); a send opens (and caches) a channel to the receiver from the
endpoint table and issues one unary ``SendMessage(CommRequest)`` whose
payload is the binary ``Message`` framing; received payloads land in a
queue drained by ``handle_receive_message``. The message cap is 1 GiB.

gRPC is optional: ``grpcio`` may be absent (:func:`grpc_available` says
so), and then constructing a :class:`GrpcCommManager` raises — choosing
this backend never quietly swaps transports. The protobuf stub is
generated from the port's own ``native/comm/comm_manager.proto`` with
``protoc`` into ``neuroimagedisttraining_torch/_build/`` at first use; the
service is registered through ``grpc.GenericRpcHandler``, so no protoc
plugin is needed.
"""
from __future__ import annotations

import importlib.util
import logging
import os
import queue
import subprocess
import threading
from concurrent import futures
from typing import Sequence, Tuple

from .base import BaseCommunicationManager, QueueInboxMixin
from .message import Message

logger = logging.getLogger(__name__)

GRPC_BASE_PORT = 50000  # grpc_comm_manager.py: PORT_BASE = 50000
MAX_MESSAGE_BYTES = 1 << 30
_SERVICE_METHOD = "/nidt.comm.CommManager/SendMessage"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROTO_DIR = os.path.join(_PKG, "native", "comm")
_GEN_DIR = os.path.join(_PKG, "_build")

_stub_lock = threading.Lock()
_pb2 = None


def _load_pb2():
    """The protobuf stub module, generated with ``protoc`` into ``_build/``
    when it is missing or older than the ``.proto``. Raises
    ``RuntimeError`` when ``protoc`` is missing or fails."""
    global _pb2
    with _stub_lock:
        if _pb2 is not None:
            return _pb2
        src = os.path.join(_PROTO_DIR, "comm_manager.proto")
        out = os.path.join(_GEN_DIR, "comm_manager_pb2.py")
        if not os.path.exists(out) or \
                os.path.getmtime(out) < os.path.getmtime(src):
            os.makedirs(_GEN_DIR, exist_ok=True)
            try:
                done = subprocess.run(
                    ["protoc", f"--python_out={_GEN_DIR}", f"-I{_PROTO_DIR}",
                     "comm_manager.proto"], capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(
                    "the gRPC comm backend generates its protobuf stub with "
                    "`protoc`, which is not on PATH") from e
            if done.returncode != 0:
                raise RuntimeError(
                    f"protoc failed generating the gRPC stub from {src}: "
                    f"{done.stderr.strip()}")
        spec = importlib.util.spec_from_file_location(
            "neuroimagedisttraining_torch_comm_manager_pb2", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _pb2 = mod
        return _pb2


def grpc_available() -> bool:
    """``grpcio`` imports and the stub loads."""
    try:
        import grpc  # noqa: F401
        _load_pb2()
        return True
    except Exception:
        return False


class _CommServicer:
    """Queues every inbound CommRequest (grpc_server.py:9-40 equivalent)."""

    def __init__(self, pb2, inbox: "queue.Queue[bytes]", rank: int):
        self._pb2 = pb2
        self._inbox = inbox
        self._rank = rank

    def send_message(self, request, context):
        self._inbox.put(request.message)
        return self._pb2.CommResponse(
            client_id=self._rank, message="ack")

    def handler(self):
        import grpc

        pb2 = self._pb2
        rpc = grpc.unary_unary_rpc_method_handler(
            self.send_message,
            request_deserializer=pb2.CommRequest.FromString,
            response_serializer=pb2.CommResponse.SerializeToString,
        )
        method = _SERVICE_METHOD

        class _Generic(grpc.GenericRpcHandler):
            def service(self, details):
                return rpc if details.method == method else None

        return _Generic()


class GrpcCommManager(QueueInboxMixin, BaseCommunicationManager):
    """One rank of a gRPC mesh.

    ``endpoints``: ``[(host, port)] * world_size`` — the reference's
    ip-config table (``build_ip_table``); a port of 0 in this rank's own
    entry means "bind an ephemeral port" (the chosen port is exposed as
    ``.port`` so tests and dynamic deployments can exchange it out of
    band). Plain host strings get the reference's ``50000 + rank`` scheme
    via :func:`endpoints_from_hosts`.
    """

    def __init__(self, rank: int, endpoints: Sequence[Tuple[str, int]]):
        super().__init__()
        import grpc

        self._pb2 = _load_pb2()
        self.rank = rank
        self.world_size = len(endpoints)
        self._endpoints = [tuple(e) for e in endpoints]
        self._init_pump()
        # receiver rank -> (grpc.Channel, unary-unary callable); the channel
        # reference is kept so finalize() can close it
        self._channels: dict[int, Tuple[object, object]] = {}
        self._chan_lock = threading.Lock()

        opts = [("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES)]
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4), options=opts)
        self._server.add_generic_rpc_handlers(
            (_CommServicer(self._pb2, self._inbox, rank).handler(),))
        host, port = self._endpoints[rank]
        bound = self._server.add_insecure_port(f"{host}:{port}")
        if bound == 0:
            raise OSError(f"rank {rank}: cannot bind grpc on {host}:{port}")
        self.port = bound
        self._endpoints[rank] = (host, bound)
        self._server.start()

    # -- sending ---------------------------------------------------------------
    def _stub(self, receiver: int):
        import grpc

        with self._chan_lock:
            entry = self._channels.get(receiver)
            if entry is None:
                host, port = self._endpoints[receiver]
                chan = grpc.insecure_channel(
                    f"{host}:{port}",
                    options=[("grpc.max_send_message_length",
                              MAX_MESSAGE_BYTES),
                             ("grpc.max_receive_message_length",
                              MAX_MESSAGE_BYTES)])
                call = chan.unary_unary(
                    _SERVICE_METHOD,
                    request_serializer=(
                        self._pb2.CommRequest.SerializeToString),
                    response_deserializer=(
                        self._pb2.CommResponse.FromString),
                )
                entry = (chan, call)
                self._channels[receiver] = entry
            return entry[1]

    def send_message(self, msg: Message) -> None:
        payload = msg.to_bytes()
        req = self._pb2.CommRequest(
            client_id=self.rank, message=payload)
        self._stub(msg.receiver_id)(req)
        # counted after the unary call returns (ack received) — the
        # same sent-means-transport-accepted semantics as the TCP
        # backend's post-rc check
        self.counters.note_sent(len(payload))

    # -- receiving: recv/pump come from QueueInboxMixin (the servicer feeds
    # self._inbox) — the message_handling_subroutine equivalent, without the
    # reference's 0.3 s sleep poll.

    def finalize(self) -> None:
        self.stop_receive_message()
        # wake any recv() blocked on the inbox: once queued messages drain
        # it raises ConnectionError instead of spinning forever
        self._fail_inbox()
        with self._chan_lock:
            for chan, _call in self._channels.values():
                chan.close()
            self._channels.clear()
        if self._server is not None:
            self._server.stop(grace=1).wait()
            self._server = None


def endpoints_from_hosts(hosts: Sequence[str]) -> list[Tuple[str, int]]:
    """Reference port scheme: rank ``i`` serves on ``50000 + i``."""
    return [(h, GRPC_BASE_PORT + i) for i, h in enumerate(hosts)]
