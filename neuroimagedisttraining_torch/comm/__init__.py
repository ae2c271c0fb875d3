"""Cross-silo message layer (counterpart of
``neuroimagedisttraining_tpu/comm``).

In-mesh training exchanges through ``torch.distributed`` collectives
(``parallel/``); this package is the message layer between processes or
hosts: the typed ``Message`` with its binary tree framing, observers and
client/server managers, and the backends (the native C++ TCP transport of
``native/comm/tcp_comm.cpp``, an in-process one for simulation, a pub/sub
broker and an optional gRPC mesh), with the cross-silo FedAvg protocol on
top.
"""
from .base import BaseCommunicationManager, CommCounters, Observer
from .cross_silo import CrossSiloClient, CrossSiloServer, RoundOutcome
from .grpc_backend import GrpcCommManager, endpoints_from_hosts, grpc_available
from .local import LocalCommManager, LocalRouter
from .manager import ClientManager, DistributedManager, ServerManager
from .message import Message
from .pubsub import PubSubBroker, PubSubCommManager
from .tcp import TcpCommManager, build_native, native_available

__all__ = [
    "BaseCommunicationManager",
    "ClientManager",
    "CommCounters",
    "CrossSiloClient",
    "CrossSiloServer",
    "RoundOutcome",
    "DistributedManager",
    "GrpcCommManager",
    "LocalCommManager",
    "LocalRouter",
    "Message",
    "Observer",
    "PubSubBroker",
    "PubSubCommManager",
    "ServerManager",
    "TcpCommManager",
    "build_native",
    "endpoints_from_hosts",
    "grpc_available",
    "native_available",
]
