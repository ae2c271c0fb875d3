"""Native TCP comm backend: a ctypes binding over the port's own
``native/comm/tcp_comm.cpp`` (counterpart of
``neuroimagedisttraining_tpu/comm/tcp.py``).

The cross-silo transport: the C++ library owns the sockets, the listener
and reader threads and the blocking receive queue; Python only frames
Messages. Frames carry a ``uint32`` length, so one message stays under
4 GiB.

The shared library is built at first use with ``g++ -O2 -std=c++17
-shared`` into ``neuroimagedisttraining_torch/_build/`` (no pip or cmake
dependency), compiled to a per-process temporary path and renamed into
place, so ranks starting together on one host never load a half-written
library.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

from .base import BaseCommunicationManager, PollingReceiveLoopMixin
from .message import Message

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "comm", "tcp_comm.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtcpcomm.so")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_native(force: bool = False) -> str:
    """Compile the C++ transport if it is not built or older than its
    source; returns the .so path. A failed compile raises
    ``RuntimeError`` with the compiler's output (``FileNotFoundError``
    without ``g++``): there is no other transport to fall back to."""
    with _lib_lock:
        if not force and os.path.exists(_LIB_PATH) and \
                os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
            return _LIB_PATH
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # compile to a per-process temp path, then rename atomically —
        # concurrent ranks on one host must never load a half-written .so
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
               _SRC, "-o", tmp]
        logger.info("building native comm: %s", " ".join(cmd))
        try:
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(
                    "building the native TCP transport failed "
                    f"({' '.join(cmd)} exited {done.returncode}):\n"
                    f"{done.stderr}")
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    lib = ctypes.CDLL(path)
    lib.comm_init.restype = ctypes.c_void_p
    lib.comm_init.argtypes = [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_char_p),
                              ctypes.POINTER(ctypes.c_int)]
    lib.comm_send.restype = ctypes.c_int
    # buf as c_char_p: ctypes passes the bytes object's buffer directly
    # (the C side only reads), avoiding a full payload copy per send
    lib.comm_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_char_p, ctypes.c_uint32]
    lib.comm_recv.restype = ctypes.c_int
    lib.comm_recv.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                              ctypes.POINTER(ctypes.c_uint32),
                              ctypes.c_double]
    lib.comm_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.comm_pending.restype = ctypes.c_int
    lib.comm_pending.argtypes = [ctypes.c_void_p]
    lib.comm_finalize.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


class TcpCommManager(PollingReceiveLoopMixin, BaseCommunicationManager):
    """One rank of a TCP mesh. ``endpoints`` = [(host, port)] * world_size;
    rank ``i`` listens on endpoints[i] (gRPC backend's port-per-rank scheme,
    ``grpc_comm_manager.py:20-40``, minus the JSON and the broken imports)."""

    def __init__(self, rank: int, endpoints: Sequence[Tuple[str, int]]):
        super().__init__()
        self.rank = rank
        self.world_size = len(endpoints)
        self._lib = _load()
        hosts = (ctypes.c_char_p * self.world_size)(
            *[h.encode() for h, _ in endpoints])
        ports = (ctypes.c_int * self.world_size)(
            *[p for _, p in endpoints])
        self._h = self._lib.comm_init(rank, self.world_size, hosts, ports)
        if not self._h:
            raise OSError(
                f"comm_init failed (rank {rank}, endpoint "
                f"{endpoints[rank]}): port in use?")
        self._init_pump()

    def send_message(self, msg: Message) -> None:
        payload = msg.to_bytes()
        if len(payload) >= 2 ** 32:
            # the wire frame is u32-length; ctypes would silently truncate
            raise ValueError(
                f"message payload {len(payload)} bytes exceeds the 4 GiB "
                "frame limit — shard the pytree across messages")
        rc = self._lib.comm_send(self._h, msg.receiver_id, payload,
                                 len(payload))
        if rc != 0:
            raise OSError(f"comm_send to rank {msg.receiver_id} failed ({rc})")
        self.counters.note_sent(len(payload))

    def recv(self, timeout_s: float = -1.0) -> Optional[Message]:
        """Blocking receive of one message (None on timeout)."""
        buf = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_uint32()
        rc = self._lib.comm_recv(self._h, ctypes.byref(buf),
                                 ctypes.byref(length), timeout_s)
        if rc == 1:
            return None
        if rc != 0:
            raise OSError(f"comm_recv failed ({rc})")
        try:
            payload = ctypes.string_at(buf, length.value)
        finally:
            self._lib.comm_free_buf(buf)
        self.counters.note_received(len(payload))
        return Message.from_bytes(payload)

    # handle_receive_message/stop_receive_message from PollingReceiveLoopMixin

    def finalize(self) -> None:
        self.stop_receive_message()
        if self._h:
            self._lib.comm_finalize(self._h)
            self._h = None

    def __del__(self):
        try:
            self.finalize()
        except Exception:
            pass
