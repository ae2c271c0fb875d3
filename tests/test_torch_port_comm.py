"""The port's ``comm/`` against the JAX package's, on the CPU.

1. Message frames: the same numpy trees give byte-identical
   ``Message.to_bytes()`` in both packages (dict leaves by sorted key, an
   ``OrderedDict``'s in insertion order, int keys, tuples, lists, ``None``,
   scalars, empty leaves, mask-sparse leaves), and each package decodes
   the other's frames to the same tree. A torch-tensor tree frames as its
   numpy twin; a bf16 tensor is refused.
2. Transports: a torch-tensor tree round-trips bit for bit over the
   in-process, native TCP (built here with ``g++`` from the port's own
   source), pub/sub and gRPC backends, and the observer managers dispatch
   over them. A native build that fails raises; gRPC without ``grpcio``
   raises.
3. The cross-silo FedAvg protocol over torch trees: the sample-weighted
   mean of the clients' updates, as the JAX package's server computes it.
"""
import collections
import queue
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.comm import message as jmessage  # noqa: E402
from neuroimagedisttraining_tpu.comm.cross_silo import (  # noqa: E402
    CrossSiloClient as JClient,
    CrossSiloServer as JServer,
)
from neuroimagedisttraining_tpu.comm.local import LocalRouter as JRouter  # noqa: E402
from neuroimagedisttraining_torch.comm import (  # noqa: E402
    ClientManager,
    CrossSiloClient,
    CrossSiloServer,
    GrpcCommManager,
    LocalRouter,
    Message,
    PubSubBroker,
    PubSubCommManager,
    ServerManager,
    TcpCommManager,
    grpc_backend,
    tcp,
)
from neuroimagedisttraining_torch.comm import message as tmessage  # noqa: E402

RNG = np.random.RandomState(7)


def _trees():
    """Trees by case id: every structure the frame's ``treedef`` encodes."""
    r = RNG
    return {
        "sorted_keys": {"zeta": r.rand(3, 2).astype(np.float32),
                        "alpha": r.randn(5).astype(np.float64),
                        "mid": {"b": np.arange(4, dtype=np.int32),
                                "a": np.zeros((0, 3), np.float32)}},
        "int_keys": {7: np.ones(2, bool), 3: np.int8([1, -2]),
                     11: {2: np.float32(1.5)}},
        "sequences": [np.arange(3, dtype=np.int64), None,
                      (np.float64(2.0), [np.uint16([1, 2, 3])], ())],
        "ordered": collections.OrderedDict(
            [("y", np.ones((2, 2), np.float32)),
             ("x", np.zeros(3, np.float32))]),
        "scalars": {"n": 3, "f": 0.25, "none": None, "nested": {"e": {}}},
    }


TREES = _trees()


def _sparse_case():
    w = RNG.randn(6, 5).astype(np.float32)
    m = (RNG.rand(6, 5) > 0.5).astype(np.float32)
    return {"w": w, "b": RNG.randn(4)}, {"w": m, "b": np.ones(4)}


def _pair(tree, sparse=None):
    """The same message built in both packages."""
    out = []
    for mod in (jmessage, tmessage):
        m = mod.Message("t", 1, 2)
        m.add("round", 3)
        m.add("meta", {"k": [1, 2]})
        m.add_tensor("p", tree)
        if sparse is not None:
            m.add_masked_tensor("s", *sparse)
        out.append(m)
    return out


def _assert_tree_equal(a, b):
    fa, sa = tmessage.tree_flatten(a)
    fb, sb = tmessage.tree_flatten(b)
    assert sa == sb
    for x, y in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", sorted(TREES))
def test_frames_byte_identical_to_reference(case):
    j, t = _pair(TREES[case])
    jb, tb = j.to_bytes(), t.to_bytes()
    assert jb == tb
    assert t.nbytes == len(tb)


@pytest.mark.parametrize("case", sorted(TREES))
def test_each_side_decodes_the_other(case):
    j, t = _pair(TREES[case])
    from_j = tmessage.Message.from_bytes(j.to_bytes())
    from_t = jmessage.Message.from_bytes(t.to_bytes())
    assert from_j.params == from_t.params == t.params
    _assert_tree_equal(from_j.get_tensor("p"), from_t.get_tensor("p"))
    # decoding and re-framing reproduces the frame (a decoded OrderedDict
    # is a dict, framed by sorted key, on both sides)
    if case != "ordered":
        assert from_j.to_bytes() == j.to_bytes()
    assert from_j.to_bytes() == from_t.to_bytes()


def test_sparse_leaves_byte_identical_and_cross_decoded():
    tree, mask = _sparse_case()
    j, t = _pair({"d": np.arange(2.0)}, sparse=(tree, mask))
    assert j.to_bytes() == t.to_bytes()
    back = tmessage.Message.from_bytes(j.to_bytes())
    jback = jmessage.Message.from_bytes(t.to_bytes())
    for k in tree:
        want = np.asarray(tree[k]) * (np.asarray(mask[k]) != 0)
        np.testing.assert_array_equal(back.get_tensor("s")[k], want)
        np.testing.assert_array_equal(jback.get_tensor("s")[k], want)
        np.testing.assert_array_equal(back.get_tensor_mask("s")[k],
                                      (np.asarray(mask[k]) != 0))
    # the values on the mask and a bit per element ship, the rest not
    import json
    import struct

    raw = t.to_bytes()
    (hlen,) = struct.unpack("<I", raw[4:8])
    leaves = json.loads(raw[8:8 + hlen])["tensors"]["s"]["leaves"]
    payload = sum(int((m != 0).sum()) * np.asarray(tree[k]).itemsize
                  + (m.size + 7) // 8 for k, m in mask.items())
    assert sum(e["nbytes"] + e["bitmap_nbytes"] for e in leaves) == \
        payload < sum(np.asarray(v).nbytes for v in tree.values())


def test_torch_tree_frames_as_its_numpy_twin():
    tree = {"b": torch.randn(3, 4), "a": [torch.arange(5),
                                          torch.ones(2, dtype=torch.bool)]}
    as_np = {"b": tree["b"].numpy(), "a": [tree["a"][0].numpy(),
                                           tree["a"][1].numpy()]}
    t = tmessage.Message("x", 0, 1)
    t.add_tensor("p", tree)
    j = jmessage.Message("x", 0, 1)
    j.add_tensor("p", as_np)
    assert t.to_bytes() == j.to_bytes()
    # a sparse leaf from a torch tensor and mask too
    t.add_masked_tensor("s", {"w": tree["b"]}, {"w": tree["b"] > 0})
    j.add_masked_tensor("s", {"w": as_np["b"]}, {"w": as_np["b"] > 0})
    assert t.to_bytes() == j.to_bytes()


def test_bf16_tensor_refused_with_a_clear_message():
    m = tmessage.Message("x", 0, 1)
    m.add_tensor("p", {"w": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16.*uint16"):
        m.to_bytes()


def test_tree_helpers_follow_the_reference_order():
    import jax

    tree = TREES["sorted_keys"]
    leaves, _ = tmessage.tree_flatten(tree)
    jleaves = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a, b)
    doubled = tmessage.tree_map(lambda x: np.asarray(x) * 2, tree)
    np.testing.assert_array_equal(doubled["mid"]["b"],
                                  tree["mid"]["b"] * 2)


def test_json_codec_counts_bytes():
    seen = []
    hook = tmessage.add_nbytes_hook(lambda t, n: seen.append((t, n)))
    try:
        m = Message("ctl", 0, 1)
        m.add("x", 1)
        payload = m.to_json()
        assert Message.from_json(payload).params == m.params
        assert seen == [("ctl", len(payload.encode()))]
        with pytest.raises(ValueError, match="to_bytes"):
            bad = Message("ctl", 0, 1)
            bad.add_tensor("p", {"a": np.zeros(1)})
            bad.to_json()
    finally:
        tmessage.remove_nbytes_hook(hook)


# -- transports ------------------------------------------------------------

def _tree():
    return {"w": torch.randn(5, 3), "b": torch.arange(4, dtype=torch.int64),
            "m": [torch.ones(2, dtype=torch.bool), None]}


def _check_roundtrip(got, tree):
    assert got.get("round") == 2
    t = got.get_tensor("p")
    np.testing.assert_array_equal(t["w"], tree["w"].numpy())
    np.testing.assert_array_equal(t["b"], tree["b"].numpy())
    np.testing.assert_array_equal(t["m"][0], tree["m"][0].numpy())
    assert t["m"][1] is None


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _send_tree(sender, receiver_id):
    tree = _tree()
    msg = Message("payload", getattr(sender, "rank", 0), receiver_id)
    msg.add("round", 2)
    msg.add_tensor("p", tree)
    sender.send_message(msg)
    return tree


def test_local_backend_roundtrip_and_dispatch():
    router = LocalRouter(2)
    server, client = (ServerManager(router.manager(0), 0, 2),
                      ClientManager(router.manager(1), 1, 2))
    got = queue.Queue()
    client.register_message_receive_handler("payload", got.put)
    client.run(background=True)
    try:
        tree = _send_tree(server, 1)
        _check_roundtrip(got.get(timeout=10), tree)
        assert server.comm.counters.snapshot()["comm_messages_sent"] == 1
    finally:
        client.finish()


def test_tcp_backend_roundtrip_built_from_the_port_source():
    path = tcp.build_native()
    assert path.startswith(tcp._BUILD_DIR)
    assert tcp._SRC.endswith("neuroimagedisttraining_torch/native/comm/"
                             "tcp_comm.cpp")
    eps = [("127.0.0.1", p) for p in _free_ports(2)]
    a, b = TcpCommManager(0, eps), TcpCommManager(1, eps)
    try:
        tree = _send_tree(a, 1)
        got = b.recv(timeout_s=10.0)
        _check_roundtrip(got, tree)
        assert b.counters.snapshot()["comm_bytes_received"] == \
            a.counters.snapshot()["comm_bytes_sent"] > 0
        assert b.recv(timeout_s=0.05) is None
    finally:
        a.finalize()
        b.finalize()


def test_tcp_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tcp, "_SRC", str(bad))
    monkeypatch.setattr(tcp, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tcp, "_LIB_PATH",
                        str(tmp_path / "build" / "libtcpcomm.so"))
    with pytest.raises(RuntimeError, match="native TCP transport failed"):
        tcp.build_native(force=True)
    assert not (tmp_path / "build" / "libtcpcomm.so").exists()


def test_pubsub_backend_roundtrip():
    broker = PubSubBroker()
    server = PubSubCommManager(0, broker.host, broker.port, 2)
    client = PubSubCommManager(1, broker.host, broker.port, 2)
    try:
        tree = _send_tree(server, 1)
        _check_roundtrip(client.recv(timeout_s=10.0), tree)
        back = Message("payload", 1, 0)
        back.add("round", 2)
        back.add_tensor("p", tree)
        client.send_message(back)
        _check_roundtrip(server.recv(timeout_s=10.0), tree)
    finally:
        client.finalize()
        server.finalize()
        broker.stop()


def test_grpc_backend_roundtrip():
    pytest.importorskip("grpc")
    eps = [("127.0.0.1", 0), ("127.0.0.1", 0)]
    b = GrpcCommManager(1, eps)
    a = GrpcCommManager(0, [("127.0.0.1", 0), ("127.0.0.1", b.port)])
    try:
        tree = _send_tree(a, 1)
        _check_roundtrip(b.recv(timeout_s=10.0), tree)
    finally:
        a.finalize()
        b.finalize()


def test_grpc_without_grpcio_raises(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "grpc", None)
    assert not grpc_backend.grpc_available()
    with pytest.raises(ImportError):
        GrpcCommManager(0, [("127.0.0.1", 0)])


# -- the cross-silo protocol -----------------------------------------------

@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_cross_silo_fedavg_matches_the_reference(backend):
    g0 = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    updates = {1: ({"w": torch.full((3, 2), 1.0), "b": torch.ones(2)}, 2),
               2: ({"w": torch.full((3, 2), 4.0), "b": torch.zeros(2)}, 6)}

    def fn_for(rank):
        return lambda params, r: (updates[rank][0], updates[rank][1], 0.5)

    if backend == "local":
        router = LocalRouter(3)
        comms = [router.manager(i) for i in range(3)]
    else:
        eps = [("127.0.0.1", p) for p in _free_ports(3)]
        comms = [TcpCommManager(i, eps) for i in range(3)]
    server = CrossSiloServer(comms[0], 3, g0)
    clients = [CrossSiloClient(comms[k], k, 3, fn_for(k)) for k in (1, 2)]
    for c in clients:
        c.run(background=True)
    server.run(background=True)
    try:
        out = server.run_round(0, timeout_s=30)
    finally:
        for c in clients:
            c.finish()
        server.finish()
    assert out.status == "completed" and out.received == [1, 2]
    # the reference server on the same updates
    jrouter = JRouter(3)
    jserver = JServer(jrouter.manager(0), 3,
                      {k: v.numpy() for k, v in g0.items()})
    jclients = [JClient(jrouter.manager(k), k, 3, lambda p, r, k=k: (
        {n: v.numpy() for n, v in updates[k][0].items()}, updates[k][1],
        0.5)) for k in (1, 2)]
    for c in jclients:
        c.run(background=True)
    jserver.run(background=True)
    try:
        jserver.run_round(0, timeout_s=30)
    finally:
        for c in jclients:
            c.finish()
        jserver.finish()
    for k in ("w", "b"):
        np.testing.assert_array_equal(np.asarray(server.global_params[k]),
                                      np.asarray(jserver.global_params[k]))


def test_cross_silo_sparse_transport_rejects_a_dense_trainer():
    router = LocalRouter(2)
    g0 = {"w": torch.ones(4)}
    mask = {"w": torch.tensor([1.0, 0.0, 1.0, 0.0])}
    server = CrossSiloServer(router.manager(0), 2, g0, mask=mask)
    client = CrossSiloClient(router.manager(1), 1, 2,
                             lambda p, r: ({"w": torch.ones(4)}, 1, 0.1))
    client.run(background=True)
    server.run(background=True)
    done = threading.Event()
    try:
        with pytest.raises(RuntimeError, match="off-mask"):
            server.run_round(0, timeout_s=30)
        done.set()
    finally:
        client.finish()
        server.finish()
    assert done.is_set() and client.error
