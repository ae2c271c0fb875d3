"""The port's checkpoint pushes against the JAX package's, on the CPU.

One sequence of parameter trees (a baseline, then drifted versions) goes
through the port's ``CheckpointPublisher`` (torch leaves) and the JAX
package's (numpy leaves) on each push codec (dense, bf16, int8), over the
local router and the native TCP transport: every push frame is byte-equal
to the reference's, every checkpoint file is byte-equal, and the worker's
reconstruction is bitwise the publisher's and the checkpoint's, at every
version. The publisher's frame digests and the worker's adopted-model
digests follow the frames. A frame of the JAX publisher decodes in the
port's worker to the JAX checkpoint, bitwise (over TCP, one package a
side). Lossy int8 pushes stay bitwise transparent over many versions.
"""
import hashlib
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.comm import local as jlocal  # noqa: E402
from neuroimagedisttraining_tpu.comm import tcp as jtcp  # noqa: E402
from neuroimagedisttraining_tpu.serve import batcher as jbatcher  # noqa: E402
from neuroimagedisttraining_tpu.serve import publisher as jpublisher  # noqa: E402
from neuroimagedisttraining_tpu.serve import worker as jworker  # noqa: E402
from neuroimagedisttraining_torch.comm import local, tcp  # noqa: E402
from neuroimagedisttraining_torch.comm.message import tree_flatten  # noqa: E402
from neuroimagedisttraining_torch.serve import PUSH_WIRE_IMPLS  # noqa: E402
from neuroimagedisttraining_torch.serve.batcher import MicroBatcher  # noqa: E402
from neuroimagedisttraining_torch.serve.publisher import (  # noqa: E402
    CheckpointPublisher,
    checkpoint_path,
    load_checkpoint,
)
from neuroimagedisttraining_torch.serve.worker import (  # noqa: E402
    ServeWorker,
    tree_digest,
)


def _versions(n=3, seed=13):
    """A baseline and ``n - 1`` drifted versions of one nested tree (a
    flax-shaped scope, a flat leaf, a scalar)."""
    r = np.random.default_rng(seed)
    base = {"conv": {"w": r.standard_normal((3, 4)).astype(np.float32),
                     "b": np.zeros((4,), np.float32)},
            "head": {"k": r.standard_normal((5,)).astype(np.float32)},
            "s": np.float32(0.5).reshape(())}
    out = [base]
    for _ in range(n - 1):
        prev = out[-1]
        out.append({
            "conv": {"w": prev["conv"]["w"] * np.float32(1.5)
                     + np.float32(0.25) * r.standard_normal(
                         (3, 4)).astype(np.float32),
                     "b": prev["conv"]["b"] - np.float32(0.125)},
            "head": {"k": prev["head"]["k"] * np.float32(0.75)},
            "s": prev["s"] + np.float32(1e-3)})
    return out


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_bitwise(a, b):
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _dummy_apply(params, x, train, rng):
    return np.zeros((x.shape[0], 2), np.float32)


def _port_worker(comm):
    # no traffic: only the push handler (the model plane) runs
    return ServeWorker(comm, rank=1, world_size=2, apply_fn=_dummy_apply,
                       init_params={"w": np.zeros(1, np.float32)},
                       store=None, data_x=np.zeros((1, 1, 2)),
                       data_n=np.ones(1, np.int64),
                       batcher=MicroBatcher(max_batch=2))


def _jax_worker(comm):
    return jworker.ServeWorker(
        comm, rank=1, world_size=2, apply_fn=_dummy_apply,
        init_params={"w": np.zeros(1, np.float32)}, store=None,
        data_x=np.zeros((1, 1, 2)), data_n=np.ones(1, np.int64),
        batcher=jbatcher.MicroBatcher(max_batch=2))


def _capture(pub):
    """The push frames ``pub`` sends, as bytes."""
    frames = []
    send = pub.send_message

    def capture(msg):
        if msg.type == "serve_push":
            frames.append(msg.to_bytes())
        send(msg)

    pub.send_message = capture
    return frames


def _push_all(pub, worker, versions, torch_leaves):
    adopted = []
    for v, params in enumerate(versions):
        pub.publish(_torch_tree(params) if torch_leaves else params, v)
        assert pub.wait_acked(v, timeout_s=20.0)
        adopted.append(worker.global_params)
    return adopted


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


def _run(side, backend, impl, ckpt_dir, versions):
    """Push ``versions`` through one package's publisher and worker;
    returns (frames, per-version adopted trees, publisher, worker)."""
    port = side == "port"
    if backend == "local":
        router = (local.LocalRouter if port else jlocal.LocalRouter)(2)
        comms = router.manager(0), router.manager(1)
    else:
        eps = [("127.0.0.1", p) for p in _free_ports(2)]
        mgr = tcp.TcpCommManager if port else jtcp.TcpCommManager
        comms = mgr(0, eps), mgr(1, eps)
    worker = (_port_worker if port else _jax_worker)(comms[1])
    worker.run(background=True)
    pub = (CheckpointPublisher if port else jpublisher.CheckpointPublisher)(
        comms[0], ckpt_dir=ckpt_dir, wire_impl=impl)
    frames = _capture(pub)
    pub.run(background=True)
    try:
        adopted = _push_all(pub, worker, versions, torch_leaves=port)
    finally:
        worker.finish()
        pub.finish()
    return frames, adopted, pub, worker


needs_native = pytest.mark.skipif(
    not (tcp.native_available() and jtcp.native_available()),
    reason="g++/native build unavailable")

BACKENDS = ["local", pytest.param("tcp", marks=needs_native)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("impl", PUSH_WIRE_IMPLS)
def test_push_frames_checkpoints_and_reconstructions_as_reference(
        tmp_path, backend, impl):
    versions = _versions()
    t_frames, t_adopted, t_pub, t_worker = _run(
        "port", backend, impl, str(tmp_path / "t"), versions)
    j_frames, j_adopted, j_pub, _ = _run(
        "jax", backend, impl, str(tmp_path / "j"), versions)
    assert len(t_frames) == len(j_frames) == len(versions)
    for v, (tf, jf) in enumerate(zip(t_frames, j_frames)):
        assert tf == jf, f"v{v}: push frame differs"
        assert t_pub.push_digests[v] == hashlib.sha256(tf).hexdigest()
        tp, jp = (checkpoint_path(str(tmp_path / s), v) for s in "tj")
        with open(tp, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read(), f"v{v}: checkpoint differs"
        disk_v, disk = load_checkpoint(tp)
        assert disk_v == v
        # worker == the publisher's chain == the disk == the reference's
        _assert_bitwise(t_adopted[v], disk)
        _assert_bitwise(j_adopted[v], disk)
        assert t_worker.adopt_digests[v] == tree_digest(disk)
    _assert_bitwise(t_pub.servable_params, j_pub.servable_params)
    assert t_pub.bytes_pushed == j_pub.bytes_pushed
    assert t_worker.pushes_adopted == len(versions)


@needs_native
def test_reference_frames_decode_in_the_port_worker(tmp_path):
    """The JAX publisher on one end of a TCP link, the port's worker on
    the other: the worker lands on the JAX checkpoint bitwise."""
    versions = _versions(4, seed=2)
    eps = [("127.0.0.1", p) for p in _free_ports(2)]
    worker = _port_worker(tcp.TcpCommManager(1, eps))
    worker.run(background=True)
    pub = jpublisher.CheckpointPublisher(
        jtcp.TcpCommManager(0, eps), ckpt_dir=str(tmp_path),
        wire_impl="int8")
    pub.run(background=True)
    try:
        adopted = _push_all(pub, worker, versions, torch_leaves=False)
    finally:
        worker.finish()
        pub.finish()
    for v, tree in enumerate(adopted):
        _, disk = jpublisher.load_checkpoint(
            jpublisher.checkpoint_path(str(tmp_path), v))
        _assert_bitwise(tree, disk)


def test_lossy_int8_pushes_stay_transparent(tmp_path):
    """int8 deltas are lossy against the true params but exact against the
    reconstruction, version after version, on both packages alike."""
    rng = np.random.default_rng(5)
    versions = [{"w": rng.standard_normal(32).astype(np.float32)}]
    for _ in range(6):
        versions.append({"w": versions[-1]["w"] + rng.standard_normal(
            32).astype(np.float32) * np.float32(0.1)})
    _, t_adopted, t_pub, _ = _run("port", "local", "int8",
                                  str(tmp_path / "t"), versions)
    _, j_adopted, _, _ = _run("jax", "local", "int8", str(tmp_path / "j"),
                              versions)
    for t, j in zip(t_adopted, j_adopted):
        _assert_bitwise(t, j)
    assert not np.array_equal(t_pub.servable_params["w"],
                              versions[-1]["w"])
