"""The port's ``fed/wire.py`` and ``fed/protocol.py`` against the JAX
package's, on the CPU.

1. The four delta codecs (dense, bf16, int8, topk) give the JAX package's
   frame byte for byte on the same tree, torch leaves or numpy: bf16 ties
   (round to nearest even), a NaN of either sign and the infinities, int8
   on an all-zero leaf, top-k ties at the threshold, nested trees. Each
   side decodes the other's frame to the same tree, and transport over the
   local and TCP backends adds no bit.
2. ``host_topk_indices`` equals the reference's on ties and NaNs.
3. The protocol's pure parts: ``partition_slots`` as the reference's, the
   per-site generator seed deterministic and distinct,
   ``send_with_retry``'s retry accounting, ``parse_site_faults`` and
   ``parse_endpoints`` as the reference's, and every refusal of
   ``validate_fed_args`` with the reference's message.
"""
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.comm.message import Message as JMessage  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.fed import protocol as jprotocol  # noqa: E402
from neuroimagedisttraining_tpu.fed import runtime as jruntime  # noqa: E402
from neuroimagedisttraining_tpu.fed import wire as jwire  # noqa: E402
from neuroimagedisttraining_tpu.ops.topk_select import (  # noqa: E402
    host_topk_indices as j_host_topk,
)
from neuroimagedisttraining_torch.comm import (  # noqa: E402
    LocalRouter,
    Message,
    TcpCommManager,
)
from neuroimagedisttraining_torch.comm.base import CommCounters  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.fed import protocol, runtime, wire  # noqa: E402
from neuroimagedisttraining_torch.ops.topk_select import host_topk_indices  # noqa: E402


def _bits(u):
    return np.frombuffer(np.uint32(u).tobytes(), np.float32)[0]


def _trees():
    r = np.random.RandomState(3)
    edge = r.randn(6, 7).astype(np.float32)
    # bf16 ties: halfway between two bf16 values, both parities; NaNs of
    # both signs and a signalling one; the infinities; -0
    edge[0, :6] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), np.nan,
                   -np.nan, _bits(0x7F800001)]
    edge[1, :4] = [np.inf, -np.inf, -0.0, 3.4e38]
    ties = np.zeros((5, 8), np.float32)
    ties[0, :5] = 1.0  # five ties at the top-k threshold
    ties[1, :3] = -1.0
    ties[2, 0] = 2.0
    return {
        "edge": {"w": edge, "b": r.randn(9).astype(np.float32)},
        "ties": {"t": ties, "z": np.zeros(4, np.float32)},
        "nested": {"b": {"y": r.randn(3, 3).astype(np.float32),
                         "x": r.randn(2).astype(np.float32)},
                   "a": [r.randn(4).astype(np.float32)]},
    }


TREES = _trees()
CASES = [(t, impl) for t in sorted(TREES) for impl in wire.WIRE_IMPLS]


def _torchify(tree):
    if isinstance(tree, dict):
        return {k: _torchify(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torchify(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _frames(tree, impl, density=0.3):
    j = JMessage("fed_update", 1, 0)
    jwire.encode_update(j, tree, impl, density=density)
    t = Message("fed_update", 1, 0)
    wire.encode_update(t, _torchify(tree), impl, density=density)
    return j.to_bytes(), t.to_bytes()


def _leaves_equal(a, b):
    from neuroimagedisttraining_torch.comm.message import tree_flatten

    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("tree,impl", CASES)
def test_codec_frame_byte_identical_to_reference(tree, impl):
    jb, tb = _frames(TREES[tree], impl)
    assert jb == tb


@pytest.mark.parametrize("tree,impl", CASES)
def test_codec_decodes_the_others_frame(tree, impl):
    jb, tb = _frames(TREES[tree], impl)
    _leaves_equal(wire.decode_update(Message.from_bytes(jb)),
                  jwire.decode_update(JMessage.from_bytes(tb)))


def test_bf16_rounding_and_nan_as_the_reference():
    import ml_dtypes

    a = TREES["edge"]["w"]
    want = a.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(wire.bf16_bits(a), want)
    np.testing.assert_array_equal(
        wire.bf16_float(want).view(np.uint32),
        want.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


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


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_wire_is_bit_transparent(backend):
    tree = TREES["nested"]
    if backend == "local":
        router = LocalRouter(2)
        a, b = router.manager(0), router.manager(1)
        got = {}
        b.add_observer(type("O", (), {"receive_message": lambda self, t, m:
                                      got.setdefault(t, m)})())
    else:
        eps = [("127.0.0.1", p) for p in _free_ports(2)]
        a, b = TcpCommManager(0, eps), TcpCommManager(1, eps)
    try:
        for impl in wire.WIRE_IMPLS:
            m = Message("fed_update", 0, 1)
            wire.encode_update(m, _torchify(tree), impl, density=0.3)
            local = wire.decode_update(Message.from_bytes(m.to_bytes()))
            a.send_message(m)
            if backend == "local":
                payload = b.router.queues[1].get(timeout=10)
                shipped = Message.from_bytes(payload)
            else:
                shipped = b.recv(timeout_s=10.0)
            _leaves_equal(wire.decode_update(shipped), local)
    finally:
        if backend == "tcp":
            a.finalize()
            b.finalize()


def test_unknown_impl_refused():
    with pytest.raises(ValueError, match="unknown wire impl"):
        wire.encode_update(Message(), {"a": np.zeros(2)}, "zfp")
    m = Message()
    m.add("delta_wire", "zfp")
    m.add_tensor("delta", {})
    with pytest.raises(ValueError, match="unknown wire impl"):
        wire.decode_update(m)


@pytest.mark.parametrize("seed", range(4))
def test_host_topk_indices_as_the_reference(seed):
    r = np.random.RandomState(seed)
    mag = np.abs(r.randn(257)).astype(np.float32)
    mag[r.randint(0, 257, 40)] = 1.25  # ties across the threshold
    if seed % 2:
        mag[r.randint(0, 257, 5)] = np.nan
    for k in (1, 7, 40, 200, 257, 300):
        np.testing.assert_array_equal(host_topk_indices(mag, k),
                                      j_host_topk(mag, k))


# -- the protocol ---------------------------------------------------------

@pytest.mark.parametrize("n_items,n_sites", [(1, 1), (5, 3), (6, 3), (7, 3),
                                             (8, 2), (40, 7)])
def test_partition_slots_as_the_reference(n_items, n_sites):
    got = protocol.partition_slots(n_items, n_sites)
    want = jprotocol.partition_slots(n_items, n_sites)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), np.arange(n_items))
    with pytest.raises(ValueError):
        protocol.partition_slots(3, 0)


def test_site_generator_deterministic_and_distinct():
    a = protocol.site_round_key(0, 3, 1)
    b = protocol.site_round_key(0, 3, 1)
    assert torch.equal(a.get_state(), b.get_state())
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    seeds = {protocol.site_round_seed(s, v, r)
             for s in (0, 1) for v in (0, 1, 2) for r in (1, 2, 3)}
    assert len(seeds) == 2 * 3 * 3
    assert protocol.FED_SALT == jprotocol.FED_SALT
    for name in ("MSG_FED_TRAIN", "MSG_FED_UPDATE", "MSG_FED_FINISH",
                 "MSG_FED_HELLO", "MSG_FED_HELLO_ACK", "MSG_FED_HEARTBEAT"):
        assert getattr(protocol, name) == getattr(jprotocol, name)


def test_send_with_retry_counts_and_reraises():
    class Flaky:
        def __init__(self, fail_n):
            self.fail_n = fail_n
            self.sent = 0
            self.counters = CommCounters()

        def send_message(self, msg):
            if self.fail_n > 0:
                self.fail_n -= 1
                raise ConnectionRefusedError("not yet bound")
            self.sent += 1

    m = Flaky(fail_n=2)
    protocol.send_with_retry(m, Message("x", 1, 0), retries=2, backoff_s=0.0)
    assert m.sent == 1
    assert m.counters.snapshot()["comm_messages_retried"] == 2
    m2 = Flaky(fail_n=3)
    with pytest.raises(OSError):
        protocol.send_with_retry(m2, Message("x", 1, 0), retries=2,
                                 backoff_s=0.0)
    assert m2.counters.snapshot()["comm_messages_retried"] == 2


def test_hello_and_heartbeat_frames_as_the_reference():
    from neuroimagedisttraining_tpu.obs import live as jlive
    from neuroimagedisttraining_torch.obs import live

    assert protocol.hello_message(0, 2, 123).to_bytes() == \
        jprotocol.hello_message(0, 2, 123).to_bytes()
    ack = protocol.hello_ack(Message.from_bytes(
        protocol.hello_message(0, 2, 5).to_bytes()), 2, 2, 9)
    jack = jprotocol.hello_ack(JMessage.from_bytes(
        jprotocol.hello_message(0, 2, 5).to_bytes()), 2, 2, 9)
    assert ack.to_bytes() == jack.to_bytes()
    hb, jhb = live.HeartbeatConfig("site1", 1.0), jlive.HeartbeatConfig(
        "site1", 1.0)
    for h in (hb, jhb):
        h.note("train_loss", 0.5)
        h.note_round(3)
    assert protocol.heartbeat_message(1, 0, hb).to_bytes() == \
        jprotocol.heartbeat_message(1, 0, jhb).to_bytes()


@pytest.mark.parametrize("spec", ["3:straggle=1.0:6.0;1:drop=0.5", "",
                                  "2:byzantine", "4:kill:1.5"])
def test_parse_site_faults_as_the_reference(spec):
    got, want = runtime.parse_site_faults(spec), jruntime.parse_site_faults(
        spec)
    assert sorted(got) == sorted(want)
    for k in got:
        (gs, gd, gk), (ws, wd, wk) = got[k], want[k]
        assert (gd, gk) == (wd, wk)
        assert (gs is None) == (ws is None)
        if gs is not None:
            assert vars(gs) == vars(ws)


@pytest.mark.parametrize("bad", ["3", "x:drop=1.0", "0:drop=1.0",
                                 "2:drop=0.1;2:drop=0.2", "2:drop=0.1:oops"])
def test_parse_site_faults_rejects(bad):
    with pytest.raises(ValueError) as e:
        runtime.parse_site_faults(bad)
    with pytest.raises(ValueError) as je:
        jruntime.parse_site_faults(bad)
    assert str(e.value) == str(je.value)


def test_parse_endpoints_as_the_reference():
    assert runtime.parse_endpoints("127.0.0.1:9000, 10.0.0.2:9001", 2) == \
        jruntime.parse_endpoints("127.0.0.1:9000, 10.0.0.2:9001", 2)
    for bad, n in (("127.0.0.1:9000", 2), ("nocolon, 1.2.3.4:5", 2)):
        with pytest.raises(ValueError):
            runtime.parse_endpoints(bad, n)


def _fed_args(cfg, tmp_path):
    return cfg.parse_args([
        "--model", "small3dcnn", "--dataset", "synthetic",
        "--client_num_in_total", "6", "--frac", "1.0",
        "--batch_size", "8", "--epochs", "1", "--comm_round", "2",
        "--final_finetune", "0",
        "--results_dir", str(tmp_path / "results"),
        "--fed_role", "aggregator", "--fed_mode", "sync",
        "--fed_sites", "3"], algo="fedavg")


#: every refusal of validate_fed_args (the reference test's list), by the
#: fragment its message holds
REFUSALS = [
    (dict(fuse_rounds=4), "fuse_rounds"),
    (dict(watchdog=2), "watchdog"),
    (dict(client_store="host"), "client_store"),
    (dict(multihost=True), "multihost"),
    (dict(defense_type="krum"), "defenses"),
    (dict(fault_spec="drop=0.2"), "fed_site_faults"),
    (dict(eval_cache=1), "eval_cache"),
    (dict(checkpoint_dir="/tmp/ck"), "checkpoint"),
    (dict(mesh_space=2), "mesh_space"),
    (dict(agg_impl="int8"), "bit-parity"),
    (dict(fed_mode="buffered", agg_impl="zfp"), "wire codec"),
    (dict(fed_mode="buffered", frac=0.5), "frac"),
    (dict(fed_mode="buffered", fed_buffer_k=9), "fed_buffer_k"),
    (dict(fed_mode="buffered", fed_buffer_k=2, fed_staleness_bound=-1),
     "staleness"),
    (dict(fed_replay="/tmp/trace.json"), "replay"),
    (dict(fed_site_faults="9:drop=1.0"), "only 3 sites"),
    (dict(fed_sites=0), "fed_sites"),
    (dict(fed_mode="eventual"), "fed_mode"),
]


def test_validate_accepts_the_baseline(tmp_path):
    runtime.validate_fed_args(_fed_args(tconfig, tmp_path), "fedavg")


@pytest.mark.parametrize("mutate,fragment", REFUSALS,
                         ids=[f for _, f in REFUSALS])
def test_validate_refuses_as_the_reference(tmp_path, mutate, fragment):
    args, jargs = _fed_args(tconfig, tmp_path), _fed_args(jconfig, tmp_path)
    for k, v in mutate.items():
        setattr(args, k, v)
        setattr(jargs, k, v)
    with pytest.raises(SystemExit, match=fragment) as e:
        runtime.validate_fed_args(args, "fedavg")
    with pytest.raises(SystemExit) as je:
        jruntime.validate_fed_args(jargs, "fedavg")
    assert str(e.value.code) == str(je.value.code)


def test_validate_refuses_non_fedavg(tmp_path):
    with pytest.raises(SystemExit, match="fedavg") as e:
        runtime.validate_fed_args(_fed_args(tconfig, tmp_path), "salientgrads")
    with pytest.raises(SystemExit) as je:
        jruntime.validate_fed_args(_fed_args(jconfig, tmp_path),
                                   "salientgrads")
    assert str(e.value.code) == str(je.value.code)


def test_parse_time_fed_flags_as_the_reference(tmp_path):
    args = _fed_args(tconfig, tmp_path)
    assert args.fed_mode == "sync"
    buffered = tconfig.parse_args([
        "--model", "small3dcnn", "--fed_role", "aggregator",
        "--fed_mode", "buffered", "--fed_sites", "3",
        "--fed_site_faults", "3:straggle=1.0:6.0"], algo="fedavg")
    assert buffered.fed_buffer_k == 2  # max(1, sites - 1)
    assert tconfig.run_identity(buffered, "fedavg") == jconfig.run_identity(
        jconfig.parse_args([
            "--model", "small3dcnn", "--fed_role", "aggregator",
            "--fed_mode", "buffered", "--fed_sites", "3",
            "--fed_site_faults", "3:straggle=1.0:6.0"], algo="fedavg"),
        "fedavg")
    with pytest.raises(ValueError, match="fed_role"):
        tconfig.parse_args(["--fed_mode", "buffered"], algo="fedavg")
    with pytest.raises(ValueError, match="is not an int"):
        tconfig.parse_args(["--fed_role", "aggregator", "--fed_sites", "2",
                            "--fed_site_faults", "x:drop=1.0"],
                           algo="fedavg")
