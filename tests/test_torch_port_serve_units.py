"""The port's serving units against the JAX package's, on the CPU.

1. The micro-batcher (``serve/batcher.py``): the cases of
   ``tests/test_serve.py`` (full slab, linger, timeout, overflow, wake,
   validation) against the port's copy.
2. ``serve/traffic.py``: request streams and trace files byte-equal to the
   JAX package's for several seeds, Zipf exponents and per-client sample
   counts; the hot set; a recorded trace replays to the stream.
3. ``obs/prom.py``: ``render_prom`` bodies byte-equal to the JAX package's
   on the golden snapshot of ``tests/test_prom.py`` and on a live
   registry's snapshot; a ``PromServer`` scrape round trip on an ephemeral
   localhost port; ``maybe_prom_server``'s gate; ``parse_prom_text``.
4. ``obs/diff.py``: ``params_diff`` verdicts equal to the JAX package's on
   equal, NaN, shape-changed and value-changed trees (the port's trees are
   the reference's after ``jax_params_to_torch``); the config plane's
   census classes as the JAX package's.
"""
import copy
import math
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.obs import diff as jdiff  # noqa: E402
from neuroimagedisttraining_tpu.obs import prom as jprom  # noqa: E402
from neuroimagedisttraining_tpu.serve import traffic as jtraffic  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.obs import diff, prom  # noqa: E402
from neuroimagedisttraining_torch.obs.metrics import MetricsRegistry  # noqa: E402
from neuroimagedisttraining_torch.serve import traffic  # noqa: E402
from neuroimagedisttraining_torch.serve.batcher import (  # noqa: E402
    MicroBatcher,
    ServeRequest,
)

# -- 1. the micro-batcher -----------------------------------------------------


def test_batcher_full_batch_closes_immediately():
    b = MicroBatcher(max_batch=4, linger_ms=10_000.0)
    for i in range(4):
        b.submit(ServeRequest(i, 0))
    t0 = time.perf_counter()
    batch = b.next_batch(timeout_s=5.0)
    assert time.perf_counter() - t0 < 1.0
    assert [r.client_id for r in batch] == [0, 1, 2, 3]
    assert b.depth() == 0


def test_batcher_linger_closes_partial_batch():
    b = MicroBatcher(max_batch=64, linger_ms=30.0)
    b.submit(ServeRequest(7, 1))
    t0 = time.perf_counter()
    batch = b.next_batch(timeout_s=5.0)
    assert [r.client_id for r in batch] == [7]
    assert time.perf_counter() - t0 < 2.0


def test_batcher_timeout_returns_none():
    assert MicroBatcher(max_batch=4, linger_ms=1.0).next_batch(
        timeout_s=0.02) is None


def test_batcher_overflow_spills_to_next_batch():
    b = MicroBatcher(max_batch=3, linger_ms=0.0)
    for i in range(5):
        b.submit(ServeRequest(i, 0))
    assert len(b.next_batch(timeout_s=1.0)) == 3
    assert len(b.next_batch(timeout_s=1.0)) == 2


def test_batcher_wake_unblocks_consumer():
    b = MicroBatcher(max_batch=4, linger_ms=5.0)
    out = {}

    def consume():
        out["batch"] = b.next_batch(timeout_s=10.0)

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.05)
    b.wake()
    t.join(timeout=1.0)
    b.submit(ServeRequest(1, 0))
    t.join(timeout=6.0)
    assert not t.is_alive()
    assert [r.client_id for r in out["batch"]] == [1]


@pytest.mark.parametrize("kw", [{"max_batch": 0}, {"linger_ms": -1.0}])
def test_batcher_validation(kw):
    with pytest.raises(ValueError):
        MicroBatcher(**kw)


# -- 2. traffic ---------------------------------------------------------------

TRAFFIC = [(0, 16, 1.1, 40), (3, 16, 1.1, [5, 9, 40, 1] * 4),
           (7, 1, 0.6, 3), (11, 64, 2.0, 7), (42, 9, 1.0, 40)]


@pytest.mark.parametrize("seed,clients,zipf,n", TRAFFIC)
def test_traffic_stream_byte_equal(seed, clients, zipf, n):
    j = jtraffic.TrafficGenerator(clients, n, zipf_s=zipf, seed=seed)
    t = traffic.TrafficGenerator(clients, n, zipf_s=zipf, seed=seed)
    assert t.probs.tobytes() == j.probs.tobytes()
    np.testing.assert_array_equal(t.hot_clients(4), j.hot_clients(4))
    for size in (1, 37, 256):
        a, b = t.draw(size), j.draw(size)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert list(traffic.TrafficGenerator(
        clients, n, zipf_s=zipf, seed=seed).iter_requests(50)) == \
        list(jtraffic.TrafficGenerator(
            clients, n, zipf_s=zipf, seed=seed).iter_requests(50))


@pytest.mark.parametrize("seed,clients,zipf,n", TRAFFIC[:3])
def test_trace_file_byte_equal(tmp_path, seed, clients, zipf, n):
    reqs = [tuple(r) for r in traffic.TrafficGenerator(
        clients, n, zipf_s=zipf, seed=seed).draw(64)]
    meta = {"seed": seed, "zipf_s": zipf, "num_clients": clients}
    a = traffic.trace_save(str(tmp_path / "t.json"), reqs, meta=meta)
    b = jtraffic.trace_save(str(tmp_path / "j.json"), reqs, meta=meta)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert list(traffic.replay_requests(traffic.trace_load(a))) == \
        [(int(c), int(s)) for c, s in reqs] == jtraffic.trace_load(b)


@pytest.mark.parametrize("kw", [{"num_clients": 0, "n_per_client": 1},
                                {"num_clients": 2, "n_per_client": 1,
                                 "zipf_s": 0.0},
                                {"num_clients": 2, "n_per_client": [1, 0]}])
def test_traffic_refusals_as_reference(kw):
    with pytest.raises(ValueError) as t:
        traffic.TrafficGenerator(**kw)
    with pytest.raises(ValueError) as j:
        jtraffic.TrafficGenerator(**kw)
    assert str(t.value) == str(j.value)


# -- 3. prom ------------------------------------------------------------------

def _snapshot():
    # the golden snapshot of tests/test_prom.py
    return {
        "fed_rounds_total": {"type": "counter", "value": 23.0,
                             "labeled": {"site=site2": 7.0}},
        "fleet_sites_live": {"type": "gauge", "value": 3},
        "fleet_round_progress": {"type": "gauge", "value": 0.75},
        "agg_flush_ms": {"type": "distribution",
                         "value": {"p50": 12.0, "p99": 40.5,
                                   "sum": 120.25, "count": 9},
                         "labeled": {"wire=int8": {"p50": 3.5,
                                                   "sum": 7.0,
                                                   "count": 2}}},
        "queue_depth": {"type": "gauge", "value": float("nan"),
                        "labeled": {"site=site1": float("inf"),
                                    "site=site2": float("-inf")}},
    }


def _live_snapshot():
    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(48.0)
    reg.counter("serve_batches_total").labels(worker="w1").inc(3)
    reg.gauge("serve_model_version").set(2.0)
    d = reg.distribution("serve_latency_ms")
    for v in (1.5, 3.25, 80.0, 0.125, 7.0):
        d.observe(v)
    reg.gauge('odd name-1').labels(k='a"b').set(1e20)
    return reg.snapshot()


@pytest.mark.parametrize("which", ["golden", "live", "empty"])
def test_render_prom_byte_equal(which):
    snap = {"golden": _snapshot, "live": _live_snapshot,
            "empty": dict}[which]()
    body = prom.render_prom(snap)
    assert body == jprom.render_prom(snap)
    shuffled = {k: snap[k] for k in reversed(list(snap))}
    assert prom.render_prom(shuffled) == body
    assert prom.CONTENT_TYPE == jprom.CONTENT_TYPE


def test_prom_server_scrape_roundtrip():
    snap = _snapshot()
    srv = prom.PromServer(lambda: snap, port=0).start()
    try:
        assert srv.port > 0
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == prom.CONTENT_TYPE
            body = r.read().decode()
        assert body == jprom.render_prom(snap)
        samples = prom.parse_prom_text(body)
        assert samples == pytest.approx(jprom.parse_prom_text(body),
                                        nan_ok=True)
        assert samples['agg_flush_ms{quantile="0.99"}'] == 40.5
        assert math.isnan(samples["queue_depth"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/other", timeout=10)
        assert ei.value.code == 404
        snap["fleet_sites_live"]["value"] = 2
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert "fleet_sites_live 2" in r.read().decode()
    finally:
        srv.close()
        srv.close()


def test_maybe_prom_server_gate():
    assert prom.maybe_prom_server(dict, 0) is None
    srv = prom.maybe_prom_server(dict, -1)
    try:
        assert srv is not None and srv.port > 0
    finally:
        srv.close()
    blocker = socket.socket()
    try:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        assert prom.maybe_prom_server(
            dict, blocker.getsockname()[1]) is None
    finally:
        blocker.close()


@pytest.mark.parametrize("text", ["just_a_name_no_value",
                                  "ok 1\nbad notafloat"])
def test_parse_prom_text_rejects_malformed_as_reference(text):
    with pytest.raises(ValueError) as t:
        prom.parse_prom_text(text)
    with pytest.raises(ValueError) as j:
        jprom.parse_prom_text(text)
    assert str(t.value) == str(j.value)


# -- 4. params_diff -----------------------------------------------------------

def _jax_tree(seed=0):
    """A small3dcnn-shaped reference tree (nested flax scopes, a conv
    kernel in DHWIO and a dense kernel in (in, out))."""
    r = np.random.RandomState(seed)
    return {
        "Conv3d_0": {"Conv_0": {
            "kernel": r.randn(3, 3, 3, 1, 4).astype(np.float32),
            "bias": r.randn(4).astype(np.float32)}},
        "Dense_0": {"kernel": r.randn(8, 2).astype(np.float32),
                    "bias": r.randn(2).astype(np.float32)},
        "GroupNorm_0": {"scale": r.randn(4).astype(np.float32),
                        "bias": r.randn(4).astype(np.float32)},
    }


def _edit(tree, case):
    """A copy of ``tree`` changed as ``case`` says (``nan`` puts the same
    NaN into both trees)."""
    out = copy.deepcopy(tree)
    if case == "nan":
        for t in (out, tree):
            t["Dense_0"]["bias"][1] = np.nan
    elif case == "shape":
        out["GroupNorm_0"]["scale"] = np.zeros(5, np.float32)
    elif case == "values":
        out["Dense_0"]["kernel"] += np.float32(0.5) * (
            np.arange(16).reshape(8, 2) % 3 == 0)
        out["Conv3d_0"]["Conv_0"]["bias"][2] = np.inf
    elif case == "nan_vs_value":
        out["Dense_0"]["bias"][0] = np.nan
    return out


def _port(tree):
    return jax_params_to_torch(tree)


@pytest.mark.parametrize("case", ["equal", "nan", "shape", "values",
                                  "nan_vs_value"])
def test_params_diff_verdicts_as_reference(case):
    a = _jax_tree()
    b = _edit(a, case)
    want = jdiff.params_diff(a, b)
    got = diff.params_diff(_port(a), _port(b))
    assert got["identical"] == want["identical"]
    assert got["structure_identical"] == want["structure_identical"]
    assert got["leaves"] == want["leaves"]
    assert len(got["diverged"]) == len(want["diverged"])
    for g, w in zip(got["diverged"], want["diverged"]):
        assert g["reason"] == w["reason"]
        if w["reason"] == "values":
            assert g["n_diff"] == w["n_diff"]
            assert g["max_abs_delta"] == w["max_abs_delta"]
    # numpy leaves and nested scopes give the same verdict as tensors
    np_a = {k: v.numpy() for k, v in _port(a).items()}
    assert diff.params_diff(np_a, _port(b))["identical"] == \
        want["identical"]


def test_params_diff_structure_mismatch():
    a = _port(_jax_tree())
    b = dict(a)
    b.pop("Dense_0.bias")
    assert not diff.params_diff(a, b)["structure_identical"]
    c = {("X" + k if k.startswith("Dense") else k): v for k, v in a.items()}
    assert not diff.params_diff(a, c)["identical"]


def test_config_plane_census_as_reference():
    from neuroimagedisttraining_tpu.analysis.identity import FLAG_CLASSES

    want = {k: cls for k, (cls, _) in FLAG_CLASSES.items()}
    assert {k: v for k, v in diff.FLAG_CLASSES.items()
            if k != "device"} == want
    assert diff.FLAG_CLASSES["device"] == "inert"
    a = {"seed": 0, "serve_rps": 200.0, "layout": "s2d", "mystery": 1}
    b = {"seed": 1, "serve_rps": 400.0, "layout": "flat", "mystery": 2}
    got, ref = diff.config_diff(a, b), jdiff.config_diff(a, b)
    assert got == ref
