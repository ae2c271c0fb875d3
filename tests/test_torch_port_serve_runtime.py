"""The port's serving runtime through its CLI, on the CPU, against the JAX
package's.

1. The loopback run of ``tests/test_serve.py``'s end-to-end test through
   the port's CLI (``--device cpu``): every request served, the full
   baseline and a delta a round adopted, the served model bitwise its
   checkpoint, a hit rate strictly between 0 and 1 (a hot set of 4 of 16
   clients), the serving gauges and ``slo_health`` on the tick lines, the
   ``serve_drained`` record, a ``-serve`` catalog entry with ``completed``
   true, a ``/metrics`` scrape during the run, every ``adopt`` span parented
   to a ``publish`` span. The JAX CLI runs the same command: the recorded
   request trace is byte-equal to its, and so are the served requests and
   the pushes' count.
2. The ``--serve_workers 2`` fan-out: both workers adopt bitwise-identical
   models at every version (the adopted models' digests), each gate
   bitwise, the per-rank ack watermarks equal.
3. ``--obs_prom_port -1`` on a loopback federation: ``/metrics`` scraped
   before and after the rounds, the body parsed, the bound port reported.
"""
import json
import os
import threading
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.fed import aggregator as tagg  # noqa: E402
from neuroimagedisttraining_torch.obs import prom, xtrace  # noqa: E402
from neuroimagedisttraining_torch.serve import runtime  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops among the suite's parallel workers
    yield
    torch.set_num_threads(threads)


def _argv(tmp, sub, *extra):
    return ["--model", "small3dcnn", "--dataset", "synthetic",
            "--client_num_in_total", "16", "--frac", "0.25",
            "--batch_size", "8", "--epochs", "1", "--comm_round", "2",
            "--lr", "0.05", "--seed", "3", "--final_finetune", "0",
            "--results_dir", os.path.join(tmp, sub, "results"),
            "--log_dir", os.path.join(tmp, sub, "LOG"),
            "--serve_role", "worker", "--serve_backend", "local",
            "--serve_requests", "48", "--serve_rps", "400",
            "--serve_batch", "8", "--serve_wire", "int8",
            "--serve_store", "disk", "--store_hot_clients", "4",
            "--serve_trace", os.path.join(tmp, sub + ".trace.json"),
            "--slo_spec", "p99:serve_latency_ms<50@w=200"] + list(extra)


@pytest.fixture
def prom_servers(monkeypatch):
    """Every ``/metrics`` server a run starts, as it starts it."""
    servers = []
    start = prom.maybe_prom_server

    def capture(fn, port):
        srv = start(fn, port)
        servers.append(srv)
        return srv

    monkeypatch.setattr(prom, "maybe_prom_server", capture)
    return servers


def _scrape(srv):
    with urllib.request.urlopen(srv.url, timeout=10) as r:
        assert r.headers["Content-Type"] == prom.CONTENT_TYPE
        return prom.parse_prom_text(r.read().decode())


def test_serving_loopback_end_to_end(tmp_path, monkeypatch, prom_servers):
    tmp = str(tmp_path)
    scraped = {}
    train = runtime._train_and_push

    def train_then_scrape(*a, **k):
        out = train(*a, **k)
        scraped.update(_scrape(prom_servers[0]))
        return out

    monkeypatch.setattr(runtime, "_train_and_push", train_then_scrape)
    out = trunner.main(_argv(tmp, "t", "--device", "cpu", "--xtrace", "1",
                             "--serve_probe_every", "2",
                             "--obs_prom_port", "-1"))
    s = out["serve"]
    assert s["requests"] == 48
    assert s["pushes_adopted"] == 3 and s["model_version"] == 2
    assert s["acked_version"] == 2 and s["pushes"] == 3
    assert s["bit_identical"] is True
    assert 0.0 < s["hit_rate"] < 1.0
    assert s["slo"] is not None and s["prom_port"] > 0
    # the warm-up, one forward per distinct client of each micro-batch, the
    # probes: at least one per batch, at most one per request
    assert s["batches"] + 1 <= s["forwards"]
    assert s["forwards"] <= 1 + 48 + s["batches"]
    assert sorted(s["adopt_digests"]) == sorted(s["push_digests"]) == \
        ["0", "1", "2"]
    with open(os.path.join(s["out_dir"], "serve_summary_worker.json")) as f:
        assert json.load(f)["push_digests"] == s["push_digests"]
    with open(s["jsonl"]) as f:
        records = [json.loads(line) for line in f]
    ticks = [r for r in records
             if isinstance(r.get("round"), int) and r["round"] >= 0]
    assert ticks
    for key in ("serve_latency_ms", "serve_hit_rate", "serve_batch_fill",
                "serve_model_version", "serve_model_staleness_s",
                "serve_rps", "serve_queue_depth", "slo_health"):
        assert key in ticks[-1], key
    assert any("serve_probe_acc" in r for r in ticks)
    assert any(r.get("serve_drained") for r in records)
    # the mid-run scrape: the worker's registry and its transport counters
    assert scraped["serve_requests_total"] > 0
    assert scraped["comm_messages_received"] >= 1
    # every adopt span parents to a publish span (the merged trace)
    doc = xtrace.load_doc(s["merged_trace"])
    assert not xtrace.validate_parentage(doc)
    spans = xtrace.span_index(doc)
    adopts = [e for e in spans.values() if e["name"] == "adopt"]
    assert len(adopts) == 3
    for e in adopts:
        assert spans[e["args"]["parent"]]["name"] == "publish"
    # catalog entry: completed, distinct -serve lineage
    with open(os.path.join(tmp, "t", "results", "runs_index.jsonl")) as f:
        entries = [json.loads(line) for line in f]
    mine = [e for e in entries if e["identity"].endswith("-serve")]
    assert mine and mine[-1]["completed"] is True
    # the JAX CLI's run of the same command
    j = jrunner.main(_argv(tmp, "j"))["serve"]
    assert (j["requests"], j["pushes_adopted"], j["bit_identical"]) == \
        (s["requests"], s["pushes_adopted"], s["bit_identical"])
    with open(os.path.join(tmp, "t.trace.json"), "rb") as a, \
            open(os.path.join(tmp, "j.trace.json"), "rb") as b:
        assert a.read() == b.read()


def test_serving_fanout_workers_identical(tmp_path):
    out = trunner.main(_argv(str(tmp_path), "f", "--device", "cpu",
                             "--serve_workers", "2", "--comm_round", "1",
                             "--serve_requests", "64"))
    s = out["serve"]
    ws = s["workers"]
    assert [w["rank"] for w in ws] == [1, 2]
    assert all(w["bit_identical"] and w["pushes_adopted"] == 2
               and w["model_version"] == 1 for w in ws)
    assert ws[0]["adopt_digests"] == ws[1]["adopt_digests"]
    assert sorted(ws[0]["adopt_digests"]) == ["0", "1"]
    assert s["acked_versions"] == {"1": 1, "2": 1}
    assert ws[0]["requests"] == 64 and ws[1]["requests"] == 0


def test_federation_prom_scrape(tmp_path, monkeypatch, prom_servers):
    """``--obs_prom_port -1`` on the loopback federation: the server is up
    before the first round and after the last."""
    before, ran, after = (threading.Event() for _ in range(3))
    execute = tagg.FedAggregator.execute

    def gated(self):
        before.wait(30)
        execute(self)
        ran.set()
        after.wait(30)

    monkeypatch.setattr(tagg.FedAggregator, "execute", gated)
    result = {}

    def run():
        result["out"] = trunner.main([
            "--algo", "fedavg", "--model", "small3dcnn", "--dataset",
            "synthetic", "--client_num_in_total", "6", "--comm_round",
            "2", "--final_finetune", "0", "--device", "cpu",
            "--fed_role", "aggregator", "--fed_mode", "sync",
            "--fed_sites", "3", "--obs_prom_port", "-1",
            "--results_dir", str(tmp_path / "res"),
            "--log_dir", str(tmp_path / "log")])

    th = threading.Thread(target=run)
    th.start()
    try:
        while not prom_servers and th.is_alive():
            th.join(0.05)
        first = _scrape(prom_servers[0])
        before.set()
        assert ran.wait(60)
        last = _scrape(prom_servers[0])
    finally:
        before.set()
        after.set()
        th.join(120)
    fed = result["out"]["fed"]
    assert fed["prom_port"] == prom_servers[0].port > 0
    # two rounds to three sites and the finish went out between the two
    assert last["comm_messages_sent"] - first.get(
        "comm_messages_sent", 0) >= 3 * 2 + 3
    assert last["comm_bytes_received"] > 0
