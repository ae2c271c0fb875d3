"""The port's serving worker against the JAX package's, on the CPU.

1. ``_populate_store``: every client's personal-delta row is bitwise the
   JAX package's row after ``jax_params_to_torch`` (drawn in the
   reference's leaf order and layout), in the disk and the host tiers.
2. The served logits: the port's worker (one forward per distinct client
   of a micro-batch, the global plus the client's delta summed in float32)
   equals the JAX worker's own vmapped ``_jserve`` on the same global,
   deltas and inputs, with converted weights, norm-wise within 1e-5 in
   float32, on the narrow phased AlexNet3D of the round tests; the store's
   hit and miss counts equal the JAX gather's of the same requests.
3. ``validate_serve_args`` and the parser's serve checks refuse with the
   reference's messages, case by case.
4. Threads: one thread runs FedAvg rounds on an algorithm while another
   serves a fixed micro-batch through a worker built on it; every served
   output is bitwise the first, and the worker's module is not the
   algorithm's.
"""
import argparse
import os
import threading

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.comm import local as jlocal  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as jmake_apply  # noqa: E402
from neuroimagedisttraining_tpu.serve import batcher as jbatcher  # noqa: E402
from neuroimagedisttraining_tpu.serve import runtime as jruntime  # noqa: E402
from neuroimagedisttraining_tpu.serve import worker as jworker  # noqa: E402
from neuroimagedisttraining_torch.comm.local import LocalRouter  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.models import make_apply_fn  # noqa: E402
from neuroimagedisttraining_torch.serve import runtime  # noqa: E402
from neuroimagedisttraining_torch.serve.batcher import MicroBatcher  # noqa: E402
from neuroimagedisttraining_torch.serve.worker import (  # noqa: E402
    PERSONAL_FIELD,
    ServeWorker,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops among the suite's parallel workers
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def narrow():
    """The narrow phased AlexNet3D on both sides, the reference's init
    params and the port's conversion, the cohort."""
    c = pc.cohort()
    jparams = pc.np_tree(jinit(c["jm"], jax.random.PRNGKey(7), pc.SS))
    c["jparams"] = jparams
    c["tparams"] = jax_params_to_torch(jparams)
    return c


def _store_args(mode, hot):
    return argparse.Namespace(seed=11, serve_store=mode,
                              store_hot_clients=hot)


@pytest.mark.parametrize("mode", ["disk", "host"])
def test_populate_store_rows_bitwise_the_reference(tmp_path, narrow, mode):
    c = pc.N_CLIENTS
    args = _store_args(mode, 2)
    jstore = jruntime._populate_store(args, str(tmp_path / "j"),
                                      narrow["jparams"], c)
    tstore = runtime._populate_store(args, str(tmp_path / "t"),
                                     narrow["tparams"], c)
    want = jax_params_to_torch(
        pc.np_tree(jstore.gather(PERSONAL_FIELD, list(range(c)))), lead=1)
    got = tstore.gather_all(PERSONAL_FIELD)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert got[k].shape == want[k].shape
        assert torch.equal(got[k].view(torch.int32),
                           want[k].contiguous().view(torch.int32)), k
    if mode == "disk":
        assert os.listdir(tmp_path / "t" / "store")


def test_served_logits_match_the_reference_worker(tmp_path, narrow):
    c = pc.N_CLIENTS
    args = _store_args("disk", 1)
    jd, td = narrow["jd"], narrow["td"]
    jstore = jruntime._populate_store(args, str(tmp_path / "j"),
                                      narrow["jparams"], c)
    tstore = runtime._populate_store(args, str(tmp_path / "t"),
                                     narrow["tparams"], c)
    # a served global away from the init (the deltas are 0.01-scale)
    jg = jax.tree_util.tree_map(lambda a: a * np.float32(1.25),
                                narrow["jparams"])
    jw = jworker.ServeWorker(
        jlocal.LocalRouter(2).manager(1), rank=1, world_size=2,
        apply_fn=jmake_apply(narrow["jm"]), init_params=jg, store=jstore,
        data_x=np.asarray(jd.x_train), data_n=np.asarray(jd.n_train),
        batcher=jbatcher.MicroBatcher(max_batch=8))
    tw = ServeWorker(
        LocalRouter(2).manager(1), rank=1, world_size=2,
        apply_fn=make_apply_fn(narrow["tm"]),
        init_params=jax_params_to_torch(jg), store=tstore,
        data_x=td.x_train, data_n=td.n_train,
        batcher=MicroBatcher(max_batch=8))
    ids = [2, 0, 2, 1, 2, 0]
    samples = [0, 3, 1, 2, 4, 0]
    deltas = jstore.gather(PERSONAL_FIELD, ids)
    want = np.asarray(jw._jserve(
        jax.device_put(deltas),
        jax.device_put(np.asarray(jd.x_train)[ids, samples]), jw._g_dev))
    got = tw.serve_logits(ids, samples).numpy()
    assert got.shape == want.shape == (len(ids), 1)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    # one forward per distinct client; the store read every request's row
    assert tw.forwards == len(set(ids))
    assert (tstore.hits, tstore.misses) == (jstore.hits, jstore.misses)
    # the same request alone gives the same row (per-sample model)
    one = tw.serve_logits([ids[3]], [samples[3]]).numpy()
    assert np.linalg.norm(one[0] - got[3]) <= 1e-6 * np.linalg.norm(got[3])


BASE = ["--model", "small3dcnn", "--dataset", "synthetic",
        "--client_num_in_total", "8", "--comm_round", "1",
        "--serve_role", "worker"]
REFUSALS = [
    ["--algo", "salientgrads"],
    ["--serve_requests", "0"],
    ["--serve_rps", "0"],
    ["--serve_batch", "0"],
    ["--serve_linger_ms", "-1"],
    ["--serve_zipf", "0"],
    ["--serve_push_every", "0"],
    ["--serve_timeout_s", "0"],
    ["--serve_wire", "topk"],
    ["--serve_store", "device"],
    ["--serve_backend", "grpc"],
    ["--multihost"],
    ["--serve_backend", "tcp", "--serve_endpoints",
     "127.0.0.1:1,127.0.0.1:2", "--serve_workers", "2"],
    ["--serve_backend", "tcp"],
    ["--serve_role", "publisher"],
    ["--fed_role", "aggregator", "--fed_sites", "2"],
    ["--serve_replay", "/nonexistent/trace.json"],
    ["--serve_role", "router"],
]


@pytest.mark.parametrize("extra", REFUSALS, ids=lambda e: " ".join(e))
def test_serve_refusals_as_reference(extra):
    argv = BASE + extra
    algo = "salientgrads" if "salientgrads" in extra else "fedavg"
    argv = [a for a in argv if a not in ("--algo", "salientgrads")]
    outcome = []
    for config, validate in ((jconfig, jruntime.validate_serve_args),
                             (tconfig, runtime.validate_serve_args)):
        try:
            args = config.parse_args(argv, algo)
            validate(args, algo)
        except (ValueError, SystemExit) as e:
            outcome.append((type(e).__name__, str(e)))
        else:
            outcome.append(None)
    assert outcome[0] is not None, "the reference accepts it"
    assert outcome[1] == outcome[0]


def test_serving_beside_training_threads(tmp_path):
    """FedAvg rounds in one thread, a fixed micro-batch served 50+ times in
    another through a worker built on the same algorithm: the served
    logits never move (the worker forwards through its own module)."""
    args = tconfig.parse_args(
        ["--model", "small3dcnn", "--dataset", "synthetic",
         "--client_num_in_total", "8", "--comm_round", "4", "--epochs",
         "2", "--batch_size", "4", "--seed", "3", "--device", "cpu",
         "--serve_role", "worker", "--serve_store", "host",
         "--serve_batch", "4"], "fedavg")
    trunner.seed_everything(args.seed)
    algo, _ = trunner.build_algorithm(args, "fedavg")
    state = algo.init_state()
    w = runtime._make_worker(args, algo, LocalRouter(2).manager(1), None,
                             str(tmp_path), state.global_params)
    assert w.apply_fn.model is not algo.model
    assert algo.apply_fn.model is algo.model
    ids, samples = [1, 5, 1, 0], [0, 2, 3, 1]
    first = w.serve_logits(ids, samples)
    outs, stop = [], threading.Event()

    def serve():
        while len(outs) < 50 or not stop.is_set():
            outs.append(w.serve_logits(ids, samples))

    th = threading.Thread(target=serve)
    th.start()
    try:
        for r in range(int(args.comm_round)):
            state, _ = algo.run_round(state, r)
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive() and len(outs) >= 50
    assert all(torch.equal(o, first) for o in outs)
    # the rounds trained: the served model is the init, not the trained one
    assert not all(torch.equal(state.global_params[k].cpu(),
                               w._g_dev[k].cpu()) for k in w._g_dev)
