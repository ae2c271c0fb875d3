"""Serving runtime: role dispatch, the loopback harness, refusals
(counterpart of ``neuroimagedisttraining_tpu/serve/runtime.py``).

``run_serving(args, algo_name)`` is the ``--serve_role`` entry the
runner dispatches to (before the fed dispatch — the two roles refuse
each other). Three shapes of run, mirroring ``fed/runtime.py``:

* ``--serve_backend local --serve_role worker`` — the single-process
  loopback: one ``LocalRouter(2)``, the worker on a receive-pump
  thread with its serve loop and traffic pump, the publisher's
  training loop in the calling thread. The test and CI-adjacent shape.
* ``--serve_backend tcp --serve_role worker`` — rank 1 over the
  native TCP transport: builds the same model/data from the argv,
  serves its own ``--serve_requests`` of Zipf traffic, adopts pushes
  until ``serve_finish``.
* ``--serve_backend tcp --serve_role publisher`` — rank 0: trains
  ``--comm_round`` rounds, pushing every ``--serve_push_every``
  rounds, then drains the worker. ``chip_smoke.py``'s ``serve`` phase
  runs the two roles concurrently on one card.

Every role runs on ``--device`` (CUDA by default, where it must be
present; ``--device cpu`` asks for the CPU): no role falls back. In the
loopback run the publisher trains in the calling thread while each worker
serves in threads of its own on the same card; a worker forwards through a
module of its own (:func:`_serving_apply_fn`), never the training one.

Unlike the training path, the serving worker constructs its
``ObsSession`` unconditionally — latency/hit-rate/staleness gauges ARE
the product of a serving run, there is no obs-off serving — and
``--slo_spec`` arms the engine directly (no ``--obs 1`` prerequisite;
that gate guards the training hot path, which serving never enters).

The bit-identity gate: after drain, the worker's reconstructed model
must compare ``identical`` (``obs/diff.py params_diff``) against the
publisher's last on-disk checkpoint. A lossy wire that survives this
gate is lossy exactly once, at encode — the reconstruction chains on
both ends are twins. Failure is a ``SystemExit``, not a warning.

Each process writes ``serve_summary_<role>.json`` into the serving output
directory: the run's ``serve`` record (requests, pushes, the frames' and
adopted models' digests, the gate's verdict, peak device memory).
"""
from __future__ import annotations

import copy
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..fed.site import peak_memory
from ..obs import xtrace
from ..obs.xtrace import XTracer
from . import PUSH_WIRE_IMPLS, SERVE_SALT
from .batcher import MicroBatcher, ServeRequest
from .publisher import (CheckpointPublisher, checkpoint_path,
                        load_checkpoint)
from .traffic import TrafficGenerator, trace_load, trace_save
from .worker import PERSONAL_FIELD, ServeWorker

logger = logging.getLogger(__name__)

#: serving store modes (``--serve_store``): the population lives on
#: disk by default — the tier the LRU hot set is measured against
SERVE_STORE_MODES = ("disk", "host")


def _refuse(why: str) -> None:
    raise SystemExit(f"serving deployment: {why}")


def validate_serve_args(args, algo_name: str) -> None:
    """The serve-mode refusal cluster (the fed runtime's SystemExit
    idiom): anything the serving plane cannot honor refuses loudly at
    parse/derive time instead of silently diverging."""
    role = getattr(args, "serve_role", "")
    if role not in ("worker", "publisher"):
        _refuse(f"unknown --serve_role {role!r} (worker|publisher)")
    if getattr(args, "fed_role", ""):
        _refuse("--serve_role and --fed_role are different processes; "
                "run the federation and the serving worker separately")
    if algo_name != "fedavg":
        _refuse(f"algo {algo_name!r} unsupported — the publisher ships "
                "FedAvg's round body; run --algo fedavg")
    if getattr(args, "multihost", False):
        _refuse("--multihost shards ONE training run over hosts; the "
                "serving plane is its own process pair")
    backend = getattr(args, "serve_backend", "local")
    if backend not in ("local", "tcp"):
        _refuse(f"unknown --serve_backend {backend!r} (local|tcp)")
    if backend == "local" and role != "worker":
        _refuse("--serve_backend local runs the publisher as the "
                "calling thread of the worker process; --serve_role "
                "publisher needs a real transport (tcp)")
    if backend == "tcp" and not getattr(args, "serve_endpoints", ""):
        _refuse("--serve_backend tcp needs --serve_endpoints "
                "host:port,host:port (rank 0 = publisher, 1 = worker)")
    if getattr(args, "serve_wire", "int8") not in PUSH_WIRE_IMPLS:
        _refuse(f"--serve_wire {getattr(args, 'serve_wire', '')!r} has "
                f"no push codec (supported: {PUSH_WIRE_IMPLS})")
    if getattr(args, "serve_store", "disk") not in SERVE_STORE_MODES:
        _refuse(f"--serve_store {getattr(args, 'serve_store', '')!r} "
                f"not in {SERVE_STORE_MODES}")
    if int(getattr(args, "serve_requests", 0)) < 1:
        _refuse("--serve_requests must be >= 1")
    if float(getattr(args, "serve_rps", 0.0)) <= 0:
        _refuse("--serve_rps must be > 0")
    if int(getattr(args, "serve_batch", 0)) < 1:
        _refuse("--serve_batch must be >= 1")
    if float(getattr(args, "serve_linger_ms", 0.0)) < 0:
        _refuse("--serve_linger_ms must be >= 0")
    if float(getattr(args, "serve_zipf", 0.0)) <= 0:
        _refuse("--serve_zipf must be > 0")
    if int(getattr(args, "serve_push_every", 0)) < 1:
        _refuse("--serve_push_every must be >= 1")
    if float(getattr(args, "serve_timeout_s", 0.0)) <= 0:
        _refuse("--serve_timeout_s must be > 0")
    n_workers = int(getattr(args, "serve_workers", 1) or 1)
    if n_workers < 1:
        _refuse("--serve_workers must be >= 1")
    if n_workers > 1 and backend == "tcp":
        _refuse("--serve_workers > 1 is the loopback fan-out harness; "
                "a tcp deployment runs one --serve_role worker process "
                "per rank against a single publisher")


def _out_dir(args, identity: str) -> str:
    d = getattr(args, "serve_out", "") or os.path.join(
        getattr(args, "results_dir", "results"), "serve", identity)
    os.makedirs(d, exist_ok=True)
    return d


def _make_session(args, algo_name: str, identity: str, out_dir: str,
                  suffix: str = "", catalog: bool = True):
    """A real ObsSession for the worker (runner template, minus the
    --obs gate): JSONL stream, SLO engine straight off --slo_spec,
    catalog entry at close. ``suffix`` keys extra fan-out workers'
    streams (``catalog=False`` for those — one catalog entry per run,
    not per subscriber)."""
    from ..experiments.config import run_identity
    from ..obs.export import ObsSession

    slo_engine = None
    if getattr(args, "slo_spec", ""):
        from ..obs.slo import SloEngine, load_slo_spec

        slo_engine = SloEngine(load_slo_spec(args.slo_spec))
    identity = identity + suffix
    jsonl = os.path.join(out_dir, identity + ".obs.jsonl")
    cat_path, cat_info = "", None
    if catalog and getattr(args, "obs_catalog", 1) and \
            getattr(args, "results_dir", ""):
        from ..obs import catalog as obs_catalog
        from ..obs.regress import git_sha as _git_sha

        cat_path = obs_catalog.catalog_path(args.results_dir)
        cat_info = {
            "config": vars(args),
            "checkpoint_identity": run_identity(
                args, algo_name, for_checkpoint=True),
            "git_sha": _git_sha(),
            # serving runs have no stat_info sidecar; the session's own
            # metrics.json is the summary artifact
            "stat_json": "",
        }
    session = ObsSession(
        jsonl_path=jsonl, identity=identity, slo=slo_engine,
        catalog_path=cat_path, catalog_info=cat_info)
    logger.info("serve obs: per-tick JSONL -> %s", jsonl)
    if slo_engine is not None:
        logger.info("serve slo: %d objective(s) armed, events -> %s",
                    len(slo_engine.objectives), session.events_path)
    return session


def _populate_store(args, out_dir: str, init_params, num_clients: int,
                    rank: int = 1):
    """The personal-model population: one deterministic per-client
    delta row, REALLY staged+committed (a disk-mode store ends up with
    real row files — the tier the Zipf head's LRU is measured against).
    Row c is a pure function of (seed, SERVE_SALT, c): re-deriving the
    population on the publisher side (or in a test) is byte-exact. Its
    leaves are drawn as the reference draws them, in the reference's leaf
    order and layout (``convert.reference_leaf_order``,
    ``to_reference_layout``), then laid out as this package's, so a row is
    bitwise the reference's row after conversion. Fan-out workers
    (rank > 1) stage into their own root — two LRU tiers must not share
    row files."""
    import torch

    from ..convert import (from_reference_layout, reference_leaf_order,
                           to_reference_layout)
    from ..core.client_store import ClientStore

    store = ClientStore(
        num_clients, mode=getattr(args, "serve_store", "disk"),
        hot_clients=int(getattr(args, "store_hot_clients", 64)),
        root=os.path.join(out_dir,
                          "store" if rank == 1 else f"store{rank}"))
    zeros = {k: torch.zeros(tuple(v.shape), dtype=torch.float32)
             for k, v in init_params.items()}
    store.register(PERSONAL_FIELD, zeros)
    order = reference_leaf_order(zeros)
    for c in range(num_clients):
        rng = np.random.default_rng((int(args.seed), SERVE_SALT, 2, c))
        row = {}
        for k in order:
            shape = tuple(to_reference_layout(k, zeros[k]).shape)
            a = (0.01 * rng.standard_normal((1,) + shape)).astype(
                np.float32)
            row[k] = from_reference_layout(
                k, torch.from_numpy(a), lead=1).contiguous()
        store.stage(PERSONAL_FIELD, [c], row)
    store.commit()
    return store


def _requests(args, num_clients: int, n_train) -> List[Tuple[int, int]]:
    """Materialize the request stream: a fresh Zipf draw, or a recorded
    trace (``--serve_replay``). ``--serve_trace`` records whichever
    stream actually ran (the replay-equality contract's artifact)."""
    if getattr(args, "serve_replay", ""):
        reqs = trace_load(args.serve_replay)
        for c, s in reqs:
            if not 0 <= c < num_clients:
                _refuse(f"--serve_replay names client {c} but the run "
                        f"has {num_clients}")
    else:
        gen = TrafficGenerator(
            num_clients, n_train,
            zipf_s=float(getattr(args, "serve_zipf", 1.1)),
            seed=int(args.seed))
        reqs = [(int(c), int(s))
                for c, s in gen.draw(int(args.serve_requests))]
    if getattr(args, "serve_trace", ""):
        trace_save(args.serve_trace, reqs,
                   meta={"seed": int(args.seed),
                         "zipf_s": float(getattr(args, "serve_zipf",
                                                 1.1)),
                         "num_clients": int(num_clients)})
    return reqs


def _pump_traffic(worker: ServeWorker, reqs, rps: float) -> None:
    """Open-loop submission at the target rate: the schedule advances
    by 1/rps per request regardless of service time, so a slow worker
    builds queue depth instead of silently shedding load."""
    interval = 1.0 / float(rps)
    t_next = time.perf_counter()
    try:
        for c, s in reqs:
            now = time.perf_counter()
            if t_next > now:
                time.sleep(t_next - now)
            worker.batcher.submit(ServeRequest(c, s))
            t_next += interval
    finally:
        worker.mark_traffic_done()


def _serve_tracer(args, process: str) -> Optional[XTracer]:
    """Per-process tracer for the serving pair (``--xtrace`` only).
    The publisher is the plane's reference clock."""
    if not getattr(args, "xtrace", 0):
        return None
    return XTracer(process, ref="publisher")


def _serve_xtrace_dir(args, out_dir: str) -> str:
    return getattr(args, "xtrace_dir", "") or out_dir


def _write_serve_stream(tracer: Optional[XTracer], args,
                        out_dir: str) -> str:
    if tracer is None:
        return ""
    return tracer.write(os.path.join(
        _serve_xtrace_dir(args, out_dir),
        tracer.process + xtrace.STREAM_SUFFIX))


def _probe_data(args, algo) -> Optional[Tuple[Any, Any]]:
    """The fixed labeled probe slab for ``--serve_probe_every``: the
    first training volume of the first few clients (deterministic),
    copied where the cohort lives (the stem kernel reads a contiguous
    batch)."""
    if int(getattr(args, "serve_probe_every", 0)) < 1:
        return None
    d = algo.data
    n = min(8, int(d.x_train.shape[0]))
    return d.x_train[:n, 0].contiguous(), d.y_train[:n, 0]


def _serve_heartbeat(args, peer: str):
    """One ``HeartbeatConfig`` per emitting process
    (``--obs_heartbeat_every`` only; ``None`` keeps every wire
    byte-inert — the fed runtime's gating contract, shared)."""
    every = float(getattr(args, "obs_heartbeat_every", 0.0) or 0.0)
    if every <= 0:
        return None
    from ..obs import live as obs_live

    return obs_live.HeartbeatConfig(peer, every)


def _serve_prom(args, snapshot_fn):
    """The worker's ``/metrics`` endpoint (``--obs_prom_port``; 0 =
    off, -1 = ephemeral). Returns the server or ``None``."""
    from ..obs import prom as obs_prom

    return obs_prom.maybe_prom_server(
        snapshot_fn, int(getattr(args, "obs_prom_port", 0) or 0))


def _serving_apply_fn(algo):
    """``apply_fn`` over a module of the worker's own, a copy of the
    algorithm's (the same configuration and buffers): the training thread's
    ``functional_call`` swaps ``algo.model``'s parameters in place while a
    step runs, so a forward through that module from the serving thread
    could run on the other thread's weights."""
    from ..models import make_apply_fn

    return make_apply_fn(copy.deepcopy(algo.model), algo.compute_dtype,
                         channel_inject=algo.channel_inject)


def _make_worker(args, algo, comm, session, out_dir: str,
                 init_params, rank: int = 1, world_size: int = 2,
                 tracer: Optional[XTracer] = None) -> ServeWorker:
    d = algo.data
    num_clients = int(d.x_train.shape[0])
    store = _populate_store(args, out_dir, init_params, num_clients,
                            rank=rank)
    batcher = MicroBatcher(
        max_batch=int(getattr(args, "serve_batch", 16)),
        linger_ms=float(getattr(args, "serve_linger_ms", 2.0)))
    return ServeWorker(
        comm, rank=rank, world_size=world_size,
        apply_fn=_serving_apply_fn(algo),
        init_params=init_params, store=store, data_x=d.x_train,
        data_n=d.n_train, batcher=batcher, session=session,
        retries=int(getattr(args, "fed_retries", 2)),
        backoff_s=float(getattr(args, "fed_backoff_s", 0.05)),
        tracer=tracer,
        probe_every=int(getattr(args, "serve_probe_every", 0)),
        probe_data=_probe_data(args, algo),
        heartbeat=_serve_heartbeat(args, f"worker{rank}"))


def _ckpt_dir(args, out_dir: str) -> str:
    return getattr(args, "serve_ckpt_dir", "") or os.path.join(
        out_dir, "ckpt")


def _bit_identity_gate(worker: ServeWorker, ckpt_dir: str) -> bool:
    """Compare the worker's live reconstruction against the checkpoint
    for the version it serves. Returns False (no gate) if no push was
    ever adopted or the checkpoint is not visible on this filesystem
    (a genuinely remote publisher); divergence is fatal."""
    from ..obs import diff as obs_diff

    if worker.pushes_adopted == 0:
        return False
    path = checkpoint_path(ckpt_dir, worker.version)
    if not os.path.exists(path):
        logger.warning("serve: checkpoint %s not visible; skipping "
                       "bit-identity gate", path)
        return False
    version, disk_params = load_checkpoint(path)
    pd = obs_diff.params_diff(worker.global_params, disk_params)
    if not pd["identical"]:
        _refuse(f"served model v{version} diverged from its disk "
                f"checkpoint: {len(pd['diverged'])} leaves, first "
                f"{pd['diverged'][:3]} — the push wire is NOT "
                "bit-transparent")
    logger.info("serve: v%d bit-identical to %s", version, path)
    return True


def _drain(args, worker: ServeWorker, session,
           serve_thread: threading.Thread, ckpt_dir: str,
           wall_s: float) -> Dict[str, Any]:
    """The graceful-drain path (satellite: the catalog must record
    completed=true for a serving stream): final round=-1 record,
    bit-identity gate, session finish."""
    timeout = float(getattr(args, "serve_timeout_s", 60.0))
    if not worker.drained.wait(timeout=timeout):
        _refuse(f"serve loop did not drain within {timeout}s "
                f"(queue depth {worker.batcher.depth()})")
    serve_thread.join(timeout=5.0)
    if worker.error is not None:
        _refuse(f"serve loop failed after {worker.requests_served} "
                f"requests: {worker.error!r}")
    rec = worker.drain_record()
    session.record_round(rec)
    gated = _bit_identity_gate(worker, ckpt_dir)
    slo_summary = session.slo.summary() if session.slo is not None \
        else None
    session.finish()
    worker.finish()
    served = worker.requests_served
    return {
        "requests": served, "batches": worker.batches_served,
        "pushes_adopted": worker.pushes_adopted,
        "model_version": worker.version,
        "hit_rate": rec["serve_hit_rate_total"],
        "bit_identical": gated, "wall_s": wall_s,
        "rps": served / wall_s if wall_s > 0 else 0.0,
        "slo": slo_summary, "jsonl": session.jsonl_path,
        "events": session.events_path if session.slo is not None
        else "", "metrics_json": session.metrics_json_path,
        "ckpt_dir": ckpt_dir, "forwards": worker.forwards,
        "adopt_digests": {str(v): h for v, h in
                          sorted(worker.adopt_digests.items())},
    }


def _train_and_push(args, algo, state, pub: CheckpointPublisher
                    ) -> Tuple[Any, int]:
    """The publisher's round loop: version 0 is the init full push (the
    baseline), then train ``--comm_round`` rounds pushing every
    ``--serve_push_every``."""
    pub.publish(state.global_params, 0)
    last_version = 0
    every = int(getattr(args, "serve_push_every", 1))
    for r in range(int(args.comm_round)):
        state, metrics = algo.run_round(state, r)
        if (r + 1) % every == 0:
            pub.publish(state.global_params, r + 1)
            last_version = r + 1
        logger.info("serve publisher round %d: %s", r, metrics)
    return state, last_version


def _summary(args, out_dir: str, serve: Dict[str, Any]) -> None:
    """``serve_summary_<role>.json``: the run's ``serve`` record."""
    path = os.path.join(out_dir,
                        f"serve_summary_{args.serve_role}.json")
    with open(path, "w") as f:
        json.dump(serve, f, indent=1, default=str)


def _run_loopback(args, algo_name: str, identity: str,
                  out_dir: str, algo=None) -> Dict[str, Any]:
    from ..comm.local import LocalRouter
    from ..experiments.runner import build_algorithm

    if algo is None:
        algo, _ = build_algorithm(args, algo_name)
    state = algo.init_state()
    init_params = state.global_params
    d = algo.data
    num_clients = int(d.x_train.shape[0])
    n_workers = int(getattr(args, "serve_workers", 1) or 1)
    router = LocalRouter(1 + n_workers)
    ckpt_dir = _ckpt_dir(args, out_dir)
    workers: List[ServeWorker] = []
    sessions = []
    for r in range(1, n_workers + 1):
        sess = _make_session(args, algo_name, identity, out_dir) \
            if r == 1 else _make_session(
                args, algo_name, identity, out_dir,
                suffix=f".w{r}", catalog=False)
        w = _make_worker(
            args, algo, router.manager(r), sess, out_dir, init_params,
            rank=r, world_size=1 + n_workers,
            tracer=_serve_tracer(
                args, "serve_worker" if r == 1 else f"serve_worker{r}"))
        w.run(background=True)
        workers.append(w)
        sessions.append(sess)
    worker, session = workers[0], sessions[0]
    pub = CheckpointPublisher(
        router.manager(0), world_size=1 + n_workers,
        worker_ranks=list(range(1, n_workers + 1)), ckpt_dir=ckpt_dir,
        wire_impl=getattr(args, "serve_wire", "int8"),
        retries=int(getattr(args, "fed_retries", 2)),
        backoff_s=float(getattr(args, "fed_backoff_s", 0.05)),
        tracer=_serve_tracer(args, "publisher"),
        heartbeat_every=float(
            getattr(args, "obs_heartbeat_every", 0.0) or 0.0))
    pub.run(background=True)
    for w in workers:
        w.clock_sync()
    worker.warmup()
    threads = []
    for w in workers:
        th = threading.Thread(target=w.serve_loop, daemon=True)
        th.start()
        threads.append(th)
        if w is not worker:
            # fan-out subscribers take no traffic in this harness —
            # they exist to adopt every push identically; an immediate
            # traffic_done lets their drain fire on serve_finish
            w.mark_traffic_done()
    reqs = _requests(args, num_clients, d.n_train)
    traffic = threading.Thread(
        target=_pump_traffic,
        args=(worker, reqs, float(getattr(args, "serve_rps", 200.0))),
        daemon=True)
    t0 = time.perf_counter()
    traffic.start()
    prom = _serve_prom(args, worker.prom_snapshot)
    try:
        # the training loop IS the calling thread: checkpoints stream
        # to the worker(s) while rank 1 absorbs the open-loop traffic
        state, last_version = _train_and_push(args, algo, state, pub)
        traffic.join()
        if not pub.wait_acked(last_version, timeout_s=float(
                getattr(args, "serve_timeout_s", 60.0))):
            _refuse(f"worker(s) never acked v{last_version} "
                    f"(watermarks {pub.acked_versions()})")
        pub.finish_worker()
        wall = time.perf_counter() - t0
        serve = _drain(args, worker, session, serve_thread=threads[0],
                       ckpt_dir=ckpt_dir, wall_s=wall)
        extras = [_drain(args, w, s, serve_thread=th,
                         ckpt_dir=ckpt_dir, wall_s=wall)
                  for w, s, th in zip(workers[1:], sessions[1:],
                                      threads[1:])]
    finally:
        pub.finish()
        if prom is not None:
            prom.close()
    _write_serve_stream(pub.tracer, args, out_dir)
    for w in workers:
        _write_serve_stream(w.tracer, args, out_dir)
    if worker.tracer is not None:
        serve["merged_trace"] = xtrace.merge_run_dir(
            _serve_xtrace_dir(args, out_dir)) or ""
    serve.update(pushes=pub.pushes, bytes_pushed=pub.bytes_pushed,
                 acked_version=pub.acked_version, out_dir=out_dir,
                 backend="local",
                 push_digests={str(v): h for v, h in
                               sorted(pub.push_digests.items())},
                 push_bytes={str(v): n for v, n in
                             sorted(pub.push_bytes.items())},
                 **peak_memory(algo.device))
    if n_workers > 1:
        serve["workers"] = [
            {"rank": r, "requests": s["requests"],
             "pushes_adopted": s["pushes_adopted"],
             "model_version": s["model_version"],
             "bit_identical": s["bit_identical"],
             "adopt_digests": s["adopt_digests"],
             "forwards": s["forwards"]}
            for r, s in enumerate([serve] + extras, start=1)]
        serve["acked_versions"] = {
            str(k): v for k, v in sorted(pub.acked_versions().items())}
    fleet = pub.fleet_snapshot()
    if fleet is not None:
        serve["fleet"] = fleet
        with open(os.path.join(out_dir, "fleet.json"), "w") as f:
            import json as _json

            _json.dump(fleet, f, indent=1)
    if prom is not None:
        serve["prom_port"] = prom.port
    _summary(args, out_dir, serve)
    return {"identity": identity, "history": [], "final_eval": {},
            "stat_path": out_dir, "state": None, "serve": serve}


def _run_tcp(args, algo_name: str, identity: str,
             out_dir: str) -> Dict[str, Any]:
    from ..comm.tcp import TcpCommManager
    from ..experiments.runner import build_algorithm
    from ..fed.runtime import parse_endpoints

    endpoints = parse_endpoints(
        getattr(args, "serve_endpoints", ""), 2)
    algo, _ = build_algorithm(args, algo_name)
    state = algo.init_state()
    init_params = state.global_params
    ckpt_dir = _ckpt_dir(args, out_dir)
    if args.serve_role == "publisher":
        pub = CheckpointPublisher(
            TcpCommManager(0, endpoints), ckpt_dir=ckpt_dir,
            wire_impl=getattr(args, "serve_wire", "int8"),
            retries=int(getattr(args, "fed_retries", 2)),
            backoff_s=float(getattr(args, "fed_backoff_s", 0.05)),
            tracer=_serve_tracer(args, "publisher"),
            heartbeat_every=float(
                getattr(args, "obs_heartbeat_every", 0.0) or 0.0))
        pub.run(background=True)
        t0 = time.perf_counter()
        try:
            state, last_version = _train_and_push(args, algo, state,
                                                  pub)
            if not pub.wait_acked(last_version, timeout_s=float(
                    getattr(args, "serve_timeout_s", 60.0))):
                _refuse(f"worker never acked v{last_version}")
            pub.finish_worker()
        finally:
            pub.finish()
        xtrace_path = _write_serve_stream(pub.tracer, args, out_dir)
        serve_pub = {"role": "publisher", "backend": "tcp",
                     "pushes": pub.pushes,
                     "bytes_pushed": pub.bytes_pushed,
                     "acked_version": pub.acked_version,
                     "ckpt_dir": ckpt_dir,
                     "wall_s": time.perf_counter() - t0,
                     "out_dir": out_dir,
                     "xtrace_path": xtrace_path,
                     "push_digests": {str(v): h for v, h in
                                      sorted(pub.push_digests.items())},
                     "push_bytes": {str(v): n for v, n in
                                    sorted(pub.push_bytes.items())},
                     **peak_memory(algo.device),
                     **pub.comm.counters.snapshot()}
        fleet = pub.fleet_snapshot()
        if fleet is not None:
            serve_pub["fleet"] = fleet
        _summary(args, out_dir, serve_pub)
        return {"identity": identity, "history": [], "final_eval": {},
                "stat_path": out_dir, "state": None,
                "serve": serve_pub}
    # worker role: serve own traffic, adopt pushes until serve_finish
    d = algo.data
    num_clients = int(d.x_train.shape[0])
    session = _make_session(args, algo_name, identity, out_dir)
    worker = _make_worker(args, algo, TcpCommManager(1, endpoints),
                          session, out_dir, init_params,
                          tracer=_serve_tracer(args, "serve_worker"))
    worker.run(background=True)
    worker.clock_sync()
    worker.warmup()
    serve_thread = threading.Thread(target=worker.serve_loop,
                                    daemon=True)
    serve_thread.start()
    reqs = _requests(args, num_clients, d.n_train)
    traffic = threading.Thread(
        target=_pump_traffic,
        args=(worker, reqs, float(getattr(args, "serve_rps", 200.0))),
        daemon=True)
    t0 = time.perf_counter()
    traffic.start()
    prom = _serve_prom(args, worker.prom_snapshot)
    timeout = float(getattr(args, "serve_timeout_s", 60.0))
    try:
        if not worker.done.wait(timeout=timeout):
            _refuse(
                f"no serve_finish from the publisher within {timeout}s")
        traffic.join(timeout=timeout)
        wall = time.perf_counter() - t0
        serve = _drain(args, worker, session, serve_thread, ckpt_dir,
                       wall)
    finally:
        if prom is not None:
            prom.close()
    if prom is not None:
        serve["prom_port"] = prom.port
    _write_serve_stream(worker.tracer, args, out_dir)
    if worker.tracer is not None:
        # same filesystem (the smoke's shape): the publisher's stream
        # is already on disk, so this merge holds both lanes
        serve["merged_trace"] = xtrace.merge_run_dir(
            _serve_xtrace_dir(args, out_dir)) or ""
    serve.update(role="worker", backend="tcp", out_dir=out_dir,
                 **peak_memory(algo.device))
    _summary(args, out_dir, serve)
    return {"identity": identity, "history": [], "final_eval": {},
            "stat_path": out_dir, "state": None, "serve": serve}


def run_serving(args, algo_name: str, *, algo=None) -> Dict[str, Any]:
    """The ``--serve_role`` entry point: validate, build, run the role. On
    the loopback backend ``algo`` (an algorithm built from ``args``) saves
    the build."""
    validate_serve_args(args, algo_name)
    from ..experiments.config import run_identity

    # "-serve" keeps the serving stream's catalog lineage distinct
    # from any training run with the same argv
    identity = run_identity(args, algo_name) + "-serve"
    out_dir = _out_dir(args, identity)
    backend = getattr(args, "serve_backend", "local")
    logger.info("serving: role=%s backend=%s wire=%s -> %s",
                args.serve_role, backend,
                getattr(args, "serve_wire", "int8"), out_dir)
    if backend == "local":
        return _run_loopback(args, algo_name, identity, out_dir,
                             algo=algo)
    return _run_tcp(args, algo_name, identity, out_dir)
