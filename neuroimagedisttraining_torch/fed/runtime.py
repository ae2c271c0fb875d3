"""Federation runtime: role dispatch, the loopback harness, refusals,
and the per-site observability fold (counterpart of
``neuroimagedisttraining_tpu/fed/runtime.py``).

``run_federated(args, algo_name)`` is the ``--fed_role`` entry the
runner dispatches to (``experiments/runner.py run_experiment``). Three
shapes of run:

* ``--fed_backend local`` — the single-process loopback: one
  ``LocalRouter``, sites on receive-pump threads sharing one built
  algorithm (their calls serialized on one lock), the aggregator in the
  calling thread. This is the test shape and the sync bit-parity
  anchor.
* ``--fed_backend tcp --fed_role aggregator`` — rank 0 of a real
  multi-process federation over the native TCP transport.
* ``--fed_backend tcp --fed_role site --fed_site_rank k`` — site
  process k (started by ``scripts/torch_run_federation.py``).

Every role runs on ``--device`` (CUDA by default, where it must be
present; ``--device cpu`` asks for the CPU): no role falls back.

Every process writes its own JSONL round/event streams into the fed
output directory; the aggregator folds them into ``federation.jsonl``
/ ``federation.events.jsonl`` with ``obs.export.merge_host_jsonl`` /
``merge_host_events`` — the multihost fold, reused verbatim (events
fold with ``dedupe=False``: the same event type in the same round on
two SITES is two events, not a rerun duplicate).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import xtrace
from ..obs.xtrace import XTracer
from ..robust.faults import FaultSpec, parse_fault_spec
from ..comm.message import to_numpy
from . import wire
from .aggregator import FedAggregator
from .site import SiteWorker, peak_memory
from .trainer import SiteTrainer

logger = logging.getLogger(__name__)

#: default real-process sleep for a site whose straggle fault fires
DEFAULT_STRAGGLE_S = 2.0

#: the aggregator's final global model, beside ``summary.json``
PARAMS_FILE = "global_params.npz"


def params_digest(params: Dict[str, np.ndarray]) -> str:
    """SHA-256 over a parameter tree's names, dtypes, shapes and bytes (in
    sorted name order): twins with equal digests are bitwise equal."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        a = np.ascontiguousarray(params[k])
        h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def parse_site_faults(
        spec: str) -> Dict[int, Tuple[Optional[FaultSpec], float, float]]:
    """``"rank:fault_spec[:delay_s];..."`` -> {site_rank: (FaultSpec,
    straggle_sleep_s, kill_after_s)}.

    The fault grammar is ``robust.faults.parse_fault_spec``'s
    (``drop=p,straggle=p,...``); the optional trailing ``:delay_s``
    sets how long a fired straggle sleeps the REAL site process
    (default ``DEFAULT_STRAGGLE_S``). Example:
    ``"3:straggle=1.0:6.0"`` — site 3 always straggles, 6s per round.
    ``"rank:byzantine"`` is sugar for ``rank:scale=1.0`` — an
    always-lying site shipping the 100x-forged delta every round.
    ``"rank:kill[:after_s]"`` is the process-death fault: the site goes
    COMPLETELY silent (no replies, no heartbeats, pump stopped)
    ``after_s`` seconds in — the fleet ledger's SITE_DOWN detection
    target, as distinct from ``drop`` (alive but withholding).
    Raises ``ValueError`` on malformed entries (parse-time validation,
    the derive() contract)."""
    out: Dict[int, Tuple[Optional[FaultSpec], float, float]] = {}
    if not spec:
        return out
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        rank_s, sep, rest = entry.partition(":")
        if not sep or not rest:
            raise ValueError(
                f"fed_site_faults entry {entry!r} is not "
                "rank:fault_spec[:delay_s]")
        try:
            rank = int(rank_s)
        except ValueError:
            raise ValueError(
                f"fed_site_faults rank {rank_s!r} is not an int") from None
        if rank < 1:
            raise ValueError(
                f"fed_site_faults rank {rank} must be >= 1 (site ranks)")
        delay = DEFAULT_STRAGGLE_S
        head, sep2, tail = rest.rpartition(":")
        if sep2 and "=" not in tail:
            try:
                delay = float(tail)
            except ValueError:
                raise ValueError(
                    f"fed_site_faults trailing field {tail!r} is neither "
                    "a fault clause nor a delay") from None
            rest = head
        if rank in out:
            raise ValueError(f"duplicate fed_site_faults rank {rank}")
        if rest == "kill":
            out[rank] = (None, 0.0, delay)
            continue
        if rest == "byzantine":
            # the Byzantine-role sugar: scale fires every round at the
            # default 100x factor (parse_fault_spec's scale_factor)
            rest = "scale=1.0"
        fs = parse_fault_spec(rest)
        if fs is None:
            raise ValueError(
                f"fed_site_faults entry {entry!r} has an empty fault spec")
        out[rank] = (fs, delay, 0.0)
    return out


def parse_endpoints(spec: str, world_size: int
                    ) -> List[Tuple[str, int]]:
    """``"host:port,host:port,..."`` rank-ordered (rank 0 = aggregator)."""
    eps = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if not sep:
            raise ValueError(
                f"fed_endpoints entry {part!r} is not host:port")
        eps.append((host, int(port)))
    if len(eps) != world_size:
        raise ValueError(
            f"fed_endpoints has {len(eps)} entries, need "
            f"{world_size} (aggregator + {world_size - 1} sites)")
    return eps


def _refuse(why: str) -> None:
    raise SystemExit(f"federated deployment: {why}")


def validate_fed_args(args, algo_name: str) -> None:
    """The fed-mode refusal cluster (the runner's SystemExit idiom):
    every in-process feature whose semantics a multi-process federation
    does not (yet) reproduce refuses loudly instead of silently
    diverging from the simulation."""
    if algo_name != "fedavg":
        _refuse(f"algo {algo_name!r} unsupported — the federation "
                "ships FedAvg's round body; run --algo fedavg")
    n_sites = int(getattr(args, "fed_sites", 0))
    if n_sites < 1:
        _refuse("--fed_sites must be >= 1")
    mode = getattr(args, "fed_mode", "")
    if mode not in ("sync", "buffered"):
        _refuse(f"unknown --fed_mode {mode!r}")
    if getattr(args, "fuse_rounds", 1) > 1:
        _refuse("--fuse_rounds > 1 fuses rounds into one device program;"
                " a federation advances the model over a wire per round")
    if getattr(args, "watchdog", None):
        _refuse("--watchdog rollback-retry drives the in-process round "
                "loop; the federation's degradation is quorum/staleness")
    if getattr(args, "client_store", "device") != "device":
        _refuse("--client_store host/disk residency is an in-process "
                "optimization; each site already holds only its clients")
    if getattr(args, "multihost", False):
        _refuse("--multihost (one model, many hosts, XLA collectives) "
                "and --fed_role (many models, message passing) are "
                "different distribution axes; pick one")
    if getattr(args, "defense_type", "none") not in ("", "none"):
        _refuse("robust defenses transform the [S]-stacked cohort "
                "inside one program; the aggregator only sees deltas")
    if getattr(args, "fault_spec", ""):
        _refuse("--fault_spec injects simulated in-jit faults; use "
                "--fed_site_faults to fault REAL site processes")
    if getattr(args, "eval_cache", 0):
        _refuse("--eval_cache rides in-process round state")
    if getattr(args, "checkpoint_dir", ""):
        _refuse("--checkpoint_dir round-granular checkpointing is not "
                "wired into the federation lifecycle yet")
    if getattr(args, "mesh_space", 1) > 1:
        _refuse("--mesh_space > 1 shards one simulation over a mesh")
    impl = getattr(args, "agg_impl", "dense")
    if mode == "sync":
        if impl != "dense":
            _refuse("sync federation ships full params dense — the "
                    "bit-parity anchor; compressed delta wires "
                    f"(--agg_impl {impl}) ride --fed_mode buffered")
        # the cohort-must-cover-sites check runs after build (needs C)
    else:
        if impl not in wire.WIRE_IMPLS:
            _refuse(f"--agg_impl {impl!r} has no federation wire codec "
                    f"(supported: {wire.WIRE_IMPLS})")
        if abs(getattr(args, "frac", 1.0) - 1.0) > 1e-9:
            _refuse("buffered federation trains each site's full client "
                    "block every dispatch; --frac sampling is a sync-"
                    "mode concept")
        if not 1 <= int(getattr(args, "fed_buffer_k", 0)) <= n_sites:
            _refuse(f"--fed_buffer_k must be in [1, fed_sites="
                    f"{n_sites}]")
        if int(getattr(args, "fed_staleness_bound", 0)) < 0:
            _refuse("--fed_staleness_bound must be >= 0")
    if getattr(args, "fed_replay", "") and mode != "buffered":
        _refuse("--fed_replay replays a buffered arrival trace; sync "
                "rounds are already deterministic")
    faults = parse_site_faults(getattr(args, "fed_site_faults", ""))
    for rank in faults:
        if rank > n_sites:
            _refuse(f"--fed_site_faults names site {rank} but there are "
                    f"only {n_sites} sites")


def _out_dir(args, identity: str) -> str:
    d = getattr(args, "fed_out", "") or os.path.join(
        getattr(args, "results_dir", "results"), "fed", identity)
    os.makedirs(d, exist_ok=True)
    return d


def _site_paths(out_dir: str, rank: int) -> Tuple[str, str]:
    return (os.path.join(out_dir, f"site{rank}.jsonl"),
            os.path.join(out_dir, f"site{rank}.events.jsonl"))


def _xtrace_dir(args, out_dir: str) -> str:
    return getattr(args, "xtrace_dir", "") or out_dir


def _fed_tracer(args, process: str) -> Optional[XTracer]:
    """One :class:`XTracer` per federation process (``--xtrace`` only;
    ``None`` keeps every wire byte-inert). The aggregator is the
    reference clock for both lanes and offsets."""
    if not getattr(args, "xtrace", 0):
        return None
    return XTracer(process, ref="aggregator")


def _write_stream(tracer: Optional[XTracer], args,
                  out_dir: str) -> str:
    if tracer is None:
        return ""
    return tracer.write(os.path.join(
        _xtrace_dir(args, out_dir),
        tracer.process + xtrace.STREAM_SUFFIX))


def _fed_slo(args):
    """The live federation SLO engine (``obs/slo.py``, observing aggregator
    round records) — armed only by ``--slo_spec``."""
    if not getattr(args, "slo_spec", ""):
        return None
    from ..obs.slo import SloEngine, load_slo_spec

    return SloEngine(load_slo_spec(args.slo_spec))


def _fed_heartbeat(args, peer: str):
    """One :class:`obs.live.HeartbeatConfig` per emitting process —
    ``--obs_heartbeat_every`` only; ``None`` keeps every wire
    byte-inert (the HELLO/xtrace gating contract, third instance)."""
    every = float(getattr(args, "obs_heartbeat_every", 0.0) or 0.0)
    if every <= 0:
        return None
    from ..obs import live as obs_live

    return obs_live.HeartbeatConfig(peer, every)


def _make_worker(args, comm, rank: int, world: int,
                 trainer: SiteTrainer, out_dir: str,
                 tracer: Optional[XTracer] = None) -> SiteWorker:
    faults = parse_site_faults(getattr(args, "fed_site_faults", ""))
    fs, delay, kill_after = faults.get(rank, (None, 0.0, 0.0))
    log_path, events_path = _site_paths(out_dir, rank)
    return SiteWorker(
        comm, rank, world, trainer, seed=args.seed,
        wire_impl=getattr(args, "agg_impl", "dense"),
        wire_density=getattr(args, "agg_topk_density", 0.1),
        fault_spec=fs, straggle_s=delay, kill_after_s=kill_after,
        retries=args.fed_retries, backoff_s=args.fed_backoff_s,
        log_path=log_path, events_path=events_path, tracer=tracer,
        heartbeat=_fed_heartbeat(args, f"site{rank}"))


def _make_aggregator(args, comm, world: int, algo, out_dir: str,
                     tracer: Optional[XTracer] = None,
                     round_draws=None, lock=None) -> FedAggregator:
    replay = None
    if getattr(args, "fed_replay", ""):
        with open(args.fed_replay) as f:
            replay = json.load(f)
    return FedAggregator(
        comm, world, algo, mode=args.fed_mode, rounds=args.comm_round,
        seed=args.seed, buffer_k=args.fed_buffer_k,
        staleness_bound=args.fed_staleness_bound,
        timeout_s=args.fed_timeout_s, retries=args.fed_retries,
        backoff_s=args.fed_backoff_s,
        wire_impl=getattr(args, "agg_impl", "dense"),
        wire_density=getattr(args, "agg_topk_density", 0.1),
        replay_trace=replay,
        robust_agg=getattr(args, "robust_agg", "none"),
        robust_trim=getattr(args, "robust_trim", 0.2),
        robust_krum_f=getattr(args, "robust_krum_f", 0),
        robust_norm_bound=getattr(args, "norm_bound", 5.0),
        log_path=os.path.join(out_dir, "aggregator.jsonl"),
        events_path=os.path.join(out_dir, "aggregator.events.jsonl"),
        tracer=tracer, slo=_fed_slo(args),
        heartbeat_every=float(
            getattr(args, "obs_heartbeat_every", 0.0) or 0.0),
        round_draws=round_draws, lock=lock)


def _fold_obs(out_dir: str, n_sites: int) -> Dict[str, str]:
    """Fold the aggregator's + every site's streams into one timeline
    (host 0 = aggregator, host k = site k — the merge functions' host
    tagging is positional, which matches the rank numbering)."""
    from ..obs.export import merge_host_events, merge_host_jsonl

    paths = {"federation_jsonl": "", "federation_events": ""}
    rounds = [os.path.join(out_dir, "aggregator.jsonl")] + \
        [_site_paths(out_dir, k)[0] for k in range(1, n_sites + 1)]
    rounds = [p for p in rounds if os.path.exists(p)]
    if rounds:
        merged = merge_host_jsonl(rounds)
        dst = os.path.join(out_dir, "federation.jsonl")
        with open(dst, "w") as f:
            for rec in merged:
                f.write(json.dumps(rec) + "\n")
        paths["federation_jsonl"] = dst
    events = [os.path.join(out_dir, "aggregator.events.jsonl")] + \
        [_site_paths(out_dir, k)[1] for k in range(1, n_sites + 1)]
    events = [p for p in events if os.path.exists(p)]
    if events:
        # dedupe=False: (round, event_type) collides across SITES by
        # design — they are distinct events, not rerun duplicates
        merged = merge_host_events(events, dedupe=False)
        dst = os.path.join(out_dir, "federation.events.jsonl")
        with open(dst, "w") as f:
            for rec in merged:
                f.write(json.dumps(rec) + "\n")
        paths["federation_events"] = dst
    return paths


def _finish_aggregator(args, agg: FedAggregator, algo, identity: str,
                       out_dir: str) -> Dict[str, Any]:
    trace_path = ""
    if agg.mode == "buffered" and agg.replay_trace is None:
        trace_path = getattr(args, "fed_trace", "") or \
            os.path.join(out_dir, "trace.json")
        with open(trace_path, "w") as f:
            json.dump(agg.trace, f, indent=1)
    with agg.lock:
        ev = algo._eval_global(agg.global_params)
        final_eval = {"global_acc": float(ev["acc"]),
                      "global_loss": float(ev["loss"])}
    fold = _fold_obs(out_dir, agg.n_sites)
    xtrace_path = _write_stream(agg.tracer, args, out_dir)
    merged_trace = ""
    if agg.tracer is not None:
        # loopback: every site stream is on disk by now, so this is the
        # complete merge; TCP: a partial (aggregator-lane) merge the
        # launcher re-runs once the site processes have written theirs
        merged_trace = xtrace.merge_run_dir(
            _xtrace_dir(args, out_dir)) or ""
    fed = {
        "mode": agg.mode, "sites": agg.n_sites,
        "version": agg.version, "stale_drops": agg.stale_drops,
        "staleness_hist": {str(k): v for k, v in
                           sorted(agg.staleness_hist.items())},
        "trace_path": trace_path, "out_dir": out_dir,
        "replayed": agg.replay_trace is not None,
        "robust_agg": agg.robust_agg,
        "byzantine_flags": {str(k): v for k, v in
                            sorted(agg.byzantine_flags.items())},
        **fold, **agg.comm.counters.snapshot(),
        **peak_memory(algo.device),
    }
    if xtrace_path:
        fed["xtrace_path"] = xtrace_path
        fed["merged_trace"] = merged_trace
    if agg.slo is not None:
        fed["slo"] = agg.slo.summary()
    if agg.ledger is not None:
        # the final fleet snapshot (+ a disk copy for `obs watch`):
        # per-peer liveness states, heartbeat frame counts, gauges
        fed["fleet"] = agg.ledger.snapshot(time.monotonic())
        with open(os.path.join(out_dir, "fleet.json"), "w") as f:
            json.dump(fed["fleet"], f, indent=1)
    params = {k: to_numpy(v) for k, v in agg.global_params.items()}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"identity": identity, "final_eval": final_eval,
                   "rounds": len([r for r in agg.history
                                  if r.get("round", -1) >= 0]),
                   "history": agg.history,
                   "params_sha256": params_digest(params),
                   "fed": fed}, f, indent=1)
    np.savez(os.path.join(out_dir, PARAMS_FILE), **params)
    return {
        "identity": identity, "history": agg.history,
        "final_eval": final_eval, "stat_path": out_dir, "state": None,
        "global_params": params, "fed": fed,
    }


def _run_loopback(args, algo_name: str, identity: str, out_dir: str,
                  algo=None, round_draws=None) -> Dict[str, Any]:
    from ..comm.local import LocalRouter
    from ..experiments.runner import build_algorithm

    if algo is None:
        algo, _ = build_algorithm(args, algo_name)
    if args.fed_mode == "sync" and \
            algo.clients_per_round < args.fed_sites:
        _refuse(f"sync cohort of {algo.clients_per_round} clients "
                f"cannot cover {args.fed_sites} sites")
    world = args.fed_sites + 1
    router = LocalRouter(world)
    trainer = SiteTrainer(algo)
    workers = []
    for k in range(1, world):
        w = _make_worker(args, router.manager(k), k, world, trainer,
                         out_dir, tracer=_fed_tracer(args, f"site{k}"))
        w.run(background=True)
        workers.append(w)
    agg = _make_aggregator(args, router.manager(0), world, algo,
                           out_dir,
                           tracer=_fed_tracer(args, "aggregator"),
                           round_draws=round_draws, lock=trainer.lock)
    agg.run(background=True)
    try:
        agg.execute()
    finally:
        for w in workers:
            # a deliberately-straggling site may still be asleep in its
            # handler: finish() wakes it, and it gives up its round
            w.done.wait(timeout=2.0)
            w.finish()
            _write_stream(w.tracer, args, out_dir)
        agg.finish()
    return _finish_aggregator(args, agg, algo, identity, out_dir)


def _run_tcp(args, algo_name: str, identity: str,
             out_dir: str) -> Dict[str, Any]:
    from ..comm.tcp import TcpCommManager
    from ..experiments.runner import build_algorithm

    world = args.fed_sites + 1
    endpoints = parse_endpoints(args.fed_endpoints, world)
    algo, _ = build_algorithm(args, algo_name)
    if args.fed_role == "aggregator":
        if args.fed_mode == "sync" and \
                algo.clients_per_round < args.fed_sites:
            _refuse(f"sync cohort of {algo.clients_per_round} clients "
                    f"cannot cover {args.fed_sites} sites")
        agg = _make_aggregator(
            args, TcpCommManager(0, endpoints), world, algo, out_dir,
            tracer=_fed_tracer(args, "aggregator"))
        agg.run(background=True)
        try:
            agg.execute()
        finally:
            agg.finish()
        return _finish_aggregator(args, agg, algo, identity, out_dir)
    rank = int(getattr(args, "fed_site_rank", 0))
    if not 1 <= rank <= args.fed_sites:
        _refuse(f"--fed_site_rank {rank} outside [1, fed_sites="
                f"{args.fed_sites}]")
    trainer = SiteTrainer(algo)
    worker = _make_worker(args, TcpCommManager(rank, endpoints), rank,
                          world, trainer, out_dir,
                          tracer=_fed_tracer(args, f"site{rank}"))
    worker.run(background=True)
    worker.done.wait()
    worker.finish()
    xtrace_path = _write_stream(worker.tracer, args, out_dir)
    fed: Dict[str, Any] = {"role": "site", "rank": rank,
                           "rounds_trained": worker.rounds_trained,
                           **peak_memory(algo.device),
                           **worker.comm.counters.snapshot()}
    if xtrace_path:
        fed["xtrace_path"] = xtrace_path
    return {"identity": identity, "history": [], "final_eval": {},
            "stat_path": out_dir, "state": None, "fed": fed}


def run_federated(args, algo_name: str, *, algo=None,
                  round_draws=None) -> Dict[str, Any]:
    """The ``--fed_role`` entry point: validate, build, run the role.
    On the loopback backend ``algo`` (an algorithm built from ``args``)
    saves the build, and ``round_draws`` (per sync round, the
    ``run_round`` seams) replaces the rounds' draws."""
    validate_fed_args(args, algo_name)
    from ..experiments.config import run_identity

    identity = run_identity(args, algo_name)
    out_dir = _out_dir(args, identity)
    backend = getattr(args, "fed_backend", "local")
    logger.info("federation: role=%s backend=%s mode=%s sites=%d -> %s",
                args.fed_role, backend, args.fed_mode, args.fed_sites,
                out_dir)
    if backend == "local":
        if args.fed_role == "site":
            _refuse("--fed_backend local runs sites as in-process "
                    "threads; --fed_role site needs a real transport "
                    "(tcp)")
        return _run_loopback(args, algo_name, identity, out_dir,
                             algo=algo, round_draws=round_draws)
    if backend == "tcp":
        return _run_tcp(args, algo_name, identity, out_dir)
    _refuse(f"unknown --fed_backend {backend!r} (local|tcp)")
