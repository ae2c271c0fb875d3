"""FedAggregator: rank-0 of a federation — two aggregation policies
behind one surface (counterpart of
``neuroimagedisttraining_tpu/fed/aggregator.py``).

**sync** — barrier per round. The aggregator owns the in-process state's
``torch.Generator`` and advances it exactly as ``FedAlgorithm.run_round``
does (``_eager_inputs``: the round's draws from a copy of the generator,
which the next round starts from), ships each site the global model, its
slots' client ids and its slots' draws, and reassembles the sites'
locally-trained rows in slot order into the SAME [S] stack the
in-process round aggregates, through the port's own FedAvg aggregate
(``FedAlgorithm._aggregate``: the weighted-sum kernel on the card). On
the loopback backend and over TCP on one card this is bit for bit the
in-process run. An optional per-round ``round_draws`` (the ``run_round``
seams: epoch permutations, dropout masks) replaces the drawn ones, so a
test can feed the JAX package's draws. Missing sites degrade the round
to a survivor-renormalized quorum aggregate (the ``RoundOutcome``
semantics of ``comm/cross_silo.py``, here at federation scale), and zero
arrivals carry the global model.

**buffered** — FedBuff (Nguyen et al., AISTATS 2022): deltas are
applied in arrival order, K per flush, each weighted
``n_i / sqrt(1 + tau_i)`` (staleness-discounted, normalized over the
buffer) — a straggling site stops gating the round clock. Updates
staler than ``staleness_bound`` are dropped and the site re-dispatched
at the current version. Every flush's ``(site, base_version)`` members
are recorded to an **arrival trace**; replaying the trace re-applies
the same deltas in the same order — and because a site's delta is a
pure function of ``(seed, version, site)`` (``protocol.site_round_key``)
the replayed run is bit-for-bit identical (the async twin of the
repo's determinism contract).
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..comm.manager import ServerManager
from ..comm.message import Message, to_numpy, tree_flatten, tree_unflatten
from ..obs import live as obs_live, xtrace
from ..obs.export import RoundLogWriter, record_schema
from ..obs.xtrace import XTracer
from . import protocol, wire
from .site import peak_memory
from .trainer import slot_draws

logger = logging.getLogger(__name__)

#: clock-offset re-handshake cadence (rounds/flushes): the NTP-midpoint
#: estimate drifts over long runs, so the aggregator re-initiates the
#: HELLO pair every this many rounds and the FRESHEST offset wins —
#: both here (``fed_wire_ms`` attribution via ``to_ref_ns``) and in the
#: merged-trace lane alignment (``xtrace.merge_docs`` keeps the last
#: offset a stream carries).
CLOCK_RESYNC_EVERY = 16

#: Byzantine norm screen: a member whose delta norm exceeds this factor
#: times the median member norm is flagged (typed BYZANTINE event +
#: fault-attribution naming the site). Detection only — survival comes
#: from ``robust_agg``; an attacker below the screen still gets voted
#: out by the robust statistic, it just isn't NAMED by the screen.
BYZ_NORM_FACTOR = 10.0


class FedAggregator(ServerManager):
    def __init__(self, comm, world_size: int, algo: Any, *, mode: str,
                 rounds: int, seed: int, buffer_k: int = 1,
                 staleness_bound: int = 2, timeout_s: float = 60.0,
                 retries: int = 2, backoff_s: float = 0.05,
                 wire_impl: str = "dense", wire_density: float = 0.1,
                 replay_trace: Optional[Dict[str, Any]] = None,
                 robust_agg: str = "none", robust_trim: float = 0.2,
                 robust_krum_f: int = 0, robust_norm_bound: float = 5.0,
                 log_path: str = "", events_path: str = "",
                 tracer: Optional[XTracer] = None, slo: Any = None,
                 heartbeat_every: float = 0.0,
                 round_draws: Optional[List[Dict[str, Any]]] = None,
                 lock: Optional[threading.Lock] = None):
        super().__init__(comm, rank=0, world_size=world_size)
        self.algo = algo
        self.mode = mode
        self.rounds = int(rounds)
        self.seed = int(seed)
        self.n_sites = world_size - 1
        self.buffer_k = max(1, int(buffer_k))
        self.staleness_bound = int(staleness_bound)
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.wire_impl = wire_impl
        self.wire_density = wire_density
        self.replay_trace = replay_trace
        # robust_agg: Byzantine-robust statistic replacing the weighted
        # sum (sync) / discounted delta sum (buffered) — the same
        # robust/aggregation.py estimators the in-process round runs,
        # here over SITE rows/deltas on the aggregator host
        from ..robust.aggregation import ROBUST_AGGS

        if robust_agg not in ROBUST_AGGS:
            raise ValueError(
                f"robust_agg {robust_agg!r} not in {ROBUST_AGGS}")
        self.robust_agg = robust_agg
        self.robust_trim = float(robust_trim)
        self.robust_krum_f = int(robust_krum_f)
        self.robust_norm_bound = float(robust_norm_bound)
        self.byzantine_flags: Dict[int, int] = {}  # site -> flag count
        # buffered sites own fixed client blocks; sync re-partitions the
        # sampled cohort per round
        self.partition = protocol.partition_slots(
            algo.num_clients, self.n_sites)
        # the aggregator owns exactly the in-process state: params from
        # the same init draws, the same generator (the per-client rows are
        # the sites' business)
        state0 = algo.init_state()
        self.state = dataclasses.replace(
            state0, **{f: None for f in algo._row_fields_of(state0)})
        #: per sync round, the ``run_round`` seams replacing its draws
        self.round_draws = round_draws
        #: the algorithm's calls serialize on this (loopback sites share
        #: the algorithm: ``SiteTrainer.lock``)
        self.lock = lock if lock is not None else threading.Lock()
        self.version = 0
        self.history: List[Dict[str, Any]] = []
        self.staleness_hist: Dict[int, int] = {}
        self.stale_drops = 0
        self.trace: Dict[str, Any] = {
            "mode": mode, "seed": self.seed, "sites": self.n_sites,
            "buffer_k": self.buffer_k,
            "staleness_bound": self.staleness_bound, "flushes": []}
        self.writer = RoundLogWriter(log_path, force=True) \
            if log_path else None
        self.events = RoundLogWriter(events_path, force=True) \
            if events_path else None
        self._norm_history: List[float] = []
        self.tracer = tracer
        self.slo = slo  # SloEngine observing federation round records
        self._updates: "queue.Queue[Message]" = queue.Queue()
        self.register_message_receive_handler(
            protocol.MSG_FED_UPDATE, self._enqueue_update)
        self._hello_acks: "queue.Queue[Dict[str, float]]" = queue.Queue()
        self.register_message_receive_handler(
            protocol.MSG_FED_HELLO_ACK, self._on_hello_ack)
        # fleet ledger (--obs_heartbeat_every): per-site liveness state
        # machine fed by standalone HEARTBEAT frames + the hb_* headers
        # piggybacked on UPDATE replies. The handler is registered
        # unconditionally (inert unless sites actually send, which is
        # flag-gated — the same idiom as the HELLO echo); the lock
        # serializes pump-thread observations against round-loop ticks.
        self.ledger: Optional[obs_live.FleetLedger] = \
            obs_live.FleetLedger(heartbeat_every) \
            if heartbeat_every > 0 else None
        self._ledger_lock = threading.Lock()
        self.register_message_receive_handler(
            protocol.MSG_FED_HEARTBEAT, self._on_heartbeat)
        if self.ledger is not None:
            now = time.monotonic()
            for k in range(1, self.n_sites + 1):
                # expected peers start LIVE with the silence clock
                # running: a site that dies before its first heartbeat
                # still goes DOWN
                self.ledger.register(f"site{k}", now)
        # per-round wire/queue accumulators (tracing on): reset at every
        # round / flush boundary
        self._xt_wire_ns = 0.0
        self._xt_queue_ns = 0.0
        self._xt_round_t0 = time.perf_counter()
        # buffered-mode re-handshake latch: one resync per flush index
        self._resynced_at = -1

    @property
    def global_params(self) -> Dict[str, torch.Tensor]:
        return self.state.global_params

    @global_params.setter
    def global_params(self, params: Dict[str, torch.Tensor]) -> None:
        self.state = dataclasses.replace(self.state, global_params=params)

    # -- clock sync / trace plumbing (xtrace-gated, byte-inert off) -------
    def _enqueue_update(self, msg: Message) -> None:
        # arrival stamp BEFORE the queue: dequeue - arrival is queue
        # wait, site-send - arrival (offset-corrected) is the wire leg.
        # The attribute lives on the in-memory Message only — never
        # serialized, so the wire stays byte-identical either way.
        if self.tracer is not None:
            msg.xt_arrival_ns = self.tracer.wall_ns()
        self._observe_heartbeat(msg)
        self._updates.put(msg)

    # -- fleet ledger (heartbeat-gated, byte-inert off) -------------------
    def _observe_heartbeat(self, msg: Message) -> None:
        """Fold an inbound frame's piggybacked ``hb_*`` headers (or a
        standalone HEARTBEAT frame) into the ledger; heartbeat-free
        frames read unchanged."""
        if self.ledger is None:
            return
        hb = obs_live.extract_heartbeat(msg)
        if hb is None:
            return
        with self._ledger_lock:
            events = self.ledger.observe(
                hb["peer"], time.monotonic(),
                round_idx=hb["round"], gauges=hb["gauges"])
        for ev in events:
            self._emit_live_event(ev)

    def _on_heartbeat(self, msg: Message) -> None:
        self._observe_heartbeat(msg)

    def _emit_live_event(self, ev) -> None:
        rec = ev.to_record()
        logger.warning("fleet: %s", ev.message)
        if self.events is not None:
            with self._ledger_lock:
                self.events.write(rec)

    def _ledger_tick(self) -> None:
        """Advance the liveness clocks (SITE_DOWN fires here — from
        the round loop, so detection happens WHILE a collect wait is
        still pending, not after the round timeout)."""
        if self.ledger is None:
            return
        with self._ledger_lock:
            events = self.ledger.tick(time.monotonic())
        for ev in events:
            self._emit_live_event(ev)

    def _get_update(self, timeout: float) -> Message:
        """``_updates.get`` that keeps the ledger ticking: with
        heartbeats on, the blocking wait is sliced at the heartbeat
        interval so a dying site turns SUSPECT/DOWN mid-wait instead
        of only after the round timeout. Raises ``queue.Empty`` after
        ``timeout`` like the plain get."""
        if self.ledger is None:
            return self._updates.get(timeout=timeout)
        deadline = time.monotonic() + max(0.0, float(timeout))
        while True:
            self._ledger_tick()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise queue.Empty
            try:
                return self._updates.get(timeout=min(
                    remaining, self.ledger.interval_s))
            except queue.Empty:
                continue

    def _on_hello_ack(self, msg: Message) -> None:
        t2 = self.tracer.wall_ns() if self.tracer is not None \
            else time.time_ns()
        self._hello_acks.put({"rank": int(msg.get("rank", -1)),
                              "t0": float(msg.get("t0_ns", 0)),
                              "t1": float(msg.get("t1_ns", 0)),
                              "t2": float(t2)})

    def clock_sync(self, timeout_s: Optional[float] = None) -> None:
        """One HELLO handshake per site: NTP-midpoint clock-offset
        estimate (``xtrace.ntp_offset``) recorded on the tracer, keying
        both the merged-trace lane alignment and the per-update wire
        attribution. Only ever called when tracing is on. Re-invoked
        every ``CLOCK_RESYNC_EVERY`` rounds (with a short timeout so a
        dead site cannot stall the round loop); ``note_offset``
        overwrites, so the freshest estimate wins everywhere."""
        if self.tracer is None:
            return
        for k in range(1, self.n_sites + 1):
            self._send(protocol.hello_message(
                0, k, self.tracer.wall_ns()))
        deadline = time.monotonic() + (
            self.timeout_s if timeout_s is None else float(timeout_s))
        got = 0
        while got < self.n_sites:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                ack = self._hello_acks.get(timeout=remaining)
            except queue.Empty:
                break
            offset, rtt = xtrace.ntp_offset(
                ack["t0"], ack["t1"], ack["t2"])
            self.tracer.note_offset(
                f"site{int(ack['rank'])}", offset, rtt)
            got += 1
        if got < self.n_sites:
            logger.warning("fed hello: %d/%d sites answered before "
                           "timeout; missing lanes merge unaligned",
                           got, self.n_sites)

    def _note_arrival(self, msg: Message) -> None:
        """Fold one dequeued update into the round's queue-wait and
        wire-leg accumulators (tracing on; no-op otherwise)."""
        if self.tracer is None:
            return
        arrival = getattr(msg, "xt_arrival_ns", None)
        if arrival is None:
            return
        self._xt_queue_ns += max(
            0.0, self.tracer.wall_ns() - arrival)
        send = xtrace.send_wall_ns(msg)
        if send is None:
            return
        site = msg.get("site")
        peer = f"site{int(site)}" if site is not None else ""
        self._xt_wire_ns += max(
            0.0, arrival - self.tracer.to_ref_ns(send, peer))

    # -- Byzantine screen / robust combine --------------------------------
    def _byzantine_screen(self, round_idx: int, sites: List[int],
                          norms: List[float]) -> List[int]:
        """Flag members whose delta norm exceeds ``BYZ_NORM_FACTOR`` x
        the running median member norm (history + this round — the
        history keeps the baseline honest-dominated even when one flush
        holds too few members for a meaningful within-flush median).
        Emits ONE typed BYZANTINE event naming the flagged sites.
        Norms append in member order at aggregate time, so a trace
        replay reproduces the identical screen decisions."""
        self._norm_history.extend(float(x) for x in norms)
        self._norm_history = self._norm_history[-256:]
        med = float(np.median(np.asarray(self._norm_history,
                                         np.float32)))
        flagged = [int(s) for s, nm in zip(sites, norms)
                   if nm > BYZ_NORM_FACTOR * max(med, 1e-12)]
        if flagged:
            for s in flagged:
                self.byzantine_flags[s] = \
                    self.byzantine_flags.get(s, 0) + 1
            logger.warning(
                "round %d BYZANTINE screen: sites %s ship deltas > "
                "%gx the median member norm (%.3g)", round_idx,
                flagged, BYZ_NORM_FACTOR, med)
            self._event(round_idx, "BYZANTINE", sites=flagged,
                        norm_median=med,
                        norms={str(int(s)): float(n)
                               for s, n in zip(sites, norms)})
        return flagged

    def _robust_combine(self, delta_mat: np.ndarray,
                        weights: np.ndarray) -> np.ndarray:
        """One robust [N] delta from the [M, N] member-delta matrix —
        the same ``robust_combine_mat`` estimator the in-jit round body
        runs, evaluated on the aggregator host (same function, same
        inputs: deterministic for record AND replay)."""
        from ..robust.aggregation import robust_combine_mat

        return robust_combine_mat(
            torch.as_tensor(np.asarray(delta_mat, np.float32)),
            torch.as_tensor(np.asarray(weights, np.float32)),
            self.robust_agg, trim_frac=self.robust_trim,
            krum_f=self.robust_krum_f,
            norm_bound=self.robust_norm_bound).numpy().astype(np.float32)

    # -- shared plumbing --------------------------------------------------
    def _send(self, msg: Message) -> None:
        protocol.send_with_retry(self, msg, retries=self.retries,
                                 backoff_s=self.backoff_s)

    def _event(self, round_idx: int, event_type: str, **extra) -> None:
        if self.events is not None:
            self.events.write({"round": int(round_idx),
                               "event_type": event_type, **extra})

    def _record(self, rec: Dict[str, Any]) -> None:
        if self.ledger is not None and int(rec.get("round", -1)) >= 0:
            # federation-scope gauges join the round record BEFORE the
            # SLO engine sees it, so --slo_spec can declare fleet
            # objectives (min sites live, max heartbeat age). The keys
            # are volatile in obs/diff.py — heartbeat-on twins stay
            # ``identical``.
            self._ledger_tick()
            with self._ledger_lock:
                self.ledger.note_round(int(rec["round"]))
                rec = {**rec, **self.ledger.fleet_gauges(
                    time.monotonic())}
        self.history.append(rec)
        if self.slo is not None and int(rec.get("round", -1)) >= 0:
            # live SLO evaluation on the federation round stream
            # (obs/slo.py): p95:fed_round_ms<... style objectives
            # breach DURING the run, not in a postmortem
            rec = dict(rec)
            for ev in self.slo.observe(rec):
                if self.events is not None:
                    with self._ledger_lock:
                        self.events.write(ev.to_record())
            rec["slo_health"] = self.slo.health
            rec["slo_breached"] = float(len(self.slo.breached))
            rec["obs_schema"] = record_schema(rec)
            self.history[-1] = rec
        if self.writer is not None:
            self.writer.write(rec)

    def execute(self) -> None:
        """Run the configured number of rounds (sync) or flushes
        (buffered), then tell every site to finish."""
        self.clock_sync()
        if self.mode == "sync":
            for r in range(self.rounds):
                self.run_sync_round(r)
        elif self.replay_trace is not None:
            self.run_buffered_replay()
        else:
            self.run_buffered()
        with xtrace.xspan(self.tracer, "finish",
                          trace_id="finish") as fin:
            for dest in range(1, self.world_size):
                msg = Message(protocol.MSG_FED_FINISH, 0, dest)
                if self.tracer is not None:
                    xtrace.inject(msg, fin.ctx(),
                                  wall_ns=self.tracer.wall_ns())
                try:
                    self._send(msg)
                except OSError:
                    logger.warning("site %d unreachable at finish", dest)
        if self.writer is not None:
            self._record({"round": -1, "fed_mode": self.mode,
                          "fed_version": self.version,
                          "fed_stale_drops": self.stale_drops,
                          "fed_staleness_hist": {
                              str(k): v for k, v
                              in sorted(self.staleness_hist.items())},
                          **peak_memory(self.algo.device),
                          **self.comm.counters.snapshot()})
            self.writer.close()
        if self.events is not None:
            self.events.close()

    # -- synchronous barrier ---------------------------------------------
    def run_sync_round(self, round_idx: int) -> str:
        """One barrier round; returns completed|quorum|timeout."""
        tr = self.tracer
        if tr is not None and round_idx > 0 and \
                round_idx % CLOCK_RESYNC_EVERY == 0:
            # drift fix: refresh the per-site offsets between rounds
            # (sites are idle at the barrier, so acks are immediate; a
            # dead site only costs the short bounded wait)
            self.clock_sync(timeout_s=min(self.timeout_s, 2.0))
        if self.ledger is not None:
            with self._ledger_lock:
                self.ledger.note_round(round_idx)
        self._xt_wire_ns = self._xt_queue_ns = 0.0
        t_round = time.perf_counter()
        # the round's trace tree: minted from the round index, so twin
        # runs produce identical ids (the structure-determinism contract)
        with xtrace.xspan(tr, "fed_round", trace_id=f"r{round_idx}",
                          args={"round": round_idx}) as rspan:
            algo = self.algo
            sel = algo._selected_client_indexes(round_idx)
            s_total = int(sel.shape[0])
            seams = dict(self.round_draws[round_idx]) \
                if self.round_draws is not None else {}
            with self.lock:
                # the in-process round's draws, from a copy of the state's
                # generator (which the next round starts from)
                inp, generator = algo._eager_inputs(self.state, round_idx,
                                                    seams)
            parts = protocol.partition_slots(s_total, self.n_sites)
            with xtrace.xspan(tr, "dispatch",
                              args={"sites": self.n_sites}) as dspan:
                for k in range(1, self.n_sites + 1):
                    pos = parts[k - 1]
                    msg = Message(protocol.MSG_FED_TRAIN, 0, k)
                    msg.add("version", round_idx)
                    msg.add("mode", "sync")
                    msg.add("cohort_size", s_total)
                    msg.add_tensor("params", self.global_params)
                    msg.add_tensor("client_ids",
                                   sel[pos].astype(np.int32))
                    msg.add_tensor("slot_pos", pos.astype(np.int32))
                    msg.add_tensor("draws", slot_draws(algo, inp, pos))
                    if tr is not None:
                        xtrace.inject(msg, dspan.ctx(),
                                      wall_ns=tr.wall_ns())
                    self._send(msg)
            rows_by_site: Dict[int, Any] = {}
            losses_by_site: Dict[int, np.ndarray] = {}
            with xtrace.xspan(tr, "collect"):
                deadline = time.monotonic() + self.timeout_s
                while len(rows_by_site) < self.n_sites:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        msg = self._get_update(remaining)
                    except queue.Empty:
                        break
                    self._note_arrival(msg)
                    if msg.get("mode") != "sync" or \
                            int(msg.get("version")) != round_idx:
                        logger.warning(
                            "dropping stale fed update (site %s, version "
                            "%s != round %d)", msg.get("site"),
                            msg.get("version"), round_idx)
                        continue
                    site = int(msg.get("site"))
                    if site in rows_by_site:
                        logger.warning(
                            "duplicate update from site %d dropped", site)
                        continue
                    rows_by_site[site] = msg.get_tensor("rows")
                    losses_by_site[site] = np.asarray(
                        msg.get_tensor("losses"))
            received = sorted(rows_by_site)
            missing = [k for k in range(1, self.n_sites + 1)
                       if k not in rows_by_site]
            if not received:
                logger.warning(
                    "sync round %d TIMEOUT: no site reported; global "
                    "carried", round_idx)
                self._event(round_idx, "fed_timeout",
                            sites_missing=missing)
                rspan.add(status="timeout")
                self._record(self._xt_round_rec(
                    {"round": round_idx, "train_loss": float("nan"),
                     "sites_reported": 0, "fed_status": "timeout"},
                    t_round))
                self.state = dataclasses.replace(self.state,
                                                 generator=generator)
                self.version = round_idx + 1
                return "timeout"
            with xtrace.xspan(tr, "combine",
                              args={"robust": self.robust_agg,
                                    "members": len(received)}):
                dev = algo.device
                # reassemble the cohort in slot order: partitions are
                # contiguous blocks, so concatenating the received
                # sites' rows in rank order restores ascending slot
                # positions
                slot_pos = np.concatenate(
                    [parts[k - 1] for k in received])
                stacked = {name: torch.from_numpy(np.concatenate(
                    [rows_by_site[k][name] for k in received])).to(dev)
                    for name in self.global_params}
                losses = torch.from_numpy(np.concatenate(
                    [losses_by_site[k] for k in received])).to(dev)
                n_sel = inp.n_sel[torch.from_numpy(
                    slot_pos.astype(np.int64)).to(dev)]
                # the in-process aggregation, verbatim (base.py round
                # body): f32 sample weights normalized over whoever
                # reported — all sites is the bit-parity path, a subset
                # is the survivor-renormalization degradation
                weights = n_sel / torch.clamp(n_sel.sum(), min=1.0)
                # Byzantine norm screen: per-SITE delta norm of the
                # shipped rows against the running median (detection;
                # typed event)
                gl = {name: to_numpy(v).astype(np.float32)
                      for name, v in self.global_params.items()}
                site_norms = []
                for k in received:
                    d2 = 0.0
                    for name, g in gl.items():
                        d = np.asarray(rows_by_site[k][name],
                                       np.float32) - g[None]
                        d2 += float(np.sum(d * d))
                    site_norms.append(float(np.sqrt(d2)))
                flagged = self._byzantine_screen(
                    round_idx, received, site_norms)
                with self.lock:
                    if self.robust_agg != "none":
                        # the in-process _robust_aggregate on the f32
                        # wire: the robust statistic of the [S]-stacked
                        # rows' deltas, survivors weighted as above
                        from ..parallel import collectives
                        from ..robust.aggregation import robust_combine_mat

                        spec = collectives.flat_spec(stacked, stacked=True)
                        gvec = collectives.tree_to_vec(
                            self.global_params).to(torch.float32)
                        combined = robust_combine_mat(
                            collectives.stacked_to_mat(stacked)
                            - gvec[None], weights, self.robust_agg,
                            trim_frac=self.robust_trim,
                            krum_f=self.robust_krum_f,
                            norm_bound=self.robust_norm_bound)
                        new_global = collectives.vec_to_tree(
                            gvec + combined, spec)
                    else:
                        # FedAvg's own aggregate: the weighted-sum kernel
                        new_global = algo._aggregate(stacked, weights)
                    loss = float(losses.mean())
                self.state = dataclasses.replace(
                    self.state, global_params=new_global,
                    generator=generator)
            self.version = round_idx + 1
            status = "completed" if not missing else "quorum"
            if missing:
                logger.warning(
                    "sync round %d QUORUM %d/%d (missing sites %s; "
                    "weights renormalized)", round_idx, len(received),
                    self.n_sites, missing)
                self._event(round_idx, "fed_quorum",
                            sites_missing=missing)
            rspan.add(status=status)
            self._record(self._xt_round_rec(
                {"round": round_idx, "train_loss": loss,
                 "sites_reported": len(received),
                 "fed_status": status,
                 "fed_byzantine_flagged": len(flagged)}, t_round))
        return status

    def _xt_round_rec(self, rec: Dict[str, Any],
                      t_round: float) -> Dict[str, Any]:
        """Join the round's critical-path metrics onto its record
        (tracing on only — the keys are volatile in ``obs/diff.py``, so
        twins with tracing off still gate ``identical``)."""
        if self.tracer is None:
            return rec
        rec["fed_round_ms"] = (time.perf_counter() - t_round) * 1e3
        rec["fed_wire_ms"] = self._xt_wire_ns / 1e6
        rec["fed_queue_ms"] = self._xt_queue_ns / 1e6
        self._xt_wire_ns = self._xt_queue_ns = 0.0
        return rec

    # -- buffered async (FedBuff) ----------------------------------------
    def _np_global(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(to_numpy(v), np.float32)
                for k, v in self.global_params.items()}

    def _dispatch_train(self, site: int, version: int) -> None:
        msg = Message(protocol.MSG_FED_TRAIN, 0, site)
        msg.add("version", int(version))
        msg.add("mode", "buffered")
        msg.add_tensor("params", self.global_params)
        msg.add_tensor(
            "client_ids", self.partition[site - 1].astype(np.int32))
        # buffered trace trees are keyed by the dispatched base version
        # (the async analogue of the sync round id)
        with xtrace.xspan(self.tracer, "dispatch",
                          trace_id=f"v{int(version)}",
                          args={"site": int(site)}) as dspan:
            if self.tracer is not None:
                xtrace.inject(msg, dspan.ctx(),
                              wall_ns=self.tracer.wall_ns())
            self._send(msg)

    def _entry(self, msg: Message) -> Tuple[int, int, Any, float, float]:
        return (int(msg.get("site")), int(msg.get("version")),
                wire.decode_update(msg), float(msg.get("n_sum")),
                float(msg.get("train_loss")))

    def _flush(self, members: List[Tuple[int, int, Any, float, float]],
               flush_idx: int, depth: int, quorum: bool = False) -> None:
        """Apply one buffer of deltas: staleness-discounted weights
        ``n_i / sqrt(1 + tau_i)`` normalized over the members, summed in
        member (arrival) order — all float32 numpy, so a replayed flush
        with the same members in the same order is bit-identical."""
        t_round = self._xt_round_t0
        with xtrace.xspan(self.tracer, "flush",
                          trace_id=f"v{self.version + 1}",
                          args={"members": len(members),
                                "quorum": bool(quorum)}):
            taus = [self.version - base for _, base, _, _, _ in members]
            for t in taus:
                self.staleness_hist[t] = \
                    self.staleness_hist.get(t, 0) + 1
            raw = []
            for (_, _, _, n_sum, _), tau in zip(members, taus):
                raw.append(np.float32(n_sum) /
                           np.float32(np.sqrt(np.float32(1.0 + tau))))
            wsum = np.float32(0.0)
            for w in raw:
                wsum = np.float32(wsum + w)
            wnorm = [np.float32(w / wsum) for w in raw]
            g = self._np_global()
            leaves, treedef = tree_flatten(g)
            deltas = [tree_flatten(d)[0] for _, _, d, _, _ in members]
            # Byzantine norm screen over the flush members (typed event)
            member_sites = [site for site, _, _, _, _ in members]
            norms = [float(np.sqrt(sum(
                float(np.sum(np.square(np.asarray(dl_i, np.float32))))
                for dl_i in dl))) for dl in deltas]
            flagged = self._byzantine_screen(
                flush_idx, member_sites, norms)
            if self.robust_agg != "none":
                # robust statistic over the member deltas: the
                # staleness-discounted weights keep gating MEMBERSHIP
                # (a zero weight is a masked row) while influence is
                # the estimator's — FedBuff's n/sqrt(1+tau) discount no
                # longer scales a colluding stale attacker's pull, it
                # only ranks it
                mat = np.stack([np.concatenate(
                    [np.asarray(x, np.float32).ravel() for x in dl])
                    for dl in deltas])
                combined = self._robust_combine(
                    mat, np.asarray(wnorm, np.float32))
                new_leaves = []
                off = 0
                for leaf in leaves:
                    n = int(leaf.size)
                    new_leaves.append(
                        leaf + combined[off:off + n].reshape(leaf.shape))
                    off += n
            else:
                new_leaves = []
                for i, leaf in enumerate(leaves):
                    out = leaf.copy()
                    for w, dl in zip(wnorm, deltas):
                        out += w * np.asarray(dl[i], np.float32)
                    new_leaves.append(out)
            new = tree_unflatten(treedef, new_leaves)
            # back on the device, in the model's leaf order
            self.global_params = {
                k: torch.from_numpy(new[k]).to(self.algo.device)
                for k in self.global_params}
            self.version += 1
        losses = [loss for _, _, _, _, loss in members]
        mean_loss = float(np.mean(np.asarray(losses, np.float32)))
        member_ids = [[site, base] for site, base, _, _, _ in members]
        self.trace["flushes"].append(
            {"version": self.version, "members": member_ids})
        self._event(flush_idx, "fed_flush", members=member_ids,
                    buffer_depth=depth, quorum=quorum)
        # flush-to-flush wall time is the buffered analogue of the sync
        # round clock
        self._xt_round_t0 = time.perf_counter()
        self._record(self._xt_round_rec(
            {"round": flush_idx, "train_loss": mean_loss,
             "fed_version": self.version,
             "fed_buffer_depth": depth,
             "fed_staleness_max": int(max(taus)),
             "fed_staleness_mean": float(np.mean(taus)),
             "fed_quorum_flush": bool(quorum),
             "fed_stale_drops": self.stale_drops,
             "fed_byzantine_flagged": len(flagged)}, t_round))

    def run_buffered(self) -> None:
        for k in range(1, self.n_sites + 1):
            self._dispatch_train(k, 0)
        buffer: List[Tuple[int, int, Any, float, float]] = []
        flushes = 0
        while flushes < self.rounds:
            if self.tracer is not None and flushes > 0 and \
                    flushes % CLOCK_RESYNC_EVERY == 0 and \
                    not self._resynced_at == flushes:
                self._resynced_at = flushes
                self.clock_sync(timeout_s=min(self.timeout_s, 2.0))
            try:
                msg = self._get_update(self.timeout_s)
                self._note_arrival(msg)
            except queue.Empty:
                if buffer:
                    # degrade: flush what arrived rather than stall the
                    # federation on a dead/straggling site
                    members, buffer = buffer, []
                    self._flush(members, flushes, len(members),
                                quorum=True)
                    flushes += 1
                    for site, _, _, _, _ in members:
                        self._dispatch_train(site, self.version)
                    continue
                raise RuntimeError(
                    f"buffered federation stalled: no update within "
                    f"{self.timeout_s}s and the buffer is empty")
            site, base, delta, n_sum, loss = self._entry(msg)
            tau = self.version - base
            if tau > self.staleness_bound:
                self.stale_drops += 1
                self._event(flushes, "fed_stale_drop", site=site,
                            base_version=base, staleness=tau)
                self._dispatch_train(site, self.version)
                continue
            buffer.append((site, base, delta, n_sum, loss))
            if len(buffer) >= self.buffer_k:
                members, buffer = buffer[:self.buffer_k], \
                    buffer[self.buffer_k:]
                self._flush(members, flushes,
                            len(members) + len(buffer))
                flushes += 1
                for site, _, _, _, _ in members:
                    self._dispatch_train(site, self.version)

    # -- deterministic replay --------------------------------------------
    def _replay_dispatch(self, version: int,
                         remaining: List[List[List[int]]]) -> None:
        """Dispatch TRAIN@version to every site the trace says will
        contribute a delta with this base version — the only dispatches
        whose results the replay will consume."""
        sites = sorted({s for flush in remaining for s, b in flush
                        if b == version})
        for s in sites:
            self._dispatch_train(s, version)

    def run_buffered_replay(self) -> None:
        trace = self.replay_trace
        flushes = trace.get("flushes", [])
        if int(trace.get("sites", self.n_sites)) != self.n_sites:
            raise ValueError(
                f"trace was recorded with {trace.get('sites')} sites, "
                f"this federation has {self.n_sites}")
        # record mode dispatches TRAIN@0 to every site at start; the
        # deltas a replay consumes are the traced subset
        for k in range(1, self.n_sites + 1):
            self._dispatch_train(k, 0)
        pool: Dict[Tuple[int, int], Tuple[int, int, Any, float, float]] \
            = {}
        for flush_idx, flush in enumerate(flushes):
            need = [(int(s), int(b)) for s, b in flush["members"]]
            while not all(k in pool for k in need):
                try:
                    msg = self._get_update(self.timeout_s)
                    self._note_arrival(msg)
                except queue.Empty:
                    waiting = [k for k in need if k not in pool]
                    raise RuntimeError(
                        f"trace replay stalled waiting for deltas "
                        f"{waiting} (flush {flush_idx})") from None
                entry = self._entry(msg)
                pool.setdefault((entry[0], entry[1]), entry)
            members = [pool[k] for k in need]
            self._flush(members, flush_idx, len(members))
            rest = [f["members"] for f in flushes[flush_idx + 1:]]
            self._replay_dispatch(self.version, rest)
