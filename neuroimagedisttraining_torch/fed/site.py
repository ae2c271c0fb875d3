"""SiteWorker: one federation site process (or loopback thread)
(counterpart of ``neuroimagedisttraining_tpu/fed/site.py``).

Reacts to the aggregator's ``fed_train`` dispatches — sync rounds train
the slice of the cohort named in the message, buffered rounds train all
of the site's own clients from the shipped base model — and replies
with ``fed_update`` via ``send_with_retry``. Per-site fault specs
(``--fed_site_faults``) turn the chaos harness end-to-end: a
``straggle`` draw here sleeps a REAL process before replying and a
``drop`` draw withholds the reply entirely, exercising the
aggregator's staleness/quorum machinery over an actual wire instead of
a simulated slot. Draws reuse ``robust.faults.fault_trace_round`` keyed
by ``(seed, version, site_rank)`` — deterministic, analyzable offline.

Each site writes its own JSONL round + event streams; the runtime
folds them with the aggregator's via ``obs.export.merge_host_jsonl`` /
``merge_host_events`` (the multihost fold, reused verbatim).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from ..comm.manager import ClientManager
from ..comm.message import Message, tree_map
from ..obs import live as obs_live, xtrace
from ..obs.export import RoundLogWriter
from ..obs.xtrace import XTracer
from ..robust.faults import FaultSpec, fault_trace_round
from . import protocol, wire
from .trainer import SiteTrainer

logger = logging.getLogger(__name__)


def peak_memory(device) -> dict:
    """``{"peak_mem_bytes": ...}``: the process's peak device memory on a
    card (``torch.cuda.max_memory_allocated``), empty on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    return {"peak_mem_bytes": int(torch.cuda.max_memory_allocated(dev))}


class SiteWorker(ClientManager):
    """Rank >= 1 site manager.

    ``fault_spec``/``straggle_s``: this site's process-level fault
    model (None = healthy). ``wire_impl``/``wire_density``: the delta
    codec for buffered replies (``fed/wire.py``; sync replies are
    always dense rows — the bit-parity contract).
    """

    def __init__(self, comm, rank: int, world_size: int,
                 trainer: SiteTrainer, seed: int,
                 wire_impl: str = "dense", wire_density: float = 0.1,
                 fault_spec: Optional[FaultSpec] = None,
                 straggle_s: float = 0.0, kill_after_s: float = 0.0,
                 retries: int = 2,
                 backoff_s: float = 0.05, log_path: str = "",
                 events_path: str = "",
                 tracer: Optional[XTracer] = None,
                 heartbeat: Optional[obs_live.HeartbeatConfig] = None):
        super().__init__(comm, rank=rank, world_size=world_size)
        self.trainer = trainer
        self.seed = int(seed)
        self.wire_impl = wire_impl
        self.wire_density = wire_density
        self.fault_spec = fault_spec
        self.straggle_s = float(straggle_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.tracer = tracer
        self.writer = RoundLogWriter(log_path, force=True) \
            if log_path else None
        self.events = RoundLogWriter(events_path, force=True) \
            if events_path else None
        self.done = threading.Event()
        self.rounds_trained = 0
        self.heartbeat = heartbeat
        # set by finish(): a handler asleep in an injected straggle gives
        # up its round instead of training after the federation ended
        self._halt = threading.Event()
        # our own threads (receive pump + heartbeat emitter) must not
        # interleave sends on the shared transport
        self._send_lock = threading.Lock()
        self.register_message_receive_handler(
            protocol.MSG_FED_TRAIN, self._on_train)
        self.register_message_receive_handler(
            protocol.MSG_FED_FINISH, self._on_finish)
        # clock-sync echo: registered unconditionally (inert unless the
        # aggregator actually initiates a HELLO, which is xtrace-gated)
        self.register_message_receive_handler(
            protocol.MSG_FED_HELLO, self._on_hello)
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"hb:site{rank}", daemon=True)
            self._hb_thread.start()
        # the process-death fault ("rank:kill[:after_s]"): unlike a
        # `drop` draw (alive but withholding one reply) the site goes
        # COMPLETELY silent — no replies, no heartbeats, pump stopped —
        # which is exactly the signal the fleet ledger's SUSPECT/DOWN
        # machine (and nothing else in the repo) can see mid-round
        self.kill_after_s = float(kill_after_s)
        self._killed = False
        if self.kill_after_s > 0:
            threading.Thread(target=self._kill_loop,
                             name=f"kill:site{rank}",
                             daemon=True).start()

    def _kill_loop(self) -> None:
        if self.done.wait(self.kill_after_s):
            return  # run finished before the kill fired
        logger.warning("site %d: injected kill fires after %.2fs — "
                       "going silent", self.rank, self.kill_after_s)
        self._event(self.rounds_trained, "fed_site_kill",
                    after_s=self.kill_after_s)
        self._killed = True
        # done stops the heartbeat emitter AND lets the runtime's
        # bounded join proceed; the pump stop silences the handlers
        self.done.set()
        self.comm.stop_receive_message()

    def _on_hello(self, msg: Message) -> None:
        if self._killed:
            return
        t1 = self.tracer.wall_ns() if self.tracer is not None \
            else time.time_ns()
        reply = protocol.hello_ack(msg, self.rank, self.rank, t1)
        with self._send_lock:
            protocol.send_with_retry(self, reply, retries=self.retries,
                                     backoff_s=self.backoff_s)

    # -- live telemetry ---------------------------------------------------
    def _heartbeat_loop(self) -> None:
        """Periodic standalone HEARTBEAT frames toward the aggregator:
        mid-round progress while ``_on_train`` is still inside its
        train step. Best-effort by design — a LOST heartbeat is exactly
        the signal the fleet ledger detects, so send failures are
        swallowed, never retried."""
        hb = self.heartbeat
        while not self.done.wait(hb.every_s):
            from ..obs.memory import host_rss

            hb.note("mem_rss_mb",
                    host_rss()["rss_bytes"] / 1e6)
            hb.note("comm_messages_sent",
                    self.comm.counters.messages_sent)
            hb.note("comm_bytes_sent", self.comm.counters.bytes_sent)
            try:
                with self._send_lock:
                    self.send_message(protocol.heartbeat_message(
                        self.rank, 0, hb))
            except OSError:
                pass  # aggregator draining/gone: the ledger's problem

    # -- fault model ------------------------------------------------------
    def _draw_faults(self, version: int):
        """(straggled, dropped, byzantine, signflipped) for this round —
        drawn from the shared ``fault_trace_round`` twin keyed by
        ``(seed, version, rank)``, so the aggregator's analyzer can
        reconstruct (and a replay re-forge) every fault offline."""
        if self.fault_spec is None or not self.fault_spec.any_active:
            return False, False, False, False
        tr = fault_trace_round(self.fault_spec, self.seed, version,
                               np.asarray([self.rank]))
        return (bool(tr["straggled"][0]), bool(tr["dropped"][0]),
                bool(tr["byzantine"][0]), bool(tr["signflipped"][0]))

    def _forge_factor(self, byzantine: bool, signflip: bool) -> float:
        """The Byzantine delta multiplier this round: ``scale_factor``
        when the scale draw fired (``rank:byzantine`` sugar = scale=1.0,
        an always-on attacker), negated by a signflip draw."""
        factor = 1.0
        if byzantine:
            factor *= float(self.fault_spec.scale_factor)
        if signflip:
            factor = -factor
        return factor

    def _event(self, version: int, event_type: str, **extra) -> None:
        if self.events is not None:
            self.events.write({"round": int(version),
                               "event_type": event_type,
                               "site": self.rank, **extra})

    # -- protocol ---------------------------------------------------------
    def _on_train(self, msg: Message) -> None:
        if self._killed:
            return
        version = int(msg.get("version"))
        mode = msg.get("mode")
        t0 = time.perf_counter()
        # causal link: the aggregator's dispatch span is this round's
        # parent; absent headers (old peers, tracing off) read as None
        ctx = xtrace.extract(msg) if self.tracer is not None else None
        with xtrace.xspan(self.tracer, "site_round",
                          trace_id=ctx.trace_id if ctx else None,
                          parent=ctx.span_id if ctx else None,
                          args={"site": self.rank,
                                "version": version}) as sr:
            straggled, dropped, byzantine, signflip = \
                self._draw_faults(version)
            forged = byzantine or signflip
            if straggled and self.straggle_s > 0:
                # a REAL straggling process: the aggregator's round
                # clock (sync timeout / buffered staleness bound) sees
                # this delay
                self._event(version, "fed_site_straggle",
                            sleep_s=self.straggle_s)
                with xtrace.xspan(self.tracer, "straggle",
                                  args={"sleep_s": self.straggle_s}):
                    if self._halt.wait(self.straggle_s):
                        sr.add(abandoned=True)
                        return
            if dropped:
                # withhold the reply entirely — site death for this
                # round; the aggregator degrades to quorum / flushes
                # without us
                self._event(version, "fed_site_drop")
                sr.add(dropped=True)
                return
            params = msg.get_tensor("params")
            client_ids = np.array(msg.get_tensor("client_ids"))
            reply = Message(protocol.MSG_FED_UPDATE, self.rank, 0)
            reply.add("version", version)
            reply.add("site", self.rank)
            reply.add("mode", mode)
            if mode == "sync":
                # writable copies: the decoded leaves view the frame
                draws = tree_map(np.array, msg.get_tensor("draws"))
                with xtrace.xspan(self.tracer, "train"):
                    rows, losses = self.trainer.train_sync(
                        params, version, client_ids, draws)
                if forged:
                    # a LYING site: every row it ships is the forged
                    # delta g + factor*(row - g) — a real adversarial
                    # process on the wire, not a simulated slot. Pure
                    # in (seed, version, rank) + the deterministic
                    # trained rows, so the attack replays bit-for-bit.
                    factor = self._forge_factor(byzantine, signflip)
                    rows = {k: np.asarray(params[k], np.float32)[None]
                            + np.float32(factor)
                            * (np.asarray(r, np.float32)
                               - np.asarray(params[k], np.float32)[None])
                            for k, r in rows.items()}
                    self._event(version, "fed_site_byzantine",
                                factor=factor)
                with xtrace.xspan(self.tracer, "encode"):
                    reply.add_tensor("rows", rows)
                    reply.add_tensor("losses", losses)
                loss = float(np.mean(losses)) if losses.size \
                    else float("nan")
                n_train = self.trainer.algo._n_train
                n_sum = float(sum(n_train[int(c)] for c in client_ids))
            else:  # buffered
                with xtrace.xspan(self.tracer, "train"):
                    delta, n_sum, loss = self.trainer.train_delta(
                        params, self.seed, self.rank, version, client_ids)
                if forged:
                    factor = self._forge_factor(byzantine, signflip)
                    delta = {k: np.float32(factor) * np.asarray(d, np.float32)
                             for k, d in delta.items()}
                    self._event(version, "fed_site_byzantine",
                                factor=factor)
                with xtrace.xspan(self.tracer, "encode"):
                    wire.encode_update(reply, delta, self.wire_impl,
                                       density=self.wire_density)
                reply.add("n_sum", n_sum)
                reply.add("train_loss", loss)
            if ctx is not None:
                # the reply carries OUR span as the aggregator-side
                # parent plus our send wall clock (its wire-time input)
                xtrace.inject(reply, sr.ctx(),
                              wall_ns=self.tracer.wall_ns())
            if self.heartbeat is not None:
                # piggybacked gauge snapshot: every UPDATE is also a
                # heartbeat (heartbeats off adds not one byte here)
                self.heartbeat.note_round(version)
                self.heartbeat.note("train_loss", loss)
                self.heartbeat.note("local_epoch",
                                    self.rounds_trained + 1)
                obs_live.inject_heartbeat(reply, self.heartbeat)
            if self._killed:
                # the kill fired while we were training: a dead
                # process does not get to finish its send
                return
            with self._send_lock:
                protocol.send_with_retry(self, reply,
                                         retries=self.retries,
                                         backoff_s=self.backoff_s)
        self.rounds_trained += 1
        if self.writer is not None:
            self.writer.write({
                "round": version, "site": self.rank, "mode": mode,
                "train_loss": loss, "n_sum": n_sum,
                "clients": int(client_ids.size),
                "wall_s": time.perf_counter() - t0,
                "fed_straggled": straggled,
                "fed_byzantine": forged,
            })

    def finish(self) -> None:
        self._halt.set()
        super().finish()

    def _on_finish(self, msg: Message) -> None:
        ctx = xtrace.extract(msg) if self.tracer is not None else None
        if ctx is not None:
            with xtrace.xspan(self.tracer, "site_finish",
                              trace_id=ctx.trace_id,
                              parent=ctx.span_id,
                              args={"site": self.rank}):
                pass
        if self.writer is not None:
            self.writer.write({"round": -1, "site": self.rank,
                               "rounds_trained": self.rounds_trained,
                               **peak_memory(self.trainer.algo.device),
                               **self.comm.counters.snapshot()})
            self.writer.close()
        if self.events is not None:
            self.events.close()
        self.done.set()
        self.comm.stop_receive_message()
