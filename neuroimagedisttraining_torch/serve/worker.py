"""ServeWorker: the rank-1 inference process (counterpart of
``neuroimagedisttraining_tpu/serve/worker.py``).

Three planes, one class:

* **Model plane** — ``serve_push`` handler: decode the ``fed/wire``
  payload, reconstruct (full push = the new base; delta push =
  ``base + decode(delta)``, the publisher's reconstruction twin), copy the
  finished host tree to a NEW device dict (a blocking host-to-device copy)
  and swap both by reference under a lock: requests batched before the
  swap ran on the old version, requests after it on the new one, nothing
  ever sees a half-updated model. A served tensor is never written in
  place (a forward queued on the stream may still read it).
* **Data plane** — the serve loop: pull a micro-batch, gather the clients'
  personal-delta rows from the ``core/client_store.py`` tier (disk
  population, host LRU hot set — the hit/miss counters become the
  per-tick ``serve_hit_rate`` gauge), run the forward and wait for its
  logits on the host, stamp latencies. Each request row runs the FedAvg
  model on its own parameters, the served global plus its client's
  personal delta, summed in float32 on the device and cast to the compute
  type inside ``apply_fn`` (the reference's ``vmap(apply(g + delta_c,
  x_c))``). Rows of one client share their parameters, so the worker runs
  one forward per distinct client of the micro-batch over that client's
  rows (Zipf traffic makes these few). The reference pads the slab to
  ``max_batch`` rows so that XLA compiles one shape and drops the padded
  rows' outputs; nothing is compiled here, so the padded rows are not run
  (``serve_batch_fill`` still reads as the reference's).
* **Obs plane** — every tick writes one record through an
  ``obs.export.ObsSession`` (``record_round`` with the tick index as the
  round key): latency/throughput/hit-rate/staleness/version land on the
  JSONL line, the SLO engine evaluates objectives like
  ``p99:serve_latency_ms<50@w=200`` live, breaches become typed events,
  and the catalog entry at close carries the serving gauges.

The forward runs on a module of the worker's own (``serve/runtime.py``
builds it from the algorithm's configuration): ``torch.func.
functional_call`` swaps a module's parameters in place while it runs, so a
module shared with the training thread would run one thread's forward on
the other's weights. The worker never takes the training side's lock, and
its forwards run under ``torch.inference_mode()``, entered in the thread
that runs them (grad mode is per thread).

The drain contract: on ``serve_finish`` the loop finishes the queue and the
runtime writes a final ``{"round": -1, "serve_drained": true, ...}`` totals
record, the serving stream's graceful-completion trace.
"""
from __future__ import annotations

import hashlib
import json
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm.manager import ClientManager
from ..comm.message import Message, tree_flatten, tree_map
from ..fed import protocol, wire
from ..fed.protocol import send_with_retry
from ..obs import live as obs_live, xtrace
from ..obs.xtrace import XTracer
from . import MSG_SERVE_ACK, MSG_SERVE_FINISH, MSG_SERVE_PUSH
from .batcher import MicroBatcher
from .publisher import _np_f32_tree

logger = logging.getLogger(__name__)

#: store field holding each client's personal delta against the global
#: model (served params = global + delta_c; unwritten rows synthesize
#: byte-exact zeros — an unpersonalized client serves the global model)
PERSONAL_FIELD = "personal_delta"


def tree_digest(tree: Any) -> str:
    """SHA-256 over a tree's structure and each leaf's dtype, shape and
    bytes (reference leaf order): equal digests, bitwise-equal trees."""
    leaves, structure = tree_flatten(tree)
    h = hashlib.sha256(json.dumps(structure).encode())
    for a in leaves:
        a = np.ascontiguousarray(a)
        h.update(f"|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _to_device(tree: Any, device: torch.device) -> Any:
    """A host float32 tree as a new tree of device tensors (a copy: the
    host leaves may view a frame's read-only bytes)."""
    return tree_map(lambda x: torch.from_numpy(
        np.array(x, np.float32)).to(device), tree)


class ServeWorker(ClientManager):
    """``apply_fn`` is ``models.make_apply_fn`` over a module of the
    worker's own, so serving runs the exact training forward;
    ``init_params`` seeds version 0 (served until the first push lands);
    ``data_x``/``data_n`` are the cohort's training volumes the requests
    index (``data_x`` stays where it lives: the requests' rows are
    indexed on its device, where the forward runs)."""

    def __init__(self, comm, rank: int, world_size: int, apply_fn,
                 init_params: Any, store, data_x, data_n,
                 batcher: MicroBatcher, session=None,
                 retries: int = 2, backoff_s: float = 0.05,
                 tracer: Optional[XTracer] = None,
                 probe_every: int = 0,
                 probe_data: Optional[Tuple[Any, Any]] = None,
                 heartbeat: Optional[
                     obs_live.HeartbeatConfig] = None):
        super().__init__(comm, rank=rank, world_size=world_size)
        self.apply_fn = apply_fn
        self.store = store
        self.data_x = torch.as_tensor(data_x)
        self.device = self.data_x.device
        self.data_n = np.asarray(torch.as_tensor(data_n).cpu())
        self.batcher = batcher
        self.session = session
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.tracer = tracer
        # accuracy-under-staleness probe: every ``probe_every`` ticks
        # run the CURRENT served model over a fixed labeled probe set
        # and stamp ``serve_probe_acc`` beside the tick's
        # ``serve_model_staleness_s`` (the analyzer joins the pairs)
        self.probe_every = int(probe_every)
        self._probe_x = self._probe_y = None
        if probe_data is not None:
            self._probe_x = torch.as_tensor(probe_data[0])
            self._probe_y = np.asarray(torch.as_tensor(probe_data[1]).cpu())
        self._last_adopt_lag_ms: Optional[float] = None
        self._hello_acks: "queue.Queue[Dict[str, float]]" = queue.Queue()
        # model plane
        self._swap_lock = threading.Lock()
        self._g_host = _np_f32_tree(init_params)
        self._g_dev = _to_device(self._g_host, self.device)
        self.version = 0
        self._last_swap_t = time.perf_counter()
        self.pushes_adopted = 0
        #: version -> :func:`tree_digest` of the adopted model
        self.adopt_digests: Dict[int, str] = {}
        # data plane
        self.done = threading.Event()       # serve_finish received
        self.traffic_done = threading.Event()  # all requests submitted
        self.drained = threading.Event()    # serve loop exited
        self.requests_served = 0
        self.batches_served = 0
        #: what ended the serve loop early, if anything did
        self.error: Optional[BaseException] = None
        #: forwards this worker ran (warm-up, serving, probe): each
        #: launches the model's kernels once
        self.forwards = 0
        self._hits0 = self._miss0 = 0.0
        self._t_prev_tick: Optional[float] = None
        self.register_message_receive_handler(MSG_SERVE_PUSH,
                                              self._on_push)
        self.register_message_receive_handler(MSG_SERVE_FINISH,
                                              self._on_finish)
        self.register_message_receive_handler(
            protocol.MSG_FED_HELLO_ACK, self._on_hello_ack)
        # live telemetry: ACKs carry a piggybacked gauge snapshot and a
        # daemon thread emits standalone HEARTBEAT frames toward the
        # publisher's fleet ledger (--obs_heartbeat_every only — every
        # wire stays byte-inert otherwise, the HELLO/xtrace contract)
        self.heartbeat = heartbeat
        # our own threads (receive pump + heartbeat emitter + the
        # caller's clock_sync) must not interleave sends on the shared
        # transport
        self._send_lock = threading.Lock()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"hb:worker{rank}", daemon=True)
            self._hb_thread.start()

    # -- live telemetry ---------------------------------------------------
    def _heartbeat_loop(self) -> None:
        """Best-effort by design — a LOST heartbeat is exactly the
        signal the fleet ledger detects, so send failures are
        swallowed, never retried."""
        hb = self.heartbeat
        while not self.done.wait(hb.every_s):
            from ..obs.memory import host_rss

            hb.note("mem_rss_mb", host_rss()["rss_bytes"] / 1e6)
            hb.note("serve_queue_depth", self.batcher.depth())
            hb.note("serve_requests_total", self.requests_served)
            hb.note("comm_messages_sent",
                    self.comm.counters.messages_sent)
            hb.note("comm_bytes_sent", self.comm.counters.bytes_sent)
            try:
                with self._send_lock:
                    self.send_message(protocol.heartbeat_message(
                        self.rank, 0, hb))
            except OSError:
                pass  # publisher draining/gone: the ledger's problem

    def prom_snapshot(self) -> Dict[str, Any]:
        """The worker's ``/metrics`` source: the session registry
        (latency/throughput/hit-rate distributions and gauges) joined
        with the transport counters — rendered by ``obs/prom.py`` at
        scrape time."""
        snap: Dict[str, Any] = {}
        if self.session is not None:
            snap.update(self.session.registry.snapshot())
        for k, v in self.comm.counters.snapshot().items():
            snap[k] = {"type": "counter", "value": float(v)}
        return snap

    # -- clock sync (xtrace-gated) ----------------------------------------
    def _on_hello_ack(self, msg: Message) -> None:
        t2 = self.tracer.wall_ns() if self.tracer is not None \
            else time.time_ns()
        self._hello_acks.put({"t0": float(msg.get("t0_ns", 0)),
                              "t1": float(msg.get("t1_ns", 0)),
                              "t2": float(t2)})

    def clock_sync(self, timeout_s: float = 10.0) -> bool:
        """Worker-initiated HELLO toward the publisher (the serving
        plane's reference clock): the NTP-midpoint estimate lands on
        ``tracer.offset_ns`` as THIS clock minus the publisher's —
        adopt-lag and the merged-trace lane alignment both key off it.
        No-op (False) when tracing is off."""
        if self.tracer is None:
            return False
        with self._send_lock:
            send_with_retry(
                self, protocol.hello_message(self.rank, 0,
                                             self.tracer.wall_ns()),
                retries=self.retries, backoff_s=self.backoff_s)
        try:
            ack = self._hello_acks.get(timeout=float(timeout_s))
        except queue.Empty:
            logger.warning("serve hello: no ACK from publisher within "
                           "%.1fs; lanes merge unaligned", timeout_s)
            return False
        # ntp_offset returns publisher-minus-worker; offset_ns is
        # worker-minus-reference, hence the sign flip
        est, rtt = xtrace.ntp_offset(ack["t0"], ack["t1"], ack["t2"])
        self.tracer.offset_ns = -est
        self.tracer.hello["publisher"] = {"offset_ns": -est,
                                          "rtt_ns": rtt}
        return True

    # -- model plane ------------------------------------------------------
    @property
    def global_params(self) -> Any:
        """The served model's host tree (the bit-identity gate compares
        this against the publisher's on-disk checkpoint)."""
        with self._swap_lock:
            return self._g_host

    def _on_push(self, msg: Message) -> None:
        version = int(msg.get("version"))
        kind = msg.get("kind")
        ctx = xtrace.extract(msg) if self.tracer is not None else None
        with xtrace.xspan(self.tracer, "adopt",
                          trace_id=ctx.trace_id if ctx else None,
                          parent=ctx.span_id if ctx else None,
                          args={"version": version,
                                "kind": str(kind)}) as aspan:
            if ctx is not None:
                send_ns = xtrace.send_wall_ns(msg)
                if send_ns is not None:
                    # publish-to-adopt lag on the PUBLISHER clock:
                    # our wall mapped through the HELLO offset minus
                    # the push's send stamp
                    lag_ms = (self.tracer.to_ref_ns(
                        self.tracer.wall_ns()) - send_ns) / 1e6
                    self._last_adopt_lag_ms = lag_ms
                    aspan.add(lag_ms=lag_ms)
                    if self.session is not None:
                        self.session.registry.distribution(
                            "serve_adopt_lag_ms").observe(float(lag_ms))
            payload = wire.decode_update(msg, key="delta")
            if kind == "full":
                new_host = tree_map(
                    lambda x: np.asarray(x, np.float32), payload)
            else:
                with self._swap_lock:
                    base = self._g_host
                new_host = tree_map(
                    lambda b, d: (np.asarray(b, np.float32)
                                  + np.asarray(d, np.float32)),
                    base, payload)
            new_dev = _to_device(new_host, self.device)
            with self._swap_lock:
                self._g_host = new_host
                self._g_dev = new_dev
                self.version = version
                self._last_swap_t = time.perf_counter()
            self.pushes_adopted += 1
            if self.session is not None:
                self.session.registry.gauge("serve_model_version").set(
                    float(version))
                self.session.registry.counter(
                    "serve_pushes_adopted_total").inc()
            ack = Message(MSG_SERVE_ACK, self.rank, msg.sender_id)
            ack.add("version", version)
            if ctx is not None:
                xtrace.inject(ack, aspan.ctx(),
                              wall_ns=self.tracer.wall_ns())
            if self.heartbeat is not None:
                # piggybacked gauge snapshot: every ACK is also a
                # heartbeat (heartbeats off adds not one byte here)
                self.heartbeat.note_round(version)
                self.heartbeat.note("serve_model_version",
                                    float(version))
                self.heartbeat.note("serve_requests_total",
                                    self.requests_served)
                obs_live.inject_heartbeat(ack, self.heartbeat)
            with self._send_lock:
                send_with_retry(self, ack, retries=self.retries,
                                backoff_s=self.backoff_s)
        # after the ack: the digest is bookkeeping, not adopt latency
        self.adopt_digests[version] = tree_digest(new_host)
        logger.info("serve worker adopted v%d (%s push)", version, kind)

    def _on_finish(self, msg: Message) -> None:
        self.done.set()
        # wake the serve loop if it is parked in next_batch
        self.batcher.wake()

    def mark_traffic_done(self) -> None:
        """The traffic pump's last act. The serve loop may not exit on
        a momentarily-empty queue while submissions are still coming
        (``serve_finish`` from a remote publisher races the local
        pump); this event closes that hole."""
        self.traffic_done.set()
        self.batcher.wake()

    # -- data plane -------------------------------------------------------
    def _gather(self, ids: Sequence[int]) -> Dict[int, Dict[str, Any]]:
        """Each distinct client's personal delta row, on the device, keyed
        by client id. The store's hit/miss counters read as the reference's
        gather of every row: a repeated client counts as its first read
        did (a read never moves a row into the hot set, and serving writes
        no rows, so the second read meets the tier the first one did)."""
        counts: Dict[int, int] = {}
        for c in ids:
            counts[int(c)] = counts.get(int(c), 0) + 1
        rows: Dict[int, Dict[str, Any]] = {}
        for c, n in counts.items():
            h0, m0 = self.store.hits, self.store.misses
            rows[c] = self.store.gather(PERSONAL_FIELD, [c],
                                        device=self.device)
            self.store.hits += (n - 1) * (self.store.hits - h0)
            self.store.misses += (n - 1) * (self.store.misses - m0)
        return rows

    def _forward(self, params: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
        out = self.apply_fn(params, x, False, None)
        self.forwards += 1
        return out

    def serve_logits(self, ids: Sequence[int], samples: Sequence[int],
                     global_dev: Optional[Dict[str, Any]] = None
                     ) -> torch.Tensor:
        """The served logits of the requests ``(ids[i], samples[i])``, one
        row each, on the host: request ``i`` runs the model on
        ``g + delta[ids[i]]`` (``g`` the served global, or ``global_dev``)
        over ``data_x[ids[i], samples[i]]``. One forward per distinct
        client, over that client's rows; returns once the logits are on the
        host (the device work is done)."""
        with torch.inference_mode():
            if global_dev is None:
                with self._swap_lock:
                    global_dev = self._g_dev
            rows = self._gather(ids)
            pos: Dict[int, List[int]] = {}
            for i, c in enumerate(ids):
                pos.setdefault(int(c), []).append(i)
            outs, order = [], []
            for c, at in pos.items():
                delta = rows[c]
                params = {k: global_dev[k] + delta[k][0]
                          for k in global_dev}
                sel = torch.as_tensor([int(samples[i]) for i in at],
                                      device=self.device)
                outs.append(self._forward(params, self.data_x[c][sel]))
                order.extend(at)
            out = torch.cat(outs)
            logits = torch.empty_like(out)
            logits[torch.as_tensor(order, device=out.device)] = out
            return logits.cpu()

    def warmup(self) -> None:
        """One forward of a full micro-batch off the latency clock (the
        first one loads the kernels and picks cuDNN's algorithms)."""
        ids = [0] * self.batcher.max_batch
        self.serve_logits(ids, [0] * len(ids))

    def _probe_acc(self) -> float:
        """Accuracy of the CURRENT served global model over the fixed
        probe set — the staleness-vs-accuracy joint the analyzer pins
        (a stale model is only a problem if this number says so). As the
        reference scores it: ``argmax`` over the last axis, which for a
        one-logit BCE model is always 0, so this is the share of label 0."""
        with self._swap_lock:
            g = self._g_dev
        with torch.inference_mode():
            logits = self._forward(g, self._probe_x).cpu().numpy()
        return float(np.mean(
            np.argmax(logits, axis=-1) == self._probe_y))

    def _tick_record(self, tick: int, batch, lat_ms: np.ndarray,
                     wall_s: float) -> Dict[str, Any]:
        hits = float(self.store.hits)
        misses = float(self.store.misses)
        dh, dm = hits - self._hits0, misses - self._miss0
        self._hits0, self._miss0 = hits, misses
        now = time.perf_counter()
        rps = (len(batch) / (now - self._t_prev_tick)
               if self._t_prev_tick is not None and
               now > self._t_prev_tick else 0.0)
        self._t_prev_tick = now
        with self._swap_lock:
            version = self.version
            staleness = now - self._last_swap_t
        rec = {
            "round": int(tick),
            "serve_requests": float(len(batch)),
            "serve_batch_fill": len(batch) / self.batcher.max_batch,
            "serve_latency_ms": float(np.max(lat_ms)),
            "serve_latency_mean_ms": float(np.mean(lat_ms)),
            "serve_wall_ms": wall_s * 1e3,
            "serve_rps": float(rps),
            "serve_queue_depth": float(self.batcher.depth()),
            "serve_hit_rate": (dh / (dh + dm)) if dh + dm else 1.0,
            "serve_model_version": float(version),
            "serve_model_staleness_s": float(staleness),
        }
        if self._last_adopt_lag_ms is not None:
            rec["serve_adopt_lag_ms"] = float(self._last_adopt_lag_ms)
        if self.probe_every > 0 and self._probe_x is not None \
                and tick % self.probe_every == 0:
            acc = self._probe_acc()
            rec["serve_probe_acc"] = acc
            if self.session is not None:
                self.session.registry.gauge(
                    "serve_probe_acc").set(acc)
        return rec

    def _serve_one(self, batch, tick: int) -> None:
        t0 = time.perf_counter()
        self.serve_logits([r.client_id for r in batch],
                          [r.sample_idx for r in batch])
        t1 = time.perf_counter()
        lat_ms = np.asarray([(t1 - r.t_submit) * 1e3 for r in batch])
        self.requests_served += len(batch)
        self.batches_served += 1
        if self.session is not None:
            reg = self.session.registry
            reg.counter("serve_requests_total").inc(float(len(batch)))
            reg.counter("serve_batches_total").inc()
            reg.distribution("serve_latency_ms").observe(
                float(np.max(lat_ms)))
            self.session.record_round(
                self._tick_record(tick, batch, lat_ms, t1 - t0))

    def serve_loop(self) -> None:
        """Drain-aware consumer loop (run in its own thread): serve
        until ``serve_finish`` has landed, the traffic pump is done
        submitting, AND the queue is empty."""
        tick = 0
        try:
            while True:
                batch = self.batcher.next_batch(timeout_s=0.05)
                if batch:
                    self._serve_one(batch, tick)
                    tick += 1
                elif (self.done.is_set() and self.traffic_done.is_set()
                        and self.batcher.depth() == 0):
                    break
        except BaseException as e:
            # the drain reports it: a dead loop must not read as drained
            self.error = e
            raise
        finally:
            self.drained.set()

    def drain_record(self) -> Dict[str, Any]:
        """The graceful-drain totals record (``round=-1`` +
        ``serve_drained`` — the serving stream's completion trace)."""
        hits = float(self.store.hits)
        misses = float(self.store.misses)
        return {
            "round": -1,
            "serve_drained": True,
            "serve_requests_total": float(self.requests_served),
            "serve_batches_total": float(self.batches_served),
            "serve_hit_rate_total": (hits / (hits + misses)
                                     if hits + misses else 1.0),
            "serve_pushes_adopted": float(self.pushes_adopted),
            "serve_model_version": float(self.version),
            **self.comm.counters.snapshot(),
        }
