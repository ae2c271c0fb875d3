"""Serving subsystem: checkpoint-streaming inference under load
(counterpart of ``neuroimagedisttraining_tpu/serve``).

A **serving worker** answers batched per-client inference requests against
personal models held in a ``core/client_store.py`` tier (disk population,
host-RAM LRU hot set, the micro-batch's rows moved to the card), while a
live **training run streams checkpoints** to it as ``fed/wire`` delta
pushes over the comm backends: the same codecs, transports and retry
machinery the federation runs on.

Star-of-two topology: rank 0 = the **publisher** (the training process;
``publisher.py`` hooks its round loop), rank 1 = the **worker**
(``worker.py``). Messages (``comm/message.py`` binary tree framing):

* ``serve_push`` (publisher -> worker): one model version. The first push
  ships the full params dense (the baseline nothing can delta from); every
  later push ships the delta against the previous *reconstructed* version
  in a ``fed/wire.py`` codec (int8 by default). Both ends apply the
  identical decode to the identical payload, so the worker's swapped model
  is bit-identical to the checkpoint the publisher writes to disk, even
  through the lossy int8 encode (lossy exactly once, at encode; the
  reconstruction chain is shared).
* ``serve_ack`` (worker -> publisher): version adopted — the publisher's
  pacing/accounting signal.
* ``serve_finish`` (publisher -> worker): drain the request queue, write
  the final record, exit.

Traffic is synthetic and head-heavy: ``traffic.py`` draws (client, sample)
requests over the cohort's training volumes under a Zipf-skewed client
popularity (the profile that exercises the store's LRU), open-loop at a
target requests/sec. ``batcher.py`` coalesces them into micro-batches; the
worker runs one forward per distinct client of a micro-batch, over that
client's rows, on a module of its own (the training thread's module is
never touched).

Per-tick records flow through an ``obs.export.ObsSession`` (JSONL stream,
metrics registry, the SLO engine on ``serve_latency_ms``-style objectives,
typed events, run catalog), and every ``--serve_*`` flag is inert: serving
never touches training lineage.
"""
from __future__ import annotations

MSG_SERVE_PUSH = "serve_push"
MSG_SERVE_ACK = "serve_ack"
MSG_SERVE_FINISH = "serve_finish"

#: PRNG domain separator for serving-plane draws ("srv" in ascii) — the
#: FED_SALT idiom, a different constant so traffic/popularity draws never
#: collide with training or fault key chains.
SERVE_SALT = 0x737276

#: wire codecs a model push may ride (``fed/wire.py``; topk is a
#: gradient-sparsity format — a *parameter* delta is dense by nature, so the
#: push path offers the dense/bf16/int8 family only)
PUSH_WIRE_IMPLS = ("dense", "bf16", "int8")

from .batcher import MicroBatcher, ServeRequest  # noqa: E402
from .publisher import (CheckpointPublisher, load_checkpoint,  # noqa: E402
                        save_checkpoint)
from .traffic import TrafficGenerator  # noqa: E402
from .worker import ServeWorker  # noqa: E402

__all__ = [
    "MSG_SERVE_PUSH", "MSG_SERVE_ACK", "MSG_SERVE_FINISH",
    "SERVE_SALT", "PUSH_WIRE_IMPLS",
    "MicroBatcher", "ServeRequest", "TrafficGenerator",
    "CheckpointPublisher", "save_checkpoint", "load_checkpoint",
    "ServeWorker",
]
