"""Federation wire protocol: message types, retry/backoff on send, and
the deterministic key/partition derivations both ends must agree on
(counterpart of ``neuroimagedisttraining_tpu/fed/protocol.py``).

Star topology, aggregator = rank 0, sites = ranks 1..N (the cross-silo
scheme of ``comm/cross_silo.py``, extended with versioned dispatch so
the buffered-async policy can tag every delta with the global-model
version it was computed against).

Messages (all via ``comm/message.py``'s binary pytree framing):

* ``fed_train`` (aggregator -> site): global params + ``version`` +
  ``mode``; sync rounds add the site's client ids, their slot positions,
  the cohort size and the slots' draws of the round (epoch permutations,
  dropout keep masks: the rows of the in-process round's draws at those
  slots) so the site reproduces exactly its slice of the in-process
  round.
* ``fed_update`` (site -> aggregator): sync — the trained local models
  (dense rows, the bit-parity path); buffered — the site's weighted
  local delta in a ``fed/wire.py`` format, tagged with the base
  ``version`` it trained from.
* ``fed_finish`` (aggregator -> site): drain and exit.
* ``fed_hello`` / ``fed_hello_ack``: the clock-sync handshake behind
  cross-process tracing (``obs/xtrace.py``). The initiator stamps its
  wall clock ``t0``; the peer echoes it with its own ``t1``; the
  initiator reads ``t2`` at the ACK and estimates the peer's clock
  offset by the NTP midpoint. Only ever sent when ``--xtrace`` is on
  (the byte-inert contract); both planes reuse the same pair — the
  aggregator initiates toward its sites, the serve worker toward its
  publisher. The aggregator re-initiates every
  ``fed/aggregator.CLOCK_RESYNC_EVERY`` rounds so long runs track
  clock drift instead of freezing the first offset estimate.
* ``fed_heartbeat`` (site -> aggregator; serve worker -> publisher):
  periodic standalone liveness frame carrying only the ``hb_*``
  headers (``obs/live.py``) — mid-round progress for the fleet
  ledger. Only ever sent when ``--obs_heartbeat_every`` is on (the
  byte-inert contract, same as the HELLO pair).
"""
from __future__ import annotations

import logging
import time
from typing import Any, List

import numpy as np
import torch

from ..comm.message import Message

logger = logging.getLogger(__name__)

MSG_FED_TRAIN = "fed_train"
MSG_FED_UPDATE = "fed_update"
MSG_FED_FINISH = "fed_finish"
MSG_FED_HELLO = "fed_hello"
MSG_FED_HELLO_ACK = "fed_hello_ack"
MSG_FED_HEARTBEAT = "fed_heartbeat"


def heartbeat_message(sender: int, receiver: int, hb: Any) -> Message:
    """A standalone HEARTBEAT frame: pure control plane (no tensors),
    carrying only the ``hb_*`` headers of ``obs/live.py``. Only ever
    sent when ``--obs_heartbeat_every`` is on (the byte-inert
    contract, same as the HELLO pair)."""
    from ..obs import live as obs_live

    msg = Message(MSG_FED_HEARTBEAT, sender, receiver)
    obs_live.inject_heartbeat(msg, hb)
    return msg


def hello_message(sender: int, receiver: int, t0_ns: int) -> Message:
    """The handshake's first leg: the initiator's wall clock."""
    msg = Message(MSG_FED_HELLO, sender, receiver)
    msg.add("t0_ns", int(t0_ns))
    return msg


def hello_ack(msg: Message, sender: int, rank: int,
              t1_ns: int) -> Message:
    """The echo leg: ``t0`` returned untouched, the peer's ``t1`` and
    rank added (``rank`` keys the initiator's offset table)."""
    reply = Message(MSG_FED_HELLO_ACK, sender, msg.sender_id)
    reply.add("t0_ns", int(msg.get("t0_ns", 0)))
    reply.add("rank", int(rank))
    reply.add("t1_ns", int(t1_ns))
    return reply

#: PRNG domain separator for the buffered policy's per-site key chain
#: ("fed" in ascii) — the same fold-in idiom as robust.faults.FAULT_SALT,
#: a different constant so fault draws and training keys never collide.
FED_SALT = 0x666564


def site_round_seed(seed: int, version: int, site_rank: int) -> int:
    """The 64-bit seed of the buffered-async training generator of (site,
    global-model version): a pure function of ``(run seed, FED_SALT,
    version, site rank)`` through ``np.random.SeedSequence`` (the
    reference folds the same four into a threefry key, which torch cannot
    reproduce)."""
    words = np.random.SeedSequence(
        [int(seed) % 2 ** 32, FED_SALT, int(version) % 2 ** 32,
         int(site_rank) % 2 ** 32]).generate_state(2, np.uint32)
    return int(words[0]) << 32 | int(words[1])


def site_round_key(seed: int, version: int, site_rank: int,
                   device="cpu") -> torch.Generator:
    """Buffered-async training generator for (site, global-model version),
    on ``device``, seeded by :func:`site_round_seed`.

    Nothing about arrival order, wall clock, or process identity enters
    it, so a site's delta is reproducible from its TRAIN message alone and
    a recorded arrival trace replays bit for bit (``fed/aggregator.py``).
    """
    return torch.Generator(device=device).manual_seed(
        site_round_seed(seed, version, site_rank))


def partition_slots(n_items: int, n_sites: int) -> List[np.ndarray]:
    """Contiguous order-preserving split of ``arange(n_items)`` into
    ``n_sites`` blocks (site k, 1-based, owns block k-1).

    Contiguity is load-bearing for the sync barrier: concatenating the
    sites' reply rows in rank order reassembles the cohort in exact
    slot order, so the aggregate runs over the same [S] stacking as the
    in-process round body.
    """
    if n_sites < 1:
        raise ValueError(f"n_sites must be >= 1, got {n_sites}")
    return np.array_split(np.arange(int(n_items)), int(n_sites))


def send_with_retry(manager: Any, msg: Message, retries: int = 2,
                    backoff_s: float = 0.05) -> None:
    """``send_message`` with bounded retry + exponential backoff.

    Transient transport failures (``OSError`` from the native TCP
    backend, ``ConnectionError`` from a draining inbox) are retried up
    to ``retries`` times with ``backoff_s * 2**attempt`` sleeps; each
    re-issue bumps the manager's ``CommCounters.messages_retried`` so
    degradation is visible in the obs fold. Anything still failing
    after the budget propagates — a dead peer is the caller's quorum
    logic's problem, not this function's.
    """
    comm = getattr(manager, "comm", manager)
    attempt = 0
    while True:
        try:
            manager.send_message(msg)
            return
        except OSError as e:  # ConnectionError is an OSError subclass
            if attempt >= retries:
                raise
            counters = getattr(comm, "counters", None)
            if counters is not None:
                counters.note_retry()
            delay = backoff_s * (2 ** attempt)
            logger.warning(
                "send %s -> rank %s failed (%s); retry %d/%d in %.3fs",
                msg.type, msg.receiver_id, e, attempt + 1, retries, delay)
            time.sleep(delay)
            attempt += 1
