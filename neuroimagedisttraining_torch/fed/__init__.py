"""Distributed federation runtime (counterpart of
``neuroimagedisttraining_tpu/fed``): one **aggregator process** and N
**site processes** exchanging model deltas over a wire (``comm/``),
driven by ``scripts/torch_run_federation.py`` or the CLI's
``--fed_role aggregator|site``.

Two aggregation policies behind one surface:

* ``sync`` — barrier per round. The aggregator draws each round from the
  in-process state's generator and ships every site its slots' draws; the
  sites train their slots and ship the rows back; the aggregator runs
  FedAvg's own aggregate (the weighted-sum kernel). On the loopback
  backend, and over TCP with every process on one card, this is bit for
  bit the in-process run.
* ``buffered`` — FedBuff-style async (Nguyen et al., AISTATS 2022): apply
  the first K arriving deltas with staleness-discounted weights
  ``n_i / sqrt(1 + tau_i)`` under ``--fed_staleness_bound``; stragglers
  stop gating the round clock. Arrival order is recorded to a trace so a
  buffered run replays bit for bit (``--fed_replay``).

Module map: ``wire`` (delta codecs in the ``agg_impl`` formats),
``protocol`` (message types, send retry/backoff, the site generators'
seeds), ``trainer`` (the local-training half of a round), ``site`` (the
site worker), ``aggregator`` (both policies, trace record/replay),
``runtime`` (role dispatch, loopback harness, refusals, obs fold).
"""
from .aggregator import FedAggregator
from .protocol import (
    FED_SALT,
    MSG_FED_FINISH,
    MSG_FED_TRAIN,
    MSG_FED_UPDATE,
    partition_slots,
    send_with_retry,
    site_round_key,
    site_round_seed,
)
from .runtime import run_federated
from .site import SiteWorker
from .trainer import SiteTrainer
from .wire import WIRE_IMPLS, decode_update, encode_update

__all__ = [
    "FED_SALT",
    "FedAggregator",
    "MSG_FED_FINISH",
    "MSG_FED_TRAIN",
    "MSG_FED_UPDATE",
    "SiteTrainer",
    "SiteWorker",
    "WIRE_IMPLS",
    "decode_update",
    "encode_update",
    "partition_slots",
    "run_federated",
    "send_with_retry",
    "site_round_key",
    "site_round_seed",
]
