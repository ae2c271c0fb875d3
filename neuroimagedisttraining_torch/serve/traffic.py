"""Synthetic request traffic: deterministic Zipf-skewed load (counterpart
of ``neuroimagedisttraining_tpu/serve/traffic.py``, copied: its streams and
trace files are the reference's byte for byte).

The millions-of-users load profile at CI scale: requests are
``(client_id, sample_idx)`` pairs over the synthetic federated volumes
(``data/synthetic.py`` — ``sample_idx`` indexes the client's own
``x_train`` rows, request granularity instead of round granularity).
Client popularity is Zipf: rank ``r`` (0-based) draws with weight
``1/(r+1)^s``, and WHICH client holds which rank is a seeded
permutation — so the hot head is a deterministic function of the seed,
not of client numbering. A head-heavy skew is the whole point: it is
what makes the store's LRU hot set earn its keep (the monotonicity
test in ``tests/test_serve_traffic.py`` pins hit-rate vs capacity).

Determinism is the contract, same as everywhere else in the repo: the
generator is a pure function of ``(seed, num_clients, zipf_s)`` plus
its draw count — ``np.random.Generator`` (PCG64), no wall clock — so
two generators with one seed emit identical request streams, and a
recorded trace replays equal to a fresh generator (both pinned by
tests). Traces serialize to JSON for offline analysis / replay.
"""
from __future__ import annotations

import json
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import SERVE_SALT


class TrafficGenerator:
    """Deterministic open-loop request source.

    ``n_per_client`` bounds each client's ``sample_idx`` (the
    synthetic data's ``n_train``); a scalar broadcasts. ``zipf_s`` is
    the skew exponent (1.0-1.2 is the classic web-traffic range;
    larger = hotter head).
    """

    def __init__(self, num_clients: int, n_per_client,
                 zipf_s: float = 1.1, seed: int = 0):
        if num_clients < 1:
            raise ValueError("TrafficGenerator needs num_clients >= 1")
        if zipf_s <= 0:
            raise ValueError(f"zipf_s must be > 0, got {zipf_s}")
        self.num_clients = int(num_clients)
        self.zipf_s = float(zipf_s)
        self.seed = int(seed)
        n = np.broadcast_to(np.asarray(n_per_client, np.int64),
                            (self.num_clients,))
        if np.any(n < 1):
            raise ValueError("every client needs >= 1 sample to serve")
        self.n_per_client = np.array(n)
        # popularity: a seeded permutation assigns each client its Zipf
        # rank (domain-separated from the draw stream so adding draws
        # never reshuffles who is popular)
        perm_rng = np.random.default_rng((self.seed, SERVE_SALT, 0))
        ranks = perm_rng.permutation(self.num_clients)
        w = 1.0 / (np.arange(self.num_clients, dtype=np.float64)
                   + 1.0) ** self.zipf_s
        p = w[ranks]
        self.probs = p / p.sum()
        self._rng = np.random.default_rng((self.seed, SERVE_SALT, 1))
        self.drawn = 0

    def hot_clients(self, k: int) -> np.ndarray:
        """The ``k`` most popular client ids, descending popularity —
        what an informed prefetch would pin."""
        return np.argsort(-self.probs, kind="stable")[:int(k)]

    def draw(self, n: int) -> np.ndarray:
        """``[n, 2]`` int64 requests ``(client_id, sample_idx)``."""
        n = int(n)
        clients = self._rng.choice(self.num_clients, size=n,
                                   p=self.probs)
        # a full-width draw modulo the client's own sample count keeps
        # the stream length (and hence determinism) independent of the
        # per-client data sizes
        raw = self._rng.integers(0, np.int64(2) ** 62, size=n)
        samples = raw % self.n_per_client[clients]
        self.drawn += n
        return np.stack([clients, samples], axis=1).astype(np.int64)

    def iter_requests(self, total: int) -> Iterator[Tuple[int, int]]:
        """Yield ``total`` requests one at a time, equal to
        ``draw(total)`` element-for-element. Materialized as ONE draw:
        chunked draws would interleave the client/sample consumption of
        the underlying bit stream differently and fork the sequence."""
        for c, s in self.draw(int(total)):
            yield int(c), int(s)


# -- trace record / replay -----------------------------------------------

def trace_save(path: str, requests: Sequence[Tuple[int, int]],
               meta: Optional[dict] = None) -> str:
    """Serialize a served request stream (list of ``(client, sample)``)
    plus generator metadata to JSON."""
    body = {"meta": dict(meta or {}),
            "requests": [[int(c), int(s)] for c, s in requests]}
    with open(path, "w") as f:
        json.dump(body, f)
    return path


def trace_load(path: str) -> List[Tuple[int, int]]:
    with open(path) as f:
        body = json.load(f)
    return [(int(c), int(s)) for c, s in body["requests"]]


def replay_requests(trace: Sequence[Tuple[int, int]]
                    ) -> Iterator[Tuple[int, int]]:
    """A recorded trace as a request source — drop-in for
    ``TrafficGenerator.iter_requests`` (the replay-equality contract:
    a worker fed the trace serves the identical request sequence)."""
    for c, s in trace:
        yield int(c), int(s)
