"""The fault-count replay (the part of
``neuroimagedisttraining_tpu/obs/health.py`` the in-process tier needs;
its offline ledger waits for the analyzer).

Cohort draws are a pure function of the round index
(``algorithms.base.sample_client_indexes``) and fault draws of ``(seed,
round, client id)`` (the port's own ``robust.faults.fault_trace_round``,
from the draws its rounds read), so the runner stamps each round's JSONL
line with the clients a fault actually touched, replayed host-side
(:func:`make_fault_counts_fn`); the flight recorder maps cohort slots to
client ids the same way (:func:`replay_client_indexes`).
"""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["make_fault_counts_fn", "replay_client_indexes"]


def _effective_straggled(tr: Dict[str, Any]):
    """Straggle draws that actually took effect in the round program:
    ``make_fault_fn`` lets Byzantine scaling override the straggle
    factor, a colluding client's delta is REPLACED by the shared attack
    direction, NaN poison overrides every delta transform, and a
    dropped client's payload never reaches the server at all. (A
    signflip does NOT mask a straggle — the negation composes with the
    straggle factor, so both draws show in the shipped delta.)"""
    import numpy as np

    return np.logical_and.reduce([
        tr["straggled"],
        np.logical_not(tr["byzantine"]),
        np.logical_not(tr["colluding"]),
        np.logical_not(tr["poisoned"]),
        np.logical_not(tr["dropped"]),
    ])


def _effective_masks(tr: Dict[str, Any]) -> Dict[str, Any]:
    """The per-kind draws that actually shipped an adversarial delta,
    after the injector's override chain (collude > byzantine/signflip >
    straggle; nan poisons everything; drop withholds everything).
    ``labelflipped`` is a DATA-path fault — it survives every delta
    transform except drop/nan (which remove the round's contribution
    entirely)."""
    import numpy as np

    alive = np.logical_not(tr["poisoned"]) \
        & np.logical_not(tr["dropped"])
    not_collude = np.logical_not(tr["colluding"])
    return {
        "byzantine": tr["byzantine"] & alive & not_collude,
        "signflipped": tr["signflipped"] & alive & not_collude,
        "colluding": tr["colluding"] & alive,
        "labelflipped": tr["labelflipped"] & alive,
        "straggled": _effective_straggled(tr),
    }


def replay_client_indexes(round_idx: int, num_clients: int,
                          clients_per_round: int, retry: int = 0):
    """Offline twin of ``algorithms.base.sample_client_indexes``: the
    identical draw (it IS that function), but with the process-global
    numpy RNG state saved and restored around the reseed — the runner
    stamps counts mid-round-loop, and telemetry must not leave RNG
    side effects behind (the bit-identity contract). ``retry`` is the
    accepted attempt's watchdog nonce (``rounds_retried`` on the
    record): a retried round trained a RE-DRAWN cohort, and replaying
    nonce 0 would attribute faults to clients that never ran."""
    import numpy as np

    from ..algorithms.base import sample_client_indexes

    state = np.random.get_state()
    try:
        return sample_client_indexes(
            round_idx, num_clients, clients_per_round, retry=retry)
    finally:
        np.random.set_state(state)


def make_fault_counts_fn(fault_spec: str, seed: int, num_clients: int,
                         clients_per_round: int):
    """Per-round fault-count stamper for the runner's obs path: returns
    ``fn(round, retry=0) -> {"clients_straggled",
    "clients_byzantine", "clients_signflipped", "clients_colluding",
    "clients_labelflipped"}`` counted over that round's REPLAYED
    cohort (drop/quarantine counts are measured in-jit by the guard
    and deliberately not replayed here). Returns None when the spec
    injects nothing."""
    from ..robust.faults import fault_trace_round, parse_fault_spec

    spec = parse_fault_spec(fault_spec)
    if spec is None or not spec.any_active:
        return None

    def counts(round_idx: int, retry: int = 0) -> Dict[str, float]:
        sel = replay_client_indexes(
            round_idx, num_clients, clients_per_round, retry=retry)
        tr = fault_trace_round(spec, seed, round_idx, sel)
        eff = _effective_masks(tr)
        return {
            "clients_straggled": float(eff["straggled"].sum()),
            "clients_byzantine": float(eff["byzantine"].sum()),
            "clients_signflipped": float(eff["signflipped"].sum()),
            "clients_colluding": float(eff["colluding"].sum()),
            "clients_labelflipped": float(eff["labelflipped"].sum()),
        }

    return counts

