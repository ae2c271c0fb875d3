"""Live fleet telemetry plane: in-band heartbeats + the FleetLedger (the
port's own copy of ``neuroimagedisttraining_tpu/obs/live.py``, on the
port's ``obs.events``).

Every observability layer before this one is post-hoc — per-process
JSONL streams merged and judged after the run ends. This module is the
*live* half: while a federation (or serving deployment) is still
running, the aggregator/publisher knows which peers are alive, how far
through the round each one is, and what their key gauges read — and
the SLO engine can declare federation-scope objectives over that
state.

Three pieces, all pure and wall-clock-free (time is an explicit
argument everywhere — the determinism contract every obs layer keeps):

* **In-band heartbeat headers** — the ``hb_*`` ``Message.params`` keys
  (the proven ``obs/xtrace.py`` pattern): a lightweight gauge snapshot
  piggybacked on frames the protocol already sends (TRAIN replies,
  serve ACKs), plus periodic standalone HEARTBEAT frames so mid-round
  progress is visible while a site is still training. ``inject``-side
  call sites gate on their heartbeat config being non-None — that IS
  the byte-inert contract: heartbeats off adds not one byte to any
  wire. ``extract_heartbeat`` tolerates absence (returns None, never
  raises) so a heartbeat-aware receiver reads heartbeat-free frames
  unchanged.
* :class:`FleetLedger` — per-peer last-seen, round progress, key
  gauges, and the liveness state machine (LIVE -> SUSPECT -> DOWN on
  missed heartbeats, back to LIVE on any sign of life) emitting typed
  ``SITE_DOWN`` / ``SITE_RECOVERED`` events into the event bus
  (``obs/events.py``).
  ``fleet_gauges`` feeds the live SLO engine (``fleet_sites_live``,
  ``fleet_max_heartbeat_age_s``, ``fleet_round_progress``) so
  ``--slo_spec`` can declare federation-scope objectives; the gauges
  are classed volatile in ``obs/diff.py`` so a heartbeat-on twin stays
  ``identical`` to its off twin.
* :func:`render_frame` — the ``obs watch`` dashboard frame, a pure
  function of a ledger :meth:`~FleetLedger.snapshot` (byte-pinned in
  tests): one lane per peer, health glyphs, the fleet summary line.

The state machine is deterministic given its (peer, time) observation
sequence — under ``--fed_replay`` the arrival trace replays the same
sequence, so the ledger replays too.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .events import Event, make_event

__all__ = [
    "DOWN", "FleetLedger", "HB_GAUGES", "HB_PEER", "HB_ROUND",
    "HeartbeatConfig", "LIVE", "SUSPECT", "extract_heartbeat",
    "fleet_gauge_keys", "inject_heartbeat", "render_frame",
]

#: the in-band header keys (``Message.params`` is a JSON header;
#: decode keeps unknown keys, handlers read only what they want — the
#: transparency property tests/test_live.py pins over every wire)
HB_PEER = "hb_peer"
HB_ROUND = "hb_round"
HB_GAUGES = "hb_gauges"

#: liveness states, in health order
LIVE = "live"
SUSPECT = "suspect"
DOWN = "down"

#: missed-interval multiples: a peer silent for ``suspect_after``
#: heartbeat intervals is SUSPECT, for ``down_after`` it is DOWN.
DEFAULT_SUSPECT_AFTER = 3.0
DEFAULT_DOWN_AFTER = 6.0

#: gauge subset worth shipping in-band (a heartbeat is a header, not a
#: telemetry dump — the full registry stays in the per-process JSONL)
HEARTBEAT_GAUGE_KEYS = (
    "local_epoch", "train_loss", "mem_rss_mb",
    "comm_messages_sent", "comm_bytes_sent",
    "serve_requests", "serve_model_version",
)


class HeartbeatConfig:
    """One process's heartbeat emission config + mutable gauge board.

    Constructed only when ``--obs_heartbeat_every > 0`` — every inject
    call site gates on the config being non-None, so heartbeats off
    touches no wire. ``note`` updates the board from wherever the host
    code has fresh values (train loop, serve tick); ``payload`` freezes
    the board into the JSON-safe dict that rides the header.
    """

    def __init__(self, peer: str, every_s: float):
        if every_s <= 0:
            raise ValueError(
                f"heartbeat interval must be > 0, got {every_s}")
        self.peer = str(peer)
        self.every_s = float(every_s)
        self.gauges: Dict[str, float] = {}
        self.round = -1
        self.sent = 0

    def note(self, key: str, value: Any) -> None:
        if isinstance(value, (int, float)) and not isinstance(
                value, bool):
            self.gauges[str(key)] = float(value)

    def note_round(self, round_idx: int) -> None:
        self.round = int(round_idx)

    def payload(self) -> Dict[str, float]:
        return {k: self.gauges[k] for k in sorted(self.gauges)}


def inject_heartbeat(msg: Any, hb: HeartbeatConfig) -> None:
    """Stamp the heartbeat headers onto an outbound message (works on
    anything with ``Message.add``). Callers gate on ``hb`` non-None —
    off-path frames are byte-identical to pre-heartbeat builds."""
    msg.add(HB_PEER, hb.peer)
    msg.add(HB_ROUND, int(hb.round))
    msg.add(HB_GAUGES, hb.payload())
    hb.sent += 1


def extract_heartbeat(msg: Any) -> Optional[Dict[str, Any]]:
    """The heartbeat of an inbound message, or None when the sender
    did not inject one (heartbeat-free frames read unchanged — never
    raises)."""
    peer = msg.get(HB_PEER, None)
    if peer is None:
        return None
    gauges = msg.get(HB_GAUGES, None)
    return {
        "peer": str(peer),
        "round": int(msg.get(HB_ROUND, -1)),
        "gauges": dict(gauges) if isinstance(gauges, dict) else {},
    }


def fleet_gauge_keys() -> Sequence[str]:
    """The fleet-level metric names the ledger stamps (volatile in
    ``obs/diff.py``; SLO-declarable)."""
    return ("fleet_sites_live", "fleet_sites_down",
            "fleet_max_heartbeat_age_s", "fleet_round_progress")


class _PeerRow:
    __slots__ = ("peer", "state", "last_seen_s", "round", "gauges",
                 "frames", "downs")

    def __init__(self, peer: str, now_s: float):
        self.peer = peer
        self.state = LIVE
        self.last_seen_s = float(now_s)
        self.round = -1
        self.gauges: Dict[str, float] = {}
        self.frames = 0
        self.downs = 0


class FleetLedger:
    """Per-peer liveness ledger on the aggregator/publisher.

    Wall-clock-free: every method takes ``now_s`` explicitly, so tests
    drive the state machine with a synthetic clock and the transitions
    are a pure function of the observation sequence. Thresholds are
    multiples of the heartbeat interval: a peer silent for
    ``suspect_after`` intervals is SUSPECT, for ``down_after`` DOWN.

    Transitions emit typed events (``SITE_DOWN`` on entering DOWN,
    ``SITE_RECOVERED`` on leaving it) batched one event per
    ``tick``/``observe`` call — the detail lists every peer that moved,
    honoring the one-event-per-(round, type) emission contract.
    """

    def __init__(self, interval_s: float,
                 suspect_after: float = DEFAULT_SUSPECT_AFTER,
                 down_after: float = DEFAULT_DOWN_AFTER):
        if interval_s <= 0:
            raise ValueError(
                f"ledger interval must be > 0, got {interval_s}")
        if not suspect_after < down_after:
            raise ValueError(
                f"need suspect_after < down_after, got "
                f"{suspect_after} >= {down_after}")
        self.interval_s = float(interval_s)
        self.suspect_s = float(suspect_after) * self.interval_s
        self.down_s = float(down_after) * self.interval_s
        self.round = -1
        self._rows: Dict[str, _PeerRow] = {}

    # -- observation -----------------------------------------------------
    def register(self, peer: str, now_s: float) -> None:
        """Pre-register an expected peer (HELLO/first dispatch time):
        it starts LIVE and the silence clock starts now — a site that
        dies before its first heartbeat still goes DOWN."""
        self._rows.setdefault(str(peer), _PeerRow(str(peer), now_s))

    def note_round(self, round_idx: int) -> None:
        """The aggregator's current round — the index transition
        events carry."""
        self.round = int(round_idx)

    def observe(self, peer: str, now_s: float,
                round_idx: Optional[int] = None,
                gauges: Optional[Dict[str, float]] = None
                ) -> List[Event]:
        """One sign of life from ``peer`` (heartbeat frame, piggybacked
        header, or any protocol frame): refresh last-seen, absorb
        gauges, and return the recovery event if the peer was DOWN."""
        row = self._rows.setdefault(str(peer),
                                    _PeerRow(str(peer), now_s))
        was_down = row.state == DOWN
        row.last_seen_s = float(now_s)
        row.state = LIVE
        row.frames += 1
        if round_idx is not None:
            row.round = max(row.round, int(round_idx))
        for k, v in (gauges or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                row.gauges[str(k)] = float(v)
        if was_down:
            return [make_event(
                "SITE_RECOVERED", self.round,
                f"site(s) {peer} recovered after DOWN",
                {"peers": [str(peer)]})]
        return []

    def tick(self, now_s: float) -> List[Event]:
        """Advance the silence clocks: LIVE -> SUSPECT -> DOWN on
        missed heartbeats. Returns the (at most one) SITE_DOWN event
        for every peer that entered DOWN this tick."""
        newly_down: List[str] = []
        for peer in sorted(self._rows):
            row = self._rows[peer]
            age = float(now_s) - row.last_seen_s
            if age >= self.down_s:
                if row.state != DOWN:
                    row.state = DOWN
                    row.downs += 1
                    newly_down.append(peer)
            elif age >= self.suspect_s:
                if row.state == LIVE:
                    row.state = SUSPECT
        if not newly_down:
            return []
        return [make_event(
            "SITE_DOWN", self.round,
            "site(s) " + ",".join(newly_down)
            + f" missed heartbeats for >= {self.down_s:g}s",
            {"peers": newly_down, "down_after_s": self.down_s})]

    # -- views -----------------------------------------------------------
    def states(self) -> Dict[str, str]:
        return {p: self._rows[p].state for p in sorted(self._rows)}

    def fleet_gauges(self, now_s: float) -> Dict[str, float]:
        """The federation-scope metrics the SLO engine evaluates,
        joined onto the aggregator's round records (volatile keys —
        twin-safe). ``fleet_round_progress`` is the fraction of known
        peers whose last reported round has reached the ledger's
        current round."""
        rows = list(self._rows.values())
        if not rows:
            return {"fleet_sites_live": 0.0, "fleet_sites_down": 0.0,
                    "fleet_max_heartbeat_age_s": 0.0,
                    "fleet_round_progress": 0.0}
        live = sum(1.0 for r in rows if r.state != DOWN)
        down = sum(1.0 for r in rows if r.state == DOWN)
        age = max(float(now_s) - r.last_seen_s for r in rows)
        caught_up = sum(1.0 for r in rows if r.round >= self.round)
        return {
            "fleet_sites_live": live,
            "fleet_sites_down": down,
            "fleet_max_heartbeat_age_s": max(0.0, age),
            "fleet_round_progress": caught_up / len(rows),
        }

    def snapshot(self, now_s: float) -> Dict[str, Any]:
        """Frozen JSON-safe view: sorted peer rows + fleet summary —
        the ONE input :func:`render_frame` (and the prom fleet gauges,
        and the tests' byte pins) consume."""
        peers = []
        for p in sorted(self._rows):
            row = self._rows[p]
            peers.append({
                "peer": row.peer,
                "state": row.state,
                "age_s": round(max(0.0, float(now_s)
                                   - row.last_seen_s), 3),
                "round": row.round,
                "frames": row.frames,
                "downs": row.downs,
                "gauges": {k: row.gauges[k]
                           for k in sorted(row.gauges)},
            })
        return {"round": self.round, "interval_s": self.interval_s,
                "peers": peers, "fleet": self.fleet_gauges(now_s)}


# -- the watch dashboard ------------------------------------------------

#: state -> (glyph, ANSI color) for the dashboard lanes
_STATE_STYLE = {LIVE: ("●", "32"), SUSPECT: ("◐", "33"),
                DOWN: ("○", "31")}

#: gauges worth a dashboard column, in display order
_LANE_GAUGES = ("train_loss", "serve_model_version", "mem_rss_mb")


def _paint(text: str, code: str, color: bool) -> str:
    return f"\x1b[{code}m{text}\x1b[0m" if color else text


def render_frame(snapshot: Dict[str, Any], color: bool = False,
                 slo_health: str = "") -> str:
    """One dashboard frame from one ledger snapshot — a pure function
    (byte-pinned in tests/test_live.py): the fleet summary line, then
    one lane per peer with its health glyph, age, round progress, and
    key gauges. ``slo_health`` (when the caller runs an SLO engine)
    joins the header."""
    fleet = snapshot.get("fleet") or {}
    peers = snapshot.get("peers") or []
    # peer-less snapshots (an endpoint scrape carries only the fleet
    # gauges) still know the fleet size from live + down
    total = len(peers) or int(fleet.get("fleet_sites_live", 0)
                              + fleet.get("fleet_sites_down", 0))
    head = (f"fleet round {snapshot.get('round', -1)}  "
            f"live {fleet.get('fleet_sites_live', 0):g}"
            f"/{total}  "
            f"max_age {fleet.get('fleet_max_heartbeat_age_s', 0):.1f}s"
            f"  progress "
            f"{100 * fleet.get('fleet_round_progress', 0):.0f}%")
    if slo_health:
        code = {"ok": "32", "degraded": "33"}.get(slo_health, "31")
        head += "  slo " + _paint(slo_health.upper(), code, color)
    lines = [head]
    for row in peers:
        glyph, code = _STATE_STYLE.get(row.get("state", DOWN),
                                       ("?", "31"))
        lane = (f"  {_paint(glyph, code, color)} "
                f"{row.get('peer', '?'):<12} "
                f"{row.get('state', '?'):<8} "
                f"age {row.get('age_s', 0):6.1f}s  "
                f"round {row.get('round', -1):<4} "
                f"frames {row.get('frames', 0):<5}")
        gauges = row.get("gauges") or {}
        extras = [f"{k}={gauges[k]:g}" for k in _LANE_GAUGES
                  if k in gauges]
        if extras:
            lane += " " + " ".join(extras)
        lines.append(lane)
    return "\n".join(lines) + "\n"
