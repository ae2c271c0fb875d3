"""Deterministic fault injection for federated rounds (counterpart of
``neuroimagedisttraining_tpu/robust/faults.py``).

Faults are applied to the ``[S, ...]``-stacked local models inside the round
body, so a guarded round stays one body (one CUDA-graph replay in the fused
loop) and composes with every ``agg_impl`` wire.

The draws are a pure function of (run seed, round index, POPULATION client
id): each selected client's draws come from a CPU ``torch.Generator`` seeded
by that tuple alone (:func:`client_draws`), never from the round's shared
generator. So a fault trace does not change with the cohort, with a
watchdog retry, or between the eager and the fused loop, and
:func:`fault_trace_round` replays it on the host. The draws enter the round
as an input (``RoundInputs.faults``), like every random draw of this
package, so a test can feed the reference's threefry draws instead.

``--fault_spec`` grammar (comma-separated ``kind=prob`` entries):

    drop=0.2,straggle=0.1,nan=0.05,scale=0.02:100x

* ``drop``      the client's update never reaches the server (the guard
                zero-weights it and keeps its personal model);
* ``straggle``  partial work: the delta scaled by a per-(round, client)
                uniform fraction in [0.25, 0.75);
* ``nan``       the whole update is NaN (caught by the guard's screen);
* ``scale``     Byzantine scaling of the delta by ``factor`` (default 100,
                ``scale=p:Fx``);
* ``signflip``  the delta negated;
* ``collude``   every colluding client of a round ships the same forged
                delta, ``factor`` times one Rademacher direction per (seed,
                round) (``collude=p:Fx``);
* ``labelflip`` the client trains on flipped labels (``C-1-y`` for integer
                labels, ``1-y`` for float targets), on the data path.

Per client, in the reference's order: ``labelflip`` acts upstream; after
training, nan overrides every delta transform, ``collude`` replaces the
delta, ``scale`` overrides ``straggle``, ``signflip`` negates the factor that
survived; ``drop`` is orthogonal. A client with no fault passes through bit
for bit, by select (``g + (p - g) * 1`` is not ``p``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.state import Tree

#: domain-separation salt of the per-client draws ("faul")
FAULT_SALT = 0x6661756C

#: round-level salt of the colluders' shared direction ("col")
COLLUDE_SALT = 0x636F6C

_KINDS = ("drop", "straggle", "nan", "scale", "signflip", "collude",
          "labelflip")

#: kinds taking a ``=p:Fx`` factor suffix -> FaultSpec factor field
_FACTOR_KINDS = {"scale": "scale_factor", "collude": "collude_factor"}

#: the columns of one client's draw row (:func:`client_draws`): the
#: reference's ``u[4]``, the straggle fraction and ``u2[3]``
DRAW_COLUMNS = ("drop", "straggle", "nan", "scale", "frac", "signflip",
                "collude", "labelflip")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Parsed ``--fault_spec``: per-round, per-client fault probabilities."""

    drop: float = 0.0
    straggle: float = 0.0
    nan: float = 0.0
    scale: float = 0.0
    scale_factor: float = 100.0
    signflip: float = 0.0
    collude: float = 0.0
    collude_factor: float = 100.0
    labelflip: float = 0.0

    @property
    def any_active(self) -> bool:
        return max(self.drop, self.straggle, self.nan, self.scale,
                   self.signflip, self.collude, self.labelflip) > 0.0

    def describe(self) -> str:
        parts = []
        for k in _KINDS:
            p = getattr(self, k)
            if p <= 0:
                continue
            if k in _FACTOR_KINDS:
                fac = getattr(self, _FACTOR_KINDS[k])
                parts.append(f"{k}={p:g}:{fac:g}x")
            else:
                parts.append(f"{k}={p:g}")
        return ",".join(parts) or "none"


def parse_fault_spec(spec: Optional[str]) -> Optional[FaultSpec]:
    """``"drop=0.2,straggle=0.1,nan=0.05,scale=0.02:100x"`` -> FaultSpec;
    empty or None -> None (injection off). Raises ValueError on an unknown
    kind, a factor on a kind that takes none, a non-positive factor, a
    probability outside [0, 1] or a kind given twice."""
    if not spec:
        return None
    fields = {}
    factors = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"fault_spec entry {entry!r} is not kind=prob "
                f"(kinds: {_KINDS})")
        kind, _, val = entry.partition("=")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (kinds: {_KINDS})")
        if ":" in val:
            if kind not in _FACTOR_KINDS:
                raise ValueError(
                    f"fault kind {kind!r} takes no :factor suffix "
                    f"(only {tuple(_FACTOR_KINDS)})")
            val, _, fac = val.partition(":")
            factor = float(fac.rstrip("xX"))
            if factor <= 0:
                raise ValueError(
                    f"{kind} factor must be positive, got {factor}")
            factors[_FACTOR_KINDS[kind]] = factor
        p = float(val)
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"fault probability {kind}={p} outside [0, 1]")
        if kind in fields:
            raise ValueError(f"duplicate fault kind {kind!r}")
        fields[kind] = p
    return FaultSpec(**factors, **fields)


def _keyed_generator(*key: int) -> torch.Generator:
    """A CPU generator seeded by a hash of the integer tuple ``key`` (each
    taken modulo 2**32), the same seed on every host."""
    words = [int(k) & 0xFFFFFFFF for k in key]
    seed = int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] & 0x7FFFFFFFFFFFFFFF)
    return torch.Generator().manual_seed(seed)


def client_draws(seed: int, round_idx: int,
                 client_ids: Sequence[int]) -> torch.Tensor:
    """``[S, 8]`` float32 on the CPU: for each population client id of
    ``client_ids``, the columns of :data:`DRAW_COLUMNS` (four uniforms, the
    straggle fraction in [0.25, 0.75), three uniforms), from a generator of
    its own seeded by (seed, FAULT_SALT, round, client id)."""
    rows = []
    for cid in client_ids:
        g = _keyed_generator(seed, FAULT_SALT, round_idx, int(cid))
        u = torch.rand(4, generator=g)
        frac = 0.25 + 0.5 * torch.rand(1, generator=g)
        u2 = torch.rand(3, generator=g)
        rows.append(torch.cat([u, frac, u2]))
    return torch.stack(rows) if rows else torch.zeros((0, 8))


def collude_direction(seed: int, round_idx: int, params: Tree) -> Tree:
    """The colluders' shared direction of a round: one Rademacher (+-1)
    tree shaped like ``params``, on the CPU, from a generator seeded by
    (seed, COLLUDE_SALT, round), leaves drawn in sorted name order."""
    g = _keyed_generator(seed, COLLUDE_SALT, round_idx)
    out = {}
    for k in sorted(params):
        bits = torch.randint(0, 2, tuple(params[k].shape), generator=g)
        out[k] = (bits * 2 - 1).to(params[k].dtype)
    return {k: out[k] for k in params}


class FaultInjector:
    """The injector of one run (``make_fault_fn``): its draws on the host,
    its transform on the device.

    * :meth:`draws` / :meth:`direction`: a round's inputs, made on the CPU
      from (seed, round, client id) alone;
    * :meth:`__call__` ``(stacked, global_params, draws, direction) ->
      (faulted, dropped)``: the spec's faults applied to the ``[S, ...]``
      stacked post-training local models (``global_params``, unstacked, is
      the pre-round global the deltas are measured against), and the [S]
      dropout flags. It reads the host for nothing: a CUDA graph holds it."""

    def __init__(self, spec: FaultSpec, seed: int):
        self.spec, self.seed = spec, int(seed)

    def draws(self, round_idx: int,
              client_ids: Sequence[int]) -> torch.Tensor:
        return client_draws(self.seed, round_idx, client_ids)

    def direction(self, round_idx: int, params: Tree) -> Optional[Tree]:
        if self.spec.collude <= 0:
            return None
        return collude_direction(self.seed, round_idx, params)

    def __call__(self, stacked: Tree, global_params: Tree,
                 draws: torch.Tensor,
                 direction: Optional[Tree] = None
                 ) -> Tuple[Tree, torch.Tensor]:
        spec = self.spec
        col = {c: draws[:, i] for i, c in enumerate(DRAW_COLUMNS)}
        dropped = col["drop"] < spec.drop
        straggles = col["straggle"] < spec.straggle
        poisoned = col["nan"] < spec.nan
        byzantine = col["scale"] < spec.scale
        signflips = col["signflip"] < spec.signflip
        colludes = col["collude"] < spec.collude
        frac = col["frac"]
        factor = torch.where(straggles, frac, torch.ones_like(frac))
        factor = torch.where(byzantine,
                             torch.full_like(frac, spec.scale_factor), factor)
        factor = torch.where(signflips, -factor, factor)
        rescaled = straggles | byzantine | signflips
        s = draws.shape[0]
        out = {}
        for k, p in stacked.items():
            def row(t):
                return t.reshape((s,) + (1,) * (p.dim() - 1))

            g = global_params[k]
            x = torch.where(row(rescaled),
                            g + (p - g) * row(factor).to(p.dtype), p)
            if direction is not None:
                forged = g + torch.tensor(spec.collude_factor,
                                          dtype=p.dtype) * direction[k]
                x = torch.where(row(colludes), forged, x)
            out[k] = torch.where(row(poisoned),
                                 torch.full_like(x, float("nan")), x)
        return out, dropped


def make_fault_fn(spec: FaultSpec, seed: int) -> FaultInjector:
    """The injector of ``spec`` under run seed ``seed``."""
    return FaultInjector(spec, seed)


def labelflip_flags(spec: FaultSpec, draws: torch.Tensor) -> torch.Tensor:
    """The [S] ``labelflip`` flags of a round's draws (the third ``u2``
    column, as the reference's ``fold_in(k, 2)`` draw)."""
    return draws[:, DRAW_COLUMNS.index("labelflip")] < spec.labelflip


def flip_labels(y: torch.Tensor, flagged: torch.Tensor,
                num_classes: int) -> torch.Tensor:
    """``y`` flipped where ``flagged`` (a bool broadcastable against it):
    integer labels to ``num_classes - 1 - y``, float targets to ``1 - y``.
    The reference takes ``num_classes`` from the model's output count, so
    a binary BCE model (one output) flips an integer label ``y`` to
    ``-y``; this keeps that."""
    if y.dtype.is_floating_point:
        flipped = torch.tensor(1.0, dtype=y.dtype, device=y.device) - y
    else:
        flipped = (num_classes - 1) - y
    return torch.where(flagged, flipped, y)


def make_labelflip_fn(spec: Optional[FaultSpec], seed: int,
                      num_classes: int):
    """The data-path twin of the injector, or None when the spec never
    flips: ``flip(y, flagged)`` (:func:`flip_labels` at ``num_classes``).
    Its flags come from the injector's draws (:func:`labelflip_flags`), so
    :func:`fault_trace_round` attributes the same clients."""
    if spec is None or spec.labelflip <= 0:
        return None

    def flip(y: torch.Tensor, flagged: torch.Tensor) -> torch.Tensor:
        return flip_labels(y, flagged, num_classes)

    return flip


def fault_trace_round(spec: FaultSpec, seed: int, round_idx: int,
                      client_ids) -> Dict[str, np.ndarray]:
    """The host replay of one round's fault draws: ``{"dropped",
    "straggled", "poisoned", "byzantine", "signflipped", "colluding",
    "labelflipped"}``, each a bool array aligned with ``client_ids``, from
    the draws the round itself read."""
    d = client_draws(seed, round_idx, [int(c) for c in client_ids])
    col: Dict[str, torch.Tensor] = {c: d[:, i]
                                    for i, c in enumerate(DRAW_COLUMNS)}
    names: List[Tuple[str, str]] = [
        ("dropped", "drop"), ("straggled", "straggle"), ("poisoned", "nan"),
        ("byzantine", "scale"), ("signflipped", "signflip"),
        ("colluding", "collude"), ("labelflipped", "labelflip")]
    return {out: (col[c] < getattr(spec, c)).numpy() for out, c in names}
