"""Round-granular checkpoint and resume in a torch format (counterpart of
``neuroimagedisttraining_tpu/utils/checkpoint.py``, which writes orbax).

The reference's own job lost a 3-day SLURM run at the time limit: its
federated loop had no checkpoint. Here every round (or every fused block)
can be saved: the whole algorithm state (the global model, the per-client
stacks, the mask, the eval cache, the generator) plus the round index, and a
run resumes from the newest step that loads.

The layout is the reference's, ``<root>/<identity>/<step>``: one directory
per step holding ``state.pt``, one ``torch.save`` of the state's fields
(tensors moved to the CPU, trees as plain dicts, ``None`` fields kept, the
generator as its ``get_state()``), written to a temporary name and moved
into place with ``os.replace``, so a kill mid-write leaves no truncated
step behind. Beside the steps, ``meta_<step>.json`` (cost totals, the
lineage's semantics) and, for a store-backed lineage, ``store_<step>.npz``
(the client store's rows); both are pruned with their step. A step is
loaded with ``torch.load(weights_only=True)`` onto the device of the
caller's template state.

On a client mesh (the manager's ``layout``, an algorithm whose data is
sharded) a step is the file a single-process run writes: its per-client row
fields hold all ``C`` rows in client order. Every rank takes part in a save
(the rows gathered whole, ``FedAlgorithm.state_to_global``), rank 0 alone
writes the step and its sidecars, and every rank then waits at a barrier,
also when the write failed, so no rank reads a step that is not in place
and none is left waiting. Every rank restores the same step (rank 0's,
checked), reads it whole and keeps its block of the row fields
(``FedAlgorithm.state_to_local``). So a step resumes at any mesh width,
one process included, as the reference's orbax steps of global arrays do.
A store-backed lineage's ``store_<step>.npz`` is the single process's file
too: every rank commits its staged rows and the ranks' written rows are
gathered to rank 0, which writes them with the step
(``ClientStore.snapshot``); a rank restoring it keeps its block's rows.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

#: the step file's format tag
FORMAT = "neuroimagedisttraining_torch/state-v1"
_STATE = "state.pt"
#: files an orbax step directory of the JAX package holds (any one marks it)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "default",
                  "manifest.ocdbt", "d", "ocdbt.process_0")
_GENERATOR = "__generator__"


class ForeignCheckpointError(RuntimeError):
    """A step directory of another format (an orbax step of the JAX
    package): refused by name, never skipped."""


def _pack(v: Any) -> Any:
    """One state field as what ``torch.load(weights_only=True)`` reads."""
    if isinstance(v, torch.Generator):
        return {_GENERATOR: v.get_state()}
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _pack(x) for k, x in v.items()}
    return v


def _unpack(v: Any, like: Any, path: str) -> Any:
    """A saved field back in the shape of the template's ``like`` (tensors
    onto ``like``'s device); a structure that does not match raises."""
    if isinstance(like, torch.Generator):
        if not (isinstance(v, dict) and _GENERATOR in v):
            raise ValueError(f"{path}: a generator was expected")
        g = torch.Generator(device=like.device)
        g.set_state(v[_GENERATOR])
        return g
    if isinstance(like, torch.Tensor):
        if not isinstance(v, torch.Tensor):
            raise ValueError(f"{path}: a tensor was expected")
        if v.shape != like.shape or v.dtype != like.dtype:
            raise ValueError(
                f"{path}: saved {tuple(v.shape)} {v.dtype}, the template "
                f"has {tuple(like.shape)} {like.dtype}")
        return v.to(like.device)
    if isinstance(like, dict):
        if not isinstance(v, dict) or sorted(v) != sorted(like):
            raise ValueError(f"{path}: the saved keys differ from the "
                             "template's")
        return {k: _unpack(v[k], like[k], f"{path}.{k}") for k in like}
    if (v is None) != (like is None):
        raise ValueError(f"{path}: saved {'None' if v is None else 'a value'}"
                         f", the template has "
                         f"{'None' if like is None else 'a value'}")
    return v


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class CheckpointManager:
    """Checkpoints of one lineage at ``<root>/<identity>/<step>``, the
    ``max_to_keep`` newest kept, a save every ``save_every`` steps.

    ``layout`` (settable later, once the algorithm is built): the algorithm
    whose states are saved, when its data is sharded over a client mesh
    (its ``mesh``, ``state_to_global``, ``state_to_local`` and
    ``checkpoint_template``); every rank then calls :meth:`save` and
    :meth:`restore_latest` together (module docstring)."""

    def __init__(self, root: str, identity: str = "run",
                 max_to_keep: int = 3, save_every: int = 1,
                 layout: Optional[Any] = None):
        path = os.path.abspath(os.path.join(root, identity))
        os.makedirs(path, exist_ok=True)
        self.directory = path
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_every = max(1, save_every)
        self.layout = layout
        #: best-effort save failures so far (``checkpoint_save_failures``):
        #: a disk hiccup must not end the run this manager protects
        self.save_failures = 0

    @property
    def mesh(self):
        """The client mesh of the ``layout``'s data, None off the mesh."""
        return getattr(self.layout, "mesh", None)

    # -- steps --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Every step directory, oldest first (an orbax step included)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isdir(
                    os.path.join(self.directory, name)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _store_path(self, step: int) -> str:
        return os.path.join(self.directory, f"store_{step}.npz")

    # -- save ---------------------------------------------------------------
    def save(self, round_idx: int, state: Any, force: bool = False,
             metadata: Optional[dict] = None,
             store: Optional[Any] = None) -> bool:
        """Best-effort save of ``state`` as step ``round_idx`` (every
        ``save_every`` steps unless ``force``): a failure logs a warning,
        counts ``save_failures`` and lets training go on, the steps kept
        before still there for a resume. ``metadata``: a JSON sidecar
        (the cost totals, the lineage's semantics). ``store``: the
        :class:`~..core.client_store.ClientStore` whose rows a store-backed
        state lacks, saved as ``store_<step>.npz`` (staged rows committed
        first). On a client mesh every rank calls it: the state's rows and
        the store's written rows are gathered to rank 0, rank 0 writes (and
        counts a failure), and every rank returns after the barrier that
        follows, whatever rank 0's write did; the return value is this
        rank's part."""
        if not force and round_idx % self.save_every:
            return False
        mesh = self.mesh
        try:
            try:
                if self.layout is not None:
                    state = self.layout.state_to_global(state)
                # on a mesh a collective: every rank commits and sends
                snap = None if store is None else store.snapshot()
                if mesh is None or mesh.rank == 0:
                    self._write(round_idx, state, metadata, snap)
            except Exception:
                self.save_failures += 1
                logger.warning(
                    "checkpoint save at step %d failed "
                    "(checkpoint_save_failures=%d); training continues on "
                    "the previously retained steps", round_idx,
                    self.save_failures, exc_info=True)
                return False
            finally:
                state = snap = None  # the gathered rows, before the barrier
        finally:
            if mesh is not None:
                mesh.barrier()
        return True

    def _write(self, round_idx: int, state: Any, metadata: Optional[dict],
               snap: Optional[Dict[str, Any]]) -> None:
        """Step ``round_idx``, its sidecars (``snap``: the client store's
        snapshot arrays), then the pruning."""
        from ..core.client_store import write_snapshot

        self._save_state(round_idx, state)
        if metadata is not None:
            self._publish(os.path.join(self.directory,
                                       f"meta_{round_idx}.json"),
                          json.dumps(metadata).encode())
        if snap is not None:
            write_snapshot(self._store_path(round_idx), snap)
        self._prune()

    @staticmethod
    def _publish(path: str, payload: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)

    def _save_state(self, step: int, state: Any) -> None:
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        blob = {"format": FORMAT, "step": int(step),
                "type": type(state).__name__,
                "fields": {f.name: _pack(getattr(state, f.name))
                           for f in dataclasses.fields(state)}}
        tmp = os.path.join(d, _STATE + ".tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(d, _STATE))

    def _prune(self) -> None:
        """Drop this format's steps past ``max_to_keep`` (a foreign step
        directory is left alone) and every sidecar whose step is gone."""
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep]:
            d = self._step_dir(step)
            if set(os.listdir(d)) <= {_STATE, _STATE + ".tmp"}:
                shutil.rmtree(d, ignore_errors=True)
        alive = set(steps[-self.max_to_keep:])
        for pattern, rx in (("meta_*.json", r"meta_(\d+)\.json$"),
                            ("store_*.npz", r"store_(\d+)\.npz$")):
            for p in glob.glob(os.path.join(self.directory, pattern)):
                m = re.match(rx, os.path.basename(p))
                if m and int(m.group(1)) not in alive:
                    _unlink(p)

    # -- load ---------------------------------------------------------------
    def load_metadata(self, round_idx: int) -> Optional[dict]:
        path = os.path.join(self.directory, f"meta_{round_idx}.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (ValueError, OSError):
            logger.warning("unreadable checkpoint metadata %s; falling back "
                           "to estimated cost counters", path)
            return None

    def _load_step(self, step: int, template: Any) -> Any:
        d = self._step_dir(step)
        path = os.path.join(d, _STATE)
        if not os.path.exists(path):
            found = set(os.listdir(d))
            if found & set(_ORBAX_MARKERS):
                # never skipped: resuming from an older step would silently
                # drop the rounds this one holds
                raise ForeignCheckpointError(
                    f"checkpoint step {step} at {d} is an orbax step of the "
                    "JAX package ({}), which the PyTorch port cannot read; "
                    "restore it with the JAX package and convert the state "
                    "(convert.jax_state_to_torch), or point "
                    "--checkpoint_dir elsewhere".format(
                        ", ".join(sorted(found & set(_ORBAX_MARKERS)))))
            raise FileNotFoundError(f"{path}: no state file (a save cut "
                                    "short)")
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(blob, dict) or blob.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} checkpoint")
        fields: Dict[str, Any] = blob["fields"]
        names = [f.name for f in dataclasses.fields(template)]
        if sorted(fields) != sorted(names):
            raise ValueError(
                f"{path}: saved fields {sorted(fields)}, the template "
                f"({type(template).__name__}) has {sorted(names)}")
        return dataclasses.replace(template, **{
            n: _unpack(fields[n], getattr(template, n), n) for n in names})

    def restore_latest(self, template: Any, schema_hint: str = "",
                       store: Optional[Any] = None,
                       ) -> Optional[Tuple[Any, int]]:
        """The newest step that loads, shaped like ``template`` (an
        ``algo.init_state()``: its field structure, shapes and dtypes, and
        the device every tensor goes to), as ``(state, step)``; None when
        the lineage is empty.

        A step that does not load (a save cut short, a state of another
        schema, a missing or unreadable ``store_<step>.npz`` when ``store``
        is given) is logged and the next older one tried; when every step
        fails the error propagates, with ``schema_hint``. An orbax step of
        the JAX package is refused by name, never skipped. ``store``: a
        store-backed lineage's :class:`~..core.client_store.ClientStore`,
        whose rows are replaced by the step's snapshot. The restored state
        is freshly allocated: the caller owns it.

        On a client mesh every rank calls it: each reads the step in the
        single-process layout (``layout.checkpoint_template``) and keeps its
        block of the row fields (``layout.state_to_local``) and of the
        store's rows; a rank that would restore another step than rank 0
        raises."""
        steps = sorted(self.all_steps(), reverse=True)
        mesh = self.mesh
        if mesh is not None:
            from ..parallel.mesh import broadcast_value

            if broadcast_value(mesh, -1 if not steps else steps[0]) != (
                    -1 if not steps else steps[0]):
                raise RuntimeError(
                    f"checkpoint lineage {self.directory}: rank {mesh.rank} "
                    "sees other steps than rank 0")
        if not steps:
            return None
        if self.layout is not None:
            template = self.layout.checkpoint_template(template)
        last_err: Optional[Exception] = None
        for step in steps:
            try:
                state = self._load_step(step, template)
                if store is not None:
                    # the step is only as good as its row snapshot
                    store.snapshot_load(self._store_path(step))
            except ForeignCheckpointError:
                raise
            except Exception as e:
                last_err = e
            else:
                if mesh is not None and broadcast_value(mesh, step) != step:
                    raise RuntimeError(
                        f"checkpoint lineage {self.directory}: rank "
                        f"{mesh.rank} restored step {step}, rank 0 another")
                if self.layout is not None:
                    state = self.layout.state_to_local(state)
                logger.info("restored checkpoint step %d from %s", step,
                            self.directory)
                return state, step
            logger.warning(
                "checkpoint step %d at %s is unrestorable (%s: %s); "
                "falling back to the next older retained step",
                step, self.directory, type(last_err).__name__, last_err)
        hint = f" {schema_hint}" if schema_hint else ""
        raise RuntimeError(
            f"no retained checkpoint at {self.directory} is restorable "
            f"(tried steps {steps}) — if every step fails the same way, "
            "the lineage was likely written by an older framework version "
            "whose state structure no longer matches. Restart without "
            "--resume (or point --checkpoint_dir elsewhere) to begin a "
            f"fresh lineage.{hint}") from last_err

    def close(self) -> None:
        """Nothing is written in the background: saves finish in
        :meth:`save`."""
