"""Run logging: console config + per-run file handler (a copy of
``neuroimagedisttraining_tpu/experiments/logging_utils.py``).

Rebuilds the reference's two logger configs: the per-run ``FileHandler``
keyed by identity string (``main_sailentgrads.py:184-192,248-253``) and the
console format with a process-id prefix (``fedml_api/utils/logger.py:7-32``).
"""
from __future__ import annotations

import logging
import os
from typing import Optional


def configure_console(level: int = logging.INFO, rank: int = 0) -> None:
    fmt = (f"[rank{rank}] %(asctime)s %(levelname)s "
           "%(name)s: %(message)s")
    logging.basicConfig(level=level, format=fmt, force=False)


def add_run_file_logger(log_dir: str, identity: str,
                        level: int = logging.INFO
                        ) -> Optional[logging.Handler]:
    """Attach a FileHandler at ``<log_dir>/<identity>.log`` to the root
    logger; returns the handler (caller must ``remove_run_file_logger`` it
    when the run ends) or None when log_dir is falsy."""
    if not log_dir:
        return None
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{identity}.log")
    handler = logging.FileHandler(path)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root = logging.getLogger()
    root.addHandler(handler)
    if root.level > level or root.level == logging.NOTSET:
        root.setLevel(level)
    return handler


def remove_run_file_logger(handler: Optional[logging.Handler]) -> None:
    """Detach + close a per-run handler so sequential runs in one process
    don't cross-write each other's log files or leak descriptors."""
    if handler is None:
        return
    logging.getLogger().removeHandler(handler)
    handler.close()
