"""L5 experiments/CLI layer (counterpart of
``neuroimagedisttraining_tpu/experiments``).

``python -m neuroimagedisttraining_torch.experiments --algo salientgrads ...``
or the per-algorithm mains (``python -m
neuroimagedisttraining_torch.experiments.main_salientgrads ...``); add
``--device cpu`` to run on the CPU.
"""
from .config import ALGO_NAMES, build_parser, parse_args, run_identity
from .runner import build_algorithm, main, run_experiment

__all__ = [
    "ALGO_NAMES",
    "build_algorithm",
    "build_parser",
    "main",
    "parse_args",
    "run_experiment",
    "run_identity",
]
