"""Fault injection, the in-round guard, robust aggregation and the
divergence watchdog with its checkpoint rollback (counterpart of
``neuroimagedisttraining_tpu/robust``)."""
from .aggregation import (
    ROBUST_AGGS,
    RobustAggregator,
    add_gaussian_noise,
    norm_diff_clipping,
    resolve_krum_f,
    robust_combine_mat,
)
from .faults import (
    FaultSpec,
    fault_trace_round,
    make_fault_fn,
    make_labelflip_fn,
    parse_fault_spec,
)
from .guard import (
    carry_if_empty,
    finite_screen,
    guarded_aggregate,
    merge_residual,
    merge_updates,
    quarantine,
)
from .recovery import RoundWatchdog, tree_finite

__all__ = [
    "ROBUST_AGGS",
    "RobustAggregator",
    "add_gaussian_noise",
    "norm_diff_clipping",
    "resolve_krum_f",
    "robust_combine_mat",
    "FaultSpec",
    "fault_trace_round",
    "make_fault_fn",
    "make_labelflip_fn",
    "parse_fault_spec",
    "carry_if_empty",
    "finite_screen",
    "guarded_aggregate",
    "merge_residual",
    "merge_updates",
    "quarantine",
    "RoundWatchdog",
    "tree_finite",
]
