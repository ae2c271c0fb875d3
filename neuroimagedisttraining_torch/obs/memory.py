"""Device-memory watermark + host-RSS sampling (counterpart of
``neuroimagedisttraining_tpu/obs/memory.py``).

Makes the card's memory budget observable instead of inferred. Per CUDA
device this process has touched, ``torch.cuda.memory_stats`` gives the
caching allocator's bytes in use and peak (``allocated_bytes.all.
current`` / ``.peak``: what ``torch.cuda.memory_allocated`` and
``max_memory_allocated`` read) and ``torch.cuda.mem_get_info`` the card's
total, the limit. Without CUDA there is one CPU entry: the process's
resident set under ``platform`` "cpu" (``source`` "host_rss"), never
under a card's name.

Host RSS comes from ``psutil`` when present, else
``resource.getrusage`` (``ru_maxrss`` is a peak, noted in ``source``).

Sampling runs at round BOUNDARIES only (the runner's record hook, every
``--obs_sample_every`` rounds) — never inside a captured round, and it
reads allocator counters only, with no device sync.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["MemoryWatermark", "device_memory", "host_rss"]


#: ``memory_stats`` keys, newest spelling first: the allocator's bytes in
#: use and its peak (a build that lacks both reports zero)
_IN_USE_KEYS = ("allocated_bytes.all.current",)
_PEAK_KEYS = ("allocated_bytes.all.peak",)


def _stat(stats: Dict[str, Any], keys) -> Optional[int]:
    for k in keys:
        if k in stats:
            return int(stats[k])
    return None


def _touched_devices(torch) -> List[int]:
    """The CUDA devices this process has allocated on (the current one
    always): a mesh rank reports its own card, and no context is made on a
    card the process never used."""
    n = torch.cuda.device_count()
    cur = torch.cuda.current_device()
    out = []
    for d in range(n):
        if d == cur or torch.cuda.memory_stats(d).get(_PEAK_KEYS[0], 0):
            out.append(d)
    return out


def device_memory() -> List[Dict[str, Any]]:
    """Per-device memory snapshot: ``{device, platform, bytes_in_use,
    peak_bytes_in_use?, bytes_limit?, source}``; on a host without CUDA
    one ``platform`` "cpu" entry holding the process's resident set."""
    import torch

    if not torch.cuda.is_available():
        rss = host_rss()
        return [{"device": 0, "platform": "cpu",
                 "bytes_in_use": int(rss["rss_bytes"]),
                 "source": "host_rss"}]
    out: List[Dict[str, Any]] = []
    for d in _touched_devices(torch):
        stats = torch.cuda.memory_stats(d)
        rec: Dict[str, Any] = {
            "device": d, "platform": "gpu",
            "bytes_in_use": _stat(stats, _IN_USE_KEYS) or 0,
            "source": "memory_stats",
        }
        peak = _stat(stats, _PEAK_KEYS)
        if peak is not None:
            rec["peak_bytes_in_use"] = peak
        rec["bytes_limit"] = int(torch.cuda.mem_get_info(d)[1])
        out.append(rec)
    return out


def host_rss() -> Dict[str, Any]:
    """Host resident-set size in bytes (+ which API produced it)."""
    try:
        import psutil

        return {"rss_bytes": int(psutil.Process().memory_info().rss),
                "source": "psutil"}
    except ImportError:
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux (bytes on macOS); this repo targets
        # Linux hosts — and it is a PEAK, not current, hence source
        return {"rss_bytes":
                int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
                * 1024,
                "source": "getrusage_peak"}
    except Exception:  # pragma: no cover - exotic host
        return {"rss_bytes": 0, "source": "unavailable"}


class MemoryWatermark:
    """Round-boundary sampler surfacing memory as registry gauges:
    ``mem_device_bytes_in_use`` (labeled per device, plus the unlabeled
    max over devices), ``mem_device_peak_bytes`` where the backend
    reports it, ``mem_host_rss_bytes``."""

    def __init__(self, registry, sample_every: int = 1):
        self._registry = registry
        self._every = max(1, int(sample_every))
        self.samples = 0
        self._extra_fn = None

    def attach_extra(self, fn) -> None:
        """Attach a zero-arg provider of extra float gauges merged into
        every :meth:`sample` (the --client_store residency ledger:
        ``mem_host_cache_bytes`` / ``mem_store_*`` / ``store_gather_ms``
        from ``ClientStore.stats``). Host-side readout only — sampled at
        round boundaries with the rest of the watermark."""
        self._extra_fn = fn

    def maybe_sample(self, round_idx: int):
        """Cadence-gated :meth:`sample`: the sampled values dict when a
        sample was taken this round, else None (the ObsSession stamps
        the dict into the round's JSONL record — the per-round series
        the leak detector in ``obs/analyze.py`` trends over)."""
        if round_idx % self._every:
            return None
        return self.sample()

    def sample(self) -> Dict[str, float]:
        reg = self._registry
        try:
            devs = device_memory()
        except Exception:  # never let telemetry kill the run
            logger.debug("device memory sampling failed", exc_info=True)
            devs = []
        in_use_max = 0
        peak_max = None
        for rec in devs:
            g = reg.gauge("mem_device_bytes_in_use").labels(
                device=rec["device"])
            g.set(rec["bytes_in_use"])
            in_use_max = max(in_use_max, rec["bytes_in_use"])
            if "peak_bytes_in_use" in rec:
                reg.gauge("mem_device_peak_bytes").labels(
                    device=rec["device"]).set(rec["peak_bytes_in_use"])
                peak_max = max(peak_max or 0, rec["peak_bytes_in_use"])
        if devs:
            reg.gauge("mem_device_bytes_in_use").set(in_use_max)
            reg.gauge("mem_device_source").labels(
                source=devs[0]["source"]).set(1)
        if peak_max is not None:
            reg.gauge("mem_device_peak_bytes").set(peak_max)
        rss = host_rss()
        reg.gauge("mem_host_rss_bytes").set(rss["rss_bytes"])
        self.samples += 1
        out = {"mem_host_rss_bytes": float(rss["rss_bytes"])}
        if devs:
            out["mem_device_bytes_in_use"] = float(in_use_max)
        if peak_max is not None:
            out["mem_device_peak_bytes"] = float(peak_max)
        if self._extra_fn is not None:
            try:
                extra = self._extra_fn()
            except Exception:  # never let telemetry kill the run
                logger.debug("extra memory gauges failed", exc_info=True)
                extra = {}
            for k, v in extra.items():
                reg.gauge(k).set(float(v))
                out[k] = float(v)
        return out
