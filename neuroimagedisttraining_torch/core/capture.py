"""CUDA graphs of a round body, captured in segments.

A fused round (``algorithms/base.py``) is one Python call that runs every
local step of every client a rank trains, and a CUDA graph of it holds a
node for each kernel those steps launch. The CUDA driver does not take a
graph of any size: ResNet-18-GN's 1,600-step CIFAR round, captured whole,
crashed it at the first replay. So the body is captured as a chain of
graphs that share one memory pool: at each step boundary
(:func:`step_boundary`, which the local training loop calls after every
optimizer step) the capture closes its graph once it holds SEGMENT_NODES
nodes and opens the next one.
The chain is replayed in the order it was captured, on one stream, so a
tensor that crosses a boundary is written by one graph and read by the
next, as in the body itself. Outside a capture the boundary does nothing.
"""
from __future__ import annotations

import ctypes
from typing import Callable, List, Optional

import torch

#: the nodes one graph of a chain reaches before the next step boundary
#: closes it (the count is read from the CUDA driver at each boundary)
SEGMENT_NODES = 1 << 17

_ACTIVE: Optional["SegmentedGraph"] = None
_LIBCUDA: List[Optional[ctypes.CDLL]] = []


def _libcuda() -> Optional[ctypes.CDLL]:
    if not _LIBCUDA:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
            lib.cuStreamGetCaptureInfo_v2
            lib.cuGraphGetNodes
        except (OSError, AttributeError):
            lib = None
        _LIBCUDA.append(lib)
    return _LIBCUDA[0]


def capture_nodes(stream: torch.cuda.Stream) -> Optional[int]:
    """The nodes of the graph ``stream`` is capturing, from the CUDA driver
    (None where it cannot say)."""
    lib = _libcuda()
    if lib is None:
        return None
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    n = ctypes.c_size_t()
    if (lib.cuStreamGetCaptureInfo_v2(
            ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), None,
            ctypes.byref(graph), None, None) != 0 or status.value != 1
            or lib.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0):
        return None
    return int(n.value)


def step_boundary() -> None:
    """A point between two local steps: the capture in progress, if any,
    closes its graph here once it holds SEGMENT_NODES nodes (or when the
    CUDA driver cannot count them) and goes on in a new one."""
    if _ACTIVE is not None:
        _ACTIVE.boundary()


class SegmentedGraph:
    """``fn()`` captured on ``stream`` as a chain of CUDA graphs in one
    memory pool, cut at the step boundaries it passes (module docstring).
    ``out`` is ``fn``'s output, which each :meth:`replay` rewrites in
    place; ``nodes`` the node count of each graph of the chain.

    A capture error propagates as the ``RuntimeError`` it is."""

    def __init__(self, fn: Callable, stream: torch.cuda.Stream):
        global _ACTIVE
        self.stream = stream
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.nodes: List[Optional[int]] = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with torch.cuda.stream(stream):
            self._open()
            _ACTIVE = self
            try:
                self.out = fn()
            except BaseException:
                _ACTIVE = None
                self.graphs[-1].capture_end()
                raise
            _ACTIVE = None
            self._close(capture_nodes(stream))

    def _open(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(
            pool=self.graphs[0].pool() if self.graphs else None)
        self.graphs.append(graph)

    def _close(self, nodes: Optional[int]) -> None:
        self.nodes.append(nodes)
        self.graphs[-1].capture_end()

    def boundary(self) -> None:
        n = capture_nodes(self.stream)
        if n is None or n >= SEGMENT_NODES:
            self._close(n)
            self._open()

    def replay(self) -> None:
        for graph in self.graphs:
            graph.replay()

    def reset(self) -> None:
        for graph in self.graphs:
            graph.reset()
        self.graphs = []
