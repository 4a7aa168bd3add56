"""One CUDA graph captured from an eager function: the mechanics that
``solvers.CapturedSolve`` (the timed HPCG solve), ``serve.CapturedDecode``
(the LM decode step), ``serve.CapturedLane`` (the engine's lanes) and
``train.CapturedTrainStep`` (the one-device train step) share, the port's
form of the reference's ``jax.jit``.

:func:`capture` runs ``fn`` once eagerly on a side stream (the warm-up,
where every first-call cache is built, cuBLAS gets the stream's workspace
and the host may read the device), then captures one more call under
``torch.no_grad()`` into a ``torch.cuda.CUDAGraph`` on that stream and
instantiates it. The capture records the call's kernels and runs none of
them. Entering the capture empties the allocator's cache
(``torch.cuda.graph`` does), so what the warm-up allocated and freed goes
back to the device before the graph's private pool asks for its own.
A host read inside ``fn`` makes the capture raise :class:`CaptureError`;
nothing runs eagerly in its place. Python runs only at the warm-up and the
capture: launch counters, the health registry and any recorder count
those two calls, never a replay.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple

import torch


class CaptureError(RuntimeError):
    """A CUDA graph capture failed: the captured work read the host, or ran
    an operation a capture does not take."""


class Captured(NamedTuple):
    """A captured and instantiated graph.

    Attributes:
        graph: the ``torch.cuda.CUDAGraph``; ``graph.replay()`` runs it.
        out: what ``fn`` returned at the capture (static tensors that every
            replay writes).
        capture_s: seconds of the capture (``fn``'s Python run included).
        instantiate_s: seconds of ``cudaGraphInstantiate``.
        nodes: the graph's node count (kernels, copies, memsets).
        launches: each kernel wrapper's launches during the capture, the
            graph's hand-written kernel launches a replay.
        warm: what ``fn`` returned at the warm-up, where asked for
            (``keep_warm``), else ``None``.
    """

    graph: Any
    out: Any
    capture_s: float
    instantiate_s: float
    nodes: int
    launches: Dict[str, int]
    warm: Any = None

    def stats(self) -> dict:
        return {"capture_s": self.capture_s, "instantiate_s": self.instantiate_s,
                "nodes": self.nodes, "launches": dict(self.launches)}


def capture(fn: Callable[[], Any], device: torch.device, what: str,
            keep_warm: bool = False) -> Captured:
    """Warm ``fn()`` up on a side stream of ``device``, capture one more
    call in a CUDA graph and instantiate it. ``keep_warm`` keeps what the
    warm-up returned (a train step's metrics: its warm-up is a real step);
    otherwise it is freed before the capture.

    Raises:
        CaptureError: the capture failed (a host read, an operation a
            capture does not take); ``what`` names the captured work.
    """
    from repro_torch.kernels import graph_nodes, launch_counts

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), torch.cuda.stream(side):
        warm = fn()
    if not keep_warm:
        warm = None
    torch.cuda.current_stream(device).wait_stream(side)
    before = launch_counts()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    caller = torch.cuda.current_stream(device)
    t0 = time.perf_counter()
    try:
        with torch.no_grad(), torch.cuda.graph(graph, stream=side):
            out = fn()
    except RuntimeError as e:
        # a failed capture_end leaves the capture stream current, and the
        # device's default generator marked as capturing (the capture's
        # epilogue never ran), so every later random draw on the device
        # would raise: give the generator a fresh copy of its state
        torch.cuda.set_stream(caller)
        gen = torch.cuda.default_generators[caller.device.index]
        gen.graphsafe_set_state(gen.clone_state())
        raise CaptureError(f"capturing {what} in a CUDA graph failed: "
                           f"{type(e).__name__}: {e}") from e
    capture_s = time.perf_counter() - t0
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    nodes = graph_nodes(graph.raw_cuda_graph())
    t0 = time.perf_counter()
    graph.instantiate()
    return Captured(graph, out, capture_s, time.perf_counter() - t0, nodes, launches, warm)
