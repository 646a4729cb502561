"""Chunks of train steps as CUDA-graph replays: the port's ``scan_steps``.

``grl_tpu`` fuses ``scan_steps = K`` train steps into one ``lax.scan``
dispatch (``grl_tpu/trainer/procedures/kv_procedure.py:236-336``,
``full_graph_procedure.py:189-219``). On the card the port captures the K
steps of a chunk into one CUDA graph, once for each shape of chunk (its
key), and replays it: one host call enqueues every kernel of the K steps.
On the CPU the same chunks run eagerly, in the same order, and so they do
on the card in a world whose backend is gloo (``capture=False``, chosen
from the backend up front): a CUDA graph can capture NCCL's collectives,
not gloo's.

:class:`CapturedSteps` runs a chunk's ``body``: the device work of its
steps, with no host read and no host-side bookkeeping, on inputs that stay
at fixed addresses (the procedures copy each chunk's data into static
tensors before it runs). On a CUDA device, for each key:

* the first chunk runs eagerly on the runner's side stream: the warm-up.
  The lazy ``nvcc`` builds, the ``ctypes`` loads, the occupancy queries and
  launch plans of the kernels, the optimizer's state and cuBLAS's
  workspaces are all made there, outside any capture;
* the second is captured (recorded, not run) and then replayed, and every
  later chunk replays the graph.

So every chunk's steps run once, from the state the chunk starts in. The
graph registers the procedure's generators, so each replay draws the next
dropout masks and DropEdge seeds, as the same steps run eagerly would. A
capture that fails raises: there is no eager fallback on the card.

A runner's graphs share one memory pool: they replay one after another on
one stream, so the temporaries of one key's steps reuse the blocks of
another's, and several keys cost the device the largest chunk's memory, not
the sum. The outputs of a replay are overwritten by the next replay of any
key.

Kernel wrappers count their launches at capture; the runner takes what a
capture recorded back out of :data:`grl_torch.ops.launches.ran` and adds it
again at every replay. Each key's warm-up and capture are timed
(:attr:`CapturedSteps.setup`). A chunk's replay is the span
``grl.chunk.replay`` (:func:`grl_torch.utils.profiling.span`) under an
active ``torch.profiler``.

A procedure also replays its single train steps (``KVProcedure``'s
``_train_fn``: an epoch's leftovers, ``scan_steps: 1``) from one-step
graphs, one a batch shape, in a second runner, the step runner
(:meth:`CapturedSteps.sharing`): its own graphs, replay count and set-up
times, on the chunk runner's stream and in its memory pool. The procedure
records a key's one-step graph (:meth:`CapturedSteps.record`) right after
the step that warms it up (recording runs nothing), so the key's second
step is a replay; a step runner's replays enter no span of their own,
since the procedure's ``grl.step.replay`` holds the step's copy-in and
launch.
"""
from __future__ import annotations

import gc
import time
from collections import Counter
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from grl_torch.ops import launches
from grl_torch.utils.profiling import span


class CapturedSteps:
    """Runs chunks of train steps, replaying one CUDA graph per key on a
    CUDA device (eager on the CPU). ``replays`` counts this runner's
    replays, each inside the span ``replay_span`` (``grl.chunk.replay``;
    none in a step runner, :meth:`sharing`); ``graphs`` holds each key's
    graph, its outputs and the launches it recorded; ``setup`` each key's
    seconds of warm-up (the eager first chunk, to its end on the device)
    and capture, and the bytes the capture added to the device's reserved
    memory."""

    def __init__(self, device: torch.device, generators: Sequence[torch.Generator], capture: bool = True):
        self.device = device
        # False where the steps' collectives cannot be captured (a gloo
        # world): every chunk then runs eagerly, on the runner's stream.
        self.capture = capture
        self.generators = tuple(generators)
        self.graphs: Dict[Hashable, Tuple[Any, Any, Counter]] = {}
        self.setup: Dict[Hashable, Dict[str, float]] = {}
        self.replays = 0
        self.replay_span: Optional[str] = "grl.chunk.replay"
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None

    def sharing(self) -> "CapturedSteps":
        """A step runner: one of other graphs on this runner's stream and in
        its memory pool, registering the same generators, with graphs,
        replays and set-up of its own; its replays enter no span."""
        runner = CapturedSteps(self.device, self.generators, self.capture)
        runner.stream, runner.pool, runner.replay_span = self.stream, self.pool, None
        return runner

    def run(self, key: Hashable, body: Callable[[], Any]) -> Any:
        """``body()``'s outputs for this chunk. After a replay they are the
        graph's static outputs, which the next replay overwrites: read or
        copy them first."""
        if self.device.type != "cuda":
            return body()
        if not self.capture:
            return self.eager(body)
        if key not in self.setup:
            start = time.perf_counter()
            outputs = self.eager(body)
            torch.cuda.synchronize(self.device)
            self.setup[key] = {"warmup_s": time.perf_counter() - start}
            return outputs
        if key not in self.graphs:
            self.graphs[key] = self._capture(key, body)
        graph, outputs, recorded = self.graphs[key]
        with span(self.replay_span):
            graph.replay()
            self.replays += 1
            launches.ran.update(recorded)
        return outputs

    def record(self, key: Hashable, body: Callable[[], Any]) -> None:
        """Captures ``key``'s graph of ``body`` now, after the key's warm-up
        (its first :meth:`run`), so that its next run replays: a capture
        runs nothing, and leaves what ``body`` assigns (a parameter's
        ``.grad``) on the graph's outputs."""
        self.graphs[key] = self._capture(key, body)

    def eager(self, body: Callable[[], Any]) -> Any:
        """``body()`` run eagerly where the runner runs its chunks (the side
        stream on a CUDA device): the warm-up, or a chunk to hold a replay
        against."""
        if self.device.type != "cuda":
            return body()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            outputs = body()
        current.wait_stream(self.stream)
        return outputs

    def _capture(self, key: Hashable, body: Callable[[], Any]) -> Tuple[Any, Any, Counter]:
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = launches.device_counts()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        # torch.cuda.graph empties the allocator's cache as it starts: empty
        # it first, so the reserved bytes read here are those it starts from.
        torch.cuda.synchronize(self.device)
        # No cyclic collection inside the capture: freeing a dead cycle's
        # page-locked host tensor there records a CUDA event on another
        # stream, which a global-mode capture forbids; the graph is then
        # invalidated (cudaErrorStreamCaptureInvalidated, seen once in a
        # full run of chip_smoke.py). Collect first, then hold the collector.
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        start = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = body()
        finally:
            if collecting:
                gc.enable()
        self.setup[key].update(capture_s=time.perf_counter() - start,
                               capture_bytes=torch.cuda.memory_reserved(self.device) - reserved)
        recorded = launches.device_counts() - before
        launches.ran.subtract(recorded)
        return graph, outputs, recorded
