# ported from paddle_tpu/serving/engine.py (_get_prefill_exe, _get_decode_exe, _get_verify_exe, lines 1241-1406)
"""The serving dispatch as a CUDA graph: the port's counterpart of the JAX
package's AOT-compiled prefill, decode and verify executables.

A :class:`CapturedDispatch` holds one dispatch body at one shape (a decode
of ``decode_fuse`` steps, or a verify window of width W, with or without
the sampler; a prefill, or a prefix-hit resume, at one prompt bucket).
The body reads and writes only static tensors: the engine's slot-state
vectors and KV cache, updated in place, and the dispatch's own input and
output buffers. Each graph has a memory pool of its own: graphs that
shared one pool, replayed in any order across engines, failed a later
capture in cuBLAS on the H100. On the card its first run
is an eager warm-up on a side stream (a real dispatch: it allocates what
the body keeps between launches, such as the paged-attention kernel's
arrival counters of that stream, outside any graph); the second captures
the body on the same stream into a ``torch.cuda.CUDAGraph`` and replays
it, and every later run replays. On the CPU the body runs as it is. A
capture that fails raises :class:`CaptureError` naming the dispatch:
nothing runs eagerly in the graph's place.

Every capture of the port runs with Python's cyclic garbage collector
paused (:func:`gc_paused`): a CUDA graph in a dead reference cycle (an
engine and its dispatches) that the collector frees during another
graph's capture destroys its executable mid-capture, which CUDA forbids
while a stream captures; the capture is invalidated and its next kernel
fails (a cuBLAS sgemm with ``CUBLAS_STATUS_EXECUTION_FAILED`` on the
H100, after "operation not permitted when stream is capturing (function
reset)" warnings).
"""

from __future__ import annotations

import contextlib
import gc
import time
import warnings
from typing import Callable, Optional

import torch

__all__ = ["CaptureError", "CapturedDispatch", "end_failed_capture",
           "gc_paused"]


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector off for the block (a capture):
    dead cycles are freed at a collection after it, outside any capture
    (module docstring)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def end_failed_capture(stream, generators=()) -> None:
    """Take the CUDA generators out of capture mode after a capture that
    raised: ``torch.cuda.graph`` puts the default generator and the ones
    registered with the graph in capture mode when the capture begins and
    takes them out only when it ends cleanly, and a generator left in it
    raises at its next eager draw. An empty capture of them on
    ``stream`` ends the mode."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the graph is empty
        with gc_paused(), torch.cuda.graph(graph, stream=stream):
            pass
    graph.reset()


class CaptureError(RuntimeError):
    """A dispatch body could not be captured into a CUDA graph. Not a
    fault of the dispatch's requests: the engine's retry ladder lets it
    through."""


class CapturedDispatch:
    """``body()`` at one shape: eager, then captured, then replayed (on the
    card), or eager every time (``device`` on the CPU, or ``capture=False``
    — the yardstick the graphs are timed against). ``stream`` is the side
    stream of the warm-up and the capture."""

    def __init__(self, name: str, body: Callable[[], None], device,
                 stream: Optional["torch.cuda.Stream"] = None,
                 capture: bool = True):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.stream = stream
        self.capture = bool(capture) and self.device.type == "cuda"
        self.warm_left = 1
        self.graph = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        # the body's static buffers (outputs, inputs), kept with it by the
        # caller that made them
        self.out = self.logits = self.inputs = None

    def run(self) -> None:
        if not self.capture:
            self.body()
            return
        if self.warm_left > 0:
            self.warm_left -= 1
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self.body()
            cur.wait_stream(self.stream)
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1

    def _capture(self) -> None:
        t0 = time.perf_counter()
        # torch.cuda.graph empties the allocator's cache on entry; doing it
        # first makes the growth of reserved memory the graph pool's
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with gc_paused(), torch.cuda.graph(graph, stream=self.stream):
                self.body()
        except Exception as e:
            end_failed_capture(self.stream)
            raise CaptureError(
                "capturing the serving %s dispatch into a CUDA graph failed; "
                "it is not run eagerly in its place. A captured dispatch may "
                "not read a device value on the host, allocate a buffer it "
                "keeps, or change shapes: %s: %s"
                % (self.name, type(e).__name__, e)) from e
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before

    def release(self) -> None:
        """Drop the graph and with it its memory pool; the next run
        captures again (after no further warm-up)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
