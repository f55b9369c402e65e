# ported from paddle_tpu/imperative/jit.py
"""Dygraph → captured execution: ``imperative.jit`` and ``jit_train``.

The reference's dygraph runs one kernel per op from Python (tracer.cc),
and so does the port's: each op is a few kernel launches and its Python.
The JAX package closes that gap with ``jax.jit``; here the step is
captured once into a CUDA graph and replayed:

- ``jit(layer)`` captures the Layer's forward (under ``no_grad``: its
  outputs are ``stop_gradient``) once per input signature, after one
  warm-up forward on a side stream; each call copies the inputs into the
  graph's static tensors, replays, and hands out copies of the outputs.
  A forward that writes state (BatchNorm in train mode) writes it in the
  warm-up and in every replay: put such a layer in eval mode first.
- ``jit_train(loss_fn, layer, optimizer)`` captures a FULL train step —
  forward, backward (``torch.autograd.grad``) and the optimizer's own
  eager update — as one CUDA graph. The first call runs one eager step
  (it builds lazily-sized layers and the optimizer's slots), as in the
  JAX package. Parameters, buffers (BatchNorm's running statistics) and
  the optimizer's slots are updated in place in the tensors the graph
  captured, so the Layer and the optimizer see every replay's result.
  Random ops draw from the tracer's generator, registered with the graph:
  each replay moves its state on as an eager step would, so masks differ
  per step and a replayed step draws what the same eager step draws.

Both raise when the capture fails (nothing runs eagerly in its place),
and pause Python's cyclic collector during a capture (``gc_paused``; a
failed one ends the generators' capture mode, ``end_failed_capture``).
On ``CPUPlace()`` both run the eager step, because that is what the
caller asked for; ``captured`` on the returned callable says which of the
two the last call did.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..serving.captured import end_failed_capture, gc_paused
from .layers import Layer
from .tracer import VarBase, _as_tensor, current_tracer

__all__ = ["jit", "jit_train"]


def _tensors(inputs):
    return [x.value.detach() if isinstance(x, VarBase) else _as_tensor(x)
            for x in inputs]


def _signature(tensors):
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _map(out, fn):
    if isinstance(out, (tuple, list)):
        return type(out)(_map(o, fn) for o in out)
    return fn(out)


def _capture(body, stream, generators):
    """One CUDA graph of ``body()`` on ``stream``; its outputs."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    try:
        with gc_paused(), torch.cuda.graph(graph, stream=stream):
            out = body()
    except Exception as e:
        graph.reset()
        end_failed_capture(stream, generators)
        raise RuntimeError(
            "imperative: capturing the step into a CUDA graph failed; it is "
            "not run eagerly in its place. A captured step may not read a "
            "device value on the host or change shapes: %s: %s"
            % (type(e).__name__, e)) from e
    return graph, out


def _tracer(what):
    """The guard's tracer; ``what`` raises outside ``guard()`` (it would
    not know its device)."""
    tracer = current_tracer()
    if tracer is None:
        raise RuntimeError("imperative.%s runs in imperative mode only "
                           "(inside paddle_tpu_torch.imperative.guard())"
                           % what)
    return tracer


def _generators(tracer):
    gen = tracer._gen
    return [gen] if gen.device.type == "cuda" else []


def jit(target: Any) -> Callable:
    """Capture a dygraph ``Layer`` (or a function over VarBase/tensors).

    >>> mlp = MyMLP("mlp")
    >>> fast = imperative.jit(mlp)
    >>> y = fast(x)          # first call captures, later calls replay
    """
    fwd = target.forward if isinstance(target, Layer) else target
    graphs: Dict[Any, Any] = {}

    def run(tensors):
        with torch.no_grad():
            return fwd(*[VarBase(t, stop_gradient=True) for t in tensors])

    def wrapper(*inputs):
        tracer = _tracer("jit")
        if isinstance(target, Layer) and not target._built:
            # lazily-built layers (FC etc.) create params on first forward;
            # one eager call makes the parameter list final first
            target(*inputs)
        tensors = _tensors(inputs)
        if tracer.device.type != "cuda":
            wrapper.captured = False
            return _map(run(tensors), lambda o: VarBase(
                o.value.detach(), stop_gradient=True))
        sig = _signature(tensors)
        entry = graphs.get(sig)
        if entry is None:
            static = [t.clone() for t in tensors]
            stream = torch.cuda.Stream(tracer.device)
            stream.wait_stream(torch.cuda.current_stream(tracer.device))
            with torch.cuda.stream(stream):
                run(static)  # warm-up outside the capture
            torch.cuda.current_stream(tracer.device).wait_stream(stream)
            graph, out = _capture(lambda: run(static), stream,
                                  _generators(tracer))
            entry = graphs[sig] = (graph, static, out)
        graph, static, out = entry
        for s, t in zip(static, tensors):
            s.copy_(t)
        graph.replay()
        wrapper.captured = True
        return _map(out, lambda o: VarBase(o.value.clone(), stop_gradient=True))

    wrapper.captured = False
    return wrapper


def jit_train(loss_fn: Callable, layer: Layer, optimizer) -> Callable:
    """Capture a dygraph train step as ONE CUDA graph.

    ``loss_fn(*inputs) -> scalar-loss VarBase`` is dygraph code over
    ``layer`` (any registered ops). Returns ``step(*inputs) -> loss
    VarBase``; each call runs forward + backward + update, updating
    ``layer.parameters()``, its buffers and the optimizer's accumulators
    in place.

    >>> step = imperative.jit_train(
    ...     lambda img, lbl: F.mean(F.softmax_with_cross_entropy(mlp(img), lbl)),
    ...     mlp, fluid.optimizer.Adam(1e-3))
    >>> for img, lbl in batches:
    ...     loss = step(img, lbl)

    The FIRST call runs one eager step (on the card on the side stream the
    graph is then captured on); the second captures and replays, and the
    later ones replay. Mixing ``step()`` with a manual ``loss._backward()``
    over the same parameters in the same iteration is a HARD ERROR: the
    step computes its own gradients and would silently ignore the eager
    tape's accumulated ``.grad``. ``clear_gradient()`` the parameters
    first if the manual pass was intentional.
    """
    state: Dict[str, Any] = {"graphs": {}, "step": 0, "stream": None}

    def _params():
        ps = [p for p in layer.parameters() if p.trainable]
        return sorted(ps, key=lambda p: p.name)

    def body(tensors):
        """forward, backward and the update; the loss (detached)."""
        ins = [VarBase(t, stop_gradient=True) for t in tensors]
        loss = loss_fn(*ins)
        ps = _params()  # after the forward: it builds lazily-sized layers
        grads = torch.autograd.grad(
            loss.value, [p.value for p in ps], torch.ones_like(loss.value),
            allow_unused=True)
        for p, g in zip(ps, grads):
            p._grad = torch.zeros_like(p.value) if g is None else g
        optimizer._imperative_minimize(None, parameter_list=ps)
        for p in ps:
            p._grad = None
        return loss.value.detach()

    def step(*inputs):
        # Same-tape mixing guard: a manual backward() since the last step
        # left gradients the step would silently ignore.
        stale = [p.name for p in _params() if p._grad is not None]
        if stale:
            raise RuntimeError(
                "imperative.jit_train: parameter(s) %s carry gradients from "
                "a manual backward() on the same tape; jit_train's step "
                "computes its own gradients and would silently ignore "
                "them. Run either the step OR manual "
                "backward()+minimize() per iteration — or clear_gradient() "
                "first if the manual pass was intentional." % stale)
        tracer = _tracer("jit_train")
        tensors = _tensors(inputs)
        dev = tracer.device
        state["step"] += 1
        if dev.type != "cuda":
            step.captured = False
            return VarBase(body(tensors), stop_gradient=True)
        if state["stream"] is None:
            state["stream"] = torch.cuda.Stream(dev)
        stream = state["stream"]
        cur = torch.cuda.current_stream(dev)
        sig = _signature(tensors)
        entry = state["graphs"].get(sig)
        if state["step"] == 1:
            # warm-up: one true eager step finalizes params + slots, on
            # the stream the capture then uses
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                loss = body(tensors)
            cur.wait_stream(stream)
            step.captured = False
            return VarBase(loss, stop_gradient=True)
        if entry is None:
            static = [t.clone() for t in tensors]
            stream.wait_stream(cur)
            graph, loss = _capture(lambda: body(static), stream,
                                   _generators(tracer))
            cur.wait_stream(stream)
            entry = state["graphs"][sig] = (graph, static, loss)
        graph, static, loss = entry
        for s, t in zip(static, tensors):
            s.copy_(t)
        graph.replay()
        step.captured = True
        return VarBase(loss.clone(), stop_gradient=True)

    step.captured = False
    step._jit_state = state
    return step
