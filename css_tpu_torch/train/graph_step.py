"""The train step's device work replayed as CUDA graphs.

``make_train_step`` (``train/train_step.py``) hands its device work,
``device_step(state, batch, draws, scalars, use_rep_labels) -> losses``, to
a ``StepGraphs``.  On the card, each call asks ``prepare`` for a replay:

* a key is what the work's kernels depend on that the code can observe: the
  shapes and dtypes of the batch and of the draws, and ``use_rep_labels``;
* a key's first ``_WARMUP`` calls run eagerly (cuDNN's autotune and the lazy
  inits happen there), as does any call before every trained parameter has
  its momentum buffer;
* the next call captures the work once, on a side stream, into graphs that
  share one memory pool, with the call's inputs copied into buffers of the
  graphs' own (a capture runs no kernel: the replay that follows does the
  step's work);
* later calls copy their inputs into those buffers and replay.  A replay
  first checks that the state's tensors (both networks' parameters and
  buffers, the momentum buffers, the prototypes) still lie where the capture
  found them; where ``restore_checkpoint`` or a snapshot copy put new ones
  there, the key is captured again.

The capture is cut at every span's edge (``utils/profiling.py``
``cut_at_spans``), so a replay launches the graphs in turn and opens and
closes the spans between them, inside one ``css.graph`` span: the spans time
the replayed phases as they time the eager ones.

Where a capture raises (an op that synchronises with the host, for one, or
one that CUDA refuses to capture), the state is as it was (a capture runs
nothing on the device, and the ``consumed`` flag is put back; only the last
step's gradients, which no step reads, are gone), the capture's memory goes
back to the allocator, the failure is reported once as a warning, and the
step stays eager from then on.

Every tensor a graph reads before it writes it lies outside the pool: the
state, the input buffers, the step's scalars and the cached constants, all
made before the capture.  What the graphs leave in the pool (the gradients,
the losses) is rewritten by each replay before it is read, and the losses
are copied out right after it; so graphs of several keys can share the pool
and replay in any order.

The kernels' ``LAUNCHES`` counters count the wrappers' calls, so the capture's
once and a replay's not at all: a replay calls no Python of the step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Optional

import torch

from css_tpu_torch.utils.profiling import cut_at_spans, span

__all__ = ["StepGraphs"]

_WARMUP = 1         # eager calls of a key before its capture
_EMPTY = "CUDA Graph is empty"       # torch's warning for a capture with no work
_STREAMS = {}       # device index -> the capture stream


def _inputs(batch: dict, draws) -> list:
    """The batch's tensors in key order, then every field of every group of
    ``draws`` (a ``StepDraws``), None where a field is absent."""
    flat = [batch[k] for k in sorted(batch)]
    for group in dataclasses.fields(draws):
        d = getattr(draws, group.name)
        flat.extend(getattr(d, f.name) for f in dataclasses.fields(d))
    return flat


def _rebuild(batch: dict, draws, tensors: list):
    """``batch`` and ``draws`` with their tensors replaced, in ``_inputs``
    order, by ``tensors``."""
    it = iter(tensors)
    out_batch = {k: next(it) for k in sorted(batch)}
    groups = {}
    for group in dataclasses.fields(draws):
        d = getattr(draws, group.name)
        groups[group.name] = dataclasses.replace(
            d, **{f.name: next(it) for f in dataclasses.fields(d)})
    return out_batch, dataclasses.replace(draws, **groups)


def _state_tensors(state) -> list:
    opt = state.optimizer.state
    params = list(state.model.parameters())
    return (params + list(state.model.buffers()) + list(state.teacher.parameters())
            + list(state.teacher.buffers())
            + [opt.get(p, {}).get("momentum_buffer") for p in params] + [state.prototypes])


def _addresses(tensors) -> tuple:
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


def _has_momentum(state) -> bool:
    if all(g["momentum"] == 0 for g in state.optimizer.param_groups):
        return True
    opt = state.optimizer.state
    return all(opt.get(p, {}).get("momentum_buffer") is not None
               for p in state.model.parameters() if p.requires_grad)


class _Replay:
    """One key's captured work: the graphs with the span edges between them,
    the input buffers, the losses' buffer and the addresses of the state's
    tensors at the capture."""

    def __init__(self, segments, inputs, losses, addresses):
        self.segments, self.inputs, self.losses = segments, inputs, losses
        self.addresses = addresses

    def __call__(self, batch: dict, draws) -> torch.Tensor:
        torch._foreach_copy_(self.inputs, [t for t in _inputs(batch, draws) if t is not None])
        with span("css.graph"):
            opened = []
            for graph, empty, edge in self.segments:
                if not empty:
                    graph.replay()
                if edge is None:
                    continue
                if edge[0] == "enter":
                    sp = span(edge[1], edge[2])
                    sp.__enter__()
                    opened.append(sp)
                else:
                    opened.pop().__exit__(None, None, None)
        return self.losses.clone()


def _capture(fn: Callable, pool, stream) -> tuple:
    """Runs ``fn`` under a capture on ``stream`` into ``pool``, a new graph
    begun at each span edge; returns ([(graph, empty, edge or None after the
    last)], fn's result).  An empty graph is kept all the same: a graph that
    goes drops its hold on the pool, and a pool that no graph holds takes no
    further capture while its memory is in use.  The sync debug mode is
    "error" inside: an op that would synchronise raises before it calls into
    CUDA, so the capture still ends cleanly (a synchronisation that CUDA
    refuses would leave the capture, and the CUDA generators' capture state,
    open); where CUDA refuses an op all the same, ``_end_capture`` lets go of
    the pool."""
    segments, current = [], []
    device = stream.device.index

    def begin():
        current.append(torch.cuda.CUDAGraph())
        current[-1].capture_begin(pool=pool)

    def end(edge):
        graph = current.pop()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _end_capture(graph, pool, device)
        empty = any(_EMPTY in str(w.message) for w in caught)
        segments.append((graph, empty, edge))

    def cut(edge):
        end(edge)
        begin()

    stream.wait_stream(torch.cuda.current_stream())
    mode = torch.cuda.get_sync_debug_mode()
    _sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            begin()
            try:
                with cut_at_spans(cut):
                    out = fn()
                end(None)
            except BaseException:
                while current:
                    with contextlib.suppress(Exception):
                        _end_capture(current.pop(), pool, device)
                raise
    finally:
        _sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(stream)
    return segments, out


def _end_capture(graph, pool, device: int) -> None:
    """``graph.capture_end()``.  Where CUDA refused the capture (an op that
    made the legacy stream wait on the capturing one, say), ``capture_end``
    raises before it ends the pool's allocations, and the graph then never
    lets go of the pool: the memory of the capture would stay reserved for
    good.  Both are done here in that case, and the error raised."""
    try:
        graph.capture_end()
    except BaseException:
        try:
            torch._C._cuda_endAllocateToPool(device, pool)
        except RuntimeError:        # capture_end got that far: the graph lets go itself
            pass
        else:
            torch._C._cuda_releasePool(device, pool)
        raise


def _sync_debug_mode(mode) -> None:
    with warnings.catch_warnings():     # torch's note that the mode is a prototype
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)


class StepGraphs:
    """The graphs of one train step function, by key (see the module's
    docstring).  ``captures`` and ``replays`` count what it did; ``failed``
    holds the message of a capture that raised (the step is eager from then
    on)."""

    def __init__(self, device_step: Callable):
        self.device_step = device_step
        self.replays_by_key = {}
        self.eager_calls = {}
        self.failed: Optional[str] = None
        self.captures = self.replays = 0
        self.pool = None            # the memory pool of this step's graphs

    def prepare(self, state, batch: dict, draws, scalars, use_rep_labels: bool
                ) -> Optional[Callable]:
        """A replay for this call (``replay(batch, draws) -> losses``, the
        state's step work done once), capturing it first where due; None
        where the call runs eagerly."""
        if (self.failed is not None or not state.prototypes.is_cuda
                or torch.cuda.is_current_stream_capturing()):
            return None
        flat = _inputs(batch, draws)
        key = (bool(use_rep_labels),) + tuple(
            None if t is None else (tuple(t.shape), t.dtype, t.device) for t in flat)
        replay = self.replays_by_key.get(key)
        if replay is not None and replay.addresses == _addresses(_state_tensors(state)):
            self.replays += 1
            return replay
        # none yet, or the state's tensors moved: capture (again; the old
        # graphs go only after the new ones hold the pool)
        if self.eager_calls.get(key, 0) < _WARMUP or not _has_momentum(state):
            self.eager_calls[key] = self.eager_calls.get(key, 0) + 1
            return None
        replay = self._capture(state, batch, draws, flat, scalars, use_rep_labels)
        if replay is None:
            return None
        self.replays_by_key[key] = replay
        self.captures += 1
        self.replays += 1
        return replay

    def _capture(self, state, batch, draws, flat: list, scalars, use_rep_labels
                 ) -> Optional[_Replay]:
        device = state.prototypes.device
        if device.index not in _STREAMS:
            _STREAMS[device.index] = torch.cuda.Stream(device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        inputs = [torch.empty_like(t) for t in flat if t is not None]
        torch._foreach_copy_(inputs, [t for t in flat if t is not None])
        it = iter(inputs)
        s_batch, s_draws = _rebuild(batch, draws,
                                    [None if t is None else next(it) for t in flat])
        consumed = state.consumed
        # the last step's gradients go now, not at the backward as in an eager
        # step: the capture's own are made while they would still be alive
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(device)
        # a capture allocates from its pool alone, and the allocator frees no
        # cached memory while one is under way: what it holds cached (the eager
        # calls' activations, the pools of graphs that are gone) goes back first
        torch.cuda.empty_cache()
        try:
            segments, losses = _capture(
                lambda: self.device_step(state, s_batch, s_draws, scalars, use_rep_labels),
                self.pool, _STREAMS[device.index])
        except Exception as err:      # the state is as it was: nothing ran on the device
            # the message only: the traceback's frames hold the capture's tensors
            self.failed = f"{type(err).__name__}: {err}"
            self.replays_by_key.clear()
            warnings.warn(f"train step: CUDA graph capture failed ({self.failed}); the step "
                          "runs eagerly from now on", RuntimeWarning)
            return None
        finally:
            state.consumed = consumed
        return _Replay(segments, inputs, losses, _addresses(_state_tensors(state)))

