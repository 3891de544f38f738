"""CUDA graphs of the adversarial step (:func:`t2igan_torch.train.steps.
make_gan_step`): its phases captured once and replayed on every later
step, so that the host issues a handful of graph launches a step instead
of thousands of kernels.

The step's phases (the text tower, G's forwards, each discriminator
update, G's loss, G's backward, Adam and the EMA) are captured one graph
each, in order, into one private memory pool, and replayed in the same
order: PyTorch's rule for graphs that share a pool.  Autograd crosses the
graphs as it crosses the phases of the eager step: G's backward is
captured over the autograd graph that the captures of G's forward and
loss recorded, on the tensors they left in the pool.

:class:`StepGraphs` keeps one capture, of one input shape (the trainer's
loader drops a short last batch, so every batch has the config's shape):
the first call runs the eager step, which creates the optimizers' state
and loads every kernel, and a second call of the same shapes and dtypes
captures.  A call of any other shape, once the capture stands, runs
eagerly and keeps it.  A rebound tensor (a module's parameter or buffer,
an optimizer's state or groups, as ``.to()``, an optimizer's
``load_state_dict`` or
:func:`t2igan_torch.train.checkpoint.restore_gan_payload` leave them), or
a changed hyperparameter, drops the capture, and the runner starts over.
:data:`GAN_GRAPHS` counts, always on, the steps run eagerly (``eager``),
the captures (``capture``) and the steps the graphs ran (``replay``; a
capture's own step is one).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.ops.kernels.batchnorm import BN_LAUNCHES
from t2igan_torch.utils.profiling import span

GAN_GRAPHS: "collections.Counter[str]" = collections.Counter()
"""Steps run eagerly (``eager``), captures (``capture``) and steps the
graphs ran (``replay``); reset a count by assigning 0."""

Phase = Tuple[Optional[str], Callable[[], None]]
"""A phase of the step: the span its work runs in (None: none) and the
function that does it."""


def in_span(name: Optional[str]):
    """``span(name)``, or no span for None."""
    return contextlib.nullcontext() if name is None else span(name)


class CudaGraphs:
    """The capture backend on a card: each function becomes one
    ``torch.cuda.CUDAGraph``, all of one instance in one private memory
    pool."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()

    def capture(self, fn: Callable[[], None]) -> Callable[[], None]:
        """``fn``'s kernels as a graph (``fn`` runs once, on the capture
        stream, and nothing it launches executes); returns the replay."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            fn()
        return graph.replay

    @staticmethod
    def prepare(opt: torch.optim.Optimizer, device: torch.device) -> None:
        """Make ``opt`` capturable where it can be (Adam: the step count
        and the bias correction on the device), with any step count it
        already holds moved to ``device``."""
        for group in opt.param_groups:
            if "capturable" in group:
                group["capturable"] = True
        for st in opt.state.values():
            step = st.get("step")
            if torch.is_tensor(step) and step.device != device:
                st["step"] = step.to(device)


def backend_for(device: torch.device):
    """The capture backend for ``device``: :class:`CudaGraphs` on a card,
    None (the step runs eagerly) elsewhere."""
    return CudaGraphs if device.type == "cuda" else None


class _Watch:
    """What the graphs read and write in place, as it stood when they were
    made: the modules and optimizers, each module's parameters and buffers
    (the tensor and where its data lies), each optimizer's state and
    groups and their hyperparameters (baked into the captured update).
    :meth:`holds` is False once any of them changed."""

    def __init__(self, modules: Sequence[nn.Module],
                 optimizers: Sequence[torch.optim.Optimizer],
                 bumped: Sequence[nn.Module]):
        self.modules, self.optimizers = list(modules), list(optimizers)
        self.slots = [(d, k) for m in modules for sub in m.modules()
                      for d in (sub._parameters, sub._buffers) for k in d
                      if d[k] is not None]
        self.tensors = [(d[k], d[k].data_ptr()) for d, k in self.slots]
        self.opt_state = [(o.state, o.param_groups, self._hyper(o))
                          for o in optimizers]
        self.bumped = [t for m in bumped
                       for t in (*m.parameters(), *m.buffers())]

    @staticmethod
    def _hyper(opt: torch.optim.Optimizer) -> list:
        return [{k: v for k, v in g.items() if k != "params"}
                for g in opt.param_groups]

    def holds(self, modules: Sequence[nn.Module],
              optimizers: Sequence[torch.optim.Optimizer]) -> bool:
        if len(modules) != len(self.modules) or len(optimizers) != len(
                self.optimizers):
            return False
        if not all(a is b for a, b in zip(modules, self.modules)) or \
                not all(a is b for a, b in zip(optimizers, self.optimizers)):
            return False
        for (d, k), (t, ptr) in zip(self.slots, self.tensors):
            if d.get(k) is not t or t.data_ptr() != ptr:
                return False
        return all(o.state is st and o.param_groups is groups
                   and self._hyper(o) == hyper for o, (st, groups, hyper)
                   in zip(optimizers, self.opt_state))


class _Captured:
    """The phases as graphs, their static inputs and outputs, and the
    kernel launches a replay stands for: the wrappers' counts of what the
    capture recorded, copied into their counters on every replay (a
    replay runs no Python, so nothing else counts it)."""

    def __init__(self, backend, static: Dict[str, torch.Tensor],
                 phases: Sequence[Phase], results: Callable[[], object]):
        self.static = static
        before = LAUNCHES.copy(), BN_LAUNCHES.copy()
        with span("t2igan.gan.capture"):
            self.replays = [(name, backend.capture(fn))
                            for name, fn in phases]
        self.results = results
        # The wrappers counted the launches they recorded; a replay runs
        # them, a capture runs none.
        self.launches = []
        for counter, was in zip((LAUNCHES, BN_LAUNCHES), before):
            recorded = counter - was
            counter.clear()
            counter.update(was)
            self.launches.append((counter, recorded))

    def replay(self, inputs: Dict[str, torch.Tensor]):
        """Copy ``inputs`` into the static inputs, replay every phase in
        its span and count its launches; returns the step's results."""
        for k, v in inputs.items():
            self.static[k].copy_(v)
        for name, replay in self.replays:
            with in_span(name):
                replay()
        for counter, recorded in self.launches:
            counter.update(recorded)
        return self.results()


class StepGraphs:
    """The capture of one step function, for the shapes and dtypes of its
    inputs.

    ``eager(state, inputs)`` is the step's body; ``phases(state, work)``
    its phases in order, each phase's function reading what it needs from
    the dict ``work`` (the inputs to start with) and writing what later
    phases read into it.  ``results(work)`` makes a replayed step's
    results out of the tensors the captured phases left in ``work``, which
    every replay rewrites (so the results must be copies)."""

    def __init__(self, eager: Callable, phases: Callable[..., List[Phase]],
                 results: Callable[[Dict], object]):
        self.eager, self.phases, self.results = eager, phases, results
        self.key: Optional[Hashable] = None
        self.captured: Optional[_Captured] = None
        self.watch: Optional[_Watch] = None

    def drop(self) -> None:
        """Forget the capture (its pool goes with it)."""
        self.key = self.captured = self.watch = None

    def run(self, state, inputs: Dict[str, torch.Tensor], key: Hashable,
            device: torch.device, graphed: bool,
            modules: Sequence[nn.Module],
            optimizers: Sequence[torch.optim.Optimizer],
            bumped: Sequence[nn.Module]):
        """One step of ``state`` on ``inputs``: eagerly where ``graphed``
        is False or ``device`` has no capture backend, where ``key`` (the
        inputs' shapes and dtypes) is not the previous call's and nothing
        is captured yet, and where it is not the captured one; else by the
        graphs, captured on the second call in a row of one key.
        ``modules`` and ``optimizers`` are what the step reads and updates;
        after a replay every parameter and buffer of ``bumped`` has its
        version moved, as the eager step's in-place updates move it.
        Returns what ``eager`` or ``results`` returns."""
        backend = backend_for(device) if graphed else None
        if backend is None:
            return self._eager(state, inputs, device)
        if self.watch is not None and not self.watch.holds(modules,
                                                           optimizers):
            self.drop()
        if self.watch is None:
            for opt in optimizers:
                backend.prepare(opt, device)
            self.watch = _Watch(modules, optimizers, bumped)
        if key != self.key:
            if self.captured is None:
                self.key = key  # captured on its next call
            return self._eager(state, inputs, device)
        if self.captured is None:
            static = {k: torch.empty_like(v) for k, v in inputs.items()}
            work = dict(static)
            self.captured = _Captured(backend(), static,
                                      self.phases(state, work),
                                      lambda: self.results(work))
            GAN_GRAPHS["capture"] += 1
        out = self.captured.replay(inputs)
        torch.autograd.graph.increment_version(self.watch.bumped)
        GAN_GRAPHS["replay"] += 1
        return out

    def _eager(self, state, inputs, device):
        GAN_GRAPHS["eager"] += 1
        with span("t2igan.gan.eager") if device.type == "cuda" else \
                contextlib.nullcontext():
            return self.eager(state, inputs)
