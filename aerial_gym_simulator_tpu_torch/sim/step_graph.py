"""The physics step replayed from CUDA graphs.

At 16,384 envs ``dynamics.env_step`` launches about 10,300 small kernels a
step, and the host's cost of launching them, not their device time, sets the
step's pace. ``StepGraphs.step`` captures the whole step (every substep's
control, integration and contact) in one ``torch.cuda.CUDAGraph`` and replays
it, so a step costs the host a handful of launches. The graph replays the
same kernels in the same order on the same tensors: its results are the
eager step's, bit for bit.

When. What the call shows decides. A call is replayed from a graph when its
state and action are on CUDA and no input needs a gradient (grad mode is on
and the action, a state field or a ``params`` tensor requires one). Every
other call runs the eager step unchanged: the CPU, BPTT, gradient-based
system identification and trajectory optimisation.

Key. A graph belongs to the device, the substep count (each count its own
graph), the state's generator and its shard (``utils/env_rng.shard_of``),
the shapes and dtypes of the state's fields and of the action, and every leaf
of ``params`` by identity: a record whose field is reassigned is another
key, and the cache holds each leaf, so a leaf's identity cannot be reused. A
key is captured the second time it is seen, so a ``params`` rebuilt every
step stays eager. A key whose capture fails (a host read or a
data-dependent shape inside the step) is remembered and stays eager. The
cache holds ``MAX_GRAPHS`` keys, the least recently used leaving first.

Capture. The first replayed call of a key copies the state and action into
static buffers, runs the eager step once on a side stream (lazy set-up, and
the cuBLAS workspace of the stream the capture runs on), puts the generator
back, captures the step with the generator registered
(``CUDAGraph.register_generator_state``) and replays it for the call's
result. A replay advances the generator as the eager draws do, so draws
outside the graph (resets, sensor noise, a task's draws) interleave as
before and ``rng.get_state()`` after a replay equals the eager one.

Replay. The state's fields and the action are copied into the static buffers
(one concatenation per dtype), the graph replays, and the fields the step
changed are cloned out of the graph's memory as one flat buffer per dtype
that the returned state's fields view. A later replay never changes a state
already returned. Fields the step passes through are the caller's own
tensors, as in the eager step.

``COUNTS`` counts the calls by what they ran ("captured", "replayed",
"eager"; ``dynamics.STEP_GRAPHS``).
"""

from __future__ import annotations

import dataclasses
import logging
from collections import OrderedDict

import torch

from ..utils.env_rng import shard_of
from .structs import SimState, replace

logger = logging.getLogger(__name__)

MAX_GRAPHS = 16
# calls of the step by what they ran
COUNTS = {"captured": 0, "replayed": 0, "eager": 0}
# the state's tensor fields, in record order; the action follows them
STATE_TENSORS = tuple(f.name for f in dataclasses.fields(SimState) if f.name != "rng")

_FIELD_NAMES: dict = {}      # record type -> its field names


def _field_names(rec) -> tuple:
    names = _FIELD_NAMES.get(type(rec))
    if names is None:
        names = _FIELD_NAMES[type(rec)] = tuple(f.name for f in dataclasses.fields(rec))
    return names


def _leaves(rec, out: list) -> list:
    """Every leaf of a nest of parameter records (tensors, numbers, names,
    None), in field order."""
    for name in _field_names(rec):
        v = getattr(rec, name)
        if dataclasses.is_dataclass(v):
            _leaves(v, out)
        else:
            out.append(v)
    return out


def _inputs(params, state: SimState, action: torch.Tensor):
    tensors = [getattr(state, name) for name in STATE_TENSORS]
    tensors.append(action)
    return _leaves(params, []), tensors


def _needs_grad(leaves, tensors) -> bool:
    if not torch.is_grad_enabled():
        return False
    return (any(t.requires_grad for t in tensors)
            or any(isinstance(v, torch.Tensor) and v.requires_grad for v in leaves))


def _key(state: SimState, n: int, leaves, tensors) -> tuple:
    shard = shard_of(state.rng)
    return (state.pos.device, n, id(state.rng),
            None if shard is None else (shard.offset, shard.n_local, shard.n_global),
            tuple((t.shape, t.dtype) for t in tensors), tuple(map(id, leaves)))


def needs_grad(params, state: SimState, action: torch.Tensor) -> bool:
    """Grad mode is on and the action, a state field or a ``params`` tensor
    requires a gradient."""
    return _needs_grad(*_inputs(params, state, action))


def capturable(params, state: SimState, action: torch.Tensor) -> bool:
    """The rule: the state and action on CUDA and no input needing a
    gradient."""
    return state.pos.is_cuda and action.is_cuda and not needs_grad(params, state, action)


def graph_key(params, state: SimState, action: torch.Tensor, n: int) -> tuple:
    """The cache key of a call with ``n`` substeps."""
    leaves, tensors = _inputs(params, state, action)
    return _key(state, n, leaves, tensors)


class _Packing:
    """Tensors of given shapes and dtypes laid end to end in one flat buffer
    per dtype."""

    def __init__(self, specs):
        groups: dict = {}
        for i, (shape, dtype) in enumerate(specs):
            groups.setdefault(dtype, []).append(i)
        self.count = len(specs)
        self.groups = [(dtype, idx, [specs[i][0] for i in idx],
                        [specs[i][0].numel() for i in idx]) for dtype, idx in groups.items()]

    def empty(self, device) -> list:
        return [torch.empty(sum(sizes), dtype=dtype, device=device)
                for dtype, _, _, sizes in self.groups]

    def pack(self, tensors, flats=None) -> list:
        """One concatenation per dtype, into ``flats`` if given."""
        out = []
        for g, (_, idx, _, _) in enumerate(self.groups):
            parts = [tensors[i].reshape(-1) for i in idx]
            out.append(torch.cat(parts) if flats is None else torch.cat(parts, out=flats[g]))
        return out

    def views(self, flats) -> list:
        """The tensors as views of ``flats``, in the order of the specs."""
        out = [None] * self.count
        for flat, (_, idx, shapes, sizes) in zip(flats, self.groups):
            for i, part, shape in zip(idx, flat.split(sizes), shapes):
                out[i] = part.view(shape)
        return out


class _Graph:
    """One captured step, or (``graph`` None) a key that runs eagerly."""

    def __init__(self, pins):
        self.pins = pins          # the key's leaves and generator, held
        self.graph = None
        self.pack_in = self.flats_in = None
        self.changed = self.pack_out = self.flats_out = None

    def replay(self, state: SimState, tensors) -> SimState:
        self.pack_in.pack(tensors, self.flats_in)
        self.graph.replay()
        outs = self.pack_out.views([f.clone() for f in self.flats_out])
        return replace(state, **dict(zip(self.changed, outs)))


class StepGraphs:
    """The graphs of one step function, keyed and bounded as the module says."""

    def __init__(self, counts: dict = COUNTS):
        self.counts = counts
        self.graphs: OrderedDict = OrderedDict()      # key -> _Graph
        self.seen: OrderedDict = OrderedDict()        # key -> pins, of keys seen once
        self._streams: dict = {}

    def _eager(self, eager, params, state, action, n):
        self.counts["eager"] += 1
        return eager(params, state, action, n)

    def step(self, eager, params, state: SimState, action: torch.Tensor, n: int) -> SimState:
        """``eager(params, state, action, n)``, replayed from a graph where
        the rule allows."""
        if not (state.pos.is_cuda and action.is_cuda):
            return self._eager(eager, params, state, action, n)
        leaves, tensors = _inputs(params, state, action)
        if _needs_grad(leaves, tensors):
            return self._eager(eager, params, state, action, n)
        key = _key(state, n, leaves, tensors)
        g = self.graphs.get(key)
        if g is None:
            if key not in self.seen:
                self.seen[key] = (leaves, state.rng)
                while len(self.seen) > MAX_GRAPHS:
                    self.seen.popitem(last=False)
                return self._eager(eager, params, state, action, n)
            del self.seen[key]
            g = self.graphs[key] = _Graph((leaves, state.rng))
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
            with torch.cuda.device(state.pos.device):
                out = self._capture(g, eager, params, state, action, n, tensors)
            if out is not None:
                self.counts["captured"] += 1
                return out
            return self._eager(eager, params, state, action, n)
        self.graphs.move_to_end(key)
        if g.graph is None:
            return self._eager(eager, params, state, action, n)
        self.counts["replayed"] += 1
        with torch.cuda.device(state.pos.device):
            return g.replay(state, tensors)

    def _stream(self, device) -> torch.cuda.Stream:
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    def _capture(self, g: _Graph, eager, params, state, action, n, tensors):
        """Capture ``g`` and replay it for this call -> the new state, or
        None where the step cannot be captured (``g`` then stays eager)."""
        device, rng = state.pos.device, state.rng
        pack_in = _Packing([(t.shape, t.dtype) for t in tensors])
        flats_in = pack_in.empty(device)
        pack_in.pack(tensors, flats_in)
        views = pack_in.views(flats_in)
        st = replace(state, **dict(zip(STATE_TENSORS, views)))
        act = views[-1]
        side, here = self._stream(device), torch.cuda.current_stream(device)
        before = rng.get_state()
        graph = torch.cuda.CUDAGraph()
        try:
            side.wait_stream(here)
            with torch.cuda.stream(side):
                eager(params, st, act, n)                   # warm-up
            here.wait_stream(side)
            drew = not torch.equal(rng.get_state(), before)
            rng.set_state(before)
            register = getattr(graph, "register_generator_state", None)
            if register is not None:
                register(rng)
            elif drew:
                raise RuntimeError("the step draws from its generator and this PyTorch "
                                   "build cannot register one with a CUDA graph")
            torch.cuda.synchronize(device)
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    out = eager(params, st, act, n)
                    changed = [i for i, name in enumerate(STATE_TENSORS)
                               if getattr(out, name) is not views[i]]
                    outs = [getattr(out, STATE_TENSORS[i]) for i in changed]
                    pack_out = _Packing([(t.shape, t.dtype) for t in outs])
                    flats_out = pack_out.pack(outs)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            logger.warning("the physics step runs eagerly for this key: its capture failed (%s)",
                           str(e).splitlines()[0] if str(e) else type(e).__name__)
            rng.set_state(before)
            return None
        g.graph, g.pack_in, g.flats_in = graph, pack_in, flats_in
        g.changed = [STATE_TENSORS[i] for i in changed]
        g.pack_out, g.flats_out = pack_out, flats_out
        return g.replay(state, tensors)


# the process's graphs of ``dynamics.env_step_eager``
GRAPHS = StepGraphs()
