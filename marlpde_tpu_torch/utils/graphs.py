"""CUDA graphs of the training steps: the port's counterpart of the ``jax.jit``
around a step (marlpde_tpu/train/trainer.py:209-250, make_update_scan;
marlpde_tpu/envs/rollout.py:110, the macro-step scan).

The JAX package runs a generation as a few compiled programs.  Eager PyTorch
issues every operation of a step from the host: 517-589 launches for an
experience-mode update, about 930 for an episode-mode one, 91-504 for a
macro-step of the collection.  ``capture`` records one step as a CUDA graph
and ``StepGraph.replay`` issues all of it as one launch.

A step that is captured obeys three rules:
  * every tensor it reads or writes outlives the graph at a fixed address:
    the callers keep static buffers and copy new values into them, never
    replace them;
  * it makes no host-device copy and no readback, and reads no host value that
    changes between replays: such values live on the device (the update
    counter, the replay's cursor and live count);
  * its random draws come from ``torch.Generator``s registered with the graph,
    whose offsets each replay advances exactly as eager draws would, so the
    stream (and a resume) is the same with and without graphs.

``capture`` runs the step once for real on a side stream (the warm-up: the
optimizer's state, cuBLAS and cuFFT plans, the kernels' libraries), then
records it on that same stream, with Python's cyclic garbage collector held
off: a step and its ``Step`` often form a reference cycle, so an old graph is
freed whenever the collector runs, and a graph destroyed during another's
capture invalidates that capture.  Every capture of a device shares that one
stream, so the process keeps one cuBLAS workspace for it (cuBLAS keeps one
for each stream that runs a matmul).  The hand-written kernels count their launches in Python, which a
replay skips: the capture records what each wrapper counted, puts the counters
back, and every replay adds those numbers again.  Other counters that a
step's Python advances join through ``count_per_replay`` (the mesh's
all_reduces, parallel/mesh.py), and so do the named counters of the tracer
(utils/profiling.py: the kernels' launches by shape).

Each capture is a ``capture`` span of the tracer, and counts, by graph name,
into the tracer's counters: ``captures/<name>``, and at every replay
``replays/<name>`` and ``kernels/<name>``, the kernel nodes the replay ran,
counted from the captured graph itself (``nodes``; its node types by count
are kept in the tracer's ``graphs``).  A replay's host time inside the
launch, which blocks while the card's launch queue is full, goes to the
tracer's ``launched``.

Graphs are only for CUDA tensors, and a failed capture or replay raises: no
step quietly runs eagerly instead.  The callers run their steps directly where
``enabled`` is false: on the CPU, which a caller asks for explicitly, and on
the card inside ``eager()``, which comparisons of the two paths use.
``cached``/``store`` keep the last MAX_GRAPHS graphs, with the objects they
were captured against.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc

import torch

from marlpde_tpu_torch.kernels import abcn, mlp
from marlpde_tpu_torch.rl import vracer_loss
from marlpde_tpu_torch.utils import profiling

# graph replays since the last reset, of every graph
replays = 0

# the wrappers whose ``launches`` counters a replay advances
_COUNTED = (abcn, mlp, vracer_loss)
# other counters a replay advances: (module, attribute) pairs
_OTHERS: list = []
_eager_depth = 0


def enabled(device) -> bool:
    """Whether steps on ``device`` run as graph replays."""
    return torch.device(device).type == "cuda" and _eager_depth == 0


@contextlib.contextmanager
def eager():
    """Run the steps directly, on the card too, inside the block."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the calls ``capture`` makes.  The
    graph is kept after its instantiation, so that ``nodes`` can read it."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"[graphs] CUDA graphs take CUDA tensors, not {device}")
        self.device = device
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

    def register_generator_state(self, generator: torch.Generator):
        self.graph.register_generator_state(generator)

    def capture(self, fn):
        # capture_begin/_end on the shared stream, as torch.cuda.graph does,
        # without its empty_cache (and, in some versions, gc.collect) before
        # every capture, which costs more than a short step's replays save
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(side_stream(self.device)):
            self.graph.capture_begin()
            try:
                out = fn()
            finally:
                self.graph.capture_end()
        # at once, as capture_end does without keep_graph: not at the first replay
        self.graph.instantiate()
        return out

    def nodes(self, name: str) -> dict:
        """{node type: count} of the captured graph ``name``."""
        return nodes(name, self.graph.raw_cuda_graph())

    def replay(self):
        self.graph.replay()


# CUgraphNodeType (cuda.h); a child graph's nodes count as its parent's
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 5: "empty",
               6: "wait_event", 7: "event_record", 8: "ext_semas_signal",
               9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
               13: "conditional"}
_CHILD_GRAPH = 4


@functools.lru_cache(maxsize=None)
def _libcuda():
    """libcuda, bound with ctypes: a runtime cudaGraph_t is libcuda's
    CUgraph, and a process loads one libcuda whichever runtime torch
    linked."""
    lib = ctypes.CDLL("libcuda.so.1")
    ptr, size = ctypes.c_void_p, ctypes.c_size_t
    lib.cuGraphGetNodes.argtypes = [ptr, ctypes.POINTER(ptr), ctypes.POINTER(size)]
    lib.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphChildGraphNodeGetGraph.argtypes = [ptr, ctypes.POINTER(ptr)]
    for f in (lib.cuGraphGetNodes, lib.cuGraphNodeGetType, lib.cuGraphChildGraphNodeGetGraph):
        f.restype = ctypes.c_int
    return lib


def _check(status: int, call: str):
    if status != 0:
        raise RuntimeError(f"[graphs] {call} failed with CUresult {status}")


def _node_total(raw: int) -> int:
    n = ctypes.c_size_t(0)
    _check(_libcuda().cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    return n.value


# {node type: count} by (graph name, node total)
_NODES: dict = {}


def nodes(name: str, raw: int) -> dict:
    """{node type: count} of the graph ``raw`` captured as ``name``: walked
    once for each name and node total (a step captured on every call, as the
    ddp pipeline's are, costs one driver call after its first capture)."""
    key = (name, _node_total(raw))
    out = _NODES.get(key)
    if out is None:
        out = _NODES[key] = node_types(raw)
    return out


def node_types(raw: int) -> dict:
    """{node type: count} of the CUDA graph ``raw`` (a cudaGraph_t's
    address), the nodes of child graphs included."""
    cuda, n = _libcuda(), ctypes.c_size_t(0)
    _check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out, kind = {}, ctypes.c_int()
    for node in nodes[:n.value]:
        _check(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value == _CHILD_GRAPH:
            child = ctypes.c_void_p()
            _check(cuda.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            inner = node_types(child.value)
        else:
            inner = {_NODE_TYPES.get(kind.value, f"type {kind.value}"): 1}
        for name, k in inner.items():
            out[name] = out.get(name, 0) + k
    return out


# the graph type ``capture`` records into (the CPU tests substitute a stand-in)
new_graph = CudaGraph


def count_per_replay(module, name: str):
    """Have every replay add to ``module.<name>`` what the step added to it
    while it was captured, as a replay does for the kernels' launches."""
    if (module, name) not in _OTHERS:
        _OTHERS.append((module, name))


def _counters():
    return [(m, "launches") for m in _COUNTED] + _OTHERS


def _ints():
    return [getattr(m, a) for m, a in _counters()]


def _set_ints(values):
    for (m, a), n in zip(_counters(), values):
        setattr(m, a, n)


def _counts():
    """Every counter a replay advances: the module counters, in the order of
    ``_counters``, and a copy of the tracer's named counters."""
    return _ints(), dict(profiling.TRACER.counters)


def _set_counts(counts):
    ints, named = counts
    _set_ints(ints)
    profiling.TRACER.counters.clear()
    profiling.TRACER.counters.update(named)


@dataclasses.dataclass
class StepGraph:
    """A captured step.  ``out`` is its static output: every replay overwrites
    it.  ``launches`` holds the hand-written kernels' launches in one replay
    (in the order of ``_COUNTED``), ``others`` what one replay adds to the
    counters of ``count_per_replay`` (in its order), ``named`` what it adds
    to the tracer's named counters, ``kernels`` the graph's kernel nodes."""

    name: str
    graph: object
    out: object
    launches: tuple
    others: tuple = ()
    named: dict = dataclasses.field(default_factory=dict)
    kernels: int = 0

    def replay(self):
        global replays
        t0 = profiling.clock()
        try:
            self.graph.replay()
        except RuntimeError as e:
            e.add_note(f"[graphs] while replaying {self.name}")
            raise
        profiling.TRACER.launched(profiling.clock() - t0)
        _set_ints([n + k for n, k in zip(_ints(), self.launches + self.others)])
        for name, n in self.named.items():
            profiling.count(name, n)
        profiling.count(f"replays/{self.name}")
        profiling.count(f"kernels/{self.name}", self.kernels)
        replays += 1
        return self.out


# the side stream of each device that warm-ups and captures run on
_SIDE: dict = {}


def side_stream(device: torch.device):
    """The side stream of ``device`` for warm-ups and captures."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(index)
    return _SIDE[index]


def _warm_up(fn, device: torch.device):
    if device.type != "cuda":
        return fn()
    side = side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


@contextlib.contextmanager
def _collector_held():
    """Keep Python's cyclic garbage collector from running inside the block
    (an explicit ``gc.collect()`` still runs)."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def capture(name: str, fn, device, generators=()):
    """Run ``fn()`` once (the warm-up, a real step), then capture it.

    Returns (the warm-up's result, the ``StepGraph``).  ``generators`` draw
    ``fn``'s random numbers; each replay advances them.  The warm-up, the
    capture and the count of the graph's nodes are one ``capture`` span."""
    device = torch.device(device)
    with profiling.span("capture", attr=name):
        first = _warm_up(fn, device)
        graph = new_graph(device)
        for g in generators:
            graph.register_generator_state(g)
        before = _counts()
        try:
            with _collector_held():
                out = graph.capture(fn)
        except BaseException as e:
            e.add_note(f"[graphs] while capturing {name}")
            raise
        finally:
            # the capture launched nothing: what the wrappers counted is per replay
            ints, named = _counts()
            per_replay = tuple(a - b for a, b in zip(ints, before[0]))
            named = {k: n - before[1].get(k, 0) for k, n in named.items()
                     if n != before[1].get(k, 0)}
            _set_counts(before)
        types = graph.nodes(name) if hasattr(graph, "nodes") else {}
    profiling.TRACER.graphs[name] = types
    profiling.count(f"captures/{name}")
    k = len(_COUNTED)
    return first, StepGraph(name, graph, out, per_replay[:k], per_replay[k:], named,
                            types.get("kernel", 0))


class Step:
    """The calls of one step ``fn``, which takes no arguments and works on
    buffers that outlive it.  Where graphs are ``enabled`` on ``device`` (as
    they were when the ``Step`` was made), the first call runs ``fn`` for
    real and captures it (``capture``'s warm-up is that call) and every later
    call replays the graph; elsewhere every call runs ``fn`` directly."""

    def __init__(self, name: str, fn, device, generators=()):
        self.name, self.fn, self.device = name, fn, torch.device(device)
        self.generators = tuple(generators)
        self.graphed = enabled(self.device)
        self.graph = None

    def __call__(self):
        if not self.graphed:
            self.fn()
        elif self.graph is None:
            self.graph = capture(self.name, self.fn, self.device, self.generators)[1]
        else:
            self.graph.replay()


def adam(params, lr: float, eps: float = 1e-8) -> torch.optim.Adam:
    """``torch.optim.Adam`` for a step that is captured: capturable on the
    card (its step count and bias corrections on the device), with its step
    count in the parameters' dtype, where capturable Adam would keep it in
    float32 and round a float64 run's bias corrections to seven digits (the
    plain Adam computes them in float64 on the host); the plain Adam on the
    CPU, which capturable Adam does not take."""
    params = list(params)
    on_card = params[0].device.type == "cuda"
    opt = torch.optim.Adam(params, lr=lr, eps=eps, capturable=on_card)
    if on_card:
        for p in params:
            opt.state[p] = dict(step=torch.zeros((), dtype=p.dtype, device=p.device),
                                exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
    return opt


# the graphs kept, least recently used first: (key, ids, settings) -> (objects, value)
_CACHE: "collections.OrderedDict" = collections.OrderedDict()
# graphs kept at once: a generation uses two to four (the training and test
# collections, 50 updates and a remainder); each holds its buffers and
# private memory pool
MAX_GRAPHS = 8


def _settings() -> tuple:
    """The global switches a graph freezes at its capture: the float32 matmul
    precision, which --bf16 lowers for one run (device.py)."""
    return (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def cached(key, objects=()):
    """What ``store`` kept under ``key`` for these same ``objects`` (held
    alive by the cache, so no other object can take their ids) and the same
    matmul settings, or None."""
    k = (key, tuple(map(id, objects)), _settings())
    hit = _CACHE.get(k)
    if hit is None:
        return None
    _CACHE.move_to_end(k)
    return hit[1]


def store(key, objects, value):
    """Keep ``value`` (a graph and its buffers) for ``key`` and ``objects``,
    dropping the least recently used graph beyond MAX_GRAPHS."""
    _CACHE[(key, tuple(map(id, objects)), _settings())] = (tuple(objects), value)
    while len(_CACHE) > MAX_GRAPHS:
        _CACHE.popitem(last=False)


def forget(obj):
    """Drop every graph that ``store`` kept with ``obj`` among its objects."""
    for k in [k for k, (objs, _) in _CACHE.items() if any(o is obj for o in objs)]:
        del _CACHE[k]


def tensors(tree) -> list:
    """The tensors of a tree of dataclasses, dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def pointers(tree) -> tuple:
    """(address, shape, dtype) of each tensor of ``tree``: what a graph that
    reads them by address was captured against."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors(tree))


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each of its tensors, in the order of
    ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def clone(tree):
    """``tree`` with every tensor cloned into fresh, writable storage."""
    return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), tree)


@torch.no_grad()
def copy_(dst, src):
    """Copy every tensor of ``src`` into the tensor at its place in ``dst``
    (same structure, shapes and dtypes).  A source that is another
    destination's buffer is read before anything is written."""
    dsts, srcs = tensors(dst), tensors(src)
    if len(dsts) != len(srcs):
        raise ValueError(f"[graphs] copy_: {len(srcs)} tensors into {len(dsts)}")
    for d, s in zip(dsts, srcs):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"[graphs] copy_: {tuple(s.shape)} {s.dtype} into "
                             f"{tuple(d.shape)} {d.dtype}")
    held = {d.data_ptr() for d in dsts}
    srcs = [s.clone() if s.data_ptr() in held and s is not d else s
            for d, s in zip(dsts, srcs)]
    for d, s in zip(dsts, srcs):
        if s is not d:
            d.copy_(s)
