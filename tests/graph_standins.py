"""Stand-ins for a CUDA graph, so that the CPU tests can drive the port's
graphed paths (utils/graphs.py) without a card.

``Replayed`` behaves as a captured step would for everything the CPU can
see: its capture runs nothing, and every replay runs the step under
``CaptureRules``, which refuses what a CUDA capture refuses (a readback, a
host-to-device copy, an output whose size depends on the data) and checks that
every replay issues the same operations on the same shapes with the same host
values, as a graph replays them.  ``Counted`` runs the step's Python once, at
the capture, as a CUDA capture does, and nothing at a replay.
"""

from __future__ import annotations

import os

import torch
from torch.overrides import TorchFunctionMode

from marlpde_tpu_torch.utils import graphs

# what makes the host wait for the device or copies to it
_SYNCS = {"item", "tolist", "__bool__", "__int__", "__float__", "__index__", "nonzero",
          "argwhere", "numpy", "cpu", "masked_select", "unique", "unique_consecutive",
          "repeat_interleave", "_local_scalar_dense"}
_FROM_HOST = {"tensor", "as_tensor", "asarray", "from_numpy", "new_tensor"}
_OPTIM = os.sep + os.path.join("torch", "optim") + os.sep


def _from_torch_optim() -> bool:
    """The CPU's plain Adam reads its step count on the host; the card's
    capturable Adam, which the graphs capture, does not."""
    import sys
    f = sys._getframe(2)
    while f is not None:
        if _OPTIM in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in x.items())
    if isinstance(x, (int, float, bool, str, type(None), torch.dtype, torch.device)):
        return repr(x)
    return type(x).__name__


class CaptureRules(TorchFunctionMode):
    """Raise on what a CUDA stream capture refuses, and record each
    operation's name, shapes and host values into ``trace``."""

    def __init__(self):
        super().__init__()
        self.trace = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if not _from_torch_optim():
            if name in _SYNCS:
                raise RuntimeError(f"capture rules: {name} reads the device from the host")
            data = args[1] if name == "new_tensor" else (args[0] if args else None)
            if name in _FROM_HOST and not isinstance(data, torch.Tensor):
                raise RuntimeError(f"capture rules: {name} copies host data to the device")
            if name == "__getitem__" and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if isinstance(args[1], tuple) else (args[1],))):
                raise RuntimeError("capture rules: a boolean index sizes its output by the data")
            self.trace.append((name, _sig(args), _sig(kwargs)))
        return func(*args, **kwargs)


def _copy_out(dst, src):
    if isinstance(dst, dict):
        dst.clear()
        dst.update(src)


class Replayed:
    """A captured step whose replays run it under ``CaptureRules``."""

    def __init__(self, device):
        self.fn, self.trace, self.generators = None, None, []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def capture(self, fn):
        self.fn = fn
        self.out = {}
        return self.out

    def replay(self):
        counts = graphs._counts()
        rules = CaptureRules()
        try:
            with rules:
                out = self.fn()
        finally:
            graphs._set_counts(counts)
        if self.trace is None:
            self.trace = rules.trace
        elif rules.trace != self.trace:
            diff = next(i for i, (a, b) in enumerate(zip(rules.trace, self.trace)) if a != b)
            raise RuntimeError(f"capture rules: replay differs from the first at op {diff}: "
                               f"{rules.trace[diff]} against {self.trace[diff]}")
        if out is not None:
            _copy_out(self.out, out)


class Counted:
    """A captured step as the kernels' counters see it: its Python runs once,
    at the capture, and never at a replay."""

    def __init__(self, device):
        self.replays = 0

    def register_generator_state(self, generator):
        pass

    def capture(self, fn):
        with CaptureRules():
            return fn()

    def replay(self):
        self.replays += 1


def use(monkeypatch, stand_in=Replayed):
    """Route the port's graphed paths through ``stand_in`` on the CPU."""
    monkeypatch.setattr(graphs, "new_graph", stand_in)
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
