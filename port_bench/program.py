"""What the benchmark takes from the program under test
(``gaussian_process_transportation_tpu_torch``): its modules and entries,
and the spans and counters that the per-layer metrics read.  Only this
module, ``kernels/``, ``entries/`` and ``faults.py`` touch the program."""
from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, Tuple

import torch
from torch import Tensor

PACKAGE = "gaussian_process_transportation_tpu_torch"


def module(name: str):
    """The program's module ``name`` (relative to the package)."""
    return importlib.import_module(f"{PACKAGE}.{name}")


def entry(path: str) -> Callable:
    """``"<module>.<attribute>"`` under the package → a function that calls
    the attribute as it is at each call, so that a fault or a span planted
    on it is seen."""
    name, _, attr = path.rpartition(".")
    mod = module(name)
    if not hasattr(mod, attr):
        raise AttributeError(f"{PACKAGE}.{name} has no entry {attr!r}")
    return lambda *a, **kw: getattr(mod, attr)(*a, **kw)


@dataclass
class Caller:
    """How a run drives one entry: ``call(targets)`` makes one timed call and
    returns (the tensor whose host read ends the call, what the checks need
    of the call); ``installed()`` is open while the window runs (a capture
    of state the entry does not return); ``own_state`` says that each call
    derives its own state (a fit from random starts), so that only the kept
    call's host read can be compared."""

    call: Callable[[Tensor], Tuple[Tensor, Dict]]
    installed: Callable[[], ContextManager] = contextlib.nullcontext
    own_state: bool = False


class Span:
    """A module attribute wrapped so that each call is a
    ``torch.profiler.record_function`` range and a pair of CUDA events.  A
    span whose attribute is missing stays empty: its metrics read nothing."""

    def __init__(self, name: str):
        self.name = name
        mod, _, self.attr = name.rpartition(".")
        self.events = []
        self.module = self.original = None
        self.present = False
        try:
            self.module = module(mod)
        except ImportError:
            return
        self.present = hasattr(self.module, self.attr)

    def install(self):
        """Wrap the attribute as it is now; ``remove`` puts that back."""
        if not self.present:
            return
        self.original = original = getattr(self.module, self.attr)
        events, label = self.events, self.name

        def wrapped(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(label):
                start.record()
                out = original(*args, **kwargs)
                end.record()
            events.append((start, end))
            return out

        setattr(self.module, self.attr, wrapped)

    def remove(self):
        if self.present:
            setattr(self.module, self.attr, self.original)

    def ms(self):
        """Each call's time between its events, in ms (after a synchronise)."""
        return [s.elapsed_time(e) for s, e in self.events]


class Capture:
    """A module attribute wrapped to keep what its last call returned: how
    a check reads what the timed path derived and does not return (the
    refit's hyperparameters)."""

    def __init__(self, name: str):
        mod, _, self.attr = name.rpartition(".")
        self.module = module(mod)
        self.original = None
        self.last = None

    @contextlib.contextmanager
    def installed(self):
        self.original = original = getattr(self.module, self.attr)

        def wrapped(*args, **kwargs):
            self.last = original(*args, **kwargs)
            return self.last

        setattr(self.module, self.attr, wrapped)
        try:
            yield
        finally:
            setattr(self.module, self.attr, original)


def counter(name: str):
    """(read, reset) of a wrapper's launch counter ``"module.function.field"``,
    or None where the program has no such counter."""
    path, _, field = name.rpartition(".")
    mod, _, fn = path.rpartition(".")
    try:
        obj = getattr(module(mod), fn)
    except (ImportError, AttributeError):
        return None
    if not hasattr(obj, field):
        return None
    return (lambda: getattr(obj, field)), (lambda: setattr(obj, field, 0))
