"""What the kernel wrappers and the counting collectives tell a dry-run.

A dry-run (``launch/dryrun.py``) runs one rank's step on the ``meta``
device, where nothing is computed: each kernel wrapper's ``meta`` branch
returns empty outputs of the right shapes and reports the work its kernel
would do through :func:`report`, and the counters of
``roofline/analysis.py`` listen (:func:`listening`).  A wrapper's
``launches`` count is not touched there: nothing is launched.

:func:`quiet` marks the operations a stand-in makes to give its outputs
values (``models/sharding.py``'s ``CountingGroup`` filling a gather's
parts on a real device): they are not the rank's work, and the counters
skip what runs inside it.
"""
from __future__ import annotations

import contextlib

_listeners: list = []
_quiet = [0]


def report(name: str, flops: float, nbytes: float) -> None:
    """Kernel ``name`` would do ``flops`` operations and move ``nbytes``
    (each input read once, each output written once): tell every
    listener (``listener.kernel(name, flops, nbytes)``)."""
    for listener in _listeners:
        listener.kernel(name, flops, nbytes)


@contextlib.contextmanager
def listening(listener):
    """Have ``listener`` hear every :func:`report` made inside."""
    _listeners.append(listener)
    try:
        yield listener
    finally:
        _listeners.remove(listener)


@contextlib.contextmanager
def quiet():
    """Operations run inside are a stand-in's, not the rank's work."""
    _quiet[0] += 1
    try:
        yield
    finally:
        _quiet[0] -= 1


def is_quiet() -> bool:
    return _quiet[0] > 0


def nbytes(*tensors) -> int:
    """The bytes of the tensors given (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
