"""Dispatch/drain pipeline with one writer thread.

The analog of the reference's BUFFER_SLOTS circular buffer and its
asynchronous write queue (reference: main_aux_functions.h:5,
main.cpp:886-898): ``dispatch`` (device work and readback) runs on the
calling thread, ``drain`` (host export) on one writer thread, so the drain
of item i runs while item i+1 is dispatched.  At most one drain is in
flight, so the results of two items are held at once.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def pipelined(items: Iterable[T], dispatch: Callable[[T], R],
              drain: Callable[[T, R], None]) -> None:
    """``dispatch`` each item here, ``drain`` it on the writer thread.
    Drains run in item order; an exception in one is raised here before
    the next drain starts."""
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="drain") as writer:
        pending: Future | None = None
        for it in items:
            result = dispatch(it)
            if pending is not None:
                pending.result()
            pending = writer.submit(drain, it, result)
        if pending is not None:
            pending.result()
