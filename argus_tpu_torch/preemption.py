"""Preemption detection for training: a copy of `argus_tpu/preemption.py`.

Preemptions and evictions deliver SIGTERM with a grace window. The guard
turns that into a flag the train loop polls between steps: the loop
finishes the step in flight, writes a full train-state checkpoint and
returns, so `resume_from` (or `find_latest_checkpoint`) continues from the
exact optimizer step.

Usage:
    with PreemptionGuard() as guard:
        for batch in loader:
            ...
            if guard.requested:
                break
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager that latches termination signals into a poll-able flag.

    Installs handlers for `signals` (default SIGTERM — the cloud-preemption
    signal) on entry and restores the previous handlers on exit. Signal
    handlers can only be installed from the main thread; elsewhere (e.g. a
    test worker) the guard degrades to an always-False flag rather than
    raising, and `install_failed` records it.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self.install_failed = False

    def _handler(self, signum, frame):  # pragma: no cover - exercised via test subprocess
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                self.install_failed = True
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        return None

    @property
    def requested(self) -> bool:
        """True once a termination signal has been received."""
        return self._event.is_set()
