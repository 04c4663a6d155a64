"""Termination-signal detection (paper: "deteccao de sinais de terminacao").

Schedulers (SLURM preemption, spot/preemptible VMs, kubelet eviction) send
SIGTERM/SIGUSR1 before killing a job.  ``TerminationSignal`` latches the
signal so the BSP coordinator can take a final checkpoint at the next step
boundary and exit cleanly — compiled steps are atomic w.r.t. the handler
(the flag is only read between supersteps), which sidesteps the atomicity
problem the paper hit in the FWI codebase.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional


class TerminationSignal:
    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGUSR1)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._received: Optional[int] = None
        self._prev_handlers = {}
        self._installed = False

    def install(self):
        for s in self.signals:
            self._prev_handlers[s] = signal.signal(s, self._handler)
        self._installed = True
        return self

    def _handler(self, signum, frame):
        self._received = signum
        self._event.set()

    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def received(self) -> Optional[int]:
        return self._received

    def reset(self):
        self._event.clear()
        self._received = None

    def uninstall(self):
        if not self._installed:
            return
        for s, h in self._prev_handlers.items():
            signal.signal(s, h)
        self._installed = False
