"""Stall watchdog: detect a wedged device call and fail loudly (a copy of
the JAX package's ``utils/stall.py``).

A device call can block the main thread forever in a C extension at 0%
CPU, unreachable from Python.  The wedged thread cannot detect its own
hang, so a daemon thread watches a heartbeat the work loop updates:

- no heartbeat for the active timeout -> log CRITICAL, then either
  re-exec this exact command (``respawn=True`` and
  ``BS_STALL_RESPAWN`` (default 1), bounded by
  ``BS_STALL_MAX_RESPAWNS`` (default 3) via a respawn-count env var;
  ``os.execv`` from any thread replaces every thread including the
  wedged one) or ``os._exit(113)`` so an outer driver can restart.
- two-phase timeouts: ``initial_timeout_s`` applies until the FIRST
  heartbeat (cold remote compiles legitimately take minutes to tens
  of minutes), then ``steady_timeout_s`` applies.

Checkpoint/flush from the watchdog is impossible by construction (any
device call would wedge too) — keep persistent progress (checkpoints,
tile writes) frequent enough that losing the tail is acceptable.
Exit code 113 is the contract with callers.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

logger = logging.getLogger(__name__)

EXIT_CODE = 113


class StallWatchdog:
    def __init__(
        self,
        initial_timeout_s: float,
        steady_timeout_s: float = None,
        label: str = "work",
        respawn: bool = False,
    ):
        self.initial_timeout_s = initial_timeout_s
        self.steady_timeout_s = (
            initial_timeout_s if steady_timeout_s is None
            else steady_timeout_s
        )
        self.label = label
        self.respawn = respawn
        self._last = time.monotonic()
        self._beats = 0
        self._tag = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"bs-stall-watchdog-{label}",
            daemon=True,
        )

    def start(self):
        self._thread.start()
        return self

    def beat(self, tag=None):
        self._tag = tag
        self._beats += 1
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    @property
    def _timeout(self) -> float:
        return (
            self.initial_timeout_s if self._beats == 0
            else self.steady_timeout_s
        )

    # separated so tests can observe the decision without dying
    def _die(self):
        respawns = int(os.environ.get("BS_STALL_RESPAWN_COUNT", "0"))
        max_respawns = int(os.environ.get("BS_STALL_MAX_RESPAWNS", "3"))
        what = (
            f"{self.label} stalled >{self._timeout:.0f}s at "
            f"{self._tag!r} (beats {self._beats}; wedged relay "
            "dispatch or dead relay?)"
        )
        if (
            self.respawn
            and os.environ.get("BS_STALL_RESPAWN", "1") == "1"
            and respawns < max_respawns
        ):
            os.environ["BS_STALL_RESPAWN_COUNT"] = str(respawns + 1)
            if sys.argv[0].endswith("__main__.py"):
                argv = (
                    [sys.executable, "-m", "bootstrapper_torch"]
                    + sys.argv[1:]
                )
            else:
                argv = [sys.executable] + sys.argv
            logger.critical(
                "%s — re-executing %r (respawn %d/%d)",
                what, argv, respawns + 1, max_respawns,
            )
            os.execv(sys.executable, argv)
        logger.critical(
            "%s — exiting %d for the caller to restart (respawn "
            "%s, %d/%d used)",
            what, EXIT_CODE,
            "enabled" if self.respawn else "disabled",
            respawns, max_respawns,
        )
        os._exit(EXIT_CODE)

    def _run(self):
        while not self._stop.wait(
            max(1.0, min(30.0, self.steady_timeout_s / 4))
        ):
            if time.monotonic() - self._last > self._timeout:
                self._die()
                return  # only reachable when _die is stubbed in tests
