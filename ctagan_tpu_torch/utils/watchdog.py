"""Stall watchdog + crash/wedge supervisor of the port
(``ctagan_tpu/utils/watchdog.py``, copied; the reference has none).

The failure mode it covers (seen on the JAX package's accelerator): a long
training run wedges inside a device call — the main thread parks in
a futex wait, the log stops growing, CPU stays alive. No in-process
recovery is possible (the wedged call never returns), so the playbook is
kill + resume from the newest checkpoint. These two pieces automate it:

- ``Watchdog``: a daemon thread armed with a heartbeat. The training loop
  beats once per step (and around eval); if no beat lands for
  ``timeout_s`` the watchdog reports and hard-exits the process with
  ``STALL_EXIT_CODE`` (``os._exit`` — a wedged runtime cannot run atexit
  handlers or flush a normal ``sys.exit`` through a held lock).
- ``supervise()``: re-runs a training command in a child process until it
  succeeds, injecting ``resume: true`` after the first attempt so every
  retry continues from the newest checkpoint. Any non-zero exit
  (stall-kill, crash, OOM-kill) triggers a retry up to ``max_restarts``.

Wire-up: config ``stall_timeout`` arms the watchdog inside the trainers'
``train()`` (paused around the first step, which on the card builds the
kernels with nvcc, and around validation); ``python -m ctagan_tpu_torch
--supervise N`` wraps the whole run.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

STALL_EXIT_CODE = 42


class Watchdog:
    """Heartbeat-armed stall detector.

    ``beat()`` is safe to call from any thread at any rate. When no beat
    arrives within ``timeout_s``, ``on_stall`` runs once (default: print +
    ``os._exit(STALL_EXIT_CODE)``). ``pause()``/``resume()`` bracket
    legitimately slow regions (the first step, which on the card builds the
    kernels with nvcc, and validation); a paused watchdog never fires.
    """

    def __init__(
        self,
        timeout_s: float,
        on_stall: Optional[Callable[[], None]] = None,
        poll_s: Optional[float] = None,
    ):
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall or self._default_on_stall
        self.poll_s = poll_s if poll_s is not None else min(5.0, timeout_s / 4)
        self._last = time.monotonic()
        self._paused = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_on_stall(self):
        print(
            f"[watchdog] no heartbeat for {self.timeout_s:.0f}s — assuming a "
            "wedged device call; exiting for the supervisor to resume "
            f"(exit code {STALL_EXIT_CODE})",
            file=sys.stderr,
            flush=True,
        )
        os._exit(STALL_EXIT_CODE)

    # -- heartbeat / pause ---------------------------------------------------
    def beat(self):
        with self._lock:
            self._last = time.monotonic()

    def pause(self):
        """Suspend stall detection (re-entrant)."""
        with self._lock:
            self._paused += 1

    def resume(self):
        with self._lock:
            self._paused = max(0, self._paused - 1)
            self._last = time.monotonic()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="ctagan-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                stalled = (
                    self._paused == 0
                    and time.monotonic() - self._last > self.timeout_s
                )
            if stalled:
                self.on_stall()
                return


def supervise(
    argv: List[str],
    max_restarts: int = 3,
    resume_flag: str = "--resume",
    run: Optional[Callable[[List[str]], int]] = None,
) -> int:
    """Run ``argv`` (a full command line) until it exits 0, re-launching
    with ``resume_flag`` appended after the first attempt. Returns the final
    exit code. ``run`` is injectable for tests (defaults to subprocess)."""
    if run is None:
        run = lambda cmd: subprocess.run(cmd).returncode
    attempt = 0
    while True:
        cmd = list(argv)
        if attempt > 0 and resume_flag and resume_flag not in cmd:
            cmd.append(resume_flag)
        code = run(cmd)
        if code == 0:
            return 0
        attempt += 1
        if attempt > max_restarts:
            print(
                f"[supervise] giving up after {max_restarts} restarts "
                f"(last exit {code})",
                file=sys.stderr,
                flush=True,
            )
            return code
        print(
            f"[supervise] attempt {attempt} exited {code} "
            f"({'stall-kill' if code == STALL_EXIT_CODE else 'crash'}) — "
            "restarting with resume",
            file=sys.stderr,
            flush=True,
        )
