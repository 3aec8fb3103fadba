"""Child processes of the operator entry points, for the drivers that
start them (the fleet's replica processes, a telemetry daemon).

A child's stdout and stderr go to a file, never to a pipe, so a chatty
child cannot stall on a full pipe; every wait on it has a timeout; and
``close`` kills it if it is still running, so a driver that closes its
children in a ``finally`` leaves no process behind.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence

#: the checkout's root: ``python -m gochugaru_tpu_torch...`` resolves here
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def module_argv(module: str, *args: str) -> List[str]:
    """``python -m module args...`` with this interpreter."""
    return [sys.executable, "-m", module, *map(str, args)]


class Child:
    """One child process, its output in ``log_path``."""

    def __init__(self, argv: Sequence[str], log_path: str, *, env=None,
                 cwd: Optional[str] = None, name: Optional[str] = None) -> None:
        self.argv = list(argv)
        self.name = name or " ".join(self.argv[1:4])
        self.log_path = log_path
        self._log = open(log_path, "wb")
        self.proc = subprocess.Popen(
            self.argv, stdout=self._log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, env=env, cwd=cwd or ROOT,
        )
        self.pid = self.proc.pid

    def text(self) -> str:
        with open(self.log_path, "rb") as f:
            return f.read().decode("utf-8", "replace")

    def lines(self, prefix: str = "") -> List[str]:
        return [ln for ln in self.text().splitlines() if ln.startswith(prefix)]

    def tail(self, n: int = 20) -> str:
        return "\n".join(self.text().splitlines()[-n:])

    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait_line(self, prefix: str, timeout: float, *, count: int = 1) -> str:
        """The ``count``-th line starting with ``prefix`` once the child
        has printed it; raises if the child exits first or ``timeout``
        seconds pass."""
        deadline = time.monotonic() + timeout
        while True:
            got = self.lines(prefix)
            if len(got) >= count:
                return got[count - 1]
            if not self.alive():
                raise RuntimeError(
                    f"{self.name} exited (rc {self.proc.returncode}) before"
                    f" printing {prefix!r}:\n{self.tail()}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.name} printed no {prefix!r} in {timeout:.0f}s:"
                    f"\n{self.tail()}")
            time.sleep(0.02)

    def send(self, sig: int) -> None:
        if self.alive():
            self.proc.send_signal(sig)

    def wait(self, timeout: float) -> int:
        """The exit code; kills the child if it outlives ``timeout``."""
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
            raise

    def stop(self, timeout: float, sig: int = signal.SIGINT) -> int:
        """Signal a clean stop and wait for it (killed past ``timeout``)."""
        self.send(sig)
        return self.wait(timeout)

    def close(self) -> None:
        """Kill the child if it still runs, reap it, close its log."""
        if self.alive():
            self.proc.kill()
        try:
            self.proc.wait(10)
        finally:
            self._log.close()


def close_all(children: Sequence[Child]) -> None:
    """``close`` every child, whatever the others raise."""
    err = None
    for c in children:
        try:
            c.close()
        except BaseException as e:  # noqa: BLE001 - close the rest first
            err = err or e
    if err is not None:
        raise err
