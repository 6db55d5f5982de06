"""Every process a run starts has ended, and been waited for, before the run
prints its result and on every path out of it.

The sharded cell spawns one process a card through ``multiprocessing``,
whose spawn start method also starts a resource tracker that otherwise
lives until the command's process has exited, and a little past it.  A rank
may start compilers of its own.  ``adopt_orphans`` makes the command's
process the reaper of its orphans (Linux's ``PR_SET_CHILD_SUBREAPER``), so a
grandchild whose parent ended is handed to it and not to init;
``end_all`` ends and waits for whatever the run still has: multiprocessing's
children, the resource tracker, then every other descendant, read from
``/proc``.
"""

from __future__ import annotations

import ctypes
import multiprocessing
import os
import signal
import threading
import time
from multiprocessing import resource_tracker
from typing import Dict, List, Tuple

PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> bool:
    """Make this process the reaper of its descendants' orphans; False where
    the kernel or libc does not allow it."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def _table() -> Dict[int, Tuple[int, str]]:
    """pid -> (parent pid, state) of every process in ``/proc``."""
    table = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                s = f.read()
        except OSError:
            continue
        fields = s[s.rfind(")") + 2:].split()     # the name may hold spaces and parentheses
        table[int(d)] = (int(fields[1]), fields[0])
    return table


def descendants(pid: int = 0) -> List[int]:
    """Every process below ``pid`` (this process where 0), zombies included."""
    pid = pid or os.getpid()
    table = _table()
    below, todo = [], [pid]
    while todo:
        p = todo.pop()
        kids = [c for c, (pp, _) in table.items() if pp == p]
        below += kids
        todo += kids
    return sorted(below)


def _command(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()[:120]
    except OSError:
        return "?"


def _reap() -> None:
    """Wait for every child of this process that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _stop_tracker(grace_s: float) -> None:
    """Close multiprocessing's resource tracker's pipe and wait for it to end
    (it unlinks what is left registered); kill it past ``grace_s``."""
    rt = resource_tracker._resource_tracker
    pid = getattr(rt, "_pid", None)
    if pid is None or not hasattr(rt, "_stop"):
        return
    t = threading.Thread(target=rt._stop, daemon=True)
    t.start()
    t.join(grace_s)
    if t.is_alive():
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        t.join(grace_s)


def end_all(grace_s: float = 10.0) -> List[str]:
    """End every process this one still has below it and wait for each;
    returns the commands of those that were still running (the resource
    tracker, which is this process's to stop, is not among them)."""
    left = []
    for p in multiprocessing.active_children():
        left.append(f"{p.pid} {_command(p.pid)}")
        p.terminate()
        p.join(grace_s)
        if p.is_alive():
            p.kill()
            p.join()
    _stop_tracker(grace_s)
    running = [p for p in descendants() if _table().get(p, (0, "Z"))[1] != "Z"]
    left += [f"{p} {_command(p)}" for p in running]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in descendants():
            try:
                os.kill(p, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            _reap()
            if not descendants():
                return left
            time.sleep(0.05)
    _reap()
    return left
