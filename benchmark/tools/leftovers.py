"""Run a command and list the processes it leaves running when it exits
(the logic of the program's ``tools/leftover_processes.py``, kept with the
benchmark):

    python3 benchmark/tools/leftovers.py python3 benchmark/run.py --workload ...

This process makes itself a child subreaper (Linux), so every descendant the
command orphans is re-parented here; those present when the command has
exited, and two seconds later, are printed. Exits with the command's own
code, or 1 if the command exited 0 but left a process behind."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

PR_SET_CHILD_SUBREAPER = 36


def children() -> list:
    """(pid, state, command line) of every child of this process."""
    me, out = os.getpid(), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me:
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            out.append((int(pid), fields[0], cmd[:200]))
        except OSError:
            pass
    return out


def main() -> int:
    cmd = sys.argv[1:]
    if not cmd:
        print(__doc__, file=sys.stderr)
        return 2
    if ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")
    t0 = time.perf_counter()
    rc = subprocess.call(cmd)
    left = children()
    print(f"leftovers: rc {rc} after {time.perf_counter() - t0:.1f} s; left at exit: {left}",
          file=sys.stderr, flush=True)
    time.sleep(2)
    print(f"leftovers: left 2 s later: {children()}", file=sys.stderr, flush=True)
    return rc if rc != 0 or not left else 1


if __name__ == "__main__":
    sys.exit(main())
