"""Peak of this process's resident set over a block.

Sampled every 20 ms from ``/proc/<pid>/statm``, as ``_RssPeak`` in
``chip_smoke.py`` (commit fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91) does,
but by a process of its own (``python rss.py <pid>``), not by a thread of
the measured one: each read of a sampler thread gives up and takes back the
interpreter lock among the program's threads, which slowed whole passes by
a quarter and spread them by a third.
"""

from __future__ import annotations

import os
import select
import subprocess
import sys

INTERVAL_S = 0.02


def _resident(pid: int, page: int) -> int:
    with open(f"/proc/{pid}/statm") as f:
        return int(f.read().split()[1]) * page


class RssPeak:
    """Peak of this process's resident set while the block runs (bytes),
    beside the value at entry."""

    def __enter__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = _resident(os.getpid(), self._page)
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(os.getpid())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if self._proc.stdout.readline().strip() != "sampling":
            self._proc.kill()
            self._proc.wait()
            raise RuntimeError("the resident-set sampler did not start")
        return self

    def __exit__(self, *exc):
        out, _ = self._proc.communicate(input="stop\n", timeout=60)
        self.peak = max(self.peak, int(out.split()[-1]),
                        _resident(os.getpid(), self._page))


def _sample(pid: int) -> None:
    page = os.sysconf("SC_PAGE_SIZE")
    peak = _resident(pid, page)
    print("sampling", flush=True)
    while not select.select([sys.stdin], [], [], INTERVAL_S)[0]:
        peak = max(peak, _resident(pid, page))
    print(peak, flush=True)


if __name__ == "__main__":
    _sample(int(sys.argv[1]))
