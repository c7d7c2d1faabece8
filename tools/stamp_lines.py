#!/usr/bin/env python3
"""Run a command and print each line of its output with the wall seconds
since the start, to read where a long script such as ``chip_smoke.py``
spends its time (the gap between two stamped lines is the time of the
work between them).

    python3 tools/stamp_lines.py -- python3 chip_smoke.py

Standard error is merged into the output. Exits with the command's code.
"""
from __future__ import annotations

import subprocess
import sys
import time


def main(argv: list[str]) -> int:
    cmd = argv[1:] if argv[:1] == ["--"] else argv
    if not cmd:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          bufsize=1) as proc:
        for line in proc.stdout:
            print(f"[{time.perf_counter() - t0:8.2f} s] {line}", end="",
                  flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
