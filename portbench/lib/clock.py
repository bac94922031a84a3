"""Set-up's steps on standard error, each with the seconds since the
harness was imported."""

import sys
import time

START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[portbench {time.perf_counter() - START:8.3f} s] {msg}", file=sys.stderr, flush=True)
