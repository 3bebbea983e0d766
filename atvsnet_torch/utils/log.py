"""Colored, timestamped logging (equivalent of reference tools/common.py:15-51; the
port's copy of atvsnet_tpu/utils/log.py)."""

from __future__ import annotations

import sys
import time


class Notify:
    HEADER = "\033[95m"
    INFO = "\033[92mI"
    WARNING = "\033[93mW"
    FAIL = "\033[91mF"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"
    ENDC = "\033[0m"


def _stamp() -> str:
    return time.strftime("%y-%m-%d %H:%M:%S")


def info(*args) -> None:
    print(Notify.INFO, _stamp(), *args, Notify.ENDC, file=sys.stderr)


def warn(*args) -> None:
    print(Notify.WARNING, _stamp(), *args, Notify.ENDC, file=sys.stderr)


def fail(*args) -> None:
    print(Notify.FAIL, _stamp(), *args, Notify.ENDC, file=sys.stderr)


def read_list(path: str):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def write_list(path: str, items) -> None:
    with open(path, "w") as f:
        for it in items:
            f.write(str(it) + "\n")
