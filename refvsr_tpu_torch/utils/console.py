"""Console logging; counterpart of ``refvsr_tpu/utils/console.py``: ANSI
colour helpers, the training status line (rewritten in place on a TTY, one
plain line per call when piped) and the log-tree wipe of ``--delete_log``."""

from __future__ import annotations

import os
import shutil
import sys

_CODES = {"red": 31, "green": 32, "yellow": 33, "blue": 34, "cyan": 36}


def _c(text, color):
    if not sys.stdout.isatty():
        return str(text)
    return f"\033[{_CODES[color]}m{text}\033[0m"


def to_red(t):
    return _c(t, "red")


def to_green(t):
    return _c(t, "green")


def to_yellow(t):
    return _c(t, "yellow")


def to_blue(t):
    return _c(t, "blue")


def format_train_line(mode, epoch, itr, itr_per_epoch, errs: dict,
                      lr: float, elapsed: float) -> str:
    """'[mode] [E e] [I i/n] loss: ... lr: ... (x.xxs)'."""
    parts = [f"[{to_green(mode)}]", f"[E {epoch}]",
             f"[I {itr}/{itr_per_epoch}]"]
    for k, v in errs.items():
        parts.append(f"{k}: {v:.5f}")
    parts.append(f"lr: {lr:.2e}")
    parts.append(f"({elapsed:.2f}s)")
    return " ".join(parts)


def print_status(line: str) -> None:
    """A status line that overwrites itself on a TTY; piped, one plain line
    per call."""
    if sys.stdout.isatty():
        sys.stdout.write(f"\r\033[2K{line}")
        sys.stdout.flush()
    else:
        print(line)


def end_status() -> None:
    """End an in-place status line before a permanent print."""
    if sys.stdout.isatty():
        sys.stdout.write("\n")
        sys.stdout.flush()


def handle_directory(config, delete_log: bool) -> None:
    """At a training start (no resume), optionally wipe the run's log tree,
    after a y/n confirmation on a TTY; a run without a TTY takes the flag
    as given. Then make sure the log directory exists."""
    if delete_log:
        if sys.stdin.isatty():
            ans = input("Are you sure to delete the logs (y/n):\n")
            if len(ans) == 0 or ans[0].lower() == "y":
                pass
            elif ans[0].lower() == "n":
                delete_log = False
            else:
                print("invalid input")
                raise SystemExit(1)
        if delete_log:
            shutil.rmtree(config.log_dir, ignore_errors=True)
    os.makedirs(config.log_dir, exist_ok=True)
