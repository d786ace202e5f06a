"""Stdout/stderr tee into a log file, and time formatting.

Counterpart of vivid_tpu/core/logger.py `Logger` and `format_time`. The
trainer tees everything it prints into `<run_dir>/log.txt`. Each stream
keeps its own destination: text written to stderr goes to the saved stderr
(and the file), text written to stdout to the saved stdout (and the file).
"""

import sys
from typing import Optional


class _Tee:
    """One tee'd stream: the file, then the stream it replaced."""

    def __init__(self, logger: "Logger", stream):
        self.logger = logger
        self.stream = stream

    def write(self, text) -> None:
        if len(text) == 0:
            return
        if self.logger.file is not None:
            self.logger.file.write(text)
        self.stream.write(text)
        if self.logger.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.logger.file is not None:
            self.logger.file.flush()
        self.stream.flush()

    def isatty(self):
        return False


class Logger:
    """Tee stdout (and stderr, with `also_stderr`) into `file_name`.
    Installs itself on construction; `close()` (or leaving a `with` block)
    puts the streams back."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "w",
                 should_flush: bool = True, also_stderr: bool = True):
        self.file = open(file_name, file_mode) if file_name is not None else None
        self.should_flush = should_flush
        self.stdout = _Tee(self, sys.stdout)
        self.stderr = _Tee(self, sys.stderr) if also_stderr else None
        sys.stdout = self.stdout
        if self.stderr is not None:
            sys.stderr = self.stderr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        for tee, name in ((self.stdout, "stdout"), (self.stderr, "stderr")):
            if tee is None:
                continue
            tee.flush()
            if getattr(sys, name) is tee:
                setattr(sys, name, tee.stream)
        if self.file is not None:
            self.file.close()
            self.file = None


def format_time(seconds) -> str:
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 60 * 60:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 24 * 60 * 60:
        return f"{s // (60 * 60)}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // (24 * 60 * 60)}d {(s // (60 * 60)) % 24:02d}h {(s // 60) % 60:02d}m"
