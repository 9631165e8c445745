"""Run logging: a timestamped tee of stdout and stderr into log files.

Counterpart of ``beta_recsys_tpu/utils/logger.py``: ``Logger(log_dir,
run_id)`` writes ``<run_id>.stdout.log`` and ``<run_id>.stderr.log``, each
line stamped, while the original streams keep printing; ``restore()`` puts
them back. ``system.log_to_file`` installs one for a run.
"""

import datetime
import logging
import os
import sys

from .common import ensure_dir


def get_logger(name="beta_recsys_tpu_torch", level=logging.INFO):
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


class _TeeStream:
    """Writes to the original stream and, each line stamped, to a file."""

    def __init__(self, stream, file_path):
        self.stream = stream
        self.file = open(file_path, "a", buffering=1)
        self._at_line_start = True

    def write(self, text):
        self.stream.write(text)
        for chunk in text.splitlines(keepends=True):
            if self._at_line_start and chunk.strip():
                self.file.write(f"[{datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S')}] ")
            self.file.write(chunk)
            self._at_line_start = chunk.endswith("\n")

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def isatty(self):
        return False

    def close(self):
        self.file.close()


class Logger:
    """Timestamping tees over stdout and stderr for a run."""

    def __init__(self, log_dir, run_id):
        ensure_dir(log_dir)
        base = os.path.join(log_dir, run_id)
        self.stdout_path, self.stderr_path = base + ".stdout.log", base + ".stderr.log"
        self._orig_out, self._orig_err = sys.stdout, sys.stderr
        sys.stdout = _TeeStream(self._orig_out, self.stdout_path)
        sys.stderr = _TeeStream(self._orig_err, self.stderr_path)

    def restore(self):
        for stream in (sys.stdout, sys.stderr):
            if isinstance(stream, _TeeStream):
                stream.close()
        sys.stdout, sys.stderr = self._orig_out, self._orig_err
