"""Structured JSONL run logging.

The reference's observability is bare stderr prints (SURVEY.md §5).  Here
every pipeline event (window/burst completion, adaptation state, acceptance
rates, ESS) is a JSON line, machine-readable for dashboards, with wall-clock
and throughput attached.  Enabled via ``log_file`` in the Mcmc config or
``COVID19UK_TPU_LOG`` env var (the JAX package's, so one setting serves
both); stderr keeps the human-readable summary.  Port of
``covid19uk_tpu/utils/logging.py``.
"""

import json
import os
import sys
import time


class RunLog:
    def __init__(self, path=None):
        self.path = path or os.environ.get("COVID19UK_TPU_LOG")
        self._fh = open(self.path, "a") if self.path else None
        self._t0 = time.time()

    def event(self, kind, **fields):
        rec = {
            "t": round(time.time() - self._t0, 3),
            "event": kind,
            **fields,
        }
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def info(self, msg):
        print(msg, file=sys.stderr, flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class StageTimer:
    """Context manager measuring one pipeline stage."""

    def __init__(self, log: RunLog, kind, **fields):
        self.log, self.kind, self.fields = log, kind, fields

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.log.event(
            self.kind,
            wall_s=round(time.time() - self.start, 3),
            **self.fields,
        )
        return False
