"""Atomic stats-artifact I/O: a copy of the JAX package's
``telemetry/stats_io.py``.

``launch/train.py --stats-json`` goes through :func:`atomic_write_json`:
the record is serialized to a temp file in the *same directory* and
published with ``os.replace``, so a reader either sees the previous
complete artifact or the new complete artifact — never a torn half-dump,
even if the writer is killed mid-write. :func:`read_jsonl` reads an
append-only spill and skips a torn tail line.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional


def atomic_write_json(path: str, obj: Any, *, indent: int = 1,
                      default=str) -> None:
    """Serialize ``obj`` to ``path`` atomically (tmp file + ``os.replace``)."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-stats-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=indent, default=default)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_json(path: str, default: Optional[Any] = None) -> Any:
    """Best-effort read of a stats artifact; returns ``default`` when the
    file is absent or unparseable (a scraper should never crash the host)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return default


def read_jsonl(path: str):
    """Yield parsed records from a JSONL spill, skipping torn tail lines
    (the spill is append-only; a crash can leave one partial last line)."""
    try:
        f = open(path)
    except OSError:
        return
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue
