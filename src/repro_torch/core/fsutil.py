"""Shared filesystem idioms (the part of the reference's
``core/fsutil.py`` this slice needs).

Files other processes may read are published the same way: write to a
uniquely-named tempfile in the *same directory*, then atomically
``os.replace`` it over the target.  Concurrent publishers each land a
complete file (last writer wins) and readers never observe a torn one.

``append_jsonl`` is the torn-tolerant O_APPEND record append (one line
per record, self-healing after a torn tail) shared by the trial history
(core/history.py), the quarantine ledger (core/quarantine.py) and the
telemetry event stream (core/telemetry.py).
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import Dict, Optional


def _fsync_dir(directory: pathlib.Path) -> None:
    """fsync a directory so a just-renamed/created entry survives a
    crash (no-op on platforms that refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_publish(path: pathlib.Path, text: str,
                   prefix: Optional[str] = None,
                   durable: bool = False) -> None:
    """Publish ``text`` at ``path`` atomically (unique tempfile +
    same-directory ``os.replace`` — the same directory is what makes
    the rename atomic).  The parent directory must exist.  On any
    error the tempfile is removed and the exception re-raised; the
    target is either its old content or the complete new content,
    never a mix.

    With ``durable=True`` the tempfile is fsynced before the rename
    and the parent directory after it, so the publish also survives a
    host crash (not just a process crash)."""
    path = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent,
                               prefix=prefix or f".{path.name}.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if durable:
            _fsync_dir(path.parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def append_jsonl(path: pathlib.Path, record: Dict,
                 durable: bool = False) -> None:
    """Append one JSON record as one line, multi-process safe.

    O_APPEND keeps concurrent appenders from interleaving (each line is
    one ``os.write`` well under PIPE_BUF).  A torn tail left by a crashed
    writer self-heals: if the last byte on disk is not a newline, the
    next append starts with one, so the torn line stays parseable-as-bad
    and every later record lands intact (readers skip bad lines).

    ``durable=True`` additionally fsyncs after the write, so the record
    survives a host crash — required for the quarantine ledger, where a
    lost intent record means a poison config gets a free retry."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    line = json.dumps(record, sort_keys=True, default=str) + "\n"
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        try:
            os.lseek(fd, -1, os.SEEK_END)
            if os.read(fd, 1) != b"\n":
                line = "\n" + line
        except OSError:
            pass                        # empty file: no tail to heal
        os.write(fd, line.encode())
        if durable:
            os.fsync(fd)
    finally:
        os.close(fd)
