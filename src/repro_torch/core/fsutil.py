"""Shared filesystem idioms (the part of the reference's
``core/fsutil.py`` this slice needs).

Files other processes may read are published the same way: write to a
uniquely-named tempfile in the *same directory*, then atomically
``os.replace`` it over the target.  Concurrent publishers each land a
complete file (last writer wins) and readers never observe a torn one.
``append_jsonl`` comes with the tuner's history (ROADMAP.md, queue A).
"""
from __future__ import annotations

import os
import pathlib
import tempfile
from typing import Optional


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
