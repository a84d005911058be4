"""Disk helpers shared by the checkpoint and the capture directories."""

from __future__ import annotations

import os


def tree_bytes(path: str) -> int:
    """Bytes of every file under ``path`` (0 when it does not exist)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total
