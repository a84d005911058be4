"""Ops CLIs (copy of ``jubatus_tpu/cmd/``, trimmed; ≙ jubatus/server/cmd/ +
jubavisor/, SURVEY.md §2.6).

- ``jubactl``    — cluster control: start/stop via supervisors, save/load/
                   status and the elastic and recovery planes via the
                   servers themselves (cmd/jubactl.cpp).
- ``jubaconfig`` — validate + write/read/delete/list engine configs in the
                   coordination store (cmd/jubaconfig.cpp).
- ``jubavisor``  — per-host process supervisor daemon, RPC-controlled
                   (jubavisor/jubavisor.{hpp,cpp}); its children are the
                   port's servers.
- ``jubadump``   — model files and sharded checkpoints to JSON, and a
                   live server's mix history, slow log and stack profile.

Each module exposes ``main(argv)`` and runs via
``python -m jubatus_tpu_torch.cmd.<tool>``. The coordinator location comes
from ``-z`` or the ``JUBATUS_COORDINATOR``/``ZK`` environment variables (the
reference honors ``ZK``, jubactl.cpp:121-127). Not carried over: the
offline converter ``jubaconv``.
"""

from __future__ import annotations

import os
from typing import Optional


def resolve_coordinator(flag: str) -> Optional[str]:
    """-z flag, else $JUBATUS_COORDINATOR, else $ZK (reference order)."""
    return flag or os.environ.get("JUBATUS_COORDINATOR") or os.environ.get("ZK")
