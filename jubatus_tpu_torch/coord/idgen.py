"""Cluster-unique uint64 ids (copy of ``jubatus_tpu/coord/idgen.py``;
≙ common/global_id_generator_*).

Standalone mode counts locally (global_id_generator_standalone); distributed
mode mints through the coordinator (global_id_generator_zk.cpp:32-56 uses the
ZK version counter on .../id_generator).
"""

from __future__ import annotations

import threading
from typing import Optional

from jubatus_tpu_torch.coord.base import Coordinator


class IdGenerator:
    def __init__(
        self, coord: Optional[Coordinator] = None, path: str = "/jubatus/id_generator"
    ) -> None:
        self._coord = coord
        self._path = path
        self._counter = 0
        self._mu = threading.Lock()

    def generate(self) -> int:
        if self._coord is not None:
            return self._coord.create_id(self._path)
        with self._mu:
            self._counter += 1
            return self._counter
