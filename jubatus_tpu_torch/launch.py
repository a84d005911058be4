"""Per-engine entry functions (copy of ``jubatus_tpu/launch.py``; ≙ the
reference's juba* binaries).

The reference installs one binary per engine (``jubaclassifier``,
``jubarecommender_proxy``, ... — jubatus/server/server/wscript:13-34);
here each is a function of the same name, a thin wrapper over the port's
generic server/proxy mains with the engine pre-bound
(``jubatus_tpu_torch.launch.jubaclassifier(["-f", "conf.json"])``). No
console script names them: the package declares none.
"""

from __future__ import annotations

import sys
from typing import List, Optional


def _server(engine: str, argv: Optional[List[str]]) -> int:
    from jubatus_tpu_torch.server.__main__ import main

    return main([engine] + list(sys.argv[1:] if argv is None else argv)) or 0


def _proxy(engine: str, argv: Optional[List[str]]) -> int:
    from jubatus_tpu_torch.server.proxy import main

    return main([engine] + list(sys.argv[1:] if argv is None else argv)) or 0


def jubaanomaly(argv=None): return _server("anomaly", argv)
def jubabandit(argv=None): return _server("bandit", argv)
def jubaburst(argv=None): return _server("burst", argv)
def jubaclassifier(argv=None): return _server("classifier", argv)
def jubaclustering(argv=None): return _server("clustering", argv)
def jubagraph(argv=None): return _server("graph", argv)
def jubanearest_neighbor(argv=None): return _server("nearest_neighbor", argv)
def jubarecommender(argv=None): return _server("recommender", argv)
def jubaregression(argv=None): return _server("regression", argv)
def jubastat(argv=None): return _server("stat", argv)
def jubaweight(argv=None): return _server("weight", argv)


def jubaanomaly_proxy(argv=None): return _proxy("anomaly", argv)
def jubabandit_proxy(argv=None): return _proxy("bandit", argv)
def jubaburst_proxy(argv=None): return _proxy("burst", argv)
def jubaclassifier_proxy(argv=None): return _proxy("classifier", argv)
def jubaclustering_proxy(argv=None): return _proxy("clustering", argv)
def jubagraph_proxy(argv=None): return _proxy("graph", argv)
def jubanearest_neighbor_proxy(argv=None): return _proxy("nearest_neighbor", argv)
def jubarecommender_proxy(argv=None): return _proxy("recommender", argv)
def jubaregression_proxy(argv=None): return _proxy("regression", argv)
def jubastat_proxy(argv=None): return _proxy("stat", argv)
def jubaweight_proxy(argv=None): return _proxy("weight", argv)
