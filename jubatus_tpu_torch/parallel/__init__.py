"""The port's parallel planes (counterpart of ``jubatus_tpu.parallel``):
the mix engine (``mix``: the RPC mix's host fold, the in-process
all-reduce and ``LocalMixGroup``), the meshes (``mesh``: the 1-D shard
mesh, the replica, grid and two-tier host meshes), the process world
(``multihost``), the collective data plane (``collective``), the replica
× shard train step (``spmd``), the sharded row store and IVF cell arenas
(``row_store``), the row-sharded exact and IVF scans (``sharded_knn``,
``sharded_ivf``), the ring scans that keep queries and table both sharded
(``ring``) and the feature-sharded linear engines (``sharded_model``)."""

from jubatus_tpu_torch.parallel.ring import (  # noqa: F401
    ring_euclid_topk,
    ring_hamming_topk,
    ring_scan,
)
