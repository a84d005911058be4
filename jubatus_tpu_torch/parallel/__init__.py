"""The port's parallel planes (counterpart of ``jubatus_tpu.parallel``):
the host fold of the RPC mix (``mix.tree_sum``), the 1-D shard mesh
(``mesh``), the sharded row store and IVF cell arenas (``row_store``),
and the row-sharded exact and IVF scans (``sharded_knn``,
``sharded_ivf``)."""
