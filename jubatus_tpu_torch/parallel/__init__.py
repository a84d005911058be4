"""The port's mix data plane (counterpart of ``jubatus_tpu.parallel``):
so far the host fold of the RPC mix, ``mix.tree_sum``."""
