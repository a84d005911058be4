"""Host utilities of the port (copies of ``jubatus_tpu.utils`` modules,
trimmed to what the checkpoint and mix planes use)."""
