"""Host utilities of the port (copies of ``jubatus_tpu.utils`` modules,
trimmed to what the port's planes use)."""
