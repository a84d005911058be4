"""Framework version (copy of ``jubatus_tpu/version.py``).

The reference declares VERSION='1.0.2' in wscript:7. The checkpoint
envelope (framework/save_load.py) embeds that compatibility version, so
files saved by either package carry the same header.
"""

# Version of the jubatus API surface we are compatible with (reference
# wscript:7). Embedded in saved model headers for tool parity.
COMPAT_JUBATUS_VERSION = (1, 0, 2)
