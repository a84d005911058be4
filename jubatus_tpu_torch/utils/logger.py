"""Process logging setup (copy of ``jubatus_tpu/utils/logger.py``;
≙ common/logger + log4cxx wiring).

The reference logs through log4cxx behind glog-style macros, with a
per-process pattern carrying (progname, host, port), an optional XML
config file (``--log_config``) hot-reloaded on SIGHUP
(server_util.cpp:70-127), and ``--logdir`` redirecting to files. Here:

- ``setup(progname, host, port, logdir, log_config)`` configures the root
  logger: stderr by default, ``<logdir>/<progname>.log`` when logdir is
  set, or a Python ``logging.config`` dictConfig JSON file when
  log_config is set.
- ``install_sighup_reload(...)`` re-applies the config file on SIGHUP —
  same operational contract (rotate/adjust levels without restart).
"""

from __future__ import annotations

import json
import logging
import logging.config
import os
import signal
from typing import Optional

DEFAULT_FORMAT = "%(asctime)s %(levelname)s [{prog}:{host}:{port}] %(message)s"


def setup(progname: str, host: str = "", port: int = 0,
          logdir: str = "", log_config: str = "") -> None:
    if log_config:
        apply_config_file(log_config)
        return
    fmt = DEFAULT_FORMAT.format(prog=progname, host=host or "-", port=port)
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        handler: logging.Handler = logging.FileHandler(
            os.path.join(logdir, f"{progname}.log"))
    else:
        handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(fmt))
    root.addHandler(handler)
    root.setLevel(logging.INFO)


def apply_config_file(path: str) -> None:
    """JSON dictConfig (the Python-native stand-in for log4cxx XML)."""
    with open(path) as f:
        cfg = json.load(f)
    # module-level loggers created before setup() must stay enabled unless
    # the config explicitly says otherwise (dictConfig defaults to True,
    # which would silently mute every jubatus module logger)
    cfg.setdefault("disable_existing_loggers", False)
    logging.config.dictConfig(cfg)


def install_sighup_reload(log_config: str) -> None:
    """Re-apply the logging config file on SIGHUP (server_util.cpp:70-127).
    No-op when no config file is in use."""
    if not log_config:
        return

    def _reload(_sig, _frame) -> None:
        try:
            apply_config_file(log_config)
            logging.getLogger(__name__).info("log config reloaded from %s",
                                             log_config)
        except Exception:  # noqa: BLE001 — keep the old config on error
            logging.getLogger(__name__).exception(
                "failed to reload log config %s", log_config)

    signal.signal(signal.SIGHUP, _reload)
