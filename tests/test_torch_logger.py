"""Logging set-up of the port (``jubatus_tpu_torch/utils/logger.py``),
mirroring ``tests/test_logger.py``: each case runs on both packages'
modules, which must behave alike; the server's ``-l`` writes its log file.
"""

from __future__ import annotations

import json
import logging
import os
import signal

import pytest

from jubatus_tpu.utils import logger as jax_logger
from jubatus_tpu_torch.utils import logger as port_logger


@pytest.fixture(params=["jax", "port"])
def jlog(request):
    return jax_logger if request.param == "jax" else port_logger


def _cleanup():
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)


def test_logdir_writes_file(jlog, tmp_path):
    try:
        jlog.setup("jubatest", "1.2.3.4", 9, logdir=str(tmp_path))
        logging.getLogger("x").info("hello-logdir")
        for h in logging.getLogger().handlers:
            h.flush()
        content = (tmp_path / "jubatest.log").read_text()
        assert "hello-logdir" in content
        assert "[jubatest:1.2.3.4:9]" in content
    finally:
        _cleanup()


def test_same_line_format_in_both_packages(tmp_path):
    """One log line, formatted by each package's set-up: identical but for
    the timestamp."""
    lines = []
    for mod, sub in ((jax_logger, "j"), (port_logger, "p")):
        d = tmp_path / sub
        try:
            mod.setup("jubaclassifier", "10.0.0.1", 9199, logdir=str(d))
            logging.getLogger("y").warning("same line")
            for h in logging.getLogger().handlers:
                h.flush()
        finally:
            _cleanup()
        line = (d / "jubaclassifier.log").read_text().strip()
        lines.append(line.split(" ", 2)[2])  # drop date and time
    assert lines[0] == lines[1]
    assert lines[0] == "WARNING [jubaclassifier:10.0.0.1:9199] same line"


def test_install_sighup_reload_noop_without_config(jlog):
    """install_sighup_reload("") must not claim the SIGHUP handler."""
    prev = signal.getsignal(signal.SIGHUP)
    try:
        jlog.install_sighup_reload("")
        assert signal.getsignal(signal.SIGHUP) is prev
    finally:
        signal.signal(signal.SIGHUP, prev)


def test_sighup_reload_keeps_old_config_on_error(jlog, tmp_path):
    """A broken config file at reload time keeps the previous logging
    config; a later good one applies again."""
    conf = tmp_path / "log.json"
    conf.write_text(json.dumps({
        "version": 1, "root": {"level": "WARNING", "handlers": []}}))
    try:
        jlog.setup("jubatest", log_config=str(conf))
        jlog.install_sighup_reload(str(conf))
        assert logging.getLogger().level == logging.WARNING
        conf.write_text("{not json")
        os.kill(os.getpid(), signal.SIGHUP)  # must not raise
        assert logging.getLogger().level == logging.WARNING
        conf.write_text(json.dumps({
            "version": 1, "root": {"level": "ERROR", "handlers": []}}))
        os.kill(os.getpid(), signal.SIGHUP)
        assert logging.getLogger().level == logging.ERROR
    finally:
        signal.signal(signal.SIGHUP, signal.SIG_DFL)
        logging.getLogger().setLevel(logging.WARNING)
        _cleanup()


def test_sighup_reload_missing_file_keeps_old_config(jlog, tmp_path):
    conf = tmp_path / "log.json"
    conf.write_text(json.dumps({
        "version": 1, "root": {"level": "INFO", "handlers": []}}))
    try:
        jlog.setup("jubatest", log_config=str(conf))
        jlog.install_sighup_reload(str(conf))
        conf.unlink()
        os.kill(os.getpid(), signal.SIGHUP)  # must not raise
        assert logging.getLogger().level == logging.INFO
    finally:
        signal.signal(signal.SIGHUP, signal.SIG_DFL)
        logging.getLogger().setLevel(logging.WARNING)
        _cleanup()


def test_log_config_and_sighup_reload(jlog, tmp_path):
    conf = tmp_path / "log.json"

    def write(level):
        conf.write_text(json.dumps({
            "version": 1,
            "root": {"level": level, "handlers": []},
        }))

    try:
        write("WARNING")
        jlog.setup("jubatest", log_config=str(conf))
        assert logging.getLogger().level == logging.WARNING
        jlog.install_sighup_reload(str(conf))
        write("DEBUG")
        os.kill(os.getpid(), signal.SIGHUP)
        assert logging.getLogger().level == logging.DEBUG
    finally:
        signal.signal(signal.SIGHUP, signal.SIG_DFL)
        logging.getLogger().setLevel(logging.WARNING)
        _cleanup()


def test_server_main_logs_into_logdir_and_takes_timeout(tmp_path):
    """``python -m jubatus_tpu_torch.server ... -l <dir> -t 5 -D`` starts,
    writes ``<dir>/jubastat.log`` and reports the flags in get_status."""
    import subprocess
    import sys

    from jubatus_tpu_torch.rpc.client import StatClient

    root = os.path.join(os.path.dirname(__file__), "..")
    logdir = tmp_path / "logs"
    proc = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.server", "stat",
         "-f", os.path.join(root, "config", "stat", "default.json"),
         "-p", "0", "-b", "127.0.0.1", "--device", "cpu",
         "-l", str(logdir), "-t", "5", "-D"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving on port" in line, proc.stderr.read()
        port = int(line.split("serving on port")[1].split()[0])
        with StatClient("127.0.0.1", port, "") as c:
            st = next(iter(c.get_status().values()))
        assert st["argv.timeout"] == 5.0 and st["argv.daemon"] is True
        assert st["argv.logdir"] == str(logdir)
        assert (logdir / "jubastat.log").exists()
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
