#!/usr/bin/env python3
"""What each server plane costs coalesced training: phase 9's regression
server shape under one arm of flags each, timed in turns.

    python tools/planes_ab.py [--rounds 6] [--device cuda]

One ``python -m jubatus_tpu_torch.server regression -f
config/regression/default.json -c 4`` process per arm (all started at
once, each with a datadir of its own under ``build/planes_ab``); then,
``--rounds`` times, the arms in order (even rounds) or reversed (odd
ones), each taking chip_smoke.py's phase 9 rows (10^4 rows in calls of
256) from 4 clients at once. Prints one line a run and, last, one JSON
line: the median rows/s and every run's by arm, with the card's name and
power limit.

The arms: the defaults; every plane off (chip_smoke.py's ``planes_off``);
the quality plane off (``--quality-sample 0``); every call scored
(``--quality-sample 1.0``); the usage ledger off (``--usage-top 0``);
the time series and the event journal off.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

ARMS = {"defaults": (),
        "planes_off": cs.AB_ARMS["planes_off"],
        "quality_off": ("--quality-sample", "0"),
        "sample_all": ("--quality-sample", "1.0"),
        "usage_off": ("--usage-top", "0"),
        "series_events_off": ("--timeseries-capacity", "0",
                              "--event-capacity", "0")}
CLIENTS = 4
OUT = os.path.join(ROOT, "build", "planes_ab")


def start(arm: str, flags, device: str):
    port = cs.free_port()
    datadir = os.path.join(OUT, arm)
    os.makedirs(datadir)
    log = open(os.path.join(OUT, f"{arm}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.server", "regression",
         "-f", os.path.join(ROOT, "config", "regression", "default.json"),
         "-p", str(port), "-b", "127.0.0.1", "-c", str(CLIENTS),
         "--device", device, "-d", datadir, *flags],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, port


def wait_ready(proc, port: int) -> None:
    from jubatus_tpu_torch.rpc.client import RpcClient

    deadline = time.time() + 180
    while True:
        cs.check(proc.poll() is None, f"server on {port} exited")
        try:
            with RpcClient("127.0.0.1", port, timeout=5.0) as c:
                c.call("get_status", "ab")
            return
        except Exception:  # broad-ok — the server is still starting
            cs.check(time.time() < deadline, f"server on {port} not up")
            time.sleep(0.5)


def train_run(port: int, batches) -> float:
    """Every batch once, from CLIENTS clients at once; rows/s."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    errors = []

    def client(k: int) -> None:
        try:
            with RpcClient("127.0.0.1", port, timeout=120.0) as c:
                for b in batches[k::CLIENTS]:
                    if c.call("train", "ab", b) != len(b):
                        errors.append(f"client {k}: short count")
        except Exception as e:  # broad-ok — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    cs.check(not errors, f"train failed: {errors[:2]}")
    return sum(len(b) for b in batches) / seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from jubatus_tpu_torch.core.datum import Datum

    smi = cs.nvidia_smi_line() if args.device == "cuda" else ""
    rng = np.random.default_rng(args.seed + 41)
    rows = [cs.linear_example(rng, Datum, "regression", i)
            for i in range(cs.SERVER_ROWS)]
    batches = [rows[lo:lo + cs.LINEAR_BATCH]
               for lo in range(0, len(rows), cs.LINEAR_BATCH)]
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    servers = {arm: start(arm, flags, args.device)
               for arm, flags in ARMS.items()}
    try:
        for proc, port in servers.values():
            wait_ready(proc, port)
        for _proc, port in servers.values():  # warm-up: kernels, converter
            train_run(port, batches[:8])
        runs = {arm: [] for arm in ARMS}
        arms = list(ARMS)
        for r in range(args.rounds):
            for arm in (arms if r % 2 == 0 else arms[::-1]):
                runs[arm].append(train_run(servers[arm][1], batches))
                print(f"[planes_ab] round {r} {arm} {runs[arm][-1]:.1f} "
                      "rows/s", flush=True)
    finally:
        for proc, _port in servers.values():
            cs.stop_server(proc)
    print(json.dumps({"device": args.device, "smi": smi,
                      "rows": len(rows), "clients": CLIENTS,
                      "median_rows_per_s": {a: statistics.median(v)
                                            for a, v in runs.items()},
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
