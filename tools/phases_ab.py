#!/usr/bin/env python3
"""Time chip_smoke.py's phases 9, 13 and 18 of one checkout on the card.

    python3 tools/phases_ab.py ROOT

ROOT is a checkout of the repo (this one, or an earlier commit unpacked
with ``git archive`` into a directory ``.gitignore`` lists); its own
``chip_smoke.py`` and package run, its servers from its own tree. Builds
the kernels, then runs phase 9's two linear servers (``arow.json`` and
regression ``default.json``), phase 13's fleet with the autoscaler drive
and phase 18's server planes, and prints one ``AB {...}`` JSON line: each
phase's wall seconds, phase 9's rows/s, phase 13's boot, autoscaler and
regression numbers, and phase 18's rows/s by arm. Run two checkouts in
one call to compare them on one card.
"""

import json
import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import torch

    from jubatus_tpu_torch.core.datum import Datum
    from jubatus_tpu_torch.models.classifier import ClassifierDriver
    from jubatus_tpu_torch.models.nearest_neighbor import \
        NearestNeighborDriver
    from jubatus_tpu_torch.models.regression import RegressionDriver
    from jubatus_tpu_torch.ops import online_scan, sig_scan

    if not cs.__file__.startswith(root):
        raise SystemExit(f"imported {cs.__file__}, not {root}'s")
    sig_scan.library()
    online_scan.library()
    out = {"root": root}
    for key, driver, engine, config in (
            ("p9_arow", ClassifierDriver, "classifier", "arow.json"),
            ("p9_reg", RegressionDriver, "regression", "default.json")):
        t0 = time.perf_counter()
        r = cs.phase_linear_server(Datum, driver, engine, config, 0)
        out[f"{key}_s"] = time.perf_counter() - t0
        out[key] = {k: r[k] for k in ("concurrent", "sequential")}
    t0 = time.perf_counter()
    r = cs.phase_fleet(Datum, 0, member_flags="--telemetry-interval 1",
                       autoscale=True)
    out["p13_s"] = time.perf_counter() - t0
    out["p13_boot_s"] = r["boot_s"]
    out["p13_autoscale"] = {k: v for k, v in r["autoscale"].items()
                            if isinstance(v, (int, float))}
    out["p13_regression"] = r["regression"]
    t0 = time.perf_counter()
    r = cs.phase_server_planes(torch, Datum, NearestNeighborDriver, 0)
    out["p18_s"] = time.perf_counter() - t0
    out["p18_arms"] = {k: v["rows_per_s"] for k, v in r["arms"].items()}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
