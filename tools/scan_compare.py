#!/usr/bin/env python3
"""Time regression's scan kernel against an earlier version of its source,
in turns, on one GPU.

    python tools/scan_compare.py --baseline build/pr4/online_scan.cu

The baseline is an earlier ``jubatus_tpu_torch/csrc/online_scan.cu`` with
the first C interface (``jt_pa_scan(w, dw, idx, val, y, B, K, tile, method,
sensitivity, c, stream)``, one warp, ``tile`` examples of
``40960 // (8K + 4)`` at most 256 staged at a time), for example
``git show d66d446:jubatus_tpu_torch/csrc/online_scan.cu`` saved under the
ignored ``build/``. Both are built with nvcc for sm_90a; both run PA on the
same inputs at ``chip_smoke.py``'s two scan shapes (the stress shape,
``pa_scan_inputs``, and the server-shaped batch, ``scan_server_batch``),
B = 8192, must give bit-equal dw from dw = 0, and are timed in turns
(baseline, current, current, baseline; each a median of ``--reps``
CUDA-event timings after a warm-up). Prints one JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def baseline_tile(k: int) -> int:
    return max(1, min(256, 40 * 1024 // (k * 8 + 4)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_compare: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from jubatus_tpu_torch.core.datum import Datum
    from jubatus_tpu_torch.models.regression import RegressionDriver
    from jubatus_tpu_torch.ops import _build, online_scan

    base_lib, _ = _build.build(args.baseline.resolve())
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    base_lib.jt_pa_scan.argtypes = [P, P, P, P, P, I, I, I, I, F, F, P]
    base_lib.jt_pa_scan.restype = I
    online_scan.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed + 31)
    shapes = {
        "stress": cs.pa_scan_inputs(rng, cs.SCAN_TIME_B),
        "server": cs.scan_server_batch(rng, Datum, RegressionDriver,
                                       cs.SCAN_TIME_B),
    }
    out = {}
    for name, (idx, val, y, w) in shapes.items():
        card = [torch.from_numpy(a).to(dev) for a in (idx, val, y, w)]
        b, k = idx.shape
        stream = torch.cuda.current_stream(dev).cuda_stream

        def baseline(dw):
            err = base_lib.jt_pa_scan(
                card[3].data_ptr(), dw.data_ptr(), card[0].data_ptr(),
                card[1].data_ptr(), card[2].data_ptr(), b, k,
                baseline_tile(k), 0, 0.1, 1.0, stream)
            if err != 0:
                raise RuntimeError(f"baseline launch failed: {err}")

        dw_base = torch.zeros_like(card[3])
        baseline(dw_base)
        dw_cur = torch.zeros_like(card[3])
        launch = online_scan.pa_scan.plan(card[3], dw_cur, card[0], card[1],
                                          card[2], 0.1, 1.0, "PA")
        launch.run()
        torch.cuda.synchronize()
        if not torch.equal(dw_base, dw_cur):
            print(f"scan_compare: {name}: the two kernels disagree (max "
                  f"{float((dw_base - dw_cur).abs().max())})",
                  file=sys.stderr)
            return 1
        runs = {"baseline": lambda: baseline(dw_base), "current": launch.run}
        times = {"baseline": [], "current": []}
        for who in ("baseline", "current", "current", "baseline"):
            times[who].append(cs.time_ms(torch, runs[who], args.reps))
        out[name] = dict(
            B=int(b), K=int(k), variant=launch.variant,
            baseline_ms=times["baseline"], current_ms=times["current"],
            speedup=(statistics.fmean(times["baseline"])
                     / statistics.fmean(times["current"])))
    print(json.dumps(dict(shapes=out, baseline=str(args.baseline),
                          device=torch.cuda.get_device_name(0),
                          nvidia_smi=cs.nvidia_smi_line(),
                          reps=args.reps)))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
