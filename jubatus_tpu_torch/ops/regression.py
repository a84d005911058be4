"""Passive-aggressive regression: PA / PA1 / PA2 (counterpart of
``jubatus_tpu/ops/regression.py``).

Same state layout and additive-diff mix as ``ops/classifier.py``, with one
weight row. Update (epsilon-insensitive hinge): err = y - w.x,
l = |err| - epsilon; if l > 0: w += sign(err) * alpha * x with
  PA:  alpha = l / x2
  PA1: alpha = min(C, l / x2)
  PA2: alpha = l / (x2 + 1/(2C))

``train_batch`` is the per-example scan: on a CUDA state it is the kernel of
``ops/online_scan.py`` (one launch per batch), on a CPU state that module's
plain loop. It updates ``dw`` in place. The scan sums each example's K
products in the kernel's order, not XLA's, so it agrees with the JAX package
within a stated tolerance (``tests/test_torch_regression_ops.py``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.ops import online_scan
from jubatus_tpu_torch.ops.classifier import _f32, _on

METHODS = online_scan.METHODS


class RegressionState(NamedTuple):
    w: torch.Tensor   # [D] master weights
    dw: torch.Tensor  # [D] local diff since the last mix


def init_state(dim: int, device=None) -> RegressionState:
    dev = resolve_device(device)
    return RegressionState(w=torch.zeros(dim, dtype=torch.float32, device=dev),
                           dw=torch.zeros(dim, dtype=torch.float32, device=dev))


def estimate(state: RegressionState, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """Batch estimates [B]."""
    return ((state.w[idx] + state.dw[idx]) * val).sum(-1)


def train_batch(state: RegressionState, idx: torch.Tensor, val: torch.Tensor,
                targets: torch.Tensor, sensitivity: float, c: float, *,
                method: str) -> RegressionState:
    online_scan.pa_scan(state.w, state.dw, idx, val, targets, sensitivity, c,
                        method)
    return state


# -- mixable protocol -------------------------------------------------------
def get_diff(state: RegressionState) -> Dict[str, Any]:
    return {"dw": state.dw.clone(), "count": 1.0}


def mix_diffs(lhs: Dict[str, Any], rhs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: lhs[k] + rhs[k] for k in lhs}


def put_diff(state: RegressionState, diff: Dict[str, Any]) -> RegressionState:
    """w += summed dw / count (float32, count at least 1); dw = 0. In
    place; the diff may be host numpy or a tensor."""
    w, dw = state
    ddw = _on(diff["dw"], w)
    n = torch.clamp_min(_f32(diff["count"], w.device), 1.0)
    w += ddw / n
    dw.zero_()
    return RegressionState(w, dw)
