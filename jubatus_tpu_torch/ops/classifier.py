"""Multiclass linear classifier: perceptron / PA / PA1 / PA2 / CW / AROW /
NHERD (counterpart of ``jubatus_tpu/ops/classifier.py``).

The JAX package writes these as jitted XLA programs; here they are plain
PyTorch on whatever device the state lives on. Same state layout, same
update rules, same masking:

- Weights are dense [L, D] float32 tables over the hashed feature space,
  split as ``w`` (master, as of the last mix) + ``dw`` (local diff);
  training scatters into ``dw`` only. CW / AROW / NHERD keep the diagonal
  covariance as a precision (1/sigma), ``prec`` + ``dprec``; the other
  methods carry (1, 1) placeholders.
- ``train_batch_parallel`` decides every example against the batch-start
  snapshot and lands all updates in two scatter-adds;
  ``train_batch_sequential`` is the exact per-example semantics (a plain
  Python loop over the examples here, ``lax.scan`` in the JAX package).
- The schema paths take one index vector shared by the whole batch and run
  the step as dense products over the [L, K] submatrix.

Where this differs from the JAX package, and why:

- The state is updated in place (JAX donates it): ``train_*`` and
  ``put_diff`` write into the tensors they were given and return the same
  state object's tensors. Callers that keep an old state must clone it.
- Scatters are ``index_put_(..., accumulate=True)``, which sums duplicate
  indices as ``.at[...].add`` does (``t[i] += v`` keeps one of them). On
  the CPU it adds serially in index order; on CUDA it sorts the indices
  and adds each run of duplicates in order, and under
  ``torch.use_deterministic_algorithms(True)`` a step reproduces itself
  bit for bit.
- ``param`` is held as a float32 tensor, as the JAX jit traces it, so
  ``1 / (2 * param)`` and ``x2_vec / r`` round in float32.
- Gathers fetch ``w`` and ``dw`` at the indices and add the two: the same
  values as gathering the sum, without forming ``w + dw`` over all of D.
- Products and sums over K run in PyTorch's order, not XLA's, so scores
  and updates agree with the JAX package within a stated tolerance
  (``tests/test_torch_classifier_ops.py``), not bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from jubatus_tpu_torch import resolve_device

METHODS = ("perceptron", "PA", "PA1", "PA2", "CW", "AROW", "NHERD")
CONFIDENCE_METHODS = ("CW", "AROW", "NHERD")

_NEG = -1e30


class ClassifierState(NamedTuple):
    """w, dw: [L, D] float32 master weights / local diff; prec, dprec:
    [L, D] float32 precision master / diff for the confidence methods,
    (1, 1) placeholders for the others."""

    w: torch.Tensor
    dw: torch.Tensor
    prec: torch.Tensor
    dprec: torch.Tensor


def init_state(num_labels: int, dim: int, confidence: bool,
               device=None) -> ClassifierState:
    dev = resolve_device(device)
    shape = (num_labels, dim)
    cshape = shape if confidence else (1, 1)
    return ClassifierState(
        w=torch.zeros(shape, dtype=torch.float32, device=dev),
        dw=torch.zeros(shape, dtype=torch.float32, device=dev),
        prec=torch.ones(cshape, dtype=torch.float32, device=dev),
        dprec=torch.zeros(cshape, dtype=torch.float32, device=dev),
    )


def grow_labels(state: ClassifierState, new_num_labels: int) -> ClassifierState:
    """Label-capacity growth: new rows start at the init values."""
    L = state.w.shape[0]
    if new_num_labels <= L:
        return state
    pad = new_num_labels - L

    def _pad(a: torch.Tensor, fill: float) -> torch.Tensor:
        if a.shape == (1, 1):
            return a
        return torch.cat([a, a.new_full((pad, a.shape[1]), fill)], dim=0)

    return ClassifierState(w=_pad(state.w, 0.0), dw=_pad(state.dw, 0.0),
                           prec=_pad(state.prec, 1.0),
                           dprec=_pad(state.dprec, 0.0))


def _f32(x: Any, device: torch.device) -> torch.Tensor:
    """A float32 scalar tensor: a parameter as the JAX jit traces it."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(x), device=device)


def decide_updates(s, labels, label_mask, x2, v, x2_vec, param, *, method):
    """The shared per-batch update decision (parallel and schema paths).

    s [B, L] raw scores, labels [B], label_mask [L] bool, x2 / v [B],
    x2_vec [B, K]. Returns (wrong [B], alpha [B], alpha_w [B], dp [B, K] or
    None): alpha scales the correct row's update, alpha_w the rival's. With
    no rival label the rival score is taken as 0 and alpha_w is 0."""
    B = s.shape[0]
    rows = torch.arange(B, device=s.device)
    s = torch.where(label_mask[None, :], s, _NEG)
    s_correct = s[rows, labels]
    s_masked = s.clone()
    s_masked[rows, labels] = _NEG
    s_wrong = torch.amax(s_masked, dim=1)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    wrong = torch.argmax(s_masked, dim=1)
    no_rival = s_wrong <= _NEG / 2
    margin = s_correct - torch.where(no_rival, 0.0, s_wrong)
    loss = torch.clamp_min(1.0 - margin, 0.0)
    live = x2 > 0.0
    alpha, dp = _alpha_and_prec(method, param, margin, loss, x2, v, x2_vec)
    alpha = torch.where(live, alpha, 0.0)
    alpha_w = torch.where(no_rival, 0.0, alpha)
    if dp is not None:
        dp = torch.where((live & (alpha > 0.0))[:, None], dp, 0.0)
    return wrong, alpha, alpha_w, dp


def _alpha_and_prec(method: str, param, margin, loss, x2, v, x2_vec):
    """Per-method update size and precision increment (per feature).

    margin / loss / x2 / v are 0-d (sequential path) or [B] (parallel
    path); x2_vec has one more trailing [K] axis. ``param`` is a float32
    tensor. Each expression keeps the JAX package's evaluation order."""

    def vec(a):
        return a[..., None] if x2_vec.dim() > a.dim() else a

    x2s = torch.clamp_min(x2, 1e-12)
    if method == "perceptron":
        return torch.where(margin <= 0.0, 1.0, 0.0), None
    if method == "PA":
        return torch.where(loss > 0.0, loss / (2.0 * x2s), 0.0), None
    if method == "PA1":
        return torch.where(loss > 0.0,
                           torch.minimum(param, loss / (2.0 * x2s)), 0.0), None
    if method == "PA2":
        return torch.where(loss > 0.0,
                           loss / (2.0 * x2s + 1.0 / (2.0 * param)), 0.0), None
    if method == "AROW":
        r = param
        beta = 1.0 / (v + r)
        alpha = torch.where(loss > 0.0, loss * beta, 0.0)
        dp = torch.where(vec(loss) > 0.0, x2_vec / r, 0.0)
        return alpha, dp
    if method == "NHERD":
        r = param
        alpha = torch.where(loss > 0.0, loss / (v + r), 0.0)
        dp = torch.where(vec(loss) > 0.0,
                         x2_vec * vec(v + 2.0 * r) / (r * r), 0.0)
        return alpha, dp
    if method == "CW":
        phi = param
        m = margin
        a = 1.0 + 2.0 * phi * m
        vs = torch.clamp_min(v, 1e-12)
        disc = torch.clamp_min(a * a - 8.0 * phi * (m - phi * vs), 0.0)
        alpha = torch.clamp_min((-a + torch.sqrt(disc)) / (4.0 * phi * vs), 0.0)
        dp = 2.0 * vec(alpha) * phi * x2_vec
        return alpha, dp
    raise ValueError(f"unknown classifier method {method!r}")


def _gather_cols(a: torch.Tensor, da: torch.Tensor,
                 flat_idx: torch.Tensor) -> torch.Tensor:
    """(a + da)[:, flat_idx] without forming a + da over all of D."""
    return a.index_select(1, flat_idx) + da.index_select(1, flat_idx)


def scores(state: ClassifierState, idx: torch.Tensor, val: torch.Tensor,
           label_mask: torch.Tensor) -> torch.Tensor:
    """idx / val [B, K], label_mask [L] bool → [B, L] margins, dead labels
    at -1e30."""
    B, K = idx.shape
    g = _gather_cols(state.w, state.dw, idx.reshape(-1)).view(-1, B, K)
    s = (g * val[None]).sum(-1).T
    return torch.where(label_mask[None, :], s, _NEG)


def train_batch_parallel(state: ClassifierState, idx: torch.Tensor,
                         val: torch.Tensor, labels: torch.Tensor,
                         label_mask: torch.Tensor, param, *,
                         method: str) -> ClassifierState:
    """Vectorized microbatch update: every example decides against the
    batch-start snapshot; the updates land in two scatter-adds."""
    confidence = method in CONFIDENCE_METHODS
    w, dw, prec, dprec = state
    p = _f32(param, w.device)
    B, K = idx.shape
    flat = idx.reshape(-1)
    cols = torch.arange(B, device=w.device)
    eff_g = _gather_cols(w, dw, flat).view(-1, B, K)               # [L, B, K]
    s = (eff_g * val[None]).sum(-1).T                              # [B, L]
    x2_vec = val * val
    x2 = x2_vec.sum(1)
    if confidence:
        p_g = _gather_cols(prec, dprec, flat).view(-1, B, K)       # [L, B, K]
        sig_c = 1.0 / p_g[labels, cols]                            # [B, K]
        wrong0, _, _, _ = decide_updates(
            s, labels, label_mask, x2, torch.zeros_like(x2), x2_vec, p,
            method=method)
        # no rival label: the rival carries the unit precision prior
        no_rival = label_mask.sum() < 2
        sig_w = torch.where(no_rival, 1.0, 1.0 / p_g[wrong0, cols])
        v = ((sig_c + sig_w) * x2_vec).sum(1)
    else:
        sig_c = sig_w = torch.ones_like(val)
        v = torch.zeros_like(x2)
    wrong, alpha, alpha_w, dp = decide_updates(
        s, labels, label_mask, x2, v, x2_vec, p, method=method)
    up_c = alpha[:, None] * sig_c * val
    up_w = alpha_w[:, None] * sig_w * val
    rows_c = labels[:, None].expand(B, K)
    rows_w = wrong[:, None].expand(B, K)
    dw.index_put_((rows_c, idx), up_c, accumulate=True)
    dw.index_put_((rows_w, idx), -up_w, accumulate=True)
    if confidence:
        dprec.index_put_((rows_c, idx), dp, accumulate=True)
        dprec.index_put_((rows_w, idx),
                         torch.where((alpha_w > 0.0)[:, None], dp, 0.0),
                         accumulate=True)
    return ClassifierState(w, dw, prec, dprec)


def scores_schema(state: ClassifierState, uidx: torch.Tensor,
                  val: torch.Tensor, label_mask: torch.Tensor) -> torch.Tensor:
    """Scores for a uniform-schema batch (every example carries ``uidx``
    [K]): one [B, K] x [K, L] product."""
    eff_sub = _gather_cols(state.w, state.dw, uidx)                # [L, K]
    s = val @ eff_sub.T
    return torch.where(label_mask[None, :], s, _NEG)


def _expand_combo(base_val: torch.Tensor, a_idx: torch.Tensor,
                  b_idx: torch.Tensor, mul_mask: torch.Tensor) -> torch.Tensor:
    """Combination slots of a uniform-schema batch from its [B, K0] base
    columns: slot s = base[:, a] * base[:, b] (mul) or + (add). Returns the
    [B, K0 + S] values aligned with uidx = concat(base_idx, slot_idx)."""
    va = base_val.index_select(1, a_idx)
    vb = base_val.index_select(1, b_idx)
    slots = torch.where(mul_mask[None, :], va * vb, va + vb)
    return torch.cat([base_val, slots], dim=1)


def scores_schema_combo(state: ClassifierState, uidx: torch.Tensor,
                        base_val: torch.Tensor, a_idx: torch.Tensor,
                        b_idx: torch.Tensor, mul_mask: torch.Tensor,
                        label_mask: torch.Tensor) -> torch.Tensor:
    return scores_schema(state, uidx,
                         _expand_combo(base_val, a_idx, b_idx, mul_mask),
                         label_mask)


def train_batch_schema(state: ClassifierState, uidx: torch.Tensor,
                       val: torch.Tensor, labels: torch.Tensor,
                       label_mask: torch.Tensor, param, *,
                       method: str) -> ClassifierState:
    """train_batch_parallel's semantics for a uniform-schema batch, as dense
    products over the [L, K] submatrix and one K-column scatter."""
    return _train_schema_impl(state, uidx, val, labels, label_mask, param,
                              method)


def train_batch_schema_combo(state: ClassifierState, uidx: torch.Tensor,
                             base_val: torch.Tensor, a_idx: torch.Tensor,
                             b_idx: torch.Tensor, mul_mask: torch.Tensor,
                             labels: torch.Tensor, label_mask: torch.Tensor,
                             param, *, method: str) -> ClassifierState:
    """train_batch_schema with the combination slots expanded on the
    device; ``uidx`` holds no duplicate index across base and slots."""
    return _train_schema_impl(
        state, uidx, _expand_combo(base_val, a_idx, b_idx, mul_mask), labels,
        label_mask, param, method)


def _train_schema_impl(state, uidx, val, labels, label_mask, param, method):
    confidence = method in CONFIDENCE_METHODS
    w, dw, prec, dprec = state
    p = _f32(param, w.device)
    L = w.shape[0]
    K = uidx.shape[0]
    eff_sub = _gather_cols(w, dw, uidx)                            # [L, K]
    s = val @ eff_sub.T                                            # [B, L]
    x2_vec = val * val
    x2 = x2_vec.sum(1)
    if confidence:
        sig_sub = 1.0 / _gather_cols(prec, dprec, uidx)            # [L, K]
        sig_c = sig_sub[labels]                                    # [B, K]
        wrong0, _, _, _ = decide_updates(
            s, labels, label_mask, x2, torch.zeros_like(x2), x2_vec, p,
            method=method)
        no_rival = label_mask.sum() < 2
        sig_w = torch.where(no_rival, 1.0, sig_sub[wrong0])
        v = ((sig_c + sig_w) * x2_vec).sum(1)
    else:
        sig_c = sig_w = torch.ones_like(val)
        v = torch.zeros_like(x2)
    wrong, alpha, alpha_w, dp = decide_updates(
        s, labels, label_mask, x2, v, x2_vec, p, method=method)
    up_c = alpha[:, None] * sig_c * val
    up_w = alpha_w[:, None] * sig_w * val
    onehot_c = torch.nn.functional.one_hot(labels.long(), L).to(val.dtype)
    onehot_w = torch.nn.functional.one_hot(wrong.long(), L).to(val.dtype)
    rows = torch.arange(L, device=w.device)[:, None].expand(L, K)
    cols = uidx[None, :].expand(L, K)
    dw.index_put_((rows, cols), onehot_c.T @ up_c - onehot_w.T @ up_w,
                  accumulate=True)
    if confidence:
        dp_w = torch.where((alpha_w > 0.0)[:, None], dp, 0.0)
        dprec.index_put_((rows, cols), onehot_c.T @ dp + onehot_w.T @ dp_w,
                         accumulate=True)
    return ClassifierState(w, dw, prec, dprec)


def train_batch_sequential(state: ClassifierState, idx: torch.Tensor,
                           val: torch.Tensor, labels: torch.Tensor,
                           label_mask: torch.Tensor, param, *,
                           method: str) -> ClassifierState:
    """Exact per-example online semantics: one example at a time, each
    against the state the previous one left. A plain loop of small
    PyTorch ops (about 20 launches per example on the card)."""
    confidence = method in CONFIDENCE_METHODS
    w, dw, prec, dprec = state
    p = _f32(param, w.device)
    mask_scores = torch.where(label_mask, 0.0, _NEG).to(torch.float32)
    for b in range(idx.shape[0]):
        e_idx, e_val = idx[b], val[b]
        e_label = int(labels[b])
        w_g = _gather_cols(w, dw, e_idx)                           # [L, K]
        s = (w_g * e_val).sum(-1) + mask_scores                    # [L]
        s_correct = s[e_label]
        s_m = s.clone()
        s_m[e_label] = _NEG
        s_wrong = torch.amax(s_m)
        wrong = int(torch.argmax(s_m))
        no_rival = s_wrong <= _NEG / 2
        margin = s_correct - torch.where(no_rival, 0.0, s_wrong)
        loss = torch.clamp_min(1.0 - margin, 0.0)
        x2_vec = e_val * e_val
        x2 = x2_vec.sum()
        live = x2 > 0.0
        if confidence:
            p_g = _gather_cols(prec, dprec, e_idx)
            sig_c = 1.0 / p_g[e_label]
            sig_w = torch.where(no_rival, 1.0, 1.0 / p_g[wrong])
            v = ((sig_c + sig_w) * x2_vec).sum()
        else:
            sig_c = sig_w = torch.ones_like(e_val)
            v = torch.zeros_like(x2)
        alpha, dp = _alpha_and_prec(method, p, margin, loss, x2, v, x2_vec)
        alpha = torch.where(live, alpha, 0.0)
        alpha_w = torch.where(no_rival, 0.0, alpha)
        dw[e_label].index_put_((e_idx,), alpha * sig_c * e_val,
                               accumulate=True)
        dw[wrong].index_put_((e_idx,), -alpha_w * sig_w * e_val,
                             accumulate=True)
        if confidence:
            dp = torch.where(live & (alpha > 0.0), dp, 0.0)
            dprec[e_label].index_put_((e_idx,), dp, accumulate=True)
            dprec[wrong].index_put_((e_idx,),
                                    torch.where(alpha_w > 0.0, dp, 0.0),
                                    accumulate=True)
    return ClassifierState(w, dw, prec, dprec)


def train_batch(state: ClassifierState, idx, val, labels, label_mask, param,
                *, method: str, mode: str = "parallel") -> ClassifierState:
    """Train dispatcher: "parallel" (batch-start snapshot) or "sequential"
    (exact per-example semantics)."""
    if mode == "parallel":
        fn = train_batch_parallel
    elif mode == "sequential":
        fn = train_batch_sequential
    else:
        raise ValueError(f"unknown train mode {mode!r}")
    return fn(state, idx, val, labels, label_mask, param, method=method)


# -- mixable protocol -------------------------------------------------------
def get_diff(state: ClassifierState) -> Dict[str, Any]:
    """Local diff (copies; mix = elementwise sum)."""
    return {"dw": state.dw.clone(), "dprec": state.dprec.clone(),
            "count": 1.0}


def mix_diffs(lhs: Dict[str, Any], rhs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: lhs[k] + rhs[k] for k in lhs}


def _on(x: Any, like: torch.Tensor) -> torch.Tensor:
    """A diff leaf (host numpy or a tensor) as float32 on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(like.device)


def put_diff(state: ClassifierState, diff: Dict[str, Any]) -> ClassifierState:
    """Absorb the summed diff into the master (average weights, sum
    precision) and zero the local diffs, in place. Takes row-trimmed
    diffs ([n, D] with n <= L, applied to the leading rows), as host numpy
    or tensors."""
    w, dw, prec, dprec = state
    n = torch.clamp_min(_f32(np.float32(diff["count"]), w.device), 1.0)
    ddw = _on(diff["dw"], w)
    ddp = _on(diff["dprec"], prec)
    w[:ddw.shape[0]] += ddw / n
    prec[:ddp.shape[0]] += ddp
    dw.zero_()
    dprec.zero_()
    return ClassifierState(w, dw, prec, dprec)
