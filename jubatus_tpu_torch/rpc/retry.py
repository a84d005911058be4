"""Retry policy + retry budget for the request plane (copy of
``jubatus_tpu/rpc/retry.py``).

Two guards stand between a transient failure and a retry storm:

- **RetryPolicy** — capped exponential backoff with FULL jitter
  (sleep ~ U(0, min(cap, base * 2^attempt)), the AWS-architecture result:
  full jitter de-synchronizes a thundering herd better than equal
  jitter). The sleep is additionally clamped to the call's remaining
  deadline budget (rpc/deadline.py) — no sleeping past the point where
  the answer is useless.
- **RetryBudget** — a token bucket that caps RETRY traffic to a fraction
  of real traffic (default 10%, the gRPC/Finagle convention): every
  first attempt deposits ``ratio`` tokens, every retry withdraws one.
  Under a healthy cluster the bucket stays full and every transient blip
  gets its retry; under a degraded cluster retries self-limit to ~10%
  extra load instead of multiplying the overload. A denied withdrawal is
  counted (``rpc.retry_budget_exhausted``) and the original error
  propagates.

Only IDEMPOTENT methods are ever retried (framework/idl.py owns the
per-method classification); effectful calls keep propagate-don't-
double-apply semantics no matter what these knobs say.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape for one logical call's retry loop."""

    #: total attempts including the first (3 = first try + 2 retries)
    max_attempts: int = 3
    #: backoff base before the exponential (seconds)
    base_sleep: float = 0.025
    #: backoff ceiling (seconds)
    max_sleep: float = 0.25

    def sleep_for(self, attempt: int,
                  remaining: Optional[float] = None,
                  rng: Optional[random.Random] = None) -> float:
        """Full-jitter sleep before retry number ``attempt`` (1-based),
        clamped to the remaining deadline budget."""
        cap = min(self.max_sleep, self.base_sleep * (2.0 ** attempt))
        sleep = (rng or _rng).uniform(0.0, cap)
        if remaining is not None:
            # leave some budget for the attempt itself
            sleep = max(0.0, min(sleep, remaining * 0.5))
        return sleep


#: module RNG for jitter: deterministic seeding is pointless here (tests
#: assert on counts, not sleep values) but a shared instance avoids
#: reseeding per call
_rng = random.Random()

DEFAULT_POLICY = RetryPolicy()


class RetryBudget:
    """Token bucket capping retries to ``ratio`` of first-attempt traffic.

    Thread-safe; one instance per client (RpcClient) or per routing tier
    (Proxy). Starts full so cold clients can retry their very first
    failures (min_tokens also bounds how negative a quiet client's
    goodwill can get: zero)."""

    def __init__(self, ratio: float = 0.1, max_tokens: float = 10.0) -> None:
        self.ratio = float(ratio)
        self.max_tokens = float(max_tokens)
        # ratio 0 means retries are OFF: start (and stay) empty
        self._tokens = float(max_tokens) if self.ratio > 0 else 0.0
        self._lock = threading.Lock()
        #: lifetime counters (status/debugging)
        self.deposits = 0
        self.withdrawals = 0
        self.denials = 0

    def deposit(self) -> None:
        """A first attempt happened: grow the budget by ``ratio``."""
        with self._lock:
            self._tokens = min(self.max_tokens, self._tokens + self.ratio)
            self.deposits += 1

    def try_withdraw(self) -> bool:
        """Spend one token for a retry; False when the budget is dry."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.withdrawals += 1
                return True
            self.denials += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def status(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 3),
                    "ratio": self.ratio,
                    "deposits": self.deposits,
                    "withdrawals": self.withdrawals,
                    "denials": self.denials}
