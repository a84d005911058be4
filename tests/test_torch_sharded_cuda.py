"""The feature-sharded classifier step on the card (``cuda`` marker: skips
without an NVIDIA GPU). On the same batches, the port's sharded card step
is held to the port's flat card step, to its sharded CPU step, and to the
JAX package's sharded step on the conftest's virtual CPU mesh.

Tolerance: rtol = atol = 3e-5, as in tests/test_torch_sharded_model.py
and the JAX package's own sharded tests: the cross-shard sums, XLA's
K-sums and the card's scatter add in other orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jubatus_tpu_torch.parallel import sharded_model as sm
from jubatus_tpu_torch.parallel.mesh import ShardMesh

TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _joined(leaf) -> np.ndarray:
    return (torch.cat(leaf, -1) if sm.is_blocks(leaf) else leaf).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("AROW", "PA1", "CW"))
def test_sharded_card_step_tracks_the_flat_card_step(cuda, method):
    """4 logical shards of the card against the flat card step, the
    sharded CPU step and the JAX package's sharded step, all fed the same
    three batches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from jubatus_tpu.ops import classifier as jcops
    from jubatus_tpu.parallel import sharded_model as jsm
    from jubatus_tpu_torch.ops import classifier as cops

    rng = np.random.default_rng(3)
    L, D, B, K, S = 4, 1 << 14, 512, 32, 4
    conf = method in cops.CONFIDENCE_METHODS
    mask = np.array([True, True, True, False])
    card_mesh, cpu_mesh = ShardMesh([cuda] * S), ShardMesh(["cpu"] * S)
    jmesh = Mesh(np.asarray(jax.devices()[:S]), ("shard",))
    flat = cops.init_state(L, D, conf, device=cuda)
    card = sm.place_state(card_mesh, cops.init_state(L, D, conf, device=cuda),
                          D)
    cpu = sm.place_state(cpu_mesh, cops.init_state(L, D, conf, device="cpu"),
                         D)
    jst = jsm.place_state(jmesh, jcops.init_state(L, D, conf), D)
    for _ in range(3):
        batch = (rng.integers(0, D, (B, K)).astype(np.int32),
                 rng.normal(size=(B, K)).astype(np.float32),
                 rng.integers(0, 3, B).astype(np.int32), mask)
        host = [torch.from_numpy(a) for a in batch]
        dev = [a.to(cuda) for a in host]
        flat = cops.train_batch(flat, *dev, 1.0, method=method)
        card = sm.train_batch(card_mesh, card, *dev, 1.0, method=method)
        cpu = sm.train_batch(cpu_mesh, cpu, *host, 1.0, method=method)
        jst = jsm.train_batch(jmesh, jst, *(jnp.asarray(a) for a in batch),
                              1.0, method=method)
    for name, a, f, c, j in zip(("w", "dw", "prec", "dprec"), card, flat,
                                cpu, jst):
        got = _joined(a)
        np.testing.assert_allclose(got, f.cpu().numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(got, _joined(c), err_msg=name, **TOL)
        np.testing.assert_allclose(got, np.asarray(j), err_msg=name, **TOL)
