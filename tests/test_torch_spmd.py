"""The port's replica × shard train step and in-process mix
(jubatus_tpu_torch/parallel/spmd.py and parallel/mix.py) against the JAX
package's (tests/test_spmd.py, and the LocalMixGroup cases of
tests/test_classifier_driver.py). The port's grids are logical CPU
devices standing in for the JAX side's eight virtual ones. The same
seeded batches go through both. The step's tables agree within
STEP_RTOL / STEP_ATOL: each replica's step is the port's classifier step,
whose score sums over K add in another order than the JAX body's einsum
(1-2 ULP), as tests/test_torch_classifier_ops.py states; the replica sum
itself adds in replica order. The group's folded models agree bit for
bit (bf16 sums in float32 and rounds once, as XLA's does)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jubatus_tpu.core import Datum as JDatum
from jubatus_tpu.models import ClassifierDriver as JClassifierDriver
from jubatus_tpu.ops import classifier as JC
from jubatus_tpu.parallel import LocalMixGroup as JLocalMixGroup
from jubatus_tpu.parallel.mesh import grid_mesh as jgrid
from jubatus_tpu.parallel.mesh import replica_mesh as jreplica
from jubatus_tpu.parallel.spmd import init_spmd_state as jinit
from jubatus_tpu.parallel.spmd import make_spmd_train_step as jstep
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.classifier import ClassifierDriver
from jubatus_tpu_torch.models.stat import StatDriver
from jubatus_tpu_torch.parallel.mesh import grid_mesh, replica_mesh
from jubatus_tpu_torch.parallel.mix import LocalMixGroup, Mixable
from jubatus_tpu_torch.parallel.spmd import (init_spmd_state,
                                             make_spmd_train_step)


STEP_RTOL = 1e-5
STEP_ATOL = 1e-6


def _data(rng, r, b, k, dim, labels_n):
    idx = rng.integers(1, dim, size=(r, b, k), dtype=np.int32)
    val = rng.normal(size=(r, b, k)).astype(np.float32)
    y = rng.integers(0, labels_n, size=(r, b), dtype=np.int32)
    return idx, val, y


def _meshes(kind):
    if kind == "2d":
        return jgrid(4, 2), grid_mesh(4, 2, devices=["cpu"] * 8)
    return jreplica(4), replica_mesh(4, devices=["cpu"] * 8)


@pytest.mark.parametrize("method", ["AROW", "PA1", "CW"])
@pytest.mark.parametrize("mesh_kind", ["1d", "2d"])
def test_spmd_step_matches_jax_and_single_device_reference(mesh_kind,
                                                           method, rng):
    jmesh, mesh = _meshes(mesh_kind)
    r, dim, L, B, K = 4, 128, 4, 8, 4
    mask = np.ones(L, dtype=bool)
    idx, val, y = _data(rng, r, B, K, dim, L)
    confidence = method in JC.CONFIDENCE_METHODS
    out = make_spmd_train_step(mesh, method=method, param=1.0, mix=True)(
        init_spmd_state(mesh, L, dim, confidence=confidence),
        idx, val, y, mask)
    jout = jstep(jmesh, method=method, param=1.0, mix=True)(
        jinit(jmesh, L, dim, confidence=confidence), jnp.asarray(idx),
        jnp.asarray(val), jnp.asarray(y), jnp.asarray(mask))
    fields = ("w", "dw", "prec", "dprec") if confidence else ("w", "dw")
    for f in fields:
        np.testing.assert_allclose(out.stacked(f),
                                   np.asarray(getattr(jout, f)),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
    # the single-device reference of the JAX test: train each replica's
    # batch on one state copy, sum the diffs, average
    diffs = []
    for i in range(r):
        st = JC.init_state(L, dim, True)
        st = JC.train_batch(st, jnp.asarray(idx[i]), jnp.asarray(val[i]),
                            jnp.asarray(y[i]), jnp.asarray(mask), 1.0,
                            method=method)
        diffs.append(JC.get_diff(st))
    total = diffs[0]
    for d in diffs[1:]:
        total = JC.mix_diffs(total, d)
    w_ref = np.asarray(total["dw"]) / r
    for i in range(r):
        np.testing.assert_allclose(out.stacked("w")[i], w_ref, rtol=1e-5,
                                   atol=1e-6)


def test_spmd_no_mix_keeps_local_diffs(rng):
    mesh = replica_mesh(2, devices=["cpu"] * 2)
    r, dim, L, B, K = 2, 64, 2, 4, 2
    mask = np.ones(L, dtype=bool)
    idx, val, y = _data(rng, r, B, K, dim, L)
    out = make_spmd_train_step(mesh, method="PA", param=1.0, mix=False)(
        init_spmd_state(mesh, L, dim), idx, val, y, mask)
    dw = out.stacked("dw")
    assert np.abs(dw).sum() > 0
    assert np.abs(out.stacked("w")).sum() == 0.0
    assert not np.allclose(dw[0], dw[1])
    jmesh = jreplica(2)
    jout = jstep(jmesh, method="PA", param=1.0, mix=False)(
        jinit(jmesh, L, dim), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_allclose(dw, np.asarray(jout.dw), rtol=STEP_RTOL,
                               atol=STEP_ATOL)


def test_spmd_grid_rejects_too_few_devices():
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        grid_mesh(4, 2, devices=["cpu"] * 4)


# -- LocalMixGroup ------------------------------------------------------------

CFG = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
       "converter": {"string_rules": [{"key": "*", "type": "space",
                                       "sample_weight": "tf",
                                       "global_weight": "bin"}],
                     "num_rules": [{"key": "*", "type": "num"}]}}
SPAM = ["buy cheap pills now", "cheap pills discount buy now",
        "discount pills buy"]
HAM = ["meeting notes for tuesday", "tuesday agenda and meeting notes",
       "agenda for the meeting"]
EGGS = ["fresh organic eggs from the farm", "farm eggs organic dozen",
        "dozen fresh eggs"]


def _rows(D, label, texts):
    return [(label, D({"t": t})) for t in texts]


@pytest.mark.parametrize("mesh", [False, True], ids=["host", "mesh"])
def test_local_mix_group_matches_jax(mesh):
    """Replicas with different label sets: after the group's schema sync
    and mix, every port replica holds the JAX replicas' model bit for
    bit, through the host fold or the replica grid."""
    def run(Driver, D, Group, grid, **kw):
        ds = [Driver(CFG, dim_bits=10, **kw) for _ in range(2)]
        for _ in range(3):
            ds[0].train(_rows(D, "spam", SPAM) + _rows(D, "ham", HAM))
            ds[1].train(_rows(D, "eggs", EGGS) + _rows(D, "ham", HAM))
        group = Group(ds, mesh=grid) if grid is not None else Group(ds)
        group.mix()
        return ds, group

    port, group = run(ClassifierDriver, Datum, LocalMixGroup,
                      replica_mesh(2, devices=["cpu"] * 2) if mesh else None,
                      device="cpu")
    jax_ds, _ = run(JClassifierDriver, JDatum, JLocalMixGroup,
                    jreplica(2, devices=jax.devices()[:2]) if mesh
                    else None)
    assert port[0].get_schema() == port[1].get_schema() == \
        ["eggs", "ham", "spam"]
    assert port[0].get_labels() == {"spam": 9, "ham": 18, "eggs": 9}
    for p, j in zip(port, jax_ds):
        pp, jp = p.pack(), j.pack()
        for key in ("w", "prec", "label_counts"):
            assert np.array_equal(np.asarray(pp[key]), np.asarray(jp[key])), key
    if mesh:
        assert {"ship_ms", "reduce_ms", "readback_ms",
                "payload_mb"} <= set(group.last_phases)
    assert all(isinstance(m, Mixable)
               for m in port[0].get_mixables().values())


def test_local_mix_group_folds_custom_mixes_on_the_host():
    """Stat's dict-shaped diff has a mix of its own: the group folds it on
    the host even with a grid, and every replica answers as the JAX
    package's replicas do after its group's mix."""
    from jubatus_tpu.models import StatDriver as JStatDriver

    def run(make, Group, grid):
        ds = [make() for _ in range(3)]
        for i, d in enumerate(ds):
            for v in range(4):
                d.push(f"k{v % 2}", float(3 * i + v) - 1.5)
        Group(ds, mesh=grid).mix()
        return [[getattr(d, m)(k) for k in ("k0", "k1")
                 for m in ("sum", "stddev", "max", "min", "entropy")]
                for d in ds]

    got = run(lambda: StatDriver({"window_size": 16}, device="cpu"),
              LocalMixGroup, replica_mesh(3, devices=["cpu"] * 3))
    want = run(lambda: JStatDriver({"window_size": 16}), JLocalMixGroup,
               jreplica(3, devices=jax.devices()[:3]))
    assert got == want
    with pytest.raises(ValueError, match="at least one driver"):
        LocalMixGroup([])
