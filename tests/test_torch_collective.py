"""The port's collective data plane (jubatus_tpu_torch/parallel/
collective.py) against the JAX package's (tests/test_collective_pipeline.py
and the all-reduce cases of tests/test_mix_compression.py).

World of one: both packages take the same seeded numpy inputs and their
totals are compared bit for bit — the chunk planner, padded tails, the
batched small leaves, device-resident leaves, the int8 quantize round
trip with both error-feedback chains, and the hierarchical mode over
in-process lanes (the JAX side over the conftest's eight virtual CPU
devices). The port's int8 arithmetic rounds as the JAX package's jitted
programs do on the CPU (scales as a multiply by 1/127's float32
reciprocal, the residual and ring adds fused), so world-1 int8 is
bit-equal over many rounds.

Several ranks: real gloo worlds of 3 ranks (each wire mode) and 4 ranks
(``2x2`` hierarchical), spawned on this host and bounded by WORLD_TIMEOUT.
Every rank's totals must be bit-equal to every other rank's. Against the
JAX package (its ring and tiers called directly over virtual devices on
the same per-member inputs): int8 bit for bit; ``off`` within
RTOL_OFF, because gloo's ring adds in its own order; ``bf16`` within
BF16_TOL of the sum of the members' magnitudes, because XLA sums bf16 in
float32 and rounds once where gloo rounds each partial sum (two
roundings of at most 2^-9 of a partial, one of the JAX total: under
3 x 2^-9 of the magnitudes' sum).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jubatus_tpu.parallel import collective as JC
from jubatus_tpu.parallel.mesh import replica_mesh as j_replica_mesh
from jubatus_tpu.parallel.mix import allreduce_diffs as j_allreduce
from jubatus_tpu_torch.parallel import collective as TC
from jubatus_tpu_torch.parallel import multihost
from jubatus_tpu_torch.parallel.collective import (
    QUANT_BLOCK,
    ChunkIntegrityError,
    ErrorFeedback,
    _norm_compress,
    psum_pytree,
    psum_pytree_start,
)
from jubatus_tpu_torch.parallel.mesh import host_topology, replica_mesh
from jubatus_tpu_torch.parallel.mix import allreduce_diffs
from jubatus_tpu_torch.utils import faults

RNG = np.random.default_rng(7)
WORLD_TIMEOUT = 60.0
RTOL_OFF = 1e-6
BF16_TOL = 2.0 ** -7   # of the members' summed magnitudes (see above)


def _lanes(topo: str):
    """The single process's eight logical lanes, regridded (the JAX tests'
    eight virtual CPU devices)."""
    return host_topology(devices=["cpu"] * 8, override=topo)


def _both(diff, **kw):
    """(JAX total, port total) of one world-1 round on copies of diff."""
    topo = kw.pop("topology", None)
    j = JC.psum_pytree({k: np.array(v) for k, v in diff.items()},
                       topology=topo, **kw)
    t = psum_pytree({k: np.array(v) for k, v in diff.items()},
                    topology=_lanes(topo) if topo else None, **kw)
    return j, t


def _same(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), float(np.abs(a.astype(np.float64)
                                             - b).max())


# -- world of one -------------------------------------------------------------

def test_chunked_f32_bit_identical_to_unchunked():
    diff = {"w": RNG.normal(size=(3, 700_001)).astype(np.float32),
            "b": RNG.normal(size=(64,)).astype(np.float32)}
    phases: dict = {}
    chunked = psum_pytree(diff, chunk_mb=0.25, phases=phases)
    unchunked = psum_pytree(diff, chunk_mb=1 << 20)
    assert phases["chunks"] > 1
    assert np.array_equal(chunked["w"], diff["w"])
    assert np.array_equal(chunked["w"], unchunked["w"])
    assert chunked["w"].dtype == np.float32
    assert np.array_equal(chunked["b"], unchunked["b"])
    j, _ = _both(diff, chunk_mb=0.25)
    _same(j["w"], chunked["w"])


def test_chunk_exact_multiple_no_tail():
    diff = {"w": RNG.normal(size=(1 << 16,)).astype(np.float32)}
    phases: dict = {}
    out = psum_pytree(diff, chunk_mb=64 / 1024, phases=phases)
    jph: dict = {}
    JC.psum_pytree(diff, chunk_mb=64 / 1024, phases=jph)
    assert phases["chunks"] == jph["chunks"] == 4
    assert np.array_equal(out["w"], diff["w"])


def test_chunked_bf16_matches_compress_contract():
    diff = {"w": RNG.normal(size=(2, 300_000)).astype(np.float32)}
    chunked = psum_pytree(diff, compress=True, chunk_mb=0.25)
    unchunked = psum_pytree(diff, compress=True, chunk_mb=1 << 20)
    expect = torch.from_numpy(diff["w"]).to(torch.bfloat16).float().numpy()
    assert chunked["w"].dtype == np.float32
    assert np.array_equal(chunked["w"], unchunked["w"])
    assert np.array_equal(chunked["w"], expect)
    j, _ = _both(diff, compress=True, chunk_mb=0.25)
    _same(j["w"], chunked["w"])


def test_compress_halves_reported_payload():
    diff = {"w": np.ones((256, 1024), np.float32)}
    ph_f32: dict = {}
    ph_bf16: dict = {}
    psum_pytree(diff, phases=ph_f32, chunk_mb=0.25)
    psum_pytree(diff, compress=True, phases=ph_bf16, chunk_mb=0.25)
    assert ph_bf16["payload_mb"] == round(ph_f32["payload_mb"] / 2, 2)
    jph: dict = {}
    JC.psum_pytree(diff, compress=True, phases=jph, chunk_mb=0.25)
    for key in ("payload_mb", "wire_mb", "chunks", "chunk_mb", "quant",
                "topo", "wire_bytes_per_host"):
        assert ph_bf16[key] == jph[key], key


def test_non_f32_dtype_rides_chunks_exactly():
    diff = {"idx": np.arange(200_000, dtype=np.int32)}
    out = psum_pytree(diff, chunk_mb=0.25)
    assert out["idx"].dtype == np.int32
    assert np.array_equal(out["idx"], diff["idx"])
    out_c = psum_pytree(diff, compress=True, chunk_mb=0.25)
    assert np.array_equal(out_c["idx"], diff["idx"])


def test_scalar_and_empty_pytrees():
    out = psum_pytree({"c": np.float32(2.5),
                       "d": torch.tensor(1.25, dtype=torch.float32)})
    assert float(out["c"]) == 2.5
    assert float(out["d"]) == 1.25
    phases: dict = {}
    assert psum_pytree({}, phases=phases) == {}
    assert phases["chunks"] == 0
    assert phases["overlap_ms_saved"] == 0.0


def test_device_resident_fast_path_world_of_1():
    """Tensor leaves enter with no host staging; prefer_device hands
    tensors back, bit-equal to the host path, and the caller's leaves are
    left as they were."""
    host = {"w": RNG.normal(size=(2, 400_000)).astype(np.float32),
            "b": RNG.normal(size=(16,)).astype(np.float32)}
    dev = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    out_dev = psum_pytree(dev, chunk_mb=0.25, prefer_device=True)
    assert isinstance(out_dev["w"], torch.Tensor)
    assert isinstance(out_dev["b"], torch.Tensor)
    out_host = psum_pytree(host, chunk_mb=0.25)
    assert np.array_equal(out_dev["w"].numpy(), out_host["w"])
    assert np.array_equal(out_dev["b"].numpy(), out_host["b"])
    out_mixed = psum_pytree(dev, chunk_mb=0.25)
    assert isinstance(out_mixed["w"], np.ndarray)
    assert np.array_equal(out_mixed["w"], out_host["w"])
    assert np.array_equal(dev["w"].numpy(), host["w"])


def test_mixed_host_device_tree_parity():
    diff = {"dw": torch.from_numpy(
                RNG.normal(size=(2, 350_001)).astype(np.float32)),
            "df": RNG.normal(size=(250_000,)).astype(np.float32),
            "count": torch.tensor(1.0, dtype=torch.float32)}
    phases: dict = {}
    out = psum_pytree(diff, chunk_mb=0.25, phases=phases)
    assert phases["chunks"] >= 2
    assert np.array_equal(out["dw"], diff["dw"].numpy())
    assert np.array_equal(out["df"], diff["df"])
    assert float(out["count"]) == 1.0
    j = JC.psum_pytree({"dw": jnp.asarray(diff["dw"].numpy()),
                        "df": diff["df"], "count": jnp.float32(1.0)},
                       chunk_mb=0.25)
    _same(j["dw"], out["dw"])


def test_64bit_leaves_still_refused():
    for mod in (JC, TC):
        with pytest.raises(ValueError, match="64-bit"):
            mod.psum_pytree({"x": np.zeros(4, np.float64)})
        with pytest.raises(ValueError, match="64-bit"):
            mod.psum_pytree({"x": np.zeros(1 << 18, np.int64)},
                            chunk_mb=0.25)
    with pytest.raises(ValueError, match="64-bit"):
        psum_pytree({"x": 1.0})  # a Python float is float64, as in JAX


def test_phase_accounting_keys_present():
    diff = {"w": RNG.normal(size=(1 << 18,)).astype(np.float32)}
    phases: dict = {}
    jph: dict = {}
    psum_pytree(diff, chunk_mb=0.25, phases=phases)
    JC.psum_pytree(diff, chunk_mb=0.25, phases=jph)
    assert set(jph) <= set(phases)
    for k in ("cast_ms", "ship_ms", "reduce_ms", "readback_ms",
              "payload_mb", "wire_mb", "wire_mb_ring_model", "chunks",
              "chunk_mb", "overlap_ms_saved"):
        assert phases[k] >= 0, (k, phases)
    for k in ("payload_mb", "wire_mb", "chunks", "chunk_mb", "quant",
              "topo", "wire_bytes_per_host", "intra_ms"):
        assert phases[k] == jph[k], k
    assert phases["quant"] == "off"


# -- int8 + error feedback, world of one ---------------------------------------

def test_compress_mode_enum_and_bool_compat():
    for arg, want in ((False, "off"), (True, "bf16"), ("off", "off"),
                      ("bf16", "bf16"), ("int8", "int8")):
        assert _norm_compress(arg) == JC._norm_compress(arg) == want
    with pytest.raises(ValueError, match="compress mode"):
        _norm_compress("int4")
    diff = {"w": RNG.normal(size=(2, 100_000)).astype(np.float32)}
    a = psum_pytree(diff, compress=True, chunk_mb=0.25)
    b = psum_pytree(diff, compress="bf16", chunk_mb=0.25)
    assert np.array_equal(a["w"], b["w"])


def test_block_quant_matches_the_jitted_quantizer():
    """Scales, int8 codes and the ship residual of one chunk, bit for bit
    against the JAX package's jitted ship quantizer."""
    ce = QUANT_BLOCK * 400
    x = RNG.normal(size=(ce,)).astype(np.float32)
    x[5] = 0.0
    x[QUANT_BLOCK:2 * QUANT_BLOCK] = 0.0  # an all-zero block: scale 1
    res = (RNG.normal(size=(ce,)) * 0.01).astype(np.float32)
    res[QUANT_BLOCK:2 * QUANT_BLOCK] = 0.0
    jq, js, jr = JC._quant_ship_fn(ce, QUANT_BLOCK)(jnp.asarray(x)[None],
                                                    jnp.asarray(res)[None])
    y = torch.from_numpy(x) + torch.from_numpy(res)
    q, s = TC._block_quant(y, QUANT_BLOCK)
    r = TC._add_dequant(y, q, s, QUANT_BLOCK, -1.0)
    _same(np.asarray(jq)[0], q.numpy())
    _same(np.asarray(js)[0], s.numpy())
    _same(np.asarray(jr)[0], r.numpy())
    assert s.numpy()[1] == 1.0


def test_int8_block_quant_error_bounded():
    w = RNG.normal(size=(2, 350_001)).astype(np.float32)
    w[0, 123] = 80.0
    out = psum_pytree({"w": w}, compress="int8", chunk_mb=0.25)
    err = np.abs(out["w"] - w).reshape(-1)
    flat = w.reshape(-1)
    pad = (-flat.size) % QUANT_BLOCK
    blocks = np.pad(flat, (0, pad)).reshape(-1, QUANT_BLOCK)
    bound = np.abs(blocks).max(axis=1) / 127.0 * 0.5 + 1e-6
    errp = np.pad(err, (0, pad)).reshape(-1, QUANT_BLOCK)
    assert (errp <= bound[:, None]).all()
    assert err[-QUANT_BLOCK:].max() <= 4.0 / 127.0
    j, _ = _both({"w": w}, compress="int8", chunk_mb=0.25)
    _same(j["w"], out["w"])


def test_int8_exact_for_small_and_non_f32_leaves():
    diff = {"w": RNG.normal(size=(2, 200_000)).astype(np.float32),
            "idx": np.arange(200_000, dtype=np.int32),
            "count": np.float32(17.0)}
    out = psum_pytree(diff, compress="int8", chunk_mb=0.25)
    assert np.array_equal(out["idx"], diff["idx"])
    assert float(out["count"]) == 17.0
    assert not np.array_equal(out["w"], diff["w"])


def test_int8_payload_accounting_near_4x():
    diff = {"w": np.ones((1 << 22,), np.float32)}
    ph32: dict = {}
    ph8: dict = {}
    jph8: dict = {}
    psum_pytree(diff, phases=ph32, chunk_mb=1.0)
    psum_pytree(diff, compress="int8", phases=ph8, chunk_mb=1.0)
    JC.psum_pytree(diff, compress="int8", phases=jph8, chunk_mb=1.0)
    assert ph8["quant"] == "int8"
    assert ph8["payload_mb"] == jph8["payload_mb"]
    assert 3.5 <= ph32["payload_mb"] / ph8["payload_mb"] <= 4.0


def test_int8_error_feedback_drift_gate():
    """R rounds of mixed totals, bit-equal to the JAX package's every
    round; with the residual the drift against f32 telescopes, without it
    the bias random-walks."""
    rng = np.random.default_rng(3)
    shape = (2, 200_000)
    rounds = 16
    ef, jef = ErrorFeedback(), JC.ErrorFeedback()
    s32 = np.zeros(shape, np.float32)
    s8 = np.zeros(shape, np.float32)
    s8n = np.zeros(shape, np.float32)
    drift_ef, drift_noef = [], []
    for _ in range(rounds):
        x = {"w": rng.normal(size=shape).astype(np.float32)}
        s32 += psum_pytree(x, chunk_mb=0.25)["w"]
        got = psum_pytree(x, compress="int8", chunk_mb=0.25,
                          feedback=ef)["w"]
        _same(JC.psum_pytree(x, compress="int8", chunk_mb=0.25,
                             feedback=jef)["w"], got)
        s8 += got
        s8n += psum_pytree(x, compress="int8", chunk_mb=0.25)["w"]
        drift_ef.append(float(np.linalg.norm(s8 - s32)))
        drift_noef.append(float(np.linalg.norm(s8n - s32)))
    assert ef.rounds == rounds
    assert drift_ef[-1] <= 1.5 * drift_ef[0], drift_ef
    assert drift_noef[-1] > 1.5 * drift_noef[0], drift_noef
    assert drift_noef[-1] > 2.0 * drift_ef[-1]
    norms = ef.norms()
    assert norms["contrib_residual_norm"] > 0 < norms["total_residual_norm"]


def test_int8_residual_commits_only_on_success():
    rng = np.random.default_rng(11)
    x = {"w": rng.normal(size=(2, 200_000)).astype(np.float32)}
    ef = ErrorFeedback()
    psum_pytree(x, compress="int8", chunk_mb=0.25, feedback=ef)
    assert ef.rounds == 1
    key_before = ef.key
    res_before = dict(ef.total)
    with pytest.raises(ValueError, match="64-bit"):
        psum_pytree({"w": np.zeros((1 << 18,), np.float64)},
                    compress="int8", chunk_mb=0.25, feedback=ef)
    assert ef.rounds == 1 and ef.key == key_before
    assert all(ef.total[k] is res_before[k] for k in res_before)


@pytest.mark.parametrize("topo", [None, "2x4"])
def test_round_failing_mid_entry_leaves_both_chains_uncommitted(
        monkeypatch, topo):
    """A round that dies after some chunks already reduced (and staged
    fresh residuals of both chains) commits neither chain."""
    rng = np.random.default_rng(12)
    x = {"w": rng.normal(size=(2, 200_000)).astype(np.float32)}
    ef = ErrorFeedback()
    lanes = _lanes(topo) if topo else None
    psum_pytree(x, compress="int8", chunk_mb=0.25, feedback=ef,
                topology=lanes)
    contrib, total = dict(ef.contrib), dict(ef.total)
    real = TC._quant_ring_reduce
    calls = {"n": 0}

    def dies_on_the_third_chunk(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("peer lost mid-stream")
        return real(*a, **k)

    monkeypatch.setattr(TC, "_quant_ring_reduce", dies_on_the_third_chunk)
    with pytest.raises(RuntimeError, match="mid-stream"):
        psum_pytree({"w": x["w"] * 2}, compress="int8", chunk_mb=0.25,
                    feedback=ef, topology=lanes)
    assert calls["n"] == 3
    assert ef.rounds == 1
    assert ef.contrib.keys() == contrib.keys()
    assert all(ef.contrib[k] is contrib[k] for k in contrib)
    assert all(ef.total[k] is total[k] for k in total)


def test_int8_residual_resets_on_plan_change():
    rng = np.random.default_rng(12)
    ef = ErrorFeedback()
    psum_pytree({"w": rng.normal(size=(2, 200_000)).astype(np.float32)},
                compress="int8", chunk_mb=0.25, feedback=ef)
    key1 = ef.key
    n_keys = len(ef.contrib)
    assert n_keys > 0
    psum_pytree({"w": rng.normal(size=(2, 300_000)).astype(np.float32)},
                compress="int8", chunk_mb=0.25, feedback=ef)
    assert ef.rounds == 2
    assert ef.key != key1 and len(ef.contrib) > n_keys


# -- hierarchical mode over in-process lanes ------------------------------------

@pytest.mark.parametrize("topo", ["1x1", "8x1", "1x8", "2x4", "4x2"])
def test_hier_chunked_bit_identical_to_flat(topo):
    diff = {"w": RNG.normal(size=(3, 700_001)).astype(np.float32),
            "b": RNG.normal(size=(64,)).astype(np.float32)}
    phases: dict = {}
    flat = psum_pytree({k: v.copy() for k, v in diff.items()},
                       chunk_mb=0.25)
    hier = psum_pytree({k: v.copy() for k, v in diff.items()},
                       chunk_mb=0.25, topology=_lanes(topo), phases=phases)
    assert phases["chunks"] > 1
    assert phases["topo"] == topo
    assert np.array_equal(hier["w"], flat["w"])
    assert np.array_equal(hier["b"], flat["b"])
    assert hier["w"].dtype == np.float32


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("topo", ["2x4", "4x2", "1x8"])
def test_hier_modes_match_jax_over_rounds(mode, topo):
    """bf16 and int8 through the two tiers, two rounds with feedback,
    bit-equal to the JAX package over its virtual devices."""
    rng = np.random.default_rng(5)
    ef, jef = ErrorFeedback(), JC.ErrorFeedback()
    for _ in range(2):
        x = {"w": rng.normal(size=(2, 300_001)).astype(np.float32)}
        j, t = _both(x, compress=mode, chunk_mb=0.25, topology=topo)
        _same(j["w"], t["w"])
        x2 = {"w": x["w"]}
        _same(JC.psum_pytree(x2, compress=mode, chunk_mb=0.25,
                             feedback=jef, topology=topo)["w"],
              psum_pytree(x2, compress=mode, chunk_mb=0.25, feedback=ef,
                          topology=_lanes(topo))["w"])


def test_hier_phase_keys_and_wire_per_host_model():
    elems = 1 << 18
    diff = {"w": np.ones((elems,), np.float32)}
    per_host = {}
    for topo in ("8x1", "4x2", "2x4"):
        ph: dict = {}
        jph: dict = {}
        psum_pytree(diff, chunk_mb=0.25, topology=_lanes(topo), phases=ph)
        JC.psum_pytree(diff, chunk_mb=0.25, topology=topo, phases=jph)
        for k in ("intra_ms", "inter_ms", "wire_bytes_per_host"):
            assert k in ph and ph[k] >= 0, (k, ph)
        h = int(topo.split("x")[0])
        assert ph["wire_bytes_per_host"] == jph["wire_bytes_per_host"] == \
            int(elems * 4 * 2 * (h - 1) / h)
        per_host[topo] = ph["wire_bytes_per_host"]
    assert per_host["2x4"] < per_host["4x2"] < per_host["8x1"]
    ph_flat: dict = {}
    psum_pytree(diff, chunk_mb=0.25, phases=ph_flat)
    assert ph_flat["topo"] == "flat"
    assert ph_flat["wire_bytes_per_host"] == 0
    assert ph_flat["intra_ms"] == 0.0


def test_hier_small_leaves_stay_flat_and_exact():
    diff = {"b": RNG.normal(size=(64,)).astype(np.float32),
            "c": np.float32(3.0)}
    ph: dict = {}
    out = psum_pytree(diff, topology=_lanes("2x4"), phases=ph)
    assert np.array_equal(out["b"], diff["b"])
    assert float(out["c"]) == 3.0
    assert ph["topo"] == "2x4"
    assert ph["intra_ms"] == 0.0 and ph["chunks"] == 0


def test_hier_int8_error_feedback_drift_gate():
    rng = np.random.default_rng(5)
    shape = (2, 200_000)
    rounds = 12
    lanes = _lanes("2x4")
    ef = ErrorFeedback()
    s32 = np.zeros(shape, np.float32)
    s8 = np.zeros(shape, np.float32)
    s8n = np.zeros(shape, np.float32)
    drift_ef, drift_noef = [], []
    for _ in range(rounds):
        x = {"w": rng.normal(size=shape).astype(np.float32)}
        s32 += psum_pytree(x, chunk_mb=0.25)["w"]
        s8 += psum_pytree(x, compress="int8", chunk_mb=0.25,
                          feedback=ef, topology=lanes)["w"]
        s8n += psum_pytree(x, compress="int8", chunk_mb=0.25,
                           topology=lanes)["w"]
        drift_ef.append(float(np.linalg.norm(s8 - s32)))
        drift_noef.append(float(np.linalg.norm(s8n - s32)))
    assert ef.rounds == rounds
    assert drift_ef[-1] <= 1.5 * drift_ef[0], drift_ef
    assert drift_noef[-1] > 1.5 * drift_noef[0], drift_noef
    assert drift_noef[-1] > 2.0 * drift_ef[-1]


def test_hier_int8_matches_flat_int8_on_first_round():
    diff = {"w": RNG.normal(size=(2, 350_001)).astype(np.float32)}
    flat = psum_pytree({"w": diff["w"].copy()}, compress="int8",
                       chunk_mb=0.25)
    hier = psum_pytree({"w": diff["w"].copy()}, compress="int8",
                       chunk_mb=0.25, topology=_lanes("1x8"))
    assert np.array_equal(hier["w"], flat["w"])


def test_hier_int8_residual_resets_on_topology_change():
    rng = np.random.default_rng(13)
    x = {"w": rng.normal(size=(2, 200_000)).astype(np.float32)}
    ef = ErrorFeedback()
    psum_pytree(x, compress="int8", chunk_mb=0.25, feedback=ef,
                topology=_lanes("2x4"))
    key_24 = ef.key
    assert ef.rounds == 1 and key_24 is not None
    psum_pytree(x, compress="int8", chunk_mb=0.25, feedback=ef,
                topology=_lanes("4x2"))
    assert ef.key != key_24 and ef.rounds == 2
    psum_pytree(x, compress="int8", chunk_mb=0.25, feedback=ef)
    assert ef.key != key_24


def test_hier_prefer_device_and_device_resident_leaves():
    host = RNG.normal(size=(2, 400_000)).astype(np.float32)
    out = psum_pytree({"w": torch.from_numpy(host.copy())}, chunk_mb=0.25,
                      topology=_lanes("2x4"), prefer_device=True)
    assert isinstance(out["w"], torch.Tensor)
    assert np.array_equal(out["w"].numpy(), host)


def test_hier_rejects_bad_topology():
    diff = {"w": np.zeros((1 << 18,), np.float32)}
    with pytest.raises(ValueError, match="topology"):
        psum_pytree(diff, topology="junk")
    with pytest.raises(ValueError, match="devices"):
        psum_pytree(diff, topology="4x4")  # one CPU device here


def test_int8_device_resident_leaves_and_prefer_device():
    host = RNG.normal(size=(2, 300_000)).astype(np.float32)
    ef = ErrorFeedback()
    out = psum_pytree({"w": torch.from_numpy(host.copy())},
                      compress="int8", chunk_mb=0.25, prefer_device=True,
                      feedback=ef)
    assert isinstance(out["w"], torch.Tensor)
    err = np.abs(out["w"].numpy() - host)
    assert 0 < err.max() < np.abs(host).max() / 64
    assert ef.rounds == 1
    j = JC.psum_pytree({"w": host}, compress="int8", chunk_mb=0.25)
    _same(j["w"], out["w"].numpy())


# -- the integrity screens -------------------------------------------------------

def test_guard_screens_contributions_and_crc():
    """quarantine refuses a poisoned contribution before it quantizes and
    a staged chunk whose CRC broke (the mix.wire.corrupt chaos site),
    before any residual commits; warn counts and ships."""
    x = RNG.normal(size=(2, 200_000)).astype(np.float32)
    bad = x.copy()
    bad[1, 7] = np.nan
    ef = ErrorFeedback()
    with pytest.raises(ChunkIntegrityError) as e:
        psum_pytree({"w": bad}, compress="int8", chunk_mb=0.25,
                    feedback=ef, guard="quarantine")
    assert e.value.kind == "nonfinite" and ef.rounds == 0
    ph: dict = {}
    psum_pytree({"w": bad}, chunk_mb=0.25, guard="warn", phases=ph)
    assert ph["finite_ok"] is False and ph["nonfinite_chunks"] >= 1
    with faults.armed("mix.wire.corrupt:bitflip@1"):
        with pytest.raises(ChunkIntegrityError) as e:
            psum_pytree({"w": x}, compress="int8", chunk_mb=0.25,
                        feedback=ef, guard="quarantine")
    assert e.value.kind == "crc" and ef.rounds == 0
    with faults.armed("mix.wire.corrupt:bitflip@1"):
        psum_pytree({"w": x}, chunk_mb=0.25, guard="warn", phases=ph)
    assert ph["crc_mismatch_chunks"] == 1 and ph["finite_ok"] is False
    ok = psum_pytree({"w": torch.from_numpy(x)}, chunk_mb=0.25,
                     guard="quarantine", phases=ph)
    assert ph["finite_ok"] is True
    assert np.array_equal(ok["w"], x)


# -- cross-round streaming --------------------------------------------------------

def test_psum_pytree_start_streams_back_to_back_rounds():
    a = {"w": RNG.normal(size=(1 << 18,)).astype(np.float32)}
    b = {"w": RNG.normal(size=(1 << 18,)).astype(np.float32)}
    pa, pb = {}, {}
    ra = psum_pytree_start(a, chunk_mb=0.25, phases=pa)
    rb = psum_pytree_start(b, chunk_mb=0.25, phases=pb)
    out_b = rb.result()
    out_a = ra.result()
    assert ra.done() and rb.done()
    np.testing.assert_array_equal(out_a["w"],
                                  psum_pytree(a, chunk_mb=0.25)["w"])
    np.testing.assert_array_equal(out_b["w"],
                                  psum_pytree(b, chunk_mb=0.25)["w"])
    assert pa["dispatch_gate_ms"] >= 0 and pb["dispatch_gate_ms"] >= 0


def test_psum_pytree_start_propagates_errors():
    bad = psum_pytree_start({"x": np.zeros(4, np.float64)})
    with pytest.raises(ValueError, match="64-bit"):
        bad.result()
    out = psum_pytree({"w": np.ones((1 << 16,), np.float32)},
                      chunk_mb=0.25)
    np.testing.assert_array_equal(out["w"], 1.0)


def test_dispatch_gate_serializes_many_concurrent_rounds():
    diffs = [{"w": np.full((1 << 16,), float(i + 1), np.float32)}
             for i in range(6)]
    handles = [psum_pytree_start(d, chunk_mb=0.0625) for d in diffs]
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result()["w"], float(i + 1))
    assert not TC._DISPATCH_GATE.locked()


# -- the in-process all-reduce (test_mix_compression.py) --------------------------

def test_bf16_allreduce_matches_jax(rng):
    diffs = [{"w": rng.normal(size=256).astype(np.float32)}
             for _ in range(4)]
    mesh = replica_mesh(4, devices=["cpu"] * 4)
    jmesh = j_replica_mesh(4, devices=jax.devices()[:4])
    exact = allreduce_diffs(diffs, mesh)
    quant = allreduce_diffs(diffs, mesh, compress=True)
    want = sum(d["w"].astype(np.float64) for d in diffs)
    np.testing.assert_allclose(exact["w"], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(quant["w"], want, rtol=0.05, atol=0.05)
    _same(np.asarray(j_allreduce(diffs, jmesh)["w"]), exact["w"])
    _same(np.asarray(j_allreduce(diffs, jmesh, compress=True)["w"]),
          quant["w"])
    idiffs = [{"n": np.asarray([i + 1], dtype=np.int32)} for i in range(4)]
    assert int(allreduce_diffs(idiffs, mesh, compress=True)["n"][0]) == 10


# -- several ranks over gloo -------------------------------------------------------

_GEN = r"""
import numpy as np
def member_tree(rd, rank):
    rng = np.random.default_rng(1000 * rd + rank)
    return {"w": rng.normal(size=(2, 150_001)).astype(np.float32) * (rank + 1),
            "b": rng.normal(size=(64,)).astype(np.float32),
            "idx": rng.integers(0, 100, size=(70_001,)).astype(np.int32)}
"""

#: torch threads of a spawned rank: the ranks of a world share the host
#: with the suite's other workers
RANK_THREADS = 2

_CHILD = _GEN + f"RANK_THREADS = {RANK_THREADS}\n" + r"""
import json, sys
import torch
from jubatus_tpu_torch.parallel import collective as C, multihost
torch.set_num_threads(RANK_THREADS)
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
out_dir, mode, topo, rounds = sys.argv[4], sys.argv[5], sys.argv[6], int(sys.argv[7])
assert multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=n, process_id=rank, device="cpu",
                            timeout=30.0)
topo = topo if topo != "flat" else None
ef = C.ErrorFeedback()
res, phases = {}, None
for rd in range(rounds):
    tree = member_tree(rd, rank)
    ph = {}
    out = C.psum_pytree(tree, compress=mode, chunk_mb=0.25, phases=ph,
                        feedback=ef if mode == "int8" else None,
                        topology=topo)
    phases = phases or ph
    for k, v in out.items():
        res[f"{k}{rd}"] = v
    if mode == "int8":
        res[f"noef{rd}"] = C.psum_pytree(tree, compress="int8",
                                         chunk_mb=0.25, topology=topo)["w"]
        res[f"f32_{rd}"] = C.psum_pytree(tree, chunk_mb=0.25,
                                         topology=topo)["w"]
# device-resident leaves and prefer_device agree with the host path
tree = member_tree(0, rank)
dev = C.psum_pytree({k: torch.from_numpy(v) for k, v in tree.items()},
                    compress="off" if mode == "int8" else mode,
                    chunk_mb=0.25, prefer_device=True, topology=topo)
host = C.psum_pytree(tree, compress="off" if mode == "int8" else mode,
                     chunk_mb=0.25, topology=topo)
assert all(isinstance(v, torch.Tensor) for v in dev.values())
assert all(np.array_equal(dev[k].numpy(), host[k]) for k in host)
np.savez(f"{out_dir}/rank{rank}.npz", **res)
print("PHASES", json.dumps(phases), flush=True)
multihost.shutdown()
print("RANK-OK", rank, flush=True)
"""


def _world(tmp_path, n, mode, topo, rounds):
    outs, rcs = multihost.run_local_world(
        _CHILD, n, args=(str(tmp_path), mode, topo, rounds),
        timeout=WORLD_TIMEOUT)
    for r, (out, rc) in enumerate(zip(outs, rcs)):
        assert rc == 0 and f"RANK-OK {r}" in out, out[-3000:]
    phases = json.loads(outs[0].split("PHASES ")[1].splitlines()[0])
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)], \
        phases


def _member_trees(n, rounds):
    ns: dict = {}
    exec(_GEN, ns)
    return [[ns["member_tree"](rd, r) for r in range(n)]
            for rd in range(rounds)]


def _jax_flat_int8(members, chunk_mb, feedback_state):
    """The JAX package's flat int8 stream over n members, called directly:
    per chunk its jitted ship quantizer on each member's chunk (chain 1
    per member), then its ring over n virtual devices (chain 2)."""
    n = len(members)
    block = JC.QUANT_BLOCK
    ce = max(1, int(chunk_mb * 2**20) // 4)
    ce = ((ce + n * block - 1) // (n * block)) * (n * block)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("replica",))
    sh = NamedSharding(mesh, P("replica"))
    flats = [m.reshape(-1) for m in members]
    out = []
    for start in range(0, flats[0].size, ce):
        stop = min(start + ce, flats[0].size)
        qs, ss = [], []
        for m, f in enumerate(flats):
            chunk = np.zeros(ce, np.float32)
            chunk[: stop - start] = f[start:stop]
            rc = feedback_state.get(("c", m, start),
                                    np.zeros((1, ce), np.float32))
            q, s, nr = JC._quant_ship_fn(ce, block)(
                jnp.asarray(chunk)[None], jnp.asarray(rc))
            feedback_state[("c", m, start)] = np.asarray(nr)
            qs.append(np.asarray(q)[0])
            ss.append(np.asarray(s)[0])
        rt = feedback_state.get(("t", start),
                                np.zeros((n, ce // n), np.float32))
        tot, nrt = JC._quant_reduce_fn(mesh, ce, block)(
            jax.device_put(np.stack(qs), sh), jax.device_put(np.stack(ss), sh),
            jax.device_put(rt, sh))
        feedback_state[("t", start)] = np.asarray(nrt)
        out.append(np.asarray(tot)[: stop - start])
    return np.concatenate(out).reshape(members[0].shape)


def _jax_hier_int8(members, chunk_mb, feedback_state, hosts, locs):
    """The JAX package's two-tier int8 over hosts x locs members (member
    h*locs + l is lane (h, l)), its intra and inter programs called
    directly on virtual devices."""
    block = JC.QUANT_BLOCK
    ce = max(1, int(chunk_mb * 2**20) // 4)
    q_ = locs * hosts * block
    ce = ((ce + q_ - 1) // q_) * q_
    devs = np.asarray(jax.devices()[: hosts * locs]).reshape(hosts, locs)
    mesh2 = Mesh(devs, ("host", "local"))
    sh = NamedSharding(mesh2, P("host", "local"))
    intra, inter = JC._hier_quant_fns(mesh2, ce, block)
    flats = [m.reshape(-1) for m in members]
    seg = ce // locs
    out = []
    for start in range(0, flats[0].size, ce):
        stop = min(start + ce, flats[0].size)
        x = np.zeros((hosts, locs, ce), np.float32)
        for i, f in enumerate(flats):
            x[i // locs, i % locs, : stop - start] = f[start:stop]
        rc = feedback_state.get(("c", start),
                                np.zeros((hosts, locs, seg), np.float32))
        q, s, nrc = intra(jax.device_put(x, sh), jax.device_put(rc, sh))
        feedback_state[("c", start)] = np.asarray(nrc)
        rt = feedback_state.get(("t", start), np.zeros(
            (hosts, locs, seg // hosts), np.float32))
        tot, nrt = inter(q, s, jax.device_put(rt, sh))
        feedback_state[("t", start)] = np.asarray(nrt)
        out.append(np.asarray(tot)[: stop - start])
    return np.concatenate(out).reshape(members[0].shape)


def _ranks_bit_equal(res):
    for r in res[1:]:
        assert r.keys() == res[0].keys()
        for k in res[0]:
            assert np.array_equal(r[k], res[0][k]), k


@pytest.mark.parametrize("mode", ["off", "bf16", "int8"])
def test_three_rank_gloo_world(tmp_path, mode):
    """3 ranks, a tree of a chunked ragged f32 leaf, a small f32 leaf and
    an int32 leaf: every rank's totals bit-equal; int8 (with feedback,
    over rounds) bit-equal to the JAX ring, off within RTOL_OFF, bf16
    within BF16_TOL; small and integer leaves exact in every mode."""
    n = 3
    rounds = 4 if mode == "int8" else 1
    res, phases = _world(tmp_path, n, mode, "flat", rounds)
    _ranks_bit_equal(res)
    assert phases["quant"] == mode and phases["chunks"] > 1
    assert phases["wire_mb"] == round(
        phases["payload_mb"] * 2 * (n - 1) / n, 2) or phases["wire_mb"] > 0
    trees = _member_trees(n, rounds)
    state: dict = {}
    for rd in range(rounds):
        got = res[0]
        want_idx = sum(t["idx"] for t in trees[rd])
        assert np.array_equal(got[f"idx{rd}"], want_idx)
        ws = [t["w"] for t in trees[rd]]
        if mode == "int8":
            _same(_jax_flat_int8(ws, 0.25, state), got[f"w{rd}"])
            np.testing.assert_allclose(got[f"b{rd}"],
                                       sum(t["b"] for t in trees[rd]),
                                       rtol=RTOL_OFF, atol=1e-6)
            continue
        jtot = j_allreduce([{"w": w} for w in ws],
                           j_replica_mesh(n, devices=jax.devices()[:n]),
                           compress=mode == "bf16")["w"]
        jtot = np.asarray(jtot)
        if mode == "off":
            np.testing.assert_allclose(got[f"w{rd}"], jtot, rtol=RTOL_OFF,
                                       atol=1e-6)
        else:
            err = np.abs(got[f"w{rd}"] - jtot)
            scale = sum(np.abs(w) for w in ws)
            assert (err <= BF16_TOL * scale).all(), err.max()


def test_three_rank_int8_error_feedback_drift_gate(tmp_path):
    """Over the 3-rank ring, 4 rounds: with feedback the drift of the
    accumulated totals against f32 stays bounded; without it grows."""
    res, _ = _world(tmp_path, 3, "int8", "flat", 4)
    got = res[0]
    s32 = np.zeros_like(got["w0"])
    s8 = np.zeros_like(s32)
    s8n = np.zeros_like(s32)
    d_ef, d_noef = [], []
    for rd in range(4):
        s32 += got[f"f32_{rd}"]
        s8 += got[f"w{rd}"]
        s8n += got[f"noef{rd}"]
        d_ef.append(float(np.linalg.norm(s8 - s32)))
        d_noef.append(float(np.linalg.norm(s8n - s32)))
    assert d_ef[-1] <= 1.5 * d_ef[0], d_ef
    assert d_noef[-1] > 1.5 * d_noef[0], d_noef
    assert d_noef[-1] > d_ef[-1]


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_four_rank_2x2_hierarchical(tmp_path, mode):
    """4 ranks as 2 hosts x 2 lanes: every rank's totals bit-equal; int8
    bit-equal to the JAX package's two tiers over two rounds of
    feedback, off to the exact sum within RTOL_OFF; the tier keys
    stamped."""
    n, rounds = 4, 2
    res, phases = _world(tmp_path, n, mode, "2x2", rounds)
    _ranks_bit_equal(res)
    assert phases["topo"] == "2x2"
    assert phases["intra_ms"] >= 0 and phases["inter_ms"] >= 0
    trees = _member_trees(n, rounds)
    state: dict = {}
    for rd in range(rounds):
        ws = [t["w"] for t in trees[rd]]
        if mode == "int8":
            _same(_jax_hier_int8(ws, 0.25, state, 2, 2), res[0][f"w{rd}"])
        else:
            np.testing.assert_allclose(
                res[0][f"w{rd}"], sum(w.astype(np.float64) for w in ws),
                rtol=RTOL_OFF, atol=1e-5)
