#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``jubatus_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Drives the port only; imports nothing of JAX or of ``jubatus_tpu``. Phases,
each of which fails the run (non-zero exit, no result line) on error:

1. device: the card's name, and its name and power limit from nvidia-smi;
   builds ``jubatus_tpu_torch/csrc/sig_scan.cu`` and
   ``jubatus_tpu_torch/csrc/online_scan.cu`` with nvcc (sm_90a), one nvcc
   per source, started together;
2. kernels: both modes of the signature scan against their plain PyTorch
   versions on the same tensors, bit-equal required: first at edge shapes
   (C in {1, 7, 4099}, B around each variant's limits, W in {2, 3, 64, 70},
   tables on and 4 bytes off 16-byte alignment), which must reach every
   kernel variant, and K1's gathered variant (the IVF rescore) at M in
   {1, 7, 4099} candidates, W in {2, 3, 64, 70}, a query row of padding
   only and the table's last slot; then (hamming at hash_num 64, W=2;
   minhash at H=64) at
   B in {1, 256} and C = 1,000,003 rows with kernel, plain and library-call
   times (CUDA events), the variant that ran, the bound, and the same
   operations at the card's int32 issue rate; then regression's scan
   kernel (``[scan]``): PA, PA1 and PA2 at B = 1024 on the stress shape
   (K = 64, D = 2^18, padding and duplicate indices within and across
   rounds) and on a server-shaped batch (phase 9's rows featurized by
   ``config/regression/default.json`` on the CPU, K = 16), bit-equal to
   the plain version on the CPU and within SCAN_CARD_TOL of it on the
   card; its time at B = 8192 on both shapes (median of CUDA events, the
   wrapper's index check outside the window) with the variant, the table
   flushes and the walker's wait share, against the plain version's time,
   the bytes bound, and two chain bounds from the measured latencies of a
   dependent device-memory load, shared-memory load and shuffle-add;
3. backends: an lsh and a minhash NNBackend on the card with 10^6 rows of
   32 hashed features (dim_bits 18), 200 ``neighbors(vec, 10)`` queries
   each; the kernel's launch count must rise by 200, and 5 queries redone
   with the plain scan on the same device tensors must agree; 20 more
   queries under torch.profiler split the device-busy time per query into
   signature, scan, live mask, top-k and copies;
4. server: ``python -m jubatus_tpu_torch.server nearest_neighbor -f
   config/nearest_neighbor/lsh.json`` on the card, 10^4 set_row and the
   four query methods plus get_all_rows over the port's RpcClient, compared
   with the port's driver on the CPU fed the same rows; the server's
   scan-launch count (get_status) must move;
5. recommender: ``config/recommender/{lsh,minhash,default}.json`` (default
   is inverted_index) with the first REC_ROWS (2.5·10^5) rows of phase 3
   through ``backend.set_row``;
   50 ``similar_row_from_datum`` (k = 10) and 50
   ``complete_row_from_datum`` timed (p50/p99), the flush (or, for the
   exact method, the arenas' upload) timed; the first answers held against
   the plain scan (hash methods, exactly) or the CPU recomputation of every
   distance (inverted_index, within EXACT_TOL); 10 more queries under
   torch.profiler split by step;
6. anomaly: ``config/anomaly/lof_unlearner_lru.json`` as shipped
   (euclid_lsh) and with its nested method set to lsh and to minhash, 4096
   rows through ``backend.set_row``; one cold LOF support rebuild timed and
   split into scan, readback and host, each chunk's kernel output held
   against the plain version; 5 ``add`` and 50 ``calc_score`` timed; the
   support and every score held against the port's driver on the CPU fed
   the same rows (lsh/minhash exactly, euclid_lsh within LOF_SCORE_RTOL);
   float32 matmul must be at full precision (no TF32);
7. servers: the recommender (default.json, 10^4 update_row), anomaly (LOF
   over lsh, 500 add: each add rebuilds the support) and classifier
   (``config/classifier/nn.json`` as shipped and with nested lsh, 10^4
   examples) servers on the card, every answer compared with the port's
   driver on the CPU fed the same datums;
8. classifier: AROW ``train_batch_parallel`` at the JAX package's bench
   shape (L = 2, K = 64, B = 32768, D = 2^20 and 2^24): examples/s (median
   of 10 steps after 2), one step under torch.profiler (device busy and
   idle share), the state after 4 steps against the CPU port (within
   CLF_TOL), the deterministic-mode reproduction and one PA1 and CW step
   (D = 2^20); the driver's ``train_hashed`` examples/s and
   ``classify_hashed`` p50/p99 at B = 1 and B = 32768;
9. linear servers: ``config/classifier/arow.json`` and
   ``config/regression/default.json`` on the card; 10^4 rows through
   ``train`` in calls of 256 from 4 clients at once (the coalescer merges
   them), then again from one client after ``clear`` beside a CPU driver
   fed the same calls; 50 ``classify`` / ``estimate`` calls (p50/p99,
   ``first_ms`` apart) against the CPU driver within LINEAR_TOL; the
   regression server's scan-kernel launches must move;
10. clustering and graph (no hand-written kernel: plain PyTorch on the
   card): ``config/clustering/kmeans.json`` and ``gmm.json`` as shipped
   (k = 3, bucket_size 1000) take 16,384 of phase 9's rows in pushes of
   1,024 (one recluster each), ``dbscan.json`` (eps 0.2, min_core_point 2)
   8,192 rows in 512 groups of near-duplicates; the last recluster split
   into compact / upload / fit / readback / members, the fit timed with
   CUDA events and under torch.profiler (busy against wall); centres and
   assignments held against the port's driver on the CPU fed the same
   pushes (CLUSTER_TOL, a stated tie rule), DBSCAN's labels against a
   plain host reference (scipy's connected components); graph
   (``config/graph/default.json``) with 65,536 nodes and 524,288 edges in
   process, ``update_index`` split into filter / upload / loop / readback,
   ranks within PAGERANK_RTOL of the CPU driver's; then the clustering,
   graph, stat, bandit, burst and weight servers on the card (each on its
   shipped ``default.json``, all six started at once), each call's answer
   equal to a CPU twin's (the port's server in this process on the CPU),
   p50/p99 per method;
11. save/load and the RPC linear mix: twelve servers (the eleven engines
   on a shipped config, the classifier as arow.json and nn.json) with
   ``-d``, all started at once, take a session of updates over RPC and
   ``save``; a second server of each, started with ``-m`` on the file,
   answers every query as the saver did (exactly, or within the
   tolerance of tests/test_torch_save_load.py); ``save_model`` /
   ``load_model`` of the AROW driver at phase 8's shape (D = 2^20 and
   2^24), split into readback, msgpack, CRC, write and fsync, then read,
   CRC check, unpack and upload, the loaded tables equal to the saved;
   one mix round of two AROW drivers at the same shapes through the
   mixer's wire path in this process (the round's phases, each member's
   snapshot stall, pack, unpack and apply stall), both replicas equal to
   the CPU fold of their diffs; then fleets of two server processes on
   ``-z file://<dir> --mixer linear_mixer`` (arow.json, regression's
   default.json, nearest_neighbor lsh.json), each member trained on half
   the rows and ``do_mix``: both replicas' saved models equal, and equal
   to two CPU port servers mixing the same halves (within LINEAR_TOL;
   lsh rows exactly), with the round's split from the master's flight
   recorder and the members' gauges and spans;
12. push and async mix, migration, the store and the snapshot ring, every
   server its own process on ``-z file://<dir>``: three ``arow.json``
   servers per push strategy (broadcast, random, skip; all nine started
   at once) trained on thirds and one ``do_mix`` (each exchange's peer
   get_diff and applies from the initiator's spans, every member's
   stalls; broadcast and skip against three CPU port servers repeating
   the round member by member); two with ``--mix-async``: a staleness-0
   fold of both members' diffs against two CPU port servers driven the
   same way, then streaming turns (submits, folds, staleness, drops,
   stalls) until the replicas hold one model; an ``lsh.json`` server
   filled with 1.25·10^5 rows through ``put_rows``, a second server's
   ``rebalance`` pull, its first query (signing every pulled row, K1),
   then the first server's drain and handoff, the new owner's answers
   equal to the source's each time; the AROW driver at phase 8's shape
   in a model store at D = 2^20 and 2^24 (full and diff records off and
   int8, compaction, materialize, the snapshot's lock hold, rollback); a
   regression server stopped and restarted warm from ``--store-dir``
   (answers equal, its flushes launch S1); two ``arow.json`` servers
   under ``--mix-guard quarantine``, one armed with ``--fault
   mix.diff.poison*:nan``, rolling back on the refused total;
13. the fleet, every process on the card: a port ``jubacoordd``
   (``python -m jubatus_tpu_torch.coord.server --journal``), three configs
   written with ``jubaconfig`` (nearest_neighbor lsh.json, phase 6's LOF
   config over lsh, regression default.json), one ``jubavisor``,
   ``jubactl -c start -N 2`` per engine and one routing proxy per engine
   (``python -m jubatus_tpu_torch.server.proxy``). nearest_neighbor: each
   member filled with 1.25·10^5 rows on their CHT(1) owner by ``put_rows``
   (2.5·10^5 in all), 2,000 ``set_row`` through the proxy,
   200 each of ``neighbor_row_from_datum`` and ``similar_row_from_datum``
   through the proxy and directly to both members (every proxied answer
   equal to one member's exactly; p50/p99 both ways; the proxy's forwards
   through the raw relay and the generic path); anomaly: 200 ``add``
   through the proxy, each id held by both CHT(2) owners, ``calc_score``;
   regression: 10^4 rows through the proxy in calls of 256, ``estimate``;
   the broadcasts (``get_status`` and ``save`` merged, ``clear``
   all_and); ``jubactl -c drain`` of one NN member while a client writes
   through the proxy (no client error, every row on the survivor), then
   ``rebalance``, ``rollback`` (refused by every member: jubactl start
   forwards no snapshot interval), ``status --all``, one ``watch`` frame
   and ``stop``, after which the visor has no children. K1 and S1
   launches of the phase come from the members' get_status
   (``[deploy_launches]``);
14. the IVF tier and row-sharded serving: phase 3's lsh and minhash
   backends (10^6 rows) with ``configure_ann("ivf")`` (auto cells, nprobe
   8): the build split (embed / train / assign / tables), 200 queries
   (p50/p99, recall@10 against phase 3's exact answers, K1's gathered
   launches +200), a forced cell re-split and its event, the gathered
   kernel timed at the index's B = 1 and 256 probes (kernel, plain,
   bound; minhash also index_select + cdist), then ``off`` again: the
   exact answers equal phase 3's bit for bit. ``inverted_index`` (phase
   5's recommender, default.json) under IVF: every answer within
   EXACT_TOL of a CPU recomputation. The same backends on 4 logical
   shards of cuda:0: 200 exact queries (distances equal to phase 3's, K1
   once a shard), IVF with every cell probed equal to them; LOF (phase
   6's config over lsh, 4096 rows) on the shards, bit-equal to the CPU
   port's sharded driver, its agreement with the flat LOF counted. Then
   two ``--ann ivf`` lsh.json servers: one filled with 2.5·10^5 rows by
   ``put_rows`` and queried 200 times over RPC, its ``ann.*`` status
   read, saved; the other loads the file (centroids byte for byte, equal
   answers); and ``--shard-devices 2`` on one card exits with the JAX
   server's message;
15. the feature-sharded linear engines on 4 logical shards of cuda:0
   (``ShardMesh(["cuda:0"] * 4)``): AROW at phase 8's shape (D = 2^24,
   B = 32768, K = 64, capacity 8) sharded against the flat card driver
   fed the same batches (examples/s, the four tables within FS_TOL,
   classify_hashed p50/p99 at B = 1 and 32768 for both, one sharded step
   profiled and split into masks, partials, the reduction on the first
   device, the decides and the scatters); at D = 2^20, B = 2048 the
   card's sharded driver against the CPU port's; regression's
   default.json on the shards against flat over two server-shaped flushes
   of 8192 rows (one S1 launch each over the gathered working set; the
   tables bit-equal to the flat card scan, the largest difference
   printed; the split into unique / gather / upload / S1 / write-back);
   arow.json and regression default.json served in this process on the
   shards (10^4 rows in calls of 256, answers against a CPU driver,
   beside phase 9's flat servers; a ``save`` loaded into a flat card
   server: tables bit for bit, answers within FS_TOL); two sharded
   arow.json members mixing over RPC, equal bit for bit after the round;
16. the collective mix plane (``--mixer collective_mixer``): ``psum_pytree``
   at world size 1 over NCCL on the AROW diff at bench.py's shape (D =
   2^24, the live rows of phase 8's capacity-8 driver, the weights' df on
   the host) in modes off, bf16 and int8 (each round's time and phases;
   off equal to the diff, bf16 to its cast, int8 within half a block
   scale and bit-equal to the CPU port's round on a slice), four int8
   rounds with and without error feedback against f32, and the int8
   ship's and round's kernel launches per chunk (torch.profiler); two
   ranks spawned on cuda:0 over gloo at the same width, modes off and
   int8, their totals bit-equal (off the exact sum); four ``arow.json``
   server processes on cuda:0 under ``--mix-topology 2x2 --mix-compress
   int8`` (rank 0 publishes its rendezvous in the file coordinator), two
   rounds, and two regression ``default.json`` processes with the wire
   off, one round (their flushes launch S1): after each round every
   member's saved model equal bit for bit, each member's flight record
   with its phases, the master's fallback count 0.

Phases 3-7, 8, 9, 10, 11, 12, 13, 14, 15 and 16 are the main path: each
path's launch counts are set to 0 just before it and read just after (a server's from its get_status); launches
made only to compare with the plain version or to time a kernel are not
counted. The last lines are a ``{"kernels": ...}`` JSON line (with the
launches per path), the nvidia-smi line, and ``{"ok": true, "device":
...}``. The sizes are fixed; ``--seed`` picks the random data.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
# The data sheet's rate outside the tensor cores (float32, an FMA counted
# as two). The scan's work is int32 ALU work, which Hopper issues at about
# a quarter of it (64 lanes/SM/clock); the data sheet gives no int32 rate,
# so this upper rate is used and the operations bound is stricter than the
# card can reach.
ALU_OPS_PER_S = 67e12
# int32 lanes per SM and clock on Hopper: the int32 issue rate is this times
# the SMs times the maximum SM clock (nvidia-smi clocks.max.sm)
INT32_LANES_PER_SM = 64
C_SCAN = 1_000_003            # candidate rows of the kernel phase (ragged)
ROWS = 1_000_000              # rows of each full-size backend
QUERIES = 200                 # timed neighbors() queries per backend
PROFILED_QUERIES = 20         # further queries under torch.profiler
SERVER_ROWS = 10_000          # rows written over the wire per server
REC_ROWS = 250_000            # rows of each recommender (phase 5; cut from
                              # 10^6 to keep the run inside its time limit)
REC_QUERIES = 50              # timed similar_row / complete_row calls each
REC_PROFILED = 10             # further similar_row calls under the profiler
REC_CONFIGS = ("lsh.json", "minhash.json", "default.json")
LOF_ROWS = 4096               # lof_unlearner_lru.json's max_size
LOF_ADDS = 5
LOF_SCORES = 50
LOF_METHODS = ("euclid_lsh", "lsh", "minhash")
ANOMALY_SERVER_ROWS = 500     # adds over the wire (each rebuilds the support)
REPS = 30                     # timed kernel launches per shape (median)
EDGE_C = (1, 7, 4099)         # phase 2 edge shapes
EDGE_W = (2, 3, 64, 70)
EDGE_B_EXTRA = ((4100, 4099, 2),)  # hamming past one shared query tile
#: launch counts a path reads: K1's two modes, its gathered variant's two
#: modes (the IVF rescore) and regression's scan
COUNTED = ("hamming", "minhash", "hamming_gather", "minhash_gather",
           "pa_scan")
#: K1's gathered variant: the launch count of each mode
GATHER_MODES = ("hamming", "minhash")
#: regression's scan kernel variants (online_scan.VARIANTS), counted apart
SCAN_VARIANTS = ("direct", "r1", "r2", "r4")
#: every count a path records: COUNTED and the scan's launches by variant
RECORDED = COUNTED + tuple(f"pa_scan.{v}" for v in SCAN_VARIANTS)
KERNELS = {
    # ops_per_word: the least int32 ALU work per (query, row, word):
    # xor + popcount + add for hamming, compare + add for minhash
    "hamming": dict(name="sig_scan.hamming", words=2, hash_num=64,
                    ops_per_word=3),
    "minhash": dict(name="sig_scan.minhash", words=64, hash_num=64,
                    ops_per_word=2),
}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


def int32_ops_per_s(torch) -> float:
    """64 int32 lanes x SMs x the maximum SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm", units=False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int, flush=None) -> float:
    """Median of ``reps`` single-call CUDA-event timings after one warm-up;
    ``flush`` runs (untimed) before each call to evict the L2 cache. A spin
    kernel (~1 ms) goes ahead of the start event, so the call's launches
    are queued before it fires and the events time the device, not the
    host's launch overhead."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(b: int, c: int, w: int, ops_per_word: int):
    """(bound_ms, bound_by): bytes = table + output + queries, each once;
    operations = ``ops_per_word`` int32 ops per (query, row, word) at
    ``ALU_OPS_PER_S``."""
    t_bytes = (c * w * 4 + b * c * 4 + b * w * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = ops_per_word * b * c * w / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def scan_inputs(torch, mode: str, b: int, c: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    if mode == "hamming":
        r = rng.integers(0, 1 << 32, (c, w), dtype=np.uint32)
        q = rng.integers(0, 1 << 32, (b, w), dtype=np.uint32)
    else:
        # feature ids below 2^24 (exact in float32, for the library call),
        # empty rows signed 0xFFFFFFFF, queries made from table rows with
        # half their lanes redrawn so the distances spread over [0, 1]
        r = rng.integers(1, 1 << 18, (c, w), dtype=np.uint32)
        r[rng.random(c) < 0.05] = 0xFFFFFFFF
        q = r[rng.integers(0, c, b)].copy()
        redraw = rng.random((b, w)) < rng.random((b, 1))
        q[redraw] = rng.integers(1, 1 << 18, int(redraw.sum()), dtype=np.uint32)
    dev = torch.device("cuda")
    return (torch.from_numpy(q.view(np.int32)).to(dev),
            torch.from_numpy(r.view(np.int32)).to(dev))


def edge_inputs(torch, mode: str, b: int, c: int, w: int, rng,
                misaligned: bool):
    hi = 1 << 32 if mode == "hamming" else 40
    q = rng.integers(0, hi, (b, w), dtype=np.uint32).view(np.int32)
    r = rng.integers(0, hi, (c, w), dtype=np.uint32).view(np.int32)
    qd = torch.from_numpy(q).cuda()
    if not misaligned:
        return qd, torch.from_numpy(r).cuda()
    flat = torch.zeros(r.size + 1, dtype=torch.int32, device="cuda")
    flat[1:] = torch.from_numpy(r.reshape(-1)).cuda()
    rd = flat[1:].view(c, w)
    check(rd.data_ptr() % 16 == 4, "misaligned table is not 4 bytes off")
    return qd, rd


def phase_edges(torch, sig_scan, seed: int) -> dict:
    """Every variant's edges on the card: ragged tiles, lane groups, the
    bulk-copy tail, misaligned output rows and tables, bit-equal to plain."""
    rng = np.random.default_rng(seed)
    small = sig_scan.SMALL_B
    shapes = [(b, c, w) for c in EDGE_C for w in EDGE_W
              for b in (1, 3, small, small + 1, 256, 300)]
    seen, n = set(), 0
    t0 = time.perf_counter()
    for mode in KERNELS:
        kern = sig_scan.hamming if mode == "hamming" else sig_scan.minhash
        extra = EDGE_B_EXTRA if mode == "hamming" else ()
        for b, c, w in shapes + list(extra):
            for misaligned in (False, True):
                q, r = edge_inputs(torch, mode, b, c, w, rng, misaligned)
                if mode == "hamming":
                    got = kern(q, r, 32 * w)
                    ref = sig_scan.hamming_plain(q, r, 32 * w)
                else:
                    got, ref = kern(q, r), sig_scan.minhash_plain(q, r)
                torch.cuda.synchronize()
                variant = sig_scan.choose_variant(mode, b, w,
                                                  r.data_ptr() % 16 == 0)
                check(torch.equal(got, ref),
                      f"{mode} ({variant}) B={b} C={c} W={w} misaligned="
                      f"{misaligned}: kernel != plain (max abs err "
                      f"{float((got - ref).abs().max())})")
                seen.add((mode, variant))
                n += 1
    want = {(m, v) for m, vs in sig_scan.VARIANTS.items() for v in vs}
    check(seen == want, f"edge shapes reached {sorted(seen)}, not every "
                        f"variant {sorted(want)}")
    return dict(shapes=n, variants=sorted(f"{m}.{v}" for m, v in seen),
                bit_equal=True, seconds=time.perf_counter() - t0)


def phase_kernels(torch, sig_scan, seed: int) -> dict:
    int32_rate = int32_ops_per_s(torch)
    # what the timing method reads for a kernel that does nothing (the
    # spin kernel with no cycles): the floor under every time below
    floor = time_ms(torch, lambda: torch.cuda._sleep(0), REPS)
    # a buffer twice the L2 size, rewritten before each cold timing
    l2_flush = torch.empty(25 * (1 << 20), dtype=torch.float32, device="cuda")
    results = {}
    for mode, spec in KERNELS.items():
        w, hash_num = spec["words"], spec["hash_num"]
        kern = sig_scan.hamming if mode == "hamming" else sig_scan.minhash
        shapes = []
        for b in (1, 256):
            q, r = scan_inputs(torch, mode, b, C_SCAN, w, seed + b)
            if mode == "hamming":
                run_k = lambda: kern(q, r, hash_num)
                run_p = lambda: sig_scan.hamming_plain(q, r, hash_num)
                run_l = None
            else:
                run_k = lambda: kern(q, r)
                run_p = lambda: sig_scan.minhash_plain(q, r)
                qf, rf = q.float(), r.float()
                run_l = lambda: torch.cdist(qf, rf, p=0) / w
            got = run_k()
            ref = run_p()
            torch.cuda.synchronize()
            check(got.shape == (b, C_SCAN), f"{mode} B={b}: shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{mode} B={b}: non-finite output")
            err = float((got - ref).abs().max())
            check(torch.equal(got, ref), f"{mode} B={b}: kernel != plain "
                                         f"(max abs err {err})")
            warm = time_ms(torch, run_k, REPS)
            cold = time_ms(torch, run_k, REPS, flush=l2_flush.zero_)
            plain = time_ms(torch, run_p, REPS // 4)
            lib = (time_ms(torch, run_l, REPS // 4)
                   if run_l is not None else None)
            bms, by = bound(b, C_SCAN, w, spec["ops_per_word"])
            int32_ms = spec["ops_per_word"] * b * C_SCAN * w / int32_rate * 1e3
            row = dict(B=b, C=C_SCAN, W=w,
                       variant=sig_scan.choose_variant(
                           mode, b, w, r.data_ptr() % 16 == 0),
                       kernel_ms=cold, kernel_warm_ms=warm,
                       plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=by, bound_share=bms / cold,
                       int32_issue_ms=int32_ms,
                       int32_issue_share=int32_ms / cold,
                       int32_ops_per_s=int32_rate, event_floor_ms=floor,
                       max_abs_err=err)
            shapes.append(row)
            log(f"[kernels] {spec['name']} " + json.dumps(row))
            del q, r, got, ref
        results[mode] = shapes
    del l2_flush
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: full-size backends
# ---------------------------------------------------------------------------
def random_rows(rng, n: int, nnz: int, dim_bits: int):
    idx = rng.integers(1, 1 << dim_bits, (n, nnz)).astype(np.int32)
    val = (rng.random((n, nnz)) + 0.05).astype(np.float32)
    return idx, val


def fill_rows(be, rows: int, seed: int, nnz: int = 32,
              dim_bits: int = 18) -> None:
    """``rows`` random rows (``nnz`` hashed features over 2^dim_bits) into a
    backend through ``set_row``; the same seed gives the same rows."""
    rng = np.random.default_rng(seed)
    step = 50_000
    for lo in range(0, rows, step):
        idx, val = random_rows(rng, min(step, rows - lo), nnz, dim_bits)
        for i, (ii, vv) in enumerate(zip(idx.tolist(), val.tolist())):
            be.set_row(f"r{lo + i}", list(zip(ii, vv)))


def phase_backend(torch, sig_scan, knn, NNBackend, SparseBatch, method: str,
                  seed: int, keep: dict) -> dict:
    """``keep[method]`` gets (backend, queries, answers) for phase 14."""
    rows, queries = ROWS, QUERIES
    dim_bits, nnz, k = 18, 32, 10
    be = NNBackend(method, dim=1 << dim_bits, hash_num=64, seed=0,
                   device="cuda")
    t0 = time.perf_counter()
    fill_rows(be, rows, seed, nnz, dim_bits)
    rng = np.random.default_rng(seed + 1)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    signed = be.flush()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    check(signed == rows, f"{method}: flushed {signed} of {rows} rows")
    kern = sig_scan.hamming if method == "lsh" else sig_scan.minhash
    before = kern.launches
    qidx, qval = random_rows(rng, queries, nnz, dim_bits)
    vecs = [list(zip(ii, vv)) for ii, vv in zip(qidx.tolist(), qval.tolist())]
    lat, answers = [], []
    for vec in vecs:
        t0 = time.perf_counter()
        answers.append(be.neighbors(vec, k))
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = kern.launches - before
    check(launched == queries,
          f"{method}: {launched} kernel launches for {queries} queries")
    for res in answers:
        check(len(res) == k and all(np.isfinite(d) for _, d in res),
              f"{method}: bad answer {res[:3]}")
    # five queries redone with the plain scan on the same device tensors
    table = be.sig_table()
    live = torch.tensor(be.store.live, device=table.device)
    for vec, res in list(zip(vecs, answers))[:5]:
        sb = SparseBatch.from_vectors([vec])
        qi = torch.tensor(sb.idx, device=table.device)
        qv = torch.tensor(sb.val, device=table.device)
        if method == "lsh":
            qs = knn.lsh_signature(qi, qv, hash_num=64, seed=0)
            d = sig_scan.hamming_plain(qs, table, 64)[0]
        else:
            qs = knn.minhash_signature(qi, qv, hash_num=64, seed=0)
            d = sig_scan.minhash_plain(qs, table)[0]
        d = torch.where(live, d, torch.tensor(float("inf"), device=d.device))
        vals, order = torch.topk(d, k, largest=False, sorted=True)
        ref = [(be.store.ids[s], float(v))
               for s, v in zip(order.tolist(), vals.tolist())]
        compare_ranked(res, ref, f"{method} plain recompute")
    mean_ms = statistics.fmean(lat)
    lat.sort()
    pidx, pval = random_rows(rng, PROFILED_QUERIES, nnz, dim_bits)
    pvecs = [list(zip(ii, vv)) for ii, vv in zip(pidx.tolist(), pval.tolist())]
    prof = profile_calls(
        torch, [lambda v=v: be.neighbors(v, k) for v in pvecs], mean_ms,
        [(be, "_query_sig", "signature")])
    out = dict(method=method, rows=rows, queries=queries,
               load_s=t_load, flush_s=t_flush,
               flush_rows_per_s=rows / t_flush,
               query_mean_ms=mean_ms,
               query_p50_ms=lat[len(lat) // 2],
               query_p99_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))],
               kernel_launches=launched,
               table_bytes=int(table.numel() * table.element_size()),
               profile=prof)
    keep[method] = (be, vecs, answers)
    del table
    return out


LABEL_PREFIX = "smoke."


def step_of(event) -> str:
    """The step of a profiled call that a CPU op belongs to, from its
    ancestors: the innermost ``record_function`` label that
    ``profile_calls`` put around a step (``smoke.<step>``), else top-k
    (under aten::topk), the live mask (an aten::where outside every
    labelled step: the dead-slot mask of ``_distances_dev``), else
    ``other``."""
    names, p = [], event
    while p is not None:
        if p.name.startswith(LABEL_PREFIX):
            return p.name[len(LABEL_PREFIX):]
        names.append(p.name)
        p = p.cpu_parent
    if "aten::topk" in names:
        return "topk"
    if "aten::where" in names:
        return "live_mask"
    return "other"


def busy_breakdown(prof, dev, n: int, steps) -> dict:
    """Device time per call (ms) by step: the scan kernel (by name),
    copies (memcpy/memset items), and every other kernel by the step of the
    CPU op that launched it (``step_of``). Kernels the profiler linked to
    no CPU op are ``unattributed``."""
    from torch.autograd import DeviceType

    def is_copy(name: str) -> bool:
        return name.startswith(("Memcpy", "Memset"))

    us = {step: 0.0 for step in steps}
    us.update(scan=0.0, live_mask=0.0, topk=0.0, copies=0.0, other=0.0)
    for e in dev:
        if "sig_scan" in e.name:
            us["scan"] += e.time_range.elapsed_us()
        elif is_copy(e.name):
            us["copies"] += e.time_range.elapsed_us()
    attributed = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        step = step_of(e)
        for kern in e.kernels:
            if ("sig_scan" in kern.name or is_copy(kern.name)
                    or kern.name.startswith(LABEL_PREFIX)):
                continue
            attributed += kern.duration
            us[step] += kern.duration
    rest = sum(e.time_range.elapsed_us() for e in dev
               if "sig_scan" not in e.name and not is_copy(e.name))
    us["unattributed"] = rest - attributed
    return {f"{key}_ms": v / 1e3 / n for key, v in us.items()}


def profile_calls(torch, calls, unprofiled_ms: float, steps) -> dict:
    """Where a call's time goes: the calls under torch.profiler give the
    device-busy time (sum of kernel and copy durations), the device work
    items, the scan kernel's time per call and the busy time split by step
    (``busy_breakdown``). ``steps`` is a list of (object, attribute, step):
    each such function is wrapped in a ``smoke.<step>`` label for these
    calls only. The profiler slows the host side, so the idle and scan
    shares are taken against ``unprofiled_ms``, the mean wall time of the
    same calls unprofiled; the profiled wall time is reported beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def labelled(fn, label):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    saved = []
    for obj, attr, step in steps:
        saved.append((obj, attr, vars(obj).get(attr)))
        setattr(obj, attr, labelled(getattr(obj, attr), LABEL_PREFIX + step))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for call in calls:
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, attr, orig in reversed(saved):
            if orig is None:
                delattr(obj, attr)      # the class's method shows again
            else:
                setattr(obj, attr, orig)
    # device work items; a label's own range on the device timeline spans
    # its whole step, idle time included, and is not one
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith(LABEL_PREFIX)
           and not getattr(e, "is_user_annotation", False)]
    check(dev, "torch.profiler recorded no device work")
    n = len(calls)
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n
    scan_ms = sum(e.time_range.elapsed_us() for e in dev
                  if "sig_scan" in e.name) / 1e3 / n
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(queries=n, wall_ms_per_query_profiled=wall_ms / n,
                wall_ms_per_query_unprofiled=unprofiled_ms,
                device_busy_ms_per_query=busy_ms,
                device_idle_share=1.0 - busy_ms / unprofiled_ms,
                device_idle_share_profiled=1.0 - busy_ms * n / wall_ms,
                device_items_per_query=len(dev) / n,
                sig_scan_ms_per_query=scan_ms,
                sig_scan_share=scan_ms / unprofiled_ms,
                busy_by_step=busy_breakdown(prof, dev, n,
                                            [st for _, _, st in steps]),
                top_device_us=[(name[:60], us / n) for name, us in top])


def compare_ranked(got, ref, what: str) -> None:
    """Same distance lists; ids equal as sets below the boundary distance,
    and at the boundary only carrying it (ties order arbitrarily)."""
    gd = [round(float(d), 6) for _, d in got]
    rd = [round(float(d), 6) for _, d in ref]
    check(gd == rd, f"{what}: distances {gd} != {rd}")
    if not gd:
        return
    edge = gd[-1]
    g_in = {i for i, d in zip((i for i, _ in got), gd) if d != edge}
    r_in = {i for i, d in zip((i for i, _ in ref), rd) if d != edge}
    check(g_in == r_in, f"{what}: ids below the boundary differ")


# ---------------------------------------------------------------------------
# phase 4: the server
# ---------------------------------------------------------------------------
def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def server_datum(rng, Datum, i: int):
    d = Datum()
    for j in rng.choice(64, 8, replace=False):
        d.add(f"f{j}", float(np.round(rng.standard_normal(), 3)))
    d.add("city", f"c{int(rng.integers(40))}")
    d.add("kind", f"k{i % 7}")
    return d


def start_server(engine: str, config_path: str, tag: str = "",
                 extra=()):
    """Start ``python -m jubatus_tpu_torch.server <engine> -f <config>``
    (and the flags in ``extra``) on the card; returns (process, port, log
    path) without waiting for it."""
    port = free_port()
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, f"chip_smoke_server_{engine}{tag}.log")
    cmd = [sys.executable, "-m", "jubatus_tpu_torch.server", engine,
           "-f", config_path, "-p", str(port), "-b", "127.0.0.1", "-c", "4",
           "--device", "cuda", *extra]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=logf,
                                stderr=subprocess.STDOUT)
    return proc, port, log_path


def stop_server(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=20)


@contextlib.contextmanager
def serving(engine: str, config_path: str, started=None):
    """The server of ``engine`` on the card (``started``: one already
    started by ``start_server``); yields an RpcClient once it answers. On
    an error the server log's tail goes to stderr; the server is stopped
    either way."""
    proc, port, log_path = started or start_server(engine, config_path)
    from jubatus_tpu_torch.rpc.client import RpcClient

    cli = RpcClient("127.0.0.1", port, timeout=120.0)
    try:
        deadline = time.time() + 180
        while True:
            check(proc.poll() is None,
                  f"{engine} server exited with {proc.returncode}; see "
                  f"{log_path}")
            try:
                cli.call("get_status", "smoke")
                break
            except Exception:  # broad-ok — the server is still starting
                check(time.time() < deadline,
                      f"{engine} server did not answer in 180 s")
                time.sleep(0.5)
        yield cli
    except Exception:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        print(f"--- server log ({log_path}), last lines:\n{tail}",
              file=sys.stderr)
        raise
    finally:
        cli.close()
        stop_server(proc)


def server_status(cli) -> dict:
    st = next(iter(cli.call("get_status", "smoke").values()))
    check(st.get("driver.device", "").startswith("cuda"),
          f"server runs on {st.get('driver.device')!r}, not the card")
    return st


def server_launches(st: dict) -> dict:
    out = {mode: int(st[f"kernel.sig_scan.{mode}.launches"])
           for mode in KERNELS}
    for mode in GATHER_MODES:
        out[f"{mode}_gather"] = int(
            st[f"kernel.sig_scan.{mode}.gather.launches"])
    out["pa_scan"] = int(st["kernel.online_scan.launches"])
    for v in SCAN_VARIANTS:
        out[f"pa_scan.{v}"] = int(st[f"kernel.online_scan.{v}.launches"])
    return out


def phase_server(torch, Datum, NearestNeighborDriver, seed: int) -> dict:
    config_path = os.path.join(ROOT, "config", "nearest_neighbor", "lsh.json")
    with open(config_path) as f:
        config = json.load(f)
    with serving("nearest_neighbor", config_path) as cli:
        return _drive_server(Datum, NearestNeighborDriver, config, cli,
                             SERVER_ROWS, seed)


def _drive_server(Datum, NearestNeighborDriver, config, cli, rows,
                  seed) -> dict:
    name = "smoke"
    ref = NearestNeighborDriver(config, device="cpu")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    ids = []
    for i in range(rows):
        d = server_datum(rng, Datum, i)
        rid = f"row{i}"
        check(cli.call("set_row", name, rid, d) is True, "set_row failed")
        ref.set_row(rid, d)
        ids.append(rid)
    t_set = time.perf_counter() - t0
    st0 = server_status(cli)
    calls = 0
    lat = []
    for i in range(20):
        q = server_datum(rng, Datum, rows + i)
        rid = ids[int(rng.integers(len(ids)))]
        for method, arg, local in (
                ("neighbor_row_from_datum", q, ref.neighbor_row_from_datum),
                ("similar_row_from_datum", q, ref.similar_row_from_datum),
                ("neighbor_row_from_id", rid, ref.neighbor_row_from_id),
                ("similar_row_from_id", rid, ref.similar_row_from_id)):
            t1 = time.perf_counter()
            got = cli.call(method, name, arg, 10)
            lat.append((time.perf_counter() - t1) * 1e3)
            calls += 1
            want = local(arg, 10)
            compare_ranked([tuple(x) for x in got], want, f"server {method}")
    all_rows = cli.call("get_all_rows", name)
    check(sorted(all_rows) == sorted(ids), "get_all_rows differs")
    st1 = server_status(cli)
    key = "kernel.sig_scan.hamming.launches"
    moved = st1[key] - st0[key]
    check(moved == calls, f"server scan launches moved {moved} for "
                          f"{calls} queries")
    lat.sort()
    return dict(rows=rows, set_row_s=t_set, query_calls=calls,
                query_p50_ms=lat[len(lat) // 2], query_max_ms=lat[-1],
                launches=server_launches(st1),
                server_device=st1.get("driver.device"))


# ---------------------------------------------------------------------------
# shared by the engine phases
# ---------------------------------------------------------------------------
def load_config(*parts) -> dict:
    with open(os.path.join(ROOT, "config", *parts)) as f:
        return json.load(f)


def launch_counts(sig_scan) -> dict:
    from jubatus_tpu_torch.ops import online_scan

    out = {"hamming": sig_scan.hamming.launches,
           "minhash": sig_scan.minhash.launches,
           "pa_scan": online_scan.pa_scan.launches}
    for mode in GATHER_MODES:
        out[f"{mode}_gather"] = sig_scan.GATHERS[mode].launches
    for v in SCAN_VARIANTS:
        out[f"pa_scan.{v}"] = online_scan.pa_scan.by_variant[v]
    return out


def set_counts(sig_scan, counts: dict) -> None:
    from jubatus_tpu_torch.ops import online_scan

    sig_scan.hamming.launches = counts["hamming"]
    sig_scan.minhash.launches = counts["minhash"]
    for mode in GATHER_MODES:
        sig_scan.GATHERS[mode].launches = counts[f"{mode}_gather"]
    online_scan.pa_scan.launches = counts["pa_scan"]
    for v in SCAN_VARIANTS:
        online_scan.pa_scan.by_variant[v] = counts[f"pa_scan.{v}"]


@contextlib.contextmanager
def uncounted(sig_scan):
    """Launches made inside (checks against the plain version, timings)
    do not count as the main path's."""
    saved = launch_counts(sig_scan)
    try:
        yield
    finally:
        set_counts(sig_scan, saved)


def moved(sig_scan, before: dict) -> dict:
    now = launch_counts(sig_scan)
    return {m: now[m] - before[m] for m in now}


def pcts(lat) -> dict:
    """p50 / p99 / mean of call latencies, and the first call's."""
    first, lat = lat[0], sorted(lat)
    return dict(p50_ms=lat[len(lat) // 2],
                p99_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                mean_ms=statistics.fmean(lat), first_ms=first)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


def random_datums(rng, Datum, n: int, features: int = 32):
    """Datums of ``features`` num features named f0..f511 (0.05..1.05)."""
    out = []
    for _ in range(n):
        d = Datum()
        for j in rng.choice(512, features, replace=False):
            d.add(f"f{j}", float(np.round(rng.random() + 0.05, 3)))
        out.append(d)
    return out


def assert_matmul_full_precision(torch) -> None:
    """euclid_lsh's batched distances are a float32 matmul (cuBLAS): TF32
    would move them far past the stated tolerances."""
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmul is not at full precision (TF32 on)")


def compare_close(got, want, what: str, tol: float) -> None:
    """(id, score) lists: scores within ``tol`` (absolute), ids equal as a
    set where the score is clear of the last one by more than ``tol``."""
    gs = np.array([float(s) for _, s in got])
    ws = np.array([float(s) for _, s in want])
    check(gs.shape == ws.shape, f"{what}: {len(gs)} results, want {len(ws)}")
    if not len(ws):
        return
    err = float(np.abs(gs - ws).max())
    check(err <= tol, f"{what}: scores off by {err} (> {tol})")
    edge = ws[-1]
    clear = (lambda v: v > edge + tol) if ws[0] >= ws[-1] else \
        (lambda v: v < edge - tol)
    g_in = {i for (i, _), v in zip(got, gs) if clear(v)}
    w_in = {i for (i, _), v in zip(want, ws) if clear(v)}
    check(g_in == w_in, f"{what}: ids clear of the boundary differ")


# ---------------------------------------------------------------------------
# phase 5: the recommender at REC_ROWS rows
# ---------------------------------------------------------------------------
EXACT_TOL = 1e-5      # exact distances on the card against the CPU (abs)


def phase_recommender(torch, sig_scan, knn, RecommenderDriver, Datum,
                      config_name: str, seed: int, keep: dict) -> dict:
    """``keep[config_name]`` gets the driver of an exact method (for phase
    14's IVF over it)."""
    config = load_config("recommender", config_name)
    rec = RecommenderDriver(config, device="cuda")
    be = rec.backend
    exact = be.method in ("inverted_index", "euclid")
    t0 = time.perf_counter()
    fill_rows(be, REC_ROWS, seed)
    t_load = time.perf_counter() - t0
    # the write path: signatures of every row (hash methods) or the
    # arenas' upload (the exact methods' device_view)
    t0 = time.perf_counter()
    signed = be.flush()
    if exact:
        view = be.store.device_view(be.device)
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    check(signed == (0 if exact else REC_ROWS),
          f"{config_name}: flushed {signed} rows")
    queries = random_datums(np.random.default_rng(seed + 2), Datum,
                            REC_QUERIES)
    before = launch_counts(sig_scan)
    sim_lat, comp_lat, answers = [], [], []
    for q in queries:
        res, ms = timed(rec.similar_row_from_datum, q, 10)
        sim_lat.append(ms)
        answers.append(res)
        check(len(res) == 10 and all(np.isfinite(v) for _, v in res),
              f"{config_name}: bad similar_row answer {res[:3]}")
    for q in queries:
        comp, ms = timed(rec.complete_row_from_datum, q)
        comp_lat.append(ms)
        check(all(np.isfinite(v) for _, v in comp.num_values),
              f"{config_name}: non-finite complete_row value")
    launched = moved(sig_scan, before)
    if exact:
        check(sum(launched.values()) == 0,
              f"{config_name}: the exact method launched {launched}")
    else:
        mode = "hamming" if be.method == "lsh" else "minhash"
        check(launched[mode] == 2 * REC_QUERIES,
              f"{config_name}: {launched[mode]} scans for "
              f"{2 * REC_QUERIES} queries")
    with uncounted(sig_scan):
        checked = check_recommender(torch, sig_scan, knn, rec, queries[:3],
                                    answers[:3], config_name, exact)
    sim_mean = statistics.fmean(sim_lat)
    pq = random_datums(np.random.default_rng(seed + 3), Datum, REC_PROFILED)
    steps = ([(knn, "densify", "densify"), (knn, "dot_scores", "gather_dot"),
              (knn, "row_norms", "norms"), (be, "_exact_distances", "score")]
             if exact else [(be, "_query_sig", "signature")])
    prof = profile_calls(
        torch, [lambda q=q: rec.similar_row_from_datum(q, 10) for q in pq],
        sim_mean, steps)
    out = dict(config=f"config/recommender/{config_name}", method=be.method,
               rows=REC_ROWS, queries=REC_QUERIES, load_s=t_load,
               flush_s=t_flush, flush_rows_per_s=REC_ROWS / t_flush,
               similar_row=pcts(sim_lat), complete_row=pcts(comp_lat),
               launches=launched, parity=checked, profile=prof)
    if exact:
        out["view_bytes"] = int(sum(t.numel() * t.element_size()
                                    for t in view))
        del view
    else:
        out["table_bytes"] = int(be._sigs.numel() * be._sigs.element_size())
    if exact:
        keep[config_name] = rec
    del rec, be
    torch.cuda.empty_cache()
    return out


def check_recommender(torch, sig_scan, knn, rec, queries, answers,
                      config_name, exact) -> dict:
    """The first queries' answers against their plain versions: for the
    hash methods the plain scan on the same device tensors (exact equality
    of the similarity lists); for the exact methods the whole [C] distance
    vector recomputed on the CPU from the host arenas (within
    ``EXACT_TOL``), and the same for vectors made of stored rows (half
    their entries dropped), which score many rows above 0."""
    be = rec.backend
    worst = 0.0
    if exact:
        idx = torch.from_numpy(be.store.idx)
        val = torch.from_numpy(be.store.val)
        live = torch.from_numpy(be.store.live)
        rng = np.random.default_rng(5)
        vecs = [rec.converter.convert(q) for q in queries]
        for s in rng.integers(0, REC_ROWS, 3):
            row = be.store.get_row(f"r{int(s)}")
            vecs.append(row[::2] + [(int(i), 0.5) for i in
                                    rng.integers(1, be.dim, 4)])
        for n, vec in enumerate(vecs):
            qd = knn.densify(torch.tensor([i for i, _ in vec], dtype=torch.int32),
                             torch.tensor([v for _, v in vec], dtype=torch.float32),
                             dim=be.dim)
            d_cpu = (1.0 - knn.cosine_scores(idx, val, qd)
                     if be.method == "inverted_index"
                     else knn.euclid_distances(idx, val, qd))
            d_cpu = torch.where(live, d_cpu, torch.tensor(float("inf")))
            d_dev = torch.from_numpy(be.distances(vec))
            fin = torch.isfinite(d_cpu)
            check(torch.equal(fin, torch.isfinite(d_dev)),
                  f"{config_name}: dead slots differ")
            err = float((d_dev[fin] - d_cpu[fin]).abs().max())
            worst = max(worst, err)
            check(err <= EXACT_TOL, f"{config_name}: card distances off the "
                                    f"CPU's by {err} (> {EXACT_TOL})")
            vals, order = torch.topk(d_cpu, 10, largest=False, sorted=True)
            want = [(be.store.ids[s], float(be.similarity_from_distance(
                np.float32(v)))) for s, v in zip(order.tolist(), vals.tolist())]
            got = answers[n] if n < len(answers) else be.similar(vec, 10)
            compare_close(got, want, f"{config_name} query {n}", EXACT_TOL)
        return dict(vectors=len(vecs), max_abs_err=worst, tol=EXACT_TOL)
    table = be.sig_table()
    live = torch.tensor(be.store.live, device=table.device)
    for q, res in zip(queries, answers):
        sb = rec.converter.convert(q)
        qi = torch.tensor([[i for i, _ in sb]], dtype=torch.int32,
                          device=table.device)
        qv = torch.tensor([[v for _, v in sb]], dtype=torch.float32,
                          device=table.device)
        if be.method == "lsh":
            qs = knn.lsh_signature(qi, qv, hash_num=be.hash_num, seed=be.seed)
            d = sig_scan.hamming_plain(qs, table, be.hash_num)[0]
        else:
            qs = knn.minhash_signature(qi, qv, hash_num=be.hash_num,
                                       seed=be.seed)
            d = sig_scan.minhash_plain(qs, table)[0]
        d = torch.where(live, d, torch.tensor(float("inf"), device=d.device))
        vals, order = torch.topk(d, 10, largest=False, sorted=True)
        want = [(be.store.ids[s], float(be.similarity_from_distance(
            np.float32(v)))) for s, v in zip(order.tolist(), vals.tolist())]
        compare_ranked(res, want, f"{config_name} plain recompute")
    return dict(vectors=len(queries), max_abs_err=0.0, tol=0.0)


# ---------------------------------------------------------------------------
# phase 6: anomaly LOF at 4096 rows
# ---------------------------------------------------------------------------
LOF_SCORE_RTOL = 1e-4   # euclid_lsh LOF, card against the CPU


def lof_config(nn_method: str) -> dict:
    """config/anomaly/lof_unlearner_lru.json, its nested method set to
    ``nn_method`` (the file's own is euclid_lsh)."""
    config = load_config("anomaly", "lof_unlearner_lru.json")
    config["parameter"]["method"] = nn_method
    return config


def phase_anomaly(torch, sig_scan, AnomalyDriver, Datum, nn_method: str,
                  seed: int) -> dict:
    config = lof_config(nn_method)
    drv = AnomalyDriver(config, device="cuda")
    ref = AnomalyDriver(config, device="cpu")
    be = drv.backend
    exact = nn_method in ("lsh", "minhash")
    mode = {"lsh": "hamming", "minhash": "minhash"}.get(nn_method)
    rng = np.random.default_rng(seed + 7)
    idx, val = random_rows(rng, LOF_ROWS, 32, 18)
    t0 = time.perf_counter()
    for i, (ii, vv) in enumerate(zip(idx.tolist(), val.tolist())):
        be.set_row(f"r{i}", list(zip(ii, vv)))
        ref.backend.set_row(f"r{i}", list(zip(ii, vv)))
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    be.flush()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    slots = np.asarray(sorted(be.store.slots.values()), np.int64)
    n, c = len(slots), be.store.capacity
    # one cold support rebuild, as calc_score runs it
    before = launch_counts(sig_scan)
    (kdist, lrd), support_ms = timed(drv._support)
    rebuild_launches = moved(sig_scan, before)
    chunks = -(-n // 256)
    if exact:
        check(rebuild_launches[mode] == chunks,
              f"LOF {nn_method}: {rebuild_launches[mode]} scans for one "
              f"rebuild of {n} rows, want {chunks}")
    else:
        check(sum(rebuild_launches.values()) == 0,
              f"LOF euclid_lsh launched {rebuild_launches}")
    with uncounted(sig_scan):
        split, shape = lof_split(torch, sig_scan, be, slots, mode, support_ms)
    # the CPU port driver on the same rows: the same support
    rk, rl = ref._support()
    if exact:
        check(np.array_equal(kdist, rk) and np.array_equal(lrd, rl),
              f"LOF {nn_method}: support differs from the CPU driver's")
    else:
        for a, b_, what in ((kdist, rk, "kdist"), (lrd, rl, "lrd")):
            fin = np.isfinite(b_)
            check(np.array_equal(fin, np.isfinite(a)) and np.allclose(
                a[fin], b_[fin], rtol=LOF_SCORE_RTOL, atol=0),
                f"LOF {nn_method}: {what} off the CPU driver's")
    datums = random_datums(np.random.default_rng(seed + 8), Datum,
                           LOF_ADDS + LOF_SCORES)
    before = launch_counts(sig_scan)
    add_lat, score_lat, got, want = [], [], [], []
    for d in datums[:LOF_ADDS]:
        (rid, score), ms = timed(drv.add, d)
        add_lat.append(ms)
        rid_ref, score_ref = ref.add(d)
        check(rid == rid_ref, f"LOF add minted {rid}, the CPU {rid_ref}")
        got.append(score)
        want.append(score_ref)
    for d in datums[LOF_ADDS:]:
        score, ms = timed(drv.calc_score, d)
        score_lat.append(ms)
        got.append(score)
        want.append(ref.calc_score(d))
    path_launches = moved(sig_scan, before)
    got, want = np.array(got), np.array(want)
    check(bool(np.isfinite(got).all()), f"LOF {nn_method}: non-finite score")
    if exact:
        check(np.array_equal(got, want),
              f"LOF {nn_method}: scores differ from the CPU driver's")
        err = 0.0
    else:
        err = float(np.abs(got / want - 1.0).max())
        check(err <= LOF_SCORE_RTOL, f"LOF {nn_method}: scores off the "
                                     f"CPU's by rtol {err}")
    check(len(be.store) == LOF_ROWS, "LRU max_size not held")
    launched = {m: rebuild_launches[m] + path_launches[m] for m in KERNELS}
    del drv, ref, be
    torch.cuda.empty_cache()
    return dict(config="config/anomaly/lof_unlearner_lru.json",
                nn_method=nn_method, rows=n, capacity=c, load_s=t_load,
                flush_s=t_flush, support_cold_ms=support_ms,
                support_split=split, rebuild_launches=rebuild_launches,
                add=pcts(add_lat), calc_score=pcts(score_lat),
                parity=dict(against="the port's driver on the CPU",
                            support_and_scores="bit-equal" if exact else
                            f"rtol {LOF_SCORE_RTOL}", score_max_rtol=err),
                launches=launched, lof_shape=shape)


def lof_split(torch, sig_scan, be, slots, mode, support_ms):
    """The rebuild's parts, each timed on its own: the scans alone (CUDA
    events over every chunk), ``distances_from_slots`` (scans plus the
    [n, C] readback; the readback is the difference) and the host work
    (numpy sorts; the cold rebuild less ``distances_from_slots``). For
    lsh/minhash each chunk's kernel output is held against the plain
    version, and one chunk at B = 256 is timed against it."""
    sigs = be._sigs
    sel = [torch.as_tensor(slots[lo:lo + 256], device=sigs.device)
           for lo in range(0, len(slots), 256)]
    be._scan(sigs[sel[0]], sigs)                       # warm
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    outs = [be._scan(sigs[s], sigs) for s in sel]
    end.record()
    end.synchronize()
    scan_ms = start.elapsed_time(end)
    _, dfs_ms = timed(be.distances_from_slots, slots)
    split = dict(scan_ms=scan_ms, readback_ms=dfs_ms - scan_ms,
                 host_ms=support_ms - dfs_ms,
                 readback_bytes=int(len(slots) * be.store.capacity * 4),
                 chunks=len(sel))
    if mode is None:
        return split, None
    spec = KERNELS[mode]
    plain = ((lambda q: sig_scan.hamming_plain(q, sigs, be.hash_num))
             if mode == "hamming" else
             (lambda q: sig_scan.minhash_plain(q, sigs)))
    err = 0.0
    for s, out in zip(sel, outs):
        ref = plain(sigs[s])
        err = max(err, float((out - ref).abs().max()))
        check(torch.equal(out, ref), f"{mode} at the LOF shape: kernel != "
                                     f"plain (max abs err {err})")
    q = sigs[sel[0]]
    b, c, w = q.shape[0], sigs.shape[0], sigs.shape[1]
    kern_ms = time_ms(torch, lambda: be._scan(q, sigs), REPS)
    plain_ms = time_ms(torch, lambda: plain(q), REPS // 4)
    lib_ms = None
    if mode == "minhash":   # lane values < 2^24 or -1: exact in float32
        qf, rf = q.float(), sigs.float()
        lib_ms = time_ms(torch, lambda: torch.cdist(qf, rf, p=0) / w,
                         REPS // 4)
    bms, by = bound(b, c, w, spec["ops_per_word"])
    return split, dict(B=b, C=c, W=w, variant=sig_scan.choose_variant(
        mode, b, w, sigs.data_ptr() % 16 == 0), kernel_warm_ms=kern_ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
        bound_share=bms / kern_ms, max_abs_err=err)


# ---------------------------------------------------------------------------
# phase 7: the recommender, anomaly and classifier servers over RPC
# ---------------------------------------------------------------------------
def write_config(name: str, config: dict) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def phase_recommender_server(Datum, RecommenderDriver, seed: int) -> dict:
    """config/recommender/default.json (inverted_index, cosine), 10^4
    update_row calls; every query method against the CPU driver.
    complete_row averages the 128 nearest rows: its values are compared
    where the CPU's 128th and 129th distances differ by more than
    ``EXACT_TOL`` (else the rows at the boundary may differ by a tie)."""
    path = os.path.join(ROOT, "config", "recommender", "default.json")
    config = load_config("recommender", "default.json")
    ref = RecommenderDriver(config, device="cpu")
    rng = np.random.default_rng(seed + 11)
    with serving("recommender", path) as cli:
        t0 = time.perf_counter()
        for i in range(SERVER_ROWS):
            d = server_datum(rng, Datum, i)
            check(cli.call("update_row", "smoke", f"u{i}", d) is True,
                  "update_row failed")
            ref.update_row(f"u{i}", d)
        t_set = time.perf_counter() - t0
        lat, compared, skipped = [], 0, 0
        for i in range(20):
            q = server_datum(rng, Datum, SERVER_ROWS + i)
            rid = f"u{int(rng.integers(SERVER_ROWS))}"
            for method, arg, local in (
                    ("similar_row_from_datum", q, ref.similar_row_from_datum),
                    ("similar_row_from_id", rid, ref.similar_row_from_id)):
                got, ms = timed(cli.call, method, "smoke", arg, 10)
                lat.append(ms)
                compare_close([tuple(x) for x in got], local(arg, 10),
                              f"recommender server {method}", EXACT_TOL)
            for method, arg, local, vec in (
                    ("complete_row_from_datum", q, ref.complete_row_from_datum,
                     ref.converter.convert(q)),
                    ("complete_row_from_id", rid, ref.complete_row_from_id,
                     ref.backend.store.get_row(rid))):
                got, ms = timed(cli.call, method, "smoke", arg)
                lat.append(ms)
                nn = ref.backend.neighbors(vec, 129)
                if abs(nn[127][1] - nn[128][1]) <= EXACT_TOL:
                    skipped += 1
                    continue
                want = local(arg)
                got = Datum.from_msgpack(got)
                check([k for k, _ in got.num_values] ==
                      [k for k, _ in want.num_values]
                      and got.string_values == want.string_values,
                      f"recommender server {method}: keys differ")
                err = max([abs(a - b) for (_, a), (_, b) in
                           zip(got.num_values, want.num_values)] or [0.0])
                check(err <= 1e-4, f"recommender server {method}: values "
                                   f"off by {err}")
                compared += 1
            dec = Datum.from_msgpack(cli.call("decode_row", "smoke", rid))
            check(dec == ref.decode_row(rid), "decode_row differs")
            check(cli.call("calc_similarity", "smoke", q, dec) ==
                  ref.calc_similarity(q, dec), "calc_similarity differs")
            check(cli.call("calc_l2norm", "smoke", q) == ref.calc_l2norm(q),
                  "calc_l2norm differs")
        check(compared >= 20, f"complete_row compared {compared} of 40")
        st = server_status(cli)
    return dict(engine="recommender", config="config/recommender/default.json",
                rows=SERVER_ROWS, update_row_s=t_set, query=pcts(lat),
                parity=dict(similar_row_abs_tol=EXACT_TOL,
                            complete_compared=compared,
                            complete_tied=skipped),
                launches=server_launches(st))


def phase_anomaly_server(Datum, AnomalyDriver, seed: int) -> dict:
    """LOF over nested lsh (lof_unlearner_lru.json's settings), fed through
    ``add``: every add rebuilds the support (per store version), so the
    whole fill costs ~n^3 host work and runs at ANOMALY_SERVER_ROWS, not
    10^4. Scores must equal the CPU driver's bit for bit."""
    config = lof_config("lsh")
    path = write_config("anomaly_lof_lsh.json", config)
    ref = AnomalyDriver(config, device="cpu")
    rng = np.random.default_rng(seed + 13)
    with serving("anomaly", path) as cli:
        st0 = server_status(cli)
        lat = []
        t0 = time.perf_counter()
        for i in range(ANOMALY_SERVER_ROWS):
            d = server_datum(rng, Datum, i)
            (rid, score), ms = timed(cli.call, "add", "smoke", d)
            lat.append(ms)
            check([rid, score] == list(ref.add(d)),
                  f"anomaly server add {i}: ({rid}, {score}) differs")
        t_add = time.perf_counter() - t0
        score_lat = []
        for i in range(20):
            d = server_datum(rng, Datum, ANOMALY_SERVER_ROWS + i)
            got, ms = timed(cli.call, "calc_score", "smoke", d)
            score_lat.append(ms)
            check(got == ref.calc_score(d), "anomaly calc_score differs")
        d = server_datum(rng, Datum, 0)
        check(cli.call("update", "smoke", "3", d) == ref.update("3", d),
              "anomaly update differs")
        check(cli.call("overwrite", "smoke", "zz", d) ==
              ref.overwrite("zz", d), "anomaly overwrite differs")
        check(sorted(cli.call("get_all_rows", "smoke")) ==
              sorted(ref.get_all_rows()), "anomaly get_all_rows differs")
        st = server_status(cli)
    launched = {m: server_launches(st)[m] - server_launches(st0)[m]
                for m in KERNELS}
    check(launched["hamming"] > 0, "the anomaly server never scanned")
    return dict(engine="anomaly", config="lof_unlearner_lru.json, nested lsh",
                rows=ANOMALY_SERVER_ROWS, add_s=t_add, add=pcts(lat),
                calc_score=pcts(score_lat), parity="bit-equal",
                launches=launched)


def phase_classifier_server(Datum, ClassifierNNDriver, nn_method: str,
                            seed: int) -> dict:
    """config/classifier/nn.json (k = 128), its nested method as shipped
    (euclid_lsh) or lsh; 10^4 examples through ``train``. Tie rule: where
    the CPU's k-th and (k+1)-th distances differ (by more than
    ``EXACT_TOL`` for euclid_lsh), the per-label scores are compared;
    where they tie, the scores' sum over the labels, which depends only on
    the k nearest distances."""
    config = load_config("classifier", "nn.json")
    if nn_method != config["parameter"]["method"]:
        config["parameter"]["method"] = nn_method
        path = write_config(f"classifier_nn_{nn_method}.json", config)
    else:
        path = os.path.join(ROOT, "config", "classifier", "nn.json")
    exact = nn_method in ("lsh", "minhash")
    rtol = 1e-9 if exact else 1e-4
    gap = 0.0 if exact else EXACT_TOL
    ref = ClassifierNNDriver(config, device="cpu")
    rng = np.random.default_rng(seed + 17)
    with serving("classifier", path) as cli:
        t0 = time.perf_counter()
        for lo in range(0, SERVER_ROWS, 200):
            batch = [[f"l{int(rng.integers(5))}", server_datum(rng, Datum, i)]
                     for i in range(lo, lo + 200)]
            check(cli.call("train", "smoke", batch) == len(batch),
                  "train failed")
            ref.train([(lab, d) for lab, d in batch])
        t_train = time.perf_counter() - t0
        check(cli.call("get_labels", "smoke") == ref.get_labels(),
              "get_labels differs")
        st0 = server_status(cli)
        queries = [server_datum(rng, Datum, SERVER_ROWS + i) for i in range(20)]
        lat, per_label, by_sum = [], 0, 0
        for q in queries:
            (got,), ms = timed(cli.call, "classify", "smoke", [q])
            lat.append(ms)
            (want,) = ref.classify([q])
            check([lab for lab, _ in got] == [lab for lab, _ in want],
                  "classify labels differ")
            g = np.array([s for _, s in got])
            w = np.array([s for _, s in want])
            nn = ref.backend.neighbors(ref.converter.convert(q), ref.k + 1)
            if abs(nn[ref.k - 1][1] - nn[ref.k][1]) > gap:
                check(np.allclose(g, w, rtol=rtol, atol=0),
                      f"classify ({nn_method}) scores differ: {got} {want}")
                per_label += 1
            else:
                check(np.isclose(g.sum(), w.sum(), rtol=rtol, atol=0),
                      f"classify ({nn_method}) score sums differ")
                by_sum += 1
        st = server_status(cli)
    launched = {m: server_launches(st)[m] - server_launches(st0)[m]
                for m in KERNELS}
    if nn_method == "lsh":
        check(launched["hamming"] == len(queries),
              f"classifier server: {launched} scans for {len(queries)} "
              f"queries")
    return dict(engine="classifier", config=f"config/classifier/nn.json, "
                f"nested {nn_method}", rows=SERVER_ROWS, train_s=t_train,
                classify=pcts(lat),
                parity=dict(rtol=rtol, compared_per_label=per_label,
                            compared_by_sum=by_sum),
                launches=server_launches(st))


# ---------------------------------------------------------------------------
# phase 8: the linear classifier at the JAX package's bench shape
# ---------------------------------------------------------------------------
CLF_B = 32768                 # bench.py: AROW, L = 2, K = 64, B = 32768
CLF_K = 64
CLF_L = 2
CLF_DIM_BITS = (20, 24)
CLF_WARMUP = 2
CLF_STEPS = 10                # timed steps (median)
CLF_CHECK_STEPS = 4           # steps held against the CPU port
CLF_QUERIES = 200             # classify_hashed at B = 1
CLF_BIG_QUERIES = 10          # classify_hashed at B = CLF_B
# card against CPU: |d| <= CLF_TOL * max|cpu| + 1e-4 * |cpu|. Sums over K
# and the scatter's order of duplicate adds differ (CUDA sorts the indices
# and may add in another order than the CPU's serial loop)
CLF_TOL = 1e-5
CLF_CONFIG = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
              "converter": {"num_rules": [{"key": "*", "type": "num"}]}}


def bench_batch(rng, dim_bits: int, b: int = CLF_B):
    """bench.py's make_data: uniform indices in [1, D), normal values,
    labels in {0, 1}."""
    idx = rng.integers(1, 1 << dim_bits, size=(b, CLF_K), dtype=np.int32)
    val = rng.normal(size=(b, CLF_K)).astype(np.float32)
    lab = rng.integers(0, CLF_L, size=b).astype(np.int32)
    return idx, val, lab


def table_err(got, want) -> float:
    """max |got - want| over CLF_TOL * max|want| + 1e-4 |want|: <= 1 holds."""
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    limit = CLF_TOL * float(want.abs().max()) + 1e-4 * want.abs() + 1e-30
    return float(((got - want).abs() / limit).max())


def run_steps(C, state, batches, mask, method):
    for idx, val, lab in batches:
        C.train_batch_parallel(state, idx, val, lab, mask, 1.0, method=method)
    return state


def phase_classifier_ops(torch, C, dim_bits: int, seed: int) -> dict:
    """train_batch_parallel at the bench shape: examples/s (median of
    CLF_STEPS CUDA-event-timed steps), one step profiled, the state after
    CLF_CHECK_STEPS steps against the CPU port, the deterministic-mode
    reproduction (D = 2^20) and one PA1 and CW step against the CPU."""
    dev = torch.device("cuda")
    d = 1 << dim_bits
    rng = np.random.default_rng(seed + dim_bits)
    host = [bench_batch(rng, dim_bits)
            for _ in range(CLF_WARMUP + CLF_STEPS)]
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in host]
    mask = torch.ones(CLF_L, dtype=torch.bool, device=dev)
    st = C.init_state(CLF_L, d, True, device=dev)
    run_steps(C, st, batches[:CLF_WARMUP], mask, "AROW")
    torch.cuda.synchronize()
    times, walls = [], []
    for b in batches[CLF_WARMUP:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run_steps(C, st, [b], mask, "AROW")
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    wall_ms = statistics.median(walls)
    prof = profile_calls(
        torch, [lambda: run_steps(C, st, [batches[-1]], mask, "AROW")],
        wall_ms, [])
    check(bool(torch.isfinite(st.dw).all()), "AROW state is not finite")
    # the card against the CPU port, CLF_CHECK_STEPS steps from init
    mask_cpu = mask.cpu()
    on_card = run_steps(C, C.init_state(CLF_L, d, True, device=dev),
                        batches[:CLF_CHECK_STEPS], mask, "AROW")
    on_cpu = run_steps(C, C.init_state(CLF_L, d, True, device="cpu"),
                       [tuple(torch.from_numpy(a) for a in b)
                        for b in host[:CLF_CHECK_STEPS]], mask_cpu, "AROW")
    errs = {name: table_err(a, b) for name, a, b in
            zip(("w", "dw", "prec", "dprec"), on_card, on_cpu)}
    check(max(errs.values()) <= 1.0,
          f"AROW D=2^{dim_bits}: card off the CPU port {errs}")
    q_idx, q_val, _ = host[0]
    s_card = C.scores(on_card, batches[0][0][:256], batches[0][1][:256], mask)
    s_cpu = C.scores(on_cpu, torch.from_numpy(q_idx[:256]),
                     torch.from_numpy(q_val[:256]), mask_cpu)
    errs["scores"] = table_err(s_card, s_cpu)
    check(errs["scores"] <= 1.0, f"AROW scores off the CPU: {errs}")
    del on_card, on_cpu
    out = dict(dim_bits=dim_bits, B=CLF_B, K=CLF_K, L=CLF_L,
               step_ms=step_ms, step_wall_ms=wall_ms,
               examples_per_s=CLF_B / step_ms * 1e3,
               step_ms_all=times, profile=prof,
               cpu_parity=dict(steps=CLF_CHECK_STEPS, tol=CLF_TOL,
                               err_over_limit=errs))
    if dim_bits == 20:
        out["deterministic"] = deterministic_repro(torch, C, batches, mask, d)
        out["other_methods"] = {}
        for method in ("PA1", "CW"):
            conf = method in C.CONFIDENCE_METHODS
            a = run_steps(C, C.init_state(CLF_L, d, conf, device=dev),
                          batches[:1], mask, method)
            b = run_steps(C, C.init_state(CLF_L, d, conf, device="cpu"),
                          [tuple(torch.from_numpy(x) for x in host[0])],
                          mask_cpu, method)
            e = max(table_err(x, y) for x, y in zip(a, b))
            check(e <= 1.0, f"{method}: card off the CPU port ({e})")
            out["other_methods"][method] = e
    return out


def deterministic_repro(torch, C, batches, mask, d) -> dict:
    """Under torch.use_deterministic_algorithms(True), CLF_CHECK_STEPS
    steps from init twice: the two states must be equal bit for bit."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = [run_steps(C, C.init_state(CLF_L, d, True,
                                          device=batches[0][0].device),
                          batches[:CLF_CHECK_STEPS], mask, "AROW")
                for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(was)
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(same, "deterministic mode: two runs of the same steps differ")
    return dict(steps=CLF_CHECK_STEPS, bit_equal=same)


def phase_classifier_driver(torch, C, ClassifierDriver, dim_bits: int,
                            seed: int) -> dict:
    """The driver's train_hashed (label slots, upload, the step at the
    driver's capacity of 8 rows) and classify_hashed at B = 1 and B =
    CLF_B; its answers against ops.scores of its own state on the CPU."""
    drv = ClassifierDriver(CLF_CONFIG, dim_bits=dim_bits, device="cuda")
    rng = np.random.default_rng(seed + 100 + dim_bits)
    host = [bench_batch(rng, dim_bits) for _ in range(CLF_WARMUP + CLF_STEPS)]
    names = np.array(["neg", "pos"])
    walls = []
    for i, (idx, val, lab) in enumerate(host):
        t0 = time.perf_counter()
        check(drv.train_hashed(list(names[lab]), idx, val) == CLF_B,
              "train_hashed count")
        torch.cuda.synchronize()
        if i >= CLF_WARMUP:
            walls.append((time.perf_counter() - t0) * 1e3)
    train_ms = statistics.median(walls)
    q_idx, q_val, _ = bench_batch(rng, dim_bits)
    lat1 = []
    for i in range(CLF_QUERIES):
        _, ms = timed(drv.classify_hashed, q_idx[i:i + 1], q_val[i:i + 1])
        lat1.append(ms)
    lat_big = []
    for _ in range(CLF_BIG_QUERIES):
        big, ms = timed(drv.classify_hashed, q_idx, q_val)
        lat_big.append(ms)
    state_cpu = C.ClassifierState(*(t.cpu() for t in drv.state))
    mask = torch.zeros(drv.capacity, dtype=torch.bool)
    mask[list(drv.label_slots.values())] = True
    want = C.scores(state_cpu, torch.from_numpy(q_idx[:64]),
                    torch.from_numpy(q_val[:64]), mask)
    got = torch.tensor([[s for _, s in row] for row in big[:64]])
    slots = [drv.label_slots[lab] for lab, _ in big[0]]
    err = table_err(got, want[:, slots])
    check(err <= 1.0, f"driver classify off the CPU recomputation ({err})")
    return dict(dim_bits=dim_bits, B=CLF_B, capacity=drv.capacity,
                train_hashed_ms=train_ms,
                train_examples_per_s=CLF_B / train_ms * 1e3,
                classify_b1=pcts(lat1), classify_big=pcts(lat_big),
                classify_parity_err_over_limit=err)


# ---------------------------------------------------------------------------
# phase 9: regression's scan kernel against its plain version
# ---------------------------------------------------------------------------
SCAN_DIM_BITS = 18            # the server's feature space
SCAN_K = 64
SCAN_CHECK_B = 1024
SCAN_TIME_B = 8192            # the server's --microbatch-max
SCAN_REPS = 10
SCAN_FLOPS_PER_FEATURE = 7    # 2 mul + add (pred), mul + add (x2), mul, add
# kernel against the plain version on the card: |d| <= SCAN_CARD_TOL *
# max|dw|. Only the order of duplicate adds differs there (and what it
# feeds into the later examples' predictions)
SCAN_CARD_TOL = 1e-5


def pa_scan_inputs(rng, b: int):
    """Rows as the server's batches look: 48 features and 16 padding
    columns (index 0, value 0), with duplicate indices inside a round of 32
    lanes and across rounds."""
    d = 1 << SCAN_DIM_BITS
    idx = rng.integers(1, d, size=(b, SCAN_K)).astype(np.int32)
    val = rng.normal(size=(b, SCAN_K)).astype(np.float32)
    idx[:, 48:] = 0
    val[:, 48:] = 0.0
    idx[::3, 5] = idx[::3, 2]
    idx[::5, 37] = idx[::5, 2]
    y = (rng.normal(size=b) * 3).astype(np.float32)
    w = (rng.normal(size=d) * 0.1).astype(np.float32)
    return idx, val, y, w


def scan_server_batch(rng, Datum, RegressionDriver, rows: int):
    """``rows`` rows of the regression server's traffic (phase 9's
    ``server_datum``, target the sum of the numeric values) featurized on
    the CPU by ``config/regression/default.json``'s driver, and random
    weights over its feature space: (idx, val, targets, w)."""
    drv = RegressionDriver(load_config("regression", "default.json"),
                           device="cpu")
    data = [linear_example(rng, Datum, "regression", i) for i in range(rows)]
    targets, idx, val = drv.featurize_train(data)
    w = (rng.normal(size=drv.converter.dim) * 0.1).astype(np.float32)
    return idx, val, targets, w


def scan_check(torch, online_scan, inputs, method: str, what: str) -> dict:
    """The kernel bit-equal to the plain version on the CPU, and within
    SCAN_CARD_TOL of it on the card (deterministic algorithms on)."""
    dev = torch.device("cuda")
    idx, val, y, w = inputs
    d = w.shape[0]
    cpu = [torch.from_numpy(a) for a in (idx, val, y, w)]
    card = [a.to(dev) for a in cpu]
    dw_k = torch.zeros(d, device=dev)
    online_scan.pa_scan(card[3], dw_k, card[0], card[1], card[2], 0.1, 0.7,
                        method)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        dw_p = online_scan.pa_scan_plain(card[3], torch.zeros(d, device=dev),
                                         card[0], card[1], card[2], 0.1, 0.7,
                                         method)
    finally:
        torch.use_deterministic_algorithms(was)
    dw_c = online_scan.pa_scan_plain(cpu[3], torch.zeros(d), cpu[0], cpu[1],
                                     cpu[2], 0.1, 0.7, method)
    torch.cuda.synchronize()
    err = float((dw_k - dw_p).abs().max())
    scale = float(dw_p.abs().max())
    check(scale > 0.0, f"scan {what} {method}: no update")
    check(torch.equal(dw_k.cpu(), dw_c),
          f"scan {what} {method}: kernel != plain on the CPU (max "
          f"{float((dw_k.cpu() - dw_c).abs().max())})")
    check(err <= SCAN_CARD_TOL * scale,
          f"scan {what} {method}: kernel off the plain version on the card "
          f"by {err} (> {SCAN_CARD_TOL} x {scale})")
    return dict(B=int(idx.shape[0]), K=int(idx.shape[1]), max_abs_err=err,
                max_abs=scale, bit_equal_cpu=True,
                bit_equal_card=bool(torch.equal(dw_k, dw_p)),
                variant=online_scan.choose_variant(idx.shape[1]))


def scan_timing(torch, online_scan, inputs, lat: dict) -> dict:
    """PA (config/regression/default.json's method) at these inputs: the
    launch's counters from a first run on dw = 0, then the median of
    SCAN_REPS CUDA-event timings of the launch alone (the wrapper's index
    check runs once, before them), the bounds and each one's share."""
    dev = torch.device("cuda")
    idx, val, y, w = inputs
    b, k = idx.shape
    card = [torch.from_numpy(a).to(dev) for a in (idx, val, y, w)]
    dw = torch.zeros(w.shape[0], device=dev)
    launch = online_scan.pa_scan.plan(card[3], dw, card[0], card[1],
                                      card[2], 0.1, 1.0, "PA")
    launch.run()
    stats = online_scan.pa_scan.stats()
    kernel_ms = time_ms(torch, launch.run, SCAN_REPS)
    uniq = int(np.unique(idx).size)
    t_bytes = (b * k * 8 + b * 4 + uniq * 12) / HBM_BYTES_PER_S * 1e3
    t_ops = SCAN_FLOPS_PER_FEATURE * b * k / ALU_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    # PR 4's chain: 2 dependent device-memory loads + 5 shuffle-adds an
    # example; the table's: 1 dependent shared-memory load + 5 shuffle-adds
    chain_ms = b * (2 * lat["load_ns"] + 5 * lat["shuffle_ns"]) / 1e6
    smem_chain_ms = b * (lat["smem_load_ns"] + 5 * lat["shuffle_ns"]) / 1e6
    return dict(B=int(b), K=int(k), variant=launch.variant,
                tile=online_scan.tile_for(k), distinct_indices=uniq,
                working_set_bytes=uniq * 8,
                table_capacity=(online_scan.table_capacity(k)
                                if launch.variant != "direct" else None),
                flushes=stats["flushes"],
                walker_wait_share=(stats["walker_wait_cycles"]
                                   / max(1, stats["walker_cycles"])),
                launch_counters=stats,
                kernel_ms=kernel_ms, per_example_us=kernel_ms * 1e3 / b,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_share=bound_ms / kernel_ms,
                chain_bound_ms=chain_ms, chain_share=chain_ms / kernel_ms,
                smem_chain_bound_ms=smem_chain_ms,
                smem_chain_share=smem_chain_ms / kernel_ms)


def phase_scan(torch, online_scan, Datum, RegressionDriver,
               seed: int) -> dict:
    """Each method's kernel bit-equal to the plain version on the CPU,
    whose serial ``index_put_`` adds an example's duplicate indices in k
    order as the kernel does, and within SCAN_CARD_TOL of the plain version
    on the card, whose ``index_put_`` sums each run of duplicates in its
    own order first: on the stress shape (``pa_scan_inputs``) and on a
    server-shaped batch (``scan_server_batch``). Then the kernel's time at
    B = SCAN_TIME_B on both shapes against its bounds, and the plain
    version's on the stress shape."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 31)
    checks = {}
    for method in online_scan.METHODS:
        checks[method] = scan_check(torch, online_scan,
                                    pa_scan_inputs(rng, SCAN_CHECK_B),
                                    method, "stress")
        checks[f"server_{method}"] = scan_check(
            torch, online_scan,
            scan_server_batch(rng, Datum, RegressionDriver, SCAN_CHECK_B),
            method, "server")
    lat = online_scan.latency_probe(dev)
    stress_in = pa_scan_inputs(rng, SCAN_TIME_B)
    stress = scan_timing(torch, online_scan, stress_in, lat)
    server = scan_timing(
        torch, online_scan,
        scan_server_batch(rng, Datum, RegressionDriver, SCAN_TIME_B), lat)
    idx, val, y, w = (torch.from_numpy(a).to(dev) for a in stress_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    online_scan.pa_scan_plain(w, torch.zeros_like(w), idx, val, y, 0.1, 1.0,
                              "PA")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    return dict(checks=checks, latency=lat, stress=stress, server=server,
                dim_bits=SCAN_DIM_BITS, plain_ms=plain_ms,
                max_abs_err=max(c["max_abs_err"] for c in checks.values()))


# ---------------------------------------------------------------------------
# phase 9: the linear classifier and regression servers over RPC
# ---------------------------------------------------------------------------
LINEAR_BATCH = 256            # rows per train call
LINEAR_THREADS = 4            # concurrent train clients (coalesced)
LINEAR_QUERIES = 50
# answers of the card's server against the CPU port's driver fed the same
# batches: |d| <= LINEAR_TOL * max|want| + 1e-4 |want|
LINEAR_TOL = 1e-5


def linear_example(rng, Datum, engine: str, i: int):
    d = server_datum(rng, Datum, i)
    if engine == "classifier":
        return [f"l{i % 3}", d]
    return [float(sum(v for _, v in d.num_values)), d]


def phase_linear_server(Datum, Driver, engine: str, config_name: str,
                        seed: int) -> dict:
    """config/<engine>/<config_name> on the card. First SERVER_ROWS rows
    in LINEAR_BATCH-row train calls from LINEAR_THREADS clients at once
    (the coalescer merges them; each call must return its own count); then
    ``clear`` and the same rows from one client, so each call is one flush
    and a CPU driver fed the same batches holds the same model; then
    LINEAR_QUERIES classify / estimate calls against it."""
    path = os.path.join(ROOT, "config", engine, config_name)
    config = load_config(engine, config_name)
    ref = Driver(config, device="cpu")
    rng = np.random.default_rng(seed + 41)
    rows = [linear_example(rng, Datum, engine, i) for i in range(SERVER_ROWS)]
    batches = [rows[lo:lo + LINEAR_BATCH]
               for lo in range(0, SERVER_ROWS, LINEAR_BATCH)]
    query = "classify" if engine == "classifier" else "estimate"
    from jubatus_tpu_torch.rpc.client import RpcClient

    with serving(engine, path) as cli:
        st0 = server_status(cli)
        counts, errors = [], []

        def client(k):
            try:
                with RpcClient(cli.host, cli.port, timeout=120.0) as c:
                    for b in batches[k::LINEAR_THREADS]:
                        counts.append((len(b), c.call("train", "smoke", b)))
            except Exception as e:  # broad-ok — reported below
                errors.append(e)

        import threading

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(LINEAR_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_conc = time.perf_counter() - t0
        check(not errors, f"{engine} concurrent train failed: {errors[:1]}")
        check(all(a == b for a, b in counts) and len(counts) == len(batches),
              f"{engine}: a train call got another count back")
        st1 = server_status(cli)
        flushes = (st1["microbatch.train.flush_count"]
                   - st0.get("microbatch.train.flush_count", 0))
        check(st1["microbatch.train.item_count"] == SERVER_ROWS,
              f"{engine}: {st1['microbatch.train.item_count']} examples "
              f"flushed, want {SERVER_ROWS}")
        check(cli.call("clear", "smoke") is True, "clear failed")
        t0 = time.perf_counter()
        for b in batches:
            check(cli.call("train", "smoke", b) == len(b), "train count")
        t_seq = time.perf_counter() - t0
        for b in batches:
            ref.train([(lab, d) for lab, d in b])
        qs = [server_datum(rng, Datum, SERVER_ROWS + i)
              for i in range(LINEAR_QUERIES)]
        lat, got = [], []
        for q in qs:
            (ans,), ms = timed(cli.call, query, "smoke", [q])
            lat.append(ms)
            got.append(ans)
        want = (ref.classify(qs) if engine == "classifier"
                else ref.estimate(qs))
        if engine == "classifier":
            check([[lab for lab, _ in r] for r in got] ==
                  [[lab for lab, _ in r] for r in want], "labels differ")
            check(cli.call("get_labels", "smoke") == ref.get_labels(),
                  "get_labels differs")
            g = np.array([[s for _, s in r] for r in got], dtype=np.float64)
            w = np.array([[s for _, s in r] for r in want], dtype=np.float64)
        else:
            g = np.array(got, dtype=np.float64)
            w = np.array(want, dtype=np.float64)
        check(np.isfinite(g).all(), f"{engine}: answers not finite")
        limit = LINEAR_TOL * float(np.abs(w).max()) + 1e-4 * np.abs(w) + 1e-30
        err = float((np.abs(g - w) / limit).max())
        check(err <= 1.0, f"{engine} {query}: off the CPU driver ({err})")
        st = server_status(cli)
    return dict(engine=engine, config=f"config/{engine}/{config_name}",
                rows=SERVER_ROWS, batch=LINEAR_BATCH,
                concurrent=dict(threads=LINEAR_THREADS, calls=len(batches),
                                flushes=flushes, seconds=t_conc,
                                rows_per_s=SERVER_ROWS / t_conc),
                sequential=dict(calls=len(batches), seconds=t_seq,
                                rows_per_s=SERVER_ROWS / t_seq),
                **{query: pcts(lat)},
                parity=dict(tol=LINEAR_TOL, err_over_limit=err),
                launches=server_launches(st))


# ---------------------------------------------------------------------------
# phase 10: clustering and graph on the card, and the six servers over RPC
# ---------------------------------------------------------------------------
CLUSTER_ROWS = 16_384         # server_datum rows per k-means / GMM run
CLUSTER_PUSH = 1_024          # rows per push: bucket_size 1000, one recluster
DBSCAN_ROWS = 8_192
DBSCAN_GROUPS = 512           # near-duplicate groups of the DBSCAN rows
DBSCAN_JITTER = 0.02          # |offset| on two numeric features of a row
DBSCAN_NOISE_EVERY = 20       # every 20th DBSCAN row is a lone row (noise)
# the card against the CPU port driver fed the same pushes: centres within
# CLUSTER_TOL (absolute; cuBLAS and the CPU's BLAS round differently, and
# 25 Lloyd / EM iterations carry it); assignments equal, except at a point
# whose two nearest centres (k-means) or two largest log-responsibilities
# (GMM) lie within TIE_RTOL (relative) of each other on the CPU
CLUSTER_TOL = 1e-3
TIE_RTOL = 1e-4
# DBSCAN's rows keep every pair's squared distance further than this
# (relative) from eps², which the run checks
DBSCAN_MARGIN = 1e-3
GRAPH_NODES = 65_536
GRAPH_EDGES = 524_288
GRAPH_QUERIES = 200
# PageRank on the card against the CPU port driver: CUDA's index_add_ adds
# duplicates in no fixed order
PAGERANK_RTOL = 1e-5
NEW_ENGINES = ("clustering", "graph", "stat", "bandit", "burst", "weight")


def fit_profile(torch, fit) -> dict:
    """One fit's device time: CUDA events (median of 3 after a warm-up),
    its wall time to the device's completion (median of 3), and one call
    under torch.profiler: device busy against that wall time."""
    event_ms = time_ms(torch, fit, reps=3)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    prof = profile_calls(torch, [fit], wall_ms, [])
    return dict(event_ms=event_ms, wall_ms=wall_ms,
                busy_ms=prof["device_busy_ms_per_query"],
                idle_share=prof["device_idle_share"],
                device_items=prof["device_items_per_query"],
                top_device_us=prof["top_device_us"][:3])


def split_ms(last: dict) -> dict:
    return {k[:-2] + "_ms": v * 1e3 for k, v in last.items()
            if k.endswith("_s")}


def tie_points(x, cpu, method: str, torch, ops) -> np.ndarray:
    """Points whose assignment is a near-tie on the CPU driver: the two
    nearest centres (k-means) or the two largest log-responsibilities
    (GMM, refitted on the CPU) within TIE_RTOL of each other."""
    if method == "kmeans":
        score = ((x[:, None, :].astype(np.float64)
                  - cpu._centers[None].astype(np.float64)) ** 2).sum(-1)
    else:
        state, _ = ops.gmm_fit(torch.from_numpy(x),
                               torch.from_numpy(np.asarray(cpu._weights,
                                                           np.float32)),
                               k=len(cpu._centers), seed=cpu.seed)
        score = -ops._log_resp(torch.from_numpy(x), state).double().numpy()
    s = np.sort(score, axis=1)
    return (s[:, 1] - s[:, 0]) <= TIE_RTOL * np.maximum(np.abs(s[:, 0]), 1.0)


def phase_clustering(torch, ClusteringDriver, ops, Datum, config_name: str,
                     seed: int) -> dict:
    """config/clustering/<config_name> (kmeans.json / gmm.json as shipped:
    k = 3, bucket_size 1000) on the card: CLUSTER_ROWS of phase 9's rows in
    pushes of CLUSTER_PUSH, each push reclustering once; the last
    recluster split into compact, upload, fit, readback and members, the
    fit timed apart (``fit_profile``); the final centres and assignments
    held against the CPU port driver fed the same pushes."""
    config = load_config("clustering", config_name)
    card = ClusteringDriver(config, device="cuda")
    cpu = ClusteringDriver(config, device="cpu")
    rng = np.random.default_rng(seed + 61)
    rows = [server_datum(rng, Datum, i) for i in range(CLUSTER_ROWS)]
    lat = []
    for lo in range(0, CLUSTER_ROWS, CLUSTER_PUSH):
        pts = [(f"c{i}", rows[i]) for i in range(lo, lo + CLUSTER_PUSH)]
        _, ms = timed(card.push, pts)
        lat.append(ms)
        cpu.push(pts)
    pushes = CLUSTER_ROWS // CLUSTER_PUSH
    check(card.revision == cpu.revision == pushes,
          f"{config_name}: {card.revision} reclusters, want {pushes}")
    last = split_ms(card.last_recluster)
    x, _ = card._compact()
    xt = torch.from_numpy(x).cuda()
    wt = torch.from_numpy(np.asarray(card._weights, np.float32)).cuda()
    k = len(card._centers)
    fit = (lambda: ops.kmeans_fit(xt, wt, k=k, seed=card.seed)) \
        if card.method == "kmeans" else \
        (lambda: ops.gmm_fit(xt, wt, k=k, seed=card.seed))
    check(np.array_equal(fit()[1].cpu().numpy(), card._assign),
          f"{config_name}: a refit on the card assigns otherwise")
    prof = fit_profile(torch, fit)
    err = float(np.abs(card._centers - cpu._centers).max())
    check(np.isfinite(card._centers).all(), f"{config_name}: centres not "
                                            "finite")
    check(err <= CLUSTER_TOL, f"{config_name}: centres off the CPU driver's "
                              f"by {err} (> {CLUSTER_TOL})")
    differ = card._assign != cpu._assign
    ties = tie_points(x, cpu, card.method, torch, ops)
    check(not (differ & ~ties).any(),
          f"{config_name}: {int((differ & ~ties).sum())} assignments differ "
          "from the CPU driver's away from a tie")
    sizes = np.bincount(card._assign, minlength=k).tolist()
    return dict(config=f"config/clustering/{config_name}", rows=CLUSTER_ROWS,
                dims=int(x.shape[1]), pushes=pushes, push=pcts(lat),
                last_recluster=last, fit=prof, cluster_sizes=sizes,
                parity=dict(centre_tol=CLUSTER_TOL, centre_err=err,
                            assign_differ=int(differ.sum()),
                            ties=int(ties.sum())))


def dbscan_rows(rng, Datum, n: int):
    """Rows of phase 9's shape in DBSCAN_GROUPS groups of near-duplicates
    (two numeric features moved by up to DBSCAN_JITTER), every
    DBSCAN_NOISE_EVERY-th row a lone row."""
    groups = [server_datum(rng, Datum, i) for i in range(DBSCAN_GROUPS)]
    rows = []
    for i in range(n):
        if i % DBSCAN_NOISE_EVERY == 0:
            rows.append(server_datum(rng, Datum, DBSCAN_GROUPS + i))
            continue
        g = groups[int(rng.integers(DBSCAN_GROUPS))]
        d = Datum(string_values=g.string_values)
        for j, (key, v) in enumerate(g.num_values):
            if j < 2:
                v = float(np.round(v + rng.uniform(-DBSCAN_JITTER,
                                                   DBSCAN_JITTER), 4))
            d.add(key, v)
        rows.append(d)
    return rows


def dbscan_reference(x, w, eps: float, min_core: int):
    """DBSCAN's labels, renumbered as the driver renumbers them, by a plain
    host computation: float64 distances, core points, connected components
    of the core graph (scipy), a component's least core index, borders to
    the least adjacent cluster. Also the least relative gap of a squared
    distance to eps²."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(x)
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    d2 = np.maximum(sq[:, None] - 2.0 * (x64 @ x64.T) + sq[None, :], 0.0)
    eps2 = float(np.float32(np.float32(eps) * np.float32(eps)))
    margin = float(np.abs(d2 - eps2).min() / eps2)
    adj = d2 <= eps2
    del d2
    core = adj.astype(np.float64) @ w.astype(np.float64) >= min_core
    _, comp = connected_components(
        csr_matrix(adj & core[:, None] & core[None, :]), directed=False)
    first = np.full(comp.max() + 1, n)
    np.minimum.at(first, comp[core], np.flatnonzero(core))
    label = np.where(core, first[comp], n)
    border = np.where(adj & core[None, :], label[None, :], n).min(axis=1)
    raw = np.where(core, label, border)
    reps = sorted({int(r) for r in raw if r < n})
    renum = {rep: c for c, rep in enumerate(reps)}
    return np.asarray([renum.get(int(r), -1) for r in raw]), margin


def phase_dbscan(torch, ClusteringDriver, ops, Datum, seed: int) -> dict:
    """config/clustering/dbscan.json as shipped (eps 0.2, min_core_point
    2) on the card: DBSCAN_ROWS rows in pushes of CLUSTER_PUSH; the last
    recluster (N = DBSCAN_ROWS, ⌈log2 N⌉ = 13 closure products) split and
    its fit timed; the labels held against ``dbscan_reference``."""
    config = load_config("clustering", "dbscan.json")
    card = ClusteringDriver(config, device="cuda")
    rng = np.random.default_rng(seed + 67)
    rows = dbscan_rows(rng, Datum, DBSCAN_ROWS)
    lat = []
    for lo in range(0, DBSCAN_ROWS, CLUSTER_PUSH):
        _, ms = timed(card.push, [(f"d{i}", rows[i])
                                  for i in range(lo, lo + CLUSTER_PUSH)])
        lat.append(ms)
    last = split_ms(card.last_recluster)
    x, _ = card._compact()
    w = np.asarray(card._weights, np.float32)
    want, margin = dbscan_reference(x, w, card.eps, card.min_core_point)
    check(margin > DBSCAN_MARGIN, f"dbscan rows: a pair lies within "
                                  f"{margin} of eps² (data, not the port)")
    check(np.array_equal(card._assign, want),
          f"dbscan: {int((card._assign != want).sum())} labels differ from "
          "the plain reference")
    xt, wt = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    prof = fit_profile(torch, lambda: ops.dbscan_fit(
        xt, wt, card.eps, min_core_point=card.min_core_point))
    n = DBSCAN_ROWS
    flops = ops.closure_steps(n) * 2.0 * n ** 3
    return dict(config="config/clustering/dbscan.json", rows=n,
                dims=int(x.shape[1]), pushes=len(lat), push=pcts(lat),
                last_recluster=last, fit=prof,
                closure=dict(steps=ops.closure_steps(n), flops=flops,
                             tflops_per_s=flops / prof["event_ms"] / 1e9),
                clusters=int(want.max()) + 1,
                noise=int((want < 0).sum()),
                parity=dict(labels_equal=True, eps2_margin=margin))


def phase_graph(torch, GraphDriver, seed: int) -> dict:
    """config/graph/default.json (damping 0.9) on the card, in-process:
    GRAPH_NODES nodes and GRAPH_EDGES edges (sources uniform, targets
    skewed: the square of a uniform draw), one centrality query with an
    empty filter; ``update_index`` split into the filter and the edge
    arrays (host), the upload, the PageRank loop (device, to its
    completion) and the readback; the
    ranks held against the CPU port driver loaded from the card driver's
    pack; GRAPH_QUERIES get_centrality calls timed."""
    config = load_config("graph", "default.json")
    card = GraphDriver(config, device="cuda")
    rng = np.random.default_rng(seed + 71)
    src = rng.integers(GRAPH_NODES, size=GRAPH_EDGES)
    dst = (GRAPH_NODES * rng.random(GRAPH_EDGES) ** 2).astype(np.int64)
    t0 = time.perf_counter()
    for _ in range(GRAPH_NODES):
        card.create_node()
    for s_, d_ in zip(src.tolist(), dst.tolist()):
        card.create_edge(str(s_), str(s_), str(d_))
    build_s = time.perf_counter() - t0
    cpu = GraphDriver(config, device="cpu")
    cpu.unpack(card.pack())
    q = ([], [])
    for g in (card, cpu):
        g.add_centrality_query(q)
    _, index_ms = timed(card.update_index)
    split = split_ms(card.last_pagerank)
    cpu.update_index()
    got = card._pagerank_cache[cpu_key(q)]
    want = cpu._pagerank_cache[cpu_key(q)]
    check(got.keys() == want.keys() and len(got) == GRAPH_NODES,
          "graph: ranked node sets differ")
    g = np.asarray([got[n] for n in want], np.float64)
    w = np.asarray([want[n] for n in want], np.float64)
    check(np.isfinite(g).all(), "graph: ranks not finite")
    rel = float((np.abs(g - w) / np.abs(w)).max())
    check(rel <= PAGERANK_RTOL, f"graph: ranks off the CPU driver's by {rel} "
                                f"(relative, > {PAGERANK_RTOL})")
    nodes = [str(int(i)) for i in rng.integers(GRAPH_NODES,
                                               size=GRAPH_QUERIES)]
    lat = []
    for n in nodes:
        r, ms = timed(card.get_centrality, n, 0, q)
        lat.append(ms)
        check(r == got[n], "get_centrality differs from the index")
    # one more refresh under the profiler: the device's busy time against
    # the unprofiled refresh (filter, upload, loop, readback)
    prof = profile_calls(torch, [lambda: card._pagerank(cpu_key(q))],
                         sum(split.values()), [])
    prof = dict(busy_ms=prof["device_busy_ms_per_query"],
                idle_share=prof["device_idle_share"],
                device_items=prof["device_items_per_query"],
                top_device_us=prof["top_device_us"][:3])
    return dict(config="config/graph/default.json", nodes=GRAPH_NODES,
                edges=GRAPH_EDGES, build_s=build_s, update_index_ms=index_ms,
                split=split, pagerank=prof, get_centrality=pcts(lat),
                parity=dict(rtol=PAGERANK_RTOL, max_rel_err=rel))


def cpu_key(q):
    """A preset query's key in the drivers' caches."""
    from jubatus_tpu_torch.models.graph import _canon_query

    return _canon_query(q)


def rpc_session(engine: str, rng, Datum) -> list:
    """(method, args) calls of ``engine``'s IDL groups, updates first."""
    if engine == "clustering":
        rows = [server_datum(rng, Datum, i) for i in range(4 * CLUSTER_PUSH)]
        calls = [("push", ([[f"c{i}", rows[i]] for i in
                            range(lo, lo + CLUSTER_PUSH)],))
                 for lo in range(0, len(rows), CLUSTER_PUSH)]
        calls += [("get_revision", ()), ("get_k_center", ())] * 5
        calls += [("get_nearest_center", (server_datum(rng, Datum, i),))
                  for i in range(20)]
        calls += [("get_nearest_members_light", (server_datum(rng, Datum, i),))
                  for i in range(5)]
        return calls + [("get_core_members_light", ())] * 2
    if engine == "graph":
        n, q, qf = 500, [[], []], [[], [["kind", "a"]]]
        calls = [("create_node", ())] * n
        calls += [("update_node", (str(i), {"kind": "ab"[i % 2]}))
                  for i in range(n)]
        ends = rng.integers(n, size=(4000, 2))
        calls += [("create_edge", (str(s_), [{}, str(s_), str(d_)]))
                  for s_, d_ in ends.tolist()]
        calls += [("add_centrality_query", (q,)),
                  ("add_centrality_query", (qf,)),
                  ("add_shortest_path_query", (q,)), ("update_index", ())]
        calls += [("get_centrality", (str(int(i)), 0, q))
                  for i in rng.integers(n, size=50)]
        calls += [("get_centrality", (str(2 * int(i)), 0, qf))
                  for i in rng.integers(n // 2, size=20)]
        calls += [("get_shortest_path", ([str(int(a)), str(int(b)), 4, q],))
                  for a, b in rng.integers(n, size=(20, 2))]
        calls += [("get_node", (str(i),)) for i in range(10)]
        calls += [("get_edge", ("0", i)) for i in range(10)]
        return calls + [("remove_edge", ("0", 3)), ("remove_node", ("7",)),
                        ("update_index", ()), ("get_centrality", ("0", 0, q))]
    if engine == "stat":
        calls = [("push", (f"k{i % 10}", float(np.round(rng.normal(), 3))))
                 for i in range(2000)]
        for i in range(10):
            calls += [(m, (f"k{i}",)) for m in ("sum", "stddev", "max", "min")]
            calls += [("moment", (f"k{i}", 3, 0.25)), ("entropy", (f"k{i}",))]
        return calls
    if engine == "bandit":
        arms = [f"arm{i}" for i in range(5)]
        calls = [("register_arm", (a,)) for a in arms]
        for i in range(200):
            calls += [("select_arm", (f"p{i % 4}",)),
                      ("register_reward", (f"p{i % 4}", arms[i % 5],
                                           float(rng.random() < 0.2 +
                                                 0.1 * (i % 5))))]
        return calls + [("get_arm_info", (f"p{i}",)) for i in range(4)]
    if engine == "burst":
        calls = [("add_keyword", ([kw, 2.0, 1.0],))
                 for kw in ("storm", "fire", "calm")]
        for b in range(20):
            calls.append(("add_documents", ([
                [b * 10.0 + i * 0.1, "storm warning" if 8 <= b < 11 and
                 i % 2 else f"{('fire', 'calm', 'day')[i % 3]} {i}"]
                for i in range(100)],)))
        calls += [("get_result", (kw,)) for kw in ("storm", "fire")] * 5
        calls += [("get_result_at", ("storm", float(p_)))
                  for p_ in range(20, 200, 20)]
        return calls + [("get_all_bursted_results", ()),
                        ("get_all_bursted_results_at", (105.0,)),
                        ("get_all_keywords", ())]
    words = [f"w{i}" for i in range(50)]
    calls = [("update", (Datum({"text": " ".join(
        rng.choice(words, 6)), "n": float(i % 9)}),)) for i in range(200)]
    return calls + [("calc_weight", (Datum({"text": " ".join(
        rng.choice(words, 4))}),)) for _ in range(50)]


def same_answer(got, want, rtol: float) -> bool:
    """Equal, floats within ``rtol`` (relative, with 1e-6 absolute) where
    ``rtol`` > 0."""
    if isinstance(want, float) and rtol:
        return abs(got - want) <= rtol * abs(want) + 1e-6
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(
            same_answer(g, w, rtol) for g, w in zip(got, want))
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            same_answer(got[k], want[k], rtol) for k in want)
    return got == want


def phase_new_servers(Datum, EngineServer, seed: int) -> dict:
    """``python -m jubatus_tpu_torch.server <engine> -f
    config/<engine>/default.json --device cuda`` for the six engines of
    this path, all started at once; each driven with ``rpc_session`` beside
    a CPU twin (the port's EngineServer in this process, device "cpu")
    that takes the same calls: every answer equal (clustering and graph
    within CLUSTER_TOL / PAGERANK_RTOL relative); p50/p99 per method."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    started = {e: start_server(e, os.path.join(ROOT, "config", e,
                                               "default.json"))
               for e in NEW_ENGINES}
    out = {}
    try:
        for engine in NEW_ENGINES:
            rng = np.random.default_rng(seed + 81)
            calls = rpc_session(engine, rng, Datum)
            twin = EngineServer(engine, load_config(engine, "default.json"),
                                device="cpu")
            tport = twin.start(0)
            rtol = {"clustering": CLUSTER_TOL, "graph": PAGERANK_RTOL}.get(
                engine, 0.0)
            lat: dict = {}
            try:
                with serving(engine, "", started.pop(engine)) as cli, \
                        RpcClient("127.0.0.1", tport, timeout=120.0) as ref:
                    st0 = server_status(cli)
                    t0 = time.perf_counter()
                    for method, args in calls:
                        got, ms = timed(cli.call, method, "smoke", *args)
                        lat.setdefault(method, []).append(ms)
                        want = ref.call(method, "smoke", *args)
                        check(same_answer(got, want, rtol),
                              f"{engine} server {method}: {str(got)[:200]} "
                              f"!= the CPU twin's {str(want)[:200]}")
                    session_s = time.perf_counter() - t0
                    st = server_status(cli)
            finally:
                twin.stop()
            out[engine] = dict(
                config=f"config/{engine}/default.json", calls=len(calls),
                session_s=session_s, rtol=rtol,
                update_count=st["update_count"] - st0["update_count"],
                methods={m: pcts(v) for m, v in lat.items()},
                launches=server_launches(st))
    finally:
        for proc, _, _ in started.values():
            stop_server(proc)
    return out


# ---------------------------------------------------------------------------
# phase 11: save/load through the servers, and the RPC linear mix round
# ---------------------------------------------------------------------------
#: the servers saved and reloaded: each engine on a shipped config, with the
#: tolerance its CPU test (tests/test_torch_save_load.py) states for a
#: loaded server's answers against the saver's (relative, 1e-6 absolute;
#: 0 = equal). Stat's windows are saved oldest-first: a loaded window sums
#: in another order than the saver's ring
SL_SERVERS = (
    ("nearest_neighbor", "lsh.json", 0.0),
    ("recommender", "default.json", 1e-5),
    ("anomaly", "lof.json", 1e-4),
    ("classifier", "arow.json", 1e-5),
    ("classifier", "nn.json", 1e-5),
    ("regression", "default.json", 1e-5),
    ("clustering", "default.json", 1e-5),
    ("graph", "default.json", 1e-5),
    ("stat", "default.json", 1e-12),
    ("bandit", "default.json", 0.0),
    ("burst", "default.json", 0.0),
    ("weight", "default.json", 0.0),
)
SL_ROWS = 2_000               # rows written to each row / linear server
SL_LOF_ROWS = 200             # anomaly adds (each rebuilds the support)
SL_QUERIES = 20
#: methods that change a model; every other call of a session is a query
UPDATES = frozenset((
    "set_row", "update_row", "clear_row", "add", "update", "overwrite",
    "train", "push", "create_node", "remove_node", "update_node",
    "create_edge", "update_edge", "remove_edge", "add_centrality_query",
    "add_shortest_path_query", "remove_centrality_query",
    "remove_shortest_path_query", "update_index", "create_node_here",
    "remove_global_node", "create_edge_here", "register_arm", "delete_arm",
    "select_arm", "register_reward", "reset", "add_documents",
    "add_keyword", "remove_keyword", "remove_all_keywords", "clear"))
#: the fleets of two servers: (engine, config), FLEET_ROWS rows split
#: between the two members
FLEET_CONFIGS = (("classifier", "arow.json"),
                 ("regression", "default.json"),
                 ("nearest_neighbor", "lsh.json"))
FLEET_ROWS = 4_000


def sl_session(engine: str, config_name: str, rng, Datum):
    """(updates, queries) of one saved server: (method, args) lists."""
    if engine in NEW_ENGINES:
        calls = rpc_session(engine, rng, Datum)
    elif engine in ("nearest_neighbor", "recommender"):
        write = "set_row" if engine == "nearest_neighbor" else "update_row"
        near = ("neighbor_row_from_datum" if engine == "nearest_neighbor"
                else "similar_row_from_datum")
        calls = [(write, (f"r{i}", server_datum(rng, Datum, i)))
                 for i in range(SL_ROWS)]
        calls += [(near, (server_datum(rng, Datum, SL_ROWS + i), 10))
                  for i in range(SL_QUERIES)]
        calls += [("similar_row_from_id", (f"r{i}", 10)) for i in range(5)]
    elif engine == "anomaly":
        calls = [("add", (server_datum(rng, Datum, i),))
                 for i in range(SL_LOF_ROWS)]
        calls += [("calc_score", (server_datum(rng, Datum, SL_ROWS + i),))
                  for i in range(SL_QUERIES)]
    else:
        n = SL_ROWS // 4 if config_name == "nn.json" else SL_ROWS
        rows = [linear_example(rng, Datum, engine, i) for i in range(n)]
        calls = [("train", (rows[lo:lo + LINEAR_BATCH],))
                 for lo in range(0, n, LINEAR_BATCH)]
        query = "classify" if engine == "classifier" else "estimate"
        calls += [(query, ([server_datum(rng, Datum, n + i)],))
                  for i in range(SL_QUERIES)]
        if engine == "classifier":
            calls.append(("get_labels", ()))
    return ([c for c in calls if c[0] in UPDATES],
            [c for c in calls if c[0] not in UPDATES])


def answer(cli, method: str, args):
    """("ok", result), or ("error", message) where the call fails (graph's
    session reads a node it removed)."""
    try:
        return "ok", cli.call(method, "smoke", *args)
    except Exception as e:  # broad-ok — the failure is the answer
        return "error", str(e)


def model_answer_same(got, want, rtol: float) -> bool:
    """Equal, floats within ``rtol`` (relative, 1e-6 absolute). A list of
    [id, score] pairs whose ids come in another order is compared by its
    scores, and by the ids whose score is clear of the last one (a loaded
    row store may break a tie at the boundary otherwise)."""
    def tol(w):
        return rtol * abs(w) + (1e-6 if rtol else 0.0)

    def scored(x):
        return isinstance(x, (list, tuple)) and len(x) == 2 and \
            isinstance(x[1], float) and isinstance(x[0], str)

    if isinstance(want, float):
        return isinstance(got, (int, float)) and abs(got - want) <= tol(want)
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            model_answer_same(got[k], want[k], rtol) for k in want)
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return False
        if want and all(map(scored, want)) and all(map(scored, got)) and \
                [g[0] for g in got] != [w[0] for w in want]:
            gs, ws = sorted(g[1] for g in got), sorted(w[1] for w in want)
            if not all(abs(g - w) <= tol(w) for g, w in zip(gs, ws)):
                return False
            edge = want[-1][1]
            return {g[0] for g in got if abs(g[1] - edge) > tol(edge)} == \
                {w[0] for w in want if abs(w[1] - edge) > tol(edge)}
        return all(model_answer_same(g, w, rtol) for g, w in zip(got, want))
    return got == want


def add_launches(total: dict, st: dict) -> None:
    for m, n in server_launches(st).items():
        total[m] += n


def phase_save_load_servers(Datum, seed: int) -> dict:
    """Each server of SL_SERVERS on the card with ``-d``, all started at
    once: its session's updates over RPC, then ``save``; the answers to
    its queries. Then a second server of each, all at once, started with
    ``-m`` on the saved file: every answer equal to the saver's (within
    the engine's tolerance)."""
    import shutil

    datadir = os.path.join(OUT_DIR, "models")
    shutil.rmtree(datadir, ignore_errors=True)
    os.makedirs(datadir)
    cfg = {f"{e}/{n}": os.path.join(ROOT, "config", e, n)
           for e, n, _ in SL_SERVERS}
    launches = {m: 0 for m in RECORDED}
    saved, out = {}, {}
    started = {key: start_server(key.split("/")[0], path,
                                 tag=f"_save_{key.replace('/', '_')}",
                                 extra=("-d", datadir))
               for key, path in cfg.items()}
    try:
        for engine, name, rtol in SL_SERVERS:
            key = f"{engine}/{name}"
            updates, queries = sl_session(engine, name,
                                          np.random.default_rng(seed + 111),
                                          Datum)
            with serving(engine, "", started.pop(key)) as cli:
                t0 = time.perf_counter()
                for method, args in updates:
                    cli.call(method, "smoke", *args)
                update_s = time.perf_counter() - t0
                reply, save_ms = timed(cli.call, "save", "smoke", "smoke")
                (path,) = reply.values()
                want = [answer(cli, m, a) for m, a in queries]
                st = server_status(cli)
            check(st["last_saved"] > 0, f"{key}: last_saved not set")
            add_launches(launches, st)
            saved[key] = dict(path=path, want=want, queries=queries,
                              rtol=rtol, updates=len(updates),
                              update_s=update_s, save_ms=save_ms)
    finally:
        for proc, _, _ in started.values():
            stop_server(proc)
    started = {key: start_server(key.split("/")[0], cfg[key],
                                 tag=f"_load_{key.replace('/', '_')}",
                                 extra=("-m", s["path"]))
               for key, s in saved.items()}
    try:
        for engine, name, rtol in SL_SERVERS:
            key, s = f"{engine}/{name}", saved[f"{engine}/{name}"]
            with serving(engine, "", started.pop(key)) as cli:
                st = server_status(cli)
                check(st["last_loaded"] > 0, f"{key}: -m loaded nothing")
                for (method, args), want in zip(s["queries"], s["want"]):
                    got = answer(cli, method, args)
                    check(model_answer_same(got, want, rtol),
                          f"{key} loaded with -m, {method}: {str(got)[:200]}"
                          f" != the saver's {str(want)[:200]}")
                st = server_status(cli)
            add_launches(launches, st)
            out[key] = dict(updates=s["updates"], update_s=s["update_s"],
                            queries=len(s["queries"]), rtol=rtol,
                            file_bytes=os.path.getsize(s["path"]),
                            save_ms=s["save_ms"])
    finally:
        for proc, _, _ in started.values():
            stop_server(proc)
    return dict(servers=out, server_launches=launches)


def phase_save_load_width(torch, ClassifierDriver, dim_bits: int,
                          seed: int) -> dict:
    """save_model / load_model of the AROW driver at phase 8's shape (two
    train_hashed steps of B = CLF_B), split into its steps: readback
    (``pack()``), pack (msgpack), CRC (the envelope), write, fsync; then
    read, CRC check, unpack, upload. The loaded tables equal the saved
    model's; then the two whole calls timed."""
    from jubatus_tpu_torch.framework import save_load as SL
    from jubatus_tpu_torch.utils.serialization import pack_obj, unpack_obj

    drv = ClassifierDriver(CLF_CONFIG, dim_bits=dim_bits, device="cuda")
    rng = np.random.default_rng(seed + 200 + dim_bits)
    names = np.array(["neg", "pos"])
    for _ in range(2):
        idx, val, lab = bench_batch(rng, dim_bits)
        drv.train_hashed(list(names[lab]), idx, val)
    torch.cuda.synchronize()
    config = json.dumps(CLF_CONFIG)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"arow_{dim_bits}.jubatus")
    split = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        split[name] = (time.perf_counter() - t0) * 1e3
        return res

    packed = step("readback_ms", drv.pack)
    system = {"version": SL.FORMAT_VERSION, "timestamp": int(time.time()),
              "type": drv.TYPE, "id": "smoke", "config": config}
    sys_b, user_b = step("pack_ms", lambda: (
        pack_obj(system), pack_obj([drv.USER_DATA_VERSION, packed])))
    blob = step("crc_ms", SL.pack_envelope, sys_b, user_b)
    del packed, sys_b, user_b
    f = open(path + ".tmp", "wb")
    step("write_ms", lambda: (f.write(blob), f.flush()))
    step("fsync_ms", os.fsync, f.fileno())
    f.close()
    os.replace(path + ".tmp", path)
    file_bytes = os.path.getsize(path)
    check(file_bytes == len(blob), "file size != envelope size")
    del blob
    fresh = ClassifierDriver(CLF_CONFIG, dim_bits=dim_bits, device="cuda")
    raw = step("read_ms", lambda: open(path, "rb").read())
    sys_b, user_b = step("crc_check_ms", SL.read_envelope, raw, path)
    del raw
    _, user = step("unpack_ms", unpack_obj, user_b)
    del user_b
    step("upload_ms", lambda: (fresh.unpack(user), torch.cuda.synchronize()))
    del user
    want_w = drv.state.w + drv.state.dw
    want_prec = drv.state.prec + drv.state.dprec
    check(torch.equal(fresh.state.w, want_w)
          and torch.equal(fresh.state.prec, want_prec),
          f"D=2^{dim_bits}: the loaded tables differ from the saved model")
    del fresh
    _, save_ms = timed(lambda: SL.save_model(path, drv, model_id="smoke",
                                             config=config))
    again = ClassifierDriver(CLF_CONFIG, dim_bits=dim_bits, device="cuda")
    _, load_ms = timed(lambda: (SL.load_model(path, again,
                                              expected_config=config),
                                torch.cuda.synchronize()))
    check(torch.equal(again.state.w, want_w), "load_model's tables differ")
    os.remove(path)
    return dict(dim_bits=dim_bits, capacity=drv.capacity,
                file_bytes=file_bytes, split=split,
                save=sum(split[k] for k in ("readback_ms", "pack_ms",
                                            "crc_ms", "write_ms",
                                            "fsync_ms")),
                load=sum(split[k] for k in ("read_ms", "crc_check_ms",
                                            "unpack_ms", "upload_ms")),
                save_model_ms=save_ms, load_model_ms=load_ms)


def local_mixers(drivers):
    """An RpcLinearMixer per driver (each with its own registry) whose
    fan-outs call the members' mix_* handlers in this process, payloads
    packed as on the wire; a round is ``mixers[0].mix_now()``."""
    from jubatus_tpu_torch.coord.base import NodeInfo
    from jubatus_tpu_torch.framework.linear_mixer import (
        LinearCommunication, RpcLinearMixer)
    from jubatus_tpu_torch.utils.tracing import Registry

    group = {}

    class LocalComm(LinearCommunication):
        def update_members(self):
            return [NodeInfo.from_name(n) for n in group]

        def try_lock(self):
            return True

        def unlock(self):
            pass

        def get_schemas(self):
            return [m.local_get_schema() for m in group.values()]

        def sync_schema(self, union):
            for m in group.values():
                m.local_sync_schema(union)

        def get_diff(self):
            return [(NodeInfo.from_name(n), m.local_get_diff())
                    for n, m in group.items()]

        def put_diff(self, packed):
            return {n: m.local_put_diff(packed) for n, m in group.items()}

    comm = LocalComm()
    mixers = []
    for i, d in enumerate(drivers):
        node = NodeInfo("local", i)
        m = RpcLinearMixer(d, comm, self_node=node)
        m.set_trace_registry(Registry())
        group[node.name] = m
        mixers.append(m)
    return mixers


def member_split(registry) -> dict:
    """A member's side of its last round: the lock-held snapshot (device
    readback included), the diff's pack, the total's unpack and the
    lock-held apply."""
    g, h = registry.gauges(), registry.snapshot()["hists"]
    return dict(snapshot_stall_ms=g.get("mix.snapshot_stall_ms"),
                pack_ms=h["mix.diff.pack"]["last_s"] * 1e3,
                total_unpack_ms=h["mix.total.unpack"]["last_s"] * 1e3,
                apply_stall_ms=g.get("mix.apply_stall_ms"))


def phase_mix_width(torch, ClassifierDriver, dim_bits: int, seed: int) -> dict:
    """One mix round of two AROW drivers on the card at phase 8's shape
    (one train_hashed step of B = CLF_B each), through the mixer's own
    wire path in this process: the round's phases, each member's split,
    the payload bytes. Both replicas must hold the same tables, equal to
    the fold of their diffs on the CPU: w = (dw0 + dw1) / 2, prec = 1 +
    dprec0 + dprec1."""
    drivers = [ClassifierDriver(CLF_CONFIG, dim_bits=dim_bits, device="cuda")
               for _ in range(2)]
    rng = np.random.default_rng(seed + 300 + dim_bits)
    names = np.array(["neg", "pos"])
    for d in drivers:
        idx, val, lab = bench_batch(rng, dim_bits)
        d.train_hashed(list(names[lab]), idx, val)
    # the round's schema phase aligns the label slots to the sorted union
    # first; align them here so the fold below reads the same rows
    for d in drivers:
        d.sync_schema(["neg", "pos"])
    torch.cuda.synchronize()
    n = len(drivers[0].label_slots)
    dw = [d.state.dw[:n].cpu() for d in drivers]
    dprec = [d.state.dprec[:n].cpu() for d in drivers]
    want_w = torch.from_numpy(dw[0].numpy() + dw[1].numpy()) / 2.0
    want_prec = 1.0 + torch.from_numpy(dprec[0].numpy() + dprec[1].numpy())
    del dw, dprec
    mixers = local_mixers(drivers)
    t0 = time.perf_counter()
    result = mixers[0].mix_now()
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    check(result is not None and result["acked"] == 2, "the round failed")
    for d in drivers:
        check(torch.equal(d.state.w[:n].cpu(), want_w)
              and torch.equal(d.state.prec[:n].cpu(), want_prec),
              f"D=2^{dim_bits}: a replica differs from the CPU fold")
    master = mixers[0].trace.snapshot()["hists"]
    return dict(dim_bits=dim_bits, round_ms=round_ms,
                phases=result["phases"], bytes_put=result["bytes"],
                diff_unpack_ms=master["mix.diff.unpack"]["last_s"] * 1e3,
                members=[member_split(m.trace) for m in mixers])


def fleet_rows(rng, Datum, engine: str):
    if engine == "nearest_neighbor":
        return [("set_row", (f"r{i}", server_datum(rng, Datum, i)))
                for i in range(FLEET_ROWS)]
    rows = [linear_example(rng, Datum, engine, i) for i in range(FLEET_ROWS)]
    return [("train", (rows[lo:lo + LINEAR_BATCH],))
            for lo in range(0, FLEET_ROWS, LINEAR_BATCH)]


def fleet_queries(rng, Datum, engine: str):
    qs = [server_datum(rng, Datum, FLEET_ROWS + i) for i in range(SL_QUERIES)]
    if engine == "nearest_neighbor":
        return [("neighbor_row_from_datum", (q, 10)) for q in qs]
    return [("classify" if engine == "classifier" else "estimate", ([q],))
            for q in qs]


def unpadded(pack: dict) -> dict:
    """A classifier pack with its label list cut to the live labels (a
    replica whose slots needed no realignment keeps its list unpadded)."""
    if "labels" in pack:
        pack = dict(pack, labels=[x for x in pack["labels"] if x])
    return pack


def saved_model(path: str):
    """The user data of a model file (the driver's pack)."""
    from jubatus_tpu_torch.framework.save_load import read_envelope
    from jubatus_tpu_torch.utils.serialization import unpack_obj

    with open(path, "rb") as f:
        _, user = read_envelope(f.read(), path)
    return unpadded(unpack_obj(user)[1])


def model_close(got, want, tol: float, what: str) -> float:
    """Every table of a pack within tol * max|want| + 1e-4 |want| of the
    other's (equal where tol is 0); other leaves equal. Returns the
    largest error over its limit."""
    if isinstance(want, np.ndarray) and want.dtype.kind == "f":
        g, w = np.asarray(got, np.float64), want.astype(np.float64)
        check(g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}")
        if not tol:
            check(np.array_equal(g, w), f"{what}: differs")
            return 0.0
        limit = tol * float(np.abs(w).max(initial=0.0)) + 1e-4 * np.abs(w) \
            + 1e-30
        err = float((np.abs(g - w) / limit).max(initial=0.0))
        check(err <= 1.0, f"{what}: off by {err} of its limit")
        return err
    if isinstance(want, dict):
        check(got.keys() == want.keys(), f"{what}: keys differ")
        return max([model_close(got[k], want[k], tol, f"{what}.{k}")
                    for k in want] + [0.0])
    if isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{what}: length differs")
        return max([model_close(g, w, tol, f"{what}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))] + [0.0])
    if isinstance(want, float) and tol:
        check(abs(got - want) <= tol * abs(want) + 1e-6, f"{what}: differs")
        return 0.0
    check(got == want, f"{what}: {str(got)[:80]} != {str(want)[:80]}")
    return 0.0


def cpu_fleet(EngineServer, engine: str, name: str, halves) -> dict:
    """Two port servers on the CPU in this process (one MemoryCoordinator)
    fed the same halves and mixed: the reference pack."""
    from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.server.args import ServerArgs

    store = _Store()
    servers = []
    try:
        for _ in range(2):
            srv = EngineServer(engine, load_config(engine, name), ServerArgs(
                engine=engine, coordinator="(memory)", name="fleet",
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30), device="cpu",
                coord=MemoryCoordinator(store))
            srv.start(0)
            servers.append(srv)
        for srv, calls in zip(servers, halves):
            with RpcClient("127.0.0.1", srv.rpc.port, timeout=120.0) as c:
                for method, args in calls:
                    c.call(method, "smoke", *args)
        check(servers[0].do_mix() is True, "the CPU fleet did not mix")
        return unpadded(servers[0].driver.pack())
    finally:
        for srv in servers:
            srv.stop()


def phase_fleets(Datum, EngineServer, seed: int) -> dict:
    """Two port servers on the card per FLEET_CONFIGS entry, each its own
    process, sharing ``-z file://<dir>`` with ``--mixer linear_mixer``
    (all six started at once): each trains half the rows, then ``do_mix``
    on the first. Both replicas' saved models must be equal to each other
    and to the same halves mixed by two CPU port servers (LINEAR_TOL for
    the linear tables, rows equal for nearest_neighbor); the round's
    split comes from the master's flight recorder and each member's
    gauges and spans; queries after the round on both replicas agree."""
    import shutil

    from jubatus_tpu_torch.coord import membership
    from jubatus_tpu_torch.coord.file import FileCoordinator

    launches = {m: 0 for m in RECORDED}
    out, started = {}, {}
    for engine, name in FLEET_CONFIGS:
        d = os.path.join(OUT_DIR, f"fleet_{engine}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        extra = ("-z", f"file://{d}", "-n", "fleet", "-x", "linear_mixer",
                 "-s", "1e9", "-i", str(1 << 30), "-d", d)
        started[engine] = (d, [start_server(
            engine, os.path.join(ROOT, "config", engine, name),
            tag=f"_fleet{i}", extra=extra) for i in range(2)])
    try:
        for engine, name in FLEET_CONFIGS:
            d, procs = started.pop(engine)
            rng = np.random.default_rng(seed + 131)
            calls = fleet_rows(rng, Datum, engine)
            halves = [calls[0::2], calls[1::2]]
            queries = fleet_queries(rng, Datum, engine)
            with contextlib.ExitStack() as stack:
                clis = [stack.enter_context(serving(engine, "", p))
                        for p in procs]
                view = FileCoordinator(d)
                deadline = time.time() + 60
                while len(membership.get_all_actives(
                        view, engine, "fleet")) < 2:
                    check(time.time() < deadline, "fleet never formed")
                    time.sleep(0.2)
                view.close()
                t0 = time.perf_counter()
                for cli, half in zip(clis, halves):
                    for method, args in half:
                        cli.call(method, "smoke", *args)
                train_s = time.perf_counter() - t0
                ok, round_ms = timed(clis[0].call, "do_mix", "smoke")
                check(ok is True, f"{engine} fleet: do_mix returned {ok}")
                rec = clis[0].call("get_mix_history", "smoke")[-1]
                check(rec["ok"] and rec["members"] == 2
                      and rec["acked"] == 2, f"{engine} round: {rec}")
                answers = [[answer(c, m, a) for m, a in queries]
                           for c in clis]
                for a, b, (m, _) in zip(*answers, queries):
                    check(model_answer_same(a, b, 1e-6),
                          f"{engine} replicas answer {m} differently")
                sts = [server_status(c) for c in clis]
                paths = [next(iter(c.call("save", "smoke", "mixed")
                                   .values())) for c in clis]
            for st in sts:
                add_launches(launches, st)
                check(st["mixer.model_version"] == 1,
                      f"{engine}: a member at model version "
                      f"{st['mixer.model_version']}")
            models = [saved_model(p) for p in paths]
            model_close(models[1], models[0], 0.0, f"{engine} replicas")
            tol = 0.0 if engine == "nearest_neighbor" else LINEAR_TOL
            err = model_close(models[0], cpu_fleet(EngineServer, engine,
                                                   name, halves),
                              tol, f"{engine} card vs CPU fleet")
            phases = rec["phases"]
            members = [dict(snapshot_stall_ms=st.get("mix.snapshot_stall_ms"),
                            pack_ms=st.get("trace.mix.diff.pack.last_ms"),
                            apply_stall_ms=st.get("mix.apply_stall_ms"),
                            total_unpack_ms=st.get(
                                "trace.mix.total.unpack.last_ms"))
                       for st in sts]
            member_ms = max(m["snapshot_stall_ms"] + m["pack_ms"]
                            for m in members)
            out[engine] = dict(
                config=f"config/{engine}/{name}", rows=FLEET_ROWS,
                train_s=train_s, do_mix_ms=round_ms, phases=phases,
                diff_unpack_ms=sts[0].get("trace.mix.diff.unpack.last_ms"),
                rpc_ms=phases["get_diff_ms"] - member_ms
                - sts[0].get("trace.mix.diff.unpack.last_ms", 0.0),
                bytes_put=rec["bytes"], members=members,
                cpu_fleet=dict(tol=tol, err_over_limit=err),
                launches=[server_launches(st) for st in sts])
    finally:
        for _, procs in started.values():
            for proc, _, _ in procs:
                stop_server(proc)
    return dict(fleets=out, server_launches=launches)


# ---------------------------------------------------------------------------
# phase 12: push and async mix, elastic migration, the model store, the
# snapshot ring and rollback
# ---------------------------------------------------------------------------
PUSH_STRATEGIES = ("broadcast_mixer", "random_mixer", "skip_mixer")
#: push strategies whose exchanges are a function of the member ring (the
#: CPU fleet repeats them); random_mixer draws its peer
PUSH_REPEATABLE = ("broadcast_mixer", "skip_mixer")
PUSH_ROWS = 3_000             # arow.json rows, a third per member
ASYNC_ROWS = 2_000            # arow.json rows, half per member
ASYNC_STREAM_STEPS = 4        # train + do_mix on each member, in turns
ELASTIC_ROWS = 125_000        # cut from phase 3's 10^6 (2.5·10^5 until
                              # PR 12) to keep the run inside its limit
ELASTIC_FILL = 20_000         # rows per put_rows call of the fill
ELASTIC_QUERIES = 5
STORE_ROWS = 2_000            # regression rows before the warm boot
QUARANTINE_ROWS = 1_000
P12_WAIT_S = 300              # longest wait for a fleet, a pull or a drain


def fleet_dir(name: str) -> str:
    import shutil

    d = os.path.join(OUT_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def wait_for(pred, what: str, timeout: float = P12_WAIT_S) -> None:
    deadline = time.time() + timeout
    while not pred():
        check(time.time() < deadline, f"{what} within {timeout} s")
        time.sleep(0.1)


def wait_fleet(d: str, engine: str, name: str, n: int) -> None:
    from jubatus_tpu_torch.coord import membership
    from jubatus_tpu_torch.coord.file import FileCoordinator

    view = FileCoordinator(d)
    try:
        wait_for(lambda: len(membership.get_all_actives(view, engine, name))
                 >= n, f"{n} {engine} members never joined")
    finally:
        view.close()


def node_of(cli) -> str:
    return next(iter(cli.call("get_status", "smoke")))


def saved_pack(cli, tag: str):
    (path,) = [p for k, p in cli.call("save", "smoke", tag).items()
               if not k.startswith("store:")]
    return saved_model(path)


def p12_args(d: str, name: str, *extra) -> tuple:
    return ("-z", f"file://{d}", "-n", name, "-s", "1e9",
            "-i", str(1 << 30), "-d", d, *extra)


def cpu_members(EngineServer, engine: str, config_name: str, n: int,
                **args) -> list:
    """``n`` port servers on the CPU in this process on one
    MemoryCoordinator: the reference fleet."""
    from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
    from jubatus_tpu_torch.server.args import ServerArgs

    store = _Store()
    out = []
    for _ in range(n):
        srv = EngineServer(engine, load_config(engine, config_name),
                           ServerArgs(engine=engine, coordinator="(memory)",
                                      name="smoke", listen_addr="127.0.0.1",
                                      interval_sec=1e9,
                                      interval_count=1 << 30, **args),
                           device="cpu", coord=MemoryCoordinator(store))
        srv.start(0)
        out.append(srv)
    return out


def feed(cli, calls) -> float:
    t0 = time.perf_counter()
    for method, args in calls:
        cli.call(method, "smoke", *args)
    return time.perf_counter() - t0


def phase_push(Datum, EngineServer, seed: int) -> dict:
    """Three arow.json servers per push strategy, each its own process on
    ``-z file://<dir> -x <strategy>`` (all nine started at once), trained
    on disjoint thirds; one ``do_mix`` on the first. Each exchange's
    get/put times come from the initiator's spans, the stalls from every
    member's gauges. For broadcast_mixer and skip_mixer three CPU port
    servers repeat the round (same member ranks, same thirds, same
    initiator): every card member's model must be the CPU member's of its
    rank within LINEAR_TOL."""
    rng = np.random.default_rng(seed + 1201)
    rows = [linear_example(rng, Datum, "classifier", i)
            for i in range(PUSH_ROWS)]
    calls = [("train", (rows[lo:lo + LINEAR_BATCH],))
             for lo in range(0, PUSH_ROWS, LINEAR_BATCH)]
    thirds = [calls[i::3] for i in range(3)]
    config = os.path.join(ROOT, "config", "classifier", "arow.json")
    started = {}
    for strategy in PUSH_STRATEGIES:
        d = fleet_dir(f"push_{strategy}")
        started[strategy] = (d, [start_server(
            "classifier", config, tag=f"_push_{strategy}{i}",
            extra=p12_args(d, "push", "-x", strategy)) for i in range(3)])
    out = {}
    try:
        for strategy in PUSH_STRATEGIES:
            d, procs = started.pop(strategy)
            with contextlib.ExitStack() as stack:
                clis = [stack.enter_context(serving("classifier", "", p))
                        for p in procs]
                wait_fleet(d, "classifier", "push", 3)
                names = [node_of(c) for c in clis]
                train_s = sum(feed(c, t) for c, t in zip(clis, thirds))
                ok, mix_ms = timed(clis[0].call, "do_mix", "smoke")
                check(ok is True, f"{strategy}: do_mix returned {ok}")
                rec = clis[0].call("get_mix_history", "smoke")[-1]
                check(rec["ok"] and rec["members"] >= 1,
                      f"{strategy} round: {rec}")
                sts = [server_status(c) for c in clis]
                packs = [saved_pack(c, "push") for c in clis]
            st0 = sts[0]
            res = dict(rows=PUSH_ROWS, train_s=train_s, do_mix_ms=mix_ms,
                       exchanged=rec["members"],
                       candidates=rec.get("candidates"),
                       bytes=rec["bytes"], round_ms=rec.get("duration_ms"))
            for span in ("get_diff", "put_local", "put_peer"):
                res[f"{span}_ms"] = [st0.get(f"trace.mix.push.{span}.{q}")
                                     for q in ("mean_ms", "max_ms")]
                res[f"{span}_count"] = st0.get(
                    f"trace.mix.push.{span}.count", 0)
            res["members"] = [dict(
                snapshot_stall_ms=st.get("mix.snapshot_stall_ms"),
                apply_stall_ms=st.get("mix.apply_stall_ms"),
                model_version=st["mixer.model_version"]) for st in sts]
            if strategy in PUSH_REPEATABLE:
                res["cpu_err_over_limit"] = push_cpu_check(
                    EngineServer, strategy, names, thirds, packs)
            out[strategy] = res
    finally:
        for _, procs in started.values():
            for proc, _, _ in procs:
                stop_server(proc)
    return out


def push_cpu_check(EngineServer, strategy: str, names, thirds,
                   packs) -> float:
    """The same push round on three CPU port servers: the member of rank r
    (by node name) takes the third of the card's member of rank r, the
    initiator is the CPU member of the card initiator's rank."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    cpu = cpu_members(EngineServer, "classifier", "arow.json", 3,
                      mixer=strategy)
    try:
        by_rank = sorted(cpu, key=lambda s: s.self_nodeinfo().name)
        card_rank = {n: r for r, n in enumerate(sorted(names))}
        for i, third in enumerate(thirds):
            srv = by_rank[card_rank[names[i]]]
            with RpcClient("127.0.0.1", srv.rpc.port, timeout=120.0) as c:
                feed(c, third)
        check(by_rank[card_rank[names[0]]].do_mix() is True,
              f"the CPU {strategy} fleet did not mix")
        err = 0.0
        for i, pack in enumerate(packs):
            want = unpadded(by_rank[card_rank[names[i]]].driver.pack())
            err = max(err, model_close(pack, want, LINEAR_TOL,
                                       f"{strategy} member {i} vs CPU"))
        return err
    finally:
        for srv in cpu:
            srv.stop()


def async_steps(do_mix, get_diff, submit, a_name: str, b_name: str):
    """The async drive both fleets repeat: B's diff into A's inbox (the
    payload B's submit tick sends), then A's fold of both at staleness 0."""
    packed = get_diff("b")
    ack = submit("a", b_name, packed)
    check(ack.get("accepted") is True, f"submit refused: {ack}")
    return do_mix("a")


def phase_async(Datum, EngineServer, seed: int) -> dict:
    """Two arow.json servers with ``--mix-async`` (each its own process on
    ``-z file://<dir>``): A's first fold elects it master; both train a
    half; B's diff enters A's inbox and A folds both at staleness 0 — both
    replicas must equal two CPU port servers driven the same way (within
    LINEAR_TOL). Then ASYNC_STREAM_STEPS turns of train + ``do_mix`` on B
    and on A (submit ticks and folds as masterhood moves), and flush turns
    until the replicas hold one model; the submits, folds, staleness,
    stale drops and the snapshot and apply stalls are reported."""
    rng = np.random.default_rng(seed + 1202)
    rows = [linear_example(rng, Datum, "classifier", i)
            for i in range(ASYNC_ROWS)]
    calls = [("train", (rows[lo:lo + LINEAR_BATCH],))
             for lo in range(0, ASYNC_ROWS, LINEAR_BATCH)]
    halves = [calls[0::2], calls[1::2]]
    d = fleet_dir("async")
    config = os.path.join(ROOT, "config", "classifier", "arow.json")
    procs = [start_server("classifier", config, tag=f"_async{i}",
                          extra=p12_args(d, "async", "--mix-async"))
             for i in range(2)]
    with contextlib.ExitStack() as stack:
        clis = [stack.enter_context(serving("classifier", "", p))
                for p in procs]
        wait_fleet(d, "classifier", "async", 2)
        names = [node_of(c) for c in clis]
        check(clis[0].call("do_mix", "smoke") is True, "the priming fold")
        for c, half in zip(clis, halves):
            feed(c, half)
        ab = dict(zip("ab", clis))
        t0 = time.perf_counter()
        ok = async_steps(
            lambda who: ab[who].call("do_mix", "smoke"),
            lambda who: ab[who].call("mix_get_diff", "smoke"),
            lambda who, m, p: ab[who].call("mix_submit_diff", "smoke", m, p),
            names[0], names[1])
        fold_ms = (time.perf_counter() - t0) * 1e3
        check(ok is True, "the staleness-0 fold did not run")
        rec = clis[0].call("get_mix_history", "smoke")[-1]
        check(rec["contributors"] == 2 and set(rec["weights"].values())
              == {1.0}, f"the staleness-0 fold: {rec}")
        packs = [saved_pack(c, "async0") for c in clis]
        model_close(packs[1], packs[0], 0.0, "async replicas")
        err = async_cpu_check(EngineServer, halves, packs[0])
        stream_rng = np.random.default_rng(seed + 1203)
        for step in range(ASYNC_STREAM_STEPS):
            for k, c in ((1, clis[1]), (0, clis[0])):
                batch = [linear_example(stream_rng, Datum, "classifier", i)
                         for i in range(LINEAR_BATCH)]
                c.call("train", "smoke", batch)
                c.call("do_mix", "smoke")
        # flush: fold turns until no inbox holds a payload and both
        # replicas hold one model
        flush_turns = 0
        while True:
            depth = sum(server_status(c)["mixer.async_inbox_depth"]
                        for c in clis)
            packs = [saved_pack(c, f"async{flush_turns}") for c in clis]
            if not depth and model_close_ok(packs[1], packs[0]):
                break
            check(flush_turns < 8, "the async replicas never converged")
            clis[flush_turns % 2].call("do_mix", "smoke")
            flush_turns += 1
        sts = [server_status(c) for c in clis]
    return dict(
        rows=ASYNC_ROWS, staleness0_fold_ms=fold_ms,
        staleness0_round=dict(contributors=rec["contributors"],
                              weights=rec["weights"], bytes=rec["bytes"],
                              phases=rec.get("phases")),
        cpu_err_over_limit=err, stream_steps=ASYNC_STREAM_STEPS,
        flush_turns=flush_turns,
        members=[dict(
            submits_received=st["mixer.async_inbox_submits"],
            folds=st["mixer.async_rounds"],
            submit_errors=st["mixer.async_submit_errors"],
            lag_rounds=st["mixer.async_lag_rounds"],
            staleness_max=st.get("mix.staleness_max"),
            dropped_stale=st.get("trace.counter.mix.async_dropped_stale", 0),
            captures=st.get("trace.counter.mix.async_captures", 0),
            snapshot_stall_ms=st.get("mix.snapshot_stall_ms"),
            snapshot_stall_max_ms=st.get("trace.mix.stall.snapshot.max_ms"),
            apply_stall_ms=st.get("mix.apply_stall_ms"),
            apply_stall_max_ms=st.get("trace.mix.stall.apply.max_ms"),
            model_version=st["mixer.model_version"]) for st in sts])


def model_close_ok(got, want) -> bool:
    try:
        model_close(got, want, 0.0, "")
        return True
    except SmokeError:
        return False


def async_cpu_check(EngineServer, halves, card_pack) -> float:
    """Two CPU port servers with the async plane, driven through the same
    steps in process: the card's staleness-0 fold must equal theirs."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    cpu = cpu_members(EngineServer, "classifier", "arow.json", 2,
                      mix_async=True)
    try:
        check(cpu[0].do_mix() is True, "the CPU priming fold")
        for srv, half in zip(cpu, halves):
            with RpcClient("127.0.0.1", srv.rpc.port, timeout=120.0) as c:
                feed(c, half)
        ab = dict(zip("ab", cpu))
        check(async_steps(
            lambda who: ab[who].do_mix(),
            lambda who: ab[who].mixer.local_get_diff(),
            lambda who, m, p: ab[who].mixer.local_submit_diff(m, p),
            cpu[0].self_nodeinfo().name,
            cpu[1].self_nodeinfo().name) is True, "the CPU fold")
        return model_close(card_pack, unpadded(cpu[0].driver.pack()),
                           LINEAR_TOL, "async card vs CPU fold")
    finally:
        for srv in cpu:
            srv.stop()


def elastic_fill_calls(seed: int):
    """ELASTIC_ROWS rows of phase 3's shape (32 hashed features over
    2^18) as put_rows chunks of ELASTIC_FILL rows."""
    rng = np.random.default_rng(seed + 1204)
    for lo in range(0, ELASTIC_ROWS, ELASTIC_FILL):
        n = min(ELASTIC_FILL, ELASTIC_ROWS - lo)
        idx, val = random_rows(rng, n, 32, 18)
        yield [[f"r{lo + i}", ii, vv, None]
               for i, (ii, vv) in enumerate(zip(idx.tolist(), val.tolist()))]


def phase_elastic(seed: int) -> dict:
    """An lsh.json nearest_neighbor server (its own process, ``-z
    file://<dir>``) takes ELASTIC_ROWS rows through ``put_rows``; a second
    server joins (``--no-auto-rebalance``) and pulls the rows it owns with
    ``rebalance`` (two members: every row); its first query signs every
    pulled row and scans with K1. Then the first server drains and hands
    its rows off. The new owner's neighbor_row_from_id answers must equal
    the source's, after the pull and after the handoff."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    d = fleet_dir("elastic")
    config = os.path.join(ROOT, "config", "nearest_neighbor", "lsh.json")
    extra = p12_args(d, "elastic", "--drain-grace", "0.2",
                     "--no-auto-rebalance")
    src_proc = start_server("nearest_neighbor", config, tag="_elastic_src",
                            extra=extra)
    dst_proc = None
    launches = {m: 0 for m in RECORDED}
    try:
        with serving("nearest_neighbor", "", src_proc) as src:
            wait_fleet(d, "nearest_neighbor", "elastic", 1)
            t0 = time.perf_counter()
            for rows in elastic_fill_calls(seed):
                check(src.call("put_rows", "smoke", rows) == len(rows),
                      "put_rows applied a short count")
            fill_s = time.perf_counter() - t0
            check(src.call("get_row_count", "smoke") == ELASTIC_ROWS,
                  "the source holds a short row count")
            probe = [f"r{(i * 7919) % ELASTIC_ROWS}"
                     for i in range(ELASTIC_QUERIES)]
            want, src_first_ms = timed(
                lambda: [src.call("neighbor_row_from_id", "smoke", r, 10)
                         for r in probe])
            dst_proc = start_server("nearest_neighbor", config,
                                    tag="_elastic_dst", extra=extra)
            with serving("nearest_neighbor", "", dst_proc) as dst:
                wait_fleet(d, "nearest_neighbor", "elastic", 2)
                epoch = dst.call("get_epoch", "smoke")
                wait_for(lambda: src.call("get_epoch", "smoke") == epoch,
                         "the source never saw the join")
                with RpcClient("127.0.0.1", dst_proc[1],
                               timeout=P12_WAIT_S) as slow:
                    pull = slow.call("rebalance", "smoke")
                check(pull["rows"] == ELASTIC_ROWS
                      and not pull["sources_failed"], f"pull: {pull}")
                before = server_status(dst)
                got, dst_first_ms = timed(
                    lambda: [dst.call("neighbor_row_from_id", "smoke", r, 10)
                             for r in probe[:1]])
                mid = server_status(dst)
                got += [dst.call("neighbor_row_from_id", "smoke", r, 10)
                        for r in probe[1:]]
                for g, w, r in zip(got, want, probe):
                    compare_ranked([tuple(x) for x in g],
                                   [tuple(x) for x in w], f"pulled {r}")
                dst_pull_st = server_status(dst)
                t0 = time.perf_counter()
                src.call("drain", "smoke", False)
                wait_for(lambda: src.call("drain_status", "smoke")["state"]
                         == "drained", "the drain never finished")
                drain_s = time.perf_counter() - t0
                drained = src.call("drain_status", "smoke")
                check(not drained["error"]
                      and drained["rows_handed_off"] == ELASTIC_ROWS,
                      f"drain: {drained}")
                src_st = server_status(src)
                got, after_handoff_ms = timed(
                    lambda: [dst.call("neighbor_row_from_id", "smoke", r, 10)
                             for r in probe])
                for g, w, r in zip(got, want, probe):
                    compare_ranked([tuple(x) for x in g],
                                   [tuple(x) for x in w], f"handed off {r}")
                dst_st = server_status(dst)
            add_launches(launches, src_st)
            add_launches(launches, dst_st)
        sign = mid["kernel.sig_scan.hamming.launches"] \
            - before["kernel.sig_scan.hamming.launches"]
        return dict(
            rows=ELASTIC_ROWS, fill_s=fill_s,
            fill_rows_per_s=ELASTIC_ROWS / fill_s,
            source_first_queries_ms=src_first_ms,
            pull=dict(pull, rows_per_s=pull["rows"] / pull["seconds"],
                      chunks=dst_pull_st["migration.chunks"]),
            first_query_ms=dst_first_ms, first_query_k1_launches=sign,
            drain=dict(seconds=drain_s,
                       rows_per_s=drained["rows_handed_off"] / drain_s,
                       bytes=drained["bytes_handed_off"],
                       chunks=src_st["migration.chunks"],
                       grace_s=0.2),
            queries_after_handoff_ms=after_handoff_ms,
            server_launches=launches)
    finally:
        for p in (src_proc, dst_proc):
            if p is not None:
                stop_server(p[0])


def phase_store_width(torch, ClassifierDriver, dim_bits: int,
                      seed: int) -> dict:
    """The AROW driver at phase 8's shape on the card and a model store in
    OUT_DIR: a full upload, then a diff record after one more train batch,
    with ``--store-compress`` off and int8 (time, bytes); the off chain's
    compaction; materialize of each chain (off: equal to the driver's
    model; int8: within one quantization step); the lock hold of a
    snapshot into the ring, and a rollback's restore (the tables equal
    the snapshot's)."""
    from jubatus_tpu_torch.framework.model_guard import ModelSnapshotRing
    from jubatus_tpu_torch.framework.model_store import (LocalDirBackend,
                                                         ModelStore,
                                                         StoreUploader)
    from jubatus_tpu_torch.framework.save_load import read_envelope
    from jubatus_tpu_torch.utils.serialization import unpack_obj

    drv = ClassifierDriver(CLF_CONFIG, dim_bits=dim_bits, device="cuda")
    rng = np.random.default_rng(seed + 1205 + dim_bits)
    names = np.array(["neg", "pos"])

    def train_step():
        idx, val, lab = bench_batch(rng, dim_bits)
        drv.train_hashed(list(names[lab]), idx, val)
        torch.cuda.synchronize()

    train_step()
    root = fleet_dir(f"store_{dim_bits}")
    store = ModelStore(LocalDirBackend(root), cluster="smoke",
                       engine="classifier")
    ups = {mode: StoreUploader(store, f"n_{mode}", model_id="smoke",
                               config=json.dumps(CLF_CONFIG), compress=mode)
           for mode in ("off", "int8")}

    def record_bytes(key):
        return os.path.getsize(os.path.join(root, key))

    out = {"dim_bits": dim_bits}
    for mode, up in ups.items():
        key, ms = timed(up.tick, drv, 1)
        out[f"full_{mode}"] = dict(ms=ms, bytes=record_bytes(key))
    train_step()
    for mode, up in ups.items():
        key, ms = timed(up.tick, drv, 2)
        check(key is not None and "/diff/" in key, f"{mode}: no diff record")
        out[f"diff_{mode}"] = dict(ms=ms, bytes=record_bytes(key))
    want = drv.pack()
    (blob, meta), ms = timed(lambda: store.materialize(node="n_int8"))
    check(meta["chain_len"] == 1, "the int8 chain did not replay")
    got = unpack_obj(read_envelope(blob, "int8")[1])[1]
    scale = float(np.abs(want["w"]).max())
    err = float(np.abs(np.asarray(got["w"]) - want["w"]).max())
    check(err <= scale / 127.0, f"int8 replay off by {err} (scale {scale})")
    out["materialize_int8"] = dict(ms=ms, max_abs_err=err)
    key, ms = timed(lambda: store.compact(node="n_off"))
    check(key is not None, "nothing compacted")
    out["compact_off_ms"] = ms
    (blob, meta), ms = timed(lambda: store.materialize(node="n_off"))
    got = unpack_obj(read_envelope(blob, "off")[1])[1]
    check(np.array_equal(got["w"], want["w"])
          and np.array_equal(got["prec"], want["prec"]),
          "the compacted chain differs from the model")
    out["materialize_off"] = dict(ms=ms, chain_len=meta["chain_len"])
    del got, blob, want
    ring = ModelSnapshotRing()
    t0 = time.perf_counter()
    with drv.lock:
        entry = ring.snapshot(drv, 2)
    out["snapshot_lock_ms"] = (time.perf_counter() - t0) * 1e3
    out["snapshot_bytes"] = entry["bytes"]
    snap_w = drv.state.w + drv.state.dw
    train_step()
    t0 = time.perf_counter()
    with drv.lock:
        ring.restore(drv)
    torch.cuda.synchronize()
    out["rollback_ms"] = (time.perf_counter() - t0) * 1e3
    check(torch.equal(drv.state.w, snap_w), "rollback restored other tables")
    return out


def phase_warmboot(Datum, seed: int) -> dict:
    """A regression server (its own process, ``--store-dir``, uploads each
    second) takes STORE_ROWS rows; once the store holds its last version
    it is stopped, and a new server on the same store boots warm: every
    estimate equal to the first server's; then it trains, and its flushes
    launch the scan kernel."""
    d = fleet_dir("warmboot")
    config = os.path.join(ROOT, "config", "regression", "default.json")
    extra = ("--store-dir", d, "--store-interval", "1", "-d", d)
    rng = np.random.default_rng(seed + 1206)
    rows = [linear_example(rng, Datum, "regression", i)
            for i in range(STORE_ROWS + LINEAR_BATCH)]
    queries = [[server_datum(rng, Datum, STORE_ROWS + i)]
               for i in range(SL_QUERIES)]
    launches = {m: 0 for m in RECORDED}
    with serving("regression", "", start_server(
            "regression", config, tag="_warm0", extra=extra)) as cli:
        feed(cli, [("train", (rows[lo:lo + LINEAR_BATCH],))
                   for lo in range(0, STORE_ROWS, LINEAR_BATCH)])
        version = server_status(cli)["update_count"]
        t0 = time.perf_counter()
        wait_for(lambda: any(
            r["version"] == version for r in next(iter(cli.call(
                "get_store_status", "smoke").values()))["records"]),
            "the store never held the last version")
        upload_wait_s = time.perf_counter() - t0
        want = [cli.call("estimate", "smoke", q) for q in queries]
        add_launches(launches, server_status(cli))
    with serving("regression", "", start_server(
            "regression", config, tag="_warm1", extra=extra)) as cli:
        st = server_status(cli)
        check(st["warmboot.outcome"] == "warm", f"warm boot: "
              f"{st['warmboot.outcome']}")
        check(st["warmboot.model_version"] == version,
              "the warm boot loaded another version")
        got = [cli.call("estimate", "smoke", q) for q in queries]
        check(got == want, "the warm-booted server answers otherwise")
        before = st["kernel.online_scan.launches"]
        cli.call("train", "smoke", rows[STORE_ROWS:])
        st = server_status(cli)
        check(st["kernel.online_scan.launches"] > before,
              "the warm-booted server's flush did not launch the scan")
        add_launches(launches, st)
    return dict(rows=STORE_ROWS, upload_wait_s=upload_wait_s,
                warmboot_s=st["warmboot.seconds"],
                chain_len=st["warmboot.chain_len"],
                records_full=st["store.records_full"],
                records_diff=st["store.records_diff"],
                server_launches=launches)


def phase_quarantine(Datum, seed: int) -> dict:
    """Two arow.json servers (each its own process) on ``-x
    broadcast_mixer --mix-guard quarantine --model-snapshot-interval 1``,
    the second armed with ``--fault mix.diff.poison*:nan``. Both train;
    once each has snapshotted the trained model, the poisoned member's
    round folds its NaN diff into the exchange's total: both members
    refuse it and roll back, and answer as before the round."""
    d = fleet_dir("quarantine")
    config = os.path.join(ROOT, "config", "classifier", "arow.json")
    extra = p12_args(d, "q", "-x", "broadcast_mixer", "--mix-guard",
                     "quarantine", "--model-snapshot-interval", "1")
    procs = [start_server("classifier", config, tag=f"_q{i}",
                          extra=extra + (("--fault", "mix.diff.poison*:nan")
                                         if i else ()))
             for i in range(2)]
    rng = np.random.default_rng(seed + 1207)
    rows = [linear_example(rng, Datum, "classifier", i)
            for i in range(QUARANTINE_ROWS)]
    queries = [[server_datum(rng, Datum, QUARANTINE_ROWS + i)]
               for i in range(SL_QUERIES)]
    with contextlib.ExitStack() as stack:
        clis = [stack.enter_context(serving("classifier", "", p))
                for p in procs]
        wait_fleet(d, "classifier", "q", 2)
        for k, c in enumerate(clis):
            feed(c, [("train", (rows[lo:lo + LINEAR_BATCH],))
                     for lo in range(k * LINEAR_BATCH, QUARANTINE_ROWS,
                                     2 * LINEAR_BATCH)])
        taken = [server_status(c)["snapshot.taken"] for c in clis]
        for c, t in zip(clis, taken):
            wait_for(lambda c=c, t=t: server_status(c)["snapshot.taken"] > t,
                     "no snapshot after training")
        before = [[c.call("classify", "smoke", q) for q in queries]
                  for c in clis]
        _, round_ms = timed(clis[1].call, "do_mix", "smoke")
        sts = [server_status(c) for c in clis]
        for st in sts:
            check(st["rollback.count"] == 1,
                  f"a member rolled back {st['rollback.count']} times")
            check(st.get("trace.counter.mix.guard.nonfinite_total", 0) >= 1,
                  "the non-finite total was not refused")
        after = [[c.call("classify", "smoke", q) for q in queries]
                 for c in clis]
        check(after == before, "a rolled-back member answers otherwise")
    return dict(rows=QUARANTINE_ROWS, round_ms=round_ms,
                members=[dict(rollbacks=st["rollback.count"],
                              snapshots_taken=st["snapshot.taken"],
                              snapshot_bytes=st["snapshot.bytes"],
                              snapshot_lock_ms=st.get(
                                  "trace.snapshot.lock.max_ms"),
                              refused=st.get(
                                  "trace.counter.mix.guard.nonfinite_total"))
                         for st in sts])


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 13: the fleet — jubacoordd, jubaconfig, jubavisor, jubactl and one
# routing proxy per engine, every process on the card
# ---------------------------------------------------------------------------
FLEET_NN_ROWS = 125_000       # put_rows per NN member (cut from 5·10^5,
                              # then 2.5·10^5 until PR 12: the run's limit)
FLEET_NN_FILL = 20_000        # rows per put_rows call
FLEET_SETS = 2_000            # set_row calls through the proxy
FLEET_QUERIES = 200           # each NN query method through the proxy
FLEET_ADDS = 200              # anomaly adds through the proxy
FLEET_SCORES = 20             # calc_score through the proxy
FLEET_TRAIN = 10_000          # regression rows through the proxy
FLEET_ESTIMATES = 50
FLEET_WAIT_S = 300            # longest wait for a fleet, a drain, a stop
FLEET_ENGINES = (("nearest_neighbor", "fleet_nn"), ("anomaly", "fleet_lof"),
                 ("regression", "fleet_reg"))


def spawn(tag: str, *argv):
    """``python -m <argv>`` from the repo root, its output to a log file
    under OUT_DIR; returns (process, log path)."""
    log_path = os.path.join(OUT_DIR, f"chip_smoke_{tag}.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                stdout=logf, stderr=subprocess.STDOUT)
    return proc, log_path


def ctl(tool, *argv) -> tuple:
    """One ``jubactl`` / ``jubaconfig`` run in this process (their
    ``main``): (exit code, what it printed)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(list(argv))
    return rc, buf.getvalue()


def children_of(pid: int) -> list:
    """The live child processes of ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def fleet_nn_fill(ring, members, seed: int):
    """FLEET_NN_ROWS rows for each member, each row on its CHT(1) owner:
    {member name: [put_rows chunk, ...]} (phase 3's row shape)."""
    rng = np.random.default_rng(seed + 1301)
    want = {m.name: [] for m in members}
    i = 0
    while any(len(v) < FLEET_NN_ROWS for v in want.values()):
        idx, val = random_rows(rng, FLEET_NN_FILL, 32, 18)
        for ii, vv in zip(idx.tolist(), val.tolist()):
            rid = f"r{i}"
            i += 1
            owner = ring.find(rid, 1)[0].name
            if len(want[owner]) < FLEET_NN_ROWS:
                want[owner].append([rid, ii, vv, None])
    return {name: [rows[lo:lo + FLEET_NN_FILL]
                   for lo in range(0, len(rows), FLEET_NN_FILL)]
            for name, rows in want.items()}


def one_of(got, answers, what: str) -> int:
    """The index of the direct answer ``got`` equals exactly."""
    for i, a in enumerate(answers):
        if got == a:
            return i
    raise SmokeError(f"{what}: the proxied answer equals no member's "
                     f"direct answer")


def phase_fleet(Datum, seed: int) -> dict:
    """A port ``jubacoordd`` (``--journal``), three configs written with
    ``jubaconfig`` (nearest_neighbor lsh.json, the LOF config of phase 6
    over lsh, regression default.json), one ``jubavisor`` on the card,
    ``jubactl -c start -N 2`` per engine and one proxy per engine, every
    one its own process. nearest_neighbor: each member filled with
    FLEET_NN_ROWS rows on their CHT(1) owner by ``put_rows``, FLEET_SETS
    ``set_row`` through the proxy, then FLEET_QUERIES of each query method
    through the proxy and directly to both members (each proxied answer
    equal to one member's). anomaly: FLEET_ADDS ``add`` through the proxy,
    each id held by both CHT(2) owners, then ``calc_score``. regression:
    FLEET_TRAIN rows in calls of LINEAR_BATCH through the proxy, then
    ``estimate``. The broadcasts (``get_status`` merge, ``save`` merge,
    ``clear`` all_and), then ``jubactl -c drain`` of one NN member under a
    writer through the proxy (no client error, every row handed off),
    ``rebalance``, ``rollback``, ``status --all``, ``watch --once`` and
    ``stop``: the visor is left with no children."""
    import threading

    from jubatus_tpu_torch.cmd import jubaconfig, jubactl
    from jubatus_tpu_torch.coord import membership
    from jubatus_tpu_torch.coord.cht import CHT
    from jubatus_tpu_torch.coord.remote import RemoteCoordinator
    from jubatus_tpu_torch.rpc.client import RpcClient

    d = fleet_dir("fleet13")
    cport, vport = free_port(), free_port()
    locator = f"tcp://127.0.0.1:{cport}"
    procs = []
    out: dict = {}
    launches = {m: 0 for m in RECORDED}
    view = None
    try:
        t_boot = time.perf_counter()
        coordd = spawn("coordd", "jubatus_tpu_torch.coord.server", "-p",
                       str(cport), "-b", "127.0.0.1", "--journal",
                       os.path.join(d, "coord.journal"))
        procs.append(coordd)
        deadline = time.time() + FLEET_WAIT_S
        while view is None:
            check(coordd[0].poll() is None, "jubacoordd exited")
            try:
                view = RemoteCoordinator("127.0.0.1", cport)
            except Exception:  # broad-ok — still starting
                check(time.time() < deadline, "jubacoordd never answered")
                time.sleep(0.2)
        configs = {
            "nearest_neighbor": os.path.join(ROOT, "config",
                                             "nearest_neighbor", "lsh.json"),
            "anomaly": write_config("fleet_lof.json", lof_config("lsh")),
            "regression": os.path.join(ROOT, "config", "regression",
                                       "default.json")}
        for engine, name in FLEET_ENGINES:
            rc, text = ctl(jubaconfig, "-c", "write", "-t", engine, "-n",
                           name, "-f", configs[engine], "-z", locator,
                           "--device", "cuda")
            check(rc == 0, f"jubaconfig write {engine}: {text}")
        visor = spawn("jubavisor", "jubatus_tpu_torch.cmd.jubavisor", "-z",
                      locator, "-p", str(vport), "-m", "8", "-b",
                      "127.0.0.1", "-l", os.path.join(d, "children.log"),
                      "--device", "cuda")
        procs.append(visor)
        wait_for(lambda: view.list(membership.SUPERVISOR_BASE),
                 "the visor never registered", FLEET_WAIT_S)
        for engine, name in FLEET_ENGINES:
            rc, text = ctl(jubactl, "-c", "start", "-t", engine, "-n", name,
                           "-N", "2", "-z", locator, "-B", "127.0.0.1",
                           "-C", "4", "-D", d, "-S", str(10 ** 9),
                           "-I", str(1 << 30))
            check(rc == 0, f"jubactl start {engine}: {text}")
        proxies = {}
        for engine, name in FLEET_ENGINES:
            pport = free_port()
            procs.append(spawn(f"proxy_{engine}",
                               "jubatus_tpu_torch.server.proxy", engine,
                               "-z", locator, "-p", str(pport), "-b",
                               "127.0.0.1", "-c", "8", "-t", "300",
                               "--interconnect-timeout", "300"))
            proxies[engine] = pport
        for engine, name in FLEET_ENGINES:
            wait_for(lambda e=engine, n=name: len(membership.get_all_actives(
                view, e, n)) == 2, f"two {engine} members never joined",
                FLEET_WAIT_S)
        pcli = {}
        for engine, name in FLEET_ENGINES:
            pcli[engine] = RpcClient("127.0.0.1", proxies[engine],
                                     timeout=300.0)
            wait_for(lambda c=pcli[engine], n=name: answers_ok(
                c, "get_proxy_status", n), f"the {engine} proxy never "
                "answered", FLEET_WAIT_S)
        members = {engine: sorted(membership.get_all_actives(view, engine,
                                                              name),
                                  key=lambda m: m.port)
                   for engine, name in FLEET_ENGINES}
        direct = {engine: [RpcClient(m.host, m.port, timeout=300.0)
                           for m in ms] for engine, ms in members.items()}
        for engine, clis in direct.items():
            for c in clis:
                st = next(iter(c.call("get_status", "smoke").values()))
                check(st["driver.device"].startswith("cuda"),
                      f"{engine} member on {st['driver.device']}")
        out["boot_s"] = time.perf_counter() - t_boot
        nn_name = FLEET_ENGINES[0][1]

        # -- nearest_neighbor: fill, set_row, queries
        ring = CHT.from_coordinator(view, "nearest_neighbor", nn_name)
        fill = fleet_nn_fill(ring, members["nearest_neighbor"], seed)
        t0 = time.perf_counter()

        def put(member, cli):
            for rows in fill[member.name]:
                check(cli.call("put_rows", nn_name, rows) == len(rows),
                      "put_rows applied a short count")

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for fut in [pool.submit(put, m, c) for m, c in zip(
                    members["nearest_neighbor"],
                    direct["nearest_neighbor"])]:
                fut.result()
        fill_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 1302)
        nn = pcli["nearest_neighbor"]
        set_lat = []
        for i in range(FLEET_SETS):
            dat = server_datum(rng, Datum, i)
            ok, ms = timed(nn.call, "set_row", nn_name, f"s{i}", dat)
            check(ok is True, "set_row through the proxy failed")
            set_lat.append(ms)
        # each member's first query signs the rows written since the fill
        warm = server_datum(rng, Datum, FLEET_SETS + FLEET_QUERIES)
        first = [timed(c.call, "neighbor_row_from_datum", nn_name, warm,
                       10)[1] for c in direct["nearest_neighbor"]]
        queries = {"neighbor_row_from_datum": [], "similar_row_from_datum": []}
        lat = {m: {"proxy": [], "direct": []} for m in queries}
        routed = {m: [0, 0] for m in queries}
        for i in range(FLEET_QUERIES):
            dat = server_datum(rng, Datum, FLEET_SETS + i)
            for method in queries:
                got, ms = timed(nn.call, method, nn_name, dat, 10)
                lat[method]["proxy"].append(ms)
                answers = []
                for c in direct["nearest_neighbor"]:
                    a, ms = timed(c.call, method, nn_name, dat, 10)
                    lat[method]["direct"].append(ms)
                    answers.append(a)
                check(len(got) == 10, f"{method}: {len(got)} answers")
                routed[method][one_of(got, answers, method)] += 1
        (pst,) = nn.call("get_proxy_status", nn_name).values()
        nn_rows = sum(c.call("get_row_count", nn_name)
                      for c in direct["nearest_neighbor"])
        check(nn_rows == 2 * FLEET_NN_ROWS + FLEET_SETS,
              f"the NN members hold {nn_rows} rows")
        out["nearest_neighbor"] = dict(
            config="config/nearest_neighbor/lsh.json",
            rows=2 * FLEET_NN_ROWS, fill_s=fill_s,
            fill_rows_per_s=2 * FLEET_NN_ROWS / fill_s,
            set_row=pcts(set_lat), first_query_direct_ms=first,
            queries={m: dict(proxy=pcts(v["proxy"]),
                             direct=pcts(v["direct"]),
                             answered_by_member=routed[m])
                     for m, v in lat.items()},
            proxy=dict(forward_count=pst["forward_count"],
                       relay_count=pst["relay_count"],
                       generic_count=pst["forward_count"]
                       - pst["relay_count"],
                       forward_errors=pst["forward_errors"],
                       ring_builds=pst["ring.builds"],
                       ring_hits=pst["ring.hits"]))

        # -- anomaly: adds placed on both CHT(2) owners, then calc_score
        lof_name = FLEET_ENGINES[1][1]
        an = pcli["anomaly"]
        add_lat, ids = [], []
        for i in range(FLEET_ADDS):
            (rid, score), ms = timed(an.call, "add", lof_name,
                                     server_datum(rng, Datum, i))
            check(np.isfinite(score), f"add score {score}")
            ids.append(rid)
            add_lat.append(ms)
        ring = CHT.from_coordinator(view, "anomaly", lof_name)
        held = [set(c.call("get_all_rows", lof_name))
                for c in direct["anomaly"]]
        by_name = {m.name: h for m, h in zip(members["anomaly"], held)}
        for rid in ids:
            owners = ring.find(rid, 2)
            check(len(owners) == 2 and all(rid in by_name[o.name]
                                           for o in owners),
                  f"row {rid} is not on both of its CHT(2) owners")
        score_lat = []
        for i in range(FLEET_SCORES):
            dat = server_datum(rng, Datum, FLEET_ADDS + i)
            got, ms = timed(an.call, "calc_score", lof_name, dat)
            score_lat.append(ms)
            answers = [c.call("calc_score", lof_name, dat)
                       for c in direct["anomaly"]]
            check(np.isfinite(got), f"calc_score {got}")
            one_of(got, answers, "calc_score")
        out["anomaly"] = dict(config="lof_unlearner_lru.json, nested lsh",
                              adds=FLEET_ADDS, add=pcts(add_lat),
                              calc_score=pcts(score_lat))

        # -- regression: train in calls of LINEAR_BATCH, then estimate
        reg_name = FLEET_ENGINES[2][1]
        rg = pcli["regression"]
        rows = [linear_example(rng, Datum, "regression", i)
                for i in range(FLEET_TRAIN)]
        t0 = time.perf_counter()
        train_lat = []
        for lo in range(0, FLEET_TRAIN, LINEAR_BATCH):
            batch = rows[lo:lo + LINEAR_BATCH]
            n, ms = timed(rg.call, "train", reg_name, batch)
            check(n == len(batch), "train through the proxy: short count")
            train_lat.append(ms)
        train_s = time.perf_counter() - t0
        est_lat = []
        for i in range(FLEET_ESTIMATES):
            dat = [rows[i][1]]
            got, ms = timed(rg.call, "estimate", reg_name, dat)
            est_lat.append(ms)
            answers = [c.call("estimate", reg_name, dat)
                       for c in direct["regression"]]
            check(all(np.isfinite(got)), f"estimate {got}")
            one_of(got, answers, "estimate")
        out["regression"] = dict(config="config/regression/default.json",
                                 rows=FLEET_TRAIN,
                                 rows_per_s=FLEET_TRAIN / train_s,
                                 train=pcts(train_lat),
                                 estimate=pcts(est_lat))

        # -- broadcasts
        bc = {}
        for engine, name in FLEET_ENGINES:
            st, ms = timed(pcli[engine].call, "get_status", name)
            check(set(st) == {m.name for m in members[engine]},
                  f"{engine} get_status merged {sorted(st)}")
            saved, save_ms = timed(pcli[engine].call, "save", name, "f13")
            check(len(saved) == 2 and all(
                os.path.exists(p) for p in saved.values()),
                f"{engine} save merged {saved}")
            bc[engine] = dict(get_status_ms=ms, save_ms=save_ms)
        ok, ms = timed(rg.call, "clear", reg_name)
        check(ok is True, "clear through the proxy")
        for c in direct["regression"]:
            check(c.call("estimate", reg_name, [rows[0][1]]) == [0.0],
                  "a regression member kept its model after clear")
        bc["regression"]["clear_ms"] = ms
        out["broadcasts"] = bc

        # -- operations: a drain under a writer through the proxy; the
        # drained member exits (--stop), so its counts are read first
        final = {c.port: next(iter(c.call("get_status", "smoke").values()))
                 for clis in direct.values() for c in clis}
        src = members["nearest_neighbor"][0]
        src_rows = direct["nearest_neighbor"][0].call("get_row_count",
                                                      nn_name)
        writes, errors = [0], []
        stop = threading.Event()

        def writer():
            with RpcClient("127.0.0.1", proxies["nearest_neighbor"],
                           timeout=300.0) as w:
                wrng = np.random.default_rng(seed + 1303)
                while not stop.is_set():
                    try:
                        ok = w.call("set_row", nn_name, f"w{writes[0]}",
                                    server_datum(wrng, Datum, writes[0]))
                        check(ok is True, "set_row returned False")
                        writes[0] += 1
                    except Exception as e:  # broad-ok — counted, checked
                        errors.append(repr(e))

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        t0 = time.perf_counter()
        rc, text = ctl(jubactl, "-c", "drain", "-t", "nearest_neighbor",
                       "-n", nn_name, "-z", locator, "--target", src.name,
                       "--stop", "--drain-timeout", str(FLEET_WAIT_S))
        drain_s = time.perf_counter() - t0
        stop.set()
        wt.join(timeout=FLEET_WAIT_S)
        check(rc == 0, f"jubactl drain: {text}")
        check(not errors, f"{len(errors)} client errors during the drain: "
              f"{errors[:3]}")
        wait_for(lambda: len(membership.get_all_nodes(
            view, "nearest_neighbor", nn_name)) == 1,
            "the drained member never left", FLEET_WAIT_S)
        direct["nearest_neighbor"][0].close()
        survivor = direct["nearest_neighbor"][1]
        direct["nearest_neighbor"] = [survivor]
        total = 2 * FLEET_NN_ROWS + FLEET_SETS + writes[0]
        check(survivor.call("get_row_count", nn_name) == total,
              "the survivor does not hold every row after the drain")
        # the source's rows when the drain began (the writer's few rows
        # routed to it before its gate closed are not counted)
        out["drain"] = dict(seconds=drain_s, source_rows=src_rows,
                            rows_per_s=src_rows / drain_s,
                            writes_during=writes[0], client_errors=0)
        rc, text = ctl(jubactl, "-c", "rebalance", "-t", "nearest_neighbor",
                       "-n", nn_name, "-z", locator)
        check(rc == 0 and "rebalance complete" in text,
              f"jubactl rebalance: {text}")
        check(survivor.call("get_row_count", nn_name) == total,
              "rows moved by the rebalance")
        # jubactl start forwards no --model-snapshot-interval (nor does
        # the JAX package's), so no member holds a snapshot: rollback
        # must reach every member and be refused by each
        rc, text = ctl(jubactl, "-c", "rollback", "-t", "regression", "-n",
                       reg_name, "-z", locator)
        check(text.count("refused: no model snapshot retained") == 2,
              f"jubactl rollback: {text}")
        rc, text = ctl(jubactl, "-c", "status", "--all", "-t",
                       "nearest_neighbor", "-n", nn_name, "-z", locator)
        check(rc == 0 and f"{nn_name}: 1 node(s), 1 active" in text
              and f"update_count: " in text, f"jubactl status: {text[:400]}")
        rc, frame = ctl(jubactl, "-c", "watch", "--once", "-t",
                        "nearest_neighbor", "-n", nn_name, "-z", locator)
        check(rc == 0 and "(1 server(s), 3 proxy(ies))" in frame,
              f"jubactl watch: {frame}")
        out["watch_frame"] = frame.splitlines()
        for engine, clis in direct.items():
            for c in clis:
                final[c.port] = next(iter(
                    c.call("get_status", "smoke").values()))
                c.close()
        launches = {m: 0 for m in RECORDED}
        for st in final.values():
            add_launches(launches, st)
        for c in pcli.values():
            c.close()
        for engine, name in FLEET_ENGINES:
            rc, text = ctl(jubactl, "-c", "stop", "-t", engine, "-n", name,
                           "-z", locator)
            check(rc == 0, f"jubactl stop {engine}: {text}")
        for engine, name in FLEET_ENGINES:
            wait_for(lambda e=engine, n=name: not membership.get_all_nodes(
                view, e, n), f"the {engine} members never left",
                FLEET_WAIT_S)
        wait_for(lambda: not children_of(visor[0].pid),
                 "the visor still has children", FLEET_WAIT_S)
        out["visor_children_after_stop"] = 0
        return dict(out, server_launches=launches)
    except Exception:
        for _, log_path in procs:
            with open(log_path) as f:
                tail = f.read()[-2000:]
            print(f"--- {log_path}, last lines:\n{tail}", file=sys.stderr)
        raise
    finally:
        if view is not None:
            view.close()
        for proc, _ in reversed(procs):
            stop_server(proc)


def answers_ok(cli, method: str, name: str) -> bool:
    try:
        cli.call(method, name)
        return True
    except Exception:  # broad-ok — not serving yet
        return False

# ---------------------------------------------------------------------------
# phase 2: K1's gathered variant at its edges
# ---------------------------------------------------------------------------
GATHER_EDGE_M = (1, 7, 4099)
GATHER_EDGE_C = (7, 4099)


def phase_gather_edges(torch, sig_scan, seed: int) -> dict:
    """The gathered variant against its plain version on the card, bit for
    bit: M in GATHER_EDGE_M candidates, W in EDGE_W, tables on and 4 bytes
    off 16-byte alignment (the 16-byte and the word-at-a-time loads), a
    query row of padding only, the table's last slot."""
    rng = np.random.default_rng(seed + 2)
    n = 0
    t0 = time.perf_counter()
    for mode in GATHER_MODES:
        for c in GATHER_EDGE_C:
            for w in EDGE_W:
                for m in GATHER_EDGE_M:
                    for misaligned in (False, True):
                        q, r = edge_inputs(torch, mode, 3, c, w, rng,
                                           misaligned)
                        cand = rng.integers(-1, c, (3, m)).astype(np.int32)
                        cand[0, 0] = c - 1
                        cand[1] = -1
                        cd = torch.from_numpy(cand).cuda()
                        got = sig_scan.gathered(mode, q, r, cd, 32 * w)
                        ref = sig_scan.gathered_plain(mode, q, r, cd, 32 * w)
                        torch.cuda.synchronize()
                        check(torch.equal(got, ref),
                              f"{mode} gather C={c} W={w} M={m} misaligned="
                              f"{misaligned}: kernel != plain (max abs err "
                              f"{float((got - ref).nan_to_num().abs().max())})")
                        check(bool(torch.isinf(got[1]).all()),
                              f"{mode} gather: padding did not score +inf")
                        n += 1
    return dict(shapes=n, bit_equal=True, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 14: the IVF tier and row-sharded serving
# ---------------------------------------------------------------------------
IVF_NPROBE = 8                # --ann-nprobe's default
SHARDS = 4                    # logical shards on cuda:0
SHARD_IVF_CELLS = 16          # the sharded full-probe check's cells
SHARD_IVF_QUERIES = 20
IVF_SERVER_ROWS = 250_000     # the --ann ivf server's put_rows fill
IVF_SERVER_QUERIES = 200
IVF_LOAD_QUERIES = 50
SHARD_LOF_SCORES = 20


def gather_bound(b: int, m: int, valid: int, distinct: int, w: int,
                 ops_per_word: int):
    """(bound_ms, bound_by) of one gathered launch: bytes = the distinct
    table rows the valid candidates name (queries that probe one cell share
    its rows), every slot id and output, the queries, each once;
    operations = ``ops_per_word`` int32 ops per (valid candidate, word)."""
    t_bytes = (distinct * w * 4 + b * m * 4 + b * m * 4 + b * w * 4) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = ops_per_word * valid * w / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_timing(torch, sig_scan, ivf, be, seed: int, l2) -> list:
    """The gathered variant at this index's shapes (B = 1 and 256 queries'
    real probe of IVF_NPROBE cells): cold-L2 kernel time, the plain
    version's and, for minhash, the library pair index_select + cdist."""
    mode = "hamming" if be.method == "lsh" else "minhash"
    spec = KERNELS[mode]
    rng = np.random.default_rng(seed + 14)
    cen, tab, _cap = be._ann_device_state()
    table = be.sig_table()
    w = table.shape[1]
    rows = []
    for b in (1, 256):
        idx, val = random_rows(rng, b, 32, 18)
        q = be._query_sigs_batch([list(zip(ii, vv)) for ii, vv in
                                  zip(idx.tolist(), val.tolist())])
        emb = ivf.embed_signatures(q, method=be.method, hash_num=be.hash_num)
        cand = ivf.probe_gather(emb, cen, tab, IVF_NPROBE).to(
            torch.int32).contiguous()
        run_k = lambda: sig_scan.gathered(mode, q, table, cand, be.hash_num)
        run_p = lambda: sig_scan.gathered_plain(mode, q, table, cand,
                                                be.hash_num)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"{mode} gather B={b}: kernel != plain")
        run_l = None
        if mode == "minhash":
            def run_l():
                g = table.index_select(0, cand.reshape(-1).clamp(min=0)
                                       .long()).view(b, -1, w).float()
                return torch.cdist(q.float()[:, None, :], g, p=0)[:, 0] / w
        m = cand.shape[1]
        valid = int((cand >= 0).sum())
        distinct = int(torch.unique(cand[cand >= 0]).numel())
        bms, by = gather_bound(b, m, valid, distinct, w, spec["ops_per_word"])
        ms = time_ms(torch, run_k, REPS, flush=l2.zero_)
        row = dict(B=b, M=m, valid_candidates=valid, distinct_rows=distinct,
                   W=w, C=table.shape[0],
                   kernel_ms=ms,
                   kernel_warm_ms=time_ms(torch, run_k, REPS),
                   plain_ms=time_ms(torch, run_p, REPS // 4),
                   library_ms=(time_ms(torch, run_l, REPS // 4)
                               if run_l is not None else None),
                   bound_ms=bms, bound_by=by, bound_share=bms / ms,
                   max_abs_err=float((got - ref).nan_to_num(posinf=0.0)
                                     .abs().max()))
        log(f"[kernels] sig_scan.{mode}_gather " + json.dumps(row))
        rows.append(row)
        del got, ref, cand
    return rows


def recall_at(got, want, k: int) -> tuple:
    """(id recall, distance recall) of an approximate answer: the share of
    the exact answer's ids it holds, and the share of its rows as near as
    the exact k-th (tie-aware: rows tied at the boundary count)."""
    ids = len({r for r, _ in got} & {r for r, _ in want}) / k
    edge = want[-1][1]
    return ids, sum(1 for _, d in got if d <= edge) / k


def phase_ivf_flat(torch, sig_scan, ivf, events, kept, seed: int,
                   l2) -> dict:
    """configure_ann("ivf") on phase 3's backend (auto cells, nprobe 8):
    the build split, 200 queries against phase 3's exact answers (recall,
    every distance the row's true one), a forced re-split and its event,
    the gathered kernel's timing, then ``off`` again: the exact path's
    answers equal phase 3's bit for bit."""
    be, vecs, answers = kept
    mode = "hamming" if be.method == "lsh" else "minhash"
    k = 10
    be.configure_ann("ivf")
    t0 = time.perf_counter()
    check(be._ann_ready(), f"{be.method}: the IVF index did not build")
    be._ann_device_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    split = dict(be.ann_last_build)
    st = be.ann_stats()
    check(st["cells"] >= ivf.auto_cells(ROWS)
          and st["rows_indexed"] == ROWS, f"{be.method}: index {st}")
    before = launch_counts(sig_scan)
    lat, got = [], []
    for vec in vecs:
        res, ms = timed(be.neighbors, vec, k)
        lat.append(ms)
        got.append(res)
    launched = moved(sig_scan, before)
    check(launched[f"{mode}_gather"] == len(vecs),
          f"{be.method}: {launched[f'{mode}_gather']} gathered launches for "
          f"{len(vecs)} IVF queries")
    rec = [recall_at(g, a, k) for g, a in zip(got, answers)]
    for res in got:
        check(len(res) == k and all(np.isfinite(d) for _, d in res),
              f"{be.method}: bad IVF answer {res[:3]}")
    with uncounted(sig_scan):
        for vec, res in list(zip(vecs, got))[:5]:
            full = be.distances(vec)
            check(all(full[be.store.slots[r]] == d for r, d in res),
                  f"{be.method}: an IVF distance is not the row's own")
    # a forced re-split: the widest cells past a width one under theirs
    sizes = be._ann_arenas.sizes()
    cells_before = len(sizes)
    be.ann_split_width = max(sizes) - 1
    seen = len(events.default_journal().snapshot(grep="resplit"))
    be.set_row("ivf_probe_row", vecs[0])
    be.neighbors(vecs[0], k)
    be.ann_split_width = 0
    resplits = len(events.default_journal().snapshot(grep="resplit")) - seen
    check(resplits >= 1 and be._ann_arenas.n_cells > cells_before,
          f"{be.method}: no re-split ({resplits} events)")
    be.remove_row("ivf_probe_row")
    with uncounted(sig_scan):
        timing = gather_timing(torch, sig_scan, ivf, be, seed, l2)
    st = be.ann_stats()
    be.configure_ann("off")
    exact_lat, same = [], 0
    for vec, want in zip(vecs, answers):
        res, ms = timed(be.neighbors, vec, k)
        exact_lat.append(ms)
        same += res == want
    check(same == len(vecs), f"{be.method}: the exact path after --ann off "
                             f"answered {len(vecs) - same} queries unlike "
                             "phase 3")
    return dict(method=be.method, rows=ROWS, cells=split["cells"],
                nprobe=IVF_NPROBE, build_s=build_s, build_split=split,
                cells_after_resplit=st["cells"], resplit_events=resplits,
                ivf=pcts(lat), exact=pcts(exact_lat),
                recall_at_10=statistics.fmean(r[0] for r in rec),
                recall_at_10_tie_aware=statistics.fmean(r[1] for r in rec),
                rescore_candidates=st["rescore_candidates"],
                recall_probe=st.get("recall_probe"), launches=launched,
                exact_equal_to_phase3=same, gather_timing=timing)


def phase_ivf_exact(torch, knn, rec, Datum, seed: int) -> dict:
    """``inverted_index`` (recommender default.json) under IVF on phase
    5's rows: the JL probe table filled at the flush, ivf_topk_exact's
    answers each within EXACT_TOL of a CPU recomputation of every
    distance, recall against that exact top-10."""
    be = rec.backend
    t0 = time.perf_counter()
    be.configure_ann("ivf")
    signed = be.flush()
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    check(signed == REC_ROWS, f"inverted_index: {signed} JL rows signed")
    t0 = time.perf_counter()
    check(be._ann_ready(), "inverted_index: the IVF index did not build")
    be._ann_device_state()
    build_s = time.perf_counter() - t0
    queries = random_datums(np.random.default_rng(seed + 2), Datum,
                            REC_QUERIES)
    lat, answers = [], []
    for q in queries:
        res, ms = timed(rec.similar_row_from_datum, q, 10)
        lat.append(ms)
        answers.append(res)
    st = be.ann_stats()
    idx = torch.from_numpy(be.store.idx)
    val = torch.from_numpy(be.store.val)
    live = torch.from_numpy(be.store.live)
    worst, recalls = 0.0, []
    for q, res in list(zip(queries, answers))[:10]:
        vec = rec.converter.convert(q)
        qd = knn.densify(torch.tensor([i for i, _ in vec], dtype=torch.int32),
                         torch.tensor([v for _, v in vec],
                                      dtype=torch.float32), dim=be.dim)
        d_cpu = torch.where(live, 1.0 - knn.cosine_scores(idx, val, qd),
                            torch.tensor(float("inf")))
        true = [(rid, float(d_cpu[be.store.slots[rid]])) for rid, _ in res]
        for (_, sim), (_, d) in zip(res, true):
            worst = max(worst, abs(float(sim) - (1.0 - d)))
        vals, order = torch.topk(d_cpu, 10, largest=False, sorted=True)
        want = [(be.store.ids[s], float(v)) for s, v in
                zip(order.tolist(), vals.tolist())]
        recalls.append(recall_at(true, want, 10))
    check(worst <= EXACT_TOL, f"inverted_index IVF: similarities off the "
                              f"CPU's by {worst} (> {EXACT_TOL})")
    be.configure_ann("off")
    exact_lat = [timed(rec.similar_row_from_datum, q, 10)[1]
                 for q in queries]
    return dict(config="config/recommender/default.json", rows=REC_ROWS,
                cells=st["cells"], nprobe=st["nprobe"],
                probe_table_s=probe_s, build_s=build_s,
                build_split=dict(be.ann_last_build), ivf=pcts(lat),
                exact=pcts(exact_lat), max_abs_err=worst, tol=EXACT_TOL,
                recall_at_10=statistics.fmean(r[0] for r in recalls),
                recall_at_10_tie_aware=statistics.fmean(
                    r[1] for r in recalls))


def phase_sharded(torch, sig_scan, ShardMesh, kept) -> dict:
    """Phase 3's backend row-sharded over SHARDS logical shards on cuda:0:
    200 exact queries (distances equal to phase 3's, ids up to ties at the
    k-th, K1 launched once a shard), then IVF over the shards with every
    cell probed, equal to the sharded exact answers."""
    be, vecs, answers = kept
    mode = "hamming" if be.method == "lsh" else "minhash"
    k = 10
    t0 = time.perf_counter()
    be.attach_mesh(ShardMesh(["cuda:0"] * SHARDS))
    attach_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    signed = be.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    check(signed == ROWS, f"{be.method} sharded: signed {signed} rows")
    before = launch_counts(sig_scan)
    lat, got, merge = [], [], []
    for vec in vecs:
        res, ms = timed(be.neighbors, vec, k)
        lat.append(ms)
        got.append(res)
        merge.append(be.last_topk_ms)
    launched = moved(sig_scan, before)
    check(launched[mode] == SHARDS * len(vecs),
          f"{be.method} sharded: {launched[mode]} scans for {len(vecs)} "
          f"queries over {SHARDS} shards")
    for g, a in zip(got, answers):
        check([d for _, d in g] == [d for _, d in a],
              f"{be.method} sharded: distances differ from the flat path's")
        compare_ranked(g, a, f"{be.method} sharded")
    shard_st = be.shard_stats()
    be.configure_ann("ivf", cells=SHARD_IVF_CELLS, nprobe=SHARD_IVF_CELLS)
    t0 = time.perf_counter()
    check(be._ann_ready(), f"{be.method} sharded: the IVF index did not "
                           "build")
    build_s = time.perf_counter() - t0
    before = launch_counts(sig_scan)
    ivf_lat = []
    for vec, want in list(zip(vecs, got))[:SHARD_IVF_QUERIES]:
        res, ms = timed(be.neighbors, vec, k)
        ivf_lat.append(ms)
        check([d for _, d in res] == [d for _, d in want],
              f"{be.method} sharded IVF with every cell probed: distances "
              "differ from the sharded exact path's")
        compare_ranked(res, want, f"{be.method} sharded IVF")
    ivf_launched = moved(sig_scan, before)
    check(ivf_launched[f"{mode}_gather"] == SHARDS * SHARD_IVF_QUERIES,
          f"{be.method} sharded IVF: {ivf_launched[f'{mode}_gather']} "
          "gathered launches")
    st = be.ann_stats()
    be.configure_ann("off")
    launched = {m: launched[m] + ivf_launched[m] for m in launched}
    return dict(method=be.method, rows=ROWS, shards=SHARDS,
                attach_s=attach_s, flush_s=flush_s, exact=pcts(lat),
                topk_merge_ms=pcts(merge), shard_stats=shard_st,
                ivf_full_probe=dict(cells=st["cells"], build_s=build_s,
                                    rescore_candidates=st[
                                        "rescore_candidates"],
                                    queries=SHARD_IVF_QUERIES,
                                    latency=pcts(ivf_lat)),
                launches=launched)


def lof_by_id(torch, drv, datums) -> list:
    """LOF of ``datums`` from the driver's backend distances with ties
    between equal distances broken by row id (columns in id order, stable
    sorts on the card): the driver's ``_support`` and ``_score`` made
    independent of the slot layout, whose numpy sorts break ties by
    column."""
    be = drv.backend
    slots = np.asarray([be.store.slots[r] for r in sorted(be.store.slots)])
    n = len(slots)
    kk, k = min(drv.k, n - 1), min(drv.k, n)
    d = torch.from_numpy(be.distances_from_slots(slots)[:, slots]).cuda()
    d.fill_diagonal_(float("inf"))
    dv, nbr = torch.sort(d, dim=1, stable=True)
    dv, nbr = dv[:, :kk], nbr[:, :kk]
    kdist = dv[:, -1]
    lrd = kk / torch.maximum(kdist[nbr], dv).sum(1)
    q = torch.from_numpy(np.stack([
        be.distances(drv.converter.convert(dt))[slots] for dt in datums])
    ).cuda()
    qv, order = torch.sort(q, dim=1, stable=True)
    lrd_q = k / torch.maximum(kdist[order[:, :k]], qv[:, :k]).sum(1)
    return (lrd[order[:, :k]].mean(1) / lrd_q).cpu().tolist()


def phase_sharded_lof(torch, sig_scan, AnomalyDriver, ShardMesh, Datum,
                      seed: int) -> dict:
    """Phase 6's LOF config over lsh at LOF_ROWS rows on SHARDS logical
    shards of cuda:0: the full distance rows equal the flat backend's (id
    for id), the scores equal the CPU port driver's on the same shard
    layout bit for bit, and how many equal the flat card driver's (LOF's
    host sorts break ties between equal distances by column, and a shard
    layout orders the columns differently). The witness: with ties broken
    by row id (``lof_by_id``), the sharded and the flat card driver's
    scores are equal bit for bit."""
    config = lof_config("lsh")
    card = AnomalyDriver(config, device="cuda")
    card.backend.attach_mesh(ShardMesh(["cuda:0"] * SHARDS))
    cpu = AnomalyDriver(config, device="cpu")
    cpu.backend.attach_mesh(ShardMesh(["cpu"] * SHARDS))
    flat = AnomalyDriver(config, device="cuda")
    rng = np.random.default_rng(seed + 7)
    idx, val = random_rows(rng, LOF_ROWS, 32, 18)
    for i, (ii, vv) in enumerate(zip(idx.tolist(), val.tolist())):
        for drv in (card, cpu, flat):
            drv.backend.set_row(f"r{i}", list(zip(ii, vv)))
    datums = random_datums(np.random.default_rng(seed + 8), Datum,
                           SHARD_LOF_SCORES)
    before = launch_counts(sig_scan)
    lat, got = [], []
    for d in datums:
        score, ms = timed(card.calc_score, d)
        lat.append(ms)
        got.append(score)
    launched = moved(sig_scan, before)
    with uncounted(sig_scan):
        want = [cpu.calc_score(d) for d in datums]
        flat_scores = [flat.calc_score(d) for d in datums]
        ids = card.backend.store.all_ids()[:64]
        ds = card.backend.distances_from_slots(
            np.asarray([card.backend.store.slots[r] for r in ids]))
        df = flat.backend.distances_from_slots(
            np.asarray([flat.backend.store.slots[r] for r in ids]))
        cols_s = np.asarray([card.backend.store.slots[r] for r in
                             flat.backend.store.ids if r])
        cols_f = np.asarray([flat.backend.store.slots[r] for r in
                             flat.backend.store.ids if r])
        check(np.array_equal(ds[:, cols_s], df[:, cols_f]),
              "sharded LOF: distance rows differ from the flat backend's")
        by_id = lof_by_id(torch, card, datums)
        check(np.array_equal(by_id, lof_by_id(torch, flat, datums),
                             equal_nan=True),
              "sharded LOF: id-ordered scores differ from the flat driver's")
    check(bool(np.isfinite(got).all()), "sharded LOF: non-finite score")
    check(got == want, "sharded LOF: scores differ from the CPU driver's on "
                       "the same shard layout")
    check(launched["hamming"] > 0, "sharded LOF launched no K1 scan")
    return dict(config="config/anomaly/lof_unlearner_lru.json (lsh)",
                rows=LOF_ROWS, shards=SHARDS, scores=len(got),
                calc_score=pcts(lat), equal_to_cpu_sharded=len(got),
                equal_to_flat=int(sum(a == b for a, b in
                                      zip(got, flat_scores))),
                max_rel_diff_to_flat=float(max(
                    abs(a / b - 1.0) for a, b in zip(got, flat_scores))),
                id_ordered_equal_to_flat=len(by_id),
                launches=launched)


def ivf_fill_calls(seed: int):
    """IVF_SERVER_ROWS rows of phase 3's shape as put_rows chunks."""
    rng = np.random.default_rng(seed + 1404)
    for lo in range(0, IVF_SERVER_ROWS, ELASTIC_FILL):
        n = min(ELASTIC_FILL, IVF_SERVER_ROWS - lo)
        idx, val = random_rows(rng, n, 32, 18)
        yield [[f"r{lo + i}", ii, vv, None]
               for i, (ii, vv) in enumerate(zip(idx.tolist(), val.tolist()))]


def phase_ivf_server(seed: int) -> dict:
    """``--ann ivf`` nearest_neighbor servers (lsh.json) on the card: one
    filled by put_rows, queried over RPC, its status read, saved; a second
    loads the file (the centroids byte for byte, equal answers); and
    ``--shard-devices 2`` on a one-card machine exits with the JAX
    server's message."""
    import shutil

    config = os.path.join(ROOT, "config", "nearest_neighbor", "lsh.json")
    d = os.path.join(OUT_DIR, "ivf_server")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    extra = ("--ann", "ivf", "-d", d)
    procs = [start_server("nearest_neighbor", config, tag=f"_ivf_{t}",
                          extra=extra) for t in "ab"]
    bad = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.server", "nearest_neighbor",
         "-f", config, "-p", str(free_port()), "-b", "127.0.0.1",
         "--shard-devices", "2", "--device", "cuda"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    launches = {m: 0 for m in RECORDED}
    try:
        with serving("nearest_neighbor", "", procs[0]) as a, \
                serving("nearest_neighbor", "", procs[1]) as b:
            t0 = time.perf_counter()
            for rows in ivf_fill_calls(seed):
                check(a.call("put_rows", "smoke", rows) == len(rows),
                      "put_rows applied a short count")
            fill_s = time.perf_counter() - t0
            probe = [f"r{(i * 7919) % IVF_SERVER_ROWS}"
                     for i in range(IVF_SERVER_QUERIES)]
            first, first_ms = timed(a.call, "neighbor_row_from_id", "smoke",
                                    probe[0], 10)
            lat, want = [], [first]
            for rid in probe[1:]:
                res, ms = timed(a.call, "neighbor_row_from_id", "smoke", rid,
                                10)
                lat.append(ms)
                want.append(res)
            st = server_status(a)
            for key in ("driver.ann.built", "ann.cells", "ann.recall_probe"):
                check(key in st, f"--ann ivf get_status lacks {key}")
            check(st["driver.ann.built"] is True, "the server's index is "
                                                  "not built")
            (path,), save_ms = timed(lambda: list(a.call("save", "smoke",
                                                          "ivf").values()))
            b_path = os.path.join(
                d, f"127.0.0.1_{procs[1][1]}_nearest_neighbor_ivf.jubatus")
            shutil.copy(path, b_path)
            ok, load_ms = timed(b.call, "load", "smoke", "ivf")
            check(ok is True, "load of the --ann ivf model failed")
            for rid, w in list(zip(probe, want))[:IVF_LOAD_QUERIES]:
                got = b.call("neighbor_row_from_id", "smoke", rid, 10)
                check(got == w, f"the loaded server answers {rid} unlike "
                                "the saver")
            (b2,) = b.call("save", "smoke", "ivf2").values()
            ca = saved_model(path)["backend"]["ann"]
            cb = saved_model(b2)["backend"]["ann"]
            check(ca["centroids"] == cb["centroids"]
                  and ca["cells"] == cb["cells"],
                  "the loaded server's centroids differ from the saver's")
            st_b = server_status(b)
            add_launches(launches, st)
            add_launches(launches, st_b)
        out, err = bad.communicate(timeout=180)
        check(bad.returncode == 1 and "--shard-devices 2 but only 1 local "
              "devices present" in err,
              f"--shard-devices 2 on one card: exit {bad.returncode}, "
              f"{err[-300:]!r}")
        return dict(config="config/nearest_neighbor/lsh.json --ann ivf",
                    rows=IVF_SERVER_ROWS, fill_s=fill_s,
                    fill_rows_per_s=IVF_SERVER_ROWS / fill_s,
                    first_query_ms=first_ms, query=pcts(lat),
                    status={k: st[k] for k in sorted(st)
                            if k.startswith(("ann.", "driver.ann."))},
                    save_ms=save_ms, load_ms=load_ms,
                    loaded_queries_equal=IVF_LOAD_QUERIES,
                    centroid_bytes=len(ca["centroids"]),
                    shard_devices_2_exit=bad.returncode,
                    server_launches=launches)
    finally:
        for p in procs:
            stop_server(p[0])
        if bad.poll() is None:
            bad.kill()
            bad.wait(timeout=20)


# ---------------------------------------------------------------------------
# phase 15: the feature-sharded linear engines on 4 logical shards of the card
# ---------------------------------------------------------------------------
FS_SHARDS = 4                 # logical shards of one card (ShardMesh)
FS_DIM_BITS = 24              # AROW at phase 8's widest shape
FS_CPU_DIM_BITS = 20          # the reduced shape held against the CPU port
FS_CPU_B = 2048
FS_CPU_STEPS = 2
FS_REG_BATCHES = 2            # regression flushes of SCAN_TIME_B rows
FS_SPLIT_REPS = 5             # timed repeats of the regression split
FS_MIX_ROWS = 2_000           # rows of the mix round, half per member
# sharded against flat (card or CPU): |d| <= FS_TOL + FS_TOL * |want|, the
# rtol = atol of tests/test_torch_sharded_model.py; the cross-shard sums
# add the K products in another order than the flat step
FS_TOL = 3e-5
FS_FIELDS = ("w", "dw", "prec", "dprec")


def blocks_err(sm, got, want) -> dict:
    """A sharded leaf (blocks, or a whole tensor) against the flat one
    column range by column range on the device: the largest |d|, and the
    largest |d| / (FS_TOL + FS_TOL * |want|) (<= 1 holds)."""
    blocks = got if sm.is_blocks(got) else (got,)
    off, worst, biggest = 0, 0.0, 0.0
    for b in blocks:
        w = want[..., off:off + b.shape[-1]].to(b.device)
        d = (b - w).abs()
        biggest = max(biggest, float(d.max()))
        worst = max(worst, float((d / (FS_TOL + FS_TOL * w.abs())).max()))
        off += b.shape[-1]
    return dict(max_abs=biggest, err_over_limit=worst)


def fs_state_errs(sm, got_state, want_state, what: str) -> dict:
    errs = {name: blocks_err(sm, a, b)
            for name, a, b in zip(FS_FIELDS, got_state, want_state)}
    check(max(e["err_over_limit"] for e in errs.values()) <= 1.0,
          f"{what}: sharded tables off the flat ones {errs}")
    return errs


def fs_answers_err(got, want) -> float:
    """classify answers (label, score) lists: labels equal, scores within
    the FS_TOL rule; returns the largest |d| / limit."""
    check([[lab for lab, _ in r] for r in got] ==
          [[lab for lab, _ in r] for r in want], "sharded labels differ")
    g = np.array([[s for _, s in r] for r in got], dtype=np.float64)
    w = np.array([[s for _, s in r] for r in want], dtype=np.float64)
    check(np.isfinite(g).all(), "sharded scores not finite")
    return float((np.abs(g - w) / (FS_TOL + FS_TOL * np.abs(w))).max())


def phase_fs_arow(torch, sm, ShardMesh, ClassifierDriver, dev,
                  seed: int) -> dict:
    """AROW at the bench shape (L = 2 labels, capacity 8, K = 64, B =
    CLF_B, D = 2^FS_DIM_BITS): a driver on FS_SHARDS logical shards of the
    card and a flat one on the card take the same train_hashed batches
    (examples/s, median of CLF_STEPS after CLF_WARMUP); the four tables
    equal within FS_TOL; classify_hashed p50/p99 at B = 1 and B = CLF_B,
    both drivers, answers within FS_TOL; one sharded step under
    torch.profiler split into the shards' masks, partials, the reduction
    on the first device, the decides and the shards' scatters, and one
    flat step beside it."""
    mesh = ShardMesh([dev] * FS_SHARDS)
    drivers = {
        "flat": ClassifierDriver(CLF_CONFIG, dim_bits=FS_DIM_BITS,
                                 device=dev),
        "sharded": ClassifierDriver(CLF_CONFIG, dim_bits=FS_DIM_BITS,
                                    device=dev, mesh=mesh)}
    rng = np.random.default_rng(seed + 151)
    host = [bench_batch(rng, FS_DIM_BITS, CLF_B)
            for _ in range(CLF_WARMUP + CLF_STEPS)]
    names = np.array(["neg", "pos"])
    out = dict(dim_bits=FS_DIM_BITS, B=CLF_B, K=CLF_K, L=CLF_L,
               shards=FS_SHARDS, mesh=str(mesh))
    for key, drv in drivers.items():
        walls = []
        for i, (idx, val, lab) in enumerate(host):
            t0 = time.perf_counter()
            check(drv.train_hashed(list(names[lab]), idx, val) == CLF_B,
                  "train_hashed count")
            torch.cuda.synchronize()
            if i >= CLF_WARMUP:
                walls.append((time.perf_counter() - t0) * 1e3)
        out[key] = dict(train_hashed_ms=statistics.median(walls),
                        train_examples_per_s=CLF_B / statistics.median(walls)
                        * 1e3, train_ms_all=walls)
    flat, shard = drivers["flat"], drivers["sharded"]
    check(len(shard.state.w) == FS_SHARDS
          and shard.state.w[0].shape == (8, (1 << FS_DIM_BITS) // FS_SHARDS),
          "the sharded state is not in FS_SHARDS blocks")
    out["tables"] = fs_state_errs(sm, shard.state, flat.state,
                                  f"AROW D=2^{FS_DIM_BITS}")
    q_idx, q_val, _ = bench_batch(rng, FS_DIM_BITS, CLF_B)
    answers = {}
    for key, drv in drivers.items():
        lat1 = [timed(drv.classify_hashed, q_idx[i:i + 1], q_val[i:i + 1])[1]
                for i in range(CLF_QUERIES)]
        lat_big = []
        for _ in range(CLF_BIG_QUERIES):
            big, ms = timed(drv.classify_hashed, q_idx, q_val)
            lat_big.append(ms)
        answers[key] = big
        out[key].update(classify_b1=pcts(lat1), classify_big=pcts(lat_big))
    out["classify_err_over_limit"] = fs_answers_err(answers["sharded"],
                                                    answers["flat"])
    check(out["classify_err_over_limit"] <= 1.0,
          f"sharded classify off the flat: {out['classify_err_over_limit']}")
    idx, val, lab = host[-1]
    steps = [(sm, "_owned", "mask"), (sm, "_shard_partials", "partials"),
             (sm, "_shard_confidence", "partials"), (sm, "psum", "reduce"),
             (sm, "decide_updates", "decide"),
             (sm, "_shard_scatter", "scatter")]
    out["profile"] = profile_calls(
        torch, [lambda: shard.train_hashed(list(names[lab]), idx, val)],
        out["sharded"]["train_hashed_ms"], steps)
    out["profile_flat"] = profile_calls(
        torch, [lambda: flat.train_hashed(list(names[lab]), idx, val)],
        out["flat"]["train_hashed_ms"], [])
    return out


def phase_fs_arow_cpu(torch, sm, ShardMesh, ClassifierDriver, dev,
                      seed: int) -> dict:
    """The reduced shape (D = 2^FS_CPU_DIM_BITS, B = FS_CPU_B): the card's
    sharded driver against the CPU port's sharded driver, FS_CPU_STEPS
    batches, tables and 256 answers within FS_TOL."""
    card = ClassifierDriver(CLF_CONFIG, dim_bits=FS_CPU_DIM_BITS, device=dev,
                            mesh=ShardMesh([dev] * FS_SHARDS))
    cpu = ClassifierDriver(CLF_CONFIG, dim_bits=FS_CPU_DIM_BITS,
                           device="cpu", mesh=ShardMesh(["cpu"] * FS_SHARDS))
    rng = np.random.default_rng(seed + 152)
    names = np.array(["neg", "pos"])
    for _ in range(FS_CPU_STEPS):
        idx, val, lab = bench_batch(rng, FS_CPU_DIM_BITS, FS_CPU_B)
        for drv in (card, cpu):
            drv.train_hashed(list(names[lab]), idx, val)
    want = type(cpu.state)(*(torch.cat(a, -1) for a in cpu.state))
    errs = fs_state_errs(sm, card.state, want,
                         f"AROW D=2^{FS_CPU_DIM_BITS} card vs CPU")
    q_idx, q_val, _ = bench_batch(rng, FS_CPU_DIM_BITS, 256)
    err = fs_answers_err(card.classify_hashed(q_idx, q_val),
                         cpu.classify_hashed(q_idx, q_val))
    check(err <= 1.0, f"sharded classify, card vs CPU: {err}")
    return dict(dim_bits=FS_CPU_DIM_BITS, B=FS_CPU_B, steps=FS_CPU_STEPS,
                tables=errs, classify_err_over_limit=err)


def phase_fs_regression(torch, sm, ShardMesh, RegressionDriver, Datum,
                        sig_scan, dev, seed: int) -> dict:
    """config/regression/default.json on FS_SHARDS logical shards against
    the flat driver on the card: FS_REG_BATCHES server-shaped flushes of
    SCAN_TIME_B rows (phase 2's ``scan_server_batch``, K = 16) through
    train_hashed, each one S1 launch; the tables bit-equal to the flat
    card scan's (the largest difference printed); then the sharded train
    split into host unique / gather / upload / S1 / write-back (median of
    FS_SPLIT_REPS, not counted as the path's launches)."""
    from jubatus_tpu_torch.core.sparse import to_device
    from jubatus_tpu_torch.ops import online_scan
    from jubatus_tpu_torch.ops import regression as rops

    mesh = ShardMesh([dev] * FS_SHARDS)
    config = load_config("regression", "default.json")
    flat = RegressionDriver(config, device=dev)
    shard = RegressionDriver(config, device=dev, mesh=mesh)
    rng = np.random.default_rng(seed + 153)
    batches = [scan_server_batch(rng, Datum, RegressionDriver, SCAN_TIME_B)
               for _ in range(FS_REG_BATCHES)]
    times = {"flat": [], "sharded": []}
    before = online_scan.pa_scan.launches
    for idx, val, targets, _ in batches:
        with uncounted(sig_scan):
            _, ms = timed(lambda: (flat.train_hashed(targets, idx, val),
                                   torch.cuda.synchronize()))
        times["flat"].append(ms)
        _, ms = timed(lambda: (shard.train_hashed(targets, idx, val),
                               torch.cuda.synchronize()))
        times["sharded"].append(ms)
    launches = online_scan.pa_scan.launches - before
    check(launches == FS_REG_BATCHES,
          f"sharded regression: {launches} S1 launches for "
          f"{FS_REG_BATCHES} flushes")
    wf, ws = flat.pack()["w"], shard.pack()["w"]
    check(np.isfinite(ws).all() and np.abs(ws).max() > 0,
          "sharded regression: no finite update")
    diff = float(np.abs(ws - wf).max())
    # the same kernel over the same values in the same order: a lost bit
    # is a fault of the gathered working set
    check(np.array_equal(ws, wf),
          f"sharded regression not bit-equal to the flat card scan (max "
          f"difference {diff})")
    idx, val, targets, _ = batches[0]
    split = {k: [] for k in ("unique", "gather", "upload", "scan",
                             "write_back")}
    with uncounted(sig_scan):
        for _ in range(FS_SPLIT_REPS):
            t0 = time.perf_counter()
            uniq, inv = sm.compact_indices(idx)
            t1 = time.perf_counter()
            work, plan = sm.working_set(shard.state, uniq)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            args = (to_device(inv, mesh.devices[0]),
                    to_device(val, mesh.devices[0]),
                    to_device(targets, mesh.devices[0]))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            rops.train_batch(work, *args, shard.sensitivity, shard.c,
                             method=shard.method)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            sm.write_back(shard.state, plan, work, ("dw",))
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            for key, a, b in (("unique", t0, t1), ("gather", t1, t2),
                              ("upload", t2, t3), ("scan", t3, t4),
                              ("write_back", t4, t5)):
                split[key].append((b - a) * 1e3)
    return dict(config="config/regression/default.json", rows=SCAN_TIME_B,
                K=int(idx.shape[1]), flushes=FS_REG_BATCHES,
                distinct_keys=int(len(uniq)), s1_launches=launches,
                variant=online_scan.choose_variant(int(idx.shape[1])),
                bit_equal_flat_card=True, max_abs_diff_flat_card=diff,
                train_ms={k: v for k, v in times.items()},
                split_ms={k: statistics.median(v) for k, v in split.items()})


def fs_status(cli, dev) -> dict:
    st = next(iter(cli.call("get_status", "smoke").values()))
    check(st.get("driver.device", "").startswith(dev.type),
          f"server runs on {st.get('driver.device')!r}, not {dev}")
    return st


def phase_fs_servers(torch, ShardMesh, EngineServer, ServerArgs, Datum,
                     Driver, engine: str, config_name: str, dev,
                     flat_phase9: dict, seed: int) -> dict:
    """config/<engine>/<config_name> served in this process on FS_SHARDS
    logical shards of the card: SERVER_ROWS rows in LINEAR_BATCH-row train
    calls over RPC from one client (each call one flush), LINEAR_QUERIES
    classify / estimate calls against a CPU driver fed the same calls
    (LINEAR_TOL), beside phase 9's flat server; then a ``save``, loaded
    into a flat card server: its tables equal the saver's bit for bit and
    its answers the saver's within FS_TOL."""
    import tempfile

    from jubatus_tpu_torch.rpc.client import RpcClient

    config = load_config(engine, config_name)
    ref = Driver(config, device="cpu")
    rng = np.random.default_rng(seed + 154)
    rows = [linear_example(rng, Datum, engine, i) for i in range(SERVER_ROWS)]
    batches = [rows[lo:lo + LINEAR_BATCH]
               for lo in range(0, SERVER_ROWS, LINEAR_BATCH)]
    qs = [server_datum(rng, Datum, SERVER_ROWS + i)
          for i in range(LINEAR_QUERIES)]
    query = "classify" if engine == "classifier" else "estimate"
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fs_", dir=OUT_DIR)
    srv = EngineServer(engine, config, ServerArgs(engine=engine, datadir=tmp),
                       device=dev, mesh=ShardMesh([dev] * FS_SHARDS))
    port = srv.start(0)
    try:
        with RpcClient("127.0.0.1", port, timeout=120.0) as cli:
            t0 = time.perf_counter()
            for b in batches:
                check(cli.call("train", "smoke", b) == len(b), "train count")
            t_seq = time.perf_counter() - t0
            for b in batches:
                ref.train([(lab, d) for lab, d in b])
            lat, got = [], []
            for q in qs:
                (ans,), ms = timed(cli.call, query, "smoke", [q])
                lat.append(ms)
                got.append(ans)
            saved = cli.call("save", "smoke", "fs")
            st = fs_status(cli, dev)
        saver_pack = srv.driver.pack()
    finally:
        srv.stop()
    want = ref.classify(qs) if engine == "classifier" else ref.estimate(qs)
    if engine == "classifier":
        check([[lab for lab, _ in r] for r in got] ==
              [[lab for lab, _ in r] for r in want], "labels differ")
        g = np.array([[s for _, s in r] for r in got], dtype=np.float64)
        w = np.array([[s for _, s in r] for r in want], dtype=np.float64)
    else:
        g, w = (np.array(x, dtype=np.float64) for x in (got, want))
    check(np.isfinite(g).all(), f"sharded {engine}: answers not finite")
    limit = LINEAR_TOL * float(np.abs(w).max()) + 1e-4 * np.abs(w) + 1e-30
    err = float((np.abs(g - w) / limit).max())
    check(err <= 1.0, f"sharded {engine} {query}: off the CPU driver ({err})")
    check(st["driver.shard.count"] == FS_SHARDS
          and st["shard.count"] == FS_SHARDS,
          f"sharded {engine}: shard gauges {st.get('driver.shard.count')}")
    (path,) = saved.values()
    flat = EngineServer(engine, config, ServerArgs(engine=engine), device=dev)
    t0 = time.perf_counter()
    flat.load_file(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    flat_pack = flat.driver.pack()
    for key in ("w", "prec", "label_counts"):
        if key in saver_pack:
            check(np.array_equal(np.asarray(flat_pack[key]),
                                 np.asarray(saver_pack[key])),
                  f"{engine}: the flat server's loaded {key} differs")
    loaded = (flat.driver.classify(qs) if engine == "classifier"
              else flat.driver.estimate(qs))
    if engine == "classifier":
        load_err = fs_answers_err(loaded, got)
    else:
        a, b = np.array(loaded), np.array(got)
        load_err = float((np.abs(a - b) / (FS_TOL + FS_TOL * np.abs(b))).max())
    check(load_err <= 1.0, f"{engine}: the loaded flat server's answers "
                           f"off the saver's ({load_err})")
    return dict(engine=engine, config=f"config/{engine}/{config_name}",
                shards=FS_SHARDS, rows=SERVER_ROWS, batch=LINEAR_BATCH,
                sequential=dict(calls=len(batches), seconds=t_seq,
                                rows_per_s=SERVER_ROWS / t_seq),
                **{query: pcts(lat)},
                flat_phase9=flat_phase9,
                parity=dict(tol=LINEAR_TOL, err_over_limit=err),
                save_load=dict(load_ms=load_ms, tables_bit_equal=True,
                               answers_err_over_limit=load_err),
                shard_gauges={k: st[k] for k in st
                              if k.startswith("driver.shard.")},
                launches=server_launches(st))


def phase_fs_mix(torch, ShardMesh, EngineServer, ServerArgs, Datum, dev,
                 seed: int) -> dict:
    """Two arow.json members in this process, each on FS_SHARDS logical
    shards, on one MemoryCoordinator: each trains half of FS_MIX_ROWS rows
    over RPC, then ``do_mix`` on the first: both end with equal models
    bit for bit; the round's wall time and the members' mix gauges."""
    from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
    from jubatus_tpu_torch.rpc.client import RpcClient

    store = _Store()
    config = load_config("classifier", "arow.json")
    rng = np.random.default_rng(seed + 155)
    rows = [linear_example(rng, Datum, "classifier", i)
            for i in range(FS_MIX_ROWS)]
    servers = []
    try:
        for _ in range(2):
            srv = EngineServer("classifier", config, ServerArgs(
                engine="classifier", coordinator="(shared)", name="smoke",
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30), device=dev,
                coord=MemoryCoordinator(store),
                mesh=ShardMesh([dev] * FS_SHARDS))
            srv.start(0)
            servers.append(srv)
        clis = [RpcClient("127.0.0.1", s.args.rpc_port, timeout=120.0)
                for s in servers]
        try:
            for k, cli in enumerate(clis):
                half = rows[k::2]
                for lo in range(0, len(half), LINEAR_BATCH):
                    cli.call("train", "smoke", half[lo:lo + LINEAR_BATCH])
            pre = [s.driver.pack()["w"] for s in servers]
            check(not np.array_equal(pre[0], pre[1]),
                  "the members trained alike before the mix")
            ok, mix_ms = timed(clis[0].call, "do_mix", "smoke")
            check(ok is True, "do_mix failed")
            sts = [fs_status(c, dev) for c in clis]
        finally:
            for c in clis:
                c.close()
        packs = [s.driver.pack() for s in servers]
    finally:
        for s in servers:
            s.stop()
    for key in ("w", "prec", "label_counts"):
        check(np.array_equal(np.asarray(packs[0][key]),
                             np.asarray(packs[1][key])),
              f"sharded mix: members' {key} differ after the round")
    return dict(config="config/classifier/arow.json", shards=FS_SHARDS,
                rows=FS_MIX_ROWS, do_mix_ms=mix_ms, bit_equal=True,
                model_version=[st.get("mixer.model_version") for st in sts],
                gauges=[{k: v for k, v in st.items()
                         if k.startswith("mix.")} for st in sts])


# ---------------------------------------------------------------------------
# phase 16: the collective mix plane
# ---------------------------------------------------------------------------
COL_MODES = ("off", "bf16", "int8")
COL_TIMED = 3                 # timed world-1 rounds per mode (median)
COL_EF_ROUNDS = 4             # int8 rounds with feedback against f32
COL_CHECK_ELEMS = 1 << 20     # columns of dw held against the CPU port
COL_FLEET_ROWS = 2_000        # arow.json rows a round over the 2x2 fleet
COL_REG_ROWS = 2_000          # regression rows over the two members
COL_FLEET_CHUNK_MB = 1.0      # the 2x2 fleet's chunk: its [L, 2^18]
                              # tables (~1-3 MB) then ride the two tiers
COL_WORLD_TIMEOUT = 180.0     # the two-rank world's bound (s)
COL_GROUP_TIMEOUT = 120.0     # the process groups' collective timeout (s)


def col_staged(ClassifierDriver, rng):
    """Phase 8's AROW driver at D = 2^24 (capacity 8, one train_hashed step
    of B = CLF_B) and the diff its collective mixer stages: the live label
    rows of dw / dprec, the count and the label counts on the card, the
    weights' df on the host."""
    from jubatus_tpu_torch.framework.collective_mixer import _staged_diff

    d = ClassifierDriver(CLF_CONFIG, dim_bits=24, device="cuda")
    idx, val, lab = bench_batch(rng, 24)
    d.train_hashed(list(np.array(["neg", "pos"])[lab]), idx, val)
    return d, {name: _staged_diff(m) for name, m in d.get_mixables().items()}


def kernel_count(prof) -> dict:
    """Kernels in a torch.profiler trace: the device's kernel records
    (memcpys and memsets apart) and the host's launch calls."""
    device = launches = 0
    for e in prof.events():
        name = e.name.lower()
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            device += not name.startswith(("memcpy", "memset"))
        elif name.startswith("cudalaunchkernel"):
            launches += 1
    return {"device_kernels": device, "launch_calls": launches}


def phase_collective_world1(torch, ClassifierDriver, seed: int) -> dict:
    """``psum_pytree`` at world size 1 over NCCL on the card, on the AROW
    diff at bench.py's shape (D = 2^24): each wire mode's round (median of
    COL_TIMED, phases, wire MB); each mode's total against the round trip
    it must equal (off: the diff itself; bf16: its bf16 cast; int8: within
    half a block scale, and bit-equal to the CPU port's round on the first
    COL_CHECK_ELEMS columns); COL_EF_ROUNDS int8 rounds with and without
    feedback against f32; the ship's and the whole round's kernel launches
    per chunk under torch.profiler."""
    import datetime

    import torch.distributed as dist

    from jubatus_tpu_torch.parallel import collective as C
    from jubatus_tpu_torch.parallel import multihost
    from jubatus_tpu_torch.utils.tree import tree_leaves

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    td = datetime.timedelta(seconds=COL_GROUP_TIMEOUT)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, is_master=True,
                          timeout=td)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=td)
    try:
        check(multihost.backend() == "nccl"
              and multihost.wire_device() == dev,
              f"world-1 group on {multihost.backend()}, not NCCL")
        rng = np.random.default_rng(seed + 1600)
        drv, diff = col_staged(ClassifierDriver, rng)
        dw = diff["classifier"]["dw"]
        out = {"shape": dict(L=int(dw.shape[0]), D=int(dw.shape[1]),
                             B=CLF_B, K=CLF_K, capacity=8),
               "backend": "nccl", "world": 1}
        for mode in COL_MODES:
            times, ph = [], {}
            for _ in range(COL_TIMED):
                ph = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tot = C.psum_pytree(diff, compress=mode, prefer_device=True,
                                    phases=ph, device=dev,
                                    feedback=C.ErrorFeedback()
                                    if mode == "int8" else None)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            got = tot["classifier"]["dw"]
            check(got.device == dev and got.shape == dw.shape
                  and bool(torch.isfinite(got).all()),
                  f"{mode}: total off the card, misshapen or not finite")
            if mode == "off":
                ok = all(torch.equal(a.cpu() if hasattr(a, "cpu")
                                     else torch.as_tensor(np.asarray(a)),
                                     b.cpu())
                         for a, b in zip(tree_leaves(diff), tree_leaves(tot)))
                check(ok, "off: a world-1 total is not the diff")
                err = 0.0
            elif mode == "bf16":
                check(torch.equal(got, dw.to(torch.bfloat16).float()),
                      "bf16: the total is not the diff's bf16 cast")
                err = float((got - dw).abs().max())
            else:
                blocks = dw.reshape(-1, C.QUANT_BLOCK)
                bound = blocks.abs().amax(1, keepdim=True) / 127.0 * 0.5
                diffb = (got - dw).abs().reshape(-1, C.QUANT_BLOCK)
                # the round requantizes the dequantized values: a scale
                # may move by an ulp, so the bound carries a 1e-4 slack
                check(bool((diffb <= bound * 1.0001 + 1e-9).all()),
                      "int8: an element off by more than half its scale")
                err = float(diffb.max())
                sub = {"w": dw[:, :COL_CHECK_ELEMS].contiguous()}
                card = C.psum_pytree(sub, compress="int8", chunk_mb=1.0,
                                     prefer_device=True, device=dev)["w"]
                cpu = C.psum_pytree({"w": sub["w"].cpu()}, compress="int8",
                                    chunk_mb=1.0, device="cpu")["w"]
                check(np.array_equal(card.cpu().numpy(), cpu),
                      "int8: the card's round differs from the CPU port's")
            out[mode] = dict(round_ms=statistics.median(times),
                             round_ms_all=times, max_abs_err=err,
                             phases={k: ph[k] for k in (
                                 "ship_ms", "reduce_ms", "readback_ms",
                                 "intra_ms", "inter_ms", "payload_mb",
                                 "wire_mb", "wire_bytes_per_host", "chunks",
                                 "chunk_mb", "overlap_ms_saved", "quant",
                                 "topo")})
        # int8 with and without feedback against f32 over fresh rounds
        ef = C.ErrorFeedback()
        s32 = torch.zeros_like(dw, dtype=torch.float64)
        s8 = torch.zeros_like(s32)
        s8n = torch.zeros_like(s32)
        drift = []
        for _ in range(COL_EF_ROUNDS):
            idx, val, lab = bench_batch(rng, 24)
            drv.train_hashed(list(np.array(["neg", "pos"])[lab]), idx, val)
            round_diff = {"w": drv.get_mixables()["classifier"]
                          .get_device_diff()["dw"]}
            s32 += C.psum_pytree(round_diff, prefer_device=True,
                                 device=dev)["w"].double()
            s8 += C.psum_pytree(round_diff, compress="int8", feedback=ef,
                                prefer_device=True, device=dev)["w"].double()
            s8n += C.psum_pytree(round_diff, compress="int8",
                                 prefer_device=True,
                                 device=dev)["w"].double()
            norm = float(s32.norm())
            drift.append(dict(ef=float((s8 - s32).norm()) / norm,
                              no_ef=float((s8n - s32).norm()) / norm))
        out["int8_vs_f32"] = dict(rounds=COL_EF_ROUNDS, rel_l2=drift,
                                  ef_norms=ef.norms())
        check(drift[-1]["ef"] <= drift[-1]["no_ef"],
              "int8: feedback drifted further than no feedback")
        # launches: the ship of one chunk, and a whole int8 round
        chunk = dw.reshape(-1)[: (8 << 20) // 4].clone()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            y = chunk + 0.0
            q, s = C._block_quant(y, C.QUANT_BLOCK)
            C._add_dequant(y, q, s, C.QUANT_BLOCK, -1.0)
            torch.cuda.synchronize()
        ship = kernel_count(prof)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ph = {}
            C.psum_pytree(diff, compress="int8", prefer_device=True,
                          phases=ph, device=dev,
                          feedback=C.ErrorFeedback())
            torch.cuda.synchronize()
        total = kernel_count(prof)
        out["int8_launches"] = dict(
            ship_per_chunk=ship, round=total, chunks=ph["chunks"],
            round_per_chunk={k: v / max(1, ph["chunks"])
                             for k, v in total.items()})
        return out
    finally:
        dist.destroy_process_group()


_COL_RANK = r"""
import hashlib, json, sys, time
import numpy as np
import torch
from jubatus_tpu_torch.parallel import collective as C, multihost
from jubatus_tpu_torch.utils.tree import tree_leaves
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
modes, dim_bits, timeout = sys.argv[4].split(","), int(sys.argv[5]), float(sys.argv[6])
dev = torch.device("cuda", 0)
assert multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=n, process_id=rank, device="cuda",
                            timeout=timeout)
assert multihost.backend() == "gloo", multihost.backend()

def member(r):
    g = torch.Generator(device=dev).manual_seed(1600 + r)
    D = 1 << dim_bits
    return {"classifier": {
                "dw": torch.randn(2, D, generator=g, device=dev) * 0.01,
                "dprec": torch.rand(2, D, generator=g, device=dev),
                "count": torch.ones((), device=dev),
                "label_counts": torch.tensor([3.0 + r, 5.0], device=dev)},
            "weights": {"df": np.zeros(D, np.float32),
                        "ndocs": np.float32(r)}}

mine = member(rank)
res = {}
for mode in modes:
    ph = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tot = C.psum_pytree(mine, compress=mode, prefer_device=True, phases=ph,
                        device=dev, feedback=C.ErrorFeedback()
                        if mode == "int8" else None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    h = hashlib.sha256()
    for leaf in tree_leaves(tot):
        h.update(leaf.detach().cpu().numpy().tobytes())
    dw = tot["classifier"]["dw"]
    want = sum(member(r)["classifier"]["dw"] for r in range(n))
    exact = bool(torch.equal(dw, want)) if mode == "off" else None
    res[mode] = dict(ms=ms, sha256=h.hexdigest(), exact_sum=exact,
                     finite=bool(torch.isfinite(dw).all()),
                     max_abs_err=float((dw - want).abs().max()),
                     phases={k: ph[k] for k in ("ship_ms", "reduce_ms",
                             "readback_ms", "payload_mb", "wire_mb",
                             "chunks", "overlap_ms_saved")})
print("RESULT " + json.dumps(res), flush=True)
multihost.shutdown()
"""


def phase_collective_gloo(seed: int) -> dict:
    """Two ranks spawned on cuda:0, one gloo world (NCCL cannot hold two
    ranks on one card), each with a seeded diff at the AROW width (dw and
    dprec [2, 2^24] on the card, df [2^24] on the host): one round in
    modes off and int8. The ranks' totals must be bit-equal (hashes of
    every leaf), off equal to the exact sum of the two diffs."""
    from jubatus_tpu_torch.parallel import multihost

    modes = ("off", "int8")
    t0 = time.perf_counter()
    outs, rcs = multihost.run_local_world(
        _COL_RANK, 2, args=(",".join(modes), 24, COL_GROUP_TIMEOUT),
        timeout=COL_WORLD_TIMEOUT, cwd=ROOT)
    wall = time.perf_counter() - t0
    res = []
    for r, (text, rc) in enumerate(zip(outs, rcs)):
        if rc != 0 or "RESULT " not in text:
            print(f"--- rank {r} output:\n{text[-4000:]}", file=sys.stderr)
        check(rc == 0 and "RESULT " in text, f"gloo rank {r} exited {rc}")
        res.append(json.loads(text.split("RESULT ")[1].splitlines()[0]))
    for mode in modes:
        check(res[0][mode]["sha256"] == res[1][mode]["sha256"],
              f"{mode}: the ranks' totals differ")
        check(all(r[mode]["finite"] for r in res), f"{mode}: not finite")
    check(all(r["off"]["exact_sum"] for r in res),
          "off: the total is not the exact sum of the two diffs")
    return dict(ranks=2, backend="gloo", device="cuda:0", wall_s=wall,
                bit_equal=True, per_rank=res)


def col_fleet_rounds(engine: str, config: str, n: int, extra, rows_per,
                     rounds: int, seed: int, Datum,
                     chunk_mb: float = 0.0) -> dict:
    """``n`` ``engine`` servers on the card under ``-x collective_mixer``
    with ``--jax-processes n`` (rank 0 publishes its rendezvous in the
    file coordinator, the others find it there), ``rounds`` times: each
    member trains its share of ``rows_per`` rows, then ``do_mix`` on the
    first. After each round every member is at that model version and
    their saved models are equal bit for bit; the master's counters show
    only collective rounds. ``chunk_mb`` (when set) is the fleet's
    JUBATUS_TPU_MIX_CHUNK_MB, which every member must share: small enough
    that the tables ride the chunked stream (and so the two tiers)."""
    d = fleet_dir(f"collective_{engine}")
    port = free_port()
    procs = []
    saved_env = os.environ.get("JUBATUS_TPU_MIX_CHUNK_MB")
    if chunk_mb:
        os.environ["JUBATUS_TPU_MIX_CHUNK_MB"] = str(chunk_mb)
    for r in range(n):
        flags = ["-z", f"file://{d}", "-n", "col", "-d", d, "-s", "1e9",
                 "-i", str(1 << 30), "-x", "collective_mixer",
                 "--jax-processes", str(n), "--jax-process-id", str(r),
                 *extra]
        if r == 0:
            flags += ["--jax-coordinator", f"127.0.0.1:{port}"]
        procs.append(start_server(engine, os.path.join(
            ROOT, "config", engine, config), tag=f"_col{r}", extra=flags))
    if saved_env is None:
        os.environ.pop("JUBATUS_TPU_MIX_CHUNK_MB", None)
    else:
        os.environ["JUBATUS_TPU_MIX_CHUNK_MB"] = saved_env
    rng = np.random.default_rng(seed + 1610)
    launches = {m: 0 for m in RECORDED}
    out = {"engine": engine, "config": f"config/{engine}/{config}",
           "members": n, "flags": list(extra), "rounds": []}
    with contextlib.ExitStack() as stack:
        clis = [stack.enter_context(serving(engine, "", p)) for p in procs]
        wait_fleet(d, engine, "col", n)
        for k in range(rounds):
            rows = [linear_example(rng, Datum, engine, i)
                    for i in range(rows_per)]
            for r, cli in enumerate(clis):
                mine = rows[r::n]
                for lo in range(0, len(mine), LINEAR_BATCH):
                    cli.call("train", "smoke", mine[lo:lo + LINEAR_BATCH])
            ok, mix_ms = timed(clis[0].call, "do_mix", "smoke")
            check(ok is True, f"{engine} collective round {k + 1} failed")
            sts = []
            for cli in clis:
                wait_for(lambda c=cli: server_status(c)[
                    "mixer.model_version"] >= k + 1,
                    f"{engine}: a member never applied round {k + 1}", 120)
                sts.append(server_status(cli))
            models = [saved_pack(c, f"col{k}") for c in clis]
            for m in models[1:]:
                model_close(m, models[0], 0.0,
                            f"{engine} members after round {k + 1}")
            recs = [[h for h in c.call("get_mix_history", "smoke")
                     if h.get("mode") == "collective" and h.get("ok")]
                    for c in clis]
            check(all(recs), f"{engine}: a member logged no collective entry")
            out["rounds"].append(dict(
                do_mix_ms=mix_ms, bit_equal=True,
                phases=[r[-1]["phases"] for r in recs]))
        master = sts[0]
        check(master["mixer.collective_rounds"] == rounds
              and master["mixer.fallback_rounds"] == 0,
              f"{engine}: {master['mixer.collective_rounds']} collective, "
              f"{master['mixer.fallback_rounds']} fallback rounds")
        if "--mix-topology" in extra:
            check(all(p["topo"] != "flat" and p["chunks"] > 0
                      for rd in out["rounds"] for p in rd["phases"]),
                  f"{engine}: a round did not ride the two tiers")
        check(master["mixer.mix_caps_backend"] == "gloo",
              f"{engine}: the fleet's world is "
              f"{master['mixer.mix_caps_backend']}, not gloo")
        out.update(fallback_rounds=0, topology=master["mixer.mix_topology"],
                   compress=master["mixer.mix_compress"],
                   launches=[server_launches(st) for st in sts])
        for st in sts:
            add_launches(launches, st)
    return dict(result=out, server_launches=launches)


def phase_collective_fleets(Datum, seed: int) -> dict:
    """Four arow.json servers on cuda:0 as a 2x2 topology with int8 on the
    wire, two rounds; then two regression default.json servers with the
    wire off, one round (their flushes launch S1)."""
    arow = col_fleet_rounds(
        "classifier", "arow.json", 4,
        ["--mix-topology", "2x2", "--mix-compress", "int8"],
        COL_FLEET_ROWS, 2, seed, Datum, chunk_mb=COL_FLEET_CHUNK_MB)
    reg = col_fleet_rounds("regression", "default.json", 2,
                           ["--mix-compress", "off"], COL_REG_ROWS, 1, seed,
                           Datum)
    launches = {m: arow["server_launches"][m] + reg["server_launches"][m]
                for m in RECORDED}
    return dict(arow=arow["result"], regression=reg["result"],
                server_launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from jubatus_tpu_torch.core.datum import Datum
        from jubatus_tpu_torch.core.sparse import SparseBatch
        from jubatus_tpu_torch.models._nn_backend import NNBackend
        from jubatus_tpu_torch.models.anomaly import AnomalyDriver
        from jubatus_tpu_torch.models.classifier import ClassifierDriver
        from jubatus_tpu_torch.models.classifier_nn import ClassifierNNDriver
        from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
        from jubatus_tpu_torch.models.recommender import RecommenderDriver
        from jubatus_tpu_torch.models.regression import RegressionDriver
        from jubatus_tpu_torch.ops import classifier as clf_ops
        from jubatus_tpu_torch.ops import knn, online_scan, sig_scan
        from jubatus_tpu_torch.models.clustering import ClusteringDriver
        from jubatus_tpu_torch.models.graph import GraphDriver
        from jubatus_tpu_torch.ops import clustering as cl_ops
        from jubatus_tpu_torch.server import EngineServer
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    try:
        # -- phase 1: device + build
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
            f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            # one nvcc per source, started together
            for fut in [pool.submit(m.library) for m in (sig_scan, online_scan)]:
                fut.result()
        log(f"[build] {sig_scan.SOURCE.name}, {online_scan.SOURCE.name} built "
            f"and loaded in {time.perf_counter() - t0:.2f} s")
        for line in (sig_scan.build_log + online_scan.build_log).splitlines():
            if "entry function" in line:
                log(f"[build] {line.strip()[:120]}")
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
        # -- phase 2: kernels vs plain, edge shapes first
        edges = phase_edges(torch, sig_scan, args.seed)
        log(f"[edges] {json.dumps(edges)}")
        edges = phase_gather_edges(torch, sig_scan, args.seed)
        log(f"[edges] gather {json.dumps(edges)}")
        scans = phase_kernels(torch, sig_scan, args.seed)
        with uncounted(sig_scan):
            pa = phase_scan(torch, online_scan, Datum, RegressionDriver,
                            args.seed)
        log(f"[scan] {json.dumps(pa)} | {kind} | {smi}")
        # -- phases 3-7: the main path; each path's launch counts are set
        # to 0 just before it and read just after (the servers' own counts
        # come from their get_status)
        paths, path_s = {}, {}

        def run_path(name, fn, *fn_args):
            set_counts(sig_scan, {m: 0 for m in RECORDED})
            t0 = time.perf_counter()
            res = fn(*fn_args)
            path_s[name] = time.perf_counter() - t0
            counts = launch_counts(sig_scan)
            paths[name] = {m: counts[m] + res.get("server_launches", {})
                           .get(m, 0) for m in RECORDED}
            return res

        def nn_path():
            for method in ("lsh", "minhash"):
                res = phase_backend(torch, sig_scan, knn, NNBackend,
                                    SparseBatch, method, args.seed, kept)
                log(f"[backend] {json.dumps(res)} | {kind} | {smi}")
            return {}

        def nn_server_path():
            res = phase_server(torch, Datum, NearestNeighborDriver, args.seed)
            log(f"[server] {json.dumps(res)} | {kind} | {smi}")
            return {"server_launches": res["launches"]}

        def recommender_path():
            for name in REC_CONFIGS:
                res = phase_recommender(torch, sig_scan, knn,
                                        RecommenderDriver, Datum, name,
                                        args.seed, kept)
                log(f"[recommender] {json.dumps(res)} | {kind} | {smi}")
            return {}

        def anomaly_path():
            assert_matmul_full_precision(torch)
            for nn_method in LOF_METHODS:
                res = phase_anomaly(torch, sig_scan, AnomalyDriver, Datum,
                                    nn_method, args.seed)
                log(f"[anomaly] {json.dumps(res)} | {kind} | {smi}")
                if res["lof_shape"] is not None:
                    mode = "hamming" if nn_method == "lsh" else "minhash"
                    lof_shapes[mode] = res["lof_shape"]
            return {}

        def servers_path():
            total = {m: 0 for m in KERNELS}
            runs = [lambda: phase_recommender_server(Datum, RecommenderDriver,
                                                     args.seed),
                    lambda: phase_anomaly_server(Datum, AnomalyDriver,
                                                 args.seed)]
            runs += [lambda m=m: phase_classifier_server(
                Datum, ClassifierNNDriver, m, args.seed)
                for m in ("euclid_lsh", "lsh")]
            for run in runs:
                res = run()
                tag = {"classifier": "classifier_nn"}.get(
                    res["engine"], res["engine"] + "_server")
                log(f"[{tag}] {json.dumps(res)} | {kind} | {smi}")
                for m in KERNELS:
                    total[m] += res["launches"][m]
            return {"server_launches": total}

        def classifier_path():
            for dim_bits in CLF_DIM_BITS:
                res = phase_classifier_ops(torch, clf_ops, dim_bits, args.seed)
                log(f"[classifier_ops] {json.dumps(res)} | {kind} | {smi}")
                res = phase_classifier_driver(torch, clf_ops, ClassifierDriver,
                                              dim_bits, args.seed)
                log(f"[classifier_driver] {json.dumps(res)} | {kind} | {smi}")
            return {}

        def linear_servers_path():
            total = {m: 0 for m in RECORDED}
            for engine, driver, config in (
                    ("classifier", ClassifierDriver, "arow.json"),
                    ("regression", RegressionDriver, "default.json")):
                res = phase_linear_server(Datum, driver, engine, config,
                                          args.seed)
                log(f"[{engine}_server] {json.dumps(res)} | {kind} | {smi}")
                query = "classify" if engine == "classifier" else "estimate"
                flat_servers[engine] = dict(sequential=res["sequential"],
                                            **{query: res[query]})
                for m in RECORDED:
                    total[m] += res["launches"][m]
            return {"server_launches": total}

        def clustering_graph_path():
            assert_matmul_full_precision(torch)
            for name in ("kmeans.json", "gmm.json"):
                res = phase_clustering(torch, ClusteringDriver, cl_ops, Datum,
                                       name, args.seed)
                log(f"[clustering] {json.dumps(res)} | {kind} | {smi}")
            res = phase_dbscan(torch, ClusteringDriver, cl_ops, Datum,
                               args.seed)
            log(f"[dbscan] {json.dumps(res)} | {kind} | {smi}")
            res = phase_graph(torch, GraphDriver, args.seed)
            log(f"[graph] {json.dumps(res)} | {kind} | {smi}")
            res = phase_new_servers(Datum, EngineServer, args.seed)
            total = {m: 0 for m in RECORDED}
            for engine, r in res.items():
                log(f"[{engine}_server] {json.dumps(r)} | {kind} | {smi}")
                for m in RECORDED:
                    total[m] += r["launches"][m]
            return {"server_launches": total}

        def p12_path():
            total = {m: 0 for m in RECORDED}
            res = phase_push(Datum, EngineServer, args.seed)
            for strategy, r in res.items():
                log(f"[push] {strategy} {json.dumps(r)} | {kind} | {smi}")
            res = phase_async(Datum, EngineServer, args.seed)
            log(f"[async] {json.dumps(res)} | {kind} | {smi}")
            res = phase_elastic(args.seed)
            log(f"[elastic] {json.dumps(res)} | {kind} | {smi}")
            for m in RECORDED:
                total[m] += res["server_launches"][m]
            for dim_bits in CLF_DIM_BITS:
                r = phase_store_width(torch, ClassifierDriver, dim_bits,
                                      args.seed)
                log(f"[store_width] {json.dumps(r)} | {kind} | {smi}")
            res = phase_warmboot(Datum, args.seed)
            log(f"[warmboot] {json.dumps(res)} | {kind} | {smi}")
            for m in RECORDED:
                total[m] += res["server_launches"][m]
            res = phase_quarantine(Datum, args.seed)
            log(f"[quarantine] {json.dumps(res)} | {kind} | {smi}")
            return {"server_launches": total}

        def save_load_mix_path():
            res = phase_save_load_servers(Datum, args.seed)
            for key, r in res["servers"].items():
                log(f"[save_load] {key} {json.dumps(r)} | {kind} | {smi}")
            total = dict(res["server_launches"])
            for dim_bits in CLF_DIM_BITS:
                r = phase_save_load_width(torch, ClassifierDriver, dim_bits,
                                          args.seed)
                log(f"[save_load_width] {json.dumps(r)} | {kind} | {smi}")
                r = phase_mix_width(torch, ClassifierDriver, dim_bits,
                                    args.seed)
                log(f"[mix_width] {json.dumps(r)} | {kind} | {smi}")
            res = phase_fleets(Datum, EngineServer, args.seed)
            for engine, r in res["fleets"].items():
                log(f"[fleet] {engine} {json.dumps(r)} | {kind} | {smi}")
            for m in RECORDED:
                total[m] += res["server_launches"][m]
            return {"server_launches": total}

        lof_shapes = {}
        #: phase 9's flat linear servers, printed beside phase 15's
        flat_servers: dict = {}
        #: phase 3's backends and phase 5's exact recommender, for phase 14
        kept: dict = {}
        #: the gathered variant's timing rows, by mode (phase 14)
        gather_rows: dict = {}
        run_path("nearest_neighbor", nn_path)
        run_path("nearest_neighbor_server", nn_server_path)
        run_path("recommender", recommender_path)
        run_path("anomaly", anomaly_path)
        run_path("servers", servers_path)
        run_path("classifier", classifier_path)
        run_path("linear_servers", linear_servers_path)
        run_path("clustering_graph", clustering_graph_path)
        run_path("save_load_mix", save_load_mix_path)
        def deploy_path():
            res = phase_fleet(Datum, args.seed)
            for key in ("nearest_neighbor", "anomaly", "regression",
                        "broadcasts", "drain"):
                log(f"[deploy] {key} {json.dumps(res[key])} | {kind} | {smi}")
            log(f"[deploy] boot_s {res['boot_s']:.3f} visor children after "
                f"stop {res['visor_children_after_stop']}")
            for line in res["watch_frame"]:
                log(f"[deploy] watch | {line}")
            return {"server_launches": res["server_launches"]}

        run_path("push_async_elastic_store", p12_path)
        run_path("deploy", deploy_path)

        def ivf_shard_path():
            from jubatus_tpu_torch.ops import ivf
            from jubatus_tpu_torch.parallel.mesh import ShardMesh
            from jubatus_tpu_torch.utils import events

            assert_matmul_full_precision(torch)
            l2 = torch.empty(25 * (1 << 20), dtype=torch.float32,
                             device="cuda")
            for method in ("lsh", "minhash"):
                res = phase_ivf_flat(torch, sig_scan, ivf, events,
                                     kept[method], args.seed, l2)
                mode = "hamming" if method == "lsh" else "minhash"
                gather_rows[mode] = res.pop("gather_timing")
                log(f"[ivf] {json.dumps(res)} | {kind} | {smi}")
            del l2
            res = phase_ivf_exact(torch, knn, kept.pop("default.json"), Datum,
                                  args.seed)
            log(f"[ivf] inverted_index {json.dumps(res)} | {kind} | {smi}")
            for method in ("lsh", "minhash"):
                res = phase_sharded(torch, sig_scan, ShardMesh,
                                    kept.pop(method))
                log(f"[sharded] {json.dumps(res)} | {kind} | {smi}")
                torch.cuda.empty_cache()
            res = phase_sharded_lof(torch, sig_scan, AnomalyDriver, ShardMesh,
                                    Datum, args.seed)
            log(f"[sharded_lof] {json.dumps(res)} | {kind} | {smi}")
            res = phase_ivf_server(args.seed)
            log(f"[ivf_server] {json.dumps(res)} | {kind} | {smi}")
            return {"server_launches": res["server_launches"]}

        run_path("ivf_sharded", ivf_shard_path)

        def feature_sharded_path():
            from jubatus_tpu_torch.parallel import sharded_model as sm
            from jubatus_tpu_torch.parallel.mesh import ShardMesh
            from jubatus_tpu_torch.server.args import ServerArgs

            dev = torch.device("cuda", 0)
            res = phase_fs_arow(torch, sm, ShardMesh, ClassifierDriver, dev,
                                args.seed)
            log(f"[fs_arow] {json.dumps(res)} | {kind} | {smi}")
            torch.cuda.empty_cache()
            res = phase_fs_arow_cpu(torch, sm, ShardMesh, ClassifierDriver,
                                    dev, args.seed)
            log(f"[fs_arow_cpu] {json.dumps(res)} | {kind} | {smi}")
            res = phase_fs_regression(torch, sm, ShardMesh, RegressionDriver,
                                      Datum, sig_scan, dev, args.seed)
            log(f"[fs_regression] {json.dumps(res)} | {kind} | {smi}")
            for engine, driver, config in (
                    ("classifier", ClassifierDriver, "arow.json"),
                    ("regression", RegressionDriver, "default.json")):
                res = phase_fs_servers(torch, ShardMesh, EngineServer,
                                       ServerArgs, Datum, driver, engine,
                                       config, dev,
                                       flat_servers.get(engine, {}),
                                       args.seed)
                log(f"[fs_server] {json.dumps(res)} | {kind} | {smi}")
            res = phase_fs_mix(torch, ShardMesh, EngineServer, ServerArgs,
                               Datum, dev, args.seed)
            log(f"[fs_mix] {json.dumps(res)} | {kind} | {smi}")
            return {}

        run_path("feature_sharded", feature_sharded_path)

        def collective_path():
            res = phase_collective_world1(torch, ClassifierDriver, args.seed)
            log(f"[collective] world1 {json.dumps(res)} | {kind} | {smi}")
            res = phase_collective_gloo(args.seed)
            log(f"[collective] gloo {json.dumps(res)} | {kind} | {smi}")
            res = phase_collective_fleets(Datum, args.seed)
            for key in ("arow", "regression"):
                log(f"[collective_fleet] {json.dumps(res[key])} | {kind} | "
                    f"{smi}")
            return {"server_launches": res["server_launches"]}

        run_path("collective", collective_path)
        log(f"[paths] {json.dumps(paths)} seconds {json.dumps(path_s)}")
        log(f"[deploy_launches] phase 13, read from the members' get_status: "
            f"K1 sig_scan.hamming {paths['deploy']['hamming']}, "
            f"sig_scan.minhash {paths['deploy']['minhash']}, "
            f"S1 online_scan.pa {paths['deploy']['pa_scan']} "
            f"({json.dumps(paths['deploy'])}) | {kind} | {smi}")
        launches = {m: sum(p[m] for p in paths.values()) for m in COUNTED}
        for mode, n in launches.items():
            check(n > 0, f"{mode} never launched on the main path")
        for path in ("recommender", "anomaly"):
            for mode in KERNELS:
                check(paths[path][mode] > 0,
                      f"sig_scan.{mode} never launched on the {path} path")
        check(paths["linear_servers"]["pa_scan"] > 0,
              "online_scan.pa never launched on the linear servers path")
        for mode in ("hamming", "pa_scan"):
            check(paths["save_load_mix"][mode] > 0,
                  f"{mode} never launched on the save/load and mix path")
            check(paths["push_async_elastic_store"][mode] > 0,
                  f"{mode} never launched on the push, async, elastic and "
                  "store path")
            check(paths["deploy"][mode] > 0,
                  f"{mode} never launched on the deploy path (phase 13)")
        for mode in ("hamming", "minhash", "hamming_gather",
                     "minhash_gather"):
            check(paths["ivf_sharded"][mode] > 0,
                  f"{mode} never launched on the IVF and sharded path "
                  "(phase 14)")
        check(paths["feature_sharded"]["pa_scan"] > 0,
              "online_scan.pa never launched on the feature-sharded path "
              "(phase 15)")
        check(paths["collective"]["pa_scan"] > 0,
              "online_scan.pa never launched on the collective path "
              "(phase 16)")
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for mode, spec in KERNELS.items():
        first = scans[mode][0]  # B = 1, the single-query serving shape
        kernels.append({
            "name": spec["name"], "route": "cuda",
            "source": "jubatus_tpu_torch/csrc/sig_scan.cu",
            "replaces": "jubatus_tpu/ops/pallas_kernels.py:87",
            "launches": launches[mode],
            "launches_by_path": {p: c[mode] for p, c in paths.items()},
            "max_abs_err": max([s["max_abs_err"] for s in scans[mode]]
                               + [lof_shapes[mode]["max_abs_err"]]),
            "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "shapes": scans[mode], "lof_shape": lof_shapes[mode],
        })
    for mode in GATHER_MODES:
        rows = gather_rows[mode]
        kernels.append({
            "name": f"sig_scan.{mode}_gather", "route": "cuda",
            "source": "jubatus_tpu_torch/csrc/sig_scan.cu",
            "replaces": "jubatus_tpu/ops/pallas_kernels.py:87",
            "replaces_kind": "K1's gathered variant: the IVF rescore "
                             "(jubatus_tpu/ops/ivf.py:251, XLA there)",
            "launches": launches[f"{mode}_gather"],
            "launches_by_path": {p: c[f"{mode}_gather"]
                                 for p, c in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["kernel_ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": rows[0]["library_ms"], "shapes": rows,
        })
    st = pa["stress"]
    kernels.append({
        "name": "online_scan.pa", "route": "cuda",
        "source": "jubatus_tpu_torch/csrc/online_scan.cu",
        "replaces": "jubatus_tpu/ops/regression.py:74",
        "replaces_kind": "jax.lax.scan (no Pallas kernel)",
        "launches": launches["pa_scan"],
        "launches_by_path": {p: c["pa_scan"] for p, c in paths.items()},
        "launches_by_variant": {v: sum(c[f"pa_scan.{v}"]
                                       for c in paths.values())
                                for v in SCAN_VARIANTS},
        "max_abs_err": pa["max_abs_err"], "ms": st["kernel_ms"],
        "plain_ms": pa["plain_ms"], "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"], "library_ms": None,
        "variant": st["variant"],
        "chain_bound_ms": st["chain_bound_ms"],
        "smem_chain_bound_ms": st["smem_chain_bound_ms"],
        "shape": dict(B=st["B"], K=st["K"], dim_bits=pa["dim_bits"]),
        "server_shape": {key: pa["server"][key] for key in (
            "B", "K", "variant", "kernel_ms", "distinct_indices",
            "flushes")},
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
