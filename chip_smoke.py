#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``jubatus_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Drives the port only; imports nothing of JAX or of ``jubatus_tpu``. Phases,
each of which fails the run (non-zero exit, no result line) on error:

1. device: the card's name, and its name and power limit from nvidia-smi;
   builds ``jubatus_tpu_torch/csrc/sig_scan.cu`` and
   ``jubatus_tpu_torch/csrc/online_scan.cu`` with nvcc (sm_90a), one nvcc
   per source, and ``native/fast_ingest.cpp`` (the raw-wire parser the
   linear servers load) and ``native/rpc_frontend.cpp`` (the native
   transport every server and proxy serves on) with g++, started
   together;
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
   32 hashed features (dim_bits 18; written into the row arenas in one
   assignment an array by ``bulk_fill``, the state ``set_row`` leaves),
   200 ``neighbors(vec, 10)`` queries
   each; the kernel's launch count must rise by 200, and 5 queries redone
   with the plain scan on the same device tensors must agree; 20 more
   queries under torch.profiler split the device-busy time per query into
   signature, scan, live mask, top-k and copies;
4. server: ``python -m jubatus_tpu_torch.server nearest_neighbor -f
   config/nearest_neighbor/lsh.json`` on the card, 2,500 set_row and the
   four query methods plus get_all_rows over the port's RpcClient, compared
   with the port's driver on the CPU fed the same rows; the server's
   scan-launch count (get_status) must move;
5. recommender: ``config/recommender/{lsh,minhash,default}.json`` (default
   is inverted_index) with the first REC_HASH_ROWS (6.25·10^4; lsh and
   minhash) or REC_ROWS (2.5·10^5; default) rows of phase 3 (``bulk_fill``);
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
   against the plain version; 2 ``add`` and 50 ``calc_score`` timed; the
   support and every score held against the port's driver on the CPU fed
   the same rows (lsh/minhash exactly, euclid_lsh within LOF_SCORE_RTOL);
   float32 matmul must be at full precision (no TF32);
7. servers: the recommender (default.json, 2,500 update_row), anomaly (LOF
   over lsh, 100 add: each add rebuilds the support) and classifier
   (``config/classifier/nn.json`` as shipped and with nested lsh, 2,500
   examples) servers on the card, all four started at once and each
   driven alone once all four answer, every answer compared with the
   port's driver on the CPU fed the same datums;
8. classifier: AROW ``train_batch_parallel`` at the JAX package's bench
   shape (L = 2, K = 64, B = 32768, D = 2^20 and 2^24): examples/s (median
   of 10 steps after 2), one step under torch.profiler (device busy and
   idle share), the state after 4 steps against the CPU port (within
   CLF_TOL), the deterministic-mode reproduction and one PA1 and CW step
   (D = 2^20); the driver's ``train_hashed`` examples/s and
   ``classify_hashed`` p50/p99 at B = 1 and B = 32768;
9. linear servers: ``config/classifier/arow.json`` and
   ``config/regression/default.json`` on the card (both started at once,
   each driven alone once both answer); 10^4 rows through
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
   ``load_model`` of the AROW driver at phase 8's shape (D = 2^20; phase
   17 times them at 2^24), split into readback, msgpack, CRC, write and
   fsync, then read, CRC check, unpack and upload, the loaded tables equal
   to the saved; one mix round of two AROW drivers at that shape through
   the mixer's wire path in this process (the round's phases, each member's
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
   filled with 3.125·10^4 rows through ``put_rows``, a second server's
   ``rebalance`` pull, its first query (signing every pulled row, K1),
   then the first server's drain and handoff, the new owner's answers
   equal to the source's each time; the AROW driver (capacity 8, B =
   32768) in a model store at D = 2^20 and 2^24 (full and diff records
   off, and int8 at 2^20 only; compaction, materialize, the snapshot's
   lock hold, rollback); a
   regression server stopped and restarted warm from ``--store-dir``
   (answers equal, its flushes launch S1); two ``arow.json`` servers
   under ``--mix-guard quarantine``, one armed with ``--fault
   mix.diff.poison*:nan``, rolling back on the refused total;
13. the fleet, every member on the card: a port ``jubacoordd``
   (``python -m jubatus_tpu_torch.coord.server --journal``), three configs
   written with ``jubaconfig`` (nearest_neighbor lsh.json, phase 6's LOF
   config over lsh, regression default.json), one ``jubavisor``,
   ``jubactl -c start -N 2`` per engine and a routing proxy per engine on
   the native transport (``python -m jubatus_tpu_torch.server.proxy``, its
   planes on), and a second NN and a second regression proxy with
   ``JUBATUS_TPU_NATIVE_RPC=0`` (FLEET_PROXIES).
   nearest_neighbor: each member filled with 3.125·10^4 rows on their
   CHT(1) owner by ``put_rows`` (6.25·10^4 in all), 2,000 ``set_row``
   through the proxy, then, once its C++ relay has engaged, 100 each of
   ``neighbor_row_from_datum`` and ``similar_row_from_datum`` through the
   relay, through the Python-transport proxy and directly to both members
   (every proxied answer equal to one member's exactly; p50/p99 three
   ways; the relay's ``relay_count`` at least the 200 queries, by method,
   its forward errors 0, the Python proxy's ``relay_count`` 0); anomaly:
   50 ``add`` through the proxy, each id held by both CHT(2) owners,
   ``calc_score``; regression: 10^4 rows through the proxy in calls of
   256, ``estimate`` (the relay forwards some of them);
   the broadcasts (``get_status`` and ``save`` merged, ``clear``
   all_and); the views through the proxies (a traced NN query through the
   Python-transport NN proxy assembled by ``jubactl -c trace``,
   ``metrics``, ``alerts`` with that proxy's SLO firing, ``quality``,
   ``usage``, ``profile``, ``timeline``,
   ``incident`` with its one bundle, a live ``watch``, ``/metrics``, each
   forensics RPC timed, no proxy holding a /dev/nvidia* node open where
   every member holds one); ``jubactl -c drain`` of one NN member while a
   client writes through the proxy and another reads through its C++
   relay (no client error, every row on the survivor), then
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
   two ``--ann ivf`` lsh.json servers: one filled with 6.25·10^4 rows by
   ``put_rows`` and queried 100 times over RPC, its ``ann.*`` status
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
   with its phases, the master's fallback count 0;
17. sharded checkpoints and the forensics plane: AROW at phase 15's shape
   (D = 2^24, capacity 8) on 4 logical shards of cuda:0 after two
   train_hashed steps of phase 8's batch, ``save_sharded`` (dcp) timed and
   split into staging, write and sidecar with its bytes on disk, restored
   at 4, 2 and 1 shards (every field ``torch.equal`` to the source), read
   back with ``checkpoint_metadata`` and ``jubadump -i``, beside
   ``save_model`` / ``load_model`` of the same state; then servers started
   with ``-c 2 --metrics-port 0 --telemetry-interval 1 --profile-dir``: two
   nearest_neighbor lsh.json (the stack sampler at 67 Hz and off, each
   with 2,500 set_row; query p50/p99 in turns) and a regression
   default.json; ``profile_device`` once on each (a process's first
   capture; ``--forensics-ab`` takes a later one too), under a querying
   (training) client
   must name K1 (S1) in its artifact, no more often than the server's
   launch count rose, its wall split into start / window / stop / export,
   and ``get_status`` must answer while it is in flight (a capture holds
   no RPC worker); each server's ``runtime.torch_device_bytes_in_use``,
   /metrics (``rpc.<method>`` buckets, runtime gauges), /healthz, slow log
   and folded profile; the telemetry sample's cost in this process;
18. the server planes, seven server processes started at once with ``-l
   <dir> -t 30`` (each must write ``<dir>/juba<engine>.log``): three
   ``arow.json`` servers, one an arm each (the defaults;
   ``--quality-sample 1.0``; every plane off), trained by two clients
   (principals ``tenant-a`` and ``tenant-b``, 10^4 rows each in calls of
   256, the label mix and the feature scale shifted after half), after a
   warm-up of SP_WARMUP_ROWS rows a server, the arms in order, reversed
   and in order again (median rows/s); ``get_quality``'s prequential
   accuracy and drift, ``get_usage``'s rows per tenant (equal to what
   each sent); the drift drill on a fourth ``arow.json`` server, not
   timed (SP_DRILL: every batch scored, 2 s quality windows, a 1 s
   telemetry tick, ``--slo drift=gauge:quality.drift.max:0.1``): the same
   stream, the drift SLO firing in ``get_alerts`` and one bundle in
   ``get_incidents``; a regression ``default.json`` server under ``--quality-sample 1.0`` (10^4
   rows in calls of 256, S1), its prequential MAE against a CPU driver
   replaying the same test-then-train (SP_MAE_RTOL); two ``lsh.json``
   servers whose converter splits a text key with the ``ux_splitter``
   plugin (its dictionary written here), one with ``--fv-cache-size 0``:
   5,000 set_row each (both filled at once), then 200 queries each in turn
   (p50/p99, K1 launches +200), the
   answers of both against the CPU port's driver, the memo caches' hit
   rate; then the usage ledger's billed "device seconds" beside the
   CUDA-event time of the same flushes (an ``arow.json`` server in this
   process);
19. the control loops and the legacy wire: (a) two regression
   ``default.json`` servers in this process, ``--auto-tune on`` and
   ``--auto-tune observe`` with ``--telemetry-interval 1``, fed one
   client's stream of phase 9's rows in calls of 256 in bursts and
   pauses: the ``on`` server's coalescer depth moves and ``get_tune``
   journals it, the ``observe`` server's stays and its journal holds the
   dry-run intents, S1 launches on both, 200 ``estimate`` answers agree
   across the two, and each tuner tick is timed on the host; (b) two
   ``arow.json`` members under ``--mixer collective_mixer`` as the two
   gloo ranks of one world on cuda:0 (beside (a)), the master's PerfTuner
   ticked by
   hand (cooldown 0) between rounds: each plan change costs exactly one
   ``prepare_not_viable`` RPC-fallback round (the peer takes the plan a
   round later), and the members are bit-equal after the last round;
   (c) on phase 13's fleet (its members tick their telemetry every
   second), ``jubactl -c autoscale`` as a process against the regression
   members while 8 clients train through the proxy (``--queue-hot`` set
   from a short burst, ``--cooldown 20``: above a member's boot): the
   visor spawns a third member on the card (it holds /dev/nvidia* nodes),
   which answers through the proxy; the load stops and the loop drains a
   member; no client error, one scale-out
   and one scale-in in the journal, one ``--watch`` frame; (d) one
   ``lsh.json`` server and a proxy started with ``--legacy-wire``:
   pre-2013 clients (old-format requests, the port's ``legacy.unpackb``)
   direct and through the proxy get answers equal to a modern client's,
   a modern client on the detecting server stays modern, K1 launches,
   and legacy against modern ``neighbor_row_from_datum`` p50;
20. ZooKeeper sessions and the ring scan: (ring) on
   ``ShardMesh(["cuda:0"] * 4)``, ``ring_hamming_topk`` at C = 2^20
   rows (hash_num 64, W = 2), B = 1,024, k = 10: S² = 16 K1 launches a
   call, its distances and ids equal to the flat K1 scan's under the
   ring's tie rule (visit step, then slot) and its distances to
   ``sharded_hamming_topk``'s (ids below the k-th distance equal across
   the three); ``ring_euclid_topk`` at C = 2^16 (nnz 32), a dense query
   width of 2^16 and B = 256 within RING_EUCLID_TOL of the flat euclid
   scan; ``assign_cells_hier`` against ``assign_cells`` at 2^20 rows and
   1,024 cells (agreement above 0.9), each timed by the median of 10
   CUDA-event timings against its flat counterpart; (zk_fleet, booted
   while the ring runs) on one ``zk://`` locator (the ensemble
   ``JUBATUS_TPU_ZK`` names, else tests/fake_zk.py's FakeZkServer in this
   process), two nearest_neighbor ``lsh.json`` and two regression
   ``default.json`` members and a port proxy per engine: through the
   proxies with the port's typed clients 1,000 ``set_row`` and 200
   ``neighbor_row_from_datum`` (K1), 2,000 regression rows in calls of
   256 (S1); one ``do_mix`` of the regression pair, the two saved models
   equal; ``jubactl -c status -z zk://...``; a client emitted by the
   port's codegen answering ``get_status``; then SIGTERM to one NN member:
   it leaves the actives within the 10 s session timeout and 50 more
   queries through the proxy are each answered by the survivor (its K1
   count rises by 50); p50/p99 through the proxies and the leave time.
21. the raw-wire ingest (path ``raw_ingest``): for each of arow.json (a
   fixed 16-key schema: the schema plan), arow_combinational_feature.json's
   rules with bin weights (the shipped file weighs strings by idf, which
   the native parser declines with combinations: the combo device plan),
   regression pa.json (phase 9's rows: S1) and a pure-idf classifier (the
   deferred idf), two servers in this process on the card, one on the
   raw path and one with ``JUBATUS_TPU_NATIVE_INGEST=0``, each fed
   4,096 rows in calls of 256 from 4 clients, then ``clear`` and 4,096
   more from 1 client (each call one flush); ``train_raw`` must count
   every row, the plan's ``ingest.*`` counter must move, the raw server's
   64 probe answers must equal the decoded server's and a CPU driver's
   fed the parser's arrays of the same calls, and so must its model,
   within phase 9's tolerance; train rows/s of both paths, and a call's
   parse, the flush's merge and its device stage (host wall and CUDA
   events) against the decoded path's featurize.
22. the native transport (path ``native_transport``): two regression
   ``default.json`` server processes on the card, started at once, one
   on the native transport and one with ``JUBATUS_TPU_NATIVE_RPC=0``, each
   fed 4,096 rows from 1 client (a call of 256 at a time) and 4,096 from
   4 clients that pipeline their calls, every call's features disjoint
   in the hashed space, then 200 ``estimate``: rows/s, p50/p99 a call, S1
   launches from each server's get_status, and the two saved models
   equal bit for bit (else within LINEAR_TOL, and the line says so).

Phases 3-7 and 8-22 are the main path: each
path's launch counts are set to 0 just before it and read just after (a server's from its get_status); launches
made only to compare with the plain version or to time a kernel are not
counted. The last lines are a ``{"kernels": ...}`` JSON line (with the
launches per path), the nvidia-smi line, and ``{"ok": true, "device":
...}``. The sizes are fixed; ``--seed`` picks the random data.

``python3 chip_smoke.py --forensics-ab N [--parent DIR]`` drives none of
the main path and prints no result line: it measures what the forensics
plane and the server planes cost the servers. After the build it runs, N
rounds over, phase 9's two linear servers and phase 13's fleet under each
arm of AB_ARMS (the servers' defaults; the stack sampler off; the sampler
and the runtime telemetry off; the quality, usage, time-series and event
planes off) and, with ``--parent``, the same two phases of the checkout
in DIR (its own chip_smoke.py, in a process of its own), the arms in
order in even rounds and reversed in odd ones. One ``[forensics_ab]``
line per arm and round, then the medians by arm; then phase 17's servers
with two device captures each (the first capture of a process against a
later one).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import shutil
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
NN_SERVER_ROWS = 2_500        # phase 4's set_row fill (cut from 10^4 for
                              # the run's limit: phase 17 fills two servers
                              # of its config with 10^4 rows and times
                              # queries on each)
REC_ROWS = 250_000            # rows of the exact recommender (phase 5; cut
                              # from 10^6 to keep the run inside its time
                              # limit; phase 14 builds IVF over it)
REC_HASH_ROWS = 62_500        # rows of the lsh and minhash recommenders:
                              # their scan and signature repeat phase 3's
                              # at 10^6 rows (cut from 1.25·10^5)
REC_QUERIES = 50              # timed similar_row / complete_row calls each
REC_PROFILED = 10             # further similar_row calls under the profiler
REC_CONFIGS = ("lsh.json", "minhash.json", "default.json")
LOF_ROWS = 4096               # lof_unlearner_lru.json's max_size
LOF_ADDS = 2                  # each add rebuilds the support, whose cold
                              # rebuild the phase times and splits
LOF_SCORES = 50
LOF_METHODS = ("euclid_lsh", "lsh", "minhash")
ANOMALY_SERVER_ROWS = 100     # adds over the wire (each rebuilds the
                              # support; cut from 200 for the run's limit:
                              # phases 11 and 13 make 50 adds each)
SERVER7_ROWS = 2_500          # phase 7's recommender update_row calls and
#                               nn.json examples (cut from 10^4: phase 11
#                               writes 2,000 rows to servers of both
#                               configs, phase 9 10^4 to its own)
CLASSIFIER_NN_METHODS = ("euclid_lsh", "lsh")  # phase 7's nn.json servers
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


FILL_STEP = 50_000             # rows drawn per random_rows call of a fill


def fill_arrays(rows: int, seed: int, nnz: int = 32, dim_bits: int = 18):
    """The rows ``fill_rows`` writes: (idx [rows, nnz], val [rows, nnz]),
    drawn FILL_STEP rows at a time; the same seed gives the same rows."""
    rng = np.random.default_rng(seed)
    parts = [random_rows(rng, min(FILL_STEP, rows - lo), nnz, dim_bits)
             for lo in range(0, rows, FILL_STEP)]
    if not parts:
        return (np.zeros((0, nnz), np.int32), np.zeros((0, nnz), np.float32))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def fill_rows(be, rows: int, seed: int, nnz: int = 32,
              dim_bits: int = 18) -> None:
    """``rows`` random rows (``nnz`` hashed features over 2^dim_bits) into a
    backend through ``set_row``, row ``i`` under the id ``r<i>``: the
    per-row fill that ``bulk_fill`` is held equal to."""
    idx, val = fill_arrays(rows, seed, nnz, dim_bits)
    for i, (ii, vv) in enumerate(zip(idx.tolist(), val.tolist())):
        be.set_row(f"r{i}", list(zip(ii, vv)))


def bulk_fill(be, rows: int, seed: int, nnz: int = 32,
              dim_bits: int = 18) -> None:
    """``fill_rows``' rows written into an empty backend's row arenas in one
    assignment per array, leaving the state ``set_row`` leaves: the
    arenas' capacity and width, ids and slots, the live mask, the LRU
    clock, the rows written since the last mix, a version bump and (where
    the backend keeps signatures) every row pending for one flush. The set-up
    of phases 3 and 5; tests/test_torch_smoke_fill.py holds it equal to
    ``fill_rows``."""
    from jubatus_tpu_torch.core import row_store

    st = be.store
    check(type(st) is row_store.RowStore and len(st) == 0
          and st.max_size is None,
          "bulk_fill needs an empty, unbounded flat row store")
    if rows == 0:                       # set_row never runs: nothing moves
        return
    idx, val = fill_arrays(rows, seed, nnz, dim_bits)
    cap = row_store._pow2_at_least(rows, st.capacity)
    width = (st.width if nnz <= st.width
             else row_store._pow2_at_least(nnz, st.width * 2))
    st.capacity, st.width = cap, width
    st.idx = np.zeros((cap, width), np.int32)
    st.val = np.zeros((cap, width), np.float32)
    st.live = np.zeros(cap, bool)
    st.idx[:rows, :nnz] = idx
    st.val[:rows, :nnz] = val
    st.live[:rows] = True
    ids = [f"r{i}" for i in range(rows)]
    st.ids = ids
    st.slots = dict(zip(ids, range(rows)))
    st._clock = rows
    st._touch = dict(zip(ids, range(1, rows + 1)))
    st.updated_since_mix = dict.fromkeys(ids)
    st.version = next(row_store._STAMPS)
    if be._sigs is not None:
        be._pending = dict.fromkeys(ids)


def phase_backend(torch, sig_scan, knn, NNBackend, SparseBatch, method: str,
                  seed: int, keep: dict) -> dict:
    """``keep[method]`` gets (backend, queries, answers) for phase 14."""
    rows, queries = ROWS, QUERIES
    dim_bits, nnz, k = 18, 32, 10
    be = NNBackend(method, dim=1 << dim_bits, hash_num=64, seed=0,
                   device="cuda")
    t0 = time.perf_counter()
    bulk_fill(be, rows, seed, nnz, dim_bits)
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
    for e in prof.function_events:
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
    same calls unprofiled; the profiled wall time is reported beside it.
    The capture is ``torch.autograd.profiler``'s kineto one
    (``kineto_profile``): ``torch.profiler.profile`` would import
    ``torch._inductor`` on its first use, seconds of the run."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function

    from jubatus_tpu_torch.utils.profiler import kineto_profile

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
        with kineto_profile(cuda=True) as prof:
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
    dev = [e for e in prof.function_events
           if e.device_type == DeviceType.CUDA
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


def free_port_block(n: int) -> int:
    """A port p with p .. p + n all free and below the ephemeral range
    (/proc/sys/net/ipv4/ip_local_port_range), so that no connection's
    local port can take one of them later: jubavisor hands p + 1 .. p + n
    to the servers it spawns, late ones (an autoscaler's) included."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])

    def free(port: int) -> bool:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("0.0.0.0", port))
            except OSError:
                return False
        return True

    for base in range(low - 2 * (n + 1), 1024, -(n + 1)):
        if all(free(p) for p in range(base, base + n + 1)):
            return base
    raise SmokeError(f"no block of {n + 1} free ports below {low}")


def server_datum(rng, Datum, i: int):
    d = Datum()
    for j in rng.choice(64, 8, replace=False):
        d.add(f"f{j}", float(np.round(rng.standard_normal(), 3)))
    d.add("city", f"c{int(rng.integers(40))}")
    d.add("kind", f"k{i % 7}")
    return d


def server_datadir(name: str) -> str:
    """An empty datadir under OUT_DIR for one server, so that nothing a
    server writes (incident bundles, device captures) lands outside the
    checkout or meets an earlier run's files."""
    return fleet_dir(os.path.join("data", name))


def start_server(engine: str, config_path: str, tag: str = "",
                 extra=(), env=None):
    """Start ``python -m jubatus_tpu_torch.server <engine> -f <config>``
    (and the flags in ``extra``, the variables in ``env``) on the card;
    returns (process, port, log path) without waiting for it. Unless
    ``extra`` names a ``-d``, the server's datadir (where its incident
    bundles and captures go) is an empty directory of its own under
    OUT_DIR."""
    port = free_port()
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, f"chip_smoke_server_{engine}{tag}.log")
    if "-d" not in extra and "--datadir" not in extra:
        extra = ("-d", server_datadir(f"{engine}{tag}_{port}"), *extra)
    cmd = [sys.executable, "-m", "jubatus_tpu_torch.server", engine,
           "-f", config_path, "-p", str(port), "-b", "127.0.0.1", "-c", "4",
           "--device", "cuda", *extra]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=logf,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, **env) if env else None)
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
    started = started or start_server(engine, config_path)
    proc, port, log_path = started
    from jubatus_tpu_torch.rpc.client import RpcClient

    cli = RpcClient("127.0.0.1", port, timeout=120.0)
    try:
        await_answer(engine, started, cli)
        yield cli
    except Exception:
        print_server_log(log_path)
        raise
    finally:
        cli.close()
        stop_server(proc)


def await_answer(engine: str, started, cli) -> None:
    """Wait until the server ``started`` (start_server's tuple) answers
    ``get_status`` on ``cli``; fails if it exits or takes 180 s."""
    proc, _, log_path = started
    deadline = time.time() + 180
    while True:
        check(proc.poll() is None,
              f"{engine} server exited with {proc.returncode}; see "
              f"{log_path}")
        try:
            cli.call("get_status", "smoke")
            return
        except Exception:  # broad-ok — the server is still starting
            check(time.time() < deadline,
                  f"{engine} server did not answer in 180 s")
            time.sleep(0.5)


def await_started(started: dict) -> None:
    """Wait until every server of ``started`` ({tag: start_server's
    tuple}, started at once) answers, so that none is driven while
    another still boots."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    for tag, st in started.items():
        cli = RpcClient("127.0.0.1", st[1], timeout=120.0)
        try:
            await_answer(tag, st, cli)
        except Exception:
            print_server_log(st[2])
            raise
        finally:
            cli.close()


def print_server_log(log_path: str) -> None:
    with open(log_path) as f:
        tail = f.read()[-4000:]
    print(f"--- server log ({log_path}), last lines:\n{tail}",
          file=sys.stderr)


def with_gauges(cli, st: dict) -> dict:
    """A member's status map with its registry gauges (``mix.*``,
    ``ann.*``, ``shard.*``, served by get_metrics, as the JAX server
    serves them) folded in under their own names."""
    (snap,) = cli.call("get_metrics", "smoke").values()
    for k, v in (snap.get("gauges") or {}).items():
        st.setdefault(k, v)
    return st


def server_status(cli) -> dict:
    st = next(iter(cli.call("get_status", "smoke").values()))
    check(st.get("driver.device", "").startswith("cuda"),
          f"server runs on {st.get('driver.device')!r}, not the card")
    return with_gauges(cli, st)


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
                             NN_SERVER_ROWS, seed)


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
    rows = REC_ROWS if exact else REC_HASH_ROWS
    t0 = time.perf_counter()
    bulk_fill(be, rows, seed)
    t_load = time.perf_counter() - t0
    # the write path: signatures of every row (hash methods) or the
    # arenas' upload (the exact methods' device_view)
    t0 = time.perf_counter()
    signed = be.flush()
    if exact:
        view = be.store.device_view(be.device)
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    check(signed == (0 if exact else rows),
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
               rows=rows, queries=REC_QUERIES, load_s=t_load,
               flush_s=t_flush, flush_rows_per_s=rows / t_flush,
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


def phase_recommender_server(Datum, RecommenderDriver, seed: int,
                             started) -> dict:
    """config/recommender/default.json (inverted_index, cosine),
    SERVER7_ROWS update_row calls; every query method against the CPU
    driver.
    complete_row averages the 128 nearest rows: its values are compared
    where the CPU's 128th and 129th distances differ by more than
    ``EXACT_TOL`` (else the rows at the boundary may differ by a tie).
    ``started``: the server, started by ``start_phase7_servers``."""
    path = os.path.join(ROOT, "config", "recommender", "default.json")
    config = load_config("recommender", "default.json")
    ref = RecommenderDriver(config, device="cpu")
    rng = np.random.default_rng(seed + 11)
    with serving("recommender", path, started) as cli:
        t0 = time.perf_counter()
        for i in range(SERVER7_ROWS):
            d = server_datum(rng, Datum, i)
            check(cli.call("update_row", "smoke", f"u{i}", d) is True,
                  "update_row failed")
            ref.update_row(f"u{i}", d)
        t_set = time.perf_counter() - t0
        lat, compared, skipped = [], 0, 0
        for i in range(20):
            q = server_datum(rng, Datum, SERVER7_ROWS + i)
            rid = f"u{int(rng.integers(SERVER7_ROWS))}"
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
                rows=SERVER7_ROWS, update_row_s=t_set, query=pcts(lat),
                parity=dict(similar_row_abs_tol=EXACT_TOL,
                            complete_compared=compared,
                            complete_tied=skipped),
                launches=server_launches(st))


def anomaly_server_config():
    """(config, path) of phase 7's anomaly server."""
    config = lof_config("lsh")
    return config, write_config("anomaly_lof_lsh.json", config)


def phase_anomaly_server(Datum, AnomalyDriver, seed: int,
                         started) -> dict:
    """LOF over nested lsh (lof_unlearner_lru.json's settings), fed through
    ``add``: every add rebuilds the support (per store version), so the
    whole fill costs ~n^3 host work and runs at ANOMALY_SERVER_ROWS, not
    10^4. Scores must equal the CPU driver's bit for bit. ``started``: the
    server, started by ``start_phase7_servers``."""
    config, path = anomaly_server_config()
    ref = AnomalyDriver(config, device="cpu")
    rng = np.random.default_rng(seed + 13)
    with serving("anomaly", path, started) as cli:
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


def classifier_server_config(nn_method: str):
    """(config, path) of phase 7's NN classifier server over ``nn_method``."""
    config = load_config("classifier", "nn.json")
    if nn_method == config["parameter"]["method"]:
        return config, os.path.join(ROOT, "config", "classifier", "nn.json")
    config["parameter"]["method"] = nn_method
    return config, write_config(f"classifier_nn_{nn_method}.json", config)


def start_phase7_servers(out: dict) -> None:
    """Phase 7's four servers, started at once into ``out`` ({tag:
    start_server's tuple}); returns once all of them answer, so their
    boots overlap and each is driven alone afterwards."""
    out["recommender"] = start_server(
        "recommender", os.path.join(ROOT, "config", "recommender",
                                    "default.json"))
    out["anomaly"] = start_server("anomaly", anomaly_server_config()[1])
    for m in CLASSIFIER_NN_METHODS:
        out[f"classifier_{m}"] = start_server(
            "classifier", classifier_server_config(m)[1], tag=f"_{m}")
    await_started(out)


def phase_classifier_server(Datum, ClassifierNNDriver, nn_method: str,
                            seed: int, started) -> dict:
    """config/classifier/nn.json (k = 128), its nested method as shipped
    (euclid_lsh) or lsh; SERVER7_ROWS examples through ``train``. Tie
    rule: where
    the CPU's k-th and (k+1)-th distances differ (by more than
    ``EXACT_TOL`` for euclid_lsh), the per-label scores are compared;
    where they tie, the scores' sum over the labels, which depends only on
    the k nearest distances. ``started``: the server, started by
    ``start_phase7_servers``."""
    config, path = classifier_server_config(nn_method)
    exact = nn_method in ("lsh", "minhash")
    rtol = 1e-9 if exact else 1e-4
    gap = 0.0 if exact else EXACT_TOL
    ref = ClassifierNNDriver(config, device="cpu")
    rng = np.random.default_rng(seed + 17)
    with serving("classifier", path, started) as cli:
        t0 = time.perf_counter()
        for lo in range(0, SERVER7_ROWS, 200):
            batch = [[f"l{int(rng.integers(5))}", server_datum(rng, Datum, i)]
                     for i in range(lo, min(lo + 200, SERVER7_ROWS))]
            check(cli.call("train", "smoke", batch) == len(batch),
                  "train failed")
            ref.train([(lab, d) for lab, d in batch])
        t_train = time.perf_counter() - t0
        check(cli.call("get_labels", "smoke") == ref.get_labels(),
              "get_labels differs")
        st0 = server_status(cli)
        queries = [server_datum(rng, Datum, SERVER7_ROWS + i)
                   for i in range(20)]
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
                f"nested {nn_method}", rows=SERVER7_ROWS, train_s=t_train,
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
#: phase 11's save/load split and in-process mix round: at 2^24 they do
#: not fit the run's time limit (phase 17 times save_model / load_model of
#: AROW at 2^24 as wholes; no phase times the save split or a
#: linear_mixer round at 2^24 now)
WIDTH_DIM_BITS = (20,)
#: phase 12's int8 store chain: at 2^24 it repeats the off chain's
#: readback and write with a quantize more (its codec is timed at 2^20)
STORE_INT8_DIM_BITS = (20,)
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
                        seed: int, extra=(), started=None) -> dict:
    """config/<engine>/<config_name> on the card. First SERVER_ROWS rows
    in LINEAR_BATCH-row train calls from LINEAR_THREADS clients at once
    (the coalescer merges them; each call must return its own count); then
    ``clear`` and the same rows from one client, so each call is one flush
    and a CPU driver fed the same batches holds the same model; then
    LINEAR_QUERIES classify / estimate calls against it. ``extra``: more
    server flags; ``started``: the server, already started with them."""
    path = os.path.join(ROOT, "config", engine, config_name)
    config = load_config(engine, config_name)
    ref = Driver(config, device="cpu")
    rng = np.random.default_rng(seed + 41)
    rows = [linear_example(rng, Datum, engine, i) for i in range(SERVER_ROWS)]
    batches = [rows[lo:lo + LINEAR_BATCH]
               for lo in range(0, SERVER_ROWS, LINEAR_BATCH)]
    query = "classify" if engine == "classifier" else "estimate"
    from jubatus_tpu_torch.rpc.client import RpcClient

    with serving(engine, path, started or start_server(
            engine, path, extra=extra)) as cli:
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
        # arow.json and default.json are converters the native parser
        # expresses: the calls take the raw-wire path and its coalescer
        flushes = (st1["microbatch.train_raw.flush_count"]
                   - st0.get("microbatch.train_raw.flush_count", 0))
        check(st1["microbatch.train_raw.item_count"] == SERVER_ROWS,
              f"{engine}: {st1['microbatch.train_raw.item_count']} examples "
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
    from jubatus_tpu_torch.server.args import ServerArgs

    started = {e: start_server(e, os.path.join(ROOT, "config", e,
                                               "default.json"))
               for e in NEW_ENGINES}
    out = {}
    try:
        for engine in NEW_ENGINES:
            rng = np.random.default_rng(seed + 81)
            calls = rpc_session(engine, rng, Datum)
            twin_args = ServerArgs(engine=engine,
                                   datadir=server_datadir(f"{engine}_twin"))
            twin = EngineServer(engine, load_config(engine, "default.json"),
                                twin_args, device="cpu")
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
SL_LOF_ROWS = 50              # anomaly adds (each rebuilds the support;
                              # cut from 200: the adds set the saved model
                              # up, and phase 7 times 200 of them)
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
        for i in range(2):
            srv = EngineServer(engine, load_config(engine, name), ServerArgs(
                engine=engine, coordinator="(memory)", name="fleet",
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30,
                datadir=server_datadir(f"cpu_fleet_{engine}_{i}")),
                device="cpu",
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
PUSH_ROWS = 1_500             # arow.json rows, a third per member (cut
                              # from 3,000 for the run's limit: phases 11
                              # and 16 train such fleets too)
ASYNC_ROWS = 2_000            # arow.json rows, half per member
ASYNC_STREAM_STEPS = 4        # train + do_mix on each member, in turns
ELASTIC_ROWS = 31_250         # cut from phase 3's 10^6, then 62,500, to keep
                              # the run inside its limit (phase 13 fills
                              # and drains 3.125·10^4 a member)
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
    for i in range(n):
        args = {"datadir": server_datadir(f"cpu_members_{engine}_{i}"),
                **args}
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
    with ``--store-compress`` off and, at STORE_INT8_DIM_BITS, int8 (time,
    bytes); the off chain's
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
           for mode in (("off", "int8") if dim_bits in STORE_INT8_DIM_BITS
                        else ("off",))}

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
    if "int8" in ups:
        (blob, meta), ms = timed(lambda: store.materialize(node="n_int8"))
        check(meta["chain_len"] == 1, "the int8 chain did not replay")
        got = unpack_obj(read_envelope(blob, "int8")[1])[1]
        scale = float(np.abs(want["w"]).max())
        err = float(np.abs(np.asarray(got["w"]) - want["w"]).max())
        check(err <= scale / 127.0,
              f"int8 replay off by {err} (scale {scale})")
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


def same_up_to_alignment(after, before):
    """Whether a member's classify answers ``after`` (one list of [label,
    score] pairs per datum of each query) equal ``before``: False when
    they equal them pair for pair, True when only the labels' order
    differs and it is the sorted one (a mix round's schema alignment),
    None otherwise. Scores are compared exactly."""
    if after == before:
        return False
    if len(after) != len(before):
        return None
    for got, want in zip(after, before):
        if len(got) != len(want):
            return None
        for g, w in zip(got, want):
            if [lab for lab, _ in g] != sorted(lab for lab, _ in w) or \
                    sorted(map(tuple, g)) != sorted(map(tuple, w)):
                return None
    return True


def phase_quarantine(Datum, seed: int) -> dict:
    """Two arow.json servers (each its own process) on ``-x
    broadcast_mixer --mix-guard quarantine --model-snapshot-interval 1``,
    the second armed with ``--fault mix.diff.poison*:nan``. Both train;
    once each has snapshotted the trained model, the poisoned member's
    round folds its NaN diff into the exchange's total: both members
    refuse it and roll back, and answer as before the round: every
    label's score bit-equal. The member that runs the round takes no
    snapshot inside it (the tick waits out the round's lock); a member
    whose slots a peer's round aligned (``sync_schema``: the sorted
    union's order) may snapshot the same model so aligned, and its
    labels then come back in the sorted order, and in no other
    (``same_up_to_alignment``)."""
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
        aligned = [same_up_to_alignment(a, b) for a, b in zip(after, before)]
        for k, (a, b) in enumerate(zip(after, before)):
            if aligned[k] is None:  # what differed, for the log
                i = next((i for i, (x, y) in enumerate(zip(a, b))
                          if x != y), None)
                print(f"[quarantine] member {k} answers otherwise: query "
                      f"{i}, before {b[i] if i is not None else b} after "
                      f"{a[i] if i is not None else a}; snapshots "
                      f"{sts[k]['snapshot.taken']}", file=sys.stderr)
        check(all(k is not None for k in aligned),
              "a rolled-back member answers otherwise")
    return dict(rows=QUARANTINE_ROWS, round_ms=round_ms,
                members=[dict(rollbacks=st["rollback.count"],
                              restored_aligned=k,
                              snapshots_taken=st["snapshot.taken"],
                              snapshot_bytes=st["snapshot.bytes"],
                              snapshot_lock_ms=st.get(
                                  "trace.snapshot.lock.max_ms"),
                              refused=st.get(
                                  "trace.counter.mix.guard.nonfinite_total"))
                         for st, k in zip(sts, aligned)])


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 13: the fleet — jubacoordd, jubaconfig, jubavisor, jubactl and one
# routing proxy per engine, every member on the card; then the fleet's views
# ---------------------------------------------------------------------------
FLEET_NN_ROWS = 31_250        # put_rows per NN member (cut from 5·10^5,
                              # then 2.5·10^5 and 1.25·10^5, for the run's
                              # limit: phase 12 times the same put_rows
                              # fill, pull and drain)
FLEET_NN_FILL = 20_000        # rows per put_rows call
FLEET_SETS = 2_000            # set_row calls through the proxy
FLEET_QUERIES = 100           # each NN query method through the proxy
                              # (cut from 200 for the run's limit: phase
                              # 20 times 200 + 50 through its proxy)
FLEET_ADDS = 50               # anomaly adds through the proxy (cut from
                              # 200: phase 7 times 100 adds of the same
                              # config over the wire)
FLEET_SCORES = 20             # calc_score through the proxy
FLEET_TRAIN = 10_000          # regression rows through the proxy
FLEET_ESTIMATES = 50
FLEET_WAIT_S = 300            # longest wait for a fleet, a drain, a stop
FLEET_ENGINES = (("nearest_neighbor", "fleet_nn"), ("anomaly", "fleet_lof"),
                 ("regression", "fleet_reg"))
#: phase 13's proxies: (key, engine, cluster, on the native transport).
#: The default proxies serve on the native transport, whose C++ relay
#: forwards random-routed calls without entering Python. The NN proxy on
#: the Python transport carries the SLO, the incident bundle and the traced
#: query (a relayed query leaves no dispatch span at the proxy), and the
#: regression one the autoscaler drill's light client: an effectful call
#: the C++ relay hands to a draining member is refused there (NodeDraining)
#: and the refusal goes to the client as it is, where the Python path
#: re-routes it
FLEET_PROXIES = (("nearest_neighbor", "nearest_neighbor", "fleet_nn", True),
                 ("nearest_neighbor_py", "nearest_neighbor", "fleet_nn",
                  False),
                 ("anomaly", "anomaly", "fleet_lof", True),
                 ("regression", "regression", "fleet_reg", True),
                 ("regression_py", "regression", "fleet_reg", False))
#: proxy key -> its cluster name
FLEET_PROXY_NAME = {key: name for key, _, name, _ in FLEET_PROXIES}
FLEET_RELAY_WAIT_S = 30       # longest wait for the C++ relay to engage
#: the Python-transport NN proxy's SLO: every proxied NN query's dispatch
#: exceeds 50 µs, so it burns from the first tick that sees one (the
#: windows are short and the incident window long: one bundle for the
#: phase)
FLEET_SLO = "latency:rpc.neighbor_row_from_datum:p99:0.05"
FLEET_VIEW_QUERIES = 20       # proxied NN queries just before the views
FLEET_FORENSICS_REPS = 5      # timed calls of each forensics RPC
#: the forensics RPCs a proxy folds: method -> its arguments after the name
FLEET_FORENSICS = (("get_spans", ("",)), ("get_slow_log", ()),
                   ("get_timeseries", ()), ("get_alerts", ()),
                   ("get_quality", ()), ("get_usage", ()),
                   ("get_profile", (60.0,)), ("get_events", (0, "")),
                   ("get_incidents", ("",)))


def cuda_device_fds(pid: int) -> list:
    """The /dev/nvidia* nodes that process ``pid`` holds open (from /proc).
    Once a process has initialised the CUDA driver (a context, or no more
    than ``torch.cuda.is_available()``) it holds /dev/nvidiactl and its
    card's node; ``import torch`` opens none, though it maps libcuda."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:  # closed since the listing
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def rss_split_mb(pid: int) -> dict:
    """Process ``pid``'s resident set in MiB (/proc/<pid>/smaps): in mapped
    files (the shared libraries) and in the rest (heap, anonymous)."""
    files = other = 0
    name = ""
    with open(f"/proc/{pid}/smaps") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if not parts[0].endswith(":"):  # a mapping's header line
                name = parts[5] if len(parts) > 5 else ""
            elif parts[0] == "Rss:":
                if name.startswith("/"):
                    files += int(parts[1])
                else:
                    other += int(parts[1])
    return dict(files=round(files / 1024, 1), other=round(other / 1024, 1))


def spawn(tag: str, *argv, env=None):
    """``python -m <argv>`` from the repo root (with the variables in
    ``env``), its output to a log file under OUT_DIR; returns (process,
    log path)."""
    log_path = os.path.join(OUT_DIR, f"chip_smoke_{tag}.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                stdout=logf, stderr=subprocess.STDOUT,
                                env=dict(os.environ, **env) if env else None)
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


def relayed_query(cli, name: str, dat) -> bool:
    """One neighbor_row_from_datum through the proxy ``cli``: whether the
    C++ relay forwarded it (the proxy's relay_count moved)."""
    (before,) = cli.call("get_proxy_status", name).values()
    cli.call("neighbor_row_from_datum", name, dat, 10)
    (after,) = cli.call("get_proxy_status", name).values()
    return after["relay_count"] > before["relay_count"]


def relay_moved(before: dict, after: dict, methods) -> dict:
    """What a proxy's C++ relay forwarded between two of its status maps:
    ``relay_count``, and per method the requests counted less those the
    Python path served (each leaves a dispatch span there); their sum
    must be the relay count."""
    out = {"relay_count": after["relay_count"] - before["relay_count"]}
    for m in methods:
        out[m] = (after.get(f"request.{m}", 0) - before.get(f"request.{m}", 0)
                  - after.get(f"trace.rpc.{m}.count", 0)
                  + before.get(f"trace.rpc.{m}.count", 0))
    check(sum(out[m] for m in methods) == out["relay_count"],
          f"the relay's per-method counts {out} do not add up")
    return out


def phase_fleet(Datum, seed: int, member_flags: str = "",
                autoscale: bool = False) -> dict:
    """A port ``jubacoordd`` (``--journal``), three configs written with
    ``jubaconfig`` (nearest_neighbor lsh.json, the LOF config of phase 6
    over lsh, regression default.json), one ``jubavisor`` on the card,
    ``jubactl -c start -N 2`` per engine and the proxies of
    FLEET_PROXIES, every one its own process. nearest_neighbor: each
    member filled with FLEET_NN_ROWS rows on their CHT(1) owner by
    ``put_rows``, FLEET_SETS ``set_row`` through the proxy, then, once its
    C++ relay has engaged, FLEET_QUERIES of each query method through the
    relay, through the Python-transport proxy and directly to both members
    (each proxied answer equal to one member's; the relay's counts by
    method). anomaly: FLEET_ADDS ``add`` through the proxy,
    each id held by both CHT(2) owners, then ``calc_score``. regression:
    FLEET_TRAIN rows in calls of LINEAR_BATCH through the proxy, then
    ``estimate``. The broadcasts (``get_status`` merge, ``save`` merge,
    ``clear`` all_and), the views (``fleet_views``), then ``jubactl -c
    drain`` of one NN member under a writer through the proxy and a
    reader through its C++ relay (no client error, every row handed off),
    ``rebalance``, ``rollback``, ``status --all``, ``watch --once`` and
    ``stop``: the visor is left with no children. ``member_flags``: more
    server flags for every member (the visor's ``--server-flags``).
    ``autoscale``: phase 19's autoscaler drill (``fleet_autoscale``) on
    the regression members, once phase 13's own counts are read and
    before the stop; its result is ``autoscale``."""
    import threading

    from jubatus_tpu_torch.cmd import jubaconfig, jubactl
    from jubatus_tpu_torch.coord import membership
    from jubatus_tpu_torch.coord.cht import CHT
    from jubatus_tpu_torch.coord.remote import RemoteCoordinator
    from jubatus_tpu_torch.rpc.client import RpcClient

    d = fleet_dir("fleet13")
    cport, vport = free_port(), free_port_block(8)
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
                      "--device", "cuda",
                      *(("--server-flags", member_flags) if member_flags
                        else ()))
        procs.append(visor)
        wait_for(lambda: view.list(membership.SUPERVISOR_BASE),
                 "the visor never registered", FLEET_WAIT_S)
        for engine, name in FLEET_ENGINES:
            rc, text = ctl(jubactl, "-c", "start", "-t", engine, "-n", name,
                           "-N", "2", "-z", locator, "-B", "127.0.0.1",
                           "-C", "4", "-D", d, "-S", str(10 ** 9),
                           "-I", str(1 << 30))
            check(rc == 0, f"jubactl start {engine}: {text}")
        proxies, proxy_pids = {}, {}
        for key, engine, name, native_rpc in FLEET_PROXIES:
            pport = free_port()
            planes = ["--telemetry-interval", "1", "--metrics-port", "0",
                      "--slowlog-min-count", "8", "--incident-dir",
                      server_datadir(f"proxy_{key}_{pport}")]
            if key == "nearest_neighbor_py":
                planes += ["--slo", FLEET_SLO, "--slo-fast-window", "30",
                           "--slo-slow-window", "60", "--incident-window",
                           "3600"]
            proc = spawn(f"proxy_{key}",
                         "jubatus_tpu_torch.server.proxy", engine,
                         "-z", locator, "-p", str(pport), "-b",
                         "127.0.0.1", "-c", "8", "-t", "300",
                         "--interconnect-timeout", "300", *planes,
                         env=None if native_rpc else {
                             "JUBATUS_TPU_NATIVE_RPC": "0"})
            procs.append(proc)
            proxies[key] = pport
            proxy_pids[key] = proc[0].pid
        for engine, name in FLEET_ENGINES:
            wait_for(lambda e=engine, n=name: len(membership.get_all_actives(
                view, e, n)) == 2, f"two {engine} members never joined",
                FLEET_WAIT_S)
        pcli = {}
        for key, _, name, _ in FLEET_PROXIES:
            pcli[key] = RpcClient("127.0.0.1", proxies[key], timeout=300.0)
            wait_for(lambda c=pcli[key], n=name: answers_ok(
                c, "get_proxy_status", n), f"the {key} proxy never "
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
        nn, nn_py = pcli["nearest_neighbor"], pcli["nearest_neighbor_py"]
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
        # the C++ relay takes the cluster at the refresher's first tick
        # after the proxy has seen it (the set_row calls, CHT-routed, took
        # its Python path): queries until one was relayed
        wait_for(lambda: relayed_query(nn, nn_name, warm),
                 "the NN proxy's C++ relay never engaged", FLEET_RELAY_WAIT_S)
        queries = {"neighbor_row_from_datum": [], "similar_row_from_datum": []}
        lat = {m: {"relay": [], "python_proxy": [], "direct": []}
               for m in queries}
        routed = {m: [0, 0] for m in queries}
        (pst0,) = nn.call("get_proxy_status", nn_name).values()
        for i in range(FLEET_QUERIES):
            dat = server_datum(rng, Datum, FLEET_SETS + i)
            for method in queries:
                got, ms = timed(nn.call, method, nn_name, dat, 10)
                lat[method]["relay"].append(ms)
                got_py, ms = timed(nn_py.call, method, nn_name, dat, 10)
                lat[method]["python_proxy"].append(ms)
                answers = []
                for c in direct["nearest_neighbor"]:
                    a, ms = timed(c.call, method, nn_name, dat, 10)
                    lat[method]["direct"].append(ms)
                    answers.append(a)
                check(len(got) == 10, f"{method}: {len(got)} answers")
                routed[method][one_of(got, answers, method)] += 1
                one_of(got_py, answers, f"{method} (the Python proxy)")
        (pst,) = nn.call("get_proxy_status", nn_name).values()
        (pst_py,) = nn_py.call("get_proxy_status", nn_name).values()
        relay = relay_moved(pst0, pst, queries)
        check(relay["relay_count"] >= len(queries) * FLEET_QUERIES,
              f"the C++ relay forwarded {relay['relay_count']} of "
              f"{len(queries) * FLEET_QUERIES} queries")
        check(pst["forward_errors"] == 0,
              f"the NN proxy's forward errors {pst['forward_errors']}")
        check(pst_py["relay_count"] == 0,
              f"the Python-transport proxy's relay_count "
              f"{pst_py['relay_count']}")
        nn_rows = sum(c.call("get_row_count", nn_name)
                      for c in direct["nearest_neighbor"])
        check(nn_rows == 2 * FLEET_NN_ROWS + FLEET_SETS,
              f"the NN members hold {nn_rows} rows")
        out["nearest_neighbor"] = dict(
            config="config/nearest_neighbor/lsh.json",
            rows=2 * FLEET_NN_ROWS, fill_s=fill_s,
            fill_rows_per_s=2 * FLEET_NN_ROWS / fill_s,
            set_row=pcts(set_lat), first_query_direct_ms=first,
            queries={m: dict(relay=pcts(v["relay"]),
                             python_proxy=pcts(v["python_proxy"]),
                             direct=pcts(v["direct"]),
                             answered_by_member=routed[m])
                     for m, v in lat.items()},
            proxy=dict(forward_count=pst["forward_count"],
                       relay_count=pst["relay_count"],
                       forward_errors=pst["forward_errors"],
                       ring_builds=pst["ring.builds"],
                       ring_hits=pst["ring.hits"],
                       queries_relayed=relay),
            proxy_python=dict(forward_count=pst_py["forward_count"],
                              relay_count=pst_py["relay_count"],
                              forward_errors=pst_py["forward_errors"]))

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
        (rst0,) = rg.call("get_proxy_status", reg_name).values()
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
        (rst,) = rg.call("get_proxy_status", reg_name).values()
        reg_relay = relay_moved(rst0, rst, ("train", "estimate"))
        check(reg_relay["relay_count"] > 0 and rst["forward_errors"] == 0,
              f"the regression proxy relayed {reg_relay}, forward errors "
              f"{rst['forward_errors']}")
        out["regression"] = dict(config="config/regression/default.json",
                                 rows=FLEET_TRAIN,
                                 rows_per_s=FLEET_TRAIN / train_s,
                                 train=pcts(train_lat),
                                 estimate=pcts(est_lat),
                                 relayed=reg_relay)

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
        out["views"] = fleet_views(Datum, seed, locator, view, proxies,
                                   proxy_pids, children_of(visor[0].pid),
                                   pcli, direct)

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

        reads, read_errors = [0], []

        def reader():
            # random-routed reads through the C++ relay: the pipe to the
            # drained member retires once the table drops it
            with RpcClient("127.0.0.1", proxies["nearest_neighbor"],
                           timeout=300.0) as q:
                qrng = np.random.default_rng(seed + 1305)
                while not stop.is_set():
                    try:
                        got = q.call("neighbor_row_from_datum", nn_name,
                                     server_datum(qrng, Datum, reads[0]), 10)
                        check(isinstance(got, list), f"a read answered "
                              f"{got!r}")
                        reads[0] += 1
                    except Exception as e:  # broad-ok — counted, checked
                        read_errors.append(repr(e))

        (dst0,) = nn.call("get_proxy_status", nn_name).values()
        wt = threading.Thread(target=writer, daemon=True)
        rt = threading.Thread(target=reader, daemon=True)
        wt.start()
        rt.start()
        t0 = time.perf_counter()
        rc, text = ctl(jubactl, "-c", "drain", "-t", "nearest_neighbor",
                       "-n", nn_name, "-z", locator, "--target", src.name,
                       "--stop", "--drain-timeout", str(FLEET_WAIT_S))
        drain_s = time.perf_counter() - t0
        stop.set()
        wt.join(timeout=FLEET_WAIT_S)
        rt.join(timeout=FLEET_WAIT_S)
        (dst,) = nn.call("get_proxy_status", nn_name).values()
        check(rc == 0, f"jubactl drain: {text}")
        check(not errors, f"{len(errors)} client errors during the drain: "
              f"{errors[:3]}")
        check(not read_errors, f"{len(read_errors)} relayed reads failed "
              f"during the drain: {read_errors[:3]}")
        drain_relayed = dst["relay_count"] - dst0["relay_count"]
        check(drain_relayed > 0, "no read was relayed during the drain")
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
                            writes_during=writes[0],
                            relayed_reads_during=reads[0],
                            relay_count_during=drain_relayed,
                            client_errors=0)
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
        check(rc == 0 and f"(1 server(s), {len(FLEET_PROXIES)} proxy(ies))"
              in frame, f"jubactl watch: {frame}")
        out["watch_frame"] = frame.splitlines()
        for engine, clis in direct.items():
            for c in clis:
                final[c.port] = next(iter(
                    c.call("get_status", "smoke").values()))
                c.close()
        launches = {m: 0 for m in RECORDED}
        for st in final.values():
            add_launches(launches, st)
        # the members' stack samplers: their own wall, summed
        out["members_sampler_ms"] = sum(
            st.get("profiler.sample_ms_total", 0.0) for st in final.values())
        if autoscale:
            out["autoscale"] = fleet_autoscale(
                Datum, seed, locator, view, d, proxies, visor[0].pid, procs)
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
        for _, log_path in procs + [(None, os.path.join(d, "children.log"))]:
            if os.path.exists(log_path):
                with open(log_path) as f:
                    tail = f.read()[-2000:]
                print(f"--- {log_path}, last lines:\n{tail}",
                      file=sys.stderr)
        raise
    finally:
        if view is not None:
            view.close()
        for proc, _ in reversed(procs):
            stop_server(proc)


def fleet_views(Datum, seed: int, locator: str, view, proxies: dict,
                proxy_pids: dict, member_pids: list, pcli: dict,
                direct: dict) -> dict:
    """The fleet's observability views through phase 13's proxies, after
    its traffic: one traced NN query through the Python-transport NN proxy
    (the C++ relay of the default one records no span of a relayed
    query), assembled by ``jubactl -c trace`` into one tree (proxy
    dispatch -> the proxy's client call -> the member's dispatch) while
    K1's count moves on the member; ``-c metrics``, ``-c alerts`` (that
    proxy's SLO fires), ``-c quality``, ``-c usage``, ``-c profile``
    (folded, and the ``--device`` listing: no new capture), a live
    ``watch`` process's frames, ``-c timeline`` and ``-c incident`` (one
    ``slo_firing`` bundle at that proxy, in its directory under OUT_DIR);
    ``/metrics`` on each proxy; each forensics RPC through the default NN
    proxy timed; no proxy holds a CUDA context (no /dev/nvidia* node
    open, where each of ``member_pids`` holds one), and each proxy's
    resident set split by kind. Host work: the views move no device
    time."""
    import io
    import urllib.request

    from jubatus_tpu_torch.cmd import jubactl
    from jubatus_tpu_torch.utils import tracing

    t_views = time.perf_counter()
    nn_name, reg_name = FLEET_ENGINES[0][1], FLEET_ENGINES[2][1]
    nn, nn_py = pcli["nearest_neighbor"], pcli["nearest_neighbor_py"]
    members = direct["nearest_neighbor"]
    rng = np.random.default_rng(seed + 1304)
    res: dict = {}

    def k1() -> int:
        return sum(next(iter(c.call("get_status", nn_name).values()))[
            "kernel.sig_scan.hamming.launches"] for c in members)

    for i in range(FLEET_VIEW_QUERIES):
        nn_py.call("neighbor_row_from_datum", nn_name,
                   server_datum(rng, Datum, i), 10)
    before = k1()
    ctx = tracing.new_root()
    with tracing.use_trace(ctx):
        got, ms = timed(nn_py.call, "neighbor_row_from_datum", nn_name,
                        server_datum(rng, Datum, FLEET_VIEW_QUERIES), 10)
    check(len(got) == 10, f"traced query: {len(got)} answers")
    res["traced_query_ms"] = ms
    res["traced_query_k1_launches"] = k1() - before
    check(res["traced_query_k1_launches"] > 0,
          "the traced query launched no K1 on a member")
    # two telemetry ticks: the NN proxy's ring and SLO see the queries
    time.sleep(2.5)

    def run(*argv) -> str:
        rc, text = ctl(jubactl, *argv, "-z", locator)
        check(rc == 0, f"jubactl {' '.join(argv)}: rc {rc}: {text[-600:]}")
        return text

    t0 = time.perf_counter()
    text = run("-c", "trace", "-t", "nearest_neighbor", "-n", nn_name,
               ctx.trace_id)
    res["trace_ms"] = (time.perf_counter() - t0) * 1e3
    pnode = f"127.0.0.1_{proxies['nearest_neighbor_py']}"
    check("1 root(s)" in text and f"rpc.neighbor_row_from_datum" in text
          and "rpc.client.neighbor_row_from_datum" in text
          and f"@{pnode}" in text
          and any(f"@{c.host}_{c.port}" in text for c in members),
          f"jubactl trace: {text}")
    res["trace_tree"] = text.splitlines()
    text = run("-c", "metrics", "-t", "nearest_neighbor", "-n", nn_name)
    check("merged metrics from 2 node(s)" in text
          and "rpc.neighbor_row_from_datum" in text, f"metrics: {text}")
    text = run("-c", "alerts", "-t", "nearest_neighbor", "-n", nn_name)
    check("1 alert(s) firing" in text and re.search(
        rf"{pnode}\s+rpc\.neighbor_row_from_datum\.p99\s+FIRING", text)
        is not None, f"alerts: {text}")
    res["alerts"] = text.splitlines()
    text = run("-c", "quality", "-t", "regression", "-n", reg_name)
    check("data quality across 2 node(s)" in text, f"quality: {text}")
    res["quality"] = text.splitlines()
    text = run("-c", "usage", "-t", "nearest_neighbor", "-n", nn_name)
    check(f"usage across {2 + len(proxies)} node(s)" in text
          and "(untagged)" in text, f"usage: {text}")
    res["usage"] = text.splitlines()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        text = run("-c", "profile", "-t", "nearest_neighbor", "-n", nn_name,
                   "--folded")
    folded = [ln for ln in text.splitlines() if ln.strip()]
    check(folded and all(int(ln.rpartition(" ")[2]) > 0 for ln in folded)
          and pnode in err.getvalue(), f"profile: {err.getvalue()}")
    res["profile_folded_stacks"] = len(folded)
    text = run("-c", "profile", "-t", "nearest_neighbor", "-n", nn_name,
               "--device")
    check(text.count("capture(s) in") == 2, f"profile --device: {text}")
    text = run("-c", "timeline", "-t", "nearest_neighbor", "-n", nn_name)
    check("slo.firing" in text and "membership." in text,
          f"timeline: {text[-800:]}")
    res["timeline_events"] = len(text.splitlines())
    text = run("-c", "incident", "-t", "nearest_neighbor", "-n", nn_name)
    fired = [ln for ln in text.splitlines() if "slo_firing:" in ln]
    check(len(fired) == 1 and pnode in fired[0],
          f"incident: one slo_firing bundle at the NN proxy: {text}")
    res["incident"] = text.splitlines()
    # the bundle is on disk in the proxy's directory under OUT_DIR
    inc = nn_py.call("get_proxy_incidents", nn_name, "")[pnode]
    check(os.path.realpath(inc["dir"]).startswith(
        os.path.realpath(OUT_DIR)) and len(inc["incidents"]) == 1,
        f"the NN proxy's bundles: {inc}")
    # a live watch: the CLI refreshes its frame every second
    frame_log = os.path.join(OUT_DIR, "chip_smoke_watch_live.log")
    with open(frame_log, "w") as f:
        live = subprocess.Popen(
            [sys.executable, "-m", "jubatus_tpu_torch.cmd.jubactl", "-c",
             "watch", "-t", "nearest_neighbor", "-n", nn_name, "-z",
             locator, "--interval", "1", "--window", "60"], cwd=ROOT,
            stdout=f, stderr=subprocess.STDOUT)
    try:
        def frames() -> int:
            with open(frame_log) as f:
                return f.read().count("\x1b[2J\x1b[H")

        wait_for(lambda: frames() >= 2, "the live watch drew two frames",
                 60.0)
    finally:
        stop_server(live)
    with open(frame_log) as f:
        # the first frame: complete, since a second one followed it
        first = f.read().split("\x1b[2J\x1b[H")[1]
    check(f"(2 server(s), {len(proxies)} proxy(ies))" in first
          and "alerts firing:" in first, f"watch frame: {first}")
    t0 = time.perf_counter()
    frame = jubactl.render_watch_frame(jubactl.collect_watch(
        view, "nearest_neighbor", nn_name, 60.0))
    res["watch_frame_ms"] = (time.perf_counter() - t0) * 1e3
    res["watch_frame"] = frame.splitlines()
    # /metrics on every proxy
    for key, client in pcli.items():
        (st,) = client.call("get_proxy_status",
                            FLEET_PROXY_NAME[key]).values()
        url = f"http://127.0.0.1:{st['argv.metrics_port']}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            body = r.read().decode()
        engine = st["type"].removesuffix("_proxy")
        check(f'engine="{engine}_proxy"' in body
              and "jubatus_span_duration_seconds_bucket" in body,
              f"the {key} proxy's /metrics")
    # each forensics RPC through the NN proxy: its own hop and the
    # members' broadcast, timed from here
    calls = {}
    for method, args in FLEET_FORENSICS:
        lat = []
        for _ in range(FLEET_FORENSICS_REPS):
            doc, ms = timed(nn.call, method, nn_name, *args)
            lat.append(ms)
        want = 2 if method == "get_quality" else 3
        check(isinstance(doc, dict) and len(doc) == want,
              f"{method} through the proxy: {sorted(doc)}")
        calls[method] = statistics.median(lat)
    res["forensics_call_ms"] = calls
    # no proxy process holds a CUDA context: none holds a /dev/nvidia* node
    # open, as every member does (the witness's control), and none reports
    # the runtime's torch_* rows, which a process carries only once it has
    # initialised CUDA
    member_fds = {pid: cuda_device_fds(pid) for pid in member_pids}
    check(len(member_fds) == sum(map(len, direct.values()))
          and all(member_fds.values()),
          f"a member holds no /dev/nvidia* node open: {member_fds}")
    proxy_fds = {e: cuda_device_fds(pid) for e, pid in proxy_pids.items()}
    check(not any(proxy_fds.values()), f"a proxy opened the card: {proxy_fds}")
    res["member_nvidia_nodes"] = sorted(set().union(*member_fds.values()))
    res["proxy_rss_mb"], res["proxy_rss_split_mb"] = {}, {}
    for engine, pid in proxy_pids.items():
        res["proxy_rss_split_mb"][engine] = rss_split_mb(pid)
    for key, c in pcli.items():
        (st,) = c.call("get_proxy_status", FLEET_PROXY_NAME[key]).values()
        cuda_rows = sorted(k for k in st if k.startswith("runtime.torch_"))
        check(not cuda_rows, f"the {key} proxy initialised CUDA: "
              f"{cuda_rows}")
        res["proxy_rss_mb"][key] = round(
            st["runtime.rss_bytes"] / 2 ** 20, 1)
    (st,) = members[0].call("get_status", nn_name).values()
    res["member_rss_mb"] = round(st["runtime.rss_bytes"] / 2 ** 20, 1)
    res["member_device_reserved_mb"] = round(st.get(
        "runtime.torch_device_bytes_reserved", 0) / 2 ** 20, 1)
    res["views_s"] = time.perf_counter() - t_views
    return res


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
IVF_SERVER_ROWS = 62_500      # the --ann ivf server's put_rows fill (cut
                              # from 2.5·10^5, then 1.25·10^5: the IVF query
                              # at 10^6 rows is the flat index's)
IVF_SERVER_QUERIES = 100      # (cut from 200 for the run's limit: phase
                              # 14 times IVF queries at 10^6 rows)
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
    return with_gauges(cli, st)


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
    flat = EngineServer(engine, config, ServerArgs(engine=engine, datadir=tmp),
                        device=dev)
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
        for i in range(2):
            srv = EngineServer("classifier", config, ServerArgs(
                engine="classifier", coordinator="(shared)", name="smoke",
                listen_addr="127.0.0.1", interval_sec=1e9,
                interval_count=1 << 30,
                datadir=server_datadir(f"fs_mix_{i}")), device=dev,
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
    for e in prof.function_events:
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
        from jubatus_tpu_torch.utils.profiler import kineto_profile

        with kineto_profile(cuda=True) as prof:
            y = chunk + 0.0
            q, s = C._block_quant(y, C.QUANT_BLOCK)
            C._add_dequant(y, q, s, C.QUANT_BLOCK, -1.0)
            torch.cuda.synchronize()
        ship = kernel_count(prof)
        with kineto_profile(cuda=True) as prof:
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


# ---------------------------------------------------------------------------
# phase 17: sharded checkpoints and the forensics plane
# ---------------------------------------------------------------------------
CK_SHARDS = (4, 2, 1)         # restore layouts of the 2^24 checkpoint
FX_ROWS = NN_SERVER_ROWS      # set_row calls per NN server (cut from
#                               10^4: phase 18 fills two lsh.json servers
#                               with 5,000 set_row each)
FX_FILL_THREADS = 4
FX_QUERIES = 200              # NN queries per server for p50/p99
FX_CAPTURE_S = 2.0            # profile_device seconds
FX_CAPTURES = 2               # captures per server under --forensics-ab:
                              # a process's first pays the profiler's
                              # set-up, a later one not (the main path
                              # takes the first only, for the run's limit)
FX_TRAIN_ROWS = 256           # regression rows per train call
FX_WARM_TRAINS = 96           # train calls before the capture: past the
#                               slow log's first threshold refresh (64)
FX_SLOW_MIN = 8               # --slowlog-min-count of the phase's servers
FX_SLOW_Q = 0.9               # --slowlog-quantile: a tenth of the calls
FX_SAMPLES = 20               # timed telemetry samples (median)


def ck_template(torch, ClassifierState, rows: int, dim: int, n: int, dev):
    """A restore template allocating nothing: AROW's four [rows, dim]
    tables as n column blocks of ``device="meta"`` tensors carrying their
    target device (``sharded_checkpoint.abstract_like``'s form)."""
    def leaf():
        blocks = []
        for _ in range(n):
            m = torch.empty((rows, dim // n), dtype=torch.float32,
                            device="meta")
            m.target_device = dev
            blocks.append(m)
        return tuple(blocks) if n > 1 else blocks[0]

    return ClassifierState(*(leaf() for _ in range(4)))


def joined(torch, leaf):
    return torch.cat(leaf, dim=-1) if isinstance(leaf, tuple) else leaf


def phase_checkpoint(torch, ClassifierDriver, dev, seed: int) -> dict:
    """AROW at phase 15's shape (D = 2^FS_DIM_BITS, capacity 8) on
    FS_SHARDS logical shards of the card after two train_hashed steps of
    phase 8's batch: ``save_sharded`` timed and split (staging, write,
    sidecar) with its bytes on disk; restored at 4, 2 and 1 shards on the
    card, every field ``torch.equal`` to the source; read back with
    ``checkpoint_metadata`` and ``jubadump -i`` (a process); then the same
    state through the envelope path (``save_model`` / ``load_model``),
    timed beside it."""
    from jubatus_tpu_torch.framework import save_load as SL
    from jubatus_tpu_torch.framework import sharded_checkpoint as SC
    from jubatus_tpu_torch.ops.classifier import ClassifierState
    from jubatus_tpu_torch.parallel.mesh import ShardMesh
    from jubatus_tpu_torch.utils.disk import tree_bytes

    dim = 1 << FS_DIM_BITS
    drv = ClassifierDriver(CLF_CONFIG, dim_bits=FS_DIM_BITS, device=dev,
                           mesh=ShardMesh([dev] * FS_SHARDS))
    rng = np.random.default_rng(seed + 170)
    names = np.array(["neg", "pos"])
    for _ in range(2):
        idx, val, lab = bench_batch(rng, FS_DIM_BITS)
        drv.train_hashed(list(names[lab]), idx, val)
    torch.cuda.synchronize()
    state = drv.state
    rows = int(state.w[0].shape[0])
    config = json.dumps(CLF_CONFIG)
    path = os.path.join(OUT_DIR, "ckpt_arow24")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401 — timed apart
    import_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    split = SC.save_sharded(path, state, engine_type="classifier",
                            model_id="smoke", config=config)
    save_ms = (time.perf_counter() - t0) * 1e3
    disk = tree_bytes(path)
    state_bytes = sum(b.numel() * b.element_size()
                      for f in state for b in f)
    out = dict(dim_bits=FS_DIM_BITS, capacity=rows, shards=FS_SHARDS,
               state_bytes=state_bytes, disk_bytes=disk,
               dcp_import_ms=import_ms,
               save_sharded_ms=save_ms, save_split_ms=split,
               write_gb_per_s=state_bytes / (split["write_ms"] / 1e3) / 1e9)
    restores = {}
    for n in CK_SHARDS:
        tmpl = ck_template(torch, ClassifierState, rows, dim, n, dev)
        t0 = time.perf_counter()
        system, got = SC.load_sharded(path, tmpl, expected_type="classifier",
                                      expected_config=config)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(system["shard_layout"] == {"shard": FS_SHARDS},
              f"sidecar layout {system['shard_layout']}")
        for name, a, b in zip(ClassifierState._fields, state, got):
            blocks = b if isinstance(b, tuple) else (b,)
            check(len(blocks) == n and all(x.device == dev for x in blocks),
                  f"restore at {n}: {name} not in {n} blocks on {dev}")
            check(torch.equal(joined(torch, a), joined(torch, b)),
                  f"restore at {n} shards: {name} differs from the source")
        restores[n] = dict(load_ms=ms)
        del got
        torch.cuda.empty_cache()
    out["restores"] = restores
    md = SC.checkpoint_metadata(path)
    check(md["arrays"]["w"] == {"shape": [rows, dim], "dtype": "float32",
                                "partition_spec": ["None", "shard"]},
          f"checkpoint_metadata w: {md['arrays']['w']}")
    import io

    from jubatus_tpu_torch.cmd import jubadump

    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = jubadump.main(["-i", path])
    dump_ms = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"jubadump -i exited {rc}")
    dumped = json.loads(text.getvalue())
    check(dumped["arrays"] == md["arrays"]
          and dumped["system"]["config"] == CLF_CONFIG,
          "jubadump -i disagrees with checkpoint_metadata")
    out.update(jubadump_ms=dump_ms, arrays_w=md["arrays"]["w"])
    shutil.rmtree(path)
    envelope = path + ".jubatus"
    _, env_save = timed(lambda: SL.save_model(envelope, drv, model_id="smoke",
                                              config=config))
    env_bytes = os.path.getsize(envelope)
    again = ClassifierDriver(CLF_CONFIG, dim_bits=FS_DIM_BITS, device=dev,
                             mesh=ShardMesh([dev] * FS_SHARDS))
    _, env_load = timed(lambda: (SL.load_model(envelope, again,
                                               expected_config=config),
                                 torch.cuda.synchronize()))
    check(torch.equal(joined(torch, again.state.w),
                      joined(torch, state.w) + joined(torch, state.dw)),
          "the envelope path's loaded w differs")
    os.remove(envelope)
    out["envelope"] = dict(save_model_ms=env_save, load_model_ms=env_load,
                           file_bytes=env_bytes)
    del again, drv, state
    torch.cuda.empty_cache()
    return out


def trace_kernels(path: str, needle: str) -> dict:
    """Kernel records in a capture's Chrome trace whose name holds
    ``needle``: their count and names, and every kernel record's count."""
    from jubatus_tpu_torch.utils.profiler import TRACE_FILE

    with open(os.path.join(path, TRACE_FILE)) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    hits = [e["name"] for e in kernels if needle in e.get("name", "")]
    return dict(kernel_records=len(kernels), hits=len(hits),
                names=sorted(set(h[:80] for h in hits)))


def parse_prometheus(text: str) -> list:
    """(name, labels, value) of every sample line (exemplars allowed);
    fails on a line that does not parse."""
    import re

    pat = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                     r'([0-9eE.+-]+|NaN|\+Inf)( # \{[^}]*\} \S+ \S+)?$')
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = pat.match(line)
        check(m is not None, f"unparseable /metrics line: {line[:120]!r}")
        out.append((m.group(1), m.group(2) or "", float(m.group(3))))
    return out


def forensics_checks(cli, mport: int, method: str, sampled: bool) -> dict:
    """get_status's runtime keys, /metrics (rpc.<method> buckets and the
    runtime gauges), /healthz, get_slow_log and get_profile of one server
    (folded stacks when ``sampled``, none with the sampler off)."""
    import urllib.request

    st = server_status(cli)
    check(st.get("runtime.torch_device_bytes_in_use", 0) > 0,
          f"runtime.torch_device_bytes_in_use "
          f"{st.get('runtime.torch_device_bytes_in_use')}")
    with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                timeout=30) as resp:
        samples = parse_prometheus(resp.read().decode())
    spans = {lab for n, lab, _ in samples
             if n == "jubatus_span_duration_seconds_bucket"}
    check(any(f'span="rpc.{method}"' in lab for lab in spans),
          f"/metrics has no rpc.{method} buckets")
    gauges = {lab for n, lab, _ in samples if n == "jubatus_runtime_gauge"}
    check(any('key="torch_device_bytes_in_use"' in g for g in gauges),
          "/metrics has no torch_device_bytes_in_use gauge")
    with urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz",
                                timeout=30) as resp:
        health = json.loads(resp.read().decode())
    check(health["status"] == "ok", f"/healthz {health}")
    (slow,) = cli.call("get_slow_log", "smoke").values()
    check(len(slow) > 0,
          f"get_slow_log of the {st['type']} server holds no captures "
          f"({[(k, v) for k, v in st.items() if k.endswith('.count')]})")
    (prof,) = cli.call("get_profile", "smoke", 60.0).values()
    check((sum(prof["folded"].values()) > 0) == sampled
          and prof["stats"]["enabled"] == sampled,
          f"get_profile folded {sum(prof['folded'].values())} samples, "
          f"sampler enabled {prof['stats']['enabled']}")
    return dict(runtime={k[len("runtime."):]: st[k] for k in st
                         if k.startswith("runtime.torch_")
                         or k.startswith("runtime.kernel_build")},
                metrics_samples=len(samples), slow_captures=len(slow),
                profile_stacks=len(prof["folded"]),
                profile_samples=prof["stats"]["samples"],
                overhead_ms_per_s=st.get("profiler.overhead_ms_per_s"))


def capture_under_load(cli, port: int, key: str, load, needle: str) -> dict:
    """``profile_device(FX_CAPTURE_S)`` while ``load`` runs in a thread:
    the artifact must name the kernel (``needle``) at least once and no
    more often than the server's launch count ``key`` rose over the
    window; ``get_status`` must answer while the capture is in flight (the
    capture holds no RPC worker), every 0.25 s, each timed."""
    import threading

    from jubatus_tpu_torch.rpc.client import RpcClient

    stop = threading.Event()
    errors: list = []

    def pump():
        try:
            with RpcClient("127.0.0.1", port, timeout=120.0) as loader:
                while not stop.is_set():
                    load(loader)
        except Exception as e:  # broad-ok — reported below
            errors.append(e)

    def capture():
        try:
            with RpcClient("127.0.0.1", port, timeout=300.0) as c:
                t0 = time.perf_counter()
                (got["doc"],) = c.call("profile_device", "smoke",
                                       FX_CAPTURE_S).values()
                got["wall"] = time.perf_counter() - t0
        except Exception as e:  # broad-ok — reported below
            errors.append(e)

    got: dict = {}
    status_ms: list = []
    before = int(server_status(cli)[key])
    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        ct = threading.Thread(target=capture, daemon=True)
        ct.start()
        while ct.is_alive():
            _, ms = timed(cli.call, "get_status", "smoke")
            if ct.is_alive():
                status_ms.append(ms)
            time.sleep(0.25)
        ct.join()
    finally:
        stop.set()
        t.join(timeout=60)
    check(not errors, f"load or capture failed: {errors[:1]}")
    doc, wall = got["doc"], got["wall"]
    check("error" not in doc, f"profile_device: {doc.get('error')}")
    check(len(status_ms) > 0,
          "no get_status answered while the capture was in flight")
    after = int(server_status(cli)[key])
    found = trace_kernels(doc["artifact"], needle)
    rose = after - before
    check(found["hits"] >= 1,
          f"the capture names no {needle} kernel ({found})")
    check(found["hits"] <= rose,
          f"the capture names {needle} {found['hits']} times, the launch "
          f"count rose {rose}")
    return dict(seconds=doc["seconds"], bytes=doc["bytes"],
                rpc_wall_s=wall, timing_ms=doc["timing_ms"],
                status_during_capture=dict(calls=len(status_ms),
                                           **pcts(status_ms)),
                activities=doc.get("activities"),
                trace_hits=found["hits"], launches_rose=rose,
                kernel_records=found["kernel_records"],
                names=found["names"])


def nn_fill(port: int, Datum, seed: int) -> None:
    """FX_ROWS set_row calls (phase 4's rows) from FX_FILL_THREADS
    clients."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    rng = np.random.default_rng(seed)
    rows = [(f"row{i}", server_datum(rng, Datum, i)) for i in range(FX_ROWS)]

    def part(k):
        with RpcClient("127.0.0.1", port, timeout=120.0) as c:
            for rid, d in rows[k::FX_FILL_THREADS]:
                check(c.call("set_row", "smoke", rid, d) is True,
                      "set_row failed")

    with concurrent.futures.ThreadPoolExecutor(FX_FILL_THREADS) as pool:
        for fut in [pool.submit(part, k) for k in range(FX_FILL_THREADS)]:
            fut.result()


def phase_forensics(torch, Datum, seed: int, captures: int = 1) -> dict:
    """Servers on the card with ``-c 2 --metrics-port 0
    --telemetry-interval 1 --profile-dir <dir>``: two nearest_neighbor
    lsh.json servers (the stack sampler at its default 67 Hz and off)
    filled with FX_ROWS rows, and a regression default.json
    server. On the sampled NN server a client keeps querying while
    ``profile_device`` captures FX_CAPTURE_S
    (K1 named in the artifact), likewise the regression server under a
    training client (S1); each server's runtime keys, /metrics, /healthz,
    slow log and folded profile. FX_QUERIES queries in turns on the two
    NN servers give the sampler's cost on the query p50/p99; the telemetry
    sample's cost is timed in this process. Each capture is taken
    ``captures`` times (``*_recaptures``: those after the process's
    first)."""
    from jubatus_tpu_torch.utils.runtime_telemetry import RuntimeTelemetry
    from jubatus_tpu_torch.utils.tracing import Registry

    prof_dir = os.path.join(OUT_DIR, "profiles")
    shutil.rmtree(prof_dir, ignore_errors=True)
    common = ("-c", "2",   # the server's default RPC workers
              "--metrics-port", "0", "--telemetry-interval", "1",
              "--slowlog-min-count", str(FX_SLOW_MIN),
              "--slowlog-quantile", str(FX_SLOW_Q))
    nn = os.path.join(ROOT, "config", "nearest_neighbor", "lsh.json")
    reg = os.path.join(ROOT, "config", "regression", "default.json")
    t_start = time.perf_counter()
    started = {
        "nn": start_server("nearest_neighbor", nn, "_p17", common + (
            "--profile-dir", os.path.join(prof_dir, "nn"))),
        "nn_hz0": start_server("nearest_neighbor", nn, "_p17_hz0", common + (
            "--profile-dir", os.path.join(prof_dir, "nn_hz0"),
            "--profile-hz", "0")),
        "regression": start_server("regression", reg, "_p17", common + (
            "--profile-dir", os.path.join(prof_dir, "regression"))),
    }
    out: dict = {}
    launches = {m: 0 for m in RECORDED}
    engines = {"nn": "nearest_neighbor", "nn_hz0": "nearest_neighbor",
               "regression": "regression"}
    ports = {k: v[1] for k, v in started.items()}
    with contextlib.ExitStack() as stack:
        clis = {k: stack.enter_context(serving(engines[k], "", started=v))
                for k, v in started.items()}
        out["start_s"] = time.perf_counter() - t_start
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for fut in [pool.submit(nn_fill, ports[k], Datum, seed)
                        for k in ("nn", "nn_hz0")]:
                fut.result()
        out["fill_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 171)
        queries = [server_datum(rng, Datum, FX_ROWS + i)
                   for i in range(FX_QUERIES)]
        lat = {"nn": [], "nn_hz0": []}
        for q in queries:   # in turns: the two servers see the same drift
            for k in ("nn", "nn_hz0"):
                t1 = time.perf_counter()
                got = clis[k].call("neighbor_row_from_datum", "smoke", q, 10)
                lat[k].append((time.perf_counter() - t1) * 1e3)
                check(len(got) == 10, f"{k}: {len(got)} neighbors")
        out["query_hz67"] = pcts(lat["nn"])
        out["query_hz0"] = pcts(lat["nn_hz0"])
        nth = iter(range(1 << 30))
        nn_caps = [capture_under_load(
            clis["nn"], ports["nn"], "kernel.sig_scan.hamming.launches",
            lambda c: c.call("neighbor_row_from_datum", "smoke",
                             queries[next(nth) % FX_QUERIES], 10),
            "sig_scan") for _ in range(captures)]
        out["nn_capture"] = nn_caps[0]
        rows = [linear_example(rng, Datum, "regression", i)
                for i in range(8 * FX_TRAIN_ROWS)]

        def train(c):
            j = next(nth) % 8
            c.call("train", "smoke",
                   rows[j * FX_TRAIN_ROWS:(j + 1) * FX_TRAIN_ROWS])

        for _ in range(FX_WARM_TRAINS):
            train(clis["regression"])
        reg_caps = [capture_under_load(
            clis["regression"], ports["regression"],
            "kernel.online_scan.launches", train, "pa_scan")
            for _ in range(captures)]
        out["regression_capture"] = reg_caps[0]
        out["nn_recaptures"] = nn_caps[1:]
        out["regression_recaptures"] = reg_caps[1:]
        for k, method in (("nn", "neighbor_row_from_datum"),
                          ("nn_hz0", "neighbor_row_from_datum"),
                          ("regression", "train")):
            mport = int(server_status(clis[k])["argv.metrics_port"])
            check(mport > 0, f"{k}: metrics port {mport}")
            out[f"{k}_forensics"] = forensics_checks(clis[k], mport, method,
                                                     k != "nn_hz0")
            for m, n in server_launches(server_status(clis[k])).items():
                launches[m] += n
        out["served_s"] = time.perf_counter() - t_start
    held = torch.ones(1 << 20, device="cuda")  # CUDA in use here too
    rt = RuntimeTelemetry(Registry())
    costs = [timed(rt.sample)[1] for _ in range(FX_SAMPLES)]
    check(rt.sample().get("torch_device_bytes_in_use", 0) > 0,
          "this process's telemetry sample reads no device bytes")
    del held
    out["telemetry_sample_ms"] = statistics.median(costs)
    out["server_launches"] = launches
    return out


# ---------------------------------------------------------------------------
# --forensics-ab: what the forensics plane costs phase 9's and phase 13's
# servers
# ---------------------------------------------------------------------------
#: server flags of each arm (phase 13's members get them through the
#: visor's --server-flags)
AB_ARMS = {"default": (),
           "sampler_off": ("--profile-hz", "0"),
           "off": ("--profile-hz", "0", "--telemetry-interval", "0"),
           "planes_off": ("--quality-sample", "0", "--usage-top", "0",
                          "--timeseries-capacity", "0",
                          "--event-capacity", "0")}
#: the parent arm: phase 9's linear servers and phase 13 from the checkout
#: in the working directory, with its own chip_smoke.py and package
PARENT_AB = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.classifier import ClassifierDriver
from jubatus_tpu_torch.models.regression import RegressionDriver
from jubatus_tpu_torch.ops import online_scan, sig_scan
sig_scan.library(); online_scan.library()
seed = int(sys.argv[1])
out = {engine: cs.phase_linear_server(Datum, drv, engine, cfg, seed)
       for engine, drv, cfg in (("classifier", ClassifierDriver, "arow.json"),
                                ("regression", RegressionDriver,
                                 "default.json"))}
out["fleet"] = cs.phase_fleet(Datum, seed)
print("AB_RESULT " + json.dumps(out))
"""


def ab_summary(lin: dict, fleet: dict) -> dict:
    """The numbers an arm is compared on: phase 9's rows/s and p50/p99,
    phase 13's boot, fill, queries, regression, estimate and drain."""
    out = {}
    for engine, r in lin.items():
        q = "classify" if engine == "classifier" else "estimate"
        out[engine] = dict(conc_rows_per_s=r["concurrent"]["rows_per_s"],
                           seq_rows_per_s=r["sequential"]["rows_per_s"],
                           p50_ms=r[q]["p50_ms"], p99_ms=r[q]["p99_ms"])
    nn = fleet["nearest_neighbor"]
    q = nn["queries"]["neighbor_row_from_datum"]
    reg = fleet["regression"]
    out["fleet"] = dict(
        boot_s=fleet["boot_s"], fill_rows_per_s=nn["fill_rows_per_s"],
        set_row_p50_ms=nn["set_row"]["p50_ms"],
        nn_proxy_p50_ms=q["proxy"]["p50_ms"],
        nn_proxy_p99_ms=q["proxy"]["p99_ms"],
        nn_direct_p50_ms=q["direct"]["p50_ms"],
        add_p50_ms=fleet["anomaly"]["add"]["p50_ms"],
        reg_rows_per_s=reg["rows_per_s"],
        reg_train_p50_ms=reg["train"]["p50_ms"],
        estimate_p50_ms=reg["estimate"]["p50_ms"],
        estimate_p99_ms=reg["estimate"]["p99_ms"],
        drain_rows_per_s=fleet["drain"]["rows_per_s"],
        members_sampler_ms=fleet.get("members_sampler_ms"))
    return out


def median_tree(docs: list):
    """Element-wise median of equally shaped nested dicts (None skipped)."""
    if isinstance(docs[0], dict):
        return {k: median_tree([d[k] for d in docs]) for k in docs[0]}
    vals = [d for d in docs if d is not None]
    return statistics.median(vals) if vals else None


def run_forensics_ab(torch, Datum, ClassifierDriver, RegressionDriver,
                     rounds: int, parent: str, seed: int, kind: str,
                     smi: str) -> None:
    arms = list(AB_ARMS) + (["parent"] if parent else [])
    results: dict = {arm: [] for arm in arms}
    for r in range(rounds):
        for arm in (arms if r % 2 == 0 else arms[::-1]):
            t0 = time.perf_counter()
            if arm == "parent":
                proc = subprocess.run(
                    [sys.executable, "-c", PARENT_AB, str(seed)],
                    cwd=parent, capture_output=True, text=True, timeout=900)
                check(proc.returncode == 0,
                      f"the parent's phases failed: {proc.stderr[-3000:]}")
                (line,) = [x for x in proc.stdout.splitlines()
                           if x.startswith("AB_RESULT ")]
                res = json.loads(line[len("AB_RESULT "):])
                fleet = res.pop("fleet")
                summary = ab_summary(res, fleet)
            else:
                flags = AB_ARMS[arm]
                lin = {engine: phase_linear_server(Datum, drv, engine, cfg,
                                                   seed, extra=flags)
                       for engine, drv, cfg in (
                           ("classifier", ClassifierDriver, "arow.json"),
                           ("regression", RegressionDriver,
                            "default.json"))}
                summary = ab_summary(lin, phase_fleet(
                    Datum, seed, member_flags=" ".join(flags)))
            summary["seconds"] = time.perf_counter() - t0
            results[arm].append(summary)
            log(f"[forensics_ab] round {r} arm {arm} {json.dumps(summary)} "
                f"| {kind} | {smi}")
    medians = {arm: median_tree(v) for arm, v in results.items()}
    log(f"[forensics_ab] medians {json.dumps(medians)} | {kind} | {smi}")
    log_forensics(torch, Datum, seed, kind, smi, FX_CAPTURES)


def log_forensics(torch, Datum, seed: int, kind: str, smi: str,
                  captures: int = 1) -> dict:
    """Phase 17's servers (``phase_forensics``), printed as ``[forensics]``
    lines: each capture on a line of its own."""
    res = phase_forensics(torch, Datum, seed, captures)
    for key in ("nn_capture", "regression_capture", "nn_recaptures",
                "regression_recaptures"):
        if res[key]:
            log(f"[forensics] {key} {json.dumps(res[key])} | {kind} | "
                f"{smi}")
        del res[key]
    log(f"[forensics] {json.dumps(res)} | {kind} | {smi}")
    return res


# ---------------------------------------------------------------------------
# phase 18: the server planes (quality, usage, SLOs, incidents, plugins)
# ---------------------------------------------------------------------------
SP_ROWS = 10_000              # rows each tenant's client trains per arm run
SP_BATCH = 256                # rows per train call (phase 9's)
SP_ROUNDS = 3                 # arms in order, reversed, in order (medians)
SP_WARMUP_ROWS = 2_048        # rows each arm server trains before timing
SP_TENANTS = ("tenant-a", "tenant-b")
SP_ARMS = {
    "defaults": (),
    "sample_all": ("--quality-sample", "1.0"),
    "planes_off": AB_ARMS["planes_off"],
}
#: the drift drill, on a fourth arow.json server that is not timed:
#: every batch scored, 2 s quality windows, the first completed one pinned
#: as the reference, a 1 s telemetry tick and an SLO on the input drift (a
#: PSI of 0.1 is the ceiling)
SP_DRILL = ("--quality-sample", "1.0",
            "--quality-window", "2", "--quality-ref-windows", "1",
            "--telemetry-interval", "1",
            "--slo", "drift=gauge:quality.drift.max:0.1",
            "--slo-fast-window", "4", "--slo-slow-window", "8")
SP_DRILL_WAIT_S = 30.0        # longest wait for the reference / the alert
SP_SCORED = 8                 # rows the prequential scorer takes a batch
SP_NN_ROWS = 5_000            # set_row calls per nearest_neighbor server
                              # (cut from 10^4 for the run's limit: phase
                              # 13 serves 3.125·10^4 rows a member)
SP_NN_QUERIES = 200
SP_TEXTS = 500                # distinct texts of the NN rows (hot strings)
SP_KEYWORDS = 400             # ux_splitter dictionary entries
SP_TIMEOUT = "30"             # -t of the phase's servers
SP_MAE_RTOL = 1e-4            # prequential MAE, card against the CPU replay


def sp_rows(rng, Datum, n: int):
    """A tenant's classifier rows: the label mix turns from 80% "a" to 20%
    after half, and the features scale by 4 (the drift the plane sees)."""
    out = []
    for i in range(n):
        late = i >= n // 2
        lab = "a" if rng.random() < (0.2 if late else 0.8) else "b"
        d = Datum()
        for j in rng.choice(16, 6, replace=False):
            v = rng.standard_normal() + (1.0 if lab == "a" else -1.0)
            d.add(f"f{j}", float(np.round(v * (4.0 if late else 1.0), 3)))
        d.add("city", f"c{int(rng.integers(40))}")
        out.append([lab, d])
    return out


def sp_batches(rows):
    return [rows[lo:lo + SP_BATCH] for lo in range(0, len(rows), SP_BATCH)]


def two_tenants(port: int, batches_by_tenant) -> float:
    """Each tenant's client trains its batches at once, under its own
    principal; returns the wall seconds. Every call must answer its own
    count."""
    import threading

    from jubatus_tpu_torch.rpc import principal as principals
    from jubatus_tpu_torch.rpc.client import RpcClient

    errors = []

    def client(tenant, batches):
        try:
            with principals.use(tenant), \
                    RpcClient("127.0.0.1", port, timeout=120.0) as c:
                for b in batches:
                    n = c.call("train", "smoke", b)
                    if n != len(b):
                        errors.append(f"{tenant}: {n} for {len(b)} rows")
        except Exception as e:  # broad-ok — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=kv)
               for kv in batches_by_tenant.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    check(not errors, f"tenant train failed: {errors[:2]}")
    return seconds


def node_doc(cli, method: str, *args):
    (doc,) = cli.call(method, "smoke", *args).values()
    return doc


def wait_doc(cli, method: str, pred, what: str, *args):
    deadline = time.time() + SP_DRILL_WAIT_S
    while True:
        doc = node_doc(cli, method, *args)
        if pred(doc):
            return doc
        check(time.time() < deadline,
              f"{what} not seen in {SP_DRILL_WAIT_S:.0f} s")
        time.sleep(0.25)


def sp_log_check(logdir: str, engine: str) -> None:
    check(os.path.isfile(os.path.join(logdir, f"juba{engine}.log")),
          f"-l {logdir}: the {engine} server wrote no log file")


def sp_start(engine: str, config_path: str, tag: str, extra=()):
    logdir = os.path.join(OUT_DIR, "p18_logs", tag)
    started = start_server(engine, config_path, tag=f"_p18_{tag}",
                           extra=("-l", logdir, "-t", SP_TIMEOUT, *extra))
    return started, logdir


def sp_stream(Datum, seed: int):
    """The two tenants' rows as halves of batches (before and after the
    shift), and the warm-up batches."""
    rng = np.random.default_rng(seed + 1800)
    rows = {t: sp_rows(rng, Datum, SP_ROWS) for t in SP_TENANTS}
    halves = [{t: sp_batches(r[:SP_ROWS // 2]) for t, r in rows.items()},
              {t: sp_batches(r[SP_ROWS // 2:]) for t, r in rows.items()}]
    warm = sp_batches(sp_rows(rng, Datum, SP_WARMUP_ROWS))
    return halves, warm


def sp_arms(clis, halves, warm) -> dict:
    """Three arow.json servers, one an arm of SP_ARMS, trained by two
    tenants' clients in turns."""
    from jubatus_tpu_torch.utils.usage import FIELDS

    for cli in clis.values():
        two_tenants(cli.port, {"warmup": warm})
    rates = {arm: [] for arm in SP_ARMS}
    arms = list(SP_ARMS)
    for rnd in range(SP_ROUNDS):
        for arm in (arms if rnd % 2 == 0 else arms[::-1]):
            port = clis[arm].port
            seconds = sum(two_tenants(port, h) for h in halves)
            rates[arm].append(2 * SP_ROWS / seconds)
            log(f"[server_planes] round {rnd} arm {arm} "
                f"{2 * SP_ROWS / seconds:.1f} rows/s")
    out = {}
    for arm, cli in clis.items():
        st = server_status(cli)
        q = node_doc(cli, "get_quality")
        u = node_doc(cli, "get_usage")
        doc = dict(flags=list(SP_ARMS[arm]),
                   rows_per_s=statistics.median(rates[arm]),
                   rows_per_s_runs=rates[arm],
                   flushes=st["microbatch.train_raw.flush_count"],
                   launches=server_launches(st))
        check(st["microbatch.train_raw.item_count"] ==
              SP_WARMUP_ROWS + SP_ROUNDS * 2 * SP_ROWS,
              f"{arm}: {st['microbatch.train_raw.item_count']} rows flushed")
        if arm == "planes_off":
            check(q == {} and u == {}, "planes_off still answers planes")
        else:
            preq = q["prequential"]
            calls = len(warm) + SP_ROUNDS * sum(
                len(b) for h in halves for b in h.values())
            if arm == "sample_all":
                # every call scores SP_SCORED rows, but the very first
                # meets a model with no labels yet
                check(calls - 2 <= preq["n"] // SP_SCORED <= calls,
                      f"sample_all scored {preq['n']} rows for {calls} "
                      "calls")
            doc["prequential"] = dict(
                n=preq["n"], correct=preq["correct"],
                accuracy=preq["correct"] / preq["n"] if preq["n"] else None)
            doc["drift"] = q["drift"]
            doc["quality_stats"] = q["stats"]
            rows_idx = FIELDS.index("rows")
            billed = {}
            for t in SP_TENANTS:
                row = u["table"][t]["train"]
                billed[t] = dict(zip(FIELDS, row))
                check(row[rows_idx] == SP_ROUNDS * SP_ROWS,
                      f"{arm}: {t} billed {row[rows_idx]} rows, sent "
                      f"{SP_ROUNDS * SP_ROWS}")
            doc["usage"] = billed
        out[arm] = doc
    fire = out["sample_all"]
    check(fire["prequential"]["accuracy"] is not None
          and 0.0 < fire["prequential"]["accuracy"] <= 1.0,
          "prequential accuracy out of range")
    return out


def sp_drill(cli, halves) -> dict:
    """The drift drill on its own server (SP_DRILL): the tenants' rows
    before the shift, the first window pinned as the reference, the rows
    after it; the drift SLO must fire, degrade the health and leave one
    incident bundle."""
    two_tenants(cli.port, halves[0])
    doc = wait_doc(cli, "get_quality",
                   lambda d: d["stats"]["reference_pinned"],
                   "the pinned quality reference")
    drill = {"reference_rows": doc["stats"]["recorded_rows"]}
    two_tenants(cli.port, halves[1])
    alerts = wait_doc(
        cli, "get_alerts",
        lambda d: any(a["name"] == "drift" for a in d["alerts"]),
        "the drift SLO firing")
    drill["alerts"] = alerts["alerts"]
    drill["slos"] = alerts["slos"]
    q = node_doc(cli, "get_quality")
    drill["drift"] = q["drift"]
    drill["prequential"] = q["prequential"]["n"]
    # arow.json's converter rides the raw-wire path, where feature names
    # never materialize: the values record under one "hashed" group
    check(q["drift"].get("hashed", 0.0) > 0.1,
          f"the shifted features drew no drift: {q['drift']}")
    bundles = node_doc(cli, "get_incidents", "")["incidents"]
    check(len(bundles) == 1, f"{len(bundles)} incident bundles, want 1")
    check(bundles[0]["reason"] == "slo_firing:drift",
          f"incident reason {bundles[0]['reason']!r}")
    drill["incident"] = bundles[0]
    health = server_status(cli)["health.reasons"]
    check(any(r["kind"] == "slo_firing" for r in health),
          "a firing SLO did not degrade the health")
    return drill



def sp_regression(cli, Datum, seed: int) -> dict:
    """regression default.json under --quality-sample 1.0, trained from
    one client in phase 9's calls; its prequential MAE against a CPU
    driver replaying the same test-then-train."""
    from jubatus_tpu_torch.models.regression import RegressionDriver
    from jubatus_tpu_torch.utils.usage import FIELDS

    rng = np.random.default_rng(seed + 1810)
    rows = [linear_example(rng, Datum, "regression", i)
            for i in range(SERVER_ROWS)]
    ref = RegressionDriver(load_config("regression", "default.json"),
                           device="cpu")
    abs_err, n = 0.0, 0
    t0 = time.perf_counter()
    for b in sp_batches(rows):
        check(cli.call("train", "smoke", b) == len(b), "train count")
    seconds = time.perf_counter() - t0
    for b in sp_batches(rows):
        sub = b[:SP_SCORED]
        for (truth, _d), est in zip(sub, ref.estimate([d for _, d in sub])):
            abs_err += abs(float(est) - float(truth))
            n += 1
        ref.train([(t, d) for t, d in b])
    q = node_doc(cli, "get_quality")["prequential"]
    check(q["n"] == n, f"prequential n {q['n']}, CPU replay {n}")
    mae, want = q["abs_err"] / q["n"], abs_err / n
    check(abs(mae - want) <= SP_MAE_RTOL * abs(want),
          f"prequential MAE {mae} against the CPU replay's {want}")
    st = server_status(cli)
    launches = server_launches(st)
    check(launches["pa_scan"] > 0, "the regression flushes launched no S1")
    u = node_doc(cli, "get_usage")
    return dict(rows=SERVER_ROWS, rows_per_s=SERVER_ROWS / seconds,
                prequential=dict(n=q["n"], mae=mae, cpu_replay_mae=want,
                                 rtol=SP_MAE_RTOL),
                billed_device_s=u["table"]["(untagged)"]["train"][
                    FIELDS.index("device_seconds")],
                launches=launches)


def sp_texts(rng):
    """The ux_splitter dictionary (SP_KEYWORDS words) and SP_TEXTS texts
    made of its words and of filler no keyword matches."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, int(rng.integers(4, 9))))
                    for _ in range(SP_KEYWORDS * 2)})[:SP_KEYWORDS]
    filler = ["0", "1", "2", "-", "+"]
    texts = []
    for _ in range(SP_TEXTS):
        parts = list(rng.choice(words, int(rng.integers(3, 9))))
        parts += list(rng.choice(filler, 3))
        rng.shuffle(parts)
        texts.append(" ".join(parts))
    return words, texts


def sp_nn_datum(rng, Datum, texts, weights, i: int):
    d = Datum()
    d.add("text", texts[int(rng.choice(len(texts), p=weights))])
    for j in rng.choice(16, 4, replace=False):
        d.add(f"f{j}", float(np.round(rng.standard_normal(), 3)))
    d.add("kind", f"k{i % 7}")
    return d


def sp_nn_config(seed: int):
    """lsh.json with a converter that splits "text" with the ux_splitter
    plugin over a dictionary written here; returns (config, its path, the
    texts of the rows)."""
    rng = np.random.default_rng(seed + 1820)
    words, texts = sp_texts(rng)
    os.makedirs(OUT_DIR, exist_ok=True)
    kw_path = os.path.join(OUT_DIR, "p18_keywords.txt")
    with open(kw_path, "w") as f:
        f.write("\n".join(words) + "\n")
    config = load_config("nearest_neighbor", "lsh.json")
    config["converter"] = {
        "string_types": {"ux": {"method": "dynamic", "path": "ux_splitter",
                                "function": "create",
                                "dict_path": kw_path}},
        "string_rules": [{"key": "text", "type": "ux", "sample_weight": "tf",
                          "global_weight": "bin"},
                         {"key": "kind", "type": "str",
                          "sample_weight": "bin", "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}]}
    return config, write_config("p18_lsh_ux.json", config), texts


def sp_nn(clis, config, texts, Datum, NearestNeighborDriver,
          seed: int) -> dict:
    """Two such servers, one with the memo caches and one with
    --fv-cache-size 0: 5,000 set_row each (both servers and the CPU port's
    driver filled at once), then 200 queries timed on each in turn (K1),
    the answers of the two and of the CPU driver fed the same rows
    agreeing."""
    import threading

    rng = np.random.default_rng(seed + 1821)
    zipf = 1.0 / np.arange(1, SP_TEXTS + 1)
    weights = zipf / zipf.sum()
    rows = [sp_nn_datum(rng, Datum, texts, weights, i)
            for i in range(SP_NN_ROWS)]
    queries = [sp_nn_datum(rng, Datum, texts, weights, SP_NN_ROWS + i)
               for i in range(SP_NN_QUERIES)]
    set_s, errors = {}, []

    def fill(key, cli):
        t0 = time.perf_counter()
        try:
            for i, d in enumerate(rows):
                if cli.call("set_row", "smoke", f"r{i}", d) is not True:
                    errors.append(f"{key}: set_row r{i} failed")
                    return
        except Exception as e:  # broad-ok — reported below
            errors.append(f"{key}: {e!r}")
        set_s[key] = time.perf_counter() - t0

    from jubatus_tpu_torch.rpc.client import RpcClient

    fill_clis = {k: RpcClient("127.0.0.1", c.port, timeout=120.0)
                 for k, c in clis.items()}
    threads = [threading.Thread(target=fill, args=kv)
               for kv in fill_clis.items()]
    for t in threads:
        t.start()
    ref = NearestNeighborDriver(config, device="cpu")
    for i, d in enumerate(rows):
        ref.set_row(f"r{i}", d)
    for t in threads:
        t.join()
    for c in fill_clis.values():
        c.close()
    check(not errors, f"set_row failed: {errors[:2]}")
    out, answers = {}, {}
    for key, cli in clis.items():
        st0 = server_status(cli)
        lat, got = [], []
        for q in queries:
            ans, ms = timed(cli.call, "neighbor_row_from_datum", "smoke", q,
                            10)
            lat.append(ms)
            got.append([tuple(x) for x in ans])
        st1 = server_status(cli)
        moved = (st1["kernel.sig_scan.hamming.launches"]
                 - st0["kernel.sig_scan.hamming.launches"])
        check(moved == SP_NN_QUERIES,
              f"{key}: K1 launches moved {moved} for {SP_NN_QUERIES} "
              "queries")
        answers[key] = got
        out[key] = dict(set_row_s=set_s[key],
                        set_rows_per_s=SP_NN_ROWS / set_s[key],
                        **pcts(lat), memo_hit_rate=st1["fv.memo_hit_rate"],
                        memo={c: {k: st1[f"fv.memo.{c}.{k}"]
                                  for k in ("entries", "hits", "misses")}
                              for c in ("filter", "token", "name")},
                        launches=server_launches(st1))
    for q, got, other in zip(queries, answers["memo"], answers["no_memo"]):
        want = ref.neighbor_row_from_datum(q, 10)
        compare_ranked(got, want, "ux_splitter server")
        compare_ranked(other, want, "ux_splitter server, no memo")
    check(out["memo"]["memo_hit_rate"] > 0.5,
          f"memo hit rate {out['memo']['memo_hit_rate']}")
    check(out["no_memo"]["memo_hit_rate"] == 0.0,
          "--fv-cache-size 0 still memoizes")
    return dict(rows=SP_NN_ROWS, queries=SP_NN_QUERIES, texts=SP_TEXTS,
                keywords=SP_KEYWORDS, **out)


def sp_billing(torch, Datum, seed: int) -> dict:
    """The usage ledger's "device seconds" beside CUDA-event time of the
    same flushes: an arow.json server in this process on the card, its
    train coalescer's device stage bracketed by events (the ledger bills
    the stage's host wall time, as the JAX package does)."""
    from jubatus_tpu_torch.rpc import principal as principals
    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.args import ServerArgs
    from jubatus_tpu_torch.utils.usage import FIELDS

    srv = EngineServer("classifier", load_config("classifier", "arow.json"),
                       ServerArgs(engine="classifier", listen_addr="127.0.0.1",
                                  telemetry_interval=0,
                                  datadir=server_datadir("p18_billing")),
                       device="cuda")
    port = srv.start(0)
    try:
        co = srv.coalescers["train_raw"]  # arow.json: the raw-wire path
        stage, pairs = co._flush, []

        def bracketed(prepared):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            try:
                return stage(prepared)
            finally:
                b.record()
                pairs.append((a, b))

        co._flush = bracketed
        rng = np.random.default_rng(seed + 1830)
        rows = sp_rows(rng, Datum, SP_ROWS)
        with principals.use("tenant-a"), \
                RpcClient("127.0.0.1", port, timeout=120.0) as c:
            for b in sp_batches(rows):
                check(c.call("train", "smoke", b) == len(b), "train count")
        torch.cuda.synchronize()
        event_s = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        row = srv.usage.snapshot()["table"]["tenant-a"]["train"]
        billed = row[FIELDS.index("device_seconds")]
        return dict(flushes=len(pairs), billed_device_s=billed,
                    cuda_event_s=event_s,
                    queue_s=row[FIELDS.index("queue_seconds")],
                    cpu_s=row[FIELDS.index("cpu_seconds")])
    finally:
        srv.stop()


def phase_server_planes(torch, Datum, NearestNeighborDriver,
                        seed: int) -> dict:
    """Phase 18 (see the module's docstring)."""
    shutil.rmtree(os.path.join(OUT_DIR, "p18_logs"), ignore_errors=True)
    nn_config, nn_path, texts = sp_nn_config(seed)
    clf = os.path.join(ROOT, "config", "classifier", "arow.json")
    specs = {arm: ("classifier", clf, flags)
             for arm, flags in SP_ARMS.items()}
    specs["drill"] = ("classifier", clf, SP_DRILL)
    specs["regression"] = ("regression", os.path.join(
        ROOT, "config", "regression", "default.json"),
        ("--quality-sample", "1.0"))
    specs["memo"] = ("nearest_neighbor", nn_path, ())
    specs["no_memo"] = ("nearest_neighbor", nn_path,
                        ("--fv-cache-size", "0"))
    # all seven processes start at once; nothing is driven before every
    # one answers
    started = {key: sp_start(engine, path, key, extra)
               for key, (engine, path, extra) in specs.items()}
    with contextlib.ExitStack() as stack:
        clis = {}
        for key, (st, logdir) in started.items():
            engine, path, _extra = specs[key]
            clis[key] = stack.enter_context(serving(engine, path, st))
            sp_log_check(logdir, engine)
        halves, warm = sp_stream(Datum, seed)
        arms = sp_arms({a: clis[a] for a in SP_ARMS}, halves, warm)
        drill = sp_drill(clis["drill"], halves)
        reg = sp_regression(clis["regression"], Datum, seed)
        nn = sp_nn({k: clis[k] for k in ("memo", "no_memo")}, nn_config,
                   texts, Datum, NearestNeighborDriver, seed)
    billing = sp_billing(torch, Datum, seed)
    total = {m: 0 for m in RECORDED}
    for doc in (*arms.values(), reg, nn["memo"], nn["no_memo"]):
        for m in RECORDED:
            total[m] += doc["launches"][m]
    return dict(arms=arms, drill=drill, regression=reg, nearest_neighbor=nn,
                billing=billing, server_launches=total)


# ---------------------------------------------------------------------------
# phase 19: the control loops and the legacy wire
# ---------------------------------------------------------------------------
TUNE_BURST_CALLS = 40         # train calls of LINEAR_BATCH rows a burst
TUNE_MIN_BURSTS = 2           # bursts before the coalescer check
TUNE_MAX_BURSTS = 12          # bursts before the on server must have moved
TUNE_PAUSE_S = 1.5            # pause between bursts (a telemetry tick and a half)
TUNE_ESTIMATES = 200          # estimate calls held across the two servers
MIXTUNE_ROUNDS = 4            # hand-ticked rounds of the collective pair
MIXTUNE_ROWS = 512            # arow.json rows a round, half per member
AS_CLIENTS = 8                # heavy clients at the regression proxy
AS_BATCH = 1024               # rows a heavy client's train call (the
#                               coalescer queues behind longer flushes)
AS_BURST_S = 4.0              # the burst that sets --queue-hot
AS_COOLDOWN_S = 20.0          # --cooldown: above a member's boot on the
#                               card (6.8-12.8 s measured from the
#                               scale-out to answering), so the load may
#                               run on until the new member answers with
#                               no 4th spawn
AS_WAIT_S = 180               # longest wait for a spawn, an answer, a drain
LEGACY_ROWS = 500             # set_row calls before the legacy sessions
LEGACY_QUERIES = 200          # timed neighbor_row_from_datum, each wire


def phase_tune_coalescer(Datum, EngineServer, ServerArgs, online_scan,
                         seed: int) -> dict:
    """Two regression ``default.json`` servers in this process on the card
    with ``--telemetry-interval 1``, one ``--auto-tune on`` and one
    ``--auto-tune observe``, fed one client's stream of phase 9's rows in
    calls of LINEAR_BATCH (each call to both servers in turn, so both see
    the same order), in bursts of TUNE_BURST_CALLS calls with TUNE_PAUSE_S
    pauses. The ``on`` server's coalescer depth must move and ``get_tune``
    journal it (``tune.applies`` >= 1); the ``observe`` server's must not,
    and its journal must hold the dry-run intents; S1 must launch for
    both; TUNE_ESTIMATES ``estimate`` answers agree across the two within
    SCAN_CARD_TOL. Each tuner tick that the telemetry thread runs is timed
    on the host."""
    from jubatus_tpu_torch.cmd import jubactl
    from jubatus_tpu_torch.rpc.client import RpcClient

    config = load_config("regression", "default.json")
    servers, clis, tick_ms = {}, {}, {}
    for mode in ("on", "observe"):
        srv = EngineServer("regression", config, ServerArgs(
            engine="regression", listen_addr="127.0.0.1",
            telemetry_interval=1.0, auto_tune=mode,
            datadir=server_datadir(f"tune_{mode}")), device="cuda")
        check(srv.tuner is not None and srv.tuner.dry_run == (
            mode == "observe"), f"--auto-tune {mode}: no tuner")
        ticks = tick_ms[mode] = []

        def timed_tick(now=None, _tick=srv.tuner.tick, _out=ticks):
            t0 = time.perf_counter()
            _tick(now)
            _out.append((time.perf_counter() - t0) * 1e3)

        srv.tuner.tick = timed_tick
        servers[mode] = srv
    try:
        for mode, srv in servers.items():
            clis[mode] = RpcClient("127.0.0.1", srv.start(0), timeout=120.0)
        # default.json's converter rides the raw-wire path: its coalescer
        # is the one the stream loads
        depth0 = {m: s.coalescers["train_raw"].max_batch
                  for m, s in servers.items()}
        rng = np.random.default_rng(seed + 1901)
        s1 = {m: 0 for m in servers}
        bursts, i, t0 = 0, 0, time.perf_counter()
        while bursts < TUNE_MIN_BURSTS or (
                servers["on"].coalescers["train_raw"].max_batch
                == depth0["on"]
                and bursts < TUNE_MAX_BURSTS):
            for _ in range(TUNE_BURST_CALLS):
                batch = [linear_example(rng, Datum, "regression", i + k)
                         for k in range(LINEAR_BATCH)]
                i += LINEAR_BATCH
                for mode in ("on", "observe"):
                    before = online_scan.pa_scan.launches
                    check(clis[mode].call("train", "smoke", batch)
                          == len(batch), f"{mode}: train count")
                    s1[mode] += online_scan.pa_scan.launches - before
            bursts += 1
            time.sleep(TUNE_PAUSE_S)
        stream_s = time.perf_counter() - t0
        docs = {m: next(iter(clis[m].call("get_tune", "smoke").values()))
                for m in servers}
        depth = {m: s.coalescers["train_raw"].max_batch
                 for m, s in servers.items()}
        check(depth["on"] != depth0["on"], f"--auto-tune on: the train "
              f"coalescer stayed at {depth0['on']} after {bursts} bursts")
        check(depth["observe"] == depth0["observe"],
              f"--auto-tune observe moved the coalescer to "
              f"{depth['observe']}")
        applied = [r for r in docs["on"]["journal"]
                   if r.get("target") == "train_raw"
                   and r["action"] in ("deepen", "shallow")
                   and not r.get("dry_run")]
        check(applied and applied[-1]["signals"]["depth"] == depth["on"],
              f"get_tune journals no applied move: {docs['on']['journal']}")
        applies = servers["on"].trace.counters().get("tune.applies", 0)
        check(applies >= 1, f"tune.applies {applies}")
        intents = [r for r in docs["observe"]["journal"]
                   if r.get("dry_run")]
        check(intents and all(r.get("dry_run")
                              for r in docs["observe"]["journal"]),
              f"observe journal: {docs['observe']['journal']}")
        check(s1["on"] > 0 and s1["observe"] > 0, f"S1 launches {s1}")
        worst = 0.0
        for k in range(TUNE_ESTIMATES):
            q = [server_datum(rng, Datum, i + k)]
            a = clis["on"].call("estimate", "smoke", q)[0]
            b = clis["observe"].call("estimate", "smoke", q)[0]
            check(np.isfinite(a) and np.isfinite(b), "estimate not finite")
            err = abs(a - b) / max(1.0, abs(b))
            worst = max(worst, err)
        check(worst <= SCAN_CARD_TOL,
              f"estimates differ across the tuned servers: {worst}")
        ticks = tick_ms["on"] + tick_ms["observe"]
        check(ticks, "the telemetry thread ran no tuner tick")
        return dict(
            config="config/regression/default.json",
            rows=i, bursts=bursts, stream_s=stream_s,
            max_batch_before=depth0, max_batch_after=depth,
            applies=applies, s1_launches=s1,
            estimates=TUNE_ESTIMATES, estimate_max_rel_err=worst,
            tick_ms=dict(count=len(ticks), p50=statistics.median(ticks),
                         max=max(ticks),
                         on=statistics.median(tick_ms["on"])
                         if tick_ms["on"] else None,
                         observe=statistics.median(tick_ms["observe"])
                         if tick_ms["observe"] else None),
            journal_on=applied[-1], journal_observe=intents[-1],
            view=jubactl.render_tune("regression", "smoke", {
                "auto_tune_on": docs["on"],
                "auto_tune_observe": docs["observe"]}, last=3).splitlines())
    finally:
        for c in clis.values():
            c.close()
        for s in servers.values():
            s.stop()


_TUNE_RANK = r"""
import json, sys, threading, time
sys.path.insert(0, ".")
import numpy as np
import chip_smoke as cs
from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.perf_tuner import (PerfTuner,
                                                ServerTuneAdapter, TunerConfig)
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.parallel import multihost
from jubatus_tpu_torch.parallel.collective import _norm_compress
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
d, rounds, rows_per = sys.argv[4], int(sys.argv[5]), int(sys.argv[6])
seed, timeout = int(sys.argv[7]), float(sys.argv[8])
assert multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=n, process_id=rank, device="cuda",
                            timeout=timeout)
srv = EngineServer("classifier", cs.load_config("classifier", "arow.json"),
                   ServerArgs(engine="classifier", coordinator=f"file://{d}",
                              name="tune", listen_addr="127.0.0.1",
                              mixer="collective_mixer", interval_sec=1e9,
                              interval_count=1 << 30, telemetry_interval=0,
                              datadir=cs.server_datadir(f"mixtune{rank}")),
                   device="cuda")
done = threading.Event()
srv.rpc.register("smoke_set_wire_plan", lambda mode, chunk: bool(
    srv.mixer.set_wire_plan(chunk_mb=chunk, compress=mode)), arity=2)
srv.rpc.register("smoke_finish", lambda: done.set() or True, arity=0)
srv.start(0)

def plan():
    return [_norm_compress(srv.mixer.compress), srv.mixer.chunk_mb]

def mixer_status(c):
    st = next(iter(c.call("get_status", "tune").values()))
    return st["mixer.collective_rounds"], st["mixer.fallback_rounds"]

if rank:
    done.wait(timeout)
    print("RESULT " + json.dumps({"plan": plan()}), flush=True)
else:
    deadline = time.time() + timeout
    while len(membership.get_all_actives(srv.coord, "classifier",
                                         "tune")) < n:
        assert time.time() < deadline, "the peer never joined"
        time.sleep(0.2)
    (peer,) = [m for m in membership.get_all_actives(
        srv.coord, "classifier", "tune") if m.port != srv.rpc.port]
    me = RpcClient("127.0.0.1", srv.rpc.port, timeout=timeout)
    pc = RpcClient(peer.host, peer.port, timeout=timeout)
    tuner = PerfTuner(TunerConfig(mode="on", cooldown_s=0.0, confirm=1,
                                  settle_rounds=1),
                      ServerTuneAdapter(srv), registry=srv.trace)
    rng = np.random.default_rng(seed)
    out, pending = [], None
    for k in range(rounds + 2):
        rows = [cs.linear_example(rng, Datum, "classifier", i)
                for i in range(rows_per)]
        for r, c in enumerate((me, pc)):
            mine = rows[r::n]
            for lo in range(0, len(mine), cs.LINEAR_BATCH):
                c.call("train", "tune", mine[lo:lo + cs.LINEAR_BATCH])
        col0, fb0 = mixer_status(me)
        t0 = time.perf_counter()
        assert me.call("do_mix", "tune") is True
        ms = (time.perf_counter() - t0) * 1e3
        col1, fb1 = mixer_status(me)
        rec = [h for h in srv.mixer.flight.snapshot()
               if h.get("mode") == "collective"][-1]
        out.append(dict(round=k + 1, plan=plan(), peer_behind=pending
                        is not None, do_mix_ms=ms,
                        collective=col1 - col0, fallback=fb1 - fb0,
                        reason=rec.get("reason", "")))
        if pending is not None:  # the peer takes the plan a round late
            pc.call("smoke_set_wire_plan", *pending)
            pending = None
        if k < rounds:  # the last two rounds are the check: no tick
            before = plan()
            tuner.tick()
            if plan() != before:
                pending = plan()
    paths = [next(v for key, v in c.call("save", "tune", "mixtune").items()
                  if not key.startswith("store:")) for c in (me, pc)]
    journal = [{k: v for k, v in r.items() if k not in ("hlc", "event_hlc")}
               for r in tuner.journal_tail(16)]
    pc.call("smoke_finish")
    print("RESULT " + json.dumps(dict(rounds=out, saved=paths,
                                      journal=journal, plan=plan())),
          flush=True)
srv.stop()
multihost.shutdown()
"""


def phase_tune_mix(seed: int) -> dict:
    """Two ``arow.json`` members under ``--mixer collective_mixer`` as the
    two gloo ranks of one world on cuda:0 (spawned as phase 16's ranks
    are), rank 0 the master. MIXTUNE_ROUNDS rounds (each member trains
    half of MIXTUNE_ROWS rows, then ``do_mix``), rank 0's PerfTuner ticked
    by hand after each with cooldown 0: a plan it applies is the master's
    alone for the next round, and the peer takes it after that round, as
    a fleet rolling a change out member by member does. Every such round
    must fall back to the RPC mix with ``prepare_not_viable`` (exactly one
    round a change), every other round ride the collective, the plan
    change at least once; two more rounds with no tick follow (the second
    rides the collective again), after which the members' saved models
    are equal bit for bit."""
    from jubatus_tpu_torch.parallel import multihost

    d = fleet_dir("mixtune")
    t0 = time.perf_counter()
    outs, rcs = multihost.run_local_world(
        _TUNE_RANK, 2, args=(d, MIXTUNE_ROUNDS, MIXTUNE_ROWS, seed + 1902,
                             COL_GROUP_TIMEOUT),
        timeout=COL_WORLD_TIMEOUT, cwd=ROOT)
    wall = time.perf_counter() - t0
    res = []
    for r, (text, rc) in enumerate(zip(outs, rcs)):
        if rc != 0 or "RESULT " not in text:
            print(f"--- mixtune rank {r} output:\n{text[-4000:]}",
                  file=sys.stderr)
        check(rc == 0 and "RESULT " in text, f"mixtune rank {r} exited {rc}")
        res.append(json.loads(text.split("RESULT ")[1].splitlines()[0]))
    rounds = res[0]["rounds"]
    changes = sum(1 for rd in rounds if rd["peer_behind"])
    check(changes >= 1, f"the wire plan never changed: {rounds}")
    for rd in rounds:
        if rd["peer_behind"]:
            check(rd["fallback"] == 1 and rd["collective"] == 0
                  and "prepare_not_viable" in rd["reason"],
                  f"round {rd['round']} after a change: {rd}")
        else:
            check(rd["collective"] == 1 and rd["fallback"] == 0,
                  f"round {rd['round']} with both on one plan: {rd}")
    check(not rounds[-1]["peer_behind"] and rounds[-1]["collective"] == 1,
          f"the last round did not ride the collective: {rounds[-1]}")
    check(res[0]["plan"] == res[1]["plan"],
          f"the members end on plans {res[0]['plan']} and {res[1]['plan']}")
    models = [saved_model(p) for p in res[0]["saved"]]
    model_close(models[1], models[0], 0.0, "the tuned pair after the last "
                "round")
    return dict(config="config/classifier/arow.json", ranks=2,
                backend="gloo", device="cuda:0", rounds=rounds,
                changes=changes,
                fallback_rounds=sum(rd["fallback"] for rd in rounds),
                final_plan=res[0]["plan"], bit_equal=True, wall_s=wall,
                journal=res[0]["journal"])


def fleet_autoscale(Datum, seed: int, locator: str, view, d: str,
                    proxies: dict, visor_pid: int, procs: list) -> dict:
    """On phase 13's fleet (its jubacoordd, jubavisor and regression
    proxies): AS_CLIENTS clients train through the default regression
    proxy, whose C++ relay forwards their calls (each call's params packed
    once, so the clients outpace the members); a
    burst of AS_BURST_S sets ``--queue-hot`` to half the queued rows per
    member it shows; then ``jubactl -c autoscale --min 2 --max 3
    --autoscale-interval 1 --scale-out-confirm 2 --cooldown 20
    --scale-in-confirm 3`` runs as a process until the visor has spawned a
    third member on the card (it must hold /dev/nvidia* nodes) and the
    member answers through the proxy; then the heavy clients stop, one
    light client goes on through the Python-transport regression proxy
    (which re-routes a draining member's refusal, where the relay hands it
    to the client), and once the cooldown is over the loop drains a
    member. Client errors must be 0
    throughout, the journal must hold one scale-out and one scale-in. S1
    launches are read from every regression member's get_status (the
    drained one's last reading before it left)."""
    import threading

    import msgpack

    from jubatus_tpu_torch.cmd import jubactl
    from jubatus_tpu_torch.coord import membership
    from jubatus_tpu_torch.rpc.client import RpcClient

    reg_name = FLEET_ENGINES[2][1]
    reg_port = proxies["regression"]
    light_port = proxies["regression_py"]
    actives = lambda: {m.name: m for m in membership.get_all_actives(  # noqa: E731
        view, "regression", reg_name)}
    start = actives()
    check(len(start) == 2, f"regression actives {sorted(start)}")
    s1_seen: dict = {}

    def read_s1():
        for name, m in actives().items():
            try:
                with RpcClient(m.host, m.port, timeout=30.0) as c:
                    st = next(iter(c.call("get_status", reg_name).values()))
                s1_seen[name] = server_launches(st)
            except Exception:  # broad-ok — it may be leaving
                pass

    read_s1()
    s1_start = dict(s1_seen)
    rng = np.random.default_rng(seed + 1903)
    rows = [linear_example(rng, Datum, "regression", i)
            for i in range(8 * AS_BATCH)]
    # each call's params packed once: clients encoding rows in this
    # process are slower than the members' raw-wire ingest, and the queue
    # the autoscaler reads would not stay hot
    packed = {size: [msgpack.packb([reg_name, [[t, d.to_msgpack()]
                                               for t, d in rows[lo:lo + size]]])
                     for lo in range(0, len(rows), size)]
              for size in (AS_BATCH, LINEAR_BATCH)}
    errors, calls = [], [0]
    heavy_stop, light_stop = threading.Event(), threading.Event()

    def client(stop, pause, size, port=reg_port):
        with RpcClient("127.0.0.1", port, timeout=300.0) as c:
            k = 0
            while not stop.is_set():
                try:
                    n = msgpack.unpackb(c.call_raw(
                        "train", packed[size][k % len(packed[size])]))
                    if n != size:
                        errors.append(f"short count {n}")
                    calls[0] += 1
                except Exception as e:  # broad-ok — counted, checked
                    errors.append(repr(e))
                k += 1
                if pause:
                    time.sleep(pause)

    threads = [threading.Thread(target=client,
                                args=(heavy_stop, 0.0, AS_BATCH),
                                daemon=True) for _ in range(AS_CLIENTS)]
    threads.append(threading.Thread(target=client,
                                    args=(light_stop, 0.2, LINEAR_BATCH,
                                          light_port),
                                    daemon=True))
    for t in threads:
        t.start()
    scaler = None
    try:
        # the burst: each member's queue gauge as its telemetry tick
        # sampled it into the time series, the points the autoscaler reads
        t0 = time.time()  # wall-clock, as the points' ts
        time.sleep(AS_BURST_S)
        samples = []
        for m in start.values():
            with RpcClient(m.host, m.port, timeout=30.0) as c:
                pts = next(iter(c.call("get_timeseries",
                                       reg_name).values()))["points"]
            samples += [p["gauges"].get("microbatch.queue_depth", 0.0)
                        for p in pts if p["ts"] >= t0]
        check(samples, "the members' time series took no point in the "
              "burst")
        queued = statistics.fmean(samples)
        queue_hot = max(1.0, round(queued / 2.0))
        check(queued > 0, f"{AS_CLIENTS} clients queued no rows: {samples}")
        scaler = spawn("autoscale", "jubatus_tpu_torch.cmd.jubactl", "-c",
                       "autoscale", "-t", "regression", "-n", reg_name,
                       "-z", locator, "--min", "2", "--max", "3",
                       "--autoscale-interval", "1", "--scale-out-confirm",
                       "2", "--queue-hot", str(queue_hot), "--cooldown",
                       str(AS_COOLDOWN_S),
                       "--scale-in-confirm", "3", "--window", "10",
                       "-D", d, "-C", "4", "-S", str(10 ** 9),
                       "-I", str(1 << 30))
        procs.append(scaler)
        wait_for(lambda: membership.get_autoscalers(view),
                 "the autoscaler never registered", AS_WAIT_S)
        (node,) = membership.get_autoscalers(view)
        acli = RpcClient(node.host, node.port, timeout=30.0)

        def journal():
            return next(iter(acli.call("get_autoscale_status", reg_name,
                                       256).values()))["journal"]

        def first(pred):
            return next((r for r in journal() if pred(r)), None)

        wait_for(lambda: first(lambda r: r["action"] == "scale_out"),
                 "no scale-out", AS_WAIT_S)
        hot = first(lambda r: r["reason"] in ("hot_unconfirmed",
                                              "sustained_hot"))
        out_rec = first(lambda r: r["action"] == "scale_out")
        check(out_rec["reason"] == "sustained_hot",
              f"scale-out record {out_rec}")
        wait_for(lambda: len(actives()) == 3, "the spawned member never "
                 "joined the actives", AS_WAIT_S)
        new = (set(actives()) - set(start)).pop()
        new_port = new.rpartition("_")[2]
        new_pids = [p for p in children_of(visor_pid)
                    if new_port in open(f"/proc/{p}/cmdline").read()
                    .split("\0")]
        check(len(new_pids) == 1, f"the spawned member's process {new_pids}")
        fds = cuda_device_fds(new_pids[0])
        check(fds, "the spawned member holds no /dev/nvidia* node")
        with RpcClient("127.0.0.1", reg_port, timeout=300.0) as pc:
            deadline = time.time() + AS_WAIT_S
            while new not in pc.call("get_status", reg_name):
                check(time.time() < deadline, "the spawned member never "
                      "answered through the proxy")
                time.sleep(0.1)
        t_answer = time.time()  # wall-clock, as the journal's ts
        # the load stops once the new member answers (the hot polls while
        # it booted met the cooldown); the cold polls that follow drain
        # one member when the cooldown is over
        heavy_stop.set()
        for t in threads[:-1]:
            t.join(timeout=300)
        read_s1()
        wait_for(lambda: first(lambda r: r["action"] == "scale_in"),
                 "no scale-in", AS_WAIT_S)
        in_rec = first(lambda r: r["action"] == "scale_in")
        target = in_rec["target"]

        def left():
            read_s1()
            return target not in actives()

        wait_for(left, f"{target} never left the actives", AS_WAIT_S)
        t_left = time.time()  # wall-clock, as the journal's ts
        wait_for(lambda: target not in {m.name for m in
                                        membership.get_all_nodes(
                                            view, "regression", reg_name)},
                 f"{target} never exited", AS_WAIT_S)
        t_exit = time.time()  # wall-clock, as the journal's ts
        light_stop.set()
        threads[-1].join(timeout=300)
        check(not errors, f"{len(errors)} client errors: {errors[:3]}")
        rc, frame = ctl(jubactl, "-c", "autoscale", "--watch", "--once",
                        "-t", "regression", "-n", reg_name, "-z", locator)
        check(rc == 0 and "autoscaler" in frame, f"-c autoscale --watch "
              f"--once: {frame}")
        recs = journal()
        acts = [r["action"] for r in recs]
        check(acts.count("scale_out") == 1 and acts.count("scale_in") == 1
              and "blocked" not in acts, f"journal actions {acts}")
        acli.close()
        launches = {m: sum(n[m] - s1_start.get(k, {}).get(m, 0)
                           for k, n in s1_seen.items()) for m in RECORDED}
        s1 = launches["pa_scan"]
        check(s1 > 0, "S1 never launched on the autoscaled fleet")
        return dict(
            clients=AS_CLIENTS, burst_queue_per_member=queued,
            queue_hot=queue_hot, train_calls=calls[0], client_errors=0,
            first_hot_poll_to_answer_s=t_answer - hot["ts"],
            scale_out_to_answer_s=t_answer - out_rec["ts"],
            scale_in_to_left_s=t_left - in_rec["ts"],
            scale_in_to_exit_s=t_exit - in_rec["ts"],
            spawned=new, drained=target, spawned_cuda_nodes=fds,
            journal_actions={a: acts.count(a) for a in set(acts)},
            s1_launches=s1, watch_frame=frame.splitlines(),
            server_launches=launches)
    finally:
        heavy_stop.set()
        light_stop.set()
        if scaler is not None:
            stop_server(scaler[0])


class LegacyWireClient:
    """A pre-2013 jubatus client: requests packed in the old format (raw
    strings, no str8/bin), each response framed and parsed by the port's
    ``legacy.unpackb``, which refuses every post-2013 type byte."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=120)
        self.msgid = 0
        self.buf = b""

    def close(self):
        self.sock.close()

    def call(self, method: str, *params):
        import msgpack

        from jubatus_tpu_torch.rpc import legacy

        self.msgid += 1
        self.sock.sendall(msgpack.packb([0, self.msgid, method, list(params)],
                                        use_bin_type=False))
        while True:
            if self.buf:
                try:
                    obj, off = legacy._decode(memoryview(self.buf), 0)
                except legacy.LegacyFormatError as e:
                    check("truncated" in str(e),
                          f"{method}: a legacy client cannot parse the "
                          f"answer ({e})")
                else:
                    self.buf = self.buf[off:]
                    kind, msgid, error, result = obj
                    check(kind == 1 and msgid == self.msgid and error is None,
                          f"{method}: {error!r}")
                    return result
            chunk = self.sock.recv(65536)
            check(bool(chunk), f"{method}: the server closed the connection")
            self.buf += chunk


def as_text(x):
    """A legacy answer (every string raw bytes) in a modern client's
    terms."""
    if isinstance(x, bytes):
        return x.decode("utf-8", "surrogateescape")
    if isinstance(x, (list, tuple)):
        return [as_text(v) for v in x]
    if isinstance(x, dict):
        return {as_text(k): as_text(v) for k, v in x.items()}
    return x


def start_legacy_server():
    """Phase 19's lsh.json server (no wire flag, no telemetry tick, on a
    file coordinator of its own) and a proxy in front of it started with
    ``--legacy-wire``, neither waited for: (start_server's tuple, the
    proxy's spawn pair, the proxy's port)."""
    d = fleet_dir("legacy19")
    pport = free_port()
    server = start_server("nearest_neighbor", os.path.join(
        ROOT, "config", "nearest_neighbor", "lsh.json"), tag="_legacy",
        extra=("-z", f"file://{d}", "-n", "leg", "-s", "1e9",
               "-i", str(1 << 30), "--telemetry-interval", "0"))
    proxy = spawn("proxy_legacy", "jubatus_tpu_torch.server.proxy",
                  "nearest_neighbor", "-z", f"file://{d}", "-p", str(pport),
                  "-b", "127.0.0.1", "--legacy-wire",
                  "--telemetry-interval", "0", "--incident-dir",
                  server_datadir(f"proxy_legacy_{pport}"))
    return server, proxy, pport


def phase_legacy_wire(Datum, seed: int, started=None) -> dict:
    """One ``lsh.json`` server on the card (no wire flag: it detects each
    connection's format) and a proxy in front of it started with
    ``--legacy-wire``. LEGACY_ROWS rows by a modern client, then legacy
    sessions direct and through the proxy (``set_row``,
    ``neighbor_row_from_datum``, ``get_config``, ``get_status``): every
    answer parses with the pre-2013 unpacker and equals a modern client's
    (``get_status`` by its keys); K1 must launch; a modern client's request
    with a str8 byte gets a modern answer from the same server. Then
    LEGACY_QUERIES ``neighbor_row_from_datum`` on each wire, direct (p50,
    p99). ``started``: start_legacy_server's triple, when the two were
    started earlier (their boot overlaps other work)."""
    import msgpack

    from jubatus_tpu_torch.rpc import legacy
    from jubatus_tpu_torch.rpc.client import RpcClient

    started, proxy, pport = started or start_legacy_server()
    name = "leg"
    try:
        with serving("nearest_neighbor", "", started) as cli:
            rng = np.random.default_rng(seed + 1904)
            for i in range(LEGACY_ROWS):
                check(cli.call("set_row", name, f"r{i}",
                               server_datum(rng, Datum, i)) is True,
                      "set_row")
            k1_0 = server_launches(server_status(cli))["hamming"]
            pcli = RpcClient("127.0.0.1", pport, timeout=120.0)
            wait_for(lambda: answers_ok(pcli, "get_proxy_status", name),
                     "the legacy proxy never answered", 120)
            sessions = {}
            for where, port, modern in (("direct", started[1], cli),
                                        ("proxy", pport, pcli)):
                lc = LegacyWireClient(port)
                q = server_datum(rng, Datum, LEGACY_ROWS + len(sessions))
                wire = q.to_msgpack()
                got = dict(
                    set_row=lc.call("set_row", name, f"l_{where}", wire),
                    neighbor_row_from_datum=lc.call(
                        "neighbor_row_from_datum", name, wire, 10),
                    get_config=lc.call("get_config", name),
                    get_status=lc.call("get_status", name))
                lc.close()
                want = dict(
                    set_row=modern.call("set_row", name, f"l_{where}", q),
                    neighbor_row_from_datum=modern.call(
                        "neighbor_row_from_datum", name, q, 10),
                    get_config=modern.call("get_config", name),
                    get_status=modern.call("get_status", name))
                for method in ("set_row", "neighbor_row_from_datum",
                               "get_config"):
                    g, w = as_text(got[method]), want[method]
                    if method == "neighbor_row_from_datum":
                        w = [list(r) for r in w]
                    check(g == w, f"{where} {method}: legacy {g!r} vs "
                          f"modern {w!r}")
                gst, wst = as_text(got["get_status"]), want["get_status"]
                diff = {k: sorted(set(gst.get(k, {})) ^ set(wst.get(k, {})))
                        for k in set(gst) | set(wst)}
                check(set(gst) == set(wst) and not any(diff.values()),
                      f"{where} get_status keys differ: {diff}")
                check(isinstance(got["get_config"], bytes)
                      and len(got["get_config"]) > 31,
                      f"{where} get_config did not come as old raw")
                sessions[where] = dict(
                    neighbors=len(got["neighbor_row_from_datum"]),
                    status_keys=sum(len(v) for v in gst.values()))
            pcli.close()
            # a modern request (a str8 byte) on the detecting server: the
            # answer (its status map holds strings of 32 to 255 bytes)
            # must carry str8, which the old unpacker refuses
            with socket.create_connection(("127.0.0.1", started[1]),
                                          timeout=120) as s:
                s.sendall(msgpack.packb([0, 1, "get_status", ["m" * 40]],
                                        use_bin_type=True))
                buf = b""
                modern_kept = None
                while modern_kept is None:
                    buf += s.recv(65536)
                    try:
                        legacy.unpackb(buf)
                        modern_kept = False
                    except legacy.LegacyFormatError as e:
                        if "truncated" not in str(e):
                            modern_kept = True
            check(modern_kept, "a modern client was answered in the old "
                  "format")
            lat = {"legacy": [], "modern": []}
            lc = LegacyWireClient(started[1])
            for i in range(LEGACY_QUERIES):
                q = server_datum(rng, Datum, i)
                for wire_kind in ("legacy", "modern"):
                    if wire_kind == "legacy":
                        _, ms = timed(lc.call, "neighbor_row_from_datum",
                                      name, q.to_msgpack(), 10)
                    else:
                        _, ms = timed(cli.call, "neighbor_row_from_datum",
                                      name, q, 10)
                    lat[wire_kind].append(ms)
            lc.close()
            st = server_status(cli)
            k1 = server_launches(st)["hamming"] - k1_0
            check(k1 >= 2 * LEGACY_QUERIES + 4, f"K1 launched {k1} times for "
                  f"{2 * LEGACY_QUERIES + 4} queries")
            launches = {m: 0 for m in RECORDED}
            add_launches(launches, st)
        return dict(config="config/nearest_neighbor/lsh.json",
                    rows=LEGACY_ROWS, sessions=sessions,
                    modern_client_stays_modern=True,
                    k1_launches=k1,
                    neighbor_row_from_datum={k: pcts(v)
                                             for k, v in lat.items()},
                    server_launches=launches)
    finally:
        stop_server(proxy[0])


# ---------------------------------------------------------------------------
# phase 20: ZooKeeper sessions and the ring scan
# ---------------------------------------------------------------------------
ZK_SETS = 1_000               # set_row calls through the NN proxy (cut
                              # from 2,000 for the run's limit: phase 13
                              # makes 2,000 through its proxy)
ZK_QUERIES = 200              # neighbor_row_from_datum through the proxy
ZK_TRAIN = 2_000              # regression rows through its proxy
ZK_BATCH = 256                # rows per train call
ZK_AFTER_LEAVE = 50           # proxied queries once a member has left
ZK_WAIT_S = 180               # longest wait for a boot, a join or a leave
ZK_FLEET = (("nearest_neighbor", "lsh.json"), ("nearest_neighbor", "lsh.json"),
            ("regression", "default.json"), ("regression", "default.json"))
RING_SHARDS = 4               # logical shards of cuda:0 (ShardMesh)
RING_ROWS = 1 << 20           # the hamming ring's table (hash_num 64, W = 2)
RING_B = 1_024                # queries, RING_B / RING_SHARDS to a shard
RING_K = 10
RING_EUCLID_ROWS = 1 << 16    # the euclid ring's sparse table
RING_EUCLID_NNZ = 32
RING_EUCLID_DIM = 1 << 16     # the dense queries' width
RING_EUCLID_B = 256
RING_EUCLID_TOL = 1e-5        # euclid distances, ring against the flat scan
#                               (rtol and atol; float32 sums in another order)
RING_REPS = 10                # CUDA-event timings per call (median)
HIER_ROWS = 1 << 20           # embedded rows of the two-level assignment
HIER_CELLS = 1_024
HIER_DIM = 64
HIER_SUPERS = 32              # ≈ √cells super-groups
HIER_TOP = 2                  # probed super-groups a row
HIER_CHUNK = 1 << 18          # rows per assign call: the hierarchical
#                               gather holds [chunk, top·M, E] floats


@contextlib.contextmanager
def zk_ensemble():
    """(locator, what) of the ensemble phase 20 runs on: the one
    ``JUBATUS_TPU_ZK`` names (host:port[,...]), else tests/fake_zk.py's
    FakeZkServer in this process (stdlib only, the jute wire)."""
    spec = os.environ.get("JUBATUS_TPU_ZK", "")
    if spec:
        yield f"zk://{spec}", f"JUBATUS_TPU_ZK={spec}"
        return
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from fake_zk import FakeZkServer
    finally:
        sys.path.pop(0)
    srv = FakeZkServer()
    port = srv.start(0)
    try:
        yield f"zk://127.0.0.1:{port}", "tests/fake_zk.py FakeZkServer"
    finally:
        srv.stop()


def start_zk_fleet(stack) -> dict:
    """Phase 20's fleet on one ``zk://`` locator, started at once and not
    waited for: two nearest_neighbor ``lsh.json`` members, two regression
    ``default.json`` members (each its own process on the card) and one
    port proxy per engine. ``stack`` stops them all and the ensemble."""
    locator, ensemble = stack.enter_context(zk_ensemble())
    log(f"[zk_fleet] ensemble: {ensemble} ({locator})")
    tag = f"{os.getpid()}_{int(time.time())}"
    names = {"nearest_neighbor": f"zk_nn_{tag}", "regression": f"zk_reg_{tag}"}
    fleet = dict(locator=locator, ensemble=ensemble, names=names,
                 members={}, proxies={})
    for i, (engine, config) in enumerate(ZK_FLEET):
        started = start_server(engine, os.path.join(
            ROOT, "config", engine, config), tag=f"_zk{i}", extra=(
                "-z", locator, "-n", names[engine], "-s", "1e9",
                "-i", str(1 << 30), "--telemetry-interval", "0"))
        stack.callback(stop_server, started[0])
        fleet["members"][f"{engine}{i}"] = started
    for engine in names:
        pport = free_port()
        proc = spawn(f"proxy_zk_{engine}", "jubatus_tpu_torch.server.proxy",
                     engine, "-z", locator, "-p", str(pport), "-b",
                     "127.0.0.1", "-c", "8", "--telemetry-interval", "0",
                     "--incident-dir", server_datadir(f"proxy_zk_{pport}"))
        stack.callback(stop_server, proc[0])
        fleet["proxies"][engine] = (proc, pport)
    return fleet


def zk_idl(SERVICES, engine: str) -> str:
    """An .idl for ``engine`` written from the routing table (every
    argument a string: a Python client's types are annotations only)."""
    lines = [f"service {engine} {{"]
    for m in SERVICES[engine]:
        routing = (f"#@cht({m.cht_n})" if m.routing == "cht"
                   else f"#@{m.routing}")
        args = ", ".join(f"{i}: string {a}" for i, a in enumerate(m.args))
        lines += [f"  {routing} #@{m.lock} #@{m.aggregator}",
                  f"  bool {m.name}({args})", ""]
    return "\n".join(lines + ["}"]) + "\n"


def phase_zk_fleet(Datum, seed: int, fleet: dict) -> dict:
    """Drive ``start_zk_fleet``'s fleet: through the proxies with the
    port's typed clients, 1,000 ``set_row`` and 200
    ``neighbor_row_from_datum`` (K1 on the members), 2,000 regression rows
    in calls of 256 (S1); one ``do_mix`` of the regression pair, whose
    saved models must then be equal; ``jubactl -c status -z zk://...``;
    a client emitted by the port's codegen answering ``get_status``; then
    SIGTERM one NN member: it must leave the actives (the proxy's view)
    within the session timeout, and queries through the proxy keep
    answering, on the survivor."""
    import importlib.util

    from jubatus_tpu_torch.client import (NearestNeighborClient,
                                          RegressionClient)
    from jubatus_tpu_torch.cmd import jubactl
    from jubatus_tpu_torch.codegen import emit_python_client, parse_idl
    from jubatus_tpu_torch.coord import create_coordinator, membership
    from jubatus_tpu_torch.framework.idl import SERVICES
    from jubatus_tpu_torch.rpc.client import RpcClient

    locator, names = fleet["locator"], fleet["names"]
    nn_name, reg_name = names["nearest_neighbor"], names["regression"]
    t_boot = time.perf_counter()
    await_started(fleet["members"])
    view = create_coordinator(locator)
    clis = []
    try:
        actives = lambda e: sorted(  # noqa: E731
            membership.get_all_actives(view, e, names[e]),
            key=lambda m: m.port)
        for engine in names:
            wait_for(lambda e=engine: len(actives(e)) == 2,
                     f"two {engine} members never joined on {locator}",
                     ZK_WAIT_S)
        for engine, (proc, pport) in fleet["proxies"].items():
            c = RpcClient("127.0.0.1", pport, timeout=120.0)
            clis.append(c)
            wait_for(lambda c=c, n=names[engine]: answers_ok(
                c, "get_proxy_status", n), f"the {engine} proxy never "
                "answered", ZK_WAIT_S)
        boot_s = time.perf_counter() - t_boot
        nn = NearestNeighborClient("127.0.0.1",
                                   fleet["proxies"]["nearest_neighbor"][1],
                                   nn_name, timeout=120.0)
        reg = RegressionClient("127.0.0.1",
                               fleet["proxies"]["regression"][1], reg_name,
                               timeout=120.0)
        clis += [nn, reg]
        rng = np.random.default_rng(seed + 2017)
        lat = {"set_row": [], "neighbor_row_from_datum": [], "train": []}
        for i in range(ZK_SETS):
            ok, ms = timed(nn.set_row, f"z{i}", server_datum(rng, Datum, i))
            check(ok is True, f"set_row z{i} through the proxy: {ok}")
            lat["set_row"].append(ms)
        for i in range(ZK_QUERIES):
            got, ms = timed(nn.neighbor_row_from_datum,
                            server_datum(rng, Datum, ZK_SETS + i), 10)
            check(len(got) == 10 and all(np.isfinite(d) for _, d in got),
                  f"neighbor_row_from_datum through the proxy: {got[:3]}")
            lat["neighbor_row_from_datum"].append(ms)
        rows = [[float(np.round(rng.standard_normal(), 3)),
                 server_datum(rng, Datum, i)] for i in range(ZK_TRAIN)]
        for lo in range(0, ZK_TRAIN, ZK_BATCH):
            batch = rows[lo:lo + ZK_BATCH]
            n, ms = timed(reg.train, batch)
            check(n == len(batch), f"train through the proxy: {n}")
            lat["train"].append(ms)
        members = {e: actives(e) for e in names}
        direct = {e: [RpcClient(m.host, m.port, timeout=120.0) for m in ms]
                  for e, ms in members.items()}
        clis += [c for cs in direct.values() for c in cs]
        ok, mix_ms = timed(direct["regression"][0].call, "do_mix", reg_name)
        check(ok is True, f"regression do_mix returned {ok}")
        models = [saved_pack(c, "zk") for c in direct["regression"]]
        model_close(models[1], models[0], 0.0, "zk regression replicas")
        rc, text = ctl(jubactl, "-c", "status", "-t", "nearest_neighbor",
                       "-n", nn_name, "-z", locator)
        check(rc == 0 and f"{nn_name}: 2 node(s), 2 active" in text,
              f"jubactl status over zk: {text[:400]}")
        gen_dir = fleet_dir("zk_codegen")
        src = emit_python_client(parse_idl(zk_idl(SERVICES,
                                                  "nearest_neighbor")),
                                 "nearest_neighbor")
        gen_path = os.path.join(gen_dir, "nearest_neighbor_client.py")
        with open(gen_path, "w") as f:
            f.write(src)
        spec = importlib.util.spec_from_file_location("zk_generated", gen_path)
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        survivor, victim = members["nearest_neighbor"]
        with gen.NearestNeighborClient(survivor.host, survivor.port,
                                       nn_name) as g:
            (gst,) = g.get_status().values()
        check(gst["driver.device"].startswith("cuda")
              and gst["type"] == "nearest_neighbor",
              f"the generated client's get_status: {sorted(gst)[:8]}")
        sts = {e: [server_status(c) for c in cs] for e, cs in direct.items()}
        launches = {m: 0 for m in RECORDED}
        victim_launches = server_launches(sts["nearest_neighbor"][1])
        for st in sts["regression"] + [sts["nearest_neighbor"][1]]:
            add_launches(launches, st)
        before = server_launches(sts["nearest_neighbor"][0])["hamming"]
        # SIGTERM the second NN member: its session dies with it
        ((proc, _, _),) = [st for st in fleet["members"].values()
                           if st[1] == victim.port]
        (pproc, pport) = fleet["proxies"]["nearest_neighbor"]
        with RpcClient("127.0.0.1", pport, timeout=120.0) as pc:
            (pst,) = pc.call("get_proxy_status", nn_name).values()
        errors_before = pst["forward_errors"]
        t_kill = time.perf_counter()
        proc.terminate()
        wait_for(lambda: len(actives("nearest_neighbor")) == 1,
                 "the stopped NN member never left the actives", ZK_WAIT_S)
        leave_s = time.perf_counter() - t_kill
        proc.wait(timeout=60)
        check(leave_s < 10.0, f"left the actives after {leave_s:.3f} s, "
              "past the 10 s session timeout")
        after = []
        for i in range(ZK_AFTER_LEAVE):
            got, ms = timed(nn.neighbor_row_from_datum,
                            server_datum(rng, Datum, i), 10)
            check(len(got) == 10, f"query after the leave: {got[:3]}")
            after.append(ms)
        st0 = server_status(direct["nearest_neighbor"][0])
        add_launches(launches, st0)
        answered = server_launches(st0)["hamming"] - before
        check(answered == ZK_AFTER_LEAVE,
              f"the survivor answered {answered} of {ZK_AFTER_LEAVE} "
              "queries after the leave")
        with RpcClient("127.0.0.1", pport, timeout=120.0) as pc:
            (pst,) = pc.call("get_proxy_status", nn_name).values()
        nn_rows = direct["nearest_neighbor"][0].call("get_row_count",
                                                     nn_name)
        return dict(
            ensemble=fleet["ensemble"], boot_s=boot_s,
            set_row=pcts(lat["set_row"]),
            neighbor_row_from_datum=pcts(lat["neighbor_row_from_datum"]),
            train_256=pcts(lat["train"]), do_mix_ms=mix_ms,
            regression_replicas_equal=True, leave_s=leave_s,
            after_leave=pcts(after),
            proxy_forward_errors_during_leave=(pst["forward_errors"]
                                               - errors_before),
            survivor_rows=nn_rows, victim_launches=victim_launches,
            generated_client_bytes=len(src), server_launches=launches)
    finally:
        for c in clis:
            c.close()
        view.close()


def ring_flat_ids(torch, sig_scan, q, rows, k: int, shards: int,
                  ring_order: bool):
    """The flat K1 scan's top-k of every query (query chunks of one
    shard's B/S), as (distances, ids) under one tie rule: the ring's
    (visit step, then slot: shard s visits origins s, s-1, ...) or the
    lowest id first. Keys are unique, so the answer is one."""
    c = rows.shape[0]
    c_local = c // shards
    b_local = q.shape[0] // shards
    ids_all = torch.arange(c, device=q.device, dtype=torch.int64)
    origin, slot = ids_all // c_local, ids_all % c_local
    out_d, out_i = [], []
    for s in range(shards):
        d = sig_scan.hamming(q[s * b_local:(s + 1) * b_local], rows, 64)
        h = torch.round(d * 64).to(torch.int64)
        tie = (((s - origin) % shards) * c_local + slot if ring_order
               else ids_all)
        key = h * (1 << 40) + tie[None, :]
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
        out_d.append(d.gather(1, top))
        out_i.append(top)
    return torch.cat(out_d), torch.cat(out_i)


def phase_ring(torch, sig_scan, ShardMesh, seed: int) -> dict:
    """The ring scans on 4 logical shards of cuda:0 and the two-level IVF
    assignment. Counted: one ``ring_hamming_topk`` call (C = 2^20, B =
    1,024, k = 10: one K1 hamming launch a shard a step, S² in all), one
    ``ring_euclid_topk`` call and the assignments; the checks and the
    timings (medians of RING_REPS CUDA-event timings) are not."""
    from jubatus_tpu_torch.ops import ivf
    from jubatus_tpu_torch.parallel import (ring_euclid_topk,
                                            ring_hamming_topk)
    from jubatus_tpu_torch.parallel.ring import batch_euclid_distances
    from jubatus_tpu_torch.parallel.sharded_knn import (shard_table,
                                                        sharded_hamming_topk)

    dev = torch.device("cuda", 0)
    mesh = ShardMesh([dev] * RING_SHARDS)
    rng = np.random.default_rng(seed + 2020)
    out = {}
    # -- hamming: K1 per block
    rows = torch.from_numpy(rng.integers(0, 1 << 32, (RING_ROWS, 2),
                                         dtype=np.uint32).view(np.int32)).to(dev)
    q = torch.from_numpy(rng.integers(0, 1 << 32, (RING_B, 2),
                                      dtype=np.uint32).view(np.int32)).to(dev)
    q_blocks, r_blocks = shard_table(mesh, q), shard_table(mesh, rows)
    before = sig_scan.hamming.launches
    d, ids = ring_hamming_topk(mesh, q_blocks, r_blocks, hash_num=64,
                               k=RING_K)
    torch.cuda.synchronize()
    launched = sig_scan.hamming.launches - before
    check(launched == RING_SHARDS ** 2,
          f"ring_hamming_topk launched K1 {launched} times, not S² = "
          f"{RING_SHARDS ** 2}")
    with uncounted(sig_scan):
        fd, fi = ring_flat_ids(torch, sig_scan, q, rows, RING_K,
                               RING_SHARDS, ring_order=True)
        check(torch.equal(d, fd), "ring distances differ from the flat "
              "K1 scan's")
        check(torch.equal(ids, fi), "ring ids differ from the flat K1 "
              "scan's under the ring's tie rule")
        sd, si = sharded_hamming_topk(mesh, q, r_blocks, hash_num=64,
                                      k=RING_K)
        check(torch.equal(sd, d), "ring distances differ from "
              "sharded_hamming_topk's")
        _, li = ring_flat_ids(torch, sig_scan, q, rows, RING_K,
                              RING_SHARDS, ring_order=False)
        below = d < d[:, -1:]          # ids strictly below the k-th distance
        check(all(set(a[m].tolist()) == set(b[m].tolist()) == set(c[m]
                                                                   .tolist())
                  for a, b, c, m in zip(ids, si, li, below)),
              "ids below the k-th distance differ between the ring, the "
              "sharded and the flat scans")
        ties_at_k = int((~torch.all(ids == li, dim=1)).sum())
        t_ring = time_ms(torch, lambda: ring_hamming_topk(
            mesh, q_blocks, r_blocks, hash_num=64, k=RING_K), RING_REPS)
        t_sharded = time_ms(torch, lambda: sharded_hamming_topk(
            mesh, q, r_blocks, hash_num=64, k=RING_K), RING_REPS)
        t_flat = time_ms(torch, lambda: torch.topk(
            sig_scan.hamming(q, rows, 64), RING_K, dim=1, largest=False),
            RING_REPS)
    out["hamming"] = dict(
        C=RING_ROWS, B=RING_B, W=2, hash_num=64, k=RING_K,
        shards=RING_SHARDS, k1_launches=launched, ring_ms=t_ring,
        sharded_ms=t_sharded, flat_k1_topk_ms=t_flat,
        rows_tie_ordered_unlike_lowest_id_first=ties_at_k)
    del rows, q, q_blocks, r_blocks, fd, fi, sd, si, li
    torch.cuda.empty_cache()
    # -- euclid: the exact distance over a sparse table
    idx, val = random_rows(rng, RING_EUCLID_ROWS, RING_EUCLID_NNZ, 16)
    ridx = torch.from_numpy(idx.astype(np.int64)).to(dev)
    rval = torch.from_numpy(val).to(dev)
    qi, qv = random_rows(rng, RING_EUCLID_B, RING_EUCLID_NNZ, 16)
    qd = torch.zeros((RING_EUCLID_B, RING_EUCLID_DIM), device=dev)
    qd.index_put_((torch.arange(RING_EUCLID_B).repeat_interleave(
        RING_EUCLID_NNZ).to(dev), torch.from_numpy(qi.reshape(-1)
                                                   .astype(np.int64)).to(dev)),
        torch.from_numpy(qv.reshape(-1)).to(dev), accumulate=True)
    blocks = [shard_table(mesh, t) for t in (qd, ridx, rval)]
    ed, eids = ring_euclid_topk(mesh, *blocks, k=RING_K)
    flat = torch.cat([batch_euclid_distances(qd[lo:lo + 32], ridx, rval)
                      for lo in range(0, RING_EUCLID_B, 32)])
    fd, fi = torch.topk(flat, RING_K, dim=1, largest=False, sorted=True)
    err = float((ed - fd).abs().max())
    check(torch.allclose(ed, fd, rtol=RING_EUCLID_TOL, atol=RING_EUCLID_TOL),
          f"euclid ring distances off the flat scan by {err}")
    got_d = flat.gather(1, eids)
    check(torch.allclose(got_d, ed, rtol=RING_EUCLID_TOL,
                         atol=RING_EUCLID_TOL),
          "a euclid ring id does not score its distance")
    t_ring = time_ms(torch, lambda: ring_euclid_topk(mesh, *blocks,
                                                     k=RING_K), RING_REPS)
    t_flat = time_ms(torch, lambda: torch.topk(
        batch_euclid_distances(qd, ridx, rval), RING_K, dim=1,
        largest=False), RING_REPS)
    out["euclid"] = dict(C=RING_EUCLID_ROWS, nnz=RING_EUCLID_NNZ,
                         D=RING_EUCLID_DIM, B=RING_EUCLID_B, k=RING_K,
                         max_abs_err=err, tol=RING_EUCLID_TOL,
                         ids_equal=bool(torch.equal(eids, fi)),
                         ring_ms=t_ring, flat_ms=t_flat)
    del ridx, rval, qd, blocks, flat
    torch.cuda.empty_cache()
    # -- the two-level IVF assignment against the flat one
    centers = rng.normal(size=(HIER_CELLS, HIER_DIM)).astype(np.float32) * 4
    cen = torch.from_numpy(centers).to(dev)
    pick = torch.from_numpy(rng.integers(0, HIER_CELLS, HIER_ROWS)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = cen[pick] + torch.randn((HIER_ROWS, HIER_DIM), device=dev,
                                  generator=gen)
    t0 = time.perf_counter()
    supers, members = ivf.build_super(centers, n_super=HIER_SUPERS,
                                      seed=seed, device=dev)
    build_s = time.perf_counter() - t0
    sup, mem = torch.from_numpy(supers).to(dev), torch.from_numpy(members).to(dev)

    def flat_assign():
        return torch.cat([ivf.assign_cells(emb[lo:lo + HIER_CHUNK], cen)
                          for lo in range(0, HIER_ROWS, HIER_CHUNK)])

    def hier_assign():
        return torch.cat([ivf.assign_cells_hier(
            emb[lo:lo + HIER_CHUNK], cen, sup, mem, top_supers=HIER_TOP)
            for lo in range(0, HIER_ROWS, HIER_CHUNK)])

    a_flat, a_hier = flat_assign(), hier_assign()
    agree = float((a_flat == a_hier).float().mean())
    check(agree > 0.9, f"two-level assignment agrees with flat on {agree}")
    out["assign"] = dict(
        rows=HIER_ROWS, cells=HIER_CELLS, dim=HIER_DIM, supers=HIER_SUPERS,
        top_supers=HIER_TOP, group_max=int(members.shape[1]),
        build_super_s=build_s, agreement=agree,
        flat_ms=time_ms(torch, flat_assign, RING_REPS),
        hier_ms=time_ms(torch, hier_assign, RING_REPS))
    return out


# ---------------------------------------------------------------------------
# phase 21: the raw-wire ingest on the card
# ---------------------------------------------------------------------------
RAW_ROWS = 4_096              # rows a feed sends, in calls of LINEAR_BATCH
RAW_CLIENTS = 4               # clients of the concurrent feed
RAW_PROBES = 64               # classify / estimate probe datums
RAW_KEYS = 16                 # numeric keys of arow.json's fixed schema
RAW_COMBO_KEYS = 8            # numeric keys of the combo feed (28 pairs)
RAW_WORDS = 200               # vocabulary of the idf feed's texts
#: the pure-idf classifier (tests/test_native_ingest.py's idf server case)
RAW_IDF_CONFIG = {
    "method": "AROW", "parameter": {"regularization_weight": 1.0},
    "converter": {"string_rules": [
        {"key": "*", "type": "space", "sample_weight": "tf",
         "global_weight": "idf"}]}}


def raw_cases() -> list:
    """(name, engine, config, feed, plan) of phase 21. The shipped
    arow_combinational_feature.json weighs its strings by idf, which the
    native spec cannot compose with combinations (it declines in both
    packages); the combo plan runs on its rules with bin weights."""
    combo = load_config("classifier", "arow_combinational_feature.json")
    conv = json.loads(json.dumps(combo["converter"]))
    for rule in conv["string_rules"]:
        rule["global_weight"] = "bin"
    return [
        ("arow", "classifier", load_config("classifier", "arow.json"),
         "schema", "schema_flushes"),
        ("combo", "classifier", dict(combo, converter=conv), "combo",
         "combo_flushes"),
        ("pa", "regression", load_config("regression", "pa.json"),
         "mixed", "sparse_query_flushes"),
        ("idf", "classifier", RAW_IDF_CONFIG, "text", "sparse_flushes"),
    ]


def raw_rows(rng, Datum, engine: str, feed: str, n: int):
    """``n`` [label, Datum] rows of one feed: ``schema`` RAW_KEYS numeric
    keys every row; ``combo`` RAW_COMBO_KEYS; ``mixed`` phase 9's rows
    (random keys and two string values); ``text`` one text of 4-12 words
    of RAW_WORDS."""
    out = []
    for i in range(n):
        if feed == "mixed":
            d = server_datum(rng, Datum, i)
        elif feed == "text":
            words = rng.integers(RAW_WORDS, size=int(rng.integers(4, 13)))
            d = Datum({"t": " ".join(f"w{w}" for w in words)})
        else:
            keys = RAW_KEYS if feed == "schema" else RAW_COMBO_KEYS
            vals = np.round(rng.standard_normal(keys), 3)
            d = Datum({f"f{j}": float(v) for j, v in enumerate(vals)})
        score = float(sum(v for _, v in d.num_values)) + (
            1.0 if feed == "text" and " w1" in f" {d.string_values[0][1]}"
            else 0.0)
        label = score if engine == "regression" else "ab"[int(score > 0)]
        out.append([label, d])
    return out


def raw_feed(port: int, batches, clients: int) -> float:
    """``batches`` from ``clients`` clients at once; each call must answer
    its own count. Returns the wall seconds."""
    import threading

    from jubatus_tpu_torch.rpc.client import RpcClient

    errors = []

    def client(k):
        try:
            with RpcClient("127.0.0.1", port, timeout=120.0) as c:
                for b in batches[k::clients]:
                    got = c.call("train", "smoke", b)
                    if got != len(b):
                        errors.append(f"train answered {got} for {len(b)}")
        except Exception as e:  # broad-ok — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"raw feed: {errors[:1]}")
    return time.perf_counter() - t0


def raw_replay(ref, parser, combo, plan: str, raw: bytes) -> None:
    """The CPU driver fed the parser's arrays of one call, as the raw
    path's flush of that call alone feeds the card's driver."""
    from jubatus_tpu_torch.native.ingest import deferred_idf_scale

    if plan == "combo":
        cache, base = combo
        (_, cplan), (uniq, lidx), _idx, val = cache.parse_train(base, raw)
        ref.train_indexed_combo(uniq, lidx, cplan.uidx, val, cplan.a_idx,
                                cplan.b_idx, cplan.mul_mask)
        return
    labels, idx, val = parser.parse_indexed(raw)
    if plan == "mixed":
        ref.train_hashed(labels, idx, val)
        return
    uniq, lidx = labels
    if plan == "schema":
        check(bool((idx == idx[0]).all()), "the schema feed is not uniform")
        ref.train_indexed_schema(uniq, lidx, idx[0], val)
        return
    val = deferred_idf_scale(idx, val, ref.converter.weights, observe=True)
    ref.train_indexed(uniq, lidx, idx, val)


def raw_err(got, want) -> float:
    """max |got - want| over phase 9's limit (LINEAR_TOL of the largest
    magnitude plus 1e-4 relative): within the tolerance when <= 1."""
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    check(g.shape == w.shape and np.isfinite(g).all(),
          f"answers of shape {g.shape}, want {w.shape}, or not finite")
    if w.size == 0:
        return 0.0
    limit = LINEAR_TOL * float(np.abs(w).max()) + 1e-4 * np.abs(w) + 1e-30
    return float((np.abs(g - w) / limit).max())


def raw_answers(cli, engine: str, probes):
    """A server's answers on the probes: estimates, or each label's score
    in label order."""
    if engine == "regression":
        return cli.call("estimate", "smoke", probes)
    rows = cli.call("classify", "smoke", probes)
    return [[s for _, s in sorted(r)] for r in rows]


def raw_case(torch, Datum, EngineServer, ServerArgs, Driver, name, engine,
             conf, feed, plan_key, seed: int) -> dict:
    """One config of phase 21: a raw and a decoded server in this process
    on the card, fed the same stream."""
    import msgpack

    from jubatus_tpu_torch.native.ingest import IngestParser
    from jubatus_tpu_torch.rpc.client import RpcClient
    from jubatus_tpu_torch.server.service import _ComboPlanCache

    servers = {}
    for mode in ("raw", "decoded"):
        if mode == "decoded":
            os.environ["JUBATUS_TPU_NATIVE_INGEST"] = "0"
        try:
            srv = EngineServer(engine, conf, ServerArgs(
                engine=engine, listen_addr="127.0.0.1",
                telemetry_interval=0,
                datadir=server_datadir(f"p21_{name}_{mode}")), device="cuda")
            srv.start(0)
        finally:
            os.environ.pop("JUBATUS_TPU_NATIVE_INGEST", None)
        servers[mode] = srv
    try:
        raw, dec = servers["raw"], servers["decoded"]
        check("train" in raw.rpc._raw_methods
              and "train" not in dec.rpc._raw_methods,
              f"{name}: the raw path is not on the raw server alone")
        rng = np.random.default_rng(seed + 2100 + len(name))
        conc = raw_rows(rng, Datum, engine, feed, RAW_ROWS)
        seq = raw_rows(rng, Datum, engine, feed, RAW_ROWS)
        probes = [d for _, d in raw_rows(rng, Datum, engine, feed,
                                         RAW_PROBES)]
        split = lambda rows: [rows[lo:lo + LINEAR_BATCH]  # noqa: E731
                              for lo in range(0, len(rows), LINEAR_BATCH)]
        # the raw server's device stage bracketed by CUDA events
        co = raw.coalescers["train_raw"]
        stage, events = co._flush, []

        def bracketed(prepared):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            try:
                return stage(prepared)
            finally:
                b.record()
                events.append((a, b))

        co._flush = bracketed
        rates = {}
        for mode, srv in servers.items():
            port = srv.rpc.port
            conc_s = raw_feed(port, split(conc), RAW_CLIENTS)
            with RpcClient("127.0.0.1", port, timeout=120.0) as c:
                check(c.call("clear", "smoke") is True, "clear failed")
            seq_s = raw_feed(port, split(seq), 1)
            rates[mode] = dict(clients4_rows_per_s=RAW_ROWS / conc_s,
                               clients1_rows_per_s=RAW_ROWS / seq_s)
        torch.cuda.synchronize()
        with RpcClient("127.0.0.1", raw.rpc.port, timeout=120.0) as c:
            got = raw_answers(c, engine, probes)
            st = server_status(c)
        with RpcClient("127.0.0.1", dec.rpc.port, timeout=120.0) as c:
            want = raw_answers(c, engine, probes)
            dst = server_status(c)
        check(st["microbatch.train_raw.item_count"] == 2 * RAW_ROWS,
              f"{name}: train_raw flushed "
              f"{st['microbatch.train_raw.item_count']} rows, sent "
              f"{2 * RAW_ROWS}")
        check(dst["microbatch.train.item_count"] == 2 * RAW_ROWS
              and "microbatch.train_raw.item_count" not in dst,
              f"{name}: the decoded server did not take the decoded path")
        check(st[f"ingest.{plan_key}"] > 0,
              f"{name}: no flush took the {plan_key} plan: "
              f"{ {k: v for k, v in st.items() if k.startswith('ingest.')} }")
        vs_decoded = raw_err(got, want)
        check(vs_decoded <= 1.0,
              f"{name}: raw answers off the decoded server's ({vs_decoded})")
        # the CPU port driver fed the parser's arrays of the 1-client feed
        drv = raw.driver
        ref = Driver(conf, dim_bits=drv.converter.hasher.dim_bits,
                     device="cpu")
        parser = IngestParser.from_converter_config(
            conf["converter"], drv.converter.hasher.dim_bits)
        combo = None
        if feed == "combo":
            cache = _ComboPlanCache(conf["converter"], ref.converter)
            combo = (cache, cache.make_base_parser(
                drv.converter.hasher.dim_bits))
        wires = [msgpack.packb(["smoke", [[lab, d.to_msgpack()]
                                          for lab, d in b]])
                 for b in split(seq)]
        parse_ms = []
        for w in wires:
            t0 = time.perf_counter()
            parser.parse_indexed(w)
            parse_ms.append((time.perf_counter() - t0) * 1e3)
            raw_replay(ref, parser, combo, feed, w)
        state_err = 0.0
        for field, tensor in zip(drv.state._fields, drv.state):
            state_err = max(state_err, raw_err(
                tensor.detach().cpu().numpy(),
                getattr(ref.state, field).numpy()))
        check(state_err <= 1.0,
              f"{name}: the card's model off the CPU driver fed the "
              f"parser's arrays ({state_err})")
        if engine == "regression":
            ref_ans = ref.estimate(probes)
        else:
            ref_ans = [[s for _, s in sorted(r)] for r in ref.classify(probes)]
        vs_cpu = raw_err(got, ref_ans)
        check(vs_cpu <= 1.0, f"{name}: raw answers off the CPU driver's "
                             f"({vs_cpu})")
        flushes = co.stats()["flush_count"]
        dco = dec.coalescers["train"]
        dflushes = dco.stats()["flush_count"]
        return dict(
            config=name, engine=engine, plan=plan_key,
            rows=2 * RAW_ROWS, batch=LINEAR_BATCH, clients=RAW_CLIENTS,
            raw=rates["raw"], decoded=rates["decoded"],
            speedup_clients1=(rates["raw"]["clients1_rows_per_s"]
                              / rates["decoded"]["clients1_rows_per_s"]),
            speedup_clients4=(rates["raw"]["clients4_rows_per_s"]
                              / rates["decoded"]["clients4_rows_per_s"]),
            flush=dict(
                raw_flushes=flushes, decoded_flushes=dflushes,
                parse_ms_p50=statistics.median(parse_ms),
                raw_prep_ms=co.prep_seconds / flushes * 1e3,
                raw_device_stage_ms=co.device_seconds / flushes * 1e3,
                raw_device_event_ms=statistics.median(
                    a.elapsed_time(b) for a, b in events),
                decoded_featurize_ms=dco.prep_seconds / dflushes * 1e3,
                decoded_device_stage_ms=dco.device_seconds / dflushes * 1e3),
            ingest={k[len("ingest."):]: v for k, v in st.items()
                    if k.startswith("ingest.")},
            err_over_limit=dict(vs_decoded=vs_decoded, vs_cpu=vs_cpu,
                                state_vs_cpu=state_err),
            tol=LINEAR_TOL)
    finally:
        for srv in servers.values():
            srv.stop()


def phase_raw_ingest(torch, Datum, EngineServer, ClassifierDriver,
                     RegressionDriver, seed: int) -> dict:
    """Phase 21 (see the module's docstring)."""
    from jubatus_tpu_torch.native.ingest import IngestParser
    from jubatus_tpu_torch.server.args import ServerArgs

    shipped = load_config("classifier", "arow_combinational_feature.json")
    check(IngestParser.from_converter_config(shipped["converter"], 18)
          is None, "the shipped combo config (idf) no longer declines")
    out = {}
    for name, engine, conf, feed, plan_key in raw_cases():
        t0 = time.perf_counter()
        driver = RegressionDriver if engine == "regression" \
            else ClassifierDriver
        out[name] = raw_case(torch, Datum, EngineServer, ServerArgs, driver,
                             name, engine, conf, feed, plan_key, seed)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 22: the native transport against the Python one, each server a
# process of its own
# ---------------------------------------------------------------------------
NT_ROWS = 4_096               # rows of each feed, in calls of LINEAR_BATCH
NT_CLIENTS = 4                # pipelined clients of the second feed
NT_ESTIMATES = 200            # timed estimate calls a server
#: (transport, the server's environment)
NT_TRANSPORTS = (("native", None),
                 ("python", {"JUBATUS_TPU_NATIVE_RPC": "0"}))


def nt_datum(Datum, d, prefix: str):
    """``d`` with every key under ``prefix``."""
    out = Datum()
    for key, v in d.string_values + d.num_values:
        out.add(prefix + key, v)
    return out


def nt_prefixes(conv, Datum, calls: int) -> list:
    """A key prefix for each of ``calls`` train calls such that no hashed
    index (``conv``: the servers' converter, on the CPU) of one call's
    features, every feature ``server_datum`` can make under the prefix, is
    another call's or twice in one call: PA's model after the calls is
    then the same whichever order the server's flushes take them in."""
    d = server_datum(np.random.default_rng(0), Datum, 0)
    keys = [f"f{j}" for j in range(64)]
    strings = [("city", f"c{x}") for x in range(40)] + \
        [("kind", f"k{x}") for x in range(7)]
    used, out = set(), []
    for k in range(calls):
        for attempt in range(1000):
            pre = f"{k}.{attempt}."
            d = Datum()
            for key in keys:
                d.add(pre + key, 1.0)
            for key, v in strings:
                d.add(pre + key, v)
            idx = {i for i, _ in conv.convert(d)}
            if len(idx) == len(keys) + len(strings) and not idx & used:
                break
        else:
            raise SmokeError("no collision-free prefix for a train call")
        used |= idx
        out.append(pre)
    return out


def nt_frames(rng, Datum, prefixes, first_msgid: int) -> list:
    """A packed train frame of LINEAR_BATCH rows of phase 9's regression
    shape a prefix, the keys of call k under ``prefixes[k]``."""
    import msgpack

    frames = []
    for k, prefix in enumerate(prefixes):
        rows = []
        for i in range(LINEAR_BATCH):
            d = server_datum(rng, Datum, i)
            rows.append([float(sum(v for _, v in d.num_values)),
                         nt_datum(Datum, d, prefix).to_msgpack()])
        frames.append(msgpack.packb(
            [0, first_msgid + k, "train", ["smoke", rows]]))
    return frames


def nt_feed(port: int, frames, clients: int, pipelined: bool) -> tuple:
    """``frames`` from ``clients`` connections at once, each sending its
    share all at once (``pipelined``) or a call at a time; every answer
    must count its call's rows. Returns (wall seconds, each call's ms when
    a call at a time)."""
    import threading

    import msgpack

    errors, lat = [], []

    def client(k):
        mine = frames[k::clients]
        batches = [mine] if pipelined else [[f] for f in mine]
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=120) as sock:
                unp = msgpack.Unpacker(raw=False)
                for batch in batches:
                    t0 = time.perf_counter()
                    sock.sendall(b"".join(batch))
                    n = 0
                    while n < len(batch):
                        data = sock.recv(65536)
                        if not data:
                            raise ConnectionError("the server closed")
                        unp.feed(data)
                        for msg in unp:
                            n += 1
                            if msg[2] is not None or msg[3] != LINEAR_BATCH:
                                errors.append(f"train answered {msg[2:]}")
                    if not pipelined:
                        lat.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # broad-ok — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"native transport feed: {errors[:2]}")
    return time.perf_counter() - t0, lat


def nt_trained(st: dict) -> int:
    """Rows a server's train coalescers took (the raw path and the
    decoded one)."""
    return int(st.get("microbatch.train.item_count", 0)
               + st.get("microbatch.train_raw.item_count", 0))


def phase_native_transport(Datum, seed: int) -> dict:
    """Two ``config/regression/default.json`` servers on the card, started
    at once, one on the native transport (the default) and one with
    ``JUBATUS_TPU_NATIVE_RPC=0``. Each takes the same NT_ROWS rows from
    one client (a call at a time: each call one flush, p50/p99 a call),
    then NT_ROWS more from NT_CLIENTS clients that pipeline their calls
    (rows/s), then NT_ESTIMATES ``estimate`` calls (p50/p99), after one
    untimed call of LINEAR_BATCH rows (the first flush's set-up); S1 launches
    from each server's get_status; the two saved models equal bit for bit,
    or else within phase 9's LINEAR_TOL (the result says which), and so
    the estimates. The calls' features are disjoint in the hashed space
    (``nt_prefixes``), so the order of the pipelined calls' flushes,
    which the two transports need not share, moves no weight."""
    from jubatus_tpu_torch.models.regression import RegressionDriver
    from jubatus_tpu_torch.rpc.client import RpcClient

    config = os.path.join(ROOT, "config", "regression", "default.json")
    started = {name: start_server("regression", config, tag=f"_nt_{name}",
                                  env=env)
               for name, env in NT_TRANSPORTS}
    out: dict = {}
    packs, answers = {}, {}
    launches = {m: 0 for m in RECORDED}
    try:
        calls = NT_ROWS // LINEAR_BATCH
        conv = RegressionDriver(load_config("regression", "default.json"),
                                device="cpu").converter
        prefixes = nt_prefixes(conv, Datum, 2 * calls + 1)
        rng = np.random.default_rng(seed + 2201)
        one = nt_frames(rng, Datum, prefixes[:calls], 1)
        many = nt_frames(rng, Datum, prefixes[calls:2 * calls], 1 + calls)
        # one call before the timed feeds: a server's first flush builds
        # its tables and loads S1 (~0.1 s)
        warm = nt_frames(rng, Datum, prefixes[-1:], 1 + 2 * calls)
        probes = [nt_datum(Datum, server_datum(rng, Datum, i),
                           prefixes[i % calls]) for i in range(NT_ESTIMATES)]
        await_started(started)

        for name, _ in NT_TRANSPORTS:
            port = started[name][1]
            with RpcClient("127.0.0.1", port, timeout=120.0) as cli:
                nt_feed(port, warm, 1, pipelined=False)
                st0 = server_status(cli)
                one_s, one_lat = nt_feed(port, one, 1, pipelined=False)
                many_s, _ = nt_feed(port, many, NT_CLIENTS, pipelined=True)
                est, est_lat = [], []
                for d in probes:
                    got, ms = timed(cli.call, "estimate", "smoke", [d])
                    est += got
                    est_lat.append(ms)
                st = server_status(cli)
                moved = {m: c - server_launches(st0)[m]
                         for m, c in server_launches(st).items()}
                check(moved["pa_scan"] > 0,
                      f"S1 never launched on the {name} transport's server")
                check(nt_trained(st) - nt_trained(st0) == 2 * NT_ROWS,
                      f"the {name} server trained "
                      f"{nt_trained(st) - nt_trained(st0)} rows")
                check(all(np.isfinite(est)), f"{name} estimates not finite")
                for m in RECORDED:
                    launches[m] += moved[m]
                packs[name] = saved_pack(cli, f"nt_{name}")
                answers[name] = est
                out[name] = dict(
                    clients1=dict(rows_per_s=NT_ROWS / one_s,
                                  train=pcts(one_lat)),
                    clients4_pipelined=dict(rows_per_s=NT_ROWS / many_s),
                    estimate=pcts(est_lat), s1_launches=moved["pa_scan"],
                    flushes=int(st.get("microbatch.train_raw.flush_count", 0)
                                + st.get("microbatch.train.flush_count", 0)))
        try:
            model_close(packs["native"], packs["python"], 0.0, "model")
            bit_equal, err = True, 0.0
        except SmokeError:
            bit_equal = False
            err = model_close(packs["native"], packs["python"], LINEAR_TOL,
                              "model")
        est_err = raw_err(answers["native"], answers["python"])
        check(est_err <= 1.0, f"estimates differ across the transports by "
              f"{est_err} of phase 9's limit")
        out["models"] = dict(bit_equal=bit_equal, err_over_limit=err,
                             estimates_equal=answers["native"]
                             == answers["python"],
                             estimate_err_over_limit=est_err)
        return dict(out, config="config/regression/default.json",
                    rows=2 * NT_ROWS, server_launches=launches)
    except Exception:
        for _, _, log_path in started.values():
            print_server_log(log_path)
        raise
    finally:
        for proc, _, _ in started.values():
            stop_server(proc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--forensics-ab", type=int, default=0, metavar="N",
                    help="measure the forensics plane's cost on phase 9's "
                         "and phase 13's servers over N rounds (no main "
                         "path, no result line)")
    ap.add_argument("--parent", default="",
                    help="with --forensics-ab: a checkout whose phases 9 "
                         "and 13 run as one more arm")
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
        from jubatus_tpu_torch import native

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            # one nvcc per source, and the g++ of the ingest parser the
            # linear servers load and of the RPC front-end every server
            # and proxy serves on, started together
            futs = [pool.submit(m.library) for m in (sig_scan, online_scan)]
            futs += [pool.submit(native.ensure_built, name)
                     for name in ("fast_ingest", "rpc_frontend")]
            for fut in futs:
                fut.result()
        log(f"[build] {sig_scan.SOURCE.name}, {online_scan.SOURCE.name} built "
            f"and loaded, native/fast_ingest.cpp and native/rpc_frontend.cpp "
            f"built, in {time.perf_counter() - t0:.2f} s")
        for line in (sig_scan.build_log + online_scan.build_log).splitlines():
            if "entry function" in line:
                log(f"[build] {line.strip()[:120]}")
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
        if args.forensics_ab:
            run_forensics_ab(torch, Datum, ClassifierDriver,
                             RegressionDriver, args.forensics_ab,
                             os.path.abspath(args.parent) if args.parent
                             else "", args.seed, kind, smi)
            return 0
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
            started: dict = {}
            runs = [lambda: phase_recommender_server(
                Datum, RecommenderDriver, args.seed, started["recommender"]),
                lambda: phase_anomaly_server(Datum, AnomalyDriver, args.seed,
                                             started["anomaly"])]
            runs += [lambda m=m: phase_classifier_server(
                Datum, ClassifierNNDriver, m, args.seed,
                started[f"classifier_{m}"])
                for m in CLASSIFIER_NN_METHODS]
            try:
                start_phase7_servers(started)
                for run in runs:
                    res = run()
                    tag = {"classifier": "classifier_nn"}.get(
                        res["engine"], res["engine"] + "_server")
                    log(f"[{tag}] {json.dumps(res)} | {kind} | {smi}")
                    for m in KERNELS:
                        total[m] += res["launches"][m]
            finally:  # each run stopped its own; this stops the rest
                for proc, _, _ in started.values():
                    stop_server(proc)
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
            engines = (("classifier", ClassifierDriver, "arow.json"),
                       ("regression", RegressionDriver, "default.json"))
            # both boots overlap; each server is driven alone once both
            # answer
            started: dict = {}
            try:
                for engine, _, config in engines:
                    started[engine] = start_server(engine, os.path.join(
                        ROOT, "config", engine, config))
                await_started(started)
                for engine, driver, config in engines:
                    res = phase_linear_server(Datum, driver, engine, config,
                                              args.seed,
                                              started=started[engine])
                    log(f"[{engine}_server] {json.dumps(res)} | {kind} | "
                        f"{smi}")
                    query = ("classify" if engine == "classifier"
                             else "estimate")
                    flat_servers[engine] = dict(sequential=res["sequential"],
                                                **{query: res[query]})
                    for m in RECORDED:
                        total[m] += res["launches"][m]
            finally:  # each run stopped its own; this stops the rest
                for proc, _, _ in started.values():
                    stop_server(proc)
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
            for dim_bits in WIDTH_DIM_BITS:
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
        #: phase 19's autoscaler drill, run on phase 13's fleet
        autoscaled: dict = {}
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
            # the members tick their telemetry every second: phase 19's
            # autoscaler reads their queue gauges off the time series
            res = phase_fleet(Datum, args.seed,
                              member_flags="--telemetry-interval 1",
                              autoscale=True)
            autoscaled["result"] = res.pop("autoscale")
            for key in ("nearest_neighbor", "anomaly", "regression",
                        "broadcasts", "drain"):
                log(f"[deploy] {key} {json.dumps(res[key])} | {kind} | {smi}")
            for method, q in res["nearest_neighbor"]["queries"].items():
                log(f"[deploy] {method} p50 / p99 ms: direct "
                    f"{q['direct']['p50_ms']:.3f} / {q['direct']['p99_ms']:.3f},"
                    f" C++ relay {q['relay']['p50_ms']:.3f} / "
                    f"{q['relay']['p99_ms']:.3f}, Python-transport proxy "
                    f"{q['python_proxy']['p50_ms']:.3f} / "
                    f"{q['python_proxy']['p99_ms']:.3f} | {kind} | {smi}")
            log(f"[deploy] boot_s {res['boot_s']:.3f} visor children after "
                f"stop {res['visor_children_after_stop']}")
            for line in res["watch_frame"]:
                log(f"[deploy] watch | {line}")
            views = res["views"]
            for key in ("trace_tree", "alerts", "quality", "usage",
                        "incident", "watch_frame"):
                for line in views.pop(key):
                    log(f"[fleet_views] {key} | {line}")
            log(f"[fleet_views] {json.dumps(views)} | {kind} | {smi}")
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

        def checkpoint_forensics_path():
            dev = torch.device("cuda", 0)
            res = phase_checkpoint(torch, ClassifierDriver, dev, args.seed)
            log(f"[checkpoint] {json.dumps(res)} | {kind} | {smi}")
            res = log_forensics(torch, Datum, args.seed, kind, smi)
            return {"server_launches": res["server_launches"]}

        run_path("checkpoint_forensics", checkpoint_forensics_path)

        def server_planes_path():
            res = phase_server_planes(torch, Datum, NearestNeighborDriver,
                                      args.seed)
            for arm, r in res["arms"].items():
                log(f"[server_planes] {arm} {json.dumps(r)} | {kind} | "
                    f"{smi}")
            for key in ("drill", "regression", "nearest_neighbor",
                        "billing"):
                log(f"[server_planes] {key} {json.dumps(res[key])} | "
                    f"{kind} | {smi}")
            return {"server_launches": res["server_launches"]}

        run_path("server_planes", server_planes_path)

        def control_loops_path():
            from jubatus_tpu_torch.server.args import ServerArgs

            # (d)'s server and proxy boot, and (b)'s two ranks run in
            # processes of their own, while (a) runs in this one;
            # phase_legacy_wire stops (d)'s, or this does if (a) or (b)
            # fails
            legacy_server = start_legacy_server()
            pool = concurrent.futures.ThreadPoolExecutor(1)
            try:
                mix = pool.submit(phase_tune_mix, args.seed)
                res = phase_tune_coalescer(Datum, EngineServer, ServerArgs,
                                           online_scan, args.seed)
                for line in res.pop("view"):
                    log(f"[tune] view | {line}")
                log(f"[tune] coalescer {json.dumps(res)} | {kind} | {smi}")
                log(f"[tune] tick host ms p50 {res['tick_ms']['p50']:.4f} "
                    f"max {res['tick_ms']['max']:.4f} over "
                    f"{res['tick_ms']['count']} ticks | {kind} | {smi}")
                res = mix.result()
                log(f"[tune] mix {json.dumps(res)} | {kind} | {smi}")
            except BaseException:
                stop_server(legacy_server[0][0])
                stop_server(legacy_server[1][0])
                raise
            finally:
                pool.shutdown(wait=True)
            # (c) ran on phase 13's fleet; its S1 launches, read from the
            # regression members, count here
            auto = autoscaled["result"]
            total = dict(auto.pop("server_launches"))
            for line in auto.pop("watch_frame"):
                log(f"[autoscale] watch | {line}")
            log(f"[autoscale] {json.dumps(auto)} | {kind} | {smi}")
            log(f"[autoscale] first hot poll to the member answering "
                f"through the proxy {auto['first_hot_poll_to_answer_s']:.3f}"
                f" s, scale-in decision to leaving the actives "
                f"{auto['scale_in_to_left_s']:.3f} s | {kind} | {smi}")
            res = phase_legacy_wire(Datum, args.seed, legacy_server)
            for m in RECORDED:
                total[m] += res["server_launches"][m]
            log(f"[legacy_wire] {json.dumps(res)} | {kind} | {smi}")
            lat = res["neighbor_row_from_datum"]
            log(f"[legacy_wire] neighbor_row_from_datum p50 legacy "
                f"{lat['legacy']['p50_ms']:.3f} ms, modern "
                f"{lat['modern']['p50_ms']:.3f} ms | {kind} | {smi}")
            return {"server_launches": total}

        run_path("control_loops", control_loops_path)

        def ring_path():
            from jubatus_tpu_torch.parallel.mesh import ShardMesh

            assert_matmul_full_precision(torch)
            res = phase_ring(torch, sig_scan, ShardMesh, args.seed)
            for key, r in res.items():
                log(f"[ring] {key} {json.dumps(r)} | {kind} | {smi}")
            return {}

        def zk_fleet_path(fleet):
            res = phase_zk_fleet(Datum, args.seed, fleet)
            log(f"[zk_fleet] {json.dumps(res)} | {kind} | {smi}")
            log(f"[zk_fleet] through the proxies: neighbor_row_from_datum "
                f"p50 {res['neighbor_row_from_datum']['p50_ms']:.3f} p99 "
                f"{res['neighbor_row_from_datum']['p99_ms']:.3f} ms, set_row "
                f"p50 {res['set_row']['p50_ms']:.3f} p99 "
                f"{res['set_row']['p99_ms']:.3f} ms, train(256) p50 "
                f"{res['train_256']['p50_ms']:.3f} ms; a SIGTERMed member "
                f"left the actives in {res['leave_s']:.3f} s | {kind} | "
                f"{smi}")
            return {"server_launches": res["server_launches"]}

        # phase 20: the zk fleet boots while the ring runs in this process
        t0 = time.perf_counter()
        with contextlib.ExitStack() as zk_stack:
            fleet = start_zk_fleet(zk_stack)
            run_path("ring", ring_path)
            run_path("zk_fleet", lambda: zk_fleet_path(fleet))
        log(f"[phase20] {time.perf_counter() - t0:.3f} s (ring "
            f"{path_s['ring']:.3f} s while the fleet boots, zk_fleet "
            f"{path_s['zk_fleet']:.3f} s)")

        def raw_ingest_path():
            res = phase_raw_ingest(torch, Datum, EngineServer,
                                   ClassifierDriver, RegressionDriver,
                                   args.seed)
            for name, r in res.items():
                log(f"[raw_ingest] {name} {json.dumps(r)} | {kind} | {smi}")
                fl = r["flush"]
                log(f"[raw_ingest] {name}: train rows/s raw "
                    f"{r['raw']['clients1_rows_per_s']:.1f} / decoded "
                    f"{r['decoded']['clients1_rows_per_s']:.1f} (1 client), "
                    f"raw {r['raw']['clients4_rows_per_s']:.1f} / decoded "
                    f"{r['decoded']['clients4_rows_per_s']:.1f} "
                    f"({RAW_CLIENTS} clients); a {LINEAR_BATCH}-row call "
                    f"parses in {fl['parse_ms_p50']:.4f} ms, a raw flush "
                    f"merges in {fl['raw_prep_ms']:.4f} ms and its device "
                    f"stage takes {fl['raw_device_stage_ms']:.4f} ms host "
                    f"({fl['raw_device_event_ms']:.4f} ms CUDA events); the "
                    f"decoded flush featurizes in "
                    f"{fl['decoded_featurize_ms']:.4f} ms | {kind} | {smi}")
            return {}

        run_path("raw_ingest", raw_ingest_path)
        log(f"[phase21] {path_s['raw_ingest']:.3f} s")

        def native_transport_path():
            res = phase_native_transport(Datum, args.seed)
            log(f"[native_transport] {json.dumps(res)} | {kind} | {smi}")
            for name, _ in NT_TRANSPORTS:
                r = res[name]
                log(f"[native_transport] {name}: train rows/s "
                    f"{r['clients1']['rows_per_s']:.1f} "
                    f"(1 client, call p50 {r['clients1']['train']['p50_ms']:.3f}"
                    f" p99 {r['clients1']['train']['p99_ms']:.3f} ms), "
                    f"{r['clients4_pipelined']['rows_per_s']:.1f} "
                    f"({NT_CLIENTS} pipelined clients); estimate p50 "
                    f"{r['estimate']['p50_ms']:.3f} p99 "
                    f"{r['estimate']['p99_ms']:.3f} ms; S1 launches "
                    f"{r['s1_launches']} | {kind} | {smi}")
            return {"server_launches": res["server_launches"]}

        run_path("native_transport", native_transport_path)
        log(f"[phase22] {path_s['native_transport']:.3f} s")
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
        for mode in ("hamming", "pa_scan"):
            check(paths["checkpoint_forensics"][mode] > 0,
                  f"{mode} never launched on the checkpoint and forensics "
                  "path (phase 17)")
        for mode in ("hamming", "pa_scan"):
            check(paths["server_planes"][mode] > 0,
                  f"{mode} never launched on the server planes path "
                  "(phase 18)")
            check(paths["control_loops"][mode] > 0,
                  f"{mode} never launched on the control loops and legacy "
                  "wire path (phase 19)")
            check(paths["zk_fleet"][mode] > 0,
                  f"{mode} never launched on the zk fleet path (phase 20)")
        check(paths["raw_ingest"]["pa_scan"] > 0,
              "online_scan.pa never launched on the raw ingest path "
              "(phase 21)")
        check(paths["native_transport"]["pa_scan"] > 0,
              "online_scan.pa never launched on the native transport path "
              "(phase 22)")
        check(paths["ring"]["hamming"] == RING_SHARDS ** 2,
              f"the ring path launched K1 {paths['ring']['hamming']} times, "
              f"not S² = {RING_SHARDS ** 2}")
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
