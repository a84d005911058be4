#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``jubatus_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Drives the port only; imports nothing of JAX or of ``jubatus_tpu``. Phases,
each of which fails the run (non-zero exit, no result line) on error:

1. device: the card's name, and its name and power limit from nvidia-smi;
   builds ``jubatus_tpu_torch/csrc/sig_scan.cu`` with nvcc (sm_90a);
2. kernels: both modes of the signature scan against their plain PyTorch
   versions on the same tensors, bit-equal required: first at edge shapes
   (C in {1, 7, 4099}, B around each variant's limits, W in {2, 3, 64, 70},
   tables on and 4 bytes off 16-byte alignment), which must reach every
   kernel variant; then (hamming at hash_num 64, W=2; minhash at H=64) at
   B in {1, 256} and C = 1,000,003 rows with kernel, plain and library-call
   times (CUDA events), the variant that ran, the bound, and the same
   operations at the card's int32 issue rate;
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
   scan-launch count (get_status) must move.

Phases 3 and 4 are the main path: every launch count is set to 0 just
before them and read just after. The last lines are a ``{"kernels": ...}``
JSON line, the nvidia-smi line, and ``{"ok": true, "device": ...}``.
The sizes are fixed; ``--seed`` picks the random data.
"""

from __future__ import annotations

import argparse
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
SERVER_ROWS = 10_000          # set_row calls over the wire
REPS = 30                     # timed kernel launches per shape (median)
EDGE_C = (1, 7, 4099)         # phase 2 edge shapes
EDGE_W = (2, 3, 64, 70)
EDGE_B_EXTRA = ((4100, 4099, 2),)  # hamming past one shared query tile
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


def phase_backend(torch, sig_scan, knn, NNBackend, SparseBatch, method: str,
                  seed: int) -> dict:
    rows, queries = ROWS, QUERIES
    dim_bits, nnz, k = 18, 32, 10
    rng = np.random.default_rng(seed)
    be = NNBackend(method, dim=1 << dim_bits, hash_num=64, seed=0,
                   device="cuda")
    t0 = time.perf_counter()
    step = 50_000
    for lo in range(0, rows, step):
        idx, val = random_rows(rng, min(step, rows - lo), nnz, dim_bits)
        for i, (ii, vv) in enumerate(zip(idx.tolist(), val.tolist())):
            be.set_row(f"r{lo + i}", list(zip(ii, vv)))
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
    prof = profile_queries(torch, be, [list(zip(ii, vv)) for ii, vv in zip(
        pidx.tolist(), pval.tolist())], k, mean_ms)
    out = dict(method=method, rows=rows, queries=queries,
               load_s=t_load, flush_s=t_flush,
               flush_rows_per_s=rows / t_flush,
               query_mean_ms=mean_ms,
               query_p50_ms=lat[len(lat) // 2],
               query_p99_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))],
               kernel_launches=launched,
               table_bytes=int(table.numel() * table.element_size()),
               profile=prof)
    del be, table
    torch.cuda.empty_cache()
    return out


SIGNATURE_LABEL = "neighbors.query_signature"


def step_of(event) -> str:
    """The step of ``neighbors`` that a CPU op belongs to, from its
    ancestors: the query signature (under SIGNATURE_LABEL, which
    ``profile_queries`` puts around ``NNBackend._query_sig``), top-k (under
    aten::topk), the live mask (an aten::where outside the signature: the
    dead-slot mask of ``_distances_dev``), else ``other``."""
    names, p = set(), event
    while p is not None:
        names.add(p.name)
        p = p.cpu_parent
    if SIGNATURE_LABEL in names:
        return "signature"
    if "aten::topk" in names:
        return "topk"
    if "aten::where" in names:
        return "live_mask"
    return "other"


def busy_breakdown(prof, dev, n: int) -> dict:
    """Device time per query (ms) by step: the scan kernel (by name),
    copies (memcpy/memset items), and every other kernel by the step of the
    CPU op that launched it (``step_of``). Kernels the profiler linked to
    no CPU op are ``unattributed``."""
    from torch.autograd import DeviceType

    def is_copy(name: str) -> bool:
        return name.startswith(("Memcpy", "Memset"))

    us = dict(signature=0.0, scan=0.0, live_mask=0.0, topk=0.0, copies=0.0,
              other=0.0)
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
                    or kern.name == SIGNATURE_LABEL):
                continue
            attributed += kern.duration
            us[step] += kern.duration
    rest = sum(e.time_range.elapsed_us() for e in dev
               if "sig_scan" not in e.name and not is_copy(e.name))
    us["unattributed"] = rest - attributed
    return {f"{key}_ms": v / 1e3 / n for key, v in us.items()}


def profile_queries(torch, be, vecs, k: int, unprofiled_ms: float) -> dict:
    """Where a query's time goes: ``neighbors`` under torch.profiler gives
    the device-busy time (sum of kernel and copy durations), the device
    work items, the scan kernel's time per query and the busy time split
    by step (``busy_breakdown``). The profiler slows the host side, so the
    idle and scan shares are taken against ``unprofiled_ms``, the mean wall
    time of the same backend's timed queries; the profiled wall time is
    reported beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def labelled(vec):
        with record_function(SIGNATURE_LABEL):
            return query_sig(vec)

    query_sig = be._query_sig
    be._query_sig = labelled  # for these queries only; removed below
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for vec in vecs:
                be.neighbors(vec, k)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del be._query_sig
    # device work items; the label's own range on the device timeline spans
    # the whole signature step, idle time included, and is not one
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name != SIGNATURE_LABEL
           and not getattr(e, "is_user_annotation", False)]
    check(dev, "torch.profiler recorded no device work")
    n = len(vecs)
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
                busy_by_step=busy_breakdown(prof, dev, n),
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


def phase_server(torch, Datum, RpcClient, NearestNeighborDriver,
                 seed: int) -> dict:
    config_path = os.path.join(ROOT, "config", "nearest_neighbor", "lsh.json")
    with open(config_path) as f:
        config = json.load(f)
    port = free_port()
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "chip_smoke_server.log")
    cmd = [sys.executable, "-m", "jubatus_tpu_torch.server",
           "nearest_neighbor", "-f", config_path, "-p", str(port),
           "-b", "127.0.0.1", "-c", "4", "--device", "cuda"]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=logf,
                                stderr=subprocess.STDOUT)
    try:
        return _drive_server(torch, Datum, RpcClient, NearestNeighborDriver,
                             config, port, proc, SERVER_ROWS, seed, log_path)
    except Exception:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        print(f"--- server log ({log_path}), last lines:\n{tail}",
              file=sys.stderr)
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)


def _drive_server(torch, Datum, RpcClient, NearestNeighborDriver, config,
                  port, proc, rows, seed, log_path) -> dict:
    name = "smoke"
    cli = RpcClient("127.0.0.1", port, timeout=60.0)
    deadline = time.time() + 180
    while True:
        check(proc.poll() is None,
              f"server exited with {proc.returncode}; see {log_path}")
        try:
            cli.call("get_status", name)
            break
        except Exception:  # broad-ok — the server is still starting
            check(time.time() < deadline, "server did not answer in 180 s")
            time.sleep(0.5)
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
    st0 = next(iter(cli.call("get_status", name).values()))
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
    st1 = next(iter(cli.call("get_status", name).values()))
    key = "kernel.sig_scan.hamming.launches"
    moved = st1[key] - st0[key]
    check(st1.get("driver.device", "").startswith("cuda"),
          f"server runs on {st1.get('driver.device')!r}, not the card")
    check(moved == calls, f"server scan launches moved {moved} for "
                          f"{calls} queries")
    cli.close()
    lat.sort()
    return dict(rows=rows, set_row_s=t_set, query_calls=calls,
                query_p50_ms=lat[len(lat) // 2], query_max_ms=lat[-1],
                server_launches=int(st1[key]),
                server_minhash_launches=int(st1["kernel.sig_scan.minhash.launches"]),
                server_device=st1.get("driver.device"))


# ---------------------------------------------------------------------------
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
        from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
        from jubatus_tpu_torch.ops import knn, sig_scan
        from jubatus_tpu_torch.rpc.client import RpcClient
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
        sig_scan.library()
        log(f"[build] {sig_scan.SOURCE.name} built and loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        for line in sig_scan.build_log.splitlines():
            if "entry function" in line:
                log(f"[build] {line.strip()[:120]}")
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
        # -- phase 2: kernels vs plain, edge shapes first
        edges = phase_edges(torch, sig_scan, args.seed)
        log(f"[edges] {json.dumps(edges)}")
        scans = phase_kernels(torch, sig_scan, args.seed)
        # -- phases 3 + 4: the main path, counted from zero
        sig_scan.hamming.launches = 0
        sig_scan.minhash.launches = 0
        backends = {}
        for method in ("lsh", "minhash"):
            res = phase_backend(torch, sig_scan, knn, NNBackend, SparseBatch,
                                method, args.seed)
            backends[method] = res
            log(f"[backend] {json.dumps(res)} | {kind} | {smi}")
        srv = phase_server(torch, Datum, RpcClient, NearestNeighborDriver,
                           args.seed)
        log(f"[server] {json.dumps(srv)} | {kind} | {smi}")
        launches = {"hamming": sig_scan.hamming.launches + srv["server_launches"],
                    "minhash": sig_scan.minhash.launches
                    + srv["server_minhash_launches"]}
        for mode, n in launches.items():
            check(n > 0, f"sig_scan.{mode} never launched on the main path")
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for mode, spec in KERNELS.items():
        serving = scans[mode][0]  # B = 1, the single-query serving shape
        kernels.append({
            "name": spec["name"], "route": "cuda",
            "source": "jubatus_tpu_torch/csrc/sig_scan.cu",
            "replaces": "jubatus_tpu/ops/pallas_kernels.py:87",
            "launches": launches[mode],
            "max_abs_err": max(s["max_abs_err"] for s in scans[mode]),
            "ms": serving["kernel_ms"], "plain_ms": serving["plain_ms"],
            "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
            "library_ms": serving["library_ms"],
            "shapes": scans[mode],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
