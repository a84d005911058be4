// Signature-table scan for the LSH nearest-neighbor backends, for Hopper.
//
// Replaces the Pallas TPU kernel jubatus_tpu/ops/pallas_kernels.py:_sig_scan
// (body _sig_scan_kernel). Two modes over uint32 signature words:
//   hamming  out[b, c] = popcount(q[b] XOR r[c]) * (1 / hash_num)
//   minhash  out[b, c] = 1 - (#lanes with q[b, w] == r[c, w]) * (1 / W)
// q is [B, W], r is [C, W], out is [B, C] float32, all row-major. The table
// layout is shared with the backends and the converters and is not changed
// here: every variant reads rows of W contiguous words.
//
// What bounds each shape, and what each variant does about it. The wrapper
// (ops/sig_scan.py:choose_variant) picks the variant from (mode, B, W, table
// alignment); every variant computes the same bits. The parameters below
// were chosen by timing alternatives side by side on an H100.
//
// - hamming, W = 2 ("w2"). Bytes: the 8-byte rows (C*8 bytes) at B = 1, the
//   B*C*4-byte output at large B. A thread holds 4 groups of 4 consecutive
//   rows, each group two 16-byte loads, all issued before any is used, so
//   every load and store instruction of a warp covers 512 contiguous bytes.
//   The queries come from shared memory as uint2 broadcasts. Each query's 4
//   distances of a group leave as one 16-byte streaming store (__stcs, so
//   the output does not evict the table from L2); where C % 4 puts a query's
//   output row off 16-byte alignment, each lane stores the aligned slot that
//   starts in its group and takes the slot's tail from the next lane with a
//   shuffle. The grid covers the table once (at most 8 blocks per SM, then
//   it strides). At B = 1 and C = 10^6 the whole job is ~12 MB: the launch
//   and one memory round trip are most of its time.
// - minhash, small B (B <= kSmallB, W % 4 == 0, "stream"). Bytes: the C*W*4
//   table (256 MB at C = 10^6, W = 64). A persistent grid (4 blocks per SM)
//   streams row tiles of <= 16 KB through a 2-stage shared-memory ring, each
//   tile one contiguous 1-D bulk copy (cp.async.bulk, the TMA's non-tensor
//   copy) completing on an mbarrier, so each block has one tile in flight
//   while it compares the other. More blocks with shallower rings kept more
//   of the memory rate than fewer blocks with deeper ones. A row is split across G = W/4 lanes (rounded up
//   to a power of two, at most 32), each comparing 16 bytes at a time against
//   the queries kept in shared memory; the lane group's counts are summed
//   with __shfl_xor_sync. The ring rather than plain 16-byte loads: it keeps
//   the loads in flight without holding them in registers, and a tile is one
//   instruction of one thread. A ring wait that has not completed after
//   about 2^34 clocks traps, so a fault fails the launch instead of hanging
//   the card.
// - minhash, large B (B > kSmallB, W % 4 == 0, W <= 128, "tiled"). int32
//   issue: a compare and a count per (query, row, word), against Hopper's
//   64 int32 lanes per SM and clock. A block holds 64 rows and steps
//   through 64-query tiles, both in shared memory (rows padded by 4 words
//   so that 16-byte loads of 16 rows hit distinct banks); a thread keeps a
//   4-row x 4-query register tile and reads words as uint4, so one 16-byte
//   shared load feeds 16 compares. Each compare is a setp and a predicated
//   add (eq_add), which ptxas issues as ISETP and a predicated VIADD; the
//   C++ form `acc += (a == b)` became three instructions (ISETP, VIADD,
//   predicated IMAD.MOV) and ran 25% slower. Registers are capped at 64 so
//   that 4 blocks share an SM.
// - any other width, or a table whose data does not start on 16 bytes
//   ("generic"): one thread per row, queries in shared memory tiled at
//   48 KB, the row's words read from global memory per query word.
//
// - the gathered variant ("gather", the IVF rescore of ops/ivf.py): each
//   query b is scored against its own candidate rows r[cand[b, m]] instead
//   of the whole table, out [B, M], +inf where cand is -1. Blocks over
//   (candidate chunk, query), one thread per candidate, the query's words
//   in shared memory, the row's words read through its slot id (16 bytes
//   at a time when W % 4 == 0 on a 16-byte-aligned table). A slot >= C is
//   outside the table: its output is NaN. Bytes: each candidate's row and
//   slot id once, its distance once; a simple kernel, not yet tuned.
//
// Every variant forms the distance as the Pallas kernel does, in float32,
// with the _rn intrinsics so that nvcc cannot contract 1 - n*s into an FMA.
// Each entry point checks its variant's preconditions and returns
// cudaErrorInvalidValue when they do not hold; none falls back to another.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kQueryTileWords = 48 * 1024 / 4;  // generic: queries per tile
constexpr int kMaxDevices = 64;

// minhash "stream"
constexpr int kSmallB = 4;           // ops/sig_scan.py: SMALL_B
constexpr int kStreamMaxW = 512;     // ops/sig_scan.py: STREAM_MAX_W
constexpr int kStages = 2;
constexpr int kStageBytes = 16 * 1024;
constexpr int kStreamBlocksPerSM = 4;
constexpr int kStreamSmem =
    kStages * kStageBytes + kSmallB * kStreamMaxW * 4 + kStages * 8;
static_assert(kStreamSmem <= 48 * 1024, "stream: needs no opt-in");

// minhash "tiled"
constexpr int kTiledMaxW = 128;      // ops/sig_scan.py: TILED_MAX_W
constexpr int kTileRows = 64;
constexpr int kTileQueries = 64;
constexpr int kTiledBlocksPerSM = 4;  // caps registers at 64 a thread
constexpr int kTiledSmem = (kTileRows + kTileQueries) * (kTiledMaxW + 4) * 4;

// hamming "w2"
constexpr int kW2QueryTile = 4096;   // uint2 queries per shared tile (32 KB)
constexpr int kW2BlocksPerSM = 8;
constexpr int kW2U = 4;             // row groups per thread

__device__ __forceinline__ float hamming_dist(unsigned cnt, float scale) {
  return __fmul_rn((float)cnt, scale);
}

__device__ __forceinline__ float minhash_dist(unsigned cnt, float scale) {
  return __fsub_rn(1.0f, __fmul_rn((float)cnt, scale));
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// acc += (a == b) as a compare and a predicated add: two instructions, where
// nvcc's own code for the C++ form spends three (compare, add, select).
__device__ __forceinline__ void eq_add(unsigned& acc, uint32_t a, uint32_t b) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.eq.u32 p, %1, %2;\n\t"
      "@p add.u32 %0, %0, 1;\n\t}"
      : "+r"(acc)
      : "r"(a), "r"(b));
}

__device__ __forceinline__ void eq4_add(unsigned& acc, uint4 a, uint4 b) {
  eq_add(acc, a.x, b.x);
  eq_add(acc, a.y, b.y);
  eq_add(acc, a.z, b.z);
  eq_add(acc, a.w, b.w);
}

// ---------------------------------------------------------------------------
// generic: PR 1's design, for odd widths and unaligned tables
// ---------------------------------------------------------------------------
template <bool kMinhash>
__global__ void __launch_bounds__(kThreads)
sig_scan_generic(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
                 float* __restrict__ out, int B, int C, int W, int tile,
                 float scale) {
  extern __shared__ uint32_t qs[];
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < C;
  const uint32_t* rp = r + row * W;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int nb = min(tile, B - b0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nb * W; i += kThreads)
      qs[i] = q[(int64_t)b0 * W + i];
    __syncthreads();
    if (!live) continue;
    for (int b = 0; b < nb; ++b) {
      const uint32_t* qb = qs + b * W;
      unsigned cnt = 0;
      for (int w = 0; w < W; ++w) {
        const uint32_t x = __ldg(rp + w);
        cnt += kMinhash ? (unsigned)(qb[w] == x) : __popc(qb[w] ^ x);
      }
      out[(int64_t)(b0 + b) * C + row] =
          kMinhash ? minhash_dist(cnt, scale) : hamming_dist(cnt, scale);
    }
  }
}

// ---------------------------------------------------------------------------
// hamming, W = 2: four rows per thread, 16-byte loads and stores
// ---------------------------------------------------------------------------
// Stores d[0..3], the distances of rows x0..x0+3, into one output row `o`.
// Lanes of a warp hold consecutive row groups, so m, the misalignment of
// o + x0 in floats, is the same on every lane. With m == 0 each lane stores
// its group; otherwise it stores the aligned slot that starts m rows before
// the end of its group, the slot's last 4 - m values coming from the next
// lane. Lane 31 has no next lane and lane 0 owns the head of a slot that
// began in the previous warp: both store those parts one float at a time.
template <int M>
__device__ __forceinline__ void store_shifted(float* o, int64_t x0, int64_t C,
                                              const float (&d)[4], int lane) {
  float n[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) n[i] = __shfl_down_sync(0xffffffffu, d[i], 1);
  float s[4];
#pragma unroll
  for (int i = 0; i < M; ++i) s[i] = d[4 - M + i];
#pragma unroll
  for (int i = M; i < 4; ++i) s[i] = n[i - M];
  const int64_t xs = x0 + 4 - M;  // first row of the slot
  if (lane < 31 && xs + 3 < C) {
    __stcs(reinterpret_cast<float4*>(o + xs), make_float4(s[0], s[1], s[2], s[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((i < M || lane < 31) && xs + i < C) __stcs(o + xs + i, s[i]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4 - M; ++i)
      if (x0 + i < C) __stcs(o + x0 + i, d[i]);
  }
}

__device__ __forceinline__ void store_group(float* o, int64_t x0, int64_t C,
                                            const float (&d)[4], int lane) {
  const int m = (int)((reinterpret_cast<uintptr_t>(o + x0) >> 2) & 3);
  switch (m) {
    case 0:
      if (x0 + 3 < C) {
        __stcs(reinterpret_cast<float4*>(o + x0), make_float4(d[0], d[1], d[2], d[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (x0 + i < C) __stcs(o + x0 + i, d[i]);
      }
      break;
    case 1: store_shifted<1>(o, x0, C, d, lane); break;
    case 2: store_shifted<2>(o, x0, C, d, lane); break;
    default: store_shifted<3>(o, x0, C, d, lane); break;
  }
}

// A thread holds kW2U row groups, kThreads groups apart, so that each of
// the block's kW2U slices of kThreads groups is contiguous and every warp
// holds 32 consecutive groups. All its groups are loaded before any is used.
__global__ void __launch_bounds__(kThreads)
sig_scan_hamming_w2(const uint32_t* __restrict__ q, const uint4* __restrict__ r,
                    float* __restrict__ out, int B, int C, float scale) {
  __shared__ uint2 qs[kW2QueryTile];
  const int lane = threadIdx.x & 31;
  const int64_t groups = ((int64_t)C + 3) / 4;
  const uint2* r2 = reinterpret_cast<const uint2*>(r);
  for (int b0 = 0; b0 < B; b0 += kW2QueryTile) {
    const int nb = min(kW2QueryTile, B - b0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nb; i += kThreads)
      qs[i] = make_uint2(q[2 * (b0 + i)], q[2 * (b0 + i) + 1]);
    __syncthreads();
    // every lane of a warp runs each iteration (the stores shuffle); a group
    // past the table has no rows and stores nothing
    for (int64_t g0 = (int64_t)blockIdx.x * kThreads * kW2U; g0 < groups;
         g0 += (int64_t)gridDim.x * kThreads * kW2U) {
      uint2 rw[kW2U][4];
#pragma unroll
      for (int u = 0; u < kW2U; ++u) {
        const int64_t x0 = (g0 + u * kThreads + threadIdx.x) * 4;
        if (x0 + 3 < C) {
          const uint4 a = __ldg(r + x0 / 2);
          const uint4 b = __ldg(r + x0 / 2 + 1);
          rw[u][0] = make_uint2(a.x, a.y);
          rw[u][1] = make_uint2(a.z, a.w);
          rw[u][2] = make_uint2(b.x, b.y);
          rw[u][3] = make_uint2(b.z, b.w);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            rw[u][i] = x0 + i < C ? __ldg(r2 + x0 + i) : make_uint2(0, 0);
        }
      }
      for (int b = 0; b < nb; ++b) {
        const uint2 qq = qs[b];
#pragma unroll
        for (int u = 0; u < kW2U; ++u) {
          float d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            d[i] = hamming_dist(
                __popc(qq.x ^ rw[u][i].x) + __popc(qq.y ^ rw[u][i].y), scale);
          store_group(out + (int64_t)(b0 + b) * C,
                      (g0 + u * kThreads + threadIdx.x) * 4, C, d, lane);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// minhash, small B: a persistent grid streaming row tiles through a ring
// filled by 1-D bulk copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also tells the barrier how many bytes the copy brings.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the barrier's phase of this parity has completed; traps after
// about 2^34 clocks so that a fault fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// G lanes per row (a power of two), TR rows per tile (a multiple of
// kThreads / G, so every warp runs the same number of row passes).
__global__ void __launch_bounds__(kThreads, kStreamBlocksPerSM)
sig_scan_minhash_stream(const uint32_t* __restrict__ q,
                        const uint32_t* __restrict__ r, float* __restrict__ out,
                        int B, int C, int W, int G, int TR, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  uint32_t* qs = ring + kStages * kStageBytes / 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(qs + kSmallB * W);
  const int tid = threadIdx.x;
  const int64_t tiles = ((int64_t)C + TR - 1) / TR;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  for (int i = tid; i < B * W; i += kThreads) qs[i] = q[i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0 asks for the block's i-th tile into stage i % kStages
  auto issue = [&](int64_t i) {
    const int64_t t = blockIdx.x + i * gridDim.x;
    const int64_t row0 = t * TR;
    const uint32_t bytes = (uint32_t)(min64(TR, C - row0) * W * 4);
    uint64_t* bar = &bars[i % kStages];
    mbar_expect_tx(bar, bytes);
    bulk_copy_g2s(ring + (i % kStages) * (kStageBytes / 4), r + row0 * W,
                  bytes, bar);
  };
  if (tid == 0)
    for (int64_t i = 0; i < min64(kStages, mine); ++i) issue(i);

  const int gl = tid & (G - 1);  // lane within the row's group
  const int passes = kThreads / G;
  const int w4 = W / 4;
  for (int64_t i = 0; i < mine; ++i) {
    mbar_wait(&bars[i % kStages], (uint32_t)((i / kStages) & 1));
    const int64_t row0 = (blockIdx.x + i * gridDim.x) * TR;
    const int64_t rows = min64(TR, C - row0);
    const uint32_t* tile = ring + (i % kStages) * (kStageBytes / 4);
    for (int rl = tid / G; rl < TR; rl += passes) {
      unsigned cnt[kSmallB] = {};
      for (int j = gl; j < w4; j += G) {
        const uint4 x = *reinterpret_cast<const uint4*>(tile + rl * W + 4 * j);
#pragma unroll
        for (int b = 0; b < kSmallB; ++b)
          if (b < B)
            eq4_add(cnt[b], x, *reinterpret_cast<const uint4*>(qs + b * W + 4 * j));
      }
#pragma unroll
      for (int b = 0; b < kSmallB; ++b) {
        if (b >= B) break;
        unsigned c = cnt[b];
        for (int m = G / 2; m > 0; m >>= 1) c += __shfl_xor_sync(0xffffffffu, c, m);
        // rows past the ragged last tile hold stale words: not stored
        if (gl == 0 && rl < rows)
          out[(int64_t)b * C + row0 + rl] = minhash_dist(c, scale);
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (tid == 0 && i + kStages < mine) issue(i + kStages);
  }
}

// ---------------------------------------------------------------------------
// minhash, large B: 64 rows x 64 queries per block step, a 4 x 4 register
// tile per thread
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, kTiledBlocksPerSM)
sig_scan_minhash_tiled(const uint32_t* __restrict__ q,
                       const uint32_t* __restrict__ r, float* __restrict__ out,
                       int B, int C, int W, float scale) {
  extern __shared__ __align__(16) uint32_t tiles[];
  const int ld = W + 4;  // padded row stride in words
  uint32_t* rs = tiles;
  uint32_t* qs = tiles + kTileRows * ld;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int w4 = W / 4;
  const int64_t row0 = (int64_t)blockIdx.x * kTileRows;
  const int rows = (int)min64(kTileRows, C - row0);

  const uint4* rg = reinterpret_cast<const uint4*>(r + row0 * W);
  for (int i = tid; i < kTileRows * w4; i += kThreads) {
    const int rr = i / w4, j = i - rr * w4;
    *reinterpret_cast<uint4*>(rs + rr * ld + 4 * j) =
        rr < rows ? __ldg(rg + i) : make_uint4(0, 0, 0, 0);
  }
  for (int b0 = 0; b0 < B; b0 += kTileQueries) {
    const int nb = min(kTileQueries, B - b0);
    __syncthreads();  // the previous query tile is no longer read
    for (int i = tid; i < kTileQueries * W; i += kThreads) {
      const int bb = i / W, w = i - bb * W;
      qs[bb * ld + w] = bb < nb ? q[(int64_t)(b0 + bb) * W + w] : 0u;
    }
    __syncthreads();
    unsigned acc[4][4] = {};
    for (int j = 0; j < w4; ++j) {
      uint4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const uint4*>(rs + (tx + 16 * i) * ld + 4 * j);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        b[k] = *reinterpret_cast<const uint4*>(qs + (ty + 16 * k) * ld + 4 * j);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) eq4_add(acc[k][i], a[i], b[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int bq = ty + 16 * k;
      if (bq >= nb) continue;
      float* o = out + (int64_t)(b0 + bq) * C + row0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (tx + 16 * i < rows) __stcs(o + tx + 16 * i, minhash_dist(acc[k][i], scale));
    }
  }
}


// ---------------------------------------------------------------------------
// gathered: each query against its own candidate rows (the IVF rescore)
// ---------------------------------------------------------------------------
template <bool kMinhash, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sig_scan_gather(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
                const int32_t* __restrict__ cand, float* __restrict__ out,
                int C, int M, int W, float scale) {
  extern __shared__ uint32_t qs[];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < W; i += kThreads) qs[i] = q[(int64_t)b * W + i];
  __syncthreads();
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const int64_t o = (int64_t)b * M + m;
  const int32_t slot = __ldg(cand + o);
  if (slot < 0) {
    out[o] = __int_as_float(0x7f800000);  // +inf: padding
    return;
  }
  if (slot >= C) {
    out[o] = __int_as_float(0x7fc00000);  // NaN: outside the table
    return;
  }
  const uint32_t* rp = r + (int64_t)slot * W;
  unsigned cnt = 0;
  if (kVec4) {
    const uint4* r4 = reinterpret_cast<const uint4*>(rp);
    for (int j = 0; j < W / 4; ++j) {
      const uint4 x = __ldg(r4 + j);
      const uint32_t* qw = qs + 4 * j;
      if (kMinhash) {
        eq4_add(cnt, x, make_uint4(qw[0], qw[1], qw[2], qw[3]));
      } else {
        cnt += __popc(qw[0] ^ x.x) + __popc(qw[1] ^ x.y) +
               __popc(qw[2] ^ x.z) + __popc(qw[3] ^ x.w);
      }
    }
  } else {
    for (int w = 0; w < W; ++w) {
      const uint32_t x = __ldg(rp + w);
      cnt += kMinhash ? (unsigned)(qs[w] == x) : __popc(qs[w] ^ x);
    }
  }
  out[o] = kMinhash ? minhash_dist(cnt, scale) : hamming_dist(cnt, scale);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
int sm_count() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev]) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices) cache[dev] = n;
  return n;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_shape(int B, int C, int W) { return B <= 0 || C <= 0 || W <= 0; }

template <bool kMinhash>
int launch_generic(const void* q, const void* r, void* out, int B, int C,
                   int W, float scale, void* stream) {
  if (bad_shape(B, C, W) || W > kQueryTileWords)
    return (int)cudaErrorInvalidValue;
  const int tile = kQueryTileWords / W;
  const dim3 grid((unsigned)((C + kThreads - 1) / kThreads));
  const size_t smem = (size_t)std::min(tile, B) * W * sizeof(uint32_t);
  sig_scan_generic<kMinhash><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<float*>(out), B, C, W, tile, scale);
  return (int)cudaGetLastError();
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}


template <bool kMinhash>
int launch_gather(const void* q, const void* r, const void* cand, void* out,
                  int B, int C, int M, int W, float scale, void* stream) {
  if (bad_shape(B, C, W) || M <= 0 || B > 65535 || W > kQueryTileWords)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + kThreads - 1) / kThreads), (unsigned)B);
  const size_t smem = (size_t)W * sizeof(uint32_t);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint32_t* rr = static_cast<const uint32_t*>(r);
  const int32_t* cc = static_cast<const int32_t*>(cand);
  float* oo = static_cast<float*>(out);
  if (W % 4 == 0 && aligned16(r))
    sig_scan_gather<kMinhash, true><<<grid, kThreads, smem, st>>>(
        qq, rr, cc, oo, C, M, W, scale);
  else
    sig_scan_gather<kMinhash, false><<<grid, kThreads, smem, st>>>(
        qq, rr, cc, oo, C, M, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jt_sig_scan_hamming_generic(const void* q, const void* r,
                                           void* out, int B, int C, int W,
                                           float scale, void* stream) {
  return launch_generic<false>(q, r, out, B, C, W, scale, stream);
}

extern "C" int jt_sig_scan_minhash_generic(const void* q, const void* r,
                                           void* out, int B, int C, int W,
                                           float scale, void* stream) {
  return launch_generic<true>(q, r, out, B, C, W, scale, stream);
}

extern "C" int jt_sig_scan_hamming_w2(const void* q, const void* r, void* out,
                                      int B, int C, int W, float scale,
                                      void* stream) {
  if (bad_shape(B, C, W) || W != 2 || !aligned16(r))
    return (int)cudaErrorInvalidValue;
  const int64_t groups = ((int64_t)C + 3) / 4;
  const int64_t want = (groups + kThreads * kW2U - 1) / (kThreads * kW2U);
  const int grid = (int)std::min<int64_t>(want, (int64_t)sm_count() * kW2BlocksPerSM);
  sig_scan_hamming_w2<<<std::max(grid, 1), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint4*>(r),
      static_cast<float*>(out), B, C, scale);
  return (int)cudaGetLastError();
}

extern "C" int jt_sig_scan_minhash_stream(const void* q, const void* r,
                                          void* out, int B, int C, int W,
                                          float scale, void* stream) {
  if (bad_shape(B, C, W) || B > kSmallB || W % 4 || W > kStreamMaxW ||
      !aligned16(r))
    return (int)cudaErrorInvalidValue;
  const int G = std::min(32, next_pow2(W / 4));
  const int passes = kThreads / G;
  const int TR = std::max(passes, kStageBytes / (W * 4) / passes * passes);
  const int64_t tiles = ((int64_t)C + TR - 1) / TR;
  const int grid = (int)std::min<int64_t>(tiles, (int64_t)sm_count() * kStreamBlocksPerSM);
  const size_t smem = kStages * kStageBytes + (size_t)kSmallB * W * 4 + kStages * 8;
  sig_scan_minhash_stream<<<std::max(grid, 1), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<float*>(out), B, C, W, G, TR, scale);
  return (int)cudaGetLastError();
}

extern "C" int jt_sig_scan_minhash_tiled(const void* q, const void* r,
                                         void* out, int B, int C, int W,
                                         float scale, void* stream) {
  if (bad_shape(B, C, W) || W % 4 || W > kTiledMaxW || !aligned16(r))
    return (int)cudaErrorInvalidValue;
  // lift the dynamic shared-memory limit above 48 KB, once per device
  static bool lifted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < kMaxDevices && lifted[dev])) {
    err = cudaFuncSetAttribute(sig_scan_minhash_tiled,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTiledSmem);
    if (err == cudaSuccess && dev < kMaxDevices) lifted[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kTileRows - 1) / kTileRows));
  const size_t smem = (size_t)(kTileRows + kTileQueries) * (W + 4) * 4;
  sig_scan_minhash_tiled<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<float*>(out), B, C, W, scale);
  return (int)cudaGetLastError();
}

extern "C" int jt_sig_scan_hamming_gather(const void* q, const void* r,
                                          const void* cand, void* out, int B,
                                          int C, int M, int W, float scale,
                                          void* stream) {
  return launch_gather<false>(q, r, cand, out, B, C, M, W, scale, stream);
}

extern "C" int jt_sig_scan_minhash_gather(const void* q, const void* r,
                                          const void* cand, void* out, int B,
                                          int C, int M, int W, float scale,
                                          void* stream) {
  return launch_gather<true>(q, r, cand, out, B, C, M, W, scale, stream);
}
