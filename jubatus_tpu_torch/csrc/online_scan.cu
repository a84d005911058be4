// Regression's per-example passive-aggressive scan (PA / PA1 / PA2), for
// Hopper.
//
// Replaces no Pallas kernel: jubatus_tpu/ops/regression.py:train_batch runs
// the scan as a jax.lax.scan, which XLA compiles into one device-side loop.
// PyTorch has no such loop, and written on the host each example would cost
// about 15 small launches. Here the whole scan is one launch.
//
// For each example b in order (idx, val: [B, K]; y: [B]; w, dw: [D]):
//   pred  = sum_k (w[i_k] + dw[i_k]) * v_k
//   x2    = max(sum_k v_k * v_k, 1e-12)
//   err   = y_b - pred,  loss = |err| - sensitivity
//   alpha = PA: loss / x2;  PA1: min(c, loss / x2);  PA2: loss / (x2 + 1/(2c))
//   alpha = loss > 0 ? alpha : 0
//   dw[i_k] += (sign(err) * alpha) * v_k       for k = 0..K-1, in k order
//
// Order of the float operations (ops/online_scan.py:pa_scan_plain follows
// it): lane l of 32 adds the products k = l, l+32, ... in turn, then the
// lanes add in a tree (l + 16, then + 8, 4, 2, 1); an example's updates to
// one index add in k order. Every float operation is an _rn intrinsic, so
// nvcc contracts nothing into an FMA and the result is bit-equal to the
// plain version on the CPU.
//
// What bounds it: the chain of dependences. Example b's gather reads what
// example b-1 scattered, so the B examples run one after another. Bytes and
// operations are small (K * 8 bytes of input, ~7K flops per example). The
// chain of one example is: gather dw at its K features, multiply and add,
// a 5-step shuffle tree, err / loss / alpha (one division), scatter. With
// dw in device memory (the `direct` variant) the gather and the scatter's
// read-modify-write are two device-memory round trips per round of 32
// features. The table variants keep dw's working set in shared memory, so
// the chain's floor is one dependent shared-memory load and five dependent
// shuffle-adds an example, and every other step is taken off it.
//
// The table variants (`r1`, `r2`, `r4`: K <= 32, 64, 128, the rounds of 32
// features unrolled at compile time). One block of 24 warps:
// - Warp 0, the walker, runs the chain. Warps 4, 8, ..., 20 share the
//   walker's warp scheduler and leave at once, so no other warp takes its
//   issue slots. The other 18 warps stage.
// - Slot table: an open-addressed hash table in shared memory (2^14 slots,
//   linear probing, atomicCAS) from feature index to slot, each slot
//   holding that feature's dw. Staging maps every idx[b, k] to its slot;
//   the walker reads and writes only slots, by 32-bit shared addresses.
// - Staging fills a ring of two tiles of `tile` examples (tile * K <=
//   2048 elements) ahead of the walker. From a tile's indices and values
//   alone (cp.async copies) it works out per example x2 (clamped, plus
//   1/(2c) for PA2) and per round of 32 the groups of lanes that write one
//   feature (today's __match_any_sync masks; a zero value writes nothing,
//   see below), the largest group, and whether a feature written by an
//   earlier round is written again; then per element the slot, and w at
//   its index. A key new to the table is loaded into its slot from dw (a
//   cp.async by the thread that inserts it). The walker holds only keys
//   already in the table, so staging reads dw while the walker runs.
//   Tiles are handed over with mbarriers (full: staging -> walker, empty:
//   walker -> staging); the staging warps sync among themselves with a
//   named barrier (bar.sync, which also orders their memory accesses),
//   never with __syncthreads.
// - Flushes. When the table holds more than 3/4 of its slots less one
//   tile's elements (12288 - tile * K keys) before a tile, staging writes
//   back to dw every slot that the tile being walked does not use (pinned
//   from that tile's slot list), waits for the walker to finish it, writes
//   back that tile's slots and empties the table. The walker waits only
//   for that last part and the mapping of the next tile. A last write-back
//   ends the launch.
// - The walker's chain per example: gather the slots, multiply and add in
//   lane order, an XOR butterfly (every lane ends with the tree's sum; for
//   K <= 16 the levels over lanes past K, which add +0, become one add of
//   +0; the next example's ring entries load while the first shuffle is in
//   flight), err, loss, alpha, then the scatter: where every round's
//   writers hold distinct features not written earlier in the example, each
//   stores gathered + update, straight through; otherwise each group's
//   lowest lane adds the group's updates (shuffled in, lane order) to the
//   gathered value, or to the slot read again after a __syncwarp when an
//   earlier round wrote one.
// - Skipped writes. An update of +-0 (a zero value times a finite step)
//   leaves x unchanged for every x but -0.0, and a sum of two floats is
//   -0.0 only if both are -0.0; so where dw holds no -0.0 on entry (the
//   drivers' dw starts at +0.0) skipping them is bit-exact; with a -0.0 in
//   dw the two versions agree as values. An infinite or NaN step makes
//   those updates NaN: then every element writes, on a slower path.
// Shared memory, K = 64 (tile 32): table 131072 bytes (keys, dw), pins
// 16384, ring 2 x 33152 (slot, group, w, value per element; y, den, round
// info per example), barriers and counters 48: 213808 of 232448 bytes.
//
// The `direct` variant (K > 128: rows the table variants do not take) is
// the first design: one warp, dw in device memory, examples staged a tile
// at a time, __match_any_sync grouping duplicates in the scatter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a launch may take (H100: 227 KB per block)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;

enum Method { kPA = 0, kPA1 = 1, kPA2 = 2 };
enum Variant { kDirect = 0, kR1 = 1, kR2 = 2, kR4 = 3 };

// -- table variants ---------------------------------------------------------
constexpr int kWarps = 24;
constexpr int kThreads = kWarps * kLanes;
// warp 0 walks; warps 4, 8, ..., 20 (on the walker's scheduler) leave
constexpr int kStageWarps = kWarps - kWarps / 4;
constexpr int kStageThreads = kStageWarps * kLanes;
constexpr int kRing = 2;
constexpr int kStageBar = 1;     // named barrier of the staging warps
constexpr int kTableBits = 14;
constexpr int kSlots = 1 << kTableBits;
constexpr int kTileElems = 2048;
constexpr int kEmpty = -1;
// a round's info byte: the largest group of writers, and kRoundSeen when
// a writer's feature was written by an earlier round of the example
constexpr uint32_t kRoundSeen = 0x80u;

struct ScanArgs {
  const float* w;
  float* dw;
  const int* idx;
  const float* val;
  const float* y;
  // [flushes, walker: wait cycles, cycles; staging thread 0: cycles
  // waiting for a ring buffer, flushing, mapping, per example, in all]
  long long* stats;
  int B, K, tile;
  float sensitivity, c;
};

// Byte offsets of the table variants' shared memory; ops/online_scan.py
// computes the same total (smem_bytes).
struct Layout {
  size_t keys, tab, pin, ring, stride, bars, misc, total;
  // within a ring buffer of E = tile * K elements
  size_t g, wv, vv, y, den, rf;
};

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__host__ __device__ inline Layout layout(int K, int tile) {
  Layout L;
  const size_t e = (size_t)tile * K;
  L.keys = 0;
  L.tab = L.keys + (size_t)kSlots * 4;
  L.pin = L.tab + (size_t)kSlots * 4;
  L.ring = L.pin + (size_t)kSlots;
  L.g = e * 4;
  L.wv = L.g + e * 4;
  L.vv = L.wv + e * 4;
  L.y = L.vv + e * 4;
  L.den = L.y + (size_t)tile * 4;
  L.rf = L.den + (size_t)tile * 4;
  L.stride = up16(L.rf + (size_t)tile * 4);
  L.bars = L.ring + kRing * L.stride;
  L.misc = L.bars + 2 * kRing * 8;
  L.total = L.misc + 16;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory accesses by 32-bit address, in program order
__device__ __forceinline__ float lds_f(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t lds_u(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void sts_f(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait of over
// 2^34 cycles (~9 s) is a broken hand-over, and traps rather than hangs
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// the staging warps' barrier; it orders their shared and device memory
// accesses (bar.sync), so no fence goes with it
__device__ __forceinline__ void stage_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kStageBar), "n"(kStageThreads)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// every lane ends with the same sum, bit-equal to a shfl_down tree's lane
// 0 (each level adds the same two values; float addition commutes)
__device__ __forceinline__ float butterfly(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ uint32_t slot_hash(int key) {
  return ((uint32_t)key * 0x9E3779B1u) >> (32 - kTableBits);
}

// one ring buffer's arrays
struct Tile {
  uint32_t* sl;
  uint32_t* g;
  float* wv;
  float* vv;
  float* y;
  float* den;
  uint32_t* rf;
};

__device__ __forceinline__ Tile ring_tile(unsigned char* smem, const Layout& L,
                                          int j) {
  unsigned char* b = smem + L.ring + (size_t)j * L.stride;
  return Tile{reinterpret_cast<uint32_t*>(b),
              reinterpret_cast<uint32_t*>(b + L.g),
              reinterpret_cast<float*>(b + L.wv),
              reinterpret_cast<float*>(b + L.vv),
              reinterpret_cast<float*>(b + L.y),
              reinterpret_cast<float*>(b + L.den),
              reinterpret_cast<uint32_t*>(b + L.rf)};
}

// what the walker needs of one example, loaded ahead of the chain
template <int R>
struct Example {
  uint32_t word[R];
  uint32_t g[R];
  float wv[R];
  float v[R];
  float y, den;
  uint32_t rf;
};

// the 32-bit shared addresses of one ring buffer's arrays
struct TileAddr {
  uint32_t sl, g, wv, vv, y, den, rf;
};

// Lane `ml` of the tree's width reads element r * 32 + ml; with SKIP > 0
// the lanes past the width mirror the ones below it (ml = lane mod width),
// so every lane's tree ends with the same sum, and they write nothing.
template <int R>
__device__ __forceinline__ void load_example(Example<R>& x, const TileAddr& t,
                                             int e, int K, int ml, bool mine) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool on = r * kLanes + ml < K;
    // lanes past K read element 0 of the example and drop it
    const uint32_t at = 4u * (uint32_t)(e * K + (on ? r * kLanes + ml : 0));
    const uint32_t word = lds_u(t.sl + at), g = lds_u(t.g + at);
    const float wv = lds_f(t.wv + at), v = lds_f(t.vv + at);
    x.word[r] = on ? word : 0u;
    x.g[r] = on && mine ? g : 0u;
    x.wv[r] = on ? wv : 0.0f;
    x.v[r] = on ? v : 0.0f;
  }
  x.y = lds_f(t.y + 4u * e);
  x.den = lds_f(t.den + 4u * e);
  x.rf = lds_u(t.rf + 4u * e);
}

// The walker's tree. Lanes at and past K hold +0, so where K <= 2^(5 -
// SKIP) the tree's first SKIP levels add +0 to each lane below 2^(5 -
// SKIP): one add of +0 stands for them, bit for bit; the lanes above
// mirror those below (load_example), so every lane ends with the sum.
// `mid` runs while the first shuffle is in flight.
template <int SKIP, class F>
__device__ __forceinline__ float tree_sum(float v, F&& mid) {
  if (SKIP) v = __fadd_rn(v, 0.0f);
  if (SKIP < 5) {
    const float t = __shfl_xor_sync(kFull, v, 16 >> SKIP);
    mid();
    v = __fadd_rn(v, t);
  } else {
    mid();
  }
#pragma unroll
  for (int off = 8 >> SKIP; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Each group's updates, added by its lowest lane to `acc` in lane order
// (its own first, then the others' shuffled in) and stored at `at`; gmax
// is the largest group in the warp.
__device__ __forceinline__ void group_add(float acc, float u, uint32_t g,
                                          int gmax, uint32_t at, int lane) {
  acc = __fadd_rn(acc, u);
  uint32_t m = g & (g - 1);
  for (int i = 1; i < gmax; ++i) {
    const int src = m ? __ffs(m) - 1 : lane;
    const float t = __shfl_sync(kFull, u, src);
    if (m) {
      acc = __fadd_rn(acc, t);
      m &= m - 1;
    }
  }
  if (g && lane == __ffs(g) - 1) sts_f(at, acc);
}

template <int METHOD, int R, int SKIP, class F>
__device__ __forceinline__ void walk_example(const Example<R>& x,
                                             uint32_t tab, int K, int lane,
                                             int ml, float sens, float c,
                                             F&& prefetch) {
  float d[R];
#pragma unroll
  for (int r = 0; r < R; ++r) d[r] = lds_f(tab + 4u * x.word[r]);
  float pacc = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float p = r * kLanes + ml < K
                        ? __fmul_rn(__fadd_rn(x.wv[r], d[r]), x.v[r])
                        : 0.0f;
    pacc = r == 0 ? p : __fadd_rn(pacc, p);
  }
  // the next example's ring entries load in the tree's shadow
  const float pred = tree_sum<SKIP>(pacc, prefetch);
  const float err = __fsub_rn(x.y, pred);
  const float loss = __fsub_rn(fabsf(err), sens);
  float alpha = __fdiv_rn(loss, x.den);
  if (METHOD == kPA1) alpha = c < alpha ? c : alpha;
  alpha = loss > 0.0f ? alpha : 0.0f;
  const float sgn = err > 0.0f ? 1.0f : (err < 0.0f ? -1.0f : 0.0f);
  const float step = __fmul_rn(sgn, alpha);
  const bool finite = fabsf(step) <= 3.402823466e38f;
  // rounds whose writers repeat a feature or write one again (info > 1)
  constexpr uint32_t kRepeats = 0xfefefefeu >> (8 * (4 - R));
  if (__builtin_expect(finite && (x.rf & kRepeats) == 0u, 1)) {
    // the common case, straight through: writers store gathered + update
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (x.g[r])
        sts_f(tab + 4u * x.word[r], __fadd_rn(d[r], __fmul_rn(step, x.v[r])));
  } else if (finite) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t info = (x.rf >> (8 * r)) & 0xffu;
      const float u = __fmul_rn(step, x.v[r]);
      const uint32_t at = tab + 4u * x.word[r];
      if (info <= 1u) {  // distinct slots, none written earlier
        if (x.g[r]) sts_f(at, __fadd_rn(d[r], u));
      } else {
        // a slot an earlier round wrote is read again after its writes
        // (the others read again hold what the gather read)
        float acc = d[r];
        if (info & kRoundSeen) {
          __syncwarp();
          acc = lds_f(at);
        }
        group_add(acc, u, x.g[r], (int)(info & 0x3fu), at, lane);
      }
    }
  } else {
    // an infinite or NaN step turns a zero value's +-0 update into NaN:
    // then every element writes, grouped here (rare)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool on = lane == ml && r * kLanes + lane < K;
      const uint32_t at = tab + 4u * x.word[r];
      const uint32_t g =
          __match_any_sync(kFull, on ? (int)x.word[r] : -1 - lane);
      __syncwarp();  // earlier rounds' writes
      group_add(r == 0 ? d[r] : lds_f(at), __fmul_rn(step, x.v[r]),
                on ? g : 0u, (int)__reduce_max_sync(kFull, __popc(g)), at,
                lane);
    }
  }
  __syncwarp();  // this example's writes before the next one's gather
}

template <int METHOD, int R, int SKIP>
__device__ void walk_tiles(const ScanArgs& a, unsigned char* smem,
                           const Layout& L, uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x;
  // the table's address, kept in a register (not worked out again from
  // the block's shared window on the chain)
  uint32_t tab = smem_addr(smem + L.tab);
  asm volatile("mov.b32 %0, %0;" : "+r"(tab));
  const int ml = lane & ((kLanes >> SKIP) - 1);  // the lane it mirrors
  const int ntiles = (a.B + a.tile - 1) / a.tile;
  const long long t0 = clock64();
  long long waited = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int j = t % kRing;
    const long long w0 = clock64();
    bar_wait(&full[j], (t / kRing) & 1);
    waited += clock64() - w0;
    const Tile tl = ring_tile(smem, L, j);
    const TileAddr ta{smem_addr(tl.sl), smem_addr(tl.g), smem_addr(tl.wv),
                      smem_addr(tl.vv), smem_addr(tl.y), smem_addr(tl.den),
                      smem_addr(tl.rf)};
    const int n = min(a.tile, a.B - t * a.tile);
    Example<R> cur, nxt;
    load_example<R>(cur, ta, 0, a.K, ml, ml == lane);
    nxt = cur;
    for (int e = 0; e < n; ++e) {
      // (the last example loads itself again)
      walk_example<METHOD, R, SKIP>(cur, tab, a.K, lane, ml, a.sensitivity,
                                    a.c, [&] {
        load_example<R>(nxt, ta, min(e + 1, n - 1), a.K, ml, ml == lane);
      });
      cur = nxt;
    }
    bar_arrive(&empty[j]);  // every lane: the ring buffer and the slots
  }
  if (lane == 0) {
    a.stats[1] = waited;
    a.stats[2] = clock64() - t0;
  }
}

// the walker, its tree cut to the lanes below K (one round only)
template <int METHOD, int R>
__device__ void walker(const ScanArgs& a, unsigned char* smem,
                       const Layout& L, uint64_t* full, uint64_t* empty) {
  if constexpr (R > 1) {
    return walk_tiles<METHOD, R, 0>(a, smem, L, full, empty);
  }
  int skip = 0;  // tree levels over lanes that are all past K
  while (skip < 5 && (kLanes >> (skip + 1)) >= a.K) ++skip;
  switch (skip) {
    case 0: return walk_tiles<METHOD, R, 0>(a, smem, L, full, empty);
    case 1: return walk_tiles<METHOD, R, 1>(a, smem, L, full, empty);
    case 2: return walk_tiles<METHOD, R, 2>(a, smem, L, full, empty);
    case 3: return walk_tiles<METHOD, R, 3>(a, smem, L, full, empty);
    case 4: return walk_tiles<METHOD, R, 4>(a, smem, L, full, empty);
    default: return walk_tiles<METHOD, R, 5>(a, smem, L, full, empty);
  }
}

// A flush before tile t, in two parts. While the walker walks tile t - 1
// (it has finished every earlier tile): every slot that tile t - 1 does
// not use goes back to dw. The device memory's store rate for scattered
// words bounds this, so it is done while the walker runs.
__device__ void flush_early(const ScanArgs& a, const int* keys,
                            const float* tab, uint8_t* pin,
                            const uint32_t* prev, int n_prev, int stid) {
  for (int i = stid; i < n_prev; i += kStageThreads) pin[prev[i]] = 1;
  stage_sync();
  for (int h = stid; h < kSlots; h += kStageThreads) {
    const int key = keys[h];
    if (key != kEmpty && !pin[h]) a.dw[key] = tab[h];
  }
}

// Once the walker has finished tile t - 1: its slots go back to dw, and
// the table is empty again.
__device__ void flush_late(const ScanArgs& a, int* keys, const float* tab,
                           uint8_t* pin, const uint32_t* prev, int n_prev,
                           int stid) {
  for (int i = stid; i < n_prev; i += kStageThreads)
    a.dw[keys[prev[i]]] = tab[prev[i]];
  stage_sync();
  for (int h = stid; h < kSlots; h += kStageThreads) {
    keys[h] = kEmpty;
    pin[h] = 0;
  }
}

// the last write-back: every occupied slot; the walker has finished
__device__ void flush_all(const ScanArgs& a, const int* keys,
                          const float* tab, int stid) {
  for (int h = stid; h < kSlots; h += kStageThreads) {
    const int key = keys[h];
    if (key != kEmpty) a.dw[key] = tab[h];
  }
}

template <int METHOD, int R>
__device__ void stager(const ScanArgs& a, unsigned char* smem,
                       const Layout& L, uint64_t* full, uint64_t* empty,
                       int rank) {
  const int lane = threadIdx.x % kLanes;
  const int stid = rank * kLanes + lane;
  int* keys = reinterpret_cast<int*>(smem + L.keys);
  float* tab = reinterpret_cast<float*>(smem + L.tab);
  uint8_t* pin = smem + L.pin;
  int* occ = reinterpret_cast<int*>(smem + L.misc);
  const int K = a.K;
  const int ntiles = (a.B + a.tile - 1) / a.tile;
  const int cap = kSlots / 4 * 3 - a.tile * K;
  // PA2's 1 / (2c), rounded as the plain version rounds it
  const float inv2c = __fdiv_rn(1.0f, __fmul_rn(2.0f, a.c));
  int held = 0;  // keys in the table after the last tile was staged
  long long flushes = 0;
  // cycles of staging thread 0: waiting for a ring buffer, per-example
  // work, flushing, mapping elements to slots
  long long c_wait = 0, c_info = 0, c_flush = 0, c_map = 0;
  const long long c0 = clock64();
  for (int t = 0; t < ntiles; ++t) {
    const int j = t % kRing;
    long long c1 = clock64();
    if (t >= kRing) bar_wait(&empty[j], (t / kRing - 1) & 1);
    long long c2 = clock64();
    c_wait += c2 - c1;
    const Tile tl = ring_tile(smem, L, j);
    const int n = min(a.tile, a.B - t * a.tile);
    const size_t base = (size_t)t * a.tile * K;
    // the tile's indices (slot words hold them until the mapping), values
    // and targets, all in flight at once
    for (int i = stid; i < n * K; i += kStageThreads) {
      cp_async4(&tl.sl[i], &a.idx[base + i]);
      cp_async4(&tl.vv[i], &a.val[base + i]);
    }
    for (int i = stid; i < n; i += kStageThreads)
      cp_async4(&tl.y[i], &a.y[t * a.tile + i]);
    cp_async_wait_all();
    stage_sync();
    // each example (one warp), from its indices and values alone: the
    // groups of writers holding one index in each round, whether a round
    // writes an index an earlier round wrote, x2
    for (int e = rank; e < n; e += kStageWarps) {
      const int* ek = reinterpret_cast<const int*>(tl.sl) + (size_t)e * K;
      const float* ev = tl.vv + (size_t)e * K;
      float xacc = 0.0f;
      uint32_t rf = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = r * kLanes + lane;
        const bool on = k < K;
        const int key = on ? ek[k] : -1;
        const float v = on ? ev[k] : 0.0f;
        const bool wr = on && v != 0.0f;  // a zero value writes nothing
        const float x = on ? __fmul_rn(v, v) : 0.0f;
        xacc = r == 0 ? x : __fadd_rn(xacc, x);
        uint32_t g = __match_any_sync(kFull, wr ? key : -1 - lane);
        g = wr ? g : 0u;
        bool seen = false;
        const int earlier = min(r * kLanes, K);  // this example's
        for (int kk = 0; kk < earlier; ++kk)
          seen |= ek[kk] == key && ev[kk] != 0.0f;
        const uint32_t gmax = __reduce_max_sync(kFull, (uint32_t)__popc(g));
        const bool any_seen = __any_sync(kFull, seen && wr);
        if (on) tl.g[e * K + k] = g;
        rf |= (gmax | (any_seen ? kRoundSeen : 0u)) << (8 * r);
      }
      const float x2 = butterfly(xacc);
      const float x2s = x2 < 1e-12f ? 1e-12f : x2;
      if (lane == 0) {
        tl.den[e] = METHOD == kPA2 ? __fadd_rn(x2s, inv2c) : x2s;
        tl.rf[e] = rf;
      }
    }
    c1 = clock64();
    c_info += c1 - c2;
    c2 = c1;
    if (held > cap) {
      // held > cap >= one tile's elements: t >= 2, tile t - 1 is full
      const uint32_t* prev = ring_tile(smem, L, (t - 1) % kRing).sl;
      flush_early(a, keys, tab, pin, prev, a.tile * K, stid);
      bar_wait(&empty[(t - 1) % kRing], ((t - 1) / kRing) & 1);
      flush_late(a, keys, tab, pin, prev, a.tile * K, stid);
      if (stid == 0) *occ = 0;
      ++flushes;
      c1 = clock64();
      c_flush += c1 - c2;
      c2 = c1;
    }
    stage_sync();  // the tile's keys read; the flush done
    // each element: its slot (a key new to the table brings its dw), w at
    // its index
    int fresh = 0;
    for (int i = stid; i < n * K; i += kStageThreads) {
      const int key = (int)tl.sl[i];
      cp_async4(&tl.wv[i], &a.w[key]);
      uint32_t h = slot_hash(key);
      for (;;) {
        const int cur = reinterpret_cast<volatile int*>(keys)[h];
        if (cur == key) break;
        if (cur == kEmpty) {
          const int prev = atomicCAS(&keys[h], kEmpty, key);
          if (prev == kEmpty) {
            cp_async4(&tab[h], &a.dw[key]);
            ++fresh;
            break;
          }
          if (prev == key) break;
        }
        h = (h + 1) & (kSlots - 1);
      }
      tl.sl[i] = h;
    }
    fresh = __reduce_add_sync(kFull, fresh);
    if (lane == 0 && fresh) atomicAdd(occ, fresh);
    cp_async_wait_all();
    stage_sync();
    held = *reinterpret_cast<volatile int*>(occ);
    bar_arrive(&full[j]);
    c_map += clock64() - c2;
  }
  // the last tile walked: every slot back to dw
  bar_wait(&empty[(ntiles - 1) % kRing], ((ntiles - 1) / kRing) & 1);
  flush_all(a, keys, tab, stid);
  if (stid == 0) {
    a.stats[0] = flushes;
    a.stats[3] = c_wait;
    a.stats[4] = c_flush;
    a.stats[5] = c_map;
    a.stats[6] = c_info;
    a.stats[7] = clock64() - c0;
  }
}

template <int METHOD, int R>
__global__ void __launch_bounds__(kThreads, 1)
pa_scan_table(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.K, a.tile);
  int* keys = reinterpret_cast<int*>(smem + L.keys);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kRing;
  for (int h = threadIdx.x; h < kSlots; h += kThreads) {
    keys[h] = kEmpty;
    smem[L.pin + h] = 0;
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < kRing; ++j) {
      bar_init(&full[j], kStageThreads);
      bar_init(&empty[j], kLanes);
    }
    *reinterpret_cast<int*>(smem + L.misc) = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / kLanes;
  if (warp == 0) {
    walker<METHOD, R>(a, smem, L, full, empty);
  } else if (warp % 4 != 0) {
    stager<METHOD, R>(a, smem, L, full, empty, warp - 1 - warp / 4);
  }
}

template <int METHOD, int R>
cudaError_t launch_table(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = layout(a.K, a.tile).total;
  if (a.K > R * kLanes || (size_t)a.tile * a.K > kTileElems ||
      a.tile > 256 || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pa_scan_table<METHOD, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  pa_scan_table<METHOD, R><<<1, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// -- the direct variant -----------------------------------------------------
__device__ __forceinline__ float warp_tree(float v) {
  // lane 0 ends with the sum: v[l] + v[l + off] for off = 16, 8, 4, 2, 1
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

template <int METHOD>
__global__ void __launch_bounds__(kLanes, 1)
pa_scan_direct(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, tile = a.tile;
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(s_idx + tile * K);
  float* s_y = s_val + tile * K;
  float* s_upd = s_y + tile;
  const int lane = threadIdx.x;
  const int rounds = (K + kLanes - 1) / kLanes;
  const float inv2c = __fdiv_rn(1.0f, __fmul_rn(2.0f, a.c));
  const long long t0 = clock64();

  for (int base = 0; base < a.B; base += tile) {
    const int n = min(tile, a.B - base);
    __syncwarp();  // the previous tile's reads are done
    const int* gi = a.idx + (size_t)base * K;
    const float* gv = a.val + (size_t)base * K;
    for (int j = lane; j < n * K; j += kLanes) {
      s_idx[j] = gi[j];
      s_val[j] = gv[j];
    }
    for (int j = lane; j < n; j += kLanes) s_y[j] = a.y[base + j];
    __syncwarp();

    for (int e = 0; e < n; ++e) {
      const int* ei = s_idx + e * K;
      const float* ev = s_val + e * K;
      float pacc = 0.0f, xacc = 0.0f;
      for (int r = 0; r < rounds; ++r) {
        const int k = r * kLanes + lane;
        float p = 0.0f, x = 0.0f;
        if (k < K) {
          const int i = ei[k];
          const float v = ev[k];
          p = __fmul_rn(__fadd_rn(a.w[i], a.dw[i]), v);
          x = __fmul_rn(v, v);
        }
        pacc = r == 0 ? p : __fadd_rn(pacc, p);
        xacc = r == 0 ? x : __fadd_rn(xacc, x);
      }
      const float pred = warp_tree(pacc);
      const float x2 = warp_tree(xacc);
      const float err = __fsub_rn(s_y[e], pred);
      const float loss = __fsub_rn(fabsf(err), a.sensitivity);
      const float x2s = x2 < 1e-12f ? 1e-12f : x2;
      float alpha;
      if (METHOD == kPA) {
        alpha = __fdiv_rn(loss, x2s);
      } else if (METHOD == kPA1) {
        const float q = __fdiv_rn(loss, x2s);
        alpha = a.c < q ? a.c : q;
      } else {
        alpha = __fdiv_rn(loss, __fadd_rn(x2s, inv2c));
      }
      alpha = loss > 0.0f ? alpha : 0.0f;
      const float sgn = err > 0.0f ? 1.0f : (err < 0.0f ? -1.0f : 0.0f);
      const float step = __fmul_rn(sgn, alpha);

      for (int r = 0; r < rounds; ++r) {
        const int k = r * kLanes + lane;
        const bool on = k < K;
        const int i = on ? ei[k] : -1 - lane;  // lanes past K stand alone
        s_upd[lane] = on ? __fmul_rn(step, ev[k]) : 0.0f;
        const unsigned group = __match_any_sync(kFull, i);
        __syncwarp();
        if (on && lane == __ffs(group) - 1) {
          float acc = a.dw[i];
          for (unsigned m = group; m; m &= m - 1)
            acc = __fadd_rn(acc, s_upd[__ffs(m) - 1]);
          a.dw[i] = acc;
        }
        __syncwarp();  // this round's writes before the next reads
      }
    }
  }
  if (lane == 0) {
    for (int i = 0; i < 8; ++i) a.stats[i] = 0;
    a.stats[2] = clock64() - t0;
  }
}

size_t direct_smem(int K, int tile) {
  return (size_t)tile * K * 8 + (size_t)tile * 4 + kLanes * 4;
}

template <int METHOD>
cudaError_t launch_direct(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = direct_smem(a.K, a.tile);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        pa_scan_direct<METHOD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  pa_scan_direct<METHOD><<<1, kLanes, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int METHOD>
cudaError_t launch(const ScanArgs& a, int variant, cudaStream_t stream) {
  switch (variant) {
    case kDirect: return launch_direct<METHOD>(a, stream);
    case kR1: return launch_table<METHOD, 1>(a, stream);
    case kR2: return launch_table<METHOD, 2>(a, stream);
    case kR4: return launch_table<METHOD, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Measurement probe (not on any path): one thread follows `hops` dependent
// loads through `chain` in device memory (mode 0) or through its first
// kProbeWords words copied into shared memory (mode 2, a cycle within
// them), or one warp runs `hops` dependent shuffle-adds (mode 1), or `hops`
// steps of load, add, store, __syncwarp, each lane's next load at another
// word (mode 3: a dependent shared-memory load behind the warp's own
// store, as the walker's gather follows the last example's scatter).
// Timed over many hops, it gives the latency of one step of the scan's
// dependence chain on this card.
constexpr int kProbeWords = 8192;

__global__ void latency_probe_kernel(const int* __restrict__ chain, int hops,
                                     int mode, int* out) {
  __shared__ int s_chain[kProbeWords];
  if (mode == 0) {
    if (threadIdx.x != 0) return;
    int p = 0;
    for (int h = 0; h < hops; ++h) p = chain[p];
    out[0] = p;
  } else if (mode == 2) {
    for (int i = threadIdx.x; i < kProbeWords; i += kLanes)
      s_chain[i] = chain[i];
    __syncwarp();
    if (threadIdx.x != 0) return;
    int p = 0;
    for (int h = 0; h < hops; ++h) p = s_chain[p];
    out[0] = p;
  } else if (mode == 3) {
    for (int i = threadIdx.x; i < kProbeWords; i += kLanes) s_chain[i] = 0;
    __syncwarp();
    const uint32_t base = smem_addr(s_chain);
    uint32_t at = (threadIdx.x * 37u) % kProbeWords;
    float v = 0.0f;
    for (int h = 0; h < hops; ++h) {
      v = __fadd_rn(v, lds_f(base + 4u * at));
      sts_f(base + 4u * at, v);
      __syncwarp();
      at = (at + 33u) % kProbeWords;
    }
    if (threadIdx.x == 0) out[0] = __float_as_int(v);
  } else {
    float v = (float)threadIdx.x;
    for (int h = 0; h < hops; ++h)
      v = __fadd_rn(v, __shfl_down_sync(kFull, v, 1));
    if (threadIdx.x == 0) out[0] = __float_as_int(v);
  }
}

}  // namespace

extern "C" {

// Shared memory of one launch: variant 0 (direct) or 1-3 (table, r1 r2 r4).
size_t jt_pa_scan_smem_bytes(int K, int tile, int variant) {
  return variant == kDirect ? direct_smem(K, tile) : layout(K, tile).total;
}

// method: 0 PA, 1 PA1, 2 PA2. idx, val: [B, K] row-major; y: [B]; w, dw: [D]
// with every index in [0, D). dw is updated in place. `tile` examples are
// staged at a time. stats: 8 int64 the launch writes (ScanArgs::stats).
int jt_pa_scan(const float* w, float* dw, const int* idx, const float* val,
               const float* y, long long* stats, int B, int K, int tile,
               int variant, int method, float sensitivity, float c,
               void* stream) {
  if (B < 0 || K < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const ScanArgs a{w, dw, idx, val, y, stats, B, K, tile, sensitivity, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case kPA: return (int)launch<kPA>(a, variant, s);
    case kPA1: return (int)launch<kPA1>(a, variant, s);
    case kPA2: return (int)launch<kPA2>(a, variant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int jt_latency_probe(const int* chain, int hops, int mode, int* out,
                     void* stream) {
  latency_probe_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      chain, hops, mode, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
