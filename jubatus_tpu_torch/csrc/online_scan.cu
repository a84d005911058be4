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
// What bounds it: the chain of dependences. Example b's gather reads what
// example b-1 scattered, so the B examples run one after another, each at
// least one global-memory round trip for the gather, one for the scatter's
// read-modify-write and one warp reduction. Bytes and operations are small
// (K*8 bytes of input and ~6K flops per example). The design keeps each
// step of the chain short:
// - One warp does the whole scan, so the order between examples needs only
//   __syncwarp (which orders the warp's memory accesses), no block barrier.
// - The examples' idx / val / y come into shared memory a tile at a time
//   with coalesced loads, so no example waits on its own index load before
//   its gather.
// - Lane l takes k = l, l+32, l+64, ...: it adds its products in that order,
//   then the warp adds across lanes in a shuffle tree (offsets 16, 8, 4, 2,
//   1). ops/online_scan.py:pa_scan_plain sums in the same order.
// - Duplicate indices within an example add in k order, as the reference's
//   .at[idx].add does, without atomics: per round of 32 k's,
//   __match_any_sync groups the lanes holding one index, and the lowest of
//   them reads dw once, adds the group's updates in lane order and writes
//   it back; rounds run in order. So each dw entry sees the same additions
//   in the same order as the plain version's serial index_put_.
// Every float operation is an _rn intrinsic, so nvcc cannot contract a
// product and a sum into an FMA: the result is bit-equal to the plain
// version on the CPU, which rounds each operation and scatters serially.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a launch may take (H100: 227 KB per block)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;

enum Method { kPA = 0, kPA1 = 1, kPA2 = 2 };

__device__ __forceinline__ float warp_tree(float v) {
  // lane 0 ends with the sum: v[l] + v[l + off] for off = 16, 8, 4, 2, 1
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

template <int METHOD>
__global__ void __launch_bounds__(kLanes, 1)
pa_scan_kernel(const float* __restrict__ w, float* dw,
               const int* __restrict__ idx, const float* __restrict__ val,
               const float* __restrict__ y, int B, int K, int tile,
               float sensitivity, float c) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(s_idx + tile * K);
  float* s_y = s_val + tile * K;
  float* s_upd = s_y + tile;
  const int lane = threadIdx.x;
  const int rounds = (K + kLanes - 1) / kLanes;
  // PA2's 1 / (2c), rounded as the plain version rounds it
  const float inv2c = __fdiv_rn(1.0f, __fmul_rn(2.0f, c));

  for (int base = 0; base < B; base += tile) {
    const int n = min(tile, B - base);
    __syncwarp();  // the previous tile's reads are done
    const int* gi = idx + (size_t)base * K;
    const float* gv = val + (size_t)base * K;
    for (int j = lane; j < n * K; j += kLanes) {
      s_idx[j] = gi[j];
      s_val[j] = gv[j];
    }
    for (int j = lane; j < n; j += kLanes) s_y[j] = y[base + j];
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
          p = __fmul_rn(__fadd_rn(w[i], dw[i]), v);
          x = __fmul_rn(v, v);
        }
        pacc = r == 0 ? p : __fadd_rn(pacc, p);
        xacc = r == 0 ? x : __fadd_rn(xacc, x);
      }
      const float pred = warp_tree(pacc);
      const float x2 = warp_tree(xacc);
      const float err = __fsub_rn(s_y[e], pred);
      const float loss = __fsub_rn(fabsf(err), sensitivity);
      const float x2s = x2 < 1e-12f ? 1e-12f : x2;
      float alpha;
      if (METHOD == kPA) {
        alpha = __fdiv_rn(loss, x2s);
      } else if (METHOD == kPA1) {
        const float a = __fdiv_rn(loss, x2s);
        alpha = c < a ? c : a;
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
          float acc = dw[i];
          for (unsigned m = group; m; m &= m - 1)
            acc = __fadd_rn(acc, s_upd[__ffs(m) - 1]);
          dw[i] = acc;
        }
        __syncwarp();  // this round's writes before the next reads
      }
    }
  }
}

template <int METHOD>
cudaError_t launch(const float* w, float* dw, const int* idx, const float* val,
                   const float* y, int B, int K, int tile, float sensitivity,
                   float c, cudaStream_t stream) {
  const size_t smem = (size_t)tile * K * 8 + (size_t)tile * 4 + kLanes * 4;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        pa_scan_kernel<METHOD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  pa_scan_kernel<METHOD><<<1, kLanes, smem, stream>>>(
      w, dw, idx, val, y, B, K, tile, sensitivity, c);
  return cudaGetLastError();
}

// Measurement probe (not on any path): one thread follows `hops` dependent
// loads through `chain` (mode 0), or one warp runs `hops` dependent
// shuffle-adds (mode 1). Timed over many hops, it gives the latency of one
// step of the scan's dependence chain on this card.
__global__ void latency_probe_kernel(const int* __restrict__ chain, int hops,
                                     int mode, int* out) {
  if (mode == 0) {
    if (threadIdx.x != 0) return;
    int p = 0;
    for (int h = 0; h < hops; ++h) p = chain[p];
    out[0] = p;
  } else {
    float v = (float)threadIdx.x;
    for (int h = 0; h < hops; ++h)
      v = __fadd_rn(v, __shfl_down_sync(kFull, v, 1));
    if (threadIdx.x == 0) out[0] = __float_as_int(v);
  }
}

}  // namespace

extern "C" {

// method: 0 PA, 1 PA1, 2 PA2. idx, val: [B, K] row-major; y: [B]; w, dw: [D]
// with every index in [0, D). dw is updated in place. `tile` examples are
// staged in shared memory at a time (tile * K * 8 + tile * 4 + 128 bytes).
int jt_pa_scan(const float* w, float* dw, const int* idx, const float* val,
               const float* y, int B, int K, int tile, int method,
               float sensitivity, float c, void* stream) {
  if (B < 0 || K < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case kPA:
      return (int)launch<kPA>(w, dw, idx, val, y, B, K, tile, sensitivity, c, s);
    case kPA1:
      return (int)launch<kPA1>(w, dw, idx, val, y, B, K, tile, sensitivity, c, s);
    case kPA2:
      return (int)launch<kPA2>(w, dw, idx, val, y, B, K, tile, sensitivity, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int jt_latency_probe(const int* chain, int hops, int mode, int* out,
                     void* stream) {
  latency_probe_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      chain, hops, mode, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
