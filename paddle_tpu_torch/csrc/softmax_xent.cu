// Fused softmax cross-entropy over hard labels for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/softmax_xent.py:
//   K2a  _fwd_kernel (launched by _call_fwd, entry fused_softmax_xent)
//   K2b  _bwd_kernel (launched by _fused_bwd)
// For each row of [N, V] logits x with label y, smoothing eps and
// lse = log(sum_j exp(x_j)):
//   K2a  loss = lse - (1 - eps) * x[y] - (eps / V) * sum_j x_j,   lse
//   K2b  dlogits = g * (exp(x - lse) - (1 - eps) * onehot(y) - eps / V)
// Rows whose label equals ignore_index get loss 0 and dlogits 0; other
// labels outside [0, V) are clamped to the vocabulary. All arithmetic is
// float32; bf16 logits are upcast as they are loaded, and dlogits is
// written in the logits' type.
//
// Bound: memory. K2a must read the N*V logits once, K2b read them once and
// write dlogits once: at N=16384, V=30000 in float32 that is 1.97 GB and
// 3.93 GB, 0.587 ms and 1.174 ms at 3.35 TB/s (H100 SXM). Each element
// costs one exp and a few flops, about 3 flops per 4-byte load, far below
// the ~20 flop/byte at which the card's float32 rate would bind.
//
// Design. The Pallas grid walks V tiles in order and keeps the running
// max / sum / label logit in VMEM scratch across them; a GPU has no
// ordered grid. Here one thread block owns one row: its 256 threads stride
// over V (neighbouring threads on neighbouring addresses, so every warp
// load is coalesced), each keeping its own online (max, sum-of-exp) and,
// for smoothing, its running sum of x, with 4 loads issued before any is
// used. The partial states merge with warp shuffles, then across the 8
// warps through shared memory; thread 0 reads the label logit and writes
// loss and lse. K2b is an elementwise pass with the row's lse, g and
// label in registers. Both take any V: the ragged tail is masked by index,
// nothing is padded (the Pallas version pads V to its 2048-wide tile with
// -1e30). Vectorised loads, several rows per block for small V, and
// TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// (m, s) <- the online-softmax state of both (m, s) and (m2, s2). The
// states start at (-FLT_MAX, 0), so an empty one merges to a zero weight.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ int clamp_label(long long y, int v) {
  return static_cast<int>(y < 0 ? 0 : (y >= v ? v - 1 : y));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ logits,
                    const long long* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse, int v,
                    float smooth, long long ignore_index) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<size_t>(row) * v;
  float m = -FLT_MAX, s = 0.f, z = 0.f;
  for (int base = threadIdx.x; base < v; base += kThreads * kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      xs[u] = i < v ? to_float(x[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads >= v) break;
      const float xi = xs[u];
      if (xi > m) {
        s = s * expf(m - xi) + 1.f;
        m = xi;
      } else {
        s += expf(xi - m);
      }
      z += xi;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
    z += __shfl_xor_sync(0xffffffffu, z, o);
  }
  __shared__ float sm_m[kWarps], sm_s[kWarps], sm_z[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
    sm_z[warp] = z;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm_m[0];
    s = sm_s[0];
    z = sm_z[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      merge(m, s, sm_m[w], sm_s[w]);
      z += sm_z[w];
    }
    const long long y = labels[row];
    const float l = m + logf(s);
    const float xl = to_float(x[clamp_label(y, v)]);
    lse[row] = l;
    loss[row] = y == ignore_index
                    ? 0.f
                    : l - ((1.f - smooth) * xl + (smooth / v) * z);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ logits,
                    const long long* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, T* __restrict__ dlogits,
                    int v, float smooth, long long ignore_index) {
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * v;
  const T* x = logits + off;
  T* dx = dlogits + off;
  const long long y = labels[row];
  const int yi = clamp_label(y, v);
  const float gr = y == ignore_index ? 0.f : g[row];
  const float l = lse[row];
  const float on = 1.f - smooth, uniform = smooth / v;
  for (int base = threadIdx.x; base < v; base += kThreads * kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      xs[u] = i < v ? to_float(x[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i >= v) break;
      const float p = expf(xs[u] - l);
      store(dx + i, gr * ((i == yi ? p - on : p) - uniform));
    }
  }
}

bool bad_args(int n, int v, int dtype) {
  return n < 1 || v < 1 || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits; labels int64; loss, lse float32
// [N]. Returns the cudaError_t of the launch; the caller raises on non-zero.
extern "C" int softmax_xent_fwd(const void* logits, const void* labels,
                                void* loss, void* lse, int n, int v,
                                float smooth, long long ignore_index,
                                int dtype, void* stream) {
  if (bad_args(n, v, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lab = static_cast<const long long*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    xent_fwd_kernel<float><<<n, kThreads, 0, st>>>(
        static_cast<const float*>(logits), lab, lo, ls, v, smooth,
        ignore_index);
  else
    xent_fwd_kernel<__nv_bfloat16><<<n, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, lo, ls, v, smooth,
        ignore_index);
  return static_cast<int>(cudaGetLastError());
}

// dlogits has the logits' dtype; lse and g are float32 [N].
extern "C" int softmax_xent_bwd(const void* logits, const void* labels,
                                const void* lse, const void* g, void* dlogits,
                                int n, int v, float smooth,
                                long long ignore_index, int dtype,
                                void* stream) {
  if (bad_args(n, v, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lab = static_cast<const long long*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (dtype == 0)
    xent_bwd_kernel<float><<<n, kThreads, 0, st>>>(
        static_cast<const float*>(logits), lab, ls, gg,
        static_cast<float*>(dlogits), v, smooth, ignore_index);
  else
    xent_bwd_kernel<__nv_bfloat16><<<n, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, ls, gg,
        static_cast<__nv_bfloat16*>(dlogits), v, smooth, ignore_index);
  return static_cast<int>(cudaGetLastError());
}
