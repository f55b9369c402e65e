// Row-wise sparse optimizer updates (lazy Adam, SGD) for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/sparse_adam.py:
//   K4a  _adam_kernel (launched by sparse_adam_rows)
//   K4b  _sgd_kernel  (launched by sparse_sgd_rows)
// Both take merged sparse gradients: ids [N] int64, unique except for the
// padding tail of core/sparse.merge_rows, whose ids equal V; rows [N, D]
// float32. For each (i, j) with 0 <= ids[i] < V and k = ids[i] * D + j:
//   K4a  m[k] = b1 * m[k] + (1 - b1) * g;  v[k] = b2 * v[k] + (1 - b2) * g^2
//        p[k] = p[k] - lr_t * m[k] / (sqrt(v[k]) + eps)      (g = rows[i, j])
//   K4b  p[k] = p[k] - lr * g
// The [V, D] float32 tables are updated in place: rows no id names are
// neither read nor written, and a padding id touches nothing. lr_t (the
// bias-corrected Adam step size) and lr are read from device memory, so the
// host never waits for them.
//
// Bound: memory. K4a reads p, m, v and the gradient row and writes p, m,
// v: 7 * 4 bytes per element of a touched row and about 11 flops, far below
// the ~20 flop/byte at which the card's float32 rate would bind. At the
// DeepFM step (N = 26,624 ids, about 26,270 distinct, from V = 1e6) that is
// 7.4 MB for the [V, 10] table and 0.95 MB for the [V, 1] table: 2.3 and
// 0.28 us at 3.35 TB/s (H100 SXM), less than a kernel launch. The rows lie
// at random in the table, so the card moves whole 32-byte sectors: a
// 40-byte row spans 2-3 of them and a 4-byte row one, 8 times the 4 bytes
// it needs. On the H100 the random row reads, not the bytes, set the time.
//
// Design. The Pallas kernel batches 128 row DMAs per grid step between HBM
// and VMEM scratch, because a TPU core has no gather-capable loads. Here
// each merged row is a chain that no design removes: id -> row loads ->
// IEEE div and sqrt -> stores, each DRAM trip cold. A design controls what
// comes before the first load, how many loads are in flight and how the
// loads of a warp spread over rows, so:
//  * a thread (or a group of lanes) owns a whole merged row, found by its
//    index with no division: it reads lr_t and its id once, through the
//    read-only path;
//  * it issues every load of its row (the gradient at i * D; p, m and v at
//    id * D) before any arithmetic, in the widest vector the alignment
//    allows: float4 where D % 4 == 0 and every pointer lies on 16 bytes,
//    float2 where D is even and they lie on 8, else scalar. The wrapper
//    picks the width from D and the pointers;
//  * offsets within a row are 32-bit; id * D stays 64-bit (at V = 5e7 and
//    D = 64 it passes 2^31).
// Two kernels:
//  * sparse_group_kernel, for every D but 1: a group of lanes a merged
//    row, as many as the row has chunks of VEC floats, rounded up to a
//    power of two (so a group never straddles a warp), at most 32; lane 0
//    loads the id and shuffles it to the others, and lane l takes the
//    chunks l, l + lanes, ... of the row. At D = 10: 8 lanes of float2, 5
//    of them busy, so a warp's loads touch 4 rows;
//  * sparse_row_kernel, for D = 1: one thread a row, D a template
//    parameter. The group kernel with one lane does the same work but
//    takes 0.15-0.3 us more (its shuffle and chunk loop: 20 registers
//    against 12 for K4b).
// What sets the time is how many rows a warp's loads touch: one thread a
// row at D = 10 (32 rows a warp) took twice the time of 8 lanes a row. At
// D = 10 the group kernel launches 832 blocks of 256 threads: one wave
// only if 8 blocks fit an SM, so only at 32 registers a thread or fewer.
// With its table loads written in C++, nvcc gave it 36 registers (6 blocks
// an SM, 40 blocks in a second wave, +0.6 us); with them as inline PTX,
// 32. A register bound (__launch_bounds__) spilled instead and was no
// faster. flash_variants.py --sparse times the alternatives (other lanes,
// one thread a row at D = 10, the group kernel at D = 1, several rows a
// thread at D = 1, C++ loads, L2 fetch-size hints, threads a block)
// against this source on the card, and PERF.md keeps the numbers.
//
// The ids are unique, so no two threads write one element: no atomics, and
// the same result on every run. The products and sums round one at a time
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), as the plain PyTorch
// version rounds them, so nvcc contracts nothing into an FMA: K4b is
// bit-equal to its plain version. The launch shape depends only on N and D,
// never on the number of distinct ids, so nothing waits on the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block

// The table row a merged id names, or -1 for a padding id (== V; an id
// below 0 too): a padding id touches nothing.
__device__ __forceinline__ long long named_row(long long id,
                                               long long vocab) {
  return id >= 0 && id < vocab ? id : -1;
}

// VEC floats of a table from src (on 4 * VEC bytes) into dst[0, VEC), as
// inline PTX (see the Design note above). volatile keeps each load where
// the source puts it: after the checks that a padding id and a thread past
// n return on.
template <int VEC>
__device__ __forceinline__ void load(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(dst[0]), "=f"(dst[1]), "=f"(dst[2]), "=f"(dst[3])
        : "l"(src));
  } else if constexpr (VEC == 2) {
    asm volatile("ld.global.v2.f32 {%0, %1}, [%2];"
        : "=f"(dst[0]), "=f"(dst[1])
        : "l"(src));
  } else {
    asm volatile("ld.global.f32 %0, [%1];" : "=f"(dst[0]) : "l"(src));
  }
}

// VEC floats of the gradient rows, through the read-only path.
template <int VEC>
__device__ __forceinline__ void load_ro(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(src));
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    dst[0] = __ldg(src);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    *dst = src[0];
  }
}

// K4a's tables and constants; load/update/store act on VEC floats at k.
struct SparseAdam {
  float* p;
  float* m;
  float* v;
  float b1, omb1, b2, omb2, eps;

  template <int VEC>
  __device__ __forceinline__ void load_at(long long k, float* p_, float* m_,
                                          float* v_) const {
    load<VEC>(p_, p + k);
    load<VEC>(m_, m + k);
    load<VEC>(v_, v + k);
  }
  __device__ __forceinline__ void update(float g, float& p_, float& m_,
                                         float& v_, float lr) const {
    const float m_new = __fadd_rn(__fmul_rn(b1, m_), __fmul_rn(omb1, g));
    const float v_new =
        __fadd_rn(__fmul_rn(b2, v_), __fmul_rn(omb2, __fmul_rn(g, g)));
    p_ = __fsub_rn(p_, __fdiv_rn(__fmul_rn(lr, m_new),
                                 __fadd_rn(__fsqrt_rn(v_new), eps)));
    m_ = m_new;
    v_ = v_new;
  }
  template <int VEC>
  __device__ __forceinline__ void store_at(long long k, const float* p_,
                                           const float* m_,
                                           const float* v_) const {
    store<VEC>(p + k, p_);
    store<VEC>(m + k, m_);
    store<VEC>(v + k, v_);
  }
};

// K4b's table; m and v are unused.
struct SparseSgd {
  float* p;

  template <int VEC>
  __device__ __forceinline__ void load_at(long long k, float* p_, float*,
                                          float*) const {
    load<VEC>(p_, p + k);
  }
  __device__ __forceinline__ void update(float g, float& p_, float&, float&,
                                         float lr) const {
    p_ = __fsub_rn(p_, __fmul_rn(lr, g));
  }
  template <int VEC>
  __device__ __forceinline__ void store_at(long long k, const float* p_,
                                           const float*, const float*) const {
    store<VEC>(p + k, p_);
  }
};

// E floats of one row, table offset k, gradient at g_src: every load, then
// the arithmetic, then every store.
template <class Op, int E, int VEC>
__device__ __forceinline__ void update_span(const Op& op, long long k,
                                            const float* g_src, float lr) {
  float g[E], p[E], m[E], v[E];
#pragma unroll
  for (int j = 0; j < E; j += VEC) {
    load_ro<VEC>(g + j, g_src + j);
    op.template load_at<VEC>(k + j, p + j, m + j, v + j);
  }
#pragma unroll
  for (int j = 0; j < E; ++j) op.update(g[j], p[j], m[j], v[j], lr);
#pragma unroll
  for (int j = 0; j < E; j += VEC) {
    op.template store_at<VEC>(k + j, p + j, m + j, v + j);
  }
}

// One thread a merged row of D floats.
template <class Op, int D, int VEC>
__global__ void __launch_bounds__(kThreads)
    sparse_row_kernel(Op op, const long long* __restrict__ ids,
                      const float* __restrict__ rows,
                      const float* __restrict__ lr_t, long long n,
                      long long vocab) {
  const float lr = __ldg(lr_t);
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = named_row(__ldg(ids + i), vocab);
  if (row < 0) return;
  update_span<Op, D, VEC>(op, row * D, rows + i * D, lr);
}

// 1 << lanes_log2 lanes a merged row of d floats, d % VEC == 0.
template <class Op, int VEC>
__global__ void __launch_bounds__(kThreads)
    sparse_group_kernel(Op op, const long long* __restrict__ ids,
                        const float* __restrict__ rows,
                        const float* __restrict__ lr_t, long long n, int d,
                        long long vocab, int lanes_log2) {
  const float lr = __ldg(lr_t);
  const int lanes = 1 << lanes_log2;
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >>
      lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  long long id = -1;
  if (lane == 0 && i < n) id = __ldg(ids + i);
  id = __shfl_sync(0xffffffffu, id, 0, lanes);  // every lane of the warp
  if (i >= n) return;
  const long long row = named_row(id, vocab);
  if (row < 0) return;
  const float* g = rows + i * d;
  const long long k = row * d;
  for (int c = lane * VEC; c < d; c += lanes * VEC) {
    update_span<Op, VEC, VEC>(op, k + c, g + c, lr);
  }
}

unsigned int blocks_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

// The kernel's arguments past the op.
struct Rows {
  const long long* ids;
  const float* rows;
  const float* lr;
  long long n;
  int d;
  long long vocab;
};

// One launch of K4a or K4b over n merged rows of d floats: vec is the
// wrapper's vector width (4, 2 or 1; d % vec == 0). D = 1 takes the row
// kernel; any other D the group kernel, a row as many lanes as it has
// chunks of vec floats, rounded up to a power of two, at most 32.
template <class Op>
int launch_rows(const Op& op, const Rows& a, int vec, cudaStream_t s) {
  if (a.d < 1 || (vec != 1 && vec != 2 && vec != 4) || a.d % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  if (a.d == 1) {
    sparse_row_kernel<Op, 1, 1><<<blocks_for(a.n), kThreads, 0, s>>>(
        op, a.ids, a.rows, a.lr, a.n, a.vocab);
    return static_cast<int>(cudaGetLastError());
  }
  const int lanes = a.d / vec;
  int l2 = 0;
  while ((1 << l2) < lanes && l2 < 5) ++l2;
  const unsigned int b = blocks_for(a.n << l2);
  if (vec == 4) {
    sparse_group_kernel<Op, 4><<<b, kThreads, 0, s>>>(
        op, a.ids, a.rows, a.lr, a.n, a.d, a.vocab, l2);
  } else if (vec == 2) {
    sparse_group_kernel<Op, 2><<<b, kThreads, 0, s>>>(
        op, a.ids, a.rows, a.lr, a.n, a.d, a.vocab, l2);
  } else {
    sparse_group_kernel<Op, 1><<<b, kThreads, 0, s>>>(
        op, a.ids, a.rows, a.lr, a.n, a.d, a.vocab, l2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, m, v: [vocab, d] float32, updated in place; ids: [n] int64; rows:
// [n, d] float32; lr_t: one float32 on the device; vec: see launch_rows.
// Returns cudaError_t.
extern "C" int sparse_adam_rows(void* p, void* m, void* v, const void* ids,
                                const void* rows, const void* lr_t,
                                long long n, int d, long long vocab,
                                float beta1, float one_minus_beta1,
                                float beta2, float one_minus_beta2,
                                float epsilon, int vec, void* stream) {
  const SparseAdam op{static_cast<float*>(p), static_cast<float*>(m),
                      static_cast<float*>(v), beta1, one_minus_beta1, beta2,
                      one_minus_beta2, epsilon};
  const Rows a{static_cast<const long long*>(ids),
               static_cast<const float*>(rows),
               static_cast<const float*>(lr_t), n, d, vocab};
  return launch_rows(op, a, vec, static_cast<cudaStream_t>(stream));
}

// p: [vocab, d] float32, updated in place; ids, rows, vec as above;
// lr: one float32 on the device. Returns cudaError_t.
extern "C" int sparse_sgd_rows(void* p, const void* ids, const void* rows,
                               const void* lr, long long n, int d,
                               long long vocab, int vec, void* stream) {
  const SparseSgd op{static_cast<float*>(p)};
  const Rows a{static_cast<const long long*>(ids),
               static_cast<const float*>(rows), static_cast<const float*>(lr),
               n, d, vocab};
  return launch_rows(op, a, vec, static_cast<cudaStream_t>(stream));
}
