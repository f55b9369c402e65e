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
// Bound: memory. K4a reads p, m, v and the gradient row and writes p, m, v:
// 7 * 4 bytes per element of a touched row and about 8 flops, far below
// the ~20 flop/byte at which the card's float32 rate would bind. At the
// DeepFM step (N = 26,624 ids, about 26,270 distinct, from V = 1e6) that is
// 7.36 MB for the [V, 10] table and 0.74 MB for the [V, 1] table: 2.2 and
// 0.22 us at 3.35 TB/s (H100 SXM), less than a kernel launch. The rows lie
// at random in the table, so the card moves whole 32-byte sectors: a 40-byte
// row spans 2-3 of them and a 4-byte row one, 8 times the 4 bytes it needs.
//
// Design. The Pallas kernel batches 128 row DMAs per grid step between HBM
// and VMEM scratch, because a TPU core has no gather-capable loads. Here one
// thread owns one element of the flat N x D gradient: row i = t / D, column
// j = t % D. It reads ids[i]; a padding id returns at once; otherwise it
// loads g, p, m and v, updates them in float32 and stores them back.
// Neighbouring threads touch the D contiguous floats of one row, and for
// D = 1 each thread touches one random row. The ids are unique, so no two
// threads write one element: no atomics, and the same result on every run.
// The products and sums round one at a time (__fmul_rn, __fadd_rn), as the
// plain PyTorch version rounds them, so nvcc contracts nothing into an FMA.
// The launch shape depends only on N * D, never on the number of distinct
// ids, so nothing waits on the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    sparse_adam_rows_kernel(float* __restrict__ p, float* __restrict__ m,
                            float* __restrict__ v,
                            const long long* __restrict__ ids,
                            const float* __restrict__ rows,
                            const float* __restrict__ lr_t, long long n_elems,
                            int d, long long vocab, float beta1,
                            float one_minus_beta1, float beta2,
                            float one_minus_beta2, float epsilon) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_elems) return;
  const long long id = ids[t / d];
  if (id < 0 || id >= vocab) return;  // merge padding: touch nothing
  const long long k = id * d + t % d;
  const float g = rows[t];
  const float m_new =
      __fadd_rn(__fmul_rn(beta1, m[k]), __fmul_rn(one_minus_beta1, g));
  const float v_new = __fadd_rn(__fmul_rn(beta2, v[k]),
                                __fmul_rn(one_minus_beta2, __fmul_rn(g, g)));
  const float step =
      __fdiv_rn(__fmul_rn(*lr_t, m_new), __fadd_rn(__fsqrt_rn(v_new), epsilon));
  p[k] = __fsub_rn(p[k], step);
  m[k] = m_new;
  v[k] = v_new;
}

__global__ void __launch_bounds__(kThreads)
    sparse_sgd_rows_kernel(float* __restrict__ p,
                           const long long* __restrict__ ids,
                           const float* __restrict__ rows,
                           const float* __restrict__ lr, long long n_elems,
                           int d, long long vocab) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_elems) return;
  const long long id = ids[t / d];
  if (id < 0 || id >= vocab) return;  // merge padding: touch nothing
  const long long k = id * d + t % d;
  p[k] = __fsub_rn(p[k], __fmul_rn(*lr, rows[t]));
}

unsigned int blocks_for(long long n_elems) {
  return static_cast<unsigned int>((n_elems + kThreads - 1) / kThreads);
}

}  // namespace

// p, m, v: [vocab, d] float32, updated in place; ids: [n] int64; rows:
// [n, d] float32; lr_t: one float32 on the device. Returns cudaError_t.
extern "C" int sparse_adam_rows(void* p, void* m, void* v, const void* ids,
                                const void* rows, const void* lr_t,
                                long long n, int d, long long vocab,
                                float beta1, float one_minus_beta1,
                                float beta2, float one_minus_beta2,
                                float epsilon, void* stream) {
  const long long n_elems = n * d;
  if (n_elems > 0) {
    sparse_adam_rows_kernel<<<blocks_for(n_elems), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<const long long*>(ids),
        static_cast<const float*>(rows), static_cast<const float*>(lr_t),
        n_elems, d, vocab, beta1, one_minus_beta1, beta2, one_minus_beta2,
        epsilon);
  }
  return static_cast<int>(cudaGetLastError());
}

// p: [vocab, d] float32, updated in place; ids, rows as above; lr: one
// float32 on the device. Returns cudaError_t.
extern "C" int sparse_sgd_rows(void* p, const void* ids, const void* rows,
                               const void* lr, long long n, int d,
                               long long vocab, void* stream) {
  const long long n_elems = n * d;
  if (n_elems > 0) {
    sparse_sgd_rows_kernel<<<blocks_for(n_elems), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<const long long*>(ids),
        static_cast<const float*>(rows), static_cast<const float*>(lr),
        n_elems, d, vocab);
  }
  return static_cast<int>(cudaGetLastError());
}
