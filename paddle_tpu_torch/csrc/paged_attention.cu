// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   paddle_tpu/ops/pallas_kernels/paged_attention.py:_paged_attn_kernel
// (entry paged_decode_attention). Per slot b and head h it computes
//   out[b,h,:] = softmax(q[b,h,:] . K[ctx rows of b, h, :] * sm_scale) @ V[...]
// straight from the flat page pool [num_pages*page_size, H, D]: logical
// position r of slot b lives in pool row
//   clamp(page_table[b, r / page_size], 0, num_pages-1) * page_size + r % page_size.
// Rows at or beyond ctx_len[b] are never loaded. That is the exact limit of
// the TPU kernel's masking (scores set to neg_inf_value(float32), V zeroed):
// garbage in stale or unreserved pages cannot move an output bit. The
// softmax is the online (m, l, acc) form in float32, m starting at the mask
// value, and the result is acc / max(l, 1e-30); a slot with no live row
// gives 0.
//
// Bound: memory. One layer-step must read the live K and V rows once,
// sum_b ctx_len[b] * H * D * 2 * itemsize bytes, at 3.35 TB/s (H100 SXM).
// It does 4 * D flops per live row and head (q.k and p.v) against
// 2 * D * itemsize bytes: 0.5 flop/byte in float32, 1 in bf16, far below
// the ~20 flop/byte at which the card's float32 rate (67 TFLOP/s) would
// become the limit.
//
// Design for that bound: split each slot's context, and keep many loads in
// flight. A slot's live rows are cut into chunks of chunk_rows rows, and a
// block of 4 warps owns one (chunk, head, slot); blocks of chunks that lie
// wholly beyond ctx_len exit at once, so the grid that the page table's
// width sizes does the work of the live rows, and one long context spreads
// over many SMs instead of walking alone. A row of one head is d_head
// contiguous elements (256 bytes at D = 64 in float32): LPR lanes read it by
// 16-byte vectors (one element at a time where the head width or the pool's
// base misses 16 bytes), so a warp reads 32 / LPR rows with one load, and
// it issues the loads of G such row groups of K and V before it uses any.
// q . k is reduced over the LPR lanes by shuffles; each lane folds its rows
// into its own (m, l, acc), which merge across the warp by shuffles and
// across the 4 warps through shared memory, always in the same order.
//
// The chunks of a (slot, head) merge inside the same launch. Each block
// writes its chunk's (m, l, acc) to a float32 workspace and counts its
// arrival on the (slot, head)'s counter; the block that arrives last merges
// the partials in chunk order, not in arrival order, writes the output and
// sets the counter back to 0 for the next launch. The fixed order keeps the
// output bit-identical from run to run. A slot of one chunk writes its
// output directly. One launch a call keeps the host's launches per decode
// step as they were: the serving step is bound by the host.
//
// Measured at the serving shape (chip_smoke.py, kernel_phase: B = 16, H =
// 12, D = 64, float32, ctx_len 1..1024) on an NVIDIA H100 80GB HBM3 at
// 700 W: 0.0276 ms at 64 rows a chunk, 42 % of the 0.0116 ms byte bound,
// against 0.0607 ms for one block a (slot, head) of 8 warps; 0.0337 /
// 0.0276 / 0.0266 ms at 32 / 128 / 256 rows a chunk. With one slot at 1024
// rows and fifteen at 1, 64 rows a chunk take 0.0125 ms against 0.0136 /
// 0.0142 / 0.0195: 64 keeps a lone long context spread over 16 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// VEC elements of T read by one load: a 16-byte vector, or one element.
template <typename T, int VEC>
struct Loader;
template <typename T>
struct Loader<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float (&x)[1]) {
    x[0] = to_float(r);
  }
};
template <>
struct Loader<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&x)[4]) {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
};
template <>
struct Loader<bf16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  // a bfloat16 is the high half of the float32 it widens to, exactly
  static __device__ __forceinline__ void unpack(Raw r, float (&x)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

struct PagedParams {
  const void* q;           // [B, H, D]
  const void* k_pool;      // [num_pages * page_size, H, D]
  const void* v_pool;
  const int* page_table;   // [B, pages_per_slot]
  const int* ctx_len;      // [B]
  void* out;               // [B, H, D]
  float* ws;               // [B, H, max_chunks, 2 + D]: m, l, acc a chunk
  unsigned* counters;      // [B * H], 0 between launches
  int d_head, pages_per_slot, num_pages, page_size, chunk_rows;
  float sm_scale, mask_value;
};

// The block of (chunk blockIdx.x, head blockIdx.y, slot blockIdx.z). A lane
// holds NV vectors of VEC elements of q, of a row's K and V and of its
// accumulator: the elements (sub + LPR nv) VEC + e of the head, sub = lane %
// LPR.
template <typename T, int VEC, int LPR, int NV>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(PagedParams p) {
  using L = Loader<T, VEC>;
  constexpr int RPW = 32 / LPR;  // rows a warp reads with one load
  constexpr int E = NV * VEC;    // elements of a row a lane holds
  // row groups of K and V a warp has in flight: 64 floats of each a lane
  constexpr int G = 32 / E < 1 ? 1 : (32 / E > 8 ? 8 : 32 / E);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_head = gridDim.y;
  const int ctx = min(max(p.ctx_len[b], 0), p.pages_per_slot * p.page_size);
  const int n_chunks = max(1, (ctx + p.chunk_rows - 1) / p.chunk_rows);
  if (c >= n_chunks) return;  // wholly beyond ctx_len
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPR, lrow = lane / LPR;
  const T* q = static_cast<const T*>(p.q);
  const T* k_pool = static_cast<const T*>(p.k_pool);
  const T* v_pool = static_cast<const T*>(p.v_pool);
  const int* pt = p.page_table + static_cast<size_t>(b) * p.pages_per_slot;
  const size_t row_stride = static_cast<size_t>(n_head) * p.d_head;
  const size_t head_off = static_cast<size_t>(h) * p.d_head;
  const size_t qo_off = (static_cast<size_t>(b) * n_head + h) * p.d_head;
  const int r_end = min((c + 1) * p.chunk_rows, ctx);

  float qr[E], acc[E];
  bool lane_d[NV];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
    const int d0 = (sub + LPR * nv) * VEC;
    lane_d[nv] = d0 < p.d_head;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[nv * VEC + e] = lane_d[nv] ? to_float(q[qo_off + d0 + e]) : 0.f;
      acc[nv * VEC + e] = 0.f;
    }
  }
  float m = p.mask_value, l = 0.f;

  for (int r0 = c * p.chunk_rows + warp * G * RPW; r0 < r_end;
       r0 += kWarps * G * RPW) {
    typename L::Raw kr[G][NV], vr[G][NV];
    bool live[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = r0 + g * RPW + lrow;
      live[g] = r < r_end;
      size_t base = 0;
      if (live[g]) {
        const int page =
            min(max(pt[r / p.page_size], 0), p.num_pages - 1);
        base = (static_cast<size_t>(page) * p.page_size + r % p.page_size) *
                   row_stride + head_off;
      }
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const size_t idx = base + (sub + LPR * nv) * VEC;
        const bool ld = live[g] && lane_d[nv];  // else zeros
        kr[g][nv] = ld ? L::load(k_pool + idx) : typename L::Raw{};
        vr[g][nv] = ld ? L::load(v_pool + idx) : typename L::Raw{};
      }
    }
    float s[G];
    float m_new = m;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        float kx[VEC];
        L::unpack(kr[g][nv], kx);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part = fmaf(qr[nv * VEC + e], kx[e], part);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      s[g] = part * p.sm_scale;
      if (live[g]) m_new = fmaxf(m_new, s[g]);
    }
    // a row at or beyond ctx_len adds exactly nothing
    const float alpha = expf(m - m_new);
    float pr[G], psum = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      pr[g] = live[g] ? expf(s[g] - m_new) : 0.f;
      psum += pr[g];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        float vx[VEC];
        L::unpack(vr[g][nv], vx);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[nv * VEC + e] = fmaf(pr[g], vx[e], acc[nv * VEC + e]);
      }
    m = m_new;
  }

  // the warp's rows: lanes lrow and lrow ^ o hold the same elements of
  // other rows; a state that saw no row is (mask_value, 0, 0)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
    const float m_n = fmaxf(m, m_o);
    const float a = expf(m - m_n), a_o = expf(m_o - m_n);
    l = l * a + l_o * a_o;
#pragma unroll
    for (int i = 0; i < E; ++i)
      acc[i] = acc[i] * a + __shfl_xor_sync(0xffffffffu, acc[i], o) * a_o;
    m = m_n;
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxD];
  __shared__ bool last;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lrow == 0) {
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
      if (lane_d[nv])
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][(sub + LPR * nv) * VEC + e] = acc[nv * VEC + e];
  }
  __syncthreads();
  // the chunk's state: the 4 warps merged in order
  float mc = p.mask_value;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, sm_m[w]);
  float wscale[kWarps], lc = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wscale[w] = expf(sm_m[w] - mc);
    lc += sm_l[w] * wscale[w];
  }
  T* out = static_cast<T*>(p.out) + qo_off;
  if (n_chunks == 1) {
    const float denom = fmaxf(lc, 1e-30f);
    for (int d = threadIdx.x; d < p.d_head; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w][d], wscale[w], a);
      store(out + d, a / denom);
    }
    return;
  }

  const int pitch = 2 + p.d_head;
  float* parts = p.ws + (static_cast<size_t>(b) * n_head + h) *
                            gridDim.x * pitch;
  float* mine = parts + static_cast<size_t>(c) * pitch;
  if (threadIdx.x == 0) {
    mine[0] = mc;
    mine[1] = lc;
  }
  for (int d = threadIdx.x; d < p.d_head; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w][d], wscale[w], a);
    mine[2 + d] = a;
  }
  __threadfence();  // the partial is visible before the arrival counts
  __syncthreads();
  unsigned* counter = p.counters + static_cast<size_t>(b) * n_head + h;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == n_chunks - 1u;
  __syncthreads();
  if (!last) return;

  // the last block to arrive: every chunk's partial, merged in chunk order
  // by each thread for its elements; the loads of 8 chunks at a time are
  // in flight together
  __threadfence();
  for (int d = threadIdx.x; d < p.d_head; d += kThreads) {
    float m_all = p.mask_value, l_all = 0.f, a = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < n_chunks; ++cc) {
      const float* pc = parts + static_cast<size_t>(cc) * pitch;
      const float m_c = __ldcg(pc), l_c = __ldcg(pc + 1);
      const float a_c = __ldcg(pc + 2 + d);
      const float m_n = fmaxf(m_all, m_c);
      const float w = expf(m_all - m_n), w_c = expf(m_c - m_n);
      l_all = l_all * w + l_c * w_c;
      a = a * w + a_c * w_c;
      m_all = m_n;
    }
    store(out + d, a / fmaxf(l_all, 1e-30f));
  }
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
}

template <typename T, int VEC, int LPR, int NV>
int launch(const PagedParams& p, int batch, int n_head, int max_chunks,
           cudaStream_t st) {
  const dim3 grid(max_chunks, n_head, batch);
  paged_attn_kernel<T, VEC, LPR, NV><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a row and vectors a lane by the head width: rows of up to 8
// vectors take 8 lanes (32 / 8 = 4 rows a load), up to 16 take 16, more
// take the whole warp.
template <typename T, int VEC>
int launch_lanes(const PagedParams& p, int batch, int n_head,
                 int max_chunks, cudaStream_t st) {
  const int nvec = (p.d_head + VEC - 1) / VEC;
  if (nvec <= 8)
    return launch<T, VEC, 8, 1>(p, batch, n_head, max_chunks, st);
  if (nvec <= 16)
    return launch<T, VEC, 16, 1>(p, batch, n_head, max_chunks, st);
  if (nvec <= 32)
    return launch<T, VEC, 32, 1>(p, batch, n_head, max_chunks, st);
  if constexpr (64 * VEC <= kMaxD) {
    if (nvec <= 64)
      return launch<T, VEC, 32, 2>(p, batch, n_head, max_chunks, st);
  }
  if constexpr (128 * VEC <= kMaxD) {
    if (nvec <= 128)
      return launch<T, VEC, 32, 4>(p, batch, n_head, max_chunks, st);
    return launch<T, VEC, 32, 8>(p, batch, n_head, max_chunks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 16-byte vectors where the head width is whole vectors and both pools
// start on 16 bytes (then every row and head does), else one element a load.
template <typename T>
int launch_typed(const PagedParams& p, int batch, int n_head, int max_chunks,
                 cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = p.d_head % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(p.k_pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.v_pool) % 16 == 0;
  if (vec)
    return launch_lanes<T, kVec>(p, batch, n_head, max_chunks, st);
  return launch_lanes<T, 1>(p, batch, n_head, max_chunks, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// ws: float32, [batch, n_head, ceil(pages_per_slot * page_size / chunk_rows),
// 2 + d_head], or null when that count is 1; counters: [batch * n_head]
// zeros, which each launch leaves at zero. Returns the cudaError_t of the
// launch; the caller raises on non-zero.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* ctx_len, void* out, void* ws,
    void* counters, int batch, int n_head, int d_head, int pages_per_slot,
    int num_pages, int page_size, int chunk_rows, float sm_scale,
    float mask_value, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || n_head < 1 || n_head > 65535 ||
      d_head < 1 || d_head > kMaxD || pages_per_slot < 1 || num_pages < 1 ||
      page_size < 1 || chunk_rows < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(pages_per_slot) * page_size;
  const long long max_chunks = (rows + chunk_rows - 1) / chunk_rows;
  if (max_chunks > (1LL << 31) - 1 ||
      (max_chunks > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  PagedParams p{q, k_pool, v_pool, static_cast<const int*>(page_table),
                static_cast<const int*>(ctx_len), out,
                static_cast<float*>(ws), static_cast<unsigned*>(counters),
                d_head, pages_per_slot, num_pages, page_size, chunk_rows,
                sm_scale, mask_value};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(p, batch, n_head, static_cast<int>(max_chunks),
                               st);
  return launch_typed<bf16>(p, batch, n_head, static_cast<int>(max_chunks),
                            st);
}
