// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces the TPU kernels of
// paddle_tpu/ops/pallas_kernels/flash_attention.py:
//   K1a  _flash_attention_kernel        (launched by _flash_attention_impl)
//   K1b  _flash_attention_dkv_kernel    (launched by _flash_attention_bwd_dkv)
//   K1c  _flash_attention_dq_kernel     (launched by _flash_attention_bwd_dq)
// For q [B,H,Sq,D], k/v [B,H,Sk,D], an optional additive bias ab
// [B,H,Sq,Sk], optional segment ids and an optional causal mask:
//   s   = (q . k^T) * sm_scale + ab, plus -0.7 * FLT_MAX where masked
//   K1a o = dropout(softmax(s)) . v,  lse = log(sum_k exp(s))   [B,H,Sq] f32
//   K1b p = exp(s - lse); dv = dropout(p)^T . do;
//       ds = p * (dropout'(do . v^T) - di); dk = (ds * sm_scale)^T . q
//   K1c dq = (ds * sm_scale) . k, and ds itself as the bias gradient
// with di = rowsum(o * do), which the caller computes. The scale comes
// before the bias, as in the composed attention of both packages (the
// Pallas kernels add the bias first). Dropout drops the normalised
// probabilities and leaves the statistics alone; the keep mask is a hash of
// (seed, b, h, q position, k position), the same uint32 arithmetic as the
// Pallas kernels' _dropout_keep_tile, so the three kernels redraw one mask.
// A row with no visible position (segment ids only) gives o = 0 and
// lse = +inf, hence p = 0 and no gradient.
//
// Rounding: q, k, v, do are read as float32 or bfloat16 and widened; every
// sum is float32. With bfloat16 inputs p is rounded to bfloat16 before
// p . v and p^T . do, and ds * sm_scale before its two products, where the
// Pallas kernels cast to the input type.
//
// Bound: arithmetic. At the training shape [8,16,2048,64], causal, the
// forward is 4*B*H*S^2*D/2 = 68.7 GFLOP against 268 MB of q, k, v, o in
// float32: 1.03 ms at the card's 67 TFLOP/s of plain float32 against
// 0.08 ms of memory traffic. K1b does twice the forward's products, K1c one
// and a half times.
//
// Design. The Pallas grid walks the kv tiles (K1a, K1c) or the q tiles
// (K1b) in order and carries the softmax state or the dk/dv sums in VMEM
// scratch from one grid step to the next. A GPU has no ordered grid, so one
// thread block owns one 64-row tile of (b, h) and loops over the other
// sequence itself, its state in registers: K1a and K1c own a q tile and walk
// the kv tiles, K1b owns a kv tile and walks the q tiles. No block adds into
// another's output, so there are no atomics and a result is the same from
// run to run. Causal tiles above the diagonal are never visited (the loop
// bounds stop there), and K1a/K1c start their longest blocks first.
// Each product is a 64x64 (or 64xD) register-tiled FMA loop over float32
// tiles in shared memory, read 16 bytes at a time with row pitches that
// keep those reads free of bank conflicts; 256 threads hold 4x4 scores and
// 4 x D/16 outputs each. The tensors come with their strides (last stride
// 1), so the [B,S,H,D] views the attention layer hands over are read in
// place rather than copied, and ragged ends are masked by index: any Sq and
// Sk, D of 32, 64 or 128. Tensor-core products (mma.sync, wgmma) and TMA
// staging are later work: this version is bound by its shared-memory reads
// and the float32 FMA rate. Measured at the training shape on an H100 80GB
// HBM3 at 700 W (chip_smoke.py): 5.10 / 6.34 / 6.30 ms in float32 and
// 5.16 / 6.48 / 7.30 ms in bfloat16 for K1a / K1b / K1c.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

// Mirrored field for field by ctypes in ops/kernels/flash_attention.py.
// Strides count elements: {batch, head, row}; the last dimension has
// stride 1. lse, di and the segment ids are contiguous.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* ab;      // bias in the q/k/v type, or null
  const int* seg_q;    // [B,Sq] int32, or null
  const int* seg_kv;   // [B,Sk] int32, or null
  void* o;             // K1a out
  float* lse;          // K1a out, K1b/K1c in   [B,H,Sq]
  const void* dout;    // K1b/K1c in
  const float* di;     // K1b/K1c in            [B,H,Sq]
  void* dq;            // K1c out
  void* dk;            // K1b out
  void* dv;            // K1b out
  void* dab;           // K1c out, contiguous [B,H,Sq,Sk], or null
  long long q_st[3], k_st[3], v_st[3], ab_st[3], o_st[3], do_st[3], dq_st[3],
      dk_st[3], dv_st[3];
  int b, h, sq, sk, d;
  int causal;
  int dtype;           // 0 = float32, 1 = bfloat16
  int dropout;         // 0 = none
  unsigned int seed, threshold;  // keep where hash >= threshold
  float keep_scale;    // 1 / (1 - rate)
  float sm_scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of a q tile and of a kv tile
constexpr int kPitchS = kTile + 4;  // pitch of a 64x64 score tile
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and widened again: where the product's operand has type T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The keep mask of _dropout_keep_tile: a splitmix32-style hash of the
// absolute element coordinates and the seed, in wrap-around uint32.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t b,
                                             uint32_t h, uint32_t row,
                                             uint32_t col,
                                             uint32_t threshold) {
  uint32_t x = (row * 2654435761u) ^ (col * 0x85EBCA6Bu);
  x ^= seed + b * 0x9E3779B9u + h * 0xC2B2AE35u;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold;
}

// dst[r][c] = src[row0 + r][c] widened to float, zero beyond `rows`.
template <typename T, int D, int PITCH>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * PITCH + c] =
        gr < rows ? to_float(src[static_cast<long long>(gr) * row_stride + c])
                  : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]: a 64x64 tile of
// A . B^T, 4x4 per thread. Both pitches are D + 4, so the 16-byte reads of
// the 8 threads of a quarter warp fall into different banks.
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         int ty, int tx, float (&acc)[4][4]) {
  constexpr int P = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * P + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * P + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

template <int DV>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[DV]) {
  if constexpr (DV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < DV; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      out[c] = t.x;
      out[c + 1] = t.y;
      out[c + 2] = t.z;
      out[c + 3] = t.w;
    }
  }
}

// acc[i][c] += sum_k P[ty + 16 i][k] * B[k][tx * DV + c] over the 64 values
// of k: a 64 x D tile of P . B, 4 x DV per thread (DV = D / 16).
template <int DV, int PB>
__device__ __forceinline__ void acc_tile(const float* P, const float* Bm,
                                         int ty, int tx,
                                         float (&acc)[4][DV]) {
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(&P[(ty + 16 * i) * kPitchS + k]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[DV];
      load_vec<DV>(&Bm[(k + kk) * PB + tx * DV], bv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk = kk == 0 ? p[i].x
                         : kk == 1 ? p[i].y
                         : kk == 2 ? p[i].z
                                   : p[i].w;
#pragma unroll
        for (int c = 0; c < DV; ++c) acc[i][c] = fmaf(pk, bv[c], acc[i][c]);
      }
    }
  }
}

// Everything one score needs besides q . k^T: scale, bias, the masks.
template <typename T>
struct ScoreCtx {
  const T* ab;          // bias of this (b, h), or null
  long long ab_row;     // its row stride
  const int* seg_q;     // ids of this batch row, or null
  const int* seg_kv;
  int sq, sk, causal;
  float sm_scale;

  __device__ __forceinline__ ScoreCtx(const FlashParams& p, int b, int h)
      : ab(p.ab ? static_cast<const T*>(p.ab) + b * p.ab_st[0] +
                      h * p.ab_st[1]
                : nullptr),
        ab_row(p.ab_st[2]),
        seg_q(p.seg_q ? p.seg_q + static_cast<long long>(b) * p.sq : nullptr),
        seg_kv(p.seg_kv ? p.seg_kv + static_cast<long long>(b) * p.sk
                        : nullptr),
        sq(p.sq),
        sk(p.sk),
        causal(p.causal),
        sm_scale(p.sm_scale) {}

  // The masked score of (row, col) from the raw product: the mask value is
  // added, as the Pallas kernels add it; a column beyond Sk is -inf, so
  // that it adds nothing even to a row that is masked everywhere.
  __device__ __forceinline__ float score(float qk, int row, int col,
                                         int id_q, int id_kv) const {
    if (col >= sk) return -INFINITY;
    float x = qk * sm_scale;
    if (ab != nullptr && row < sq)
      x += to_float(ab[static_cast<long long>(row) * ab_row + col]);
    bool visible = true;
    if (seg_q != nullptr) visible = id_q == id_kv;
    if (causal) visible = visible && col <= row;
    return visible ? x : x + kMaskValue;
  }
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// The number of kv tiles a q tile starting at q0 visits.
__device__ __forceinline__ int kv_tiles(int sk, int causal, int q0) {
  const int n = (sk + kTile - 1) / kTile;
  if (!causal) return n;
  const int diag = (q0 + kTile - 1) / kTile + 1;  // tiles with k0 <= last row
  return diag < n ? diag : n;
}

// ---------------------------------------------------------------- K1a -----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  constexpr int DV = D / 16, PQ = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [64][D + 4]
  float* Ks = Qs + kTile * PQ;    // [64][D + 4]
  float* Vs = Ks + kTile * PQ;    // [64][D]
  float* Ps = Vs + kTile * D;     // [64][68]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // causal: the tiles nearest the end walk the most kv tiles; start them
  // first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const T* q = static_cast<const T*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const T* k = static_cast<const T*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const T* v = static_cast<const T*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const ScoreCtx<T> sc(p, b, h);

  load_tile<T, D, PQ>(Qs, q, p.q_st[2], q0, p.sq);
  float m[4], l[4], acc[4][DV];
  int id_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    const int row = q0 + ty + 16 * i;
    id_q[i] = (sc.seg_q != nullptr && row < p.sq) ? sc.seg_q[row] : 0;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = kv_tiles(p.sk, p.causal, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's reads are done
    load_tile<T, D, PQ>(Ks, k, p.k_st[2], k0, p.sk);
    load_tile<T, D, D>(Vs, v, p.v_st[2], k0, p.sk);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(Qs, Ks, ty, tx, s);
    int id_kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      id_kv[j] = (sc.seg_kv != nullptr && col < p.sk) ? sc.seg_kv[col] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = sc.score(s[i][j], row, k0 + tx + 16 * j, id_q[i], id_kv[j]);
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds column k0 < Sk, so the row's maximum is finite
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float pij = expf(s[i][j] - m_new);
        rs += pij;  // the statistics see no dropout
        if (p.dropout)
          pij = dropout_keep(p.seed, b, h, row, col, p.threshold)
                    ? pij * p.keep_scale
                    : 0.f;
        Ps[(ty + 16 * i) * kPitchS + tx + 16 * j] = round_to<T>(pij);
      }
      l[i] = l[i] * alpha + rs;  // this thread's 4 columns; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    acc_tile<DV, D>(Ps, Vs, ty, tx, acc);
  }

  T* o = static_cast<T*>(p.o) + b * p.o_st[0] + h * p.o_st[1];
  float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float lt = half_warp_sum(l[i]);
    // a row whose every visited position was masked: its maximum is the
    // mask value itself
    const bool dead = m[i] < 0.5f * kMaskValue;
    const float inv = dead ? 0.f : 1.f / lt;
    if (row < p.sq) {
#pragma unroll
      for (int c = 0; c < DV; ++c)
        store(&o[static_cast<long long>(row) * p.o_st[2] + tx * DV + c],
              acc[i][c] * inv);
      if (tx == 0) lse[row] = dead ? INFINITY : m[i] + logf(lt);
    }
  }
}

// p, and the gradient ds of the masked score, of one element in the
// backward kernels. dp is do . v^T of the element.
struct PAndDs {
  float pd;  // p after dropout (the operand of dv)
  float ds;  // p * (dropout'(dp) - di)
};
template <typename T>
__device__ __forceinline__ PAndDs p_and_ds(const FlashParams& p,
                                           const ScoreCtx<T>& sc, float qk,
                                           float dp, float lse, float di,
                                           int b, int h, int row, int col,
                                           int id_q, int id_kv) {
  const float s = sc.score(qk, row, col, id_q, id_kv);
  const float pij = expf(s - lse);  // 0 for lse = +inf and for s = -inf
  PAndDs r;
  r.pd = pij;
  if (p.dropout) {
    const bool keep = dropout_keep(p.seed, b, h, row, col, p.threshold);
    r.pd = keep ? pij * p.keep_scale : 0.f;
    dp = keep ? dp * p.keep_scale : 0.f;
  }
  r.ds = pij * (dp - di);
  return r;
}

// ---------------------------------------------------------------- K1b -----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(FlashParams p) {
  constexpr int DV = D / 16, PQ = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [64][D + 4]
  float* Vs = Ks + kTile * PQ;        // [64][D + 4]
  float* Qs = Vs + kTile * PQ;        // [64][D + 4]
  float* dOs = Qs + kTile * PQ;       // [64][D + 4]
  float* PT = dOs + kTile * PQ;       // [kv][q], pitch 68: dropout(p)^T
  float* dST = PT + kTile * kPitchS;  // [kv][q], pitch 68: (ds * scale)^T
  float* lse_s = dST + kTile * kPitchS;  // [64]
  float* di_s = lse_s + kTile;           // [64]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // causal: the first kv tiles walk the most q tiles, and start first
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const T* q = static_cast<const T*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const T* k = static_cast<const T*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const T* v = static_cast<const T*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.do_st[0] + h * p.do_st[1];
  const float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
  const float* di = p.di + (static_cast<long long>(b) * p.h + h) * p.sq;
  const ScoreCtx<T> sc(p, b, h);

  load_tile<T, D, PQ>(Ks, k, p.k_st[2], k0, p.sk);
  load_tile<T, D, PQ>(Vs, v, p.v_st[2], k0, p.sk);
  int id_kv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + tx + 16 * j;
    id_kv[j] = (sc.seg_kv != nullptr && col < p.sk) ? sc.seg_kv[col] : 0;
  }
  // this thread's outputs: kv rows ty + 16 i, columns tx * DV + c
  float dk[4][DV], dv[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DV; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (p.sq + kTile - 1) / kTile;
  // causal: rows before k0 see none of this tile
  for (int qt = p.causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's reads are done
    load_tile<T, D, PQ>(Qs, q, p.q_st[2], q0, p.sq);
    load_tile<T, D, PQ>(dOs, dout, p.do_st[2], q0, p.sq);
    if (tid < kTile) {
      const int row = q0 + tid;
      // a row beyond Sq gets lse = +inf, so its p is 0
      lse_s[tid] = row < p.sq ? lse[row] : INFINITY;
      di_s[tid] = row < p.sq ? di[row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(Qs, Ks, ty, tx, s);
    dot_tile<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const int id_q = (sc.seg_q != nullptr && row < p.sq) ? sc.seg_q[row] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j;
        const PAndDs e = p_and_ds<T>(p, sc, s[i][j], dp[i][j], lse_s[r],
                                     di_s[r], b, h, row, k0 + cj, id_q,
                                     id_kv[j]);
        PT[cj * kPitchS + r] = round_to<T>(e.pd);
        dST[cj * kPitchS + r] = round_to<T>(e.ds * p.sm_scale);
      }
    }
    __syncthreads();
    acc_tile<DV, PQ>(PT, dOs, ty, tx, dv);
    acc_tile<DV, PQ>(dST, Qs, ty, tx, dk);
  }

  T* dk_out = static_cast<T*>(p.dk) + b * p.dk_st[0] + h * p.dk_st[1];
  T* dv_out = static_cast<T*>(p.dv) + b * p.dv_st[0] + h * p.dv_st[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < p.sk) {
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        store(&dk_out[static_cast<long long>(row) * p.dk_st[2] + tx * DV + c],
              dk[i][c]);
        store(&dv_out[static_cast<long long>(row) * p.dv_st[2] + tx * DV + c],
              dv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------- K1c -----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(FlashParams p) {
  constexpr int DV = D / 16, PQ = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [64][D + 4]
  float* dOs = Qs + kTile * PQ;    // [64][D + 4]
  float* Ks = dOs + kTile * PQ;    // [64][D + 4]
  float* Vs = Ks + kTile * PQ;     // [64][D + 4]
  float* dS = Vs + kTile * PQ;     // [q][kv], pitch 68: ds * scale
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const T* q = static_cast<const T*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const T* k = static_cast<const T*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const T* v = static_cast<const T*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.do_st[0] + h * p.do_st[1];
  const float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
  const float* di = p.di + (static_cast<long long>(b) * p.h + h) * p.sq;
  T* dab = p.dab ? static_cast<T*>(p.dab) +
                       (static_cast<long long>(b) * p.h + h) * p.sq * p.sk
                 : nullptr;
  const ScoreCtx<T> sc(p, b, h);

  load_tile<T, D, PQ>(Qs, q, p.q_st[2], q0, p.sq);
  load_tile<T, D, PQ>(dOs, dout, p.do_st[2], q0, p.sq);
  float lse_r[4], di_r[4], dq[4][DV];
  int id_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < p.sq ? lse[row] : INFINITY;
    di_r[i] = row < p.sq ? di[row] : 0.f;
    id_q[i] = (sc.seg_q != nullptr && row < p.sq) ? sc.seg_q[row] : 0;
#pragma unroll
    for (int c = 0; c < DV; ++c) dq[i][c] = 0.f;
  }

  const int n_kt = kv_tiles(p.sk, p.causal, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's reads are done
    load_tile<T, D, PQ>(Ks, k, p.k_st[2], k0, p.sk);
    load_tile<T, D, PQ>(Vs, v, p.v_st[2], k0, p.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(Qs, Ks, ty, tx, s);
    dot_tile<D>(dOs, Vs, ty, tx, dp);
    int id_kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      id_kv[j] = (sc.seg_kv != nullptr && col < p.sk) ? sc.seg_kv[col] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j, col = k0 + cj;
        const PAndDs e = p_and_ds<T>(p, sc, s[i][j], dp[i][j], lse_r[i],
                                     di_r[i], b, h, row, col, id_q[i],
                                     id_kv[j]);
        if (dab != nullptr && row < p.sq && col < p.sk)
          store(&dab[static_cast<long long>(row) * p.sk + col], e.ds);
        dS[r * kPitchS + cj] = round_to<T>(e.ds * p.sm_scale);
      }
    }
    __syncthreads();
    acc_tile<DV, PQ>(dS, Ks, ty, tx, dq);
  }

  // causal: the bias gradient of the tiles above the diagonal is 0
  if (dab != nullptr) {
    const int col0 = n_kt * kTile;
    for (int r = ty; r < kTile; r += 16) {
      const int row = q0 + r;
      if (row >= p.sq) break;
      for (int col = col0 + tx; col < p.sk; col += 16)
        store(&dab[static_cast<long long>(row) * p.sk + col], 0.f);
    }
  }
  T* dq_out = static_cast<T*>(p.dq) + b * p.dq_st[0] + h * p.dq_st[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < p.sq) {
#pragma unroll
      for (int c = 0; c < DV; ++c)
        store(&dq_out[static_cast<long long>(row) * p.dq_st[2] + tx * DV + c],
              dq[i][c]);
    }
  }
}

// ------------------------------------------------------------ launchers ---
constexpr size_t fwd_smem(int d) {
  return sizeof(float) * (2 * kTile * (d + 4) + kTile * d + kTile * kPitchS);
}
constexpr size_t dkv_smem(int d) {
  return sizeof(float) *
         (4 * kTile * (d + 4) + 2 * kTile * kPitchS + 2 * kTile);
}
constexpr size_t dq_smem(int d) {
  return sizeof(float) * (4 * kTile * (d + 4) + kTile * kPitchS);
}

// Above 48 KB a block's shared memory has to be asked for; a launch that
// is refused shows only in cudaGetLastError().
template <typename Kernel>
int launch(Kernel kernel, const FlashParams& p, int tiles, size_t smem,
           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(tiles, p.h, p.b);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd, kDkv, kDq };

template <typename T, int D>
int launch_one(Which which, const FlashParams& p, cudaStream_t st) {
  const int q_tiles = (p.sq + kTile - 1) / kTile;
  const int kv_tiles_n = (p.sk + kTile - 1) / kTile;
  switch (which) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, p, q_tiles, fwd_smem(D), st);
    case kDkv:
      return launch(flash_dkv_kernel<T, D>, p, kv_tiles_n, dkv_smem(D), st);
    default:
      return launch(flash_dq_kernel<T, D>, p, q_tiles, dq_smem(D), st);
  }
}

template <typename T>
int launch_d(Which which, const FlashParams& p, cudaStream_t st) {
  switch (p.d) {
    case 32:
      return launch_one<T, 32>(which, p, st);
    case 64:
      return launch_one<T, 64>(which, p, st);
    case 128:
      return launch_one<T, 128>(which, p, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(Which which, const FlashParams* p, void* stream) {
  if (p == nullptr || p->b < 1 || p->h < 1 || p->sq < 1 || p->sk < 1 ||
      p->h > 65535 || p->b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return launch_d<float>(which, *p, st);
  if (p->dtype == 1) return launch_d<__nv_bfloat16>(which, *p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns the cudaError_t of the launch; the caller raises on non-zero.
extern "C" int flash_attention_fwd(const FlashParams* p, void* stream) {
  return dispatch(kFwd, p, stream);
}
extern "C" int flash_attention_bwd_dkv(const FlashParams* p, void* stream) {
  return dispatch(kDkv, p, stream);
}
extern "C" int flash_attention_bwd_dq(const FlashParams* p, void* stream) {
  return dispatch(kDq, p, stream);
}
