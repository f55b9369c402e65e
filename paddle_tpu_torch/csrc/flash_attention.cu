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
// Pallas kernels add the bias first). The bias is float32 or q's type
// (ab_dtype), read in its own type and added in float32 as the Pallas
// kernels read theirs; K1c writes ds in the bias's type. Dropout drops the
// normalised probabilities and leaves the statistics alone; the keep mask
// is a hash of (seed, b, h, q position, k position), the same uint32
// arithmetic as the Pallas kernels' _dropout_keep_tile, so the three
// kernels redraw one mask. The seed lies on the card (one int64 the
// caller drew from its generator there), and each kernel reads it once,
// so no host ever reads it and a CUDA graph can replay the launch.
// A row with no visible position (segment ids only) gives o = 0 and
// lse = +inf, hence p = 0 and no gradient.
//
// Rounding: every sum is float32. With bfloat16 inputs p is rounded to
// bfloat16 before p . v and p^T . do, and ds * sm_scale before its two
// products, where the Pallas kernels cast to the input type.
//
// Bound: arithmetic. At the training shape [8,16,2048,64], causal, the
// forward is 4*B*H*S^2*D/2 = 68.7 GFLOP against 268 MB of q, k, v, o in
// float32: 1.03 ms at the card's 67 TFLOP/s of plain float32 against
// 0.08 ms of memory traffic; in bfloat16 0.0695 ms at the tensor cores'
// 989 TFLOP/s against 0.04 ms of memory traffic. K1b does twice the
// forward's products, K1c one and a half times.
//
// Two families of kernels:
//   float32 (K1a, K1b, K1c): register-blocked FFMA tiles fed by a cp.async
//     ring (flash_fwd_kernel, flash_dkv_kernel, flash_dq_kernel);
//   bfloat16 (K1a, K1b, K1c): tensor-core kernels (flash_fwd_bf16_kernel,
//     flash_dkv_bf16_kernel, flash_dq_bf16_kernel).
//
// What all share. The Pallas grid walks the kv tiles (K1a, K1c) or the q
// tiles (K1b) in order and carries the softmax state or the dk/dv sums in
// VMEM scratch from one grid step to the next. A GPU has no ordered grid,
// so one thread block owns one tile of (b, h) and loops over the other
// sequence itself, its state in registers: K1a and K1c own a q tile and
// walk the kv tiles of 64, K1b owns a kv tile and walks the q tiles. No
// block adds into another's output, so there are no atomics and a result
// is the same from run to run. Causal tiles above the diagonal are never
// visited (the loop bounds stop there), and K1a/K1c start their longest
// blocks first. The tensors come with their strides (last stride 1), so
// the [B,S,H,D] views the attention layer hands over are read in place
// rather than copied, and ragged ends are masked by index: any Sq and Sk,
// D of 32, 64 or 128.
//
// Design of the float32 FFMA tiles. Full float32 products on the FMA
// units, no tensor-core instruction: the bound is the card's 67 TFLOP/s of
// FFMA, and what stands between a kernel and it is the shared-memory
// instructions that feed each FMA, the barriers, and the work per score.
// In K1a and K1c a block of 128 threads owns 64 q rows; a thread owns 4 of
// them (ty + 16 i) and 8 columns of each 64-column kv tile (tx + 8 j), so
// 8 adjacent lanes share a row and its maximum and sum take three
// shuffles. Every tile is row-major with a pitch of D + 4 floats, an odd
// number of 16-byte chunks: a product reads both operands along d as
// float4, and the 8 rows tx + 8 j that a warp reads at one d, like its 4
// q rows, fall into different bank groups. So S = Q . K^T (and in K1c
// dP = dO . V^T) costs 12 float4 reads per 128 FMAs, and O += P . V (dQ +=
// dS . K) reads a P row as float4 along k and 8 adjacent chunks of the V
// (K) row: 12 per 128 as well. One K layout serves both of K1c's reads, so
// K is staged once, not also transposed; nothing needs a transposing
// store, and every operand comes by 16-byte cp.async copies straight into
// its tile (rows at or beyond Sq/Sk zero-filled by src-size 0). K and V go
// through a two-stage ring (K1c: two K stages and one V stage, refilled as
// soon as dP is done, so that its 105 KB at D = 64 leave two blocks an
// SM), the next tile's copies in flight while the current one computes,
// with two barriers a tile. P (K1a) and dS (K1c) pass through a [64][72]
// tile, whose pitch puts a warp's 4 rows 8 banks apart for both the
// scalar stores and the float4 reads. A tile that no bias, segment id,
// ragged edge or causal diagonal reaches only scales; the others go
// through ScoreCtx::score or p_and_ds. The exponentials are ex2.approx of
// (s - m) * log2(e), the difference taken first so that a masked score
// cannot overflow (K1c's masked tiles keep expf). Warps an SM decided the
// tile, as in the bf16 kernels (flash_variants.py on an H100 80GB HBM3 at
// 700 W, D = 64): the source, 8 warps an SM by 105 KB of shared memory
// (K1a 210 registers, K1c 254, no spill), ran K1a / K1c in 2.36-2.38 /
// 3.11-3.13 ms; 128 rows on 256 threads, 8 warps in one block, 2.35-2.42
// / 3.26; 8 x 8 tiles, 4 warps an SM, 2.86-2.95 / 4.29 on 128 threads
// (128 rows; K1c spills 140 bytes) and 3.45-3.47 / 4.80 on 64 (64 rows).
// Measured at the training shape (chip_smoke.py, same card): 2.374 ms for
// K1a and 3.123 ms for K1c, 43 % and 49 % of their bounds, against 4.96
// and 6.02 ms for the FMA loops they replaced.
//
// K1b is K1c's shape turned around (its own note at the kernel): a block
// owns 64 kv rows and walks the q tiles, a thread holds 4 kv rows x 8 q
// columns of S^T and dP^T and 4 rows of both accumulators, dK and dV (246
// registers at D = 64, no spill). Lean, it keeps one dO stage and one tile
// for P^T and then dS^T, 106 KB at D = 64, so two blocks of 4 warps share
// an SM. flash_variants.py (same card, D = 64): the source 3.99 ms; 4 x 8
// on 256 threads over 128 kv rows (214 KB, one block of 8 warps, 254
// registers) 4.26; 4 x 8 on 128 threads with two dO stages and separate
// P^T and dS^T tiles (142 KB, one block of 4 warps) 4.69; 2 x 8 on 256
// threads, 8 warps in one block, 5.89 with two dO stages (190 registers)
// and 6.00 lean: the 2 x 8 tile reads 10 float4 per 64 FMAs, the 4 x 8
// tile 12 per 128. Measured at the training shape (chip_smoke.py, same
// card): 3.982 ms, 52 % of its bound, against 6.05-6.11 ms for the FMA
// loop it replaced and 5.52 ms for the library's whole backward.
//
// Design of the tensor-core family (FlashAttention-2's shape on mma.sync).
// The grid, the loop over the other sequence and the causal order are
// those above. In K1a and K1c a block of 4 warps owns 64 * MT q rows (a
// warp 16 * MT of them) and walks kv tiles of 64 columns; K1b is the same
// shape turned around (a block owns 16 kv rows a warp and walks q tiles of
// 64, its own note below). All three launch 64-row tiles on 4 warps and
// ask for as many blocks an SM as their registers allow (fwd_min_blocks,
// dkv_min_blocks, dq_min_blocks), the choice flash_variants.py measures
// against 128-row tiles and other block counts. The owned tile (Q, and dO
// for K1c; K and V for K1b) stays in shared memory as bfloat16, read in
// place from its strided view by 16-byte cp.async copies; the walked one
// goes through a two-stage ring, the next tile's copies in flight while
// the current one computes. Rows at or beyond Sq/Sk
// are zero-filled by the copy itself (src-size 0). A tile's rows are
// XOR-swizzled in 16-byte chunks, so the 8 rows an ldmatrix phase reads lie
// in 8 different bank groups. Products are mma.sync m16n8k16 bf16 -> f32:
// S = Q . K^T and (K1c) dP = dO . V^T read K and V by ldmatrix, O += P . V
// and (K1c) dQ += dS . K by ldmatrix.trans, so one K and one V tile serve
// all products. P and dS never touch shared memory: the f32 accumulator of
// two adjacent n8 tiles, packed to bf16x2, is the A operand of the next k16
// product. A row's 64 scores of a tile lie in the 4 lanes of a quad, so its
// maximum and sum take two shuffles. Scale, bias, masks and dropout apply
// per accumulator element from its (row, col) through
// ScoreCtx::score and p_and_ds; a tile that no mask, bias, dropout (K1b,
// K1c) or ragged edge reaches only scales. Their exponentials take the SFU's
// ex2.approx (__expf, a few ulp): p is rounded to bfloat16 before its
// product, and the log-sum-exp moves by ~1e-6. The loads need 16-byte aligned bases and
// strides; the wrapper hands over an aligned copy of an operand that misses
// it, and the launch refuses one that still does. Measured at the training
// shape on an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.432 ms for K1a,
// 0.626 ms for K1b and 0.470 ms for K1c in bfloat16, 16 %, 22 % and 22 %
// of their bounds (5.16, 6.33 and 7.30 ms as FMA loops).

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
  const void* ab;      // bias of type ab_dtype, or null
  const int* seg_q;    // [B,Sq] int32, or null
  const int* seg_kv;   // [B,Sk] int32, or null
  void* o;             // K1a out
  float* lse;          // K1a out, K1b/K1c in   [B,H,Sq]
  const void* dout;    // K1b/K1c in
  const float* di;     // K1b/K1c in            [B,H,Sq]
  void* dq;            // K1c out
  void* dk;            // K1b out
  void* dv;            // K1b out
  void* dab;           // K1c out, contiguous [B,H,Sq,Sk] of type ab_dtype,
                       // or null
  long long q_st[3], k_st[3], v_st[3], ab_st[3], o_st[3], do_st[3], dq_st[3],
      dk_st[3], dv_st[3];
  int b, h, sq, sk, d;
  int causal;
  int dtype;           // 0 = float32, 1 = bfloat16
  int ab_dtype;        // the bias's: 0 = float32, 1 = bfloat16 (dtype 1 only)
  int dropout;         // 0 = none
  const long long* seed;  // [1] on the card, its low 32 bits the mask's
                          // seed; read only with dropout (may be null)
  unsigned int threshold;  // keep where hash >= threshold
  float keep_scale;    // 1 / (1 - rate)
  float sm_scale;
};

namespace {

constexpr int kTile = 64;        // rows of a q tile and of a kv tile
constexpr float kMaskValue = -0.7f * FLT_MAX;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// Everything one score needs besides q . k^T: scale, bias, the masks. AB
// is the bias's element type (float32, or bfloat16 under bfloat16 q, k,
// v): the bias is read in its own type and added in float32, as the Pallas
// kernels read theirs. The launch picks AB from ab_dtype, so a kernel
// without a bias is the one for a bias of its own type.
template <typename AB>
struct ScoreCtx {
  const AB* ab;         // bias of this (b, h), or null
  long long ab_row;     // its row stride
  const int* seg_q;     // ids of this batch row, or null
  const int* seg_kv;
  int sq, sk, causal;
  float sm_scale;
  uint32_t seed;        // the dropout mask's seed, read once a block

  __device__ __forceinline__ ScoreCtx(const FlashParams& p, int b, int h)
      : ab(p.ab ? static_cast<const AB*>(p.ab) + b * p.ab_st[0] +
                      h * p.ab_st[1]
                : nullptr),
        ab_row(p.ab_st[2]),
        seg_q(p.seg_q ? p.seg_q + static_cast<long long>(b) * p.sq : nullptr),
        seg_kv(p.seg_kv ? p.seg_kv + static_cast<long long>(b) * p.sk
                        : nullptr),
        sq(p.sq),
        sk(p.sk),
        causal(p.causal),
        sm_scale(p.sm_scale),
        seed(p.dropout ? static_cast<uint32_t>(*p.seed) : 0u) {}

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

// The number of kv tiles a q tile of `rows` rows starting at q0 visits.
__device__ __forceinline__ int kv_tiles(int sk, int causal, int q0,
                                        int rows = kTile) {
  const int n = (sk + kTile - 1) / kTile;
  if (!causal) return n;
  const int diag = (q0 + rows - 1) / kTile + 1;  // tiles with k0 <= last row
  return diag < n ? diag : n;
}

// p, and the gradient ds of the masked score, of one element in the
// backward kernels. dp is do . v^T of the element.
struct PAndDs {
  float pd;  // p after dropout (the operand of dv)
  float ds;  // p * (dropout'(dp) - di)
};
template <typename AB>
__device__ __forceinline__ PAndDs p_and_ds(const FlashParams& p,
                                           const ScoreCtx<AB>& sc, float qk,
                                           float dp, float lse, float di,
                                           int b, int h, int row, int col,
                                           int id_q, int id_kv) {
  const float s = sc.score(qk, row, col, id_q, id_kv);
  const float pij = expf(s - lse);  // 0 for lse = +inf and for s = -inf
  PAndDs r;
  r.pd = pij;
  if (p.dropout) {
    const bool keep = dropout_keep(sc.seed, b, h, row, col, p.threshold);
    r.pd = keep ? pij * p.keep_scale : 0.f;
    dp = keep ? dp * p.keep_scale : 0.f;
  }
  r.ds = pij * (dp - di);
  return r;
}

// ------------------------------------------- bfloat16 on the tensor cores --
// K1a, K1b and K1c in bfloat16 (the design note at the top of the file).
constexpr int kMmaThreads = 128;  // 4 warps; a warp owns 16 * MT q rows
constexpr int kBc = kTile;        // columns of a kv tile
constexpr int kNt = kBc / 8;      // n8 tiles of a kv tile

// Blocks an SM must hold at once, which caps a thread's registers at
// 65536 / (128 n). More blocks hide the latency of one block's barriers
// and exponentials behind another's products, until the cap spills:
// flash_variants.py times the neighbouring counts. At D = 128 the
// accumulators need more registers than 3 or 4 blocks leave.
constexpr int fwd_min_blocks(int d) { return d <= 64 ? 4 : 2; }
constexpr int dq_min_blocks(int d) { return d <= 64 ? 3 : 2; }
constexpr int dkv_min_blocks(int d) { return d <= 64 ? 2 : 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, past L1; zeros where !in (src-size
// 0 reads nothing).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of 16-byte chunk `chunk` of row `row` in a swizzled
// [rows][D] bf16 tile. The 8 consecutive rows one ldmatrix phase reads at a
// fixed logical chunk land in 8 different 16-byte bank groups: the chunk
// index is XORed with the row (D >= 64, rows of 128 or 256 bytes) or with
// the row pair (D = 32, rows of 64 bytes, two to a 128-byte line).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (D == 32) return row * D + ((chunk ^ ((row >> 1) & 3)) << 3);
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Rows [row0, row0 + ROWS) of a bf16 matrix with row stride `row_stride`
// into a swizzled tile, asynchronously, by a block of THREADS threads;
// rows at or beyond `rows` read as 0.
template <int D, int ROWS, int THREADS = kMmaThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride,
                                                int row0, int rows) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * C % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < ROWS * C / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / C, c = i % C, gr = row0 + r;
    const bool in = gr < rows;
    cp_async_16(smem_addr(dst + swz<D>(r, c)),
                in ? src + gr * row_stride + c * 8 : src, in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragment of the 16 x 16 block at rows r0.., columns 16 kk.. of a
// row-major tile.
template <int D>
__device__ __forceinline__ void ldsm_a(const bf16* tile, int r0, int kk,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(smem_addr(tile + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4))),
          a);
}
// B fragments of B = tile^T for the two n8 tiles of rows n0..n0 + 15 of a
// [n][k] tile, k columns 16 kk..: {b[0], b[1]} of n tile n0 / 8, {b[2],
// b[3]} of the next.
template <int D>
__device__ __forceinline__ void ldsm_b(const bf16* tile, int n0, int kk,
                                       uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(smem_addr(tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1))),
          b);
}
// B fragments of B = tile for k rows k0..k0 + 15 of a [k][n] tile, n
// columns 16 nn..: {b[0], b[1]} of n tile 2 nn, {b[2], b[3]} of the next.
template <int D>
__device__ __forceinline__ void ldsm_bt(const bf16* tile, int k0, int nn,
                                        uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(
      smem_addr(tile + swz<D>(k0 + (lane & 15), 2 * nn + (lane >> 4))), b);
}

// c += a . b on the tensor cores, m16n8k16, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warp's accumulators. Element e of c[mt][nt] is row 16 mt + g + 8 (e/2)
// of the warp's rows and column 8 nt + 2 t + e%2 of the tile, for lane
// 4 g + t.
template <int MT>
using ScoreFrag = float[MT][kNt][4];

// c = A . B^T over D: the warp's 16 * MT rows from r0 of A [rows][D]
// against the 64 rows of B [64][D], both swizzled tiles.
template <int D, int MT>
__device__ __forceinline__ void mma_abt(const bf16* A, int r0, const bf16* B,
                                        ScoreFrag<MT>& c) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_a<D>(A, r0 + 16 * mt, kk, a[mt]);
#pragma unroll
    for (int np = 0; np < kNt / 2; ++np) {
      uint32_t b[4];
      ldsm_b<D>(B, 16 * np, kk, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(c[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(c[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// acc += P . B: P the warp's [16 MT][64] accumulators, rounded here to
// bf16 and used as A operands where they lie (the accumulators of n tiles
// 2 kc and 2 kc + 1 are the A fragment of k16 step kc), B [64][D] swizzled.
template <int D, int MT>
__device__ __forceinline__ void mma_pb(const ScoreFrag<MT>& pf, const bf16* B,
                                       float (&acc)[MT][D / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < kBc / 16; ++kc) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(pf[mt][2 * kc][0], pf[mt][2 * kc][1]);
      a[mt][1] = pack_bf16(pf[mt][2 * kc][2], pf[mt][2 * kc][3]);
      a[mt][2] = pack_bf16(pf[mt][2 * kc + 1][0], pf[mt][2 * kc + 1][1]);
      a[mt][3] = pack_bf16(pf[mt][2 * kc + 1][2], pf[mt][2 * kc + 1][3]);
    }
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];
      ldsm_bt<D>(B, 16 * kc, nn, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * nn], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * nn + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The segment ids (seg, of n positions, or null) of a lane's 16 columns
// of a 64-column tile: columns col0 + 8 nt + j, col0 = the tile's first
// plus 2 t.
__device__ __forceinline__ void tile_ids(const int* seg, int n, int col0,
                                         int (&id)[kNt][2]) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = col0 + 8 * nt + j;
      id[nt][j] = (seg != nullptr && col < n) ? seg[col] : 0;
    }
}

// Whether the tile at k0 needs only the scale for the rows from wrow0 on:
// no bias, no segment ids, no column beyond Sk and, causal, none above the
// diagonal.
template <typename AB>
__device__ __forceinline__ bool plain_tile(const ScoreCtx<AB>& sc, int k0,
                                           int wrow0) {
  return sc.ab == nullptr && sc.seg_q == nullptr && k0 + kBc <= sc.sk &&
         !(sc.causal && k0 + kBc - 1 > wrow0);
}

// ------------------------------------------------------- K1a, bfloat16 -----
template <int D, int MT, typename AB>
__global__ void __launch_bounds__(kMmaThreads, fwd_min_blocks(D))
    flash_fwd_bf16_kernel(FlashParams p) {
  constexpr int BR = 64 * MT, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BR][D]
  bf16* Ks = Qs + BR * D;                         // [2][64][D]
  bf16* Vs = Ks + 2 * kBc * D;                    // [2][64][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BR, wr0 = 16 * MT * warp;  // wr0: the warp's rows
  const int row0 = q0 + wr0 + g;  // row of element 0 of c[0][*]
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const ScoreCtx<AB> sc(p, b, h);
  const int n_kt = kv_tiles(p.sk, p.causal, q0, BR);

  load_tile_async<D, BR>(Qs, q, p.q_st[2], q0, p.sq);
  load_tile_async<D, kBc>(Ks, k, p.k_st[2], 0, p.sk);
  load_tile_async<D, kBc>(Vs, v, p.v_st[2], 0, p.sk);
  cp_async_commit();

  float m[MT][2], l[MT][2], acc[MT][DT][4];
  int id_q[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 16 * mt + 8 * hi;
      m[mt][hi] = -INFINITY;
      l[mt][hi] = 0.f;
      id_q[mt][hi] =
          (sc.seg_q != nullptr && row < p.sq) ? sc.seg_q[row] : 0;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBc;
    if (kt + 1 < n_kt) {  // the next tile's copies fly while this computes
      const int nx = ((kt + 1) & 1) * kBc * D;
      load_tile_async<D, kBc>(Ks + nx, k, p.k_st[2], k0 + kBc, p.sk);
      load_tile_async<D, kBc>(Vs + nx, v, p.v_st[2], k0 + kBc, p.sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    const bf16* Kt = Ks + (kt & 1) * kBc * D;
    const bf16* Vt = Vs + (kt & 1) * kBc * D;

    float s[MT][kNt][4];
    mma_abt<D, MT>(Qs, wr0, Kt, s);
    if (plain_tile(sc, k0, q0 + wr0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] *= p.sm_scale;
    } else {
      int id_kv[kNt][2];
      tile_ids(sc.seg_kv, sc.sk, k0 + 2 * t, id_kv);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][nt][e] = sc.score(s[mt][nt][e], row0 + 16 * mt + 8 * (e >> 1),
                                    k0 + 8 * nt + 2 * t + (e & 1),
                                    id_q[mt][e >> 1], id_kv[nt][e & 1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hi], s[mt][nt][2 * hi + 1]));
        // every tile holds column k0 < Sk, so the row's maximum is finite
        const float m_new = fmaxf(m[mt][hi], quad_max(mx));
        const float alpha = __expf(m[mt][hi] - m_new);
        const int row = row0 + 16 * mt + 8 * hi;
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float pij = __expf(s[mt][nt][2 * hi + j] - m_new);
            rs += pij;  // the statistics see no dropout
            if (p.dropout)
              pij = dropout_keep(sc.seed, b, h, row, k0 + 8 * nt + 2 * t + j,
                                 p.threshold)
                        ? pij * p.keep_scale
                        : 0.f;
            s[mt][nt][2 * hi + j] = pij;
          }
        l[mt][hi] = l[mt][hi] * alpha + rs;  // the lane's 16 columns
        m[mt][hi] = m_new;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          acc[mt][dt][2 * hi] *= alpha;
          acc[mt][dt][2 * hi + 1] *= alpha;
        }
      }
    mma_pb<D, MT>(s, Vt, acc);
    __syncthreads();  // every warp is done with this stage before its refill
  }

  bf16* o = static_cast<bf16*>(p.o) + b * p.o_st[0] + h * p.o_st[1];
  float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 16 * mt + 8 * hi;
      const float lt = quad_sum(l[mt][hi]);
      // a row whose every visited position was masked: its maximum is the
      // mask value itself
      const bool dead = m[mt][hi] < 0.5f * kMaskValue;
      const float inv = dead ? 0.f : 1.f / lt;
      if (row < p.sq) {
        bf16* orow = o + static_cast<long long>(row) * p.o_st[2] + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * dt) =
              __floats2bfloat162_rn(acc[mt][dt][2 * hi] * inv,
                                    acc[mt][dt][2 * hi + 1] * inv);
        if (t == 0) lse[row] = dead ? INFINITY : m[mt][hi] + logf(lt);
      }
    }
}

// ------------------------------------------------------- K1c, bfloat16 -----
template <int D, int MT, typename AB>
__global__ void __launch_bounds__(kMmaThreads, dq_min_blocks(D))
    flash_dq_bf16_kernel(FlashParams p) {
  constexpr int BR = 64 * MT, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BR][D]
  bf16* dOs = Qs + BR * D;                        // [BR][D]
  bf16* Ks = dOs + BR * D;                        // [2][64][D]
  bf16* Vs = Ks + 2 * kBc * D;                    // [2][64][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BR, wr0 = 16 * MT * warp;
  const int row0 = q0 + wr0 + g;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.do_st[0] + h * p.do_st[1];
  const float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
  const float* di = p.di + (static_cast<long long>(b) * p.h + h) * p.sq;
  AB* dab = p.dab ? static_cast<AB*>(p.dab) +
                        (static_cast<long long>(b) * p.h + h) * p.sq * p.sk
                  : nullptr;
  const ScoreCtx<AB> sc(p, b, h);
  const int n_kt = kv_tiles(p.sk, p.causal, q0, BR);

  load_tile_async<D, BR>(Qs, q, p.q_st[2], q0, p.sq);
  load_tile_async<D, BR>(dOs, dout, p.do_st[2], q0, p.sq);
  load_tile_async<D, kBc>(Ks, k, p.k_st[2], 0, p.sk);
  load_tile_async<D, kBc>(Vs, v, p.v_st[2], 0, p.sk);
  cp_async_commit();

  float lse_r[MT][2], di_r[MT][2], dq[MT][DT][4];
  int id_q[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 16 * mt + 8 * hi;
      // a row beyond Sq gets lse = +inf, so its p is 0
      lse_r[mt][hi] = row < p.sq ? lse[row] : INFINITY;
      di_r[mt][hi] = row < p.sq ? di[row] : 0.f;
      id_q[mt][hi] =
          (sc.seg_q != nullptr && row < p.sq) ? sc.seg_q[row] : 0;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[mt][dt][e] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBc;
    if (kt + 1 < n_kt) {
      const int nx = ((kt + 1) & 1) * kBc * D;
      load_tile_async<D, kBc>(Ks + nx, k, p.k_st[2], k0 + kBc, p.sk);
      load_tile_async<D, kBc>(Vs + nx, v, p.v_st[2], k0 + kBc, p.sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + (kt & 1) * kBc * D;
    const bf16* Vt = Vs + (kt & 1) * kBc * D;

    float s[MT][kNt][4], dp[MT][kNt][4];
    mma_abt<D, MT>(Qs, wr0, Kt, s);
    mma_abt<D, MT>(dOs, wr0, Vt, dp);
    // s becomes ds * sm_scale, the A operand of dq += ds . k
    if (!p.dropout && plain_tile(sc, k0, q0 + wr0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pij =
                __expf(s[mt][nt][e] * p.sm_scale - lse_r[mt][e >> 1]);
            s[mt][nt][e] =
                pij * (dp[mt][nt][e] - di_r[mt][e >> 1]) * p.sm_scale;
          }
    } else {
      int id_kv[kNt][2];
      tile_ids(sc.seg_kv, sc.sk, k0 + 2 * t, id_kv);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 16 * mt + 8 * (e >> 1);
            const int col = k0 + 8 * nt + 2 * t + (e & 1);
            const PAndDs r = p_and_ds(
                p, sc, s[mt][nt][e], dp[mt][nt][e], lse_r[mt][e >> 1],
                di_r[mt][e >> 1], b, h, row, col, id_q[mt][e >> 1],
                id_kv[nt][e & 1]);
            if (dab != nullptr && row < p.sq && col < p.sk)
              store(&dab[static_cast<long long>(row) * p.sk + col], r.ds);
            s[mt][nt][e] = r.ds * p.sm_scale;
          }
    }
    mma_pb<D, MT>(s, Kt, dq);
    __syncthreads();
  }

  // causal: the bias gradient of the tiles above the diagonal is 0
  const int col0 = n_kt * kBc;
  if (dab != nullptr && col0 < p.sk) {
    const int w = p.sk - col0;
    for (int i = threadIdx.x; i < BR * w; i += kMmaThreads) {
      const int row = q0 + i / w;
      if (row < p.sq)
        store(&dab[static_cast<long long>(row) * p.sk + col0 + i % w], 0.f);
    }
  }
  bf16* dq_out = static_cast<bf16*>(p.dq) + b * p.dq_st[0] + h * p.dq_st[1];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 16 * mt + 8 * hi;
      if (row < p.sq) {
        bf16* drow = dq_out + static_cast<long long>(row) * p.dq_st[2] + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(drow + 8 * dt) =
              __floats2bfloat162_rn(dq[mt][dt][2 * hi], dq[mt][dt][2 * hi + 1]);
      }
    }
}

// ------------------------------------------------------- K1b, bfloat16 -----
// The forward's products turned around: a block of WARPS warps owns 16 *
// WARPS kv rows (a warp 16 of them) and walks the q tiles of 64 rows, so a
// fragment's row is a kv position and its column a q position. K and V
// stay in shared memory; Q, dO and the tile's lse and di go through the
// two-stage ring. Per q tile a warp computes S^T = K . Q^T and dP^T =
// V . dO^T (K and V as A operands, Q and dO by ldmatrix), then P^T and
// dS^T element by element, then dV += dropout(P^T) . dO and dK += (dS^T *
// scale) . Q with dO and Q by ldmatrix.trans: each Q and dO tile serves two
// products, and P^T and dS^T never leave registers. A q position's lse and
// di are per column, so they come from shared memory, not from the quad.
template <int D, int WARPS, typename AB>
__global__ void __launch_bounds__(32 * WARPS, dkv_min_blocks(D))
    flash_dkv_bf16_kernel(FlashParams p) {
  constexpr int BKV = 16 * WARPS, NTH = 32 * WARPS, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BKV][D]
  bf16* Vs = Ks + BKV * D;                        // [BKV][D]
  bf16* Qs = Vs + BKV * D;                        // [2][64][D]
  bf16* dOs = Qs + 2 * kBc * D;                   // [2][64][D]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kBc * D);  // [2][64]
  float* di_s = lse_s + 2 * kBc;                                // [2][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // causal: the first kv tiles walk the most q tiles, and start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV, wk0 = k0 + 16 * warp;  // the warp's rows
  const int row0 = wk0 + g;  // kv row of element 0 of a fragment
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.do_st[0] + h * p.do_st[1];
  const float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
  const float* di = p.di + (static_cast<long long>(b) * p.h + h) * p.sq;
  const ScoreCtx<AB> sc(p, b, h);
  const int n_qt = (p.sq + kBc - 1) / kBc;
  const int qt0 = p.causal ? k0 / kBc : 0;  // causal: rows before k0 see none

  load_tile_async<D, BKV, NTH>(Ks, k, p.k_st[2], k0, p.sk);
  load_tile_async<D, BKV, NTH>(Vs, v, p.v_st[2], k0, p.sk);
  if (qt0 < n_qt) {
    load_tile_async<D, kBc, NTH>(Qs, q, p.q_st[2], qt0 * kBc, p.sq);
    load_tile_async<D, kBc, NTH>(dOs, dout, p.do_st[2], qt0 * kBc, p.sq);
  }
  cp_async_commit();
  if (threadIdx.x < kBc) {
    // a row at or beyond Sq gets lse = +inf, so its p is 0
    const int row = qt0 * kBc + threadIdx.x;
    lse_s[threadIdx.x] = row < p.sq ? lse[row] : INFINITY;
    di_s[threadIdx.x] = row < p.sq ? di[row] : 0.f;
  }
  int id_kv[2];
  float dk[1][DT][4], dv[1][DT][4];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    id_kv[hi] = (sc.seg_kv != nullptr && row < p.sk) ? sc.seg_kv[row] : 0;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[0][dt][e] = dv[0][dt][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBc, st = (qt - qt0) & 1;
    // the next tile's copies fly while this one computes; its lse and di
    // wait in registers until this tile's reads are done
    float lse_nx = INFINITY, di_nx = 0.f;
    if (qt + 1 < n_qt) {
      const int nx = (st ^ 1) * kBc * D;
      load_tile_async<D, kBc, NTH>(Qs + nx, q, p.q_st[2], q0 + kBc, p.sq);
      load_tile_async<D, kBc, NTH>(dOs + nx, dout, p.do_st[2], q0 + kBc, p.sq);
      const int row = q0 + kBc + threadIdx.x;
      if (threadIdx.x < kBc && row < p.sq) {
        lse_nx = lse[row];
        di_nx = di[row];
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) has landed
    __syncthreads();
    const bf16* Qt = Qs + st * kBc * D;
    const bf16* dOt = dOs + st * kBc * D;
    const float* lse_t = lse_s + st * kBc;
    const float* di_t = di_s + st * kBc;

    // s becomes dropout(p)^T, the A operand of dv += p^T . do, and dp
    // becomes (ds * sm_scale)^T, that of dk += ds^T . q
    float s[1][kNt][4], dp[1][kNt][4];
    mma_abt<D, 1>(Ks, wk0 - k0, Qt, s);
    mma_abt<D, 1>(Vs, wk0 - k0, dOt, dp);
    // only the scale: no bias, segment ids or dropout, no q row beyond Sq,
    // no kv row beyond Sk and, causal, no kv row after the tile's first q
    if (!p.dropout && sc.ab == nullptr && sc.seg_q == nullptr &&
        q0 + kBc <= p.sq && wk0 + 16 <= p.sk &&
        !(p.causal && wk0 + 15 > q0)) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int c = 8 * nt + 2 * t;  // the lane's first q row of the n8
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(di_t + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pij =
              __expf(s[0][nt][e] * p.sm_scale - ((e & 1) ? l2.y : l2.x));
          dp[0][nt][e] =
              pij * (dp[0][nt][e] - ((e & 1) ? d2.y : d2.x)) * p.sm_scale;
          s[0][nt][e] = pij;
        }
      }
    } else {
      int id_q[kNt][2];
      tile_ids(sc.seg_q, p.sq, q0 + 2 * t, id_q);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nt + 2 * t + (e & 1);  // q row in the tile
          const PAndDs r = p_and_ds(p, sc, s[0][nt][e], dp[0][nt][e],
                                    lse_t[c], di_t[c], b, h, q0 + c,
                                    row0 + 8 * (e >> 1), id_q[nt][e & 1],
                                    id_kv[e >> 1]);
          s[0][nt][e] = r.pd;
          dp[0][nt][e] = r.ds * p.sm_scale;
        }
    }
    mma_pb<D, 1>(s, dOt, dv);
    mma_pb<D, 1>(dp, Qt, dk);
    if (qt + 1 < n_qt && threadIdx.x < kBc) {
      lse_s[(st ^ 1) * kBc + threadIdx.x] = lse_nx;
      di_s[(st ^ 1) * kBc + threadIdx.x] = di_nx;
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();  // a block with no q tile still has K and V in flight

  bf16* dk_out = static_cast<bf16*>(p.dk) + b * p.dk_st[0] + h * p.dk_st[1];
  bf16* dv_out = static_cast<bf16*>(p.dv) + b * p.dv_st[0] + h * p.dv_st[1];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    if (row < p.sk) {
      bf16* krow = dk_out + static_cast<long long>(row) * p.dk_st[2] + 2 * t;
      bf16* vrow = dv_out + static_cast<long long>(row) * p.dv_st[2] + 2 * t;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * dt) =
            __floats2bfloat162_rn(dk[0][dt][2 * hi], dk[0][dt][2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * dt) =
            __floats2bfloat162_rn(dv[0][dt][2 * hi], dv[0][dt][2 * hi + 1]);
      }
    }
  }
}

// ------------------------------------------- float32 K1a and K1c, FFMA -----
// Register-blocked tiles fed by a cp.async ring (the design note at the top
// of the file). A block of NT threads is TY = NT / 8 rows of 8 threads; a
// thread owns q rows ty + TY i (i < MT) and, of a 64-column kv tile, the
// columns tx + 8 j (j < 8): MT x 8 scores. The 8 threads of a row are 8
// adjacent lanes of one warp.
constexpr int kRowLanes = 8;         // threads that share a q row
constexpr int kPitchP = kTile + 8;   // pitch of a P or dS tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx, 2 ulp); -inf gives 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The maximum and the sum over the 8 lanes of a row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + ROWS) of a float32 matrix with row stride `row_stride`
// into a row-major [ROWS][D + 4] tile, asynchronously, by a block of NT
// threads; rows at or beyond `rows` read as 0.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_f32_async(float* dst,
                                                    const float* src,
                                                    long long row_stride,
                                                    int row0, int rows) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * C % NT == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < ROWS * C / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / C, c = i % C, gr = row0 + r;
    const bool in = gr < rows;
    cp_async_16(smem_addr(dst + r * (D + 4) + 4 * c),
                in ? src + gr * row_stride + 4 * c : src, in);
  }
}

// c[i][j] = sum_d A[ty + TY i][d] * B[tx + 8 j][d]: MT rows of A against 8
// of the 64 rows of B, both row-major of pitch D + 4. Per 4 d a thread reads
// 8 + MT float4 for 32 MT FMAs. The pitch is an odd number of 16-byte
// chunks, so a warp's 8 rows tx + 8 j of B (j fixed) and its 4 rows of A
// lie in different bank groups.
template <int D, int MT, int TY>
__device__ __forceinline__ void ffma_abt(const float* A, const float* B,
                                         int ty, int tx, float (&c)[MT][8]) {
  constexpr int P = D + 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * P + d);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (ty + TY * i) * P + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[i][j] = fmaf(a.x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a.y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a.z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a.w, b[j].w, c[i][j]);
      }
    }
  }
}

// acc[i][4 m + e] += sum_k Pm[ty + TY i][k] * B[k][4 tx + 32 m + e] over
// the 64 k of a tile: Pm row-major of pitch kPitchP, B row-major of pitch
// D + 4. Per 4 k a thread reads MT + D / 8 float4 for MT * D / 2 FMAs; a
// warp's reads of B at one k are 8 adjacent chunks, its 4 rows of Pm lie 8
// banks apart.
template <int D, int MT, int TY>
__device__ __forceinline__ void ffma_pb(const float* Pm, const float* B,
                                        int ty, int tx,
                                        float (&acc)[MT][D / 8]) {
  constexpr int PB = D + 4, M = D / 32;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 pv[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      pv[i] = *reinterpret_cast<const float4*>(Pm + (ty + TY * i) * kPitchP +
                                               k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 bv[M];
#pragma unroll
      for (int m = 0; m < M; ++m)
        bv[m] = *reinterpret_cast<const float4*>(B + (k + kk) * PB + 4 * tx +
                                                 32 * m);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float pk = kk == 0 ? pv[i].x
                         : kk == 1 ? pv[i].y
                         : kk == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc[i][4 * m] = fmaf(pk, bv[m].x, acc[i][4 * m]);
          acc[i][4 * m + 1] = fmaf(pk, bv[m].y, acc[i][4 * m + 1]);
          acc[i][4 * m + 2] = fmaf(pk, bv[m].z, acc[i][4 * m + 2]);
          acc[i][4 * m + 3] = fmaf(pk, bv[m].w, acc[i][4 * m + 3]);
        }
      }
    }
  }
}

// The segment ids (seg, of n positions, or null) of a thread's 8 columns
// tx + 8 j of the kv tile at k0.
__device__ __forceinline__ void row_ids(const int* seg, int n, int k0, int tx,
                                        int (&id)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = k0 + tx + 8 * j;
    id[j] = (seg != nullptr && col < n) ? seg[col] : 0;
  }
}

// ---------------------------------------------------------- K1a, float32 --
template <int D, int MT, int NT>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashParams p) {
  constexpr int TY = NT / kRowLanes, BR = TY * MT, P = D + 4, DC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BR][D + 4]
  float* Ks = Qs + BR * P;         // [2][64][D + 4]
  float* Vs = Ks + 2 * kTile * P;  // [2][64][D + 4]
  float* Ps = Vs + 2 * kTile * P;  // [BR][kPitchP]: dropout(p)
  const int ty = threadIdx.x / kRowLanes, tx = threadIdx.x % kRowLanes;
  // causal: the tiles nearest the end walk the most kv tiles; start them
  // first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BR;
  const float* q =
      static_cast<const float*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const float* k =
      static_cast<const float*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const float* v =
      static_cast<const float*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const ScoreCtx<float> sc(p, b, h);
  const int n_kt = kv_tiles(p.sk, p.causal, q0, BR);

  load_tile_f32_async<D, BR, NT>(Qs, q, p.q_st[2], q0, p.sq);
  load_tile_f32_async<D, kTile, NT>(Ks, k, p.k_st[2], 0, p.sk);
  load_tile_f32_async<D, kTile, NT>(Vs, v, p.v_st[2], 0, p.sk);
  cp_async_commit();

  float m[MT], l[MT], acc[MT][DC];
  int id_q[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = q0 + ty + TY * i;
    m[i] = -INFINITY;
    l[i] = 0.f;
    id_q[i] = (sc.seg_q != nullptr && row < p.sq) ? sc.seg_q[row] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; every thread is done with the
                      // last one, its stage and P
    if (kt + 1 < n_kt) {  // the next tile's copies fly while this computes
      const int nx = ((kt + 1) & 1) * kTile * P;
      load_tile_f32_async<D, kTile, NT>(Ks + nx, k, p.k_st[2], k0 + kTile,
                                        p.sk);
      load_tile_f32_async<D, kTile, NT>(Vs + nx, v, p.v_st[2], k0 + kTile,
                                        p.sk);
      cp_async_commit();
    }
    const float* Kt = Ks + (kt & 1) * kTile * P;
    const float* Vt = Vs + (kt & 1) * kTile * P;

    float s[MT][8];
    ffma_abt<D, MT, TY>(Qs, Kt, ty, tx, s);
    if (plain_tile(sc, k0, q0)) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] *= p.sm_scale;
    } else {
      int id_kv[8];
      row_ids(sc.seg_kv, p.sk, k0, tx, id_kv);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = sc.score(s[i][j], q0 + ty + TY * i, k0 + tx + 8 * j,
                             id_q[i], id_kv[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      // every tile holds column k0 < Sk, so the row's maximum is finite;
      // the difference is taken before the factor log2(e), so that a
      // masked score cannot overflow
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = exp2_approx((m[i] - m_new) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pij = exp2_approx((s[i][j] - m_new) * kLog2e);
        rs += pij;  // the statistics see no dropout
        if (p.dropout)
          pij = dropout_keep(sc.seed, b, h, row, k0 + tx + 8 * j, p.threshold)
                    ? pij * p.keep_scale
                    : 0.f;
        Ps[(ty + TY * i) * kPitchP + tx + 8 * j] = pij;
      }
      l[i] = l[i] * alpha + rs;  // this thread's 8 columns; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is whole
    ffma_pb<D, MT, TY>(Ps, Vt, ty, tx, acc);
  }

  float* o = static_cast<float*>(p.o) + b * p.o_st[0] + h * p.o_st[1];
  float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = q0 + ty + TY * i;
    const float lt = row_sum(l[i]);
    // a row whose every visited position was masked: its maximum is the
    // mask value itself
    const bool dead = m[i] < 0.5f * kMaskValue;
    const float inv = dead ? 0.f : 1.f / lt;
    if (row < p.sq) {
      float* orow = o + static_cast<long long>(row) * p.o_st[2] + 4 * tx;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        store(&orow[32 * (c / 4) + c % 4], acc[i][c] * inv);
      if (tx == 0) lse[row] = dead ? INFINITY : m[i] + logf(lt);
    }
  }
}

// ---------------------------------------------------------- K1c, float32 --
// K is row-major like every tile here, which serves both of its reads:
// S = Q . K^T reads 8 rows at one d (as B of ffma_abt), dQ += dS . K one row
// at 32 adjacent d (as B of ffma_pb). V is read only by dP = dO . V^T, so
// it has one stage, refilled once every thread has read it.
template <int D, int MT, int NT>
__global__ void __launch_bounds__(NT) flash_dq_kernel(FlashParams p) {
  constexpr int TY = NT / kRowLanes, BR = TY * MT, P = D + 4, DC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BR][D + 4]
  float* dOs = Qs + BR * P;         // [BR][D + 4]
  float* Ks = dOs + BR * P;         // [2][64][D + 4]
  float* Vs = Ks + 2 * kTile * P;   // [64][D + 4]
  float* dSs = Vs + kTile * P;      // [BR][kPitchP]: ds * sm_scale
  const int ty = threadIdx.x / kRowLanes, tx = threadIdx.x % kRowLanes;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BR;
  const float* q =
      static_cast<const float*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const float* k =
      static_cast<const float*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const float* v =
      static_cast<const float*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_st[0] + h * p.do_st[1];
  const float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
  const float* di = p.di + (static_cast<long long>(b) * p.h + h) * p.sq;
  float* dab = p.dab ? static_cast<float*>(p.dab) +
                           (static_cast<long long>(b) * p.h + h) * p.sq * p.sk
                     : nullptr;
  const ScoreCtx<float> sc(p, b, h);
  const int n_kt = kv_tiles(p.sk, p.causal, q0, BR);

  load_tile_f32_async<D, BR, NT>(Qs, q, p.q_st[2], q0, p.sq);
  load_tile_f32_async<D, BR, NT>(dOs, dout, p.do_st[2], q0, p.sq);
  load_tile_f32_async<D, kTile, NT>(Ks, k, p.k_st[2], 0, p.sk);
  load_tile_f32_async<D, kTile, NT>(Vs, v, p.v_st[2], 0, p.sk);
  cp_async_commit();

  float lse_r[MT], di_r[MT], dq[MT][DC];
  int id_q[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = q0 + ty + TY * i;
    // a row beyond Sq gets lse = +inf, so its p is 0
    lse_r[i] = row < p.sq ? lse[row] : INFINITY;
    di_r[i] = row < p.sq ? di[row] : 0.f;
    id_q[i] = (sc.seg_q != nullptr && row < p.sq) ? sc.seg_q[row] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    cp_async_wait<0>();
    __syncthreads();  // K and V of this tile have landed; every thread is
                      // done with the last tile's K stage and dS
    if (kt + 1 < n_kt) {
      load_tile_f32_async<D, kTile, NT>(Ks + ((kt + 1) & 1) * kTile * P, k,
                                        p.k_st[2], k0 + kTile, p.sk);
      cp_async_commit();
    }
    const float* Kt = Ks + (kt & 1) * kTile * P;

    float s[MT][8], dp[MT][8];
    ffma_abt<D, MT, TY>(Qs, Kt, ty, tx, s);
    ffma_abt<D, MT, TY>(dOs, Vs, ty, tx, dp);
    // s becomes ds * sm_scale, the operand of dq += ds . k
    if (!p.dropout && plain_tile(sc, k0, q0)) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pij =
              exp2_approx((s[i][j] * p.sm_scale - lse_r[i]) * kLog2e);
          s[i][j] = pij * (dp[i][j] - di_r[i]) * p.sm_scale;
        }
    } else {
      int id_kv[8];
      row_ids(sc.seg_kv, p.sk, k0, tx, id_kv);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = q0 + ty + TY * i, col = k0 + tx + 8 * j;
          const PAndDs e = p_and_ds(p, sc, s[i][j], dp[i][j], lse_r[i],
                                    di_r[i], b, h, row, col, id_q[i],
                                    id_kv[j]);
          if (dab != nullptr && row < p.sq && col < p.sk)
            store(&dab[static_cast<long long>(row) * p.sk + col], e.ds);
          s[i][j] = e.ds * p.sm_scale;
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dSs[(ty + TY * i) * kPitchP + tx + 8 * j] = s[i][j];
    __syncthreads();  // dS is whole, and every thread is done with V
    if (kt + 1 < n_kt) {  // V's next copies fly during dq += ds . k
      load_tile_f32_async<D, kTile, NT>(Vs, v, p.v_st[2], k0 + kTile, p.sk);
      cp_async_commit();
    }
    ffma_pb<D, MT, TY>(dSs, Kt, ty, tx, dq);
  }

  // causal: the bias gradient of the tiles above the diagonal is 0
  const int col0 = n_kt * kTile;
  if (dab != nullptr && col0 < p.sk) {
    const int w = p.sk - col0;
    for (int i = threadIdx.x; i < BR * w; i += NT) {
      const int row = q0 + i / w;
      if (row < p.sq)
        store(&dab[static_cast<long long>(row) * p.sk + col0 + i % w], 0.f);
    }
  }
  float* dq_out = static_cast<float*>(p.dq) + b * p.dq_st[0] + h * p.dq_st[1];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row < p.sq) {
      float* drow = dq_out + static_cast<long long>(row) * p.dq_st[2] + 4 * tx;
#pragma unroll
      for (int c = 0; c < DC; ++c) store(&drow[32 * (c / 4) + c % 4], dq[i][c]);
    }
  }
}

// ---------------------------------------------------------- K1b, float32 --
// K1c's tiles turned around: a block of NT threads owns BKV = NT / 8 * MT kv
// rows and walks the q tiles of 64 rows from the first one that sees them; a
// thread owns kv rows ty + TY i and, of a q tile, the columns tx + 8 j. So
// S^T = K . Q^T and dP^T = V . dO^T are ffma_abt with K, V as A and Q, dO as
// B, and dV += P^T . dO and dK += dS^T . Q are ffma_pb over a [BKV][kPitchP]
// tile: no operand needs a transposing store. K and V are copied once; Q, dO
// and the q tile's lse and di go through a two-stage ring (lse and di are
// per column here, so they come from shared memory, not from registers).
// LEAN keeps one dO stage, refilled once dV's product is done, and one tile
// for P^T and then dS^T: 106 KB at D = 64 instead of 142, and at D = 128 the
// only layout that fits.
template <int D, int MT, int NT, bool LEAN>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(FlashParams p) {
  constexpr int TY = NT / kRowLanes, BKV = TY * MT, P = D + 4, DC = D / 8;
  static_assert(NT >= kTile, "a thread for each lse and di of a q tile");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                               // [BKV][D + 4]
  float* Vs = Ks + BKV * P;                       // [BKV][D + 4]
  float* Qs = Vs + BKV * P;                       // [2][64][D + 4]
  float* dOs = Qs + 2 * kTile * P;                // [1 or 2][64][D + 4]
  float* PTs = dOs + (LEAN ? 1 : 2) * kTile * P;  // [BKV][kPitchP]
  float* dSTs = LEAN ? PTs : PTs + BKV * kPitchP;  // [BKV][kPitchP]
  float* lse_s = dSTs + BKV * kPitchP;            // [2][64]
  float* di_s = lse_s + 2 * kTile;                // [2][64]
  const int ty = threadIdx.x / kRowLanes, tx = threadIdx.x % kRowLanes;
  // causal: the first kv tiles walk the most q tiles, and start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;
  const float* q =
      static_cast<const float*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
  const float* k =
      static_cast<const float*>(p.k) + b * p.k_st[0] + h * p.k_st[1];
  const float* v =
      static_cast<const float*>(p.v) + b * p.v_st[0] + h * p.v_st[1];
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_st[0] + h * p.do_st[1];
  const float* lse = p.lse + (static_cast<long long>(b) * p.h + h) * p.sq;
  const float* di = p.di + (static_cast<long long>(b) * p.h + h) * p.sq;
  const ScoreCtx<float> sc(p, b, h);
  const int n_qt = (p.sq + kTile - 1) / kTile;
  const int qt0 = p.causal ? k0 / kTile : 0;  // rows before k0 see none

  load_tile_f32_async<D, BKV, NT>(Ks, k, p.k_st[2], k0, p.sk);
  load_tile_f32_async<D, BKV, NT>(Vs, v, p.v_st[2], k0, p.sk);
  if (qt0 < n_qt) {
    load_tile_f32_async<D, kTile, NT>(Qs, q, p.q_st[2], qt0 * kTile, p.sq);
    load_tile_f32_async<D, kTile, NT>(dOs, dout, p.do_st[2], qt0 * kTile,
                                      p.sq);
  }
  cp_async_commit();
  if (threadIdx.x < kTile) {
    // a row at or beyond Sq gets lse = +inf, so its p is 0
    const int row = qt0 * kTile + threadIdx.x;
    lse_s[threadIdx.x] = row < p.sq ? lse[row] : INFINITY;
    di_s[threadIdx.x] = row < p.sq ? di[row] : 0.f;
  }
  int id_kv[MT];
  float dk[MT][DC], dv[MT][DC];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = k0 + ty + TY * i;
    id_kv[i] = (sc.seg_kv != nullptr && row < p.sk) ? sc.seg_kv[row] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile, st = (qt - qt0) & 1;
    const bool next = qt + 1 < n_qt;
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed, its lse and di are in; every
                      // thread is done with the last tile
    // the next tile's copies fly while this one computes; its lse and di
    // wait in registers until this tile's reads are done
    float lse_nx = INFINITY, di_nx = 0.f;
    if (next) {
      load_tile_f32_async<D, kTile, NT>(Qs + (st ^ 1) * kTile * P, q,
                                        p.q_st[2], q0 + kTile, p.sq);
      if constexpr (!LEAN)
        load_tile_f32_async<D, kTile, NT>(dOs + (st ^ 1) * kTile * P, dout,
                                          p.do_st[2], q0 + kTile, p.sq);
      cp_async_commit();
      const int row = q0 + kTile + threadIdx.x;
      if (threadIdx.x < kTile && row < p.sq) {
        lse_nx = lse[row];
        di_nx = di[row];
      }
    }
    const float* Qt = Qs + st * kTile * P;
    const float* dOt = LEAN ? dOs : dOs + st * kTile * P;
    const float* lse_t = lse_s + st * kTile;
    const float* di_t = di_s + st * kTile;

    // s becomes dropout(p)^T, the operand of dv += p^T . do, and dp
    // becomes (ds * sm_scale)^T, that of dk += ds^T . q
    float s[MT][8], dp[MT][8];
    ffma_abt<D, MT, TY>(Ks, Qt, ty, tx, s);
    ffma_abt<D, MT, TY>(Vs, dOt, ty, tx, dp);
    // only the scale: no bias, segment ids or dropout, no q row beyond Sq,
    // no kv row beyond Sk and, causal, no kv row after the tile's first q
    if (!p.dropout && sc.ab == nullptr && sc.seg_q == nullptr &&
        q0 + kTile <= p.sq && k0 + BKV <= p.sk &&
        !(p.causal && k0 + BKV - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float lse_j = lse_t[tx + 8 * j], di_j = di_t[tx + 8 * j];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float pij =
              exp2_approx((s[i][j] * p.sm_scale - lse_j) * kLog2e);
          dp[i][j] = pij * (dp[i][j] - di_j) * p.sm_scale;
          s[i][j] = pij;
        }
      }
    } else {
      int id_q[8];
      row_ids(sc.seg_q, p.sq, q0, tx, id_q);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 8 * j;  // the q row in the tile
          const PAndDs e =
              p_and_ds(p, sc, s[i][j], dp[i][j], lse_t[c], di_t[c], b, h,
                       q0 + c, k0 + ty + TY * i, id_q[j], id_kv[i]);
          s[i][j] = e.pd;
          dp[i][j] = e.ds * p.sm_scale;
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = (ty + TY * i) * kPitchP + tx + 8 * j;
        PTs[e] = s[i][j];
        if constexpr (!LEAN) dSTs[e] = dp[i][j];
      }
    __syncthreads();  // P^T (and dS^T) whole
    ffma_pb<D, MT, TY>(PTs, dOt, ty, tx, dv);
    if constexpr (LEAN) {
      __syncthreads();  // every thread is done with P^T and dO
      if (next) {  // dO's next copies fly during dk += ds^T . q
        load_tile_f32_async<D, kTile, NT>(dOs, dout, p.do_st[2], q0 + kTile,
                                          p.sq);
        cp_async_commit();
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dSTs[(ty + TY * i) * kPitchP + tx + 8 * j] = dp[i][j];
      __syncthreads();  // dS^T whole
    }
    ffma_pb<D, MT, TY>(dSTs, Qt, ty, tx, dk);
    if (next && threadIdx.x < kTile) {
      lse_s[(st ^ 1) * kTile + threadIdx.x] = lse_nx;
      di_s[(st ^ 1) * kTile + threadIdx.x] = di_nx;
    }
  }
  cp_async_wait<0>();  // a block with no q tile still has K and V in flight

  float* dk_out = static_cast<float*>(p.dk) + b * p.dk_st[0] + h * p.dk_st[1];
  float* dv_out = static_cast<float*>(p.dv) + b * p.dv_st[0] + h * p.dv_st[1];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = k0 + ty + TY * i;
    if (row < p.sk) {
      float* krow = dk_out + static_cast<long long>(row) * p.dk_st[2] + 4 * tx;
      float* vrow = dv_out + static_cast<long long>(row) * p.dv_st[2] + 4 * tx;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        store(&krow[32 * (c / 4) + c % 4], dk[i][c]);
        store(&vrow[32 * (c / 4) + c % 4], dv[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------ launchers ---
// float32 K1a: a q tile of br rows, two K and two V stages of 64 rows, all
// of pitch d + 4, and P
constexpr size_t fwd_smem(int br, int d) {
  return sizeof(float) * ((br + 4 * kTile) * (d + 4) + br * kPitchP);
}
// float32 K1b: a K and a V tile of bkv rows, two Q stages and one (lean) or
// two dO stages of 64 rows, all of pitch d + 4, one (lean) or two [bkv]
// [kPitchP] tiles for P^T and dS^T, and two stages of lse and di
constexpr size_t dkv_smem(int bkv, int d, bool lean) {
  return sizeof(float) * ((2 * bkv + (lean ? 3 : 4) * kTile) * (d + 4) +
                          (lean ? 1 : 2) * bkv * kPitchP + 4 * kTile);
}
// float32 K1c: q and do tiles of br rows, two K stages and one V of 64 rows,
// all of pitch d + 4, and dS
constexpr size_t dq_smem(int br, int d) {
  return sizeof(float) * ((2 * br + 3 * kTile) * (d + 4) + br * kPitchP);
}
// the tensor-core kernels: q (and do) tiles of br rows, two K and two V
// stages of 64 rows, all bf16
constexpr size_t fwd_bf16_smem(int br, int d) {
  return sizeof(bf16) * (br + 4 * kBc) * d;
}
constexpr size_t dq_bf16_smem(int br, int d) {
  return sizeof(bf16) * (2 * br + 4 * kBc) * d;
}
// K1b: a K and a V tile of bkv rows, two Q and two dO stages of 64 rows,
// two stages of the q tile's lse and di
constexpr size_t dkv_bf16_smem(int bkv, int d) {
  return sizeof(bf16) * (2 * bkv + 4 * kBc) * d + sizeof(float) * 4 * kBc;
}

// Above 48 KB a block's shared memory has to be asked for; a launch that
// is refused shows only in cudaGetLastError().
template <typename Kernel>
int launch(Kernel kernel, const FlashParams& p, int tiles, size_t smem,
           int threads, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(tiles, p.h, p.b);
  kernel<<<grid, threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd, kDkv, kDq };

// The 16-byte copies need an aligned base and, where a dimension has more
// than one index, strides of whole 16 bytes, in elements of type T.
template <typename T>
bool copy_aligned(const void* ptr, const long long (&st)[3], int b, int h,
                  int rows) {
  constexpr long long kElems = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (b == 1 || st[0] % kElems == 0) && (h == 1 || st[1] % kElems == 0) &&
         (rows == 1 || st[2] % kElems == 0);
}

// Whether the operands kernel `which` copies by cp.async (q, k, v, and do
// in the backward kernels) meet copy_aligned.
template <typename T>
bool operands_aligned(Which which, const FlashParams& p) {
  return copy_aligned<T>(p.q, p.q_st, p.b, p.h, p.sq) &&
         copy_aligned<T>(p.k, p.k_st, p.b, p.h, p.sk) &&
         copy_aligned<T>(p.v, p.v_st, p.b, p.h, p.sk) &&
         (which == kFwd || copy_aligned<T>(p.dout, p.do_st, p.b, p.h, p.sq));
}

constexpr int tiles_of(int rows, int br) { return (rows + br - 1) / br; }

// The bfloat16 kernels with a bias of element type AB (bf16 without one).
template <int D, typename AB>
int launch_bf16(Which which, const FlashParams& p, cudaStream_t st) {
  if (!operands_aligned<bf16>(which, p))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // 64-row tiles (MT = 1, 4 warps) for all three: more blocks fit an SM
  if (which == kFwd)
    return launch(flash_fwd_bf16_kernel<D, 1, AB>, p, tiles_of(p.sq, 64),
                  fwd_bf16_smem(64, D), kMmaThreads, st);
  if (which == kDkv)
    return launch(flash_dkv_bf16_kernel<D, 4, AB>, p, tiles_of(p.sk, 64),
                  dkv_bf16_smem(64, D), 128, st);
  return launch(flash_dq_bf16_kernel<D, 1, AB>, p, tiles_of(p.sq, 64),
                dq_bf16_smem(64, D), kMmaThreads, st);
}

template <int D>
int launch_one(Which which, const FlashParams& p, cudaStream_t st) {
  if (p.dtype == 0) {
    if (!operands_aligned<float>(which, p))
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (which == kDkv) {
      // 64 kv rows of 4 x 8 scores a thread on 128 threads, lean: two
      // blocks an SM (flash_variants.py); at D = 128 the two accumulators
      // of 4 x 16 would spill, so 2 x 16 on 256 threads
      if constexpr (D == 128)
        return launch(flash_dkv_kernel<D, 2, 256, true>, p,
                      tiles_of(p.sk, 64), dkv_smem(64, D, true), 256, st);
      else
        return launch(flash_dkv_kernel<D, 4, 128, true>, p,
                      tiles_of(p.sk, 64), dkv_smem(64, D, true), 128, st);
    }
    // 64-row q tiles of 4 x 8 scores a thread on 128 threads: two blocks an
    // SM (flash_variants.py)
    if (which == kFwd)
      return launch(flash_fwd_kernel<D, 4, 128>, p, tiles_of(p.sq, 64),
                    fwd_smem(64, D), 128, st);
    return launch(flash_dq_kernel<D, 4, 128>, p, tiles_of(p.sq, 64),
                  dq_smem(64, D), 128, st);
  }
  // a float32 bias under bfloat16 q, k, v has kernels of its own, so the
  // bias's type costs a launch without one nothing
  if (p.ab != nullptr && p.ab_dtype == 0)
    return launch_bf16<D, float>(which, p, st);
  return launch_bf16<D, bf16>(which, p, st);
}

int dispatch(Which which, const FlashParams* p, void* stream) {
  if (p == nullptr || p->b < 1 || p->h < 1 || p->sq < 1 || p->sk < 1 ||
      p->h > 65535 || p->b > 65535 || (p->dtype != 0 && p->dtype != 1) ||
      (p->ab_dtype != 0 && p->ab_dtype != p->dtype) ||
      (p->dropout && p->seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p->d) {
    case 32:
      return launch_one<32>(which, *p, st);
    case 64:
      return launch_one<64>(which, *p, st);
    case 128:
      return launch_one<128>(which, *p, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
