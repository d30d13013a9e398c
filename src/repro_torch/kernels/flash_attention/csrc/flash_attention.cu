// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_bhsd`
// in repro/kernels/flash_attention/kernel.py and computes what it computes:
// causal and sliding-window masks with block skipping, the tanh logit
// softcap, GQA (q head h reads kv head h / group), an online softmax with
// float32 m, l and acc, p rounded to the value dtype before p.v, and the
// output acc / max(l, 1e-30) in q's dtype. Scores are float32 sums of
// products of the inputs; the scale D**-0.5 comes before the softcap and
// the mask after it. Masked scores are -2e38 and the running max is
// clamped at -1e30, so a row with no visible key in a tile adds exactly 0.
//
// Rethought for blocks that run in parallel: the TPU grid walks the KV
// blocks of one (b, h, q-block) in order and carries m/l/acc in VMEM from
// step to step. Here one thread block owns one (b, q-head, q-tile) and
// loops over the KV tiles itself; the loop's first and last tile come
// from the same causal and window conditions as kernel.py:42-46, so fully
// masked tiles are never loaded. Tensors are read in the model layout
// [B, S, H, D] through the strides the wrapper passes (no transposes), and
// the ragged tail of Sq and Sk is masked, so any length works (the TPU
// kernel asserts sq % bq == 0).
//
// Bound on this card. At the serve path's shapes (gemma2-9b prefill, B=2,
// S=5120, 16 q heads, D=256) a global layer does 4*B*H*S*S*D/2 = 429 GFLOP
// on ~252 MB of q/k/v/o: ~1700 FLOP per byte, far above the H100's ~295
// FLOP/byte ridge, so the bound is the tensor cores (0.43 ms at 989
// TFLOP/s bf16), not HBM (0.075 ms at 3.35 TB/s).
//
// Three kernels, chosen by dtype and head dim (the route; ops.py's
// `route` states the same rule):
//
// * "wgmma", bfloat16 at D in {64, 128, 256} (every served model): the
//   Hopper design, from the building blocks of ../../csrc/hopper.cuh. A
//   CTA of 384 threads owns 128 query rows: warpgroup 0 is the producer,
//   warpgroups 1 and 2 consume 64 rows each. One producer thread brings
//   the Q tile in once and the K and V tiles into two rings of 2 stages
//   by TMA (4-D tensor maps over (D, H, S, B), 64-element = 128-byte boxes
//   along D, 128-byte swizzle; rows past Sk arrive as zeros and their
//   scores are masked all the same), with completion on mbarriers: a
//   "full" barrier per stage that the consumers wait on and an "empty"
//   one that every consumer thread arrives at once its products have read
//   the stage; K is released as soon as Q K^T is done, V after P V. Keys
//   per tile: 80 at D=256 (Q 64 KB + 2 x 2 x 40 KB, 224 KB of shared
//   memory), 128 at D=128 and D=64. S = Q K^T is an SS wgmma (Q and K
//   K-major); the online softmax runs on the accumulator (a row's scores
//   over the 4 lanes of a quad, as mma.sync's), p is rounded to bf16 in
//   registers, and P V is an RS wgmma with p as the A fragments and V
//   read MN-major through the transpose bit. Two overlaps hide the
//   softmax, which bounds this kernel (its exponentials and the softcap's
//   run on the SFU): a one-tile software pipeline (Q K^T of tile j and
//   P V of tile j - 1 are issued together, and the softmax of tile j runs
//   while P V is in flight), and ping-pong between the two consumers
//   (named barriers make them take turns issuing, so one's softmax runs
//   under the other's products). The softmax is instantiated with and
//   without the cap and the mask, chosen per call and per tile, so an
//   unmasked tile issues no mask arithmetic. setmaxnreg hands the
//   producer's registers to the consumers (24 / 240). The output is
//   stored from registers with masked 4-byte stores (no row >= Sq). CTAs
//   are ordered with the longest causal q tiles first and the q heads of
//   one kv group side by side, so they share K and V in L2. The softcap
//   stays exact to ~1e-7 (tanh from one ex2 and one rcp, not
//   tanh.approx.f32, whose ~5e-4 relative error at the tanh's bend could
//   move a concentrated softmax by as much as BF16_ROW_TOL in the q*8
//   cases).
// * "mma_sync", bfloat16 at D in {16, 32} (smoke configs): tensor cores
//   through mma.sync m16n8k16, fragments by ldmatrix, K/V tiles loaded
//   synchronously. A block of 4 warps owns 64 query rows, 16 per warp; a
//   warp skips a tile masked for all its rows and does no mask arithmetic
//   on a tile visible to all of them.
// * "f32", float32 (tests and parity runs): CUDA cores. A block of 4 warps
//   stages 32-key K and V tiles in shared memory; each warp owns 4 rows,
//   lane i holds elements i, i+32, ... of q and acc, dot products are
//   reduced with warp shuffles and lane j keeps the score of key j.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError(). The
// TMA descriptors hold the tensors' addresses, so they are encoded on every
// call (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint:
// nothing links against libcuda) and passed as __grid_constant__ params.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kMaxFloor = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, kv_heads, sq, sk, group;
  // batch, seq and head strides, in elements; the last dim has stride 1
  long long q_stride[3], k_stride[3], v_stride[3], o_stride[3];
  int causal, window;
  float scale, cap;
};

__device__ __forceinline__ float capped(float x, const Params& p) {
  x *= p.scale;
  return p.cap > 0.f ? p.cap * tanhf(x / p.cap) : x;
}

__device__ __forceinline__ bool visible(int qi, int kj, const Params& p) {
  bool ok = kj < p.sk;
  if (p.causal) ok = ok && qi >= kj;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// The keys [lo, hi) some row of [q_first, q_last] can see; tiles outside
// are masked for every one of those rows (kernel.py:42-46).
__device__ __forceinline__ void visible_keys(int q_first, int q_last,
                                             const Params& p, int* lo,
                                             int* hi) {
  *lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  *hi = p.causal ? min(p.sk, q_last + 1) : p.sk;
}

typedef __nv_bfloat16 bf16;

// two floats -> bf16x2, round to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// tanh from one exponential and one reciprocal (two MUFU operations):
// absolute error ~1e-7, so cap * tanh is off by ~5e-6 at cap 50, far below
// the bf16 output rounding
__device__ __forceinline__ float fast_tanh(float y) {
  return 1.f - __fdividef(2.f, __expf(2.f * y) + 1.f);
}

// 2**x, one MUFU operation (ex2.approx: ~2 ulp)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bfloat16, D in {16, 32}: tensor cores (mma.sync m16n8k16, fragments by
// ldmatrix)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlockQ = kMmaWarps * 16;  // 16 query rows per warp
constexpr int kMmaBlockK = 64;              // keys per KV tile
constexpr int kPad = 8;                     // bf16 elements of row padding

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of each matrix i in r[i], the
// pair at row l / 4, columns 2 (l % 4) and +1 (transposed with kTrans)
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
}

// Rows [r0, r0 + ROWS) of a [rows, D] bf16 matrix with row stride `stride`
// into shared memory with row stride D + kPad, zeros for rows >= n, 16
// bytes at a time (rows start on 16-byte boundaries).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kMmaBlockQ + 2 * kMmaBlockK) * (D + kPad);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const Params p) {
  constexpr int kStride = D + kPad;   // row stride of the Q, K, V tiles
  constexpr int kN = kMmaBlockK / 8;  // 8-key column blocks of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kMmaBlockQ * kStride;
  bf16* sV = sK + kMmaBlockK * kStride;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in the quad
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / p.group;
  const int q0 = blockIdx.x * kMmaBlockQ;
  const int wq0 = q0 + warp * 16;  // this warp's first row

  const bf16* qb =
      static_cast<const bf16*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const bf16* kb =
      static_cast<const bf16*>(p.k) + b * p.k_stride[0] + hk * p.k_stride[2];
  const bf16* vb =
      static_cast<const bf16*>(p.v) + b * p.v_stride[0] + hk * p.v_stride[2];
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_stride[0] + h * p.o_stride[2];

  load_tile<D, kMmaBlockQ>(sQ, qb, p.q_stride[1], q0, p.sq);

  // ldmatrix row addresses of this lane: Q (A fragments), K (B fragments
  // of two 8-key blocks), V (B fragments of two 8-column blocks, .trans)
  const bf16* q_frag =
      sQ + (warp * 16 + (lane & 15)) * kStride + (lane >> 4) * 8;
  const bf16* k_frag =
      sK + ((lane & 7) + ((lane >> 4) << 3)) * kStride + ((lane >> 3) & 1) * 8;
  const bf16* v_frag = sV + (lane & 15) * kStride + (lane >> 4) * 8;

  // this thread holds rows wq0+g (fragment regs 0,1) and wq0+g+8 (2,3)
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  int kv_lo, kv_hi, w_lo, w_hi;
  visible_keys(q0, min(q0 + kMmaBlockQ, p.sq) - 1, p, &kv_lo, &kv_hi);
  visible_keys(wq0, min(wq0 + 16, p.sq) - 1, p, &w_lo, &w_hi);
  const bool warp_live = wq0 < p.sq;

  for (int tile = kv_lo / kMmaBlockK; tile * kMmaBlockK < kv_hi; ++tile) {
    const int k0 = tile * kMmaBlockK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, kMmaBlockK>(sK, kb, p.k_stride[1], k0, p.sk);
    load_tile<D, kMmaBlockK>(sV, vb, p.v_stride[1], k0, p.sk);
    __syncthreads();
    // warp-uniform: the tile is masked for every row of this warp
    if (!warp_live || k0 >= w_hi || k0 + kMmaBlockK <= w_lo) continue;
    // ... or visible to every row: no mask arithmetic
    const bool interior = k0 + kMmaBlockK <= p.sk &&
                          (!p.causal || k0 + kMmaBlockK - 1 <= wq0) &&
                          (p.window <= 0 || k0 > wq0 + 15 - p.window);

    // s = q k^T for the warp's 16 rows and the tile's 64 keys
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4<false>(a, q_frag + kk * 16);
#pragma unroll
      for (int n = 0; n < kN; n += 2) {
        uint32_t bk[4];
        ldmatrix_x4<false>(bk, k_frag + n * 8 * kStride + kk * 16);
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax (kernel.py:53-79) on the two rows; a row's 64 scores
    // are spread over the quad's 4 lanes, 16 each
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = wq0 + g + 8 * hr;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[n][2 * hr + j] * p.scale;
          if (p.cap > 0.f) x = p.cap * fast_tanh(x / p.cap);
          if (!interior && !visible(qi, k0 + n * 8 + 2 * t + j, p))
            x = kNegInf;
          s[n][2 * hr + j] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float m_safe = fmaxf(m_new, kMaxFloor);
      const float alpha = __expf(fmaxf(m[hr], kMaxFloor) - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pr = __expf(s[n][2 * hr + j] - m_safe);
          s[n][2 * hr + j] = pr;
          sum += pr;
        }
      sum += __shfl_xor_sync(kFullMask, sum, 1);
      sum += __shfl_xor_sync(kFullMask, sum, 2);
      l[hr] = l[hr] * alpha + sum;  // l sums p before its bf16 rounding
      m[hr] = m_new;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][2 * hr] *= alpha;
        o[nd][2 * hr + 1] *= alpha;
      }
    }

    // o += p v, p rounded to bf16 (v's dtype): the score accumulators of
    // two 8-key blocks are exactly the A fragment of a 16-key step
#pragma unroll
    for (int kk = 0; kk < kMmaBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t bv[4];
        ldmatrix_x4<true>(bv, v_frag + kk * 16 * kStride + nd * 8);
        mma_bf16(o[nd], a, bv[0], bv[1]);
        mma_bf16(o[nd + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = wq0 + g + 8 * hr;
    if (qi >= p.sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    bf16* orow = ob + qi * p.o_stride[1] + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack_bf16(o[nd][2 * hr] / den, o[nd][2 * hr + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D in {64, 128, 256}: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // a producer warpgroup and two consumers
constexpr int kWgBlockQ = 128;   // query rows per CTA, 64 per consumer
constexpr int kKVStages = 2;     // the K ring and the V ring

template <int D>
struct WgTile {
  // keys per KV tile: 80 at D=256 keeps the score tile, p twice (the
  // pipeline's two tiles) and the 64 x 256 accumulator within 240
  // registers a thread
  static constexpr int kBN = D == 256 ? 80 : 128;
  static constexpr int kChunks = D / 64;           // 128-byte column blocks
  static constexpr int kQChunk = kWgBlockQ * 128;  // bytes of a Q block
  static constexpr int kKVChunk = kBN * 128;       // ... of a K or V block
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // K or V of a stage
  // 1024 bytes of slack to align the tiles, then Q, the K ring, the V ring
  // and 9 barriers
  static constexpr size_t kSmem =
      1024 + kQBytes + kKVStages * 2 * kKVBytes + 128;
};

// The online softmax (kernel.py:53-79) of one score tile on a thread's two
// rows r0 and r0 + 8: softcap, mask, running max and sum; p (not yet
// rounded) replaces the scores, alpha[hr] is the rescale of the row's
// earlier sum and accumulator. A row's scores are spread over the 4 lanes
// of a quad. Without a cap the max is taken on the raw products q.k (the
// scale is positive) and the scale folds into the exponent's one FMA:
// exp(scale (s - m)) = 2**(s c - m c) with c = scale log2(e); with a cap,
// x = cap tanh(scale s / cap) and c = log2(e). m is kept in the units of x.
// The cap and the mask are template arguments, chosen per call and per
// tile by a warp-uniform branch, so a tile without them issues none of
// their instructions (predicated code would); the max and the sum run
// over 4 partial chains to cut their latency.
template <int kBN, bool kCap, bool kMask>
__device__ __forceinline__ void online_softmax(float (&sc)[kBN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int r0,
                                               int k0, int t,
                                               const Params& p) {
  constexpr int kCols = kBN / 4;  // a thread's scores of one row
  const float cap_mul = kCap ? p.scale / p.cap : 0.f;
  const float c = kCap ? kLog2e : p.scale * kLog2e;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = r0 + 8 * hr;
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      // column 8 (i / 2) + 2 t + i % 2 of the tile
      const int idx = 4 * (i / 2) + 2 * hr + i % 2;
      float x = sc[idx];
      if (kCap) x = p.cap * fast_tanh(x * cap_mul);
      if (kMask && !visible(qi, k0 + 8 * (i / 2) + 2 * t + i % 2, p))
        x = kNegInf;
      sc[idx] = x;
      mx[i % 4] = fmaxf(mx[i % 4], x);
    }
    float row_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    row_max = fmaxf(row_max, __shfl_xor_sync(kFullMask, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(kFullMask, row_max, 2));
    const float m_new = fmaxf(m[hr], row_max);
    const float m_safe = fmaxf(m_new, kMaxFloor);
    alpha[hr] = fast_exp2((fmaxf(m[hr], kMaxFloor) - m_safe) * c);
    const float m_scaled = m_safe * c;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int idx = 4 * (i / 2) + 2 * hr + i % 2;
      const float pr = fast_exp2(fmaf(sc[idx], c, -m_scaled));
      sc[idx] = pr;
      part[i % 4] += pr;
    }
    float sum = (part[0] + part[1]) + (part[2] + part[3]);
    sum += __shfl_xor_sync(kFullMask, sum, 1);
    sum += __shfl_xor_sync(kFullMask, sum, 2);
    l[hr] = l[hr] * alpha[hr] + sum;  // l sums p before its bf16 rounding
    m[hr] = m_new;
  }
}

// p rounded to bf16 (v's dtype) as the A fragments of the P V products:
// the accumulators of two 8-key column blocks are one 16-key step's
template <int kBN>
__device__ __forceinline__ void pack_p(const float (&sc)[kBN / 2],
                                       uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const Params p) {
  using T = WgTile<D>;
  constexpr int kBN = T::kBN;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: every tile starts on one
  unsigned char* sQ =
      smem_raw + (1024 - hopper::smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* sK = sQ + T::kQBytes;  // K stage s at s * kKVBytes
  unsigned char* sV = sK + kKVStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kKVStages * T::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kKVStages;
  uint64_t* v_full = k_empty + kKVStages;
  uint64_t* v_empty = v_full + kKVStages;

  // CTA -> (q tile, batch row, kv head, q head of the group): the q heads
  // of one kv group side by side, the longest causal q tiles first
  int idx = blockIdx.x;
  const int gi = idx % p.group;
  idx /= p.group;
  const int hk = idx % p.kv_heads;
  idx /= p.kv_heads;
  const int b = idx % p.batch;
  idx /= p.batch;
  const int n_qt = (p.sq + kWgBlockQ - 1) / kWgBlockQ;
  const int q0 = (n_qt - 1 - idx) * kWgBlockQ;
  const int h = hk * p.group + gi;

  int kv_lo, kv_hi;
  visible_keys(q0, min(q0 + kWgBlockQ, p.sq) - 1, p, &kv_lo, &kv_hi);
  const int t_first = kv_lo / kBN;
  const int n_tiles =
      kv_hi > kv_lo ? (kv_hi + kBN - 1) / kBN - t_first : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kKVStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2 * 128);  // every consumer thread
      hopper::mbar_init(&v_empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        hopper::tma_load_4d(sQ + c * T::kQChunk, &tm_q, q_full, 64 * c, h,
                            q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kKVStages;
        // wait for the consumers' release of this stage's previous round
        // (a fresh barrier passes parity 1 at once)
        const uint32_t parity = ((it / kKVStages) & 1) ^ 1;
        const int k0 = (t_first + it) * kBN;
        hopper::mbar_wait(&k_empty[s], parity);
        hopper::mbar_arrive_expect_tx(&k_full[s], T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          hopper::tma_load_4d(sK + s * T::kKVBytes + c * T::kKVChunk, &tm_k,
                              &k_full[s], 64 * c, hk, k0, b);
        hopper::mbar_wait(&v_empty[s], parity);
        hopper::mbar_arrive_expect_tx(&v_full[s], T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          hopper::tma_load_4d(sV + s * T::kKVBytes + c * T::kKVChunk, &tm_v,
                              &v_full[s], 64 * c, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    hopper::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in the quad
    const int w0 = q0 + 64 * c;         // this warpgroup's first row
    const int r0 = w0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    const uint32_t q_addr = hopper::smem_u32(sQ) + c * 64 * 128;
    const uint32_t k_addr = hopper::smem_u32(sK);
    const uint32_t v_addr = hopper::smem_u32(sV);
    // s = q k^T of tile `it`: 16-deep k steps, 4 per 128-byte block of D
    auto issue_qk = [&](float (&sc)[kBN / 2], int it) {
      const int s = it % kKVStages;
      hopper::mbar_wait(&k_full[s], (it / kKVStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kBN, 0>(
            sc,
            hopper::desc_k_major(q_addr + (kk / 4) * T::kQChunk +
                                 (kk % 4) * 32),
            hopper::desc_k_major(k_addr + s * T::kKVBytes +
                                 (kk / 4) * T::kKVChunk + (kk % 4) * 32),
            kk > 0);
      hopper::wgmma_commit();
    };
    // o += p v of tile `it`, V read MN-major (keys are its rows)
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[kBN / 16][4],
                        int it) {
      const int s = it % kKVStages;
      hopper::mbar_wait(&v_full[s], (it / kKVStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<D, 1>(
            o, pa[kk],
            hopper::desc_mn_major(v_addr + s * T::kKVBytes + kk * 16 * 128,
                                  T::kKVChunk),
            1);
      hopper::wgmma_commit();
    };
    // accumulator (j, hr, cc) of a 64 x N wgmma tile: row r0 + 8 hr,
    // column 8 j + 2 t + cc, at index 4 j + 2 hr + cc
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    float alpha[2];

    // the softmax of the tile at key k0; one that every row of the
    // warpgroup sees whole needs no mask
    auto softmax = [&](float (&sc)[kBN / 2], int k0) {
      const bool mask = !(k0 + kBN <= p.sk &&
                          (!p.causal || k0 + kBN - 1 <= w0) &&
                          (p.window <= 0 || k0 > w0 + 63 - p.window));
      if (p.cap > 0.f) {
        if (mask)
          online_softmax<kBN, true, true>(sc, m, l, alpha, r0, k0, t, p);
        else
          online_softmax<kBN, true, false>(sc, m, l, alpha, r0, k0, t, p);
      } else {
        if (mask)
          online_softmax<kBN, false, true>(sc, m, l, alpha, r0, k0, t, p);
        else
          online_softmax<kBN, false, false>(sc, m, l, alpha, r0, k0, t, p);
      }
    };

    // Ping-pong: the two consumers take turns issuing their products
    // (named barrier 1 is consumer 0's turn, 2 consumer 1's), so that one's
    // softmax overlaps the other's products. Both take every tile of the
    // CTA, masked where a row sees none of it, so their turns pair up;
    // consumer 1 hands consumer 0 the first turn.
    auto my_turn = [&]() { hopper::named_bar_sync(1 + c, 256); };
    auto your_turn = [&]() { hopper::named_bar_arrive(2 - c, 256); };
    if (c == 1 && n_tiles > 0) hopper::named_bar_arrive(1, 256);
    hopper::mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      // Software pipeline, one tile deep: while the tensor cores run
      // q k^T of tile it and p v of tile it - 1, the warpgroup waits only
      // for the former, and its softmax of tile it overlaps the latter.
      uint32_t pa[kBN / 16][4];
      {
        float sc[kBN / 2];
        my_turn();
        issue_qk(sc, 0);
        your_turn();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::mbar_arrive(&k_empty[0]);
        const int k0 = t_first * kBN;
        softmax(sc, k0);
        pack_p<kBN>(sc, pa);
      }
      for (int it = 1; it < n_tiles; ++it) {
        float sc[kBN / 2];
        my_turn();
        issue_qk(sc, it);
        issue_pv(o, pa, it - 1);
        your_turn();
        hopper::wgmma_wait<1>();  // q k^T of tile it is done
        hopper::fence_regs(sc);
        hopper::mbar_arrive(&k_empty[it % kKVStages]);
        const int k0 = (t_first + it) * kBN;
        softmax(sc, k0);
        hopper::wgmma_wait<0>();  // p v of tile it - 1 is done
        hopper::fence_regs(o);
        hopper::mbar_arrive(&v_empty[(it - 1) % kKVStages]);
        pack_p<kBN>(sc, pa);
        // once the running max has settled, alpha is 1 for whole warps
        if (!__all_sync(kFullMask, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
          }
        }
      }
      my_turn();
      issue_pv(o, pa, n_tiles - 1);
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&v_empty[(n_tiles - 1) % kKVStages]);
    }

    bf16* ob = static_cast<bf16*>(p.o) + b * p.o_stride[0] +
               h * p.o_stride[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = r0 + 8 * hr;
      if (qi >= p.sq) continue;
      const float den = fmaxf(l[hr], 1e-30f);
      bf16* orow = ob + qi * p.o_stride[1] + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * hr] / den, o[4 * j + 2 * hr + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane

// xor butterflies: every lane ends with the same, bit-identical value
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const Params p) {
  constexpr int kPerLane = D >= 32 ? D / 32 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_tile = reinterpret_cast<float*>(smem);
  float* v_tile = k_tile + kBlockK * D;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / p.group;
  const int q0 = blockIdx.x * kBlockQ;
  const int row0 = q0 + warp * kRowsPerWarp;
  const bool lane_on = D >= 32 || lane < D;  // D=16 uses half the lanes

  const float* qb =
      static_cast<const float*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const float* kb = static_cast<const float*>(p.k) + b * p.k_stride[0] +
                    hk * p.k_stride[2];
  const float* vb = static_cast<const float*>(p.v) + b * p.v_stride[0] +
                    hk * p.v_stride[2];
  float* ob = static_cast<float*>(p.o) + b * p.o_stride[0] + h * p.o_stride[2];

  float qr[kRowsPerWarp][kPerLane];
  float acc[kRowsPerWarp][kPerLane];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = row0 + r;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      qr[r][e] =
          (qi < p.sq && lane_on) ? qb[qi * p.q_stride[1] + lane + 32 * e] : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  int kv_lo, kv_hi;
  visible_keys(q0, min(q0 + kBlockQ, p.sq) - 1, p, &kv_lo, &kv_hi);

  for (int tile = kv_lo / kBlockK; tile * kBlockK < kv_hi; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int kj = k0 + j;
      const bool in = kj < p.sk;  // ragged tail: zeros, masked below
      k_tile[i] = in ? kb[kj * p.k_stride[1] + d] : 0.f;
      v_tile[i] = in ? vb[kj * p.v_stride[1] + d] : 0.f;
    }
    __syncthreads();
    if (row0 >= p.sq) continue;  // warp-uniform; barriers still reached

    // s[r] on lane j: the raw score of query row0+r against key k0+j
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float kv[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        kv[e] = lane_on ? k_tile[j * D + lane + 32 * e] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) part = fmaf(qr[r][e], kv[e], part);
        part = warp_sum(part);
        if (lane == j) s[r] = part;
      }
    }

    const int kj = k0 + lane;
    float pv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = row0 + r;
      const float x = visible(qi, kj, p) ? capped(s[r], p) : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float m_safe = fmaxf(m_new, kMaxFloor);
      pv[r] = expf(x - m_safe);
      const float alpha = expf(fmaxf(m[r], kMaxFloor) - m_safe);
      l[r] = l[r] * alpha + warp_sum(pv[r]);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[r][e] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        vv[e] = lane_on ? v_tile[j * D + lane + 32 * e] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFullMask, pv[r], j);
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = row0 + r;
    if (qi >= p.sq || !lane_on) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      ob[qi * p.o_stride[1] + lane + 32 * e] = acc[r][e] / den;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a kernel must opt in, once per
// device: `done` holds this kernel's flags (the attribute call costs far
// more than a launch).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, bool (&done)[kMaxDevices],
                        size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Launch on the caller's stream, one block per block_q query rows.
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool (&done)[kMaxDevices], size_t smem,
                   int block_q, int threads, const Params& p, int batch,
                   int heads, cudaStream_t stream) {
  const cudaError_t err = opt_in_smem(kernel, done, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + block_q - 1) / block_q, heads, batch);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 [B, S, H, D] tensor with element strides (batch, seq, head) as a
// 4-D tensor map over (D, H, S, B), boxes of 64 x 1 x rows x 1 (128 bytes
// along D), 128-byte swizzle, zeros past every edge. The stride of a dim
// of size 1 is never used; it is set to a valid value.
bool bhsd_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
              int batch, const long long* stride, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const long long elems[3] = {stride[2], stride[1], stride[0]};
  cuuint64_t strides[3];  // bytes, of dims 1..3
  cuuint64_t extent = 2ull * d;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? (extent + 15) / 16 * 16
                                  : static_cast<cuuint64_t>(elems[i]) * 2;
    extent = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  using T = WgTile<D>;
  const int heads = p.kv_heads * p.group;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!bhsd_map(&tm_q, p.q, D, heads, p.sq, p.batch, p.q_stride,
                kWgBlockQ) ||
      !bhsd_map(&tm_k, p.k, D, p.kv_heads, p.sk, p.batch, p.k_stride,
                T::kBN) ||
      !bhsd_map(&tm_v, p.v, D, p.kv_heads, p.sk, p.batch, p.v_stride,
                T::kBN))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      opt_in_smem(flash_attention_wgmma_kernel<D>, done, T::kSmem);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>(
      (p.sq + kWgBlockQ - 1) / kWgBlockQ) * p.batch * heads;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  flash_attention_wgmma_kernel<D>
      <<<static_cast<unsigned>(ctas), kWgThreads, T::kSmem, stream>>>(
          tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  return launch(flash_attention_mma_kernel<D>, done, mma_smem_bytes<D>(),
                kMmaBlockQ, kMmaThreads, p, p.batch, p.kv_heads * p.group,
                stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  return launch(flash_attention_f32_kernel<D>, done,
                2 * kBlockK * D * sizeof(float), kBlockQ, kThreads, p,
                p.batch, p.kv_heads * p.group, stream);
}

// bf16 rows start on 16-byte boundaries: 8 elements are 16 bytes
bool rows_aligned(const void* ptr, const long long* strides) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && strides[0] % 8 == 0 &&
         strides[1] % 8 == 0 && strides[2] % 8 == 0;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. strides: 12 element strides, the
// batch, seq and head strides of q, k, v and o in that order; o's seq
// stride must be even (the bf16 kernels store pairs), and q, k and v rows
// must start on 16-byte boundaries (tiles load 16 bytes at a time). The
// route: bfloat16 at head_dim 64, 128 or 256 -> the wgmma kernel, at 16 or
// 32 -> the mma.sync kernel; float32 at any of the five -> the CUDA-core
// kernel. Anything else is cudaErrorInvalidValue.
extern "C" int repro_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, const long long* strides, int batch, int heads, int kv_heads,
    int sq, int sk, int causal, int window, float scale, float cap,
    void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || batch <= 0 || sq <= 0)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.batch = batch;
  p.kv_heads = kv_heads;
  p.sq = sq;
  p.sk = sk;
  p.group = heads / kv_heads;
  for (int i = 0; i < 3; ++i) {
    p.q_stride[i] = strides[i];
    p.k_stride[i] = strides[3 + i];
    p.v_stride[i] = strides[6 + i];
    p.o_stride[i] = strides[9 + i];
  }
  if (dtype == 0 && (reinterpret_cast<uintptr_t>(o) % 4 != 0 ||
                     p.o_stride[0] % 2 != 0 || p.o_stride[1] % 2 != 0 ||
                     p.o_stride[2] % 2 != 0))
    return cudaErrorInvalidValue;
  if (dtype == 0 &&
      !(rows_aligned(q, strides) && rows_aligned(k, strides + 3) &&
        rows_aligned(v, strides + 6)))
    return cudaErrorInvalidValue;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_mma<16>(p, st);
      case 32: return launch_mma<32>(p, st);
      case 64: return launch_wgmma<64>(p, st);
      case 128: return launch_wgmma<128>(p, st);
      case 256: return launch_wgmma<256>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (head_dim) {
    case 16: return launch_f32<16>(p, st);
    case 32: return launch_f32<32>(p, st);
    case 64: return launch_f32<64>(p, st);
    case 128: return launch_f32<128>(p, st);
    case 256: return launch_f32<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
