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
// Two kernels, chosen by dtype:
//
// * bfloat16 (the serve path): tensor cores through mma.sync m16n8k16
//   (bf16 in, float32 accumulate; a bf16 product is exact in float32, so
//   q.k is the float32 dot of the widened inputs up to summation order).
//   A block of 4 warps owns 64 query rows, 16 per warp; the Q tile and a
//   64-key K and V tile sit in shared memory (rows padded by 8 elements so
//   ldmatrix hits 32 distinct banks; V is read transposed by ldmatrix
//   .trans). Each warp computes its 16x64 score tile, runs the online
//   softmax on the accumulator fragments (a row is spread over the 4 lanes
//   of a quad), and feeds p, rounded to bf16, straight from registers
//   into the p.v products. A warp skips a tile that is masked for all its
//   rows and does no mask arithmetic on a tile visible to all of them.
//   What bounds it here: mma.sync issues at a fraction of the wgmma rate,
//   the K/V tiles are loaded synchronously (no overlap with the math), and
//   the float32 accumulator of 256 columns caps a block at 2 per SM by
//   registers. wgmma, TMA with a ring of tiles and warp specialisation are
//   the way to the bound, in a later change.
// * float32 (tests and small models): CUDA cores. A block of 4 warps
//   stages 32-key K and V tiles in shared memory; each warp owns 4 rows,
//   lane i holds elements i, i+32, ... of q and acc, dot products are
//   reduced with warp shuffles and lane j keeps the score of key j.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kMaxFloor = -1.0e30f;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, sk, group;
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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, fragments by ldmatrix)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlockQ = kMmaWarps * 16;  // 16 query rows per warp
constexpr int kMmaBlockK = 64;              // keys per KV tile
constexpr int kPad = 8;                     // bf16 elements of row padding

typedef __nv_bfloat16 bf16;

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

// two floats -> bf16x2, round to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// tanh from one exponential: absolute error ~1e-7, so cap * tanh is off
// by ~5e-6 at cap 50, far below the bf16 output rounding
__device__ __forceinline__ float fast_tanh(float y) {
  return 1.f - 2.f / (__expf(2.f * y) + 1.f);
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

// Launch on the caller's stream. Above 48 KB of dynamic shared memory the
// kernel must opt in, once per device: `done` holds this kernel's flags
// (the attribute call costs far more than a launch).
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool (&done)[kMaxDevices], size_t smem,
                   int block_q, int threads, const Params& p, int batch,
                   int heads, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || !done[dev]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) done[dev] = true;
    }
  }
  const dim3 grid((p.sq + block_q - 1) / block_q, heads, batch);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_for_dim(int dtype, const Params& p, int batch, int heads,
                           cudaStream_t stream) {
  static bool mma_done[kMaxDevices] = {};
  static bool f32_done[kMaxDevices] = {};
  if (dtype == 0)
    return launch(flash_attention_mma_kernel<D>, mma_done,
                  mma_smem_bytes<D>(), kMmaBlockQ, kMmaThreads, p, batch,
                  heads, stream);
  return launch(flash_attention_f32_kernel<D>, f32_done,
                2 * kBlockK * D * sizeof(float), kBlockQ, kThreads, p, batch,
                heads, stream);
}

// bf16 rows start on 16-byte boundaries: 8 elements are 16 bytes
bool rows_aligned(const void* ptr, const long long* strides) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && strides[0] % 8 == 0 &&
         strides[1] % 8 == 0 && strides[2] % 8 == 0;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. strides: 12 element strides, the
// batch, seq and head strides of q, k, v and o in that order; o's seq
// stride must be even (the bf16 kernel stores pairs), and q, k and v rows
// must start on 16-byte boundaries (tiles load 16 bytes at a time).
extern "C" int repro_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, const long long* strides, int batch, int heads, int kv_heads,
    int sq, int sk, int causal, int window, float scale, float cap,
    void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  switch (head_dim) {
    case 16: return launch_for_dim<16>(dtype, p, batch, heads, st);
    case 32: return launch_for_dim<32>(dtype, p, batch, heads, st);
    case 64: return launch_for_dim<64>(dtype, p, batch, heads, st);
    case 128: return launch_for_dim<128>(dtype, p, batch, heads, st);
    case 256: return launch_for_dim<256>(dtype, p, batch, heads, st);
    default: return cudaErrorInvalidValue;
  }
}
