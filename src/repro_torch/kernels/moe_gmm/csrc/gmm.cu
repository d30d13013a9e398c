// Grouped (ragged) expert matmul for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces the Pallas TPU kernel `gmm` in repro/kernels/moe_gmm/kernel.py
// and computes what it computes: x_sorted [T, D] holds tokens sorted by
// expert in groups padded to a multiple of `bt` rows, block_expert [T / bt]
// names each bt-row block's expert, and every block gives
// x_blk @ w[block_expert[i]] with float32 accumulation, rounded once to x's
// dtype. Beyond the TPU kernel: a block whose id is outside [0, E) (the
// port's layout marks trailing empty blocks -1) is skipped and its rows are
// written as zeros, and ragged tails in F and a D that is not a multiple of
// the K tile are masked (the TPU kernel asserts F % bf == 0).
//
// Rethought for blocks that run in parallel: the TPU streams one expert's
// [D, bf] tile into VMEM per grid step through a scalar-prefetched index
// map. Here each CTA owns a BM x 128 output tile (BM divides bt, so the
// whole tile has one expert), reads its expert id itself, and loops over D
// in 32-deep K tiles. CTAs are rastered in groups of 16 row tiles that walk
// the N tiles together, so the row tiles of one expert read each weight
// tile at about the same time and share it through L2, and the group's x
// rows stay in L2 while its N tiles go by.
//
// Bound on this card, from the run's routing and real rows only. grok-1's
// prefill (about 12,000 rows, D=6144, F=32768, 8 experts) does 4.8 TFLOP on
// 4.2 GB: operations, 4.9 ms at 989 TFLOP/s. arctic's (the same rows over
// 128 experts, D=7168, F=4864) does 0.84 TFLOP on 9.2 GB of weights: bytes,
// 2.75 ms at 3.35 TB/s. A decode step (a few rows) reads the weights of the
// experts it touches: bytes.
//
// Two kernels, chosen by dtype:
//
// * bfloat16 (the serve path): tensor cores through mma.sync m16n8k16 (bf16
//   in, float32 accumulate), fragments by ldmatrix (x's tile as A, w's
//   [K, N] tile transposed by ldmatrix .trans as B), tiles staged in shared
//   memory by cp.async in a ring of 3 stages (rows padded by 8 elements so
//   ldmatrix hits distinct banks). The row tile BM is the largest of 128,
//   64, 32, 16 that divides bt: 128 x 128 with 8 warps of 64 x 32 for
//   large groups, down to 16 x 128 with 4 warps of 16 x 32 for a decode
//   step or many small groups. What bounds it here: mma.sync issues at a
//   fraction of the wgmma rate, and a 32-deep K tile gives each stage
//   little work; wgmma, TMA and a persistent tile loop are later work.
// * float32 (parity runs): CUDA cores in full float32 (no TF32), 16 x 64
//   tiles, 32-deep K tiles in shared memory, each thread 2 rows x 4 columns
//   of fmaf in K order.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBN = 128;     // output columns per CTA (bf16)
constexpr int kBK = 32;      // K depth of a staged tile
constexpr int kStages = 3;   // cp.async ring
constexpr int kPad = 8;      // bf16 elements of row padding in shared memory
constexpr int kGroupM = 16;  // row tiles rastered together

struct Params {
  const void* x;
  const void* w;
  const int* block_expert;
  void* out;
  int t, d, f, e, bt;
  long long x_stride;     // row stride of x, elements
  long long w_stride[2];  // expert and row strides of w
  long long o_stride;     // row stride of out
};

// CTA -> (row tile, column tile), grouped raster (see the header)
__device__ __forceinline__ void tile_coords(const Params& p, int bm, int bn,
                                            int* m_blk, int* n_blk) {
  const int num_m = p.t / bm;
  const int num_n = (p.f + bn - 1) / bn;
  const int per_group = kGroupM * num_n;
  const int pid = blockIdx.x;
  const int first = (pid / per_group) * kGroupM;
  const int size = min(num_m - first, kGroupM);
  const int local = pid % per_group;
  *m_blk = first + local % size;
  *n_blk = local / size;
}

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

// 16 bytes global -> shared, asynchronously; zeros when !valid (src-size 0
// reads nothing, and `src` is then any valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

template <int BM>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * kStages * (BM * (kBK + kPad) + kBK * (kBN + kPad));
}

// BM rows x 128 columns per CTA, WM x WN warps
template <int BM, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
    gmm_mma_kernel(const Params p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kTileM = BM / WM;  // a warp's rows
  constexpr int kTileN = kBN / WN;  // a warp's columns
  constexpr int MI = kTileM / 16;
  constexpr int NI = kTileN / 8;
  static_assert(MI >= 1 && NI % 2 == 0, "warp tile");
  constexpr int kAStride = kBK + kPad;
  constexpr int kBStride = kBN + kPad;
  constexpr int kAStage = BM * kAStride;
  constexpr int kBStage = kBK * kBStride;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kAStage;

  int mb, nb;
  tile_coords(p, BM, kBN, &mb, &nb);
  const int m0 = mb * BM;
  const int n0 = nb * kBN;
  const int expert = p.block_expert[m0 / p.bt];
  bf16* out = static_cast<bf16*>(p.out);

  if (expert < 0 || expert >= p.e) {  // an empty block: zeros
    for (int i = threadIdx.x; i < BM * kBN / 2; i += kThreads) {
      const int r = m0 + i / (kBN / 2);
      const int c = n0 + (i % (kBN / 2)) * 2;
      if (r < p.t && c < p.f)
        *reinterpret_cast<uint32_t*>(out + r * p.o_stride + c) = 0u;
    }
    return;
  }

  const bf16* xb = static_cast<const bf16*>(p.x) + m0 * p.x_stride;
  const bf16* wb =
      static_cast<const bf16*>(p.w) + expert * p.w_stride[0] + n0;
  const int n_k = (p.d + kBK - 1) / kBK;

  // K tile kt of x's rows and w's columns into ring stage `stage`; chunks
  // past T, D or F are zero-filled (D and F are multiples of 8, so a
  // 16-byte chunk is wholly in or out)
  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    bf16* a = sA + stage * kAStage;
    bf16* b = sB + stage * kBStage;
    constexpr int kAChunks = BM * kBK / 8;
    for (int i = threadIdx.x; i < kAChunks; i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < p.t && k0 + c < p.d;
      cp_async16(a + r * kAStride + c, ok ? xb + r * p.x_stride + k0 + c : xb,
                 ok);
    }
    constexpr int kBChunks = kBK * kBN / 8;
    for (int i = threadIdx.x; i < kBChunks; i += kThreads) {
      const int r = i / (kBN / 8);
      const int c = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < p.d && n0 + c < p.f;
      cp_async16(b + r * kBStride + c,
                 ok ? wb + (k0 + r) * p.w_stride[1] + c : wb, ok);
    }
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

  // one commit group per K tile, empty ones past the end, so that
  // wait_group<kStages - 2> at step kt means tile kt has landed
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  // this lane's ldmatrix row offsets within a stage
  const int a_off = (wm * kTileM + (lane & 15)) * kAStride + (lane >> 4) * 8;
  const int b_off = (lane & 15) * kBStride + wn * kTileN + (lane >> 4) * 8;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt visible; every warp is done with kt - 1
    const int pre = kt + kStages - 1;
    if (pre < n_k) load(pre % kStages, pre);  // into kt - 1's stage
    cp_async_commit();
    const bf16* a = sA + (kt % kStages) * kAStage + a_off;
    const bf16* b = sB + (kt % kStages) * kBStage + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4<false>(af[mi], a + mi * 16 * kAStride + kk * 16);
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        uint32_t bfr[4];
        ldmatrix_x4<true>(bfr, b + kk * 16 * kBStride + ni * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_bf16(acc[mi][ni], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][ni + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): rows g and g + 8, columns 2 t and 2 t + 1
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = m0 + wm * kTileM + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int c = n0 + wn * kTileN + ni * 8 + 2 * t4;
      if (c >= p.f) continue;  // F is even: c + 1 < F
      if (r < p.t)
        *reinterpret_cast<uint32_t*>(out + r * p.o_stride + c) =
            pack_bf16(acc[mi][ni][0], acc[mi][ni][1]);
      if (r + 8 < p.t)
        *reinterpret_cast<uint32_t*>(out + (r + 8) * p.o_stride + c) =
            pack_bf16(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFBM = 16;
constexpr int kFBN = 64;
constexpr int kFBK = 32;
constexpr int kFThreads = 128;  // 16 column lanes x 8 row lanes

__global__ void __launch_bounds__(kFThreads) gmm_f32_kernel(const Params p) {
  __shared__ float sA[kFBM][kFBK + 1];
  __shared__ float sB[kFBK][kFBN];
  int mb, nb;
  tile_coords(p, kFBM, kFBN, &mb, &nb);
  const int m0 = mb * kFBM;
  const int n0 = nb * kFBN;
  const int expert = p.block_expert[m0 / p.bt];
  const int tx = threadIdx.x % 16;  // columns tx + 16 j
  const int ty = threadIdx.x / 16;  // rows ty and ty + 8
  float* out = static_cast<float*>(p.out);
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if (expert >= 0 && expert < p.e) {
    const float* xb = static_cast<const float*>(p.x) + m0 * p.x_stride;
    const float* wb =
        static_cast<const float*>(p.w) + expert * p.w_stride[0] + n0;
    for (int k0 = 0; k0 < p.d; k0 += kFBK) {
      for (int i = threadIdx.x; i < kFBM * kFBK; i += kFThreads) {
        const int r = i / kFBK;
        const int c = i % kFBK;
        sA[r][c] = (m0 + r < p.t && k0 + c < p.d)
                       ? xb[r * p.x_stride + k0 + c] : 0.f;
      }
      for (int i = threadIdx.x; i < kFBK * kFBN; i += kFThreads) {
        const int r = i / kFBN;
        const int c = i % kFBN;
        sB[r][c] = (k0 + r < p.d && n0 + c < p.f)
                       ? wb[(k0 + r) * p.w_stride[1] + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kFBK; ++kk) {
        const float a0 = sA[ty][kk];
        const float a1 = sA[ty + 8][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = sB[kk][tx + 16 * j];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + ty + 8 * i;
    if (r >= p.t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < p.f) out[r * p.o_stride + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Launch on the caller's stream. Above 48 KB of dynamic shared memory the
// kernel must opt in, once per device: `done` holds this kernel's flags.
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool (&done)[kMaxDevices], size_t smem,
                   int threads, long long ctas, const Params& p,
                   cudaStream_t stream) {
  if (ctas <= 0 || ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
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
  kernel<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int WM, int WN>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const long long ctas =
      static_cast<long long>(p.t / BM) * ((p.f + kBN - 1) / kBN);
  return launch(gmm_mma_kernel<BM, WM, WN>, done, mma_smem_bytes<BM>(),
                WM * WN * 32, ctas, p, stream);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x, w and out all of it). strides: the
// row stride of x, the expert and row strides of w, the row stride of out,
// in elements (the last dim has stride 1). bt must be a multiple of 16 and
// divide t. bfloat16 also needs d and f multiples of 8, 16-byte aligned x
// and w, strides of x and w multiples of 8 and an even stride of out.
extern "C" int repro_gmm(int dtype, const void* x, const void* w,
                         const int* block_expert, void* out,
                         const long long* strides, int t, int d, int f,
                         int e, int bt, void* stream) {
  if (t <= 0 || d <= 0 || f <= 0 || e <= 0 || bt <= 0 || bt % 16 != 0 ||
      t % bt != 0)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w = w;
  p.block_expert = block_expert;
  p.out = out;
  p.t = t;
  p.d = d;
  p.f = f;
  p.e = e;
  p.bt = bt;
  p.x_stride = strides[0];
  p.w_stride[0] = strides[1];
  p.w_stride[1] = strides[2];
  p.o_stride = strides[3];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    static bool done[kMaxDevices] = {};
    const long long ctas =
        static_cast<long long>(t / kFBM) * ((f + kFBN - 1) / kFBN);
    return launch(gmm_f32_kernel, done, 0, kFThreads, ctas, p, st);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  if (d % 8 != 0 || f % 8 != 0 || !aligned16(x) || !aligned16(w) ||
      p.x_stride % 8 != 0 || p.w_stride[0] % 8 != 0 ||
      p.w_stride[1] % 8 != 0 || p.o_stride % 2 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return cudaErrorInvalidValue;
  if (bt % 128 == 0) return launch_mma<128, 2, 4>(p, st);
  if (bt % 64 == 0) return launch_mma<64, 2, 2>(p, st);
  if (bt % 32 == 0) return launch_mma<32, 2, 2>(p, st);
  return launch_mma<16, 1, 4>(p, st);
}
