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
// map. Here a CTA owns a BM-row output tile (BM divides bt, so the whole
// tile has one expert), reads its expert id itself, and loops over D in K
// tiles. Tiles are rastered in groups of row tiles that walk the column
// tiles together, so the row tiles of one expert read each weight tile at
// about the same time and share it through L2, and the group's x rows stay
// in L2 while its column tiles go by.
//
// Bound on this card, from the run's routing and real rows only. grok-1's
// prefill (about 12,000 rows, D=6144, F=32768, 8 experts) does 4.8 TFLOP on
// 4.2 GB: operations, 4.9 ms at 989 TFLOP/s. arctic's (the same rows over
// 128 experts, D=7168, F=4864) does 0.84 TFLOP on 9.2 GB of weights: bytes,
// 2.75 ms at 3.35 TB/s. A decode step (a few rows) reads the weights of the
// experts it touches: bytes.
//
// Three kernels, chosen by dtype and bt (the route; ops.py's `gmm_route`
// states the same rule):
//
// * "wgmma", bfloat16 with bt a multiple of 64 (every prefill): the Hopper
//   design, from the building blocks of ../../csrc/hopper.cuh. Persistent:
//   one CTA per SM walks the 128 x 256 output tiles (64 x 256 when bt is
//   64) in the grouped raster, its group as many row tiles as an expert
//   holds on average (at most 16): grok-1's 12 row tiles an expert share
//   each weight tile through L2; arctic's ~1 runs the column tiles of one
//   row tile side by side, sharing its x rows (with 16, each column tile
//   re-read its x rows from HBM). Warpgroup 0 is the producer: one thread
//   keeps a 4-stage ring of 64-deep K tiles full by TMA (x through a 2-D
//   map over [T, D], 16 KB a stage; w through a 3-D map over (F, D, E), the
//   expert the outer coordinate, four 64-column boxes, 32 KB a stage;
//   128-byte swizzle, zeros past D and F), with "full" and "empty"
//   mbarriers per stage. Warpgroups 1 and 2 consume: 64 x 256 each (rows
//   split) for a 128-row tile, 64 x 128 each (columns split) for a 64-row
//   one, by SS wgmma with x K-major and w MN-major through the transpose
//   bit, one group of products kept in flight while the next stage is
//   waited on. The epilogue rounds to bf16 and stores from registers while
//   the producer already loads the next tile. A tile of a -1 block loads
//   nothing and stores zeros. setmaxnreg hands the producer's registers to
//   the consumers (40 / 232).
// * "mma_sync", bfloat16 with bt an odd multiple of 16 or 32 (decode steps
//   and small groups, where the weights' bytes bound the kernel): tensor
//   cores through mma.sync m16n8k16 (bf16 in, float32 accumulate),
//   fragments by ldmatrix (x's tile as A, w's [K, N] tile transposed by
//   ldmatrix .trans as B), tiles staged in shared memory by cp.async in a
//   ring of 3 stages (rows padded by 8 elements so ldmatrix hits distinct
//   banks), 32 x 128 or 16 x 128 per CTA, 32-deep K tiles.
// * "f32", float32 (parity runs): CUDA cores in full float32 (no TF32),
//   16 x 64 tiles, 32-deep K tiles in shared memory, each thread 2 rows x
//   4 columns of fmaf in K order.
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

typedef __nv_bfloat16 bf16;

constexpr int kBN = 128;     // output columns per CTA (bf16)
constexpr int kBK = 32;      // K depth of a staged tile
constexpr int kStages = 3;   // cp.async ring
constexpr int kPad = 8;      // bf16 elements of row padding in shared memory
constexpr int kGroupM = 16;  // row tiles rastered together, at most

struct Params {
  const void* x;
  const void* w;
  const int* block_expert;
  void* out;
  int t, d, f, e, bt;
  int group_m;            // row tiles rastered together (<= kGroupM)
  long long x_stride;     // row stride of x, elements
  long long w_stride[2];  // expert and row strides of w
  long long o_stride;     // row stride of out
};

// tile -> (row tile, column tile), grouped raster (see the header)
__device__ __forceinline__ void tile_coords(const Params& p, int pid, int bm,
                                            int bn, int* m_blk, int* n_blk) {
  const int num_m = p.t / bm;
  const int num_n = (p.f + bn - 1) / bn;
  const int per_group = p.group_m * num_n;
  const int first = (pid / per_group) * p.group_m;
  const int size = min(num_m - first, p.group_m);
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
// bfloat16, bt an odd multiple of 16 or 32: tensor cores through mma.sync
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
  tile_coords(p, blockIdx.x, BM, kBN, &mb, &nb);
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
// bfloat16, bt a multiple of 64: wgmma fed by TMA, persistent and
// warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // a producer warpgroup and two consumers
constexpr int kWgBN = 256;       // output columns per tile
constexpr int kWgBK = 64;        // K depth of a stage: 128 bytes of x rows
constexpr int kWgStages = 4;

template <int BM>
struct WgTile {
  static constexpr int kABytes = BM * kWgBK * 2;  // x: BM rows of 128 B
  static constexpr int kBChunk = kWgBK * 128;     // w: 64 k rows x 64 cols
  static constexpr int kBBytes = kWgBN / 64 * kBChunk;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // a consumer's columns: all 256 of a 128-row tile (rows split), half of
  // a 64-row tile's (columns split)
  static constexpr int kCols = BM == 128 ? kWgBN : kWgBN / 2;
  // 1024 bytes of slack to align the ring, then the ring and 8 barriers
  static constexpr size_t kSmem = 1024 + kWgStages * kStageBytes + 64;
};

template <int BM>
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const Params p) {
  using T = WgTile<BM>;
  static_assert(BM == 64 || BM == 128, "row tile");
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: every tile starts on one
  unsigned char* ring =
      smem_raw + (1024 - hopper::smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kWgStages * T::kStageBytes);
  uint64_t* empty = full + kWgStages;

  const int num_m = p.t / BM;
  const int num_n = (p.f + kWgBN - 1) / kWgBN;
  const int tiles = num_m * num_n;
  const int n_k = (p.d + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages filled so far, over every tile
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mb, nb;
        tile_coords(p, tile, BM, kWgBN, &mb, &nb);
        const int m0 = mb * BM;
        const int n0 = nb * kWgBN;
        const int expert = p.block_expert[m0 / p.bt];
        if (expert < 0 || expert >= p.e) continue;  // zeros: nothing to load
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kWgStages;
          // the consumers' release of this stage's previous round (a fresh
          // barrier passes parity 1 at once)
          hopper::mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], T::kStageBytes);
          unsigned char* a = ring + s * T::kStageBytes;
          unsigned char* b = a + T::kABytes;
          hopper::tma_load_2d(a, &tm_x, &full[s], kt * kWgBK, m0);
          for (int c = 0; c < kWgBN / 64; ++c)
            hopper::tma_load_3d(b + c * T::kBChunk, &tm_w, &full[s],
                                n0 + 64 * c, kt * kWgBK, expert);
        }
      }
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    // this consumer's part of a tile, in rows and bytes of a stage
    const int row_off = BM == 128 ? 64 * c : 0;
    const int col_off = BM == 128 ? 0 : T::kCols * c;
    const uint32_t a_off = row_off * 128;
    const uint32_t b_off = T::kABytes + col_off / 64 * T::kBChunk;
    bf16* out = static_cast<bf16*>(p.out);
    int it = 0;  // stages consumed so far, over every tile
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int mb, nb;
      tile_coords(p, tile, BM, kWgBN, &mb, &nb);
      const int m0 = mb * BM;
      const int n0 = nb * kWgBN;
      const int expert = p.block_expert[m0 / p.bt];

      // accumulator (j, hr, cc): row 16 warp + g + 8 hr, column
      // 8 j + 2 t4 + cc of this consumer's part, at index 4 j + 2 hr + cc
      float acc[T::kCols / 2];
#pragma unroll
      for (int i = 0; i < T::kCols / 2; ++i) acc[i] = 0.f;
      if (expert >= 0 && expert < p.e) {
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kWgStages;
          hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
          const uint32_t stage = hopper::smem_u32(ring + s * T::kStageBytes);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWgBK / 16; ++kk)
            hopper::wgmma_ss<T::kCols, 1>(
                acc, hopper::desc_k_major(stage + a_off + kk * 32),
                hopper::desc_mn_major(stage + b_off + kk * 16 * 128,
                                      T::kBChunk),
                1);
          hopper::wgmma_commit();
          // the previous stage's products are done: release it
          hopper::wgmma_wait<1>();
          if (kt > 0) hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
      }

      const int r = m0 + row_off + 16 * warp + g;  // and r + 8 (< T)
#pragma unroll
      for (int j = 0; j < T::kCols / 8; ++j) {
        const int col = n0 + col_off + 8 * j + 2 * t4;
        if (col >= p.f) continue;  // F is even: col + 1 < F
        *reinterpret_cast<uint32_t*>(out + r * p.o_stride + col) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(out + (r + 8) * p.o_stride + col) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
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
  tile_coords(p, blockIdx.x, kFBM, kFBN, &mb, &nb);
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, bool (&done)[kMaxDevices], size_t smem,
                   int threads, long long ctas, const Params& p,
                   cudaStream_t stream) {
  if (ctas <= 0 || ctas > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = opt_in_smem(kernel, done, smem);
  if (err != cudaSuccess) return err;
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

// A bf16 tensor map of `rank` dims (innermost first, byte strides of dims
// 1.. in `strides`), boxes `box`, 128-byte swizzle, zeros past every edge.
bool tiled_map(CUtensorMap* map, const void* ptr, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM>
cudaError_t launch_wgmma(Params p, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  using T = WgTile<BM>;
  // Row tiles rastered together: as many as an expert's group holds on
  // average (the buffer's row tiles over E), so that they share each
  // weight tile through L2 while it is read (grok-1: 12); with about one
  // row tile an expert (arctic) the column tiles of one row tile run side
  // by side instead and share its x rows, each weight tile read once.
  const int per_expert = p.t / BM / p.e;
  p.group_m = per_expert < 1 ? 1 : per_expert > kGroupM ? kGroupM
                                                        : per_expert;
  // x: (D, T) in boxes of 64 x BM; w: (F, D, E) in boxes of 64 x 64 x 1
  // (the expert stride of a single expert is never used; any valid one)
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(p.d),
                                static_cast<cuuint64_t>(p.t)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(p.x_stride) * 2};
  const cuuint32_t x_box[2] = {64, BM};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(p.f),
                                static_cast<cuuint64_t>(p.d),
                                static_cast<cuuint64_t>(p.e)};
  const cuuint64_t w_row = static_cast<cuuint64_t>(p.w_stride[1]) * 2;
  const cuuint64_t w_strides[2] = {
      w_row, p.e == 1 ? w_row * p.d
                      : static_cast<cuuint64_t>(p.w_stride[0]) * 2};
  const cuuint32_t w_box[3] = {64, 64, 1};
  CUtensorMap tm_x, tm_w;
  if (!tiled_map(&tm_x, p.x, 2, x_dims, x_strides, x_box) ||
      !tiled_map(&tm_w, p.w, 3, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const long long tiles =
      static_cast<long long>(p.t / BM) * ((p.f + kWgBN - 1) / kWgBN);
  if (tiles <= 0 || tiles > INT_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = opt_in_smem(gmm_wgmma_kernel<BM>, done, T::kSmem);
  if (err != cudaSuccess) return err;
  const int ctas = static_cast<int>(tiles < sms ? tiles : sms);
  gmm_wgmma_kernel<BM><<<ctas, kWgThreads, T::kSmem, stream>>>(tm_x, tm_w,
                                                               p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x, w and out all of it). strides: the
// row stride of x, the expert and row strides of w, the row stride of out,
// in elements (the last dim has stride 1). bt must be a multiple of 16 and
// divide t. bfloat16 also needs d and f multiples of 8, 16-byte aligned x
// and w, strides of x and w multiples of 8 and an even stride of out. The
// route: bfloat16 with bt a multiple of 64 -> the wgmma kernel (128-row
// tiles when bt is a multiple of 128, else 64), other multiples of 16 ->
// the mma.sync kernel; float32 -> the CUDA-core kernel.
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
  p.group_m = kGroupM;
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
  if (bt % 128 == 0) return launch_wgmma<128>(p, st);
  if (bt % 64 == 0) return launch_wgmma<64>(p, st);
  if (bt % 32 == 0) return launch_mma<32, 2, 2>(p, st);
  return launch_mma<16, 1, 4>(p, st);
}
