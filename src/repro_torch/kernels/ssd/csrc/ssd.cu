// Mamba2 SSD (state-space duality) scan for Hopper (sm_90a), written by
// hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_bhsp` in
// repro/kernels/ssd/kernel.py and computes what it computes, in float32:
// for every batch row b and head h (group g = h / (H/G)), with the state
// h_t [P, N] starting at 0,
//   h_t = exp(dt_t a_h) h_{t-1} + (x_t dt_t) B_t^T,   y_t = h_t C_t,
// over x [B, S, H, P], dt [B, S, H], a [H], B and C [B, S, G, N]; it
// writes y [B, S, H, P] in x's dtype and the final state [B, H, P, N] in
// float32 (the model's layout; the TPU kernel emits [B, H, N, P] and its
// wrapper transposes).
//
// Bound on this card. Run step by step, the recurrence costs 5 P N
// operations per token and head (decay, outer-product update, read-out).
// This kernel runs most steps in a rescaled form of 4 P N, two fused
// multiply-adds an element and step, which no exact form undercuts (the
// chunked form adds its intra-chunk products to the same two). At the
// serve path's shapes (mamba2-1.3b prefill, B=2, S=4000, H=64, P=64,
// N=128, bf16) that is 16.8 GFLOP against 141 MB of inputs and outputs.
// In float32, which the reference computes and the port's parity needs
// (no TF32), the 67 TFLOP/s of the CUDA cores give 0.25 ms and the bytes
// 0.042 ms: the bound is the operations, so the design is about the
// instructions issued beside the multiply-adds and the stalls between
// them.
//
// Why not the TPU's chunked form. The TPU kernel walks the chunks of one
// (b, h) in order with the state in VMEM and spends each chunk on the
// ("dual") form's [Q,Q] and [Q,N]x[N,P] MXU products. Without float32
// tensor cores that form costs more than the recurrence itself (Q N + Q P
// + 4 N P against 4 N P per token and head), so this kernel runs the
// recurrence, the chunk loop becoming a loop over time inside the block.
//
// The design (each choice measured against its alternatives on the card;
// PERF.md, section 6):
// * A thread holds a 4 x 8 block of the state (4 rows of P, 8 columns of
//   N) in registers. Each value of B and C it reads feeds 4 rows, each
//   value of x dt 8 columns: per step one 16-byte shared-memory load for
//   each of B, C (bf16, converted where read) and x dt, for 64 fused
//   multiply-adds. (One row of 32 columns a thread read a value per
//   multiply-add and was bound by the shared-memory pipe; converting B
//   and C to float32 once a tile doubled those loads and lost more than
//   the conversions it saved; 8 x 8 blocks left one warp a scheduler.)
// * Blocks: one per (row block of up to 32 rows of P, head, batch row); at
//   the serve shape 2 x 64 x 2 = 256 blocks of 128 threads (8 row groups x
//   16 column groups), two resident an SM, so all 132 SMs work. The 16
//   threads of a row group are 16 lanes of one warp.
// * A ring of asynchronous tile copies: three stages of 32 steps of x, dt,
//   B and C, in their own dtype, filled with 16-byte cp.async (4-byte for
//   dt, whose steps are H apart) two tiles ahead of the compute, so tile
//   k+2 arrives while tile k is computed. Rows that are not 16-byte
//   aligned (any stride the wrapper takes) fall back to plain loads into
//   the same ring. One pass over an arrived tile computes the decays and
//   w = x dt (over L_t, below) in float32, one more writes y out, 8 rows a
//   16-byte store: three block barriers a tile.
// * The rescaled recurrence. Within a run of 16 steps, with L_t =
//   exp(a sum dt) over the run's steps so far and s0 the state before the
//   run, h_t = L_t (s0 + sum_{k<=t} (x_k dt_k / L_k) B_k^T). So the kernel
//   keeps g_t = h_t / L_t: one fused multiply-add an element and step
//   updates it, one more reads y_t / L_t out, y_t is scaled by L_t once
//   per row, and the state is multiplied back by L once per run: 2 + 1/16
//   instructions per element and step against 3 (a build without the
//   rescaled form ran 7% slower at the serve shape; PERF.md, section 6).
//   A run whose L leaves [1e-18, 1e18] (dt a below about -2.6 a step over
//   the run) takes the step-by-step form, h = h exp(dt a) + (x dt) B,
//   instead; the branch is uniform over the block, since dt and a are per
//   (b, h). Full runs are compiled without the masks of a ragged tail.
// * The read-out: a thread sums its 8 columns for each of its rows, and
//   the 16 lanes of a row group reduce the partial sums of 4 steps at
//   once, in 4 rounds of shuffles that halve the values a lane keeps (15
//   shuffles for 16 sums); each batch's reduction is issued after the
//   next batch's multiply-adds, so its latency hides under them.
// Rounding: the result does not depend on the TPU kernel's chunk size;
// the rescaled form rounds w_k = (x dt)_k / L_k and the products with L,
// within float32's relative error of the sequential scan. Ragged S needs
// no padding: a tile's loop runs to its length.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // time steps of a ring stage
constexpr int kStages = 3;     // ring depth: tiles k, k+1, k+2
constexpr int kR = 4;          // a thread's rows of the state
constexpr int kC = 8;          // and its columns
constexpr int kBatch = 4;      // steps whose read-outs are reduced together
constexpr int kMaxRows = 32;   // rows of P a block (P = 64 takes two)
// the rescale rule, decided here alone, run by run
constexpr int kRun = 16;       // steps under one rescale
constexpr float kMinScale = 1e-18f;
constexpr float kMaxScale = 1e18f;

typedef __nv_bfloat16 bf16;

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* state;
  // batch, seq and head (group) strides in elements; last dims stride 1
  long long x_stride[3], dt_stride[2], b_stride[3], c_stride[3],
      y_stride[3];
  int seq, heads, rep, p_dim;
  int vec_x, vec_bc, vec_y;  // rows of x, B and C, y are 16-byte aligned
};

// 8 consecutive values from shared memory, as float32 (16-byte aligned)
__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

template <int R>
__device__ __forceinline__ void load_rows(const float* src, float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(src)[i];
    v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

// 8 consecutive values to device memory, in 16-byte stores if `vec`
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8],
                                      int vec) {
  if (vec) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b2);
    }
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8],
                                      int vec) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = v[i];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The G lanes of a row group (lane bits below G) hold V partial sums
// each. Each round with a lane mask M keeps half of the values (the upper
// half where the lane's bit M is set), adds the partner's copy of them,
// and passes on the other half; once one value is left, the remaining
// rounds add it whole. On return a lane holds max(V / G, 1) complete sums,
// of the values `first` on.
template <int M, int NV, int V>
__device__ __forceinline__ void reduce_rows(float (&v)[V], int lane,
                                            unsigned mask, int& first) {
  if constexpr (M >= 1) {
    if constexpr (NV > 1) {
      constexpr int H = NV / 2;
      const bool upper = lane & M;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float keep = upper ? v[H + i] : v[i];
        const float send = upper ? v[i] : v[H + i];
        v[i] = keep + __shfl_xor_sync(mask, send, M);
      }
      if (upper) first += H;
      reduce_rows<M / 2, H, V>(v, lane, mask, first);
    } else {
      v[0] += __shfl_xor_sync(mask, v[0], M);
      reduce_rows<M / 2, 1, V>(v, lane, mask, first);
    }
  }
}

// Shared memory of one block, in bytes: the ring of raw tiles, then the
// float32 buffers of the tile being computed.
template <typename T, int N, int kRows>
struct Layout {
  static constexpr int kChunks = kRows / 8;  // 8-row chunks of a step
  static constexpr int kColGroups = N / kC;  // lanes of a row group
  static constexpr int kThreads = kRows / kR * kColGroups;
  static constexpr int kXBytes = kTile * kRows * sizeof(T);
  static constexpr int kBBytes = kTile * N * sizeof(T);
  static constexpr int kStageBytes = kXBytes + 2 * kBBytes + kTile * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kFloats = 2 * kTile * kRows  // w, y
                                 + 2 * kTile        // decay, y's scale
                                 + kTile / kRun;    // run flags
  static constexpr int kBytes = kRingBytes + 4 * kFloats;
  static_assert(kColGroups <= 32 && kRows % kR == 0, "row groups");
  static_assert(kC % 8 == 0 && kR % 4 == 0 && kRun % kBatch == 0,
                "blocks");
  static_assert(kRows * sizeof(T) % 16 == 0, "16-byte rows of x");
  static_assert(kStageBytes % 16 == 0, "16-byte stages");
};

// Issue the copies of one tile (steps t0 .. t0+len) into a ring stage.
template <typename T, int N, int kRows>
__device__ __forceinline__ void load_tile(const Params& p, uint8_t* stage,
                                          const T* xb, const float* dtb,
                                          const T* bb, const T* cb, int t0,
                                          int len, int tid) {
  using L = Layout<T, N, kRows>;
  constexpr int kPerChunk = 16 / sizeof(T);
  constexpr int kXChunks = kRows / kPerChunk;  // 16-byte chunks of a row
  constexpr int kBChunks = N / kPerChunk;
  T* sx = reinterpret_cast<T*>(stage);
  T* sb = reinterpret_cast<T*>(stage + L::kXBytes);
  T* sc = reinterpret_cast<T*>(stage + L::kXBytes + L::kBBytes);
  float* sdt = reinterpret_cast<float*>(stage + L::kXBytes + 2 * L::kBBytes);
  const long long xs = p.x_stride[1], bs = p.b_stride[1],
                  cs = p.c_stride[1];
  if (p.vec_x) {
    for (int i = tid; i < len * kXChunks; i += L::kThreads) {
      const int r = i / kXChunks, e = (i % kXChunks) * kPerChunk;
      cp_async16(sx + r * kRows + e, xb + (t0 + r) * xs + e);
    }
  } else {
    for (int i = tid; i < len * kRows; i += L::kThreads) {
      const int r = i / kRows, e = i % kRows;
      sx[i] = xb[(t0 + r) * xs + e];
    }
  }
  if (p.vec_bc) {
    for (int i = tid; i < len * kBChunks; i += L::kThreads) {
      const int r = i / kBChunks, e = (i % kBChunks) * kPerChunk;
      cp_async16(sb + r * N + e, bb + (t0 + r) * bs + e);
      cp_async16(sc + r * N + e, cb + (t0 + r) * cs + e);
    }
  } else {
    for (int i = tid; i < len * N; i += L::kThreads) {
      const int r = i / N, e = i % N;
      sb[i] = bb[(t0 + r) * bs + e];
      sc[i] = cb[(t0 + r) * cs + e];
    }
  }
  for (int i = tid; i < len; i += L::kThreads)
    cp_async4(sdt + i, dtb + (t0 + i) * p.dt_stride[1]);
}

// The step loop of one run (steps r0 .. r1 of the tile) for one thread:
// batches of kBatch steps, each followed by the shuffle reduction of the
// previous batch's read-outs, so that the reduction's latency hides under
// the next batch's multiply-adds. Steps past r1 (a ragged tail) run with
// w = 0, B = 0 and decay 1, which leaves the state as it is, and store
// nothing.
template <typename T, int N, int kRows, int G>
struct Steps {
  static constexpr int kV = kBatch * kR;  // read-outs of a batch
  const float* w_rows;  // s_w + the thread's first row
  const T* b_cols;      // the ring's B + the thread's first column
  const T* c_cols;
  const float* decay;
  float* y_rows;        // s_y + the thread's first row
  int cg;
  unsigned mask;

  template <bool kRescaled, bool kFull>
  __device__ __forceinline__ void batch(float (&st)[kR][kC],
                                        float (&acc)[kV], int t,
                                        int r1) const {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = kFull || t + u < r1;
      float w[kR], bn[kC], cn[kC];
      load_rows(w_rows + (t + u) * kRows, w);
#pragma unroll
      for (int j = 0; j < kC / 8; ++j) {
        load8(b_cols + (t + u) * N + 8 * j,
              *reinterpret_cast<float(*)[8]>(bn + 8 * j));
        load8(c_cols + (t + u) * N + 8 * j,
              *reinterpret_cast<float(*)[8]>(cn + 8 * j));
      }
      if constexpr (!kFull) {
#pragma unroll
        for (int r = 0; r < kR; ++r) w[r] = live ? w[r] : 0.f;
#pragma unroll
        for (int j = 0; j < kC; ++j) bn[j] = live ? bn[j] : 0.f;
      }
      float* au = acc + u * kR;
      if constexpr (kRescaled) {
        // g += w B; y / L = g . C
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          au[r] = 0.f;
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            st[r][j] = fmaf(w[r], bn[j], st[r][j]);
            au[r] = fmaf(st[r][j], cn[j], au[r]);
          }
        }
      } else {
        // step by step: h = h decay + (x dt) B, y = h . C
        const float d = live ? decay[t + u] : 1.f;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          au[r] = 0.f;
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            st[r][j] = fmaf(st[r][j], d, w[r] * bn[j]);
            au[r] = fmaf(st[r][j], cn[j], au[r]);
          }
        }
      }
    }
  }

  // reduce a batch's read-outs over the G lanes of the row group and
  // store the row sums of its live steps
  __device__ __forceinline__ void reduce(float (&acc)[kV], int t,
                                         int r1) const {
    int first = 0;
    reduce_rows<G / 2, kV, kV>(acc, cg, mask, first);
    constexpr int kHeld = kV / G > 1 ? kV / G : 1;
    if (G <= kV || (cg & 1) == 0) {
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int u = (first + i) / kR, r = (first + i) % kR;
        if (t + u < r1) y_rows[(t + u) * kRows + r] = acc[i];
      }
    }
  }

  // kFull: r1 = r0 + kRun, no step to mask
  template <bool kRescaled, bool kFull>
  __device__ __forceinline__ void run(float (&st)[kR][kC], int r0,
                                      int r1) const {
    float acc[kV];
    batch<kRescaled, kFull>(st, acc, r0, r1);
    for (int t = r0 + kBatch; t < r1; t += kBatch) {
      float next[kV];
      batch<kRescaled, kFull>(st, next, t, r1);
      reduce(acc, t - kBatch, r1);
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = next[i];
    }
    reduce(acc, r0 + (r1 - 1 - r0) / kBatch * kBatch, r1);
  }
};

template <typename T, int N, int kRows>
__global__ void __launch_bounds__(Layout<T, N, kRows>::kThreads)
    ssd_scan_kernel(const Params p) {
  using L = Layout<T, N, kRows>;
  constexpr int kThreads = L::kThreads;
  constexpr int G = L::kColGroups;
  constexpr int kChunks = L::kChunks;
  constexpr unsigned kMask =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1u;
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_w = reinterpret_cast<float*>(smem + L::kRingBytes);  // [kTile][kRows]
  float* s_y = s_w + kTile * kRows;          // [kTile][kRows]
  float* s_decay = s_y + kTile * kRows;      // [kTile]
  float* s_scale = s_decay + kTile;  // [kTile]: L_t, or 1 step by step
  int* s_ok = reinterpret_cast<int*>(s_scale + kTile);  // [kTile / kRun]

  const int tid = threadIdx.x;
  const int cg = tid % G;           // this thread's columns: kC cg + j
  const int rg = tid / G;           // and rows: kR rg + r
  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int grp = h / p.rep;
  const float a = p.a[h];

  const T* xb = static_cast<const T*>(p.x) + bi * p.x_stride[0] +
                h * p.x_stride[2] + row0;
  const float* dtb = p.dt + bi * p.dt_stride[0] + h;
  const T* bb = static_cast<const T*>(p.b) + bi * p.b_stride[0] +
                grp * p.b_stride[2];
  const T* cb = static_cast<const T*>(p.c) + bi * p.c_stride[0] +
                grp * p.c_stride[2];
  T* yb = static_cast<T*>(p.y) + bi * p.y_stride[0] + h * p.y_stride[2] +
          row0;

  float st[kR][kC];  // [row][column]
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kC; ++j) st[r][j] = 0.f;

  const int tiles = (p.seq + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      load_tile<T, N, kRows>(p, smem + s * L::kStageBytes, xb, dtb, bb, cb,
                             s * kTile, min(kTile, p.seq - s * kTile), tid);
    cp_async_commit();
  }

  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kTile;
    const int len = min(kTile, p.seq - t0);
    cp_async_wait<kStages - 2>();
    // tile k has arrived; the previous tile's y is out and its buffers
    // and ring stage are free
    __syncthreads();
    {
      const int nk = k + kStages - 1;
      if (nk < tiles)
        load_tile<T, N, kRows>(p, smem + (nk % kStages) * L::kStageBytes,
                               xb, dtb, bb, cb, nk * kTile,
                               min(kTile, p.seq - nk * kTile), tid);
      cp_async_commit();
    }
    const uint8_t* stage = smem + (k % kStages) * L::kStageBytes;
    const T* sx = reinterpret_cast<const T*>(stage);
    const T* sb = reinterpret_cast<const T*>(stage + L::kXBytes);
    const T* sc = reinterpret_cast<const T*>(stage + L::kXBytes + L::kBBytes);
    const float* sdt =
        reinterpret_cast<const float*>(stage + L::kXBytes + 2 * L::kBBytes);
    // One pass over (step, 8 rows): the run's L_t = exp(a sum dt) so far
    // and at its end (the same sums in the same order in every thread),
    // whether the run is rescaled, and w = x dt, over L_t if it is.
    for (int i = tid; i < len * kChunks; i += kThreads) {
      const int t = i / kChunks, c8 = (i % kChunks) * 8;
      const int start = t - t % kRun;
      const int end = min(start + kRun, len);
      float dts[kRun];
      load_rows(sdt + start, dts);
      float sum = 0.f, run_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const float d = start + j < end ? dts[j] : 0.f;
        run_sum += d;
        if (start + j <= t) sum = run_sum;
      }
      const float run_scale = expf(run_sum * a);
      const bool ok = run_scale >= kMinScale && run_scale <= kMaxScale;
      const float scale = expf(sum * a);
      const float coef = ok ? sdt[t] * (1.f / scale) : sdt[t];
      float xv[8];
      load8(sx + t * kRows + c8, xv);
      float4* w = reinterpret_cast<float4*>(s_w + t * kRows + c8);
      w[0] = make_float4(xv[0] * coef, xv[1] * coef, xv[2] * coef,
                         xv[3] * coef);
      w[1] = make_float4(xv[4] * coef, xv[5] * coef, xv[6] * coef,
                         xv[7] * coef);
      if (c8 == 0) {
        s_decay[t] = expf(sdt[t] * a);
        s_scale[t] = ok ? scale : 1.f;
        if (t == start) s_ok[t / kRun] = ok;
      }
    }
    __syncthreads();

    const Steps<T, N, kRows, G> steps{s_w + rg * kR, sb + cg * kC,
                                      sc + cg * kC, s_decay, s_y + rg * kR,
                                      cg, kMask};
    for (int r0 = 0; r0 < len; r0 += kRun) {
      const int r1 = min(r0 + kRun, len);
      const bool full = r1 - r0 == kRun;
      if (s_ok[r0 / kRun]) {
        if (full)
          steps.template run<true, true>(st, r0, r1);
        else
          steps.template run<true, false>(st, r0, r1);
        const float scale = s_scale[r1 - 1];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int j = 0; j < kC; ++j) st[r][j] *= scale;
      } else if (full) {
        steps.template run<false, true>(st, r0, r1);
      } else {
        steps.template run<false, false>(st, r0, r1);
      }
    }
    __syncthreads();

    // y, scaled by L_t in a rescaled run, in x's dtype, 8 rows a store
    for (int i = tid; i < len * kChunks; i += kThreads) {
      const int t = i / kChunks, c8 = (i % kChunks) * 8;
      float v[8];
      load_rows(s_y + t * kRows + c8, v);
      const float scale = s_scale[t];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= scale;
      store8(yb + (t0 + t) * p.y_stride[1] + c8, v, p.vec_y);
    }
  }
  cp_async_wait<0>();

  float* out = p.state +
               ((static_cast<long long>(bi) * p.heads + h) * p.p_dim + row0 +
                rg * kR) * N +
               cg * kC;
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kC / 4; ++j)
      reinterpret_cast<float4*>(out + r * N)[j] =
          make_float4(st[r][4 * j], st[r][4 * j + 1], st[r][4 * j + 2],
                      st[r][4 * j + 3]);
}

constexpr int kMaxDevices = 64;

// Launch on the caller's stream. Above 48 KB of dynamic shared memory the
// kernel must opt in, once per device and instance: `done` holds its flags.
template <typename T, int N, int kRows>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<T, N, kRows>;
  static bool done[kMaxDevices] = {};
  auto kernel = ssd_scan_kernel<T, N, kRows>;
  if (L::kBytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || !done[dev]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::kBytes);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) done[dev] = true;
    }
  }
  const dim3 grid(p.p_dim / kRows, p.heads, batch);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_for_p(const Params& p, int batch, cudaStream_t stream) {
  switch (p.p_dim) {
    case 8: return launch<T, N, 8>(p, batch, stream);
    case 16: return launch<T, N, 16>(p, batch, stream);
    case 64: return launch<T, N, kMaxRows>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_for_n(int n, const Params& p, int batch,
                         cudaStream_t stream) {
  switch (n) {
    case 16: return launch_for_p<T, 16>(p, batch, stream);
    case 32: return launch_for_p<T, 32>(p, batch, stream);
    case 128: return launch_for_p<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, const long long* strides, int n,
               int itemsize) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] * itemsize % 16) return false;
  return true;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, of x, B, C and y; dt and a are
// float32. strides: 14 element strides: the batch, seq and head strides of
// x, the batch and seq strides of dt, the batch, seq and group strides of
// B and C, the batch, seq and head strides of y, in that order; the last
// dim of every tensor has stride 1, and the state [B, H, P, N] is
// contiguous. P must be 8, 16 or 64 and N 16, 32 or 128.
extern "C" int repro_ssd_scan(int dtype, const void* x, const float* dt,
                              const float* a, const void* b, const void* c,
                              void* y, float* state,
                              const long long* strides, int batch, int seq,
                              int heads, int groups, int p_dim, int n_dim,
                              void* stream) {
  if (batch <= 0 || batch > 65535 || seq <= 0 || heads <= 0 ||
      heads > 65535 || groups <= 0 || heads % groups != 0)
    return cudaErrorInvalidValue;
  if (p_dim != 8 && p_dim != 16 && p_dim != 64) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.a = a;
  p.b = b;
  p.c = c;
  p.y = y;
  p.state = state;
  for (int i = 0; i < 3; ++i) {
    p.x_stride[i] = strides[i];
    p.b_stride[i] = strides[5 + i];
    p.c_stride[i] = strides[8 + i];
    p.y_stride[i] = strides[11 + i];
  }
  p.dt_stride[0] = strides[3];
  p.dt_stride[1] = strides[4];
  p.seq = seq;
  p.heads = heads;
  p.rep = heads / groups;
  p.p_dim = p_dim;
  const int itemsize = dtype == 0 ? 2 : 4;
  p.vec_x = aligned16(x, p.x_stride, 3, itemsize);
  p.vec_bc = aligned16(b, p.b_stride, 3, itemsize) &&
             aligned16(c, p.c_stride, 3, itemsize);
  p.vec_y = aligned16(y, p.y_stride, 3, itemsize);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_for_n<bf16>(n_dim, p, batch, st);
  return launch_for_n<float>(n_dim, p, batch, st);
}
