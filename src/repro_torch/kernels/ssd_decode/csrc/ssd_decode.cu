// Mamba2 SSD single-token decode step for Hopper (sm_90a), written by hand
// in CUDA C++.
//
// Replaces no TPU kernel: JAX's decode step (repro/models/ssm.py,
// ssd_decode_step) is plain jnp, and the port ran it as eager PyTorch
// (../ref.py, ssd_decode_step) followed by a copy of the new state over
// the cache's. For every batch row b and head h (group g = h / (H/G)) it
// computes
//   h_new = h exp(dt a) + (x dt) B^T,   y = h_new C + x d_skip,
// over the state h [B, H, P, N] float32, x [B, H, P], dt [B, H] and a [H]
// float32, B and C [B, G, N] and d_skip [H], and writes h_new over h in
// place and y [B, H, P] in x's dtype.
//
// Bound on this card: bytes. Per element of the state the step does five
// float32 operations against a read and a write of 4 bytes each, about
// 0.6 operations a byte, far below the H100's ~295 (bf16) or ~20 (float32
// CUDA cores). At mamba2-1.3b's decode shape (B = 256, H = 64, P = 64,
// N = 128) one layer's state is 537 MB: 1.074 GB read and written, 0.321
// ms at 3.35 TB/s; x, y, B, C, dt, a and d_skip add 0.2%. The eager route
// made seven passes over tensors of the state's size (the outer product,
// the decay, the casts, the add, the read-out's operand, the copy).
//
// The design: one pass, each state byte read once and written once.
// * A block of up to 256 threads owns one (b, h) tile of P x N float32
//   (32 KB at P = 64, N = 128). N / 4 lanes of a warp hold a row of the
//   tile as 16-byte vectors; a thread holds P N / (4 threads) of them, all
//   loaded before the first is used, so 8 blocks an SM keep 256 KB of
//   loads in flight, enough to cover the memory's latency on 132 SMs.
// * The state is loaded and stored with streaming hints (ld.global.cs,
//   st.global.cs): each byte is touched once a step, so it should not
//   push the weights the next kernels read out of L2.
// * A thread's four columns of B and C, dt, a and d_skip are loaded once
//   for all its rows, x once a row, through the strides of the caller's
//   views (x, B and C are slices of one conv output): no copies.
// * The read-out sums a thread's four products and then the N / 4 lanes
//   of a row with shuffles; the row's first lane writes y.
// * No shared memory, TMA or tensor cores: there is no product to reuse
//   a byte in.
//
// Rounding: as the eager route, which is JAX's. With bf16 x: decay =
// expf(dt a) in float32; xdt = bf16(x bf16(dt)); upd = bf16(xdt B);
// h_new = f32(h decay) + f32(upd), two separately rounded float32
// operations (written with __fmul_rn / __fadd_rn, so nvcc does not
// contract them into one fused multiply-add); y = bf16(sum_n
// f32(bf16(h_new)) f32(C)), summed in float32 in this kernel's order, then
// y = bf16(y + bf16(x bf16(d_skip))). With float32 x the same steps round
// in float32 only. h_new is bit-identical to the eager route's; y may
// differ by its sum's order (one bf16 ulp).
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxThreads = 256;

struct Params {
  float* h;
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const void* d_skip;
  void* y;
  // element strides: h's batch and head (its rows of N are N apart, its
  // last dim stride 1), x's batch and head, dt's batch, B's and C's batch
  // and group; y [B, H, P] is contiguous
  long long h_stride[2], x_stride[2], dt_stride, b_stride[2], c_stride[2];
  int heads, rep;
  int d_float;  // d_skip is float32 (else bf16)
};

__device__ __forceinline__ float to_f(const float* p) { return *p; }
__device__ __forceinline__ float to_f(const bf16* p) {
  return __bfloat162float(*p);
}

// a float32 value rounded to T, as float32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int P, int N>
struct Layout {
  static constexpr int kVecs = P * N / 4;                // float4s a tile
  static constexpr int kThreads =
      kVecs < kMaxThreads ? kVecs : kMaxThreads;
  static constexpr int kItems = kVecs / kThreads;        // a thread's
  static constexpr int kLanes = N / 4;                   // lanes a row
  static constexpr int kRowStep = kThreads / kLanes;     // rows a pass
  static_assert(kVecs % kThreads == 0, "tile splits over the threads");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(32 % kLanes == 0, "a row's lanes lie in one warp");
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(Layout<T, P, N>::kThreads)
    ssd_decode_kernel(Params p) {
  using L = Layout<T, P, N>;
  const int tile = blockIdx.x;
  const int bi = tile / p.heads;
  const int hi = tile - bi * p.heads;
  const int gi = hi / p.rep;
  const int col = threadIdx.x % L::kLanes;  // this thread's 4 columns
  const int row0 = threadIdx.x / L::kLanes;

  float* hp = p.h + bi * p.h_stride[0] + hi * p.h_stride[1] + col * 4;
  float4 v[L::kItems];
#pragma unroll
  for (int k = 0; k < L::kItems; ++k)
    v[k] = __ldcs(reinterpret_cast<const float4*>(
        hp + (row0 + k * L::kRowStep) * N));

  const T* xp = static_cast<const T*>(p.x) + bi * p.x_stride[0] +
                hi * p.x_stride[1];
  float xv[L::kItems];
#pragma unroll
  for (int k = 0; k < L::kItems; ++k)
    xv[k] = to_f(xp + row0 + k * L::kRowStep);
  const T* bp = static_cast<const T*>(p.b) + bi * p.b_stride[0] +
                gi * p.b_stride[1] + col * 4;
  const T* cp = static_cast<const T*>(p.c) + bi * p.c_stride[0] +
                gi * p.c_stride[1] + col * 4;
  float bv[4], cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bv[j] = to_f(bp + j);
    cv[j] = to_f(cp + j);
  }
  const float dtv = p.dt[bi * p.dt_stride + hi];
  const float decay = expf(__fmul_rn(dtv, p.a[hi]));
  const float dt_t = round_to(dtv, xp);  // dt cast to x's dtype
  const float dv = round_to(
      p.d_float ? static_cast<const float*>(p.d_skip)[hi]
                : __bfloat162float(static_cast<const bf16*>(p.d_skip)[hi]),
      xp);

  float acc[L::kItems];
#pragma unroll
  for (int k = 0; k < L::kItems; ++k) {
    const float xdt = round_to(__fmul_rn(xv[k], dt_t), xp);
    float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float upd = round_to(__fmul_rn(xdt, bv[j]), xp);
      e[j] = __fadd_rn(__fmul_rn(e[j], decay), upd);
      sum = fmaf(round_to(e[j], xp), cv[j], sum);
    }
    __stcs(reinterpret_cast<float4*>(hp + (row0 + k * L::kRowStep) * N),
           make_float4(e[0], e[1], e[2], e[3]));
    acc[k] = sum;
  }
#pragma unroll
  for (int off = L::kLanes / 2; off > 0; off /= 2) {
#pragma unroll
    for (int k = 0; k < L::kItems; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (col == 0) {
    T* yp = static_cast<T*>(p.y) + (static_cast<long long>(bi) * p.heads +
                                    hi) * P;
#pragma unroll
    for (int k = 0; k < L::kItems; ++k) {
      const float ys = round_to(acc[k], xp);
      const float skip = round_to(__fmul_rn(xv[k], dv), xp);
      store(yp + row0 + k * L::kRowStep, __fadd_rn(ys, skip));
    }
  }
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, int tiles, cudaStream_t stream) {
  constexpr int threads = Layout<T, P, N>::kThreads;
  ssd_decode_kernel<T, P, N><<<tiles, threads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_for_p(int p_dim, const Params& p, int tiles,
                         cudaStream_t stream) {
  switch (p_dim) {
    case 8: return launch<T, 8, N>(p, tiles, stream);
    case 16: return launch<T, 16, N>(p, tiles, stream);
    case 64: return launch<T, 64, N>(p, tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_for_n(int p_dim, int n_dim, const Params& p, int tiles,
                         cudaStream_t stream) {
  switch (n_dim) {
    case 16: return launch_for_p<T, 16>(p_dim, p, tiles, stream);
    case 32: return launch_for_p<T, 32>(p_dim, p, tiles, stream);
    case 128: return launch_for_p<T, 128>(p_dim, p, tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, of x, B, C and y; d_dtype the same
// code for d_skip; h, dt and a are float32. strides: 9 element strides:
// h's batch and head, x's batch and head, dt's batch, B's batch and group,
// C's batch and group, in that order; the last dim of every tensor has
// stride 1, h's rows of N are N apart, h and its strides are 16-byte
// aligned, and y [B, H, P] is contiguous. P must be 8, 16 or 64 and N 16,
// 32 or 128.
extern "C" int repro_ssd_decode(int dtype, int d_dtype, float* h,
                                const void* x, const float* dt,
                                const float* a, const void* b, const void* c,
                                const void* d_skip, void* y,
                                const long long* strides, int batch,
                                int heads, int groups, int p_dim, int n_dim,
                                void* stream) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || heads % groups != 0 ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || (d_dtype != 0 && d_dtype != 1))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(h) % 16 || strides[0] % 4 ||
      strides[1] % 4)
    return cudaErrorInvalidValue;
  Params p;
  p.h = h;
  p.x = x;
  p.dt = dt;
  p.a = a;
  p.b = b;
  p.c = c;
  p.d_skip = d_skip;
  p.y = y;
  p.h_stride[0] = strides[0];
  p.h_stride[1] = strides[1];
  p.x_stride[0] = strides[2];
  p.x_stride[1] = strides[3];
  p.dt_stride = strides[4];
  p.b_stride[0] = strides[5];
  p.b_stride[1] = strides[6];
  p.c_stride[0] = strides[7];
  p.c_stride[1] = strides[8];
  p.heads = heads;
  p.rep = heads / groups;
  p.d_float = d_dtype;
  const int tiles = batch * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_for_n<bf16>(p_dim, n_dim, p, tiles, st);
  return launch_for_n<float>(p_dim, n_dim, p, tiles, st);
}
