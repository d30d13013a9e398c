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
// Bound on this card. The recurrence costs 5 P N operations per token and
// head (decay, outer-product update, read-out); at the serve path's shapes
// (mamba2-1.3b prefill, B=2, S=4000, H=64, P=64, N=128, bf16) that is
// 21.0 GFLOP against 141 MB of inputs and outputs. In float32, which the
// reference computes and the port's parity needs (no TF32), the 67 TFLOP/s
// of the CUDA cores give 0.31 ms and the bytes 0.042 ms: the bound is the
// operations.
//
// Rethought for this card. The TPU kernel walks the chunks of one (b, h)
// in order with the state in VMEM, and spends each chunk on the chunked
// ("dual") form's [Q,Q] and [Q,N]x[N,P] MXU products. Without float32
// tensor cores, that form costs more than the recurrence itself: per token
// and head Q N + Q P + 4 N P operations against 5 N P, twice as many at
// Q=256, N=128, P=64; and its 256 x 256 score tile would not fit in shared
// memory. So here one block owns one (b, h) and runs the recurrence, the
// chunk loop becoming a loop over time inside the block, with the whole
// [P, N] state in registers: a thread holds 2 rows of P and N/8 (or N/4)
// columns of N, updates them with one multiply and one fused multiply-add
// each, and the threads of a row pair sum its read-out with warp shuffles.
// Time is staged in tiles of 64 steps: dt, the decay, x dt, B and C of a
// tile are loaded into shared memory once, in float32, and y goes back
// out a tile at a time. B and C are read per group (the TPU index map's
// h -> h / rep, with no broadcast copy). B x H = 128 blocks fill the card
// in one wave at the serve shapes. What bounds this design is instruction
// issue (two instructions per state element and step, and the shared
// memory reads of B and C) and the serial tile loads; the result does not
// depend on the TPU kernel's chunk size, only the rounding does. Ragged
// S needs no padding: the loop runs to S.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 64;       // time steps staged in shared memory
constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

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
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int N>
struct Layout {
  static constexpr int kGroup = N >= 32 ? 8 : 4;  // threads of a row pair
  static constexpr int kPer = N / kGroup;          // state columns a thread
  static constexpr int kVec = kPer / 4;            // float4s of B or C
};

size_t smem_bytes(int p_dim, int n) {
  return sizeof(float) * (2 * kSteps * p_dim + 2 * kSteps * n + 2 * kSteps);
}

template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads) ssd_scan_kernel(const Params p) {
  constexpr int kGroup = Layout<N>::kGroup;
  constexpr int kPer = Layout<N>::kPer;
  constexpr int kVec = Layout<N>::kVec;
  const int P = p.p_dim;
  extern __shared__ __align__(16) float smem[];
  float* s_xdt = smem;               // [kSteps][P]: x dt
  float* s_y = s_xdt + kSteps * P;   // [kSteps][P]
  float* s_b = s_y + kSteps * P;     // [kSteps][N]
  float* s_c = s_b + kSteps * N;     // [kSteps][N]
  float* s_dt = s_c + kSteps * N;    // [kSteps]
  float* s_decay = s_dt + kSteps;    // [kSteps]

  const int tid = threadIdx.x;
  const int q = tid % kGroup;     // this thread's columns: 4 (q + kGroup j) + e
  const int pair = tid / kGroup;  // this thread's rows: 2 pair, 2 pair + 1
  // threads past the last row pair (P = 8) compute on row 0 and write
  // nothing: every lane of a warp takes part in the shuffles
  const bool active = 2 * pair < P;
  const int p0 = active ? 2 * pair : 0;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int grp = h / p.rep;
  const float a = p.a[h];

  const T* xb = static_cast<const T*>(p.x) + bi * p.x_stride[0] +
                h * p.x_stride[2];
  const float* dtb = p.dt + bi * p.dt_stride[0] + h;
  const T* bb = static_cast<const T*>(p.b) + bi * p.b_stride[0] +
                grp * p.b_stride[2];
  const T* cb = static_cast<const T*>(p.c) + bi * p.c_stride[0] +
                grp * p.c_stride[2];
  T* yb = static_cast<T*>(p.y) + bi * p.y_stride[0] + h * p.y_stride[2];

  float st[2][kPer];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < kPer; ++k) st[r][k] = 0.f;

  for (int t0 = 0; t0 < p.seq; t0 += kSteps) {
    const int len = min(kSteps, p.seq - t0);
    __syncthreads();  // the previous tile's y is written out
    for (int i = tid; i < len; i += blockDim.x) {
      const float d = dtb[(t0 + i) * p.dt_stride[1]];
      s_dt[i] = d;
      s_decay[i] = expf(d * a);
    }
    for (int i = tid; i < len * N; i += blockDim.x) {
      const int t = i / N;
      const int n = i % N;
      s_b[i] = to_f32(bb[(t0 + t) * p.b_stride[1] + n]);
      s_c[i] = to_f32(cb[(t0 + t) * p.c_stride[1] + n]);
    }
    __syncthreads();
    for (int i = tid; i < len * P; i += blockDim.x) {
      const int t = i / P;
      const int pp = i % P;
      s_xdt[i] = to_f32(xb[(t0 + t) * p.x_stride[1] + pp]) * s_dt[t];
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      const float decay = s_decay[t];
      const float xd0 = s_xdt[t * P + p0];
      const float xd1 = s_xdt[t * P + p0 + 1];
      const float4* bv = reinterpret_cast<const float4*>(s_b + t * N);
      const float4* cv = reinterpret_cast<const float4*>(s_c + t * N);
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float4 bj = bv[q + kGroup * j];
        const float4 cj = cv[q + kGroup * j];
        const float bn[4] = {bj.x, bj.y, bj.z, bj.w};
        const float cn[4] = {cj.x, cj.y, cj.z, cj.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s0 = st[0][4 * j + e];
          float& s1 = st[1][4 * j + e];
          s0 = fmaf(s0, decay, bn[e] * xd0);
          s1 = fmaf(s1, decay, bn[e] * xd1);
          y0 = fmaf(s0, cn[e], y0);
          y1 = fmaf(s1, cn[e], y1);
        }
      }
#pragma unroll
      for (int o = 1; o < kGroup; o <<= 1) {
        y0 += __shfl_xor_sync(kFullMask, y0, o);
        y1 += __shfl_xor_sync(kFullMask, y1, o);
      }
      if (q == 0 && active) {
        s_y[t * P + p0] = y0;
        s_y[t * P + p0 + 1] = y1;
      }
    }
    __syncthreads();
    for (int i = tid; i < len * P; i += blockDim.x) {
      const int t = i / P;
      const int pp = i % P;
      yb[(t0 + t) * p.y_stride[1] + pp] = from_f32<T>(s_y[i]);
    }
  }

  if (!active) return;
  float* sb = p.state + (static_cast<long long>(bi) * p.heads + h) * P * N;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sb[(p0 + r) * N + 4 * (q + kGroup * j) + e] = st[r][4 * j + e];
}

constexpr int kMaxDevices = 64;

// Launch on the caller's stream. Above 48 KB of dynamic shared memory the
// kernel must opt in, once per device and instance: `done` holds its flags.
template <typename T, int N>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  auto kernel = ssd_scan_kernel<T, N>;
  const size_t smem = smem_bytes(p.p_dim, N);
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
  const int pairs = p.p_dim / 2 * Layout<N>::kGroup;
  const int threads = (pairs + 31) / 32 * 32;
  const dim3 grid(p.heads, batch);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_n(int n, const Params& p, int batch,
                         cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
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
      groups <= 0 || heads % groups != 0)
    return cudaErrorInvalidValue;
  if (p_dim != 8 && p_dim != 16 && p_dim != 64) return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_for_n<bf16>(n_dim, p, batch, st);
  if (dtype == 1) return launch_for_n<float>(n_dim, p, batch, st);
  return cudaErrorInvalidValue;
}
