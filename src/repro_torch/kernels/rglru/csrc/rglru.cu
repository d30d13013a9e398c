// RG-LRU linear-recurrence scan for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_blocked` in
// repro/kernels/rglru/kernel.py and computes what it computes, in float32:
//   h_t = a_t h_{t-1} + b_t,  a_t = exp(log_a_t),
//   b_t = sqrt(max(-expm1(2 log_a_t), 1e-12)) gated_t,  h_{-1} = 0,
// over log_a, gated [B, S, W] into h [B, S, W]. The recurrence is diagonal:
// every channel is its own chain of S dependent steps.
//
// Bound on this card. There is no matrix work: per element and step an
// exp, an expm1, a sqrt and two multiply-adds against 12 bytes of traffic
// (two float32 inputs read, one output written). At the serve path's
// shapes (recurrentgemma-9b prefill, B=2, S=3000, W=4096) that is 294.9 MB,
// 0.088 ms at 3.35 TB/s; the arithmetic is far below the card's rate. So
// the bound is device memory.
//
// Rethought for blocks that run in parallel. The TPU kernel walks the
// sequence blocks of a channel block in order and carries h in VMEM. One
// thread per (batch, channel) would give 8,192 chains here, about two
// warps an SM, each walking 3,000 dependent steps: latency, not bandwidth,
// would bound it. So a block owns 32 channels (one warp-wide, coalesced
// row of each time step) and cuts the sequence into 16 chunks, one warp
// each; 2 x 128 blocks of 16 warps fill the 132 SMs in one wave.
//   1. Each thread runs its chunk from h = 0 and keeps the chunk's
//      composition: the product of its a (A) and its final h (B), so that
//      h_end = A h_start + B, which is what the TPU kernel's in-block
//      doubling scan composes.
//   2. One warp carries h across the 16 chunks of its channels in shared
//      memory: h_start[c] = A[c-1] h_start[c-1] + B[c-1].
//   3. Each thread runs its chunk again from its h_start and writes h.
// The inputs are read twice (the second read mostly misses L2 at these
// sizes): 491 MB of traffic against the 295 MB bound, for a kernel with no
// look-back protocol between blocks. Within a chunk the steps are the
// reference's own sequential multiply-adds; a chunk's start differs from
// the sequential value by the rounding of one composition. The ragged
// tails of S and W are masked (the TPU kernel asserts S % bs == 0 and
// W % bw == 0).
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;   // channels of a block
constexpr int kChunks = 16;  // sequence chunks of a block, one warp each

struct Params {
  const float* log_a;
  const float* gated;
  float* h;
  // batch and seq strides, in elements; the channel dim has stride 1
  long long la_stride[2], g_stride[2], h_stride[2];
  int seq, width;
};

__device__ __forceinline__ void coeffs(float log_a, float gated, float* a,
                                       float* b) {
  *a = expf(log_a);
  *b = sqrtf(fmaxf(-expm1f(2.f * log_a), 1e-12f)) * gated;
}

__global__ void __launch_bounds__(kLanes * kChunks)
    rglru_scan_kernel(const Params p) {
  // per chunk and channel: first the chunk's decay product A, then the
  // chunk's starting h; and the chunk's h from h = 0 (B)
  __shared__ float s_a[kChunks][kLanes];
  __shared__ float s_b[kChunks][kLanes];

  const int lane = threadIdx.x;
  const int chunk = threadIdx.y;
  const int w = blockIdx.x * kLanes + lane;
  const int b = blockIdx.y;
  const bool on = w < p.width;
  const int len = (p.seq + kChunks - 1) / kChunks;
  const int t0 = min(p.seq, chunk * len);
  const int t1 = min(p.seq, t0 + len);

  const float* la = p.log_a + b * p.la_stride[0] + (on ? w : 0);
  const float* g = p.gated + b * p.g_stride[0] + (on ? w : 0);

  // 1. the chunk's composition
  float prod = 1.f, h = 0.f;
  if (on) {
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      float a, bt;
      coeffs(la[t * p.la_stride[1]], g[t * p.g_stride[1]], &a, &bt);
      h = a * h + bt;
      prod *= a;
    }
  }
  s_a[chunk][lane] = prod;
  s_b[chunk][lane] = h;
  __syncthreads();

  // 2. carry across the chunks, in order
  if (chunk == 0) {
    float carry = 0.f;
    for (int c = 0; c < kChunks; ++c) {
      const float pa = s_a[c][lane];
      const float pb = s_b[c][lane];
      s_a[c][lane] = carry;
      carry = pa * carry + pb;
    }
  }
  __syncthreads();

  // 3. the chunk again, from its true start
  if (!on) return;
  h = s_a[chunk][lane];
  float* out = p.h + b * p.h_stride[0] + w;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    float a, bt;
    coeffs(la[t * p.la_stride[1]], g[t * p.g_stride[1]], &a, &bt);
    h = a * h + bt;
    out[t * p.h_stride[1]] = h;
  }
}

}  // namespace

// log_a, gated, h: float32 [batch, seq, width] with the channel dim of
// stride 1; strides: 6 element strides, the batch and seq strides of
// log_a, gated and h in that order.
extern "C" int repro_rglru_scan(const float* log_a, const float* gated,
                                float* h, const long long* strides, int batch,
                                int seq, int width, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0 || batch > 65535)
    return cudaErrorInvalidValue;
  Params p;
  p.log_a = log_a;
  p.gated = gated;
  p.h = h;
  for (int i = 0; i < 2; ++i) {
    p.la_stride[i] = strides[i];
    p.g_stride[i] = strides[2 + i];
    p.h_stride[i] = strides[4 + i];
  }
  p.seq = seq;
  p.width = width;
  const dim3 grid((width + kLanes - 1) / kLanes, batch);
  const dim3 block(kLanes, kChunks);
  rglru_scan_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
