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
// the bound is device memory: the inputs must be read once, and enough
// bytes must be in flight (3.35 TB/s x ~1 us, ~25 KB an SM) to cover its
// latency.
//
// The design: a single-pass chained scan. The TPU kernel walks the
// sequence blocks of a channel block in order and carries h in VMEM; here
// blocks run in parallel, so the carry goes from block to block through
// device memory.
// * Tiles: 64 steps x 128 channels of one batch row. A block of 8 warps
//   takes one; a lane owns 4 adjacent channels (one 16-byte load a step
//   and input) and a warp 8 consecutive steps, so a thread issues its 16
//   loads of the tile at once: 64 KB in flight a block. The inputs are
//   read once, with streaming (evict-first) loads, and h is written once.
// * Compose: each thread turns its steps into (a, b) in registers and
//   composes them, A = prod a and B = h from 0; warp 0 chains the 8 warps'
//   compositions in shared memory.
// * Carry, deterministically: a block takes its start state from its
//   predecessor's (the tile 64 steps earlier, same batch row and channels)
//   inclusive end state, published in a scratch buffer: each channel's
//   value shares one 64-bit word with its ready flag, so the successor
//   polls the data itself (one L2 round trip a hand-off, no fence). It
//   always waits for that state, never combines partial aggregates, so
//   every launch rounds alike (bit-identical results).
// * Forward progress: a block takes its tile from an atomic ticket, in
//   the order sequence tile, batch row, channel tile, so it only waits on
//   a block that took its ticket earlier and is already running. The wait
//   is bounded: after kSpinLimitNs it traps, so a fault fails the launch
//   instead of hanging it.
// * Finish: each thread runs its steps from its start state, out of its
//   registers, and writes h. The chain's hand-off (128 words through L2
//   per 64 steps, 47 hand-offs at S = 3000) overlaps the other tiles'
//   loads.
// Within a warp's 8 steps the multiply-adds are the reference's own; a
// start state differs from the sequential value by the rounding of the
// compositions. Rows that are not 16-byte aligned, or W not a multiple of
// 4, take scalar loads. The ragged tails of S and W are masked (the TPU
// kernel asserts S % bs == 0 and W % bw == 0).
//
// Scratch: the wrapper allocates the ticket and the flagged carries,
// zeroed, for each launch (`repro_rglru_scratch` gives the size); the
// kernel allocates nothing.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;                     // channels a lane
constexpr int kChannels = 32 * kVec;        // channels a tile
constexpr int kWarps = 8;
constexpr int kSteps = 8;                   // steps a warp
constexpr int kTileSteps = kWarps * kSteps;  // steps a tile
constexpr unsigned long long kSpinLimitNs = 2000000000ull;  // 2 s

struct Params {
  const float* log_a;
  const float* gated;
  float* h;
  // batch and seq strides, in elements; the channel dim has stride 1
  long long la_stride[2], g_stride[2], h_stride[2];
  int batch, seq, width, channel_tiles;
  int vec;  // 16-byte aligned rows and W % 4 == 0: float4 loads
  unsigned long long* ticket;  // zero at launch
  // [tiles][kChannels], zero at launch: each tile's inclusive end state,
  // the float's bits in the low word and 1 (ready) in the high word
  unsigned long long* carry;
};

__device__ __forceinline__ void coeffs(float log_a, float gated, float* a,
                                       float* b) {
  *a = expf(log_a);
  *b = sqrtf(fmaxf(-expm1f(2.f * log_a), 1e-12f)) * gated;
}

__device__ __forceinline__ void ld_carry(const unsigned long long* ptr,
                                         unsigned long long (&v)[kVec]) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%4];\n"
               "ld.relaxed.gpu.global.v2.u64 {%2, %3}, [%4+16];\n"
               : "=l"(v[0]), "=l"(v[1]), "=l"(v[2]), "=l"(v[3])
               : "l"(ptr)
               : "memory");
}

__device__ __forceinline__ void st_carry(unsigned long long* ptr,
                                         const float (&c)[kVec]) {
  unsigned long long v[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    v[e] = (1ull << 32) | __float_as_uint(c[e]);
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};\n"
               "st.relaxed.gpu.global.v2.u64 [%0+16], {%3, %4};\n"
               :
               : "l"(ptr), "l"(v[0]), "l"(v[1]), "l"(v[2]), "l"(v[3])
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until another block has published the 4 carries at `ptr`, and
// return them; trap past the limit.
__device__ __forceinline__ void wait_carry(const unsigned long long* ptr,
                                           float (&c)[kVec]) {
  unsigned long long v[kVec];
  unsigned long long t0 = 0;
  for (;;) {
    ld_carry(ptr, v);
    if ((v[0] >> 32) & (v[1] >> 32) & (v[2] >> 32) & (v[3] >> 32)) break;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > kSpinLimitNs) {
      __trap();
    }
    __nanosleep(20);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    c[e] = __uint_as_float(static_cast<uint32_t>(v[e]));
}

__global__ void __launch_bounds__(32 * kWarps)
    rglru_chain_kernel(const Params p) {
  // per warp and channel: the warp's decay product A, then its start h
  __shared__ float s_a[kWarps][kChannels];
  __shared__ float s_b[kWarps][kChannels];  // the warp's h from 0 (B)
  __shared__ int s_ticket;

  if (threadIdx.x == 0)
    s_ticket = static_cast<int>(atomicAdd(p.ticket, 1ull));
  __syncthreads();
  const int tile = s_ticket;
  const int per_step_tile = p.batch * p.channel_tiles;
  const int stile = tile / per_step_tile;
  const int bi = (tile % per_step_tile) / p.channel_tiles;
  const int ctile = tile % p.channel_tiles;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ch = lane * kVec;               // within the tile
  const int w0 = ctile * kChannels + ch;    // within the row
  const int t0 = stile * kTileSteps + warp * kSteps;
  const float* la = p.log_a + bi * p.la_stride[0] + w0;
  const float* g = p.gated + bi * p.g_stride[0] + w0;
  float* out = p.h + bi * p.h_stride[0] + w0;

  // 1. load the thread's steps (all loads issued before any is used),
  // then turn them into (a, b); steps and channels off the end are the
  // identity a = 1, b = 0
  float av[kSteps][kVec], bv[kSteps][kVec];
  if (p.vec) {
    const bool on = w0 < p.width;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t0 + i;
      if (on && t < p.seq) {
        const float4 x = __ldcs(
            reinterpret_cast<const float4*>(la + t * p.la_stride[1]));
        const float4 y = __ldcs(
            reinterpret_cast<const float4*>(g + t * p.g_stride[1]));
        av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
        bv[i][0] = y.x; bv[i][1] = y.y; bv[i][2] = y.z; bv[i][3] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) av[i][e] = bv[i][e] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t0 + i;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const bool on = w0 + e < p.width && t < p.seq;
        av[i][e] = on ? __ldcs(la + t * p.la_stride[1] + e) : 0.f;
        bv[i][e] = on ? __ldcs(g + t * p.g_stride[1] + e) : 0.f;
      }
    }
  }
  float prod[kVec], hb[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    prod[e] = 1.f;
    hb[e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const bool live = t0 + i < p.seq;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float a, b;
      coeffs(av[i][e], bv[i][e], &a, &b);
      if (!live) {
        a = 1.f;
        b = 0.f;
      }
      av[i][e] = a;
      bv[i][e] = b;
      hb[e] = a * hb[e] + b;
      prod[e] *= a;
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    s_a[warp][ch + e] = prod[e];
    s_b[warp][ch + e] = hb[e];
  }
  __syncthreads();

  // 2. warp 0: the predecessor's end state, this tile's warps' start
  // states in order, and this tile's end state, published
  if (warp == 0) {
    float carry[kVec] = {0.f, 0.f, 0.f, 0.f};
    if (stile > 0)
      wait_carry(p.carry + (tile - per_step_tile) * kChannels + ch, carry);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float pa = s_a[w][ch + e], pb = s_b[w][ch + e];
        s_a[w][ch + e] = carry[e];
        carry[e] = pa * carry[e] + pb;
      }
    }
    st_carry(p.carry + tile * kChannels + ch, carry);
  }
  __syncthreads();

  // 3. the thread's steps from their true start, written out
  float hv[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) hv[e] = s_a[warp][ch + e];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int t = t0 + i;
#pragma unroll
    for (int e = 0; e < kVec; ++e) hv[e] = av[i][e] * hv[e] + bv[i][e];
    if (t >= p.seq) continue;
    if (p.vec) {
      if (w0 < p.width)
        __stcs(reinterpret_cast<float4*>(out + t * p.h_stride[1]),
               make_float4(hv[0], hv[1], hv[2], hv[3]));
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (w0 + e < p.width) __stcs(out + t * p.h_stride[1] + e, hv[e]);
    }
  }
}

bool aligned16(const void* ptr, const long long* strides) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && strides[0] % 4 == 0 &&
         strides[1] % 4 == 0;
}

}  // namespace

// The scratch a launch at these sizes needs, in 64-bit words, zeroed by
// the caller: the ticket, a pad word, and one word a channel of each tile.
// Returns the number of tiles, or -1 for invalid sizes.
extern "C" int repro_rglru_scratch(int batch, int seq, int width,
                                   long long* words) {
  if (batch <= 0 || seq <= 0 || width <= 0) return -1;
  const long long tiles =
      static_cast<long long>((seq + kTileSteps - 1) / kTileSteps) * batch *
      ((width + kChannels - 1) / kChannels);
  if (tiles > 0x7fffffff / kChannels) return -1;
  *words = 2 + tiles * kChannels;
  return static_cast<int>(tiles);
}

// log_a, gated, h: float32 [batch, seq, width] with the channel dim of
// stride 1; strides: 6 element strides, the batch and seq strides of
// log_a, gated and h in that order; scratch: `repro_rglru_scratch` words,
// zeroed, 16-byte aligned.
extern "C" int repro_rglru_scan(const float* log_a, const float* gated,
                                float* h, const long long* strides, int batch,
                                int seq, int width,
                                unsigned long long* scratch, void* stream) {
  long long words = 0;
  const int tiles = repro_rglru_scratch(batch, seq, width, &words);
  if (tiles < 0 || batch > 65535 || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
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
  p.batch = batch;
  p.seq = seq;
  p.width = width;
  p.channel_tiles = (width + kChannels - 1) / kChannels;
  p.vec = width % kVec == 0 && aligned16(log_a, p.la_stride) &&
          aligned16(gated, p.g_stride) && aligned16(h, p.h_stride);
  p.ticket = scratch;
  p.carry = scratch + 2;
  rglru_chain_kernel<<<tiles, 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
