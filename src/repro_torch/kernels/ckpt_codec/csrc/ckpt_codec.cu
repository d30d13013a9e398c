// Delta-int8 checkpoint codec for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces the Pallas TPU kernels `encode_tiles` (`_encode_kernel`) and
// `decode_tiles` (`_decode_kernel`) of repro/kernels/ckpt_codec/kernel.py
// and computes, bit for bit, what their numpy oracle
// repro/kernels/ckpt_codec/ref.py computes, per tile of 1024 elements:
//   encode: d = f32(new) - f32(base); scale = max(max|d| / 127, 1e-12);
//           q = int8(clip(round_half_even(d / scale), -127, 127))
//   decode: out = cast(f32(base) + f32(q) * scale)
// Every operation is one IEEE float32 operation rounded to nearest, in the
// oracle's order: the divisions, the product and the sum are written with
// the `_rn` intrinsics, so that nvcc neither contracts `base + q * scale`
// into one fused multiply-add (numpy rounds twice) nor replaces a division
// by an approximation. `rintf` rounds half to even, as np.round does. The
// cast to bfloat16 rounds to nearest even; the cast to int32 truncates
// toward zero, as numpy's astype does. bfloat16 inputs widen exactly
// (bits << 16).
//
// Inputs and outputs are flat arrays of n elements in float32, bfloat16
// or int32 (the training state: bf16 parameters, float32 moments, the
// int32 step). A ragged last tile reads zeros past n and writes nothing
// there, which is what the oracle's zero padding of new and base gives.
//
// Bound on this card. Per element the encode reads new and base and
// writes one byte (plus a float32 scale a tile); the decode reads a byte
// and base and writes the output. A handful of float32 operations an
// element is far below the card's rate, so device memory bounds both: the
// bf16 embedding shard of gemma2-9b (64000 x 3584) encodes in no less than
// 1.15 GB / 3.35 TB/s = 0.34 ms.
//
// Design. The TPU kernel takes one (1, 1024) block a grid step and reduces
// it in VMEM. Here one block of 256 threads owns one tile: each thread
// loads 4 consecutive elements of each input with one vector load (16
// bytes for float32, 8 for bfloat16) when they are in range and aligned,
// the tile's max |d| is reduced across the warp by shuffles and across the
// 8 warps through shared memory, and each thread writes its 4 codes as
// one 4-byte store. The tiles are independent, so the grid of n / 1024
// blocks needs no second pass.
//
// Interface: plain C functions, loaded with ctypes. They launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;  // elements a thread
constexpr int kWarps = kThreads / 32;

// dtype codes of the wrapper (ops.py _DTYPES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI32 = 2;

template <int DT>
__device__ __forceinline__ float elem(const void* p, long long i) {
  if constexpr (DT == kF32) {
    return static_cast<const float*>(p)[i];
  } else if constexpr (DT == kBF16) {
    const uint16_t b = static_cast<const uint16_t*>(p)[i];
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  } else {
    return __int2float_rn(static_cast<const int*>(p)[i]);
  }
}

// v[k] = element e0 + k as float32, 0 past n
template <int DT>
__device__ __forceinline__ void load4(const void* p, long long e0,
                                      long long n, bool vec, float v[kPer]) {
  if (vec && e0 + kPer <= n) {
    if constexpr (DT == kF32) {
      const float4 x = *reinterpret_cast<const float4*>(
          static_cast<const float*>(p) + e0);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else if constexpr (DT == kBF16) {
      const uint2 x = *reinterpret_cast<const uint2*>(
          static_cast<const uint16_t*>(p) + e0);
      v[0] = __uint_as_float(x.x << 16);
      v[1] = __uint_as_float(x.x & 0xffff0000u);
      v[2] = __uint_as_float(x.y << 16);
      v[3] = __uint_as_float(x.y & 0xffff0000u);
    } else {
      const int4 x = *reinterpret_cast<const int4*>(
          static_cast<const int*>(p) + e0);
      v[0] = __int2float_rn(x.x); v[1] = __int2float_rn(x.y);
      v[2] = __int2float_rn(x.z); v[3] = __int2float_rn(x.w);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    v[k] = e0 + k < n ? elem<DT>(p, e0 + k) : 0.0f;
}

template <int DT>
__device__ __forceinline__ void store4(void* p, long long e0, long long n,
                                       bool vec, const float v[kPer]) {
  if constexpr (DT == kF32) {
    float* o = static_cast<float*>(p);
    if (vec && e0 + kPer <= n) {
      *reinterpret_cast<float4*>(o + e0) = make_float4(v[0], v[1], v[2],
                                                       v[3]);
      return;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (e0 + k < n) o[e0 + k] = v[k];
  } else if constexpr (DT == kBF16) {
    uint16_t b[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      b[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k]));
    uint16_t* o = static_cast<uint16_t*>(p);
    if (vec && e0 + kPer <= n) {
      *reinterpret_cast<uint2*>(o + e0) = make_uint2(
          b[0] | (static_cast<uint32_t>(b[1]) << 16),
          b[2] | (static_cast<uint32_t>(b[3]) << 16));
      return;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (e0 + k < n) o[e0 + k] = b[k];
  } else {
    int* o = static_cast<int*>(p);
    int w[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) w[k] = __float2int_rz(v[k]);
    if (vec && e0 + kPer <= n) {
      *reinterpret_cast<int4*>(o + e0) = make_int4(w[0], w[1], w[2], w[3]);
      return;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (e0 + k < n) o[e0 + k] = w[k];
  }
}

template <int DN, int DB>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const void* __restrict__ new_p, int new_vec,
                  const void* __restrict__ base_p, int base_vec, long long n,
                  int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float warp_max[kWarps];
  const long long tile = blockIdx.x;
  const long long e0 = tile * kTile + threadIdx.x * kPer;
  float nv[kPer], bv[kPer], d[kPer];
  load4<DN>(new_p, e0, n, new_vec, nv);
  load4<DB>(base_p, e0, n, base_vec, bv);
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    d[k] = __fsub_rn(nv[k], bv[k]);
    m = fmaxf(m, fabsf(d[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  const float s = fmaxf(__fdiv_rn(m, 127.0f), 1e-12f);
  char4 out;
  int8_t* c = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(d[k], s)), -127.0f), 127.0f);
    c[k] = static_cast<int8_t>(__float2int_rz(r));
  }
  *reinterpret_cast<char4*>(q + tile * kTile + threadIdx.x * kPer) = out;
  if (threadIdx.x == 0) scale[tile] = s;
}

template <int DB, int DO>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  const void* __restrict__ base_p, int base_vec, long long n,
                  void* __restrict__ out_p, int out_vec) {
  const long long tile = blockIdx.x;
  const long long e0 = tile * kTile + threadIdx.x * kPer;
  const char4 qv = *reinterpret_cast<const char4*>(q + tile * kTile +
                                                   threadIdx.x * kPer);
  const int8_t* c = reinterpret_cast<const int8_t*>(&qv);
  const float s = scale[tile];
  float bv[kPer], o[kPer];
  load4<DB>(base_p, e0, n, base_vec, bv);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    o[k] = __fadd_rn(bv[k], __fmul_rn(static_cast<float>(c[k]), s));
  store4<DO>(out_p, e0, n, out_vec, o);
}

bool bad_code(int c) { return c < kF32 || c > kI32; }

template <int DN, int DB>
void launch_encode(const void* new_p, int new_vec, const void* base_p,
                   int base_vec, long long n, int8_t* q, float* scale,
                   cudaStream_t st) {
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  encode_kernel<DN, DB><<<tiles, kThreads, 0, st>>>(new_p, new_vec, base_p,
                                                    base_vec, n, q, scale);
}

template <int DB, int DO>
void launch_decode(const int8_t* q, const float* scale, const void* base_p,
                   int base_vec, long long n, void* out_p, int out_vec,
                   cudaStream_t st) {
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  decode_kernel<DB, DO><<<tiles, kThreads, 0, st>>>(q, scale, base_p,
                                                    base_vec, n, out_p,
                                                    out_vec);
}

}  // namespace

// The pair of dtype codes selects one of nine instances.
#define CODEC_PAIRS(X) \
  X(0, 0) X(0, 1) X(0, 2) X(1, 0) X(1, 1) X(1, 2) X(2, 0) X(2, 1) X(2, 2)

extern "C" int repro_ckpt_encode(const void* new_p, int new_dtype,
                                 int new_vec, const void* base_p,
                                 int base_dtype, int base_vec, long long n,
                                 int8_t* q, float* scale, void* stream) {
  if (n <= 0 || (n + kTile - 1) / kTile > 0x7fffffffLL ||
      bad_code(new_dtype) || bad_code(base_dtype))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (new_dtype * 3 + base_dtype) {
#define ENC(a, b)                                                        \
  case a * 3 + b:                                                        \
    launch_encode<a, b>(new_p, new_vec, base_p, base_vec, n, q, scale,   \
                        st);                                             \
    break;
    CODEC_PAIRS(ENC)
#undef ENC
  }
  return cudaGetLastError();
}

extern "C" int repro_ckpt_decode(const int8_t* q, const float* scale,
                                 const void* base_p, int base_dtype,
                                 int base_vec, long long n, void* out_p,
                                 int out_dtype, int out_vec, void* stream) {
  if (n <= 0 || (n + kTile - 1) / kTile > 0x7fffffffLL ||
      bad_code(base_dtype) || bad_code(out_dtype))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (base_dtype * 3 + out_dtype) {
#define DEC(a, b)                                                        \
  case a * 3 + b:                                                        \
    launch_decode<a, b>(q, scale, base_p, base_vec, n, out_p, out_vec,   \
                        st);                                             \
    break;
    CODEC_PAIRS(DEC)
#undef DEC
  }
  return cudaGetLastError();
}
