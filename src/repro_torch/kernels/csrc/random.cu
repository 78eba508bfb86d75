// Counter-based random draws for Hopper (sm_90a): JAX's threefry2x32
// streams, so that a seed means on the card what it means in the
// reference.
//
//   threefry_draw   one key per row [R, 2]; element j of row r is drawn
//     from the hash of the counter pair (j >> 32, j & 0xffffffff) under
//     key r, bits1 ^ bits2 (jax/_src/prng.py:
//     _threefry_random_bits_partitionable), mapped to raw bits, uniform,
//     normal or gumbel in float32 or bfloat16.  With split_first the key
//     row is split first (jax.random.split(key)): the new key, the hash of
//     (0, 0), goes to new_keys and the draw comes from the subkey, the
//     hash of (0, 1); a replayed step advances its key on the device.
//   threefry_split  jax.random.split(key, n) for each key row: new key i
//     is the hash of (0, i).
//
// Replaces no Pallas kernel: the reference's draws are jax.random calls,
// which XLA lowers to threefry2x32 itself (prng.py: threefry2x32_p).  The
// plain version is repro_torch/random.py.
//
// The maps are XLA's on the CPU, operation for operation, so a draw here
// equals the plain version and the reference bit for bit up to the
// rounding of a fused multiply-add that the plain version emulates in
// float64: uniform is max(lo, fma(f, hi - lo, lo)) on 23 random mantissa
// bits (7 of 8 bits in bfloat16, each operation rounded to bfloat16);
// normal is sqrt(2) * erf_inv(u) with XLA's single-precision erf_inv (M.
// Giles' polynomial, branches on w = -log1p(-x^2) < 5, Horner by fmaf);
// gumbel is -log(-log(u)).  log and log1p are XLA's CPU versions (Cephes'
// polynomials, their multiply-adds fused), not CUDA's logf: the card's
// libm would differ from the reference by an ulp here and there, and an
// ulp of -log(u) near 1 is many ulp of the gumbel.  Every other product
// and sum is __fmul_rn / __fadd_rn, so nvcc contracts nothing the plain
// version keeps apart (no --use_fast_math, no __logf).
//
// Bound on the card: the hash is 20 rounds of add, rotate (one funnel
// shift) and xor plus 5 key injections, about 72 integer operations an
// element, against 4 or 2 bytes written: about 18-36 operations a byte,
// so at any size the INT32 rate (132 SMs x 64 lanes) bounds it, not the
// memory.  Design: one thread an element in a grid-stride loop, the key
// rows in registers (each thread rereads its row's 16 bytes, from L1);
// the maps add a few dozen float operations on the FP32 pipes beside the
// integer ones.  A simple kernel first: no vectorised stores, no sharing
// of the subkey between the threads of a row (with split_first each
// element hashes its row's subkey again).
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// each launcher returns the launch's CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 132 * 16;

enum Kind { kBits = 0, kUniform = 1, kNormal = 2, kGumbel = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define TF_ROUND(r)  \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

#undef TF_ROUND

// XLA's CPU log: Cephes' logf on the mantissa in [sqrt(1/2), sqrt(2)).
__device__ float xla_log(float x) {
  const bool bad = !(x > 0.f), zero = x == 0.f, inf = x == INFINITY;
  const uint32_t b = __float_as_uint(fmaxf(x, 0x1p-126f));
  float e = static_cast<float>(static_cast<int>(b >> 23) - 126);
  float m = __uint_as_float((b & 0x007FFFFFu) | 0x3F000000u);
  const bool low = m < 0x1.6a09e6p-1f;
  m = __fadd_rn(__fsub_rn(m, 1.f), low ? m : 0.f);
  e = __fsub_rn(e, low ? 1.f : 0.f);
  const float m2 = __fmul_rn(m, m), m3 = __fmul_rn(m2, m);
  float y = fmaf(fmaf(m, 0x1.204376p-4f, -0x1.d7a37p-4f), m, 0x1.de4a34p-4f);
  const float y1 = fmaf(fmaf(m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), m, -0x1.555cap-3f);
  const float y2 = fmaf(fmaf(m, 0x1.999d58p-3f, -0x1.fffff8p-3f), m, 0x1.555554p-2f);
  y = fmaf(fmaf(y, m3, y1), m3, y2);
  y = fmaf(y, m3, __fmul_rn(-0x1.bd0106p-13f, e));
  float out = __fadd_rn(__fadd_rn(__fsub_rn(m, __fmul_rn(0.5f, m2)), y), __fmul_rn(0x1.63p-1f, e));
  if (bad) out = NAN;
  if (zero) out = -INFINITY;
  if (inf) out = INFINITY;
  return out;
}

// XLA's CPU log1p: Cephes' rational approximation below sqrt(2) - 1.
__device__ float xla_log1p(float x) {
  const float num[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,
                        0x1.e798ecp+5f,  0x1.c8e75ap+5f, 0x1.40a202p+4f};
  const float den[7] = {1.f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                        0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
  float p = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    p = fmaf(p, x, num[i]);
    q = fmaf(q, x, den[i]);
  }
  const float x2 = __fmul_rn(x, x);
  float small = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
  small = __fadd_rn(x, fmaf(x2, -0.5f, small));
  return fabsf(x) < 0x1.a8279ap-2f ? small : xla_log(__fadd_rn(x, 1.f));
}

// XLA's float32 erf_inv (Giles).
__device__ float xla_erf_inv(float x) {
  const float lt[9] = {0x1.e2cb1p-26f,   0x1.70966cp-22f,  -0x1.d8e6aep-19f,
                       -0x1.26b582p-18f, 0x1.ca65b6p-13f,  -0x1.48a81p-10f,
                       -0x1.11c9dep-8f,  0x1.f91ec6p-3f,   0x1.805c5ep+0f};
  const float ge[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f,  0x1.61b8e4p-10f,
                       -0x1.e17bcep-9f,  0x1.7824f6p-8f,   -0x1.f38baep-8f,
                       0x1.354afcp-7f,   0x1.006db6p+0f,   0x1.6a9efcp+1f};
  float w = -xla_log1p(-__fmul_rn(x, x));
  const bool small = w < 5.f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.f);
  float p = small ? lt[0] : ge[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, w, small ? lt[i] : ge[i]);
  return fabsf(x) == 1.f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The uniform draw from bits1 ^ bits2: [lo, lo + diff) in float32, or in
// bfloat16 (bf16), each operation rounded to bfloat16.
__device__ __forceinline__ float uniform_of(uint32_t bits, bool bf16, float lo, float diff) {
  if (!bf16) {
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
    return fmaxf(lo, fmaf(f, diff, lo));
  }
  const uint32_t hi = (((bits & 0xFFu) >> 1) | 0x3F80u) << 16;
  const float f = bf(__fsub_rn(__uint_as_float(hi), 1.f));
  return fmaxf(lo, bf(__fadd_rn(bf(__fmul_rn(f, diff)), lo)));
}

__device__ __forceinline__ float map_bits(uint32_t bits, int kind, bool bf16, float lo,
                                          float diff) {
  const float u = uniform_of(bits, bf16, lo, diff);
  if (kind == kNormal) {
    const float e = xla_erf_inv(u);
    return bf16 ? __fmul_rn(0x1.6ap+0f, bf(e)) : __fmul_rn(0x1.6a09e6p+0f, e);
  }
  if (kind == kGumbel) {
    const float l = bf16 ? bf(xla_log(u)) : xla_log(u);
    return -(bf16 ? bf(xla_log(-l)) : xla_log(-l));
  }
  return u;
}

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const int64_t* __restrict__ keys, int64_t* __restrict__ new_keys,
                     void* __restrict__ out, long long rows, long long n, int kind, int bf16,
                     float lo, float diff, int split_first) {
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
    uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
    if (split_first) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        const uint2 nk = threefry2x32(k0, k1, 0u, 0u);
        new_keys[2 * r] = nk.x;
        new_keys[2 * r + 1] = nk.y;
      }
      const uint2 sub = threefry2x32(k0, k1, 0u, 1u);
      k0 = sub.x;
      k1 = sub.y;
    }
    for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < n;
         j += static_cast<long long>(gridDim.x) * kThreads) {
      const uint2 h = threefry2x32(k0, k1, static_cast<uint32_t>(j >> 32),
                                   static_cast<uint32_t>(j));
      const uint32_t bits = h.x ^ h.y;
      const long long i = r * n + j;
      if (kind == kBits) {
        static_cast<int64_t*>(out)[i] = bits;
      } else if (bf16) {
        static_cast<__nv_bfloat16*>(out)[i] =
            __float2bfloat16_rn(map_bits(bits, kind, true, lo, diff));
      } else {
        static_cast<float*>(out)[i] = map_bits(bits, kind, false, lo, diff);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
threefry_split_kernel(const int64_t* __restrict__ keys, int64_t* __restrict__ out, long long rows,
                      long long n) {
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
    for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < n;
         j += static_cast<long long>(gridDim.x) * kThreads) {
      const uint2 h = threefry2x32(k0, k1, static_cast<uint32_t>(j >> 32),
                                   static_cast<uint32_t>(j));
      out[2 * (r * n + j)] = h.x;
      out[2 * (r * n + j) + 1] = h.y;
    }
  }
}

dim3 grid_of(long long rows, long long n) {
  const long long bx = (n + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(bx < kMaxBlocksX ? bx : kMaxBlocksX),
              static_cast<unsigned>(rows < 65535 ? rows : 65535));
}

}  // namespace

// keys int64 [rows, 2] (uint32 words); out [rows, n]: int64 bits (kind 0),
// float32 or bfloat16 (bf16) draws; new_keys int64 [rows, 2] with
// split_first.  lo and diff: the uniform's low end and its width, already
// rounded to the draw's type.
extern "C" int threefry_draw_launch(const void* keys, void* new_keys, void* out, long long rows,
                                    long long n, int kind, int bf16, float lo, float diff,
                                    int split_first, void* stream) {
  if (rows <= 0 || n < 0 || kind < kBits || kind > kGumbel || (split_first && !new_keys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 && !split_first) return 0;
  threefry_draw_kernel<<<grid_of(rows, n > 0 ? n : 1), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<int64_t*>(new_keys), out, rows, n, kind,
      bf16, lo, diff, split_first);
  return static_cast<int>(cudaGetLastError());
}

// keys int64 [rows, 2]; out int64 [rows, n, 2].
extern "C" int threefry_split_launch(const void* keys, void* out, long long rows, long long n,
                                     void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  threefry_split_kernel<<<grid_of(rows, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<int64_t*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}
