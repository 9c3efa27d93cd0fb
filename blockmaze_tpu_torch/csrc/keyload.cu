// Point decompression for the proving key's text form: compressed G1 and G2
// points (x in standard form, the parity bit of y, the zero flag) to the
// affine Montgomery limbs (x, y, inf) the DevicePK stores, one thread a
// point.
//
// Replaces: the host decompression of blockmaze_tpu/native/keyparse.cpp
// (g1_decompress :138, g2_decompress :265 and to_mont_limbs :117, C++ over
// GMP) and of the Python reader it stood in for
// (serialization/libsnark_io.py read_g1 / read_g2 over fields/host.py
// fq_sqrt and fq2_sqrt). Not a Pallas kernel: the JAX package decompressed
// on the host.
//
// What bounds it on this card: integer multiplies. Per G1 point 5 Fq
// products around the square root (x to Montgomery form, x^3, the check
// y*y, y's parity out of Montgomery form) and the chain a^((q+1)/4) of 251
// squarings and 108 multiplies; per G2 point 16 Fq products around it (x
// to Montgomery form, x^3 in Fq2, the root's three products and the
// quadratic-residue test of three squarings, the check, the parity) and the
// chain a^((t-1)/2) in Fq2 (q^2 - 1 = 2^4 t) of 502 squarings (2 Fq
// products each) and 228 multiplies (3 each), then Tonelli-Shanks' loop of
// at most three rounds. Bytes are a point's x (64 / 128 B) and two flags in,
// x, y and two flags out.
//
// Design: the chains of fields/host.py, run the same way on every point so
// that the root is the one the Python reader picks: G1's root is unique up
// to sign, and the parity of y picks the sign; in G2, where y.c0 = 0 leaves
// the parity unable to tell the roots apart, the Tonelli-Shanks chain of
// host.fq2_sqrt (s = 4, the non-residue's power z = nqr^t, the same loop)
// gives host.fq2_sqrt's root. The exponents sit in constant memory and
// every thread reads the same word at once (a broadcast); the chain is a
// left-to-right square-and-multiply that skips the exponent's leading
// zeros. A zero point gives (0, 0, 1) as the key stores infinity; an x
// whose y^2 is not a square (or whose root fails y*y = y^2) sets the
// point's `bad` flag, and the wrapper raises.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace bm;

namespace {

constexpr int THREADS = 128;

// (q + 1) / 4, 252 bits
__constant__ uint32_t G1_EXP[8] = {0xb61f3f52u, 0x4f082305u, 0x5a1c72a3u,
                                   0x65e05aa4u, 0xa0605617u, 0x6e14116du,
                                   0xb84c680au, 0x0c19139cu};
constexpr int G1_EXP_BITS = 252;
// (t - 1) / 2 with q^2 - 1 = 2^4 t, 503 bits
__constant__ uint32_t G2_EXP[16] = {
    0x113aeb4du, 0x09daa2c5u, 0x684f5608u, 0xe5301039u, 0xe36cb656u,
    0x425280c4u, 0xabd09216u, 0x682344f4u, 0xe1a6359cu, 0x31376fd2u,
    0x88b1bab0u, 0xe5805c2au, 0xe01a4690u, 0xe2ccd37bu, 0xc3b1e5fcu,
    0x00492e25u};
constexpr int G2_EXP_BITS = 503;
constexpr int TS_S = 4;

// Fq constants as 32-bit words, Montgomery form unless marked
__constant__ uint32_t K_R2[8] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu,
                                 0xb5e71911u, 0x0a417ff6u, 0x47ab1effu,
                                 0xcab8351fu, 0x06d89f71u};  // R^2 (plain)
__constant__ uint32_t K_B1[8] = {0x50ad28d7u, 0x7a17caa9u, 0xe15521b9u,
                                 0x1f6ac17au, 0x696bd284u, 0x334bea4eu,
                                 0xce179d8eu, 0x2a1f6744u};  // G1's b = 3
__constant__ uint32_t K_B2[16] = {
    0x77b802a8u, 0x3bf938e3u, 0x3633535du, 0x020b1b27u, 0x49755260u,
    0x26b7edf0u, 0x4384a86du, 0x2514c632u,  // the twist's b' = 3/(9+u), c0
    0xd1dcff67u, 0x38e7ecccu, 0x93ce0d3eu, 0x65f0b37du, 0x22ac00aau,
    0xd749d0ddu, 0x4a688d4du, 0x0141b9ceu};  // c1
__constant__ uint32_t K_NQR_T[16] = {
    0x87961532u, 0x801dd976u, 0x3e84d778u, 0xb2fe144bu, 0x98f81824u,
    0x936464b8u, 0xad99ce67u, 0x2581f70bu,  // z = nqr^t, c0
    0x07394ed9u, 0x60b5b575u, 0x808492c9u, 0xf3a19577u, 0xeb1419ecu,
    0xd0048196u, 0x9ba98a59u, 0x0e752acfu};  // c1

__device__ __forceinline__ E kconst(const uint32_t* w) {
  E r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = w[k];
  return r;
}

__device__ __forceinline__ E plain_one() {
  E r = zero_e<FqP>();
  r.v[0] = 1u;
  return r;
}

__device__ __forceinline__ bool eq_e(const E& a, const E& b) {
  uint32_t d = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) d |= a.v[k] ^ b.v[k];
  return d == 0u;
}

__device__ __forceinline__ bool eq(const Fq& a, const Fq& b) {
  return eq_e(a.c, b.c);
}

__device__ __forceinline__ bool eq(const Fq2& a, const Fq2& b) {
  return eq_e(a.c0, b.c0) && eq_e(a.c1, b.c1);
}

__device__ __forceinline__ Fq neg(const Fq& a) { return Fq{neg_e<FqP>(a.c)}; }

__device__ __forceinline__ Fq2 neg(const Fq2& a) {
  return Fq2{neg_e<FqP>(a.c0), neg_e<FqP>(a.c1)};
}

// a^e for the exponent of `bits` bits in constant memory: left to right
// from its top bit (fields/tfield.py inv's order of products).
template <class F>
__device__ F pow_const(const F& a, const uint32_t* e, int bits) {
  F r = a;
#pragma unroll 1
  for (int b = bits - 2; b >= 0; --b) {
    r = sqr(r);
    if ((e[b >> 5] >> (b & 31)) & 1u) r = r * a;
  }
  return r;
}

// host.fq2_sqrt: Tonelli-Shanks with s = 4. false when a is not a square.
__device__ bool fq2_sqrt(const Fq2& a, Fq2& root) {
  root = Fq2::zero();
  if (a.is_zero()) return true;
  const Fq2 one = Fq2::one();
  const Fq2 w0 = pow_const(a, G2_EXP, G2_EXP_BITS);
  Fq2 x = a * w0;
  Fq2 b = x * w0;
  Fq2 chk = b;
#pragma unroll 1
  for (int k = 0; k < TS_S - 1; ++k) chk = sqr(chk);
  if (!eq(chk, one)) return false;
  Fq2 z{kconst(K_NQR_T), kconst(K_NQR_T + 8)};
  int v = TS_S;
#pragma unroll 1
  for (int round = 0; round < TS_S && !eq(b, one); ++round) {
    int m = 0;
    Fq2 b2m = b;
#pragma unroll 1
    while (m < TS_S && !eq(b2m, one)) {
      b2m = sqr(b2m);
      ++m;
    }
    Fq2 w = z;
#pragma unroll 1
    for (int j = v - m - 1; j > 0; --j) w = sqr(w);
    z = sqr(w);
    b = b * z;
    x = x * w;
    v = m;
  }
  root = x;
  return true;
}

__global__ void __launch_bounds__(THREADS)
decompress_g1_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     uint8_t* __restrict__ oinf, uint8_t* __restrict__ obad,
                     const int32_t* __restrict__ xs,
                     const uint8_t* __restrict__ lsb,
                     const uint8_t* __restrict__ zero, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (zero[i]) {
      Fq::zero().store(ox + i * 16);
      Fq::zero().store(oy + i * 16);
      oinf[i] = 1;
      obad[i] = 0;
      continue;
    }
    const Fq x{mul_e<FqP>(load_e(xs + i * 16), kconst(K_R2))};
    const Fq y2 = sqr(x) * x + Fq{kconst(K_B1)};
    Fq y = pow_const(y2, G1_EXP, G1_EXP_BITS);
    const bool ok = eq(sqr(y), y2);
    const E ystd = mul_e<FqP>(y.c, plain_one());
    if ((ystd.v[0] & 1u) != (uint32_t)lsb[i]) y = neg(y);
    x.store(ox + i * 16);
    y.store(oy + i * 16);
    oinf[i] = 0;
    obad[i] = ok ? 0 : 1;
  }
}

__global__ void __launch_bounds__(THREADS)
decompress_g2_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     uint8_t* __restrict__ oinf, uint8_t* __restrict__ obad,
                     const int32_t* __restrict__ xs,
                     const uint8_t* __restrict__ lsb,
                     const uint8_t* __restrict__ zero, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (zero[i]) {
      Fq2::zero().store(ox + i * 32);
      Fq2::zero().store(oy + i * 32);
      oinf[i] = 1;
      obad[i] = 0;
      continue;
    }
    const E r2 = kconst(K_R2);
    const Fq2 x{mul_e<FqP>(load_e(xs + i * 32), r2),
                mul_e<FqP>(load_e(xs + i * 32 + 16), r2)};
    const Fq2 y2 = sqr(x) * x + Fq2{kconst(K_B2), kconst(K_B2 + 8)};
    Fq2 y;
    const bool square = fq2_sqrt(y2, y);
    const bool ok = eq(sqr(y), y2) && square;
    const E c0std = mul_e<FqP>(y.c0, plain_one());
    if ((c0std.v[0] & 1u) != (uint32_t)lsb[i]) y = neg(y);
    x.store(ox + i * 32);
    y.store(oy + i * 32);
    oinf[i] = 0;
    obad[i] = ok ? 0 : 1;
  }
}

unsigned blocks_for(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  return (unsigned)(want < 65535 ? want : 65535);
}

}  // namespace

// curve: 1 = G1, 2 = G2. ox, oy: (n, 16) / (n, 2, 16) int32 affine
// Montgomery limbs out; oinf, obad: n bytes out (infinity; x off the
// curve); xs: (n, 16) / (n, 2, 16) int32 standard-form 16-bit limbs (any
// value below 2^256); lsb: the parity bit of y (G2: of y.c0), zero: the
// zero flag, n bytes each.
extern "C" int bm_decompress(int curve, void* ox, void* oy, void* oinf,
                             void* obad, const void* xs, const void* lsb,
                             const void* zero, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  if (curve == 1)
    decompress_g1_kernel<<<blocks_for(n), THREADS, 0, s>>>(
        (int32_t*)ox, (int32_t*)oy, (uint8_t*)oinf, (uint8_t*)obad,
        (const int32_t*)xs, (const uint8_t*)lsb, (const uint8_t*)zero, n);
  else
    decompress_g2_kernel<<<blocks_for(n), THREADS, 0, s>>>(
        (int32_t*)ox, (int32_t*)oy, (uint8_t*)oinf, (uint8_t*)obad,
        (const int32_t*)xs, (const uint8_t*)lsb, (const uint8_t*)zero, n);
  return (int)cudaGetLastError();
}
