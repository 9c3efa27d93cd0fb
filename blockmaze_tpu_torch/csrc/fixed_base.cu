// Keygen's fixed-base exponentiation: s_i * G for a whole query vector of
// standard-form scalars, as affine Montgomery limbs, in one launch.
//
// Replaces: the keygen role of blockmaze_tpu/curves/pcurve.py
// `mixed_add_noexc` (:115, K8) and `mixed_add` (:102, K7), which ran the
// window ladder one batched point op per launch, 34 launches a chunk, the
// accumulator and a gathered table row through device memory each time, and
// then a host round trip (Python-int batch inversion to affine, and back to
// Montgomery limbs for the proving key).
//
// What bounds it on this card: integer multiplies. Per G1 point 11 Fq
// products for the blind and for each nonzero digit of windows 1..31 plus
// 11 to remove the blind, then 366 for the affine normalisation (a Fermat
// inversion of 362 products and 4 more); G2 29 per mixed add and 377 for
// the normalisation. The bytes are a scalar (64 B) in and x, y and the flag
// out per point, with the window table (1 MB G1, 2 MB G2 in 16-bit limbs)
// read from L2.
//
// Design: one thread per scalar (grid-stride loop), the Jacobian
// accumulator in registers through all 32 windows of c = 8 bits (digit w is
// byte w of the scalar). Window 0 starts the accumulator from the table;
// the blind B joins through the complete mixed add; windows 1..31 use the
// exception-free mixed add (acc = B + partial sum is infinity or +-T only
// if B is, probability ~ n*W/r); a complete mixed add of -B removes the
// blind. Then Z^-1 by Fermat (field.cuh inv) and x = X Z^-2, y = Y Z^-3; Z =
// 0 gives x = y = 0 and the flag set, as the key's infinity points are
// stored. Every output is canonical, so the limbs equal the plain version's
// and the host's. The table is repacked by the wrapper to 32-bit words, x
// then y, so an entry is one 64 B (G1) or 128 B (G2) run of int4 loads.
// The G2 point ops and inversion are called out of line (the G2 mixed add
// alone sits near the 255-register cap; see triangle.cu).

#include <cuda_runtime.h>

#include <type_traits>

#include "curve.cuh"

using namespace bm;

namespace {

constexpr int THREADS = 128;
constexpr int WINDOW_BITS = 8;
constexpr int N_WINDOWS = 32;
constexpr int TABLE_ROW = 1 << WINDOW_BITS;

template <class F>
__host__ __device__ constexpr bool out_of_line() {
  return std::is_same<F, Fq2>::value;
}

template <class F>
__device__ __noinline__ Jac<F> madd_noexc_call(const Jac<F>& P, const F& Qx,
                                               const F& Qy) {
  return mixed_add_noexc(P, Qx, Qy, false);
}

template <class F>
__device__ __noinline__ Jac<F> madd_call(const Jac<F>& P, const F& Qx,
                                         const F& Qy) {
  return mixed_add(P, Qx, Qy, false);
}

template <class F>
__device__ __noinline__ F inv_call(const F& a) {
  return inv(a);
}

template <class F>
__device__ __forceinline__ Jac<F> madd_noexc_op(const Jac<F>& P, const F& Qx,
                                                const F& Qy) {
  if constexpr (out_of_line<F>())
    return madd_noexc_call(P, Qx, Qy);
  else
    return mixed_add_noexc(P, Qx, Qy, false);
}

template <class F>
__device__ __forceinline__ Jac<F> madd_op(const Jac<F>& P, const F& Qx,
                                          const F& Qy) {
  if constexpr (out_of_line<F>())
    return madd_call(P, Qx, Qy);
  else
    return mixed_add(P, Qx, Qy, false);
}

template <class F>
__device__ __forceinline__ F inv_op(const F& a) {
  if constexpr (out_of_line<F>())
    return inv_call(a);
  else
    return inv(a);
}

// One packed table entry: x then y, each as 32-bit words (Fq: 2 int4, Fq2:
// c0 then c1, 4 int4).
__device__ __forceinline__ void load_entry(const int4* e, Fq& x, Fq& y) {
  x = Fq{e_from_int4(__ldg(e), __ldg(e + 1))};
  y = Fq{e_from_int4(__ldg(e + 2), __ldg(e + 3))};
}

__device__ __forceinline__ void load_entry(const int4* e, Fq2& x, Fq2& y) {
  x = Fq2{e_from_int4(__ldg(e), __ldg(e + 1)),
          e_from_int4(__ldg(e + 2), __ldg(e + 3))};
  y = Fq2{e_from_int4(__ldg(e + 4), __ldg(e + 5)),
          e_from_int4(__ldg(e + 6), __ldg(e + 7))};
}

__device__ __forceinline__ void store4(int32_t* p, const Fq& a) {
  store_e4((int4*)p, a.c);
}

__device__ __forceinline__ void store4(int32_t* p, const Fq2& a) {
  store_e4((int4*)p, a.c0);
  store_e4((int4*)p + 4, a.c1);
}

// The low byte of the 256-bit scalar s, which then shifts right by a byte.
__device__ __forceinline__ uint32_t next_digit(uint32_t (&s)[8]) {
  const uint32_t d = s[0] & 0xffu;
#pragma unroll
  for (int k = 0; k < 7; ++k) s[k] = __funnelshift_r(s[k], s[k + 1], 8);
  s[7] >>= 8;
  return d;
}

template <class F>
__global__ void __launch_bounds__(THREADS)
fixed_base_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  uint8_t* __restrict__ oinf, const int4* __restrict__ table,
                  const uint8_t* __restrict__ tinf,
                  const int4* __restrict__ scalars,
                  const int32_t* __restrict__ bx,
                  const int32_t* __restrict__ by, long long n) {
  constexpr int ENTRY = 2 * F::WORDS / 8;  // int4 per packed entry
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t s[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 w = __ldg(scalars + i * 4 + q);
      s[2 * q] = (uint32_t)w.x | ((uint32_t)w.y << 16);
      s[2 * q + 1] = (uint32_t)w.z | ((uint32_t)w.w << 16);
    }
    // window 0 from infinity: the table entry itself (jcurve's mixed add
    // of infinity and T)
    uint32_t d = next_digit(s);
    F qx, qy;
    load_entry(table + d * ENTRY, qx, qy);
    Jac<F> acc{qx, qy, tinf[d] ? F::zero() : F::one()};
    acc = madd_op(acc, F::load(bx), F::load(by));
#pragma unroll 1
    for (int w = 1; w < N_WINDOWS; ++w) {
      d = next_digit(s);
      const int idx = w * TABLE_ROW + (int)d;
      if (tinf[idx]) continue;
      load_entry(table + idx * ENTRY, qx, qy);
      acc = madd_noexc_op(acc, qx, qy);
    }
    F nby = F::zero() - F::load(by);
    acc = madd_op(acc, F::load(bx), nby);
    // affine: Z = 0 inverts to 0, so x = y = 0 for infinity
    const F zi = inv_op(acc.Z);
    const F zi2 = sqr(zi);
    store4(ox + i * F::WORDS, acc.X * zi2);
    store4(oy + i * F::WORDS, acc.Y * (zi2 * zi));
    oinf[i] = acc.Z.is_zero() ? 1 : 0;
  }
}

template <class F>
void launch(void* ox, void* oy, void* oinf, const void* table,
            const void* tinf, const void* scalars, const void* bx,
            const void* by, long long n, cudaStream_t s) {
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 65535 ? want : 65535);
  fixed_base_kernel<F><<<blocks, THREADS, 0, s>>>(
      (int32_t*)ox, (int32_t*)oy, (uint8_t*)oinf, (const int4*)table,
      (const uint8_t*)tinf, (const int4*)scalars, (const int32_t*)bx,
      (const int32_t*)by, n);
}

}  // namespace

// curve: 1 = G1, 2 = G2. ox, oy: (n, 16) / (n, 2, 16) int32 affine
// Montgomery limbs out, oinf: n bytes out; table: (32 * 256) packed entries
// (x then y as 32-bit words; 16-byte aligned), tinf: 32 * 256 bytes;
// scalars: (n, 16) int32 standard-form 16-bit limbs (16-byte aligned); bx,
// by: the blind's affine Montgomery limbs.
extern "C" int bm_fixed_base_exp(int curve, void* ox, void* oy, void* oinf,
                                 const void* table, const void* tinf,
                                 const void* scalars, const void* bx,
                                 const void* by, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  if (curve == 1)
    launch<Fq>(ox, oy, oinf, table, tinf, scalars, bx, by, n, s);
  else
    launch<Fq2>(ox, oy, oinf, table, tinf, scalars, bx, by, n, s);
  return (int)cudaGetLastError();
}
