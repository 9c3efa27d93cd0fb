// Batched point kernels over G1 and G2: Jacobian add, double, and mixed
// add with and without the exceptional cases.
//
// Replaces: blockmaze_tpu/curves/pcurve.py `add`, `double`, `mixed_add`
// and `mixed_add_noexc` (each a Pallas kernel over limb-major tiles running
// the jcurve formulas). They run on neither the prove path nor the keygen
// path: the MSM's reduction (combine.cu, triangle.cu, fold.cu) and keygen's
// fixed-base exponentiation (fixed_base.cu) have kernels of their own.
// chip_smoke.py holds them against their plain versions.
//
// What bounds them on this card: integer multiplies. A G1 add is ~16 Fq
// CIOS products for 288 bytes of limbs in and 192 out; G2 costs about three
// times the products for twice the bytes. At the MSM's batch sizes (2^15 to
// 2^17 points) every kernel is compute-bound.
//
// Design: one thread per point, the group law of curve.cuh with branches in
// place of the TPU's all-lanes selects (same results). Coordinates stay in
// the JAX layout in memory: (n, 16) int32 for G1, (n, 2, 16) for G2.

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace bm;

namespace {

constexpr int THREADS = 128;

unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

template <class F>
__global__ void add_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                           const int32_t* x1, const int32_t* y1,
                           const int32_t* z1, const int32_t* x2,
                           const int32_t* y2, const int32_t* z2,
                           long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<F> r = add(load_jac<F>(x1, y1, z1, i), load_jac<F>(x2, y2, z2, i));
  store_jac(ox, oy, oz, i, r);
}

template <class F>
__global__ void double_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                              const int32_t* x, const int32_t* y,
                              const int32_t* z, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_jac(ox, oy, oz, i, dbl(load_jac<F>(x, y, z, i)));
}

template <class F, bool EXC>
__global__ void mixed_add_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                                 const int32_t* x, const int32_t* y,
                                 const int32_t* z, const int32_t* qx,
                                 const int32_t* qy, const uint8_t* qinf,
                                 long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<F> P = load_jac<F>(x, y, z, i);
  F Qx = F::load(qx + i * F::WORDS), Qy = F::load(qy + i * F::WORDS);
  bool qi = qinf[i] != 0;
  Jac<F> r = EXC ? mixed_add(P, Qx, Qy, qi) : mixed_add_noexc(P, Qx, Qy, qi);
  store_jac(ox, oy, oz, i, r);
}

}  // namespace

// curve: 1 = G1, 2 = G2. Every pointer is a contiguous int32 coordinate
// array of n points (qinf: n bytes).
extern "C" int bm_point_add(int curve, void* ox, void* oy, void* oz,
                            const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto c = [](const void* p) { return (const int32_t*)p; };
  if (curve == 1)
    add_kernel<Fq><<<blocks_for(n), THREADS, 0, s>>>(
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, c(x1), c(y1), c(z1), c(x2),
        c(y2), c(z2), n);
  else
    add_kernel<Fq2><<<blocks_for(n), THREADS, 0, s>>>(
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, c(x1), c(y1), c(z1), c(x2),
        c(y2), c(z2), n);
  return (int)cudaGetLastError();
}

extern "C" int bm_point_double(int curve, void* ox, void* oy, void* oz,
                               const void* x, const void* y, const void* z,
                               long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto c = [](const void* p) { return (const int32_t*)p; };
  if (curve == 1)
    double_kernel<Fq><<<blocks_for(n), THREADS, 0, s>>>(
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, c(x), c(y), c(z), n);
  else
    double_kernel<Fq2><<<blocks_for(n), THREADS, 0, s>>>(
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, c(x), c(y), c(z), n);
  return (int)cudaGetLastError();
}

// exc = 1: jcurve.point_mixed_add; exc = 0: point_mixed_add_noexc.
extern "C" int bm_point_mixed_add(int curve, int exc, void* ox, void* oy,
                                  void* oz, const void* x, const void* y,
                                  const void* z, const void* qx,
                                  const void* qy, const void* qinf,
                                  long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto c = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
  auto qi = (const uint8_t*)qinf;
  unsigned g = blocks_for(n);
  if (curve == 1 && exc)
    mixed_add_kernel<Fq, true><<<g, THREADS, 0, s>>>(
        o(ox), o(oy), o(oz), c(x), c(y), c(z), c(qx), c(qy), qi, n);
  else if (curve == 1)
    mixed_add_kernel<Fq, false><<<g, THREADS, 0, s>>>(
        o(ox), o(oy), o(oz), c(x), c(y), c(z), c(qx), c(qy), qi, n);
  else if (exc)
    mixed_add_kernel<Fq2, true><<<g, THREADS, 0, s>>>(
        o(ox), o(oy), o(oz), c(x), c(y), c(z), c(qx), c(qy), qi, n);
  else
    mixed_add_kernel<Fq2, false><<<g, THREADS, 0, s>>>(
        o(ox), o(oy), o(oz), c(x), c(y), c(z), c(qx), c(qy), qi, n);
  return (int)cudaGetLastError();
}
