// Fr kernels of the QAP witness map: one radix-2 FFT stage, and the
// pointwise Montgomery product.
//
// Replaces: blockmaze_tpu/ntt/pntt.py `butterfly` (one DIT stage,
// (lo + w*hi, lo - w*hi)) and `mul_elementwise` (pointwise product: COO
// matvec terms, A*B, coset / 1/Z / 1/m scaling).
//
// What bounds them on this card: one Fr CIOS product per element, 64-96
// bytes of limbs read and 64-128 written. At 2^16 butterflies that is
// ~12 MB per stage, so a stage is a few microseconds of memory traffic and
// launch overhead dominates at the mint shapes; the product costs about as
// much as the traffic.
//
// Design: one thread per butterfly (per element), limbs repacked from the
// JAX layout (16 x 16-bit int32 words) into 8 x 32-bit registers. The
// stage kernel indexes the stage's lo/hi halves and its span-long twiddle
// table directly, so no broadcast twiddle tensor is materialised (the TPU
// version is fed a pre-broadcast (m/2, 16) twiddle array). Stage fusion in
// shared memory is left for later work.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace bm;

namespace {

// a, out: (m, 16); tw: (span, 16). Butterfly j pairs rows lo = blk*2*span+k
// and lo + span with twiddle k, for blk = j / span, k = j % span.
__global__ void butterfly_stage_kernel(int32_t* out, const int32_t* a,
                                       const int32_t* tw, long long half,
                                       long long span) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= half) return;
  long long blk = j / span, k = j - blk * span;
  long long lo = blk * 2 * span + k, hi = lo + span;
  E w = load_e(tw + k * 16);
  E x = load_e(a + lo * 16);
  E y = load_e(a + hi * 16);
  E t = mul_e<FrP>(w, y);
  store_e(out + lo * 16, add_e<FrP>(x, t));
  store_e(out + hi * 16, sub_e<FrP>(x, t));
}

// out[i] = a[i] * b[b_bcast ? 0 : i] * R^-1 mod r
__global__ void mul_elementwise_kernel(int32_t* out, const int32_t* a,
                                       const int32_t* b, long long n,
                                       int b_bcast) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  E x = load_e(a + i * 16);
  E y = load_e(b + (b_bcast ? 0 : i) * 16);
  store_e(out + i * 16, mul_e<FrP>(x, y));
}

constexpr int THREADS = 256;

unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int bm_butterfly_stage(void* out, const void* a, const void* tw,
                                  long long m, long long span, void* stream) {
  long long half = m / 2;
  if (half > 0)
    butterfly_stage_kernel<<<blocks_for(half), THREADS, 0,
                             (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)tw, half, span);
  return (int)cudaGetLastError();
}

extern "C" int bm_mul_elementwise(void* out, const void* a, const void* b,
                                  long long n, int b_bcast, void* stream) {
  if (n > 0)
    mul_elementwise_kernel<<<blocks_for(n), THREADS, 0,
                             (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, b_bcast);
  return (int)cudaGetLastError();
}
