// The QAP witness map's pointwise Fr work around its FFTs: the three
// constraint matrices times the witness, the step domain's input and output
// stages, and H = (A*B - C) / Z.
//
// Replaces: blockmaze_tpu/ntt/pntt.py `mul_elementwise` in its QAP roles,
// together with the XLA field ops the JAX pipeline put between its
// launches: the COO matvec (gather, product, segment sum, canon_wide:
// groth16/qap.py sparse_matvec), the step domain's coset product, add/sub,
// omega powers and compression sums before its two forward FFTs and the
// 1/m, omega, sub, omega^-1, (U0 +- U1)/2 and coset^-1 after its two
// inverse ones (ntt/jntt.py _step_fft_t, _step_ifft_t), and A*B - C, 1/Z
// (groth16/qap.py qap_h_arrays).
//
// What bounds them on this card: each is a handful of Fr CIOS products per
// element of arrays that fit in L2 (the mint's 196,608 rows are 12.6 MB an
// array), so memory and the IMAD pipe are close: the step kernels read and
// write each element once with ~2-4 products; the matvec does one product
// per term (928k for mint) against 68 B of term and a 64 B witness gather.
//
// Design: one thread per output group, every field value canonical, so the
// result is bit-equal to the JAX pipeline whatever the association order.
// - qap_matvec: A, B and C stacked as one CSR of 3m rows. A row of at most
//   `long_row` terms is one thread's loop; a longer row (the mint key has
//   rows of up to 253 terms) is one warp's: lane l takes terms l, l + 32,
//   ..., and a shuffle tree of Fr adds joins the lanes. Both kinds run in
//   one launch (the blocks past the short-row grid take the long rows). A
//   row with no terms stores zero.
// - step_pre / step_post: thread i < small_m owns the compr = big_m /
//   small_m elements i, small_m + i, ... of the big part and element i of
//   the small part, so the stride-small_m compression sums are a loop in
//   registers and every load and store coalesces across the warp.
// - qap_combine: one thread per element.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace bm;

namespace {

__device__ __forceinline__ E ld(const int32_t* base, long long row) {
  return load_e4(reinterpret_cast<const int4*>(base) + 4 * row, 1);
}

__device__ __forceinline__ void st(int32_t* base, long long row, const E& v) {
  store_e4(reinterpret_cast<int4*>(base) + 4 * row, v);
}

__device__ __forceinline__ E term(const int32_t* var, const int32_t* coeff,
                                  const int32_t* w, int t) {
  return mul_e<FrP>(ld(w, var[t]), ld(coeff, t));
}

// y[r] = sum over t in [ptr[r], ptr[r+1]) of coeff[t] * w[var[t]].
// Blocks [0, short_blocks): one thread per row, skipping rows of more than
// long_row terms; the blocks after: one warp per row of long_rows.
__global__ void qap_matvec_kernel(int32_t* y, const int32_t* ptr,
                                  const int32_t* var, const int32_t* coeff,
                                  const int32_t* w, const int32_t* long_rows,
                                  int nrows, int nlong, int long_row,
                                  int short_blocks) {
  if ((int)blockIdx.x < short_blocks) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= nrows) return;
    const int t0 = ptr[r], t1 = ptr[r + 1];
    if (t1 - t0 > long_row) return;
    E acc = zero_e<FrP>();
    for (int t = t0; t < t1; ++t)
      acc = add_e<FrP>(acc, term(var, coeff, w, t));
    st(y, r, acc);
    return;
  }
  // the warp index is the same for the warp's 32 lanes: it leaves or
  // stays whole, as the full-mask shuffles need
  const int wi = ((blockIdx.x - short_blocks) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wi >= nlong) return;
  const int r = long_rows[wi];
  const int t0 = ptr[r], t1 = ptr[r + 1];
  E acc = zero_e<FrP>();
  for (int t = t0 + lane; t < t1; t += 32)
    acc = add_e<FrP>(acc, term(var, coeff, w, t));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    E o;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o.v[k] = __shfl_down_sync(0xffffffffu, acc.v[k], off);
    acc = add_e<FrP>(acc, o);
  }
  if (lane == 0) st(y, r, acc);
}

// x = a (times coset if given). out[0, big) = x_lo + pad(x_hi);
// out[big + i] = sum_j omega[j*small + i] * (x_lo - pad(x_hi))[j*small + i].
__global__ void step_pre_kernel(int32_t* out, const int32_t* a,
                                const int32_t* coset, const int32_t* omega,
                                int big, int small) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= small) return;
  const int compr = big / small;
  E hi = ld(a, big + i);
  if (coset) hi = mul_e<FrP>(hi, ld(coset, big + i));
  E acc = zero_e<FrP>();
  for (int j = 0; j < compr; ++j) {
    const long long p = (long long)j * small + i;
    E x = ld(a, p);
    if (coset) x = mul_e<FrP>(x, ld(coset, p));
    E c = x, d = x;
    if (j == 0) {
      c = add_e<FrP>(x, hi);
      d = sub_e<FrP>(x, hi);
    }
    st(out, p, c);
    acc = add_e<FrP>(acc, mul_e<FrP>(ld(omega, p), d));
  }
  st(out, big + i, acc);
}

// U0 = u0 / big_m, U1 = u1 / small_m (the rows big_minv, small_minv);
// V = (U1 - sum_{j>=1} omega[j*small + i] * U0[j*small + i]) * omega_inv[i];
// out[i] = (U0[i] + V) * half, out[j*small + i] = U0[j*small + i] (j >= 1),
// out[big + i] = (U0[i] - V) * half; then each out[p] times post[p] if given.
__global__ void step_post_kernel(int32_t* out, const int32_t* u0,
                                 const int32_t* u1, const int32_t* omega,
                                 const int32_t* omega_inv,
                                 const int32_t* big_minv,
                                 const int32_t* small_minv,
                                 const int32_t* half, const int32_t* post,
                                 int big, int small) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= small) return;
  const int compr = big / small;
  const E bm = ld(big_minv, 0);
  const E head = mul_e<FrP>(ld(u0, i), bm);
  E s = zero_e<FrP>();
  for (int j = 1; j < compr; ++j) {
    const long long p = (long long)j * small + i;
    const E v = mul_e<FrP>(ld(u0, p), bm);
    s = add_e<FrP>(s, mul_e<FrP>(v, ld(omega, p)));
    st(out, p, post ? mul_e<FrP>(v, ld(post, p)) : v);
  }
  E v = mul_e<FrP>(ld(u1, i), ld(small_minv, 0));
  v = mul_e<FrP>(sub_e<FrP>(v, s), ld(omega_inv, i));
  const E h = ld(half, 0);
  E lo = mul_e<FrP>(add_e<FrP>(head, v), h);
  E hi = mul_e<FrP>(sub_e<FrP>(head, v), h);
  if (post) {
    lo = mul_e<FrP>(lo, ld(post, i));
    hi = mul_e<FrP>(hi, ld(post, big + i));
  }
  st(out, i, lo);
  st(out, big + i, hi);
}

// out[i] = (a[i] * b[i] - c[i]) * zinv[i]
__global__ void qap_combine_kernel(int32_t* out, const int32_t* a,
                                   const int32_t* b, const int32_t* c,
                                   const int32_t* zinv, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E ab = mul_e<FrP>(ld(a, i), ld(b, i));
  st(out, i, mul_e<FrP>(sub_e<FrP>(ab, ld(c, i)), ld(zinv, i)));
}

constexpr int THREADS = 256;
constexpr int STEP_THREADS = 128;

}  // namespace

// y: (nrows, 16); ptr: (nrows + 1,) int32 row offsets into var (nnz,)
// int32 and coeff (nnz, 16); w: witness (nvars + 1, 16); long_rows:
// (nlong,) int32, the rows of more than long_row terms. All limb arrays
// 16-byte aligned.
extern "C" int bm_qap_matvec(void* y, const void* ptr, const void* var,
                             const void* coeff, const void* w,
                             const void* long_rows, int nrows, int nlong,
                             int long_row, void* stream) {
  if (nrows < 0 || nlong < 0 || long_row < 0)
    return (int)cudaErrorInvalidValue;
  const int short_blocks = (nrows + THREADS - 1) / THREADS;
  const int long_blocks = (int)(((long long)nlong * 32 + THREADS - 1) /
                                THREADS);
  if (short_blocks + long_blocks > 0)
    qap_matvec_kernel<<<short_blocks + long_blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(
        (int32_t*)y, (const int32_t*)ptr, (const int32_t*)var,
        (const int32_t*)coeff, (const int32_t*)w, (const int32_t*)long_rows,
        nrows, nlong, long_row, short_blocks);
  return (int)cudaGetLastError();
}

// out: (big + small, 16); a: (big + small, 16); coset: (big + small, 16) or
// null; omega: (big, 16). small divides big.
extern "C" int bm_step_pre(void* out, const void* a, const void* coset,
                           const void* omega, int big, int small,
                           void* stream) {
  if (small <= 0 || big < small || big % small)
    return (int)cudaErrorInvalidValue;
  step_pre_kernel<<<(small + STEP_THREADS - 1) / STEP_THREADS, STEP_THREADS,
                    0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)coset,
      (const int32_t*)omega, big, small);
  return (int)cudaGetLastError();
}

// out: (big + small, 16); u0: (big, 16); u1: (small, 16); omega: (big, 16);
// omega_inv: (small, 16); big_minv, small_minv, half: one row each; post:
// (big + small, 16) or null. small divides big.
extern "C" int bm_step_post(void* out, const void* u0, const void* u1,
                            const void* omega, const void* omega_inv,
                            const void* big_minv, const void* small_minv,
                            const void* half, const void* post, int big,
                            int small, void* stream) {
  if (small <= 0 || big < small || big % small)
    return (int)cudaErrorInvalidValue;
  step_post_kernel<<<(small + STEP_THREADS - 1) / STEP_THREADS, STEP_THREADS,
                     0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)u0, (const int32_t*)u1,
      (const int32_t*)omega, (const int32_t*)omega_inv,
      (const int32_t*)big_minv, (const int32_t*)small_minv,
      (const int32_t*)half, (const int32_t*)post, big, small);
  return (int)cudaGetLastError();
}

// out, a, b, c, zinv: (n, 16).
extern "C" int bm_qap_combine(void* out, const void* a, const void* b,
                              const void* c, const void* zinv, long long n,
                              void* stream) {
  if (n > 0)
    qap_combine_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b,
        (const int32_t*)c, (const int32_t*)zinv, n);
  return (int)cudaGetLastError();
}
