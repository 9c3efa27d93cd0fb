// Fr kernels of the QAP witness map: the in-order radix-2 FFT (stages fused
// in shared memory), one radix-2 FFT stage, and the pointwise Montgomery
// product.
//
// Replaces: blockmaze_tpu/ntt/pntt.py `butterfly` (one DIT stage,
// (lo + w*hi, lo - w*hi), launched once per stage by jntt.fft_with after an
// XLA gather for the bit reversal) and `mul_elementwise` (pointwise
// product: COO matvec terms, A*B, coset / 1/Z / 1/m scaling). On the prove
// path mul_elementwise is left with one role, the witness's Montgomery
// form (x * R^2); its others moved into fft's factors and csrc/qap.cu.
//
// What bounds them on this card: one Fr CIOS product per butterfly or
// element. A whole FFT of 2^k elements is k * 2^(k-1) products (2^17: 17.6
// us of IMAD) against reading and writing the array once (2^17 x 64 B each
// way: 5 us); one stage alone is 2^(k-1) products against the same bytes,
// so a stage per launch is bound by its round trip to device memory and
// by the launch itself.
//
// Design of `fft`: the k stages run in ceil(k / 10) passes of nearly equal
// depth d over tiles of 2^d elements held in shared memory (8 x 32-bit
// limbs in two 16-byte planes, at most 32 KB a block), so an FFT costs two
// launches up to 2^20, and a 2^16 FFT still fills 128 blocks. A pass
// covering stages [s0, s1) sees the array as columns at stride 2^s0, each
// column an independent FFT of 2^(s1-s0) rows; a block takes 2^d /
// 2^(s1-s0) neighbouring columns, so its loads coalesce. The first pass
// gathers its tile through the permutation (the bit reversal that was an
// index_select) and works on contiguous ranges; a later pass reads and
// writes in place the packed 32-byte scratch the previous pass left; the
// last writes the JAX layout. One thread per butterfly and stage; the
// twiddle of stage s, lo position p, is w[2^s - 1 + p mod 2^s] in the
// concatenated table. Field arithmetic is exact and canonical, so the
// result equals the stage-by-stage loop bit for bit whatever the split.
//
// The pointwise products around a basic-domain FFT ride in its first and
// last pass instead of launches of their own: the first pass multiplies
// each element it gathers by `pre` at the element's source index (the
// coset powers of a coset FFT), the last multiplies each element it stores
// by the single row `scale` (1/m of an inverse FFT) and then by `post` at
// its output index (coset^-1 of an inverse coset FFT). Each is an optional
// (null) pointer; the product order is the JAX pipeline's.
//
// A batch of B = 2^b transforms of 2^j elements each, stored one after the
// other, is the first j stages of one array of 2^(j+b) elements: a pass
// never pairs elements of different transforms while its stages stay below
// j, the twiddles of those stages are the length-2^j table's, and the first
// pass gathers each element through the length-2^j permutation inside its
// own transform (the row's high bits kept, its low j bits permuted). The
// sharded 4-step FFT runs its column and row FFTs so (parallel/sntt.py).
//
// `butterfly_stage` stays as the one-to-one counterpart of the TPU kernel;
// the prove path launches `fft`.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace bm;

namespace {

constexpr int FFT_TILE_LOG = 10;  // ntt/pntt.py FFT_TILE_LOG

__device__ __forceinline__ E tile_get(const int4* sm, int tile, int e) {
  return e_from_int4(sm[e], sm[tile + e]);
}

__device__ __forceinline__ void tile_put(int4* sm, int tile, int e,
                                         const E& v) {
  sm[e] = e_lo4(v);
  sm[tile + e] = e_hi4(v);
}

// Stages [s0, s1) of the in-order DIT FFT of 2^k elements, over tiles of
// 2^tile_log elements and one thread per butterfly (tile / 2 threads).
// FIRST: `in` is (2^k, 16) in the JAX layout, gathered through the
// 2^perm_log-entry perm inside each run of 2^perm_log rows; else
// `in` is the packed (2^k, 8) scratch. LAST: `out` is (2^k, 16) in the JAX
// layout; else the packed scratch (in place when in == out).
// pre (FIRST), scale and post (LAST): optional factors, see above.
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(1 << (FFT_TILE_LOG - 1))
    fft_pass_kernel(int32_t* out, const int32_t* in, const int32_t* perm,
                    int perm_log, const int32_t* tw, int tile_log, int s0,
                    int s1, const int32_t* pre, const int32_t* scale,
                    const int32_t* post) {
  extern __shared__ int4 sm[];
  const int ns = s1 - s0;
  const int tile = 1 << tile_log;
  const int R = 1 << ns, C = tile >> ns;  // rows per column, columns
  // s0 = 0: the block's columns are one contiguous range, stored column by
  // column; else row by row, so neighbouring columns are neighbours
  const bool contig = s0 == 0;
  const int rs = contig ? 1 : C, cs = contig ? R : 1;
  const long long col0 = (long long)blockIdx.x * C;
  const long long low_mask = (1LL << s0) - 1;
  auto pos = [&](int r, int cl) -> long long {
    long long col = col0 + cl;
    return (col & low_mask) + ((long long)r << s0) + ((col >> s0) << s1);
  };
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int r = contig ? e % R : e / C;
    const int cl = contig ? e / R : e % C;
    const long long p = pos(r, cl);
    E v;
    if (FIRST) {
      const long long pmask = (1LL << perm_log) - 1;
      const long long src = (p & ~pmask) | perm[p & pmask];
      v = load_e4(reinterpret_cast<const int4*>(in) + 4 * src, 1);
      if (pre)
        v = mul_e<FrP>(v, load_e4(reinterpret_cast<const int4*>(pre) + 4 * src,
                                  1));
    } else {
      const int4* q = reinterpret_cast<const int4*>(in) + 2 * p;
      v = e_from_int4(q[0], q[1]);
    }
    tile_put(sm, tile, e, v);
  }
  // this thread's butterfly: row pair pr of column cl; its stage-l
  // twiddle is loaded one stage ahead
  const int i = threadIdx.x;
  const bool active = 2 * i < tile;
  const int pr = contig ? i % (R / 2 > 0 ? R / 2 : 1) : i / C;
  const int cl = contig ? i / (R / 2 > 0 ? R / 2 : 1) : i % C;
  const long long low = (col0 + cl) & low_mask;
  auto twiddle = [&](int l) {
    const long long j = low + ((long long)(pr & ((1 << l) - 1)) << s0);
    return load_e4(reinterpret_cast<const int4*>(tw) +
                       4 * ((1LL << (s0 + l)) - 1 + j),
                   1);
  };
  E w_next;
  if (active && ns > 0) w_next = twiddle(0);
  __syncthreads();
  for (int l = 0; l < ns; ++l) {
    const int half = 1 << l;
    if (active) {
      const E w = w_next;
      if (l + 1 < ns) w_next = twiddle(l + 1);
      const int rlo = ((pr >> l) << (l + 1)) | (pr & (half - 1));
      const int elo = rlo * rs + cl * cs, ehi = elo + half * rs;
      E x = tile_get(sm, tile, elo), y = tile_get(sm, tile, ehi);
      E t = mul_e<FrP>(w, y);
      tile_put(sm, tile, elo, add_e<FrP>(x, t));
      tile_put(sm, tile, ehi, sub_e<FrP>(x, t));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int r = contig ? e % R : e / C;
    const int cl = contig ? e / R : e % C;
    const long long p = pos(r, cl);
    E v = tile_get(sm, tile, e);
    if (LAST) {
      if (scale) v = mul_e<FrP>(v, load_e4(reinterpret_cast<const int4*>(scale),
                                           1));
      if (post)
        v = mul_e<FrP>(v, load_e4(reinterpret_cast<const int4*>(post) + 4 * p,
                                  1));
      store_e4(reinterpret_cast<int4*>(out) + 4 * p, v);
    } else {
      int4* q = reinterpret_cast<int4*>(out) + 2 * p;
      q[0] = e_lo4(v);
      q[1] = e_hi4(v);
    }
  }
}

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

// One pass over stages [s0, s1) of 2^(k - perm_log) FFTs of 2^perm_log
// elements each, stored one after the other (one FFT when perm_log = k), in
// tiles of 2^tile_log elements, s1 - s0 <= tile_log <= min(k, 10), s1 <=
// perm_log. a: (2^k, 16) (first pass) or packed (2^k, 8) scratch; out:
// (2^k, 16) (last pass) or the scratch, all 16-byte aligned; perm:
// (2^perm_log,) int32; tw: (2^perm_log - 1, 16), stage s at row 2^s - 1.
// pre (read by the first pass), scale (1, 16) and post (read by the last)
// are (2^k, 16) or null.
extern "C" int bm_fft_pass(void* out, const void* a, const void* perm,
                           const void* tw, int k, int perm_log, int tile_log,
                           int s0, int s1, int first, int last,
                           const void* pre, const void* scale,
                           const void* post, void* stream) {
  if (k < 0 || k > 30 || perm_log < 0 || perm_log > k || tile_log > k ||
      tile_log > FFT_TILE_LOG || s0 < 0 || s1 < s0 || s1 > perm_log ||
      s1 - s0 > tile_log)
    return (int)cudaErrorInvalidValue;
  const int tile = 1 << tile_log;
  const unsigned grid = 1u << (k - tile_log);
  const int threads = tile > 1 ? tile / 2 : 1;
  const size_t smem = (size_t)tile * 2 * sizeof(int4);
  auto s = (cudaStream_t)stream;
  auto o = (int32_t*)out;
  auto i = (const int32_t*)a;
  auto p = (const int32_t*)perm;
  auto w = (const int32_t*)tw;
  auto f0 = (const int32_t*)pre;
  auto f1 = (const int32_t*)scale;
  auto f2 = (const int32_t*)post;
  if (first && last)
    fft_pass_kernel<true, true><<<grid, threads, smem, s>>>(
        o, i, p, perm_log, w, tile_log, s0, s1, f0, f1, f2);
  else if (first)
    fft_pass_kernel<true, false><<<grid, threads, smem, s>>>(
        o, i, p, perm_log, w, tile_log, s0, s1, f0, f1, f2);
  else if (last)
    fft_pass_kernel<false, true><<<grid, threads, smem, s>>>(
        o, i, p, perm_log, w, tile_log, s0, s1, f0, f1, f2);
  else
    fft_pass_kernel<false, false><<<grid, threads, smem, s>>>(
        o, i, p, perm_log, w, tile_log, s0, s1, f0, f1, f2);
  return (int)cudaGetLastError();
}

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
