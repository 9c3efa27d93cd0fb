// Pippenger weighted bucket sums: win_w = sum_{d>=1} d * S_{w,d} for every
// window in one launch.
//
// Replaces: the K3 `add` (blockmaze_tpu/curves/pcurve.py:129) and K4
// `double` (:141) launches of blockmaze_tpu/msm/pippenger.py's step 4, a
// 12-level weighted-pair tree over every window's 2^c buckets (:593-637):
// 47 adds and 11 doubles of batches from 22*2^11 points down to 22, with
// torch reshapes and copies between them.
//
// What bounds it on this card: integer multiplies at 2 adds per nonempty
// bucket (16 Fq products per G1 add, ~43 per G2 add), tens of microseconds
// at the card's IMAD rate. The real limit is latency: a chain of ~20 point
// operations per thread and then a tree, and the G2 add holds ~255
// registers, so few threads are resident.
//
// Design: thread p of a window walks a chunk of k buckets from the top with
// a running sum and a running weighted sum (2 adds per bucket), giving
// (t = k * s, w = sum of 1-based local weight * S); the nodes join in shared
// memory by w' = (w_lo + w_hi) + t_hi, t' = 2 (t_lo + t_hi), and across the
// blocks of a window by the last block to finish (threadfence and an atomic
// counter), whose root w is win_w. Several blocks per window fill the SMs
// that one block per window (22 of 132) would leave idle. The point
// operations are called out of line: inlining their ~8 call sites made
// this file take minutes in ptxas. The add is the complete one of
// curve.cuh: equal bucket sums occur.

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace bm;

namespace {

template <class F>
__device__ __forceinline__ Jac<F> load_jac_cg(const int32_t* x,
                                              const int32_t* y,
                                              const int32_t* z, long long i) {
  int32_t buf[3][F::WORDS];
#pragma unroll
  for (int k = 0; k < F::WORDS; ++k) {
    buf[0][k] = __ldcg(x + i * F::WORDS + k);
    buf[1][k] = __ldcg(y + i * F::WORDS + k);
    buf[2][k] = __ldcg(z + i * F::WORDS + k);
  }
  return Jac<F>{F::load(buf[0]), F::load(buf[1]), F::load(buf[2])};
}

template <class F>
__device__ __noinline__ Jac<F> add_call(const Jac<F>& P, const Jac<F>& Q) {
  return add(P, Q);
}

template <class F>
__device__ __noinline__ Jac<F> dbl_call(const Jac<F>& P) {
  return dbl(P);
}

// Joins n (a power of two) adjacent (t, w) nodes in shared memory, pairing
// neighbours at every level; the root lands in slot 0. Every thread of the
// block calls it.
template <class F>
__device__ void weighted_tree(Jac<F>* tt, Jac<F>* ww, int n) {
  for (int half = 1; half < n; half *= 2) {
    const int a = threadIdx.x * 2 * half;
    if (a < n) {
      const int h = a + half;
      Jac<F> w = add_call(add_call(ww[a], ww[h]), tt[h]);
      Jac<F> t = dbl_call(add_call(tt[a], tt[h]));
      ww[a] = w;
      tt[a] = t;
    }
    __syncthreads();
  }
}

template <class F>
__global__ void __launch_bounds__(64)
triangle_kernel(const int32_t* bx, const int32_t* by, const int32_t* bz,
                int nb, int chunk, int log_chunk, int blocks_per_window,
                int32_t* sx, int32_t* sy, int32_t* sz, int32_t* swx,
                int32_t* swy, int32_t* swz, int* counters, int32_t* ox,
                int32_t* oy, int32_t* oz) {
  extern __shared__ long long smem_ll[];
  __shared__ int is_last;
  const int P = blockDim.x;
  Jac<F>* tt = reinterpret_cast<Jac<F>*>(smem_ll);
  Jac<F>* ww = tt + P;
  const int win = blockIdx.x / blocks_per_window;
  const int blk = blockIdx.x % blocks_per_window;
  // slot j of the window is bucket d = j + 1; the last slot pads to 2^c
  const long long row0 = (long long)win * nb + 1;
  const int j0 = (blk * P + threadIdx.x) * chunk;
  Jac<F> run = infinity<F>(), acc = infinity<F>();
  for (int i = chunk - 1; i >= 0; --i) {
    const int j = j0 + i;
    Jac<F> S = j < nb - 1 ? load_jac<F>(bx, by, bz, row0 + j) : infinity<F>();
    run = add_call(run, S);
    acc = add_call(acc, run);
  }
  for (int k = 0; k < log_chunk; ++k) run = dbl_call(run);
  tt[threadIdx.x] = run;
  ww[threadIdx.x] = acc;
  __syncthreads();
  weighted_tree(tt, ww, P);
  if (blocks_per_window == 1) {
    if (threadIdx.x == 0) store_jac(ox, oy, oz, win, ww[0]);
    return;
  }
  if (threadIdx.x == 0) {
    const long long s = (long long)win * blocks_per_window + blk;
    store_jac(sx, sy, sz, s, tt[0]);
    store_jac(swx, swy, swz, s, ww[0]);
    __threadfence();
    is_last = atomicAdd(&counters[win], 1) == blocks_per_window - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < blocks_per_window; i += P) {
    const long long s = (long long)win * blocks_per_window + i;
    tt[i] = load_jac_cg<F>(sx, sy, sz, s);
    ww[i] = load_jac_cg<F>(swx, swy, swz, s);
  }
  __syncthreads();
  weighted_tree(tt, ww, blocks_per_window);
  if (threadIdx.x == 0) store_jac(ox, oy, oz, win, ww[0]);
}

template <class F>
int launch_triangle(int n_windows, int nb, const void* bx, const void* by,
                    const void* bz, int chunk, int threads,
                    int blocks_per_window, void* sx, void* sy, void* sz,
                    void* swx, void* swy, void* swz, void* counters, void* ox,
                    void* oy, void* oz, cudaStream_t s) {
  int log_chunk = 0;
  while ((1 << log_chunk) < chunk) ++log_chunk;
  const size_t smem = 2 * (size_t)threads * sizeof(Jac<F>);
  cudaError_t err = cudaFuncSetAttribute(
      triangle_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto c = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
  triangle_kernel<F><<<n_windows * blocks_per_window, threads, smem, s>>>(
      c(bx), c(by), c(bz), nb, chunk, log_chunk, blocks_per_window, o(sx),
      o(sy), o(sz), o(swx), o(swy), o(swz), (int*)counters, o(ox), o(oy),
      o(oz));
  return (int)cudaGetLastError();
}

}  // namespace

// win_w = sum_{d=1}^{nb-1} d * S_{w,d} for the (n_windows * nb, ...)
// bucket arrays bx/by/bz. Each thread takes `chunk` buckets; `threads`
// threads per block and `blocks_per_window` blocks per window, with
// chunk * threads * blocks_per_window == nb, all powers of two, and
// blocks_per_window <= threads <= 64. s*/sw*:
// (n_windows * blocks_per_window, ...) int32 scratch; counters:
// n_windows zero-filled int32; out: (n_windows, ...) int32.
extern "C" int bm_msm_triangle(int curve, int n_windows, int nb,
                               const void* bx, const void* by, const void* bz,
                               int chunk, int threads, int blocks_per_window,
                               void* sx, void* sy, void* sz, void* swx,
                               void* swy, void* swz, void* counters, void* ox,
                               void* oy, void* oz, void* stream) {
  auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  if (n_windows <= 0 || !pow2(chunk) || !pow2(threads) || threads > 64 ||
      !pow2(blocks_per_window) || blocks_per_window > threads ||
      (long long)chunk * threads * blocks_per_window != nb)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (curve == 1)
    return launch_triangle<Fq>(n_windows, nb, bx, by, bz, chunk, threads,
                               blocks_per_window, sx, sy, sz, swx, swy, swz,
                               counters, ox, oy, oz, s);
  return launch_triangle<Fq2>(n_windows, nb, bx, by, bz, chunk, threads,
                              blocks_per_window, sx, sy, sz, swx, swy, swz,
                              counters, ox, oy, oz, s);
}
