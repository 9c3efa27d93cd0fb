// Pippenger boundary combine: the lanes' head and tail partial sums,
// reduced by key into their buckets.
//
// Replaces: the K3 `add` launches (blockmaze_tpu/curves/pcurve.py:129) of
// blockmaze_tpu/msm/pippenger.py's step 3, a 16-step flag-based
// Hillis-Steele scan of batched adds over the 2T partials (:539-591), with
// torch selects and rolls between the launches. The scan's shape came from
// a TPU with no atomics and a sequential grid; it costs ~16 x 2T adds
// where ~2T do the work.
//
// What bounds it on this card: integer multiplies (16 Fq CIOS products per
// G1 add, ~43 per G2 add) at the work-efficient count, fewer than 2T adds:
// microseconds at the card's IMAD rate. The real limit is latency: the
// tree's depth, not its width, sets the time.
//
// Design: one block takes 2*blockDim consecutive partials into shared
// memory and reduces them by key with a segmented tree (O(n) adds, depth
// log2(n)). A tree node keeps the partial sum of its first run at its first
// slot and that of its last run at its last slot; joining two nodes adds
// the left node's last run to the right node's first run when their keys
// match, and a run closed on both sides inside the node is stored straight
// into its bucket with its blind count. The block hands its first and last
// run (key, point, count) on; a second launch runs the same routine over
// those, and the last launch, over at most one block, stores them too.
// Runs of any length, across any number of blocks, reduce this way. The
// add is the complete one of curve.cuh: equal partial sums occur.

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace bm;

namespace {

// A run's sum and blind count into its bucket; keys >= drop are dead items.
template <class F>
__device__ __forceinline__ void put_bucket(int32_t* bx, int32_t* by,
                                           int32_t* bz, long long* bcnt,
                                           int32_t drop, int32_t key,
                                           const Jac<F>& p, long long cnt) {
  if (key >= drop) return;
  store_jac(bx, by, bz, key, p);
  bcnt[key] = cnt;
}

template <class F>
__global__ void __launch_bounds__(256)
combine_kernel(int final_pass, long long n, const int32_t* keys,
               const int32_t* px, const int32_t* py, const int32_t* pz,
               const long long* cnt, int32_t drop, int32_t* out_keys,
               int32_t* ox, int32_t* oy, int32_t* oz, long long* ocnt,
               int32_t* bx, int32_t* by, int32_t* bz, long long* bcnt) {
  extern __shared__ long long smem_ll[];
  const int items = 2 * blockDim.x;
  long long* cn = smem_ll;
  Jac<F>* pts = reinterpret_cast<Jac<F>*>(cn + items);
  int32_t* ks = reinterpret_cast<int32_t*>(pts + items);
  const long long base = (long long)blockIdx.x * items;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    long long g = base + i;
    if (g < n) {
      pts[i] = load_jac<F>(px, py, pz, g);
      cn[i] = cnt[g];
      ks[i] = keys[g];
    } else {
      pts[i] = infinity<F>();
      cn[i] = 0;
      ks[i] = drop;
    }
  }
  __syncthreads();
  for (int half = 1; half < items; half *= 2) {
    const int a = threadIdx.x * 2 * half;
    if (a < items) {
      const int m = a + half, e = a + 2 * half - 1;
      const int32_t kl = ks[m - 1], kr = ks[m];
      const bool sl = ks[a] == kl, sr = kr == ks[e];
      const int last_l = sl ? a : m - 1;
      if (kl == kr) {
        Jac<F> M = add(pts[last_l], pts[m]);
        long long cm = cn[last_l] + cn[m];
        if (sl) {
          pts[a] = M;
          cn[a] = cm;
        } else if (sr) {
          pts[e] = M;
          cn[e] = cm;
        } else {
          put_bucket(bx, by, bz, bcnt, drop, kl, M, cm);
        }
      } else {
        if (!sl) put_bucket(bx, by, bz, bcnt, drop, kl, pts[m - 1], cn[m - 1]);
        if (!sr) {
          put_bucket(bx, by, bz, bcnt, drop, kr, pts[m], cn[m]);
        } else {
          pts[e] = pts[m];
          cn[e] = cn[m];
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const int z = items - 1;
  const bool single = ks[0] == ks[z];
  if (final_pass) {
    put_bucket(bx, by, bz, bcnt, drop, ks[0], pts[0], cn[0]);
    if (!single) put_bucket(bx, by, bz, bcnt, drop, ks[z], pts[z], cn[z]);
    return;
  }
  const long long o = 2 * (long long)blockIdx.x;
  out_keys[o] = ks[0];
  store_jac(ox, oy, oz, o, pts[0]);
  ocnt[o] = cn[0];
  out_keys[o + 1] = ks[z];
  store_jac(ox, oy, oz, o + 1, single ? infinity<F>() : pts[z]);
  ocnt[o + 1] = single ? 0 : cn[z];
}

template <class F>
int launch_combine(int final_pass, long long n, const void* keys,
                   const void* px, const void* py, const void* pz,
                   const void* cnt, int drop, int threads, void* out_keys,
                   void* ox, void* oy, void* oz, void* ocnt, void* bx,
                   void* by, void* bz, void* bcnt, cudaStream_t s) {
  const int items = 2 * threads;
  const size_t smem = (size_t)items * (sizeof(long long) + sizeof(Jac<F>) +
                                       sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      combine_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned g = (unsigned)((n + items - 1) / items);
  auto c = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
  combine_kernel<F><<<g, threads, smem, s>>>(
      final_pass, n, c(keys), c(px), c(py), c(pz), (const long long*)cnt,
      drop, o(out_keys), o(ox), o(oy), o(oz), (long long*)ocnt, o(bx), o(by),
      o(bz), (long long*)bcnt);
  return (int)cudaGetLastError();
}

}  // namespace

// One pass of the combine. curve: 1 = G1, 2 = G2. keys (n,) int32 sorted;
// px/py/pz (n, ...) int32 Jacobian partials; cnt (n,) int64 blind counts.
// Blocks of 2*threads partials, 2 <= threads <= 256. final_pass = 0 writes two hand-off
// partials per block to out_* (keys, coordinates, int64 counts); 1 needs
// n <= 2*threads and writes every run. bx/by/bz/bcnt: the (drop, ...)
// bucket arrays and their int64 counts, written in place.
extern "C" int bm_msm_combine(int curve, int final_pass, long long n,
                              const void* keys, const void* px,
                              const void* py, const void* pz,
                              const void* cnt, int drop, int threads,
                              void* out_keys, void* ox, void* oy, void* oz,
                              void* ocnt, void* bx, void* by, void* bz,
                              void* bcnt, void* stream) {
  if (n <= 0 || threads < 2 || threads > 256 ||
      (threads & (threads - 1)) != 0 ||
      (final_pass && n > 2 * (long long)threads))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (curve == 1)
    return launch_combine<Fq>(final_pass, n, keys, px, py, pz, cnt, drop,
                              threads, out_keys, ox, oy, oz, ocnt, bx, by, bz,
                              bcnt, s);
  return launch_combine<Fq2>(final_pass, n, keys, px, py, pz, cnt, drop,
                             threads, out_keys, ox, oy, oz, ocnt, bx, by, bz,
                             bcnt, s);
}

