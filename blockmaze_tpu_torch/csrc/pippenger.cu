// Pippenger bucket accumulation over the sorted item stream.
//
// Replaces: blockmaze_tpu/msm/pippenger.py `_round_kernel` (one round of
// K items per lane, launched `rounds` times, each launch followed by an XLA
// scatter of the flushed buckets).
//
// What bounds the accumulation on this card: one mixed add per stream item
// (~11 Fq products in G1, ~33 in G2) plus a random 132/260-byte gather of
// the item's affine point. At the prover's sizes (2^18 points x 22 windows,
// 5.8M items) it is compute-bound, and latency-bound where lanes are few:
// each lane is one thread walking its range in order.
//
// Design. The TPU shape (rounds unrolled in Python, one grid step per item,
// no atomics, flushes scattered by XLA after each round) exists because a
// Pallas grid is sequential and bounded by VMEM. Here one launch walks each
// lane's whole contiguous range [t*L, (t+1)*L) of the key-sorted stream in
// a per-thread loop. An interior run of equal keys (a bucket) begins and
// ends inside one lane, so its flush is a plain store into the bucket
// arrays: no atomics and no scatter pass. What leaves the kernel equals
// what the JAX rounds leave: the tail accumulator, meta = (cur_key,
// head_key, seen), the head run's partial sum, and the flushed bucket rows
// with blind count 1. Keys and point ids arrive transposed to (L, T) so
// that neighbouring threads read neighbouring words.

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace bm;

namespace {

template <class F, bool BLIND>
__global__ void accumulate_kernel(
    const int32_t* keys, const int32_t* pids, const int32_t* px,
    const int32_t* py, const uint8_t* pinf, const int32_t* blind_x,
    const int32_t* blind_y, int32_t drop, long long T, long long L,
    int32_t* acc_x, int32_t* acc_y, int32_t* acc_z, int32_t* meta,
    int32_t* head_x, int32_t* head_y, int32_t* head_z, int32_t* bkt_x,
    int32_t* bkt_y, int32_t* bkt_z, int32_t* bkt_cnt) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  Jac<F> init;
  if (BLIND)
    init = Jac<F>{F::load(blind_x), F::load(blind_y), F::one()};
  else
    init = Jac<F>{F::zero(), F::one(), F::zero()};
  Jac<F> acc = init;
  Jac<F> head{F::zero(), F::one(), F::zero()};
  int32_t cur = keys[t], hk = drop, seen = 0;
  for (long long i = 0; i < L; ++i) {
    int32_t key = keys[i * T + t];
    long long pid = pids[i * T + t];
    bool is_new = key != cur;
    if (is_new) {
      if (seen && cur < drop) {
        store_jac(bkt_x, bkt_y, bkt_z, cur, acc);
        bkt_cnt[cur] = 1;
      } else if (!seen) {
        hk = cur;
        head = acc;
      }
      seen = 1;
      acc = init;
    }
    bool q_inf = pinf[pid] != 0 || key >= drop;
    F qx = F::load(px + pid * F::WORDS), qy = F::load(py + pid * F::WORDS);
    acc = BLIND ? mixed_add_noexc(acc, qx, qy, q_inf)
                : mixed_add(acc, qx, qy, q_inf);
    cur = key;
  }
  store_jac(acc_x, acc_y, acc_z, t, acc);
  store_jac(head_x, head_y, head_z, t, head);
  meta[t] = cur;
  meta[T + t] = hk;
  meta[2 * T + t] = seen;
}

}  // namespace

// curve: 1 = G1, 2 = G2. keys/pids: (L, T) int32; px/py: (n, 16|32) int32;
// pinf: n bytes; blind_x/blind_y: one coordinate each (ignored unless
// blind); outputs: acc/head (T, ...), meta (3, T), bkt (drop, ...) and
// bkt_cnt (drop,), which the caller zero-fills.
extern "C" int bm_msm_accumulate(
    int curve, int blind, const void* keys, const void* pids, const void* px,
    const void* py, const void* pinf, const void* blind_x,
    const void* blind_y, int drop, long long T, long long L, void* acc_x,
    void* acc_y, void* acc_z, void* meta, void* head_x, void* head_y,
    void* head_z, void* bkt_x, void* bkt_y, void* bkt_z, void* bkt_cnt,
    void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  constexpr int THREADS = 64;
  unsigned g = (unsigned)((T + THREADS - 1) / THREADS);
  auto s = (cudaStream_t)stream;
  auto c = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
#define BM_ACC_ARGS                                                          \
  c(keys), c(pids), c(px), c(py), (const uint8_t*)pinf, c(blind_x),          \
      c(blind_y), drop, T, L, o(acc_x), o(acc_y), o(acc_z), o(meta),         \
      o(head_x), o(head_y), o(head_z), o(bkt_x), o(bkt_y), o(bkt_z),         \
      o(bkt_cnt)
  if (curve == 1 && blind)
    accumulate_kernel<Fq, true><<<g, THREADS, 0, s>>>(BM_ACC_ARGS);
  else if (curve == 1)
    accumulate_kernel<Fq, false><<<g, THREADS, 0, s>>>(BM_ACC_ARGS);
  else if (blind)
    accumulate_kernel<Fq2, true><<<g, THREADS, 0, s>>>(BM_ACC_ARGS);
  else
    accumulate_kernel<Fq2, false><<<g, THREADS, 0, s>>>(BM_ACC_ARGS);
#undef BM_ACC_ARGS
  return (int)cudaGetLastError();
}
