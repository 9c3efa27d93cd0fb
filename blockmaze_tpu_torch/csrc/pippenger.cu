// Pippenger bucket accumulation over the sorted item stream.
//
// Replaces: blockmaze_tpu/msm/pippenger.py `_round_kernel` (one round of
// K items per lane, launched `rounds` times, each launch followed by an XLA
// scatter of the flushed buckets).
//
// What bounds the accumulation on this card: one mixed add per live item
// (11 Fq products in G1, 29 in G2) plus a random 128/256-byte gather of the
// item's affine point. msm/pippenger.py feeds only the live items (nonzero
// digit, finite point), so the work is what the scalars need: for the mint
// witness's bit-valued wires that is ~1.5% of the W*n (window, point)
// pairs. Where the stream is dense the kernel is compute-bound; where lanes
// are few it is bound by each lane's chain of dependent adds.
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
//
// The gather is pipelined: while a thread adds item i, cp.async brings item
// i+1's point (16-byte chunks, L2 only) into the thread's column of a
// two-slot ring in shared memory, and plain loads bring item i+2's key and
// point id, so the gather's latency hides behind the 11 or 29 products.
// The ring is laid out [slot][chunk][thread], so a warp's 16-byte reads hit
// distinct banks. Only the accumulator lives in registers across the loop:
// the head run's sum is stored as soon as it closes and the blind start is
// re-read from memory at each reset, which keeps the G2 instance within
// its registers.

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace bm;

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Threads per block: 32 KB of ring either way.
template <class F>
struct Acc;
template <>
struct Acc<Fq> {
  static constexpr int THREADS = 128;
};
template <>
struct Acc<Fq2> {
  static constexpr int THREADS = 64;
};

// cp.async item pid's X and Y into one slot of the thread's ring column.
template <class F, int NT>
__device__ __forceinline__ void fetch_point(int4 (*slot)[NT], int tid,
                                            const int32_t* px,
                                            const int32_t* py,
                                            long long pid) {
  constexpr int CH = F::WORDS / 4;
  const int4* gx = reinterpret_cast<const int4*>(px + pid * F::WORDS);
  const int4* gy = reinterpret_cast<const int4*>(py + pid * F::WORDS);
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    cp_async16(&slot[q][tid], gx + q);
    cp_async16(&slot[CH + q][tid], gy + q);
  }
}

// curve.cuh's mixed_add with its rare doubling (Q = P) called out of line,
// which keeps the unblinded G2 instance within its registers.
template <class F>
__device__ __noinline__ Jac<F> dbl_call(const Jac<F> P) {
  return dbl(P);
}

template <class F>
__device__ __forceinline__ Jac<F> mixed_add_acc(const Jac<F>& P, const F& Qx,
                                                const F& Qy, bool q_inf) {
  if (P.Z.is_zero()) return Jac<F>{Qx, Qy, q_inf ? F::zero() : F::one()};
  if (q_inf) return P;
  F H, r;
  Jac<F> R = madd_core(P, Qx, Qy, H, r);
  if (H.is_zero() && r.is_zero()) return dbl_call(P);
  return R;
}

template <class F, bool BLIND>
__device__ __forceinline__ Jac<F> run_start(const int32_t* bx,
                                            const int32_t* by) {
  if (BLIND) return Jac<F>{F::load(bx), F::load(by), F::one()};
  return infinity<F>();
}

template <class F, bool BLIND>
__global__ void __launch_bounds__(Acc<F>::THREADS) accumulate_kernel(
    const int32_t* keys, const int32_t* pids, const int32_t* px,
    const int32_t* py, const uint8_t* pinf, const int32_t* blind_x,
    const int32_t* blind_y, int32_t drop, long long T, long long L,
    int32_t* acc_x, int32_t* acc_y, int32_t* acc_z, int32_t* meta,
    int32_t* head_x, int32_t* head_y, int32_t* head_z, int32_t* bkt_x,
    int32_t* bkt_y, int32_t* bkt_z, int32_t* bkt_cnt) {
  constexpr int NT = Acc<F>::THREADS;
  constexpr int CH = F::WORDS / 4;  // 16-byte chunks per coordinate
  __shared__ int4 ring[2][2 * CH][NT];
  const int tid = threadIdx.x;
  const long long t = (long long)blockIdx.x * NT + tid;
  if (t >= T) return;  // no block-wide barrier below

  // item i in (key, pid, q_inf); item i+1's key and pid in (nkey, npid)
  int32_t key = keys[t];
  long long pid = pids[t];
  fetch_point<F, NT>(ring[0], tid, px, py, pid);
  cp_async_commit();
  bool pt_inf = pinf[pid] != 0;
  int32_t nkey = drop;
  long long npid = 0;
  if (L > 1) {
    nkey = keys[T + t];
    npid = pids[T + t];
  }
  Jac<F> acc = run_start<F, BLIND>(blind_x, blind_y);
  int32_t cur = key, hk = drop, seen = 0;
  for (long long i = 0; i < L; ++i) {
    const int slot = (int)(i & 1);
    bool npt_inf = false;
    int32_t nnkey = drop;
    long long nnpid = 0;
    if (i + 1 < L) {
      fetch_point<F, NT>(ring[slot ^ 1], tid, px, py, npid);
      npt_inf = pinf[npid] != 0;
      if (i + 2 < L) {
        nnkey = keys[(i + 2) * T + t];
        nnpid = pids[(i + 2) * T + t];
      }
    }
    cp_async_commit();  // possibly empty: one group per iteration
    if (key != cur) {
      if (seen && cur < drop) {
        store_jac(bkt_x, bkt_y, bkt_z, cur, acc);
        bkt_cnt[cur] = 1;
      } else if (!seen) {
        hk = cur;
        store_jac(head_x, head_y, head_z, t, acc);
      }
      seen = 1;
      acc = run_start<F, BLIND>(blind_x, blind_y);
    }
    cp_async_wait_one();  // item i's point has landed
    const bool q_inf = pt_inf || key >= drop;
    F qx = F::load4(&ring[slot][0][tid], NT);
    F qy = F::load4(&ring[slot][CH][tid], NT);
    acc = BLIND ? mixed_add_noexc(acc, qx, qy, q_inf)
                : mixed_add_acc(acc, qx, qy, q_inf);
    cur = key;
    key = nkey;
    pt_inf = npt_inf;
    nkey = nnkey;
    npid = nnpid;
  }
  store_jac(acc_x, acc_y, acc_z, t, acc);
  if (!seen) store_jac(head_x, head_y, head_z, t, infinity<F>());
  meta[t] = cur;
  meta[T + t] = hk;
  meta[2 * T + t] = seen;
}

template <class F>
int launch(int blind, const void* keys, const void* pids, const void* px,
           const void* py, const void* pinf, const void* blind_x,
           const void* blind_y, int drop, long long T, long long L,
           void* acc_x, void* acc_y, void* acc_z, void* meta, void* head_x,
           void* head_y, void* head_z, void* bkt_x, void* bkt_y, void* bkt_z,
           void* bkt_cnt, cudaStream_t s) {
  constexpr int NT = Acc<F>::THREADS;
  unsigned g = (unsigned)((T + NT - 1) / NT);
  auto c = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
#define BM_ACC_ARGS                                                          \
  c(keys), c(pids), c(px), c(py), (const uint8_t*)pinf, c(blind_x),          \
      c(blind_y), drop, T, L, o(acc_x), o(acc_y), o(acc_z), o(meta),         \
      o(head_x), o(head_y), o(head_z), o(bkt_x), o(bkt_y), o(bkt_z),         \
      o(bkt_cnt)
  if (blind)
    accumulate_kernel<F, true><<<g, NT, 0, s>>>(BM_ACC_ARGS);
  else
    accumulate_kernel<F, false><<<g, NT, 0, s>>>(BM_ACC_ARGS);
#undef BM_ACC_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// curve: 1 = G1, 2 = G2. keys/pids: (L, T) int32; px/py: (n, 16|32) int32,
// 16-byte aligned; pinf: n bytes; blind_x/blind_y: one coordinate each
// (ignored unless blind); outputs: acc/head (T, ...), meta (3, T), bkt
// (drop, ...) and bkt_cnt (drop,), which the caller zero-fills.
extern "C" int bm_msm_accumulate(
    int curve, int blind, const void* keys, const void* pids, const void* px,
    const void* py, const void* pinf, const void* blind_x,
    const void* blind_y, int drop, long long T, long long L, void* acc_x,
    void* acc_y, void* acc_z, void* meta, void* head_x, void* head_y,
    void* head_z, void* bkt_x, void* bkt_y, void* bkt_z, void* bkt_cnt,
    void* stream) {
  if (T <= 0 || L <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  return curve == 1
             ? launch<Fq>(blind, keys, pids, px, py, pinf, blind_x, blind_y,
                          drop, T, L, acc_x, acc_y, acc_z, meta, head_x,
                          head_y, head_z, bkt_x, bkt_y, bkt_z, bkt_cnt, s)
             : launch<Fq2>(blind, keys, pids, px, py, pinf, blind_x, blind_y,
                           drop, T, L, acc_x, acc_y, acc_z, meta, head_x,
                           head_y, head_z, bkt_x, bkt_y, bkt_z, bkt_cnt, s);
}
