// Horner fold of the Pippenger window sums, res = sum_w 2^{c*w} * win_w, by
// one warp.
//
// Replaces: blockmaze_tpu/msm/pippenger.py `_fold_kernel` (pallas_call at
// :288, via `_fold_pallas` :341): c doublings and one add per window, one
// point chain.
//
// What bounds it on this card: the dependency chain. The fold is
// W*(c+1) = 273 point operations in a row (252 doublings, 21 adds at W = 22,
// c = 12): about 2,100 Fq products in G1 and 4,900 in G2, under a
// microsecond of the card's multiply rate, but each waits for the one
// before. One thread running the chain took 1.7 ms (G1) and 8.4 ms (G2,
// 255 registers and spills) on an H100.
//
// Design: the same sequence of doublings and complete adds as the plain
// version (fold_plain), with the same formulas (dbl-2009-l, add-2007-bl),
// so the result is bit-exact. What changes is how one point operation
// runs: its independent Fq products go to the 32 lanes of one warp, one
// product per lane, a round at a time. A doubling takes 3 rounds of products
// (G1 3/3/1 products, G2 7/6/3) in place of 7 or 16 in a row, an add 5
// rounds in place of 16 or 43. Lane 0 does the additions and subtractions
// between rounds and keeps the point state in shared memory, so no lane
// holds more than one product's registers. Operands and results cross
// through shared memory under __syncwarp.

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace bm;

namespace {

constexpr int LANES = 32;

// One round of independent Montgomery products: lane i computes
// r[i] = a[i] * b[i].
struct Round {
  E a[LANES], b[LANES], r[LANES];
};

__device__ __forceinline__ void run_round(Round& R, int n) {
  __syncwarp();
  const int l = threadIdx.x;
  if (l < n) R.r[l] = mul_e<FqP>(R.a[l], R.b[l]);
  __syncwarp();
}

// Placing a field product's Fq products into a round (lane 0) and reading
// the result back; Fq2 follows operator* and sqr of field.cuh exactly.
template <class F>
struct Slots;

template <>
struct Slots<Fq> {
  static constexpr int MUL = 1, SQR = 1;
  __device__ static void mul(Round& R, int k, const Fq& a, const Fq& b) {
    R.a[k] = a.c;
    R.b[k] = b.c;
  }
  __device__ static Fq mul_out(const Round& R, int k) { return Fq{R.r[k]}; }
  __device__ static void sqr(Round& R, int k, const Fq& a) { mul(R, k, a, a); }
  __device__ static Fq sqr_out(const Round& R, int k) { return Fq{R.r[k]}; }
};

template <>
struct Slots<Fq2> {
  static constexpr int MUL = 3, SQR = 2;
  __device__ static void mul(Round& R, int k, const Fq2& a, const Fq2& b) {
    R.a[k] = a.c0;
    R.b[k] = b.c0;
    R.a[k + 1] = a.c1;
    R.b[k + 1] = b.c1;
    R.a[k + 2] = add_e<FqP>(a.c0, a.c1);
    R.b[k + 2] = add_e<FqP>(b.c0, b.c1);
  }
  __device__ static Fq2 mul_out(const Round& R, int k) {
    const E& t0 = R.r[k];
    const E& t1 = R.r[k + 1];
    const E& s = R.r[k + 2];
    return Fq2{sub_e<FqP>(t0, t1), sub_e<FqP>(sub_e<FqP>(s, t0), t1)};
  }
  __device__ static void sqr(Round& R, int k, const Fq2& a) {
    R.a[k] = add_e<FqP>(a.c0, a.c1);
    R.b[k] = sub_e<FqP>(a.c0, a.c1);
    R.a[k + 1] = a.c0;
    R.b[k + 1] = a.c1;
  }
  __device__ static Fq2 sqr_out(const Round& R, int k) {
    return Fq2{R.r[k], add_e<FqP>(R.r[k + 1], R.r[k + 1])};
  }
};

// The fold's state and the intermediates of one point operation, in shared
// memory (written by lane 0 only).
template <class F>
struct State {
  Jac<F> P;  // the running result
  Jac<F> Q;  // the window sum to add
  F A, B, Ev, Z3, C8, X3;                       // dbl
  F Z1Z1, Z2Z2, ZZ, U1, U2, S1, H, r, I, V;  // add
  int doubling;
};

// P = dbl(P), dbl-2009-l in three product rounds.
template <class F>
__device__ void warp_dbl(Round& R, State<F>& S) {
  using SL = Slots<F>;
  const bool lead = threadIdx.x == 0;
  constexpr int M = SL::MUL, Q = SL::SQR;
  if (lead) {  // A = X^2, B = Y^2, YZ = Y*Z
    SL::sqr(R, 0, S.P.X);
    SL::sqr(R, Q, S.P.Y);
    SL::mul(R, 2 * Q, S.P.Y, S.P.Z);
  }
  run_round(R, 2 * Q + M);
  if (lead) {  // C = B^2, (X + B)^2, Fv = Ev^2
    S.A = SL::sqr_out(R, 0);
    S.B = SL::sqr_out(R, Q);
    F YZ = SL::mul_out(R, 2 * Q);
    S.Z3 = YZ + YZ;
    S.Ev = S.A + S.A + S.A;
    SL::sqr(R, 0, S.B);
    SL::sqr(R, Q, S.P.X + S.B);
    SL::sqr(R, 2 * Q, S.Ev);
  }
  run_round(R, 3 * Q);
  if (lead) {  // Ev * (D - X3)
    F C = SL::sqr_out(R, 0);
    F D = SL::sqr_out(R, Q) - S.A - C;
    D = D + D;
    F Fv = SL::sqr_out(R, 2 * Q);
    S.X3 = Fv - (D + D);
    F C8 = C + C;
    C8 = C8 + C8;
    S.C8 = C8 + C8;
    SL::mul(R, 0, S.Ev, D - S.X3);
  }
  run_round(R, M);
  if (lead) S.P = Jac<F>{S.X3, SL::mul_out(R, 0) - S.C8, S.Z3};
  __syncwarp();
}

// P = add(P, Q), add-2007-bl with the selects of curve.cuh `add`, in five
// product rounds (a doubling when P = Q).
template <class F>
__device__ void warp_add(Round& R, State<F>& S) {
  using SL = Slots<F>;
  const bool lead = threadIdx.x == 0;
  constexpr int M = SL::MUL, Q = SL::SQR;
  __syncwarp();
  if (S.P.Z.is_zero()) {  // every lane reads the same state
    __syncwarp();
    if (lead) S.P = S.Q;
    __syncwarp();
    return;
  }
  if (S.Q.Z.is_zero()) {
    __syncwarp();
    return;
  }
  if (lead) {  // Z1Z1, Z2Z2, (Z1 + Z2)^2
    SL::sqr(R, 0, S.P.Z);
    SL::sqr(R, Q, S.Q.Z);
    SL::sqr(R, 2 * Q, S.P.Z + S.Q.Z);
  }
  run_round(R, 3 * Q);
  if (lead) {  // U1 = X1*Z2Z2, U2 = X2*Z1Z1, Z2*Z2Z2, Z1*Z1Z1
    S.Z1Z1 = SL::sqr_out(R, 0);
    S.Z2Z2 = SL::sqr_out(R, Q);
    S.ZZ = SL::sqr_out(R, 2 * Q);
    SL::mul(R, 0, S.P.X, S.Z2Z2);
    SL::mul(R, M, S.Q.X, S.Z1Z1);
    SL::mul(R, 2 * M, S.Q.Z, S.Z2Z2);
    SL::mul(R, 3 * M, S.P.Z, S.Z1Z1);
  }
  run_round(R, 4 * M);
  if (lead) {  // S1 = Y1*(Z2 Z2Z2), S2 = Y2*(Z1 Z1Z1), I = (2H)^2, Z3
    S.U1 = SL::mul_out(R, 0);
    S.U2 = SL::mul_out(R, M);
    F T1 = SL::mul_out(R, 2 * M);
    F T2 = SL::mul_out(R, 3 * M);
    S.H = S.U2 - S.U1;
    SL::mul(R, 0, S.P.Y, T1);
    SL::mul(R, M, S.Q.Y, T2);
    SL::sqr(R, 2 * M, S.H + S.H);
    SL::mul(R, 2 * M + Q, S.ZZ - S.Z1Z1 - S.Z2Z2, S.H);
  }
  run_round(R, 3 * M + Q);
  if (lead) {
    S.S1 = SL::mul_out(R, 0);
    F S2 = SL::mul_out(R, M);
    S.I = SL::sqr_out(R, 2 * M);
    S.Z3 = SL::mul_out(R, 2 * M + Q);
    F r = S2 - S.S1;
    S.r = r + r;
    S.doubling = S.H.is_zero() && S.r.is_zero();
  }
  __syncwarp();
  if (S.doubling) {
    warp_dbl(R, S);
    return;
  }
  if (lead) {  // J = H*I, V = U1*I, r^2
    SL::mul(R, 0, S.H, S.I);
    SL::mul(R, M, S.U1, S.I);
    SL::sqr(R, 2 * M, S.r);
  }
  run_round(R, 2 * M + Q);
  if (lead) {  // S1*J, r*(V - X3)
    F J = SL::mul_out(R, 0);
    S.V = SL::mul_out(R, M);
    S.X3 = SL::sqr_out(R, 2 * M) - J - (S.V + S.V);
    SL::mul(R, 0, S.S1, J);
    SL::mul(R, M, S.r, S.V - S.X3);
  }
  run_round(R, 2 * M);
  if (lead) {
    F SJ = SL::mul_out(R, 0);
    F Y3 = SL::mul_out(R, M) - (SJ + SJ);
    S.P = Jac<F>{S.X3, Y3, S.Z3};
  }
  __syncwarp();
}

template <class F>
__global__ void __launch_bounds__(LANES)
fold_kernel(const int32_t* wx, const int32_t* wy, const int32_t* wz,
            int n_windows, int c, int32_t* ox, int32_t* oy, int32_t* oz) {
  __shared__ Round R;
  __shared__ State<F> S;
  const bool lead = threadIdx.x == 0;
  if (lead) S.P = load_jac<F>(wx, wy, wz, n_windows - 1);
  for (int w = n_windows - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) warp_dbl(R, S);
    if (lead) S.Q = load_jac<F>(wx, wy, wz, w);
    warp_add(R, S);
  }
  __syncwarp();
  if (lead) store_jac(ox, oy, oz, 0, S.P);
}

}  // namespace

// curve: 1 = G1, 2 = G2. win: (W, ...) Jacobian window sums; out: one
// point. One block of one warp.
extern "C" int bm_msm_fold(int curve, const void* wx, const void* wy,
                           const void* wz, int n_windows, int c, void* ox,
                           void* oy, void* oz, void* stream) {
  if (n_windows <= 0 || c < 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto i = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
  if (curve == 1)
    fold_kernel<Fq><<<1, LANES, 0, s>>>(i(wx), i(wy), i(wz), n_windows, c,
                                        o(ox), o(oy), o(oz));
  else
    fold_kernel<Fq2><<<1, LANES, 0, s>>>(i(wx), i(wy), i(wz), n_windows, c,
                                         o(ox), o(oy), o(oz));
  return (int)cudaGetLastError();
}
