// Jacobian group law of alt_bn128 G1 (over Fq) and G2 (over Fq2) as device
// functions, generic over the coordinate field.
//
// Replaces: the formulas and selects of blockmaze_tpu/curves/jcurve.py
// (_dbl, _add_core, _madd_core, point_double, point_add, point_mixed_add,
// point_mixed_add_noexc), which the JAX package's Pallas kernels
// (curves/pcurve.py, msm/pippenger.py) run on limb-major tiles.
//
// Design: the same formulas (dbl-2009-l, add-2007-bl, madd-2007-bl, a = 0)
// and the same outcome of every select, so the Jacobian triples equal the
// JAX package's and the plain torch version's bit for bit. The TPU computes
// both the sum and the doubling in every lane and selects; one thread per
// point here branches instead and computes the doubling only when it is
// needed, which gives the same values. Infinity is Z == 0.

#pragma once
#include "field.cuh"

namespace bm {

template <class F>
struct Jac {
  F X, Y, Z;
};

// Infinity as the plain versions build it (tcurve zeros: X = 0, Y = 1,
// Z = 0), so that padded slots carry the same bits in both.
template <class F>
__device__ __forceinline__ Jac<F> infinity() {
  return Jac<F>{F::zero(), F::one(), F::zero()};
}

template <class F>
__device__ __forceinline__ Jac<F> load_jac(const int32_t* x, const int32_t* y,
                                           const int32_t* z, long long i) {
  return Jac<F>{F::load(x + i * F::WORDS), F::load(y + i * F::WORDS),
                F::load(z + i * F::WORDS)};
}

template <class F>
__device__ __forceinline__ void store_jac(int32_t* x, int32_t* y, int32_t* z,
                                          long long i, const Jac<F>& p) {
  p.X.store(x + i * F::WORDS);
  p.Y.store(y + i * F::WORDS);
  p.Z.store(z + i * F::WORDS);
}

// dbl-2009-l. Doubling infinity gives Z3 = 2*Y*0 = 0: no select needed.
template <class F>
__device__ Jac<F> dbl(const Jac<F>& P) {
  F A = sqr(P.X);
  F B = sqr(P.Y);
  F C = sqr(B);
  F D = sqr(P.X + B) - A - C;
  D = D + D;
  F Ev = A + A + A;
  F Fv = sqr(Ev);
  F X3 = Fv - (D + D);
  F C8 = C + C;
  C8 = C8 + C8;
  C8 = C8 + C8;
  F Y3 = Ev * (D - X3) - C8;
  F YZ = P.Y * P.Z;
  return Jac<F>{X3, Y3, YZ + YZ};
}

// add-2007-bl, with the selects of jcurve.point_add: P = inf -> Q,
// Q = inf -> P, P = Q -> dbl(P); P = -Q gives Z3 = 0 by the formula.
template <class F>
__device__ Jac<F> add(const Jac<F>& P, const Jac<F>& Q) {
  bool p_inf = P.Z.is_zero();
  bool q_inf = Q.Z.is_zero();
  if (p_inf) return Q;
  if (q_inf) return P;
  F Z1Z1 = sqr(P.Z);
  F Z2Z2 = sqr(Q.Z);
  F U1 = P.X * Z2Z2;
  F U2 = Q.X * Z1Z1;
  F S1 = P.Y * (Q.Z * Z2Z2);
  F S2 = Q.Y * (P.Z * Z1Z1);
  F H = U2 - U1;
  F r = S2 - S1;
  r = r + r;
  if (H.is_zero() && r.is_zero()) return dbl(P);
  F I = sqr(H + H);
  F J = H * I;
  F V = U1 * I;
  F X3 = sqr(r) - J - (V + V);
  F SJ = S1 * J;
  F Y3 = r * (V - X3) - (SJ + SJ);
  F Z3 = (sqr(P.Z + Q.Z) - Z1Z1 - Z2Z2) * H;
  return Jac<F>{X3, Y3, Z3};
}

// madd-2007-bl core (Q affine, Z2 = 1), no exceptional cases. Also returns
// H and r for the doubling test.
template <class F>
__device__ __forceinline__ Jac<F> madd_core(const Jac<F>& P, const F& Qx,
                                            const F& Qy, F& H, F& r) {
  F Z1Z1 = sqr(P.Z);
  F U2 = Qx * Z1Z1;
  F S2 = Qy * (P.Z * Z1Z1);
  H = U2 - P.X;
  F HH = sqr(H);
  F I = HH + HH;
  I = I + I;
  F J = H * I;
  r = S2 - P.Y;
  r = r + r;
  F V = P.X * I;
  F X3 = sqr(r) - J - (V + V);
  F YJ = P.Y * J;
  F Y3 = r * (V - X3) - (YJ + YJ);
  F Z3 = sqr(P.Z + H) - Z1Z1 - HH;
  return Jac<F>{X3, Y3, Z3};
}

// jcurve.point_mixed_add: q_inf and p_inf lanes as the JAX selects leave
// them (both infinite -> (Qx, Qy, 0)).
template <class F>
__device__ Jac<F> mixed_add(const Jac<F>& P, const F& Qx, const F& Qy,
                            bool q_inf) {
  bool p_inf = P.Z.is_zero();
  if (p_inf) return Jac<F>{Qx, Qy, q_inf ? F::zero() : F::one()};
  if (q_inf) return P;
  F H, r;
  Jac<F> R = madd_core(P, Qx, Qy, H, r);
  if (H.is_zero() && r.is_zero()) return dbl(P);
  return R;
}

// jcurve.point_mixed_add_noexc: exact when P is neither infinity nor +-Q
// (the blinded accumulations guarantee that with overwhelming probability).
template <class F>
__device__ __forceinline__ Jac<F> mixed_add_noexc(const Jac<F>& P,
                                                  const F& Qx, const F& Qy,
                                                  bool q_inf) {
  if (q_inf) return P;
  F H, r;
  return madd_core(P, Qx, Qy, H, r);
}

}  // namespace bm
