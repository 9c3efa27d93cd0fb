// The proof's host group law (curves/native.py): BN254 G1 and G2 scalar
// products and adds, the MSM results taken from the card's Jacobian
// Montgomery limbs less their blind's surplus, and the proof's A, B and C
// (groth16/prover.py _combine), exact, in 4 x 64-bit Montgomery arithmetic.
//
// Fq elements are 4 little-endian 64-bit words in Montgomery form with
// R = 2^256, the card's R, so a card coordinate (16 x 16-bit limbs in
// 32-bit lanes) needs no conversion once reduced below q. Fq2 = Fq[u] /
// (u^2 + 1). Points are Jacobian (x = X/Z^2, y = Y/Z^3, Z = 0 at infinity)
// with dbl-2009-l and add-2007-bl (a = 0); add handles P + P (a double)
// and P + (-P) (infinity) exactly. A scalar product reduces its 256-bit
// scalar mod r and runs a 4-bit fixed window from the top; each result
// leaves as affine through one Fermat inversion.
//
// Buffers, 64-bit words: a G1 affine point is x[4] y[4] inf[1], a G2 one
// x.c0[4] x.c1[4] y.c0[4] y.c1[4] inf[1], coordinates in standard form
// (below 2^256; reduced mod q here), 0 0 1 at infinity as
// curves/host_curve.py has it; a scalar is 4 words. Curve codes: 1 G1,
// 2 G2.
//
// C ABI for ctypes.CDLL (no Python objects; the interpreter lock is
// released through each call): bm_hc_mul, bm_hc_add, bm_hc_msub,
// bm_hc_unblind and bm_hc_combine write their result and return 0, or -1
// for an unknown curve code; bm_hc_muls returns the scalar products the
// calling thread has made so far.

#include <cstdint>

namespace {

using u64 = uint64_t;
using u128 = unsigned __int128;

constexpr u64 kQ[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                       0xb85045b68181585dULL, 0x30644e72e131a029ULL};
constexpr u64 kR[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                       0xb85045b68181585dULL, 0x30644e72e131a029ULL};

constexpr u64 neg_inv(u64 q0) {
  u64 x = 1;  // Newton's iteration doubles the correct low bits
  for (int i = 0; i < 7; ++i) x *= 2 - q0 * x;
  return ~x + 1;
}
constexpr u64 kQinv = neg_inv(kQ[0]);  // -q^-1 mod 2^64

thread_local long long g_muls = 0;

struct Fq {
  u64 v[4];
};

bool geq(const u64 *a, const u64 *m) {
  for (int i = 3; i >= 0; --i)
    if (a[i] != m[i]) return a[i] > m[i];
  return true;
}

// a - m, a >= m
void sub_words(u64 *a, const u64 *m) {
  u64 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    const u128 d = (u128)a[i] - m[i] - borrow;
    a[i] = (u64)d;
    borrow = (u64)(d >> 64) & 1;
  }
}

// any 256-bit value mod m (m > 2^253, so at most 7 subtractions)
void reduce(u64 *a, const u64 *m) {
  while (geq(a, m)) sub_words(a, m);
}

Fq add(const Fq &a, const Fq &b) {
  Fq r;
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    const u128 s = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  if (geq(r.v, kQ)) sub_words(r.v, kQ);  // a + b < 2q < 2^255
  return r;
}

Fq sub(const Fq &a, const Fq &b) {
  Fq r;
  u64 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    const u128 d = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (u64)(d >> 64) & 1;
  }
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < 4; ++i) {
      const u128 s = (u128)r.v[i] + kQ[i] + carry;
      r.v[i] = (u64)s;
      carry = (u64)(s >> 64);
    }
  }
  return r;
}

// a * b * 2^-256 mod q (CIOS), a, b < q (every element here is reduced).
// q's top word is below 2^62, so every partial sum t stays below 2q <
// 2^255 and fits four words.
Fq mul(const Fq &a, const Fq &b) {
  u64 t0 = 0, t1 = 0, t2 = 0, t3 = 0;
  for (int i = 0; i < 4; ++i) {
    const u64 bi = b.v[i];
    u128 c = (u128)a.v[0] * bi + t0;
    t0 = (u64)c;
    c = (c >> 64) + (u128)a.v[1] * bi + t1;
    t1 = (u64)c;
    c = (c >> 64) + (u128)a.v[2] * bi + t2;
    t2 = (u64)c;
    c = (c >> 64) + (u128)a.v[3] * bi + t3;
    t3 = (u64)c;
    const u64 t4 = (u64)(c >> 64);
    const u64 m = t0 * kQinv;
    c = ((u128)m * kQ[0] + t0) >> 64;
    c += (u128)m * kQ[1] + t1;
    t0 = (u64)c;
    c = (c >> 64) + (u128)m * kQ[2] + t2;
    t1 = (u64)c;
    c = (c >> 64) + (u128)m * kQ[3] + t3;
    t2 = (u64)c;
    t3 = t4 + (u64)(c >> 64);
  }
  Fq r = {{t0, t1, t2, t3}};
  if (geq(r.v, kQ)) sub_words(r.v, kQ);
  return r;
}

Fq sqr(const Fq &a) { return mul(a, a); }
Fq neg(const Fq &a) { return sub(Fq{{0, 0, 0, 0}}, a); }
bool is_zero(const Fq &a) { return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]); }
bool eq(const Fq &a, const Fq &b) {
  return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
         a.v[3] == b.v[3];
}

// R mod q (Montgomery one) and R^2 mod q, by doubling 1 mod q
struct Consts {
  Fq one, r2;
  Consts() {
    Fq x = {{1, 0, 0, 0}};
    for (int i = 0; i < 256; ++i) x = add(x, x);
    one = x;
    for (int i = 0; i < 256; ++i) x = add(x, x);
    r2 = x;
  }
};
const Consts kC;

Fq to_mont(const u64 *w) {
  Fq a = {{w[0], w[1], w[2], w[3]}};
  reduce(a.v, kQ);
  return mul(a, kC.r2);
}

void from_mont(const Fq &a, u64 *w) {
  const Fq r = mul(a, Fq{{1, 0, 0, 0}});
  for (int i = 0; i < 4; ++i) w[i] = r.v[i];
}

// a^(q-2): a^-1 for a != 0, 0 for 0
Fq inv(const Fq &a) {
  u64 e[4] = {kQ[0] - 2, kQ[1], kQ[2], kQ[3]};
  Fq r = kC.one;
  for (int i = 255; i >= 0; --i) {
    r = sqr(r);
    if ((e[i / 64] >> (i % 64)) & 1) r = mul(r, a);
  }
  return r;
}

struct Fq2 {
  Fq c0, c1;
};

Fq2 add(const Fq2 &a, const Fq2 &b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}
Fq2 sub(const Fq2 &a, const Fq2 &b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
Fq2 neg(const Fq2 &a) { return {neg(a.c0), neg(a.c1)}; }
bool is_zero(const Fq2 &a) { return is_zero(a.c0) && is_zero(a.c1); }
bool eq(const Fq2 &a, const Fq2 &b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}

Fq2 mul(const Fq2 &a, const Fq2 &b) {
  const Fq a0b0 = mul(a.c0, b.c0), a1b1 = mul(a.c1, b.c1);
  const Fq m = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(a0b0, a1b1), sub(sub(m, a0b0), a1b1)};
}

Fq2 sqr(const Fq2 &a) {
  const Fq ab = mul(a.c0, a.c1);
  return {mul(add(a.c0, a.c1), sub(a.c0, a.c1)), add(ab, ab)};
}

// (c0 - c1 u) / (c0^2 + c1^2)
Fq2 inv(const Fq2 &a) {
  const Fq t = inv(add(sqr(a.c0), sqr(a.c1)));
  return {mul(a.c0, t), neg(mul(a.c1, t))};
}

// Each field's words in a buffer: its count and its reads and writes.
template <class F> struct Io;

template <> struct Io<Fq> {
  static constexpr int kWords = 4;
  static Fq one() { return kC.one; }
  static Fq zero() { return Fq{{0, 0, 0, 0}}; }
  static Fq read(const u64 *w) { return to_mont(w); }
  static void write(const Fq &a, u64 *w) { from_mont(a, w); }
  // 16 x 16-bit limbs in 32-bit lanes, Montgomery form, any value < 2^256
  static Fq read_card(const int32_t *limbs) {
    Fq a;
    for (int i = 0; i < 4; ++i) {
      a.v[i] = 0;
      for (int k = 0; k < 4; ++k)
        a.v[i] |= (u64)((uint32_t)limbs[4 * i + k] & 0xffff) << (16 * k);
    }
    reduce(a.v, kQ);
    return a;
  }
};

template <> struct Io<Fq2> {
  static constexpr int kWords = 8;
  static Fq2 one() { return {kC.one, Io<Fq>::zero()}; }
  static Fq2 zero() { return {Io<Fq>::zero(), Io<Fq>::zero()}; }
  static Fq2 read(const u64 *w) { return {to_mont(w), to_mont(w + 4)}; }
  static void write(const Fq2 &a, u64 *w) {
    from_mont(a.c0, w);
    from_mont(a.c1, w + 4);
  }
  static Fq2 read_card(const int32_t *limbs) {
    return {Io<Fq>::read_card(limbs), Io<Fq>::read_card(limbs + 16)};
  }
};

template <class F> struct Jac {
  F X, Y, Z;
};

template <class F> Jac<F> infinity() {
  return {Io<F>::one(), Io<F>::one(), Io<F>::zero()};
}

template <class F> Jac<F> neg(const Jac<F> &p) { return {p.X, neg(p.Y), p.Z}; }

// dbl-2009-l; infinity stays infinity (Z3 = 2 Y Z)
template <class F> Jac<F> dbl(const Jac<F> &p) {
  const F A = sqr(p.X), B = sqr(p.Y), C = sqr(B);
  F D = sub(sub(sqr(add(p.X, B)), A), C);
  D = add(D, D);
  const F E = add(add(A, A), A);
  const F X3 = sub(sqr(E), add(D, D));
  F C8 = add(C, C);
  C8 = add(C8, C8);
  C8 = add(C8, C8);
  const F Y3 = sub(mul(E, sub(D, X3)), C8);
  const F YZ = mul(p.Y, p.Z);
  return {X3, Y3, add(YZ, YZ)};
}

// add-2007-bl with the exceptional cases: either input at infinity, P + P,
// P + (-P)
template <class F> Jac<F> add(const Jac<F> &p, const Jac<F> &q) {
  if (is_zero(p.Z)) return q;
  if (is_zero(q.Z)) return p;
  const F Z1Z1 = sqr(p.Z), Z2Z2 = sqr(q.Z);
  const F U1 = mul(p.X, Z2Z2), U2 = mul(q.X, Z1Z1);
  const F S1 = mul(mul(p.Y, q.Z), Z2Z2), S2 = mul(mul(q.Y, p.Z), Z1Z1);
  if (eq(U1, U2)) return eq(S1, S2) ? dbl(p) : infinity<F>();
  const F H = sub(U2, U1);
  const F I = sqr(add(H, H));
  const F J = mul(H, I);
  F r = sub(S2, S1);
  r = add(r, r);
  const F V = mul(U1, I);
  const F X3 = sub(sub(sqr(r), J), add(V, V));
  const F S1J = mul(S1, J);
  const F Y3 = sub(mul(r, sub(V, X3)), add(S1J, S1J));
  const F Z3 = mul(sub(sub(sqr(add(p.Z, q.Z)), Z1Z1), Z2Z2), H);
  return {X3, Y3, Z3};
}

// (k mod r) p, 4-bit fixed window from the top
template <class F> Jac<F> mul(const Jac<F> &p, const u64 *scalar) {
  ++g_muls;
  u64 k[4] = {scalar[0], scalar[1], scalar[2], scalar[3]};
  reduce(k, kR);
  Jac<F> t[16];
  t[1] = p;
  t[2] = dbl(p);
  for (int i = 3; i < 16; ++i) t[i] = add(t[i - 1], p);
  Jac<F> acc = infinity<F>();
  bool started = false;
  for (int i = 63; i >= 0; --i) {
    const unsigned d = (k[i / 16] >> (4 * (i % 16))) & 15;
    if (started)
      for (int j = 0; j < 4; ++j) acc = dbl(acc);
    if (d) {
      acc = started ? add(acc, t[d]) : t[d];
      started = true;
    }
  }
  return acc;
}

template <class F> Jac<F> read_affine(const u64 *w) {
  const int n = Io<F>::kWords;
  if (w[2 * n]) return infinity<F>();
  return {Io<F>::read(w), Io<F>::read(w + n), Io<F>::one()};
}

// one inversion; 0 0 1 at infinity
template <class F> void write_affine(const Jac<F> &p, u64 *w) {
  const int n = Io<F>::kWords;
  if (is_zero(p.Z)) {
    for (int i = 0; i < 2 * n; ++i) w[i] = 0;
    w[2 * n] = 1;
    return;
  }
  const F zi = inv(p.Z), zi2 = sqr(zi);
  Io<F>::write(mul(p.X, zi2), w);
  Io<F>::write(mul(mul(p.Y, zi2), zi), w + n);
  w[2 * n] = 0;
}

template <class F> void mul_affine(const u64 *p, const u64 *k, u64 *out) {
  write_affine(mul(read_affine<F>(p), k), out);
}

template <class F> void add_affine(const u64 *p, const u64 *q, u64 *out) {
  write_affine(add(read_affine<F>(p), read_affine<F>(q)), out);
}

// p - m R
template <class F> Jac<F> msub(const Jac<F> &p, const u64 *R, const u64 *m) {
  return add(p, neg(mul(read_affine<F>(R), m)));
}

template <class F>
void unblind(const int32_t *X, const int32_t *Y, const int32_t *Z,
             const u64 *R, const u64 *m, u64 *out) {
  const Jac<F> p = {Io<F>::read_card(X), Io<F>::read_card(Y),
                    Io<F>::read_card(Z)};
  write_affine(msub(p, R, m), out);
}

constexpr int kG1 = 9, kG2 = 17;

}  // namespace

extern "C" long long bm_hc_muls() { return g_muls; }

extern "C" int bm_hc_mul(int curve, const u64 *p, const u64 *k, u64 *out) {
  if (curve == 1) mul_affine<Fq>(p, k, out);
  else if (curve == 2) mul_affine<Fq2>(p, k, out);
  else return -1;
  return 0;
}

extern "C" int bm_hc_add(int curve, const u64 *p, const u64 *q, u64 *out) {
  if (curve == 1) add_affine<Fq>(p, q, out);
  else if (curve == 2) add_affine<Fq2>(p, q, out);
  else return -1;
  return 0;
}

// affine p - m R
extern "C" int bm_hc_msub(int curve, const u64 *p, const u64 *R,
                          const u64 *m, u64 *out) {
  if (curve == 1) write_affine(msub(read_affine<Fq>(p), R, m), out);
  else if (curve == 2) write_affine(msub(read_affine<Fq2>(p), R, m), out);
  else return -1;
  return 0;
}

// the card's Jacobian Montgomery (X, Y, Z) less m R, affine: X, Y, Z are
// 16 limbs each (G1) or 32 (G2: c0's, then c1's)
extern "C" int bm_hc_unblind(int curve, const int32_t *X, const int32_t *Y,
                             const int32_t *Z, const u64 *R, const u64 *m,
                             u64 *out) {
  if (curve == 1) unblind<Fq>(X, Y, Z, R, m, out);
  else if (curve == 2) unblind<Fq2>(X, Y, Z, R, m, out);
  else return -1;
  return 0;
}

// The proof from the key's constants and the unblinded MSM results:
//   A = alpha + At + r delta,  B = beta + Bt + s delta (G2 and G1),
//   C = Ht + Lt + s A + r B1 - (r s mod r) delta
// consts: alpha_g1 beta_g1 beta_g2 delta_g1 delta_g2 (61 words); terms:
// At Bt2 Bt1 Ht Lt (53 words); scalars: r s rs (12 words); out: A (G1),
// B (G2), C (G1), 35 words. Six scalar products.
extern "C" int bm_hc_combine(const u64 *consts, const u64 *terms,
                             const u64 *scalars, u64 *out) {
  const Jac<Fq> alpha = read_affine<Fq>(consts);
  const Jac<Fq> beta1 = read_affine<Fq>(consts + kG1);
  const Jac<Fq2> beta2 = read_affine<Fq2>(consts + 2 * kG1);
  const Jac<Fq> delta1 = read_affine<Fq>(consts + 2 * kG1 + kG2);
  const Jac<Fq2> delta2 = read_affine<Fq2>(consts + 3 * kG1 + kG2);
  const Jac<Fq> At = read_affine<Fq>(terms);
  const Jac<Fq2> Bt2 = read_affine<Fq2>(terms + kG1);
  const Jac<Fq> Bt1 = read_affine<Fq>(terms + kG1 + kG2);
  const Jac<Fq> Ht = read_affine<Fq>(terms + 2 * kG1 + kG2);
  const Jac<Fq> Lt = read_affine<Fq>(terms + 3 * kG1 + kG2);
  const u64 *r = scalars, *s = scalars + 4, *rs = scalars + 8;
  const Jac<Fq> A = add(add(alpha, At), mul(delta1, r));
  const Jac<Fq> B1 = add(add(beta1, Bt1), mul(delta1, s));
  const Jac<Fq2> B2 = add(add(beta2, Bt2), mul(delta2, s));
  const Jac<Fq> C = add(add(add(Ht, Lt), mul(A, s)),
                        add(mul(B1, r), neg(mul(delta1, rs))));
  write_affine(A, out);
  write_affine(B2, out + kG1);
  write_affine(C, out + kG1 + kG2);
  return 0;
}
