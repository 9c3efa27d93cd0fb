// Montgomery arithmetic over the BN254 (alt_bn128) base field Fq and scalar
// field Fr, and the quadratic extension Fq2 = Fq[u]/(u^2 + 1), as device
// functions for the kernels in this directory.
//
// Replaces: blockmaze_tpu/fields/kfield.py (mul, add, sub, neg, KFqOps,
// KFq2Ops), the limb-major device-function library every Pallas kernel of
// the JAX package calls. No kernel of its own.
//
// Design: an element lives in registers as 8 x 32-bit limbs (the TPU's
// 16 x 16-bit limbs existed because its vector unit has no widening
// multiply; Hopper has 32x32->64 IMAD.WIDE). Montgomery radix R = 2^256 as
// in the JAX package, so residues are identical; mul is CIOS with one
// conditional subtraction, add/sub/neg are carry/borrow chains. Inputs are
// canonical (< p) and outputs canonical, which is what makes the results
// bit-equal to the JAX package and to the plain torch versions
// (fields/tfield.py) whatever the limb width.
//
// Memory layout at the kernel boundary is the JAX package's: one element is
// 16 int32 words holding 16-bit limbs (an Fq2 element is two of those).
// load/store repack between that and registers.
//
// What bounds the kernels on this card: integer multiply throughput (a
// 256-bit CIOS product is 128 IMAD.WIDE-equivalent operations plus carry
// adds). Memory traffic per element is at most a few hundred bytes, so
// every kernel here is compute-bound at batch sizes the prover uses.

#pragma once
#include <cstdint>

namespace bm {

// Modulus words, Montgomery one (R mod p) and -p^-1 mod 2^32. The arrays
// are function-local so that, inside the unrolled loops, each index is a
// compile-time constant and the words become immediates.
struct FqP {
  __device__ __forceinline__ static uint32_t P(int k) {
    const uint32_t w[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                           0x97816a91u, 0x8181585du, 0xb85045b6u,
                           0xe131a029u, 0x30644e72u};
    return w[k];
  }
  __device__ __forceinline__ static uint32_t ONE(int k) {
    const uint32_t w[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                           0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                           0x9a07df2fu, 0x0e0a77c1u};
    return w[k];
  }
  static constexpr uint32_t INV = 0xe4866389u;
};

struct FrP {
  __device__ __forceinline__ static uint32_t P(int k) {
    const uint32_t w[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                           0x2833e848u, 0x8181585du, 0xb85045b6u,
                           0xe131a029u, 0x30644e72u};
    return w[k];
  }
  __device__ __forceinline__ static uint32_t ONE(int k) {
    const uint32_t w[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u,
                           0x36fc7695u, 0x7879462eu, 0x666ea36fu,
                           0x9a07df2fu, 0x0e0a77c1u};
    return w[k];
  }
  static constexpr uint32_t INV = 0xefffffffu;
};

struct E {
  uint32_t v[8];
};

// ---- load / store between 16 x 16-bit int32 limbs and 8 x 32-bit --------

__device__ __forceinline__ E load_e(const int32_t* p) {
  E r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.v[k] = (uint32_t)p[2 * k] | ((uint32_t)p[2 * k + 1] << 16);
  return r;
}

__device__ __forceinline__ void store_e(int32_t* p, const E& a) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    p[2 * k] = (int32_t)(a.v[k] & 0xffffu);
    p[2 * k + 1] = (int32_t)(a.v[k] >> 16);
  }
}

// The same 16-word element as four 16-byte chunks, chunk q at p[q * stride]
// (stride 1 in device memory, which must then be 16-byte aligned; a
// thread's column of a shared-memory ring otherwise).
__device__ __forceinline__ E load_e4(const int4* p, int stride) {
  E r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4 w = p[q * stride];
    r.v[2 * q] = (uint32_t)w.x | ((uint32_t)w.y << 16);
    r.v[2 * q + 1] = (uint32_t)w.z | ((uint32_t)w.w << 16);
  }
  return r;
}

__device__ __forceinline__ void store_e4(int4* p, const E& a) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    p[q] = make_int4((int)(a.v[2 * q] & 0xffffu), (int)(a.v[2 * q] >> 16),
                     (int)(a.v[2 * q + 1] & 0xffffu),
                     (int)(a.v[2 * q + 1] >> 16));
}

// 8 x 32-bit limbs as two 16-byte words (the FFT's packed scratch layout).
__device__ __forceinline__ E e_from_int4(int4 lo, int4 hi) {
  E r;
  r.v[0] = (uint32_t)lo.x; r.v[1] = (uint32_t)lo.y;
  r.v[2] = (uint32_t)lo.z; r.v[3] = (uint32_t)lo.w;
  r.v[4] = (uint32_t)hi.x; r.v[5] = (uint32_t)hi.y;
  r.v[6] = (uint32_t)hi.z; r.v[7] = (uint32_t)hi.w;
  return r;
}

__device__ __forceinline__ int4 e_lo4(const E& a) {
  return make_int4((int)a.v[0], (int)a.v[1], (int)a.v[2], (int)a.v[3]);
}

__device__ __forceinline__ int4 e_hi4(const E& a) {
  return make_int4((int)a.v[4], (int)a.v[5], (int)a.v[6], (int)a.v[7]);
}

// ---- base field ops, templated on the modulus ----------------------------

template <class M>
__device__ __forceinline__ E zero_e() {
  E r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = 0u;
  return r;
}

template <class M>
__device__ __forceinline__ E one_e() {
  E r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = M::ONE(k);
  return r;
}

__device__ __forceinline__ bool is_zero_e(const E& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc |= a.v[k];
  return acc == 0u;
}

// x - p if (hi, x) >= p, else x.
template <class M>
__device__ __forceinline__ E cond_sub(const E& x, uint32_t hi) {
  E d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t s = (uint64_t)x.v[k] - M::P(k) - borrow;
    d.v[k] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  bool take = (hi != 0u) || (borrow == 0);
  E r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = take ? d.v[k] : x.v[k];
  return r;
}

template <class M>
__device__ __forceinline__ E add_e(const E& a, const E& b) {
  E s;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t t = (uint64_t)a.v[k] + b.v[k] + c;
    s.v[k] = (uint32_t)t;
    c = t >> 32;
  }
  return cond_sub<M>(s, (uint32_t)c);
}

template <class M>
__device__ __forceinline__ E sub_e(const E& a, const E& b) {
  E d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t t = (uint64_t)a.v[k] - b.v[k] - borrow;
    d.v[k] = (uint32_t)t;
    borrow = (t >> 32) & 1u;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t t = (uint64_t)d.v[k] + M::P(k) + c;
      d.v[k] = (uint32_t)t;
      c = t >> 32;
    }
  }
  return d;
}

template <class M>
__device__ __forceinline__ E neg_e(const E& a) {
  if (is_zero_e(a)) return a;
  return sub_e<M>(zero_e<M>(), a);
}

// CIOS Montgomery product a*b*2^-256 mod p. One operand canonical, the
// other < 2^256: the pre-subtraction value is < 2p, so one conditional
// subtraction gives the canonical residue.
template <class M>
__device__ __forceinline__ E mul_e(const E& a, const E& b) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.v[i] * b.v[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * M::INV;
    s = (uint64_t)t[0] + (uint64_t)m * M::P(0);
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * M::P(j) + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  E r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = t[k];
  return cond_sub<M>(r, t[8]);
}

// Inverse by Fermat: a^(p-2) by left-to-right square-and-multiply over the
// bits of p - 2 (compile-time words). A Montgomery-form input gives the
// Montgomery form of the inverse (each product keeps the factor R); 0 maps
// to 0. The branch on a bit is uniform across a warp. For both BN254
// moduli the chain is 253 squarings and 109 multiplies (362 products).
template <class M>
__device__ __forceinline__ uint32_t pm2_word(int k) {
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j == k) w = M::P(j);
  return k == 0 ? w - 2u : w;  // P(0) >= 2: no borrow
}

template <class M>
__device__ E inv_e(const E& a) {
  E r = a;  // the top bit of p - 2
  const int top = 31 - __clz((int)M::P(7));
#pragma unroll 1
  for (int k = 7; k >= 0; --k) {
    const uint32_t w = pm2_word<M>(k);
#pragma unroll 1
    for (int b = (k == 7 ? top - 1 : 31); b >= 0; --b) {
      r = mul_e<M>(r, r);
      if ((w >> b) & 1u) r = mul_e<M>(r, a);
    }
  }
  return r;
}

// ---- the two coordinate fields of the group law --------------------------

// G1 coordinates: Fq.
struct Fq {
  E c;
  static constexpr int WORDS = 16;  // int32 words per element in memory
  __device__ static Fq load(const int32_t* p) { return Fq{load_e(p)}; }
  __device__ static Fq load4(const int4* p, int stride) {
    return Fq{load_e4(p, stride)};
  }
  __device__ void store(int32_t* p) const { store_e(p, c); }
  __device__ static Fq zero() { return Fq{zero_e<FqP>()}; }
  __device__ static Fq one() { return Fq{one_e<FqP>()}; }
  __device__ bool is_zero() const { return is_zero_e(c); }
};

__device__ __forceinline__ Fq operator+(const Fq& a, const Fq& b) {
  return Fq{add_e<FqP>(a.c, b.c)};
}
__device__ __forceinline__ Fq operator-(const Fq& a, const Fq& b) {
  return Fq{sub_e<FqP>(a.c, b.c)};
}
__device__ __forceinline__ Fq operator*(const Fq& a, const Fq& b) {
  return Fq{mul_e<FqP>(a.c, b.c)};
}
__device__ __forceinline__ Fq sqr(const Fq& a) { return a * a; }
__device__ inline Fq inv(const Fq& a) { return Fq{inv_e<FqP>(a.c)}; }

// G2 coordinates: Fq2 with u^2 = -1. mul is the 3-product Karatsuba of
// KFq2Ops.mul, sqr the 2-product complex squaring of KFq2Ops.sqr.
struct Fq2 {
  E c0, c1;
  static constexpr int WORDS = 32;
  __device__ static Fq2 load(const int32_t* p) {
    return Fq2{load_e(p), load_e(p + 16)};
  }
  __device__ static Fq2 load4(const int4* p, int stride) {
    return Fq2{load_e4(p, stride), load_e4(p + 4 * stride, stride)};
  }
  __device__ void store(int32_t* p) const {
    store_e(p, c0);
    store_e(p + 16, c1);
  }
  __device__ static Fq2 zero() { return Fq2{zero_e<FqP>(), zero_e<FqP>()}; }
  __device__ static Fq2 one() { return Fq2{one_e<FqP>(), zero_e<FqP>()}; }
  __device__ bool is_zero() const { return is_zero_e(c0) && is_zero_e(c1); }
};

__device__ __forceinline__ Fq2 operator+(const Fq2& a, const Fq2& b) {
  return Fq2{add_e<FqP>(a.c0, b.c0), add_e<FqP>(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2 operator-(const Fq2& a, const Fq2& b) {
  return Fq2{sub_e<FqP>(a.c0, b.c0), sub_e<FqP>(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2 operator*(const Fq2& a, const Fq2& b) {
  E t0 = mul_e<FqP>(a.c0, b.c0);
  E t1 = mul_e<FqP>(a.c1, b.c1);
  E s = mul_e<FqP>(add_e<FqP>(a.c0, a.c1), add_e<FqP>(b.c0, b.c1));
  return Fq2{sub_e<FqP>(t0, t1), sub_e<FqP>(sub_e<FqP>(s, t0), t1)};
}
__device__ __forceinline__ Fq2 sqr(const Fq2& a) {
  E t = mul_e<FqP>(add_e<FqP>(a.c0, a.c1), sub_e<FqP>(a.c0, a.c1));
  E c1 = mul_e<FqP>(a.c0, a.c1);
  return Fq2{t, add_e<FqP>(c1, c1)};
}
// (a0 - a1 u) / (a0^2 + a1^2): one Fq inversion of the norm; 0 maps to 0.
__device__ inline Fq2 inv(const Fq2& a) {
  E ti = inv_e<FqP>(add_e<FqP>(mul_e<FqP>(a.c0, a.c0),
                               mul_e<FqP>(a.c1, a.c1)));
  return Fq2{mul_e<FqP>(a.c0, ti), neg_e<FqP>(mul_e<FqP>(a.c1, ti))};
}

}  // namespace bm
