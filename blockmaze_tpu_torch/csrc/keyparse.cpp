// Host tokenizer of libsnark's decimal-text proving key: the file to the
// limb arrays that the decompression kernels (keyload.cu) and the DevicePK
// take. Decimal to binary only: no field arithmetic, no GMP.
//
// Counterpart of blockmaze_tpu/native/keyparse.cpp (its Scanner :72 and
// bmtpu_parse_pk :398), which also decompressed every point on the host
// through GMP. Here a point leaves as its compressed form (x in standard
// form, the parity bit of y, the zero flag) and its y is found on the card.
//
// Layout walked (serialization/libsnark_io.py load_proving_key):
//   alpha_g1 beta_g1 beta_g2 delta_g1 delta_g2
//   A_query: n, n G1
//   B_query: domain, nidx, idx*, nval, (G2 G1)*
//   H_query, L_query: n, n G1
//   cs: primary aux ncons, ncons x (a b c), each lc: nterms, (index coeff)*
// G1: is_zero x lsb(y); G2: is_zero x.c0 x.c1 lsb(y.c0).
//
// Outputs (bm_keytext_fill): every G1 point of the queries in the order A,
// B (its G1 half), H, L and every G2 point of B, each x as 16 x 16-bit
// little-endian limbs in 32-bit lanes (G2: c0 then c1), with its parity bit
// and zero flag; B's indices; the COO of the constraint matrices, selector
// a, then b, then c, constraint by constraint, terms in file order (rows,
// variables, coefficients reduced mod r as standard-form limbs). Decimal
// tokens convert through 64-bit chunk arithmetic (19 digits a step); a
// token of more than 256 bits, a token that is not a decimal number, a
// count larger than the rest of the file and a file that ends early are
// errors that name the byte offset.
//
// C ABI for ctypes: bm_keytext_parse returns a handle (null on error, the
// message in err), bm_keytext_fill copies into caller-allocated arrays,
// bm_keytext_free releases the handle.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// r, the BN254 scalar field's modulus, as 4 x 64-bit little-endian words
const uint64_t R_MOD[4] = {0x43e1f593f0000001ull, 0x2833e84879b97091ull,
                           0xb85045b68181585dull, 0x30644e72e131a029ull};

struct ParseError {
  std::string msg;
};

struct U256 {
  uint64_t w[4];
};

struct Scanner {
  std::vector<char> buf;
  size_t pos = 0;

  bool open(const char* path, std::string& err) {
    FILE* f = fopen(path, "rb");
    if (!f) {
      err = std::string("cannot open ") + path;
      return false;
    }
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    buf.resize(len > 0 ? (size_t)len : 0);
    size_t got = buf.empty() ? 0 : fread(buf.data(), 1, buf.size(), f);
    fclose(f);
    if (got != buf.size()) {
      err = std::string("short read of ") + path;
      return false;
    }
    return true;
  }

  static bool space(char c) {
    return c == ' ' || c == '\n' || c == '\r' || c == '\t' || c == '\v' ||
           c == '\f';
  }

  [[noreturn]] void fail(const std::string& what, size_t at) const {
    throw ParseError{what + " at byte offset " + std::to_string(at)};
  }

  // The next token as [start, end); `what` names it in the error when the
  // file ends first.
  void next(const char* what, size_t& start, size_t& end) {
    const size_t n = buf.size();
    while (pos < n && space(buf[pos])) ++pos;
    if (pos >= n)
      fail(std::string("truncated file: expected ") + what + ", found the end",
           pos);
    start = pos;
    while (pos < n && !space(buf[pos])) ++pos;
    end = pos;
  }

  // A count or index: at most 18 decimal digits.
  long long next_long(const char* what) {
    size_t s, e;
    next(what, s, e);
    if (e - s > 18) fail(std::string("too long a number for ") + what, s);
    long long v = 0;
    for (size_t i = s; i < e; ++i) {
      const char c = buf[i];
      if (c < '0' || c > '9') fail(std::string("not a decimal ") + what, s);
      v = v * 10 + (c - '0');
    }
    return v;
  }

  // An index the arrays hold as int32: at most INT32_MAX.
  int32_t next_index(const char* what) {
    const size_t at = pos;
    const long long v = next_long(what);
    if (v > INT32_MAX)
      fail(std::string(what) + " " + std::to_string(v) +
               " larger than an int32 holds",
           at);
    return (int32_t)v;
  }

  // A count of items of at least `min_bytes` bytes each: no larger than
  // what is left of the file could hold.
  long long next_count(const char* what, size_t min_bytes) {
    const size_t at = pos;
    long long v = next_long(what);
    if ((size_t)v > (buf.size() - pos) / min_bytes + 1)
      fail("truncated file: " + std::string(what) + " " +
               std::to_string(v) + " larger than the rest of the file holds",
           at);
    return v;
  }

  // A field element's decimal token as 256 bits.
  U256 next_u256(const char* what) {
    size_t s, e;
    next(what, s, e);
    U256 v = {{0, 0, 0, 0}};
    size_t i = s;
    while (i < e) {
      const size_t k = (e - i) < 19 ? (e - i) : 19;
      uint64_t chunk = 0, scale = 1;
      for (size_t j = 0; j < k; ++j) {
        const char c = buf[i + j];
        if (c < '0' || c > '9') fail(std::string("not a decimal ") + what, s);
        chunk = chunk * 10 + (uint64_t)(c - '0');
        scale *= 10;
      }
      // v = v * 10^k + chunk
      unsigned __int128 carry = chunk;
      for (int w = 0; w < 4; ++w) {
        const unsigned __int128 t = (unsigned __int128)v.w[w] * scale + carry;
        v.w[w] = (uint64_t)t;
        carry = t >> 64;
      }
      if (carry != 0) fail(std::string(what) + " of more than 256 bits", s);
      i += k;
    }
    return v;
  }
};

bool geq(const U256& a, const uint64_t* m) {
  for (int w = 3; w >= 0; --w) {
    if (a.w[w] != m[w]) return a.w[w] > m[w];
  }
  return true;
}

void sub_in_place(U256& a, const uint64_t* m) {
  unsigned __int128 borrow = 0;
  for (int w = 0; w < 4; ++w) {
    const unsigned __int128 t =
        (unsigned __int128)a.w[w] - m[w] - (uint64_t)borrow;
    a.w[w] = (uint64_t)t;
    borrow = (t >> 64) & 1u;
  }
}

// 16 x 16-bit limbs in 32-bit lanes
void put_limbs(const U256& v, std::vector<uint32_t>& out) {
  for (int w = 0; w < 4; ++w)
    for (int k = 0; k < 4; ++k)
      out.push_back((uint32_t)((v.w[w] >> (16 * k)) & 0xffffu));
}

struct Points {
  std::vector<uint32_t> x;  // 16 words a coordinate
  std::vector<uint8_t> lsb, zero;
};

struct Coo {
  std::vector<int32_t> row, var;
  std::vector<uint32_t> coeff;
};

struct Parsed {
  long long primary = 0, aux = 0, ncons = 0;
  Points consts_g1, consts_g2;  // alpha, beta, delta; beta, delta
  Points A, B1, H, L, B2;
  std::vector<int32_t> b_idx;
  Coo coo[3];
};

uint8_t read_flag(Scanner& s, const char* what) {
  return s.next_long(what) != 0 ? 1 : 0;
}

uint8_t read_parity(Scanner& s) {
  const size_t at = s.pos;
  const long long v = s.next_long("parity bit");
  if (v != 0 && v != 1) s.fail("parity bit not 0 or 1", at);
  return (uint8_t)v;
}

void read_g1(Scanner& s, Points& p) {
  p.zero.push_back(read_flag(s, "G1 zero flag"));
  put_limbs(s.next_u256("G1 x"), p.x);
  p.lsb.push_back(read_parity(s));
}

void read_g2(Scanner& s, Points& p) {
  p.zero.push_back(read_flag(s, "G2 zero flag"));
  put_limbs(s.next_u256("G2 x.c0"), p.x);
  put_limbs(s.next_u256("G2 x.c1"), p.x);
  p.lsb.push_back(read_parity(s));
}

void read_g1_vector(Scanner& s, Points& p, const char* what) {
  const long long n = s.next_count(what, 6);
  p.x.reserve(16 * n);
  p.lsb.reserve(n);
  p.zero.reserve(n);
  for (long long i = 0; i < n; ++i) read_g1(s, p);
}

void read_lc(Scanner& s, long long row, Coo& coo) {
  const long long n = s.next_count("linear combination size", 4);
  for (long long i = 0; i < n; ++i) {
    coo.row.push_back((int32_t)row);
    coo.var.push_back(s.next_index("variable index"));
    U256 c = s.next_u256("coefficient");
    while (geq(c, R_MOD)) sub_in_place(c, R_MOD);
    put_limbs(c, coo.coeff);
  }
}

void parse(Scanner& s, Parsed& pk) {
  read_g1(s, pk.consts_g1);
  read_g1(s, pk.consts_g1);
  read_g2(s, pk.consts_g2);
  read_g1(s, pk.consts_g1);
  read_g2(s, pk.consts_g2);
  read_g1_vector(s, pk.A, "A_query size");
  s.next_long("B_query domain size");
  const long long nidx = s.next_count("B_query index count", 2);
  pk.b_idx.reserve(nidx);
  for (long long i = 0; i < nidx; ++i)
    pk.b_idx.push_back(s.next_index("B_query index"));
  const size_t at = s.pos;
  const long long nval = s.next_count("B_query value count", 14);
  if (nval != nidx)
    s.fail("B_query value count " + std::to_string(nval) + " != index count " +
               std::to_string(nidx),
           at);
  pk.B2.x.reserve(32 * nval);
  pk.B1.x.reserve(16 * nval);
  for (long long i = 0; i < nval; ++i) {
    read_g2(s, pk.B2);
    read_g1(s, pk.B1);
  }
  read_g1_vector(s, pk.H, "H_query size");
  read_g1_vector(s, pk.L, "L_query size");
  pk.primary = s.next_long("primary input size");
  pk.aux = s.next_long("auxiliary input size");
  const size_t at_ncons = s.pos;
  pk.ncons = s.next_count("constraint count", 6);
  if (pk.ncons > (long long)INT32_MAX + 1)
    s.fail("constraint count " + std::to_string(pk.ncons) +
               " has rows larger than an int32 holds",
           at_ncons);
  for (long long i = 0; i < pk.ncons; ++i)
    for (int sel = 0; sel < 3; ++sel) read_lc(s, i, pk.coo[sel]);
}

size_t copy_points(const Points& p, uint32_t* x, uint8_t* lsb, uint8_t* zero,
                   size_t at, int words) {
  const size_t n = p.lsb.size();
  if (n) {
    memcpy(x + at * words, p.x.data(), n * words * sizeof(uint32_t));
    memcpy(lsb + at, p.lsb.data(), n);
    memcpy(zero + at, p.zero.data(), n);
  }
  return at + n;
}

}  // namespace

extern "C" {

// meta (out, 10 values): primary, aux, ncons, nA, nB, nH, nL, nnz a, b, c.
// Returns the handle, or null with the error in err (NUL-terminated, at
// most err_len bytes).
void* bm_keytext_parse(const char* path, long long* meta, char* err,
                       int err_len) {
  std::string msg;
  auto* pk = new Parsed();
  Scanner s;
  bool ok = s.open(path, msg);
  if (ok) {
    try {
      parse(s, *pk);
    } catch (const ParseError& e) {
      msg = e.msg;
      ok = false;
    } catch (const std::bad_alloc&) {
      msg = "out of host memory";
      ok = false;
    }
  }
  if (!ok) {
    delete pk;
    snprintf(err, (size_t)err_len, "%s", msg.c_str());
    return nullptr;
  }
  const long long vals[10] = {pk->primary,
                              pk->aux,
                              pk->ncons,
                              (long long)pk->A.lsb.size(),
                              (long long)pk->B2.lsb.size(),
                              (long long)pk->H.lsb.size(),
                              (long long)pk->L.lsb.size(),
                              (long long)pk->coo[0].row.size(),
                              (long long)pk->coo[1].row.size(),
                              (long long)pk->coo[2].row.size()};
  memcpy(meta, vals, sizeof vals);
  return pk;
}

// consts_g1: 3 x 16 words (alpha, beta, delta), consts_g2: 2 x 32 words
// (beta, delta), each with its parity and zero flags; g1_*: the queries'
// G1 points A, B, H, L in that order; g2_*: B's G2 points; b_idx: B's
// indices; row, var, coeff: the COO of a, b, c in that order.
void bm_keytext_fill(void* handle, uint32_t* c1_x, uint8_t* c1_lsb,
                     uint8_t* c1_zero, uint32_t* c2_x, uint8_t* c2_lsb,
                     uint8_t* c2_zero, uint32_t* g1_x, uint8_t* g1_lsb,
                     uint8_t* g1_zero, uint32_t* g2_x, uint8_t* g2_lsb,
                     uint8_t* g2_zero, int32_t* b_idx, int32_t* row,
                     int32_t* var, uint32_t* coeff) {
  const Parsed* pk = static_cast<const Parsed*>(handle);
  copy_points(pk->consts_g1, c1_x, c1_lsb, c1_zero, 0, 16);
  copy_points(pk->consts_g2, c2_x, c2_lsb, c2_zero, 0, 32);
  size_t at = 0;
  for (const Points* p : {&pk->A, &pk->B1, &pk->H, &pk->L})
    at = copy_points(*p, g1_x, g1_lsb, g1_zero, at, 16);
  copy_points(pk->B2, g2_x, g2_lsb, g2_zero, 0, 32);
  if (!pk->b_idx.empty())
    memcpy(b_idx, pk->b_idx.data(), pk->b_idx.size() * sizeof(int32_t));
  size_t off = 0;
  for (const Coo& c : pk->coo) {
    const size_t n = c.row.size();
    if (n) {
      memcpy(row + off, c.row.data(), n * sizeof(int32_t));
      memcpy(var + off, c.var.data(), n * sizeof(int32_t));
      memcpy(coeff + 16 * off, c.coeff.data(), 16 * n * sizeof(uint32_t));
    }
    off += n;
  }
}

void bm_keytext_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
