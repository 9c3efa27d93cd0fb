// The prover's witness on the card: one little-endian 64-bit word a wire
// (csrc/wirelimbs.cpp writes them, the upload copies them from pinned host
// memory) widened to the (n, 16) int32 standard-form limbs the MSMs take
// as scalars and mul_elementwise turns into Montgomery form; then the few
// wide rows (wires of 2^64 and above, whose word is 0), each its row number
// and 16 limbs, written over their slots.
//
// Replaces: no TPU kernel. The JAX package (blockmaze_tpu/groth16/prover.py
// :322) uploads ints_to_limbs' 64-byte rows, 12 of whose 16 lanes are
// zeros for nearly every wire (3 of mint's 151,512 wires are 2^64 or
// more, 8 of deposit's 457,127). Added to cut the upload from 64 to 8
// bytes a wire.
//
// What bounds it on this card: bytes, (8 + 64) n (and 68 + 64 a wide row):
// 55 MB for deposit20's 763,860 wires, 16.4 us at 3.35 TB/s. No arithmetic.
//
// Design: four threads a row, each storing one 16-byte quarter, so a warp
// stores 512 contiguous bytes; the first quarter holds the word's four
// 16-bit limbs, the other three zeros. The wide rows go in a second launch
// on the same stream, after the first, so they land over the zeros; rows
// outside [0, n) are skipped (the wrapper's caller makes them in range).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WIDE_COLS = 17;  // a wide row: its row number, 16 limbs

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

__global__ void widen_kernel(int4 *out, const unsigned long long *words,
                             long long quarters) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= quarters) return;
  int4 q = make_int4(0, 0, 0, 0);
  if ((t & 3) == 0) {
    const unsigned long long v = words[t >> 2];
    q = make_int4((int)(v & 0xffff), (int)((v >> 16) & 0xffff),
                  (int)((v >> 32) & 0xffff), (int)(v >> 48));
  }
  out[t] = q;
}

__global__ void wide_rows_kernel(int4 *out, long long n, const int32_t *wide,
                                 long long quarters) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= quarters) return;
  const int32_t *w = wide + (t >> 2) * WIDE_COLS;
  const long long row = w[0];
  if (row < 0 || row >= n) return;
  const int32_t *l = w + 1 + 4 * (t & 3);
  out[row * 4 + (t & 3)] = make_int4(l[0], l[1], l[2], l[3]);
}

}  // namespace

extern "C" int bm_wire_widen(void *out, const void *words, long long n,
                             const void *wide, long long k, void *stream) {
  auto s = (cudaStream_t)stream;
  if (n > 0)
    widen_kernel<<<blocks_for(4 * n), THREADS, 0, s>>>(
        (int4 *)out, (const unsigned long long *)words, 4 * n);
  if (k > 0)
    wide_rows_kernel<<<blocks_for(4 * k), THREADS, 0, s>>>(
        (int4 *)out, n, (const int32_t *)wide, 4 * k);
  return (int)cudaGetLastError();
}
