// Window masks of constrained-SPADE max-start states, for sm_90a (H100).
//
// Replaces no Pallas kernel: the reference engine
// (spark_fsm_tpu/models/spade_constrained.py) builds a [chunk, S, n_pos]
// child state for every candidate and counts its windowed support.  A
// candidate's child is `occ[p] && base[p] >= 0 ? base[p] : -1`, with
// base = pm (s-extension) or m (i-extension) of its parent node, so its
// windowed support is the count of sequences where
//
//   any_p  occ[p]  &&  base[p] >= 0  &&  p - base[p] <= win
//
// holds: an AND of the item's bitmap with a mask that depends on the
// parent node alone.  This kernel writes those masks, two a node, in
// kernel B1's flat layout (csrc/pair_support.cu), which then counts every
// (node mask, item) pair at once:
//
//   out[2b,     s*W + w] bit t = pm[b, s, 32w + t] >= max(0, 32w + t - win)
//   out[2b + 1, s*W + w] bit t =  m[b, s, 32w + t] >= max(0, 32w + t - win)
//
// (the two conditions `x >= 0` and `p - x <= win` folded into one
// compare).  `win` is min(maxwindow, n_pos); with no window the caller
// passes n_pos, under which every start passes.
//
// What bounds it on this card: bytes.  It reads each state once (2 nb S
// n_pos elements of 1 or 2 bytes) and writes 2 nb S W words: at the
// Gazelle batch (nb = 32, S = 59,601, W = 9, int16) 2.20 GB read and
// 0.14 GB written, 0.70 ms at 3.35 TB/s.  The work is one compare, one
// shift and one OR a position.
//
// What the design does about it: one thread a word of both masks, so a
// warp reads 32 consecutive words' positions of a row, 2 KB (int16) or
// 1 KB (int8) of contiguous bytes from each of pm and m, with 16-byte
// loads issued together before any compare (4 a state for int16, 2 for
// int8).  A word's 32 positions start at element 32 j of the flat state
// for word j of the flat [nb, S, W] word space, so any S and W work and
// the loads stay 16-byte aligned whenever the states' base pointers are
// (the wrapper guarantees it).
//
// The launcher allocates nothing, launches on the caller's stream and
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the signed element k of a 32-bit word holding 32 / (8 * sizeof(T)) states
template <typename T>
__device__ __forceinline__ int element(uint32_t u, int k) {
  if constexpr (sizeof(T) == 2)
    return (int)(int16_t)(uint16_t)(u >> (16 * k));
  else
    return (int)(int8_t)(uint8_t)(u >> (8 * k));
}

// the 32 mask bits of one word: v[t] >= max(0, p0 + t - win)
template <typename T>
__device__ __forceinline__ uint32_t mask_word(const uint4* v, int p0, int win) {
  constexpr int per = 4 / (int)sizeof(T);   // states in a 32-bit word
  uint32_t bits = 0u;
#pragma unroll
  for (int q = 0; q < 32 / (4 * per); ++q) {
    const uint32_t u[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < per; ++k) {
        const int t = (q * 4 + c) * per + k;
        const int lo = max(0, p0 + t - win);
        bits |= (uint32_t)(element<T>(u[c], k) >= lo) << t;
      }
  }
  return bits;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxstart_masks_kernel(const T* __restrict__ m, const T* __restrict__ pm,
                      uint32_t* __restrict__ out, long long n_word_rows, long long SW, int W,
                      int win) {
  constexpr int kVecs = 32 * (int)sizeof(T) / 16;   // 16-byte loads a word
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_word_rows) return;
  const uint4* a = reinterpret_cast<const uint4*>(pm + 32 * j);
  const uint4* b = reinterpret_cast<const uint4*>(m + 32 * j);
  uint4 va[kVecs], vb[kVecs];
#pragma unroll
  for (int q = 0; q < kVecs; ++q) va[q] = __ldg(a + q);
#pragma unroll
  for (int q = 0; q < kVecs; ++q) vb[q] = __ldg(b + q);
  const int p0 = 32 * (int)(j % W);
  const long long node = j / SW, col = j - node * SW;
  out[(2 * node) * SW + col] = mask_word<T>(va, p0, win);
  out[(2 * node + 1) * SW + col] = mask_word<T>(vb, p0, win);
}

template <typename T>
int launch(const void* m, const void* pm, void* out, long long nb, long long S, int W, int win,
           cudaStream_t st) {
  const long long words = nb * S * W;
  const long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  maxstart_masks_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const T*)m, (const T*)pm, (uint32_t*)out, words, S * W, W, win);
  return (int)cudaGetLastError();
}

}  // namespace

// m and pm are contiguous [nb, S, 32 W] states of elem_bytes (1: int8,
// 2: int16) bytes, 16-byte aligned; out is [2 nb, S W] int32, every word
// written.  Returns cudaErrorInvalidValue for a bad size or element width.
extern "C" int maxstart_masks_launch(const void* m, const void* pm, void* out, long long nb,
                                     long long S, int W, int win, int elem_bytes,
                                     void* stream) {
  if (nb <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2) return launch<int16_t>(m, pm, out, nb, S, W, win, st);
  if (elem_bytes == 1) return launch<int8_t>(m, pm, out, nb, S, W, win, st);
  return (int)cudaErrorInvalidValue;
}
