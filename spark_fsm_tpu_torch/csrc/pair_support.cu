// Pair-support matrix for the SPADE classic engine, for sm_90a (H100).
//
// Replaces the Pallas TPU kernel `pair_supports` in
// spark_fsm_tpu/ops/pallas_support.py (bodies `_make_pair_kernel_1w` and
// `_make_pair_kernel`).  It computes
//
//   out[p, i] = #{ s : OR_w (pt[p, s*W + w] & items[i, s*W + w]) != 0 }
//
// for p < P parent rows (plain and s-ext-transformed rows interleaved) and
// i < NI item rows, reading both operands in the engine's native flat
// layout [rows, S*W] (word minor) with no transpose.  A sequence counts
// ONCE if any of its W words has a surviving bit: the OR across one
// sequence's words happens in registers before the count, so W > 1 never
// counts words instead of sequences.
//
// What bounds it on this card: operations.  At the main path's launch
// (P = 2048, NI = 360, S = 77.5k, W = 1) it does 57 G word pairs at no
// fewer than two integer operations each on the CUDA cores (one LOP3 that
// ANDs and sets the nonzero predicate, one predicated add; W > 1 folds each
// further word into the running OR with one more LOP3), while the bytes it
// must move (each row read once, ~0.7 GB) take a fraction of a millisecond
// at the card's memory rate.  The AND/test/count is integer
// work, not a matrix product, so neither wgmma nor the tensor cores apply.
//
// What the design does about it: it is tiled like a matrix product so
// that staged rows are reused from shared memory instead of being re-read
// from device memory.  A block owns a 64 x 64 output tile; each step it
// stages a chunk of whole sequences (at most 32 words, W words each) of its
// 64 parent rows and 64 item rows in shared memory, and each of its 256
// threads keeps a 4 x 4 block of counts in registers.  A row is read from
// device memory once per 64-wide tile of the other operand.  The sequence
// axis is split over gridDim.z so that enough blocks exist to fill the
// SMs; counts are integers, so the atomicAdd that merges the splits into
// the zeroed output is exact and order-free.  Ragged P, NI and S are
// masked here: rows and words past the edge stage as zero and are never
// written out.
//
// The launcher allocates nothing and launches on the caller's stream; it
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileP = 64;           // parent rows per block
constexpr int kTileI = 64;           // item rows per block
constexpr int kThreadsX = 16;        // threads along the item tile
constexpr int kThreadsY = 16;        // threads along the parent tile
constexpr int kRowsP = kTileP / kThreadsY;   // parent rows per thread (4)
constexpr int kRowsI = kTileI / kThreadsX;   // item rows per thread (4)
constexpr int kStageWords = 32;      // words per staged row (whole sequences)
constexpr int kMaxSmem = 232448;     // opt-in dynamic shared memory per block

template <bool kOneWord>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
pair_support_kernel(const uint32_t* __restrict__ pt,
                    const uint32_t* __restrict__ items,
                    int32_t* __restrict__ out,
                    int P, int NI, long long S, int W,
                    long long seqs_per_split, int seqs_per_stage) {
  extern __shared__ uint32_t smem[];
  const int sw = seqs_per_stage * W;   // words per staged row
  const int ld = sw + 1;               // odd pitch: conflict-free column reads
  uint32_t* sp = smem;                 // [kTileP][ld] parent rows
  uint32_t* si = smem + kTileP * ld;   // [kTileI][ld] item rows

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int p0 = blockIdx.y * kTileP;
  const int i0 = blockIdx.x * kTileI;
  const long long row_words = S * (long long)W;
  const long long s_begin = (long long)blockIdx.z * seqs_per_split;
  long long s_end = s_begin + seqs_per_split;
  if (s_end > S) s_end = S;

  int acc[kRowsP][kRowsI];
#pragma unroll
  for (int k = 0; k < kRowsP; ++k)
#pragma unroll
    for (int j = 0; j < kRowsI; ++j) acc[k][j] = 0;

  for (long long s0 = s_begin; s0 < s_end; s0 += seqs_per_stage) {
    const long long left = s_end - s0;
    const int ns = left < seqs_per_stage ? (int)left : seqs_per_stage;
    const int nw = ns * W;
    const long long w0 = s0 * W;
    // stage: consecutive threads read consecutive words of one row
    for (int e = tid; e < kTileP * sw; e += kThreadsX * kThreadsY) {
      const int r = e / sw, c = e - r * sw;
      uint32_t v = 0u;
      if (p0 + r < P && c < nw) v = pt[(long long)(p0 + r) * row_words + w0 + c];
      sp[r * ld + c] = v;
    }
    for (int e = tid; e < kTileI * sw; e += kThreadsX * kThreadsY) {
      const int r = e / sw, c = e - r * sw;
      uint32_t v = 0u;
      if (i0 + r < NI && c < nw) v = items[(long long)(i0 + r) * row_words + w0 + c];
      si[r * ld + c] = v;
    }
    __syncthreads();

    if (kOneWord) {
#pragma unroll 4
      for (int c = 0; c < nw; ++c) {
        uint32_t a[kRowsP], b[kRowsI];
#pragma unroll
        for (int k = 0; k < kRowsP; ++k) a[k] = sp[(ty + kThreadsY * k) * ld + c];
#pragma unroll
        for (int j = 0; j < kRowsI; ++j) b[j] = si[(tx + kThreadsX * j) * ld + c];
#pragma unroll
        for (int k = 0; k < kRowsP; ++k)
#pragma unroll
          for (int j = 0; j < kRowsI; ++j) acc[k][j] += (a[k] & b[j]) != 0u;
      }
    } else {
      for (int s = 0; s < ns; ++s) {
        uint32_t hit[kRowsP][kRowsI];
#pragma unroll
        for (int k = 0; k < kRowsP; ++k)
#pragma unroll
          for (int j = 0; j < kRowsI; ++j) hit[k][j] = 0u;
        for (int w = 0; w < W; ++w) {
          const int c = s * W + w;
          uint32_t a[kRowsP], b[kRowsI];
#pragma unroll
          for (int k = 0; k < kRowsP; ++k) a[k] = sp[(ty + kThreadsY * k) * ld + c];
#pragma unroll
          for (int j = 0; j < kRowsI; ++j) b[j] = si[(tx + kThreadsX * j) * ld + c];
#pragma unroll
          for (int k = 0; k < kRowsP; ++k)
#pragma unroll
            for (int j = 0; j < kRowsI; ++j) hit[k][j] |= a[k] & b[j];
        }
        // any word of the sequence survived -> the sequence counts once
#pragma unroll
        for (int k = 0; k < kRowsP; ++k)
#pragma unroll
          for (int j = 0; j < kRowsI; ++j) acc[k][j] += hit[k][j] != 0u;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kRowsP; ++k) {
    const int p = p0 + ty + kThreadsY * k;
#pragma unroll
    for (int j = 0; j < kRowsI; ++j) {
      const int i = i0 + tx + kThreadsX * j;
      if (p < P && i < NI && acc[k][j] != 0)
        atomicAdd(&out[(long long)p * NI + i], acc[k][j]);
    }
  }
}

}  // namespace

// out must be zeroed [P, NI] int32; pt is [P, S*W], items [>= NI, S*W].
// n_splits: how many parts the sequence axis is split into (gridDim.z).
// Returns cudaErrorInvalidValue for a bad size and for a W whose staged rows
// need more shared memory than a block may have (W > 453).
extern "C" int pair_support_launch(const void* pt, const void* items, void* out,
                                   int P, int NI, long long S, int W,
                                   int n_splits, void* stream) {
  if (P <= 0 || NI <= 0 || S <= 0 || W <= 0 || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int seqs_per_stage = W >= kStageWords ? 1 : kStageWords / W;
  const size_t smem =
      (size_t)(kTileP + kTileI) * (size_t)(seqs_per_stage * W + 1) * sizeof(uint32_t);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  long long per = (S + n_splits - 1) / n_splits;
  per = (per + seqs_per_stage - 1) / seqs_per_stage * seqs_per_stage;
  const long long nz = (S + per - 1) / per;
  dim3 grid((NI + kTileI - 1) / kTileI, (P + kTileP - 1) / kTileP, (unsigned)nz);
  dim3 block(kThreadsX, kThreadsY);
  cudaStream_t st = (cudaStream_t)stream;
  if (W == 1) {
    pair_support_kernel<true><<<grid, block, smem, st>>>(
        (const uint32_t*)pt, (const uint32_t*)items, (int32_t*)out, P, NI, S, W,
        per, seqs_per_stage);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          pair_support_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    pair_support_kernel<false><<<grid, block, smem, st>>>(
        (const uint32_t*)pt, (const uint32_t*)items, (int32_t*)out, P, NI, S, W,
        per, seqs_per_stage);
  }
  return (int)cudaGetLastError();
}
