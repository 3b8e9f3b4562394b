// Extension count + threshold prune (the SPAM wave) for sm_90a (H100).
//
// Replaces the Pallas TPU kernel `extend_count_prune` in
// spark_fsm_tpu/ops/pallas_extend.py (bodies `_make_extend_kernel_1w` and
// `_make_extend_kernel`, epilogue `_prune_epilogue`).  It computes
//
//   raw[p, i]  = #{ s : OR_w (pt[p, s*W + w] & items[i, s*W + w]) != 0 }
//   sup[p, i]  = raw[p, i] if raw[p, i] >= thr else 0
//   mask[p, i / 32] bit (i % 32) = (raw[p, i] >= thr)      (LSB first)
//
// for p < P parent rows (plain and s-ext-transformed rows interleaved) and
// i < NI item rows, reading both operands in the engine's flat layout
// [rows, S*W] (word minor) with no transpose.  thr >= 1, so 0 always means
// "dead", and all-zero pad item rows never survive.  thr is an argument:
// one build serves every threshold of a mine.
//
// What bounds it on this card: operations, as for the pair-support kernel
// (csrc/pair_support.cu), whose tiling this copies: W + 1 int32 operations
// per pair and sequence (a LOP3 that ANDs, folds and sets the nonzero
// predicate per word, one predicated add).  At the SPAM engine's wave on
// the MSNBC-shaped database (P = 2 x node_batch, about 12; NI = 64;
// S = 990,016; W = 1) the operations and the bytes (each row read once)
// both take about 0.09 ms.  The threshold and the mask are O(P * NI) work.
//
// What the design does about it:
// - A block owns a (16 * kRowsP) x 64 output tile.  The SPAM wave has few
//   parent rows, so the parent tile shrinks to 16 rows when P <= 16 (32
//   when P <= 32) instead of computing 64 rows of which most are padding.
// - Rows are staged in shared memory a chunk of whole sequences at a time
//   (at most 32 words) and each thread keeps kRowsP x 4 counts in
//   registers; the OR over a sequence's W words happens in registers
//   before the count, so a sequence counts once.
// - The sequence axis is split over gridDim.z so that enough blocks fill
//   the SMs (a wave has one or two output tiles).  The splits merge their
//   counts into the zeroed `sup` with atomicAdd (exact, order-free).  The
//   threshold is right only once every split has added its part, so each
//   block then takes a ticket from its tile's arrival counter
//   (`arrivals`, zeroed by the caller) after a __threadfence(); the block
//   that draws the last ticket reads the finished counts from L2, zeroes
//   the dead lanes and writes the mask.  Each mask word is one warp's
//   ballot over 32 consecutive lanes of one row, so no thread does a
//   read-modify-write of a mask word.
// - Ragged P, NI and S are masked: rows and words past the edge stage as
//   zero and are never written.  NI must be a multiple of 32, so every mask
//   word is whole.
//
// The launcher allocates nothing and launches on the caller's stream; it
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileI = 64;           // item rows per block
constexpr int kThreadsX = 16;        // threads along the item tile
constexpr int kThreadsY = 16;        // threads along the parent tile
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRowsI = kTileI / kThreadsX;   // item rows per thread (4)
constexpr int kStageWords = 32;      // words per staged row (whole sequences)
constexpr int kMaxSmem = 232448;     // opt-in dynamic shared memory per block

template <int kRowsP, bool kOneWord>
__global__ void __launch_bounds__(kThreads)
extend_prune_kernel(const uint32_t* __restrict__ pt,
                    const uint32_t* __restrict__ items,
                    int32_t* __restrict__ sup,
                    uint32_t* __restrict__ mask,
                    unsigned int* __restrict__ arrivals,
                    int P, int NI, long long S, int W, int thr,
                    long long seqs_per_split, int seqs_per_stage) {
  constexpr int kTileP = kThreadsY * kRowsP;
  extern __shared__ uint32_t smem[];
  const int sw = seqs_per_stage * W;   // words per staged row
  const int ld = sw + 1;               // odd pitch: conflict-free column reads
  uint32_t* sp = smem;                 // [kTileP][ld] parent rows
  uint32_t* si = smem + kTileP * ld;   // [kTileI][ld] item rows
  uint32_t* ticket = si + kTileI * ld; // this block's arrival ticket

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
    for (int e = tid; e < kTileP * sw; e += kThreads) {
      const int r = e / sw, c = e - r * sw;
      uint32_t v = 0u;
      if (p0 + r < P && c < nw) v = pt[(long long)(p0 + r) * row_words + w0 + c];
      sp[r * ld + c] = v;
    }
    for (int e = tid; e < kTileI * sw; e += kThreads) {
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
        atomicAdd(&sup[(long long)p * NI + i], acc[k][j]);
    }
  }

  // Arrival: this block's adds are visible device-wide before its ticket.
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(&arrivals[blockIdx.y * gridDim.x + blockIdx.x], 1u);
  __syncthreads();
  if (*ticket != gridDim.z - 1) return;
  __threadfence();

  // The last split of this tile: threshold and pack.  Warp `warp` takes
  // (row, mask word) pairs; lane l holds item i0 + 32 * word + l.
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kWords = kTileI / 32;
  for (int e = warp; e < kTileP * kWords; e += kThreads / 32) {
    const int r = e / kWords, wd = e - r * kWords;
    const int p = p0 + r;
    const int ib = i0 + 32 * wd;
    if (p >= P || ib >= NI) continue;  // warp-uniform: NI % 32 == 0
    int32_t* at = &sup[(long long)p * NI + ib + lane];
    const int v = __ldcg(at);          // from L2, where the atomics landed
    const bool alive = v >= thr;
    *at = alive ? v : 0;
    const unsigned bits = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) mask[(long long)p * (NI / 32) + ib / 32] = bits;
  }
}

template <int kRowsP>
int launch(const void* pt, const void* items, void* sup, void* mask,
           void* arrivals, int P, int NI, long long S, int W, int thr,
           int target_blocks, cudaStream_t st) {
  constexpr int kTileP = kThreadsY * kRowsP;
  const int seqs_per_stage = W >= kStageWords ? 1 : kStageWords / W;
  const size_t smem = ((size_t)(kTileP + kTileI) * (size_t)(seqs_per_stage * W + 1) + 1) *
                      sizeof(uint32_t);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((NI + kTileI - 1) / kTileI) * ((P + kTileP - 1) / kTileP);
  long long n_splits = (target_blocks + tiles - 1) / tiles;
  const long long stages = (S + seqs_per_stage - 1) / seqs_per_stage;
  if (n_splits > stages) n_splits = stages;
  if (n_splits > 65535) n_splits = 65535;
  if (n_splits < 1) n_splits = 1;
  long long per = (S + n_splits - 1) / n_splits;
  per = (per + seqs_per_stage - 1) / seqs_per_stage * seqs_per_stage;
  const long long nz = (S + per - 1) / per;
  dim3 grid((NI + kTileI - 1) / kTileI, (P + kTileP - 1) / kTileP, (unsigned)nz);
  dim3 block(kThreadsX, kThreadsY);
  if (W == 1) {
    extend_prune_kernel<kRowsP, true><<<grid, block, smem, st>>>(
        (const uint32_t*)pt, (const uint32_t*)items, (int32_t*)sup, (uint32_t*)mask,
        (unsigned int*)arrivals, P, NI, S, W, thr, per, seqs_per_stage);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(extend_prune_kernel<kRowsP, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    extend_prune_kernel<kRowsP, false><<<grid, block, smem, st>>>(
        (const uint32_t*)pt, (const uint32_t*)items, (int32_t*)sup, (uint32_t*)mask,
        (unsigned int*)arrivals, P, NI, S, W, thr, per, seqs_per_stage);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sup must be zeroed [P, NI] int32, mask [P, NI / 32] int32 words (every
// word is written), arrivals zeroed with at least ceil(P / 16) *
// ceil(NI / 64) entries; pt is [P, S*W], items [>= NI, S*W].
// target_blocks: about how many blocks the grid should hold (the sequence
// axis is split over gridDim.z to reach it).  Returns cudaErrorInvalidValue
// for a bad size or threshold (NI % 32 != 0, thr < 1) and for a W whose
// staged rows need more shared memory than a block may have.
extern "C" int extend_prune_launch(const void* pt, const void* items, void* sup,
                                   void* mask, void* arrivals, int P, int NI,
                                   long long S, int W, int thr, int target_blocks,
                                   void* stream) {
  if (P <= 0 || NI <= 0 || NI % 32 != 0 || S <= 0 || W <= 0 || thr < 1 ||
      target_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (P <= 16) return launch<1>(pt, items, sup, mask, arrivals, P, NI, S, W, thr, target_blocks, st);
  if (P <= 32) return launch<2>(pt, items, sup, mask, arrivals, P, NI, S, W, thr, target_blocks, st);
  return launch<4>(pt, items, sup, mask, arrivals, P, NI, S, W, thr, target_blocks, st);
}
