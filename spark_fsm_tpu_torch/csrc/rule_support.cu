// Rule supports for TSR (top-k sequential rules), for sm_90a (H100).
//
// Replaces the Pallas TPU kernel `rule_supports` in
// spark_fsm_tpu/ops/pallas_tsr.py (bodies `_make_kernel_1w` and
// `_make_kernel`).  For each candidate rule c with row lists xy[c, 0, :]
// (X side) and xy[c, 1, :] (Y side), km slots each, -1 = unused:
//
//   A = AND of the X rows of the prefix-or store p1,
//   Y = AND of the Y rows of the suffix-or store s1,
//   out[0, c] = #{ s : OR_w (shift_up_one(A) & Y)[s, w] != 0 },
//   out[1, c] = #{ s : OR_w A[s, w] != 0 },
//
// where shift_up_one moves every bit one position up and carries bit 31 of
// word w-1 into bit 0 of word w.  The stores are the engine's flat
// [M+1, S*W] layout (word minor), read directly: the reference's
// (S/128, 128) fold was a Mosaic rule and is not inherited.  A -1 slot
// reads the all-ones pad row M, the AND identity, so every slot has a row
// and the inner loop has no branch.  Each sequence counts once for sup and
// once for supx, whatever its W.
//
// What bounds it on this card: operations.  At the headline launch
// (C = 8192 candidates, km = 2, M + 1 = 257 rows, S = 990,000, W = 1) the
// function does at least 5 integer operations per candidate and sequence
// (a LOP3 that ANDs the X rows and tests A, the shift, a LOP3 that ANDs
// the shifted A with the Y rows and tests the result, two predicated
// adds) = 41 G, against 2.04 GB of rows that it must read once.  Naively each candidate streams its 2*km rows from device memory,
// 130 GB a launch; the rows are only 2 x 257 of them, so the design keeps
// them in L2 instead.
//
// What the design does about it:
// - The grid is (candidate tiles, sequence chunks) with the candidate tile
//   fastest, so the blocks resident together share a few sequence chunks.
//   A chunk of all 2 x 257 rows is 257 x 2 x 2048 x 4 B = 4.2 MB, so the
//   chunks in flight stay inside the 50 MB L2 and each row is read from
//   device memory about once per launch.
// - A block owns 64 candidates and 2048 sequences; each warp owns 256
//   sequences as 8 groups of 32, lane = sequence, so every load of a row
//   is one coalesced 128-byte line.  For each candidate the warp folds its
//   rows for each group, and counts the group with one ballot and one
//   popcount per count: the counts are warp-uniform, there is no per-thread
//   reduction.  Lane j keeps the counts of candidate j of each 32-wide pass
//   in registers; at the end the warps merge them in shared memory and the
//   block merges them into the zeroed output with integer atomicAdd, which
//   is exact and order-free.  A warp whose 256 sequences all exist (all but
//   the last chunk's) takes a single-word path with no bounds test, whose
//   row pointers are set once per candidate so each group's loads are
//   immediate offsets.
// - W > 1 walks a sequence's words low to high with a funnel shift for the
//   carry, and ORs the words' hits before the one count.
// - Ragged C and S are masked here; km in {1, 2, 4, 8} has its own
//   unrolled instance, any other km up to kMaxKm takes a generic one.
//
// The launcher allocates nothing and launches on the caller's stream; it
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                       // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kPasses = 2;                      // 32-candidate passes per block
constexpr int kTileC = 32 * kPasses;            // candidates per block
constexpr int kGroups = 8;                      // 32-sequence groups per warp
constexpr int kChunk = kWarps * kGroups * 32;   // sequences per block
constexpr int kMaxKm = 64;

// AND of one side's rows at word offset `o`; every slot has a row (an
// unused one points at the all-ones pad row).
template <int KM>
__device__ __forceinline__ uint32_t fold(const uint32_t* const* rows, int km,
                                         long long o) {
  uint32_t v = __ldg(rows[0] + o);
#pragma unroll
  for (int k = 1; k < (KM > 0 ? KM : km); ++k) v &= __ldg(rows[k] + o);
  return v;
}

template <int KM, bool kOneWord>
__global__ void __launch_bounds__(kThreads)
rule_support_kernel(const uint32_t* __restrict__ p1,
                    const uint32_t* __restrict__ s1,
                    const int32_t* __restrict__ xy,
                    int32_t* __restrict__ out,
                    int C, int km_rt, long long S, int W, int pad) {
  constexpr int kRegs = KM > 0 ? KM : kMaxKm;
  const int km = KM > 0 ? KM : km_rt;
  extern __shared__ int32_t smem[];
  int32_t* rows = smem;                         // [kTileC][2][km] row ids
  int32_t* cnt = smem + kTileC * 2 * km;        // [2][kTileC] block counts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kTileC;
  const int nc = min(kTileC, C - c0);
  for (int e = tid; e < nc * 2 * km; e += kThreads) {
    const int r = xy[(long long)c0 * 2 * km + e];
    if (r < -1 || r > pad) __trap();            // never read past the store
    rows[e] = r >= 0 ? r : pad;                 // -1 -> the all-ones row
  }
  for (int e = tid; e < 2 * kTileC; e += kThreads) cnt[e] = 0;
  __syncthreads();

  const long long row_words = S * (long long)W;
  // this lane's sequences: seq + 32 * g for g < kGroups; a warp whose
  // sequences all exist takes the unchecked single-word path
  const long long warp_s0 = (long long)blockIdx.y * kChunk
                            + (long long)warp * (kGroups * 32);
  const long long seq = warp_s0 + lane;
  const bool full = warp_s0 + kGroups * 32 <= S;
  int acc_sup[kPasses], acc_x[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    acc_sup[p] = 0;
    acc_x[p] = 0;
    for (int j = 0; j < 32; ++j) {
      const int c = p * 32 + j;
      if (c >= nc) break;                       // uniform across the block
      const int32_t* r = rows + c * 2 * km;
      int n_sup = 0, n_x = 0;
      if (kOneWord && full) {
        // row pointers at this lane's first sequence: the 8 groups are
        // then immediate offsets of 32 words
        const uint32_t* bx[kRegs];
        const uint32_t* by[kRegs];
#pragma unroll
        for (int k = 0; k < (KM > 0 ? KM : km); ++k) {
          bx[k] = p1 + (long long)r[k] * row_words + seq;
          by[k] = s1 + (long long)r[km + k] * row_words + seq;
        }
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const uint32_t a = fold<KM>(bx, km, 32 * g);
          const uint32_t y = fold<KM>(by, km, 32 * g);
          n_sup += __popc(__ballot_sync(0xffffffffu, ((a << 1) & y) != 0u));
          n_x += __popc(__ballot_sync(0xffffffffu, a != 0u));
        }
      } else {
        const uint32_t* bx[kRegs];
        const uint32_t* by[kRegs];
#pragma unroll
        for (int k = 0; k < (KM > 0 ? KM : km); ++k) {
          bx[k] = p1 + (long long)r[k] * row_words;
          by[k] = s1 + (long long)r[km + k] * row_words;
        }
        for (int g = 0; g < kGroups; ++g) {
          const long long s = seq + 32 * g;
          uint32_t h = 0u, hx = 0u;
          if (s < S) {
            uint32_t prev = 0u;
            for (int w = 0; w < W; ++w) {
              const uint32_t a = fold<KM>(bx, km, s * W + w);
              const uint32_t y = fold<KM>(by, km, s * W + w);
              // (a << 1) | (prev >> 31): shift_up_one with its word carry
              h |= __funnelshift_l(prev, a, 1) & y;
              hx |= a;
              prev = a;
            }
          }
          n_sup += __popc(__ballot_sync(0xffffffffu, h != 0u));
          n_x += __popc(__ballot_sync(0xffffffffu, hx != 0u));
        }
      }
      if (lane == j) {
        acc_sup[p] += n_sup;
        acc_x[p] += n_x;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (acc_sup[p]) atomicAdd(&cnt[p * 32 + lane], acc_sup[p]);
    if (acc_x[p]) atomicAdd(&cnt[kTileC + p * 32 + lane], acc_x[p]);
  }
  __syncthreads();
  if (tid < 2 * kTileC) {
    const int side = tid / kTileC, c = tid % kTileC;
    if (c < nc && cnt[tid]) atomicAdd(&out[(long long)side * C + c0 + c], cnt[tid]);
  }
}

template <int KM>
cudaError_t launch(const void* p1, const void* s1, const void* xy, void* out,
                   int C, int km, long long S, int W, int pad, cudaStream_t st) {
  const dim3 grid((C + kTileC - 1) / kTileC, (unsigned)((S + kChunk - 1) / kChunk));
  const size_t smem = (size_t)(kTileC * 2 * km + 2 * kTileC) * sizeof(int32_t);
  if (W == 1) {
    rule_support_kernel<KM, true><<<grid, kThreads, smem, st>>>(
        (const uint32_t*)p1, (const uint32_t*)s1, (const int32_t*)xy,
        (int32_t*)out, C, km, S, W, pad);
  } else {
    rule_support_kernel<KM, false><<<grid, kThreads, smem, st>>>(
        (const uint32_t*)p1, (const uint32_t*)s1, (const int32_t*)xy,
        (int32_t*)out, C, km, S, W, pad);
  }
  return cudaGetLastError();
}

}  // namespace

// out must be zeroed [2, C] int32; p1 and s1 are [rows, S*W] int32 whose
// last row (rows - 1) is all ones; xy is [C, 2, km] int32 with entries in
// -1..rows-2, where -1 reads the all-ones row.  Returns
// cudaErrorInvalidValue for a bad size, a km above kMaxKm, or more
// sequence chunks than gridDim.y allows (S > 65535 * 2048).
extern "C" int rule_support_launch(const void* p1, const void* s1,
                                   const void* xy, void* out, int C, int km,
                                   long long S, int W, int rows, void* stream) {
  if (C <= 0 || km <= 0 || km > kMaxKm || S <= 0 || W <= 0 || rows <= 0 ||
      (S + kChunk - 1) / kChunk > 65535)
    return (int)cudaErrorInvalidValue;
  const int pad = rows - 1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (km) {
    case 1: return (int)launch<1>(p1, s1, xy, out, C, km, S, W, pad, st);
    case 2: return (int)launch<2>(p1, s1, xy, out, C, km, S, W, pad, st);
    case 4: return (int)launch<4>(p1, s1, xy, out, C, km, S, W, pad, st);
    case 8: return (int)launch<8>(p1, s1, xy, out, C, km, S, W, pad, st);
    default: return (int)launch<0>(p1, s1, xy, out, C, km, S, W, pad, st);
  }
}
