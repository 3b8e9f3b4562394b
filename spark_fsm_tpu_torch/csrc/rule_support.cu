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
// stands for the all-ones pad row M, the AND identity.  Each sequence
// counts once for sup and once for supx, whatever its W.
//
// What bounds it on this card.  At the headline launch (C = 8192
// candidates, km = 2, M + 1 = 257 rows, S = 990,000, W = 1) the function
// does at least 5 integer operations per candidate and sequence = 41 G
// (2.4 ms), against 2.04 GB of rows that it must read once (0.6 ms).  The
// rows are only 2 x 257 of them while 8192 candidates read them: a kernel
// that streams each candidate's rows through L1 moves 130 GB of lines a
// launch, and that traffic, not the arithmetic, was what the first design
// (the walk kernel below) spent its time on.
//
// What the staged design does about it (W = 1, km in {1, 2, 4, 8}, and M
// small enough that all rows of a 64-sequence chunk fit in shared memory):
// - A block of 32 warps, one per SM, stages one chunk of 64 sequences of
//   all 2M rows (plus one row of ones for the -1 slots) into shared memory
//   with cp.async, 513 x 256 B = 131 KB at the headline, and then runs its
//   whole slice of candidates (4096 at km <= 2) over it before it moves to
//   the next chunk.  Device memory and L2 supply each row once per slice,
//   not once per candidate; a candidate's rows are read as 64 consecutive
//   words of shared memory, conflict-free.  Persistent blocks walk the
//   chunks (gridDim.y of them per slice, the slices fastest so that they
//   share chunks in L2).
// - Lane = two consecutive sequences of the chunk (one 8-byte load a row),
//   so a candidate's fixed costs (its decoded slots, the row addresses,
//   merging its counts) are paid once per 64 sequences; both its counts
//   come from one warp reduction (__reduce_add_sync) of sup and supx
//   packed in 16-bit halves.  Warp w owns a run of the slice and lane j
//   keeps candidate j's counts of each 32-wide pass in registers across
//   chunks (a block walks at most 1023 chunks, so a half cannot
//   overflow); at the end each lane merges them into the zeroed `out`
//   with integer atomicAdd (exact, order-free).
// - The block decodes its slice once into shared memory: each slot becomes
//   a byte offset of its staged row (the ones row for -1).  A warp takes
//   four candidates a step with no branch between them, so their loads
//   and reductions overlap.  (Reusing a side that consecutive candidates
//   share, behind a branch, measured slower than reading it again.)
// - What is left to bound it: the issue slots of the per-candidate work
//   (about 30 instructions a candidate and 64 sequences: its slots, four
//   row addresses and loads, the folds, turning hits into counts, the
//   reduction and the merge) and the staging of each chunk, which one
//   block per SM cannot overlap with its counting.
//
// The walk kernel (the first design, kept as the path for W > 1, for M too
// large to stage, and for any km outside the ladder): lane = sequence,
// each candidate's rows read through L1/L2 for 8 groups of 32 sequences a
// warp, the candidate tile fastest in the grid so blocks share an L2 chunk;
// W > 1 walks a sequence's words low to high with a funnel shift for the
// carry and ORs the words' hits before the one count.
//
// The launcher allocates nothing and launches on the caller's stream; it
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- staged

constexpr int kStagedWarps = 32;
constexpr int kStagedThreads = kStagedWarps * 32;
constexpr int kSeqChunk = 64;                   // sequences per staged chunk
constexpr int kChunkBytes = kSeqChunk * 4;      // one staged row of a chunk
constexpr int kStep = 4;                        // candidates a loop step
constexpr long long kMaxChunks = 1023;          // a block's chunks: 1023 x 64 < 2^16
constexpr int kMaxSmem = 232448;                // opt-in shared memory per block

// candidates each lane keeps counts for: the slice is 32 warps x 32 x this
// (4096 candidates at km <= 2), within the 64 registers a thread of a
// 1024-thread block may have; its decoded slots take at most 64 KB
template <int KM>
__host__ __device__ constexpr int passes() { return KM <= 2 ? 4 : 8 / KM; }

template <int KM>
__host__ __device__ constexpr int slice() { return kStagedWarps * 32 * passes<KM>(); }

// global -> shared copies of 4 or 16 bytes; a false `pred` fills zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const uint32_t* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const uint32_t* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

template <int KM>
__device__ __forceinline__ void load_slots(const uint32_t* cid, uint32_t* w) {
  if constexpr (KM == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(cid);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < KM / 2; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(cid)[q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
}

// AND of one side's staged rows at this lane's two words; `lane_rows` is
// the lane's first word in the staged rows, `w` the side's byte offsets
template <int KM>
__device__ __forceinline__ uint2 fold_staged(const char* lane_rows, const uint32_t* w) {
  uint2 v = *reinterpret_cast<const uint2*>(lane_rows + w[0]);
#pragma unroll
  for (int k = 1; k < KM; ++k) {
    const uint2 u = *reinterpret_cast<const uint2*>(lane_rows + w[k]);
    v.x &= u.x;
    v.y &= u.y;
  }
  return v;
}

template <int KM>
__global__ void __launch_bounds__(kStagedThreads, 1)
rule_staged_kernel(const uint32_t* __restrict__ p1,
                   const uint32_t* __restrict__ s1,
                   const int32_t* __restrict__ xy,
                   int32_t* __restrict__ out,
                   int C, long long S, int M, long long n_chunks, bool vec16) {
  constexpr int K = passes<KM>();
  constexpr int kSlice = slice<KM>();
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_rows = 2 * M + 1;                 // X rows, Y rows, ones row
  uint32_t* rows = smem;                        // [n_rows][64]
  uint32_t* slots = smem + n_rows * kSeqChunk;  // [kSlice][2][KM] byte offsets

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kSlice;
  const int nc = min(kSlice, C - c0);

  // decode the slice once into byte offsets of the staged rows: the ones
  // row for -1 (or the pad row M), and for the candidates that pad the
  // slice to a multiple of kStep, whose counts are never written
  const int nc_pad = (nc + kStep - 1) / kStep * kStep;
  for (int e = tid; e < nc_pad * 2; e += kStagedThreads) {
    const int c = e >> 1, side = e & 1;
    const int32_t* src = xy + ((long long)(c0 + c) * 2 + side) * KM;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const int r = c < nc ? src[k] : -1;
      if (r < -1 || r > M) __trap();            // never read past the store
      const int row = (r < 0 || r == M) ? 2 * M : side * M + r;
      slots[e * KM + k] = (uint32_t)row * kChunkBytes;
    }
  }

  // lane j's counts of candidate j of each pass: sup in the low 16 bits,
  // supx in the high (a block walks at most kMaxChunks chunks of 64)
  unsigned acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0u;

  const uint32_t rows_addr = (uint32_t)__cvta_generic_to_shared(rows);
  const char* lane_rows = reinterpret_cast<const char*>(rows) + 8 * lane;
  const int wbase = warp * 32 * K;
  const int n_mine = min(max(nc_pad - wbase, 0), 32 * K);   // this warp's run
  for (long long ch = blockIdx.y; ch < n_chunks; ch += gridDim.y) {
    const long long s0 = ch * kSeqChunk;
    __syncthreads();                            // the last chunk's reads are done
    // stage: with 16-byte aligned rows (S % 4 == 0) thread t copies words
    // 4 (t % 16) .. +3 of rows t / 16, t / 16 + 64, ...; else word t % 64
    // of rows t / 64, t / 64 + 16, ...
    if (vec16) {
      const int word = 4 * (tid & 15);
      const bool valid = s0 + word < S;
      for (int r = tid >> 4; r < 2 * M; r += kStagedThreads / 16) {
        const uint32_t* base = r < M ? p1 + (long long)r * S
                                     : s1 + (long long)(r - M) * S;
        cp_async16(rows_addr + (r * kSeqChunk + word) * 4,
                   valid ? base + s0 + word : base, valid);
      }
    } else {
      const int word = tid & (kSeqChunk - 1);
      const bool valid = s0 + word < S;
      for (int r = tid >> 6; r < 2 * M; r += kStagedThreads / kSeqChunk) {
        const uint32_t* base = r < M ? p1 + (long long)r * S
                                     : s1 + (long long)(r - M) * S;
        cp_async4(rows_addr + (r * kSeqChunk + word) * 4,
                  valid ? base + s0 + word : base, valid);
      }
    }
    if (tid < kSeqChunk) rows[2 * M * kSeqChunk + tid] = s0 + tid < S ? ~0u : 0u;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // kStep independent candidates a step, no branch between them, so
    // their shared-memory loads and reductions overlap
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int jn = min(32, n_mine - 32 * k);
      for (int j = 0; j < jn; j += kStep) {
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          uint32_t w[2 * KM];
          load_slots<KM>(slots + (wbase + 32 * k + j + u) * 2 * KM, w);
          const uint2 a = fold_staged<KM>(lane_rows, w);
          const uint2 y = fold_staged<KM>(lane_rows, w + KM);
          // this lane's two sequences' hits, sup low and supx high, summed
          // over the warp in one reduction
          const unsigned v = (unsigned)(((a.x << 1) & y.x) != 0u)
                             + (unsigned)(((a.y << 1) & y.y) != 0u)
                             + (((unsigned)(a.x != 0u) + (unsigned)(a.y != 0u)) << 16);
          const unsigned t = __reduce_add_sync(0xffffffffu, v);
          if (lane == j + u) acc[k] += t;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = wbase + k * 32 + lane;
    if (c < nc) {
      if (acc[k] & 0xffffu) atomicAdd(&out[c0 + c], (int)(acc[k] & 0xffffu));
      if (acc[k] >> 16) atomicAdd(&out[(long long)C + c0 + c], (int)(acc[k] >> 16));
    }
  }
}

size_t staged_smem(int km, int M) {
  const int sl = km == 1 ? slice<1>() : km == 2 ? slice<2>()
               : km == 4 ? slice<4>() : slice<8>();
  return (size_t)(2 * M + 1) * kChunkBytes + (size_t)sl * 2 * km * 4;
}

template <int KM>
cudaError_t launch_staged(const void* p1, const void* s1, const void* xy,
                          void* out, int C, long long S, int M, cudaStream_t st) {
  const size_t smem = staged_smem(KM, M);
  cudaError_t e = cudaFuncSetAttribute(rule_staged_kernel<KM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rule_staged_kernel<KM>, kStagedThreads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long slices = (C + slice<KM>() - 1) / slice<KM>();
  const long long n_chunks = (S + kSeqChunk - 1) / kSeqChunk;
  long long gy = ((long long)sms * per_sm + slices - 1) / slices;
  if (gy > n_chunks) gy = n_chunks;
  const long long least = (n_chunks + kMaxChunks - 1) / kMaxChunks;
  if (gy < least) gy = least;
  if (gy > 65535) return cudaErrorInvalidValue;
  rule_staged_kernel<KM><<<dim3((unsigned)slices, (unsigned)gy), kStagedThreads, smem, st>>>(
      (const uint32_t*)p1, (const uint32_t*)s1, (const int32_t*)xy, (int32_t*)out,
      C, S, M, n_chunks,
      S % 4 == 0 && (uintptr_t)p1 % 16 == 0 && (uintptr_t)s1 % 16 == 0);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ walk

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
rule_walk_kernel(const uint32_t* __restrict__ p1,
                 const uint32_t* __restrict__ s1,
                 const int32_t* __restrict__ xy,
                 int32_t* __restrict__ out,
                 int C, int km_rt, long long S, int W, int pad) {
  constexpr int kRegs = KM > 0 ? KM : kMaxKm;
  const int km = KM > 0 ? KM : km_rt;
  extern __shared__ int32_t smem_w[];
  int32_t* rows = smem_w;                       // [kTileC][2][km] row ids
  int32_t* cnt = smem_w + kTileC * 2 * km;      // [2][kTileC] block counts

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
cudaError_t launch_walk(const void* p1, const void* s1, const void* xy, void* out,
                        int C, int km, long long S, int W, int pad, cudaStream_t st) {
  if ((S + kChunk - 1) / kChunk > 65535) return cudaErrorInvalidValue;
  const dim3 grid((C + kTileC - 1) / kTileC, (unsigned)((S + kChunk - 1) / kChunk));
  const size_t smem = (size_t)(kTileC * 2 * km + 2 * kTileC) * sizeof(int32_t);
  if (W == 1) {
    rule_walk_kernel<KM, true><<<grid, kThreads, smem, st>>>(
        (const uint32_t*)p1, (const uint32_t*)s1, (const int32_t*)xy,
        (int32_t*)out, C, km, S, W, pad);
  } else {
    rule_walk_kernel<KM, false><<<grid, kThreads, smem, st>>>(
        (const uint32_t*)p1, (const uint32_t*)s1, (const int32_t*)xy,
        (int32_t*)out, C, km, S, W, pad);
  }
  return cudaGetLastError();
}

}  // namespace

// out must be zeroed [2, C] int32; p1 and s1 are [rows, S*W] int32 whose
// last row (rows - 1) is all ones; xy is [C, 2, km] int32 with entries in
// -1..rows-1, where -1 (and rows-1) stand for the all-ones row.  W = 1
// with km in {1, 2, 4, 8} takes the staged kernel when all rows of a chunk
// fit in shared memory (rule_support_staged_max_rows); anything else takes
// the walk kernel.  Returns cudaErrorInvalidValue for a bad size, a km
// above 64, or, on the walk kernel, more sequence chunks than gridDim.y
// allows (S > 65535 * 2048).
extern "C" int rule_support_launch(const void* p1, const void* s1,
                                   const void* xy, void* out, int C, int km,
                                   long long S, int W, int rows, void* stream) {
  if (C <= 0 || km <= 0 || km > kMaxKm || S <= 0 || W <= 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int M = rows - 1;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ladder = km == 1 || km == 2 || km == 4 || km == 8;
  if (W == 1 && ladder && staged_smem(km, M) <= (size_t)kMaxSmem) {
    switch (km) {
      case 1: return (int)launch_staged<1>(p1, s1, xy, out, C, S, M, st);
      case 2: return (int)launch_staged<2>(p1, s1, xy, out, C, S, M, st);
      case 4: return (int)launch_staged<4>(p1, s1, xy, out, C, S, M, st);
      default: return (int)launch_staged<8>(p1, s1, xy, out, C, S, M, st);
    }
  }
  switch (km) {
    case 1: return (int)launch_walk<1>(p1, s1, xy, out, C, km, S, W, M, st);
    case 2: return (int)launch_walk<2>(p1, s1, xy, out, C, km, S, W, M, st);
    case 4: return (int)launch_walk<4>(p1, s1, xy, out, C, km, S, W, M, st);
    case 8: return (int)launch_walk<8>(p1, s1, xy, out, C, km, S, W, M, st);
    default: return (int)launch_walk<0>(p1, s1, xy, out, C, km, S, W, M, st);
  }
}

// The largest M (rows - 1) for which a W = 1 launch at this km takes the
// staged kernel; 0 when km has no staged instance.
extern "C" int rule_support_staged_max_rows(int km) {
  if (km != 1 && km != 2 && km != 4 && km != 8) return 0;
  int M = 0;
  while (staged_smem(km, M + 1) <= (size_t)kMaxSmem) ++M;
  return M;
}
