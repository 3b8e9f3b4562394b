// Pair-support matrix (kernel B1) for sm_90a (H100).
//
// Replaces the Pallas TPU kernel `pair_supports` in
// spark_fsm_tpu/ops/pallas_support.py (bodies `_make_pair_kernel_1w` and
// `_make_pair_kernel`).  It computes
//
//   out[p, i] = #{ s : OR_w (pt[p, s*W + w] & items[i, s*W + w]) != 0 }
//
// for p < P parent rows (plain and s-ext-transformed rows interleaved) and
// i < n_live item rows, reading both operands in the engine's native flat
// layout [rows, S*W] (word minor) with no transpose.  Item rows n_live..NI-1
// are known to be all zero (the engines pad their item axis with zero
// rows), so their counts are 0: the kernel never reads them, and the
// caller's zeroed output already holds them.  A sequence counts ONCE if any
// of its W words has a surviving bit: the OR across one sequence's words
// happens in registers before the count, on every tile, so W > 1 never
// counts words instead of sequences.
//
// What bounds it on this card: operations, over the live rows.  It does no
// fewer than W + 1 integer operations per live pair and sequence on the CUDA
// cores (W = 1: one LOP3 that ANDs and sets the nonzero predicate, one
// predicated add; W > 1 folds each further word into the running OR with
// one more LOP3).  At the queue engine's wide wave (P = 1024, 360 live of
// NI = 384, S = 77,504) that is 57 G operations, 1.7 ms at 128 lanes an SM
// and clock (the LOP3s on the 64 integer lanes, the adds on the others),
// against 0.43 GB of rows (0.13 ms at the memory rate).
// Only where one side is a few rows does the byte count win: SPAM's wave on
// a mesh (P = 12, 17 live, S = 990,016) must read 29 rows of 3.96 MB.  The
// tensor cores' one-bit product (mma/wgmma .b1 with AND and POPC) counts
// bits, not sequences with any bit, so it does not compute this function.
//
// What the design does about it:
// - Tiles chosen from P and n_live (the launcher picks one of three
//   instantiations of one kernel template), over the live item tiles only:
//   * wide, P >= 128 and n_live >= 128: a 128 x 128 output tile, 256
//     threads, 8 x 8 counts a thread (strided rows: thread (gp, gi) owns
//     parent rows gp + 16k and item rows gi + 16j), compiled to fit two
//     blocks an SM (the item rows are read one at a time, so the 64 counts
//     and 9 staged words fit 128 registers);
//   * narrow, P <= 32 or n_live <= 32 (SPAM's waves, the stream's sweep):
//     a warp owns an 8 x 6 block of pairs and its 32 lanes split the
//     sequences; a block holds up to 12 warps and covers all the rows of
//     the short side (16 x 18 at SPAM's wave: 71 % of the lanes live,
//     where a 64 x 64 tile kept 5 %; 32 x 18 at the stream's sweep); the
//     warp's lanes add up their counts with one reduction per pair at the
//     end;
//   * mid, anything else: the wide layout at 4 x 4 counts a thread
//     (64 x 64).
// - Staging that overlaps compute: a ring of 3 (wide, narrow) or 4 (mid)
//   shared-memory stages, each a chunk of the block's parent and item rows
//   (32 words a row, 256 on the narrow tile), filled by cp.async (16 bytes
//   a copy where rows are 16-byte aligned, 4 where they are not).  While
//   one stage is counted the next ones are in flight; one __syncthreads a
//   stage frees the buffer the next copy overwrites.  Rows past P or
//   n_live and words past the block's sequences are zero-filled by the
//   copy (src-size 0) and count nothing.
// - Vectorised reads: rows are staged at a pitch of SW + 4 words (SW a
//   multiple of 32), so a thread fetches 4 consecutive words of a row with
//   one 128-bit shared read, and the 8 threads of a quarter warp that read
//   8 different rows land in 8 different 16-byte bank groups.  The wide
//   tile spends 16 such reads on 4 x 64 = 256 pairs.
// - The counting step (W = 1): and, setp and a predicated add in PTX,
//   which ptxas compiles to one LOP3 that writes a predicate and one
//   predicated VIADD a pair and word (cuobjdump -sass of the built library:
//   the wide W = 1 kernel holds 1,040 predicate-writing LOP3s, 1,025
//   predicated adds and 64 128-bit reads, its body of 1,024 pair-words
//   unrolled four times; kernel_ab.py prints the counts).  The C++ spelling `if (a & b)
//   ++acc` compiled to three (LOP3, VIADD, predicated IMAD.MOV) and ran
//   1.5 times slower.  W > 1: the wide and mid tiles walk the staged words
//   in order, folding each word into a running OR per pair and counting at
//   each sequence's last word (a block-uniform test), so sequences may
//   straddle stages; the narrow tile stages whole sequences (W <= 256;
//   wider rows take the mid tile) and gives each lane whole sequences,
//   read one word at a time.
// - Split-sequence partials are merged with atomicAdd into the zeroed
//   output (exact and order-free for integers).  The split count comes
//   from the live tiles and the card's resident block slots: the fewest
//   splits within 2 % of the best wave quantization, so the last wave of
//   blocks is not left a few blocks wide.
//
// The launcher allocates nothing and launches on the caller's stream; it
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;     // opt-in dynamic shared memory per block

// RP x RI counts a thread; LANES threads share them over the sequences
// (1: a thread walks every staged word; 32: a warp's lanes split them);
// NPG x NIG thread groups a block (0: set at launch); SW words a staged
// row; STAGES buffers in the ring; MAXT threads a block at most; MINB
// blocks an SM the W = 1 instantiation is compiled to fit.
template <int RP_, int RI_, int LANES_, int NPG_, int NIG_, int SW_, int STAGES_, int MAXT_,
          int MINB_>
struct Tile {
  static constexpr int RP = RP_, RI = RI_, LANES = LANES_, NPG = NPG_, NIG = NIG_;
  static constexpr int SW = SW_, STAGES = STAGES_, MAXT = MAXT_, MINB = MINB_;
  static size_t smem(int npg, int nig) {
    return (size_t)STAGES * (size_t)(RP * npg + RI * nig) * (SW + 4) * sizeof(uint32_t);
  }
};
using Wide = Tile<8, 8, 1, 16, 16, 32, 3, 256, 2>;
using Mid = Tile<4, 4, 1, 16, 16, 32, 4, 256, 1>;
using Narrow = Tile<8, 6, 32, 0, 0, 256, 3, 384, 1>;
constexpr int kNarrowWarps = 12;

struct Args {
  const uint32_t* pt;
  const uint32_t* items;
  int32_t* out;
  int P, NI, n_live;
  long long S;
  int W;
  int npg, nig;               // parent and item row groups of a block
  int seqs_per_stage;         // whole sequences a narrow stage holds (W > 1)
  long long seqs_per_split;   // sequences a block counts (gridDim.z splits)
};

template <int kWords>
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = ok ? 4 * kWords : 0;   // 0: the copy zero-fills
  if constexpr (kWords == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ++acc where x != 0, or where a & b != 0: one LOP3 that writes a
// predicate and one predicated add.  Spelled in PTX because the C++ spelling
// compiles to an add, a predicated move and the LOP3, three a pair.
__device__ __forceinline__ void count_nonzero(int& acc, uint32_t x) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(acc)
      : "r"(x));
}

__device__ __forceinline__ void count_and(int& acc, uint32_t a, uint32_t b) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\tand.b32 t, %1, %2;\n\t"
      "setp.ne.u32 p, t, 0;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(acc)
      : "r"(a), "r"(b));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <class T, bool kOneWord, bool kVec>
__global__ void __launch_bounds__(T::MAXT, kOneWord ? T::MINB : 1)
pair_support_kernel(const Args a) {
  constexpr int RP = T::RP, RI = T::RI, LANES = T::LANES, SW = T::SW;
  constexpr int STAGES = T::STAGES, ld = SW + 4;
  extern __shared__ __align__(16) uint32_t smem[];
  const int npg = T::NPG ? T::NPG : a.npg;
  const int nig = T::NIG ? T::NIG : a.nig;
  const int tp = RP * npg, ti = RI * nig, rows = tp + ti;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid / LANES, lane = tid % LANES;
  const int gi = g % nig, gp = g / nig;
  const int p0 = blockIdx.y * tp, i0 = blockIdx.x * ti;
  const long long row_words = a.S * a.W;
  const long long s_begin = (long long)blockIdx.z * a.seqs_per_split;
  const long long s_end = min(a.S, s_begin + a.seqs_per_split);
  // words a stage advances: whole sequences on the narrow tile at W > 1
  const int sw = (kOneWord || LANES == 1) ? SW : a.seqs_per_stage * a.W;
  const long long w_begin = s_begin * a.W, w_end = s_end * a.W;
  const int n_chunks = (int)((w_end - w_begin + sw - 1) / sw);

  // staged row r's source from word w0 on, or null for a row past P or
  // n_live (staged as zeros)
  auto source = [&](int r, long long w0) -> const uint32_t* {
    if (r < tp) return p0 + r < a.P ? a.pt + (p0 + r) * row_words + w0 : nullptr;
    const int i = i0 + r - tp;
    return i < a.n_live ? a.items + i * row_words + w0 : nullptr;
  };
  // stage chunk c into buffer c % STAGES: consecutive threads copy
  // consecutive pieces of one row (rows of at least 32 pieces: a warp a
  // row, so the row's source is found once a warp)
  auto stage = [&](int c) {
    constexpr int piece = kVec ? 4 : 1;
    constexpr int per_row = SW / piece;
    uint32_t* buf = smem + (c % STAGES) * rows * ld;
    const long long w0 = w_begin + (long long)c * sw;
    const int left = (int)min((long long)SW, w_end - w0);   // words to copy
    if constexpr (per_row >= 32) {
      for (int r = tid >> 5; r < rows; r += nthreads >> 5) {
        const uint32_t* src = source(r, w0);
        for (int q = (tid & 31) * piece; q < SW; q += 32 * piece) {
          const bool ok = src != nullptr && q < left;
          copy_async<piece>(buf + r * ld + q, ok ? src + q : a.pt, ok);
        }
      }
    } else {
      for (int e = tid; e < rows * per_row; e += nthreads) {
        const int r = e / per_row, q = (e - r * per_row) * piece;
        const uint32_t* src = source(r, w0);
        const bool ok = src != nullptr && q < left;
        copy_async<piece>(buf + r * ld + q, ok ? src + q : a.pt, ok);
      }
    }
  };

  int acc[RP][RI];
#pragma unroll
  for (int k = 0; k < RP; ++k)
#pragma unroll
    for (int j = 0; j < RI; ++j) acc[k][j] = 0;
  // W > 1 on the wide and mid tiles: the running OR per pair and the
  // position of the next word in its sequence (block-uniform)
  uint32_t hit[RP][RI];
  int pos = 0;
  if constexpr (!kOneWord && LANES == 1) {
#pragma unroll
    for (int k = 0; k < RP; ++k)
#pragma unroll
      for (int j = 0; j < RI; ++j) hit[k][j] = 0u;
  }

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) stage(c);
    commit_async();
  }
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    wait_async<STAGES - 2>();   // this thread's copies of chunk c landed
    __syncthreads();            // everyone's did; chunk c - 1 is counted
    if (c + STAGES - 1 < n_chunks) stage(c + STAGES - 1);
    commit_async();
    const uint32_t* buf = smem + (c % STAGES) * rows * ld;
    const uint32_t* bp = buf + gp * ld;           // parent row k: bp + k * sp
    const uint32_t* bi = buf + (tp + gi) * ld;    // item row j: bi + j * si
    const int sp = npg * ld, si = nig * ld;
    if constexpr (kOneWord || LANES == 1) {
#pragma unroll
      for (int m = 0; m < SW / (4 * LANES); ++m) {
        const int col = 4 * (m * LANES + lane);
        uint4 x[RP];
#pragma unroll
        for (int k = 0; k < RP; ++k) x[k] = *reinterpret_cast<const uint4*>(bp + k * sp + col);
        if constexpr (kOneWord) {
          // an item row at a time: the counts and RP + 1 staged words fit
          // the registers of two wide blocks an SM
#pragma unroll
          for (int j = 0; j < RI; ++j) {
            const uint4 y = *reinterpret_cast<const uint4*>(bi + j * si + col);
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int k = 0; k < RP; ++k) count_and(acc[k][j], word(x[k], q), word(y, q));
          }
        } else {
          uint4 y[RI];
#pragma unroll
          for (int j = 0; j < RI; ++j) y[j] = *reinterpret_cast<const uint4*>(bi + j * si + col);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int k = 0; k < RP; ++k)
#pragma unroll
              for (int j = 0; j < RI; ++j) hit[k][j] |= word(x[k], q) & word(y[j], q);
            if (++pos == a.W) {   // the last word of a sequence: count it once
              pos = 0;
#pragma unroll
              for (int k = 0; k < RP; ++k)
#pragma unroll
                for (int j = 0; j < RI; ++j) {
                  count_nonzero(acc[k][j], hit[k][j]);
                  hit[k][j] = 0u;
                }
            }
          }
        }
      }
    } else {
      // narrow tile, W > 1: a lane takes whole sequences of the stage
      for (int s = lane; s < a.seqs_per_stage; s += LANES) {
        uint32_t h[RP][RI];
#pragma unroll
        for (int k = 0; k < RP; ++k)
#pragma unroll
          for (int j = 0; j < RI; ++j) h[k][j] = 0u;
        for (int w = 0; w < a.W; ++w) {
          const int col = s * a.W + w;
          uint32_t x[RP], y[RI];
#pragma unroll
          for (int k = 0; k < RP; ++k) x[k] = bp[k * sp + col];
#pragma unroll
          for (int j = 0; j < RI; ++j) y[j] = bi[j * si + col];
#pragma unroll
          for (int k = 0; k < RP; ++k)
#pragma unroll
            for (int j = 0; j < RI; ++j) h[k][j] |= x[k] & y[j];
        }
#pragma unroll
        for (int k = 0; k < RP; ++k)
#pragma unroll
          for (int j = 0; j < RI; ++j)
            count_nonzero(acc[k][j], h[k][j]);
      }
    }
  }
  wait_async<0>();

#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const int p = p0 + gp + npg * k;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int i = i0 + gi + nig * j;
      int v = acc[k][j];
      if constexpr (LANES > 1) v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && p < a.P && i < a.n_live && v != 0)
        atomicAdd(&a.out[(long long)p * a.NI + i], v);
    }
  }
}

template <class T, bool kOneWord, bool kVec>
int launch_as(Args a, int threads, size_t smem, long long quantum, long long stage_seqs,
              cudaStream_t st) {
  auto kern = pair_support_kernel<T, kOneWord, kVec>;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int tp = T::RP * a.npg, ti = T::RI * a.nig;
  const long long gx = (a.n_live + ti - 1) / ti, gy = (a.P + tp - 1) / tp;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  // splits of the sequence axis: at least two stages each; among 1..most,
  // the fewest within 2 % of the least waves of blocks per unit of work
  const long long tiles = gx * gy, slots = (long long)sms * per_sm;
  long long most = a.S / (2 * stage_seqs);
  const long long reach = 4 * ((slots + tiles - 1) / tiles) + 16;
  if (most > reach) most = reach;
  if (most > 65535) most = 65535;
  if (most < 1) most = 1;
  double best = 1e300;
  for (long long n = 1; n <= most; ++n) {
    const double cost = (double)((tiles * n + slots - 1) / slots) / (double)n;
    if (cost < best) best = cost;
  }
  long long n = 1;
  while ((double)((tiles * n + slots - 1) / slots) / (double)n > best * 1.02) ++n;
  long long per = (a.S + n - 1) / n;
  per = (per + quantum - 1) / quantum * quantum;
  a.seqs_per_split = per;
  const long long gz = (a.S + per - 1) / per;
  kern<<<dim3((unsigned)gx, (unsigned)gy, (unsigned)gz), threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
int launch(Args a, int npg, int nig, cudaStream_t st) {
  a.npg = npg;
  a.nig = nig;
  const int threads = T::LANES * npg * nig;
  const size_t smem = T::smem(npg, nig);
  if (smem > (size_t)kMaxSmem || threads > T::MAXT) return (int)cudaErrorInvalidValue;
  const bool serial = T::LANES == 1 || a.W == 1;   // a stage is SW words
  a.seqs_per_stage = T::SW / a.W;
  const int sw = serial ? T::SW : a.seqs_per_stage * a.W;
  // 16-byte copies need 16-byte aligned rows, stages and split starts
  // (splits start at multiples of 4 sequences)
  const bool vec = sw % 4 == 0 && (a.S * a.W) % 4 == 0 && (uintptr_t)a.pt % 16 == 0 &&
                   (uintptr_t)a.items % 16 == 0;
  const long long quantum = vec ? 4 : 1;
  const long long stage_seqs = a.seqs_per_stage > 0 ? a.seqs_per_stage : 1;
  if (a.W == 1)
    return vec ? launch_as<T, true, true>(a, threads, smem, quantum, stage_seqs, st)
               : launch_as<T, true, false>(a, threads, smem, quantum, stage_seqs, st);
  return vec ? launch_as<T, false, true>(a, threads, smem, quantum, stage_seqs, st)
             : launch_as<T, false, false>(a, threads, smem, quantum, stage_seqs, st);
}

}  // namespace

// out must be zeroed [P, NI] int32; pt is [P, S*W], items [>= n_live, S*W].
// Item rows n_live..NI-1 are taken to be all zero: they are not read, and
// their columns of out are left as they are.  n_live = 0 launches nothing.
// Returns cudaErrorInvalidValue for a bad size (n_live outside 0..NI).
extern "C" int pair_support_launch(const void* pt, const void* items, void* out,
                                   int P, int NI, int n_live, long long S, int W,
                                   void* stream) {
  if (P <= 0 || NI <= 0 || n_live < 0 || n_live > NI || S <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_live == 0) return (int)cudaSuccess;
  Args a{(const uint32_t*)pt, (const uint32_t*)items, (int32_t*)out, P, NI, n_live, S, W,
         0, 0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (P >= 128 && n_live >= 128) return launch<Wide>(a, 16, 16, st);
  if ((P <= 32 || n_live <= 32) && W <= Narrow::SW) {
    // the short side's rows all in one block, the other side's groups up
    // to kNarrowWarps warps a block and the shared memory a block may have
    const int gp = (P + Narrow::RP - 1) / Narrow::RP;
    const int gi = (n_live + Narrow::RI - 1) / Narrow::RI;
    int npg = gp, nig = gi;
    int& other = gp <= gi ? nig : npg;
    const int small = gp <= gi ? gp : gi;
    if (other > kNarrowWarps / small) other = kNarrowWarps / small;
    while (other > 1 && Narrow::smem(npg, nig) > (size_t)kMaxSmem) --other;
    return launch<Narrow>(a, npg, nig, st);
  }
  return launch<Mid>(a, 16, 16, st);
}
