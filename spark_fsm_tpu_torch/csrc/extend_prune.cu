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
// "dead".  Item rows from n_live on are known to be all zero (the engine
// pads its item axis with zero rows), so their raw count is 0: the kernel
// never reads them and writes them dead, exactly what counting them would
// give.  thr is an argument: one build serves every threshold of a mine.
//
// What bounds it on this card.  At the SPAM engine's wave on the
// MSNBC-shaped database (P = 12, NI = 64 of which n_live = 17, S =
// 990,016, W = 1) the function must read 29 rows of 3.96 MB (115 MB,
// 0.034 ms) and do 2 int32 operations per live pair and sequence (0.40 G,
// 0.024 ms): it is bound by bytes.  The threshold and the mask are
// O(P * NI) work.
//
// What the design does about it (W = 1):
// - Only the live item lanes are read and counted: at the MSNBC wave 17 of
//   64, which removes 73 % of the pair work and 64 % of the bytes that a
//   kernel over all 64 lanes moves.
// - Lane = sequence, no staging and no barrier in the counting loop: each
//   thread reads four consecutive sequences' words of TP parent rows and
//   TI = 8 item rows straight from device memory, one 16-byte load a row
//   (a warp's load is 512 coalesced bytes, so a few warps an SM keep
//   enough bytes in flight), and keeps a TP x TI grid of counts in
//   registers, two 16-bit counts a register (the launcher splits the
//   sequence axis so no thread sees more than 65,000 sequences).  Rows
//   whose length or start is not a multiple of four words take one word a
//   step.  TP is a template argument close to the wave's P (12 at the
//   MSNBC wave, 16 for its 128 rows at the BMS wave) rather than a padded
//   16 or 64.  The grid is (item tiles, parent tiles, sequence splits), the
//   splits sized by occupancy so every SM is busy; a parent row is read
//   once per item tile, from L2 after the first.
// - At the end the block reduces its counts with one warp reduction per
//   count and one atomicAdd per pair into the zeroed `sup`.  Then each
//   block takes a ticket from its parent tile's arrival counter
//   (`arrivals`, zeroed by the caller) after a __threadfence(); the block
//   that draws the last ticket reads the finished counts of its parent rows
//   from L2, zeroes the dead lanes and writes the mask words, one warp
//   ballot over 32 consecutive lanes each (no read-modify-write of a mask
//   word).
//
// W > 1 keeps the first design, a simple exact path: a (16 * kRowsP) x 64
// output tile, rows staged in shared memory a chunk of whole sequences at
// a time with the OR over a sequence's words in registers, the sequence
// axis split over gridDim.z, and the same ticket epilogue per output tile.
// It too skips the item rows from n_live on.
//
// Ragged P, NI and S are masked.  NI must be a multiple of 32, so every
// mask word is whole.  The launcher allocates nothing and launches on the
// caller's stream; it returns cudaGetLastError() so a refused launch is
// reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------- W = 1: lane = seq

constexpr int kLaneThreads = 128;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kTileItems = 8;        // item rows a thread counts against

// V consecutive sequences a thread per step: V = 4 reads each row as one
// 16-byte load (S % 4 == 0, 16-byte aligned rows), V = 1 one word.
template <int V> struct Vec;
template <> struct Vec<1> {
  using T = uint32_t;
  __device__ static uint32_t at(const T& v, int) { return v; }
};
template <> struct Vec<4> {
  using T = uint4;
  __device__ static uint32_t at(const T& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }
};

template <int TP, int V>
__global__ void __launch_bounds__(kLaneThreads)
extend_lane_kernel(const uint32_t* __restrict__ pt,
                   const uint32_t* __restrict__ items,
                   int32_t* __restrict__ sup,
                   uint32_t* __restrict__ mask,
                   unsigned int* __restrict__ arrivals,
                   int P, int NI, int n_live, long long S, int thr,
                   long long steps_per_split) {
  constexpr int TI = kTileItems;
  using T = typename Vec<V>::T;
  __shared__ int red[kLaneWarps][TP * TI];
  __shared__ unsigned int ticket;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.y * TP;
  const int i0 = blockIdx.x * TI;
  const int np = min(TP, P - p0);
  const int ni = min(TI, n_live - i0);   // may be <= 0 when n_live == 0
  const long long SV = S / V;            // steps of V sequences (S % V == 0)
  const long long t_begin = (long long)blockIdx.z * steps_per_split;
  const long long t_end = min(SV, t_begin + steps_per_split);
  const T* prow = reinterpret_cast<const T*>(pt + (long long)p0 * S);
  const T* irow = reinterpret_cast<const T*>(items + (long long)i0 * S);

  // two 16-bit counts a register: item j counts in half j & 1 (a thread
  // sees at most 65,535 sequences; the launcher sizes the splits so)
  uint32_t acc[TP][TI / 2];
#pragma unroll
  for (int k = 0; k < TP; ++k)
#pragma unroll
    for (int j = 0; j < TI / 2; ++j) acc[k][j] = 0u;

#pragma unroll 1
  for (long long t = t_begin + tid; t < t_end; t += kLaneThreads) {
    T a[TP], b[TI];
#pragma unroll
    for (int k = 0; k < TP; ++k) a[k] = k < np ? __ldg(prow + k * SV + t) : T{};
#pragma unroll
    for (int j = 0; j < TI; ++j) b[j] = j < ni ? __ldg(irow + j * SV + t) : T{};
#pragma unroll
    for (int q = 0; q < V; ++q)
#pragma unroll
      for (int k = 0; k < TP; ++k)
#pragma unroll
        for (int j = 0; j < TI; ++j)
          if ((Vec<V>::at(a[k], q) & Vec<V>::at(b[j], q)) != 0u)
            acc[k][j >> 1] += (j & 1) ? 0x10000u : 1u;
  }
  // one warp reduction per count, then one atomic per pair of the block
#pragma unroll
  for (int k = 0; k < TP; ++k)
#pragma unroll
    for (int j = 0; j < TI; ++j) {
      const unsigned c = (j & 1) ? acc[k][j >> 1] >> 16 : acc[k][j >> 1] & 0xffffu;
      const int v = (int)__reduce_add_sync(0xffffffffu, c);
      if (lane == 0) red[warp][k * TI + j] = v;
    }
  __syncthreads();
  for (int e = tid; e < TP * TI; e += kLaneThreads) {
    const int k = e / TI, j = e - k * TI;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kLaneWarps; ++w) v += red[w][e];
    if (k < np && j < ni && v != 0) atomicAdd(&sup[(long long)(p0 + k) * NI + i0 + j], v);
  }

  // Arrival: this block's adds are visible device-wide before its ticket.
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(&arrivals[blockIdx.y], 1u);
  __syncthreads();
  if (ticket != gridDim.x * gridDim.z - 1) return;
  __threadfence();

  // The last block of this parent tile: threshold and pack its rows.  A
  // warp's 32 lanes are 32 consecutive item lanes of one row (NI % 32 == 0).
  for (int e = tid; e < np * NI; e += kLaneThreads) {
    const int r = e / NI, i = e - r * NI;
    int32_t* at = &sup[(long long)(p0 + r) * NI + i];
    const int v = __ldcg(at);            // from L2, where the atomics landed
    const bool alive = v >= thr;
    *at = alive ? v : 0;
    const unsigned bits = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) mask[(long long)(p0 + r) * (NI / 32) + i / 32] = bits;
  }
}

template <int TP, int V>
cudaError_t launch_lane_v(const void* pt, const void* items, void* sup, void* mask,
                          void* arrivals, int P, int NI, int n_live, long long S,
                          int thr, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, extend_lane_kernel<TP, V>, kLaneThreads, 0)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int gx = n_live > 0 ? (n_live + kTileItems - 1) / kTileItems : 1;
  const int gy = (P + TP - 1) / TP;
  if (gy > 65535) return cudaErrorInvalidValue;
  const long long tiles = (long long)gx * gy;
  const long long SV = S / V;
  // enough splits to fill the card, and enough that no thread counts more
  // than 65,535 sequences (its 16-bit counters)
  long long splits = ((long long)sms * per_sm + tiles - 1) / tiles;
  const long long least = (S + (long long)kLaneThreads * 65000 - 1) / ((long long)kLaneThreads * 65000);
  if (splits < least) splits = least;
  const long long most = (SV + kLaneThreads - 1) / kLaneThreads;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  if (splits > 65535) return cudaErrorInvalidValue;
  long long per = (SV + splits - 1) / splits;
  per = (per + kLaneThreads - 1) / kLaneThreads * kLaneThreads;
  const long long gz = (SV + per - 1) / per;
  extend_lane_kernel<TP, V><<<dim3(gx, gy, (unsigned)gz), kLaneThreads, 0, st>>>(
      (const uint32_t*)pt, (const uint32_t*)items, (int32_t*)sup, (uint32_t*)mask,
      (unsigned int*)arrivals, P, NI, n_live, S, thr, per);
  return cudaGetLastError();
}

template <int TP>
cudaError_t launch_lane(const void* pt, const void* items, void* sup, void* mask,
                        void* arrivals, int P, int NI, int n_live, long long S,
                        int thr, cudaStream_t st) {
  // 16-byte loads need every row to start 16-byte aligned
  const bool vec = S % 4 == 0 && ((uintptr_t)pt % 16) == 0 && ((uintptr_t)items % 16) == 0;
  if (vec)
    return launch_lane_v<TP, 4>(pt, items, sup, mask, arrivals, P, NI, n_live, S, thr, st);
  return launch_lane_v<TP, 1>(pt, items, sup, mask, arrivals, P, NI, n_live, S, thr, st);
}

// The parent tile: the smallest of 2, 4, 8, 12, 16 that holds P, else the
// one of 8, 12, 16 that pads P least (the larger on a tie).
int parent_tile(int P) {
  const int small[] = {2, 4, 8, 12, 16};
  for (int t : small)
    if (P <= t) return t;
  const int large[] = {12, 8};
  int best = 16;
  for (int t : large) {
    const long long pad_t = (long long)(P + t - 1) / t * t;
    const long long pad_b = (long long)(P + best - 1) / best * best;
    if (pad_t < pad_b) best = t;
  }
  return best;
}

// ------------------------------------------------ W > 1: staged rows

constexpr int kTileI = 64;           // item rows per block
constexpr int kThreadsX = 16;        // threads along the item tile
constexpr int kThreadsY = 16;        // threads along the parent tile
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRowsI = kTileI / kThreadsX;   // item rows per thread (4)
constexpr int kStageWords = 32;      // words per staged row (whole sequences)
constexpr int kMaxSmem = 232448;     // opt-in dynamic shared memory per block

template <int kRowsP>
__global__ void __launch_bounds__(kThreads)
extend_staged_kernel(const uint32_t* __restrict__ pt,
                     const uint32_t* __restrict__ items,
                     int32_t* __restrict__ sup,
                     uint32_t* __restrict__ mask,
                     unsigned int* __restrict__ arrivals,
                     int P, int NI, int n_live, long long S, int W, int thr,
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
      if (i0 + r < n_live && c < nw) v = items[(long long)(i0 + r) * row_words + w0 + c];
      si[r * ld + c] = v;
    }
    __syncthreads();

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
int launch_staged(const void* pt, const void* items, void* sup, void* mask,
                  void* arrivals, int P, int NI, int n_live, long long S, int W,
                  int thr, int target_blocks, cudaStream_t st) {
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
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(extend_staged_kernel<kRowsP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  extend_staged_kernel<kRowsP><<<grid, block, smem, st>>>(
      (const uint32_t*)pt, (const uint32_t*)items, (int32_t*)sup, (uint32_t*)mask,
      (unsigned int*)arrivals, P, NI, n_live, S, W, thr, per, seqs_per_stage);
  return (int)cudaGetLastError();
}

}  // namespace

// sup must be zeroed [P, NI] int32, mask [P, NI / 32] int32 words (every
// word is written), arrivals zeroed with at least P * ceil(NI / 64)
// entries; pt is [P, S*W], items [>= n_live, S*W], and item rows n_live..NI-1
// are taken to be all zero (they are not read).  W = 1 sizes its grid by
// occupancy; target_blocks (about how many blocks the grid should hold) is
// read by the W > 1 path.  Returns cudaErrorInvalidValue for a bad size or
// threshold (NI % 32 != 0, n_live outside 0..NI, thr < 1) and for a W
// whose staged rows need more shared memory than a block may have.
extern "C" int extend_prune_launch(const void* pt, const void* items, void* sup,
                                   void* mask, void* arrivals, int P, int NI,
                                   int n_live, long long S, int W, int thr,
                                   int target_blocks, void* stream) {
  if (P <= 0 || NI <= 0 || NI % 32 != 0 || n_live < 0 || n_live > NI || S <= 0 ||
      W <= 0 || thr < 1 || target_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (W == 1) {
    switch (parent_tile(P)) {
      case 2: return (int)launch_lane<2>(pt, items, sup, mask, arrivals, P, NI, n_live, S, thr, st);
      case 4: return (int)launch_lane<4>(pt, items, sup, mask, arrivals, P, NI, n_live, S, thr, st);
      case 8: return (int)launch_lane<8>(pt, items, sup, mask, arrivals, P, NI, n_live, S, thr, st);
      case 12: return (int)launch_lane<12>(pt, items, sup, mask, arrivals, P, NI, n_live, S, thr, st);
      default: return (int)launch_lane<16>(pt, items, sup, mask, arrivals, P, NI, n_live, S, thr, st);
    }
  }
  if (P <= 16) return launch_staged<1>(pt, items, sup, mask, arrivals, P, NI, n_live, S, W, thr, target_blocks, st);
  if (P <= 32) return launch_staged<2>(pt, items, sup, mask, arrivals, P, NI, n_live, S, W, thr, target_blocks, st);
  return launch_staged<4>(pt, items, sup, mask, arrivals, P, NI, n_live, S, W, thr, target_blocks, st);
}
