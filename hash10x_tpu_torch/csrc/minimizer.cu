// Fused seqhash sketch for Hopper (sm_90a): rolling canonical hash, one of
// four emission modes (every k-mer, leftmost-minimum w-window minimizers,
// modimizers, open syncmers), and in-order compaction of each read's
// emissions.
//
// Replaces the TPU kernel built by _make_kernel in
// hash10x_tpu/kernels/minimizer_pallas.py (pl.pallas_call at :403), which
// computes the same function with position-parallel doubling scans over a
// (L, B/128, 128) lane layout.  Semantics here are those of
// hash10x_tpu/core/seqhash_jnp.py in full: any B, invalid bases (code > 3)
// break runs, and a run of valid k-mer positions shorter than w emits its
// leftmost minimum.
//
// Modes (seqhash_jnp.sketch):
//   kmer       every valid k-mer position;
//   minimizer  the leftmost minimum of every w-window of a run;
//   modimizer  valid positions whose canonical hash is 0 mod m (any m >= 1);
//   syncmer    open syncmers: valid positions whose first s-mer's canonical
//              hash (under the s-mer HashSpec's factor and shift) is <= the
//              hashes of the k - s later s-mers inside the k-mer.
//
// What bounds it: bytes.  Each base is read once (1 byte) and each output
// slot written once (an int64 hash and a flags byte), so a 4096-read batch
// of 150 bases compacted to 64 slots moves 3.0 MB (0.9 us at 3.35 TB/s) and
// a crib row group of 4096 rows of 32,768 bases, dense, moves 1.34 GB
// (0.40 ms).  The integer work, two 64-bit multiplies and a few tens of
// 32-bit operations per position, stays below the byte time.  At the read
// batch's size the bytes take under a microsecond, so the floor is the
// launch and each warp's chain of dependent steps (the length and base
// loads, k - 1 + n rolls, the window scans).
//
// Design: a warp works on a tile of one row.  A tile is T own k-mer
// positions plus a halo; every decision at a position depends only on
// bases within w + k of it (its w-windows, their validity and whether its
// run is shorter than w), so tiles with that halo are independent.
//   1. Stage: the tile's bases go to shared memory with 16-byte loads that
//      keep the global alignment; bases outside [0, len) read as invalid.
//   2. Hash: each lane rolls the forward and reverse-complement codes over
//      its own n contiguous positions (n odd, so the lanes' 8-byte shared
//      stores fall in distinct banks), primed with k - 1 bases; a position
//      is valid when the lane has seen k valid bases ending at its last
//      base.  Canonical hashes (INT64_MAX where invalid) and forward bits
//      go to shared memory, and in syncmer mode the s-mer hashes too.
//   3. Emit: lane j decides positions j, j + 32, ... of the tile from
//      shared memory.  kmer and modimizer are per position; syncmer is the
//      minimum over the k - s + 1 s-mer hashes (offset 0 wins ties).  A
//      minimizer position a with hash h is emitted iff, with l the nearest
//      position left of a that is invalid or has a hash <= h and r the
//      nearest right of a that is invalid or has a hash < h, either
//      r - l - 1 >= w (some full window has a as its leftmost minimum) or
//      both l and r are invalid (a is the leftmost minimum of a run shorter
//      than w).  Both scans stop after w - 1 steps, so the halo is w - 1
//      positions on each side.
//   4. Store: dense rows (C == 0) are written position-parallel, 256
//      contiguous bytes of hashes per warp store.  Compacted rows: one warp
//      walks its row's tiles in order, ranks the emissions of each group of
//      32 positions with a ballot and popc on top of the carried count and
//      writes slot base + rank, so slots stay in position order and stores
//      are contiguous; the overflow count is exact.
// Dense rows give every (row, tile) its own warp (a crib row group of 4096
// rows of 32,768 bases is 131,072 warps); compacted rows give each row a
// warp (a read batch of 4096 reads is 4096 warps).  The mode is a template
// parameter, so each mode's kernel holds only its own emission code and
// registers.
//
// Minimizer windows wider than kMaxTileW take sketch_kernel_wide instead: one
// thread per read with a monotone deque in a scratch ring in device memory
// that the wrapper passes, O(1) amortised work per base.
//
// Outputs (row width R = C when compacting, else P = L - k + 1):
//   out_h  (B, R) int64  canonical hashes; INT64_MAX where nothing is held
//   out_f  (B, R) uint8  bit 0 emitted, bit 1 forward strand
//   over   (B,)   int32  emissions beyond C (compact mode), else 0
// Dense mode (C == 0) holds the hash of every valid position and marks
// emissions in bit 0; compact mode holds emissions only, in order.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kPad = INT64_MAX;
constexpr int kTileTarget = 1024;  // own positions per tile on long rows
constexpr int kMaxTileW = 4096;    // widest minimizer window of sketch_kernel
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSmem = 232448;   // shared bytes a block may use on sm_90
constexpr int kWideThreads = 128;

enum Mode { kKmer = 0, kMinimizer = 1, kModimizer = 2, kSyncmer = 3 };

// One call's tile shape, the same for every row.
struct Geometry {
  int n;      // k-mer positions hashed per lane (odd)
  int E;      // 32 * n positions hashed per tile: halo, own, halo
  int halo;   // positions on each side of the own ones (w - 1 or 0)
  int T;      // own positions per tile: E - 2 * halo
  int ns;     // s-mer positions hashed per lane (syncmer mode), else 0
  int nb;     // bases staged per tile
  int tiles;  // tiles per row
  int smem;   // shared bytes per warp, a multiple of 16
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int odd_ceil(int x) { return x | 1; }

Geometry geometry(int P, int k, int w, int mode, int s) {
  Geometry g;
  g.halo = mode == kMinimizer ? w - 1 : 0;
  const int want = ceil_div(P, ceil_div(P, kTileTarget));  // even split
  g.n = odd_ceil(ceil_div(want + 2 * g.halo, 32));
  g.E = 32 * g.n;
  g.T = g.E - 2 * g.halo;
  g.tiles = ceil_div(P, g.T);
  g.ns = mode == kSyncmer ? odd_ceil(ceil_div(g.T + k - s, 32)) : 0;
  g.nb = g.E + k - 1;
  if (mode == kSyncmer && 32 * g.ns + s - 1 > g.nb) g.nb = 32 * g.ns + s - 1;
  g.smem = round16(round16(8 * g.E + 256 * g.ns + g.E) + g.nb + 32);
  return g;
}

__device__ __forceinline__ uint64_t mix(uint64_t x, uint64_t factor,
                                        int shift) {
  return (x * factor) >> shift;
}

// Canonical hashes of the n kk-mers starting at sb[0..n): hs[j] is
// INT64_MAX unless the kk bases from j are all valid; fw[j] (if given) is
// 1 where the forward hash is strictly the smaller.
__device__ __forceinline__ void hash_run(const uint8_t* sb, int n, int kk,
                                         uint64_t factor, int shift,
                                         uint64_t* hs, uint8_t* fw) {
  const uint64_t mask = (1ull << (2 * kk)) - 1;  // kk <= 31
  const int rc_top = 2 * (kk - 1);
  uint64_t fwd = 0, rc = 0;
  int run = 0;  // valid bases ending at the current one
  auto roll = [&](uint32_t c) {
    run = c > 3 ? 0 : run + 1;
    const uint64_t cc = c & 3u;
    fwd = ((fwd << 2) | cc) & mask;
    rc = (rc >> 2) | ((3ull - cc) << rc_top);
  };
  for (int i = 0; i < kk - 1; ++i) roll(sb[i]);
  for (int j = 0; j < n; ++j) {
    roll(sb[j + kk - 1]);
    const uint64_t hf = mix(fwd, factor, shift);
    const uint64_t hr = mix(rc, factor, shift);
    const bool valid = run >= kk;
    const bool is_f = hf < hr;  // ties go to reverse
    hs[j] = valid ? (is_f ? hf : hr) : (uint64_t)kPad;
    if (fw) fw[j] = valid && is_f;
  }
}

// Bases [g0, g0 + nb) of a row into sb[0..nb): the in-row part [lo, hi)
// with 16-byte loads of the aligned chunks inside it, placed so that
// global and shared addresses agree mod 16 (sb starts up to 15 bytes into
// the 16-aligned sbase), and byte loads of its unaligned head and tail, so
// nothing outside [lo, hi) is read; then 4 elsewhere.
__device__ __forceinline__ void stage_bases(const uint8_t* row, int len,
                                            int g0, int nb, uint8_t* sbase,
                                            int lane, uint8_t** sb_out) {
  const uintptr_t first = (uintptr_t)row + (uintptr_t)(intptr_t)g0;
  uint8_t* sb = sbase + (first & 15);
  *sb_out = sb;
  const int lo = max(g0, 0);
  const int hi = max(min(g0 + nb, len), lo);
  if (hi > lo) {
    const uintptr_t p_lo = (uintptr_t)row + lo, p_hi = (uintptr_t)row + hi;
    // aligned chunks [a0, a1); a0 == a1 when [lo, hi) holds none
    const uintptr_t up = (p_lo + 15) & ~(uintptr_t)15;
    const uintptr_t a0 = up < p_hi ? up : p_hi;
    const uintptr_t down = p_hi & ~(uintptr_t)15;
    const uintptr_t a1 = down > a0 ? down : a0;
    const int chunks = (int)((a1 - a0) >> 4);
    uint4* dst = (uint4*)(sb + (intptr_t)(a0 - first));
    const uint4* src = (const uint4*)a0;
    for (int c = lane; c < chunks; c += 32) dst[c] = __ldg(src + c);
    const int head = (int)(a0 - p_lo);
    const int tail0 = (int)(a1 - (uintptr_t)row);  // first base of the tail
    for (int j = lane; j < head + hi - tail0; j += 32) {
      const int i = j < head ? lo + j : tail0 + j - head;
      sb[i - g0] = __ldg(row + i);
    }
  }
  __syncwarp();
  for (int j = lane; j < min(lo - g0, nb); j += 32) sb[j] = 4;
  for (int j = hi - g0 + lane; j < nb; j += 32) sb[j] = 4;
  __syncwarp();
}

// Is own position x (an index into hs) a minimizer?  hs[x] is valid.
__device__ __forceinline__ bool is_minimizer(const uint64_t* hs, int x,
                                             int w) {
  const uint64_t h = hs[x];
  int dl = 0;
  bool left_run_end = false;
  for (; dl < w - 1; ++dl) {
    const uint64_t y = hs[x - dl - 1];
    if (y == (uint64_t)kPad) {
      left_run_end = true;
      break;
    }
    if (y <= h) break;
  }
  const int cap = w - 1 - dl;  // right steps still needed for a full window
  for (int dr = 0; dr < cap; ++dr) {
    const uint64_t y = hs[x + dr + 1];
    if (y == (uint64_t)kPad) return left_run_end;  // a run shorter than w
    if (y < h) return false;
  }
  return true;
}

template <int mode>
__global__ void sketch_kernel(const uint8_t* __restrict__ codes,
                             const int32_t* __restrict__ lengths, int B,
                             int L, int k, int w, uint64_t factor1,
                             int shift1, uint64_t m, int s,
                             uint64_t s_factor1, int s_shift1, int C,
                             Geometry g, int64_t* __restrict__ out_h,
                             uint8_t* __restrict__ out_f,
                             int32_t* __restrict__ over) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool compact = C > 0;
  const int64_t item = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= (compact ? (int64_t)B : (int64_t)B * g.tiles)) return;
  const int b = compact ? (int)item : (int)(item / g.tiles);
  const int t_first = compact ? 0 : (int)(item % g.tiles);
  const int t_end = compact ? g.tiles : t_first + 1;

  uint8_t* ws = smem + (size_t)warp * g.smem;
  uint64_t* hs = (uint64_t*)ws;
  uint64_t* ss = hs + g.E;
  uint8_t* fw = (uint8_t*)(ss + 32 * g.ns);
  uint8_t* sbase = ws + round16(8 * g.E + 256 * g.ns + g.E);

  const int P = L - k + 1;
  const int R = compact ? C : P;
  const int len = min(max(lengths[b], 0), L);
  const uint8_t* row = codes + (int64_t)b * L;
  int64_t* oh = out_h + (int64_t)b * R;
  uint8_t* of = out_f + (int64_t)b * R;
  const int span = k - s;  // later s-mers inside a k-mer (syncmer)
  int n_emit = 0;

  for (int t = t_first; t < t_end; ++t) {
    const int t0 = t * g.T;
    uint8_t* sb;
    stage_bases(row, len, t0 - g.halo, g.nb, sbase, lane, &sb);
    hash_run(sb + lane * g.n, g.n, k, factor1, shift1, hs + lane * g.n,
             fw + lane * g.n);
    if (mode == kSyncmer)  // halo is 0: s-mer j starts at position t0 + j
      hash_run(sb + lane * g.ns, g.ns, s, s_factor1, s_shift1,
               ss + lane * g.ns, nullptr);
    __syncwarp();
    for (int i0 = 0; i0 < g.T; i0 += 32) {
      const int i = i0 + lane;
      const int p = t0 + i;
      const bool in = i < g.T && p < P;
      uint64_t h = kPad;
      uint32_t f = 0;
      bool e = false;
      if (in) {
        const int x = g.halo + i;
        h = hs[x];
        f = fw[x];
        if (h != (uint64_t)kPad) {
          if (mode == kKmer) {
            e = true;
          } else if (mode == kModimizer) {
            e = h % m == 0;
          } else if (mode == kSyncmer) {
            const uint64_t first = ss[i];
            e = true;
            for (int j = 1; j <= span; ++j) e &= ss[i + j] >= first;
          } else {
            e = is_minimizer(hs, x, w);
          }
        }
      }
      if (compact) {
        const unsigned bal = __ballot_sync(~0u, e);
        const int slot = n_emit + __popc(bal & ((1u << lane) - 1u));
        if (e && slot < C) {
          oh[slot] = (int64_t)h;
          of[slot] = (uint8_t)(1u | (f << 1));
        }
        n_emit += __popc(bal);
      } else if (in) {
        oh[p] = (int64_t)h;
        of[p] = (uint8_t)((e ? 1u : 0u) | (f << 1));
      }
    }
    __syncwarp();  // the next tile reuses the shared buffers
  }

  if (compact) {
    for (int r = min(n_emit, C) + lane; r < C; r += 32) {
      oh[r] = kPad;
      of[r] = 0;
    }
    if (lane == 0) over[b] = max(n_emit - C, 0);
  } else if (t_first == 0 && lane == 0) {
    over[b] = 0;
  }
}

// Minimizer mode for w > kMaxTileW: one thread per read, a monotone deque
// of (hash, position << 1 | forward) over the current run in a (capacity,
// B) scratch ring (read b owns column b), front = the window's leftmost
// minimum.
__global__ void sketch_kernel_wide(const uint8_t* __restrict__ codes,
                               const int32_t* __restrict__ lengths, int B,
                               int L, int k, int w, uint64_t factor1,
                               int shift1, int C, uint64_t* ring_h,
                               uint32_t* ring_pf, int ring_mask,
                               int64_t* __restrict__ out_h,
                               uint8_t* __restrict__ out_f,
                               int32_t* __restrict__ over) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int P = L - k + 1;
  const bool compact = C > 0;
  const int R = compact ? C : P;
  const uint8_t* cr = codes + (int64_t)b * L;
  int64_t* oh = out_h + (int64_t)b * R;
  uint8_t* of = out_f + (int64_t)b * R;
  const int len = min(max(lengths[b], 0), L);
  auto H = [&](int i) -> uint64_t& {
    return ring_h[(int64_t)(i & ring_mask) * B + b];
  };
  auto PF = [&](int i) -> uint32_t& {
    return ring_pf[(int64_t)(i & ring_mask) * B + b];
  };

  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int rc_top = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int run_bases = 0;
  int head = 0, tail = 0;
  int run_start = -1, run_last = -1, last_emit = -1, n_emit = 0;

  auto emit = [&](int i) {
    const int p = (int)(PF(i) >> 1);
    if (p == last_emit) return;  // window argmins repeat, never go back
    last_emit = p;
    if (compact) {
      if (n_emit < C) {
        oh[n_emit] = (int64_t)H(i);
        of[n_emit] = (uint8_t)(1u | ((PF(i) & 1u) << 1));
      }
    } else {
      of[p] |= 1;
    }
    ++n_emit;
  };
  // a run shorter than w never completed a window: emit its leftmost minimum
  auto finish_run = [&]() {
    if (run_start >= 0 && run_last - run_start + 1 < w && tail > head)
      emit(head);
    head = tail = 0;
    run_start = run_last = -1;
  };

  for (int i = 0; i < len; ++i) {
    const uint32_t c = cr[i];
    if (c > 3) {
      finish_run();
      run_bases = 0;
    } else {
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - c) << rc_top);
      ++run_bases;
    }
    if (i < k - 1) continue;
    const int p = i - k + 1;
    if (run_bases < k) {
      if (!compact) {
        oh[p] = kPad;
        of[p] = 0;
      }
      continue;
    }
    const uint64_t hf = mix(fwd, factor1, shift1);
    const uint64_t hr = mix(rc, factor1, shift1);
    const uint32_t is_f = hf < hr ? 1u : 0u;
    const uint64_t h = is_f ? hf : hr;
    if (!compact) {
      oh[p] = (int64_t)h;
      of[p] = (uint8_t)(is_f << 1);
    }
    if (run_start < 0) run_start = p;
    run_last = p;
    const int ws = p - w + 1;
    while (tail > head && (int)(PF(head) >> 1) < ws) ++head;
    while (tail > head && H(tail - 1) > h) --tail;
    H(tail) = h;
    PF(tail) = ((uint32_t)p << 1) | is_f;
    ++tail;
    if (ws >= run_start) emit(head);
  }
  finish_run();

  if (compact) {
    for (int r = min(n_emit, C); r < C; ++r) {
      oh[r] = kPad;
      of[r] = 0;
    }
    over[b] = max(n_emit - C, 0);
  } else {
    for (int p = max(len - k + 1, 0); p < P; ++p) {
      oh[p] = kPad;
      of[p] = 0;
    }
    over[b] = 0;
  }
}

}  // namespace

// Widest minimizer window of the tile kernel; wider ones take the scratch
// ring below.
extern "C" int h10x_max_tile_w() { return kMaxTileW; }

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// ring_h/ring_pf: a (ring_mask + 1, B) scratch deque for minimizer mode with
// w > h10x_max_tile_w() (ring_mask + 1 a power of two >= w); null otherwise.
extern "C" int h10x_sketch(const void* codes, const void* lengths, int B,
                           int L, int k, int w, unsigned long long factor1,
                           int shift1, int mode, unsigned long long m, int s,
                           unsigned long long s_factor1, int s_shift1, int C,
                           void* ring_h, void* ring_pf, int ring_mask,
                           void* out_h, void* out_f, void* over,
                           void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == kMinimizer && w > kMaxTileW) {
    sketch_kernel_wide<<<ceil_div(B, kWideThreads), kWideThreads, 0, st>>>(
        (const uint8_t*)codes, (const int32_t*)lengths, B, L, k, w,
        (uint64_t)factor1, shift1, C, (uint64_t*)ring_h, (uint32_t*)ring_pf,
        ring_mask, (int64_t*)out_h, (uint8_t*)out_f, (int32_t*)over);
    return (int)cudaGetLastError();
  }
  const Geometry g = geometry(L - k + 1, k, w, mode, s);
  const int wpb = std::max(1, std::min(kWarpsPerBlock, kMaxSmem / g.smem));
  const int bytes = wpb * g.smem;
  auto kernel = mode == kKmer        ? sketch_kernel<kKmer>
                : mode == kMinimizer ? sketch_kernel<kMinimizer>
                : mode == kModimizer ? sketch_kernel<kModimizer>
                                     : sketch_kernel<kSyncmer>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t items = C > 0 ? (int64_t)B : (int64_t)B * g.tiles;
  kernel<<<(unsigned)((items + wpb - 1) / wpb), wpb * 32, bytes, st>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, B, L, k, w,
      (uint64_t)factor1, shift1, (uint64_t)m, s, (uint64_t)s_factor1,
      s_shift1, C, g, (int64_t*)out_h, (uint8_t*)out_f, (int32_t*)over);
  return (int)cudaGetLastError();
}
