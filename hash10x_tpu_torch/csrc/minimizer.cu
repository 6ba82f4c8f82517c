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
// Minimizer windows wider than kMaxTileW (the wide route) would need a halo
// of w - 1 positions on each side, so they take three position-parallel
// passes instead, with O(log) work per position whatever w is and nothing
// w-sized in shared memory (van Herk / Gil-Werman window minima):
//   1. Hash: sketch_kernel<kHashes> (the kmer body, halo 0, bit 0 left
//      clear) writes every position's canonical hash and forward bit,
//      dense, into out_h/out_f, or into a (B, P) scratch when compacting.
//   2. Window: each row is cut into blocks of w positions from position 0,
//      and one CUDA block takes block j of one row.  It runs an inclusive
//      prefix arg-lexmin over (hash, position) of block j + 1 up to its
//      first invalid position f1 (the args go to a (B, P) int32 scratch;
//      later positions are never asked for), then a suffix arg-lexmin of
//      block j, segmented at every run break, from the right, chunk by
//      chunk (warp shuffles, then the warps' aggregates in shared memory,
//      then a carry into the next chunk).  A window of w valid positions
//      starting at s then has argmin lexmin(suffix[s], prefix[s + w - 1]),
//      and a run [s, re) shorter than w lexmin(suffix[s], prefix[re - 1])
//      (it spans at most two blocks).  Window starts are the valid s with
//      s <= max(run end - w, run start) (seqhash_jnp's rule); each sets
//      bit 0 of flags[argmin], skipping an argmin equal to the previous
//      position's.  Writers of one flag byte store the same value, so the
//      race is benign, and no state passes between CUDA blocks.
//   3. Compact (C > 0): a warp per row ranks the marks in position order
//      with ballots, 16 groups of 32 positions per step, and writes them
//      with an exact overflow count.
// Bytes of the wide route: pass 1 is the kmer route's (1 + 9 bytes per
// position); pass 2 reads each hash about twice (own block's suffix, the
// previous block's prefix, mostly from L2) and writes and reads 4 bytes of
// prefix args; compacting writes pass 1 into the scratch and reads a flags
// byte per position back.  Its bound is the same sketch_bound as every
// route's (each input read once, each output written once).
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
constexpr int kScanThreads = 512;  // most threads of a wide-route scan block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kCompactGroups = 16; // 32-position ballot groups per step

// kHashes is the wide route's first pass: kmer's hashes, no emission.
enum Mode { kKmer = 0, kMinimizer = 1, kModimizer = 2, kSyncmer = 3,
            kHashes = 4 };

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
__host__ __device__ constexpr int round_up32(int x) { return (x + 31) & ~31; }
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
          } else if (mode == kMinimizer) {
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

// (hash, position) pairs in lexicographic order: the leftmost minimum wins.
__device__ __forceinline__ bool lex_less(uint64_t h1, int p1, uint64_t h2,
                                         int p2) {
  return h1 < h2 || (h1 == h2 && p1 < p2);
}

// Pass 2 of the wide route (see the header): CUDA block (b, j) takes block j
// = [bs, be) of row b's w-blocks and sets bit 0 of flags at the argmin of
// every window start in it.  hashes/flags are pass 1's dense (B, P) grids;
// pre is a (B, P) int32 scratch that only this block reads back.
__global__ void __launch_bounds__(kScanThreads)
    wide_window_marks(const int64_t* __restrict__ hashes, uint8_t* flags,
                      int32_t* pre, int P, int w, int nblk) {
  __shared__ uint64_t tot_h[2][kScanWarps];  // warp aggregates, two chunks
  __shared__ int tot_a[2][kScanWarps];
  __shared__ int tot_e[2][kScanWarps];
  __shared__ int tot_f[2][kScanWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int64_t b = blockIdx.x / nblk;
  const int j = (int)(blockIdx.x % nblk);
  const uint64_t* hs = (const uint64_t*)hashes + b * P;
  uint8_t* fl = flags + b * P;
  int32_t* pr = pre + b * P;
  const int bs = j * w;                                   // block j: [bs, be)
  const int be = (int)min((int64_t)bs + w, (int64_t)P);   // block j + 1: [be, q1)
  const int q1 = (int)min((int64_t)be + w, (int64_t)P);
  const bool full = (int64_t)bs + w == be;                // not cut by P
  int buf = 0;

  // Prefix arg-lexmin over [be, p) of block j + 1, stopping at its first
  // invalid position f1 (the end of the run that enters it).  Each chunk
  // of nt positions: a warp scan, then every warp scans the carry and the
  // warps' aggregates across its lanes (lane 0 the carry, lane i warp
  // i - 1), so that lane `warp` holds what comes before its warp.  The next
  // chunk's hashes are loaded before this chunk's scans.
  int f1 = q1;
  uint64_t ch = (uint64_t)kPad;  // carry: lexmin of the chunks before
  int ca = INT32_MAX;
  uint64_t h_next = be + tid < q1 ? __ldg(hs + be + tid) : (uint64_t)kPad;
  for (int c0 = be; c0 < f1; c0 += nt, buf ^= 1) {
    const int p = c0 + tid;
    uint64_t h = h_next;
    h_next = p + nt < q1 ? __ldg(hs + p + nt) : (uint64_t)kPad;
    int a = p;
    const int bad = p < q1 && h == (uint64_t)kPad ? p : INT32_MAX;
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t h2 = __shfl_up_sync(~0u, h, d);
      const int a2 = __shfl_up_sync(~0u, a, d);
      if (lane >= d && lex_less(h2, a2, h, a)) {
        h = h2;
        a = a2;
      }
    }
    const int wbad = __reduce_min_sync(~0u, bad);
    if (lane == 31) {
      tot_h[buf][warp] = h;
      tot_a[buf][warp] = a;
    }
    if (lane == 0) tot_e[buf][warp] = wbad;
    __syncthreads();
    uint64_t sh = lane == 0     ? ch
                  : lane <= nw ? tot_h[buf][lane - 1]
                               : (uint64_t)kPad;
    int sa = lane == 0 ? ca : lane <= nw ? tot_a[buf][lane - 1] : INT32_MAX;
    const int cbad =
        __reduce_min_sync(~0u, lane < nw ? tot_e[buf][lane] : INT32_MAX);
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t h2 = __shfl_up_sync(~0u, sh, d);
      const int a2 = __shfl_up_sync(~0u, sa, d);
      if (lane >= d && lex_less(h2, a2, sh, sa)) {
        sh = h2;
        sa = a2;
      }
    }
    const uint64_t ih = __shfl_sync(~0u, sh, warp);
    const int ia = __shfl_sync(~0u, sa, warp);
    if (lex_less(ih, ia, h, a)) a = ia;
    f1 = min(f1, cbad);
    if (p < f1) pr[p] = a;
    ch = __shfl_sync(~0u, sh, nw);
    ca = __shfl_sync(~0u, sa, nw);
  }
  __syncthreads();  // pr[] is read below by other threads of the block

  // Suffix arg-lexmin of block j, segmented at run breaks, from the right.
  // State: (h, a) = lexmin of [p, e], e = the segment's last position,
  // f = whether e lies in the range scanned so far.  The carry always ends
  // a segment (block j's last position does), so it stops every scan.
  ch = (uint64_t)kPad;
  ca = INT32_MAX;
  int ce = -1;
  const int c_last = bs + (be - bs - 1) / nt * nt;
  h_next = c_last + tid < be ? __ldg(hs + c_last + tid) : (uint64_t)kPad;
  for (int c0 = c_last; c0 >= bs; c0 -= nt, buf ^= 1) {
    const int p = c0 + tid;
    const bool in = p < be;
    uint64_t h = h_next;
    if (c0 > bs) h_next = __ldg(hs + p - nt);
    const int valid = h != (uint64_t)kPad;
    int nv = __shfl_down_sync(~0u, valid, 1);           // valid[p + 1]
    if (lane == 31) nv = p + 1 < be && __ldg(hs + p + 1) != (uint64_t)kPad;
    nv = nv && p + 1 < be;
    int pv = __shfl_up_sync(~0u, valid, 1);             // valid[p - 1]
    if (lane == 0) pv = in && p >= 1 && __ldg(hs + p - 1) != (uint64_t)kPad;
    int a = p, e = p;
    int f = !valid || !nv;  // p ends its segment
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t h2 = __shfl_down_sync(~0u, h, d);
      const int a2 = __shfl_down_sync(~0u, a, d);
      const int e2 = __shfl_down_sync(~0u, e, d);
      const int f2 = __shfl_down_sync(~0u, f, d);
      if (lane + d < 32 && !f) {
        if (lex_less(h2, a2, h, a)) {
          h = h2;
          a = a2;
        }
        e = e2;
        f = f2;
      }
    }
    if (lane == 0) {
      tot_h[buf][warp] = h;
      tot_a[buf][warp] = a;
      tot_e[buf][warp] = e;
      tot_f[buf][warp] = f;
    }
    __syncthreads();
    // the same segmented scan over lane i = warp i's aggregate, lane nw =
    // the carry: lane warp + 1 then holds what comes after my warp
    uint64_t sh = (uint64_t)kPad;
    int sa = INT32_MAX, se = ce, sf = 1;
    if (lane < nw) {
      sh = tot_h[buf][lane];
      sa = tot_a[buf][lane];
      se = tot_e[buf][lane];
      sf = tot_f[buf][lane];
    } else if (lane == nw) {
      sh = ch;
      sa = ca;
    }
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t h2 = __shfl_down_sync(~0u, sh, d);
      const int a2 = __shfl_down_sync(~0u, sa, d);
      const int e2 = __shfl_down_sync(~0u, se, d);
      const int f2 = __shfl_down_sync(~0u, sf, d);
      if (lane + d < 32 && !sf) {
        if (lex_less(h2, a2, sh, sa)) {
          sh = h2;
          sa = a2;
        }
        se = e2;
        sf = f2;
      }
    }
    const uint64_t ih = __shfl_sync(~0u, sh, warp + 1);
    const int ia = __shfl_sync(~0u, sa, warp + 1);
    const int ie = __shfl_sync(~0u, se, warp + 1);
    if (!f) {
      if (lex_less(ih, ia, h, a)) {
        h = ih;
        a = ia;
      }
      e = ie;
    }
    ch = __shfl_sync(~0u, sh, 0);
    ca = __shfl_sync(~0u, sa, 0);
    ce = __shfl_sync(~0u, se, 0);

    // the window start at p, if any, and its argmin
    int arg = -1;
    if (in && valid) {
      const bool run_start = !pv;
      if (full && e == be - 1) {   // p's run reaches the end of block j
        int x = -1;                // the window's last position in block j + 1
        if (p == bs) {
          arg = a;                 // the window is block j
        } else if ((int64_t)p + w - 1 < f1) {
          arg = a;                 // a full window into block j + 1
          x = p + w - 1;
        } else if (run_start) {    // a run [p, f1) shorter than w
          arg = a;
          if (f1 > be) x = f1 - 1;
        }
        if (x >= 0) {
          const int a2 = pr[x];
          if (lex_less(__ldg(hs + a2), a2, h, a)) arg = a2;
        }
      } else if (run_start) {
        arg = a;                   // a run [p, e] inside block j, < w long
      }
    }
    const int prev = __shfl_up_sync(~0u, arg, 1);
    if (arg >= 0 && (lane == 0 || prev != arg)) fl[arg] |= 1;
  }
}

// Pass 3 of the wide route, C > 0: a warp per row ranks the marks of the
// dense (B, P) grids in position order and writes them to (B, C) rows.
__global__ void compact_marks(const int64_t* __restrict__ hashes,
                              const uint8_t* __restrict__ flags, int B, int P,
                              int C, int64_t* __restrict__ out_h,
                              uint8_t* __restrict__ out_f,
                              int32_t* __restrict__ over) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int64_t* hs = hashes + b * P;
  const uint8_t* fl = flags + b * P;
  int64_t* oh = out_h + b * C;
  uint8_t* of = out_f + b * C;
  int n_emit = 0;
  for (int c0 = 0; c0 < P; c0 += 32 * kCompactGroups) {
    uint32_t f[kCompactGroups];
#pragma unroll
    for (int i = 0; i < kCompactGroups; ++i) {
      const int p = c0 + 32 * i + lane;
      f[i] = p < P ? __ldg(fl + p) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kCompactGroups; ++i) {
      const bool e = f[i] & 1u;
      const unsigned bal = __ballot_sync(~0u, e);
      const int slot = n_emit + __popc(bal & ((1u << lane) - 1u));
      if (e && slot < C) {
        oh[slot] = __ldg(hs + c0 + 32 * i + lane);
        of[slot] = (uint8_t)(1u | (f[i] & 2u));
      }
      n_emit += __popc(bal);
    }
  }
  for (int r = min(n_emit, C) + lane; r < C; r += 32) {
    oh[r] = kPad;
    of[r] = 0;
  }
  if (lane == 0) over[b] = max(n_emit - C, 0);
}

// One launch of the tile kernel of `mode` over (B, L) into rows of width C
// or P.
int launch_tiles(int mode, const uint8_t* codes, const int32_t* lengths,
                 int B, int L, int k, int w, uint64_t factor1, int shift1,
                 uint64_t m, int s, uint64_t s_factor1, int s_shift1, int C,
                 int64_t* out_h, uint8_t* out_f, int32_t* over,
                 cudaStream_t st) {
  const Geometry g = geometry(L - k + 1, k, w, mode, s);
  const int wpb = std::max(1, std::min(kWarpsPerBlock, kMaxSmem / g.smem));
  const int bytes = wpb * g.smem;
  auto kernel = mode == kKmer        ? sketch_kernel<kKmer>
                : mode == kMinimizer ? sketch_kernel<kMinimizer>
                : mode == kModimizer ? sketch_kernel<kModimizer>
                : mode == kSyncmer   ? sketch_kernel<kSyncmer>
                                     : sketch_kernel<kHashes>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t items = C > 0 ? (int64_t)B : (int64_t)B * g.tiles;
  kernel<<<(unsigned)((items + wpb - 1) / wpb), wpb * 32, bytes, st>>>(
      codes, lengths, B, L, k, w, factor1, shift1, m, s, s_factor1, s_shift1,
      C, g, out_h, out_f, over);
  return (int)cudaGetLastError();
}

}  // namespace

// Widest minimizer window of the tile kernel; wider ones take the wide
// route's three passes.
extern "C" int h10x_max_tile_w() { return kMaxTileW; }

// Launches on `stream` and returns the first cudaGetLastError() that is not
// 0 (0 = launched).  Scratch for minimizer mode with w > h10x_max_tile_w(),
// null otherwise: pre a (B, P) int32 grid; hash_scratch (B, P) int64 and
// flag_scratch (B, P) uint8 when C > 0 (dense rows use out_h/out_f).
extern "C" int h10x_sketch(const void* codes, const void* lengths, int B,
                           int L, int k, int w, unsigned long long factor1,
                           int shift1, int mode, unsigned long long m, int s,
                           unsigned long long s_factor1, int s_shift1, int C,
                           void* pre, void* hash_scratch, void* flag_scratch,
                           void* out_h, void* out_f, void* over,
                           void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* cd = (const uint8_t*)codes;
  const int32_t* ln = (const int32_t*)lengths;
  int64_t* oh = (int64_t*)out_h;
  uint8_t* of = (uint8_t*)out_f;
  int32_t* ov = (int32_t*)over;
  if (mode == kMinimizer && w > kMaxTileW) {
    const int P = L - k + 1;
    int64_t* hs = C > 0 ? (int64_t*)hash_scratch : oh;
    uint8_t* fl = C > 0 ? (uint8_t*)flag_scratch : of;
    int rc = launch_tiles(kHashes, cd, ln, B, L, k, w, factor1, shift1, 0, 0,
                          0, 0, 0, hs, fl, ov, st);
    if (rc != 0) return rc;
    const int nblk = ceil_div(P, w);
    const int nt = std::min(kScanThreads, round_up32(std::min(w, P)));
    wide_window_marks<<<(unsigned)((int64_t)B * nblk), nt, 0, st>>>(
        hs, fl, (int32_t*)pre, P, w, nblk);
    rc = (int)cudaGetLastError();
    if (rc != 0 || C == 0) return rc;
    const int rows = kWarpsPerBlock;
    compact_marks<<<ceil_div(B, rows), rows * 32, 0, st>>>(hs, fl, B, P, C,
                                                           oh, of, ov);
    return (int)cudaGetLastError();
  }
  return launch_tiles(mode, cd, ln, B, L, k, w, factor1, shift1, m, s,
                      s_factor1, s_shift1, C, oh, of, ov, st);
}
