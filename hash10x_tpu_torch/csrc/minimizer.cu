// Fused seqhash sketch for Hopper (sm_90a): rolling canonical hash, one of
// four emission modes (every k-mer, leftmost-minimum w-window minimizers,
// modimizers, open syncmers), and in-order compaction of each read's
// emissions, one thread per read.
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
//   modimizer  valid positions whose canonical hash is 0 mod m (any m >= 1;
//              the TPU kernel folds through u32 and needs 1 < m < 2^16);
//   syncmer    open syncmers: valid positions whose first s-mer's canonical
//              hash (under the s-mer HashSpec's factor and shift) is <= the
//              hashes of the k - s later s-mers inside the k-mer.
//
// What bounds it: per emitted slot the kernel writes 9 bytes (int64 hash +
// flags byte) and reads about 1 byte per base, so device memory traffic is a
// few MB per 4096-read batch; the work per read is a sequential scan of L
// bases.  With one thread per read a batch of 4096 reads fills only a few
// warps per SM, so the kernel is bound by the latency of that sequential
// scan, not by bytes.  The design keeps everything but the codes and the
// outputs in registers and thread-local memory: the rolling forward and
// reverse-complement codes are two 64-bit registers (the s-mer codes are
// their low and high 2s bits), the window minimum is a monotone deque in a
// ring, and the s-mer hashes of the current k-mer sit in a 32-entry ring, so
// each base costs O(1) amortised work (O(k - s) in syncmer mode) and no
// position grid is ever materialised.  The deque never holds more than w
// entries: for w <= 64 its ring is 64 entries of thread-local memory; for
// larger w the wrapper passes a scratch ring of a power of two >= w entries
// per read in device memory, laid out slot-major so that neighbouring
// threads touch neighbouring words.  Emissions come out in ascending
// position order in every mode (the leftmost window argmin is non-decreasing
// in the window start; the other modes decide each position when its k-mer
// completes), so compaction is a per-read counter.
//
// Outputs (row width R = C when compacting, else P = L - k + 1):
//   out_h  (B, R) int64  canonical hashes; INT64_MAX where nothing is held
//   out_f  (B, R) uint8  bit 0 emitted, bit 1 forward strand
//   over   (B,)   int32  emissions beyond C (compact mode), else 0
// Dense mode (C == 0) holds the hash of every valid position and marks
// emissions in bit 0; compact mode holds emissions only, in order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLocalRing = 64;  // deque ring in thread-local memory (w <= 64)
constexpr int kSmerRing = 32;   // s-mer hash ring: span = k - s + 1 <= 31
constexpr int64_t kPad = INT64_MAX;
constexpr int kThreads = 128;

enum Mode { kKmer = 0, kMinimizer = 1, kModimizer = 2, kSyncmer = 3 };

// The window deque's storage.  Entry i of the deque lives at slot
// i & (capacity - 1); head and tail are running counters.
struct LocalRing {
  uint64_t h[kLocalRing];
  uint32_t pf[kLocalRing];
  __device__ void init(uint64_t*, uint32_t*, int, int, int) {}
  __device__ uint64_t& H(int i) { return h[i & (kLocalRing - 1)]; }
  __device__ uint32_t& PF(int i) { return pf[i & (kLocalRing - 1)]; }
};

struct GlobalRing {  // (capacity, B) scratch, read b owns column b
  uint64_t* h;
  uint32_t* pf;
  int mask;
  int64_t stride;
  __device__ void init(uint64_t* rh, uint32_t* rpf, int rmask, int b, int B) {
    h = rh + b;
    pf = rpf + b;
    mask = rmask;
    stride = B;
  }
  __device__ uint64_t& H(int i) { return h[(int64_t)(i & mask) * stride]; }
  __device__ uint32_t& PF(int i) { return pf[(int64_t)(i & mask) * stride]; }
};

__device__ __forceinline__ uint64_t mix(uint64_t x, uint64_t factor,
                                        int shift) {
  return (x * factor) >> shift;
}

template <class Ring>
__global__ void sketch_kernel(const uint8_t* __restrict__ codes,
                              const int32_t* __restrict__ lengths, int B,
                              int L, int k, int w, uint64_t factor1,
                              int shift1, int mode, uint64_t m, int s,
                              uint64_t s_factor1, int s_shift1, int C,
                              uint64_t* ring_h, uint32_t* ring_pf,
                              int ring_mask, int64_t* __restrict__ out_h,
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

  const uint64_t mask = (1ull << (2 * k)) - 1;  // k <= 31
  const int rc_top = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int run_bases = 0;  // valid bases ending at the current one

  // syncmer: the last s bases are fwd's low 2s bits and, reverse
  // complemented, rc's high 2s bits (rc >> 2(k - s)); valid once
  // run_bases >= s.  smer[q & 31] = canonical hash of the s-mer at q.
  const uint64_t s_mask = mode == kSyncmer ? (1ull << (2 * s)) - 1 : 0;
  const int s_rc_shift = 2 * (k - s);
  const int span = k - s + 1;
  uint64_t smer[kSmerRing];

  // monotone deque of (hash, position << 1 | forward) over the current run
  // of valid k-mer positions; front = leftmost minimum of the window
  Ring dq;
  dq.init(ring_h, ring_pf, ring_mask, b, B);
  int head = 0, tail = 0;
  int run_start = -1;  // first k-mer position of the current run
  int run_last = -1;   // last k-mer position of the current run
  int last_emit = -1;
  int n_emit = 0;

  auto emit = [&](int p, uint64_t h, uint32_t f) {
    if (p == last_emit) return;  // window argmins repeat, never go back
    last_emit = p;
    if (compact) {
      if (n_emit < C) {
        oh[n_emit] = (int64_t)h;
        of[n_emit] = (uint8_t)(1u | (f << 1));
      }
    } else {
      of[p] |= 1;
    }
    ++n_emit;
  };
  // a run shorter than w never completed a window: emit its leftmost minimum
  auto finish_run = [&]() {
    if (mode == kMinimizer && run_start >= 0 && run_last - run_start + 1 < w &&
        tail > head) {
      emit((int)(dq.PF(head) >> 1), dq.H(head), dq.PF(head) & 1u);
    }
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
    if (mode == kSyncmer && run_bases >= s) {
      const uint64_t sf = mix(fwd & s_mask, s_factor1, s_shift1);
      const uint64_t sr = mix(rc >> s_rc_shift, s_factor1, s_shift1);
      smer[(i - s + 1) & (kSmerRing - 1)] = sf < sr ? sf : sr;
    }
    if (i < k - 1) continue;
    const int p = i - k + 1;
    if (run_bases < k) {  // window holds an invalid base
      if (!compact) {
        oh[p] = kPad;
        of[p] = 0;
      }
      continue;
    }
    const uint64_t hf = mix(fwd, factor1, shift1);
    const uint64_t hr = mix(rc, factor1, shift1);
    const uint32_t is_f = hf < hr ? 1u : 0u;  // ties go to reverse
    const uint64_t h = is_f ? hf : hr;
    if (!compact) {
      oh[p] = (int64_t)h;
      of[p] = (uint8_t)(is_f << 1);
    }
    if (mode == kKmer) {
      emit(p, h, is_f);
      continue;
    }
    if (mode == kModimizer) {
      if (h % m == 0) emit(p, h, is_f);
      continue;
    }
    if (mode == kSyncmer) {
      // offset 0 wins ties: keep iff no later s-mer is strictly smaller
      const uint64_t first = smer[p & (kSmerRing - 1)];
      bool keep = true;
      for (int j = 1; j < span; ++j)
        keep &= smer[(p + j) & (kSmerRing - 1)] >= first;
      if (keep) emit(p, h, is_f);
      continue;
    }
    if (run_start < 0) run_start = p;
    run_last = p;
    const int ws = p - w + 1;  // start of the window ending at p
    while (tail > head && (int)(dq.PF(head) >> 1) < ws) ++head;
    while (tail > head && dq.H(tail - 1) > h) --tail;
    dq.H(tail) = h;
    dq.PF(tail) = ((uint32_t)p << 1) | is_f;
    ++tail;
    if (ws >= run_start) emit((int)(dq.PF(head) >> 1), dq.H(head),
                              dq.PF(head) & 1u);
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

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// ring_h/ring_pf: a (ring_mask + 1, B) scratch deque for minimizer mode with
// w > 64 (ring_mask + 1 a power of two >= w); null otherwise.
extern "C" int h10x_sketch(const void* codes, const void* lengths, int B,
                           int L, int k, int w, unsigned long long factor1,
                           int shift1, int mode, unsigned long long m, int s,
                           unsigned long long s_factor1, int s_shift1, int C,
                           void* ring_h, void* ring_pf, int ring_mask,
                           void* out_h, void* out_f, void* over,
                           void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  const bool global_ring = mode == kMinimizer && w > kLocalRing;
  auto kernel = global_ring ? sketch_kernel<GlobalRing>
                            : sketch_kernel<LocalRing>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, B, L, k, w,
      (uint64_t)factor1, shift1, mode, (uint64_t)m, s, (uint64_t)s_factor1,
      s_shift1, C, (uint64_t*)ring_h, (uint32_t*)ring_pf, ring_mask,
      (int64_t*)out_h, (uint8_t*)out_f, (int32_t*)over);
  return (int)cudaGetLastError();
}
