// Fused seqhash sketch for Hopper (sm_90a): rolling canonical hash,
// leftmost-minimum w-window minimizers (or every k-mer), and in-order
// compaction of each read's emissions, one thread per read.
//
// Replaces the TPU kernel built by _make_kernel in
// hash10x_tpu/kernels/minimizer_pallas.py (pl.pallas_call at :403), which
// computes the same function with position-parallel doubling scans over a
// (L, B/128, 128) lane layout.  Semantics here are those of
// hash10x_tpu/core/seqhash_jnp.py in full: any B, invalid bases (code > 3)
// break runs, and a run of valid k-mer positions shorter than w emits its
// leftmost minimum.
//
// What bounds it: per emitted slot the kernel writes 9 bytes (int64 hash +
// flags byte) and reads about 1 byte per base, so device memory traffic is a
// few MB per 4096-read batch; the work per read is a sequential scan of L
// bases.  With one thread per read a batch of 4096 reads fills only a few
// warps per SM, so the kernel is bound by the latency of that sequential
// scan, not by bytes.  The design keeps everything but the codes and the
// outputs in registers and thread-local memory: the rolling forward and
// reverse-complement codes are two 64-bit registers, and the window minimum
// is a monotone deque in a 64-entry ring (w <= 64), so each base costs O(1)
// amortised work and no position grid is ever materialised.  Emissions come
// out in ascending position order because the leftmost window argmin is
// non-decreasing in the window start, so compaction is a per-read counter.
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

constexpr int kRing = 64;  // deque capacity; the wrapper enforces w <= kRing
constexpr int64_t kPad = INT64_MAX;
constexpr int kThreads = 128;

enum Mode { kKmer = 0, kMinimizer = 1 };

__global__ void sketch_kernel(const uint8_t* __restrict__ codes,
                              const int32_t* __restrict__ lengths, int B,
                              int L, int k, int w, uint64_t factor1,
                              int shift1, int mode, int C,
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

  const uint64_t mask = (1ull << (2 * k)) - 1;  // k <= 31
  const int rc_top = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int run_bases = 0;  // valid bases ending at the current one

  // monotone deque of (hash, position << 1 | forward) over the current run
  // of valid k-mer positions; front = leftmost minimum of the window
  uint64_t dq_h[kRing];
  uint32_t dq_pf[kRing];
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
      const int f = head & (kRing - 1);
      emit((int)(dq_pf[f] >> 1), dq_h[f], dq_pf[f] & 1u);
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
    if (i < k - 1) continue;
    const int p = i - k + 1;
    if (run_bases < k) {  // window holds an invalid base
      if (!compact) {
        oh[p] = kPad;
        of[p] = 0;
      }
      continue;
    }
    const uint64_t hf = (fwd * factor1) >> shift1;
    const uint64_t hr = (rc * factor1) >> shift1;
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
    if (run_start < 0) run_start = p;
    run_last = p;
    const int s = p - w + 1;  // start of the window ending at p
    while (tail > head && (int)(dq_pf[head & (kRing - 1)] >> 1) < s) ++head;
    while (tail > head && dq_h[(tail - 1) & (kRing - 1)] > h) --tail;
    dq_h[tail & (kRing - 1)] = h;
    dq_pf[tail & (kRing - 1)] = ((uint32_t)p << 1) | is_f;
    ++tail;
    if (s >= run_start) {
      const int f = head & (kRing - 1);
      emit((int)(dq_pf[f] >> 1), dq_h[f], dq_pf[f] & 1u);
    }
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
extern "C" int h10x_sketch(const void* codes, const void* lengths, int B,
                           int L, int k, int w, unsigned long long factor1,
                           int shift1, int mode, int C, void* out_h,
                           void* out_f, void* over, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  sketch_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, B, L, k, w,
      (uint64_t)factor1, shift1, mode, C, (int64_t*)out_h, (uint8_t*)out_f,
      (int32_t*)over);
  return (int)cudaGetLastError();
}
