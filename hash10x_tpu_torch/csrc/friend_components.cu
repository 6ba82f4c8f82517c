// Connected components of capped-friend clustering's bipartite (k-mer,
// friend) graph, one barcode row a thread block, in one pass over the row's
// membership mask, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package links a k-mer and a friend of a
// barcode where the friend's id is in the k-mer's barcode list and
// propagates labels in rounds over the (B, K, F) mask (friend_union_batch in
// hash10x_tpu/cluster/cooccur.py), and the port's plain version is those
// rounds in torch (cluster/cooccur.py _friend_rounds): each round writes and
// reduces two int64 (B, K, F) temporaries, the k-mer labels to each friend
// column's minimum and back, and reads a value back to the host, until no
// label moves.  The fixpoint is each k-mer's component minimum, which one
// union-find pass over the mask's set cells gives.
//
// Row b of the batch is one thread block over K + F nodes: k-mer k is node
// k, friend column f is node K + f.
//   init   parent[i] = i in shared memory (int32) for the K + F nodes and
//          the row's valid flags beside them; n = 1 + the last valid
//          k-mer's index.
//   hook   the warps stream rows k < n of m[b] (rows of pads skipped), one
//          k-mer's F cells a group of lanes at a time: as many lanes as the
//          row has loads, rounded up to a power of two and at most 32 (16
//          at F = 256, so a warp takes two rows at once), with 16-byte
//          loads where F is a multiple of 16 and m is 16-byte aligned (else
//          byte loads), up to two loads a lane in flight.  A lane turns its
//          loads into a bit a cell (a bool is a byte of 0 or 1) and visits
//          the set cells only; a set cell (k, f) links k and K + f.  Each
//          lane keeps rk, an ancestor of k (its root when last seen; the
//          group takes its lanes' smallest after each step), and a cell
//          whose friend node hangs right under rk is already inside k's
//          component: once a friend has been joined, most of its cells end
//          there, at the cost of one shared-memory read.  Any other cell
//          climbs both ends to their roots with path halving
//          (plain stores: a store only ever points a non-root at one of its
//          ancestors), hooks the larger root under the smaller with
//          atomicCAS(parent[hi], hi, lo), retrying from what hi now points
//          at when the CAS finds it hooked meanwhile, and then points the
//          friend node right at the common root.  Every root is thus the
//          smallest index of its tree, whatever order the atomics land in;
//          a friend node's index exceeds every k-mer's, so at the end the
//          root of a component that holds a k-mer is its smallest k-mer.
//          Successful hooks are summed per block and added to one counter.
//   label  labels[b][k] = root of k (int64) for a valid k-mer, K for a pad,
//          as the plain version gives them.
// Cells of pads and of rows at or past n are never read.
//
// What bounds it: m is read once, the F cells of each valid k-mer (1 byte a
// cell: ~0.19 MB a row at the chr20 slice's n ~ 740, F = 256), the flags
// once, and the labels are written once (8 bytes a k-mer); the parents stay
// in shared memory (4 (K + F) + K bytes with the flags, 6 KB at K = 1,024,
// F = 256), so a link costs shared-memory accesses only.  m is streamed
// past L1 and L2 (ld.global.cs): no cell is read twice.
//
// Shared memory: 4 (K + F) + K bytes (16-byte rounded) of dynamic shared
// memory a block, past 48 KB only after cudaFuncSetAttribute; the wrapper
// (kernels/friend_components.py) refuses K + F whose parents exceed an H100
// block's 227 KB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 2;  // loads a lane keeps in flight

// The root of x, halving the path on the way.
__device__ __forceinline__ int find(volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int g = parent[p];
    if (g == p) return p;
    parent[x] = g;  // x skips p
    x = g;
    p = parent[x];
  }
  return x;
}

// Join the component of k, whose root was rk (an ancestor of k), and that
// of l; rk becomes their common root.  1 if this call hooked one root under
// the other.
__device__ __forceinline__ unsigned join(int* parent, int& rk, int l) {
  volatile int* vp = parent;
  int a = find(vp, rk), b = find(vp, l);
  while (a != b) {
    const int hi = a > b ? a : b;
    const int lo = a > b ? b : a;
    const int seen = atomicCAS(parent + hi, hi, lo);
    if (seen == hi) {
      rk = lo;
      return 1;
    }
    const int r = find(vp, seen);  // hi was hooked meanwhile
    if (a == hi) a = r; else b = r;
  }
  rk = a;
  return 0;
}

// The four cells of a word, bytes of 0 or 1 (a bool tensor's), as four
// bits, the lowest byte's first: the products of the four bytes' low bits
// land in bits 24-27 and nothing else reaches them.
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

template <int kW> struct Cells;
template <> struct Cells<16> {
  uint4 v;
  __device__ __forceinline__ void load(const unsigned char* row, int c) {
    v = __ldcs(reinterpret_cast<const uint4*>(row) + c);
  }
  // the set cells, a bit each
  __device__ __forceinline__ unsigned bits() const {
    return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
           nibble(v.w) << 12;
  }
};
template <> struct Cells<1> {
  unsigned char v;
  __device__ __forceinline__ void load(const unsigned char* row, int c) {
    v = __ldcs(row + c);
  }
  __device__ __forceinline__ unsigned bits() const { return v != 0; }
};

// kW: cells a load (16: 16-byte loads, F % 16 == 0 and m 16-byte aligned).
template <int kW>
__global__ void __launch_bounds__(kMaxThreads)
row_components(const unsigned char* __restrict__ m,
               const unsigned char* __restrict__ valid, int K, int F,
               int lg, long long* __restrict__ labels,
               unsigned long long* __restrict__ hooks) {
  extern __shared__ int smem[];
  int* parent = smem;
  unsigned char* ok = reinterpret_cast<unsigned char*>(smem + K + F);
  __shared__ int row_end;
  __shared__ unsigned block_links;
  const long long b = blockIdx.x;
  const unsigned char* vb = valid + b * K;
  if (threadIdx.x == 0) {
    row_end = 0;
    block_links = 0;
  }
  __syncthreads();
  int end = 0;
  for (int i = threadIdx.x; i < K + F; i += blockDim.x) {
    parent[i] = i;
    if (i < K) {
      const unsigned char v = vb[i];
      ok[i] = v;
      if (v) end = i + 1;
    }
  }
  end = __reduce_max_sync(0xffffffffu, end);
  if ((threadIdx.x & 31) == 0 && end) atomicMax(&row_end, end);
  __syncthreads();

  const int n = row_end;
  const int lane = threadIdx.x & 31;
  const int G = 1 << lg;     // lanes a k-mer row
  const int g = lane & (G - 1);
  const int rows = 32 >> lg;  // k-mer rows a warp takes at a time
  const int step = (blockDim.x >> 5) * rows;
  const int c1 = F / kW;  // chunks of kW cells covering [0, F)
  const unsigned char* mb = m + b * K * (long long)F;
  unsigned links = 0;
  volatile int* vp = parent;
  // every lane of a warp runs the same trips (the shuffles take them all)
  for (int k0 = (threadIdx.x >> 5) * rows; k0 < n; k0 += step) {
    const int k = k0 + (lane >> lg);
    const bool on = k < n && ok[k];  // uniform over k's group
    const unsigned char* row = mb + (long long)k * F;
    int rk = on ? find(parent, k) : k;  // an ancestor of k: its root when
                                        // last seen
    // the group's lanes take chunks base + g + G u, u < kUnroll
    for (int base = 0; base < c1; base += G * kUnroll) {
      const int c = base + g;
      Cells<kW> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (on && c + G * u < c1) x[u].load(row, c + G * u);
      unsigned long long set = 0;  // the lane's set cells, a bit each
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (on && c + G * u < c1)
          set |= (unsigned long long)x[u].bits() << (u * kW);
      while (set) {
        const int i = __ffsll((long long)set) - 1;
        set &= set - 1;
        const int l = K + (c + G * (i / kW)) * kW + i % kW;
        if (vp[l] != rk) {  // else l hangs right under k's root already
          links += join(parent, rk, l);
          vp[l] = rk;  // l hangs right under the common root from now on
        }
      }
      // the group's roots are ancestors of k: the smallest is the newest
      for (int o = G >> 1; o; o >>= 1)
        rk = min(rk, __shfl_xor_sync(0xffffffffu, rk, o));
    }
  }
  links = __reduce_add_sync(0xffffffffu, links);
  if (lane == 0 && links) atomicAdd(&block_links, links);
  __syncthreads();
  if (threadIdx.x == 0 && block_links) atomicAdd(hooks, block_links);

  long long* lb = labels + b * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    lb[k] = ok[k] ? (long long)find(parent, k) : (long long)K;
}

// Dynamic shared memory of one block at K k-mers and F friends: the int32
// parents and the byte flags, 16-byte rounded (friend_components.smem_bytes
// in the wrapper).
long long smem_bytes(long long K, long long F) {
  return (4 * (K + F) + K + 15) / 16 * 16;
}

}  // namespace

// Labels (B, K) int64 of the B rows of the membership mask m (B, K, F) bool,
// contiguous, and valid (B, K) bool: each valid k-mer's component minimum
// under the links of m's set cells between valid k-mers and friends, K for
// a pad.  hooks: one uint64, zeroed on the stream, then the links made.
// Zeroes the counter and launches one block a row on `stream`, with no host
// sync; returns the first CUDA error that is not 0 (0 = launched).
extern "C" int h10x_friend_components(const void* m, const void* valid,
                                      long long B, int K, int F,
                                      void* labels, void* hooks,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(hooks, 0, sizeof(unsigned long long), st);
  if (e != cudaSuccess || B <= 0 || K <= 0) return (int)e;
  const bool vec = F % 16 == 0 && (uintptr_t)m % 16 == 0;
  auto kernel = vec ? row_components<16> : row_components<1>;
  // lanes a k-mer row: its chunks' count rounded up to a power of two, <= 32
  const int c1 = vec ? F / 16 : F;
  int lg = 0;
  while (lg < 5 && (1 << lg) < c1) ++lg;
  const long long smem = smem_bytes(K, F);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a warp a k-mer row, up to kMaxThreads
  int threads = K < kMaxThreads ? K : kMaxThreads;
  threads = threads < 64 ? 64 : (threads + 31) / 32 * 32;
  kernel<<<(unsigned)B, threads, (size_t)smem, st>>>(
      (const unsigned char*)m, (const unsigned char*)valid, K, F, lg,
      (long long*)labels, (unsigned long long*)hooks);
  return (int)cudaGetLastError();
}
