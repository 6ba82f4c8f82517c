// Connected components of pair clustering's k-mer graph, one barcode row a
// thread block, in one pass over the row's support matrix, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package links two k-mers of a barcode
// where S - 1 >= min_share and propagates labels in rounds over the dense
// (B, K, K) adjacency (cluster_batch in hash10x_tpu/cluster/cooccur.py), and
// the port's plain version is those rounds in torch (cluster/cooccur.py
// _pair_rounds): the adjacency is built as (B, K, K) bool tensors, and each
// round writes and reduces a (B, K, K) int64 temporary and reads a value
// back to the host, until no label moves.  The fixpoint is each k-mer's
// component minimum, which one union-find pass over the links gives.
//
// Row b of the batch is one thread block:
//   init   parent[k] = k in shared memory (int32) and the row's valid flags
//          beside it; n = 1 + the last valid k-mer's index.
//   hook   the warps stream the upper triangle of S[b] (k < l < n; S is
//          exactly symmetric: its entries are integer counts summed exactly
//          in float32), one row k a warp at a time, the lanes over the
//          row's columns with 16-byte loads where K is a multiple of 4 and
//          S is 16-byte aligned (else 4-byte loads), four loads a lane in
//          flight.  A cell links k and l where both are valid and
//          S - 1 >= min_share, computed in float32 as the plain version
//          does.  Each lane keeps rk, an ancestor of k (its root when last
//          seen; the warp takes the lanes' smallest after each step), and a
//          link whose far end l hangs right under rk is already inside k's
//          component: most links of a barcode end there, at the cost of
//          one shared-memory read.  Any other link climbs both ends to
//          their roots with path halving (plain stores: a store only ever
//          points a non-root at one of its ancestors), hooks the larger
//          root under the smaller with atomicCAS(parent[hi], hi, lo),
//          retrying from what hi now points at when the CAS finds it hooked
//          meanwhile, and then points l right at the common root.  Every
//          root is thus the smallest index of its tree, whatever order the
//          atomics land in, and at the end each root is its component's
//          smallest k-mer.  Successful hooks are summed per block and added
//          to one counter.
//   label  labels[b][k] = root of k (int64) for a valid k-mer, K for a pad,
//          as the plain version gives them.
// Pads (invalid k-mers) are never read as links; cells at or past n are
// never read.
//
// What bounds it: S is read once, one triangle of each row's n x n valid
// block (4 bytes a cell: ~1.1 MB a row at the chr20 slice's n ~ 740), and
// the labels are written once (8 bytes a k-mer); the parents stay in shared
// memory (5 bytes a k-mer with the flags, 5 KB at K = 1,024), so a link
// costs shared-memory accesses only.  S is streamed past L1 and L2
// (ld.global.cs): no cell is read twice.
//
// Shared memory: 5 K bytes (16-byte rounded) of dynamic shared memory a
// block, past 48 KB only after cudaFuncSetAttribute; the wrapper
// (kernels/pair_components.py) refuses K whose parents exceed an H100
// block's 227 KB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;  // loads a lane keeps in flight

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

template <int kW> struct Cells;
template <> struct Cells<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* row, int c) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(row) + c);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <> struct Cells<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* row, int c) {
    v[0] = __ldcs(row + c);
  }
};

// kW: cells a load (4: 16-byte loads, K % 4 == 0 and S 16-byte aligned).
template <int kW>
__global__ void __launch_bounds__(kMaxThreads)
row_components(const float* __restrict__ s,
               const unsigned char* __restrict__ valid, int K, float thr,
               long long* __restrict__ labels,
               unsigned long long* __restrict__ hooks) {
  extern __shared__ int smem[];
  int* parent = smem;
  unsigned char* ok = reinterpret_cast<unsigned char*>(smem + K);
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
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    parent[k] = k;
    const unsigned char v = vb[k];
    ok[k] = v;
    if (v) end = k + 1;
  }
  end = __reduce_max_sync(0xffffffffu, end);
  if ((threadIdx.x & 31) == 0 && end) atomicMax(&row_end, end);
  __syncthreads();

  const int n = row_end;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const float* sb = s + b * K * (long long)K;
  unsigned links = 0;
  volatile int* vp = parent;
  for (int k = threadIdx.x >> 5; k + 1 < n; k += warps) {
    if (!ok[k]) continue;  // k is the warp's: the branch is uniform
    const float* row = sb + (long long)k * K;
    const int c1 = (n + kW - 1) / kW;  // chunks of kW cells covering [0, n)
    int rk = find(parent, k);  // an ancestor of k: its root when last seen
    // the warp's lanes take chunks base + lane + 32 u, u < kUnroll
    for (int base = (k + 1) / kW; base < c1; base += 32 * kUnroll) {
      const int c = base + lane;
      Cells<kW> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c + 32 * u < c1) x[u].load(row, c + 32 * u);
      // the links whose far end does not hang right under rk, a bit each
      unsigned miss = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          const int l = (c + 32 * u) * kW + j;
          if (c + 32 * u < c1 && l > k && l < n && x[u].v[j] - 1.0f >= thr &&
              ok[l] && vp[l] != rk)
            miss |= 1u << (u * kW + j);
        }
      while (miss) {  // one join site for them
        const int i = __ffs(miss) - 1;
        miss &= miss - 1;
        const int l = (c + 32 * (i / kW)) * kW + i % kW;
        if (vp[l] != rk) {
          links += join(parent, rk, l);
          vp[l] = rk;  // l hangs right under the common root from now on
        }
      }
      // the lanes' roots are ancestors of k: the smallest is the newest
      rk = __reduce_min_sync(0xffffffffu, rk);
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

// Dynamic shared memory of one block at width K: the int32 parents and the
// byte flags, 16-byte rounded (pair_components.smem_bytes in the wrapper).
long long smem_bytes(long long K) { return (5 * K + 15) / 16 * 16; }

}  // namespace

// Labels (B, K) int64 of the B rows of the support matrix s (B, K, K)
// float32, contiguous and symmetric, and valid (B, K) bool: each valid
// k-mer's component minimum under the links S - 1 >= thr between valid
// k-mers, K for a pad.  hooks: one uint64, zeroed on the stream, then the
// links made.  Zeroes the counter and launches one block a row on `stream`,
// with no host sync; returns the first CUDA error that is not 0 (0 =
// launched).
extern "C" int h10x_pair_components(const void* s, const void* valid,
                                    long long B, int K, float thr,
                                    void* labels, void* hooks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(hooks, 0, sizeof(unsigned long long), st);
  if (e != cudaSuccess || B <= 0 || K <= 0) return (int)e;
  const bool vec = K % 4 == 0 && (uintptr_t)s % 16 == 0;
  auto kernel = vec ? row_components<4> : row_components<1>;
  const long long smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a warp a row of the triangle, up to kMaxThreads
  int threads = K < kMaxThreads ? K : kMaxThreads;
  threads = threads < 64 ? 64 : (threads + 31) / 32 * 32;
  kernel<<<(unsigned)B, threads, (size_t)smem, st>>>(
      (const float*)s, (const unsigned char*)valid, K, thr,
      (long long*)labels, (unsigned long long*)hooks);
  return (int)cudaGetLastError();
}
