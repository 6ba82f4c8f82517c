// Connected components of friend clustering's bipartite (position, friend)
// graph by concurrent union-find, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes the same labels with
// rounds of jax.ops.segment_min and pointer jumping (_propagate in
// hash10x_tpu/cluster/sparse.py), and the port's plain version is those
// rounds in torch (scatter_reduce_(amin); cluster/sparse.py _round): each
// round streams every edge twice and makes two 64-bit atomics and two
// random gathers an edge, and the rounds repeat until no label moves.  The
// fixpoint needs no rounds: it is each position's connected-component
// minimum, which one union-find sweep over the edge list gives (after
// ECL-CC, Jaiganesh & Burtscher, HPDC 2018, and Afforest's hooking, Sutton
// et al., IPDPS 2018).
//
// Nodes: position p is node p, friend rank f is node n_p + f.  parent[]
// starts as the identity and keeps parent[x] <= x throughout:
//   init      parent[x] = x; the link counter is zeroed.
//   hook      a grid-stride sweep over the edges (p_e, f_e int64, as
//             cluster/sparse.py _edges gives them), one launch per block of
//             edges (the sharded path's per-shard blocks, all hooked into
//             the one parent array: the result does not depend on order),
//             two edges a thread with 16-byte loads where both of the
//             block's vectors are 16-byte aligned.  Both ends' parents are
//             loaded together; equal parents mean one component and end
//             the edge.  Otherwise each end climbs to its
//             root with path halving (plain stores: a store only ever points
//             a non-root at one of its ancestors, so a store that loses a
//             race still leaves a valid path), and the larger root is hooked
//             under the smaller with atomicCAS(parent[hi], hi, lo).  A CAS
//             that fails means hi was hooked meanwhile: climb again from
//             what it now points at and retry.  Every root is therefore the
//             smallest node of its tree, and positions come before friend
//             nodes, so at the end each root is its component's smallest
//             position, whatever order the atomics land in.  Successful
//             hooks are summed per thread block and added to one counter.
//   finalise  labels[p] = root of p as int64, for p < n_p.
// An edge whose position or friend rank is out of range stops the kernel
// with a trap, as torch's own index kernels assert.
//
// Index width: parents are int32 when n_p + n_f < 2^31 (more nodes per
// 32-byte sector), else int64; the same kernels are instantiated for both.
//
// What bounds it: the edges are streamed once, 16 bytes an edge (1.92G
// edges of the chr20 slice: 30.7 GB, 9.2 ms at 3.35 TB/s); the labels are
// written once.  Beyond that each edge costs random 32-byte parent sectors:
// two first loads, issued together, and on edges whose ends do not yet
// share a parent the climbs to the roots and the CAS.  The parent vector
// (0.35 GB at the slice) is far larger than L2, so those sectors come from
// device memory; path halving keeps the climbs at a step or two, so most
// edges of a formed component end after their two first loads.  Parents
// are read and written at L2 (ld.cg / st.cg): a random sector gains nothing
// from L1, and the hooking threads of other SMs write them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int cas(int* a, int expect, int value) {
  return atomicCAS(a, expect, value);
}

__device__ __forceinline__ long long cas(long long* a, long long expect,
                                         long long value) {
  return (long long)atomicCAS((unsigned long long*)a,
                              (unsigned long long)expect,
                              (unsigned long long)value);
}

// The root of x, given p = a parent of x read earlier (an ancestor of x),
// halving the path on the way.
template <typename T>
__device__ __forceinline__ T climb(T* parent, T x, T p) {
  while (p != x) {
    const T g = __ldcg(parent + p);
    if (g == p) return p;
    __stcg(parent + x, g);  // x skips p
    x = g;
    p = __ldcg(parent + x);
  }
  return x;
}

// Join the components of u and v, whose parents read earlier are a != b;
// 1 if this call hooked one root under the other.
template <typename T>
__device__ __forceinline__ unsigned join(T* parent, T u, T a, T v, T b) {
  a = climb(parent, u, a);
  b = climb(parent, v, b);
  while (a != b) {
    const T hi = a > b ? a : b;
    const T lo = a > b ? b : a;
    const T seen = cas(parent + hi, hi, lo);
    if (seen == hi) return 1;
    const T r = climb(parent, hi, seen);  // hi was hooked meanwhile
    if (a == hi) a = r; else b = r;
  }
  return 0;
}

__device__ __forceinline__ void check(long long p, long long f,
                                      long long n_p, long long n_f) {
  if ((unsigned long long)p >= (unsigned long long)n_p ||
      (unsigned long long)f >= (unsigned long long)n_f)
    __trap();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
init_parents(T* parent, long long n, unsigned long long* hooks) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    parent[i] = (T)i;
  if (blockIdx.x == 0 && threadIdx.x == 0) *hooks = 0;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
hook_edges(const long long* __restrict__ pe, const long long* __restrict__ fe,
           long long E, long long n_p, long long n_f, T* parent,
           unsigned long long* hooks) {
  __shared__ unsigned long long block_links;
  if (threadIdx.x == 0) block_links = 0;
  __syncthreads();
  unsigned links = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    const longlong2* pe2 = reinterpret_cast<const longlong2*>(pe);
    const longlong2* fe2 = reinterpret_cast<const longlong2*>(fe);
    for (long long i = t; i < E / 2; i += stride) {
      const longlong2 p = __ldcs(pe2 + i);
      const longlong2 f = __ldcs(fe2 + i);
      check(p.x, f.x, n_p, n_f);
      check(p.y, f.y, n_p, n_f);
      const T u0 = (T)p.x, v0 = (T)(n_p + f.x);
      const T u1 = (T)p.y, v1 = (T)(n_p + f.y);
      const T a0 = __ldcg(parent + u0), b0 = __ldcg(parent + v0);
      const T a1 = __ldcg(parent + u1), b1 = __ldcg(parent + v1);
      if (a0 != b0) links += join(parent, u0, a0, v0, b0);
      if (a1 != b1) links += join(parent, u1, a1, v1, b1);
    }
  }
  for (long long i = kVec ? (E & ~1LL) + t : t; i < E; i += stride) {
    const long long p = pe[i], f = fe[i];
    check(p, f, n_p, n_f);
    const T u = (T)p, v = (T)(n_p + f);
    const T a = __ldcg(parent + u), b = __ldcg(parent + v);
    if (a != b) links += join(parent, u, a, v, b);
  }
  links = __reduce_add_sync(0xffffffffu, links);
  if ((threadIdx.x & 31) == 0) atomicAdd(&block_links, links);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(hooks, block_links);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
root_labels(T* parent, long long n_p, long long* labels) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_p; i += stride)
    labels[i] = (long long)climb(parent, (T)i, __ldcg(parent + i));
}

// Blocks for a grid-stride sweep over n items: enough to fill the card,
// no more than the items need.
template <typename K>
int grid_for(K kernel, long long n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(need < most ? (need > 0 ? need : 1) : most);
  return 0;
}

template <typename T>
int run(const long long* const* pe, const long long* const* fe,
        const long long* E, int n_blocks, long long n_p, long long n_f,
        T* parent, long long* labels, unsigned long long* hooks,
        cudaStream_t st) {
  int blocks = 0, rc = grid_for(init_parents<T>, n_p + n_f, &blocks);
  if (rc != 0) return rc;
  init_parents<T><<<blocks, kThreads, 0, st>>>(parent, n_p + n_f, hooks);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  for (int b = 0; b < n_blocks; ++b) {
    if (E[b] <= 0) continue;
    const bool vec =
        ((uintptr_t)pe[b] % 16 == 0) && ((uintptr_t)fe[b] % 16 == 0);
    auto hook = vec ? hook_edges<T, true> : hook_edges<T, false>;
    if ((rc = grid_for(hook, vec ? E[b] / 2 + 1 : E[b], &blocks)) != 0)
      return rc;
    hook<<<blocks, kThreads, 0, st>>>(pe[b], fe[b], E[b], n_p, n_f, parent,
                                      hooks);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  }
  if ((rc = grid_for(root_labels<T>, n_p, &blocks)) != 0) return rc;
  root_labels<T><<<blocks, kThreads, 0, st>>>(parent, n_p, labels);
  return (int)cudaGetLastError();
}

}  // namespace

// Labels of the n_p positions (each its component's smallest position) from
// the edges of n_blocks blocks, block b holding the E[b] edges
// (p_e[b][i], f_e[b][i]); the host arrays p_e, f_e and E are read before
// the call returns.  Launches init once, hook once per block that holds
// edges (each block takes the 16-byte loads where both its vectors are
// aligned) and finalise once, all on `stream` with no host sync between
// them, and returns the first cudaGetLastError() that is not 0 (0 =
// launched).  parent: n_p + n_f entries of int32 (wide == 0) or int64
// scratch; labels: n_p int64; hooks: one uint64, the successful links of
// every block.
extern "C" int h10x_union_find(const void* const* p_e, const void* const* f_e,
                               const long long* E, int n_blocks,
                               long long n_p, long long n_f, int wide,
                               void* parent, void* labels, void* hooks,
                               void* stream) {
  if (n_p <= 0) return 0;
  const long long* const* pe = (const long long* const*)p_e;
  const long long* const* fe = (const long long* const*)f_e;
  long long* lab = (long long*)labels;
  unsigned long long* h = (unsigned long long*)hooks;
  cudaStream_t st = (cudaStream_t)stream;
  return wide ? run(pe, fe, E, n_blocks, n_p, n_f, (long long*)parent, lab,
                    h, st)
              : run(pe, fe, E, n_blocks, n_p, n_f, (int*)parent, lab, h, st);
}
