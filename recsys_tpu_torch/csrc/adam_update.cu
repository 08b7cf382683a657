// Adam's update for Hopper (sm_90a): one pass over every leaf of a
// parameter tree, in place, as recsys_tpu_torch/train/optim.py `adam`
// states it (TF-parity: ε outside the bias correction):
//
//     m ← b1·m + (1−b1)·g
//     v ← b2·v + (1−b2)·g²
//     p ← p − lr_t·m / (√v + ε)
//     p ← p − lr·wd·p_old          only with weight decay; p_old is p as read
//
// It replaces no TPU kernel: the JAX package's Adam is elementwise code
// that XLA fuses. The port ran it as about nine eager PyTorch kernels per
// leaf (mul_, add_, mul_, addcmul_, sqrt, +ε, lr_t·m, /, sub_), which move
// about 88 bytes per parameter and ran at about 19% of the pass's bound
// inside the graphed Criteo step (0.62 ms a step for 14.38M parameters).
//
// What bounds it on the H100: bytes. Each parameter needs p, g, m and v
// read and p, m and v written, 28 bytes, against 10 float32 operations, so
// the update is far below the card's operations-per-byte line: 14.38M
// parameters move 402.6 MB, 0.120 ms at 3.35 TB/s. The design touches each
// of those bytes once and keeps enough of them in flight to fill the bus:
//   - one launch covers up to MAX_LEAVES leaves. Their pointers, sizes and
//     first blocks travel by value in the kernel's parameters
//     (__grid_constant__, read in place), so there is no device table and
//     nothing that has to outlive a CUDA-graph capture; a tree with more
//     leaves takes further launches;
//   - a block owns CHUNK consecutive elements of one leaf and finds its leaf
//     by a binary search over the first blocks;
//   - a full chunk of a leaf whose four pointers are 16-byte aligned is read
//     as float4s: each thread issues U loads of each of p, g, m and v, all
//     16·U in flight before its first store, neighbouring threads on
//     neighbouring addresses. A leaf's ragged last chunk, and every chunk
//     of a leaf that is not aligned, takes the scalar path;
//   - lr_t (and lr·wd) are read from device scalars that the caller
//     computes on the card from Adam's step count, so each replay of a
//     captured step reads its own step's values;
//   - no atomics, no scratch, no order between blocks: each element is
//     computed by one thread from its own inputs, so the result does not
//     depend on the launch and a graphed step stays bitwise equal to an
//     eager one.
// Each operation is one IEEE float32 operation rounded to nearest, in the
// plain version's order (the __f*_rn intrinsics keep nvcc from contracting
// them): the two fused multiply-adds are those PyTorch's add_(alpha=) and
// addcmul_(value=) kernels compute on the card, so the kernel is bitwise
// equal to the plain version there.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libadam_update.so adam_update.cu
// C entry point adam_update returns the cudaError_t of its launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_LEAVES = 64;   // leaves per launch (a 64-bit vector mask)
constexpr int THREADS = 256;     // threads per block
constexpr int U = 4;             // float4s of each tensor per thread
constexpr long long CHUNK = 4LL * U * THREADS;   // elements per block

struct Leaves {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int first_block[MAX_LEAVES];     // strictly increasing: no empty leaf
  unsigned long long vec_mask;     // bit i: leaf i's pointers 16-B aligned
  int count;
};

struct Coefs {
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float lr_t, float lr_wd,
                                         bool decay, const Coefs& c) {
  m = __fmaf_rn(c.one_minus_b1, g, __fmul_rn(c.b1, m));
  v = __fmaf_rn(c.one_minus_b2, __fmul_rn(g, g), __fmul_rn(c.b2, v));
  const float u = __fdiv_rn(__fmul_rn(lr_t, m),
                            __fadd_rn(__fsqrt_rn(v), c.eps));
  const float p_new = __fsub_rn(p, u);
  p = decay ? __fsub_rn(p_new, __fmul_rn(lr_wd, p)) : p_new;
}

__device__ __forceinline__ void adam_four(float4& p, const float4& g,
                                          float4& m, float4& v, float lr_t,
                                          float lr_wd, bool decay,
                                          const Coefs& c) {
  adam_one(p.x, g.x, m.x, v.x, lr_t, lr_wd, decay, c);
  adam_one(p.y, g.y, m.y, v.y, lr_t, lr_wd, decay, c);
  adam_one(p.z, g.z, m.z, v.z, lr_t, lr_wd, decay, c);
  adam_one(p.w, g.w, m.w, v.w, lr_t, lr_wd, decay, c);
}

__global__ void __launch_bounds__(THREADS)
adam_update_kernel(const __grid_constant__ Leaves L,
                   const float* __restrict__ lr_t_ptr,
                   const float* __restrict__ lr_wd_ptr, const Coefs c) {
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = L.count - 1;    // the last leaf whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int leaf = lo;
  const float lr_t = *lr_t_ptr;
  const bool decay = lr_wd_ptr != nullptr;
  const float lr_wd = decay ? *lr_wd_ptr : 0.0f;
  float* __restrict__ p = L.p[leaf];
  const float* __restrict__ g = L.g[leaf];
  float* __restrict__ m = L.m[leaf];
  float* __restrict__ v = L.v[leaf];
  const long long n = L.n[leaf];
  const long long start =
      static_cast<long long>(b - L.first_block[leaf]) * CHUNK;

  if (((L.vec_mask >> leaf) & 1ULL) && start + CHUNK <= n) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const long long q0 = start / 4 + threadIdx.x;
    float4 P[U], G[U], M[U], V[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long q = q0 + k * THREADS;
      P[k] = p4[q];
      G[k] = g4[q];
      M[k] = m4[q];
      V[k] = v4[q];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long q = q0 + k * THREADS;
      adam_four(P[k], G[k], M[k], V[k], lr_t, lr_wd, decay, c);
      p4[q] = P[k];
      m4[q] = M[k];
      v4[q] = V[k];
    }
    return;
  }
  const long long end = start + CHUNK < n ? start + CHUNK : n;
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_one(pi, g[i], mi, vi, lr_t, lr_wd, decay, c);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" {

// One Adam step over `n_leaves` leaves, in place: leaf i is `sizes[i]`
// contiguous float32 elements at p[i], g[i], m[i], v[i] (device addresses
// as integers). lr_t and lr_wd are device float32 scalars; lr_wd is null
// without weight decay. Empty leaves are skipped; the others go
// MAX_LEAVES to a launch, in order, on `stream`. Does not synchronise.
int adam_update(int n_leaves, const long long* p, const long long* g,
                const long long* m, const long long* v,
                const long long* sizes, const float* lr_t,
                const float* lr_wd, float b1, float one_minus_b1, float b2,
                float one_minus_b2, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Coefs c{b1, one_minus_b1, b2, one_minus_b2, eps};
  Leaves L{};
  long long blocks = 0;
  for (int i = 0; i <= n_leaves; ++i) {
    if (i < n_leaves && sizes[i] > 0) {
      const int k = L.count++;
      L.p[k] = reinterpret_cast<float*>(p[i]);
      L.g[k] = reinterpret_cast<const float*>(g[i]);
      L.m[k] = reinterpret_cast<float*>(m[i]);
      L.v[k] = reinterpret_cast<float*>(v[i]);
      L.n[k] = sizes[i];
      L.first_block[k] = static_cast<int>(blocks);
      if (aligned16(L.p[k]) && aligned16(L.g[k]) && aligned16(L.m[k]) &&
          aligned16(L.v[k])) {
        L.vec_mask |= 1ULL << k;
      }
      blocks += (sizes[i] + CHUNK - 1) / CHUNK;
      if (blocks > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    if (L.count > 0 && (L.count == MAX_LEAVES || i == n_leaves)) {
      adam_update_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
          L, lr_t, lr_wd, c);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      L = Leaves{};
      blocks = 0;
    }
  }
  return static_cast<int>(cudaSuccess);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
