// Row-wise Adagrad for Hopper (sm_90a): the update of an embedding table
// from its sparse gradient (recsys_tpu_torch/ops/segment_sum.py
// `segment_sum_sparse`), in place, one accumulator per row:
//
//     for each touched row r, g its summed gradient [W]:
//         a_r ← a_r + mean(g²)
//         w_r ← w_r − lr·g / (√a_r + ε)
//
// It replaces no TPU kernel: the JAX package trains every table with dense
// Adam. It was added for DLRM-DCNv2 (recsys_tpu_torch/models/dlrm.py),
// whose tables hold 26.5M rows of 128 columns on one card: a dense update
// would read and write all 13.6 GB of them a step. A row that no id
// touches has a zero gradient, and row-wise Adagrad leaves such a row and
// its accumulator exactly as they were (a + 0 = a, w − 0 = w), so updating
// only the touched rows is the dense update, row for row.
//
// What bounds it on the H100: bytes. Each touched row needs its id (8 B),
// its gradient row, its table row read and written (4·W bytes each) and its
// accumulator read and written (4 + 4 B): about 1.5 KB a row at W = 128,
// against 3·W + 4 float32 operations. The design:
//   - one warp a row: the id and the accumulator are read once, by all
//     lanes, and lane j takes columns j, j + 32, ...; each pass of the warp
//     reads 128 contiguous bytes of the gradient and of the table row;
//   - the sum of squares is each lane's columns in order, then a butterfly
//     of shuffles in a fixed order, so every lane holds the same sum and
//     the result does not depend on the launch;
//   - the count of touched rows is read on the card: the grid covers every
//     place the gradient's buffers have (N, the ids of the step), and the
//     warps past the count return at once. Nothing is read back to the
//     host, so a step captures into one CUDA graph;
//   - ids outside [0, num_rows) (the sentinel of the places past the
//     count) are skipped;
//   - no atomics: the touched rows are distinct, each is one warp's.
// Each operation is one IEEE float32 operation rounded to nearest, in the
// plain version's order (`rowwise_adagrad_reference`): mean = Σg² / W,
// a + mean, √a + ε, (lr·g) / d, w − u. Only Σg² differs from PyTorch's:
// its terms are added in another order, each square fused into its add.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o librowwise_adagrad.so
//             rowwise_adagrad.cu
// C entry point rowwise_adagrad returns the cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // rows per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
rowwise_adagrad_kernel(float* __restrict__ table, float* __restrict__ acc,
                       const long long* __restrict__ ids,
                       const float* __restrict__ rows,
                       const long long* __restrict__ count, long long n,
                       int w, long long num_rows, float lr, float eps) {
  const long long r = static_cast<long long>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n || r >= *count) return;
  const long long id = ids[r];
  if (id < 0 || id >= num_rows) return;
  const float* __restrict__ g = rows + r * w;
  float* __restrict__ row = table + id * w;
  float s = 0.0f;
  for (int c = lane; c < w; c += 32) s = __fmaf_rn(g[c], g[c], s);
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, d));
  const float a = __fadd_rn(acc[id], __fdiv_rn(s, static_cast<float>(w)));
  const float den = __fadd_rn(__fsqrt_rn(a), eps);
  for (int c = lane; c < w; c += 32)
    row[c] = __fsub_rn(row[c], __fdiv_rn(__fmul_rn(lr, g[c]), den));
  if (lane == 0) acc[id] = a;
}

}  // namespace

extern "C" {

// One row-wise Adagrad step, in place: table [num_rows, w] and acc
// [num_rows] float32; ids [n] int64 and rows [n, w] float32 the sparse
// gradient, of which the first *count places (count: one int64 on the
// card) are read. Launches on `stream`; does not synchronise.
int rowwise_adagrad(void* table, void* acc, const void* ids,
                    const void* rows, const void* count, long long n, int w,
                    long long num_rows, float lr, float eps, void* stream) {
  if (n < 0 || w <= 0 || num_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rowwise_adagrad_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(acc),
      static_cast<const long long*>(ids), static_cast<const float*>(rows),
      static_cast<const long long*>(count), n, w, num_rows, lr, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
