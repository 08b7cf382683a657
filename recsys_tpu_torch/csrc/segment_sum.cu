// Sorted segment sum for Hopper (sm_90a): the dense gradient of a row
// gather,
//
//     out[v, :] = sum_{i : ids[i] = v} g[i, :]        out is [V, W] float32
//
// given the ids sorted ascending (sid, a stable sort) and the permutation
// that sorts them (order: sid[i] = ids[order[i]]).
//
// Replaces the TPU kernels recsys_tpu/ops/pallas_kernels.py
// sorted_segment_scatter_T (K1, the W-major [W, V_pad] output of
// embedding_grad_T) and sorted_segment_scatter (K2, the row-major
// [V_pad, W] output of embedding_grad). Both computed this sum as tiled
// one-hot matmuls on the MXU, because the TPU's scatter emitter handles
// duplicate row updates serially. The port's tables are row-major, so one
// row-major kernel serves both contracts and no one-hot is ever formed.
//
// What bounds it on the H100: memory latency. The work is one add per
// gradient element (N*W adds: 229,376 x 17 for the big Criteo table at batch
// 16384), far below the card's arithmetic; the gradient rows are read in
// sorted order, i.e. at random addresses, 68 bytes each. So the design
// keeps many independent row reads in flight and touches each gradient
// element once.
//
// Design (simple and right first):
//   - the gradients are read through the sort permutation (g[order[i]])
//     instead of from a sorted copy: a copy would make the same random
//     reads, then write and read the rows once more, in one more launch;
//   - the sorted stream is cut into chunks of CHUNK entries, one warp per
//     chunk, lane j on column j (a second grid dimension walks column tiles
//     of 32 when W > 32). A warp reads its chunk's ids and permutation
//     coalesced and hands them out with shuffles, and sums each run of equal
//     ids ("piece") in sorted order;
//   - a piece that is a whole segment (it starts and ends in the chunk) is
//     written to its output row directly. Segment lengths run from 1 to
//     thousands (a vocab-3 field puts about B/3 updates on one row, a
//     skewed id up to B), so a long segment is never summed by one thread:
//     every chunk also writes the sums of its first and last pieces
//     (head, tail), and a second kernel gives each segment that crosses a
//     chunk boundary to the chunk it starts in, which adds its tail to the
//     heads of the following chunks in order;
//   - every output row has exactly one writer and there are no float
//     atomics, so two calls give bitwise-equal results. Rows no id touches
//     are zeroed by the caller (the optimizer is dense over the table).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libsegment_sum.so segment_sum.cu
// C entry point segment_sum_sorted returns the cudaError_t of the launches.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;           // sorted entries per warp
constexpr int WARPS = 8;             // warps (chunks) per block
constexpr int PER_LANE = CHUNK / 32; // ids each lane loads

// One warp per chunk: whole segments go to `out`; the first and last piece
// of every chunk go to head / tail ([n_chunks, w]).
__global__ void __launch_bounds__(WARPS * 32)
segment_chunks(const long long* __restrict__ sid,
               const long long* __restrict__ order,
               const float* __restrict__ g, float* __restrict__ out,
               float* __restrict__ head, float* __restrict__ tail,
               long long n, int w, long long num_rows, int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int col = blockIdx.y * 32 + lane;
  const bool live = col < w;
  const long long lo = static_cast<long long>(c) * CHUNK;
  const int len = static_cast<int>(min(static_cast<long long>(CHUNK), n - lo));

  long long my_sid[PER_LANE], my_ord[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int i = k * 32 + lane;
    my_sid[k] = i < len ? sid[lo + i] : -1;
    my_ord[k] = i < len ? order[lo + i] : 0;
  }
  // does the first piece continue a segment of the previous chunk, and the
  // last piece one of the next?
  const bool first_cont = c > 0 && sid[lo - 1] == sid[lo];
  const bool last_cont = lo + len < n && sid[lo + len] == sid[lo + len - 1];

  float acc = 0.0f;
  bool first_piece = true;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int i = k * 32 + j;
      if (i >= len) break;  // warp-uniform
      const long long row = __shfl_sync(0xffffffffu, my_sid[k], j);
      const long long src = __shfl_sync(0xffffffffu, my_ord[k], j);
      // the next entry's id: the next lane's, or the next register's first
      long long next;
      if (j < 31) {
        next = __shfl_sync(0xffffffffu, my_sid[k], j + 1);
      } else {
        next = k + 1 < PER_LANE ? __shfl_sync(0xffffffffu, my_sid[k + 1], 0)
                                : -1;
      }
      if (live) acc += g[src * w + col];
      const bool last = i == len - 1;
      if (last || next != row) {  // the piece ends here (warp-uniform)
        if (live) {
          if (first_piece) head[static_cast<long long>(c) * w + col] = acc;
          if (last) tail[static_cast<long long>(c) * w + col] = acc;
          const bool starts_here = !(first_piece && first_cont);
          const bool ends_here = !(last && last_cont);
          if (starts_here && ends_here && row >= 0 && row < num_rows)
            out[row * w + col] = acc;
        }
        acc = 0.0f;
        first_piece = false;
      }
    }
  }
}

// One warp per chunk whose last piece starts a segment that runs on past
// the chunk: that segment's sum is its tail plus the heads of the chunks it
// covers, added in chunk order.
__global__ void __launch_bounds__(WARPS * 32)
segment_carry(const long long* __restrict__ sid,
              const float* __restrict__ head, const float* __restrict__ tail,
              float* __restrict__ out, long long n, int w, long long num_rows,
              int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= n_chunks - 1) return;  // the last chunk's segments end in it
  const long long lo = static_cast<long long>(c) * CHUNK;
  const long long hi = lo + CHUNK;  // not the last chunk: a full one
  const long long row = sid[hi - 1];
  if (sid[hi] != row) return;  // the last piece ends in this chunk
  // the last piece starts here unless the whole chunk is one piece that
  // continues a segment of the previous chunk
  if (sid[lo] == row && c > 0 && sid[lo - 1] == row) return;
  const int col = blockIdx.y * 32 + lane;
  if (col >= w || row < 0 || row >= num_rows) return;
  float acc = tail[static_cast<long long>(c) * w + col];
  for (int k = c + 1; k < n_chunks && sid[static_cast<long long>(k) * CHUNK] == row;
       ++k)
    acc += head[static_cast<long long>(k) * w + col];
  out[row * w + col] = acc;
}

}  // namespace

// sid, order: [n] int64; g: [n_g, w] float32 rows indexed by order;
// out: [num_rows, w] float32, zero on entry; head, tail: [ceil(n/128), w]
// float32 scratch. Launches on `stream`, does not synchronise.
extern "C" int segment_sum_sorted(const void* sid_p, const void* order_p,
                                  const void* g_p, void* out_p, void* head_p,
                                  void* tail_p, long long n, int w,
                                  long long num_rows, void* stream) {
  if (n <= 0 || w <= 0 || num_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  if (chunks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = static_cast<int>(chunks);
  const auto* sid = static_cast<const long long*>(sid_p);
  const auto* order = static_cast<const long long*>(order_p);
  const auto* g = static_cast<const float*>(g_p);
  auto* out = static_cast<float*>(out_p);
  auto* head = static_cast<float*>(head_p);
  auto* tail = static_cast<float*>(tail_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_chunks + WARPS - 1) / WARPS, (w + 31) / 32);
  segment_chunks<<<grid, WARPS * 32, 0, s>>>(sid, order, g, out, head, tail,
                                             n, w, num_rows, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks > 1) {
    segment_carry<<<grid, WARPS * 32, 0, s>>>(sid, head, tail, out, n, w,
                                              num_rows, n_chunks);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
