// Row gather for Hopper (sm_90a): the forward of an embedding-table read,
//
//     out[i, :] = table[ids[i], :]      table [V, W] float32, ids [N] int64
//
// Replaces the TPU kernel scratch/rowdma_kernel.py rowdma_gather (S1), the
// primitive behind the embedding forward gather. The Pallas kernel started
// one DMA per row from HBM into a VMEM output block, 16 in flight, because
// the TPU's vector units cannot address HBM row by row. Every H100 thread can load
// from device memory, so here the gather is a plain load/store kernel.
//
// What bounds it on the H100: memory latency. There is no arithmetic: each
// output element is one load from a row at a random place in the table and
// one store. A row is contiguous (68 bytes for the Criteo tables, W = 17;
// 128 bytes for DIN's, W = 32), but rows are scattered over a table of up to
// 837,632 rows (57 MB, more than the 50 MB L2). At the main paths' shapes
// (33,792 to 409,600 rows) the bytes moved are 4-28 MB each way, a few
// microseconds at 3.35 TB/s, so what decides the time is the launch and the
// latency of the dependent id -> row loads. The design keeps many row
// loads in flight and touches each byte once.
//
// Design (simple and right first):
//   - a block owns a tile of ROWS consecutive output rows. It loads their
//     ids into shared memory once (coalesced), then its threads walk the
//     tile's ROWS x W output elements in order: the stores of a warp are
//     contiguous whatever W is, and the loads of a warp cover whole rows;
//   - when W is a multiple of 4 and both pointers are 16-byte aligned, an
//     element is a float4 (one 16-byte load and store per thread). A Criteo
//     row of W = 17 is 68 bytes and not 16-byte aligned, so it goes as
//     floats;
//   - element offsets are 64-bit (id x W reaches 14.2M for the big table);
//   - no shared state between blocks: the result does not depend on the
//     launch, and a copy is exact, so it is bitwise equal to
//     torch.index_select.
//
// Ids out of range: an id < 0 or >= V reads nothing, and its output row is
// written as zeros. (The plain version, torch.index_select, raises on such
// an id; the servables reject such ids on the host, before any gather.)
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o librow_gather.so row_gather.cu
// C entry point row_gather returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS = 64;         // output rows per block
constexpr int THREADS = 256;     // threads per block
constexpr int MAX_W = 1 << 20;   // ROWS x W elements index with an int

// T is float (any W) or float4 (W % 4 == 0); wv = W in units of T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const T* __restrict__ table,
                  const long long* __restrict__ ids, T* __restrict__ out,
                  long long n, int wv, long long num_rows) {
  __shared__ long long tile_ids[ROWS];
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS),
                                        n - row0));
  for (int r = threadIdx.x; r < rows; r += THREADS)
    tile_ids[r] = ids[row0 + r];
  __syncthreads();
  const int elems = rows * wv;
  T* dst = out + row0 * wv;
#pragma unroll 4
  for (int e = threadIdx.x; e < elems; e += THREADS) {
    const int r = e / wv;
    const int c = e - r * wv;
    const long long id = tile_ids[r];
    T val{};                                  // zeros for an id out of range
    if (id >= 0 && id < num_rows) val = __ldg(table + id * wv + c);
    dst[e] = val;
  }
}

}  // namespace

// table: [num_rows, w] float32, contiguous; ids: [n] int64; out: [n, w]
// float32, contiguous. Launches on `stream`, does not synchronise.
extern "C" int row_gather(const void* table_p, const void* ids_p, void* out_p,
                          long long n, int w, long long num_rows,
                          void* stream) {
  if (n <= 0 || w <= 0 || w > MAX_W || num_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + ROWS - 1) / ROWS;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ids = static_cast<const long long*>(ids_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(table_p) |
                         reinterpret_cast<std::uintptr_t>(out_p)) & 15) == 0;
  if (w % 4 == 0 && aligned) {
    row_gather_kernel<float4><<<static_cast<unsigned>(blocks), THREADS, 0,
                                s>>>(
        static_cast<const float4*>(table_p), ids, static_cast<float4*>(out_p),
        n, w / 4, num_rows);
  } else {
    row_gather_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0,
                               s>>>(
        static_cast<const float*>(table_p), ids, static_cast<float*>(out_p),
        n, w, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
