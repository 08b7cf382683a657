// Reshape probes for Hopper (sm_90a): out = 2 * x over a float32 table,
//
//     via_reshape: flat [VP * W] read as [VP, W]    (replaces S2)
//     via_2d:      x    [VP, W]                     (replaces S3)
//
// Replaces the TPU kernels scratch/mosaic_reshape_test.py via_reshape (S2,
// the pallas_call at :18) and via_2d (S3, :33). Those were probes of the
// TPU compiler: could Mosaic reshape a flat 1-D VMEM block of 512 * 17
// floats into a [512, 17] tile (S2), against the same pass over 2-D blocks
// in the lane-padded layout (S3)? No module of either package calls them.
// On the H100 a row-major [VP, W] array and its flat [VP * W] form are the
// same bytes, so the two entry points launch one kernel: the reshape is
// free, and what is left is the pass itself.
//
// What bounds it on the H100: memory bandwidth. Each element is read once
// and written once with one multiply between: at VP = 837,632 and W = 17
// that is 56.96 MB each way, about 34 us at 3.35 TB/s, and the arrays are
// larger than the 50 MB L2.
//
// Design (simple and right first): a grid-stride loop of float4 loads and
// stores (16 bytes a thread, neighbouring threads on neighbouring
// addresses), then a scalar tail for the last n % 4 elements. When either
// pointer is not 16-byte aligned the whole pass goes as floats. No shared
// memory; the grid is capped at a few waves of blocks and each thread
// walks the rest. The result is exact (2 * x rounds nothing), so it is
// bitwise equal to torch.mul(x, 2.0).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libreshape_probe.so reshape_probe.cu
// C entry points via_reshape and via_2d return the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;   // 16 blocks per SM

__global__ void __launch_bounds__(THREADS)
times_two_vec_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                     long long n4, const float* __restrict__ in_tail,
                     float* __restrict__ out_tail, int tail) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    float4 v = in[i];
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    out[i] = v;
  }
  if (first < tail) out_tail[first] = 2.0f * in_tail[first];
}

__global__ void __launch_bounds__(THREADS)
times_two_kernel(const float* __restrict__ in, float* __restrict__ out,
                 long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = 2.0f * in[i];
}

unsigned grid_for(long long items) {
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return static_cast<unsigned>(blocks);
}

int times_two(const void* in_p, void* out_p, long long rows, int w,
              void* stream) {
  if (rows <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * w;
  const auto* in = static_cast<const float*>(in_p);
  auto* out = static_cast<float*>(out_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(in_p) |
                         reinterpret_cast<std::uintptr_t>(out_p)) & 15) == 0;
  if (aligned) {
    const long long n4 = n / 4;
    const int tail = static_cast<int>(n - 4 * n4);   // 0..3
    times_two_vec_kernel<<<grid_for(n4), THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
        n4, in + 4 * n4, out + 4 * n4, tail);
  } else {
    times_two_kernel<<<grid_for(n), THREADS, 0, s>>>(in, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flat: [rows * w] float32, contiguous; out: [rows, w] float32, contiguous.
// Launches on `stream`, does not synchronise.
extern "C" int via_reshape(const void* flat, void* out, long long rows, int w,
                           void* stream) {
  return times_two(flat, out, rows, w, stream);
}

// x, out: [rows, w] float32, contiguous. Launches on `stream`, does not
// synchronise.
extern "C" int via_2d(const void* x, void* out, long long rows, int w,
                      void* stream) {
  return times_two(x, out, rows, w, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
