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
// larger than the 50 MB L2, so every call streams both through it.
//
// What held the first design back: a grid-stride loop over a grid capped
// at 132 * 16 blocks of 256 threads, so two waves of 8 resident blocks per
// SM, each thread walking 6 or 7 float4s. ptxas unrolled the loop by 4
// behind a 64-bit division for its trip count and a remainder loop that
// issues one load at a time, and the last wave's blocks left SMs idle at
// the end. It ran 3% behind torch.mul (0.0408 against 0.0396 ms).
//
// Design: one pass, no loop. Each of a block's 128 threads owns U = 2
// float4s, neighbouring threads on neighbouring 16-byte words, and the
// grid covers the array once (n4 / (THREADS * U) blocks), so the hardware
// scheduler keeps every SM full until the last blocks. A thread issues
// both loads before its first store. The block that holds the array's end
// checks each float4 against n4; the last n % 4 floats go to block 0's
// first threads. When either pointer is not 16-byte aligned the whole pass
// goes as floats in a grid-stride loop (256 threads a block). No shared
// memory, no cache hints, no state across calls. The result is exact
// (2 * x rounds nothing), so it is bitwise equal to torch.mul(x, 2.0).
//
// Measured against it on the H100 (device time in a CUDA graph): U = 1, 4
// and 8, 256 and 512 threads a block, non-coherent loads, and a persistent
// kernel that streams 8-32 KB stages through shared memory with bulk
// copies (cp.async.bulk and mbarriers) were no faster. Evict-first loads
// and stores (ld/st.global.cs) were faster only while L2 held lines of the
// same buffers: after a kernel that wrote other memory at normal priority
// they ran 1.2% slower, as if L2 evicted their own lines before the older
// ones and left the pass the rest.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libreshape_probe.so reshape_probe.cu
// C entry points via_reshape and via_2d return the cudaError_t of the launch;
// vec_launch reports the float4 path's grid, block and U for n floats.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int U = 2;                         // float4s a thread
constexpr long long TILE4 = THREADS * U;     // float4s a block
constexpr int SCALAR_THREADS = 256;          // the scalar path's block
constexpr long long MAX_BLOCKS = 132 * 16;   // and its grid cap

__device__ __forceinline__ float4 twice(float4 v) {
  v.x *= 2.0f;
  v.y *= 2.0f;
  v.z *= 2.0f;
  v.w *= 2.0f;
  return v;
}

__global__ void __launch_bounds__(THREADS)
times_two_vec_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                     long long n4, const float* __restrict__ in_tail,
                     float* __restrict__ out_tail, int tail) {
  const long long i = static_cast<long long>(blockIdx.x) * TILE4 +
                      threadIdx.x;
  float4 v[U];
  if (i + (U - 1) * THREADS < n4) {          // every block but the last
#pragma unroll
    for (int k = 0; k < U; ++k) v[k] = in[i + k * THREADS];
#pragma unroll
    for (int k = 0; k < U; ++k) out[i + k * THREADS] = twice(v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (i + k * THREADS < n4) v[k] = in[i + k * THREADS];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (i + k * THREADS < n4) out[i + k * THREADS] = twice(v[k]);
  }
  if (i < tail) out_tail[i] = 2.0f * in_tail[i];
}

__global__ void __launch_bounds__(SCALAR_THREADS)
times_two_kernel(const float* __restrict__ in, float* __restrict__ out,
                 long long n) {
  const long long stride = static_cast<long long>(gridDim.x) *
                           SCALAR_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * SCALAR_THREADS +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = 2.0f * in[i];
}

unsigned vec_grid(long long n4) {
  const long long blocks = (n4 + TILE4 - 1) / TILE4;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

unsigned scalar_grid(long long n) {
  long long blocks = (n + SCALAR_THREADS - 1) / SCALAR_THREADS;
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
    times_two_vec_kernel<<<vec_grid(n4), THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
        n4, in + 4 * n4, out + 4 * n4, tail);
  } else {
    times_two_kernel<<<scalar_grid(n), SCALAR_THREADS, 0, s>>>(in, out, n);
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

// The float4 path's launch for n floats on aligned pointers:
// out3 = {grid, block, U}.
extern "C" void vec_launch(long long n, int* out3) {
  out3[0] = static_cast<int>(vec_grid(n / 4));
  out3[1] = THREADS;
  out3[2] = U;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
