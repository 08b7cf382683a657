// One CIN layer forward for Hopper (sm_90a):
//
//     y[n, h] = relu( sum_{p<F0, q<Fk} x0[n, p] * xk[n, q] * W[p*Fk + q, h] + b[h] )
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_cin.py:_fwd_kernel, launched
// by _fwd_impl. The Pallas kernel built the outer-product tile
// z[n, p*Fk+q] in VMEM by two 0/1 selector matmuls (x0 @ S^T, xk @ R^T) and
// fed it to the MXU. Those selector matmuls only move data, so this kernel
// indexes z directly: z is formed one element at a time in a register and
// never touches memory.
//
// What bounds it on the H100: the arithmetic. Per row it does F0*Fk*H
// multiply-adds (39*39*20 = 30,420 for the first xDeepFM layer) against
// 4*(F0 + Fk + H) bytes of row traffic, so device-memory bandwidth is far
// from the limit. Each multiply-add needs one W element; every thread of a
// warp reads the same W element at the same time, so W is read from shared
// memory as a broadcast (one shared load per multiply-add, no bank
// conflicts), and issue slots for those loads are the real ceiling.
//
// Design (simple and right first):
//   - one thread per row, ROWS rows per block; H <= 32 float accumulators in
//     registers (H is a template argument, so the accumulator array never
//     spills to local memory);
//   - the block's x0 and xk row tiles are copied coalesced into shared
//     memory; per-thread rows use odd strides, so thread t reading its own
//     row element hits bank (t*stride + c) mod 32 without conflicts, and
//     runtime Fk never indexes a register array;
//   - W is staged in chunks of `pc` values of p (at most W_CHUNK floats), so
//     the first layer's 121,680-byte W does not pin one block per SM;
//   - the ragged last tile is masked, not padded; every output is written
//     once, with no atomics, so results are deterministic.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libcin_layer.so cin_layer.cu
// C entry point cin_layer_fwd returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;      // rows of the block = threads of the block
constexpr int W_CHUNK = 6144;  // floats of W staged per pass (24 KB)

template <int H>
__global__ void __launch_bounds__(ROWS)
cin_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ xk,
               const float* __restrict__ w, const float* __restrict__ b,
               float* __restrict__ y, int n, int f0, int fk, int pc) {
  extern __shared__ float smem[];
  const int s0 = f0 | 1;  // odd strides: conflict-free per-thread rows
  const int sk = fk | 1;
  float* x0_s = smem;               // [ROWS][s0]
  float* xk_s = x0_s + ROWS * s0;   // [ROWS][sk]
  float* w_s = xk_s + ROWS * sk;    // [pc * fk][H]

  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS), n - row0));

  // The tile's rows are contiguous in global memory: copy them coalesced.
  const float* x0_g = x0 + row0 * f0;
  for (int i = t; i < rows * f0; i += ROWS) {
    const int r = i / f0;
    x0_s[r * s0 + (i - r * f0)] = x0_g[i];
  }
  const float* xk_g = xk + row0 * fk;
  for (int i = t; i < rows * fk; i += ROWS) {
    const int r = i / fk;
    xk_s[r * sk + (i - r * fk)] = xk_g[i];
  }

  float acc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.0f;

  const float* x0_r = x0_s + t * s0;
  const float* xk_r = xk_s + t * sk;
  for (int p0 = 0; p0 < f0; p0 += pc) {
    const int p1 = min(p0 + pc, f0);
    __syncthreads();  // the previous chunk of W is consumed
    const int count = (p1 - p0) * fk * H;
    const float* w_g = w + static_cast<long long>(p0) * fk * H;
    for (int i = t; i < count; i += ROWS) w_s[i] = w_g[i];
    __syncthreads();  // this chunk (and, on the first pass, the tiles) landed
    if (t < rows) {
      for (int p = p0; p < p1; ++p) {
        const float a = x0_r[p];
        const float* w_p = w_s + (p - p0) * fk * H;
        for (int q = 0; q < fk; ++q) {
          const float z = a * xk_r[q];
          const float* w_pq = w_p + q * H;
#pragma unroll
          for (int h = 0; h < H; ++h) acc[h] = fmaf(z, w_pq[h], acc[h]);
        }
      }
    }
  }

  if (t < rows) {
    float* y_r = y + (row0 + t) * H;
#pragma unroll
    for (int h = 0; h < H; ++h) y_r[h] = fmaxf(acc[h] + b[h], 0.0f);
  }
}

template <int H>
cudaError_t launch(const float* x0, const float* xk, const float* w,
                   const float* b, float* y, int n, int f0, int fk,
                   cudaStream_t stream) {
  int pc = W_CHUNK / (fk * H);
  if (pc < 1) pc = 1;
  if (pc > f0) pc = f0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(ROWS) * ((f0 | 1) + (fk | 1)) +
                       static_cast<size_t>(pc) * fk * H);
  cudaError_t err = cudaFuncSetAttribute(
      cin_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + ROWS - 1) / ROWS);
  cin_fwd_kernel<H><<<grid, ROWS, smem, stream>>>(x0, xk, w, b, y, n, f0, fk,
                                                  pc);
  return cudaGetLastError();
}

}  // namespace

#define CIN_CASE(H) \
  case H:           \
    return static_cast<int>(launch<H>(x0, xk, w, b, y, n, f0, fk, s));

extern "C" int cin_layer_fwd(const void* x0_p, const void* xk_p,
                             const void* w_p, const void* b_p, void* y_p,
                             int n, int f0, int fk, int h, void* stream) {
  const float* x0 = static_cast<const float*>(x0_p);
  const float* xk = static_cast<const float*>(xk_p);
  const float* w = static_cast<const float*>(w_p);
  const float* b = static_cast<const float*>(b_p);
  float* y = static_cast<float*>(y_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f0 <= 0 || fk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (h) {
    CIN_CASE(1) CIN_CASE(2) CIN_CASE(3) CIN_CASE(4)
    CIN_CASE(5) CIN_CASE(6) CIN_CASE(7) CIN_CASE(8)
    CIN_CASE(9) CIN_CASE(10) CIN_CASE(11) CIN_CASE(12)
    CIN_CASE(13) CIN_CASE(14) CIN_CASE(15) CIN_CASE(16)
    CIN_CASE(17) CIN_CASE(18) CIN_CASE(19) CIN_CASE(20)
    CIN_CASE(21) CIN_CASE(22) CIN_CASE(23) CIN_CASE(24)
    CIN_CASE(25) CIN_CASE(26) CIN_CASE(27) CIN_CASE(28)
    CIN_CASE(29) CIN_CASE(30) CIN_CASE(31) CIN_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
