// One CIN layer backward for Hopper (sm_90a). With the forward
//
//     y[n, h] = relu( sum_{p<F0, q<Fk} x0[n, p] * xk[n, q] * W[p*Fk + q, h] + b[h] )
//
// and dy the gradient of y, it computes (z[n, p*Fk+q] = x0[n, p] * xk[n, q])
//
//     g[n, h]   = dy[n, h] * (y[n, h] > 0)
//     dz[n, j]  = sum_h g[n, h] * W[j, h]
//     dx0[n, p] = sum_q xk[n, q] * dz[n, p*Fk+q]
//     dxk[n, q] = sum_p x0[n, p] * dz[n, p*Fk+q]
//     dW[j, h]  = sum_n z[n, j] * g[n, h]          db[h] = sum_n g[n, h]
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_cin.py:_bwd_kernel, launched
// by _bwd_impl. The Pallas kernel expanded x0 and xk into z-columns with 0/1
// selector matmuls and carried dW/db across its sequential grid in a
// resident output block. On the H100 the selector matmuls are plain
// indexing, and blocks run in parallel in no order, so dW is summed in two
// passes.
//
// What bounds it on the H100: the arithmetic, as in the forward. Per row,
// dz costs F0*Fk*H multiply-adds and dW another F0*Fk*H (39*39*20 = 30,420
// each for the first xDeepFM layer) against 4*(F0 + Fk + 2H) bytes of row
// traffic. Each multiply-add reads one operand from shared memory that
// every thread of the warp reads at once (a broadcast).
//
// Design (simple and right first), three kernels on one stream:
//   1. cin_bwd_rows: one thread per row, as the forward. g (H <= 32 values)
//      sits in registers; z and dz are formed one element at a time in a
//      register and never stored. W is staged in chunks of p through
//      dynamic shared memory (the first layer's W is 121,680 bytes). dx0[p]
//      is complete after its q loop and overwrites x0[p] in the row tile
//      (no longer read); dxk accumulates in a shared row tile. Both tiles
//      are written out coalesced.
//   2. cin_bwd_dw: one thread per column j of z (plus one for db, whose z
//      is 1) and a group of rows per block: the thread keeps dW[j, 0..H) in
//      registers while the block streams its rows' x0, xk and g through
//      shared memory. Each block writes its group's partial sums.
//   3. cin_bwd_reduce: sums the partials of all groups in group order.
//   Every output is written once and no atomics are used, so results are
//   deterministic; the ragged last tile is masked, not padded.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libcin_backward.so cin_backward.cu
// C entry point cin_layer_bwd returns the cudaError_t of the launches.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;      // rows per block in cin_bwd_rows
constexpr int W_CHUNK = 6144;  // floats of W staged per pass (24 KB)
constexpr int JT = 256;        // z columns per block in cin_bwd_dw
constexpr int TR = 32;         // rows per shared tile in cin_bwd_dw

template <int H>
__global__ void __launch_bounds__(ROWS)
cin_bwd_rows(const float* __restrict__ x0, const float* __restrict__ xk,
             const float* __restrict__ w, const float* __restrict__ y,
             const float* __restrict__ dy, float* __restrict__ dx0,
             float* __restrict__ dxk, int n, int f0, int fk, int pc) {
  extern __shared__ float smem[];
  const int s0 = f0 | 1;  // odd strides: conflict-free per-thread rows
  const int sk = fk | 1;
  float* x0_s = smem;               // [ROWS][s0], becomes dx0
  float* xk_s = x0_s + ROWS * s0;   // [ROWS][sk]
  float* dxk_s = xk_s + ROWS * sk;  // [ROWS][sk]
  float* w_s = dxk_s + ROWS * sk;   // [pc * fk][H]

  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS), n - row0));

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
  for (int i = t; i < ROWS * sk; i += ROWS) dxk_s[i] = 0.0f;

  float g[H];
#pragma unroll
  for (int h = 0; h < H; ++h) g[h] = 0.0f;
  if (t < rows) {
    const float* y_r = y + (row0 + t) * H;
    const float* dy_r = dy + (row0 + t) * H;
#pragma unroll
    for (int h = 0; h < H; ++h) g[h] = y_r[h] > 0.0f ? dy_r[h] : 0.0f;
  }

  float* x0_r = x0_s + t * s0;
  const float* xk_r = xk_s + t * sk;
  float* dxk_r = dxk_s + t * sk;
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
        float d0 = 0.0f;
        for (int q = 0; q < fk; ++q) {
          const float* w_pq = w_p + q * H;
          float dz = 0.0f;
#pragma unroll
          for (int h = 0; h < H; ++h) dz = fmaf(g[h], w_pq[h], dz);
          d0 = fmaf(xk_r[q], dz, d0);
          dxk_r[q] = fmaf(a, dz, dxk_r[q]);
        }
        x0_r[p] = d0;  // x0[p] is not read again: its slot now holds dx0[p]
      }
    }
  }
  __syncthreads();
  float* dx0_g = dx0 + row0 * f0;
  for (int i = t; i < rows * f0; i += ROWS) {
    const int r = i / f0;
    dx0_g[i] = x0_s[r * s0 + (i - r * f0)];
  }
  float* dxk_g = dxk + row0 * fk;
  for (int i = t; i < rows * fk; i += ROWS) {
    const int r = i / fk;
    dxk_g[i] = dxk_s[r * sk + (i - r * fk)];
  }
}

template <int H>
__global__ void __launch_bounds__(JT)
cin_bwd_dw(const float* __restrict__ x0, const float* __restrict__ xk,
           const float* __restrict__ y, const float* __restrict__ dy,
           float* __restrict__ part, int n, int f0, int fk,
           int rows_per_group) {
  extern __shared__ float smem[];
  float* x0_s = smem;            // [TR][f0]
  float* xk_s = x0_s + TR * f0;  // [TR][fk]
  float* g_s = xk_s + TR * fk;   // [TR][H]

  const int t = threadIdx.x;
  const int f0fk = f0 * fk;
  const int j = blockIdx.x * JT + t;  // j == f0fk: the bias, z = 1
  const bool live = j <= f0fk;
  const bool bias = j == f0fk;
  const int p = j < f0fk ? j / fk : 0;
  const int q = j < f0fk ? j - p * fk : 0;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_group;
  const long long r1 = min(r0 + rows_per_group, static_cast<long long>(n));

  float acc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.0f;

  for (long long tile = r0; tile < r1; tile += TR) {
    const int cnt = static_cast<int>(min(static_cast<long long>(TR), r1 - tile));
    __syncthreads();  // the previous tile is consumed
    for (int i = t; i < cnt * f0; i += JT) x0_s[i] = x0[tile * f0 + i];
    for (int i = t; i < cnt * fk; i += JT) xk_s[i] = xk[tile * fk + i];
    for (int i = t; i < cnt * H; i += JT) {
      const long long k = tile * H + i;
      g_s[i] = y[k] > 0.0f ? dy[k] : 0.0f;
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < cnt; ++r) {
        const float z = bias ? 1.0f : x0_s[r * f0 + p] * xk_s[r * fk + q];
        const float* g_r = g_s + r * H;
#pragma unroll
        for (int h = 0; h < H; ++h) acc[h] = fmaf(z, g_r[h], acc[h]);
      }
    }
  }
  if (live) {
    float* out = part + (static_cast<long long>(blockIdx.y) * (f0fk + 1) + j) * H;
#pragma unroll
    for (int h = 0; h < H; ++h) out[h] = acc[h];
  }
}

// dw[j, h] (j < f0fk) and db[h] (j == f0fk) = sum over groups, in order.
__global__ void cin_bwd_reduce(const float* __restrict__ part,
                               float* __restrict__ dw, float* __restrict__ db,
                               int groups, int f0fk, int h) {
  const int per_group = (f0fk + 1) * h;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_group) return;
  float acc = 0.0f;
  for (int r = 0; r < groups; ++r)
    acc += part[static_cast<long long>(r) * per_group + i];
  if (i < f0fk * h) {
    dw[i] = acc;
  } else {
    db[i - f0fk * h] = acc;
  }
}

template <int H>
cudaError_t launch(const float* x0, const float* xk, const float* w,
                   const float* y, const float* dy, float* dx0, float* dxk,
                   float* part, float* dw, float* db, int n, int f0, int fk,
                   int groups, int rows_per_group, cudaStream_t stream) {
  int pc = W_CHUNK / (fk * H);
  if (pc < 1) pc = 1;
  if (pc > f0) pc = f0;
  const size_t rows_smem =
      sizeof(float) * (static_cast<size_t>(ROWS) * ((f0 | 1) + 2 * (fk | 1)) +
                       static_cast<size_t>(pc) * fk * H);
  cudaError_t err = cudaFuncSetAttribute(
      cin_bwd_rows<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rows_smem));
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = static_cast<unsigned>((n + ROWS - 1) / ROWS);
  cin_bwd_rows<H><<<row_blocks, ROWS, rows_smem, stream>>>(
      x0, xk, w, y, dy, dx0, dxk, n, f0, fk, pc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dw_smem = sizeof(float) * TR * (f0 + fk + H);
  const int f0fk = f0 * fk;
  const dim3 dw_grid((f0fk + 1 + JT - 1) / JT, groups);
  cin_bwd_dw<H><<<dw_grid, JT, dw_smem, stream>>>(x0, xk, y, dy, part, n, f0,
                                                  fk, rows_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int outs = (f0fk + 1) * H;
  cin_bwd_reduce<<<(outs + 255) / 256, 256, 0, stream>>>(part, dw, db, groups,
                                                         f0fk, H);
  return cudaGetLastError();
}

}  // namespace

#define CIN_CASE(H)                                                          \
  case H:                                                                    \
    return static_cast<int>(launch<H>(x0, xk, w, y, dy, dx0, dxk, part, dw,  \
                                      db, n, f0, fk, groups, rows_per_group, \
                                      s));

// x0 [n, f0], xk [n, fk], w [f0*fk, h], y and dy [n, h] in; dx0 [n, f0],
// dxk [n, fk], dw [f0*fk, h], db [h] out; part [groups, f0*fk + 1, h]
// scratch, groups * rows_per_group >= n. Launches on `stream`, does not
// synchronise.
extern "C" int cin_layer_bwd(const void* x0_p, const void* xk_p,
                             const void* w_p, const void* y_p,
                             const void* dy_p, void* dx0_p, void* dxk_p,
                             void* part_p, void* dw_p, void* db_p, int n,
                             int f0, int fk, int h, int groups,
                             int rows_per_group, void* stream) {
  const auto* x0 = static_cast<const float*>(x0_p);
  const auto* xk = static_cast<const float*>(xk_p);
  const auto* w = static_cast<const float*>(w_p);
  const auto* y = static_cast<const float*>(y_p);
  const auto* dy = static_cast<const float*>(dy_p);
  auto* dx0 = static_cast<float*>(dx0_p);
  auto* dxk = static_cast<float*>(dxk_p);
  auto* part = static_cast<float*>(part_p);
  auto* dw = static_cast<float*>(dw_p);
  auto* db = static_cast<float*>(db_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f0 <= 0 || fk <= 0 || groups <= 0 || rows_per_group <= 0 ||
      static_cast<long long>(groups) * rows_per_group < n)
    return static_cast<int>(cudaErrorInvalidValue);
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
