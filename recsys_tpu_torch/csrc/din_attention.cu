// DIN's target-attention unit for Hopper (sm_90a): the elementwise work
// round the unit's three products, forward and backward, as
// recsys_tpu_torch/ops/din_attention.py drives it. For a unit with history
// rows R = B·P of width K and hidden widths h_1..h_n:
//
//     X   = [h, q, h⊙q, h−q]                  [R, 4K]     din_build
//     Z_l = A_{l−1} · W_l                      cuBLAS (torch.matmul)
//     A_l = dropout(relu(Z_l + b_l))           in place    din_epilogue
//     wgt = A_n · w_out + b_out;  prod = hist·wgt·[id > 0]
//                                              [B, P, K]   din_pool
//     out = Σ_p prod                           torch.sum
//
// and the backward: din_head_backward (the pooling's and the output
// layer's gradients and the last hidden layer's dZ), din_epilogue_backward
// (dZ of each earlier hidden layer), cuBLAS for every dA and dW,
// din_fold (the gradients of hist and query from dX) and
// din_column_sums (the biases' and w_out's gradients from per-block
// partial sums).
//
// It replaces no TPU kernel: the JAX package's unit is elementwise code
// and dots that XLA fuses. The port ran it as plain PyTorch with autograd's
// backward, about 25 eager passes a unit over [131,072, 40–128] float32
// tensors at the benchmark's shape (B = 1,024, P = 128, K = 32, 80-40):
// cat's temporaries, each layer's bias add, ReLU, dropout's compare,
// scale, zeros and select, and in the backward their mirrors and column
// reductions, which moved about 3.4 GB a unit-step.
//
// What bounds it on the H100: bytes. Every kernel here does a few float32
// operations per element it reads or writes; the units' flops are the
// products', which stay cuBLAS's. So each kernel reads each of its inputs
// once and writes each output once, and keeps enough loads in flight:
//   - the forward's kernels are flat grid-stride loops over float4s where
//     the rows' widths are multiples of 4 and the pointers 16-B aligned
//     (scalar loops otherwise); din_epilogue writes A over Z;
//   - nothing is saved for the backward but X and the activations: the
//     gradient through ReLU and dropout is nonzero exactly where A > 0
//     (a kept, positive value scaled by 1/keep > 1 stays positive), so no
//     mask is stored;
//   - the backward's column kernels give each block ROWS rows; a thread
//     owns one float4 of columns and a residue of the tile's rows, sums its
//     columns in registers, the block's threads add their sums in a fixed
//     order in shared memory and write one partial row; din_column_sums
//     adds the partial rows in a fixed order. No atomics anywhere: the
//     result does not depend on the schedule, and a graphed step is
//     bitwise an eager one;
//   - din_fold gives each block one example b: it writes d_hist for the
//     example's P rows and sums d_query over them in a fixed order.
// Why the products stay cuBLAS: the forward has to give, bitwise, the
// values the plain version gives, since a float32 product of another
// order moves the units' ReLU pre-activations across 0 on some rows, and
// the gradients with them; the same cuBLAS call on the same operands
// gives the same values.
//
// The forward's kernels compute each element with the plain version's
// IEEE float32 operations in its order (__f*_rn, which nvcc does not
// contract): z + b, then relu (NaN passes), then, with dropout, the kept
// value times the float32 reciprocal of keep — PyTorch's CUDA division by
// a Python scalar — and rand < keep compared in float32; wgt = m + b_out;
// prod = (hist · wgt) · mask.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libdin_attention.so
//             din_attention.cu
// Each C entry point returns the cudaError_t of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;     // threads per block, every kernel
constexpr int ROWS = 128;        // rows per block of the column kernels
constexpr int MAX_SEGS = 16;     // partial arrays per din_column_sums launch
constexpr unsigned MAX_GRID = 1u << 20;

template <int V>
struct Vec {
  float e[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> v;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v.e[0] = t.x;
    v.e[1] = t.y;
    v.e[2] = t.z;
    v.e[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v.e[i] = p[i];
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.e[0], v.e[1], v.e[2], v.e[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v.e[i];
  }
}

__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.0f);      // torch.relu: NaN passes
}

__device__ __forceinline__ bool real(const long long* ids, size_t r) {
  return ids[r] > 0;
}

unsigned grid_for(unsigned long long n) {
  const unsigned long long blocks = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(blocks < MAX_GRID ? blocks : MAX_GRID);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

// ---------------------------------------------------------------- forward

// X[r] = [h_r, q_b, h_r·q_b, h_r − q_b]; n = R·K/V vectors of hist.
template <int V>
__global__ void __launch_bounds__(THREADS)
din_build_kernel(const float* __restrict__ hist,
                 const float* __restrict__ query, float* __restrict__ x,
                 unsigned n, unsigned kv, unsigned pkv, int K) {
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const unsigned r = i / kv;
    const unsigned c = i - r * kv;
    const unsigned b = i / pkv;
    const Vec<V> h = load<V>(hist + static_cast<size_t>(i) * V);
    const Vec<V> q = load<V>(query + static_cast<size_t>(b) * K + c * V);
    Vec<V> hq, hd;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      hq.e[e] = __fmul_rn(h.e[e], q.e[e]);
      hd.e[e] = __fsub_rn(h.e[e], q.e[e]);
    }
    float* xr = x + static_cast<size_t>(r) * 4 * K + c * V;
    store<V>(xr, h);
    store<V>(xr + K, q);
    store<V>(xr + 2 * K, hq);
    store<V>(xr + 3 * K, hd);
  }
}

// A = dropout(relu(Z + b)) over [R, h], in place; n = R·h/V vectors.
template <int V, bool DROP>
__global__ void __launch_bounds__(THREADS)
din_epilogue_kernel(float* __restrict__ z, const float* __restrict__ bias,
                    const float* __restrict__ rnd, unsigned n, unsigned hv,
                    float keep, float inv_keep) {
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const unsigned c = i % hv;
    const size_t off = static_cast<size_t>(i) * V;
    Vec<V> a = load<V>(z + off);
    const Vec<V> b = load<V>(bias + c * V);
    Vec<V> u;
    if constexpr (DROP) u = load<V>(rnd + off);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float t = relu(__fadd_rn(a.e[e], b.e[e]));
      if constexpr (DROP) {
        a.e[e] = u.e[e] < keep ? __fmul_rn(t, inv_keep) : 0.0f;
      } else {
        a.e[e] = t;
      }
    }
    store<V>(z + off, a);
  }
}

// wgt_r = m_r + b_out; prod[r] = (hist_r · wgt_r) · [id_r > 0];
// n = R·K/V vectors of hist.
template <int V>
__global__ void __launch_bounds__(THREADS)
din_pool_kernel(const float* __restrict__ hist,
                const long long* __restrict__ ids,
                const float* __restrict__ m, const float* __restrict__ b_out,
                float* __restrict__ prod, float* __restrict__ wgt,
                unsigned n, unsigned kv) {
  const float bo = *b_out;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const unsigned r = i / kv;
    const float w = __fadd_rn(m[r], bo);
    const float mask = real(ids, r) ? 1.0f : 0.0f;
    const size_t off = static_cast<size_t>(i) * V;
    const Vec<V> h = load<V>(hist + off);
    Vec<V> p;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      p.e[e] = __fmul_rn(__fmul_rn(h.e[e], w), mask);
    }
    store<V>(prod + off, p);
    if (i == r * kv) wgt[r] = w;
  }
}

// --------------------------------------------------------------- backward
//
// Sums over rows are taken in double from each thread's first addend to
// the partial rows and their total, so that they stay within float32's
// rounding of the exact sum whatever the batch: autograd's column
// reductions, against which the backward is held, come that close.

// The column pass shared by the head and the epilogue backward over one
// tile of `nrows` rows from `row0`, width h (hv = h/V column vectors):
// dz = gate(a)·scale(d) with d = da_of(i, c, off) (no gate without GATE);
// per column, Σ dz into part_b and, with WSUM, Σ a·s_dw[i] into part_w,
// one partial row per block.
template <int V, bool GATE, bool DROP, bool WSUM, typename DaFn>
__device__ __forceinline__ void column_pass(
    const float* a, float* dz, double* __restrict__ part_b,
    double* __restrict__ part_w, const float* s_dw, double* s_acc,
    int row0, int nrows, int h, float inv_keep, DaFn da_of) {
  const int hv = h / V;
  auto one_row = [&](int i, int c, double* sb, double* sw) {
    const size_t off = static_cast<size_t>(row0 + i) * h + c * V;
    const Vec<V> av = load<V>(a + off);
    Vec<V> d = da_of(i, c, off);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if constexpr (GATE) {
        const float t = DROP ? __fmul_rn(d.e[e], inv_keep) : d.e[e];
        d.e[e] = av.e[e] > 0.0f ? t : 0.0f;
      }
      sb[e] += d.e[e];
      if constexpr (WSUM) sw[e] += static_cast<double>(av.e[e]) * s_dw[i];
    }
    store<V>(dz + off, d);
  };
  if (hv <= THREADS) {
    const int G = THREADS / hv;
    const int g = threadIdx.x / hv;
    const int c = threadIdx.x - g * hv;
    double sb[V] = {}, sw[V] = {};
    if (g < G) {
      for (int i = g; i < nrows; i += G) one_row(i, c, sb, sw);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s_acc[g * h + c * V + e] = sb[e];
        if constexpr (WSUM) s_acc[THREADS * V + g * h + c * V + e] = sw[e];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < h; j += THREADS) {
      double tb = 0.0, tw = 0.0;
      for (int k = 0; k < G; ++k) {
        tb += s_acc[k * h + j];
        if constexpr (WSUM) tw += s_acc[THREADS * V + k * h + j];
      }
      const size_t at = static_cast<size_t>(blockIdx.x) * h + j;
      if (part_b != nullptr) part_b[at] = tb;
      if constexpr (WSUM) part_w[at] = tw;
    }
    return;
  }
  for (int c = threadIdx.x; c < hv; c += THREADS) {
    double sb[V] = {}, sw[V] = {};
    for (int i = 0; i < nrows; ++i) one_row(i, c, sb, sw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const size_t at = static_cast<size_t>(blockIdx.x) * h + c * V + e;
      if (part_b != nullptr) part_b[at] = sb[e];
      if constexpr (WSUM) part_w[at] = sw[e];
    }
  }
}

// From the unit's output gradient: d_wgt_r = [id_r > 0]·Σ_k dout_bk·hist_rk
// (L lanes a row, each summing every L-th vector of K, then a shuffle
// tree); dz = gate(a)·scale(d_wgt_r·w_out) over [R, h] (without GATE, the
// gradient of X itself, a being X); partial rows of Σ dz (GATE only),
// Σ a·d_wgt (w_out's gradient) and Σ d_wgt (b_out's).
template <int V, int KV, bool GATE, bool DROP>
__global__ void __launch_bounds__(THREADS)
din_head_backward_kernel(const float* __restrict__ dout,
                         const float* __restrict__ hist,
                         const long long* __restrict__ ids,
                         const float* __restrict__ a,
                         const float* __restrict__ w_out,
                         float* __restrict__ dz, double* __restrict__ part_b,
                         double* __restrict__ part_w,
                         double* __restrict__ part_bo, int rows, int P, int K,
                         int h, float inv_keep) {
  __shared__ float s_dw[ROWS];
  __shared__ double s_acc[2 * THREADS * V];
  const int row0 = blockIdx.x * ROWS;
  const int nrows = rows - row0 < ROWS ? rows - row0 : ROWS;
  const int kv = K / KV;               // vectors of KV floats a row
  int lanes = 1;                       // L: a power of two, at most 32
  while (lanes < kv && lanes < 32) lanes <<= 1;
  const int sub = threadIdx.x & (lanes - 1);
  // every thread takes each pass, so that the shuffles see whole warps
  for (int base = 0; base < nrows; base += THREADS / lanes) {
    const int i = base + threadIdx.x / lanes;
    const int r = row0 + i;
    float s = 0.0f;
    if (i < nrows) {
      const float* dr = dout + static_cast<size_t>(r / P) * K;
      const float* hr = hist + static_cast<size_t>(r) * K;
      for (int q = sub; q < kv; q += lanes) {
        const Vec<KV> x = load<KV>(hr + q * KV), y = load<KV>(dr + q * KV);
#pragma unroll
        for (int e = 0; e < KV; ++e) s = fmaf(y.e[e], x.e[e], s);
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (i < nrows && sub == 0) s_dw[i] = real(ids, r) ? s : 0.0f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    double s = 0.0;
    for (int i = lane; i < nrows; i += 32) s += s_dw[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part_bo[blockIdx.x] = s;
  }
  column_pass<V, GATE, DROP, true>(
      a, dz, GATE ? part_b : nullptr, part_w, s_dw, s_acc, row0, nrows, h,
      inv_keep, [&](int i, int c, size_t) {
        const Vec<V> wo = load<V>(w_out + c * V);
        Vec<V> d;
#pragma unroll
        for (int e = 0; e < V; ++e) d.e[e] = __fmul_rn(s_dw[i], wo.e[e]);
        return d;
      });
}

// dz = gate(a)·scale(da) over [R, h], written over da; partial rows of
// Σ dz (the layer's bias gradient).
template <int V, bool DROP>
__global__ void __launch_bounds__(THREADS)
din_epilogue_backward_kernel(float* da, const float* __restrict__ a,
                             double* __restrict__ part_b, int rows, int h,
                             float inv_keep) {
  __shared__ double s_acc[THREADS * V];
  const int row0 = blockIdx.x * ROWS;
  const int nrows = rows - row0 < ROWS ? rows - row0 : ROWS;
  column_pass<V, true, DROP, false>(
      a, da, part_b, nullptr, nullptr, s_acc, row0, nrows, h, inv_keep,
      [&](int, int, size_t off) { return load<V>(da + off); });
}

// One block an example b: d_hist[r] = dX_h + dX_p·q + dX_d + [id > 0]·
// dout·wgt_r for its P rows, d_query[b] = Σ_p (dX_q + dX_p·h − dX_d) in a
// fixed order. A thread owns a vector of V columns k and every G-th row.
template <int V>
__global__ void __launch_bounds__(THREADS)
din_fold_kernel(const float* __restrict__ dx, const float* __restrict__ dout,
                const float* __restrict__ hist,
                const float* __restrict__ query,
                const long long* __restrict__ ids,
                const float* __restrict__ wgt, float* __restrict__ dhist,
                float* __restrict__ dquery, int P, int K) {
  __shared__ double s_q[THREADS * V];
  const size_t b = blockIdx.x;
  const int kv = K / V;
  auto slot = [&](int c, int p0, int step, double* acc) {
    const Vec<V> q = load<V>(query + b * K + c * V);
    const Vec<V> go = load<V>(dout + b * K + c * V);
    for (int p = p0; p < P; p += step) {
      const size_t r = b * P + p;
      const float* d = dx + r * 4 * K + c * V;
      const Vec<V> h = load<V>(hist + r * K + c * V);
      const Vec<V> dxh = load<V>(d), dxq = load<V>(d + K);
      const Vec<V> dxp = load<V>(d + 2 * K), dxd = load<V>(d + 3 * K);
      const bool m = real(ids, r);
      const float w = wgt[r];
      Vec<V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float pool = m ? go.e[e] * w : 0.0f;
        out.e[e] = dxh.e[e] + dxp.e[e] * q.e[e] + dxd.e[e] + pool;
        acc[e] += dxq.e[e] + dxp.e[e] * h.e[e] - dxd.e[e];
      }
      store<V>(dhist + r * K + c * V, out);
    }
  };
  if (kv <= THREADS) {
    const int G = THREADS / kv;
    const int g = threadIdx.x / kv;
    const int c = threadIdx.x - g * kv;
    double acc[V] = {};
    if (g < G) slot(c, g, G, acc);
#pragma unroll
    for (int e = 0; e < V; ++e) s_q[threadIdx.x * V + e] = acc[e];
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += THREADS) {
      double s = 0.0;
      for (int j = 0; j < G; ++j) s += s_q[j * K + k];
      dquery[b * K + k] = static_cast<float>(s);
    }
    return;
  }
  for (int c = threadIdx.x; c < kv; c += THREADS) {
    double acc[V] = {};
    slot(c, 0, 1, acc);
#pragma unroll
    for (int e = 0; e < V; ++e) dquery[b * K + c * V + e] = static_cast<float>(acc[e]);
  }
}

struct Segments {
  const double* part[MAX_SEGS];    // [nblk, cols] partial rows
  float* out[MAX_SEGS];            // [cols]
  int nblk[MAX_SEGS];
  int cols[MAX_SEGS];
  int first_block[MAX_SEGS];
  int count;
};

// out[j] = Σ_blk part[blk, j], 32 columns a block: each warp sums every
// 8th partial row in order, then warp 0 adds the 8 sums in order.
__global__ void __launch_bounds__(THREADS)
din_column_sums_kernel(const __grid_constant__ Segments S) {
  __shared__ double s_sum[THREADS / 32][32];
  int s = 0;
  while (s + 1 < S.count && S.first_block[s + 1] <= static_cast<int>(blockIdx.x)) ++s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = S.cols[s];
  const int j = (static_cast<int>(blockIdx.x) - S.first_block[s]) * 32 + lane;
  double t = 0.0;
  if (j < cols) {
    const double* p = S.part[s];
#pragma unroll 4
    for (int blk = warp; blk < S.nblk[s]; blk += THREADS / 32) {
      t += p[static_cast<size_t>(blk) * cols + j];
    }
  }
  s_sum[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && j < cols) {
    double u = 0.0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) u += s_sum[w][lane];
    S.out[s][j] = static_cast<float>(u);
  }
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// X [B·P, 4K] from hist [B, P, K] and query [B, K]. Does not synchronise.
int din_build(const float* hist, const float* query, float* x, int B, int P,
              int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long elems = 1ULL * B * P * K;
  if (elems == 0) return 0;
  if (K % 4 == 0 && aligned16(hist) && aligned16(query) && aligned16(x)) {
    const unsigned n = static_cast<unsigned>(elems / 4);
    const unsigned kv = K / 4;
    din_build_kernel<4><<<grid_for(n), THREADS, 0, st>>>(
        hist, query, x, n, kv, kv * P, K);
  } else {
    const unsigned n = static_cast<unsigned>(elems);
    din_build_kernel<1><<<grid_for(n), THREADS, 0, st>>>(
        hist, query, x, n, K, 1u * K * P, K);
  }
  return launched();
}

// A = dropout(relu(Z + b)) over Z [rows, h], in place; rnd [rows, h] of
// uniforms (dropout keeps rnd < keep), or null for no dropout.
int din_epilogue(float* z, const float* bias, const float* rnd, int rows,
                 int h, float keep, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long elems = 1ULL * rows * h;
  if (elems == 0) return 0;
  const bool vec = h % 4 == 0 && aligned16(z) && aligned16(bias) &&
                   (rnd == nullptr || aligned16(rnd));
  const unsigned n = static_cast<unsigned>(vec ? elems / 4 : elems);
  const unsigned hv = vec ? h / 4 : h;
  if (vec && rnd) {
    din_epilogue_kernel<4, true><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  } else if (vec) {
    din_epilogue_kernel<4, false><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  } else if (rnd) {
    din_epilogue_kernel<1, true><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  } else {
    din_epilogue_kernel<1, false><<<grid_for(n), THREADS, 0, st>>>(
        z, bias, rnd, n, hv, keep, inv_keep);
  }
  return launched();
}

// wgt [B·P] = m + b_out and prod [B, P, K] = hist·wgt·[id > 0], from
// hist [B, P, K], ids [B, P] (int64), m [B·P] and b_out [1].
int din_pool(const float* hist, const long long* ids, const float* m,
             const float* b_out, float* prod, float* wgt, int B, int P, int K,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long elems = 1ULL * B * P * K;
  if (elems == 0) return 0;
  const bool vec = K % 4 == 0 && aligned16(hist) && aligned16(prod);
  const unsigned n = static_cast<unsigned>(vec ? elems / 4 : elems);
  const unsigned kv = vec ? K / 4 : K;
  if (vec) {
    din_pool_kernel<4><<<grid_for(n), THREADS, 0, st>>>(hist, ids, m, b_out,
                                                        prod, wgt, n, kv);
  } else {
    din_pool_kernel<1><<<grid_for(n), THREADS, 0, st>>>(hist, ids, m, b_out,
                                                        prod, wgt, n, kv);
  }
  return launched();
}

// The head of the backward: dz [B·P, h] and the partial rows part_b
// [nblk, h] (gate only; null otherwise), part_w [nblk, h], part_bo [nblk]
// (double) from dout [B, K], hist, ids (int64), a [B·P, h] (the last hidden
// activation, or X without hidden layers, gate = 0) and w_out [h];
// nblk = ceil(B·P/ROWS).
int din_head_backward(const float* dout, const float* hist,
                      const long long* ids, const float* a,
                      const float* w_out, float* dz, double* part_b,
                      double* part_w, double* part_bo, int B, int P, int K,
                      int h, int gate, int drop, float inv_keep,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * P;
  if (rows == 0) return 0;
  const unsigned grid = (rows + ROWS - 1) / ROWS;
  const bool vec = h % 4 == 0 && aligned16(a) && aligned16(w_out) &&
                   aligned16(dz);
  const bool kvec = K % 4 == 0 && aligned16(hist) && aligned16(dout);
#define DIN_HEAD_K(V, KV, G, D)                                              \
  din_head_backward_kernel<V, KV, G, D><<<grid, THREADS, 0, st>>>(           \
      dout, hist, ids, a, w_out, dz, part_b, part_w, part_bo, rows, P, K, h, \
      inv_keep);
#define DIN_HEAD(V, G, D)                                                    \
  if (kvec) { DIN_HEAD_K(V, 4, G, D) } else { DIN_HEAD_K(V, 1, G, D) }
  if (vec) {
    if (gate && drop) { DIN_HEAD(4, true, true) }
    else if (gate) { DIN_HEAD(4, true, false) }
    else { DIN_HEAD(4, false, false) }
  } else {
    if (gate && drop) { DIN_HEAD(1, true, true) }
    else if (gate) { DIN_HEAD(1, true, false) }
    else { DIN_HEAD(1, false, false) }
  }
#undef DIN_HEAD
#undef DIN_HEAD_K
  return launched();
}

// dz = gate(a)·scale(da) over [rows, h], written over da, and the partial
// rows part_b [ceil(rows/ROWS), h] (double).
int din_epilogue_backward(float* da, const float* a, double* part_b,
                          int rows, int h, int drop, float inv_keep,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  const unsigned grid = (rows + ROWS - 1) / ROWS;
  const bool vec = h % 4 == 0 && aligned16(da) && aligned16(a);
  if (vec && drop) {
    din_epilogue_backward_kernel<4, true><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  } else if (vec) {
    din_epilogue_backward_kernel<4, false><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  } else if (drop) {
    din_epilogue_backward_kernel<1, true><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  } else {
    din_epilogue_backward_kernel<1, false><<<grid, THREADS, 0, st>>>(
        da, a, part_b, rows, h, inv_keep);
  }
  return launched();
}

// d_hist [B, P, K] and d_query [B, K] from dx [B·P, 4K], dout [B, K],
// hist, query, ids and wgt [B·P].
int din_fold(const float* dx, const float* dout, const float* hist,
             const float* query, const long long* ids, const float* wgt,
             float* dhist, float* dquery, int B, int P, int K,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0) return 0;
  const bool vec = K % 4 == 0 && aligned16(dx) && aligned16(dout) &&
                   aligned16(hist) && aligned16(query) && aligned16(dhist);
  if (vec) {
    din_fold_kernel<4><<<B, THREADS, 0, st>>>(dx, dout, hist, query, ids, wgt,
                                             dhist, dquery, P, K);
  } else {
    din_fold_kernel<1><<<B, THREADS, 0, st>>>(dx, dout, hist, query, ids, wgt,
                                             dhist, dquery, P, K);
  }
  return launched();
}

// out_i[j] = Σ_blk part_i[blk, j] for n arrays of double partial rows into
// float32 (device addresses as integers), MAX_SEGS a launch, in order.
int din_column_sums(int n, const long long* parts, const long long* outs,
                    const int* nblk, const int* cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Segments S{};
  int blocks = 0;
  for (int i = 0; i <= n; ++i) {
    if (i < n && cols[i] > 0) {
      const int k = S.count++;
      S.part[k] = reinterpret_cast<const double*>(parts[i]);
      S.out[k] = reinterpret_cast<float*>(outs[i]);
      S.nblk[k] = nblk[i];
      S.cols[k] = cols[i];
      S.first_block[k] = blocks;
      blocks += (cols[i] + 31) / 32;
    }
    if (S.count > 0 && (S.count == MAX_SEGS || i == n)) {
      din_column_sums_kernel<<<blocks, THREADS, 0, st>>>(S);
      const int err = launched();
      if (err != 0) return err;
      S = Segments{};
      blocks = 0;
    }
  }
  return 0;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
