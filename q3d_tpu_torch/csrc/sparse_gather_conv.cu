// Sparse gather-conv over a direct rulebook, for Hopper (sm_90a).
//
// Replaces the TPU kernel q3d_tpu/ops/spconv/pallas_conv.py:274
// (_onehot_conv_call -> _kernel_v3 / _kernel_v2, entered through
// gather_conv_chunked_fast).  The TPU kernel turns the row gather into a
// one-hot matmul because the TPU's row gather is latency-bound; a GPU
// gathers rows by index directly, so this kernel computes the plain
// function
//
//     out[m, :] = (sum_k f[idx[m, k], :] @ W[k]) * out_scale * out_valid[m]
//
// with idx outside [0, N) (the rulebook's miss value N) read as a zero row.
//
// Design: one block owns a tile of BM output rows x BN output channels.
// For each tap k it stages the tile's row ids in shared memory, skips the
// tap when no row of the tile hits (sparse rulebooks miss most taps), then
// walks Cin in BK-wide slices: the gathered rows f[idx[m,k], c0:c0+BK] and
// the weight slice W[k, c0:c0+BK, n0:n0+BN] go to shared memory, and each
// thread accumulates a TM x TN register tile (f32 for f32/bf16, s32 for s8).
// The epilogue applies out_scale and out_valid and writes the output type
// (f32 / bf16 for float inputs, f32 for s8 inputs).
//
// Bound on the card: at the CenterPoint backbone's widths (Cin, Cout <= 128)
// the arithmetic intensity per gathered byte is low, so the ideal is set by
// the bytes of the present taps' rows plus the output; this first version
// computes on CUDA cores (no tensor cores yet), so its compute rate, not the
// memory, is what it runs into.  wgmma/TMA are for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BK = 16;        // input channels per shared-memory slice
constexpr int THREADS = 256;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int32_t; };

__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ int32_t load_acc(const int8_t* p) {
  return static_cast<int32_t>(*p);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, typename OutT, int BN>
__global__ void __launch_bounds__(THREADS)
gather_conv_kernel(const T* __restrict__ feat, const int32_t* __restrict__ idx,
                   const T* __restrict__ w, const float* __restrict__ scale,
                   const uint8_t* __restrict__ valid, OutT* __restrict__ out,
                   int N, int M, int K, int Cin, int Cout) {
  using Acc = typename AccOf<T>::type;
  constexpr int TX = 16;                      // threads along the columns
  constexpr int TY = THREADS / TX;            // 16 threads along the rows
  constexpr int TN = BN / TX;                 // columns per thread
  constexpr int TM = BM / TY;                 // rows per thread (4)

  __shared__ int rows[BM];
  __shared__ Acc As[BK][BM + 1];              // gathered rows, transposed
  __shared__ Acc Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k = 0; k < K; ++k) {
    int hit = 0;
    if (tid < BM) {
      const int m = m0 + tid;
      int r = (m < M) ? idx[(size_t)m * K + k] : -1;
      if (r < 0 || r >= N) r = -1;
      rows[tid] = r;
      hit = r >= 0;
    }
    if (!__syncthreads_or(hit)) continue;    // no row of the tile uses tap k

    for (int c0 = 0; c0 < Cin; c0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int src = rows[r];
        As[c][r] = src >= 0 ? load_acc(feat + (size_t)src * Cin + c0 + c) : Acc(0);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, n = e % BN;
        Bs[kk][n] = load_acc(w + ((size_t)k * Cin + c0 + kk) * Cout + n0 + n);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        Acc a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const float keep = (valid == nullptr || valid[m]) ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + TX * j;
      float v = static_cast<float>(acc[i][j]);
      if (scale != nullptr) v *= scale[n];
      v *= keep;
      store_out(out + (size_t)m * Cout + n, v);
    }
  }
}

template <typename T, typename OutT>
int launch(const void* feat, const void* idx, const void* w, const void* scale,
           const void* valid, void* out, int N, int M, int K, int Cin, int Cout,
           void* stream) {
  if (M == 0) return 0;
  const dim3 block(THREADS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const T*>(feat);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* wt = static_cast<const T*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* vd = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<OutT*>(out);
  const unsigned gx = (M + BM - 1) / BM;
  if (Cout % 64 == 0) {
    gather_conv_kernel<T, OutT, 64><<<dim3(gx, Cout / 64), block, 0, s>>>(
        f, ix, wt, sc, vd, o, N, M, K, Cin, Cout);
  } else if (Cout % 32 == 0) {
    gather_conv_kernel<T, OutT, 32><<<dim3(gx, Cout / 32), block, 0, s>>>(
        f, ix, wt, sc, vd, o, N, M, K, Cin, Cout);
  } else {
    gather_conv_kernel<T, OutT, 16><<<dim3(gx, Cout / 16), block, 0, s>>>(
        f, ix, wt, sc, vd, o, N, M, K, Cin, Cout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pointers are device pointers; scale (Cout,) f32 and valid (M,) u8 may be
// null.  Requires Cin % 16 == 0 and Cout % 16 == 0 (the wrapper checks).
// Returns the cudaError_t of the launch.
extern "C" int q3d_sparse_gather_conv_f32(
    const void* feat, const void* idx, const void* w, const void* scale,
    const void* valid, void* out, int N, int M, int K, int Cin, int Cout,
    void* stream) {
  return launch<float, float>(feat, idx, w, scale, valid, out, N, M, K, Cin,
                              Cout, stream);
}

extern "C" int q3d_sparse_gather_conv_bf16(
    const void* feat, const void* idx, const void* w, const void* scale,
    const void* valid, void* out, int N, int M, int K, int Cin, int Cout,
    void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(feat, idx, w, scale, valid, out,
                                              N, M, K, Cin, Cout, stream);
}

extern "C" int q3d_sparse_gather_conv_s8(
    const void* feat, const void* idx, const void* w, const void* scale,
    const void* valid, void* out, int N, int M, int K, int Cin, int Cout,
    void* stream) {
  return launch<int8_t, float>(feat, idx, w, scale, valid, out, N, M, K, Cin,
                               Cout, stream);
}
