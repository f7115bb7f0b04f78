// Greedy NMS suppression over precomputed IoU matrices, for Hopper (sm_90a).
//
// Replaces the TPU kernel q3d_tpu/ops/iou3d_nms/pallas_nms.py:45
// (greedy_suppress_pallas -> _nms_kernel).  It computes, for each set s,
//
//     keep[s, i] = valid[s, i] and not exists j < i: keep[s, j] and iou[s, j, i] > thresh
//
// with row j the suppressor, read exactly as the TPU kernel reads it.
//
// Design: the bitmask scheme of the reference's nms_gpu
// (pcdet/ops/iou3d_nms/src/iou3d_nms_kernel.cu).
//   Phase 1 (parallel): one 64-thread block per (row block, column block,
//   set) stages a 64 x 64 IoU tile through shared memory with coalesced
//   loads and writes mask[s, i, cb] = the 64-bit word of columns j > i in
//   column block cb with iou[s, i, j] > thresh.
//   Phase 2 (sequential): one warp per set sweeps i in order with the
//   "removed" bitmask held one 64-bit word per lane; keep_i is read with a
//   warp shuffle and, when it holds, each lane ORs row i's word into its
//   own.  The mask rows stream through shared memory 64 rows at a time.
// Sets are batched with blockIdx.y in both phases.
//
// Bound on the card: phase 1 reads the S x K x K f32 IoU once (bytes);
// phase 2 is a K-step dependency chain per set (latency), a few
// microseconds at K = 512.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TB = 64;          // boxes per tile side = bits per mask word
constexpr int MAX_WORDS = 32;   // one warp lane per mask word: K <= 2048

__global__ void __launch_bounds__(TB)
nms_mask_kernel(const float* __restrict__ iou, unsigned long long* __restrict__ mask,
                int K, int nblk, float thresh) {
  const int set = blockIdx.y;
  const int rb = blockIdx.x / nblk, cb = blockIdx.x % nblk;
  const int t = threadIdx.x;
  const int i = rb * TB + t;
  unsigned long long* out = mask + (size_t)set * K * nblk;
  if (cb < rb) {                // every column precedes every row: no bits
    if (i < K) out[(size_t)i * nblk + cb] = 0ull;
    return;
  }
  __shared__ float tile[TB][TB + 1];
  const float* base = iou + (size_t)set * K * K;
  const int col = cb * TB + t;
  for (int r = 0; r < TB; ++r) {
    const int row = rb * TB + r;
    tile[r][t] = (row < K && col < K) ? base[(size_t)row * K + col] : 0.f;
  }
  __syncthreads();
  if (i >= K) return;
  unsigned long long bits = 0ull;
  for (int c = 0; c < TB; ++c) {
    const int j = cb * TB + c;
    if (j < K && j > i && tile[t][c] > thresh) bits |= 1ull << c;
  }
  out[(size_t)i * nblk + cb] = bits;
}

__global__ void __launch_bounds__(32)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                 const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 int K, int nblk) {
  __shared__ unsigned long long rows[TB * MAX_WORDS];
  const int set = blockIdx.y;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)set * K * nblk;
  const uint8_t* v = valid + (size_t)set * K;
  uint8_t* kp = keep + (size_t)set * K;
  unsigned long long removed = 0ull;           // word `lane` of the bitmask
  for (int i0 = 0; i0 < K; i0 += TB) {
    const int n = min(TB, K - i0);
    for (int e = lane; e < n * nblk; e += 32) rows[e] = m[(size_t)i0 * nblk + e];
    __syncwarp();
    for (int r = 0; r < n; ++r) {
      const int i = i0 + r;
      const int word = i / TB;
      const unsigned long long w = __shfl_sync(0xffffffffu, removed, word);
      const bool k = v[i] && !((w >> (i % TB)) & 1ull);
      if (k && lane < nblk && lane >= word) removed |= rows[r * nblk + lane];
      if (lane == 0) kp[i] = k ? 1 : 0;
    }
    __syncwarp();
  }
}

}  // namespace

// iou: (S, K, K) f32; valid, keep: (S, K) u8; mask: (S, K, ceil(K/64)) u64
// scratch.  Requires 0 < K <= 2048.  Returns the cudaError_t of the launches.
extern "C" int q3d_greedy_nms(const void* iou, const void* valid, void* mask,
                              void* keep, int S, int K, float thresh,
                              void* stream) {
  if (S == 0 || K == 0) return 0;
  const int nblk = (K + TB - 1) / TB;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* mk = static_cast<unsigned long long*>(mask);
  nms_mask_kernel<<<dim3(nblk * nblk, S), TB, 0, s>>>(
      static_cast<const float*>(iou), mk, K, nblk, thresh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_sweep_kernel<<<dim3(1, S), 32, 0, s>>>(
      mk, static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K,
      nblk);
  return static_cast<int>(cudaGetLastError());
}
