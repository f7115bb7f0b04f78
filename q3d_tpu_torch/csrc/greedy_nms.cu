// Greedy NMS for Hopper (sm_90a): the rotated BEV IoU computed on chip,
// 64-bit suppression masks, and a blocked serial sweep.
//
// Replaces the TPU kernel q3d_tpu/ops/iou3d_nms/pallas_nms.py:45
// (greedy_suppress_pallas -> _nms_kernel).  For each set s of K boxes in
// descending score order it computes
//
//     keep[s, i] = valid[s, i] and not exists j < i: keep[s, j] and iou[s, j, i] > thresh
//
// with row j the suppressor, read exactly as the TPU kernel reads it.  Two
// entries share one sweep:
//   q3d_greedy_nms_boxes (the model's path) takes each box's BEV corners,
//     area and valid flag and computes iou[j, i] itself, in registers, tile
//     by tile: nothing of the (K, K) matrix is written to device memory.
//   q3d_greedy_nms (the TPU kernel's own function) takes the (S, K, K) f32
//     IoU matrix.
//
// Mask phase: mask[s, i, cb] is the 64-bit word of columns j > i in
// column block cb that row i suppresses, for tiles of 64 x 64 boxes with
// cb >= rb; words with cb < rb are never written or read.  The diagonal
// tile also writes the set's initial removed word cb (invalid columns and
// those past K), so that the sweep starts without reading valid.
//   Boxes form, two launches.  A: one block per (tile, set) tests the
//   tile's 4096 pairs (8 ops each) and lists the pairs to evaluate, zeroing
//   the tile's words.  A pair where either box is invalid sets no bit that
//   matters (the sweep removes invalid columns from the start and never
//   keeps an invalid row), so it is not listed.  For thresh >= 0 neither
//   is a pair whose circumscribed circles (inflated by 0.05% + 5 mm each)
//   are apart: the formula gives exactly 0 there, which is not above
//   thresh (pinned by tests/test_torch_port_nms.py and by chip_smoke.py,
//   which checks the plain IoU of every pair the kernel skipped).  B: a
//   grid-stride loop over each set's listed pairs evaluates one IoU per
//   lane and ORs its bit in with a global atomic.  Balancing over the whole
//   card matters: the duplicates of one object crowd one tile (1184 of a
//   set's pairs in one tile of the ref decode), and a block per tile left
//   that tile's block running five rounds of IoUs.
//   IoU form: one block per tile; 256 threads stage the IoU tile through
//   shared memory with coalesced loads; 64 of them assemble the words.
// Sweep (one launch, two warps per set), one 64-row block b at a time:
// warp 0's lane 0 resolves block b serially in registers (per row a bit
// test and a conditional OR of its diagonal word mask[i, b]: the chain),
// and in the chain's idle cycles ORs the kept rows' words into word
// b + 1, the one the next step needs.  Warp 1 meanwhile stages block b + 2
// into shared memory (16-byte cp.async), ORs block b - 1's kept rows into
// the later words and writes its keep flags.  One barrier per block.
//
// Exactness: the IoU is the port's plain formula (iou3d_nms_utils.py:
// Liang-Barsky clipping of each edge to the other quad's half-planes,
// shoelace terms about the mean of the suppressor's corners, the 1e-3
// collinear bias and the closed-boundary test) with every operation in the
// plain version's order: the 4-term sums and the mean are left-to-right in
// both.  Built with -fmad=false and IEEE division, so each result is
// bit-equal to boxes_iou_bev on the card.
//
// Operations of one IoU, counted from the formula (add, sub, mul, div,
// abs, min, max, compare and select each one op): the origin 8; each of
// the two clipped-edge passes 400 (edge vectors 8; 16 signed distances of
// 6 ops; 16 edge-by-half-plane crossings of 12 ops; 4 clipped edges of 26
// ops); the closing test and the division 13: 821 in all.  The circle
// test of a pair is 8 ops.
//
// What bounds each entry on this card.  The sweep is a chain of K
// dependent steps per set: latency, at least K x ~4 cycles (about 1 us at
// K = 512), and the bound of both entries at the ref decode's shapes.  The
// design takes each step down to a bit test and a conditional OR in one
// thread's registers, and moves every load, every OR that does not feed
// the chain, and the staging, to the other lanes and warp; the sweep
// still costs about 30 cycles a row (chip_smoke.py's sweep_cycles_per_row,
// its time from K = 512 to 2048), not 4.  The boxes form reads ~40 bytes a box and evaluates only the near
// pairs (operations well under the chain); the IoU form reads the valid
// pairs' 4-byte entries (bytes).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int TB = 64;          // boxes per tile side = bits per mask word
constexpr int MAX_WORDS = 32;   // one warp lane per mask word: K <= 2048
constexpr int MAX_TILES = MAX_WORDS * (MAX_WORDS + 1) / 2;  // per set
constexpr int BOX_THREADS = 256;
constexpr int IOU_BLOCKS = 64;          // boxes form, kernel B: per set
constexpr int SWEEP_BUFS = 4;           // sweep: staged row blocks
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void tile_of(int x, int nblk, int& rb, int& cb) {
  rb = 0;
  while (x >= nblk - rb) {
    x -= nblk - rb;
    ++rb;
  }
  cb = rb + x;
}

// ------------------------------------------------------------ boxes form

struct Quad {
  float x[4], y[4];
};

// Edge k of convex quad poly clipped to the inside of convex quad clip
// (Liang-Barsky): its shoelace contribution about (ox, oy) and its net
// traversal vector.  Every operation as in
// iou3d_nms_utils._clipped_edges_contrib, in its order; the caller sums
// the 4 edges left to right, as the plain version does.
__device__ __forceinline__ void clipped_edge(const Quad& p, const Quad& c,
                                             float ox, float oy, float bias,
                                             int k, float& con, float& dx,
                                             float& dy) {
  const int k2 = (k + 1) & 3;
  bool out = false;
  float t0 = 0.f, t1 = 1.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // scaled distances of the edge's ends inside c's edge e
    const float ex = c.x[(e + 1) & 3] - c.x[e];
    const float ey = c.y[(e + 1) & 3] - c.y[e];
    const float d1 = ex * (p.y[k] - c.y[e]) - ey * (p.x[k] - c.x[e]) - bias;
    const float d2 = ex * (p.y[k2] - c.y[e]) - ey * (p.x[k2] - c.x[e]) - bias;
    const bool enter = d1 < 0.f && d2 >= 0.f;
    const bool leave = d1 >= 0.f && d2 < 0.f;
    out = out || (d1 < 0.f && d2 < 0.f);
    float tc = 0.f;
    if (enter || leave) {
      const float den = d1 - d2;
      tc = d1 / (fabsf(den) < 1e-8f ? 1.f : den);
    }
    const float c0 = enter ? tc : 0.f, c1 = leave ? tc : 1.f;
    t0 = e == 0 ? c0 : fmaxf(t0, c0);
    t1 = e == 0 ? c1 : fminf(t1, c1);
  }
  const float kf = (out || t0 >= t1) ? 0.f : 1.f;
  const float ex = p.x[k2] - p.x[k], ey = p.y[k2] - p.y[k];
  const float rx = p.x[k] - ox, ry = p.y[k] - oy;
  const float q1x = (rx + t0 * ex) * kf, q1y = (ry + t0 * ey) * kf;
  const float q2x = (rx + t1 * ex) * kf, q2y = (ry + t1 * ey) * kf;
  con = 0.5f * (q1x * q2y - q1y * q2x);
  dx = q2x - q1x;
  dy = q2y - q1y;
}

// iou3d_nms_utils.boxes_iou_bev for one pair, a the row (suppressor) box
// and (ox, oy) the mean of its corners: a's edges clipped to b, then b's
// to a, each pass summed over its 4 edges left to right.
__device__ __forceinline__ float pair_iou(const Quad& a, float ox, float oy,
                                          float area_a, const Quad& b,
                                          float area_b) {
  float a1, v1x, v1y, a2, v2x, v2y;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float con, dx, dy;
    clipped_edge(a, b, ox, oy, 0.f, k, con, dx, dy);
    a1 = k ? a1 + con : con;
    v1x = k ? v1x + dx : dx;
    v1y = k ? v1y + dy : dy;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float con, dx, dy;
    clipped_edge(b, a, ox, oy, 1e-3f, k, con, dx, dy);
    a2 = k ? a2 + con : con;
    v2x = k ? v2x + dx : dx;
    v2y = k ? v2y + dy : dy;
  }
  const float vx = v1x + v2x, vy = v1y + v2y;
  const float s = a1 + a2;
  const float overlap = (fabsf(vx) + fabsf(vy) < 1e-2f && s > 0.f) ? s : 0.f;
  return overlap / fmaxf(area_a + area_b - overlap, 1e-6f);
}

// The mean of quad q's corners, left to right as the plain version's
// origin.
__device__ __forceinline__ void origin(const Quad& q, float& ox, float& oy) {
  ox = (((q.x[0] + q.x[1]) + q.x[2]) + q.x[3]) * 0.25f;
  oy = (((q.y[0] + q.y[1]) + q.y[2]) + q.y[3]) * 0.25f;
}

// The origin and the circumscribed radius, inflated for the skip.
__device__ __forceinline__ void circle(const Quad& q, float& ox, float& oy,
                                       float& r) {
  origin(q, ox, oy);
  float r2 = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = q.x[k] - ox, dy = q.y[k] - oy;
    r2 = fmaxf(r2, dx * dx + dy * dy);
  }
  r = sqrtf(r2) * 1.0005f + 0.005f;
}

__device__ __forceinline__ Quad load_quad(const float* __restrict__ corners,
                                          int i) {
  const float* c = corners + (size_t)i * 8;
  Quad q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q.x[k] = c[2 * k];
    q.y[k] = c[2 * k + 1];
  }
  return q;
}

// The removed bits a set starts from, word cb: its invalid columns and those
// past K.  Written by the diagonal tile's block from 64 flags (t < 64).
__device__ __forceinline__ void write_init(unsigned long long* __restrict__ init,
                                           int t, bool gone) {
  const unsigned bits = __ballot_sync(FULL, gone);
  if ((t & 31) == 0) reinterpret_cast<unsigned*>(init)[t >> 5] = bits;
}

// Exclusive prefix sum over a block of BOX_THREADS threads; -> total.
__device__ __forceinline__ int block_scan(int v, int& excl, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < BOX_THREADS / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    total += warp_sums[w];
  }
  excl = before + incl - v;
  return total;
}

// Boxes form, kernel A: one block per (tile, set).  Tests the tile's pairs
// and lists those to evaluate (j > i, both valid, circles not apart when
// thresh >= 0) in list[set, tile], with their count; zeroes the tile's
// mask words (kernel B ORs into them) and, on the diagonal, writes the
// set's initial removed word.
__global__ void __launch_bounds__(BOX_THREADS)
nms_box_pairs_kernel(const float* __restrict__ corners,
                     const uint8_t* __restrict__ valid,
                     unsigned long long* __restrict__ mask,
                     unsigned long long* __restrict__ init,
                     int* __restrict__ counts, uint16_t* __restrict__ list,
                     int K, int nblk, bool skip_far) {
  __shared__ float sx[2][TB], sy[2][TB], sr[2][TB];
  __shared__ int sok[2][TB];
  __shared__ int npairs;
  const int set = blockIdx.y, tile = blockIdx.x;
  const int ntiles = nblk * (nblk + 1) / 2;
  int rb, cb;
  tile_of(tile, nblk, rb, cb);
  const int t = threadIdx.x, lane = t & 31;
  if (t < 2 * TB) {                  // side 0: the tile's rows, 1: columns
    const int side = t / TB, k = t % TB;
    const int i = (side ? cb : rb) * TB + k;
    const bool ok = i < K && valid[(size_t)set * K + i];
    if (ok)
      circle(load_quad(corners + (size_t)set * K * 8, i), sx[side][k],
             sy[side][k], sr[side][k]);
    sok[side][k] = ok;
    if (side == 0 && i < K)
      mask[((size_t)set * nblk * TB + i) * nblk + cb] = 0ull;
    if (side == 1 && rb == cb) write_init(init + (size_t)set * nblk + cb, k, !ok);
  }
  if (t == 0) npairs = 0;
  __syncthreads();
  constexpr int PER_THREAD = TB * TB / BOX_THREADS;
  unsigned take = 0u;                // bit m: pair m * BOX_THREADS + t
#pragma unroll
  for (int m = 0; m < PER_THREAD; ++m) {
    const int p = m * BOX_THREADS + t, r = p / TB, c = p % TB;
    bool ok = cb * TB + c > rb * TB + r && sok[0][r] && sok[1][c];
    if (ok && skip_far) {
      const float dx = sx[1][c] - sx[0][r], dy = sy[1][c] - sy[0][r];
      const float rr = sr[0][r] + sr[1][c];
      ok = dx * dx + dy * dy <= rr * rr;
    }
    take |= static_cast<unsigned>(ok) << m;
  }
  // this lane's slots: an exclusive scan of the counts over the warp, and
  // one shared atomic per warp
  const int cnt = __popc(take);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(&npairs, incl);
  int slot = __shfl_sync(FULL, base, 31) + incl - cnt;
  uint16_t* out = list + ((size_t)set * ntiles + tile) * TB * TB;
  for (; take; take &= take - 1u)
    out[slot++] = static_cast<uint16_t>((__ffs(take) - 1) * BOX_THREADS + t);
  __syncthreads();
  if (t == 0) counts[(size_t)set * ntiles + tile] = npairs;
}

// Boxes form, kernel B: a grid-stride loop over all of a set's listed
// pairs (blockIdx.y = set), so that pairs crowded into one tile, as the
// duplicates of one object are, spread over the whole card.  One IoU per
// lane per pass; each bit is ORed into its word with a global atomic.
__global__ void __launch_bounds__(BOX_THREADS)
nms_box_iou_kernel(const float* __restrict__ corners,
                   const float* __restrict__ areas,
                   const int* __restrict__ counts,
                   const uint16_t* __restrict__ list,
                   unsigned long long* __restrict__ mask,
                   float* __restrict__ iou_out, int K, int nblk, float thresh) {
  constexpr int PER_THREAD = (MAX_TILES + BOX_THREADS - 1) / BOX_THREADS;
  __shared__ int start[PER_THREAD * BOX_THREADS + 1];
  __shared__ int warp_sums[BOX_THREADS / 32];
  const int set = blockIdx.y, t = threadIdx.x;
  const int ntiles = nblk * (nblk + 1) / 2;
  const int* cnt = counts + (size_t)set * ntiles;
  int v[PER_THREAD], sum = 0;        // tiles PER_THREAD * t + k
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int tl = PER_THREAD * t + k;
    v[k] = tl < ntiles ? cnt[tl] : 0;
    sum += v[k];
  }
  int excl;
  const int total = block_scan(sum, excl, warp_sums);
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    start[PER_THREAD * t + k] = excl;
    excl += v[k];
  }
  __syncthreads();
  const float* cs = corners + (size_t)set * K * 8;
  const float* ar = areas + (size_t)set * K;
  for (int e = blockIdx.x * BOX_THREADS + t; e < total;
       e += gridDim.x * BOX_THREADS) {
    int lo = 0, hi = ntiles - 1;     // the last tile starting at or before e
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (start[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const int p = list[((size_t)set * ntiles + lo) * TB * TB + e - start[lo]];
    int rb, cb;
    tile_of(lo, nblk, rb, cb);
    const int i = rb * TB + p / TB, j = cb * TB + p % TB;
    const Quad a = load_quad(cs, i), b = load_quad(cs, j);
    float ox, oy;
    origin(a, ox, oy);
    const float iou = pair_iou(a, ox, oy, ar[i], b, ar[j]);
    if (iou > thresh)
      atomicOr(&mask[((size_t)set * nblk * TB + i) * nblk + cb],
               1ull << (p % TB));
    if (iou_out) iou_out[((size_t)set * K + i) * K + j] = iou;
  }
}

// -------------------------------------------------------------- IoU form

constexpr int IOU_THREADS = 256;

__global__ void __launch_bounds__(IOU_THREADS)
nms_iou_mask_kernel(const float* __restrict__ iou,
                    const uint8_t* __restrict__ valid,
                    unsigned long long* __restrict__ mask,
                    unsigned long long* __restrict__ init, int K, int nblk,
                    float thresh) {
  __shared__ float tile[TB][TB + 1];
  const int set = blockIdx.y;
  int rb, cb;
  tile_of(blockIdx.x, nblk, rb, cb);
  const int t = threadIdx.x;
  const float* base = iou + (size_t)set * K * K;
  const int col = cb * TB + t % TB;
#pragma unroll
  for (int r = t / TB; r < TB; r += IOU_THREADS / TB) {
    const int row = rb * TB + r;
    tile[r][t % TB] = (row < K && col < K) ? base[(size_t)row * K + col] : 0.f;
  }
  if (rb == cb && t < TB)
    write_init(init + (size_t)set * nblk + cb, t,
               col >= K || !valid[(size_t)set * K + col]);
  __syncthreads();
  const int i = rb * TB + t;
  if (t >= TB || i >= K) return;
  unsigned long long bits = 0ull;
  for (int c = 0; c < TB; ++c) {
    const int j = cb * TB + c;
    if (j < K && j > i && tile[t][c] > thresh) bits |= 1ull << c;
  }
  mask[((size_t)set * nblk * TB + i) * nblk + cb] = bits;
}

// ----------------------------------------------------------------- sweep

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One block of two warps per set.  Row block b's mask rows (64 x nblk
// words, contiguous) are staged in shared memory two blocks ahead.  In
// step b, warp 0's lane 0 resolves block b: removed word b, then per row a
// bit test and a conditional OR of the row's diagonal word, the only chain
// of the sweep; in the same pass, in the chain's idle cycles, it ORs
// the kept rows' words for word b + 1, which step b + 1 needs next.
// Meanwhile warp 1 stages block b + 2, ORs block b - 1's kept rows into
// words >= b + 1 and writes block b - 1's keep flags.
__global__ void __launch_bounds__(64)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                 const unsigned long long* __restrict__ init,
                 uint8_t* __restrict__ keep, int K, int nblk) {
  extern __shared__ __align__(16) unsigned long long rows[];
  __shared__ unsigned long long removed[MAX_WORDS], kept_w[MAX_WORDS];
  const int set = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = TB * nblk;                 // one row block's words
  const unsigned long long* m = mask + (size_t)set * nblk * words;
  uint8_t* kp = keep + (size_t)set * K;

  auto stage = [&](int b) {                    // warp 1
    if (b < nblk) {
      const unsigned long long* src = m + (size_t)b * words;
      unsigned long long* dst = rows + (b % SWEEP_BUFS) * words;
      for (int e = 2 * lane; e < words; e += 64) cp_async16(dst + e, src + e);
    }
    cp_async_commit();                         // one group per block, even empty
  };
  if (warp == 1) {
    if (lane < nblk) removed[lane] = init[(size_t)set * nblk + lane];
    stage(0);
    stage(1);
    cp_async_wait<1>();
  }
  __syncthreads();
  unsigned long long next = 0ull;              // block b - 1's ORs into word b
  for (int b = 0; b <= nblk; ++b) {
    if (warp == 0) {
      if (lane == 0 && b < nblk) {
        // rows past K read stale words, but their bits are already removed
        const unsigned long long* R = rows + (b % SWEEP_BUFS) * words;
        const int b1 = b + 1 < nblk ? b + 1 : b;
        const unsigned long long rem = removed[b] | next;
        unsigned lo = static_cast<unsigned>(rem);
        unsigned hi = static_cast<unsigned>(rem >> 32);
        unsigned nlo = 0u, nhi = 0u;
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          const unsigned long long d = R[r * nblk + b], e = R[r * nblk + b1];
          // all ones if row r is still in (kept), else 0
          const unsigned in = ((r < 32 ? lo >> r : hi >> (r - 32)) & 1u) - 1u;
          if (r < 32) lo |= static_cast<unsigned>(d) & in;
          hi |= static_cast<unsigned>(d >> 32) & in;
          nlo |= static_cast<unsigned>(e) & in;
          nhi |= static_cast<unsigned>(e >> 32) & in;
        }
        kept_w[b] = ~((static_cast<unsigned long long>(hi) << 32) | lo);
        next = b + 1 < nblk ? (static_cast<unsigned long long>(nhi) << 32) | nlo
                            : 0ull;
      }
    } else {
      stage(b + 2);
      if (b > 0) {
        const int pb = b - 1;
        const unsigned long long* R = rows + (pb % SWEEP_BUFS) * words;
        const unsigned long long kept = kept_w[pb];
        if (lane > b && lane < nblk) {
          unsigned long long acc[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
          for (int r = 0; r < TB; ++r)
            acc[r & 3] |= R[r * nblk + lane] & (0ull - ((kept >> r) & 1ull));
          removed[lane] |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
        }
        const int i0 = pb * TB;
        for (int r = lane; r < TB && i0 + r < K; r += 32)
          kp[i0 + r] = static_cast<uint8_t>((kept >> r) & 1ull);
      }
      cp_async_wait<1>();                      // block b + 1 has landed
    }
    __syncthreads();
  }
}

int launch_sweep(const unsigned long long* mask, const unsigned long long* init,
                 void* keep, int S, int K, int nblk, cudaStream_t s) {
  const int smem = SWEEP_BUFS * TB * nblk * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_sweep_kernel<<<S, 64, smem, s>>>(mask, init,
                                       static_cast<uint8_t*>(keep), K, nblk);
  return static_cast<int>(cudaGetLastError());
}

struct Scratch {
  unsigned long long *mask, *init;
  int* counts;
  uint16_t* list;
};

// Scratch layout (u64 words from a 16-byte aligned base): mask (S, 64 *
// nblk, nblk), row i of a set at i (rows past K unused); init (S, nblk);
// for the boxes form also counts (S, ntiles) int32 and list (S, ntiles,
// 64 * 64) uint16.  nblk = ceil(K / 64), ntiles = nblk (nblk + 1) / 2.
size_t scratch_layout(void* base, int S, int K, bool boxes, Scratch* out) {
  const size_t nblk = (K + TB - 1) / TB, ntiles = nblk * (nblk + 1) / 2;
  const size_t mask_w = S * TB * nblk * nblk, init_w = S * nblk;
  const size_t count_w = (S * ntiles + 1) / 2, list_w = S * ntiles * TB * TB / 4;
  if (out) {
    auto* w = static_cast<unsigned long long*>(base);
    out->mask = w;
    out->init = w + mask_w;
    out->counts = reinterpret_cast<int*>(w + mask_w + init_w);
    out->list = reinterpret_cast<uint16_t*>(w + mask_w + init_w + count_w);
  }
  return mask_w + init_w + (boxes ? count_w + list_w : 0);
}

}  // namespace

// The scratch, in 8-byte words, that entry `boxes` (1) or the IoU form (0)
// needs for S sets of K boxes.
extern "C" long long q3d_greedy_nms_scratch_words(int S, int K, int boxes) {
  return static_cast<long long>(scratch_layout(nullptr, S, K, boxes, nullptr));
}

// corners: (S, K, 4, 2) f32; areas: (S, K) f32; valid, keep: (S, K) u8;
// scratch: q3d_greedy_nms_scratch_words(S, K, 1) words; iou_out: (S, K, K)
// f32 or null, written only at the pairs the kernel evaluated.  Requires
// 0 < K <= 2048 and a 16-byte aligned scratch.  Returns the cudaError_t
// of the launches.
extern "C" int q3d_greedy_nms_boxes(const void* corners, const void* areas,
                                    const void* valid, void* scratch,
                                    void* keep, void* iou_out, int S, int K,
                                    float thresh, void* stream) {
  if (S == 0 || K == 0) return 0;
  const int nblk = (K + TB - 1) / TB, ntiles = nblk * (nblk + 1) / 2;
  const auto s = static_cast<cudaStream_t>(stream);
  Scratch w;
  scratch_layout(scratch, S, K, true, &w);
  const auto* cs = static_cast<const float*>(corners);
  nms_box_pairs_kernel<<<dim3(ntiles, S), BOX_THREADS, 0, s>>>(
      cs, static_cast<const uint8_t*>(valid), w.mask, w.init, w.counts,
      w.list, K, nblk, thresh >= 0.f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pairs = (long long)K * (K - 1) / 2;
  const int blocks = static_cast<int>(
      std::min<long long>(IOU_BLOCKS, (pairs + BOX_THREADS - 1) / BOX_THREADS));
  nms_box_iou_kernel<<<dim3(std::max(blocks, 1), S), BOX_THREADS, 0, s>>>(
      cs, static_cast<const float*>(areas), w.counts, w.list, w.mask,
      static_cast<float*>(iou_out), K, nblk, thresh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_sweep(w.mask, w.init, keep, S, K, nblk, s);
}

// iou: (S, K, K) f32; valid, keep: (S, K) u8; scratch:
// q3d_greedy_nms_scratch_words(S, K, 0) words.  Requires 0 < K <= 2048
// and a 16-byte aligned scratch.  Returns the cudaError_t of the launches.
extern "C" int q3d_greedy_nms(const void* iou, const void* valid,
                              void* scratch, void* keep, int S, int K,
                              float thresh, void* stream) {
  if (S == 0 || K == 0) return 0;
  const int nblk = (K + TB - 1) / TB;
  const auto s = static_cast<cudaStream_t>(stream);
  Scratch w;
  scratch_layout(scratch, S, K, false, &w);
  nms_iou_mask_kernel<<<dim3(nblk * (nblk + 1) / 2, S), IOU_THREADS, 0, s>>>(
      static_cast<const float*>(iou), static_cast<const uint8_t*>(valid),
      w.mask, w.init, K, nblk, thresh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_sweep(w.mask, w.init, keep, S, K, nblk, s);
}
