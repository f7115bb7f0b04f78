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
// f32 and bf16 accumulate in f32; s8 x s8 accumulates in s32 (exact) and the
// epilogue runs in f32, in the plain version's order (scale, then valid).
//
// What bounds it on the H100.  At the CenterPoint backbone's widths
// (Cin, Cout <= 128) a conv moves a few tens of MB (the rows its book uses,
// the book, the weights, the output) and does at most ~40 GFLOP on the
// present taps, so the least time is set by bytes at every width (within
// 2.5x of the operations only at 128 -> 128).  What a kernel actually runs
// into is the latency of gathering scattered rows, the per-tap overhead on
// the narrow convs, and -- once the product is on tensor cores -- the shared
// memory reads that feed them.  Measured on the H100 (PERF.md): the whole
// backbone's 21 convs take about 8x their bound; at 128 -> 128 s8, with
// half the shared-memory bytes per multiply, runs about 1.6x faster than
// bf16, so there the ldmatrix reads bound the kernel, and at the narrow
// widths the per-step latency does.
//
// Design, per block of BM = 128 output rows x all of Cout (no column
// blocks, so every row is gathered once and W[k] is read once per 128 rows):
//   1. the tile's (BM, K) block of the book is loaded once into shared
//      memory, coalesced; out-of-range entries become -1.  Warp ballots give
//      each warp's tap mask over its rows; the block walks only the taps
//      some row hits, and a warp skips the product of a tap none of its rows
//      hits;
//   2. a step is (tap, Cin slice of at most 128 bytes).  Its gathered rows
//      (16-byte cp.async, zero-fill for misses) and its W[k] slice (16-byte
//      cp.async of a plain 2-D tile) go into a shared-memory ring of 3
//      stages (2 where 3 would leave room for one block per SM, as at
//      128 -> 128); each step's copies start NSTAGE - 1 steps ahead,
//      right before an earlier step multiplies, so they overlap it.  Rows
//      are padded to an odd number of 16-byte units, which makes every
//      ldmatrix phase (8 rows x 16 bytes) hit 8 distinct 16-byte bank groups
//      at every Cin and Cout from 16 to 128;
//   3. bf16 runs mma.sync.m16n8k16 (f32 accumulators), s8 runs
//      mma.sync.m16n8k32 (s32 accumulators, bit-exact).  A warp owns 16
//      rows x Cout, or 32 rows x Cout/2 at Cout >= 64, so that B fragments
//      are read once per 32 rows.  A fragments come from ldmatrix, B from
//      ldmatrix.trans on the (Cin, Cout) weight tile; for s8 the 16-bit
//      transpose pairs are re-sorted with byte permutes into k-contiguous
//      fragments of an even and an odd column tile.  mma.sync rather than
//      wgmma: the kernel is bytes- and latency-bound, and mma.sync's rate is
//      more than 10x what the work needs, while it keeps per-warp tap
//      skipping and a 16- or 32-row warp tile;
//   4. f32 has no exact tensor-core path (TF32 breaks the f32 tolerance), so
//      f32 keeps the same tile, book, ring and epilogue and multiplies on
//      CUDA cores (an explicit dtype branch, not a fallback);
//   5. the epilogue scales and masks in f32, stages the tile through shared
//      memory and stores 16 bytes a thread;
//   6. the s8 requant entry (int8 residency) stages the scaled f32 tile
//      instead, and each thread then takes 16 consecutive outputs of a row:
//      BN fold (y * k + b), the residual (an s8 identity times its scale,
//      or an f32 one, read 16 at a time), ReLU, the row mask and the
//      per-tensor requant clip(rint(y / s), -127, 127), then one 16-byte
//      store.  That is q3d_tpu/ops/spconv/modules.py:397-416 op for op; the
//      build has -fmad=false and IEEE division (nvcc's default), so the s8
//      rows are bit-equal to the plain version's.  Fusing it keeps the f32
//      rows (4 B an element, against 1) and five elementwise passes over
//      them out of device memory.
// Instances: Cin, Cout in {16, 32, 64, 128}; K <= 27 at run time (27 for
// the 3x3x3 convs, 3 for conv_out).  Built once per entry: -DQ3D_GC_F32,
// -DQ3D_GC_BF16, -DQ3D_GC_S8 or -DQ3D_GC_S8_REQUANT selects the function a
// build exports, so the four builds run in parallel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KMAX = 27;         // most taps a book row may have
constexpr int SMEM_PER_SM = 228 * 1024;   // shared memory per SM

// the requant entry's epilogue operands (all device pointers; a null
// row_valid keeps every row, at most one of id_s8 / id_f32 is set)
struct Epilogue {
  const float* k;            // (Cout,) BN fold scale
  const float* b;            // (Cout,) BN fold shift
  const uint8_t* row_valid;  // (M,)
  const int8_t* id_s8;       // (M, Cout) s8 identity ...
  const float* id_scale;     // ... and its scale (one value)
  const float* id_f32;       // (M, Cout) f32 identity
  const float* s;            // the requant scale (one value)
};

template <typename T, int CIN, int COUT, bool RQ = false>
struct Cfg {
  static constexpr int ES = sizeof(T);
  static constexpr bool TC = !std::is_same<T, float>::value;   // tensor cores
  using Out = std::conditional_t<
      RQ, int8_t,
      std::conditional_t<std::is_same<T, __nv_bfloat16>::value, __nv_bfloat16,
                         float>>;
  // the epilogue stages the tile in the output type, or in f32 for requant
  using Stage = std::conditional_t<RQ, float, Out>;
  using Acc = std::conditional_t<std::is_same<T, int8_t>::value, int, float>;
  static constexpr int KC = CIN * ES > 128 ? 128 / ES : CIN;   // Cin per step
  static constexpr int NSL = CIN / KC;                          // steps per tap
  // mma depth is 32 bytes: s8 at Cin 16 pads its 16-byte rows with zeros
  static constexpr int KCP = (TC && KC * ES < 32) ? 32 / ES : KC;
  // warp tile: 16 rows x Cout, or (tensor cores, Cout >= 64) 32 rows x
  // Cout/2, where two A fragments share each B fragment: a fifth to a
  // third fewer ldmatrix reads of shared memory per mma
  static constexpr int WC = (TC && COUT >= 64) ? 2 : 1;   // warps across Cout
  static constexpr int RW = BM * WC / WARPS;               // rows per warp
  static constexpr int MT = RW / 16, CW = COUT / WC;
  // an odd number of 16-byte units per row: 8 consecutive rows fall in 8
  // distinct 16-byte bank groups
  static constexpr int A_PITCH = ((KCP * ES / 16) | 1) * 16;
  static constexpr int W_PITCH = ((COUT * ES / 16) | 1) * 16;
  static constexpr int A_BYTES = BM * A_PITCH;
  static constexpr int STAGE_BYTES = A_BYTES + KCP * W_PITCH;
  static constexpr int O_PITCH = ((COUT * (int)sizeof(Stage) / 16) | 1) * 16;
  static constexpr int BOOK_BYTES = BM * KMAX * 4;
  // cp.async ring depth: 3 stages, or 2 where 3 would leave room for only
  // one block per SM (no other block to hide a step's barrier behind)
  static constexpr int NSTAGE =
      2 * (BOOK_BYTES + 3 * STAGE_BYTES + 1024) <= SMEM_PER_SM ? 3 : 2;
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES > BM * O_PITCH
                                        ? NSTAGE * STAGE_BYTES : BM * O_PITCH;
  static constexpr int SMEM = BOOK_BYTES + RING_BYTES;
  static_assert(CIN % 16 == 0 && COUT % 16 == 0 && (KC * ES) % 16 == 0, "");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills (src must still be valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared-memory row of weight row k.  s8 keeps each 32-row depth step as
// k = {0,1,4,5,..,12,13}, {2,3,6,7,..,14,15}, then the same + 16, so that
// every ldmatrix.trans phase of its B fragments reads 8 consecutive rows
template <typename T>
__device__ __forceinline__ int w_row(int k) {
  if constexpr (std::is_same<T, int8_t>::value)
    return (k & ~15) | ((k >> 1) & 1) << 3 | ((k >> 2) & 3) << 1 | (k & 1);
  else
    return k;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int CIN, int COUT, bool RQ>
__global__ void __launch_bounds__(THREADS)
gather_conv_kernel(const T* __restrict__ feat, const int32_t* __restrict__ idx,
                   const T* __restrict__ w, const float* __restrict__ scale,
                   const uint8_t* __restrict__ valid,
                   typename Cfg<T, CIN, COUT, RQ>::Out* __restrict__ out,
                   int N, int M, int K, Epilogue ep) {
  using C = Cfg<T, CIN, COUT, RQ>;
  using Out = typename C::Out;
  using Stage = typename C::Stage;
  using Acc = typename C::Acc;
  constexpr int ES = C::ES, KC = C::KC, NSL = C::NSL;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t warp_mask[WARPS];
  __shared__ int taps[32];
  __shared__ int ntaps;
  int* book = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + C::BOOK_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = warp / C::WC * C::RW;        // the warp's first row
  const int pb = warp % C::WC * C::CW / 16;   // its first 16-column block
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0);

  // 1. the tile's book, once and coalesced; misses become -1
  const int32_t* gidx = idx + (size_t)m0 * K;
  for (int e = tid; e < BM * K; e += THREADS) {
    int r = e < rows * K ? gidx[e] : -1;
    book[e] = (r >= 0 && r < N) ? r : -1;
  }
  if (C::TC && C::KCP != KC) {     // zero the depth padding once (s8, Cin 16)
    for (int e = tid; e < C::RING_BYTES / 16; e += THREADS)
      reinterpret_cast<int4*>(ring)[e] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  uint32_t my_mask = 0;
  for (int k = 0; k < K; ++k) {
    const int r = book[(rb + lane % C::RW) * K + k];
    if (__ballot_sync(0xffffffffu, r >= 0)) my_mask |= 1u << k;
  }
  if (lane == 0) warp_mask[warp] = my_mask;
  __syncthreads();
  if (tid == 0) {
    uint32_t any = 0;
    for (int i = 0; i < WARPS; ++i) any |= warp_mask[i];
    int n = 0;
    for (int k = 0; k < K; ++k)
      if (any >> k & 1) taps[n++] = k;
    ntaps = n;
  }
  __syncthreads();
  const int nsteps = ntaps * NSL;

  // 2. one step = (tap, Cin slice): gathered rows + the W[k] slice
  auto load_step = [&](int s) {
    unsigned char* sa = ring + (s % C::NSTAGE) * C::STAGE_BYTES;
    unsigned char* sw = sa + C::A_BYTES;
    const int tap = taps[s / NSL], c0 = (s % NSL) * KC;
    constexpr int ACH = KC * ES / 16;
    for (int e = tid; e < BM * ACH; e += THREADS) {
      const int r = e / ACH, c = e % ACH;
      const int src = book[r * K + tap];
      const unsigned char* g = reinterpret_cast<const unsigned char*>(feat);
      if (src >= 0) g += ((size_t)src * CIN + c0) * ES + c * 16;
      cp_async16(sa + r * C::A_PITCH + c * 16, g, src >= 0 ? 16 : 0);
    }
    constexpr int WCH = COUT * ES / 16;
    const unsigned char* wk = reinterpret_cast<const unsigned char*>(w)
                              + ((size_t)tap * CIN + c0) * COUT * ES;
    for (int e = tid; e < KC * WCH; e += THREADS) {
      const int r = e / WCH, c = e % WCH;
      cp_async16(sw + w_row<T>(r) * C::W_PITCH + c * 16,
                 wk + (size_t)r * COUT * ES + c * 16, 16);
    }
  };

  // accumulators: tensor cores keep MT x (CW/8 tiles) x 4 per thread; the
  // f32 CUDA-core path keeps 8 rows x Cout/16 columns per thread
  constexpr int MT = C::TC ? C::MT : 1;
  constexpr int NT = C::TC ? C::CW / 8 : 8;
  constexpr int NJ = C::TC ? 4 : COUT / 16;
  Acc acc[MT][NT][NJ];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[mt][i][j] = Acc(0);

#pragma unroll
  for (int s = 0; s < C::NSTAGE - 1; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<C::NSTAGE - 2>();
    __syncthreads();
    // the stage this fills was read in the previous step, before the barrier
    if (s + C::NSTAGE - 1 < nsteps) load_step(s + C::NSTAGE - 1);
    cp_async_commit();
    if (my_mask >> taps[s / NSL] & 1) {
      const unsigned char* sa = ring + (s % C::NSTAGE) * C::STAGE_BYTES;
      const unsigned char* sw = sa + C::A_BYTES;
      if constexpr (C::TC) {
        // 3. tensor cores: per 32-byte depth step, MT A fragments (16 rows
        //    each) and CW/16 B fragment pairs
#pragma unroll
        for (int ks = 0; ks < C::KCP * ES / 32; ++ks) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], sa + (rb + mt * 16 + (lane & 15)) * C::A_PITCH
                               + ks * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int p = 0; p < C::CW / 16; ++p) {
            const int pc = pb + p;
            uint32_t b[4];
            if constexpr (std::is_same<T, int8_t>::value) {
              // matrices of k rows {0,1,4,5,..}, {2,3,6,7,..} (+16 for b1),
              // stored consecutively (w_row): each 16-bit transpose pair
              // holds 2 k x 2 columns; byte permutes make k-contiguous
              // fragments of columns 2j (even tile) and 2j+1 (odd tile)
              ldsm_x4_t(b, sw + (ks * 32 + lane) * C::W_PITCH + pc * 16);
              const uint32_t e0 = __byte_perm(b[0], b[1], 0x6420);
              const uint32_t e1 = __byte_perm(b[2], b[3], 0x6420);
              const uint32_t o0 = __byte_perm(b[0], b[1], 0x7531);
              const uint32_t o1 = __byte_perm(b[2], b[3], 0x7531);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma(acc[mt][2 * p], a[mt], e0, e1);
                mma(acc[mt][2 * p + 1], a[mt], o0, o1);
              }
            } else {
              const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
              ldsm_x4_t(b, sw + kr * C::W_PITCH + pc * 32 + (lane >> 4) * 16);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma(acc[mt][2 * p], a[mt], b[0], b[1]);
                mma(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
              }
            }
          }
        }
      } else {
        // 4. f32 on CUDA cores: thread (ty, tx) owns rows ty*8.. and
        //    columns tx + 16 j (ty's 8 rows lie in the warp's 16)
        const float* A = reinterpret_cast<const float*>(sa);
        const float* W = reinterpret_cast<const float*>(sw);
        const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          float av[NT], bv[NJ];
#pragma unroll
          for (int i = 0; i < NT; ++i)
            av[i] = A[(ty * 8 + i) * (C::A_PITCH / 4) + kk];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            bv[j] = W[kk * (C::W_PITCH / 4) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              acc[0][i][j] = fmaf(av[i], bv[j], acc[0][i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. epilogue: scale, then valid, in f32; stage the tile in shared memory
  Stage* so = reinterpret_cast<Stage*>(ring);
  constexpr int OP = C::O_PITCH / (int)sizeof(Stage);
  auto emit = [&](int r, int n, Acc a) {
    float v = static_cast<float>(a);
    if (scale != nullptr) v *= scale[n];
    const int m = m0 + r;
    v *= (m >= M || valid == nullptr || valid[m]) ? 1.f : 0.f;
    put(so + r * OP + n, v);
  };
  if constexpr (C::TC) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int p = 0; p < C::CW / 16; ++p) {
        const int n = 16 * (pb + p);
#pragma unroll
        for (int h = 0; h < 2; ++h) {          // rows g and g + 8
          const int r = rb + mt * 16 + g + 8 * h;
          const Acc* ev = acc[mt][2 * p];
          const Acc* od = acc[mt][2 * p + 1];
          if constexpr (std::is_same<T, int8_t>::value) {
            // even tile: columns 4t, 4t + 2; odd tile: 4t + 1, 4t + 3
            emit(r, n + 4 * t, ev[2 * h]);
            emit(r, n + 4 * t + 1, od[2 * h]);
            emit(r, n + 4 * t + 2, ev[2 * h + 1]);
            emit(r, n + 4 * t + 3, od[2 * h + 1]);
          } else {
            emit(r, n + 2 * t, ev[2 * h]);
            emit(r, n + 2 * t + 1, ev[2 * h + 1]);
            emit(r, n + 8 + 2 * t, od[2 * h]);
            emit(r, n + 8 + 2 * t + 1, od[2 * h + 1]);
          }
        }
      }
    }
  } else {
    const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) emit(ty * 8 + i, tx + 16 * j, acc[0][i][j]);
  }
  __syncthreads();
  if constexpr (!RQ) {
    constexpr int OCH = COUT * (int)sizeof(Out) / 16;
    unsigned char* gout = reinterpret_cast<unsigned char*>(out)
                          + (size_t)m0 * COUT * sizeof(Out);
    for (int e = tid; e < rows * OCH; e += THREADS) {
      const int r = e / OCH, c = e % OCH;
      *reinterpret_cast<int4*>(gout + (size_t)r * COUT * sizeof(Out) + c * 16) =
          *reinterpret_cast<const int4*>(ring + r * C::O_PITCH + c * 16);
    }
  } else {
    // 6. the fused residency epilogue, 16 outputs of a row per thread, each
    //    op rounded on its own in the plain version's order
    constexpr int OCH = COUT / 16;
    const float s = *ep.s;
    const float ids = ep.id_s8 != nullptr ? *ep.id_scale : 0.f;
    for (int e = tid; e < rows * OCH; e += THREADS) {
      const int r = e / OCH, c0 = (e % OCH) * 16;
      const size_t at = (size_t)(m0 + r) * COUT + c0;
      const float* y = reinterpret_cast<const float*>(ring + r * C::O_PITCH) + c0;
      const float rv =
          (ep.row_valid == nullptr || ep.row_valid[m0 + r]) ? 1.f : 0.f;
      alignas(16) int8_t id8[16];
      if (ep.id_s8 != nullptr)
        *reinterpret_cast<int4*>(id8) =
            *reinterpret_cast<const int4*>(ep.id_s8 + at);
      alignas(16) int8_t q[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v = y[j] * ep.k[c0 + j];
        v = v + ep.b[c0 + j];
        if (ep.id_s8 != nullptr)
          v = v + static_cast<float>(id8[j]) * ids;
        else if (ep.id_f32 != nullptr)
          v = v + ep.id_f32[at + j];
        v = fmaxf(v, 0.f);
        v = v * rv;
        q[j] = static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
      }
      *reinterpret_cast<int4*>(out + at) = *reinterpret_cast<const int4*>(q);
    }
  }
}

template <typename T, int CIN, int COUT, bool RQ>
int launch_one(const void* feat, const void* idx, const void* w,
               const void* scale, const void* valid, void* out, int N, int M,
               int K, const Epilogue& ep, cudaStream_t stream) {
  using C = Cfg<T, CIN, COUT, RQ>;
  auto* kern = gather_conv_kernel<T, CIN, COUT, RQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<(M + BM - 1) / BM, THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(feat), static_cast<const int32_t*>(idx),
      static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const uint8_t*>(valid),
      static_cast<typename C::Out*>(out), N, M, K, ep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RQ>
int launch(const void* feat, const void* idx, const void* w, const void* scale,
           const void* valid, void* out, int N, int M, int K, int Cin,
           int Cout, const Epilogue& ep, void* stream) {
  if (M == 0) return 0;
  if (K < 1 || K > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define Q3D_GC_CASE(CI, CO)                                                  \
  if (Cin == CI && Cout == CO)                                               \
    return launch_one<T, CI, CO, RQ>(feat, idx, w, scale, valid, out, N, M, \
                                     K, ep, s);
#define Q3D_GC_ROW(CI) \
  Q3D_GC_CASE(CI, 16) Q3D_GC_CASE(CI, 32) Q3D_GC_CASE(CI, 64) Q3D_GC_CASE(CI, 128)
  Q3D_GC_ROW(16) Q3D_GC_ROW(32) Q3D_GC_ROW(64) Q3D_GC_ROW(128)
#undef Q3D_GC_ROW
#undef Q3D_GC_CASE
  return static_cast<int>(cudaErrorInvalidValue);   // no instance
}

}  // namespace

// Pointers are device pointers, feat / w / out 16-byte aligned; scale (Cout,)
// f32 and valid (M,) u8 may be null.  Cin, Cout in {16, 32, 64, 128} and
// 1 <= K <= 27 (the wrapper checks).  Returns the cudaError_t of the launch.
#define Q3D_GC_EXPORT(SUFFIX, T)                                             \
  extern "C" int q3d_sparse_gather_conv_##SUFFIX(                            \
      const void* feat, const void* idx, const void* w, const void* scale,   \
      const void* valid, void* out, int N, int M, int K, int Cin, int Cout,  \
      void* stream) {                                                        \
    return launch<T, false>(feat, idx, w, scale, valid, out, N, M, K, Cin,  \
                            Cout, Epilogue{}, stream);                       \
  }

#ifdef Q3D_GC_F32
Q3D_GC_EXPORT(f32, float)
#endif
#ifdef Q3D_GC_BF16
Q3D_GC_EXPORT(bf16, __nv_bfloat16)
#endif
#ifdef Q3D_GC_S8
Q3D_GC_EXPORT(s8, int8_t)
#endif

// The s8 conv with the residency epilogue fused: out (M, Cout) s8.  scale
// (out_scale, (Cout,) f32) is required; k, b (Cout,) f32 and s (one f32)
// too; row_valid (M,) u8, id_s8 (M, Cout) s8 with id_scale (one f32), and
// id_f32 (M, Cout) f32 may be null (not both identities).
#ifdef Q3D_GC_S8_REQUANT
extern "C" int q3d_sparse_gather_conv_s8_requant(
    const void* feat, const void* idx, const void* w, const void* scale,
    const void* valid, void* out, int N, int M, int K, int Cin, int Cout,
    const void* k, const void* b, const void* row_valid, const void* id_s8,
    const void* id_scale, const void* id_f32, const void* s, void* stream) {
  if (scale == nullptr || k == nullptr || b == nullptr || s == nullptr
      || (id_s8 != nullptr && (id_scale == nullptr || id_f32 != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const float*>(k), static_cast<const float*>(b),
                    static_cast<const uint8_t*>(row_valid),
                    static_cast<const int8_t*>(id_s8),
                    static_cast<const float*>(id_scale),
                    static_cast<const float*>(id_f32),
                    static_cast<const float*>(s)};
  return launch<int8_t, true>(feat, idx, w, scale, valid, out, N, M, K, Cin,
                              Cout, ep, stream);
}
#endif
