// Block-max int8 full scan, stage 1, for Hopper (sm_90a): tensor cores.
//
// Replaces vearch_tpu/ops/pallas_kernels.py::int8_blockmax_scan_pallas
// (Pallas body _blockmax_kernel): for every query and every 512-row block
// of the docid-ordered int8 mirror it computes
//
//   dot   = bf16(q) . int8(row)            (f32 accumulation)
//   dot  *= row_scale
//   score = -(|q|^2 - 2 dot + |v|^2)       (L2)  or  dot  (IP)
//   score = valid ? score : -3.4e38
//   bmax  = bf16_rn(max over the block's 512 rows), widened back to f32
//
// and writes only the [B, N_pad/512] block maxima -- the [B, N] score
// matrix never reaches device memory. Stage 2 (select blocks, re-score
// them at f32, top-r) stays in PyTorch (ops/blockmax_scan.py).
//
// Bound at the main-path shape (B=1024, N_pad=1,000,448, d=128): the
// product is 2*B*N*d = 2.6e11 operations, 0.26 ms at the H100's 989 TF/s
// bf16 tensor-core peak, against 128 MB of int8 rows, 0.04 ms at
// 3.35 TB/s -- bound by operations, so the product runs on the tensor
// cores. int8 values -127..127 are exact in bf16 and bf16 x bf16 products
// are exact in f32, so a bf16 wgmma with f32 accumulation computes the
// TPU's MXU dots; only the summation order differs.
//
// Design. One warpgroup (128 threads) per CTA; the CTA owns a tile of N
// queries (N = 128, 64 or 8, by batch size and d) for its whole life and
// walks row blocks blk = blockIdx.y, +gridDim.y, ... (persistent, the
// query tile on the outer axis: grid.x = query tiles, grid.y about
// SMs*occupancy/query tiles, so the CTAs that share a row block are
// launched side by side and tend to find it in L2).
//
// - Rows are the wgmma M axis: a 512-row block is 8 M-tiles of 64 rows,
//   the queries are N, K is d in steps of 16.
// - A (the int8 rows) comes from registers: each thread copies 16 bytes
//   of two rows (g and g+8 of its warp's 16) per 64-byte K chunk from
//   global memory into its own slots of a kStages-deep shared-memory ring
//   (cp.async, kStages-1 chunks in flight ahead of the product; a thread
//   reads back only what it copied, so the ring needs no barrier), then
//   converts them to bf16 pairs in registers (the 2^23 magic-number
//   trick: byte_perm into a float's mantissa, one subtract,
//   cvt.rn.bf16x2). No bf16 copy of the rows exists anywhere.
//   K is permuted inside each 16-wide step so that a thread's 4 loaded
//   bytes are exactly the 4 k-slots the A fragment gives it; the query
//   tile is stored with the same permutation, so the sum is unchanged.
// - B (the queries, bf16) sits in shared memory for the CTA's life in
//   wgmma's canonical no-swizzle K-major layout (8x8 core matrices of 128
//   contiguous bytes; K-adjacent cores 128 B apart, N-adjacent 8-groups
//   dpad*16 B apart), zero past d: the ragged K slice is zero-filled.
// - Epilogue on the accumulators: scale, |q|^2, |v|^2, the valid mask
//   and a running max over the M-tiles in registers; after the block's 8
//   tiles, shuffles across the fragment's row lanes, then shared memory
//   across the 4 warps, the bf16 round, one f32 store per query. The _rn
//   intrinsics keep the compiler from contracting the epilogue into FMAs
//   that round differently from the plain PyTorch version; the one FMA
//   it has (|q|^2 - 2 dot) rounds as the plain subtraction does.
//
// Shared memory is N*dpad*2 + 20*N bytes of query tile and reductions
// (dpad = d rounded up to 64) plus the 24 KB ring: 57 KB at N=128,
// d=128. The ring holds K chunks, so it does not grow with d; the
// wrapper narrows N where d would push the query tile past its
// MAX_QUERY_SMEM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kBlockRows = 512;                  // ops/ivf.py BLOCK
constexpr int kTileRows = 64;                    // one wgmma M tile
constexpr int kTiles = kBlockRows / kTileRows;   // M tiles per block
constexpr int kThreads = 128;                    // one warpgroup
constexpr int kChunk = 64;                       // K bytes per ring stage
constexpr int kStages = 6;                       // ring depth, in chunks
constexpr float kMasked = -3.4e38f;

// -- wgmma, A from registers, B from a shared-memory descriptor ------------

__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int N> struct Mma;
template <> struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int sd) {
    wgmma_n8(d, a, desc, sd);
  }
};
template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int sd) {
    wgmma_n64(d, a, desc, sd);
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int sd) {
    wgmma_n128(d, a, desc, sd);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps a register that an in-flight wgmma reads (or writes) where it is
// until the wait: the compiler sees the asm consume it at issue time
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// no-swizzle K-major matrix descriptor: start address, leading (K) and
// stride (N) byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr,
                                              uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// four int8 in a word -> two bf16x2: bytes (0,1) and (2,3), exact
__device__ __forceinline__ float byte_to_f32(uint32_t flipped, uint32_t k) {
  // 0x4B0000xx is 2^23 + xx; xx = byte ^ 0x80 = byte + 128
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440u | k)) -
         8388736.0f;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& p01,
                                               uint32_t& p23) {
  const uint32_t x = w ^ 0x80808080u;
  p01 = pack_bf16x2(byte_to_f32(x, 0), byte_to_f32(x, 1));
  p23 = pack_bf16x2(byte_to_f32(x, 2), byte_to_f32(x, 3));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// copies 16 bytes of one row at K offset k into shared memory at `dst`,
// zero past d; kLoad = 16, 4 or 1 bytes per copy (by d's and the
// pointer's alignment). 16 and 4 go through cp.async (a source size of
// 0 zero-fills); 1 loads and stores synchronously.
template <int kLoad>
__device__ __forceinline__ void copy16(uint32_t dst,
                                       const int8_t* __restrict__ row, int k,
                                       int d) {
  if (kLoad == 16) {
    const bool in = k < d;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(in ? row + k : row), "r"(in ? 16 : 0)
                 : "memory");
  } else if (kLoad == 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool in = k + 4 * s < d;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       dst + 4 * s),
                   "l"(in ? row + k + 4 * s : row), "r"(in ? 4 : 0)
                   : "memory");
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k + 4 * s + j;
        if (kk < d) v |= (uint32_t)(uint8_t)row[kk] << (8 * j);
      }
      w[s] = v;
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// position of a K chunk in a CTA's walk: row block, M tile, chunk
struct Cursor {
  int blk, mt, c;
  __device__ __forceinline__ void advance(int nch) {
    if (++c == nch) {
      c = 0;
      if (++mt == kTiles) {
        mt = 0;
        blk += gridDim.y;
      }
    }
  }
};

// -(|q|^2 - 2 dot + |v|^2) with the plain version's roundings:
// fma(-2, dot, qs) rounds once, as qs - 2*dot does (2*dot is exact). An
// invalid row comes with vs = +inf and scores -inf, which the block max
// passes over as it does -3.4e38; a block of invalid rows gives -inf,
// the bf16 rounding of -3.4e38.
__device__ __forceinline__ float l2_score(float acc, float sc, float vs,
                                          float qs) {
  return -__fadd_rn(__fmaf_rn(-2.0f, __fmul_rn(acc, sc), qs), vs);
}

template <int N, int kLoad>
__global__ void __launch_bounds__(kThreads)
blockmax_wgmma_kernel(const __nv_bfloat16* __restrict__ q,  // [B, d]
                      const int8_t* __restrict__ rows,      // [N_pad, d]
                      const float* __restrict__ scale,      // [N_pad]
                      const float* __restrict__ vsq,        // [N_pad]
                      const uint8_t* __restrict__ valid,    // [N_pad]
                      const float* __restrict__ qsq,        // [B]
                      float* __restrict__ bmax,             // [B, nblk]
                      int B, int d, int nblk, int l2) {
  constexpr int kAcc = N / 2;   // f32 accumulators per thread
  constexpr int kCols = N / 4;  // query columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_qsq = reinterpret_cast<float*>(smem + (size_t)N * dpad * 2);
  float* s_red = s_qsq + N;  // [4 warps][N]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * N;

  // query tile -> canonical layout, K permuted within each 16-step:
  // logical slot l of step s in chunk c holds physical byte
  // 64c + 16*((l&7)>>1) + 4s + 2*(l>>3) + (l&1)
  for (int e = tid; e < N * dpad; e += kThreads) {
    const int n = e / dpad, kl = e - n * dpad;
    const int c = kl >> 6, s = (kl >> 4) & 3, l = kl & 15;
    const int phys = 64 * c + 16 * ((l & 7) >> 1) + 4 * s + 2 * (l >> 3) +
                     (l & 1);
    const int qq = q0 + n;
    const __nv_bfloat16 v = (qq < B && phys < d)
                                ? q[(long long)qq * d + phys]
                                : __float2bfloat16_rn(0.f);
    s_q[(n >> 3) * (dpad * 8) + (kl >> 3) * 64 + (n & 7) * 8 + (kl & 7)] = v;
  }
  for (int n = tid; n < N; n += kThreads)
    s_qsq[n] = q0 + n < B ? qsq[q0 + n] : 0.f;
  // generic-proxy stores -> visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t desc0 = make_desc(
      static_cast<uint32_t>(__cvta_generic_to_shared(s_q)), 128, dpad * 16);
  const int nch = dpad / kChunk;
  const int my_row = warp * 16 + g;  // within an M tile; +8 for the 2nd
  const int kt = 16 * t;             // this thread's K offset in a chunk

  // a ring of kStages chunks in shared memory, each thread's own slots
  // (16 bytes of row g, 16 of row g+8): cp.async keeps kStages-1 chunks
  // in flight ahead of the product; no thread reads another's slot, so
  // the ring needs no barrier
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(
      s_red + 4 * N));
  auto slot = [&](int stage, int half) {
    return ring + (uint32_t)(((stage * 2 + half) * kThreads + tid) * 16);
  };
  Cursor ahead{(int)blockIdx.y, 0, 0};
  auto issue = [&](int stage) {
    if (ahead.blk < nblk) {
      const int8_t* r =
          rows + ((long long)ahead.blk * kBlockRows + ahead.mt * kTileRows +
                  my_row) * d;
      const int k = ahead.c * kChunk + kt;
      copy16<kLoad>(slot(stage, 0), r, k, d);
      copy16<kLoad>(slot(stage, 1), r + 8LL * d, k, d);
    }
    cp_async_commit();
    ahead.advance(nch);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  int stage = 0;

  for (int blk = blockIdx.y; blk < nblk; blk += gridDim.y) {
    float rmax[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) rmax[i] = __int_as_float((int)0xff800000u);  // -inf
    for (int mt = 0; mt < kTiles; ++mt) {
      const long long ra = (long long)blk * kBlockRows + mt * kTileRows +
                           my_row;
      const float sca = __ldg(scale + ra), scb = __ldg(scale + ra + 8);
      const bool oka = __ldg(valid + ra) != 0;
      const bool okb = __ldg(valid + ra + 8) != 0;
      const float vsa = oka ? __ldg(vsq + ra) : __int_as_float(0x7f800000);
      const float vsb = okb ? __ldg(vsq + ra + 8)
                          : __int_as_float(0x7f800000);
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int c = 0; c < nch; ++c) {
        cp_async_wait<kStages - 2>();  // this chunk has landed
        uint32_t cur_a[4], cur_b[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(cur_a[0]), "=r"(cur_a[1]), "=r"(cur_a[2]),
                       "=r"(cur_a[3])
                     : "r"(slot(stage, 0))
                     : "memory");
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(cur_b[0]), "=r"(cur_b[1]), "=r"(cur_b[2]),
                       "=r"(cur_b[3])
                     : "r"(slot(stage, 1))
                     : "memory");
        // refill the slot read one chunk ago
        issue(stage == 0 ? kStages - 1 : stage - 1);
        stage = stage + 1 == kStages ? 0 : stage + 1;
        uint32_t a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          int8x4_to_bf16(cur_a[s], a[s][0], a[s][2]);
          int8x4_to_bf16(cur_b[s], a[s][1], a[s][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          Mma<N>::run(acc, a[s], desc0 + (uint64_t)((4 * c + s) * 16), 1);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) keep(a[s][j]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) keep(acc[i]);
      }
      // epilogue of this M tile: accumulator 4i+j is (row g, column
      // 8i+2t+j), 4i+2+j is (row g+8, the same column)
      if (l2) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float qs = s_qsq[8 * i + 2 * t + j];
            const float s0 = l2_score(acc[4 * i + j], sca, vsa, qs);
            const float s1 = l2_score(acc[4 * i + 2 + j], scb, vsb, qs);
            rmax[2 * i + j] = fmaxf(rmax[2 * i + j], fmaxf(s0, s1));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float s0 = oka ? __fmul_rn(acc[4 * i + j], sca) : kMasked;
            const float s1 =
                okb ? __fmul_rn(acc[4 * i + 2 + j], scb) : kMasked;
            rmax[2 * i + j] = fmaxf(rmax[2 * i + j], fmaxf(s0, s1));
          }
        }
      }
    }
    // max over the block: the 8 row lanes (g), then the 4 warps
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float v = rmax[i];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      rmax[i] = v;
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s_red[warp * N + 8 * i + 2 * t + j] = rmax[2 * i + j];
    }
    __syncthreads();
    for (int n = tid; n < N; n += kThreads) {
      if (q0 + n < B) {
        float v = fmaxf(fmaxf(s_red[n], s_red[N + n]),
                        fmaxf(s_red[2 * N + n], s_red[3 * N + n]));
        bmax[(long long)(q0 + n) * nblk + blk] =
            __bfloat162float(__float2bfloat16_rn(v));
      }
    }
    __syncthreads();
  }
}

// CTAs of one instance that fit on the card at once, for this shared
// memory size. The attribute and occupancy queries run once for each
// (device, size), not on every launch; the attribute only ever grows, so
// a cached smaller size stays launchable.
template <int N, int kLoad>
int resident_ctas(size_t smem, int* slots) {
  static std::mutex mu;
  static std::map<int, size_t> attr;               // device -> max set
  static std::map<std::pair<int, size_t>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *slots = hit->second;
    return 0;
  }
  auto kernel = blockmax_wgmma_kernel<N, kLoad>;
  if (smem > attr[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr[dev] = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  cache[key] = *slots;
  return 0;
}

template <int N, int kLoad>
int launch(const void* q, const void* rows, const void* scale,
           const void* vsq, const void* valid, const void* qsq, void* bmax,
           int B, int d, int nblk, int l2, cudaStream_t stream) {
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;
  const size_t smem = (size_t)N * dpad * 2 + (size_t)N * 4 * 5 +
                      (size_t)kStages * 2 * kThreads * 16;
  int slots = 0;
  const int err = resident_ctas<N, kLoad>(smem, &slots);
  if (err != 0) return err;
  const int qtiles = (B + N - 1) / N;
  int walkers = slots / qtiles;
  walkers = walkers < 1 ? 1 : (walkers > nblk ? nblk : walkers);
  walkers = walkers > 65535 ? 65535 : walkers;
  blockmax_wgmma_kernel<N, kLoad><<<dim3(qtiles, walkers), kThreads, smem,
                                    stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(rows),
      static_cast<const float*>(scale), static_cast<const float*>(vsq),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qsq),
      static_cast<float*>(bmax), B, d, nblk, l2);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(int vec, const void* q, const void* rows, const void* scale,
             const void* vsq, const void* valid, const void* qsq, void* bmax,
             int B, int d, int nblk, int l2, cudaStream_t s) {
  if (vec == 16)
    return launch<N, 16>(q, rows, scale, vsq, valid, qsq, bmax, B, d, nblk,
                         l2, s);
  if (vec == 4)
    return launch<N, 4>(q, rows, scale, vsq, valid, qsq, bmax, B, d, nblk,
                        l2, s);
  return launch<N, 1>(q, rows, scale, vsq, valid, qsq, bmax, B, d, nblk, l2,
                      s);
}

}  // namespace

// n_tile: the query tile width, 128, 64 or 8 (the wrapper picks it)
extern "C" int vt_int8_blockmax_stage1(const void* q, const void* rows,
                                       const void* scale, const void* vsq,
                                       const void* valid, const void* qsq,
                                       void* bmax, int B, int d, int nblk,
                                       int l2, int n_tile, void* stream) {
  if (B <= 0 || nblk <= 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(rows);
  const int vec = (d % 16 == 0 && p % 16 == 0) ? 16
                  : (d % 4 == 0 && p % 4 == 0) ? 4
                                               : 1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
    case 128:
      return launch_n<128>(vec, q, rows, scale, vsq, valid, qsq, bmax, B, d,
                           nblk, l2, s);
    case 64:
      return launch_n<64>(vec, q, rows, scale, vsq, valid, qsq, bmax, B, d,
                          nblk, l2, s);
    case 8:
      return launch_n<8>(vec, q, rows, scale, vsq, valid, qsq, bmax, B, d,
                         nblk, l2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
