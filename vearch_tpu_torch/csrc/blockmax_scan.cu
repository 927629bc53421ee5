// Block-max int8 full scan for Hopper (sm_90a): both stages on the tensor
// cores, over one mainloop.
//
// Stage 1 (blockmax_wgmma_kernel) replaces
// vearch_tpu/ops/pallas_kernels.py::int8_blockmax_scan_pallas (Pallas
// body _blockmax_kernel): for every query and every 512-row block of the
// docid-ordered int8 mirror it computes
//
//   dot   = bf16(q) . int8(row)            (f32 accumulation)
//   dot  *= row_scale
//   score = -(|q|^2 - 2 dot + |v|^2)       (L2)  or  dot  (IP)
//   score = valid ? score : -3.4e38
//   bmax  = bf16_rn(max over the block's 512 rows), widened back to f32
//
// and writes only the [B, N_pad/512] block maxima -- the [B, N] score
// matrix never reaches device memory.
//
// Stage 2 (refine_wgmma_kernel) replaces no Pallas kernel: the reference
// ran it as XLA ops (gather the top blocks' rows, re-score at f32, top-r).
// For each query it re-scores the rows of the blocks that query selected,
// with the same dot, scale and L2 / IP score as stage 1 but no bf16
// rounding, no maximum and -inf for an invalid row, and writes them to
// out[q, slot * 512 + row], where slot is the block's place in the
// query's list: the [B, nb_sel * 512] layout of the plain version, so
// the stable top-r that follows (ops/blockmax_scan.py) breaks ties as it
// did. The rows are read straight from the mirror, as in stage 1: no
// gathered or f32-widened copy of them exists outside shared memory and
// registers. A CTA owns a query tile and skips a block no query of its
// tile selected (the wrapper's [tiles, nblk] map), so its work is at most
// stage 1's; it stores only the (query, row) scores that were selected.
//
// Bounds at the main-path shape (B=1024, N_pad=1,000,448, d=128, rerank
// 512, so 264 blocks = 135,168 rows a query). Stage 1: the product is
// 2*B*N*d = 2.6e11 operations, 0.26 ms at the H100's 989 TF/s bf16
// tensor-core peak, against 128 MB of int8 rows, 0.04 ms at 3.35 TB/s --
// bound by operations, so the product runs on the tensor cores. Stage 2:
// 2*d*B*S = 3.5e10 useful operations (0.036 ms) against the mirror's
// 128 MB and the 553 MB of f32 scores it writes (0.20 ms at 3.35 TB/s):
// bound by the scores it writes, which is why it keeps the product on the
// tensor cores over whole query tiles (a selected block is computed once
// for all of its tile's queries, at most stage 1's work) and writes each
// selected score once, 32 contiguous bytes per 8 rows. int8 values
// -127..127 are exact in bf16 and bf16 x bf16 products are exact in f32,
// so a bf16 wgmma with f32 accumulation computes the TPU's MXU dots; only
// the summation order differs.
//
// Design. One warpgroup (128 threads) per CTA; the CTA owns a tile of N
// queries (N = 128, 64 or 8, by batch size and d) for its whole life and
// walks row blocks blk = blockIdx.y, +gridDim.y, ... (persistent, the
// query tile on the outer axis: grid.x = query tiles, grid.y about
// SMs*occupancy/query tiles, so the CTAs that share a row block are
// launched side by side and tend to find it in L2). Stage 2 walks the
// same sequence and passes over the blocks its tile did not select.
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
// - Stage 1's epilogue on the accumulators: scale, |q|^2, |v|^2, the
//   valid mask and a running max over the M-tiles in registers; after
//   the block's 8 tiles, shuffles across the fragment's row lanes, then
//   shared memory across the 4 warps, the bf16 round, one f32 store per
//   query. Stage 2's: the same score for each accumulator, stored where
//   the query selected the block (8 row lanes of one query column write
//   32 contiguous bytes). The _rn intrinsics keep the compiler from
//   contracting the epilogue into FMAs that round differently from the
//   plain PyTorch version; the one FMA it has (|q|^2 - 2 dot) rounds as
//   the plain subtraction does.
//
// Shared memory is N*dpad*2 bytes of query tile, 4*N of |q|^2 (and 16*N
// of stage 1's reductions) plus the 24 KB ring: 57 KB at N=128, d=128.
// The ring holds K chunks, so it does not grow with d; the wrapper
// narrows N where d would push the query tile past its MAX_QUERY_SMEM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
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

// Which row blocks a CTA's walk visits, from `blk` on in steps of
// gridDim.y: every one (stage 1), or those that some query of the CTA's
// tile selected (stage 2; its row of the wrapper's [tiles, nblk] map).
// `from` returns the first visited block at or after `blk` (>= nblk at
// the end of the walk).
struct EveryBlock {
  __device__ __forceinline__ int from(int blk) const { return blk; }
};
struct SelectedBlocks {
  const uint8_t* __restrict__ active;
  int nblk;
  __device__ __forceinline__ int from(int blk) const {
    while (blk < nblk && __ldg(active + blk) == 0) blk += gridDim.y;
    return blk;
  }
};

// position of a K chunk in a CTA's walk: row block, M tile, chunk
template <class Walk>
struct Cursor {
  int blk, mt, c;
  __device__ __forceinline__ void advance(int nch, const Walk& walk) {
    if (++c == nch) {
      c = 0;
      if (++mt == kTiles) {
        mt = 0;
        blk = walk.from(blk + gridDim.y);
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

// query tile -> shared memory in the canonical layout, K permuted within
// each 16-step: logical slot l of step s in chunk c holds physical byte
// 64c + 16*((l&7)>>1) + 4s + 2*(l>>3) + (l&1); zero past d and past B.
// |q|^2 beside it. Ends with the tile visible to wgmma.
template <int N>
__device__ __forceinline__ void load_query_tile(
    __nv_bfloat16* s_q, float* s_qsq, const __nv_bfloat16* __restrict__ q,
    const float* __restrict__ qsq, int q0, int B, int d, int dpad) {
  for (int e = threadIdx.x; e < N * dpad; e += kThreads) {
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
  for (int n = threadIdx.x; n < N; n += kThreads)
    s_qsq[n] = q0 + n < B ? qsq[q0 + n] : 0.f;
  // generic-proxy stores -> visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// The mainloop both stages share: the product of one 64-row M tile with
// the CTA's query tile (in shared memory at desc0), in the order the walk
// visits blocks and M tiles. A ring of kStages chunks in shared memory,
// each thread's own slots (16 bytes of row g, 16 of row g+8): cp.async
// keeps kStages-1 chunks in flight ahead of the product; no thread reads
// another's slot, so the ring needs no barrier.
template <int N, int kLoad, class Walk>
struct RowTiles {
  const int8_t* __restrict__ rows;
  Walk walk;
  int d, nblk, nch, tid, my_row, kt, stage;
  uint32_t ring;
  uint64_t desc0;
  Cursor<Walk> ahead;

  // `first`: the walk's first block (walk.from(blockIdx.y))
  __device__ __forceinline__ RowTiles(const int8_t* __restrict__ rows_,
                                      Walk walk_, int d_, int nblk_,
                                      int dpad, uint32_t ring_,
                                      uint64_t desc0_, int first)
      : rows(rows_), walk(walk_), d(d_), nblk(nblk_), nch(dpad / kChunk),
        tid(threadIdx.x), stage(0), ring(ring_), desc0(desc0_),
        ahead{first, 0, 0} {
    const int lane = tid & 31;
    my_row = (tid >> 5) * 16 + (lane >> 2);  // within an M tile; +8 too
    kt = 16 * (lane & 3);                    // this thread's K offset
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) issue(st);
  }

  __device__ __forceinline__ uint32_t slot(int st, int half) const {
    return ring + (uint32_t)(((st * 2 + half) * kThreads + tid) * 16);
  }

  __device__ __forceinline__ void issue(int st) {
    if (ahead.blk < nblk) {
      const int8_t* r =
          rows + ((long long)ahead.blk * kBlockRows + ahead.mt * kTileRows +
                  my_row) * d;
      const int k = ahead.c * kChunk + kt;
      copy16<kLoad>(slot(st, 0), r, k, d);
      copy16<kLoad>(slot(st, 1), r + 8LL * d, k, d);
    }
    cp_async_commit();
    ahead.advance(nch, walk);
  }

  // the next M tile's accumulators: accumulator 4i+j is (row g, column
  // 8i+2t+j), 4i+2+j is (row g+8, the same column)
  __device__ __forceinline__ void product(float (&acc)[N / 2]) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
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
      for (int i = 0; i < N / 2; ++i) keep(acc[i]);
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
  constexpr int kCols = N / 4;  // query columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_qsq = reinterpret_cast<float*>(smem + (size_t)N * dpad * 2);
  float* s_red = s_qsq + N;  // [4 warps][N]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * N;
  load_query_tile<N>(s_q, s_qsq, q, qsq, q0, B, d, dpad);

  const EveryBlock walk{};
  RowTiles<N, kLoad, EveryBlock> tiles(
      rows, walk, d, nblk, dpad, smem_addr(s_red + 4 * N),
      make_desc(smem_addr(s_q), 128, dpad * 16), blockIdx.y);
  const int my_row = tiles.my_row;

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
      float acc[N / 2];
      tiles.product(acc);
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

template <int N, int kLoad>
__global__ void __launch_bounds__(kThreads)
refine_wgmma_kernel(const __nv_bfloat16* __restrict__ q,  // [B, d]
                    const int8_t* __restrict__ rows,      // [N_pad, d]
                    const float* __restrict__ scale,      // [N_pad]
                    const float* __restrict__ vsq,        // [N_pad]
                    const uint8_t* __restrict__ valid,    // [N_pad]
                    const float* __restrict__ qsq,        // [B]
                    const int* __restrict__ slots,        // [nblk, B]
                    const uint8_t* __restrict__ active,   // [tiles, nblk]
                    float* __restrict__ out,              // [B, nsel*512]
                    int B, int d, int nblk, int nsel, int l2) {
  constexpr int kCols = N / 4;  // query columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_qsq = reinterpret_cast<float*>(smem + (size_t)N * dpad * 2);

  const int t = threadIdx.x & 3;
  const int q0 = blockIdx.x * N;
  const long long row_len = (long long)nsel * kBlockRows;  // out's stride
  const float neg_inf = __int_as_float((int)0xff800000u);
  load_query_tile<N>(s_q, s_qsq, q, qsq, q0, B, d, dpad);

  const SelectedBlocks walk{active + (long long)blockIdx.x * nblk, nblk};
  const int first = walk.from(blockIdx.y);
  RowTiles<N, kLoad, SelectedBlocks> tiles(
      rows, walk, d, nblk, dpad, smem_addr(s_qsq + N),
      make_desc(smem_addr(s_q), 128, dpad * 16), first);
  const int my_row = tiles.my_row;

  for (int blk = first; blk < nblk; blk = walk.from(blk + gridDim.y)) {
    // where each of this thread's query columns stores the block's rows:
    // the block's place in that query's list, -1 if it did not select it
    int sl[kCols];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qq = q0 + 8 * i + 2 * t + j;
        sl[2 * i + j] =
            qq < B ? __ldg(slots + (long long)blk * B + qq) : -1;
      }
    for (int mt = 0; mt < kTiles; ++mt) {
      const int row = mt * kTileRows + my_row;  // within the block
      const long long ra = (long long)blk * kBlockRows + row;
      const float sca = __ldg(scale + ra), scb = __ldg(scale + ra + 8);
      const bool oka = __ldg(valid + ra) != 0;
      const bool okb = __ldg(valid + ra + 8) != 0;
      const float vsa = __ldg(vsq + ra), vsb = __ldg(vsq + ra + 8);
      float acc[N / 2];
      tiles.product(acc);
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = sl[2 * i + j];
          if (s < 0) continue;
          const int n = 8 * i + 2 * t + j;
          float s0, s1;
          if (l2) {
            const float qs = s_qsq[n];
            s0 = l2_score(acc[4 * i + j], sca, vsa, qs);
            s1 = l2_score(acc[4 * i + 2 + j], scb, vsb, qs);
          } else {
            s0 = __fmul_rn(acc[4 * i + j], sca);
            s1 = __fmul_rn(acc[4 * i + 2 + j], scb);
          }
          float* o = out + (long long)(q0 + n) * row_len +
                     (long long)s * kBlockRows + row;
          o[0] = oka ? s0 : neg_inf;
          o[8] = okb ? s1 : neg_inf;
        }
      }
    }
  }
}

// CTAs of `kernel` that fit on the card at once, for this shared memory
// size. The attribute and occupancy queries run once for each (kernel,
// device, size), not on every launch; the attribute only ever grows, so
// a cached smaller size stays launchable.
int resident_ctas(const void* kernel, size_t smem, int* slots) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> attr;  // max set
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *slots = hit->second;
    return 0;
  }
  size_t& set = attr[std::make_pair(kernel, dev)];
  if (smem > set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    set = smem;
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

// the grid of a walk over nblk row blocks by query tiles of N: grid.x
// the tiles, grid.y the CTAs that share a tile, so that all fit at once
int walk_grid(const void* kernel, size_t smem, int B, int N, int nblk,
              dim3* grid) {
  int slots = 0;
  const int err = resident_ctas(kernel, smem, &slots);
  if (err != 0) return err;
  const int qtiles = (B + N - 1) / N;
  int walkers = slots / qtiles;
  walkers = walkers < 1 ? 1 : (walkers > nblk ? nblk : walkers);
  walkers = walkers > 65535 ? 65535 : walkers;
  *grid = dim3(qtiles, walkers);
  return 0;
}

size_t query_smem(int N, int d) {
  const int dpad = (d + kChunk - 1) / kChunk * kChunk;
  return (size_t)N * dpad * 2 + (size_t)N * 4 +
         (size_t)kStages * 2 * kThreads * 16;
}

// the arguments of one launch of either stage; `run<N, kLoad>` launches
struct Stage1 {
  const void *q, *rows, *scale, *vsq, *valid, *qsq;
  void* bmax;
  int B, d, nblk, l2;
  cudaStream_t stream;

  template <int N, int kLoad>
  int run() const {
    const size_t smem = query_smem(N, d) + (size_t)N * 4 * 4;  // + s_red
    dim3 grid;
    const int err = walk_grid((const void*)blockmax_wgmma_kernel<N, kLoad>,
                              smem, B, N, nblk, &grid);
    if (err != 0) return err;
    blockmax_wgmma_kernel<N, kLoad><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const int8_t*>(rows), static_cast<const float*>(scale),
        static_cast<const float*>(vsq), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(qsq), static_cast<float*>(bmax), B, d,
        nblk, l2);
    return (int)cudaGetLastError();
  }
};

struct Stage2 {
  const void *q, *rows, *scale, *vsq, *valid, *qsq, *slots, *active;
  void* out;
  int B, d, nblk, nsel, l2;
  cudaStream_t stream;

  template <int N, int kLoad>
  int run() const {
    const size_t smem = query_smem(N, d);
    dim3 grid;
    const int err = walk_grid((const void*)refine_wgmma_kernel<N, kLoad>,
                              smem, B, N, nblk, &grid);
    if (err != 0) return err;
    refine_wgmma_kernel<N, kLoad><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const int8_t*>(rows), static_cast<const float*>(scale),
        static_cast<const float*>(vsq), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(qsq), static_cast<const int*>(slots),
        static_cast<const uint8_t*>(active), static_cast<float*>(out), B,
        d, nblk, nsel, l2);
    return (int)cudaGetLastError();
  }
};

// f.run<N, kLoad>() for the query tile width n_tile (128, 64 or 8) and
// the widest row load that d and the rows' address allow (16, 4 or 1
// bytes per copy)
template <int N, class F>
int by_load(int vec, const F& f) {
  if (vec == 16) return f.template run<N, 16>();
  if (vec == 4) return f.template run<N, 4>();
  return f.template run<N, 1>();
}

template <class F>
int dispatch(const void* rows, int d, int n_tile, const F& f) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(rows);
  const int vec = (d % 16 == 0 && p % 16 == 0) ? 16
                  : (d % 4 == 0 && p % 4 == 0) ? 4
                                               : 1;
  switch (n_tile) {
    case 128:
      return by_load<128>(vec, f);
    case 64:
      return by_load<64>(vec, f);
    case 8:
      return by_load<8>(vec, f);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// n_tile: the query tile width, 128, 64 or 8 (the wrapper picks it)
extern "C" int vt_int8_blockmax_stage1(const void* q, const void* rows,
                                       const void* scale, const void* vsq,
                                       const void* valid, const void* qsq,
                                       void* bmax, int B, int d, int nblk,
                                       int l2, int n_tile, void* stream) {
  if (B <= 0 || nblk <= 0) return 0;
  const Stage1 f{q, rows, scale, vsq, valid, qsq, bmax, B, d, nblk, l2,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(rows, d, n_tile, f);
}

// slots [nblk, B] int32: the block's place in each query's list of nsel
// selected blocks, -1 where the query did not select it; active
// [ceil(B / n_tile), nblk] uint8: 1 where a query of the tile did. out
// [B, nsel * 512] f32, every entry written once.
extern "C" int vt_blockmax_stage2(const void* q, const void* rows,
                                  const void* scale, const void* vsq,
                                  const void* valid, const void* qsq,
                                  const void* slots, const void* active,
                                  void* out, int B, int d, int nblk,
                                  int nsel, int l2, int n_tile,
                                  void* stream) {
  if (B <= 0 || nblk <= 0 || nsel <= 0) return 0;
  const Stage2 f{q,    rows, scale, vsq, valid, qsq,
                 slots, active, out, B, d, nblk, nsel, l2,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(rows, d, n_tile, f);
}
