// Block-max int8 full scan, stage 1, for Hopper (sm_90a).
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
// and writes only the [B, N_pad/512] block maxima — the [B, N] score
// matrix never reaches device memory. Stage 2 (select blocks, re-score
// them at f32, top-r) stays in PyTorch (ops/blockmax_scan.py).
//
// Bound at the main-path shape (B=1024, N_pad=1,000,448, d=128): the
// product is 2*B*N*d = 2.6e11 operations, 0.26 ms at the H100's 989 TF/s
// bf16 tensor-core peak, against 128 MB of int8 rows, 0.04 ms at
// 3.35 TB/s — compute-bound. This first version runs the product as f32
// FMAs on CUDA cores (67 TF/s peak), so it cannot go below ~4 ms; wgmma,
// TMA and in-register int8->bf16 conversion are later work.
//
// Design: one thread block per (16-query tile, 512-row block); the grid's
// x axis walks query tiles so neighbouring blocks share a row block and
// the int8 rows stream from device memory about once (L2 serves the
// repeats). The block stages a 64-column slice of its 512 rows in shared
// memory (row stride padded to 17 words: conflict-free column reads) plus
// the matching f32 query slice; each of the 256 threads owns 2 rows and
// keeps 2x16 accumulators in registers. bf16 x int8 products are exact in
// f32, so only the summation order differs from the TPU. Any d is taken;
// the ragged last slice is zero-padded in shared memory. The epilogue uses
// _rn intrinsics so the compiler cannot contract it into FMAs that round
// differently from the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 512;                 // ops/ivf.py BLOCK
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBlockRows / kThreads;
constexpr int kQueryTile = 16;
constexpr int kDimChunk = 64;                   // bytes of a row per stage
constexpr int kRowWords = kDimChunk / 4 + 1;    // padded smem row stride
constexpr float kMasked = -3.4e38f;

__device__ __forceinline__ void unpack4(int w, float out[4]) {
  out[0] = (float)(int8_t)(w & 0xff);
  out[1] = (float)(int8_t)((w >> 8) & 0xff);
  out[2] = (float)(int8_t)((w >> 16) & 0xff);
  out[3] = (float)(int8_t)((w >> 24) & 0xff);
}

__global__ void __launch_bounds__(kThreads)
blockmax_kernel(const __nv_bfloat16* __restrict__ q,   // [B, d]
                const int8_t* __restrict__ rows,       // [N_pad, d]
                const float* __restrict__ scale,       // [N_pad]
                const float* __restrict__ vsq,         // [N_pad]
                const uint8_t* __restrict__ valid,     // [N_pad]
                const float* __restrict__ qsq,         // [B]
                float* __restrict__ bmax,              // [B, nblk]
                int B, int d, int nblk, int l2) {
  __shared__ int s_rows[kBlockRows * kRowWords];
  __shared__ __align__(16) float s_q[kQueryTile][kDimChunk];
  __shared__ float s_red[kThreads / 32][kQueryTile];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQueryTile;
  const int blk = blockIdx.y;
  const long long row0 = (long long)blk * kBlockRows;
  const bool vec_rows =
      (d % 4 == 0) && ((reinterpret_cast<uintptr_t>(rows) & 3) == 0);
  unsigned char* s_bytes = reinterpret_cast<unsigned char*>(s_rows);

  float acc[kRowsPerThread][kQueryTile];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
    for (int qi = 0; qi < kQueryTile; ++qi) acc[rr][qi] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDimChunk) {
    const int kw = min(kDimChunk, d - k0);  // valid columns this stage
    const int kw4 = (kw + 3) / 4;           // words per staged row
    __syncthreads();                        // previous stage consumed
    if (vec_rows) {
      for (int e = tid; e < kBlockRows * kw4; e += kThreads) {
        const int r = e / kw4, c = e - r * kw4;
        s_rows[r * kRowWords + c] = *reinterpret_cast<const int*>(
            rows + (row0 + r) * d + k0 + 4 * c);
      }
    } else {
      for (int e = tid; e < kBlockRows * kw4 * 4; e += kThreads) {
        const int r = e / (kw4 * 4), c = e - r * (kw4 * 4);
        const int8_t v = c < kw ? rows[(row0 + r) * d + k0 + c] : 0;
        s_bytes[r * kRowWords * 4 + c] = (unsigned char)v;
      }
    }
    for (int e = tid; e < kQueryTile * kw4 * 4; e += kThreads) {
      const int qi = e / (kw4 * 4), c = e - qi * (kw4 * 4);
      const int qq = q0 + qi;
      s_q[qi][c] = (qq < B && c < kw)
                       ? __bfloat162float(q[(long long)qq * d + k0 + c])
                       : 0.f;
    }
    __syncthreads();
    for (int w = 0; w < kw4; ++w) {
      float a[kRowsPerThread][4];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr)
        unpack4(s_rows[(tid + rr * kThreads) * kRowWords + w], a[rr]);
#pragma unroll
      for (int qi = 0; qi < kQueryTile; ++qi) {
        const float4 qv = *reinterpret_cast<const float4*>(&s_q[qi][4 * w]);
#pragma unroll
        for (int rr = 0; rr < kRowsPerThread; ++rr) {
          float s = acc[rr][qi];
          s = fmaf(a[rr][0], qv.x, s);
          s = fmaf(a[rr][1], qv.y, s);
          s = fmaf(a[rr][2], qv.z, s);
          s = fmaf(a[rr][3], qv.w, s);
          acc[rr][qi] = s;
        }
      }
    }
  }

  // epilogue: score, mask, max over this thread's rows
  float m[kQueryTile];
#pragma unroll
  for (int qi = 0; qi < kQueryTile; ++qi) m[qi] = __int_as_float((int)0xff800000u);  // -inf
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const long long row = row0 + tid + rr * kThreads;
    const float sc = scale[row], vs = vsq[row];
    const bool ok = valid[row] != 0;
#pragma unroll
    for (int qi = 0; qi < kQueryTile; ++qi) {
      const float dot = __fmul_rn(acc[rr][qi], sc);
      float s = dot;
      if (l2) {
        const int qq = min(q0 + qi, B - 1);
        s = -__fadd_rn(__fsub_rn(qsq[qq], __fmul_rn(2.0f, dot)), vs);
      }
      s = ok ? s : kMasked;
      m[qi] = fmaxf(m[qi], s);
    }
  }
  // block-wide max per query: warp shuffle, then across the 8 warps
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int qi = 0; qi < kQueryTile; ++qi) {
    float v = m[qi];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) s_red[warp][qi] = v;
  }
  __syncthreads();
  if (tid < kQueryTile && q0 + tid < B) {
    float v = s_red[0][tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) v = fmaxf(v, s_red[w][tid]);
    bmax[(long long)(q0 + tid) * nblk + blk] =
        __bfloat162float(__float2bfloat16_rn(v));
  }
}

}  // namespace

extern "C" int vt_int8_blockmax_stage1(const void* q, const void* rows,
                                       const void* scale, const void* vsq,
                                       const void* valid, const void* qsq,
                                       void* bmax, int B, int d, int nblk,
                                       int l2, void* stream) {
  if (B <= 0 || nblk <= 0) return 0;
  dim3 grid((B + kQueryTile - 1) / kQueryTile, nblk);
  blockmax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(rows),
      static_cast<const float*>(scale), static_cast<const float*>(vsq),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qsq),
      static_cast<float*>(bmax), B, d, nblk, l2);
  return static_cast<int>(cudaGetLastError());
}
