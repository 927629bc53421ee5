// IVF probe dots for Hopper (sm_90a): length-aware, grouped by bucket.
//
// Replaces vearch_tpu/ops/pallas_kernels.py::ivf_probe_dots (Pallas body
// _probe_dots_kernel): for every query i and probe rank j it computes the
// raw dot products of the bf16-rounded query with every row of the probed
// int8 bucket,
//
//   out[i, j, r] = sum_k bf16(q[i, k]) * buckets[probes[i, j], r, k]
//
// as f32, [B, nprobe, cap], with out[i, j, r] = 0 for r >= lens[c] (c =
// probes[i, j]): a row past its bucket's live length is never read. On
// the index's own buckets those rows are zero bytes, so the output is the
// TPU kernel's. A probe id < 0 (a padded probe slot) or >= nlist writes a
// row of zeros, so the wrapper need not read the ids back to the host.
// Score assembly (centroid term, dequant scale, norms, masking, top-r)
// stays in PyTorch (ops/probe_dots.py), as it stayed XLA in the reference.
//
// Bound: the live rows of the distinct probed buckets, read once, plus
// the [B, nprobe, cap] f32 output, written once (1.85 GB at the main
// shape: B=1024, nprobe 64, cap 7040), against 2 * d * sum over pairs of
// lens[c] operations (4e10 there: the probes favour the long buckets, a
// mean live length of ~2360 rows per pair) -- bound by the bytes of the
// output, 0.04 ms of bf16 tensor-core time against ~0.58 ms of writes.
//
// Design. The wrapper sorts the B*nprobe (query, probe) pairs by probe id
// on the device (stable), with segment offsets per bucket; ids < 0 or >=
// nlist form segment nlist, which writes zeros. The grid is fixed, x =
// row tiles of kTileRows rows over cap, y = nlist + 1 segments, so no host
// read sizes it; an empty segment exits at once. A CTA (bucket c, tile)
//
// - past lens[c] (the padding, most of the output): writes zeros for every
//   pair of the segment with 16-byte stores;
// - otherwise: takes the segment's pairs kGroup at a time. Per 64-byte K
//   slice it stages the tile's live rows (int8) and the group's queries
//   (bf16 as they are) in shared memory, and 8 warps run bf16
//   mma.sync.m16n8k16 with f32 accumulation: a warp owns 16 rows x 32
//   pairs, its A fragments are the int8 rows converted in registers (the
//   2^23 magic-number trick, exact: int8 is exact in bf16), its B
//   fragments 8-byte loads of the queries. K is permuted inside each
//   16-wide step, identically for both, so that a thread's 4 contiguous
//   bytes are the 4 k slots its fragments hold. n8 tiles past the
//   group's last pair are skipped, warp by warp. Rows past lens[c] are
//   never loaded (zero in shared memory) and their outputs are 0. The
//   products go through shared memory ([pair][row]) so that each pair's
//   output row is written with 16-byte stores, 256 contiguous bytes per
//   16 lanes.
//
// So every live row of a probed bucket tile is read from device memory
// once per group of kGroup pairs (once, for all but the most-probed
// buckets), and every output byte is written once. bf16 x int8 products
// are exact in f32, so only the summation order differs from the plain
// PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;     // bucket rows per CTA
constexpr int kGroup = 64;        // (query, probe) pairs per pass
constexpr int kSlice = 64;        // K bytes (and bf16 values) per stage
// padded strides (words) that keep the fragment loads conflict-free
constexpr int kRowWords = kSlice / 4 + 4;   // a row of the int8 tile
constexpr int kQWords = kSlice / 2 + 8;     // a query, bf16
constexpr int kOutStride = kTileRows + 4;   // a pair's products, f32

__device__ __forceinline__ float byte_to_f32(uint32_t flipped, uint32_t k) {
  // 0x4B0000xx is 2^23 + xx; xx = byte ^ 0x80 = byte + 128: exact
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440u | k)) -
         8388736.0f;
}

// zeros for rows [r0, r1) of `n` pairs' output rows
template <bool kVec>
__device__ __forceinline__ void write_zeros(float* __restrict__ out,
                                            const int* __restrict__ order,
                                            int n, int cap, int r0, int r1) {
  const int w = r1 - r0;
  if (kVec) {  // cap % 4 == 0, so r0 and w are multiples of 4
    const int w4 = w / 4;
    for (int e = threadIdx.x; e < n * w4; e += kThreads) {
      const int p = e / w4, c = e - p * w4;
      float* dst = out + (long long)order[p] * cap + r0;
      reinterpret_cast<float4*>(dst)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < n * w; e += kThreads) {
      const int p = e / w, c = e - p * w;
      out[(long long)order[p] * cap + r0 + c] = 0.f;
    }
  }
}

// bf16 m16n8k16 tensor-core product, f32 accumulate: D += A * B
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <bool kWords, bool kVec>
__global__ void __launch_bounds__(kThreads)
probe_dots_kernel(const __nv_bfloat16* __restrict__ q,  // [B, d]
                  const int* __restrict__ order,         // [B*nprobe]
                  const int* __restrict__ offs,          // [nlist + 2]
                  const int* __restrict__ lens,          // [nlist]
                  const int8_t* __restrict__ buckets,    // [nlist, cap, d]
                  float* __restrict__ out,               // [B, nprobe, cap]
                  int nprobe, int nlist, int cap, int d, bool vec_rows,
                  bool vec_q) {
  // the tile's rows, one K slice: [row][kRowWords] words, natural order
  __shared__ __align__(16) uint32_t s_rows[kTileRows * kRowWords];
  // the group's queries, one K slice, bf16: [pair][kQWords] words
  __shared__ __align__(16) uint32_t s_q[kGroup * kQWords];
  // the products, [pair][row], for full-width stores
  __shared__ __align__(16) float s_out[kGroup * kOutStride];
  __shared__ int s_pair[kGroup];

  const int c = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int lo = offs[c], hi = offs[c + 1];
  if (lo >= hi || r0 >= cap) return;
  const int r1 = min(r0 + kTileRows, cap);
  const int len = c < nlist ? min(max(lens[c], 0), cap) : 0;
  if (r0 >= len) {
    write_zeros<kVec>(out, order + lo, hi - lo, cap, r0, r1);
    return;
  }
  const int live = min(len, r1) - r0;  // live rows of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warp tile: 16 rows (M tile warp & 3) x 32 pairs (n8 tiles 4*(warp>>2)..)
  const int mrow = 16 * (warp & 3);
  const int n0 = 32 * (warp >> 2);
  const int8_t* tile = buckets + ((long long)c * cap + r0) * d;

  for (int p0 = lo; p0 < hi; p0 += kGroup) {
    const int ng = min(kGroup, hi - p0);
    __syncthreads();  // the previous group's s_pair and s_out are read
    if (tid < kGroup) s_pair[tid] = tid < ng ? order[p0 + tid] : -1;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kSlice) {
      __syncthreads();  // previous slice consumed; s_pair written
      // live rows of this slice, zero past d and past `live`
      for (int e = tid; e < kTileRows * 4; e += kThreads) {
        const int r = e >> 2, j = e & 3;
        const int k = k0 + 16 * j;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (r < live) {
          const int8_t* src = tile + (long long)r * d + k;
          if (vec_rows && k + 16 <= d) {
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
            v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
          } else if (kWords) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (k + 4 * i < d)
                v[i] = __ldg(reinterpret_cast<const uint32_t*>(src) + i);
          } else {
#pragma unroll
            for (int i = 0; i < 16; ++i)
              if (k + i < d)
                v[i >> 2] |= (uint32_t)(uint8_t)src[i] << (8 * (i & 3));
          }
        }
        *reinterpret_cast<uint4*>(&s_rows[r * kRowWords + 4 * j]) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      // the group's queries of this slice, bf16 as they are
      for (int e = tid; e < kGroup * 8; e += kThreads) {
        const int p = e >> 3, j = e & 7;
        const int pair = s_pair[p];
        const int k = k0 + 8 * j;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (pair >= 0 && k < d) {
          const __nv_bfloat16* src = q + (long long)(pair / nprobe) * d + k;
          if (vec_q) {
            x = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (k + i < d)
                w[i >> 1] |= (uint32_t)__bfloat16_as_ushort(src[i])
                             << (16 * (i & 1));
            x = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
        *reinterpret_cast<uint4*>(&s_q[p * kQWords + 4 * j]) = x;
      }
      __syncthreads();
      // K is permuted inside each 16-wide step: a thread's 4 bytes at
      // 4t..4t+3 of the step fill the A fragment's k slots 2t, 2t+1,
      // 2t+8, 2t+9, and the query's 4 bf16 at the same place fill B's
      const int steps = min(4, (d - k0 + 15) / 16);
      for (int st = 0; st < steps; ++st) {
        const uint32_t wa = s_rows[(mrow + g) * kRowWords + 4 * st + t];
        const uint32_t wb = s_rows[(mrow + g + 8) * kRowWords + 4 * st + t];
        const uint32_t xa = wa ^ 0x80808080u, xb = wb ^ 0x80808080u;
        const uint32_t a[4] = {
            pack_bf16x2(byte_to_f32(xa, 0), byte_to_f32(xa, 1)),
            pack_bf16x2(byte_to_f32(xb, 0), byte_to_f32(xb, 1)),
            pack_bf16x2(byte_to_f32(xa, 2), byte_to_f32(xa, 3)),
            pack_bf16x2(byte_to_f32(xb, 2), byte_to_f32(xb, 3))};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n0 + 8 * j >= ng) break;  // warp-uniform: pairs past the group
          const uint2 b = *reinterpret_cast<const uint2*>(
              &s_q[(n0 + 8 * j + g) * kQWords + 8 * st + 2 * t]);
          mma_bf16(acc[j], a, b.x, b.y);
        }
      }
    }
    // accumulator i of n8 tile j: row mrow+g (+8 for i >= 2), pair
    // n0+8j+2t (+1 for odd i); rows past the live length give 0
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mrow + g + 8 * (i >> 1);
        s_out[(n0 + 8 * j + 2 * t + (i & 1)) * kOutStride + r] =
            r < live ? acc[j][i] : 0.f;
      }
    __syncthreads();
    // each pair's rows [r0, r1) from s_out: 16 lanes, 256 bytes a pair
    const int w = r1 - r0;
    if (kVec) {
      const int w4 = w / 4;
      for (int e = tid; e < ng * w4; e += kThreads) {
        const int p = e / w4, cc = e - p * w4;
        *reinterpret_cast<float4*>(out + (long long)s_pair[p] * cap + r0 +
                                   4 * cc) =
            *reinterpret_cast<const float4*>(&s_out[p * kOutStride + 4 * cc]);
      }
    } else {
      for (int e = tid; e < ng * w; e += kThreads) {
        const int p = e / w, cc = e - p * w;
        out[(long long)s_pair[p] * cap + r0 + cc] = s_out[p * kOutStride + cc];
      }
    }
  }
}

template <bool kWords>
int launch(bool vec, dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
           const int* order, const int* offs, const int* lens,
           const int8_t* buckets, float* out, int nprobe, int nlist, int cap,
           int d) {
  // 16-byte row loads (4 words) and 16-byte query loads (8 bf16)
  const bool vec_rows =
      d % 16 == 0 && (reinterpret_cast<uintptr_t>(buckets) & 15) == 0;
  const bool vec_q = d % 8 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  if (vec)
    probe_dots_kernel<kWords, true><<<grid, kThreads, 0, s>>>(
        q, order, offs, lens, buckets, out, nprobe, nlist, cap, d, vec_rows,
        vec_q);
  else
    probe_dots_kernel<kWords, false><<<grid, kThreads, 0, s>>>(
        q, order, offs, lens, buckets, out, nprobe, nlist, cap, d, vec_rows,
        vec_q);
  return (int)cudaGetLastError();
}

}  // namespace

// order: the B*nprobe pair indices (i*nprobe + j) sorted by probe id;
// offs[c]..offs[c+1]: segment of bucket c, offs[nlist]..offs[nlist+1]:
// the pairs whose id is < 0 or >= nlist
extern "C" int vt_ivf_probe_dots(const void* q, const void* order,
                                 const void* offs, const void* lens,
                                 const void* buckets, void* out, int B,
                                 int nprobe, int nlist, int cap, int d,
                                 void* stream) {
  if (B <= 0 || nprobe <= 0 || cap <= 0) return 0;
  if (nlist + 1 > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((cap + kTileRows - 1) / kTileRows),
                  (unsigned)(nlist + 1));
  const bool words =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(buckets) & 3) == 0;
  const bool vec = cap % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* op = static_cast<const int*>(order);
  const auto* fp = static_cast<const int*>(offs);
  const auto* lp = static_cast<const int*>(lens);
  const auto* bp = static_cast<const int8_t*>(buckets);
  auto* outp = static_cast<float*>(out);
  if (words)
    return launch<true>(vec, grid, s, qp, op, fp, lp, bp, outp, nprobe, nlist,
                        cap, d);
  return launch<false>(vec, grid, s, qp, op, fp, lp, bp, outp, nprobe, nlist,
                       cap, d);
}
