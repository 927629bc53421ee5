// IVF probe dots for Hopper (sm_90a).
//
// Replaces vearch_tpu/ops/pallas_kernels.py::ivf_probe_dots (Pallas body
// _probe_dots_kernel): for every query i and probe rank j it computes the
// raw dot products of the bf16-rounded query with every row of the probed
// int8 bucket,
//
//   out[i, j, r] = sum_k bf16(q[i, k]) * buckets[probes[i, j], r, k]
//
// as f32, [B, nprobe, cap]. A probe id < 0 (a padded probe slot) writes
// zeros, and so does an id >= nlist, so that the wrapper need not read
// the ids back to the host to check them. Score assembly (centroid term, dequant scale, norms, masking,
// top-r) stays in PyTorch (ops/probe_dots.py), as it stayed XLA in the
// reference.
//
// Bound at the main shape (B=1024, nprobe=64, d=128, cap=7040: the
// longest of 2048 buckets over 1M rows, whose mean is 488): 1.2e11
// operations (0.12 ms at the 989 TF/s bf16 tensor-core peak) against the
// distinct probed buckets read once (~0.84 GB) plus the [B, nprobe, cap]
// f32 output (1.85 GB), ~0.8 ms at 3.35 TB/s -- bound by bytes. The TPU
// version DMAs the probed bucket per (query, probe) grid step, and so does
// this first version: every (query, probe) pair re-reads its bucket, all
// cap rows of it, 59 GB at the main shape, mostly from HBM because the
// buckets do not fit the 50 MB L2. Per-bucket lengths (skip the padding)
// and grouping the pairs by bucket (load a bucket tile once, score every
// query that probes it) are the later fixes.
//
// Design: one thread block per (query, probe rank) on grid.x = B*nprobe.
// The block widens its query from bf16 to f32 in shared memory and reads
// the probe id once. Each warp takes kRowsPerWarp rows at a time: its 32
// lanes read consecutive 4-byte words of each row (a 128-byte coalesced
// load per row at d=128), so kRowsPerWarp loads are in flight per lane,
// then each row's sum is reduced across the warp with shuffles. A row
// that is not 4-byte aligned (d % 4 != 0) is read byte by byte. bf16 x
// int8 products are exact in f32, so only the summation order differs
// from the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;

__device__ __forceinline__ float dot4(int w, float4 q, float s) {
  s = fmaf((float)(int8_t)(w & 0xff), q.x, s);
  s = fmaf((float)(int8_t)((w >> 8) & 0xff), q.y, s);
  s = fmaf((float)(int8_t)((w >> 16) & 0xff), q.z, s);
  s = fmaf((float)(int8_t)((w >> 24) & 0xff), q.w, s);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
probe_dots_kernel(const __nv_bfloat16* __restrict__ q,  // [B, d]
                  const int* __restrict__ probes,        // [B, nprobe]
                  const int8_t* __restrict__ buckets,    // [nlist, cap, d]
                  float* __restrict__ out,               // [B, nprobe, cap]
                  int nprobe, int nlist, int cap, int d) {
  extern __shared__ float4 s_q4[];  // query i as f32, d rounded up to 4
  float* s_q = reinterpret_cast<float*>(s_q4);

  const long long pair = blockIdx.x;  // i * nprobe + j
  const long long i = pair / nprobe;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* dst = out + pair * cap;
  const int c = probes[pair];
  if (c < 0 || c >= nlist) {
    for (int r = tid; r < cap; r += kThreads) dst[r] = 0.f;
    return;
  }
  const int d4 = (d + 3) / 4;
  for (int k = tid; k < 4 * d4; k += kThreads)
    s_q[k] = k < d ? __bfloat162float(q[i * d + k]) : 0.f;
  __syncthreads();

  const int8_t* bucket = buckets + (long long)c * cap * d;
  for (int r0 = warp * kRowsPerWarp; r0 < cap; r0 += kWarps * kRowsPerWarp) {
    float s[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) s[u] = 0.f;
    if (kWords) {
      for (int w = lane; w < d4; w += 32) {
        const float4 qv = s_q4[w];
        int v[kRowsPerWarp];
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u)
          v[u] = r0 + u < cap ? __ldg(reinterpret_cast<const int*>(
                                          bucket + (long long)(r0 + u) * d) +
                                      w)
                              : 0;
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u) s[u] = dot4(v[u], qv, s[u]);
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float qk = s_q[k];
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u)
          if (r0 + u < cap)
            s[u] = fmaf((float)bucket[(long long)(r0 + u) * d + k], qk, s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const float t = warp_sum(s[u]);
      if (lane == u && r0 + u < cap) dst[r0 + u] = t;
    }
  }
}

}  // namespace

extern "C" int vt_ivf_probe_dots(const void* q, const void* probes,
                                 const void* buckets, void* out, int B,
                                 int nprobe, int nlist, int cap, int d,
                                 void* stream) {
  if (B <= 0 || nprobe <= 0 || cap <= 0) return 0;
  const dim3 grid((unsigned)((long long)B * nprobe));
  const size_t smem = sizeof(float) * 4 * ((d + 3) / 4);
  const bool words =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(buckets) & 3) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* pp = static_cast<const int*>(probes);
  const auto* bp = static_cast<const int8_t*>(buckets);
  auto* op = static_cast<float*>(out);
  if (words)
    probe_dots_kernel<true><<<grid, kThreads, smem, s>>>(qp, pp, bp, op,
                                                         nprobe, nlist, cap, d);
  else
    probe_dots_kernel<false><<<grid, kThreads, smem, s>>>(qp, pp, bp, op,
                                                          nprobe, nlist, cap,
                                                          d);
  return static_cast<int>(cudaGetLastError());
}
