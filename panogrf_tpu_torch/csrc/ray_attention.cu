// The aggregation net's ray attention in one pass for Hopper (sm_90a): for
// every ray, from the cross-view pool's geo rows (16 channels a sample,
// bfloat16) and nvalid to the post-LayerNorm features that out_geometry_fc
// reads: renderer/agg_net.py IBRNetWithNeuRay.forward's position add and
// MultiHeadAttention.forward (4 heads, d_k = d_v = 4, query rows with
// nvalid <= 1 masked, fc, residual, LayerNorm with eps 1e-6).
//
// It replaces no TPU kernel.  The JAX package's attention is jnp that XLA
// fuses (panogrf_tpu/renderer/agg_net.py).  The port's plain PyTorch chain
// runs it as ~20 kernels a call.  At the walkthrough's call (16,384 rays x
// 64 samples) its (rays, 4, 64, 64) bfloat16 score tensor is 537 MB, which
// the matrix product, the -1e9 fill, the mask's where, the softmax and the
// second product write and read ~8 times, and its LayerNorm runs PyTorch's
// wide-row kernel over a million 16-wide rows: ~4.3 ms a call on an H100.
//
// What bounds it on the H100: a sample reads 34 B (geo, nvalid) and writes
// 32 B (69 MB a call: 0.02 ms at 3.35 TB/s).  Its products are ~6.4 GFLOP
// a call at dn = 64 (0.096 ms at the float32 peak of 67 TFLOP/s), two
// thirds of them the scores and weighted values, and it takes 268 M
// exponentials (0.07 ms on the SFUs).  So no score may reach memory, and
// the attention loop (~13 instructions a query, head and key) sets the
// pace.  This design:
//
// * A persistent grid of blocks of 8 warps walks tiles of R consecutive
//   rays (R = 8 / ceil(dn / 32): 4 at dn = 64).  A warp takes 32 sample
//   slots of one ray (queries qb .. qb + 31); lane (g, t) owns head t of
//   slots g, g + 8, g + 16, g + 24 from the staging to the output.
// * Staging: a lane loads channels 4t .. 4t + 3 of its slots' geo rows (8
//   bytes each; a quad reads a whole 32-byte row) and position rows, and
//   the warp projects x = geo + position to q, k and v with mma.sync
//   m16n8k8 (TF32 operands, float32 sums) over two 16-row tiles.  The K
//   and N orders of the products are permuted (ops/kernels/ray_attention.py
//   packs the weights in fragment order to match), so the A fragment a lane
//   builds is its own x channels 4t .. 4t + 3 and the C fragment it gets
//   back is head t's q, k and v of its slots.  q stays in registers; k and
//   v go to shared memory as float32 (the only per-sample data there).
// * Attention: over the ray's dn keys, one float4 load of a key's k and
//   one of its v (shared by the 8 lanes of a head) serve 4 queries.  The
//   softmax runs online in blocks of 8 keys in float32, exp2 with the
//   log2(e) / sqrt(d_k) scale folded into q; no score leaves registers.  A
//   masked query has q = 0, so every score is 0 and it averages all keys
//   uniformly, as the plain chain's -1e9 fill does.  No key is masked.
// * Output: the heads' outputs of a lane are the A fragment of fc in the
//   same permuted order, so fc is two more mma.sync tiles with no exchange
//   between lanes; the residual, the LayerNorm (two quad shuffles a
//   moment) and the 8-byte bfloat16 stores of channels 4t .. 4t + 3 follow.
//
// bfloat16 is kept where the plain chain takes it in and gives it out (geo,
// the output).  Between them every sum, the softmax and the LayerNorm are
// float32; the products' operands x and the heads' outputs are rounded to
// TF32 (10-bit mantissa; the plain chain rounds them, and every other
// intermediate, to bfloat16's 7 bits).  The weights are the plain bfloat16
// call's (rounded to bfloat16, exact in TF32), the position table float32.
//
// On an H100 (700 W) the walkthrough's call takes ~0.21 ms, ~45% of its
// operations bound, with two blocks of 113 registers a SM.  The attention
// loop is held by latency at that occupancy: one block a SM took 1.2-1.4x
// as long, while fewer instructions a key (a lazily rescaled softmax),
// full-warp broadcasts of k and v, or no exponentials at all each moved an
// earlier, all-CUDA-core version of this kernel by under 3%.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 16;                 // d_model
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQpt = 4;                // query slots a lane, one head
constexpr int kWarpQueries = 8 * kQpt; // query slots a warp (two 16-row tiles)
constexpr int kKeyBlock = 8;           // keys a step of the online softmax
constexpr int kMaxDn = kWarps * kWarpQueries;
constexpr float kEps = 1e-6f;
constexpr float kQScale = 0.72134752044448170f;  // log2(e) / sqrt(d_k)

// The packed weights (ops/kernels/ray_attention.py pack_attention_weights),
// in floats: q, k, v and fc, each 256 floats in B-fragment order (lane,
// k step, n tile, b0 / b1), then the LayerNorm's gamma and beta.
constexpr int kFrag = kD * kD;
constexpr int kFc = 3 * kFrag;
constexpr int kGamma = 4 * kFrag;
constexpr int kBeta = kGamma + kD;
constexpr int kWeights = kBeta + kD;
static_assert(kWeights == 1056 && kWeights % 4 == 0, "whole float4s");

__host__ __device__ inline int per_ray(int dn) { return (dn + kWarpQueries - 1) / kWarpQueries; }
__host__ inline int rays_a_block(int dn) { return kWarps / per_ray(dn); }
// shared memory: the weights, then k and v of the tile's rays, dn x 16 each
__host__ inline int smem_bytes(int dn) {
  return (kWeights + 2 * rays_a_block(dn) * dn * kD) * int(sizeof(float));
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16 x 8, row) @ b (8 x 8, col), TF32 operands, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// The A fragments of a lane's 4 slots x channels 4t .. 4t + 3: 16-row tile
// mt (slots 2 mt, 2 mt + 1 in rows g, g + 8), k step kk (channels 4t + 2 kk
// and 4t + 2 kk + 1 in columns t and t + 4).
__device__ __forceinline__ void a_frags(const float4 (&x)[kQpt], uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      a[mt][kk][0] = tf32(comp(x[2 * mt], 2 * kk));
      a[mt][kk][1] = tf32(comp(x[2 * mt + 1], 2 * kk));
      a[mt][kk][2] = tf32(comp(x[2 * mt], 2 * kk + 1));
      a[mt][kk][3] = tf32(comp(x[2 * mt + 1], 2 * kk + 1));
    }
}

// y[i] = channels 4t .. 4t + 3 of W x for the lane's 4 slots, W's fragments
// at wf (n tile nt of the product holds channels 4t + 2 nt, + 1 in columns
// 2t, 2t + 1).
__device__ __forceinline__ void project(const float* wf, int lane, const uint32_t (&a)[2][2][4],
                                        float4 (&y)[kQpt]) {
  const float4 b0 = ld4(wf + lane * 8), b1 = ld4(wf + lane * 8 + 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(c0, a[mt][0], b0.x, b0.y);
    mma_tf32(c1, a[mt][0], b0.z, b0.w);
    mma_tf32(c0, a[mt][1], b1.x, b1.y);
    mma_tf32(c1, a[mt][1], b1.z, b1.w);
    y[2 * mt] = make_float4(c0[0], c0[1], c1[0], c1[1]);
    y[2 * mt + 1] = make_float4(c0[2], c0[3], c1[2], c1[3]);
  }
}

__device__ __forceinline__ float dot4(const float4& q, const float4& k, float init) {
  return fmaf(q.w, k.w, fmaf(q.z, k.z, fmaf(q.y, k.y, fmaf(q.x, k.x, init))));
}

// One step of the online softmax over keys j0 .. j0 + kKeyBlock of a head
// (k and v rows at kr, vr, this lane's head; kTail guards keys past dn): the
// block's scores, the running maximum m moved to theirs (the sums so far
// scaled down; on the first block m is -inf and they are 0), then the sums
// l and acc of the block's weights.
template <bool kTail>
__device__ __forceinline__ void key_block(const float* kr, const float* vr, int j0, int dn,
                                          const float4 (&q)[kQpt], float (&m)[kQpt],
                                          float (&l)[kQpt], float4 (&acc)[kQpt]) {
  float s[kQpt][kKeyBlock];
#pragma unroll
  for (int jj = 0; jj < kKeyBlock; ++jj) {
    const bool live = !kTail || j0 + jj < dn;
    const float4 k = live ? ld4(kr + (j0 + jj) * kD) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kQpt; ++i) {
      const float d = fmaf(q[i].w, k.w, fmaf(q[i].z, k.z, fmaf(q[i].y, k.y, q[i].x * k.x)));
      s[i][jj] = live ? d : neg_inf();
    }
  }
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    float top = s[i][0];
#pragma unroll
    for (int jj = 1; jj < kKeyBlock; ++jj) top = fmaxf(top, s[i][jj]);
    const float mn = fmaxf(m[i], top);
    const float corr = ex2(m[i] - mn);
    m[i] = mn;
    l[i] *= corr;
    acc[i].x *= corr;
    acc[i].y *= corr;
    acc[i].z *= corr;
    acc[i].w *= corr;
  }
#pragma unroll
  for (int jj = 0; jj < kKeyBlock; ++jj) {
    const bool live = !kTail || j0 + jj < dn;
    const float4 v = live ? ld4(vr + (j0 + jj) * kD) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kQpt; ++i) {
      const float p = ex2(s[i][jj] - m[i]);
      l[i] += p;
      acc[i].x = fmaf(p, v.x, acc[i].x);
      acc[i].y = fmaf(p, v.y, acc[i].y);
      acc[i].z = fmaf(p, v.z, acc[i].z);
      acc[i].w = fmaf(p, v.w, acc[i].w);
    }
  }
}

// x of a lane's slot: channels 4t .. 4t + 3 of its geo row (bfloat16 bits)
// plus the same of its position row.
__device__ __forceinline__ float4 x_of(uint2 bits, const float* pos_row) {
  const float4 p = ld4(pos_row);
  return make_float4(__uint_as_float(bits.x << 16) + p.x,
                     __uint_as_float(bits.x & 0xffff0000u) + p.y,
                     __uint_as_float(bits.y << 16) + p.z,
                     __uint_as_float(bits.y & 0xffff0000u) + p.w);
}

__global__ void __launch_bounds__(kThreads, 2)
ray_attention_kernel(const __nv_bfloat16* __restrict__ geo,
                     const __nv_bfloat16* __restrict__ nvalid, const float* __restrict__ pos,
                     const float* __restrict__ weights, __nv_bfloat16* __restrict__ out, int nr,
                     int dn, int rn, int rays) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                              // the packed weights
  float* ks = ws + kWeights;                     // k of the tile's rays, [ray][key][16]
  float* vs = ks + rays * dn * kD;               // v, the same
  for (int i = threadIdx.x; i < kWeights / 4; i += kThreads)
    reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(weights)[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pr = per_ray(dn);
  const int r = warp / pr;                       // the warp's ray within a tile
  const int qb = (warp - r * pr) * kWarpQueries; // and its first query slot
  const bool working = r < rays;
  const int tiles = (nr + rays - 1) / rays;
  const unsigned short* nv_bits = reinterpret_cast<const unsigned short*>(nvalid);
  const float* kr = ks + (r * dn) * kD + 4 * t;
  const float* vr = vs + (r * dn) * kD + 4 * t;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ray = tile * rays + r;
    const bool live_ray = working && ray < nr;
    // the row of the ray's sample d is row0 + d * rn
    const int64_t row0 = int64_t(ray / rn) * dn * rn + ray % rn;
    float4 q[kQpt];
    if (live_ray) {
      // stage: x of the lane's slots, then q (kept), k and v (to shared)
      float4 x[kQpt];
      float qs[kQpt];
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        const int d = qb + g + 8 * i;
        const int64_t row = row0 + int64_t(d) * rn;
        const uint2 bits = d < dn ? *reinterpret_cast<const uint2*>(geo + row * kD + 4 * t)
                                  : make_uint2(0u, 0u);
        x[i] = x_of(bits, pos + (d < dn ? d : 0) * kD + 4 * t);
        // a query row with nvalid <= 1 is masked: q = 0 averages every key
        qs[i] = d < dn && __uint_as_float(uint32_t(nv_bits[row]) << 16) > 1.f ? kQScale : 0.f;
      }
      uint32_t a[2][2][4];
      a_frags(x, a);
      float4 kv[kQpt];
      project(ws + 0 * kFrag, lane, a, q);
      project(ws + 1 * kFrag, lane, a, kv);
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        const int d = qb + g + 8 * i;
        if (d < dn) st4(ks + (r * dn + d) * kD + 4 * t, kv[i]);
        q[i].x *= qs[i];
        q[i].y *= qs[i];
        q[i].z *= qs[i];
        q[i].w *= qs[i];
      }
      project(ws + 2 * kFrag, lane, a, kv);
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        const int d = qb + g + 8 * i;
        if (d < dn) st4(vs + (r * dn + d) * kD + 4 * t, kv[i]);
      }
    }
    __syncthreads();

    float4 o[kQpt];
    if (live_ray) {
      // attend over the ray's dn keys
      float4 acc[kQpt];
      float m[kQpt], l[kQpt];
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        m[i] = neg_inf();
        l[i] = 0.f;
      }
      const int full = dn - dn % kKeyBlock;
      for (int j0 = 0; j0 < full; j0 += kKeyBlock)
        key_block<false>(kr, vr, j0, dn, q, m, l, acc);
      if (full < dn) key_block<true>(kr, vr, full, dn, q, m, l, acc);
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        const float inv = 1.f / l[i];
        o[i] = make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
      }
    }
    __syncthreads();   // k and v of this tile are read; the next tile may stage

    if (live_ray) {
      // fc (the heads' outputs are its A fragments as they lie), the
      // residual and the LayerNorm of each slot, across the lane's quad
      uint32_t a[2][2][4];
      a_frags(o, a);
      float4 y[kQpt];
      project(ws + kFc, lane, a, y);
      const float4 gamma = ld4(ws + kGamma + 4 * t), beta = ld4(ws + kBeta + 4 * t);
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        const int d = qb + g + 8 * i;
        const uint2 bits = d < dn ? *reinterpret_cast<const uint2*>(
                                        geo + (row0 + int64_t(d) * rn) * kD + 4 * t)
                                  : make_uint2(0u, 0u);
        const float4 x = x_of(bits, pos + (d < dn ? d : 0) * kD + 4 * t);
        float4 z = make_float4(y[i].x + x.x, y[i].y + x.y, y[i].z + x.z, y[i].w + x.w);
        float sum = (z.x + z.y) + (z.z + z.w);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float mean = sum * (1.f / kD);
        z.x -= mean;
        z.y -= mean;
        z.z -= mean;
        z.w -= mean;
        float var = fmaf(z.x, z.x, fmaf(z.y, z.y, fmaf(z.z, z.z, z.w * z.w)));
        var += __shfl_xor_sync(0xffffffffu, var, 1);
        var += __shfl_xor_sync(0xffffffffu, var, 2);
        const float inv = 1.f / sqrtf(var * (1.f / kD) + kEps);
        if (d < dn) {
          const uint2 packed = make_uint2(
              pack_bf16(fmaf(z.x * inv, gamma.x, beta.x), fmaf(z.y * inv, gamma.y, beta.y)),
              pack_bf16(fmaf(z.z * inv, gamma.z, beta.z), fmaf(z.w * inv, gamma.w, beta.w)));
          *reinterpret_cast<uint2*>(out + (int64_t(ray) * dn + d) * kD + 4 * t) = packed;
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes: bfloat16 geo (n, 16) and nvalid (n,) with
// n = nr dn, their rows ordered (nr / rn, dn, rn) (depth-major; rn = 1 is
// ray-major), the float32 position table (dn, 16), the packed float32
// weights (n_weights: q, k, v and fc in fragment order, gamma, beta) and the
// output (nr, dn, 16) bfloat16, all on the device; geo, pos, weights and
// out 16-byte aligned.  Returns the launch's cudaGetLastError() (0 on
// success); -1 for arguments outside what the kernel takes (the Python
// wrapper checks them first).
extern "C" int panogrf_ray_attention(const void* geo, const void* nvalid, const void* pos,
                                     const void* weights, void* out, int nr, int dn, int rn,
                                     int n_weights, void* stream) {
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(geo) |
                              reinterpret_cast<uintptr_t>(pos) |
                              reinterpret_cast<uintptr_t>(weights) |
                              reinterpret_cast<uintptr_t>(out);
  if (nr <= 0 || dn <= 0 || dn > kMaxDn || rn <= 0 || nr % rn != 0 ||
      n_weights != kWeights || addresses % 16 != 0)
    return -1;
  // per device: the SMs, and the resident blocks a SM at each dn
  static int sms[64] = {0}, per_sm[64][kMaxDn + 1] = {{0}};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 0 || dev >= 64) return -1;
  const int smem = smem_bytes(dn);
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
  }
  if (per_sm[dev][dn] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev][dn], ray_attention_kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return int(e);
    if (per_sm[dev][dn] < 1) per_sm[dev][dn] = 1;
  }
  const int rays = rays_a_block(dn);
  const int64_t tiles = (int64_t(nr) + rays - 1) / rays;
  const int64_t cap = int64_t(sms[dev]) * per_sm[dev][dn];
  const int blocks = int(tiles < cap ? tiles : cap);
  ray_attention_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(geo), static_cast<const __nv_bfloat16*>(nvalid),
      static_cast<const float*>(pos), static_cast<const float*>(weights),
      static_cast<__nv_bfloat16*>(out), nr, dn, rn, rays);
  return int(cudaGetLastError());
}
