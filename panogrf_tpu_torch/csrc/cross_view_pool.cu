// The aggregation net's cross-view pool in one pass for Hopper (sm_90a):
// renderer/agg_net.py:pool_reference for every (ray, sample) point, from its
// per-view inputs rgb_feat (N, V, 35), neuray_feat (N, V, 32), ray_diff
// (N, V, 4) and mask (N, V, 1) to geo (N, 16), rgb (N, 3) and nvalid (N, 1),
// bfloat16 in and out, 2 <= V <= 4.
//
// It replaces no TPU kernel.  The JAX package has no Pallas kernel here: XLA
// fuses the pool chain (panogrf_tpu/renderer/agg_net.py:pool_reference) into
// a few loops.  The port's plain PyTorch version runs it as ~100 kernels a
// call: each ELU, concatenation, weighted mean/var and softmax step writes a
// (N, V, <= 64) bfloat16 tensor to device memory and reads it back, and each
// call casts the 17 weight matrices anew.  At the walkthrough's 1,048,576
// points a call (V = 2) that took ~16.9 ms on an H100.
//
// What bounds it on the H100: a point reads 144 V bytes and writes 40 (328 B
// at V = 2: 0.10 ms a call at 3.35 TB/s) and does ~72.6 kFLOP of matrix
// products (0.077 ms at 989 TFLOP/s) and ~630 exponentials (~0.16 ms on the
// SFUs).  So no intermediate may reach device memory, and the products have
// to run on the tensor cores.  This design:
//
// * One block of 8 warps takes a tile of 64 points; a persistent grid of one
//   or two blocks a SM walks the tiles.  The tile's inputs are contiguous
//   spans (64 V x 70 B of rgb_feat, and so on), staged into shared memory
//   with 16-byte cp.async, double-buffered against the previous tile's math.
// * The 25k weights live in one packed bfloat16 buffer (~58 KB), packed once
//   on the host (ops/kernels/cross_view_pool.py:pack_pool_weights, cached on
//   the module) in mma fragment order with every K and N padded, and staged
//   into shared memory once a block: a B fragment is one conflict-free
//   8-byte load a lane.
// * Every product is mma.sync.m16n8k16 with bfloat16 operands and float32
//   sums.  Each warp takes 8 points; view 2j of point g sits in row g and
//   view 2j + 1 in row g + 8 of the j-th 16-row tile, so a thread holds
//   every view of its point for its columns: the weighted mean/var, the
//   visibility normalisation and the softmax over views stay inside one
//   thread in float32.  A layer's accumulators are rounded to bfloat16 in
//   registers and serve as the next layer's A fragments (two 8-column C
//   tiles form one 16-deep A step), so the activations never leave
//   registers.  The per-point half of base_fc's first layer (the pooled
//   means and variances) is the same A fragment in rows g and g + 8; the
//   duplicate rows cost tensor-core work, not bytes.  The 1-wide heads
//   (neuray_fc, vis, the blend logit) land in the quad's first thread and
//   are broadcast with one shuffle.
// * bfloat16 is kept where the plain version materialises a bfloat16
//   tensor that a product reads (every A operand); sums, normalisations and
//   the softmax are float32, the outputs rounded to bfloat16.  mask is read
//   as the plain version reads it: a weight, and the test mask == 0 for the
//   blend logits.
//
// wgmma is not used: the layers are 4-240 deep and 8-64 wide, below its
// 64-row warpgroup tile with shared-memory operands, and the work is bound
// by bytes and the SFUs well before the tensor cores.
//
// On an H100 (700 W) a call of 1,048,576 points of 2 views takes ~0.79 ms,
// ~13% of the bytes bound.  By estimate (no hardware counters were read),
// the shared-memory reads of the B fragments (~7 KB a point) and each
// warp's chain of dependent layers set that pace, with 16 warps a SM at
// V = 2 (128 registers, two blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kF = 35;                 // rgb_feat channels (in_feat_ch + 3)
constexpr int kND = 32;                // neuray_feat channels
constexpr int kRD = 4;                 // ray_diff channels
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 8;      // points a block tile, 8 a warp
constexpr int kNrPitch = 40;           // neuray_feat row pitch in shared memory (80 B)
constexpr float kEps = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;

// The packed layers, in the buffer's order (ops/kernels/cross_view_pool.py
// LAYERS): padded K (a multiple of 16) and N (a multiple of 8).  Each layer
// is K x N weights in fragment order, then N biases.
enum Layer : int { RD0, RD1, NR0, NR1, BF0, BF1, VF0, VF1, VS0, VS1, GF0, GF1,
                   RG0, RG1, RG2, kLayers };

__host__ __device__ constexpr int layer_k(int l) {
  switch (l) {
    case RD0: case RD1: case NR1: case RG1: case RG2: return 16;
    case NR0: case VF0: case VF1: case VS0: case VS1: return 32;
    case BF0: return 240;   // [neuray | rgbf | pad | mean0 | var0 | mean1 | var1]
    case BF1: case GF1: return 64;
    case GF0: return 80;    // [mean | var | mean of the weights | pad]
    case RG0: return 48;    // [x | ray_diff, pad | vis, pad]
    default: return 0;
  }
}

__host__ __device__ constexpr int layer_n(int l) {
  switch (l) {
    case RD0: case GF1: case RG0: return 16;
    case RD1: case VF1: return 40;
    case NR0: case NR1: case VS1: case RG1: case RG2: return 8;
    case BF0: case GF0: return 64;
    case BF1: case VF0: case VS0: return 32;
    default: return 0;
  }
}

__host__ __device__ constexpr int weight_offset(int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += layer_k(i) * layer_n(i) + layer_n(i);
  return o;
}

constexpr int kPacked = weight_offset(kLayers);   // bfloat16 elements
static_assert(kPacked * 2 % 16 == 0, "the inputs' stages start 16-byte aligned");

// Shared memory of one stage of V-view inputs, in bytes.
__host__ __device__ constexpr int stage_bytes(int v) {
  return kTile * v * (kF + kNrPitch + kRD + 1) * 2;
}

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : __expf(x) - 1.f; }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + __expf(-x)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ float lo_f32(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f32(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }
__device__ __forceinline__ float bf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 inputs, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[vt] = layer L's bias in every row: thread (g, t) holds columns
// 8 nt + 2t, 8 nt + 2t + 1 of rows g (c[.][0..1]) and g + 8 (c[.][2..3]).
template <int L, int VT, int NT = layer_n(L) / 8>
__device__ __forceinline__ void bias_init(const __nv_bfloat16* w, int t,
                                          float (&c)[VT][NT][4]) {
  const __nv_bfloat16* b = w + weight_offset(L) + layer_k(L) * layer_n(L);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b + 8 * nt + 2 * t));
#pragma unroll
    for (int vt = 0; vt < VT; ++vt) {
      c[vt][nt][0] = c[vt][nt][2] = v.x;
      c[vt][nt][1] = c[vt][nt][3] = v.y;
    }
  }
}

// B fragment of layer L at k step s, n tile nt: lane's 8 bytes.
template <int L>
__device__ __forceinline__ void b_frag(const __nv_bfloat16* w, int lane, int s,
                                       int nt, uint32_t (&b)[2]) {
  constexpr int NT = layer_n(L) / 8;
  const uint2 v = reinterpret_cast<const uint2*>(w + weight_offset(L))[(s * NT + nt) * 32 + lane];
  b[0] = v.x;
  b[1] = v.y;
}

// c[vt] += a[vt] @ W_L over k steps S0 .. S0 + KS (each tile its own A).
template <int L, int S0, int KS, int VT, int NT = layer_n(L) / 8>
__device__ __forceinline__ void mma_steps(const __nv_bfloat16* w, int lane,
                                          const uint32_t (&a)[VT][KS][4],
                                          float (&c)[VT][NT][4]) {
  static_assert(S0 + KS <= layer_k(L) / 16, "k steps past the layer");
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[2];
      b_frag<L>(w, lane, S0 + s, nt, b);
#pragma unroll
      for (int vt = 0; vt < VT; ++vt) mma_bf16(c[vt][nt], a[vt][s], b);
    }
  }
}

// c[vt] += a @ W_L over k steps S0 .. S0 + KS, one A for every tile (the
// point's own inputs, alike in all its view rows).
template <int L, int S0, int KS, int VT, int NT = layer_n(L) / 8>
__device__ __forceinline__ void mma_steps_shared(const __nv_bfloat16* w, int lane,
                                                 const uint32_t (&a)[KS][4],
                                                 float (&c)[VT][NT][4]) {
  static_assert(S0 + KS <= layer_k(L) / 16, "k steps past the layer");
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[2];
      b_frag<L>(w, lane, S0 + s, nt, b);
#pragma unroll
      for (int vt = 0; vt < VT; ++vt) mma_bf16(c[vt][nt], a[s], b);
    }
  }
}

template <int VT, int NT>
__device__ __forceinline__ void elu_all(float (&c)[VT][NT][4]) {
#pragma unroll
  for (int vt = 0; vt < VT; ++vt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[vt][nt][i] = elu(c[vt][nt][i]);
}

// Accumulator n tiles 2s and 2s + 1 as k step s of the next product's A,
// each row scaled by its view's f (rounded to bf16); an odd last tile pairs
// with zeros.
template <int VT, int NT, int KS = (NT + 1) / 2>
__device__ __forceinline__ void to_a(const float (&c)[VT][NT][4], const float (&f)[2 * VT],
                                     uint32_t (&a)[VT][KS][4]) {
#pragma unroll
  for (int vt = 0; vt < VT; ++vt) {
    const float f0 = f[2 * vt], f1 = f[2 * vt + 1];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const float* lo = c[vt][2 * s];
      a[vt][s][0] = pack_bf16(lo[0] * f0, lo[1] * f0);
      a[vt][s][1] = pack_bf16(lo[2] * f1, lo[3] * f1);
      if (2 * s + 1 < NT) {
        const float* hi = c[vt][2 * s + 1];
        a[vt][s][2] = pack_bf16(hi[0] * f0, hi[1] * f0);
        a[vt][s][3] = pack_bf16(hi[2] * f1, hi[3] * f1);
      } else {
        a[vt][s][2] = a[vt][s][3] = 0u;
      }
    }
  }
}

template <int VT, int NT, int KS = (NT + 1) / 2>
__device__ __forceinline__ void to_a(const float (&c)[VT][NT][4], uint32_t (&a)[VT][KS][4]) {
  float one[2 * VT];
#pragma unroll
  for (int i = 0; i < 2 * VT; ++i) one[i] = 1.f;
  to_a(c, one, a);
}

// Column pair (2t, 2t + 1) of n tile j of a point's own A (rows g and
// g + 8 alike): k step j / 2, low or high half.
template <int KS>
__device__ __forceinline__ void put_point(uint32_t (&a)[KS][4], int j, float x0, float x1) {
  const uint32_t p = pack_bf16(x0, x1);
  a[j >> 1][(j & 1) * 2] = p;
  a[j >> 1][(j & 1) * 2 + 1] = p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Bytes [off, off + len) of src into dst, 16 a thread and step; bytes at or
// past `total` read as zeros.  len is a multiple of 16, src 16-byte aligned.
__device__ __forceinline__ void stage_span(unsigned char* dst, const unsigned char* src,
                                           int64_t off, int len, int64_t total) {
  for (int i = threadIdx.x * 16; i < len; i += kThreads * 16) {
    const int64_t left = total - (off + i);
    const int bytes = left >= 16 ? 16 : (left > 0 ? int(left) : 0);
    cp_async16(dst + i, bytes ? src + off + i : src, bytes);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, V == 2 ? 2 : 1)
cross_view_pool_kernel(const __nv_bfloat16* __restrict__ rgb,
                       const __nv_bfloat16* __restrict__ neuray,
                       const __nv_bfloat16* __restrict__ ray_diff,
                       const __nv_bfloat16* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ packed,
                       __nv_bfloat16* __restrict__ geo,
                       __nv_bfloat16* __restrict__ rgb_out,
                       __nv_bfloat16* __restrict__ nvalid, int n, int geometry_only) {
  constexpr int VT = (V + 1) / 2;      // 16-row tiles a warp: views 2j, 2j + 1 in tile j
  constexpr int VP = 2 * VT;           // view rows, a missing fourth included
  constexpr int kRows = kTile * V;     // (point, view) rows a tile
  constexpr int kRgbBytes = kRows * kF * 2;
  constexpr int kNrBytes = kRows * kNrPitch * 2;
  constexpr int kRdBytes = kRows * kRD * 2;
  constexpr int kStage = stage_bytes(V);
  static_assert(kRgbBytes % 16 == 0 && kNrBytes % 16 == 0 && kRdBytes % 16 == 0 &&
                kRows * 2 % 16 == 0, "stage spans are whole 16-byte chunks");

  extern __shared__ __align__(16) unsigned char smem[];
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(smem);
  unsigned char* stages = smem + kPacked * 2;

  const int tiles = (n + kTile - 1) / kTile;
  const int64_t rows_total = int64_t(n) * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pl = warp * 8 + g;         // this thread's point within the tile

  auto stage_tile = [&](int tile, int buf) {
    unsigned char* st = stages + buf * kStage;
    const int64_t r0 = int64_t(tile) * kRows;
    stage_span(st, reinterpret_cast<const unsigned char*>(rgb), r0 * kF * 2, kRgbBytes,
               rows_total * kF * 2);
    // neuray_feat rows (64 B) land at an 80-byte pitch
    unsigned char* nr = st + kRgbBytes;
    const unsigned char* nsrc = reinterpret_cast<const unsigned char*>(neuray);
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const bool live = r0 + r < rows_total;
      cp_async16(nr + r * kNrPitch * 2 + j * 16,
                 live ? nsrc + (r0 + r) * kND * 2 + j * 16 : nsrc, live ? 16 : 0);
    }
    stage_span(st + kRgbBytes + kNrBytes, reinterpret_cast<const unsigned char*>(ray_diff),
               r0 * kRD * 2, kRdBytes, rows_total * kRD * 2);
    stage_span(st + kRgbBytes + kNrBytes + kRdBytes,
               reinterpret_cast<const unsigned char*>(mask), r0 * 2, kRows * 2,
               rows_total * 2);
  };

  {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(packed);
    for (int i = threadIdx.x * 16; i < kPacked * 2; i += kThreads * 16)
      cp_async16(smem + i, src + i, 16);
  }
  int tile = blockIdx.x;
  if (tile < tiles) stage_tile(tile, 0);
  cp_async_commit();

  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    if (tile + int(gridDim.x) < tiles) stage_tile(tile + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();

    const unsigned char* st = stages + (it & 1) * kStage;
    const __nv_bfloat16* rgb_s = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* nr_s = reinterpret_cast<const __nv_bfloat16*>(st + kRgbBytes);
    const __nv_bfloat16* rd_s =
        reinterpret_cast<const __nv_bfloat16*>(st + kRgbBytes + kNrBytes);
    const __nv_bfloat16* mk_s =
        reinterpret_cast<const __nv_bfloat16*>(st + kRgbBytes + kNrBytes + kRdBytes);
    const int64_t point = int64_t(tile) * kTile + pl;

    // mask and weight = mask / (sum over views + eps); the missing fourth
    // view row (V = 3) reads 0 and enters no sum over views
    float m[VP], wv[VP];
    float msum = 0.f;
#pragma unroll
    for (int v = 0; v < VP; ++v) {
      m[v] = v < V ? bf(mk_s + pl * V + v) : 0.f;
      msum += m[v];
    }
    const float minv = 1.f / (msum + kEps);
#pragma unroll
    for (int v = 0; v < VP; ++v) wv[v] = m[v] * minv;

    // ray_diff as an A fragment: channels 2t, 2t + 1 in threads t < 2
    uint32_t a_rd[VT][1][4];
#pragma unroll
    for (int vt = 0; vt < VT; ++vt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * vt + h;
        a_rd[vt][0][h] = (v < V && t < 2) ? ld32(rd_s + (pl * V + v) * kRD + 2 * t) : 0u;
        a_rd[vt][0][2 + h] = 0u;
      }
    }

    // rgbf = rgb_feat + ray_dir_fc(ray_diff): 4 -> 16 ELU -> 35 ELU
    uint32_t a_rgbf[VT][3][4];
    {
      float c16[VT][2][4];
      bias_init<RD0>(w, t, c16);
      mma_steps<RD0, 0, 1>(w, lane, a_rd, c16);
      elu_all(c16);
      uint32_t a16[VT][1][4];
      to_a(c16, a16);
      float c40[VT][5][4];
      bias_init<RD1>(w, t, c40);
      mma_steps<RD1, 0, 1>(w, lane, a16, c40);
      elu_all(c40);
#pragma unroll
      for (int vt = 0; vt < VT; ++vt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = 2 * vt + h;
          if (v >= V) continue;
#pragma unroll
          for (int nt = 0; nt < 5; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * nt + 2 * t + e;
              if (col < kF) c40[vt][nt][2 * h + e] += bf(rgb_s + (pl * V + v) * kF + col);
            }
        }
      to_a(c40, a_rgbf);
    }

    // neuray_feat as A fragments (base_fc reads them again)
    uint32_t a_nr[VT][2][4];
#pragma unroll
    for (int vt = 0; vt < VT; ++vt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * vt + h;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const __nv_bfloat16* r = nr_s + (pl * V + v) * kNrPitch + 16 * s + 2 * t;
          a_nr[vt][s][h] = v < V ? ld32(r) : 0u;
          a_nr[vt][s][2 + h] = v < V ? ld32(r + 8) : 0u;
        }
      }

    // w0 = sigmoid(neuray_fc(neuray_feat)) * weight: 32 -> 8 ELU -> 1
    float w0[VP];
    {
      float c8[VT][1][4];
      bias_init<NR0>(w, t, c8);
      mma_steps<NR0, 0, 2>(w, lane, a_nr, c8);
      elu_all(c8);
      uint32_t a8[VT][1][4];
      to_a(c8, a8);
      bias_init<NR1>(w, t, c8);
      mma_steps<NR1, 0, 1>(w, lane, a8, c8);
#pragma unroll
      for (int vt = 0; vt < VT; ++vt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w0[2 * vt + h] =
              sigmoid(__shfl_sync(kFull, c8[vt][0][2 * h], lane & ~3)) * wv[2 * vt + h];
    }

    // [mean0 | var0 | mean1 | var1] of rgbf under w0 and weight: the point's
    // own A over gf n tiles 0-19 (5 per segment, columns past 35 zero)
    uint32_t a_gf[10][4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        float mean[2], var[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x[VP];
#pragma unroll
          for (int v = 0; v < VP; ++v) {
            const uint32_t p = a_rgbf[v >> 1][j >> 1][(j & 1) * 2 + (v & 1)];
            x[v] = e ? hi_f32(p) : lo_f32(p);
          }
          float mu = 0.f, s2 = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) mu += (q == 0 ? w0[v] : wv[v]) * x[v];
#pragma unroll
          for (int v = 0; v < V; ++v)
            s2 += (q == 0 ? w0[v] : wv[v]) * (x[v] - mu) * (x[v] - mu);
          mean[e] = mu;
          var[e] = s2;
        }
        put_point(a_gf, 10 * q + j, mean[0], mean[1]);
        put_point(a_gf, 10 * q + 5 + j, var[0], var[1]);
      }
    }

    // base_fc: [gf | rgbf | neuray_feat] -> 64 ELU -> 32 ELU = x
    float cx[VT][4][4];
    {
      float cb[VT][8][4];
      bias_init<BF0>(w, t, cb);
      mma_steps<BF0, 0, 2>(w, lane, a_nr, cb);
      mma_steps<BF0, 2, 3>(w, lane, a_rgbf, cb);
      mma_steps_shared<BF0, 5, 10>(w, lane, a_gf, cb);
      elu_all(cb);
      uint32_t a64[VT][4][4];
      to_a(cb, a64);
      bias_init<BF1>(w, t, cx);
      mma_steps<BF1, 0, 4>(w, lane, a64, cx);
      elu_all(cx);
    }

    // vis_fc(x * weight): 32 -> 32 ELU -> 33 ELU; x += the first 32, vis =
    // sigmoid(the last) * mask
    float vis[VP];
    uint32_t a32[VT][2][4];
    {
      to_a(cx, wv, a32);
      float c32[VT][4][4];
      bias_init<VF0>(w, t, c32);
      mma_steps<VF0, 0, 2>(w, lane, a32, c32);
      elu_all(c32);
      to_a(c32, a32);
      float c40[VT][5][4];
      bias_init<VF1>(w, t, c40);
      mma_steps<VF1, 0, 2>(w, lane, a32, c40);
      elu_all(c40);
#pragma unroll
      for (int vt = 0; vt < VT; ++vt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) cx[vt][nt][i] += c40[vt][nt][i];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          vis[2 * vt + h] =
              sigmoid(__shfl_sync(kFull, c40[vt][4][2 * h], lane & ~3)) * m[2 * vt + h];
      }
    }

    // vis_fc2(x * vis): 32 -> 32 ELU -> 1; vis = sigmoid(it) * mask
    {
      to_a(cx, vis, a32);
      float c32[VT][4][4];
      bias_init<VS0>(w, t, c32);
      mma_steps<VS0, 0, 2>(w, lane, a32, c32);
      elu_all(c32);
      to_a(c32, a32);
      float c8[VT][1][4];
      bias_init<VS1>(w, t, c8);
      mma_steps<VS1, 0, 2>(w, lane, a32, c8);
#pragma unroll
      for (int vt = 0; vt < VT; ++vt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          vis[2 * vt + h] =
              sigmoid(__shfl_sync(kFull, c8[vt][0][2 * h], lane & ~3)) * m[2 * vt + h];
    }

    // geometry_fc([mean | var of x under wgt | mean of wgt over views]):
    // 65 -> 64 ELU -> 16 ELU = geo, one 16-row tile (rows g, g + 8 alike)
    {
      float vsum = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) vsum += vis[v];
      const float vinv = 1.f / (vsum + kEps);
      float wg[VP], wmean = 0.f;
#pragma unroll
      for (int v = 0; v < VP; ++v) wg[v] = vis[v] * vinv;
#pragma unroll
      for (int v = 0; v < V; ++v) wmean += wg[v];
      wmean /= V;
      uint32_t ag[1][5][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float mean[2], var[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mu = 0.f, s2 = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) mu += wg[v] * cx[v >> 1][j][(v & 1) * 2 + e];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float d = cx[v >> 1][j][(v & 1) * 2 + e] - mu;
            s2 += wg[v] * d * d;
          }
          mean[e] = mu;
          var[e] = s2;
        }
        put_point(ag[0], j, mean[0], mean[1]);
        put_point(ag[0], 4 + j, var[0], var[1]);
      }
      put_point(ag[0], 8, t == 0 ? wmean : 0.f, 0.f);
      put_point(ag[0], 9, 0.f, 0.f);
      float cg[1][8][4];
      bias_init<GF0>(w, t, cg);
      mma_steps<GF0, 0, 5>(w, lane, ag, cg);
      elu_all(cg);
      uint32_t ag2[1][4][4];
      to_a(cg, ag2);
      float co[1][2][4];
      bias_init<GF1>(w, t, co);
      mma_steps<GF1, 0, 4>(w, lane, ag2, co);
      elu_all(co);
      if (point < n) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<uint32_t*>(geo + point * 16 + 8 * nt + 2 * t) =
              pack_bf16(co[0][nt][0], co[0][nt][1]);
      }
    }

    // rgb_fc([x | vis | ray_diff]): 37 -> 16 ELU -> 8 ELU -> 1 logit a view;
    // logits of masked views -1e9, softmax over views, blend rgb_feat[:3]
    if (!geometry_only) {
      uint32_t ar[VT][3][4];
#pragma unroll
      for (int vt = 0; vt < VT; ++vt) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ar[vt][s][h] = pack_bf16(cx[vt][2 * s][2 * h], cx[vt][2 * s][2 * h + 1]);
            ar[vt][s][2 + h] = pack_bf16(cx[vt][2 * s + 1][2 * h], cx[vt][2 * s + 1][2 * h + 1]);
          }
        }
        ar[vt][2][0] = a_rd[vt][0][0];
        ar[vt][2][1] = a_rd[vt][0][1];
        ar[vt][2][2] = t == 0 ? pack_bf16(vis[2 * vt], 0.f) : 0u;
        ar[vt][2][3] = t == 0 ? pack_bf16(vis[2 * vt + 1], 0.f) : 0u;
      }
      float c16[VT][2][4];
      bias_init<RG0>(w, t, c16);
      mma_steps<RG0, 0, 3>(w, lane, ar, c16);
      elu_all(c16);
      uint32_t a1[VT][1][4];
      to_a(c16, a1);
      float c8[VT][1][4];
      bias_init<RG1>(w, t, c8);
      mma_steps<RG1, 0, 1>(w, lane, a1, c8);
      elu_all(c8);
      to_a(c8, a1);
      bias_init<RG2>(w, t, c8);
      mma_steps<RG2, 0, 1>(w, lane, a1, c8);
      float logit[VP];
#pragma unroll
      for (int vt = 0; vt < VT; ++vt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float l = __shfl_sync(kFull, c8[vt][0][2 * h], lane & ~3);
          logit[2 * vt + h] = m[2 * vt + h] == 0.f ? -1e9f : l;
        }
      float top = logit[0];
#pragma unroll
      for (int v = 1; v < V; ++v) top = fmaxf(top, logit[v]);
      float ex[VP], esum = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ex[v] = __expf(logit[v] - top);
        esum += ex[v];
      }
      if (t < 3) {
        float acc = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) acc += bf(rgb_s + (pl * V + v) * kF + t) * ex[v];
        if (point < n) rgb_out[point * 3 + t] = __float2bfloat16(acc / esum);
      }
    } else if (t < 3 && point < n) {
      rgb_out[point * 3 + t] = __float2bfloat16(0.f);
    }
    if (t == 3 && point < n) nvalid[point] = __float2bfloat16(msum);
    __syncthreads();
  }
}

template <int V>
int launch(const void* rgb, const void* neuray, const void* ray_diff, const void* mask,
           const void* packed, void* geo, void* rgb_out, void* nvalid, int n,
           int geometry_only, cudaStream_t stream) {
  auto kernel = cross_view_pool_kernel<V>;
  constexpr int smem = kPacked * 2 + 2 * stage_bytes(V);
  static int sms[64] = {0}, per_sm[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 0 || dev >= 64) return -1;
  if (per_sm[dev] == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel, kThreads, smem);
    if (e != cudaSuccess) return int(e);
    if (per_sm[dev] < 1) per_sm[dev] = 1;
  }
  const int64_t tiles = (int64_t(n) + kTile - 1) / kTile;
  const int64_t cap = int64_t(sms[dev]) * per_sm[dev];
  const int blocks = int(tiles < cap ? tiles : cap);
  using B = const __nv_bfloat16*;
  using O = __nv_bfloat16*;
  kernel<<<blocks, kThreads, smem, stream>>>(B(rgb), B(neuray), B(ray_diff), B(mask),
                                             B(packed), O(geo), O(rgb_out), O(nvalid), n,
                                             geometry_only);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: bfloat16 rgb_feat (n, views, 35),
// neuray_feat (n, views, 32), ray_diff (n, views, 4), mask (n, views, 1),
// the packed weights (packed_size elements), and the outputs geo (n, 16),
// rgb (n, 3), nvalid (n, 1), all contiguous and 16-byte aligned.  Returns
// the launch's cudaGetLastError() (0 on success); -1 for arguments outside
// what the kernel takes (the Python wrapper checks them first).
extern "C" int panogrf_cross_view_pool(const void* rgb, const void* neuray,
                                       const void* ray_diff, const void* mask,
                                       const void* packed, void* geo, void* rgb_out,
                                       void* nvalid, int n, int views, int packed_size,
                                       int geometry_only, void* stream) {
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(rgb) | reinterpret_cast<uintptr_t>(neuray) |
      reinterpret_cast<uintptr_t>(ray_diff) | reinterpret_cast<uintptr_t>(mask) |
      reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(geo);
  if (n <= 0 || packed_size != kPacked || addresses % 16 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (views) {
    case 2: return launch<2>(rgb, neuray, ray_diff, mask, packed, geo, rgb_out, nvalid, n,
                             geometry_only, s);
    case 3: return launch<3>(rgb, neuray, ray_diff, mask, packed, geo, rgb_out, nvalid, n,
                             geometry_only, s);
    case 4: return launch<4>(rgb, neuray, ray_diff, mask, packed, geo, rgb_out, nvalid, n,
                             geometry_only, s);
    default: return -1;
  }
}
