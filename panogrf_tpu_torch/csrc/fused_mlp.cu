// Fused two- and three-layer MLPs for Hopper (sm_90a):
//   mlp2: out = act2(act1(x @ W1 + b1) @ W2 + b2)
//   mlp3: out = act3(act2(act1(x @ W1 + b1) @ W2 + b2) @ W3 + b3)
//
// Replace panogrf_tpu/ops/pallas/fused_mlp.py:_mlp2_kernel and :_mlp3_kernel
// (the TPU kernels behind mlp2 / mlp2_batched and mlp3 / mlp3_batched).  Same
// function: x and the weights in float32 or bfloat16 (weights in x's dtype),
// products accumulated in float32, the hidden activations kept on chip and
// never written to device memory, the output cast to x's dtype, the five
// activations of fused_mlp.py:_act.
//
// Each function has a "generic" variant (any width up to the limits below,
// one thread per row, runtime widths) and specialised variants compiled for
// the widths the paths use; ops/kernels/fused_mlp.py:choose_variant picks one
// from the widths, the dtype and x's alignment before the launch.
//
// mlp2 "lanes" (16 -> 16 -> 1, float32 and bfloat16; the serving and
// training out_geometry_fc).  What bounds it: a serving call moves 16 384 x
// (16 in + 1 out) x 2 B ~= 0.56 MB (0.17 us at 3.35 TB/s) and does ~9 MFLOP,
// so with ~124 rows per SM its real limit is latency: the launch, one trip
// to device memory and the longest per-thread chain.  The generic kernel
// (one thread per row) gives each SM 4 warps, re-reads the row 2 bytes at a
// time and keeps its runtime-sized arrays in local memory.  This design:
// compile-time widths (loops unroll, every value in registers); one lane per
// hidden unit, H = 16 lanes per row, so the serving call runs 262 144
// threads; lane j keeps column j of W1 and row j of W2 in registers; each
// group of H lanes takes R rows per tile (2 in bfloat16, 4 in float32) and
// reads them with 16-byte loads that the group's lanes share (a broadcast),
// all in flight before the math, and the next tile's rows are loaded before
// this tile's activations; act1 runs in float32, and the group sums the Dout
// partial outputs with __shfl_xor_sync.  A grid sized from the SM count walks
// the row tiles, so each lane loads its weights once.  It stays on the CUDA
// cores: 9 MFLOP is ~0.13 us there, and Dout = 1 would pad an mma N of 8.
//
// mlp3 "mma" (32 -> 32 -> 32 -> 2, bfloat16; the dist-decoder head shape).
// What bounds it: 65 536 rows move 4.46 MB (1.33 us) and do 277 MFLOP, ~4 us
// at the fp32 CUDA-core peak, so only the tensor cores keep the math under
// the bytes.  Each warp takes 16-row tiles with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: the B fragments of W1, W2 and
// W3 (Dout zero-padded to N = 8) are read once into 36 registers; each
// thread reads its A fragments of x straight from device memory with two
// 16-byte loads per tile (rows g and g + 8 at columns 8t..8t+7, the K order
// of layer 1 permuted to match, and W1's fragments read in the same order),
// so no shared-memory round trip is needed, and the next tile's loads are
// issued before this tile's math.  Bias and activation run in float32 on the
// accumulators (one branch per layer, MUFU exp), which are packed to bf16
// pairs and serve as the next layer's A fragments (two m16n8 C fragments
// form one m16k16 A fragment), so the hidden layers round to bf16 where the
// plain version rounds them.  wgmma is not needed: at 32 wide the product is
// bytes- and latency-bound, and a 64-row warpgroup tile with shared-memory
// operands would add staging without moving fewer bytes.
//
// mlp3 "rows" (32 -> 32 -> 32 -> 2, float32): float32 throughout, no TF32
// (the float32 check is 1e-5 of the output scale), so it runs on the CUDA
// cores: 277 MFLOP, 4.1 us at the fp32 peak.  One row per thread with
// compile-time widths and the weights in shared memory, read with broadcast
// 16-byte loads; h1 stays in 32 registers and each layer-2 unit is folded
// into the outputs.  It is bound by those shared-memory reads (8.4 KB of
// weights delivered per row at 128 B per clock per SM, ~16 us at 65 536
// rows).  The several-lanes-per-row split of mlp2 measured 2.2x slower here:
// each of a row's 32 lanes reads the whole 128-byte row, and layer 2 needs
// every lane's layer-1 unit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxDin = 256;
constexpr int kMaxHidden = 64;
constexpr int kMaxDout = 64;
constexpr int kThreads = 128;
constexpr int kLaneThreads = 256;     // block of the "lanes" kernel
constexpr int kMmaWarps = 4;          // warps per block of the "mma" kernel
constexpr int kMmaMinBlocks = 4;      // its blocks per SM (caps its registers)
constexpr int kRowThreads = 256;      // block of the "rows" kernel

enum Variant { kGeneric = 0, kLanes = 1, kMma = 2, kRows = 3 };

enum Act { kNone = 0, kElu = 1, kRelu = 2, kSigmoid = 3, kSoftplus = 4 };

// The same formulas as panogrf_tpu/ops/pallas/fused_mlp.py:_act.
__device__ __forceinline__ float act(float x, int kind) {
  switch (kind) {
    case kElu: return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
    case kRelu: return fmaxf(x, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-x));
    case kSoftplus: return fmaxf(x, 0.f) + logf(1.f + expf(-fabsf(x)));
    default: return x;
  }
}

// act over N values with one branch on `kind` (uniform across the block), so
// the N evaluations unroll and interleave.  FAST uses the MUFU intrinsics
// (__expf, __logf, __fdividef): for bfloat16 outputs, whose rounding is ~500x
// coarser than their error.
template <bool FAST>
__device__ __forceinline__ float exp_(float x) { return FAST ? __expf(x) : expf(x); }

template <bool FAST, int N>
__device__ __forceinline__ void act_n(float* v, int kind) {
  switch (kind) {
    case kElu:
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = v[i] > 0.f ? v[i] : exp_<FAST>(fminf(v[i], 0.f)) - 1.f;
      break;
    case kRelu:
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = fmaxf(v[i], 0.f);
      break;
    case kSigmoid:
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = FAST ? __fdividef(1.f, 1.f + __expf(-v[i])) : 1.f / (1.f + expf(-v[i]));
      break;
    case kSoftplus:
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = fmaxf(v[i], 0.f) + (FAST ? __logf(1.f + __expf(-fabsf(v[i])))
                                        : logf(1.f + expf(-fabsf(v[i]))));
      break;
    default:
      break;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// mlp2 "generic": one thread per row; W1, b1, W2 and b2 staged once per
// block in shared memory as float32; each thread walks the hidden units and
// folds each one into every output at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp2_kernel(const T* __restrict__ x, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, T* __restrict__ out, int n, int din,
            int dh, int dout, int act1, int act2) {
  extern __shared__ float smem[];
  float* sw1 = smem;                 // (din, dh)
  float* sb1 = sw1 + din * dh;       // (dh)
  float* sw2 = sb1 + dh;             // (dh, dout)
  float* sb2 = sw2 + dh * dout;      // (dout)
  for (int i = threadIdx.x; i < din * dh; i += blockDim.x) sw1[i] = to_f32(w1[i]);
  for (int i = threadIdx.x; i < dh; i += blockDim.x) sb1[i] = to_f32(b1[i]);
  for (int i = threadIdx.x; i < dh * dout; i += blockDim.x) sw2[i] = to_f32(w2[i]);
  for (int i = threadIdx.x; i < dout; i += blockDim.x) sb2[i] = to_f32(b2[i]);
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const T* xr = x + row * din;
  float acc[kMaxDout];
  for (int k = 0; k < dout; ++k) acc[k] = sb2[k];
  for (int j = 0; j < dh; ++j) {
    float h = sb1[j];
    for (int i = 0; i < din; ++i) h = fmaf(to_f32(xr[i]), sw1[i * dh + j], h);
    h = act(h, act1);
    for (int k = 0; k < dout; ++k) acc[k] = fmaf(h, sw2[j * dout + k], acc[k]);
  }
  T* orow = out + row * dout;
  for (int k = 0; k < dout; ++k) orow[k] = from_f32<T>(act(acc[k], act2));
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int n, int din, int dh, int dout,
           int act1, int act2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t(din) * dh + dh + size_t(dh) * dout + dout);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlp2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  mlp2_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), n,
      din, dh, dout, act1, act2);
  return int(cudaGetLastError());
}

// mlp3 "generic": one thread per row, all six weight tensors staged once per
// block in shared memory as float32.  h1 is computed in full; each unit of
// layer 2 is then activated and folded straight into the Dout output
// accumulators, so h2 never exists in full.  Its runtime-sized arrays live in
// local memory; it serves the widths no specialised variant covers and a
// misaligned x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp3_kernel(const T* __restrict__ x, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, const T* __restrict__ w3,
            const T* __restrict__ b3, T* __restrict__ out, int n, int din,
            int h1, int h2, int dout, int act1, int act2, int act3) {
  extern __shared__ float smem[];
  float* sw1 = smem;                 // (din, h1)
  float* sb1 = sw1 + din * h1;       // (h1)
  float* sw2 = sb1 + h1;             // (h1, h2)
  float* sb2 = sw2 + h1 * h2;        // (h2)
  float* sw3 = sb2 + h2;             // (h2, dout)
  float* sb3 = sw3 + h2 * dout;      // (dout)
  for (int i = threadIdx.x; i < din * h1; i += blockDim.x) sw1[i] = to_f32(w1[i]);
  for (int i = threadIdx.x; i < h1; i += blockDim.x) sb1[i] = to_f32(b1[i]);
  for (int i = threadIdx.x; i < h1 * h2; i += blockDim.x) sw2[i] = to_f32(w2[i]);
  for (int i = threadIdx.x; i < h2; i += blockDim.x) sb2[i] = to_f32(b2[i]);
  for (int i = threadIdx.x; i < h2 * dout; i += blockDim.x) sw3[i] = to_f32(w3[i]);
  for (int i = threadIdx.x; i < dout; i += blockDim.x) sb3[i] = to_f32(b3[i]);
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const T* xr = x + row * din;
  float hid[kMaxHidden];
  for (int j = 0; j < h1; ++j) {
    float h = sb1[j];
    for (int i = 0; i < din; ++i) h = fmaf(to_f32(xr[i]), sw1[i * h1 + j], h);
    hid[j] = act(h, act1);
  }
  float acc[kMaxDout];
  for (int k = 0; k < dout; ++k) acc[k] = sb3[k];
  for (int u = 0; u < h2; ++u) {
    float h = sb2[u];
    for (int j = 0; j < h1; ++j) h = fmaf(hid[j], sw2[j * h2 + u], h);
    h = act(h, act2);
    for (int k = 0; k < dout; ++k) acc[k] = fmaf(h, sw3[u * dout + k], acc[k]);
  }
  T* orow = out + row * dout;
  for (int k = 0; k < dout; ++k) orow[k] = from_f32<T>(act(acc[k], act3));
}

template <typename T>
int launch3(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, const void* w3, const void* b3, void* out, int n,
            int din, int h1, int h2, int dout, int act1, int act2, int act3,
            cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t(din) * h1 + h1 + size_t(h1) * h2 +
                                       h2 + size_t(h2) * dout + dout);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlp3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  mlp3_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(out), n, din, h1, h2, dout, act1,
      act2, act3);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Specialised variants
// ---------------------------------------------------------------------------

// Eight bfloat16 or four float32 values of one 16-byte load, as float32.
__device__ __forceinline__ void unpack16(uint4 u, float* v, float) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(uint4 u, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    float2 f = __bfloat1622float2(p);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One row of x (DIN values, 16-byte aligned) as raw 16-byte words: the
// loads of several rows stay in flight in few registers until the math.
template <typename T, int DIN>
struct RawRow {
  static_assert(DIN * sizeof(T) % 16 == 0, "the row pitch must be a multiple of 16 bytes");
  static constexpr int kWords = DIN * sizeof(T) / 16;
  static constexpr int kPer = 16 / sizeof(T);     // values per word
  uint4 w[kWords];

  // Row `row` of x; zeros when !valid (past the end).
  __device__ __forceinline__ void load(const T* __restrict__ x, int64_t row, bool valid) {
    const uint4* src = reinterpret_cast<const uint4*>(x + row * DIN);
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      w[c] = make_uint4(0u, 0u, 0u, 0u);
      if (valid) w[c] = __ldg(src + c);
    }
  }

  // acc + sum_i row[i] * wt[i], in float32, in the order of i.
  __device__ __forceinline__ float dot(const float (&wt)[DIN], float acc) const {
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      float v[kPer];
      unpack16(w[c], v, T());
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc = fmaf(v[i], wt[c * kPer + i], acc);
    }
    return acc;
  }
};

// dst[map(i)] = src[i] for i < N, by the block's THREADS threads, with
// every load in flight before the first store (one trip to memory).
template <int N, int THREADS, typename T, typename Map>
__device__ __forceinline__ void stage(const T* __restrict__ src, T* dst, Map map) {
  constexpr int kPer = (N + THREADS - 1) / THREADS;
  T v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < N) v[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < N) dst[map(i)] = v[k];
  }
}

// Sum of v over the aligned group of WIDTH lanes; every lane gets the sum.
template <int WIDTH>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Blocks for a grid-stride launch: enough to cover `needed` tiles, at most
// as many as the card holds at once.  The SM count is read once per device,
// the blocks per SM once per kernel.
template <typename Kernel>
int grid_size(Kernel kernel, int threads, int* per_sm, int64_t needed,
              int* blocks) {
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 0 || dev >= 64) return -1;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
  }
  if (*per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return int(e);
    if (*per_sm < 1) *per_sm = 1;
  }
  const int64_t cap = int64_t(sms[dev]) * *per_sm;
  *blocks = int(needed < cap ? needed : cap);
  return 0;
}

// mlp2 "lanes": H lanes per row, lane j owns hidden unit j; each group of
// H lanes takes R rows per tile, whose loads are all in flight before the
// math.
template <typename T, int DIN, int H, int DOUT, int R>
__global__ void __launch_bounds__(kLaneThreads)
mlp2_lanes_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ b2, T* __restrict__ out, int n,
                  int act1, int act2) {
  static_assert(H <= 32 && (H & (H - 1)) == 0, "H lanes must tile a warp");
  constexpr bool kFast = sizeof(T) == 2;
  constexpr int kGroups = kLaneThreads / H;      // row slots per block
  constexpr int kTileRows = kGroups * R;         // rows per tile
  const int j = threadIdx.x % H;
  const int slot = threadIdx.x / H;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  int tile = blockIdx.x;
  RawRow<T, DIN> xr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = int64_t(tile) * kTileRows + r * kGroups + slot;
    xr[r].load(x, row, tile < tiles && row < n);
  }
  float w1c[DIN], w2r[DOUT], b2v[DOUT];
#pragma unroll
  for (int i = 0; i < DIN; ++i) w1c[i] = to_f32(w1[i * H + j]);
  const float b1j = to_f32(b1[j]);
#pragma unroll
  for (int k = 0; k < DOUT; ++k) {
    w2r[k] = to_f32(w2[j * DOUT + k]);
    b2v[k] = to_f32(b2[k]);
  }
  for (; tile < tiles; tile += gridDim.x) {
    float h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) h[r] = xr[r].dot(w1c, b1j);
    const int next = tile + gridDim.x;           // the next tile's rows, in flight
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = int64_t(next) * kTileRows + r * kGroups + slot;
      xr[r].load(x, row, next < tiles && row < n);
    }
    act_n<kFast, R>(h, act1);
#pragma unroll
    for (int k = 0; k < DOUT; ++k) {
      float o[R];
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = group_sum<H>(h[r] * w2r[k]) + b2v[k];
      act_n<kFast, R>(o, act2);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t row = int64_t(tile) * kTileRows + r * kGroups + slot;
        if (row < n && k % H == j) out[row * DOUT + k] = from_f32<T>(o[r]);
      }
    }
  }
}

// mlp3 "rows": float32, one row per thread, compile-time widths; the weights
// staged once per block in shared memory (W2 transposed, so that each
// layer-2 unit reads a contiguous column), read with broadcast 16-byte loads.
template <int DIN, int H1, int H2, int DOUT>
__global__ void __launch_bounds__(kRowThreads)
mlp3_rows_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, float* __restrict__ out, int n,
                 int act1, int act2, int act3) {
  static_assert(H1 % 4 == 0 && H2 % 4 == 0, "16-byte weight reads");
  constexpr int kT = kRowThreads;
  __shared__ __align__(16) float sw1[DIN * H1], sw2t[H2 * H1], sw3[H2 * DOUT];
  __shared__ __align__(16) float sb1[H1], sb2[H2], sb3[DOUT];
  const int64_t first = int64_t(blockIdx.x) * kT + threadIdx.x;
  RawRow<float, DIN> xr;
  xr.load(x, first, first < n);
  const auto same = [](int i) { return i; };
  stage<DIN * H1, kT>(w1, sw1, same);
  stage<H1 * H2, kT>(w2, sw2t, [](int i) { return (i % H2) * H1 + i / H2; });
  stage<H2 * DOUT, kT>(w3, sw3, same);
  stage<H1, kT>(b1, sb1, same);
  stage<H2, kT>(b2, sb2, same);
  stage<DOUT, kT>(b3, sb3, same);
  __syncthreads();
  for (int64_t row = first; row < n; row += int64_t(gridDim.x) * kT) {
    float h1[H1];
#pragma unroll
    for (int j = 0; j < H1; ++j) h1[j] = sb1[j];
#pragma unroll
    for (int c = 0; c < RawRow<float, DIN>::kWords; ++c) {
      float v[4];
      unpack16(xr.w[c], v, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < H1; j += 4) {
          const float4 w = *reinterpret_cast<const float4*>(&sw1[(4 * c + e) * H1 + j]);
          h1[j] = fmaf(v[e], w.x, h1[j]);
          h1[j + 1] = fmaf(v[e], w.y, h1[j + 1]);
          h1[j + 2] = fmaf(v[e], w.z, h1[j + 2]);
          h1[j + 3] = fmaf(v[e], w.w, h1[j + 3]);
        }
      }
    }
    const int64_t next = row + int64_t(gridDim.x) * kT;   // in flight
    xr.load(x, next, next < n);
    act_n<false, H1>(h1, act1);
    float o[DOUT];
#pragma unroll
    for (int k = 0; k < DOUT; ++k) o[k] = sb3[k];
#pragma unroll
    for (int u0 = 0; u0 < H2; u0 += 4) {
      float h2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h2[q] = sb2[u0 + q];
#pragma unroll
        for (int j = 0; j < H1; j += 4) {
          const float4 w = *reinterpret_cast<const float4*>(&sw2t[(u0 + q) * H1 + j]);
          h2[q] = fmaf(h1[j], w.x, h2[q]);
          h2[q] = fmaf(h1[j + 1], w.y, h2[q]);
          h2[q] = fmaf(h1[j + 2], w.z, h2[q]);
          h2[q] = fmaf(h1[j + 3], w.w, h2[q]);
        }
      }
      act_n<false, 4>(h2, act2);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < DOUT; ++k) o[k] = fmaf(h2[q], sw3[(u0 + q) * DOUT + k], o[k]);
    }
    act_n<false, DOUT>(o, act3);
#pragma unroll
    for (int k = 0; k < DOUT; ++k) out[row * DOUT + k] = o[k];
  }
}

// Two floats as one register of a bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
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

// A 16 x (8 NT) accumulator tile, rounded to bf16 pairs as the A fragments
// of the next layer: K step s of the next product takes the C fragments of
// n tiles 2s and 2s + 1.
template <int NT>
__device__ __forceinline__ void to_a_frags(const float (&c)[NT][4],
                                           uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[s][2 * h] = pack_bf16(c[2 * s + h][0], c[2 * s + h][1]);      // row g
      a[s][2 * h + 1] = pack_bf16(c[2 * s + h][2], c[2 * s + h][3]);  // row g+8
    }
  }
}

// One layer of a 16-row tile: c = bias + a @ B over K = 16 KS, N = 8 NT.
template <int KS, int NT>
__device__ __forceinline__ void mma_layer(const uint32_t (&a)[KS][4],
                                          const uint32_t (&b)[KS][NT][2],
                                          const float (&bias)[NT][2],
                                          float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    c[nt][0] = c[nt][2] = bias[nt][0];
    c[nt][1] = c[nt][3] = bias[nt][1];
#pragma unroll
    for (int s = 0; s < KS; ++s) mma_bf16(c[nt], a[s], b[s][nt]);
  }
}

// mlp3 "mma": bfloat16 on the tensor cores, widths 32 -> 32 -> 32 -> DOUT
// (DOUT <= 8, padded to one n tile).  Each warp takes 16-row tiles; thread
// (g, t) = (lane / 4, lane % 4).
template <int DOUT>
__global__ void __launch_bounds__(kMmaWarps * 32, kMmaMinBlocks)
mlp3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ b1,
                const __nv_bfloat16* __restrict__ w2,
                const __nv_bfloat16* __restrict__ b2,
                const __nv_bfloat16* __restrict__ w3,
                const __nv_bfloat16* __restrict__ b3,
                __nv_bfloat16* __restrict__ out, int n, int act1, int act2,
                int act3) {
  static_assert(DOUT >= 1 && DOUT <= 8, "Dout is padded to one n tile of 8");
  constexpr int D = 32;          // Din = H1 = H2
  constexpr int NT = D / 8;      // n tiles of layers 1 and 2
  constexpr int KS = D / 16;     // k steps of every layer
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + 15) / 16;
  const int warps = gridDim.x * kMmaWarps;
  int tile = blockIdx.x * kMmaWarps + threadIdx.x / 32;

  // Thread (g, t) loads 16 bytes of rows g and g + 8: columns 8t .. 8t + 7.
  // Layer 1's K order is permuted to match: in k step s the fragment
  // registers of k = 2t, 2t+1 hold columns 8t + 4s + {0, 1} and those of
  // k = 2t+8, 2t+9 hold 8t + 4s + {2, 3}; W1's fragments use the same order.
  // Rows past the end read zeros.
  auto load_tile = [&](int tl, uint4& lo, uint4& hi) {
    const int64_t r0 = int64_t(tl) * 16 + g, r1 = r0 + 8;
    const uint4* base = reinterpret_cast<const uint4*>(x);
    lo = make_uint4(0u, 0u, 0u, 0u);
    hi = make_uint4(0u, 0u, 0u, 0u);
    if (tl < tiles && r0 < n) lo = __ldg(base + r0 * (D / 8) + t);
    if (tl < tiles && r1 < n) hi = __ldg(base + r1 * (D / 8) + t);
  };
  uint4 xlo, xhi;
  load_tile(tile, xlo, xhi);

  // B fragments, read once from device memory (4 KB, all loads in flight
  // together): b[0] = (k = 2t, 2t+1), b[1] = (k = 2t+8, 2t+9) of k step s,
  // at n = 8 nt + g; the weights are (in, out) row-major.
  uint32_t bw1[KS][NT][2], bw2[KS][NT][2], bw3[KS][1][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + g;
      const int p = 8 * t + 4 * s;               // layer 1: permuted K
      bw1[s][nt][0] = pack_bf16(w1[(p + 0) * D + col], w1[(p + 1) * D + col]);
      bw1[s][nt][1] = pack_bf16(w1[(p + 2) * D + col], w1[(p + 3) * D + col]);
      const int k = 16 * s + 2 * t;
      bw2[s][nt][0] = pack_bf16(w2[k * D + col], w2[(k + 1) * D + col]);
      bw2[s][nt][1] = pack_bf16(w2[(k + 8) * D + col], w2[(k + 9) * D + col]);
    }
    const int k = 16 * s + 2 * t;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const bool live = g < DOUT;                  // W3's zero padding
    bw3[s][0][0] = live ? pack_bf16(w3[k * DOUT + g], w3[(k + 1) * DOUT + g])
                        : pack_bf16(zero, zero);
    bw3[s][0][1] = live ? pack_bf16(w3[(k + 8) * DOUT + g], w3[(k + 9) * DOUT + g])
                        : pack_bf16(zero, zero);
  }
  // Biases of the accumulator columns 8 nt + 2t, 8 nt + 2t + 1.
  float bias1[NT][2], bias2[NT][2], bias3[1][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias1[nt][e] = to_f32(b1[8 * nt + 2 * t + e]);
      bias2[nt][e] = to_f32(b2[8 * nt + 2 * t + e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    bias3[0][e] = 2 * t + e < DOUT ? to_f32(b3[2 * t + e]) : 0.f;

  for (; tile < tiles; tile += warps) {
    uint32_t a[KS][4] = {{xlo.x, xhi.x, xlo.y, xhi.y},
                         {xlo.z, xhi.z, xlo.w, xhi.w}};
    load_tile(tile + warps, xlo, xhi);           // the next tile, in flight

    float c[NT][4];
    mma_layer<KS, NT>(a, bw1, bias1, c);
    act_n<true, NT * 4>(&c[0][0], act1);
    to_a_frags<NT>(c, a);
    mma_layer<KS, NT>(a, bw2, bias2, c);
    act_n<true, NT * 4>(&c[0][0], act2);
    to_a_frags<NT>(c, a);
    float o[1][4];
    mma_layer<KS, 1>(a, bw3, bias3, o);
    act_n<true, 4>(o[0], act3);

    const int64_t r0 = int64_t(tile) * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (2 * t + e < DOUT) {
        if (r0 < n) out[r0 * DOUT + 2 * t + e] = __float2bfloat16(o[0][e]);
        if (r1 < n) out[r1 * DOUT + 2 * t + e] = __float2bfloat16(o[0][2 + e]);
      }
    }
  }
}

// The widths each specialised variant is compiled for (the paths' widths).
constexpr int kM2Din = 16, kM2H = 16, kM2Dout = 1;
constexpr int kM3Din = 32, kM3H = 32, kM3Dout = 2;

// R rows per lane group: the fastest of 1, 2 and 4 without spills (at 2,
// float32 spills; bfloat16 at 4 is no faster than at 2).
template <typename T, int R = sizeof(T) == 2 ? 2 : 4>
int launch_mlp2_lanes(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, int n,
                      int act1, int act2, cudaStream_t stream) {
  auto kernel = mlp2_lanes_kernel<T, kM2Din, kM2H, kM2Dout, R>;
  static int per_sm = 0;
  int blocks = 0;
  constexpr int kTileRows = kLaneThreads / kM2H * R;
  const int rc = grid_size(kernel, kLaneThreads, &per_sm,
                           (int64_t(n) + kTileRows - 1) / kTileRows, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, kLaneThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), n,
      act1, act2);
  return int(cudaGetLastError());
}

int launch_mlp3_rows(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* w3,
                     const void* b3, void* out, int n, int act1, int act2,
                     int act3, cudaStream_t stream) {
  auto kernel = mlp3_rows_kernel<kM3Din, kM3H, kM3H, kM3Dout>;
  static int per_sm = 0;
  int blocks = 0;
  const int rc = grid_size(kernel, kRowThreads, &per_sm,
                           (int64_t(n) + kRowThreads - 1) / kRowThreads, &blocks);
  if (rc != 0) return rc;
  using F = const float*;
  kernel<<<blocks, kRowThreads, 0, stream>>>(
      F(x), F(w1), F(b1), F(w2), F(b2), F(w3), F(b3), static_cast<float*>(out), n,
      act1, act2, act3);
  return int(cudaGetLastError());
}

int launch_mlp3_mma(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* w3,
                    const void* b3, void* out, int n, int act1, int act2,
                    int act3, cudaStream_t stream) {
  auto kernel = mlp3_mma_kernel<kM3Dout>;
  static int per_sm = 0;
  int blocks = 0;
  const int64_t tiles = (int64_t(n) + 15) / 16;
  const int rc = grid_size(kernel, kMmaWarps * 32, &per_sm,
                           (tiles + kMmaWarps - 1) / kMmaWarps, &blocks);
  if (rc != 0) return rc;
  using B = const __nv_bfloat16*;
  kernel<<<blocks, kMmaWarps * 32, 0, stream>>>(
      B(x), B(w1), B(b1), B(w2), B(b2), B(w3), B(b3),
      static_cast<__nv_bfloat16*>(out), n, act1, act2, act3);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16;
// variant: 0 = generic, 1 = lanes, 2 = mma, 3 = rows (a specialised variant takes only
// the widths and dtypes it was compiled for, and x 16-byte aligned).  Each
// returns the launch's cudaGetLastError() (0 on success); -1 for arguments
// outside what the variant supports (the Python wrapper checks them first).
extern "C" int panogrf_mlp3(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, void* out, int n, int din, int h1,
                            int h2, int dout, int act1, int act2, int act3,
                            int variant, int dtype, void* stream) {
  if (n <= 0 || din <= 0 || h1 <= 0 || h2 <= 0 || dout <= 0 || din > kMaxDin ||
      h1 > kMaxHidden || h2 > kMaxHidden || dout > kMaxDout)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant != kGeneric) {
    const bool widths = din == kM3Din && h1 == kM3H && h2 == kM3H && dout == kM3Dout;
    if (!widths || reinterpret_cast<uintptr_t>(x) % 16 != 0) return -1;
    if (variant == kRows && dtype == 0)
      return launch_mlp3_rows(x, w1, b1, w2, b2, w3, b3, out, n, act1, act2, act3, s);
    if (variant == kMma && dtype == 1)
      return launch_mlp3_mma(x, w1, b1, w2, b2, w3, b3, out, n, act1, act2, act3, s);
    return -1;
  }
  if (dtype == 0)
    return launch3<float>(x, w1, b1, w2, b2, w3, b3, out, n, din, h1, h2, dout,
                          act1, act2, act3, s);
  if (dtype == 1)
    return launch3<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, n, din, h1, h2,
                                  dout, act1, act2, act3, s);
  return -1;
}

extern "C" int panogrf_mlp2(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int n,
                            int din, int dh, int dout, int act1, int act2,
                            int variant, int dtype, void* stream) {
  if (n <= 0 || din <= 0 || dh <= 0 || dout <= 0 || din > kMaxDin ||
      dh > kMaxHidden || dout > kMaxDout)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant != kGeneric) {
    const bool widths = din == kM2Din && dh == kM2H && dout == kM2Dout;
    if (variant != kLanes || !widths || reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return -1;
    if (dtype == 0)
      return launch_mlp2_lanes<float>(x, w1, b1, w2, b2, out, n, act1, act2, s);
    if (dtype == 1)
      return launch_mlp2_lanes<__nv_bfloat16>(x, w1, b1, w2, b2, out, n, act1, act2, s);
    return -1;
  }
  if (dtype == 0)
    return launch<float>(x, w1, b1, w2, b2, out, n, din, dh, dout, act1, act2, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, n, din, dh, dout, act1, act2, s);
  return -1;
}
