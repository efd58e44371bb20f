// Fused two-layer MLP for Hopper (sm_90a): out = act2(act1(x @ W1 + b1) @ W2 + b2).
//
// Replaces panogrf_tpu/ops/pallas/fused_mlp.py:_mlp2_kernel (the TPU kernel
// behind mlp2 / mlp2_batched).  Same function: x, W1, b1, W2, b2 in float32 or
// bfloat16 (weights in x's dtype), products accumulated in float32, the hidden
// activation kept in float32 on chip and never written to device memory, the
// output cast to x's dtype.
//
// Design: one thread per row.  Each block stages W1, b1, W2 and b2 once in
// shared memory as float32 (no 128-lane padding: the TPU kernel's padding
// served its (8, 128) tiling, which Hopper does not have); the ragged last
// block is masked.  Each thread walks the hidden units, applies act1 and
// accumulates the unit's contribution to every output at once, so the hidden
// vector never exists in full.
//
// What bounds it: bytes.  On the serving path (out_geometry_fc, 16 -> 16 -> 1,
// 16 384 rows per call in bfloat16) a call moves 16 384 x (16 in + 1 out) x 2 B
// ~= 0.56 MB, about 0.17 us at 3.35 TB/s, and does ~9 MFLOP, so at this size
// launch latency dominates the call.  A faster design (several rows per
// thread, vectorised 16-byte loads, fusing the kernel into its neighbours) is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxDin = 256;
constexpr int kMaxHidden = 64;
constexpr int kMaxDout = 64;
constexpr int kThreads = 128;

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// Fused three-layer MLP: out = act3(act2(act1(x @ W1 + b1) @ W2 + b2) @ W3 + b3).
//
// Replaces panogrf_tpu/ops/pallas/fused_mlp.py:_mlp3_kernel (the TPU kernel
// behind mlp3 / mlp3_batched), with the same numerics: float32 accumulation,
// both hidden layers kept in float32, output cast to x's dtype.
//
// Design: one thread per row, all six weight tensors staged once per block in
// shared memory as float32.  The first hidden layer h1[H1] is computed in full
// (it feeds every unit of layer 2); each unit of layer 2 is then computed,
// activated and folded straight into the Dout output accumulators, so only h1
// and acc are live per thread and h2 never exists in full.
//
// What bounds it: bytes.  At the dist-decoder head shape (65 536 rows,
// 32 -> 32 -> 32 -> 2, bfloat16) a call moves 65 536 x (32 + 2) x 2 B ~= 4.5 MB,
// ~1.3 us at 3.35 TB/s, against ~0.5 us of bf16 tensor-core work.  The two
// per-thread arrays live in local memory (dynamic indexing), which, with one
// row per thread and uncoalesced row loads, keeps this first version far from
// that bound; making it fast is later work.
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

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the launch's cudaGetLastError() (0 on success); -1 for
// arguments outside what the kernel supports (the Python wrapper checks them
// first).
extern "C" int panogrf_mlp3(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, void* out, int n, int din, int h1,
                            int h2, int dout, int act1, int act2, int act3,
                            int dtype, void* stream) {
  if (n <= 0 || din <= 0 || h1 <= 0 || h2 <= 0 || dout <= 0 || din > kMaxDin ||
      h1 > kMaxHidden || h2 > kMaxHidden || dout > kMaxDout)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
                            int dtype, void* stream) {
  if (n <= 0 || din <= 0 || dh <= 0 || dout <= 0 || din > kMaxDin ||
      dh > kMaxHidden || dout > kMaxDout)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, b1, w2, b2, out, n, din, dh, dout, act1, act2, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, n, din, dh, dout, act1, act2, s);
  return -1;
}
