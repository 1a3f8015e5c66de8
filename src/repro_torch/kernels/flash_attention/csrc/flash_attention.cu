// Causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_bhsd) and computes what it
// computes: q is scaled by d^-0.5 in fp32, scores and the online softmax
// (running max m, running sum l, output accumulator) are fp32, the kv head
// of q-head ih is ih*hkv/h, keys in the future are masked with -1e30 and
// tiles wholly in the future are never visited, and the output is
// acc / max(l, 1e-30) cast to the input type.
//
// Layout: the public (b, s, h, d) layout with the strides the caller gives
// (head_dim contiguous), so no transpose is needed around the call.
//
// Design. The TPU walked the kv blocks as a sequential grid dimension with
// the accumulators in VMEM scratch. Here one thread block owns one
// (batch, q-head, 64-row q tile) and loops over 64-row kv tiles up to the
// causal limit. Q (pre-scaled) and one K or V tile at a time are staged
// in shared memory as fp32; the score tile lives in shared memory; m and l
// are held per row by 4 threads and the output accumulator (64 x d) in
// registers, 4 rows x d/16 columns per thread. Ragged tiles are masked, so
// any sequence length works. Products are scalar fp32 FMAs.
//
// What bounds it on the H100: causal attention does about 2*d*s^2 flops
// per q-head and, in bf16 with qwen3's 16/8 heads, moves about 6*s*d bytes
// per q-head (q, o, and k, v shared by two heads), so s/3 flops per byte:
// below ~900 tokens the bound is the bytes, above it the bf16 tensor
// cores. This simple version runs scalar fp32 FMAs fed from shared memory
// and is far from either bound; mma/wgmma with TMA loads is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int NT = 256;       // threads per block, a 16 x 16 grid
constexpr int SP = BKV + 1;   // padded row of the score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q tile, one K/V tile (rows padded by one float), score tile, per-row
  // scale
  return sizeof(float) * (2 * BQ * (D + 1) + BQ * SP + BQ);
}

// Copies rows [row0, row0 + 64) of one head into a (64, D + 1) fp32 tile,
// zero past n_rows, multiplied by `mul`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows, float mul) {
  for (int idx = threadIdx.x; idx < BKV * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < n_rows ? to_f32(src[row * row_stride + c]) * mul : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int skv, int h,
          int hkv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
          int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
          int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
          float scale, int causal) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // BQ x DP
  float* sKV = sQ + BQ * DP;      // BKV x DP
  float* sS = sKV + BKV * DP;     // BQ x SP
  float* sRow = sS + BQ * SP;     // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = (int)((int64_t)ih * hkv / h);

  const T* qp = q + ib * q_sb + ih * q_sh;
  const T* kp = k + ib * k_sb + ikv * k_sh;
  const T* vp = v + ib * v_sb + ikv * v_sh;

  load_tile<T, D>(sQ, qp, q_ss, q0, sq, scale);

  // softmax phase: row sr is owned by 4 neighbouring lanes, 16 columns each
  const int sr = tid >> 2, part = tid & 3;
  float m_i = NEG_INF, l_i = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int q_end = min(q0 + BQ, sq);
  const int kv_end = causal ? min(skv, q_end) : skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's P V product is done
    load_tile<T, D>(sKV, kp, k_ss, kv0, skv, 1.f);
    __syncthreads();

    // S = (q * scale) K^T: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sKV[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        const bool live = col < skv && (!causal || col <= row);
        sS[(ty + 16 * i) * SP + tx + 16 * j] = live ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();  // K is read and S is whole

    load_tile<T, D>(sKV, vp, v_ss, kv0, skv, 1.f);

    // online softmax of row sr over this tile
    {
      float* srow = sS + sr * SP + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_i - m_new);
      l_i = l_i * corr + sum;
      m_i = m_new;
      if (part == 0) sRow[sr] = corr;
    }
    __syncthreads();  // P, the row corrections and V are in place

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sRow[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sKV[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();
  if (part == 0) sRow[sr] = fmaxf(l_i, 1e-30f);
  __syncthreads();
  T* op = o + ib * o_sb + ih * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= sq) continue;
    const float l = sRow[r];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      op[row * o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int skv, int h, int hkv,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_fwd<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, h, hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int b, int sq, int skv, int h, int hkv,
                       const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, skv, h, hkv, st, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, skv, h, hkv, st, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, skv, h, hkv, st, scale,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (elements): q, k, v, o each as
// (batch, seq, head); head_dim must be contiguous. Returns cudaGetLastError
// after the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, int d, const void* q,
                                   const void* k, const void* v, void* o,
                                   int b, int sq, int skv, int h, int hkv,
                                   const int64_t* strides, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, b, sq, skv, h, hkv, strides,
                             scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, sq, skv, h, hkv,
                                     strides, scale, causal, s);
  return cudaErrorInvalidValue;
}
