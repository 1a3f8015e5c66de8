// Mamba2 SSD chunked scan, the two passes around the chunk recurrence, for
// Hopper (sm_90a).
//
// ssd_intra_fwd replaces the TPU Pallas kernel ssd_intra
// (repro/kernels/ssd_scan/kernel.py, body _intra_kernel). For one
// (batch, chunk, head) it computes, in fp32 from inputs cast on load:
//   M[i, j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i, else 0
//   y[i, :]  = sum_j M[i, j] x_j
//   S[n, p]  = sum_j B_j[n] (x_j[p] * exp(cum_last - cum_j) * dt_j)
//   dec      = exp(cum_last)
// ssd_inter_fwd replaces ssd_inter (body _inter_kernel):
//   y[i, :]  = y_intra[i, :] + (C_i . h_prev) * exp(cum_i), cast to the
//   output type.
// The chunk recurrence h_c = h_{c-1} dec_c + S_c between them stays in
// torch, as the reference keeps it in a lax.scan outside any kernel.
//
// Layout (contiguous, the reference's): xh (b, c, q, h, p); bm/cm
// (b, c, q, n) in the model type; cum/dt (b, c, q, h) fp32; y_intra
// (b, c, q, h, p), S and h_prev (b, c, h, n, p), dec (b, c, h) fp32.
//
// Design. The TPU block held a whole (batch, chunk): its (q, q, h) decay
// tensor is 4 MB at q = 128, h = 64, far above the 227 KB of shared
// memory a block can have here. So heads go into the grid: one block per
// (head, batch x chunk), 256 threads as a 16 x 16 grid. The intra block
// keeps x[:, h, :] (q x p), B and C (q x n), cum, dt and its (q x q)
// weight matrix M in shared memory as fp32: 167 KB at q = 128,
// n = p = 64, behind the opt-in above 48 KB. G = C B^T is shared by all
// heads of a chunk and is recomputed per head (2 MFLOP at full width):
// that keeps the block independent of the others and needs no second
// pass or global scratch. Products run on 64-row groups, each thread
// holding a 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j);
// group pairs wholly above the diagonal are skipped, and the exp is taken
// only where j <= i, so the upper triangle never overflows. The inter
// block keeps C and h_prev[h] (n x p) in shared memory (50 KB at full
// width) and applies the state to each 64-row group.
//
// What bounds it on the H100: at b = 1, s = 512, q = 128, h = 64,
// n = p = 64 the intra pass needs ~0.56 GFLOP (lower-triangle M x, S, and
// G once per chunk) against ~17 MB moved, so at the fp32 peak outside
// the tensor cores (67 TFLOP/s) its bound is the operations (~8 us); the
// inter pass does ~0.27 GFLOP on ~17 MB and is bound by the bytes
// (~5 us). This first version runs scalar fp32 FMAs fed from shared
// memory, and recomputes G per head; bf16 mma/wgmma with TMA loads is
// the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block, a 16 x 16 grid
constexpr int TILE = 64;   // rows of a register-tiled group, 4 per thread
constexpr int Q_MAX = 128; // longest chunk

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

__host__ __device__ __forceinline__ int pad_rows(int q) {
  return (q + TILE - 1) / TILE * TILE;
}

template <int N, int P>
size_t intra_smem_bytes(int q) {
  const int qp = pad_rows(q);
  // C, B (rows padded by one float), x, M (q_pad x (q_pad + 1)), cum, dt
  return sizeof(float) *
         ((size_t)qp * (2 * (N + 1) + (P + 1) + qp + 1) + 2 * qp);
}

template <int N, int P>
size_t inter_smem_bytes(int q) {
  const int qp = pad_rows(q);
  // C, h_prev, exp(cum)
  return sizeof(float) * ((size_t)qp * (N + 1) + N * (P + 1) + qp);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(NT)
ssd_intra(const T* __restrict__ xh, const T* __restrict__ bm,
          const T* __restrict__ cm, const float* __restrict__ cum,
          const float* __restrict__ dt, float* __restrict__ y,
          float* __restrict__ s_out, float* __restrict__ dec, int q, int h) {
  static_assert(P % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LDN = N + 1, LDP = P + 1;
  constexpr int NR = (N + 15) / 16;  // state rows per thread in S
  constexpr int PC = P / 16;         // head_dim columns per thread
  extern __shared__ float smem[];
  const int qp = pad_rows(q);
  const int ldm = qp + 1;
  float* sC = smem;              // qp x LDN
  float* sB = sC + qp * LDN;     // qp x LDN
  float* sX = sB + qp * LDN;     // qp x LDP
  float* sM = sX + qp * LDP;     // qp x ldm
  float* sCum = sM + qp * ldm;   // qp
  float* sDt = sCum + qp;        // qp

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ih = blockIdx.x;
  const int64_t bc = blockIdx.y;  // batch * n_chunks + chunk
  const int64_t row_hp = (int64_t)h * P;

  const T* xp = xh + bc * q * row_hp + (int64_t)ih * P;
  const T* bp = bm + bc * q * N;
  const T* cp = cm + bc * q * N;
  const float* cump = cum + bc * q * h + ih;
  const float* dtp = dt + bc * q * h + ih;

  // stage the chunk in fp32; rows past q are zero
  for (int idx = tid; idx < qp * N; idx += NT) {
    const int r = idx / N, k = idx % N;
    const bool live = r < q;
    sC[r * LDN + k] = live ? to_f32(cp[r * N + k]) : 0.f;
    sB[r * LDN + k] = live ? to_f32(bp[r * N + k]) : 0.f;
  }
  for (int idx = tid; idx < qp * P; idx += NT) {
    const int r = idx / P, k = idx % P;
    sX[r * LDP + k] = r < q ? to_f32(xp[r * row_hp + k]) : 0.f;
  }
  for (int r = tid; r < qp; r += NT) {
    sCum[r] = r < q ? cump[(int64_t)r * h] : 0.f;
    sDt[r] = r < q ? dtp[(int64_t)r * h] : 0.f;
  }
  __syncthreads();

  // M = (C B^T) * L * dt on the lower triangle, group pair by group pair
  const int ng = qp / TILE;
  for (int rg = 0; rg < ng; ++rg) {
    for (int cg = 0; cg <= rg; ++cg) {
      const int r0 = rg * TILE, c0 = cg * TILE;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int k = 0; k < N; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sC[(r0 + ty + 16 * i) * LDN + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[(c0 + tx + 16 * j) * LDN + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          float m = 0.f;
          if (col <= row && row < q)
            m = acc[i][j] * expf(sCum[row] - sCum[col]) * sDt[col];
          sM[row * ldm + col] = m;
        }
      }
    }
  }
  __syncthreads();

  // y = M x, each 64-row group up to its causal limit
  for (int rg = 0; rg < ng; ++rg) {
    const int r0 = rg * TILE;
    const int jend = min(q, r0 + TILE);
    float acc[4][PC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < jend; ++j) {
      float m[4], xv[PC];
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = sM[(r0 + ty + 16 * i) * ldm + j];
#pragma unroll
      for (int c = 0; c < PC; ++c) xv[c] = sX[j * LDP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[i][c] = fmaf(m[i], xv[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row >= q) continue;
      float* yp = y + (bc * q + row) * row_hp + (int64_t)ih * P;
#pragma unroll
      for (int c = 0; c < PC; ++c) yp[tx + 16 * c] = acc[i][c];
    }
  }
  __syncthreads();  // x is read for y; it is rescaled next

  // chunk summary: w_j = exp(cum_last - cum_j) dt_j, x_j <- x_j w_j
  const float cum_last = sCum[q - 1];
  for (int r = tid; r < q; r += NT)
    sDt[r] = expf(cum_last - sCum[r]) * sDt[r];
  if (tid == 0) dec[bc * h + ih] = expf(cum_last);
  __syncthreads();
  for (int idx = tid; idx < q * P; idx += NT) {
    const int r = idx / P, k = idx % P;
    sX[r * LDP + k] *= sDt[r];
  }
  __syncthreads();

  // S[n, p] = sum_j B_j[n] (w x)_j[p]
  float acc[NR][PC];
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int c = 0; c < PC; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < q; ++j) {
    float bv[NR], xv[PC];
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const int n = ty + 16 * a;
      bv[a] = n < N ? sB[j * LDN + n] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < PC; ++c) xv[c] = sX[j * LDP + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < NR; ++a)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[a][c] = fmaf(bv[a], xv[c], acc[a][c]);
  }
  float* sp = s_out + (bc * h + ih) * (int64_t)(N * P);
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int n = ty + 16 * a;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < PC; ++c) sp[n * P + tx + 16 * c] = acc[a][c];
  }
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(NT)
ssd_inter(const T* __restrict__ cm, const float* __restrict__ cum,
          const float* __restrict__ hprev, const float* __restrict__ y_intra,
          T* __restrict__ y, int q, int h) {
  static_assert(P % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LDN = N + 1, LDP = P + 1;
  constexpr int PC = P / 16;
  extern __shared__ float smem[];
  const int qp = pad_rows(q);
  float* sC = smem;            // qp x LDN
  float* sH = sC + qp * LDN;   // N x LDP
  float* sE = sH + N * LDP;    // qp: exp(cum_i)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ih = blockIdx.x;
  const int64_t bc = blockIdx.y;
  const int64_t row_hp = (int64_t)h * P;

  const T* cp = cm + bc * q * N;
  const float* hp = hprev + (bc * h + ih) * (int64_t)(N * P);
  const float* cump = cum + bc * q * h + ih;
  for (int idx = tid; idx < qp * N; idx += NT) {
    const int r = idx / N, k = idx % N;
    sC[r * LDN + k] = r < q ? to_f32(cp[r * N + k]) : 0.f;
  }
  for (int idx = tid; idx < N * P; idx += NT) {
    const int r = idx / P, k = idx % P;
    sH[r * LDP + k] = hp[idx];
  }
  for (int r = tid; r < qp; r += NT)
    sE[r] = r < q ? expf(cump[(int64_t)r * h]) : 0.f;
  __syncthreads();

  for (int r0 = 0; r0 < qp; r0 += TILE) {
    float acc[4][PC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[i][c] = 0.f;
#pragma unroll 8
    for (int k = 0; k < N; ++k) {
      float a[4], hv[PC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sC[(r0 + ty + 16 * i) * LDN + k];
#pragma unroll
      for (int c = 0; c < PC; ++c) hv[c] = sH[k * LDP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[i][c] = fmaf(a[i], hv[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row >= q) continue;
      const float e = sE[row];
      const int64_t off = (bc * q + row) * row_hp + (int64_t)ih * P;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int col = tx + 16 * c;
        y[off + col] = from_f32<T>(y_intra[off + col] + acc[i][c] * e);
      }
    }
  }
}

template <typename T, int N, int P>
cudaError_t launch_intra(const void* xh, const void* bm, const void* cm,
                         const void* cum, const void* dt, void* y, void* s,
                         void* dec, int bc, int q, int h,
                         cudaStream_t stream) {
  auto kernel = ssd_intra<T, N, P>;
  const size_t smem = intra_smem_bytes<N, P>(q);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(h, bc), NT, smem, stream>>>(
      static_cast<const T*>(xh), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(cum),
      static_cast<const float*>(dt), static_cast<float*>(y),
      static_cast<float*>(s), static_cast<float*>(dec), q, h);
  return cudaGetLastError();
}

template <typename T, int N, int P>
cudaError_t launch_inter(const void* cm, const void* cum, const void* hprev,
                         const void* y_intra, void* y, int bc, int q, int h,
                         cudaStream_t stream) {
  auto kernel = ssd_inter<T, N, P>;
  const size_t smem = inter_smem_bytes<N, P>(q);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(h, bc), NT, smem, stream>>>(
      static_cast<const T*>(cm), static_cast<const float*>(cum),
      static_cast<const float*>(hprev), static_cast<const float*>(y_intra),
      static_cast<T*>(y), q, h);
  return cudaGetLastError();
}

// The (n, p) pairs built: the reference's test sweep (8, 16) and (16, 32),
// which is also the reduced config's, and the full width (64, 64).
#define SSD_SHAPES(X) X(8, 16) X(16, 32) X(64, 64)

template <typename T>
cudaError_t intra_by_shape(int n, int p, const void* xh, const void* bm,
                           const void* cm, const void* cum, const void* dt,
                           void* y, void* s, void* dec, int bc, int q, int h,
                           cudaStream_t stream) {
#define SSD_CASE(N_, P_)                                                 \
  if (n == N_ && p == P_)                                                \
    return launch_intra<T, N_, P_>(xh, bm, cm, cum, dt, y, s, dec, bc, q, \
                                   h, stream);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t inter_by_shape(int n, int p, const void* cm, const void* cum,
                           const void* hprev, const void* y_intra, void* y,
                           int bc, int q, int h, cudaStream_t stream) {
#define SSD_CASE(N_, P_)                                                   \
  if (n == N_ && p == P_)                                                  \
    return launch_inter<T, N_, P_>(cm, cum, hprev, y_intra, y, bc, q, h,   \
                                   stream);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of xh/bm/cm (intra) or cm/y (inter): 0 = float32, 1 = bfloat16.
// bc = batch x chunks; 1 <= q <= 128. All tensors contiguous. Each
// returns cudaGetLastError after the launch (0 on success).
extern "C" int ssd_intra_fwd(int dtype, int n, int p, const void* xh,
                             const void* bm, const void* cm, const void* cum,
                             const void* dt, void* y, void* s, void* dec,
                             int bc, int q, int h, void* stream) {
  if (q < 1 || q > Q_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return intra_by_shape<float>(n, p, xh, bm, cm, cum, dt, y, s, dec, bc, q,
                                 h, st);
  if (dtype == 1)
    return intra_by_shape<__nv_bfloat16>(n, p, xh, bm, cm, cum, dt, y, s,
                                         dec, bc, q, h, st);
  return cudaErrorInvalidValue;
}

extern "C" int ssd_inter_fwd(int dtype, int n, int p, const void* cm,
                             const void* cum, const void* hprev,
                             const void* y_intra, void* y, int bc, int q,
                             int h, void* stream) {
  if (q < 1 || q > Q_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return inter_by_shape<float>(n, p, cm, cum, hprev, y_intra, y, bc, q, h,
                                 st);
  if (dtype == 1)
    return inter_by_shape<__nv_bfloat16>(n, p, cm, cum, hprev, y_intra, y,
                                         bc, q, h, st);
  return cudaErrorInvalidValue;
}
