// Mamba2 SSD chunked scan for Hopper (sm_90a): the intra-chunk pass, and
// the inter-chunk pass with the chunk recurrence folded into it.
//
// The intra pass replaces the TPU Pallas kernel ssd_intra
// (repro/kernels/ssd_scan/kernel.py, body _intra_kernel) and the chunk
// cumsum that repro/kernels/ssd_scan/ops.py takes before it. For one
// (batch, chunk, head) it computes, with fp32 arithmetic:
//   cum[i]   = log_a[0] + ... + log_a[i], summed in index order in fp32
//   M[i, j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i, else 0
//   y[i, :]  = sum_j M[i, j] x_j
//   S[n, p]  = sum_j B_j[n] (x_j[p] * exp(cum_last - cum_j) * dt_j)
//   dec      = exp(cum_last)
// and writes cum as a fourth output for the inter pass. The sequential
// fp32 sum is the one torch.cumsum takes along a non-innermost axis on the
// card, so cum equals it bit for bit.
// The inter pass replaces ssd_inter (body _inter_kernel) and the host
// lax.scan that ops.py runs between the two Pallas kernels. For one
// (batch, head, 32-column slice of head_dim) it walks the chunks in order
// from h = h0 (or zeros), keeping h on chip:
//   y_c[i, :] = y_intra_c[i, :] + (C_i . h) * exp(cum_i), cast to the
//               output type;
//   h         = h * dec_c + S_c, a rounded fp32 multiply, then a rounded
//               add (no fused multiply-add), the arithmetic of the torch
//               loop models/mamba2.py::chunk_recurrence, so every state
//               and the returned last one equal that loop's bit for bit.
// The states entering each chunk never reach device memory.
//
// Layout (contiguous, the reference's): xh (b, c, q, h, p); bm/cm
// (b, c, q, n) in the model type; log_a/dt/cum (b, c, q, h) fp32; y_intra
// (b, c, q, h, p), S (b, c, h, n, p), dec (b, c, h), h0/h_last (b, h, n, p)
// fp32.
//
// The TPU block held a whole (batch, chunk): its (q, q, h) decay tensor is
// 4 MB at q = 128, h = 64, far above the 227 KB of shared memory a block
// can have here. So heads go into the grid: one block per (head,
// batch x chunk), and C B^T, shared by all heads of a chunk, is recomputed
// per head (2 MFLOP at full width), which keeps blocks independent with
// no second pass or global scratch.
//
// Intra, bf16 inputs (ssd_intra_mma, the model path): tensor cores.
// x, B and C are staged as bf16 by 16-byte cp.async (55 KB at q = 128,
// n = p = 64, rows padded by 16 bytes so ldmatrix is conflict-free), which
// lets several blocks share an SM. While the copies fly, one thread scans
// log_a. Then 8 warps split the work: warps 0-3 each own two 16-row tiles
// of y (tiles w and 7 - w, so the triangle is shared evenly), warps 4-7 a
// 16-column slice of S each. All products run on mma.sync m16n8k16 with
// fp32 accumulation:
//   G = C B^T, exact bf16 products, per 16 x 16 tile of the triangle;
//   y = M x, with M built in registers from G's accumulators (exp taken
//   only where j <= i) and fed straight to the product, never stored;
//   S = B^T (w x), with w x formed in registers from x's fragments.
// M and w x are fp32; each goes in as bf16 parts (hi, mid, lo) against
// the exact bf16 operand, each part adding 8 bits of significand: three
// parts of M (y keeps the fp32 tolerance), two of w x (S keeps the state
// tolerance). q pads to 16 rows with zeros, n to 16 columns.
//
// Intra, fp32 inputs (ssd_intra_f32): scalar fp32 FMAs from shared
// memory, the first version's design with the same cumsum prologue, kept
// because tensor cores cannot hold the fp32 tolerance on fp32 inputs. It
// stages x, B, C, cum, dt and the (q x q) weight matrix as fp32 (167 KB,
// one block per SM) and runs 4 x 4 register tiles on 64-row groups.
//
// Inter (ssd_inter_scan), both types: a block walks its chunks with a
// two-stage cp.async ring, so chunk c + 1's C, y_intra, S, cum and dec
// tiles (40 KB in bf16 at full width) fly while chunk c computes. The
// state slice h[:, 32 columns] (8 KB) stays in shared memory. bf16: C . h
// on mma.sync with C the exact bf16 A operand and h in two bf16 parts
// (hi, lo: ~16 bits, error ~1e-5 of |C| |h|, far below the bf16 rounding
// of y), split once per chunk when h is updated; y goes out through a
// per-warp bf16 tile as 16-byte stores. fp32: C . h on scalar fp32 FMAs
// (4 x 4 register tiles), y as 16-byte stores.
//
// What bounds them on the H100, at b = 1, s = 512, q = 128, h = 64,
// n = p = 64: the intra pass needs ~0.56 GFLOP against ~17 MB moved. On
// the bf16 tensor cores (989 TFLOP/s) the operations take ~0.6 us and the
// bytes ~5 us: the bf16 route is bound by the bytes. At the fp32 peak
// outside the tensor cores (67 TFLOP/s) the operations take ~8 us: the
// fp32 route is bound by the operations. The inter pass moves 18 MB
// (y_intra 8 MB and S 4 MB in, y 4 MB and h_last 1 MB out) for ~0.27
// GFLOP: bound by the bytes (~5.4 us) on either route. b h (p / 32) = 128
// blocks walk 4 chunks each; the ring keeps the next chunk's loads in
// flight behind this chunk's compute. On an H100 SXM at 700 W the bf16
// route takes ~11 us, twice the bound, and ~2.3 us more for each chunk a
// block walks past the second (1, 2, 4, 8 chunks at h = 64: ~5.2, 6.7,
// 11.1, 20.5 us; scripts/ssd_inter_variants.py). A third ring stage
// gained 1%, a fourth lost 7%; 16-column tiles (256 blocks, C read twice
// as often) lost 23% and 64-column ones (64 blocks) 41%. So each block's
// walk through its chunks, not the depth of the ring, sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int NT = 256;    // threads per block, a 16 x 16 grid (scalar)
constexpr int TILE = 64;   // rows of a register-tiled group, 4 per thread
constexpr int Q_MAX = 128; // longest chunk

__host__ __device__ __forceinline__ int pad_rows(int q) {
  return (q + TILE - 1) / TILE * TILE;
}
__host__ __device__ __forceinline__ int pad16(int q) {
  return (q + 15) / 16 * 16;
}

// cum[0..q) = inclusive prefix sums of cum[0..q) in index order, by one
// thread: the order of torch.cumsum along a non-innermost axis on the card
__device__ __forceinline__ void scan_in_order(float* cum, int q) {
  float acc = 0.f;
  for (int r = 0; r < q; ++r) {
    acc += cum[r];
    cum[r] = acc;
  }
}

// ---------------------------------------------------------------------------
// intra, bf16 inputs: mma.sync
// ---------------------------------------------------------------------------

constexpr int MNT = 256;     // threads per block: 8 warps
// bf16 parts of M in y = M x: two (16 bits of M) left y_intra up to 1e-3
// from the fp32 plain version at full width, outside its fp32 tolerance;
// three keep all 24 bits
constexpr int M_PARTS = 3;
// bf16 parts of w x in S = B^T (w x): two hold the state tolerance
constexpr int WX_PARTS = 2;

template <int N, int P>
struct MmaShape {
  static constexpr int NP = N < 16 ? 16 : N;  // state padded to mma depth
  static constexpr int LDN = NP + 8;          // padded rows (elements)
  static constexpr int LDP = P + 8;
};

template <int N, int P>
size_t intra_mma_smem_bytes(int q) {
  using S = MmaShape<N, P>;
  const size_t qp = pad16(q);
  // C, B, x as bf16; cum, dt, w as fp32
  return qp * (2 * S::LDN + S::LDP) * sizeof(bf16) + 3 * qp * sizeof(float);
}

// rows [16 r, 16 r + 16) of y = M x, M = (C B^T) exp(cum_i - cum_j) dt_j
template <int N, int P>
__device__ __forceinline__ void intra_rows(int r, const bf16* sC,
                                           const bf16* sB, const bf16* sX,
                                           const float* sCum,
                                           const float* sDt, int q,
                                           float* yp, int64_t row_hp) {
  using S = MmaShape<N, P>;
  constexpr int KN = S::NP / 16;  // k steps of C B^T
  constexpr int PT = P / 8;       // 8-column tiles of y
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  uint32_t cf[KN][4];
#pragma unroll
  for (int kd = 0; kd < KN; ++kd)
    ldmatrix_x4(cf[kd], sC + (16 * r + (lane & 15)) * S::LDN + kd * 16 +
                            (lane >> 4) * 8);
  const int i0 = 16 * r + g;  // rows i0 and i0 + 8
  const float cum_i[2] = {sCum[i0], sCum[i0 + 8]};

  float acc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int jt = 0; jt <= r; ++jt) {
    // G for columns [16 jt, 16 jt + 16): two 8-column tiles
    float gm[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) gm[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KN; ++kd) {
      uint32_t bf[4];
      ldmatrix_x4(bf, sB + (16 * jt + (lane & 7) + ((lane >> 4) << 3)) *
                               S::LDN +
                          kd * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(gm[0], cf[kd], bf[0], bf[1]);
      mma_bf16(gm[1], cf[kd], bf[2], bf[3]);
    }
    // M in registers; the exp only where j <= i
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + (e >> 1) * 8;
        const int j = 16 * jt + 8 * nt + 2 * t + (e & 1);
        float m = 0.f;
        if (j <= i && i < q)
          m = gm[nt][e] * expf(cum_i[e >> 1] - sCum[j]) * sDt[j];
        gm[nt][e] = m;
      }
    // the A fragment of M for k = j: (g, 2t..), (g + 8, 2t..), then + 8
    uint32_t mf[4][M_PARTS];
    split_bf16<M_PARTS>(gm[0][0], gm[0][1], mf[0]);
    split_bf16<M_PARTS>(gm[0][2], gm[0][3], mf[1]);
    split_bf16<M_PARTS>(gm[1][0], gm[1][1], mf[2]);
    split_bf16<M_PARTS>(gm[1][2], gm[1][3], mf[3]);
#pragma unroll
    for (int pn = 0; pn < P / 16; ++pn) {
      uint32_t xf[4];
      ldmatrix_x4_trans(xf, sX + (16 * jt + (lane & 7) +
                                  (((lane >> 3) & 1) << 3)) * S::LDP +
                                pn * 16 + ((lane >> 4) << 3));
#pragma unroll
      for (int part = 0; part < M_PARTS; ++part) {
        const uint32_t a[4] = {mf[0][part], mf[1][part], mf[2][part],
                               mf[3][part]};
        mma_bf16(acc[2 * pn], a, xf[0], xf[1]);
        mma_bf16(acc[2 * pn + 1], a, xf[2], xf[3]);
      }
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = i0 + 8 * h2;
    if (i >= q) continue;
    float* row = yp + i * row_hp;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
      *reinterpret_cast<float2*>(row + pt * 8 + 2 * t) =
          make_float2(acc[pt][2 * h2], acc[pt][2 * h2 + 1]);
  }
}

// columns [16 pu, 16 pu + 16) of S = B^T (w x), w_j = exp(cum_last -
// cum_j) dt_j
template <int N, int P>
__device__ __forceinline__ void intra_state(int pu, const bf16* sB,
                                            const bf16* sX, const float* sW,
                                            int qp, float* sp) {
  using S = MmaShape<N, P>;
  constexpr int NR = S::NP / 16;  // 16-row tiles of S
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  float acc[NR][2][4];
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][nt][e] = 0.f;

  for (int j0 = 0; j0 < qp; j0 += 16) {
    // x[j0 + 2t.., 16 pu + g] (b0) and x[j0 + 8 + 2t.., ...] (b1), for the
    // two 8-column tiles; times w_j, in bf16 parts
    uint32_t xf[4];
    ldmatrix_x4_trans(xf, sX + (j0 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                   S::LDP +
                              16 * pu + ((lane >> 4) << 3));
    const float w[4] = {sW[j0 + 2 * t], sW[j0 + 2 * t + 1],
                        sW[j0 + 8 + 2 * t], sW[j0 + 9 + 2 * t]};
    uint32_t wf[4][WX_PARTS];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float2 xv = unpack_bf16(xf[f]);
      const int wi = (f & 1) * 2;  // b0 registers take j0 + 2t, b1 + 8
      split_bf16<WX_PARTS>(xv.x * w[wi], xv.y * w[wi + 1], wf[f]);
    }
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      // A = B^T: rows n, k = j
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, sB + (j0 + (lane & 7) + ((lane >> 4) << 3)) *
                                     S::LDN +
                                16 * a + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int part = 0; part < WX_PARTS; ++part) {
        mma_bf16(acc[a][0], bt, wf[0][part], wf[1][part]);
        mma_bf16(acc[a][1], bt, wf[2][part], wf[3][part]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int n = 16 * a + g + 8 * h2;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<float2*>(sp + n * P + 16 * pu + 8 * nt + 2 * t) =
            make_float2(acc[a][nt][2 * h2], acc[a][nt][2 * h2 + 1]);
    }
}

template <int N, int P>
__global__ void __launch_bounds__(MNT)
ssd_intra_mma(const bf16* __restrict__ xh, const bf16* __restrict__ bm,
              const bf16* __restrict__ cm, const float* __restrict__ log_a,
              const float* __restrict__ dt, float* __restrict__ y,
              float* __restrict__ s_out, float* __restrict__ dec,
              float* __restrict__ cum_out, int q, int h) {
  static_assert(P % 16 == 0 && N % 8 == 0, "unsupported (n, p)");
  using S = MmaShape<N, P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qp = pad16(q);
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);  // qp x LDN
  bf16* sB = sC + qp * S::LDN;                   // qp x LDN
  bf16* sX = sB + qp * S::LDN;                   // qp x LDP
  float* sCum = reinterpret_cast<float*>(sX + qp * S::LDP);  // qp
  float* sDt = sCum + qp;                                    // qp
  float* sW = sDt + qp;                                      // qp

  const int tid = threadIdx.x, warp = tid >> 5;
  const int ih = blockIdx.x;
  const int64_t bc = blockIdx.y;  // batch * n_chunks + chunk
  const int64_t row_hp = (int64_t)h * P;
  const bf16* xp = xh + bc * q * row_hp + (int64_t)ih * P;
  const bf16* bp = bm + bc * q * N;
  const bf16* cp = cm + bc * q * N;
  const int64_t hq0 = bc * q * h + ih;  // (b, c, q, h) index of row 0

  // stage the chunk as bf16; padded rows and state columns are zero
  constexpr int CN = S::NP / 8, CP = P / 8;  // 16-byte pieces per row
  for (int idx = tid; idx < qp * CN; idx += MNT) {
    const int r = idx / CN, c = idx % CN;
    const bool live = r < q && c * 8 < N;
    const int64_t off = live ? (int64_t)r * N + c * 8 : 0;
    cp_async16(sC + r * S::LDN + c * 8, cp + off, live);
    cp_async16(sB + r * S::LDN + c * 8, bp + off, live);
  }
  for (int idx = tid; idx < qp * CP; idx += MNT) {
    const int r = idx / CP, c = idx % CP;
    const bool live = r < q;
    cp_async16(sX + r * S::LDP + c * 8, xp + (live ? r * row_hp : 0) + c * 8,
               live);
  }
  cp_async_commit();

  // the cumsum, while the copies fly
  for (int r = tid; r < qp; r += MNT) {
    sCum[r] = r < q ? log_a[hq0 + (int64_t)r * h] : 0.f;
    sDt[r] = r < q ? dt[hq0 + (int64_t)r * h] : 0.f;
  }
  __syncthreads();
  if (tid == 0) scan_in_order(sCum, q);
  __syncthreads();
  const float cum_last = sCum[q - 1];
  for (int r = tid; r < qp; r += MNT) {
    if (r < q) cum_out[hq0 + (int64_t)r * h] = sCum[r];
    sW[r] = r < q ? expf(cum_last - sCum[r]) * sDt[r] : 0.f;
  }
  if (tid == 0) dec[bc * h + ih] = expf(cum_last);
  cp_async_wait<0>();
  __syncthreads();

  if (warp < 4) {
    const int rt = qp / 16;  // 16-row tiles: warp w takes w and rt - 1 - w
    if (warp < (rt + 1) / 2) {
      float* yp = y + bc * q * row_hp + (int64_t)ih * P;
      intra_rows<N, P>(warp, sC, sB, sX, sCum, sDt, q, yp, row_hp);
      if (rt - 1 - warp > warp)
        intra_rows<N, P>(rt - 1 - warp, sC, sB, sX, sCum, sDt, q, yp, row_hp);
    }
  } else if (warp - 4 < P / 16) {
    intra_state<N, P>(warp - 4, sB, sX, sW, qp,
                      s_out + (bc * h + ih) * (int64_t)(N * P));
  }
}

// ---------------------------------------------------------------------------
// intra, fp32 inputs: scalar FMAs
// ---------------------------------------------------------------------------

template <int N, int P>
size_t intra_f32_smem_bytes(int q) {
  const int qp = pad_rows(q);
  // C, B (rows padded by one float), x, M (q_pad x (q_pad + 1)), cum, dt
  return sizeof(float) *
         ((size_t)qp * (2 * (N + 1) + (P + 1) + qp + 1) + 2 * qp);
}

template <int N, int P>
__global__ void __launch_bounds__(NT)
ssd_intra_f32(const float* __restrict__ xh, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ log_a,
              const float* __restrict__ dt, float* __restrict__ y,
              float* __restrict__ s_out, float* __restrict__ dec,
              float* __restrict__ cum_out, int q, int h) {
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

  const float* xp = xh + bc * q * row_hp + (int64_t)ih * P;
  const float* bp = bm + bc * q * N;
  const float* cp = cm + bc * q * N;
  const int64_t hq0 = bc * q * h + ih;  // (b, c, q, h) index of row 0

  // stage the chunk; rows past q are zero
  for (int idx = tid; idx < qp * N; idx += NT) {
    const int r = idx / N, k = idx % N;
    const bool live = r < q;
    sC[r * LDN + k] = live ? cp[r * N + k] : 0.f;
    sB[r * LDN + k] = live ? bp[r * N + k] : 0.f;
  }
  for (int idx = tid; idx < qp * P; idx += NT) {
    const int r = idx / P, k = idx % P;
    sX[r * LDP + k] = r < q ? xp[r * row_hp + k] : 0.f;
  }
  for (int r = tid; r < qp; r += NT) {
    sCum[r] = r < q ? log_a[hq0 + (int64_t)r * h] : 0.f;
    sDt[r] = r < q ? dt[hq0 + (int64_t)r * h] : 0.f;
  }
  __syncthreads();
  if (tid == 0) scan_in_order(sCum, q);
  __syncthreads();
  for (int r = tid; r < q; r += NT) cum_out[hq0 + (int64_t)r * h] = sCum[r];

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

// ---------------------------------------------------------------------------
// inter with the chunk recurrence: bf16 on mma.sync, fp32 on scalar FMAs
// ---------------------------------------------------------------------------

constexpr int INT_NT = 256;  // threads per block: 8 warps
// bf16 parts of the fp32 state h in C . h: two keep ~16 bits
constexpr int H_PARTS = 2;

// Shared-memory layout of one inter block: a ring of STAGES chunk tiles,
// then the state and (bf16 route) its parts and the y tile. Every row
// pitch is a multiple of 16 bytes and staggers the rows across banks.
// the dynamic shared memory a block may have on sm_90
constexpr int SMEM_MAX = 227 * 1024;

template <typename T, int N, int P>
struct Inter {
  static constexpr bool MMA = sizeof(T) == 2;        // the bf16 route
  static constexpr int PT = P < 32 ? P : 32;         // head_dim per block
  static constexpr int NP = MMA && N < 16 ? 16 : N;  // n padded to mma depth
  static constexpr int LDC = MMA ? NP + 8 : N + 4;   // C rows (elements)
  static constexpr int LDY = PT + 8;                 // y_intra rows (fp32)
  static constexpr int LDS = PT + 4;                 // S and h rows (fp32)
  static constexpr int LDB = PT + 8;                 // h parts, y rows (bf16)
  static constexpr int C_OFF = 0;
  static constexpr int Y_OFF = C_OFF + Q_MAX * LDC * (int)sizeof(T);
  static constexpr int S_OFF = Y_OFF + Q_MAX * LDY * 4;
  static constexpr int CUM_OFF = S_OFF + N * LDS * 4;
  static constexpr int DEC_OFF = CUM_OFF + Q_MAX * 4;
  static constexpr int STAGE = DEC_OFF + 16;
  // the state, its bf16 parts and the y tile, after the ring
  static constexpr int TAIL = NP * LDS * 4 +
                              (MMA ? H_PARTS * NP * LDB * 2 + Q_MAX * LDB * 2
                                   : 0);
  // chunks in the ring: two where they fit beside the tail; one at
  // (n, p) = (128, 64) in fp32, whose two stages would pass SMEM_MAX by
  // 32 bytes (each chunk then loads after the last has been used)
  static constexpr int STAGES = 2 * STAGE + TAIL <= SMEM_MAX ? 2 : 1;
  static constexpr int H_OFF = STAGES * STAGE;
  static constexpr int HB_OFF = H_OFF + NP * LDS * 4;
  static constexpr int OUT_OFF = HB_OFF + (MMA ? H_PARTS * NP * LDB * 2 : 0);
  static constexpr int SMEM = OUT_OFF + (MMA ? Q_MAX * LDB * 2 : 0);
  static_assert(SMEM <= SMEM_MAX, "the inter block's tiles do not fit");
};

// Start the copies of chunk ck's tiles (ck = batch * chunks + chunk) into
// one stage: C (rows [0, rows), zero past q and past n), the block's
// columns of y_intra and S, cum and dec.
template <typename T, int N, int P>
__device__ __forceinline__ void inter_load(
    unsigned char* stage, const T* cm, const float* cum, const float* s_chunk,
    const float* dec, const float* y_intra, int64_t ck, int rows, int q, int h,
    int ih, int p0) {
  using L = Inter<T, N, P>;
  const int tid = threadIdx.x;
  T* sC = reinterpret_cast<T*>(stage + L::C_OFF);
  float* sY = reinterpret_cast<float*>(stage + L::Y_OFF);
  float* sS = reinterpret_cast<float*>(stage + L::S_OFF);
  float* sCum = reinterpret_cast<float*>(stage + L::CUM_OFF);
  constexpr int EP = 16 / sizeof(T);             // elements per 16 bytes
  constexpr int CN = (L::MMA ? L::NP : N) / EP;  // pieces per C row
  constexpr int YN = L::PT / 4;                  // pieces per y_intra/S row
  const int64_t row_hp = (int64_t)h * P;

  const T* cp = cm + ck * q * N;
  for (int idx = tid; idx < rows * CN; idx += INT_NT) {
    const int r = idx / CN, k = idx % CN * EP;
    const bool live = r < q && k < N;
    cp_async16(sC + r * L::LDC + k, cp + (live ? r * N + k : 0), live);
  }
  const float* yp = y_intra + ck * q * row_hp + (int64_t)ih * P + p0;
  for (int idx = tid; idx < rows * YN; idx += INT_NT) {
    const int r = idx / YN, k = idx % YN * 4;
    const bool live = r < q;
    cp_async16(sY + r * L::LDY + k, yp + (live ? r * row_hp + k : 0), live);
  }
  const float* sp = s_chunk + (ck * h + ih) * (int64_t)(N * P) + p0;
  for (int idx = tid; idx < N * YN; idx += INT_NT) {
    const int r = idx / YN, k = idx % YN * 4;
    cp_async16(sS + r * L::LDS + k, sp + r * P + k, true);
  }
  const float* cup = cum + ck * q * h + ih;
  for (int r = tid; r < rows; r += INT_NT)
    cp_async4(sCum + r, cup + (r < q ? (int64_t)r * h : 0), r < q);
  if (tid == 0) cp_async4(stage + L::DEC_OFF, dec + ck * h + ih, true);
}

// h[k, col..col + 1] = v, and on the bf16 route its bf16 parts
template <typename T, int N, int P>
__device__ __forceinline__ void put_state(unsigned char* smem, int k, int col,
                                          float2 v) {
  using L = Inter<T, N, P>;
  float* sH = reinterpret_cast<float*>(smem + L::H_OFF);
  *reinterpret_cast<float2*>(sH + k * L::LDS + col) = v;
  if constexpr (L::MMA) {
    uint32_t parts[H_PARTS];
    split_bf16<H_PARTS>(v.x, v.y, parts);
    bf16* sHb = reinterpret_cast<bf16*>(smem + L::HB_OFF);
#pragma unroll
    for (int part = 0; part < H_PARTS; ++part)
      *reinterpret_cast<uint32_t*>(sHb + (part * L::NP + k) * L::LDB + col) =
          parts[part];
  }
}

// the rows of one chunk's y from a landed stage and the state h
template <typename T, int N, int P>
__device__ __forceinline__ void inter_rows(unsigned char* smem,
                                           const unsigned char* stage, T* yp,
                                           int64_t row_hp, int q) {
  using L = Inter<T, N, P>;
  const T* sC = reinterpret_cast<const T*>(stage + L::C_OFF);
  const float* sY = reinterpret_cast<const float*>(stage + L::Y_OFF);
  const float* sCum = reinterpret_cast<const float*>(stage + L::CUM_OFF);
  const int tid = threadIdx.x;
  if constexpr (L::MMA) {
    // warp w: rows [16 w, 16 w + 16) of C . h on mma.sync
    constexpr int KN = L::NP / 16, NTL = L::PT / 8;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    if (16 * warp >= q) return;
    const bf16* sHb = reinterpret_cast<const bf16*>(smem + L::HB_OFF);
    float acc[NTL][4];
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KN; ++kd) {
      uint32_t af[4];
      ldmatrix_x4(af, sC + (16 * warp + (lane & 15)) * L::LDC + kd * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int pn = 0; pn < L::PT / 16; ++pn)
#pragma unroll
        for (int part = 0; part < H_PARTS; ++part) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, sHb + (part * L::NP + 16 * kd + (lane & 7) +
                         (((lane >> 3) & 1) << 3)) * L::LDB +
                      pn * 16 + ((lane >> 4) << 3));
          mma_bf16(acc[2 * pn], af, bf[0], bf[1]);
          mma_bf16(acc[2 * pn + 1], af, bf[2], bf[3]);
        }
    }
    // y = y_intra + exp(cum_i) (C . h) as bf16 into the warp's rows of the
    // y tile, then out in 16-byte pieces
    bf16* sOut = reinterpret_cast<bf16*>(smem + L::OUT_OFF);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = 16 * warp + g + 8 * h2;
      const float e = expf(sCum[i]);
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 yi =
            *reinterpret_cast<const float2*>(sY + i * L::LDY + col);
        *reinterpret_cast<uint32_t*>(sOut + i * L::LDB + col) = pack_bf16(
            yi.x + acc[j][2 * h2] * e, yi.y + acc[j][2 * h2 + 1] * e);
      }
    }
    __syncwarp();
    constexpr int RP = L::PT / 8;  // 16-byte pieces of a y row
    for (int idx = lane; idx < 16 * RP; idx += 32) {
      const int i = 16 * warp + idx / RP, k = idx % RP * 8;
      if (i < q)
        *reinterpret_cast<uint4*>(yp + i * row_hp + k) =
            *reinterpret_cast<const uint4*>(sOut + i * L::LDB + k);
    }
  } else {
    // thread (tx, ty): rows ty + TY i, columns [4 tx, 4 tx + 4)
    constexpr int TX = L::PT / 4, TY = INT_NT / TX, RI = Q_MAX / TY;
    const int tx = tid % TX, ty = tid / TX;
    const float* sH = reinterpret_cast<const float*>(smem + L::H_OFF);
    float acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll 8
    for (int k = 0; k < N; ++k) {
      const float4 hv =
          *reinterpret_cast<const float4*>(sH + k * L::LDS + 4 * tx);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float a = sC[(ty + TY * i) * L::LDC + k];
        acc[i][0] = fmaf(a, hv.x, acc[i][0]);
        acc[i][1] = fmaf(a, hv.y, acc[i][1]);
        acc[i][2] = fmaf(a, hv.z, acc[i][2]);
        acc[i][3] = fmaf(a, hv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i;
      if (r >= q) continue;
      const float e = expf(sCum[r]);
      const float4 yi =
          *reinterpret_cast<const float4*>(sY + r * L::LDY + 4 * tx);
      *reinterpret_cast<float4*>(yp + r * row_hp + 4 * tx) =
          make_float4(yi.x + acc[i][0] * e, yi.y + acc[i][1] * e,
                      yi.z + acc[i][2] * e, yi.w + acc[i][3] * e);
    }
  }
}

// one block per (head_dim slice, head, batch), walking the c chunks in order
template <typename T, int N, int P>
__global__ void __launch_bounds__(INT_NT, 1)
ssd_inter_scan(const T* __restrict__ cm, const float* __restrict__ cum,
               const float* __restrict__ s_chunk,
               const float* __restrict__ dec,
               const float* __restrict__ y_intra,
               const float* __restrict__ h0, T* __restrict__ y,
               float* __restrict__ h_last, int c, int q, int h) {
  using L = Inter<T, N, P>;
  static_assert(P % 16 == 0 && N % 8 == 0, "unsupported (n, p)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const float* sH = reinterpret_cast<const float*>(smem + L::H_OFF);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * L::PT, ih = blockIdx.y, bb = blockIdx.z;
  const int64_t row_hp = (int64_t)h * P;
  // rows a chunk stages: the mma warps read whole 16-row tiles, the scalar
  // route every row
  const int rows = L::MMA ? pad16(q) : Q_MAX;
  auto load = [&](int st, int ci) {
    inter_load<T, N, P>(smem + st * L::STAGE, cm, cum, s_chunk, dec, y_intra,
                        (int64_t)bb * c + ci, rows, q, h, ih, p0);
  };

  // the first STAGES - 1 chunks in flight, one commit group each
  for (int ci = 0; ci < L::STAGES - 1; ++ci) {
    if (ci < c) load(ci, ci);
    cp_async_commit();
  }

  // h = h0, or zeros; state rows past n (the mma padding) are zero
  const int64_t hb = (int64_t)(bb * h + ih) * N * P + p0;
  for (int idx = tid; idx < L::NP * L::PT / 2; idx += INT_NT) {
    const int k = idx / (L::PT / 2), col = idx % (L::PT / 2) * 2;
    float2 v = make_float2(0.f, 0.f);
    if (h0 != nullptr && k < N)
      v = make_float2(h0[hb + k * P + col], h0[hb + k * P + col + 1]);
    put_state<T, N, P>(smem, k, col, v);
  }

  for (int ci = 0; ci < c; ++ci) {
    // chunk ci + STAGES - 1 into the stage chunk ci - 1 has freed
    const int next = ci + L::STAGES - 1;
    if (next < c) load(next % L::STAGES, next);
    cp_async_commit();
    unsigned char* stage = smem + ci % L::STAGES * L::STAGE;
    cp_async_wait<L::STAGES - 1>();  // chunk ci's copies have landed
    __syncthreads();
    inter_rows<T, N, P>(
        smem, stage,
        y + ((int64_t)bb * c + ci) * q * row_hp + (int64_t)ih * P + p0,
        row_hp, q);
    __syncthreads();  // h is read: now h = h dec + S, rounded twice
    const float* sS = reinterpret_cast<const float*>(stage + L::S_OFF);
    const float d = *reinterpret_cast<const float*>(stage + L::DEC_OFF);
    for (int idx = tid; idx < N * L::PT / 2; idx += INT_NT) {
      const int k = idx / (L::PT / 2), col = idx % (L::PT / 2) * 2;
      const float2 hv =
          *reinterpret_cast<const float2*>(sH + k * L::LDS + col);
      const float2 sv =
          *reinterpret_cast<const float2*>(sS + k * L::LDS + col);
      put_state<T, N, P>(smem, k, col,
                         make_float2(__fadd_rn(__fmul_rn(hv.x, d), sv.x),
                                     __fadd_rn(__fmul_rn(hv.y, d), sv.y)));
    }
    __syncthreads();  // the stage is free and h is whole
  }

  for (int idx = tid; idx < N * L::PT / 4; idx += INT_NT) {
    const int k = idx / (L::PT / 4), col = idx % (L::PT / 4) * 4;
    *reinterpret_cast<float4*>(h_last + hb + k * P + col) =
        *reinterpret_cast<const float4*>(sH + k * L::LDS + col);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int N, int P>
cudaError_t launch_intra(int dtype, const void* xh, const void* bm,
                         const void* cm, const void* log_a, const void* dt,
                         void* y, void* s, void* dec, void* cum, int bc,
                         int q, int h, cudaStream_t stream) {
  const dim3 grid(h, bc);
  const float* la = static_cast<const float*>(log_a);
  const float* dtp = static_cast<const float*>(dt);
  float *yo = static_cast<float*>(y), *so = static_cast<float*>(s),
        *deco = static_cast<float*>(dec), *cumo = static_cast<float*>(cum);
  if (dtype == 1) {
    const size_t smem = intra_mma_smem_bytes<N, P>(q);
    cudaError_t err = set_smem(ssd_intra_mma<N, P>, smem);
    if (err != cudaSuccess) return err;
    ssd_intra_mma<N, P><<<grid, MNT, smem, stream>>>(
        static_cast<const bf16*>(xh), static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), la, dtp, yo, so, deco, cumo, q, h);
  } else {
    const size_t smem = intra_f32_smem_bytes<N, P>(q);
    cudaError_t err = set_smem(ssd_intra_f32<N, P>, smem);
    if (err != cudaSuccess) return err;
    ssd_intra_f32<N, P><<<grid, NT, smem, stream>>>(
        static_cast<const float*>(xh), static_cast<const float*>(bm),
        static_cast<const float*>(cm), la, dtp, yo, so, deco, cumo, q, h);
  }
  return cudaGetLastError();
}

template <typename T, int N, int P>
cudaError_t launch_inter(const void* cm, const void* cum, const void* s_chunk,
                         const void* dec, const void* y_intra, const void* h0,
                         void* y, void* h_last, int b, int c, int q, int h,
                         cudaStream_t stream) {
  using L = Inter<T, N, P>;
  auto kernel = ssd_inter_scan<T, N, P>;
  cudaError_t err = set_smem(kernel, L::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(P / L::PT, h, b), INT_NT, L::SMEM, stream>>>(
      static_cast<const T*>(cm), static_cast<const float*>(cum),
      static_cast<const float*>(s_chunk), static_cast<const float*>(dec),
      static_cast<const float*>(y_intra), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), c, q, h);
  return cudaGetLastError();
}

// The (n, p) pairs built: the reference's test sweep (8, 16) and (16, 32),
// which is also the reduced config's, zamba2's full width (64, 64) and
// granite-4.0-h's (128, 64). At (128, 64) the intra pass stages 88 KB in
// bf16 and 227 KB (all a block may have) in fp32; the inter pass 193 KB
// in bf16 and, with one stage, 123 KB in fp32.
#define SSD_SHAPES(X) X(8, 16) X(16, 32) X(64, 64) X(128, 64)

template <typename T>
cudaError_t inter_by_shape(int n, int p, const void* cm, const void* cum,
                           const void* s_chunk, const void* dec,
                           const void* y_intra, const void* h0, void* y,
                           void* h_last, int b, int c, int q, int h,
                           cudaStream_t stream) {
#define SSD_CASE(N_, P_)                                                     \
  if (n == N_ && p == P_)                                                    \
    return launch_inter<T, N_, P_>(cm, cum, s_chunk, dec, y_intra, h0, y,    \
                                   h_last, b, c, q, h, stream);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of xh/bm/cm (intra) or cm/y (inter): 0 = float32, 1 = bfloat16.
// 1 <= q <= 128; bc = batch x chunks. All tensors contiguous; the ones
// copied in 16-byte pieces (bf16 intra inputs; inter cm, S and y_intra)
// on 16-byte boundaries. Each returns cudaGetLastError after the launch
// (0 on success).
extern "C" int ssd_intra_fwd(int dtype, int n, int p, const void* xh,
                             const void* bm, const void* cm,
                             const void* log_a, const void* dt, void* y,
                             void* s, void* dec, void* cum, int bc, int q,
                             int h, void* stream) {
  if (q < 1 || q > Q_MAX || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_CASE(N_, P_)                                                    \
  if (n == N_ && p == P_)                                                   \
    return launch_intra<N_, P_>(dtype, xh, bm, cm, log_a, dt, y, s, dec, cum, \
                                bc, q, h, st);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

// h0 may be null (a zero state); y and h_last are written.
extern "C" int ssd_inter_fwd(int dtype, int n, int p, const void* cm,
                             const void* cum, const void* s_chunk,
                             const void* dec, const void* y_intra,
                             const void* h0, void* y, void* h_last, int b,
                             int c, int q, int h, void* stream) {
  if (q < 1 || q > Q_MAX || b < 1 || c < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return inter_by_shape<float>(n, p, cm, cum, s_chunk, dec, y_intra, h0, y,
                                 h_last, b, c, q, h, st);
  if (dtype == 1)
    return inter_by_shape<bf16>(n, p, cm, cum, s_chunk, dec, y_intra, h0, y,
                                h_last, b, c, q, h, st);
  return cudaErrorInvalidValue;
}
