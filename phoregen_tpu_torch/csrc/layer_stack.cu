// Fused layer-stack stage kernels for Hopper (sm_90a), float32 throughout.
//
// These replace the four Pallas TPU kernels that `layer_stack_pallas`
// (phoregen_tpu/ops/layer_stack.py) runs per attention layer:
//   ls_stage_node       <- _stage_pallas o _stage_node         (stage A)
//   ls_stage_trip_pre   <- _stage_pallas o _stage_triplet_pre  (stage B1)
//   ls_stage_trip_att   <- _att_pallas / _head_att_accumulate  (stage B2)
//   ls_stage_pos        <- _stage_pallas o _stage_pos          (stage C)
// and the two merged kernels of fused_stack 'pallas3' / 'pallas2':
//   ls_stage_node_pre   <- _stage_pallas o _stage_node_pre     (A + B1)
//   ls_stage_att_pos    <- _att_pos_pallas                     (B2 + C)
// The merged kernels and the single ones run the SAME __device__ bodies
// (node_body, trip_pre_body, trip_att_pairs_impl, pos_body), so the settings
// cannot drift apart.
//
// Design notes (what differs from the TPU kernels, and why):
// - Parallelism. The Pallas kernels run grid (B,) — one graph per step,
//   right for one TPU core. Here A and C run one block per (graph, node),
//   B1 one block per (graph, j), B2 one block per (graph, j, i-tile), so a
//   batch of 16 graphs gives thousands of blocks for 132 SMs.
// - Heads in B2 are a loop inside the block (a warp per (pair, head)); the
//   TPU carried the output across a sequential head grid axis, which blocks
//   on a GPU cannot do. Each (j, i) pair's pre_t tile [K8, Wt] is loaded
//   once into shared memory and serves all heads.
// - Gathers load by index (nbr_idx, trip_idx, lig3_idx) instead of the
//   TPU's one-hot selection matmuls.
// - The small products (k/v second layers, query MLPs, lin_W, t_out_W) stay
//   inside the kernels as a tiled shared-memory FMA loop (`mm_smem`). The
//   node projections that neighbours gather (h @ [e_Wn_h|q_W0|b_Wn], ...)
//   are a grid-wide phase: each stage entry first launches `rows_gemm`,
//   then its main kernel — a fixed sequence of two launches, one count.
// - Bounds on the H100 (flagship, B=16, NL=80, NP=96): every stage is
//   bound by float32 FMA throughput outside the tensor cores (67 TFLOP/s)
//   except B1, whose pre_t write (B*NL*NL*K8*Wt*4 = 419 MB) makes it bound
//   by bytes (3.35 TB/s). No wgmma/TMA yet: a simple kernel that is right
//   comes first; the measured times sit beside their bounds in PERF.md.
// Numerics kept from the reference: LayerNorm as E[x^2]-mu^2, the masked
// softmax with (1-mask)*-1e9 and a denominator floor of 1.0, the cross
// product clamp at 1e-12 before the sqrt, atan2f for the triplet angle.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF_F (-1e9f)
#define LN_EPS_F 1e-6f
#define CROSS_SQ_EPS_F 1e-12f
#define NRBF 20
#define NANG 13
#define FE 93    // [edge type x rbf (80) | edge type (4) | dire (9)]
#define FEP 96   // padded row pitch of the edge-feature tile
#define SCH 32   // bond-grid sources per chunk in stages A and C
#define IT 8     // (j, i) pairs per block in stage B2
#define NT 256   // threads per block

__constant__ float c_rbf_off[NRBF] = {
    0.0f, 1.0f, 1.25f, 1.5f, 1.75f, 2.0f, 2.25f, 2.5f, 2.75f, 3.0f,
    3.5f, 4.0f, 4.5f, 5.0f, 5.5f, 6.0f, 7.0f, 8.0f, 9.0f, 10.0f};
// angular encoding frequency bands for num_ang = 3: [1, 2, 3, 1, 1/2, 1/3]
__constant__ float c_bands[6] = {1.0f, 2.0f, 3.0f, 1.0f, 0.5f, 0.33333334f};
#define RBF_COEFF (-0.5f)  // -0.5 / (offset[1] - offset[0])^2

struct Dims {
  int B, NP, NL, K, K8, H, heads, Wt;
};

#define MAXARGS 40
struct Args {
  const void* p[MAXARGS];
};
#define FP(i) (reinterpret_cast<const float*>(a.p[i]))
#define IP(i) (reinterpret_cast<const int*>(a.p[i]))
#define OUTP(i) (reinterpret_cast<float*>(const_cast<void*>(a.p[i])))

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm (E[x^2] - mu^2 form) and optional ReLU over M rows of width Wd
// in shared memory; one warp per row.
__device__ void ln_rows(float* X, int ldx, int M, int Wd,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, bool relu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < M; r += nw) {
    float* row = X + (size_t)r * ldx;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < Wd; c += 32) {
      const float v = row[c];
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / Wd;
    const float var = s2 / Wd - mu * mu;
    const float rs = rsqrtf(var + LN_EPS_F);
    for (int c = lane; c < Wd; c += 32) {
      const float y = (row[c] - mu) * rs * scale[c] + bias[c];
      row[c] = relu ? fmaxf(y, 0.f) : y;
    }
  }
}

// out[m*ldo + c] (= or +=) bias[c] + sum_k A[m*lda + k] * W[k*ldw + c]
// for m < M, c < Nc. A and out live in shared memory; W and bias in device
// memory (read through L2). A thread owns one column and MR rows in
// registers; when Nc < blockDim the block splits into row groups.
template <int MR>
__device__ void mm_smem(const float* A, int lda, int M,
                        const float* __restrict__ W, int ldw, int Kd, int Nc,
                        const float* __restrict__ bias, float* out, int ldo,
                        bool accumulate) {
  const int nt = blockDim.x, tid = threadIdx.x;
  int G, grp, c0, cstep;
  if (Nc >= nt) {
    G = 1; grp = 0; c0 = tid; cstep = nt;
  } else {
    G = nt / Nc;
    if (tid >= G * Nc) return;
    grp = tid / Nc; c0 = tid % Nc; cstep = Nc;
  }
  for (int c = c0; c < Nc; c += cstep) {
    const float bv = bias ? bias[c] : 0.f;
    for (int m0 = grp * MR; m0 < M; m0 += G * MR) {
      float acc[MR];
      int ro[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        acc[r] = 0.f;
        ro[r] = min(m0 + r, M - 1) * lda;
      }
      for (int k = 0; k < Kd; ++k) {
        const float wv = __ldg(W + (size_t)k * ldw + c);
#pragma unroll
        for (int r = 0; r < MR; ++r) acc[r] = fmaf(A[ro[r] + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (m0 + r < M) {
          float* o = out + (size_t)(m0 + r) * ldo + c;
          *o = accumulate ? *o + (acc[r] + bv) : acc[r] + bv;
        }
      }
    }
  }
}

// Y[r, c] = sum_k X[row(r), k] * W[k, c] (+ bias[c]) with rows grouped per
// graph: row(r) = (r / rpb) * bstride + roff + r % rpb. Grid-wide phase for
// the per-node projections that neighbours gather.
#define RT 32
__global__ void __launch_bounds__(NT)
rows_gemm(const float* __restrict__ X, int ldx, int rows, int rpb,
          int bstride, int roff, int Kd, const float* __restrict__ W, int Nc,
          const float* __restrict__ bias, float* __restrict__ Y) {
  extern __shared__ float sm[];  // [RT][Kd]
  const int r0 = blockIdx.x * RT;
  for (int idx = threadIdx.x; idx < RT * Kd; idx += blockDim.x) {
    const int rr = idx / Kd, k = idx % Kd, r = r0 + rr;
    float v = 0.f;
    if (r < rows) {
      const size_t row = (size_t)(r / rpb) * bstride + roff + r % rpb;
      v = X[row * ldx + k];
    }
    sm[idx] = v;
  }
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= Nc) return;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  for (int k = 0; k < Kd; ++k) {
    const float wv = __ldg(W + (size_t)k * Nc + c);
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = fmaf(sm[r * Kd + k], wv, acc[r]);
  }
  const float bv = bias ? bias[c] : 0.f;
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (r0 + r < rows) Y[(size_t)(r0 + r) * Nc + c] = acc[r] + bv;
}

// ------------------------------------------------ kNN edge attention (A, C)

// Table argument slots shared by stages A and C.
enum {
  T_NBR_IDX = 5, T_NBR_MASK, T_EDGE_TYPE, T_EW, T_PHORE_NORM, T_LIG3_IDX,
  T_LIG3_MASK, T_MASK_L
};

// comb[m]: phore unit norm for phore nodes, neighbour-centroid offset
// (mean of the 3 frozen nearest ligand atoms minus own position) for
// ligand nodes.
__device__ void node_comb(const Dims& d, const Args& a, const float* xb,
                          int b, int m, float out[3]) {
  if (m < d.NP) {
    const float* pn = FP(T_PHORE_NORM) + ((size_t)b * d.NP + m) * 3;
    out[0] = pn[0]; out[1] = pn[1]; out[2] = pn[2];
    return;
  }
  const int l = m - d.NP;
  const int* li = IP(T_LIG3_IDX) + ((size_t)b * d.NL + l) * 3;
  const float* lm = FP(T_LIG3_MASK) + ((size_t)b * d.NL + l) * 3;
  const float cnt = fmaxf(lm[0] + lm[1] + lm[2], 1.f);
  float c[3] = {0.f, 0.f, 0.f};
  for (int q = 0; q < 3; ++q) {
    const float* p = xb + (size_t)(d.NP + li[q]) * 3;
    for (int e = 0; e < 3; ++e) c[e] += lm[q] * p[e];
  }
  const float* pl = xb + (size_t)m * 3;
  for (int e = 0; e < 3; ++e) out[e] = c[e] / cnt - pl[e];
}

struct EdgeSmem {
  float *feat, *pre, *kv, *sc, *qt, *qv, *rel, *emask, *ew;
  int* src;
};

// Shared first half of stages A and C for destination node n: edge
// features, the fused first layer (columns [lo, lo+2H) of e_W plus the
// gathered node terms), LN+ReLU, the k/v second layers (v has Nv columns,
// scaled by e_w), the node query and the masked per-head softmax over K.
// Leaves alpha in sc[K][heads], k in kv[:, :H], v in kv[:, H:H+Nv].
__device__ void edge_attention(
    const Dims& d, const Args& a, const EdgeSmem& s, int b, int n,
    const float* xb, const float* P, int PW, int lo, int ln_row,
    const float* e_W, const float* e_b, const float* dire_W,
    const float* dire_b, const float* e_ln_s, const float* e_ln_b,
    const float* k2W, const float* k2b, const float* v2W, const float* v2b,
    int Nv, int qcol, const float* q_b0, const float* q_ln_s,
    const float* q_ln_b, const float* q_W1, const float* q_b1) {
  const int N = d.NP + d.NL, K = d.K, H = d.H, NH = d.heads, dh = H / NH;
  const int tid = threadIdx.x;
  const float* Pn = P + ((size_t)b * N + n) * PW;
  if (tid < K) {
    const size_t e = ((size_t)b * N + n) * K + tid;
    const int sidx = IP(T_NBR_IDX)[e];
    const float mk = FP(T_NBR_MASK)[e];
    s.src[tid] = sidx;
    s.emask[tid] = mk;
    s.ew[tid] = FP(T_EW)[e];
    float r[3];
    for (int c = 0; c < 3; ++c) r[c] = xb[n * 3 + c] - xb[sidx * 3 + c] * mk;
    for (int c = 0; c < 3; ++c) s.rel[tid * 3 + c] = r[c];
    const float dist = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + 1e-12f);
    float cs[3], cn[3];
    node_comb(d, a, xb, b, sidx, cs);
    node_comb(d, a, xb, b, n, cn);
    float d3[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < 3; ++c) {
      const float v1 = cs[c] * mk, v2 = cn[c], v3 = -r[c];
      d3[0] += v1 * v2;
      d3[1] += v1 * v3;
      d3[2] += v2 * v3;
    }
    float* f = s.feat + tid * FEP;
    const float* et = FP(T_EDGE_TYPE) + e * 4;
    for (int t4 = 0; t4 < 4; ++t4) {
      for (int q = 0; q < NRBF; ++q) {
        const float df = dist - c_rbf_off[q];
        f[t4 * NRBF + q] = et[t4] * expf(RBF_COEFF * (df * df));
      }
      f[80 + t4] = et[t4];
    }
    for (int o = 0; o < 9; ++o)
      f[84 + o] = d3[0] * dire_W[o] + d3[1] * dire_W[9 + o] +
                  d3[2] * dire_W[18 + o] + dire_b[o];
  }
  if (tid < H) s.qt[tid] = Pn[qcol + tid] + q_b0[tid];
  __syncthreads();
  mm_smem<16>(s.feat, FEP, K, e_W + lo, 4 * H, FE, 2 * H, e_b + lo, s.pre,
              2 * H, false);
  ln_rows(s.qt, H, 1, H, q_ln_s, q_ln_b, true);
  __syncthreads();
  for (int idx = tid; idx < K * 2 * H; idx += blockDim.x) {
    const int k = idx / (2 * H), c = idx % (2 * H);
    s.pre[idx] += s.emask[k] * P[((size_t)b * N + s.src[k]) * PW + 2 * H + c]
                  + Pn[c];
  }
  mm_smem<1>(s.qt, H, 1, q_W1, H, H, H, q_b1, s.qv, H, false);
  __syncthreads();
  ln_rows(s.pre, 2 * H, K, H, e_ln_s + ln_row * H, e_ln_b + ln_row * H, true);
  ln_rows(s.pre + H, 2 * H, K, H, e_ln_s + (ln_row + 1) * H,
          e_ln_b + (ln_row + 1) * H, true);
  __syncthreads();
  mm_smem<16>(s.pre, 2 * H, K, k2W, H, H, H, k2b, s.kv, 2 * H, false);
  mm_smem<16>(s.pre + H, 2 * H, K, v2W, Nv, H, Nv, v2b, s.kv + H, 2 * H,
              false);
  __syncthreads();
  for (int idx = tid; idx < K * NH; idx += blockDim.x) {
    const int k = idx / NH, hh = idx % NH;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c)
      acc += s.kv[k * 2 * H + hh * dh + c] * s.qv[hh * dh + c];
    s.sc[idx] = acc / sqrtf((float)dh);
  }
  for (int idx = tid; idx < K * Nv; idx += blockDim.x) {
    const int k = idx / Nv, c = idx % Nv;
    s.kv[k * 2 * H + H + c] *= s.ew[k];
  }
  __syncthreads();
  if (tid < NH) {
    float m = -INFINITY;
    for (int k = 0; k < K; ++k)
      m = fmaxf(m, s.sc[k * NH + tid] + (1.f - s.emask[k]) * NEG_INF_F);
    float sum = 0.f;
    for (int k = 0; k < K; ++k) {
      const float e = expf(s.sc[k * NH + tid] +
                           (1.f - s.emask[k]) * NEG_INF_F - m) * s.emask[k];
      s.sc[k * NH + tid] = e;
      sum += e;
    }
    const float den = fmaxf(sum, 1.f);
    for (int k = 0; k < K; ++k) s.sc[k * NH + tid] /= den;
  }
  __syncthreads();
}

// Row source of bond_attention that reads the bond grid from device
// memory: rows[sr] = hbg[b, s0 + sr, dl, :].
struct HbColumnRows {
  const float* hbg;
  __device__ void operator()(const Dims& d, int b, int dl, int s0, int ns,
                             float* rows) const {
    for (int idx = threadIdx.x; idx < ns * d.H; idx += blockDim.x) {
      const int sr = idx / d.H, c = idx % d.H;
      rows[idx] = hbg[(((size_t)b * d.NL + s0 + sr) * d.NL + dl) * d.H + c];
    }
    __syncthreads();
  }
};

// Dense bond-grid attention over the NL sources of ligand destination dl:
// `load_rows` leaves the bond features of sources [s0, s0+ns) towards dl in
// rows[ns][H] (and ends with a block barrier); then the first layer
// (columns of W1 [H, 2H]) plus the node terms P[dst][dcol:dcol+2H] and
// P[NP+s][scol:scol+2H], LN+ReLU, second layers (k: H columns into kv, v:
// Nv columns into vall[s]), the query (already in qv) and scores into
// scb[s][heads]; then the masked softmax over s.
template <class Rows>
__device__ void bond_attention(
    const Dims& d, const Args& a, const EdgeSmem& s, float* rows,
    float* vall, float* scb, int b, int dl, const Rows& load_rows,
    const float* P,
    int PW, int dcol, int scol, const float* W1, const float* b1,
    const float* ln_s, const float* ln_b, const float* k2W,
    const float* k2b, const float* v2W, const float* v2b, int Nv) {
  const int N = d.NP + d.NL, NL = d.NL, H = d.H, NH = d.heads, dh = H / NH;
  const int tid = threadIdx.x;
  const float* Pn = P + ((size_t)b * N + d.NP + dl) * PW;
  for (int s0 = 0; s0 < NL; s0 += SCH) {
    const int ns = min(SCH, NL - s0);
    load_rows(d, b, dl, s0, ns, rows);
    mm_smem<16>(rows, H, ns, W1, 2 * H, H, 2 * H, b1, s.pre, 2 * H, false);
    __syncthreads();
    for (int idx = tid; idx < ns * 2 * H; idx += blockDim.x) {
      const int sr = idx / (2 * H), c = idx % (2 * H);
      s.pre[idx] += Pn[dcol + c] +
                    P[((size_t)b * N + d.NP + s0 + sr) * PW + scol + c];
    }
    __syncthreads();
    ln_rows(s.pre, 2 * H, ns, H, ln_s, ln_b, true);
    ln_rows(s.pre + H, 2 * H, ns, H, ln_s + H, ln_b + H, true);
    __syncthreads();
    mm_smem<16>(s.pre, 2 * H, ns, k2W, H, H, H, k2b, s.kv, 2 * H, false);
    mm_smem<16>(s.pre + H, 2 * H, ns, v2W, Nv, H, Nv, v2b, vall + s0 * Nv,
                Nv, false);
    __syncthreads();
    for (int idx = tid; idx < ns * NH; idx += blockDim.x) {
      const int sr = idx / NH, hh = idx % NH;
      float acc = 0.f;
      for (int c = 0; c < dh; ++c)
        acc += s.kv[sr * 2 * H + hh * dh + c] * s.qv[hh * dh + c];
      scb[(s0 + sr) * NH + hh] = acc / sqrtf((float)dh);
    }
    __syncthreads();
  }
  const float* ml = FP(T_MASK_L) + (size_t)b * NL;
  if (tid < NH) {
    const float md = ml[dl];
    float m = -INFINITY;
    for (int sr = 0; sr < NL; ++sr) {
      const float pm = ml[sr] * md * (sr != dl ? 1.f : 0.f);
      m = fmaxf(m, scb[sr * NH + tid] + (1.f - pm) * NEG_INF_F);
    }
    float sum = 0.f;
    for (int sr = 0; sr < NL; ++sr) {
      const float pm = ml[sr] * md * (sr != dl ? 1.f : 0.f);
      const float e =
          expf(scb[sr * NH + tid] + (1.f - pm) * NEG_INF_F - m) * pm;
      scb[sr * NH + tid] = e;
      sum += e;
    }
    const float den = fmaxf(sum, 1.f);
    for (int sr = 0; sr < NL; ++sr) scb[sr * NH + tid] /= den;
  }
  __syncthreads();
}

// Shared-memory layout of stages A and C (floats; must match smem_edge()).
__host__ __device__ inline size_t smem_edge_floats(const Dims& d, int vcols) {
  const int H = d.H, K = d.K, KR = K > SCH ? K : SCH;
  const size_t r1 = (size_t)(K * FEP > SCH * H ? K * FEP : SCH * H);
  return r1 + 2 * (size_t)KR * 2 * H + (size_t)d.NL * vcols +
         (size_t)d.NL * d.heads + (size_t)K * d.heads + 3 * H + 6 * K + 8;
}

__device__ EdgeSmem carve_edge(const Dims& d, float* sm, int vcols,
                               float** rows, float** vall, float** scb,
                               float** outv) {
  const int H = d.H, K = d.K, KR = K > SCH ? K : SCH;
  const int r1 = K * FEP > SCH * H ? K * FEP : SCH * H;
  EdgeSmem s;
  s.feat = sm;
  *rows = sm;
  s.pre = sm + r1;
  s.kv = s.pre + KR * 2 * H;
  *vall = s.kv + KR * 2 * H;
  *scb = *vall + d.NL * vcols;
  s.sc = *scb + d.NL * d.heads;
  s.qt = s.sc + K * d.heads;
  s.qv = s.qt + H;
  *outv = s.qv + H;
  s.rel = *outv + H;
  s.emask = s.rel + 3 * K;
  s.ew = s.emask + K;
  s.src = reinterpret_cast<int*>(s.ew + K);
  return s;
}

// ------------------------------------------------------ stage A: node update

enum {
  NA_H = 0, NA_X, NA_HB, NA_OUT, NA_P,
  NA_W = 13, NA_E_W, NA_E_B, NA_DIRE_W, NA_DIRE_B, NA_E_LN_S, NA_E_LN_B,
  NA_E_K2, NA_E_B2, NA_Q_B0, NA_Q_LN_S, NA_Q_LN_B, NA_Q_W1, NA_Q_B1, NA_B_W,
  NA_B_B, NA_B_LN_S, NA_B_LN_B, NA_B_K2, NA_B_B2, NA_LIN_W, NA_LIN_B,
  NA_COUNT
};

// Stage A for node n of graph b. P holds the node projections
// h @ nodeA_W in columns [0, 10H) of rows of pitch PW.
__device__ void node_body(const Dims& d, const Args& a, float* sm, int b,
                          int n, int PW) {
  const int tid = threadIdx.x;
  const int N = d.NP + d.NL, H = d.H, NH = d.heads, dh = H / NH;
  float *rows, *vall, *scb, *outv;
  EdgeSmem s = carve_edge(d, sm, H, &rows, &vall, &scb, &outv);
  const float* xb = FP(NA_X) + (size_t)b * N * 3;
  const float* P = FP(NA_P);
  const float* qW1 = FP(NA_Q_W1);
  edge_attention(d, a, s, b, n, xb, P, PW, 0, 0, FP(NA_E_W), FP(NA_E_B),
                 FP(NA_DIRE_W), FP(NA_DIRE_B), FP(NA_E_LN_S), FP(NA_E_LN_B),
                 FP(NA_E_K2), FP(NA_E_B2), FP(NA_E_K2) + H * H,
                 FP(NA_E_B2) + H, H, 4 * H, FP(NA_Q_B0), FP(NA_Q_LN_S),
                 FP(NA_Q_LN_B), qW1, FP(NA_Q_B1));
  if (tid < H) {
    const int hh = tid / dh;
    float o = 0.f;
    for (int k = 0; k < d.K; ++k)
      o += s.sc[k * NH + hh] * s.kv[k * 2 * H + H + tid];
    outv[tid] = o;
  }
  __syncthreads();
  if (n >= d.NP) {
    const int dl = n - d.NP;
    const float* Pn = P + ((size_t)b * N + n) * PW;
    if (tid < H) s.qt[tid] = Pn[5 * H + tid] + FP(NA_Q_B0)[H + tid];
    __syncthreads();
    ln_rows(s.qt, H, 1, H, FP(NA_Q_LN_S) + H, FP(NA_Q_LN_B) + H, true);
    __syncthreads();
    mm_smem<1>(s.qt, H, 1, qW1 + H * H, H, H, H, FP(NA_Q_B1) + H, s.qv, H,
               false);
    __syncthreads();
    bond_attention(d, a, s, rows, vall, scb, b, dl, HbColumnRows{FP(NA_HB)},
                   P, PW, 6 * H, 8 * H, FP(NA_B_W), FP(NA_B_B), FP(NA_B_LN_S),
                   FP(NA_B_LN_B), FP(NA_B_K2), FP(NA_B_B2),
                   FP(NA_B_K2) + H * H, FP(NA_B_B2) + H, H);
    if (tid < H) {
      const int hh = tid / dh;
      float o = 0.f;
      for (int sr = 0; sr < d.NL; ++sr)
        o += scb[sr * NH + hh] * vall[sr * H + tid];
      outv[tid] += o;
    }
    __syncthreads();
  }
  mm_smem<1>(outv, H, 1, FP(NA_LIN_W), H, H, H, FP(NA_LIN_B), s.qt, H, false);
  __syncthreads();
  if (tid < H) {
    const size_t o = ((size_t)b * N + n) * H + tid;
    OUTP(NA_OUT)[o] = FP(NA_H)[o] + s.qt[tid];
  }
}

__global__ void __launch_bounds__(NT) node_kernel(Dims d, Args a) {
  extern __shared__ float sm[];
  node_body(d, a, sm, blockIdx.y, blockIdx.x, 10 * d.H);
}

// ------------------------------------------------- stage C: position update

enum {
  PA_NEW_H = 0, PA_X, PA_HB, PA_OUT, PA_P,
  PA_W = 13, PA_E_W, PA_E_B, PA_DIRE_W, PA_DIRE_B, PA_E_LN_S, PA_E_LN_B,
  PA_E_XK2, PA_E_XK2B, PA_E_XV2, PA_E_XV2B, PA_Q_B0, PA_Q_LN_S, PA_Q_LN_B,
  PA_Q_W1, PA_Q_B1, PA_P_W, PA_P_B, PA_P_LN_S, PA_P_LN_B, PA_P_XK2,
  PA_P_XK2B, PA_P_XV2, PA_P_XV2B, PA_COUNT
};

// Stage C for ligand destination dl of graph b (phore rows are copied by
// the host entry). `load_rows` gives the new bond features towards dl (see
// bond_attention).
template <class Rows>
__device__ void pos_body(const Dims& d, const Args& a, float* sm, int b,
                         int dl, const Rows& load_rows) {
  const int tid = threadIdx.x;
  const int NP = d.NP, N = NP + d.NL, H = d.H, NH = d.heads;
  const int n = NP + dl;
  const int PW = 10 * H;
  float *rows, *vall, *scb, *outv;
  EdgeSmem s = carve_edge(d, sm, NH, &rows, &vall, &scb, &outv);
  const float* xb = FP(PA_X) + (size_t)b * N * 3;
  const float* P = FP(PA_P);
  // stage A's q slots 0/1 are node queries; stage C reads slots 2/3
  const float* qW1 = FP(PA_Q_W1) + 2 * H * H;
  const float* qb1 = FP(PA_Q_B1) + 2 * H;
  const float* qb0 = FP(PA_Q_B0) + 2 * H;
  const float* qls = FP(PA_Q_LN_S) + 2 * H;
  const float* qlb = FP(PA_Q_LN_B) + 2 * H;
  edge_attention(d, a, s, b, n, xb, P, PW, 2 * H, 2, FP(PA_E_W), FP(PA_E_B),
                 FP(PA_DIRE_W), FP(PA_DIRE_B), FP(PA_E_LN_S), FP(PA_E_LN_B),
                 FP(PA_E_XK2), FP(PA_E_XK2B), FP(PA_E_XV2), FP(PA_E_XV2B),
                 NH, 4 * H, qb0, qls, qlb, qW1, qb1);
  // w_e[k] = mean over heads of alpha * xv; dx_edge = sum_k w_e[k] rel[k]
  if (tid < d.K) {
    float we = 0.f;
    for (int hh = 0; hh < NH; ++hh)
      we += s.sc[tid * NH + hh] * s.kv[tid * 2 * H + H + hh];
    outv[tid] = we / NH;
  }
  const float* Pn = P + ((size_t)b * N + n) * PW;
  if (tid < H) s.qt[tid] = Pn[5 * H + tid] + qb0[H + tid];
  __syncthreads();
  float dxe = 0.f;
  if (tid < 3)
    for (int k = 0; k < d.K; ++k) dxe += outv[k] * s.rel[k * 3 + tid];
  ln_rows(s.qt, H, 1, H, qls + H, qlb + H, true);
  __syncthreads();
  mm_smem<1>(s.qt, H, 1, qW1 + H * H, H, H, H, qb1 + H, s.qv, H, false);
  __syncthreads();
  bond_attention(d, a, s, rows, vall, scb, b, dl, load_rows, P, PW, 6 * H,
                 8 * H, FP(PA_P_W), FP(PA_P_B), FP(PA_P_LN_S), FP(PA_P_LN_B),
                 FP(PA_P_XK2), FP(PA_P_XK2B), FP(PA_P_XV2), FP(PA_P_XV2B),
                 NH);
  if (tid < 3) {
    const float* pl = xb + (size_t)NP * 3;
    float dxb = 0.f;
    for (int sr = 0; sr < d.NL; ++sr) {
      float wp = 0.f;
      for (int hh = 0; hh < NH; ++hh)
        wp += scb[sr * NH + hh] * vall[sr * NH + hh];
      dxb += (wp / NH) * (pl[dl * 3 + tid] - pl[sr * 3 + tid]);
    }
    const float md = FP(T_MASK_L)[(size_t)b * d.NL + dl];
    const size_t o = ((size_t)b * N + n) * 3 + tid;
    OUTP(PA_OUT)[o] = FP(PA_X)[o] + (dxe + dxb) * md;
  }
}

__global__ void __launch_bounds__(NT) pos_kernel(Dims d, Args a) {
  extern __shared__ float sm[];
  pos_body(d, a, sm, blockIdx.y, blockIdx.x, HbColumnRows{FP(PA_HB)});
}

// --------------------------------------- stage B1: triplet pre-features

enum {
  TP_H = 0, TP_X, TP_HB, TP_PRE_T, TP_QZ, TP_PB, TP_TRIP_IDX, TP_W,
  TP_T_WHB, TP_T_WR, TP_T_B, TP_T_WJI, TP_T_WANG, TP_T_LN_S, TP_T_LN_B,
  TP_TQ_WHB, TP_TQ_B0, TP_TQ_LN_S, TP_TQ_LN_B, TP_COUNT
};

__host__ __device__ inline size_t smem_trip_pre_floats(const Dims& d) {
  const int RB = d.K8 > SCH ? d.K8 : SCH;
  return (size_t)d.NL * 3 + (size_t)d.NL * NRBF + (size_t)d.NL * d.Wt +
         (size_t)d.K8 * d.Wt + (size_t)RB * d.H + (size_t)SCH * d.H +
         NANG * d.Wt + d.K8 + 8;
}

// Stage B1 for ligand atom j of graph b. PB points at the graph's first
// ligand row of the node projections h @ nodeB_W (columns [0, 2Wt+H) of
// rows of pitch PBW).
__device__ void trip_pre_body(const Dims& d, const Args& a, float* sm, int b,
                              int j, const float* PB, int PBW) {
  const int tid = threadIdx.x;
  const int NL = d.NL, NP = d.NP, N = NP + NL, H = d.H, K8 = d.K8, Wt = d.Wt;
  const int RB = K8 > SCH ? K8 : SCH;
  float* posl = sm;
  float* rf = posl + NL * 3;     // [NL][20] rbf of |pos_j - pos_i|
  float* aji = rf + NL * NRBF;   // [NL][Wt]
  float* akj = aji + NL * Wt;    // [K8][Wt]
  float* rows = akj + K8 * Wt;   // [RB][H]
  float* qp = rows + RB * H;     // [SCH][H]
  float* wang = qp + SCH * H;    // [13][Wt]
  int* tidx = reinterpret_cast<int*>(wang + NANG * Wt);
  const float* hb = FP(TP_HB);

  for (int idx = tid; idx < NL * 3; idx += blockDim.x)
    posl[idx] = FP(TP_X)[((size_t)b * N + NP) * 3 + idx];
  for (int idx = tid; idx < NANG * Wt; idx += blockDim.x)
    wang[idx] = FP(TP_T_WANG)[idx];
  if (tid < K8) tidx[tid] = IP(TP_TRIP_IDX)[((size_t)b * NL + j) * K8 + tid];
  __syncthreads();
  for (int idx = tid; idx < NL * NRBF; idx += blockDim.x) {
    const int i = idx / NRBF, q = idx % NRBF;
    float r2 = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float r = posl[j * 3 + c] - posl[i * 3 + c];
      r2 += r * r;
    }
    const float df = sqrtf(r2 + 1e-12f) - c_rbf_off[q];
    rf[idx] = expf(RBF_COEFF * (df * df));
  }
  for (int idx = tid; idx < K8 * H; idx += blockDim.x) {
    const int k8 = idx / H, c = idx % H;
    rows[idx] = hb[(((size_t)b * NL + tidx[k8]) * NL + j) * H + c];
  }
  __syncthreads();
  mm_smem<16>(rf, NRBF, NL, FP(TP_T_WJI), Wt, NRBF, Wt, nullptr, aji, Wt,
              false);
  mm_smem<16>(rows, H, K8, FP(TP_T_WHB), Wt, H, Wt, nullptr, akj, Wt, false);
  __syncthreads();
  // a_kj[m, j] for the K8 frozen sources m of j: + rbf(|pos_m - pos_j|) @
  // t_Wr + t_b + (h_m @ t_Wn[:, :Wt]) + (h_j @ t_Wn[:, Wt:])
  for (int idx = tid; idx < K8 * Wt; idx += blockDim.x) {
    const int k8 = idx / Wt, w = idx % Wt, m = tidx[k8];
    float r2 = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float r = posl[m * 3 + c] - posl[j * 3 + c];
      r2 += r * r;
    }
    const float dist = sqrtf(r2 + 1e-12f);
    float acc = 0.f;
    for (int q = 0; q < NRBF; ++q) {
      const float df = dist - c_rbf_off[q];
      acc += expf(RBF_COEFF * (df * df)) * FP(TP_T_WR)[q * Wt + w];
    }
    akj[idx] += acc + FP(TP_T_B)[w] + PB[m * PBW + w] + PB[j * PBW + Wt + w];
  }
  // q_z[j, i] = relu(LN(hb[j, i] @ tq_Whb + h_i @ tq_Wi + tq_b0))
  for (int i0 = 0; i0 < NL; i0 += SCH) {
    const int ni = min(SCH, NL - i0);
    __syncthreads();
    for (int idx = tid; idx < ni * H; idx += blockDim.x)
      rows[idx] = hb[(((size_t)b * NL + j) * NL + i0) * H + idx];
    __syncthreads();
    mm_smem<16>(rows, H, ni, FP(TP_TQ_WHB), H, H, H, nullptr, qp, H, false);
    __syncthreads();
    for (int idx = tid; idx < ni * H; idx += blockDim.x) {
      const int i = idx / H, c = idx % H;
      qp[idx] += PB[(i0 + i) * PBW + 2 * Wt + c] + FP(TP_TQ_B0)[c];
    }
    __syncthreads();
    ln_rows(qp, H, ni, H, FP(TP_TQ_LN_S), FP(TP_TQ_LN_B), true);
    __syncthreads();
    for (int idx = tid; idx < ni * H; idx += blockDim.x)
      OUTP(TP_QZ)[(((size_t)b * NL + j) * NL + i0) * H + idx] = qp[idx];
  }
  __syncthreads();
  // pre_t[j, i, k8, :] = relu(LN(a_kj[m, j] + a_ji[j, i] + enc(angle) @
  // t_Wang)); one warp per (i, k8), lane = feature w; lane e < 13 computes
  // encoding component e once and shares it by shuffle.
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const float ls = lane < Wt ? FP(TP_T_LN_S)[lane] : 0.f;
  const float lb = lane < Wt ? FP(TP_T_LN_B)[lane] : 0.f;
  for (int pr = warp; pr < NL * K8; pr += nw) {
    const int i = pr / K8, k8 = pr % K8, m = tidx[k8];
    float dot = 0.f, njsq = 0.f, nksq = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float rj = posl[j * 3 + c] - posl[i * 3 + c];
      const float rk = posl[m * 3 + c] - posl[i * 3 + c];
      dot += rj * rk;
      njsq += rj * rj;
      nksq += rk * rk;
    }
    const float cross = sqrtf(fmaxf(njsq * nksq - dot * dot, CROSS_SQ_EPS_F));
    const float ang = atan2f(cross, dot);
    float enc = ang;
    if (lane >= 1 && lane <= 6) enc = sinf(ang * c_bands[lane - 1]);
    if (lane >= 7 && lane <= 12) enc = cosf(ang * c_bands[lane - 7]);
    float v = 0.f;
    if (lane < Wt) v = akj[k8 * Wt + lane] + aji[i * Wt + lane];
    float ea = 0.f;
    for (int e = 0; e < NANG; ++e) {
      const float ev = __shfl_sync(0xffffffffu, enc, e);
      if (lane < Wt) ea += ev * wang[e * Wt + lane];
    }
    v += ea;
    const float s1 = warp_sum(lane < Wt ? v : 0.f);
    const float s2 = warp_sum(lane < Wt ? v * v : 0.f);
    const float mu = s1 / Wt, var = s2 / Wt - mu * mu;
    const float y = fmaxf((v - mu) * rsqrtf(var + LN_EPS_F) * ls + lb, 0.f);
    if (lane < Wt)
      OUTP(TP_PRE_T)[((((size_t)b * NL + j) * NL + i) * K8 + k8) * Wt + lane] = y;
  }
}

__global__ void __launch_bounds__(NT) trip_pre_kernel(Dims d, Args a) {
  extern __shared__ float sm[];
  const int PBW = 2 * d.Wt + d.H, b = blockIdx.y;
  trip_pre_body(d, a, sm, b, blockIdx.x,
                FP(TP_PB) + (size_t)b * d.NL * PBW, PBW);
}

// --------------------------------------- stage B2: triplet head attention

enum {
  TA_HB = 0, TA_PRE_T, TA_QZ, TA_OUT, TA_TRIP_IDX, TA_TRIP_MASK, TA_MASK_L,
  TA_TQ_W1, TA_TQ_B1, TA_T_OUT_W, TA_T_OUT_B, TA_COUNT
};

// One block's scratch is kept under 75 KB at the flagship widths so that
// three blocks of the stand-alone B2 kernel fit an SM (outb lies over qz).
__host__ __device__ inline size_t smem_trip_att_floats(const Dims& d) {
  const int HW = d.heads * d.Wt;
  return (size_t)IT * d.H + (size_t)IT * HW * 2 +
         (size_t)IT * d.K8 * (d.Wt + 1) + 2 * (size_t)IT * d.K8 + 8;
}

// Stage B2 for np <= IT pairs: per-head queries, masked softmax over the K8
// sources of j, pool, t_out_W. ROW: the pairs are (j0, i0 + p), contiguous
// in memory, moved as one run, written to TA_OUT; else (j0 + p, i0), one
// column of the bond grid, moved pair by pair, written to TA_OUT and kept in
// keep[p][H] (shared memory), ending with a block barrier. `sm` is scratch
// of smem_trip_att_floats(d) floats.
template <bool ROW>
__device__ __forceinline__ void trip_att_pairs_impl(
    const Dims& d, const Args& a, float* sm, int b, int j0, int i0, int np,
    float* keep) {
  constexpr int dj = ROW ? 0 : 1, di = ROW ? 1 : 0;
  const int tid = threadIdx.x, NL = d.NL, H = d.H, K8 = d.K8, Wt = d.Wt;
  const int NH = d.heads, HW = NH * Wt, WP = Wt + 1;
  float* qz = sm;                  // [IT][H]
  float* outb = qz;                // [IT][H], after the queries are done
  float* qh = qz + IT * H;         // [IT][heads*Wt]
  float* pt = qh + IT * HW;        // [IT][K8][Wt+1]
  float* pooled = pt + IT * K8 * WP;  // [IT][heads*Wt]
  float* tmk = pooled + IT * HW;   // [IT][K8]
  int* tidx = reinterpret_cast<int*>(tmk + IT * K8);  // [IT][K8]
#define PAIR(p) (((size_t)b * NL + j0 + (p) * dj) * NL + i0 + (p) * di)

  if (ROW) {
    const size_t pair0 = PAIR(0);
    for (int idx = tid; idx < IT * H; idx += blockDim.x)
      qz[idx] = idx < np * H ? FP(TA_QZ)[pair0 * H + idx] : 0.f;
    for (int idx = tid; idx < np * K8 * Wt; idx += blockDim.x)
      pt[(idx / Wt) * WP + idx % Wt] = FP(TA_PRE_T)[pair0 * K8 * Wt + idx];
  } else {
    for (int idx = tid; idx < IT * H; idx += blockDim.x) {
      const int p = idx / H, c = idx % H;
      qz[idx] = p < np ? FP(TA_QZ)[PAIR(p) * H + c] : 0.f;
    }
    for (int p = 0; p < np; ++p) {
      const float* src = FP(TA_PRE_T) + PAIR(p) * K8 * Wt;
      for (int idx = tid; idx < K8 * Wt; idx += blockDim.x)
        pt[(p * K8 + idx / Wt) * WP + idx % Wt] = src[idx];
    }
  }
  if (ROW) {  // one source atom j: one row of the tables for all pairs
    if (tid < K8) {
      tidx[tid] = IP(TA_TRIP_IDX)[((size_t)b * NL + j0) * K8 + tid];
      tmk[tid] = FP(TA_TRIP_MASK)[((size_t)b * NL + j0) * K8 + tid];
    }
  } else {
    for (int idx = tid; idx < np * K8; idx += blockDim.x) {
      const size_t o = ((size_t)b * NL + j0 + idx / K8) * K8 + idx % K8;
      tidx[idx] = IP(TA_TRIP_IDX)[o];
      tmk[idx] = FP(TA_TRIP_MASK)[o];
    }
  }
  __syncthreads();
  // per-head queries q_h = q_z @ tq_W1[h] + tq_b1[h]; column cc = h*Wt + w
  const float* W1 = FP(TA_TQ_W1);
  for (int cc = tid; cc < HW; cc += blockDim.x) {
    const int hh = cc / Wt, w = cc % Wt;
    float acc[IT];
#pragma unroll
    for (int p = 0; p < IT; ++p) acc[p] = 0.f;
    for (int k = 0; k < H; ++k) {
      const float wv = __ldg(W1 + ((size_t)hh * H + k) * Wt + w);
#pragma unroll
      for (int p = 0; p < IT; ++p) acc[p] = fmaf(qz[p * H + k], wv, acc[p]);
    }
    const float bv = FP(TA_TQ_B1)[cc];
#pragma unroll
    for (int p = 0; p < IT; ++p) qh[p * HW + cc] = acc[p] + bv;
  }
  __syncthreads();
  const float inv_sw = (float)(1.0 / sqrt((double)Wt));
  const float* ml = FP(TA_MASK_L) + (size_t)b * NL;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  for (int pr = warp; pr < np * NH; pr += nw) {
    const int p = pr / NH, hh = pr % NH;
    const int j = j0 + p * dj, i = i0 + p * di;
    const int tb = ROW ? 0 : p * K8;
    float vf = 0.f, sc = 0.f;
    if (lane < K8) {
      vf = tmk[tb + lane] * ml[i] * ml[j] *
           (tidx[tb + lane] != i ? 1.f : 0.f) * (i != j ? 1.f : 0.f);
      const float* row = pt + (p * K8 + lane) * WP;
      const float* q = qh + p * HW + hh * Wt;
      for (int w = 0; w < Wt; ++w) sc += row[w] * q[w];
      sc = sc * inv_sw + (1.f - vf) * NEG_INF_F;
    }
    const float mx = warp_max(lane < K8 ? sc : -INFINITY);
    const float e = lane < K8 ? expf(sc - mx) * vf : 0.f;
    const float al = e / fmaxf(warp_sum(e), 1.f);
    float acc = 0.f;
    for (int k = 0; k < K8; ++k) {
      const float ak = __shfl_sync(0xffffffffu, al, k);
      if (lane < Wt) acc += ak * pt[(p * K8 + k) * WP + lane];
    }
    if (lane < Wt) pooled[p * HW + hh * Wt + lane] = acc;
  }
  __syncthreads();
  mm_smem<IT>(pooled, HW, np, FP(TA_T_OUT_W), H, HW, H, nullptr, outb, H,
              false);
  __syncthreads();
  if (ROW) {
    const size_t pair0 = PAIR(0);
    for (int idx = tid; idx < np * H; idx += blockDim.x) {
      const int c = idx % H;
      OUTP(TA_OUT)[pair0 * H + idx] =
          FP(TA_HB)[pair0 * H + idx] + (outb[idx] + FP(TA_T_OUT_B)[c]);
    }
  } else {
    for (int idx = tid; idx < np * H; idx += blockDim.x) {
      const int p = idx / H, c = idx % H;
      const size_t o = PAIR(p) * H + c;
      const float v = FP(TA_HB)[o] + (outb[idx] + FP(TA_T_OUT_B)[c]);
      OUTP(TA_OUT)[o] = v;
      keep[idx] = v;
    }
    __syncthreads();
  }
#undef PAIR
}

// The column form is a call, not inlined into stage C's body: measured on
// the H100, the merged kernel is a quarter faster that way.
__device__ __noinline__ void trip_att_column(const Dims& d, const Args& a,
                                             float* sm, int b, int j0, int i0,
                                             int np, float* keep) {
  trip_att_pairs_impl<false>(d, a, sm, b, j0, i0, np, keep);
}

// Three blocks an SM (the scratch allows it) and so at most 85 registers:
// left to itself the compiler takes 48 and the kernel is 1.4x slower.
__global__ void __launch_bounds__(NT, 3) trip_att_kernel(Dims d, Args a) {
  extern __shared__ float sm[];
  const int i0 = blockIdx.x * IT;
  trip_att_pairs_impl<true>(d, a, sm, blockIdx.z, blockIdx.y, i0,
                            min(IT, d.NL - i0), nullptr);
}

// ------------------------------- merged stage A + B1 (one main grid)
//
// Counterpart of _stage_node_pre: blocks [0, NL) of a graph take the B1
// role (one ligand atom j each, the longer body, so they start first),
// blocks [NL, NL + N) the A role (one node each). Both read the node
// projections of ONE rows_gemm, h @ [nodeA_W | nodeB_W], in P (pitch PW).
// `an` is laid out as stage A's arguments, `at` as stage B1's.
__global__ void __launch_bounds__(NT)
node_pre_kernel(Dims d, Args an, Args at, int PW) {
  extern __shared__ float sm[];
  const int b = blockIdx.y, r = blockIdx.x;
  if (r < d.NL) {
    const float* PB = reinterpret_cast<const float*>(an.p[NA_P]) +
                      ((size_t)b * (d.NP + d.NL) + d.NP) * PW + 10 * d.H;
    trip_pre_body(d, at, sm, b, r, PB, PW);
  } else {
    node_body(d, an, sm, b, r - d.NL, PW);
  }
}

// ------------------------------- merged stage B2 + C (one main grid)
//
// Counterpart of _att_pos_pallas. Stage C's bond-grid attention for
// destination dl softmaxes over ALL sources j of hb_new[b, j, dl, :], so one
// block per (graph, dl) finishes that column itself: it walks the sources
// in chunks of IT pairs (j, dl), runs B2 on each chunk for all heads,
// writes hb_new once and keeps the chunk in shared memory as the rows of
// C's first layer. hb_new is never read back, and no block waits for
// another. B2's scratch lies over C's `pre` and `kv` tiles when it fits
// there (they are idle while the rows are gathered), else behind them.
struct AttRows {
  const Args* ta;
  float* scratch;
  __device__ void operator()(const Dims& d, int b, int dl, int s0, int ns,
                             float* rows) const {
    for (int j0 = s0; j0 < s0 + ns; j0 += IT)
      trip_att_column(d, *ta, scratch, b, j0, dl, min(IT, s0 + ns - j0),
                      rows + (size_t)(j0 - s0) * d.H);
  }
};

// Floats of C's pre + kv tiles, which B2's scratch may lie over.
__host__ __device__ inline size_t att_alias_floats(const Dims& d) {
  const int KR = d.K > SCH ? d.K : SCH;
  return 2 * (size_t)KR * 2 * d.H;
}

__host__ __device__ inline size_t smem_att_pos_floats(const Dims& d) {
  const size_t e = smem_edge_floats(d, d.heads), t = smem_trip_att_floats(d);
  return t <= att_alias_floats(d) ? e : e + t;
}

__global__ void __launch_bounds__(NT)
att_pos_kernel(Dims d, Args ap, Args ta) {
  extern __shared__ float sm[];
  const int KH = d.K * FEP > SCH * d.H ? d.K * FEP : SCH * d.H;
  float* scratch = smem_trip_att_floats(d) <= att_alias_floats(d)
                       ? sm + KH  // == EdgeSmem::pre, see carve_edge
                       : sm + smem_edge_floats(d, d.heads);
  pos_body(d, ap, sm, blockIdx.y, blockIdx.x, AttRows{&ta, scratch});
}

// ------------------------------------------------------------ host entries

static Dims read_dims(const int* v) {
  Dims d;
  d.B = v[0]; d.NP = v[1]; d.NL = v[2]; d.K = v[3];
  d.K8 = v[4]; d.H = v[5]; d.heads = v[6]; d.Wt = v[7];
  return d;
}

static Args read_args(const void* const* p, int n) {
  Args a;
  for (int i = 0; i < MAXARGS; ++i) a.p[i] = i < n ? p[i] : nullptr;
  return a;
}

static const size_t kMaxSmem = 232448;

static int launch_rows_gemm(const float* X, int ldx, int rows, int rpb,
                            int bstride, int roff, int Kd, const float* W,
                            int Nc, float* Y, cudaStream_t st) {
  const size_t bytes = (size_t)RT * Kd * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rows_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  dim3 grid((rows + RT - 1) / RT, (Nc + NT - 1) / NT);
  rows_gemm<<<grid, NT, bytes, st>>>(X, ldx, rows, rpb, bstride, roff, Kd, W,
                                     Nc, nullptr, Y);
  return (int)cudaGetLastError();
}

static bool dims_ok(const Dims& d) {
  return d.H % d.heads == 0 && d.H <= NT && d.Wt <= 32 && d.K8 <= 32 &&
         d.K8 >= 1 && d.K >= 1 && d.K <= d.H && d.heads <= 32;
}

extern "C" {

// Stage A. Pointer slots: see the NA_* and T_* enums.
int ls_stage_node(const void* const* p, int np, const int* dims, void* stream) {
  if (np != NA_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL;
  int rc = launch_rows_gemm(FP(NA_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                            FP(NA_W), 10 * d.H, OUTP(NA_P), st);
  if (rc) return rc;
  const size_t bytes = smem_edge_floats(d, d.H) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  node_kernel<<<dim3(N, d.B), NT, bytes, st>>>(d, a);
  return (int)cudaGetLastError();
}

// Stage C. Phore rows of x pass through unchanged (their update is masked
// to zero), so the main kernel runs on ligand rows only.
int ls_stage_pos(const void* const* p, int np, const int* dims, void* stream) {
  if (np != PA_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL;
  cudaError_t ce = cudaMemcpy2DAsync(
      OUTP(PA_OUT), (size_t)N * 3 * sizeof(float), FP(PA_X),
      (size_t)N * 3 * sizeof(float), (size_t)d.NP * 3 * sizeof(float), d.B,
      cudaMemcpyDeviceToDevice, st);
  if (ce != cudaSuccess) return (int)ce;
  int rc = launch_rows_gemm(FP(PA_NEW_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                            FP(PA_W), 10 * d.H, OUTP(PA_P), st);
  if (rc) return rc;
  const size_t bytes = smem_edge_floats(d, d.heads) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(pos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  pos_kernel<<<dim3(d.NL, d.B), NT, bytes, st>>>(d, a);
  return (int)cudaGetLastError();
}

// Stage B1. Pointer slots: see the TP_* enum.
int ls_stage_trip_pre(const void* const* p, int np, const int* dims,
                      void* stream) {
  if (np != TP_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL;
  int rc = launch_rows_gemm(FP(TP_H), d.H, d.B * d.NL, d.NL, N, d.NP, d.H,
                            FP(TP_W), 2 * d.Wt + d.H, OUTP(TP_PB), st);
  if (rc) return rc;
  const size_t bytes = smem_trip_pre_floats(d) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(trip_pre_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  trip_pre_kernel<<<dim3(d.NL, d.B), NT, bytes, st>>>(d, a);
  return (int)cudaGetLastError();
}

// Stage B2. Pointer slots: see the TA_* enum.
int ls_stage_trip_att(const void* const* p, int np, const int* dims,
                      void* stream) {
  if (np != TA_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = smem_trip_att_floats(d) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(trip_att_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  trip_att_kernel<<<dim3((d.NL + IT - 1) / IT, d.NL, d.B), NT, bytes, st>>>(
      d, a);
  return (int)cudaGetLastError();
}

// Merged stage A + B1. Pointer slots: stage A's (NA_*, T_*; slot NA_W holds
// [nodeA_W | nodeB_W]), then pre_t, q_z, trip_idx and stage B1's weights
// from TP_T_WHB on.
int ls_stage_node_pre(const void* const* p, int np, const int* dims,
                      void* stream) {
  const int extra = TP_COUNT - TP_T_WHB;
  if (np != NA_COUNT + 3 + extra) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args an = read_args(p, NA_COUNT);
  Args at = read_args(p, 0);
  at.p[TP_H] = p[NA_H];
  at.p[TP_X] = p[NA_X];
  at.p[TP_HB] = p[NA_HB];
  at.p[TP_PRE_T] = p[NA_COUNT];
  at.p[TP_QZ] = p[NA_COUNT + 1];
  at.p[TP_TRIP_IDX] = p[NA_COUNT + 2];
  for (int i = 0; i < extra; ++i) at.p[TP_T_WHB + i] = p[NA_COUNT + 3 + i];
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL, PW = 10 * d.H + 2 * d.Wt + d.H;
  const Args& a = an;
  int rc = launch_rows_gemm(FP(NA_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                            FP(NA_W), PW, OUTP(NA_P), st);
  if (rc) return rc;
  const size_t fa = smem_edge_floats(d, d.H), fb = smem_trip_pre_floats(d);
  const size_t bytes = (fa > fb ? fa : fb) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(node_pre_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  node_pre_kernel<<<dim3(d.NL + N, d.B), NT, bytes, st>>>(d, an, at, PW);
  return (int)cudaGetLastError();
}

// Merged stage B2 + C. Pointer slots: stage C's (PA_*, T_*; PA_HB is the
// OLD bond grid, B2's input), then pre_t, q_z, hb_new (output), trip_idx,
// trip_mask and stage B2's weights from TA_TQ_W1 on. Phore rows of x are
// copied as in ls_stage_pos.
int ls_stage_att_pos(const void* const* p, int np, const int* dims,
                     void* stream) {
  const int extra = TA_COUNT - TA_TQ_W1;
  if (np != PA_COUNT + 5 + extra) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args ap = read_args(p, PA_COUNT);
  Args ta = read_args(p, 0);
  ta.p[TA_HB] = p[PA_HB];
  ta.p[TA_PRE_T] = p[PA_COUNT];
  ta.p[TA_QZ] = p[PA_COUNT + 1];
  ta.p[TA_OUT] = p[PA_COUNT + 2];
  ta.p[TA_TRIP_IDX] = p[PA_COUNT + 3];
  ta.p[TA_TRIP_MASK] = p[PA_COUNT + 4];
  ta.p[TA_MASK_L] = p[T_MASK_L];
  for (int i = 0; i < extra; ++i) ta.p[TA_TQ_W1 + i] = p[PA_COUNT + 5 + i];
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL;
  const Args& a = ap;
  cudaError_t ce = cudaMemcpy2DAsync(
      OUTP(PA_OUT), (size_t)N * 3 * sizeof(float), FP(PA_X),
      (size_t)N * 3 * sizeof(float), (size_t)d.NP * 3 * sizeof(float), d.B,
      cudaMemcpyDeviceToDevice, st);
  if (ce != cudaSuccess) return (int)ce;
  int rc = launch_rows_gemm(FP(PA_NEW_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                            FP(PA_W), 10 * d.H, OUTP(PA_P), st);
  if (rc) return rc;
  const size_t bytes = smem_att_pos_floats(d) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(att_pos_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  att_pos_kernel<<<dim3(d.NL, d.B), NT, bytes, st>>>(d, ap, ta);
  return (int)cudaGetLastError();
}

}  // extern "C"
