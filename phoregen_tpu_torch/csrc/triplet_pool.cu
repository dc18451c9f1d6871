// All-k factorized triplet pool for Hopper (sm_90a), float32 throughout.
//
// Replaces the Pallas TPU kernel `_kernel` of
// phoregen_tpu/ops/pallas_triplet.py (entry `triplet_pool_pallas`). For each
// graph b and target bond (j, i):
//
//   angle(k, i)   at i between j->i and k->i, from positions
//   pre(k, i, :)  = act(LN(a_kj[k, j] + a_ji[j, i] + enc(angle) @ w_ang))
//   score(k, h)   = <pre(k, i), q(j, i, h)> / sqrt(Wt)
//   alpha         = softmax over k, masked to m[k] m[i] m[j], k != i != j != k,
//                   denominator floor 1e-30 (a fully masked column gives 0)
//   out(j, i, h)  = sum_k alpha(k, h) * pre(k, i, :)
//
// Design notes (what differs from the TPU kernel, and why):
// - Parallelism. The Pallas grid is (B, j) with the whole [k, i, Wt] tile of
//   one (b, j) resident in fast memory. That tile is N*N*Wt floats (819 KB at
//   N = 80) and does not fit a block's shared memory, so a block is
//   (b, j, IT consecutive i's): its tile is IT*N*Wt floats (42 KB at N = 80)
//   and a batch of 16 graphs gives B*N*N/IT blocks for 132 SMs.
// - The softmax over k needs no online form: all N sources of the block's
//   i's are resident, so each (i, head) is one warp that scores, normalises
//   and pools out of shared memory. The pre tile serves all heads.
// - Inputs are indexed where they lie: a_kj stays [B, k, j, Wt] (rows of one
//   j are strided), q stays [B, j, i, heads, Wt], pos[j] is a plain load, and
//   the output is written as [B, j, i, heads*Wt]. The TPU kernel needed a
//   j-major a_kj, a head-separated q, a one-hot reduction for pos[j] and a
//   transpose after the call; none of that is carried over. atan2f, rsqrtf
//   and exact division take the place of its polynomial and Newton steps.
// - Work that the mask removes is skipped: a block whose j is padding, or
//   whose i's are all padding or equal j, writes zeros and returns; masked
//   (k, i) pairs get a zero pre row without the geometry.
// - Bound on the H100: the function reads q and writes the output once
//   (2 * B*N*N*heads*Wt*4 bytes, the bulk of its traffic) and does about
//   (2*NENC + 8 + 4*heads) * Wt float32 operations per valid triplet, so
//   with few padded slots it is bound by operations (67 TFLOP/s outside the
//   tensor cores) and with many by bytes (3.35 TB/s);
//   `ops/kernel_check.py` works both out from the inputs. This kernel
//   makes one or two shared-memory loads per FMA and spends as many
//   instructions on shuffles and reductions as on FMAs, so instruction
//   throughput holds it well above either; the measured time stands beside
//   its bound in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TP_NT 256          // threads per block
#define TP_IT 4            // target atoms i per block
#define NEG_INF_F (-1e9f)
#define LN_EPS_F 1e-6f
#define CROSS_SQ_EPS_F 1e-12f
#define DENOM_FLOOR_F 1e-30f

struct TPDims {
  int B, N, heads, Wt, num_ang, norm, act;
};

// activation codes, in the order of `ops/pallas_triplet.py::ACT_CODES`
enum {
  ACT_RELU = 0, ACT_GELU, ACT_SILU, ACT_TANH, ACT_SIGMOID, ACT_LEAKYRELU,
  ACT_ELU, ACT_SELU, ACT_SOFTPLUS, ACT_IDENTITY, ACT_COUNT
};

__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.f);
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu's default
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(u));
    }
    case ACT_SILU: return x / (1.f + expf(-x));
    case ACT_TANH: return tanhf(x);
    case ACT_SIGMOID: return 1.f / (1.f + expf(-x));
    case ACT_LEAKYRELU: return x >= 0.f ? x : 0.01f * x;
    case ACT_ELU: return x > 0.f ? x : expm1f(x);
    case ACT_SELU:
      return 1.0507009873554805f *
             (x > 0.f ? x : 1.6732632423543772f * expm1f(x));
    case ACT_SOFTPLUS: return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    default: return x;
  }
}

__device__ __forceinline__ float tp_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float tp_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline size_t tp_smem_floats(const TPDims& d) {
  const int WP = d.Wt + 1, NENC = 1 + 4 * d.num_ang;
  return (size_t)TP_IT * d.N * WP          // pre tile, padded rows
         + (size_t)TP_IT * d.heads * d.Wt  // q of the block's (j, i) pairs
         + (size_t)TP_IT * d.Wt            // a_ji rows
         + (size_t)d.N * d.Wt              // a_kj[:, j] rows
         + (size_t)d.N * 4                 // positions and mask
         + (size_t)NENC * d.Wt             // w_ang
         + (size_t)(TP_NT / 32) * d.N;     // one softmax row per warp
}

__global__ void __launch_bounds__(TP_NT)
triplet_pool_kernel(TPDims d, const float* __restrict__ a_kj,
                    const float* __restrict__ a_ji,
                    const float* __restrict__ q,
                    const float* __restrict__ pos,
                    const float* __restrict__ mask,
                    const float* __restrict__ w_ang,
                    const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int i0 = blockIdx.x * TP_IT, j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int N = d.N, Wt = d.Wt, NH = d.heads, HW = NH * Wt, WP = Wt + 1;
  const int NENC = 1 + 4 * d.num_ang, NA = d.num_ang;
  const int ni = min(TP_IT, N - i0);
  const size_t pair0 = ((size_t)b * N + j) * N + i0;
  float* outp = out + pair0 * HW;
  const float* mb = mask + (size_t)b * N;

  // nothing to attend to: j is padding, or every i is padding or j itself
  bool live = false;
  if (mb[j] > 0.f)
    for (int p = 0; p < ni; ++p)
      live = live || (mb[i0 + p] > 0.f && i0 + p != j);
  if (!live) {
    for (int idx = tid; idx < ni * HW; idx += blockDim.x) outp[idx] = 0.f;
    return;
  }

  float* pt = sm;                        // [IT][N][Wt+1]
  float* qs = pt + TP_IT * N * WP;       // [IT][heads*Wt]
  float* aji = qs + TP_IT * HW;          // [IT][Wt]
  float* akj = aji + TP_IT * Wt;         // [N][Wt]
  float* posl = akj + N * Wt;            // [N][3]
  float* msk = posl + N * 3;             // [N]
  float* wang = msk + N;                 // [NENC][Wt]
  float* alpha = wang + NENC * Wt;       // [warps][N]

  for (int idx = tid; idx < N * 3; idx += blockDim.x)
    posl[idx] = pos[(size_t)b * N * 3 + idx];
  for (int idx = tid; idx < N; idx += blockDim.x) msk[idx] = mb[idx];
  for (int idx = tid; idx < NENC * Wt; idx += blockDim.x)
    wang[idx] = w_ang[idx];
  for (int idx = tid; idx < N * Wt; idx += blockDim.x) {
    const int k = idx / Wt, w = idx % Wt;
    akj[idx] = a_kj[(((size_t)b * N + k) * N + j) * Wt + w];
  }
  for (int idx = tid; idx < ni * Wt; idx += blockDim.x)
    aji[idx] = a_ji[pair0 * Wt + idx];
  for (int idx = tid; idx < ni * HW; idx += blockDim.x)
    qs[idx] = q[pair0 * HW + idx];
  __syncthreads();

  // pre(k, i, :): one warp per (i, k), lane = feature w. Lane e < NENC
  // computes encoding component e once and shares it by shuffle. The
  // products of the angle are kept unfused (no FMA contraction) so that
  // the cancellation in |a|^2 |b|^2 - (a.b)^2 rounds as the plain
  // elementwise version does.
  const float lsv = (d.norm && lane < Wt) ? ln_s[lane] : 1.f;
  const float lbv = (d.norm && lane < Wt) ? ln_b[lane] : 0.f;
  const float pjx = posl[j * 3], pjy = posl[j * 3 + 1], pjz = posl[j * 3 + 2];
  for (int pr = warp; pr < ni * N; pr += nw) {
    const int p = pr / N, k = pr % N, i = i0 + p;
    float* row = pt + (size_t)(p * N + k) * WP;
    const bool valid = msk[k] > 0.f && msk[i] > 0.f && k != i && k != j &&
                       i != j;
    if (!valid) {
      if (lane < Wt) row[lane] = 0.f;
      continue;
    }
    const float pix = posl[i * 3], piy = posl[i * 3 + 1], piz = posl[i * 3 + 2];
    const float rjx = pjx - pix, rjy = pjy - piy, rjz = pjz - piz;
    const float rkx = posl[k * 3] - pix, rky = posl[k * 3 + 1] - piy,
                rkz = posl[k * 3 + 2] - piz;
    const float dot = __fadd_rn(
        __fadd_rn(__fmul_rn(rjx, rkx), __fmul_rn(rjy, rky)),
        __fmul_rn(rjz, rkz));
    const float njsq = __fadd_rn(
        __fadd_rn(__fmul_rn(rjx, rjx), __fmul_rn(rjy, rjy)),
        __fmul_rn(rjz, rjz));
    const float nksq = __fadd_rn(
        __fadd_rn(__fmul_rn(rkx, rkx), __fmul_rn(rky, rky)),
        __fmul_rn(rkz, rkz));
    const float cross_sq =
        __fsub_rn(__fmul_rn(njsq, nksq), __fmul_rn(dot, dot));
    const float ang = atan2f(sqrtf(fmaxf(cross_sq, CROSS_SQ_EPS_F)), dot);
    // encoding [angle, sin(angle * f) x 2*NA, cos(angle * f) x 2*NA] with
    // f = [1..NA, 1/1..1/NA]
    float enc = ang;
    if (lane >= 1 && lane < NENC) {
      const int m = (lane - 1) % (2 * NA);
      const float f = m < NA ? (float)(m + 1) : 1.0f / (float)(m - NA + 1);
      enc = lane <= 2 * NA ? sinf(ang * f) : cosf(ang * f);
    }
    float ea = 0.f;
    for (int e = 0; e < NENC; ++e) {
      const float ev = __shfl_sync(0xffffffffu, enc, e);
      if (lane < Wt) ea += ev * wang[e * Wt + lane];
    }
    float v = 0.f;
    if (lane < Wt) v = (akj[k * Wt + lane] + aji[p * Wt + lane]) + ea;
    if (d.norm) {
      const float mu = tp_warp_sum(lane < Wt ? v : 0.f) / Wt;
      const float dv = lane < Wt ? v - mu : 0.f;
      const float var = tp_warp_sum(dv * dv) / Wt;
      v = dv * rsqrtf(var + LN_EPS_F) * lsv + lbv;
    }
    if (lane < Wt) row[lane] = apply_act(v, d.act);
  }
  __syncthreads();

  // per (i, head): scores over k, masked softmax, pool. One warp each.
  const float sw = sqrtf((float)Wt);
  float* al = alpha + (size_t)warp * N;
  for (int pr = warp; pr < ni * NH; pr += nw) {
    const int p = pr / NH, hh = pr % NH, i = i0 + p;
    float* orow = outp + (size_t)p * HW + hh * Wt;
    if (!(msk[i] > 0.f) || i == j) {
      if (lane < Wt) orow[lane] = 0.f;
      continue;
    }
    const float* qv = qs + p * HW + hh * Wt;
    const float* tile = pt + (size_t)p * N * WP;
    float mx = -INFINITY;
    for (int k = lane; k < N; k += 32) {
      float sc = NEG_INF_F;
      if (msk[k] > 0.f && k != i && k != j) {
        const float* row = tile + (size_t)k * WP;
        float acc = 0.f;
        for (int w = 0; w < Wt; ++w) acc = fmaf(row[w], qv[w], acc);
        sc = acc / sw;
      }
      al[k] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = tp_warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < N; k += 32) {
      const bool vf = msk[k] > 0.f && k != i && k != j;
      const float e = vf ? expf(al[k] - mx) : 0.f;
      al[k] = e;
      sum += e;
    }
    const float denom = fmaxf(tp_warp_sum(sum), DENOM_FLOOR_F);
    for (int k = lane; k < N; k += 32) al[k] = al[k] / denom;
    __syncwarp();
    if (lane < Wt) {
      float acc = 0.f;
      for (int k = 0; k < N; ++k) acc = fmaf(al[k], tile[(size_t)k * WP + lane], acc);
      orow[lane] = acc;
    }
    __syncwarp();
  }
}

static const size_t kTpMaxSmem = 232448;

extern "C" {

// Pointer slots: a_kj [B,N,N,Wt] (k, j), a_ji [B,N,N,Wt] (j, i),
// q [B,N,N,heads,Wt] (j, i), pos [B,N,3], mask [B,N] (1 = valid),
// w_ang [1+4*num_ang, Wt], ln_scale [Wt], ln_bias [Wt],
// out [B,N,N,heads*Wt] (j, i). dims: B, N, heads, Wt, num_ang, norm, act.
int tp_triplet_pool(const void* const* p, int np, const int* dims,
                    void* stream) {
  if (np != 9) return (int)cudaErrorInvalidValue;
  TPDims d;
  d.B = dims[0]; d.N = dims[1]; d.heads = dims[2]; d.Wt = dims[3];
  d.num_ang = dims[4]; d.norm = dims[5]; d.act = dims[6];
  if (d.B < 1 || d.B > 65535 || d.N < 1 || d.N > 65535 || d.heads < 1 ||
      d.Wt < 1 || d.Wt > 32 || d.num_ang < 1 || 1 + 4 * d.num_ang > 32 ||
      d.act < 0 || d.act >= ACT_COUNT)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = tp_smem_floats(d) * sizeof(float);
  if (bytes > kTpMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t ce = cudaFuncSetAttribute(
      triplet_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (ce != cudaSuccess) return (int)ce;
  const float* const* f = reinterpret_cast<const float* const*>(p);
  dim3 grid((d.N + TP_IT - 1) / TP_IT, d.N, d.B);
  triplet_pool_kernel<<<grid, TP_NT, bytes, (cudaStream_t)stream>>>(
      d, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
      reinterpret_cast<float*>(const_cast<void*>(p[8])));
  return (int)cudaGetLastError();
}

}  // extern "C"
