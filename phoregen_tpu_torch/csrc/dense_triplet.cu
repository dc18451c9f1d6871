// Dense triplet bond update for Hopper (sm_90a), float32 throughout.
//
// Replaces no TPU kernel: the JAX package leaves PhoreGen's published bond
// update (`triplet_mode: dense`, `models/layers.py::BondUpdateTriplet`) to
// XLA, and the port's plain version (`BondUpdateTriplet._dense`)
// materialises [B, k, j, i, H] grids. For each graph b, target bond (j, i)
// and source k, with k, j, i real atoms and pairwise distinct:
//
//   pre_X(k)  = a_kj_X(k, j) + a_ji_X(j, i) + enc(angle_i(j, k)) @ W_X_ang
//                                                              X in {k, v}
//   score_h   = <act(LN_k(pre_k)), q'_h>,  q'_h = W_k_out[:, h] q_h / sqrt(dh)
//   out(j, i) = (sum_k softmax_k(score_h) act(LN_v(pre_v)))_h @ W_v_out[:, h]
//               + b_v_out[h],  per head h
//
// The bond and atom terms of a_kj and a_ji and the query q come from the
// layer's prologue in plain PyTorch (`BondUpdateTriplet._dense_prologue`).
// The key output is folded into the query once a bond (q . b_k_out is the
// same for every k and cancels in the softmax), and the value output is
// applied once a bond after the pool (the weights sum to 1), so a triplet
// costs two rows of H, one score and one accumulate a head.
//
// Design:
// - A block is (b, j, DT_WARPS targets i), one warp a target bond from
//   start to end; the block shares the angle projections (with the
//   encoding's two repeated rows, sin x and cos x, merged), the LayerNorm
//   parameters, the positions and the mask. A lane owns four of the H = 128
//   features of every row.
// - Each warp lists its sources (real atoms other than i and j, in slot
//   order: the padded tail and the mask's holes are never visited), then
//   computes each source's angle and encoding a lane a source, the angle's
//   products unfused as in `triplet_pool.cu`, and folds the key output into
//   the query [16 heads][H].
// - Pass 1 walks the sources DT_S at a time: the key row (the three-term
//   sum, LayerNorm in the E[(x - mu)^2] form, activation) in registers, the
//   16 scores of each source as partial dots reduced across the warp by a
//   reduce-scatter (each lane ends with two of the DT_S x 16 sums), stored
//   in shared memory. Then the softmax over all sources, exactly. Pass 2
//   walks the sources again for the value row and accumulates it a head
//   (16 x 4 accumulators a lane). The epilogue divides by the softmax's sum
//   and applies the value output; a bond with no source writes 0.
// - Nothing a triplet produces reaches device memory; each block writes the
//   rows of its own slots that are no target as 0, so every output slot is
//   written.
// - Bound on the H100: operations, about 136 H + 84 a triplet
//   (`portbench/workcount_dense.py`). 168 registers, no spill, 71,680 B of
//   shared memory a block at N = 48 (three blocks, 12 warps an SM), 86,528
//   B at N = 80 (two). NVIDIA H100 80GB HBM3 at 700 W, B = 16, N/2 to N
//   atoms: 1.14 ms against a bound of 0.038 at N = 48, 7.63 against 0.213
//   at N = 80. Probes that drop one part each (B = 30, N = 48, 2.02 ms):
//   the rows' loads of a_kj 23% (L2 latency: the shared memory leaves
//   little L1), the fold and the value output's weight reads 10%, the
//   LayerNorm 9%, the scores' reduce-scatter 3.5%; the rest is the rows'
//   arithmetic at 12 warps an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DT_H 128                // hidden width, four features a lane
#define DT_HEADS 16
#define DT_DH 8                 // DT_H / DT_HEADS
// 3 angular bands: 13 encoding rows, 11 distinct (sin x, cos x repeat)
#define DT_NE 11
#define DT_WARPS 4              // target bonds a block, one warp each
#define DT_NT (32 * DT_WARPS)
#define DT_S 4                  // sources a step of the passes
#define DT_QP 132               // pitch of a head's row of the folded query
#define LN_EPS_F 1e-6f
#define CROSS_SQ_EPS_F 1e-12f
#define FULL 0xffffffffu

struct DTDims {
  // row strides, in floats, of kj_a, kj_b, ji (bond rows) and n_src, n_dst
  // (atom rows); 0 repeats one row
  int B, N, norm, act, sa, sb, sj, ss, sd;
};

// activation codes, in the order of `ops/pallas_triplet.py::ACT_CODES`
enum {
  ACT_RELU = 0, ACT_GELU, ACT_SILU, ACT_TANH, ACT_SIGMOID, ACT_LEAKYRELU,
  ACT_ELU, ACT_SELU, ACT_SOFTPLUS, ACT_IDENTITY, ACT_COUNT
};

template <int A>
__device__ __forceinline__ float act1(float x) {
  if constexpr (A == ACT_RELU) {
    return fmaxf(x, 0.f);
  } else if constexpr (A == ACT_GELU) {  // tanh form, jax.nn.gelu's default
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(u));
  } else if constexpr (A == ACT_SILU) {
    return x / (1.f + expf(-x));
  } else if constexpr (A == ACT_TANH) {
    return tanhf(x);
  } else if constexpr (A == ACT_SIGMOID) {
    return 1.f / (1.f + expf(-x));
  } else if constexpr (A == ACT_LEAKYRELU) {
    return x >= 0.f ? x : 0.01f * x;
  } else if constexpr (A == ACT_ELU) {
    return x > 0.f ? x : expm1f(x);
  } else if constexpr (A == ACT_SELU) {
    return 1.0507009873554805f *
           (x > 0.f ? x : 1.6732632423543772f * expm1f(x));
  } else if constexpr (A == ACT_SOFTPLUS) {
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  } else {
    return x;
  }
}

template <int A>
__device__ __forceinline__ void act_rows(float (&y)[DT_S][4]) {
#pragma unroll
  for (int s = 0; s < DT_S; ++s)
#pragma unroll
    for (int f = 0; f < 4; ++f) y[s][f] = act1<A>(y[s][f]);
}

// The switch stands outside the element loop, as in triplet_pool.cu.
__device__ __forceinline__ void apply_act(float (&y)[DT_S][4], int act) {
  switch (act) {
    case ACT_RELU: act_rows<ACT_RELU>(y); break;
    case ACT_GELU: act_rows<ACT_GELU>(y); break;
    case ACT_SILU: act_rows<ACT_SILU>(y); break;
    case ACT_TANH: act_rows<ACT_TANH>(y); break;
    case ACT_SIGMOID: act_rows<ACT_SIGMOID>(y); break;
    case ACT_LEAKYRELU: act_rows<ACT_LEAKYRELU>(y); break;
    case ACT_ELU: act_rows<ACT_ELU>(y); break;
    case ACT_SELU: act_rows<ACT_SELU>(y); break;
    case ACT_SOFTPLUS: act_rows<ACT_SOFTPLUS>(y); break;
    default: break;
  }
}

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float el(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// y += s * w, componentwise (one FMA each)
__device__ __forceinline__ void fma4(float4& y, float s, const float4& w) {
  y.x = fmaf(s, w.x, y.x); y.y = fmaf(s, w.y, y.y);
  y.z = fmaf(s, w.z, y.z); y.w = fmaf(s, w.w, y.w);
}

// The sums of v[0..3] over the warp, in every lane: a reduce-scatter over
// lane bits 4 and 3 (each lane keeps one of the four), the rest of the
// warp's sum, then each sum read back from a lane that holds it.
__device__ __forceinline__ void warp_sum4(float (&v)[4], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8;
  const float s0 = h4 ? v[0] : v[2], s1 = h4 ? v[1] : v[3];
  float k0 = h4 ? v[2] : v[0], k1 = h4 ? v[3] : v[1];
  k0 += __shfl_xor_sync(FULL, s0, 16);
  k1 += __shfl_xor_sync(FULL, s1, 16);
  // lane holds sums number 2 h4 and 2 h4 + 1 over lanes l, l ^ 16
  float c = h3 ? k1 : k0;
  c += __shfl_xor_sync(FULL, h3 ? k0 : k1, 8);
  c += __shfl_xor_sync(FULL, c, 4);
  c += __shfl_xor_sync(FULL, c, 2);
  c += __shfl_xor_sync(FULL, c, 1);
  // sum number 2 h4 + h3 over the warp
  v[0] = __shfl_sync(FULL, c, 0);
  v[1] = __shfl_sync(FULL, c, 8);
  v[2] = __shfl_sync(FULL, c, 16);
  v[3] = __shfl_sync(FULL, c, 24);
}

// One halving step of a reduce-scatter of V values over lane bit `bit`:
// the lane keeps the upper half where its bit is set, the lower half where
// not, and adds its partner's copy of the half it keeps.
template <int V>
__device__ __forceinline__ void rs_step(float (&v)[64], int lane, int bit) {
  const bool hi = lane & bit;
#pragma unroll
  for (int t = 0; t < V / 2; ++t) {
    const float send = hi ? v[t] : v[t + V / 2];
    const float keep = hi ? v[t + V / 2] : v[t];
    v[t] = keep + __shfl_xor_sync(FULL, send, bit);
  }
}

// Shared-memory layout, in floats. Block part: the merged angle
// projections [DT_NE][H] of both branches, LayerNorm scale | bias of both,
// positions, mask. Then one part a warp: q(j, i), the folded query
// [heads][DT_QP] (reused for the pooled rows), the sources' encodings
// [DT_NE][NP], their scores and then softmax numerators [NP][heads], the
// softmax sums [heads], the source list [NP] (ints).
struct DTLay {
  int NP;
  int wk, wv, ln, pos, msk, warp0;
  int qs, qf, enc, sc, den, src, wstride;
  int total;
};

__host__ __device__ inline DTLay dt_layout(const DTDims& d) {
  DTLay L;
  L.NP = up4(d.N);
  int o = 0;
  L.wk = o; o += DT_NE * DT_H;
  L.wv = o; o += DT_NE * DT_H;
  L.ln = o; o += 4 * DT_H;
  L.pos = o; o += up4(3 * d.N);
  L.msk = o; o += L.NP;
  L.warp0 = o;
  int w = 0;
  L.qs = w; w += DT_H;
  L.qf = w; w += DT_HEADS * DT_QP;
  L.enc = w; w += DT_NE * L.NP;
  L.sc = w; w += L.NP * DT_HEADS;
  L.den = w; w += DT_HEADS;
  L.src = w; w += L.NP;
  L.wstride = w;
  L.total = o + DT_WARPS * w;
  return L;
}

// One branch's rows of DT_S sources from list position p0: the three-term
// sum, LayerNorm and activation, features 4 lane .. 4 lane + 3. `kj` holds
// the row offsets of kj_a, kj_b and n_src of each source (-1: past the
// list), `base` a_ji + n_dst of the bond.
__device__ __forceinline__ void branch_rows(
    float (&y)[DT_S][4], const DTDims& d, const float* __restrict__ kja,
    const float* __restrict__ kjb, const float* __restrict__ nsrc,
    const size_t (&ra)[DT_S], const size_t (&rb)[DT_S],
    const size_t (&rs)[DT_S], const bool (&on)[DT_S], int off,
    const float4& base, const float* enc, int NP, int p0, const float* w,
    const float* lns, const float* lnb, int lane) {
  const int c = off + 4 * lane;
#pragma unroll
  for (int s = 0; s < DT_S; ++s) {
    float4 t = zero4();
    if (on[s]) {
      const float4 a = ldg4(kja + ra[s] + c), bb = ldg4(kjb + rb[s] + c),
                   n = ldg4(nsrc + rs[s] + c);
      t = make_float4(((a.x + bb.x) + n.x) + base.x,
                      ((a.y + bb.y) + n.y) + base.y,
                      ((a.z + bb.z) + n.z) + base.z,
                      ((a.w + bb.w) + n.w) + base.w);
    }
    y[s][0] = t.x; y[s][1] = t.y; y[s][2] = t.z; y[s][3] = t.w;
  }
  // + enc @ W_ang: the encodings of the DT_S sources as one 16-byte read
#pragma unroll
  for (int e = 0; e < DT_NE; ++e) {
    const float4 e4 = ld4(enc + e * NP + p0);
    const float4 w4 = ld4(w + e * DT_H + 4 * lane);
#pragma unroll
    for (int s = 0; s < DT_S; ++s) {
      const float es = el(e4, s);
      y[s][0] = fmaf(es, w4.x, y[s][0]);
      y[s][1] = fmaf(es, w4.y, y[s][1]);
      y[s][2] = fmaf(es, w4.z, y[s][2]);
      y[s][3] = fmaf(es, w4.w, y[s][3]);
    }
  }
  if (d.norm) {
    float m[DT_S];
#pragma unroll
    for (int s = 0; s < DT_S; ++s)
      m[s] = (y[s][0] + y[s][1]) + (y[s][2] + y[s][3]);
    warp_sum4(m, lane);
    float v[DT_S];
#pragma unroll
    for (int s = 0; s < DT_S; ++s) {
      m[s] = m[s] / (float)DT_H;
      float q = 0.f;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        y[s][f] -= m[s];
        q = fmaf(y[s][f], y[s][f], q);
      }
      v[s] = q;
    }
    warp_sum4(v, lane);
    const float4 ls = ld4(lns + 4 * lane), lb = ld4(lnb + 4 * lane);
#pragma unroll
    for (int s = 0; s < DT_S; ++s) {
      const float r = rsqrtf(v[s] / (float)DT_H + LN_EPS_F);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        y[s][f] = fmaf(y[s][f] * r, el(ls, f), el(lb, f));
    }
  }
  apply_act(y, d.act);
}

__global__ void __launch_bounds__(DT_NT, 3)
dense_triplet_kernel(DTDims d, const float* __restrict__ kja,
                     const float* __restrict__ kjb,
                     const float* __restrict__ ji,
                     const float* __restrict__ nsrc,
                     const float* __restrict__ ndst,
                     const float* __restrict__ q,
                     const float* __restrict__ pos,
                     const float* __restrict__ mask,
                     const float* __restrict__ wang_k,
                     const float* __restrict__ wang_v,
                     const float* __restrict__ lnk_s,
                     const float* __restrict__ lnk_b,
                     const float* __restrict__ lnv_s,
                     const float* __restrict__ lnv_b,
                     const float* __restrict__ wko,
                     const float* __restrict__ wvo,
                     const float* __restrict__ bvo,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const DTLay L = dt_layout(d);
  const int i0 = blockIdx.x * DT_WARPS, j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = d.N, NP = L.NP;
  const float* mb = mask + (size_t)b * N;

  // nk = 1 + the graph's last real slot (0: none), nv = its real slots
  int nk = 0, nv = 0;
  for (int t0 = 0; t0 < N; t0 += 32) {
    const unsigned bal =
        __ballot_sync(FULL, t0 + lane < N && mb[t0 + lane] > 0.f);
    if (bal) nk = t0 + 32 - __clz(bal);
    nv += __popc(bal);
  }
  // The targets of (b, j) are the real slots other than j, nl of them; the
  // block's warps take targets number i0 .. i0 + DT_WARPS - 1 in slot
  // order. Rows i0 .. i0 + DT_WARPS - 1 of the output that are no target
  // are zeroed here.
  const bool jv = mb[j] > 0.f;
  const int nl = jv ? nv - 1 : 0;
  {
    const int ir = i0 + warp;
    if (ir < N && !(jv && ir < nk && mb[ir] > 0.f && ir != j))
      st4(out + (((size_t)b * N + j) * N + ir) * DT_H + 4 * lane, zero4());
  }
  if (i0 >= nl) return;
  int i = -1;  // the warp's target: real slot number i0 + warp other than j
  for (int t0 = 0, r = i0 + warp; t0 < nk && i < 0; t0 += 32) {
    const bool v = t0 + lane < nk && mb[t0 + lane] > 0.f && t0 + lane != j;
    const unsigned bal = __ballot_sync(FULL, v);
    const int cnt = __popc(bal);
    if (r < cnt) {
      const unsigned hit = __ballot_sync(
          FULL, v && __popc(bal & ((1u << lane) - 1u)) == r);
      i = t0 + __ffs(hit) - 1;
    } else {
      r -= cnt;
    }
  }

  float* wk = sm + L.wk;    // [DT_NE][H]
  float* wv = sm + L.wv;    // [DT_NE][H]
  float* lnp = sm + L.ln;   // k scale | k bias | v scale | v bias
  float* posl = sm + L.pos; // [nk][3]
  float* msk = sm + L.msk;  // [nk]
  // encoding rows: x, sin x (rows 1 and 4), sin 2x, sin 3x, sin x/2,
  // sin x/3, cos x (rows 7 and 10), cos 2x, cos 3x, cos x/2, cos x/3
  for (int idx = tid; idx < DT_NE * DT_H; idx += DT_NT) {
    const int r = idx / DT_H, c = idx - r * DT_H;
    const int r0 = r < 4 ? r : (r < 9 ? r + 1 : r + 2);
    const int r1 = r == 1 ? 4 : (r == 6 ? 10 : -1);
    float a = wang_k[r0 * DT_H + c], v = wang_v[r0 * DT_H + c];
    if (r1 >= 0) {
      a += wang_k[r1 * DT_H + c];
      v += wang_v[r1 * DT_H + c];
    }
    wk[idx] = a;
    wv[idx] = v;
  }
  if (d.norm) {
    for (int idx = tid; idx < DT_H; idx += DT_NT) {
      lnp[idx] = lnk_s[idx];
      lnp[DT_H + idx] = lnk_b[idx];
      lnp[2 * DT_H + idx] = lnv_s[idx];
      lnp[3 * DT_H + idx] = lnv_b[idx];
    }
  }
  for (int idx = tid; idx < nk * 3; idx += DT_NT)
    posl[idx] = pos[(size_t)b * N * 3 + idx];
  for (int idx = tid; idx < nk; idx += DT_NT) msk[idx] = mb[idx];
  __syncthreads();
  // no block barrier from here on: each warp finishes its own bond
  if (i < 0) return;

  float* wr = sm + L.warp0 + warp * L.wstride;
  float* qs = wr + L.qs;     // [H] q(j, i)
  float* qf = wr + L.qf;     // [heads][DT_QP] folded query, then pooled
  float* enc = wr + L.enc;   // [DT_NE][NP] encodings by list position
  float* sc = wr + L.sc;     // [NP][heads] scores, then numerators
  float* den = wr + L.den;   // [heads] softmax sums
  int* src = reinterpret_cast<int*>(wr + L.src);  // [NP] source slots
  const size_t pair = ((size_t)b * N + j) * N + i;
  st4(qs + 4 * lane, ldg4(q + pair * DT_H + 4 * lane));
  // the sources: real slots other than i and j, in slot order
  int ns = 0;
  for (int t0 = 0; t0 < nk; t0 += 32) {
    const int k = t0 + lane;
    const bool v = k < nk && msk[k] > 0.f && k != i && k != j;
    const unsigned bal = __ballot_sync(FULL, v);
    if (v) src[ns + __popc(bal & ((1u << lane) - 1u))] = k;
    ns += __popc(bal);
  }
  __syncwarp();

  // each source's encoding, a lane a source (zeros past the list, up to a
  // multiple of DT_S)
  {
    const float pix = posl[i * 3], piy = posl[i * 3 + 1],
                piz = posl[i * 3 + 2];
    const float rjx = posl[j * 3] - pix, rjy = posl[j * 3 + 1] - piy,
                rjz = posl[j * 3 + 2] - piz;
    const float njsq = __fadd_rn(
        __fadd_rn(__fmul_rn(rjx, rjx), __fmul_rn(rjy, rjy)),
        __fmul_rn(rjz, rjz));
    for (int p = lane; p < up4(ns); p += 32) {
      float e[DT_NE];
#pragma unroll
      for (int r = 0; r < DT_NE; ++r) e[r] = 0.f;
      if (p < ns) {
        const int k = src[p];
        const float rkx = posl[k * 3] - pix, rky = posl[k * 3 + 1] - piy,
                    rkz = posl[k * 3 + 2] - piz;
        const float dot = __fadd_rn(
            __fadd_rn(__fmul_rn(rjx, rkx), __fmul_rn(rjy, rky)),
            __fmul_rn(rjz, rkz));
        const float nksq = __fadd_rn(
            __fadd_rn(__fmul_rn(rkx, rkx), __fmul_rn(rky, rky)),
            __fmul_rn(rkz, rkz));
        const float cross_sq =
            __fsub_rn(__fmul_rn(njsq, nksq), __fmul_rn(dot, dot));
        const float ang = atan2f(sqrtf(fmaxf(cross_sq, CROSS_SQ_EPS_F)), dot);
        // frequencies 1, 2, 3, 1/2, 1/3 as ops/rbf.py's float32 table
        const float fr[5] = {1.f, 2.f, 3.f, 0.5f, 1.f / 3.f};
        e[0] = ang;
#pragma unroll
        for (int m = 0; m < 5; ++m) sincosf(ang * fr[m], &e[1 + m], &e[6 + m]);
      }
#pragma unroll
      for (int r = 0; r < DT_NE; ++r) enc[r * NP + p] = e[r];
    }
  }
  // the key output folded into the query: lane (h, half) takes head
  // h = lane / 2 and features 64 half .. 64 half + 63
  {
    const int h = lane >> 1, c0 = (lane & 1) * 64;
    const float4 qa = ld4(qs + DT_DH * h), qb = ld4(qs + DT_DH * h + 4);
    const float sdh = sqrtf((float)DT_DH);
    for (int c = c0; c < c0 + 64; c += 4) {
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wrow = wko + (c + u) * DT_H + DT_DH * h;
        const float4 wa = ldg4(wrow), wb = ldg4(wrow + 4);
        float t = wa.x * qa.x;
        t = fmaf(wa.y, qa.y, t); t = fmaf(wa.z, qa.z, t);
        t = fmaf(wa.w, qa.w, t); t = fmaf(wb.x, qb.x, t);
        t = fmaf(wb.y, qb.y, t); t = fmaf(wb.z, qb.z, t);
        t = fmaf(wb.w, qb.w, t);
        r[u] = t / sdh;
      }
      st4(qf + h * DT_QP + c, make_float4(r[0], r[1], r[2], r[3]));
    }
  }
  __syncwarp();

  const size_t kstep = (size_t)N;  // (b, k, j) -> (b, k + 1, j): N rows
  const size_t rkj0 = (size_t)b * N * N + j;
  const float4 ji4k = ldg4(ji + pair * d.sj + 4 * lane),
               ji4v = ldg4(ji + pair * d.sj + DT_H + 4 * lane);
  const float* nd = ndst + ((size_t)b * N + j) * d.sd;
  const float4 nd4k = ldg4(nd + 4 * lane), nd4v = ldg4(nd + DT_H + 4 * lane);
  const float4 basek = make_float4(ji4k.x + nd4k.x, ji4k.y + nd4k.y,
                                   ji4k.z + nd4k.z, ji4k.w + nd4k.w);
  const float4 basev = make_float4(ji4v.x + nd4v.x, ji4v.y + nd4v.y,
                                   ji4v.z + nd4v.z, ji4v.w + nd4v.w);

  // pass 1: the scores of every source
  for (int p0 = 0; p0 < ns; p0 += DT_S) {
    size_t ra[DT_S], rb[DT_S], rs[DT_S];
    bool on[DT_S];
#pragma unroll
    for (int s = 0; s < DT_S; ++s) {
      on[s] = p0 + s < ns;
      const int k = on[s] ? src[p0 + s] : 0;
      const size_t r = rkj0 + (size_t)k * kstep;
      ra[s] = r * d.sa;
      rb[s] = r * d.sb;
      rs[s] = ((size_t)b * N + k) * d.ss;
    }
    float y[DT_S][4];
    branch_rows(y, d, kja, kjb, nsrc, ra, rb, rs, on, 0, basek, enc, NP, p0,
                wk, lnp, lnp + DT_H, lane);
    // partial dots of the lane's four features, value number 16 s + h
    float v[64];
#pragma unroll
    for (int h = 0; h < DT_HEADS; ++h) {
      const float4 q4 = ld4(qf + h * DT_QP + 4 * lane);
#pragma unroll
      for (int s = 0; s < DT_S; ++s) {
        float t = y[s][0] * q4.x;
        t = fmaf(y[s][1], q4.y, t);
        t = fmaf(y[s][2], q4.z, t);
        v[DT_HEADS * s + h] = fmaf(y[s][3], q4.w, t);
      }
    }
    rs_step<64>(v, lane, 16);
    rs_step<32>(v, lane, 8);
    rs_step<16>(v, lane, 4);
    rs_step<8>(v, lane, 2);
    rs_step<4>(v, lane, 1);
    // the lane holds the warp's sums number 2 lane and 2 lane + 1
    {
      const int s = lane >> 3, h = (lane & 7) * 2;
      if (p0 + s < ns)
        *reinterpret_cast<float2*>(sc + (p0 + s) * DT_HEADS + h) =
            make_float2(v[0], v[1]);
    }
  }
  __syncwarp();

  // the softmax over the sources: lane (h, half) takes head h = lane % 16
  // and every other source
  {
    const int h = lane & 15, half = lane >> 4;
    float mx = -INFINITY;
    for (int p = half; p < ns; p += 2) mx = fmaxf(mx, sc[p * DT_HEADS + h]);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
    float su = 0.f;
    for (int p = half; p < ns; p += 2) {
      const float e = expf(sc[p * DT_HEADS + h] - mx);
      sc[p * DT_HEADS + h] = e;
      su += e;
    }
    su += __shfl_xor_sync(FULL, su, 16);
    if (half == 0) den[h] = su;
  }
  __syncwarp();

  // pass 2: the value rows, accumulated a head
  float acc[DT_HEADS][4];
#pragma unroll
  for (int h = 0; h < DT_HEADS; ++h)
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[h][f] = 0.f;
  for (int p0 = 0; p0 < ns; p0 += DT_S) {
    size_t ra[DT_S], rb[DT_S], rs[DT_S];
    bool on[DT_S];
#pragma unroll
    for (int s = 0; s < DT_S; ++s) {
      on[s] = p0 + s < ns;
      const int k = on[s] ? src[p0 + s] : 0;
      const size_t r = rkj0 + (size_t)k * kstep;
      ra[s] = r * d.sa;
      rb[s] = r * d.sb;
      rs[s] = ((size_t)b * N + k) * d.ss;
    }
    float y[DT_S][4];
    branch_rows(y, d, kja, kjb, nsrc, ra, rb, rs, on, DT_H, basev, enc, NP,
                p0, wv, lnp + 2 * DT_H, lnp + 3 * DT_H, lane);
#pragma unroll
    for (int s = 0; s < DT_S; ++s) {
      if (!on[s]) continue;
      const float* e = sc + (p0 + s) * DT_HEADS;
#pragma unroll
      for (int h4 = 0; h4 < DT_HEADS; h4 += 4) {
        const float4 e4 = ld4(e + h4);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            acc[h4 + u][f] = fmaf(el(e4, u), y[s][f], acc[h4 + u][f]);
      }
    }
  }

  // epilogue: pooled = acc / sum, then the value output a head
  float* pool = qf;  // the folded query is no longer read
  if (ns > 0) {
#pragma unroll
    for (int h = 0; h < DT_HEADS; ++h) {
      const float dn = den[h];
      st4(pool + h * DT_QP + 4 * lane,
          make_float4(acc[h][0] / dn, acc[h][1] / dn, acc[h][2] / dn,
                      acc[h][3] / dn));
    }
  }
  __syncwarp();
  // lane (h, half) writes features t0 .. t0 + 3 of head h = lane / 2
  const int h = lane >> 1, t0 = DT_DH * h + 4 * (lane & 1);
  float4 o = zero4();
  if (ns > 0) {
    o = ldg4(bvo + t0);
    const float* prow = pool + h * DT_QP;
    for (int c = 0; c < DT_H; c += 4) {
      const float4 p4 = ld4(prow + c);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        fma4(o, el(p4, u), ldg4(wvo + (c + u) * DT_H + t0));
    }
  }
  st4(out + pair * DT_H + t0, o);
}

static const size_t kDtMaxSmem = 232448;

static int dt_dims(const int* dims, DTDims* d) {
  d->B = dims[0]; d->N = dims[1]; d->norm = dims[2]; d->act = dims[3];
  d->sa = dims[4]; d->sb = dims[5]; d->sj = dims[6]; d->ss = dims[7];
  d->sd = dims[8];
  if (d->B < 1 || d->B > 65535 || d->N < 1 || d->N > 65535 || d->act < 0 ||
      d->act >= ACT_COUNT)
    return (int)cudaErrorInvalidValue;
  const int strides[5] = {d->sa, d->sb, d->sj, d->ss, d->sd};
  for (int t = 0; t < 5; ++t)
    if (strides[t] < 0 || strides[t] % 4) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)dt_layout(*d).total * sizeof(float);
  if (bytes > kDtMaxSmem) return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" {

// Pointer slots (float32, every row 16-byte aligned, features contiguous):
// kj_a, kj_b [B,N,N] rows (k, j) of 2H (the k-branch's features, then the
// v-branch's), ji [B,N,N] rows (j, i) of 2H, n_src [B,N] rows (k) of 2H,
// n_dst [B,N] rows (j) of 2H (a_kj = kj_a + kj_b + n_src[k] + n_dst[j],
// a_ji = ji), q [B,N,N,H] (j, i), pos [B,N,3], mask [B,N] (1 = real),
// w_ang_k, w_ang_v [13,H], LayerNorm scale and bias of k, then of v [H]
// (not read when norm is 0), w_k_out, w_v_out [H,H], b_v_out [H],
// out [B,N,N,H] (j, i). dims: B, N, norm, act, then the row strides of
// kj_a, kj_b, ji, n_src, n_dst in floats (multiples of 4; 0 repeats one
// row). H = 128, 16 heads, num_ang = 3.
int dt_dense_triplet(const void* const* p, int np, const int* dims,
                     void* stream) {
  if (np != 18) return (int)cudaErrorInvalidValue;
  DTDims d;
  int rc = dt_dims(dims, &d);
  if (rc) return rc;
  const size_t bytes = (size_t)dt_layout(d).total * sizeof(float);
  cudaError_t ce = cudaFuncSetAttribute(
      dense_triplet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (ce != cudaSuccess) return (int)ce;
  const float* const* f = reinterpret_cast<const float* const*>(p);
  dim3 grid((d.N + DT_WARPS - 1) / DT_WARPS, d.N, d.B);
  dense_triplet_kernel<<<grid, DT_NT, bytes, (cudaStream_t)stream>>>(
      d, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
      f[11], f[12], f[13], f[14], f[15], f[16],
      reinterpret_cast<float*>(const_cast<void*>(p[17])));
  return (int)cudaGetLastError();
}

// The launch of dt_dense_triplet at these dims: out = dynamic shared memory
// a block (bytes), resident blocks an SM, threads a block, target bonds a
// block. Returns a cudaError_t code.
int dt_launch_plan(const int* dims, int* out) {
  DTDims d;
  int rc = dt_dims(dims, &d);
  if (rc) return rc;
  const size_t bytes = (size_t)dt_layout(d).total * sizeof(float);
  cudaError_t ce = cudaFuncSetAttribute(
      dense_triplet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (ce != cudaSuccess) return (int)ce;
  int blocks = 0;
  ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, dense_triplet_kernel, DT_NT, bytes);
  if (ce != cudaSuccess) return (int)ce;
  out[0] = (int)bytes; out[1] = blocks; out[2] = DT_NT; out[3] = DT_WARPS;
  return 0;
}

}  // extern "C"
