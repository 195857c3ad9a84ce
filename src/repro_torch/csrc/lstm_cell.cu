// The HAR LSTM over a whole sequence, fp32, for L lanes at once: a forward
// kernel that runs T steps of the cell in one launch, and the backward
// kernel that walks the same T steps in reverse.
//
//     gates = x_t @ wx + h_t @ wh + b            split [i | f | g | o] along 4H
//     c_{t+1} = sigmoid(f) * c_t + sigmoid(i) * tanh(g)
//     h_{t+1} = sigmoid(o) * tanh(c_{t+1})
//
// Shapes, per launch: x_seq (L, T, B, F), h0 and c0 (L, B, H), wx (L, F, 4H),
// wh (L, H, 4H), b (L, 4H).  Each lane has its own params (the fleet engine
// trains R requesters, or V contributor rows, at once; the loop engine is
// L = 1).  Every input is dense within a lane and is given its own lane
// stride, so the fleet passes views of its flat (L, P) parameter buffer with
// no copy.  The forward writes h_T and c_T (L, B, H), or, for a backward,
// the states before and after every step, h_seq and c_seq (L, T+1, B, H)
// with h_seq[:, 0] = h0.  The backward takes those, and the cotangents of
// h_T and c_T, and writes dgates (L, T, B, 4H) (the gate pre-activations'
// cotangents) and the cotangents of h0 and c0; the wrapper forms the weight
// gradients from dgates as batched products (x_seq^T dgates, h_seq^T dgates,
// a sum for b), as XLA's autodiff does for the reference.  No atomics: the
// results are deterministic.
//
// Replaces: src/repro/kernels/lstm_cell/kernel.py::lstm_cell_pallas (one
// step; the one-step op is the case T = 1 of the forward here).  The
// backward has no TPU counterpart: the reference differentiates the scan
// of that cell with XLA's autodiff.
//
// What bounds it on an H100: at the HAR shapes (B = 32 in fit, up to 45 in
// scoring, F = 6, H = 64, T = 32) a lane's forward is 2 B (F + H) 4H T
// ~ 36.7 MFLOP of fp32 FMA against ~0.65 MB moved (the weights 72 KB once,
// x, and the saved states): operation-bound, ~0.55 us at 67 TFLOP/s, and
// 64 lanes ~35 us.  The backward does the forward's products again plus
// 2 B 4H H T for dh, and writes dgates (1 MB a lane).  The recurrence is
// what stands in the way: step t + 1 needs all of h_t, so a block can only
// run its batch tile's T steps one after another.
//
// Design: grid (ceil(B / Bt), L), no grid axis over time: the T steps are a
// loop inside the block.  Lanes past 65,535 go in further launches
// (loaders.cuh's over_grid_y).
// Two layouts of the weights, chosen per shape by the wrapper's plan:
//
// Shared memory (lstm_seq_{fwd,bwd}_kernel).  The block stages its lane's
// [wx; wh] and b in dynamic shared memory once, with a row stride of 4H + 1
// floats: the forward reads a fixed k at consecutive gate columns, the
// backward's dh = dgates wh^T a fixed column at consecutive k, and both are
// free of bank conflicts.  A block is H x G threads; thread (j, grp) owns
// output column j of batch rows grp + G r, r < kRows, for all four gates,
// so its c (and in the backward its dh and dc) stay in registers for all T
// steps.  The tile's h_t lives in shared memory (double-buffered in the
// forward, one __syncthreads a step; the backward stages h_t from h_seq and
// keeps the step's dgates tile there, two __syncthreads a step).  A lane's
// weights at F = 6, H = 64 take 71.7 KB; the plan tries fewer groups G
// (down to a 4-row tile) before it leaves this layout, which holds up to
// H = 114 at F = 6 (H = 115 in the forward).  The saved states of the
// fleet's fit (64 lanes, B = 32, T = 32) are 2 x 33 x 64 x 32 x 64 x 4 B
// ~ 35 MB, and its dgates ~ 67 MB: small beside 80 GB.
//
// Weights through L2 (lstm_seq_{fwd,bwd}_l2_kernel), for every shape the
// first layout cannot hold.  Nothing is copied: each gate column reads its
// weights with __ldg straight from the lane's wx (F, 4H), wh (H, 4H) and b
// at row stride 4H (at H = 128 a lane's 275 KB; the fleet's 64 lanes, 17.6
// MB, stay in the 50 MB L2).  A block is S x G threads, S = H split into
// the fewest passes of at most 256 columns (kL2Threads: the registers of a
// thread's 4 rows x 4 gates of sums bound a block to 256 threads); a
// thread walks its columns j, j + S, ...  The block keeps in shared memory only its state: the h
// tile(s), c (the backward: dh and dc), and the backward's dgates tile.  A
// dgates tile that does not fit there is written to the dgates output
// first and read back from it after a __syncthreads; a state that does not
// fit at all (H > 4,842 at a 4-row tile) lies in a global scratch buffer,
// one region a block, that the wrapper allocates.
//
// Rounding: each gate sums the x-part over k with fmaf, the h-part over k
// with fmaf, then (x-part + h-part) + b, the plain version's order; expf
// and tanhf are the accurate ones (no --use_fast_math).  Both layouts run
// that order and share the cell's elementwise code (cell_forward,
// cell_backward, whose fused products are written out, not left to the
// compiler), so they agree bit for bit on any shape both can run.  The
// backward recomputes the gates with the same function, so they are the
// forward's bit for bit.  fp32 FMA only: one TF32 product already breaks
// the 1e-5 limit against the plain version, so a wgmma / 3xTF32 design, or
// one that spreads a lane over a cluster, is left to a later change.
#include <cuda_runtime.h>

#include "loaders.cuh"

namespace {

constexpr int kRows = 4;               // batch rows a thread owns
constexpr int kMaxShared = 232448;     // dynamic shared memory of an H100 block
constexpr int kL2Threads = 256;        // threads of a weights-through-L2 block
// the weights-through-L2 layout's modes (bits)
constexpr int kStateGlobal = 1;        // the block's state in the scratch buffer
constexpr int kDgatesOut = 2;          // the backward's dgates tile in the output

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// One step of the cell from the gate pre-activations p (i, f, g, o): c is
// updated in place, h_{t+1} returned.  Both layouts call it.  Its roundings
// are spelled out in intrinsics, which the compiler never contracts or
// reorders: left to contract c = f c + i g itself, it fused the one
// product in the shared-memory kernel and the other in the L2 one.  These
// are the fusions it had made in the shared-memory kernels, whose bits
// they keep (an H100 run of both against the earlier build).
__device__ __forceinline__ float cell_forward(const float (&p)[4], float& c) {
  const float gi = sigmoid(p[0]);
  const float gf = sigmoid(p[1]);
  const float gg = tanhf(p[2]);
  const float go = sigmoid(p[3]);
  c = __fmaf_rn(gi, gg, __fmul_rn(gf, c));
  return __fmul_rn(go, tanhf(c));
}

// The step's backward from its pre-activations p and cell states c_prev,
// c_new, and the cotangents dh, dc of its outputs: the gates' cotangents
// into d, dc replaced by the cotangent of c_prev (dh's comes from dgates
// wh^T).  Rounded as cell_forward says.
__device__ __forceinline__ void cell_backward(const float (&p)[4], float c_prev, float c_new,
                                              float dh, float& dc, float (&d)[4]) {
  const float si = sigmoid(p[0]);
  const float sf = sigmoid(p[1]);
  const float tg = tanhf(p[2]);
  const float so = sigmoid(p[3]);
  const float tc = tanhf(c_new);
  const float dc_tot = __fmaf_rn(__fmul_rn(dh, so), __fmaf_rn(-tc, tc, 1.f), dc);
  d[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, tg), si), __fsub_rn(1.f, si));
  d[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc_tot, c_prev), sf), __fsub_rn(1.f, sf));
  d[2] = __fmul_rn(__fmul_rn(dc_tot, si), __fmaf_rn(-tg, tg, 1.f));
  d[3] = __fmul_rn(__fmul_rn(__fmul_rn(dh, tc), so), __fsub_rn(1.f, so));
  dc = __fmul_rn(dc_tot, sf);
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Offsets (floats) of the regions of dynamic shared memory, each 16-byte
// aligned: the staged weights, the bias, the h tile(s), the dgates tile.
struct Layout {
  int s;         // row stride of the staged weights, 4H + 1
  int hs;        // row stride of an h tile, H rounded up to 4
  int b_off, h_off, dg_off, total;
};

__host__ __device__ inline Layout layout(int f, int hidden, int tile, bool backward) {
  Layout l;
  l.s = 4 * hidden + 1;
  l.hs = round4(hidden);
  l.b_off = round4((f + hidden) * l.s);
  l.h_off = l.b_off + 4 * hidden;
  l.dg_off = l.h_off + (backward ? 1 : 2) * tile * l.hs;
  l.total = l.dg_off + (backward ? tile * 4 * hidden : 0);
  return l;
}

struct SeqArgs {
  const float* x;        // (L, T, B, F), lane stride x_ls
  const float* wx;       // (L, F, 4H)
  const float* wh;       // (L, H, 4H)
  const float* b;        // (L, 4H)
  int x_ls, wx_ls, wh_ls, b_ls;
  int steps, batch, f, hidden, groups;
};

// The lane's [wx; wh] into rows 0..F+H-1 of ws (stride s), b into bs.
__device__ void stage_weights(float* ws, float* bs, const float* __restrict__ wx,
                              const float* __restrict__ wh, const float* __restrict__ b,
                              int f, int hidden, int s) {
  const int h4 = 4 * hidden;
  const int n = (f + hidden) * h4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / h4;
    const int col = i - k * h4;
    ws[k * s + col] = k < f ? __ldg(wx + i) : __ldg(wh + (i - f * h4));
  }
  for (int i = threadIdx.x; i < h4; i += blockDim.x) bs[i] = __ldg(b + i);
}

// The thread's rows of one step's gate pre-activations, pre[r][g] for
// column j of gate g: (x_t @ wx + h_t @ wh) + b in the plain version's
// order.  xt is step t of the lane's x_seq (B, F) in global memory, ht the
// tile's h_t in shared memory (row stride hs).
__device__ __forceinline__ void preacts(const float* __restrict__ xt, const float* ws,
                                        const float* bs, const float* ht, int hs,
                                        int f, int hidden, int s, int j,
                                        const int (&rowl)[kRows], const int (&rowg)[kRows],
                                        const bool (&valid)[kRows], float (&pre)[kRows][4]) {
  float ax[kRows][4], ah[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) ax[r][g] = ah[r][g] = 0.f;
  for (int k = 0; k < f; ++k) {
    const float* wr = ws + k * s + j;
    const float w0 = wr[0], w1 = wr[hidden], w2 = wr[2 * hidden], w3 = wr[3 * hidden];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = valid[r] ? __ldg(xt + static_cast<size_t>(rowg[r]) * f + k) : 0.f;
      ax[r][0] = fmaf(v, w0, ax[r][0]);
      ax[r][1] = fmaf(v, w1, ax[r][1]);
      ax[r][2] = fmaf(v, w2, ax[r][2]);
      ax[r][3] = fmaf(v, w3, ax[r][3]);
    }
  }
  int k = 0;
  for (; k + 4 <= hidden; k += 4) {
    float4 hv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      hv[r] = *reinterpret_cast<const float4*>(ht + rowl[r] * hs + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = ws + (f + k + kk) * s + j;
      const float w0 = wr[0], w1 = wr[hidden], w2 = wr[2 * hidden], w3 = wr[3 * hidden];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y : kk == 2 ? hv[r].z : hv[r].w;
        ah[r][0] = fmaf(v, w0, ah[r][0]);
        ah[r][1] = fmaf(v, w1, ah[r][1]);
        ah[r][2] = fmaf(v, w2, ah[r][2]);
        ah[r][3] = fmaf(v, w3, ah[r][3]);
      }
    }
  }
  for (; k < hidden; ++k) {
    const float* wr = ws + (f + k) * s + j;
    const float w0 = wr[0], w1 = wr[hidden], w2 = wr[2 * hidden], w3 = wr[3 * hidden];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = ht[rowl[r] * hs + k];
      ah[r][0] = fmaf(v, w0, ah[r][0]);
      ah[r][1] = fmaf(v, w1, ah[r][1]);
      ah[r][2] = fmaf(v, w2, ah[r][2]);
      ah[r][3] = fmaf(v, w3, ah[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[r][g] = ax[r][g] + ah[r][g] + bs[g * hidden + j];
}

__global__ void lstm_seq_fwd_kernel(SeqArgs a, const float* __restrict__ h0,
                                    const float* __restrict__ c0, int h0_ls, int c0_ls,
                                    float* __restrict__ h_out, float* __restrict__ c_out,
                                    int save) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int tile = a.groups * kRows;
  const Layout lo = layout(f, hidden, tile, false);
  float* ws = smem;
  float* bs = smem + lo.b_off;
  float* hbuf = smem + lo.h_off;
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  h0 += static_cast<size_t>(lane) * h0_ls;
  c0 += static_cast<size_t>(lane) * c0_ls;
  stage_weights(ws, bs, a.wx + static_cast<size_t>(lane) * a.wx_ls,
                a.wh + static_cast<size_t>(lane) * a.wh_ls,
                a.b + static_cast<size_t>(lane) * a.b_ls, f, hidden, lo.s);

  const int j = threadIdx.x % hidden;
  const int grp = threadIdx.x / hidden;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t out_lane = save ? (steps + 1) * bh : bh;
  h_out += lane * out_lane;
  c_out += lane * out_lane;
  int rowl[kRows], rowg[kRows];
  bool valid[kRows];
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    rowl[r] = grp + a.groups * r;
    rowg[r] = blockIdx.x * tile + rowl[r];
    valid[r] = rowg[r] < batch;
    const size_t o = static_cast<size_t>(rowg[r]) * hidden + j;
    const float hv = valid[r] ? __ldg(h0 + o) : 0.f;
    c[r] = valid[r] ? __ldg(c0 + o) : 0.f;
    hbuf[rowl[r] * lo.hs + j] = hv;
    if (save && valid[r]) {
      h_out[o] = hv;
      c_out[o] = c[r];
    }
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* ht = hbuf + (t & 1) * tile * lo.hs;
    float* hn = hbuf + ((t + 1) & 1) * tile * lo.hs;
    float pre[kRows][4];
    preacts(x + static_cast<size_t>(t) * batch * f, ws, bs, ht, lo.hs, f, hidden, lo.s, j,
            rowl, rowg, valid, pre);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float hv = cell_forward(pre[r], c[r]);
      hn[rowl[r] * lo.hs + j] = valid[r] ? hv : 0.f;
      if (valid[r] && (save || t == steps - 1)) {
        const size_t o = (save ? (t + 1) * bh : 0) + static_cast<size_t>(rowg[r]) * hidden + j;
        h_out[o] = hv;
        c_out[o] = c[r];
      }
    }
    __syncthreads();
  }
}

__global__ void lstm_seq_bwd_kernel(SeqArgs a, const float* __restrict__ h_seq,
                                    const float* __restrict__ c_seq,
                                    const float* __restrict__ dh_last,
                                    const float* __restrict__ dc_last,
                                    float* __restrict__ dgates, float* __restrict__ dh0,
                                    float* __restrict__ dc0) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int h4 = 4 * hidden;
  const int tile = a.groups * kRows;
  const Layout lo = layout(f, hidden, tile, true);
  float* ws = smem;
  float* bs = smem + lo.b_off;
  float* hbuf = smem + lo.h_off;
  float* dgs = smem + lo.dg_off;
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  stage_weights(ws, bs, a.wx + static_cast<size_t>(lane) * a.wx_ls,
                a.wh + static_cast<size_t>(lane) * a.wh_ls,
                a.b + static_cast<size_t>(lane) * a.b_ls, f, hidden, lo.s);

  const int j = threadIdx.x % hidden;
  const int grp = threadIdx.x / hidden;
  const int tile0 = blockIdx.x * tile;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  h_seq += lane * (steps + 1) * bh;
  c_seq += lane * (steps + 1) * bh;
  dgates += lane * static_cast<size_t>(steps) * batch * h4;
  int rowl[kRows], rowg[kRows];
  bool valid[kRows];
  float dh[kRows], dc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    rowl[r] = grp + a.groups * r;
    rowg[r] = tile0 + rowl[r];
    valid[r] = rowg[r] < batch;
    const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
    dh[r] = valid[r] ? __ldg(dh_last + o) : 0.f;
    dc[r] = valid[r] ? __ldg(dc_last + o) : 0.f;
  }

  for (int t = steps - 1; t >= 0; --t) {
    // h_t, the step's input state, for the whole tile
    const float* hsrc = h_seq + t * bh;
    for (int i = threadIdx.x; i < tile * hidden; i += blockDim.x) {
      const int bl = i / hidden;
      const int k = i - bl * hidden;
      hbuf[bl * lo.hs + k] = tile0 + bl < batch
          ? __ldg(hsrc + static_cast<size_t>(tile0 + bl) * hidden + k) : 0.f;
    }
    __syncthreads();
    float pre[kRows][4];
    preacts(x + static_cast<size_t>(t) * batch * f, ws, bs, hbuf, lo.hs, f, hidden, lo.s, j,
            rowl, rowg, valid, pre);
    float* dgt = dgates + static_cast<size_t>(t) * batch * h4;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t o = static_cast<size_t>(rowg[r]) * hidden + j;
      const float c_prev = valid[r] ? __ldg(c_seq + t * bh + o) : 0.f;
      const float c_new = valid[r] ? __ldg(c_seq + (t + 1) * bh + o) : 0.f;
      float d[4];
      cell_backward(pre[r], c_prev, c_new, dh[r], dc[r], d);
      float* drow = dgs + rowl[r] * h4 + j;
      drow[0] = d[0];
      drow[hidden] = d[1];
      drow[2 * hidden] = d[2];
      drow[3 * hidden] = d[3];
      if (valid[r]) {
        float* grow = dgt + static_cast<size_t>(rowg[r]) * h4 + j;
        grow[0] = d[0];
        grow[hidden] = d[1];
        grow[2 * hidden] = d[2];
        grow[3 * hidden] = d[3];
      }
    }
    __syncthreads();
    // dh_t[b, j] = sum over the 4H gate columns of dgates_t[b, col] wh[j, col]
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const float* wr = ws + (f + j) * lo.s;
    for (int col = 0; col < h4; col += 4) {
      const float w0 = wr[col], w1 = wr[col + 1], w2 = wr[col + 2], w3 = wr[col + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(dgs + rowl[r] * h4 + col);
        acc[r] = fmaf(d.x, w0, acc[r]);
        acc[r] = fmaf(d.y, w1, acc[r]);
        acc[r] = fmaf(d.z, w2, acc[r]);
        acc[r] = fmaf(d.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) dh[r] = acc[r];
    // the next step overwrites hbuf and dgs only after its first
    // __syncthreads, which every thread reaches after this reduction
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!valid[r]) continue;
    const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
    dh0[o] = dh[r];
    dc0[o] = dc[r];
  }
}

// ---------------------------------------------------------------------------
// The weights-through-L2 layout
// ---------------------------------------------------------------------------

// Offsets (floats) of a block's state, each 16-byte aligned: the forward's
// two h tiles and c, the backward's h tile, dh, dc and (unless kDgatesOut)
// its dgates tile.  Row stride hs (H rounded up to 4), the dgates tile's 4H.
struct StateLayout {
  int hs;
  int h_off, c_off, dh_off, dc_off, dg_off, total;
};

__host__ __device__ inline StateLayout state_layout(int hidden, int tile, bool backward,
                                                    int mode) {
  StateLayout l;
  l.hs = round4(hidden);
  const int part = tile * l.hs;
  l.h_off = 0;
  l.c_off = backward ? 0 : 2 * part;
  l.dh_off = backward ? part : 0;
  l.dc_off = backward ? 2 * part : 0;
  l.dg_off = 3 * part;
  l.total = l.dg_off + (backward && !(mode & kDgatesOut) ? tile * 4 * hidden : 0);
  return l;
}

// The block's state: its region of the scratch buffer (one region a block
// of the launch) under kStateGlobal, else dynamic shared memory.
__device__ __forceinline__ float* block_state(float* smem, float* work, int mode, int total) {
  if (!(mode & kStateGlobal)) return smem;
  return work + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * total;
}

// preacts() with the weights read from the lane's wx, wh and b in global
// memory (row stride 4H): the same sums in the same order, so the same
// bits.  ht is the tile's h_t (row stride hs), in shared or global memory.
__device__ __forceinline__ void preacts_l2(const float* __restrict__ xt,
                                           const float* __restrict__ wx,
                                           const float* __restrict__ wh,
                                           const float* __restrict__ b, const float* ht,
                                           int hs, int f, int hidden, int j,
                                           const int (&rowl)[kRows], const int (&rowg)[kRows],
                                           const bool (&valid)[kRows],
                                           float (&pre)[kRows][4]) {
  const int h4 = 4 * hidden;
  float ax[kRows][4], ah[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) ax[r][g] = ah[r][g] = 0.f;
  for (int k = 0; k < f; ++k) {
    const float* wr = wx + k * h4 + j;
    const float w0 = __ldg(wr), w1 = __ldg(wr + hidden), w2 = __ldg(wr + 2 * hidden),
                w3 = __ldg(wr + 3 * hidden);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = valid[r] ? __ldg(xt + static_cast<size_t>(rowg[r]) * f + k) : 0.f;
      ax[r][0] = fmaf(v, w0, ax[r][0]);
      ax[r][1] = fmaf(v, w1, ax[r][1]);
      ax[r][2] = fmaf(v, w2, ax[r][2]);
      ax[r][3] = fmaf(v, w3, ax[r][3]);
    }
  }
  for (int k = 0; k < hidden; ++k) {
    const float* wr = wh + k * h4 + j;
    const float w0 = __ldg(wr), w1 = __ldg(wr + hidden), w2 = __ldg(wr + 2 * hidden),
                w3 = __ldg(wr + 3 * hidden);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = ht[rowl[r] * hs + k];
      ah[r][0] = fmaf(v, w0, ah[r][0]);
      ah[r][1] = fmaf(v, w1, ah[r][1]);
      ah[r][2] = fmaf(v, w2, ah[r][2]);
      ah[r][3] = fmaf(v, w3, ah[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[r][g] = ax[r][g] + ah[r][g] + __ldg(b + g * hidden + j);
}

// The tile's rows of thread group grp: local row, batch row, in the batch.
__device__ __forceinline__ void tile_rows(int grp, int groups, int tile0, int batch,
                                          int (&rowl)[kRows], int (&rowg)[kRows],
                                          bool (&valid)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    rowl[r] = grp + groups * r;
    rowg[r] = tile0 + rowl[r];
    valid[r] = rowg[r] < batch;
  }
}

// The forward, weights through L2.  A block is span x groups threads; thread
// (j0, grp) owns columns j0, j0 + span, ... of the tile's rows grp + G r.
// Its c lives in the block's state, not in registers, since a thread may
// own several columns.
__global__ void __launch_bounds__(kL2Threads)
    lstm_seq_fwd_l2_kernel(SeqArgs a, const float* __restrict__ h0, const float* __restrict__ c0,
                           int h0_ls, int c0_ls, float* __restrict__ h_out,
                           float* __restrict__ c_out, int save, int span, int mode, float* work) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int tile = a.groups * kRows;
  const StateLayout lo = state_layout(hidden, tile, false, mode);
  float* st = block_state(smem, work, mode, lo.total);
  float* hbuf = st + lo.h_off;
  float* cst = st + lo.c_off;
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  const float* wx = a.wx + static_cast<size_t>(lane) * a.wx_ls;
  const float* wh = a.wh + static_cast<size_t>(lane) * a.wh_ls;
  const float* b = a.b + static_cast<size_t>(lane) * a.b_ls;
  h0 += static_cast<size_t>(lane) * h0_ls;
  c0 += static_cast<size_t>(lane) * c0_ls;

  const int j0 = threadIdx.x % span;
  const int grp = threadIdx.x / span;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t out_lane = save ? (steps + 1) * bh : bh;
  h_out += lane * out_lane;
  c_out += lane * out_lane;
  int rowl[kRows], rowg[kRows];
  bool valid[kRows];
  tile_rows(grp, a.groups, blockIdx.x * tile, batch, rowl, rowg, valid);
  for (int j = j0; j < hidden; j += span) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t o = static_cast<size_t>(rowg[r]) * hidden + j;
      const float hv = valid[r] ? __ldg(h0 + o) : 0.f;
      const float cv = valid[r] ? __ldg(c0 + o) : 0.f;
      hbuf[rowl[r] * lo.hs + j] = hv;
      cst[rowl[r] * lo.hs + j] = cv;
      if (save && valid[r]) {
        h_out[o] = hv;
        c_out[o] = cv;
      }
    }
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* ht = hbuf + (t & 1) * tile * lo.hs;
    float* hn = hbuf + ((t + 1) & 1) * tile * lo.hs;
    const float* xt = x + static_cast<size_t>(t) * batch * f;
    for (int j = j0; j < hidden; j += span) {
      float pre[kRows][4];
      preacts_l2(xt, wx, wh, b, ht, lo.hs, f, hidden, j, rowl, rowg, valid, pre);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float* cp = cst + rowl[r] * lo.hs + j;
        float c = *cp;
        const float hv = cell_forward(pre[r], c);
        *cp = c;
        hn[rowl[r] * lo.hs + j] = valid[r] ? hv : 0.f;
        if (valid[r] && (save || t == steps - 1)) {
          const size_t o = (save ? (t + 1) * bh : 0) + static_cast<size_t>(rowg[r]) * hidden + j;
          h_out[o] = hv;
          c_out[o] = c;
        }
      }
    }
    __syncthreads();
  }
}

// The backward, weights through L2; threads as in the forward.  dh and dc
// live in the block's state; the step's dgates tile in it too, or, under
// kDgatesOut, in the dgates output it is written to anyway.
__global__ void __launch_bounds__(kL2Threads)
    lstm_seq_bwd_l2_kernel(SeqArgs a, const float* __restrict__ h_seq,
                           const float* __restrict__ c_seq, const float* __restrict__ dh_last,
                           const float* __restrict__ dc_last, float* dgates,
                           float* __restrict__ dh0, float* __restrict__ dc0, int span, int mode,
                           float* work) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int h4 = 4 * hidden;
  const int tile = a.groups * kRows;
  const StateLayout lo = state_layout(hidden, tile, true, mode);
  float* st = block_state(smem, work, mode, lo.total);
  float* hbuf = st + lo.h_off;
  float* dhs = st + lo.dh_off;
  float* dcs = st + lo.dc_off;
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  const float* wx = a.wx + static_cast<size_t>(lane) * a.wx_ls;
  const float* wh = a.wh + static_cast<size_t>(lane) * a.wh_ls;
  const float* b = a.b + static_cast<size_t>(lane) * a.b_ls;

  const int j0 = threadIdx.x % span;
  const int grp = threadIdx.x / span;
  const int tile0 = blockIdx.x * tile;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  h_seq += lane * (steps + 1) * bh;
  c_seq += lane * (steps + 1) * bh;
  dgates += lane * static_cast<size_t>(steps) * batch * h4;
  int rowl[kRows], rowg[kRows];
  bool valid[kRows];
  tile_rows(grp, a.groups, tile0, batch, rowl, rowg, valid);
  for (int j = j0; j < hidden; j += span) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
      dhs[rowl[r] * lo.hs + j] = valid[r] ? __ldg(dh_last + o) : 0.f;
      dcs[rowl[r] * lo.hs + j] = valid[r] ? __ldg(dc_last + o) : 0.f;
    }
  }

  for (int t = steps - 1; t >= 0; --t) {
    // h_t, the step's input state, for the whole tile
    const float* hsrc = h_seq + t * bh;
    for (int i = threadIdx.x; i < tile * hidden; i += blockDim.x) {
      const int bl = i / hidden;
      const int k = i - bl * hidden;
      hbuf[bl * lo.hs + k] = tile0 + bl < batch
          ? __ldg(hsrc + static_cast<size_t>(tile0 + bl) * hidden + k) : 0.f;
    }
    __syncthreads();
    float* dgt = dgates + static_cast<size_t>(t) * batch * h4;
    // the tile's dgates, row stride 4H: rows past the batch exist only in
    // the state's copy, so only valid rows are read back
    const bool dg_out = mode & kDgatesOut;
    float* dgs = dg_out ? dgt + static_cast<size_t>(tile0) * h4 : st + lo.dg_off;
    const float* xt = x + static_cast<size_t>(t) * batch * f;
    for (int j = j0; j < hidden; j += span) {
      float pre[kRows][4];
      preacts_l2(xt, wx, wh, b, hbuf, lo.hs, f, hidden, j, rowl, rowg, valid, pre);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = static_cast<size_t>(rowg[r]) * hidden + j;
        const float c_prev = valid[r] ? __ldg(c_seq + t * bh + o) : 0.f;
        const float c_new = valid[r] ? __ldg(c_seq + (t + 1) * bh + o) : 0.f;
        float* dcp = dcs + rowl[r] * lo.hs + j;
        float dc = *dcp;
        float d[4];
        cell_backward(pre[r], c_prev, c_new, dhs[rowl[r] * lo.hs + j], dc, d);
        *dcp = dc;
        if (!dg_out) {
          float* drow = dgs + rowl[r] * h4 + j;
          drow[0] = d[0];
          drow[hidden] = d[1];
          drow[2 * hidden] = d[2];
          drow[3 * hidden] = d[3];
        }
        if (valid[r]) {
          float* grow = dgt + static_cast<size_t>(rowg[r]) * h4 + j;
          grow[0] = d[0];
          grow[hidden] = d[1];
          grow[2 * hidden] = d[2];
          grow[3 * hidden] = d[3];
        }
      }
    }
    __syncthreads();
    // dh_t[b, j] = sum over the 4H gate columns of dgates_t[b, col] wh[j, col],
    // in the shared-memory layout's order
    for (int j = j0; j < hidden; j += span) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const float* wr = wh + static_cast<size_t>(j) * h4;
      for (int col = 0; col < h4; col += 4) {
        // scalar loads: a lane's weights start anywhere (views of a flat
        // (L, P) buffer); the dgates tile's rows are 16-byte aligned
        const float w0 = __ldg(wr + col), w1 = __ldg(wr + col + 1), w2 = __ldg(wr + col + 2),
                    w3 = __ldg(wr + col + 3);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 d = valid[r] ? *reinterpret_cast<const float4*>(dgs + rowl[r] * h4 + col)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          acc[r] = fmaf(d.x, w0, acc[r]);
          acc[r] = fmaf(d.y, w1, acc[r]);
          acc[r] = fmaf(d.z, w2, acc[r]);
          acc[r] = fmaf(d.w, w3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dhs[rowl[r] * lo.hs + j] = acc[r];
    }
    // the next step overwrites hbuf and the dgates tile only after its
    // first __syncthreads, which every thread reaches after this reduction;
    // dh and dc of a (row, column) are read and written by its thread alone
  }
  for (int j = j0; j < hidden; j += span) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!valid[r]) continue;
      const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
      dh0[o] = dhs[rowl[r] * lo.hs + j];
      dc0[o] = dcs[rowl[r] * lo.hs + j];
    }
  }
}

// Checks the caller's shared-memory size against the kernel's own layout,
// raises the kernel's limit to it, and returns the launch configuration.
template <typename Kernel>
int prepare(Kernel kernel, int f, int hidden, int groups, int smem, bool backward) {
  const Layout lo = layout(f, hidden, groups * kRows, backward);
  if (smem != 4 * lo.total || smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The same for the weights-through-L2 layout: a block of span x groups
// threads, its state in shared memory (smem bytes, its own layout) or in
// the scratch buffer (smem 0).
template <typename Kernel>
int prepare_l2(Kernel kernel, int hidden, int groups, int span, int mode, int smem,
               const void* work, bool backward) {
  if (span < 1 || groups < 1 || span * groups > kL2Threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const StateLayout lo = state_layout(hidden, groups * kRows, backward, mode);
  const bool ok = (mode & kStateGlobal) ? smem == 0 && work != nullptr
                                        : smem == 4 * lo.total && smem <= kMaxShared;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

const float* at(const void* p, int l0, size_t lane_stride) {
  return static_cast<const float*>(p) + static_cast<size_t>(l0) * lane_stride;
}

float* at(void* p, int l0, size_t lane_stride) {
  return static_cast<float*>(p) + static_cast<size_t>(l0) * lane_stride;
}

}  // namespace

// Forward.  x (L, T, B, F), h0, c0 (L, B, H), wx, wh, b: fp32 on the current
// device, each dense within a lane, lane l at pointer + l * <its lane
// stride> (elements).  h_out, c_out contiguous: (L, T+1, B, H) if save,
// else (L, B, H).  groups, l2, span, mode and smem come from the wrapper's
// plan: the shared-memory layout (l2 = 0: a block of hidden * groups
// threads, a batch tile of groups * 4 rows) or weights through L2 (l2 = 1:
// span * groups threads; mode's kStateGlobal puts each block's state in
// work, one region a block of the first 65,535 lanes).  smem must equal the
// kernel's own layout.  Returns a CUDA error code (0 on success).
extern "C" int lstm_seq_fwd_launch(const void* x, const void* h0, const void* c0,
                                   const void* wx, const void* wh, const void* b,
                                   void* h_out, void* c_out, void* work, int lanes, int steps,
                                   int batch, int f, int hidden, int groups, int save, int x_ls,
                                   int h0_ls, int c0_ls, int wx_ls, int wh_ls, int b_ls, int l2,
                                   int span, int mode, int smem, void* stream) {
  if (lanes <= 0 || batch <= 0 || steps <= 0) return 0;
  const int err = l2 ? prepare_l2(lstm_seq_fwd_l2_kernel, hidden, groups, span, mode, smem,
                                  work, false)
                     : prepare(lstm_seq_fwd_kernel, f, hidden, groups, smem, false);
  if (err != 0) return err;
  const int tile = groups * kRows;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t out_lane = save ? (steps + 1) * bh : bh;
  const auto st = static_cast<cudaStream_t>(stream);
  return over_grid_y(lanes, [&](int l0, int n) {
    const dim3 grid((batch + tile - 1) / tile, n);
    const SeqArgs a{at(x, l0, x_ls), at(wx, l0, wx_ls), at(wh, l0, wh_ls), at(b, l0, b_ls),
                    x_ls, wx_ls, wh_ls, b_ls, steps, batch, f, hidden, groups};
    if (l2)
      lstm_seq_fwd_l2_kernel<<<grid, span * groups, smem, st>>>(
          a, at(h0, l0, h0_ls), at(c0, l0, c0_ls), h0_ls, c0_ls, at(h_out, l0, out_lane),
          at(c_out, l0, out_lane), save, span, mode, static_cast<float*>(work));
    else
      lstm_seq_fwd_kernel<<<grid, hidden * groups, smem, st>>>(
          a, at(h0, l0, h0_ls), at(c0, l0, c0_ls), h0_ls, c0_ls, at(h_out, l0, out_lane),
          at(c_out, l0, out_lane), save);
  });
}

// Backward.  x, wx, wh, b as for the forward; h_seq, c_seq (L, T+1, B, H)
// and dh_last, dc_last (L, B, H) contiguous; writes dgates (L, T, B, 4H),
// dh0 and dc0 (L, B, H), contiguous.  groups, l2, span, mode (kStateGlobal,
// kDgatesOut), smem and work as for the forward.  Returns a CUDA error code.
extern "C" int lstm_seq_bwd_launch(const void* x, const void* h_seq, const void* c_seq,
                                   const void* wx, const void* wh, const void* b,
                                   const void* dh_last, const void* dc_last, void* dgates,
                                   void* dh0, void* dc0, void* work, int lanes, int steps,
                                   int batch, int f, int hidden, int groups, int x_ls, int wx_ls,
                                   int wh_ls, int b_ls, int l2, int span, int mode, int smem,
                                   void* stream) {
  if (lanes <= 0 || batch <= 0 || steps <= 0) return 0;
  const int err = l2 ? prepare_l2(lstm_seq_bwd_l2_kernel, hidden, groups, span, mode, smem,
                                  work, true)
                     : prepare(lstm_seq_bwd_kernel, f, hidden, groups, smem, true);
  if (err != 0) return err;
  const int tile = groups * kRows;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t seq_lane = (steps + 1) * bh;
  const size_t dg_lane = static_cast<size_t>(steps) * batch * 4 * hidden;
  const auto st = static_cast<cudaStream_t>(stream);
  return over_grid_y(lanes, [&](int l0, int n) {
    const dim3 grid((batch + tile - 1) / tile, n);
    const SeqArgs a{at(x, l0, x_ls), at(wx, l0, wx_ls), at(wh, l0, wh_ls), at(b, l0, b_ls),
                    x_ls, wx_ls, wh_ls, b_ls, steps, batch, f, hidden, groups};
    if (l2)
      lstm_seq_bwd_l2_kernel<<<grid, span * groups, smem, st>>>(
          a, at(h_seq, l0, seq_lane), at(c_seq, l0, seq_lane), at(dh_last, l0, bh),
          at(dc_last, l0, bh), at(dgates, l0, dg_lane), at(dh0, l0, bh), at(dc0, l0, bh), span,
          mode, static_cast<float*>(work));
    else
      lstm_seq_bwd_kernel<<<grid, hidden * groups, smem, st>>>(
          a, at(h_seq, l0, seq_lane), at(c_seq, l0, seq_lane), at(dh_last, l0, bh),
          at(dc_last, l0, bh), at(dgates, l0, dg_lane), at(dh0, l0, bh), at(dc0, l0, bh));
  });
}
