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
// Design: no grid axis over time: the T steps are a loop inside the block
// (or the cluster, or the lane's blocks across the card).  Lanes past
// 65,535 go in further launches (loaders.cuh's over_lanes).  Four layouts
// of the weights, chosen per shape by the wrapper's plan in this order:
//
// Shared memory (lstm_seq_{fwd,bwd}_kernel), grid (ceil(B / Bt), L).  The
// block stages its lane's [wx; wh] and b in dynamic shared memory once, with
// a row stride of 4H + 1 floats: the forward reads a fixed k at consecutive
// gate columns, the backward's dh = dgates wh^T a fixed column at
// consecutive k, and both are free of bank conflicts.  A block is H x G
// threads; thread (j, grp) owns output column j of batch rows grp + G r,
// r < kRows, for all four gates, so its c (and in the backward its dh and
// dc) stay in registers for all T steps.  The tile's h_t lives in shared
// memory (double-buffered in the forward, one __syncthreads a step; the
// backward stages h_t from h_seq and keeps the step's dgates tile there, two
// __syncthreads a step).  A lane's weights at F = 6, H = 64 take 71.7 KB;
// the plan tries fewer groups G (down to a 4-row tile) before it leaves
// this layout, which holds up to H = 114 at F = 6 (H = 115 in the forward).
// The saved states of the fleet's fit (64 lanes, B = 32, T = 32) are
// 2 x 33 x 64 x 32 x 64 x 4 B ~ 35 MB, and its dgates ~ 67 MB: small
// beside 80 GB.
//
// A lane's weights across a thread-block cluster
// (lstm_seq_{fwd,bwd}_cluster_kernel), for the shapes past one block's
// shared memory: up to H = 461 in the forward and H = 334 in the backward
// at F = 6.  A lane and its batch tile run on a cluster of C blocks (2, 4,
// 8 or 16; grid (C ceil(B / Bt), L), the cluster's size given at launch).
// Block q owns the hidden units J_q = [q Hc, (q + 1) Hc), Hc = ceil(H / C),
// and stages the four gate columns of each of them, of [wx; wh] and b, as
// one float4 a unit and row: a warp's 32 units read a row in one
// instruction where the one-block layout issues four.  Thread (j, grp) of
// its Hc x G threads owns unit j of the one-block layout's rows and keeps c,
// dh and dc in registers.  Each block keeps the whole tile's h_t.  The
// forward writes each h_{t+1} into every block's next h tile through
// distributed shared memory, and one cluster barrier a step takes the
// place of the __syncthreads; the x-part of the next step's gates is summed
// between the barrier's arrive and its wait, from an x tile copied by
// cp.async a step ahead.  The backward recomputes its columns' gates from
// h_seq (its h_t and x_t tiles copied by cp.async a step ahead, during the
// previous step's dh; its c_t and c_{t+1} loaded as early), forms their
// dgates, and publishes them either into every block's dgates tile (a
// barrier after the writes, and one before the next step's, whose wait
// follows the next step's gates) or, where that tile does not fit, through
// the dgates output it writes anyway (kDgatesOut, one barrier a step).  It
// then forms dh for its own units from rows J_q of wh, which it also holds
// by groups of four columns, a float4 a unit: a warp reads its rows' group
// as 32 consecutive float4s, where the weights-through-L2 layout's warp
// read 32 loads 4H floats apart.  Stores to global memory go after a
// barrier's arrive, whose release then waits for the remote writes alone.
// At H = 128 a backward block (C = 4) holds 69 KB of columns and 66 KB of
// wh's rows, where one block would need 275 KB; 64 such lanes ask for 35
// MB of shared memory, more than the card's 132 x 227 KB, so their
// backward runs in two waves of one 217-KB block an SM, eight warps.  With
// so few warps a scheduler the loads' latency shows: the 64-lane pair runs
// at 4-8x its fp32 bound, one lane (16-32 blocks) at 40-60x.
//
// A lane's weights across the whole card (lstm_seq_{fwd,bwd}_grid_kernel),
// for the shapes past the cluster's 16 blocks: whole in each block up to
// H = 924 in the forward and H = 660 in the backward at F = 6, B = 32, and
// with what a block cannot hold streamed (below) up to H = 4,224 at B = 32
// in both directions (K x tiles blocks of at most 256 threads on the
// card's SMs, roughly B x H <= 132 x 1,024).  A lane and its batch tile
// run on K blocks, K up to the card's resident capacity (132 at one block
// an SM), in one persistent cooperative launch (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative: the driver keeps every block resident or
// refuses the launch, and the launcher returns its error; lanes past one
// launch's capacity go in further launches).  Block q owns units J_q =
// [q Hc, (q + 1) Hc), Hc = ceil(H / K), and stages their columns as the
// cluster layout does.  Blocks of different SMs share no shared memory,
// so what a cluster's blocks write into each other's tiles goes through
// L2: the forward writes each h_{t+1} into an exchange buffer, two halves
// a tile, and the backward its dgates into the output it writes anyway.
// One barrier a step of the tile's K blocks: after a __syncthreads thread 0
// fences and adds 1 to the tile's arrival counter (red.release.gpu; the
// wrapper allocates the counters zeroed), then spins with ld.acquire.gpu
// until it reads K (t + 1), while the block sums the next step's x-part.
// Past the barrier the block copies what the others wrote by cp.async.cg,
// which reads at L2 and never through L1 (an __ldg could return a line L1
// kept from before): the whole h_{t+1} tile (row stride H + 4 rounded, so
// a warp's 8 rows at one k hit 8 bank groups), or the step's dgates
// kDgCols columns at a time through a double-buffered stage, from which it
// forms dh for its own units with rows J_q of wh.  Each step has its own
// slice of dgates and the forward alternates its halves, so one barrier a
// step is enough.  With one block an SM and the weights spread, a lane
// has few threads (H x B / 4 at 4 batch rows a thread: 4,096 at H = 512,
// B = 32, under 2 warps an SM) and each waits on its own loads, so a grid
// thread owns R = 4, 2 or 1 rows (a template parameter; each output is
// still one thread's sum, so the bits do not move): at one row a thread
// the H = 512 pair takes 128 blocks of 128 threads and runs 1.5-1.6x
// faster than at four.
//
// Past H = 924 / 660 a grid block no longer holds its columns, the whole h
// tile (141 KB at B = 32, H = 1,100) and, in the backward, rows J_q of wh
// at once, so its mode streams, least first: kStreamH, the gates' h-part
// sums h in chunks of kappa columns (k ascending) through a ring of kRing
// stages in shared memory, chunk c + 2 copied by cp.async.cg while chunk c
// is summed, one __syncthreads a chunk (the forward reads its chunks from
// the exchange buffer after the barrier, the backward from h_seq, its
// first chunks issued a step ahead, during the previous step's dh); the
// L2 traffic is the whole-tile copy's, the block holds only kRing chunks.
// kStreamWh (the backward): rows J_q of wh are copied beside each dgates
// chunk into the same double-buffered stage (Hc runs of kDgCols floats,
// row stride kDgCols + 4), not held.  kStreamCols: the block holds rows
// [0, rho) of its columns (the x rows and the first chunks of the h rows;
// rho - F a multiple of kappa) and streams the rest every step from a
// packed copy, (F + H - rho) x Hc float4s of its own in a scratch buffer
// the wrapper allocates, written by the block at the launch's start while
// it stages the rows it holds; one thread then takes each chunk's rows in
// one TMA bulk copy (cp.async.bulk, completing on the stage's mbarrier,
// which every thread waits on) while the warps stay on the sums.  The
// plan takes the least streaming that fits, under kStreamCols with the
// largest rho.  What the launch itself writes is never read through L1:
// the exchange buffer and dgates by cp.async.cg or after the barrier's
// acquire, the packed copy by the bulk copy (async proxy, at L2) after
// each writer's fence.proxy.async and a __syncthreads; wx, wh, b, x, h0,
// h_seq and c_seq, which it only reads, may take __ldg and cp.async.
// Every chunk keeps each sum's terms in the same order, so a streamed
// launch gives the whole one's bits, and the L2 layout's.
//
// Weights through L2 (lstm_seq_{fwd,bwd}_l2_kernel), for every shape the
// grid cannot hold either, streamed or not.  Nothing is copied for the gates: each gate
// column reads its weights with __ldg straight from the lane's wx (F, 4H),
// wh (H, 4H) and b at row stride 4H.  A block is S x G threads, S = H split
// into the fewest passes of at most 256 columns (kL2Threads: the registers
// of a thread's 4 rows x 4 gates of sums bound a block to 256 threads); a
// thread walks its columns j, j + S, ...  The block keeps in shared memory
// its state: the h tile(s), c (the backward: dh and dc), and the backward's
// dgates tile.  A dgates tile that does not fit there is written to the
// dgates output first and read back from it after a __syncthreads; a state
// that does not fit at all lies in a global scratch buffer, one region a
// block, that the wrapper allocates.  The backward's dh reads a pass's rows
// of wh kWhCols columns at a time through a double-buffered stage in shared
// memory (cp.async, a warp's copies consecutive), always in shared memory.
//
// Rounding: each gate sums the x-part over k with fmaf, the h-part over k
// with fmaf, then (x-part + h-part) + b, the plain version's order; dh sums
// over the 4H columns in ascending order with fmaf; expf and tanhf are the
// accurate ones (no --use_fast_math).  Every output element is summed by
// one thread in that order in all four layouts, which share the cell's
// elementwise code (cell_forward, cell_backward, whose fused products are
// written out, not left to the compiler), so they agree bit for bit on any
// shape two of them can run.  The backward recomputes the gates with the
// same function, so they are the forward's bit for bit.  fp32 FMA only: one
// TF32 product already breaks the 1e-5 limit against the plain version, so
// a wgmma / 3xTF32 design is left to a later change.
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "loaders.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;               // batch rows a thread owns (the grid layout: R = 4, 2, 1)
constexpr int kMaxShared = 232448;     // dynamic shared memory of an H100 block
constexpr int kL2Threads = 256;        // threads of a weights-through-L2 block
// the weights-through-L2 layout's modes (bits)
constexpr int kStateGlobal = 1;        // the block's state in the scratch buffer
constexpr int kDgatesOut = 2;          // the backward's dgates tile in the output
                                       // (also a mode of the cluster layout)
constexpr int kWhCols = 32;            // columns of wh a stage of the L2 backward's dh holds
constexpr int kMaxCluster = 16;        // blocks of a cluster (above 8: non-portable)
constexpr int kDgCols = 128;           // columns of dgates a stage of the grid backward's dh holds
// the grid layout's streaming modes (bits of its mode)
constexpr int kStreamH = 4;            // the h tile through a ring of kappa-row chunks
constexpr int kStreamWh = 8;           // the backward's rows J_q of wh beside each dgates chunk
constexpr int kStreamCols = 16;        // rows past rho of the columns from the packed copy
constexpr int kRing = 3;               // stages of the grid's ring

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

// The floats of the L2 backward's stage of wh: two halves of span rows of
// kWhCols columns at row stride kWhCols + 1 (conflict-free reads of one
// column at consecutive rows).
__host__ __device__ inline int l2_stage_floats(int span) { return 2 * span * (kWhCols + 1); }

// Copies wh[row0 + i, col0 + kk] (i < rows, kk < kWhCols, col0 + kk < h4)
// into stg[i (kWhCols + 1) + kk] with cp.async, consecutive threads on
// consecutive columns of a row; the caller commits the group.
__device__ __forceinline__ void stage_wh_chunk(float* stg, const float* __restrict__ wh,
                                               int row0, int rows, int col0, int h4) {
  for (int i = threadIdx.x; i < rows * kWhCols; i += blockDim.x) {
    const int r = i / kWhCols;
    const int kk = i - r * kWhCols;
    if (col0 + kk < h4)
      __pipeline_memcpy_async(stg + r * (kWhCols + 1) + kk,
                              wh + static_cast<size_t>(row0 + r) * h4 + col0 + kk, 4);
  }
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
template <int R>
__device__ __forceinline__ void tile_rows(int grp, int groups, int tile0, int batch,
                                          int (&rowl)[R], int (&rowg)[R],
                                          bool (&valid)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
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
  float* stage = smem + ((mode & kStateGlobal) ? 0 : round4(lo.total));
  const int stage_half = span * (kWhCols + 1);
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
    // in the shared-memory layout's order.  A pass's span rows of wh come
    // through the stage kWhCols columns at a time, the next chunk's copies
    // in flight while the block sums the current one
    const int chunks = (h4 + kWhCols - 1) / kWhCols;
    for (int p = 0; p * span < hidden; ++p) {
      const int row0 = p * span;
      const int rows = min(span, hidden - row0);
      const int j = j0 + row0;
      const float* wr = stage + j0 * (kWhCols + 1);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      stage_wh_chunk(stage, wh, row0, rows, 0, h4);
      __pipeline_commit();
      for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks)
          stage_wh_chunk(stage + ((c + 1) & 1) * stage_half, wh, row0, rows,
                         (c + 1) * kWhCols, h4);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        if (j < hidden) {
          const float* w = wr + (c & 1) * stage_half;
          const int col0 = c * kWhCols;
          const int n = min(kWhCols, h4 - col0);
          for (int kk = 0; kk < n; kk += 4) {
            const float w0 = w[kk], w1 = w[kk + 1], w2 = w[kk + 2], w3 = w[kk + 3];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 d = valid[r]
                  ? *reinterpret_cast<const float4*>(dgs + rowl[r] * h4 + col0 + kk)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
              acc[r] = fmaf(d.x, w0, acc[r]);
              acc[r] = fmaf(d.y, w1, acc[r]);
              acc[r] = fmaf(d.z, w2, acc[r]);
              acc[r] = fmaf(d.w, w3, acc[r]);
            }
          }
        }
        // the chunk after next lands in this half only after every thread
        // has summed it
        __syncthreads();
      }
      if (j < hidden) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) dhs[rowl[r] * lo.hs + j] = acc[r];
      }
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

// ---------------------------------------------------------------------------
// A lane's weights across a thread-block cluster
// ---------------------------------------------------------------------------

// Offsets (floats) of a cluster block's dynamic shared memory, each 16-byte
// aligned: its units' gate columns of [wx; wh] (F + H rows of Hc float4s,
// unit u's four gates in float4 u), their bias (Hc float4s), the h tile(s)
// of all H units and the x_t tile (stride F; two of each in the forward),
// and in the backward rows J_q of wh (4H / 4 column groups of Hc float4s:
// group c of unit u holds wh[j0 + u, 4c .. 4c + 3]) and, unless
// kDgatesOut, the step's (tile, 4H) dgates tile.  A warp's 32 units read
// 32 consecutive float4s at one row or column group: one instruction, no
// bank conflict.
struct ClusterLayout {
  int hc;        // units a block owns, ceil(H / C)
  int hs;        // row stride of an h tile, H rounded up to 4
  int b_off, h_off, x_off, wt_off, dg_off, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int f, int hidden, int cluster, int tile,
                                                        bool backward, int mode) {
  ClusterLayout l;
  l.hc = (hidden + cluster - 1) / cluster;
  l.hs = round4(hidden);
  l.b_off = (f + hidden) * 4 * l.hc;
  l.h_off = l.b_off + 4 * l.hc;
  l.x_off = l.h_off + (backward ? 1 : 2) * tile * l.hs;
  l.wt_off = l.x_off + (backward ? 1 : 2) * round4(tile * f);
  l.dg_off = l.wt_off + (backward ? l.hc * 4 * hidden : 0);
  l.total = l.dg_off + (backward && !(mode & kDgatesOut) ? tile * 4 * hidden : 0);
  return l;
}

// The cluster barrier in two halves: arrive releases this thread's writes
// (shared, distributed shared and global) to the cluster, wait returns once
// every thread of the cluster has arrived and acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The block's units j0 .. j0 + Hc - 1: component g of float4 k Hc + u of
// ws is column g H + j0 + u of row k of the lane's [wx; wh], of float4 u of
// bs b's; units past H are zero.  Consecutive threads read a gate's
// consecutive columns.  Rows from rho on go, in the same order, to the
// block's packed copy (row rho first) instead of ws.
__device__ void stage_columns(float* ws, float* bs, const float* __restrict__ wx,
                              const float* __restrict__ wh, const float* __restrict__ b,
                              int f, int hidden, int j0, int hc, int rho = 1 << 30,
                              float* packed = nullptr) {
  const int h4 = 4 * hidden;
  const int w = 4 * hc;
  const int n = (f + hidden) * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / w;
    const int lc = i - k * w;
    const int g = lc / hc;
    const int u = lc - g * hc;
    const int col = g * hidden + j0 + u;
    const float v = j0 + u >= hidden ? 0.f
        : k < f ? __ldg(wx + k * h4 + col) : __ldg(wh + static_cast<size_t>(k - f) * h4 + col);
    if (k < rho)
      ws[(k * hc + u) * 4 + g] = v;
    else
      packed[((k - rho) * hc + u) * 4 + g] = v;
  }
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int g = i / hc;
    const int u = i - g * hc;
    bs[u * 4 + g] = j0 + u < hidden ? __ldg(b + g * hidden + j0 + u) : 0.f;
  }
}

// The cluster layout's gate sums, preacts() in two parts with unit u's
// four gate weights of a row in one float4 (w4, Hc float4s a row): the
// x-part from the step's x tile in shared memory (gates_x_tile, row stride
// F, rows past the batch zero) and the h-part (gates_h).  The same sums in
// the same order, so the same bits.
template <int R>
__device__ __forceinline__ void gates_x_tile(const float* xs, const float4* w4, int f, int hc,
                                             int u, const int (&rowl)[R],
                                             float (&ax)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) ax[r][g] = 0.f;
  for (int k = 0; k < f; ++k) {
    const float4 w = w4[k * hc + u];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = xs[rowl[r] * f + k];
      ax[r][0] = fmaf(v, w.x, ax[r][0]);
      ax[r][1] = fmaf(v, w.y, ax[r][1]);
      ax[r][2] = fmaf(v, w.z, ax[r][2]);
      ax[r][3] = fmaf(v, w.w, ax[r][3]);
    }
  }
}

// n rows of the h-part, continuing the sums in ah: wr is unit u's float4
// of the first row (Hc float4s a row), ht the first of the n columns of the
// tile's h (row stride hs).
template <int R>
__device__ __forceinline__ void gates_h_rows(const float4* wr, const float* ht, int hs, int n,
                                             int hc, const int (&rowl)[R], float (&ah)[R][4]) {
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= n; k += 4) {
    float4 hv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      hv[r] = *reinterpret_cast<const float4*>(ht + rowl[r] * hs + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = wr[(k + kk) * hc];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y : kk == 2 ? hv[r].z : hv[r].w;
        ah[r][0] = fmaf(v, w.x, ah[r][0]);
        ah[r][1] = fmaf(v, w.y, ah[r][1]);
        ah[r][2] = fmaf(v, w.z, ah[r][2]);
        ah[r][3] = fmaf(v, w.w, ah[r][3]);
      }
    }
  }
  for (; k < n; ++k) {
    const float4 w = wr[k * hc];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = ht[rowl[r] * hs + k];
      ah[r][0] = fmaf(v, w.x, ah[r][0]);
      ah[r][1] = fmaf(v, w.y, ah[r][1]);
      ah[r][2] = fmaf(v, w.z, ah[r][2]);
      ah[r][3] = fmaf(v, w.w, ah[r][3]);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero_sums(float (&a)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) a[r][g] = 0.f;
}

template <int R>
__device__ __forceinline__ void gates_h(const float4* w4, const float* ht, int hs, int f,
                                        int hidden, int hc, int u, const int (&rowl)[R],
                                        float (&ah)[R][4]) {
  zero_sums(ah);
  gates_h_rows(w4 + f * hc + u, ht, hs, hidden, hc, rowl, ah);
}

// Copies the tile's rows of a (B, width) array into dst (row stride ds) with
// cp.async, consecutive threads on consecutive elements; the caller
// commits.  Rows past the batch are not written (zero_tile_tail).
__device__ __forceinline__ void stage_tile_async(float* dst, const float* __restrict__ src,
                                                 int tile0, int tile, int batch, int width,
                                                 int ds) {
  const int rows = min(tile, batch - tile0);
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int bl = i / width;
    const int k = i - bl * width;
    __pipeline_memcpy_async(dst + bl * ds + k,
                            src + static_cast<size_t>(tile0 + bl) * width + k, 4);
  }
}

// Zeroes the rows of a tile (row stride ds, width columns) past the batch.
__device__ void zero_tile_tail(float* dst, int tile0, int tile, int batch, int width, int ds) {
  const int rows = min(tile, batch - tile0);
  for (int i = threadIdx.x; i < (tile - rows) * width; i += blockDim.x) {
    const int bl = rows + i / width;
    dst[bl * ds + i % width] = 0.f;
  }
}

// The forward across a cluster.  Block q (its rank) of the cluster of tile
// blockIdx.x / C owns units q Hc + u; thread (u, grp) of its Hc x G owns
// unit j = q Hc + u of rows grp + G r, its c in registers.  Each step it
// writes its h_{t+1} into the next h tile of every block of the cluster.
__global__ void __launch_bounds__(kL2Threads)
    lstm_seq_fwd_cluster_kernel(SeqArgs a, const float* __restrict__ h0,
                                const float* __restrict__ c0, int h0_ls, int c0_ls,
                                float* __restrict__ h_out, float* __restrict__ c_out, int save,
                                int cluster) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int q = static_cast<int>(cl.block_rank());
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int tile = a.groups * kRows;
  const ClusterLayout lo = cluster_layout(f, hidden, cluster, tile, false, 0);
  float* ws = smem;
  float* bs = smem + lo.b_off;
  float* hbuf = smem + lo.h_off;
  float* xbuf = smem + lo.x_off;
  const int xt_size = round4(tile * f);
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  h0 += static_cast<size_t>(lane) * h0_ls;
  c0 += static_cast<size_t>(lane) * c0_ls;
  stage_columns(ws, bs, a.wx + static_cast<size_t>(lane) * a.wx_ls,
                a.wh + static_cast<size_t>(lane) * a.wh_ls,
                a.b + static_cast<size_t>(lane) * a.b_ls, f, hidden, q * lo.hc, lo.hc);

  const int u = threadIdx.x % lo.hc;
  const int grp = threadIdx.x / lo.hc;
  const int j = q * lo.hc + u;
  const bool live = j < hidden;
  const int tile0 = (blockIdx.x / cluster) * tile;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t out_lane = save ? (steps + 1) * bh : bh;
  h_out += lane * out_lane;
  c_out += lane * out_lane;
  int rowl[kRows], rowg[kRows];
  bool valid[kRows];
  tile_rows(grp, a.groups, tile0, batch, rowl, rowg, valid);
  // h0's tile, and each step's x tile a step ahead into the other half, by
  // cp.async
  zero_tile_tail(hbuf, tile0, tile, batch, hidden, lo.hs);
  zero_tile_tail(xbuf, tile0, tile, batch, f, f);
  zero_tile_tail(xbuf + xt_size, tile0, tile, batch, f, f);
  stage_tile_async(hbuf, h0, tile0, tile, batch, hidden, lo.hs);
  stage_tile_async(xbuf, x, tile0, tile, batch, f, f);
  __pipeline_commit();
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t o = static_cast<size_t>(rowg[r]) * hidden + j;
    c[r] = live && valid[r] ? __ldg(c0 + o) : 0.f;
    if (save && live && valid[r]) {
      h_out[o] = __ldg(h0 + o);
      c_out[o] = c[r];
    }
  }
  // every block of the cluster has started and staged before any writes
  // into its h tiles; the first step's x-part meanwhile
  __pipeline_wait_prior(0);
  __syncthreads();
  float ax[kRows][4];
  cluster_arrive();
  gates_x_tile(xbuf, w4, f, lo.hc, u, rowl, ax);
  cluster_wait();

  for (int t = 0; t < steps; ++t) {
    const float* ht = hbuf + (t & 1) * tile * lo.hs;
    const int next = ((t + 1) & 1) * tile * lo.hs;
    float* xn = xbuf + ((t + 1) & 1) * xt_size;
    if (t + 1 < steps) {
      // the half every thread of the block last read before the previous
      // step's __syncthreads
      stage_tile_async(xn, x + static_cast<size_t>(t + 1) * batch * f, tile0, tile, batch, f, f);
      __pipeline_commit();
    }
    float ah[kRows][4];
    gates_h(w4, ht, lo.hs, f, hidden, lo.hc, u, rowl, ah);
    const float4 bu = reinterpret_cast<const float4*>(bs)[u];
    float hv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pre[4] = {ax[r][0] + ah[r][0] + bu.x, ax[r][1] + ah[r][1] + bu.y,
                            ax[r][2] + ah[r][2] + bu.z, ax[r][3] + ah[r][3] + bu.w};
      hv[r] = cell_forward(pre, c[r]);
    }
    if (t + 1 < steps && live) {
      for (int rank = 0; rank < cluster; ++rank) {
        float* hn = cl.map_shared_rank(hbuf, rank) + next;
#pragma unroll
        for (int r = 0; r < kRows; ++r) hn[rowl[r] * lo.hs + j] = valid[r] ? hv[r] : 0.f;
      }
    }
    // the next step reads h_{t+1} once every block has written its units;
    // its writes go to the tile this step read, which every block has
    // finished reading once it arrives.  The outputs are stored after the
    // arrive, whose release then waits for the remote writes alone
    if (t + 1 < steps) cluster_arrive();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (live && valid[r] && (save || t == steps - 1)) {
        const size_t o = (save ? (t + 1) * bh : 0) + static_cast<size_t>(rowg[r]) * hidden + j;
        h_out[o] = hv[r];
        c_out[o] = c[r];
      }
    }
    if (t + 1 == steps) break;
    __pipeline_wait_prior(0);
    __syncthreads();
    gates_x_tile(xn, w4, f, lo.hc, u, rowl, ax);
    cluster_wait();
  }
}

// The thread's c_t and c_{t+1} of step t (its unit, its rows of the batch)
// from c_seq (T + 1, B, H).
template <int R>
__device__ __forceinline__ void load_c(float (&c_prev)[R], float (&c_new)[R],
                                       const float* __restrict__ c_seq, int t, size_t bh,
                                       const int (&rowg)[R], const bool (&valid)[R],
                                       bool live, int j, int hidden) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t o = static_cast<size_t>(rowg[r]) * hidden + j;
    const bool in = live && valid[r];
    c_prev[r] = in ? __ldg(c_seq + t * bh + o) : 0.f;
    c_new[r] = in ? __ldg(c_seq + (t + 1) * bh + o) : 0.f;
  }
}

// The thread's dgates of one step into the output (its unit's four gate
// columns of each of its rows in the batch).
template <int R>
__device__ __forceinline__ void store_dgates(float* dgt, const float (&d)[R][4],
                                             const int (&rowg)[R], const bool (&valid)[R],
                                             bool live, int j, int hidden) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!(live && valid[r])) continue;
    float* grow = dgt + static_cast<size_t>(rowg[r]) * 4 * hidden + j;
    grow[0] = d[r][0];
    grow[hidden] = d[r][1];
    grow[2 * hidden] = d[r][2];
    grow[3 * hidden] = d[r][3];
  }
}

// The backward across a cluster; blocks and threads as in the forward.  A
// block recomputes its units' gates from the staged h_t and x_t tiles,
// forms their dgates, and publishes them: into every block's dgates tile
// (between two barriers: the one before the writes lets every block finish
// reading the previous step's tile), or under kDgatesOut only into the
// dgates output.  After one barrier each block forms dh for its own units
// from the whole tile and rows J_q of wh.
__global__ void __launch_bounds__(kL2Threads)
    lstm_seq_bwd_cluster_kernel(SeqArgs a, const float* __restrict__ h_seq,
                                const float* __restrict__ c_seq,
                                const float* __restrict__ dh_last,
                                const float* __restrict__ dc_last, float* dgates,
                                float* __restrict__ dh0, float* __restrict__ dc0, int cluster,
                                int mode) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int q = static_cast<int>(cl.block_rank());
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int h4 = 4 * hidden;
  const int tile = a.groups * kRows;
  const bool dg_out = mode & kDgatesOut;
  const ClusterLayout lo = cluster_layout(f, hidden, cluster, tile, true, mode);
  float* ws = smem;
  float* bs = smem + lo.b_off;
  float* hbuf = smem + lo.h_off;
  float* xs = smem + lo.x_off;
  float* wt = smem + lo.wt_off;
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  const float* wh = a.wh + static_cast<size_t>(lane) * a.wh_ls;
  const int j0 = q * lo.hc;
  stage_columns(ws, bs, a.wx + static_cast<size_t>(lane) * a.wx_ls, wh,
                a.b + static_cast<size_t>(lane) * a.b_ls, f, hidden, j0, lo.hc);
  // rows j0 .. j0 + Hc - 1 of wh, all 4H columns, by groups of 4 columns
  for (int i = threadIdx.x; i < lo.hc * h4; i += blockDim.x) {
    const int uu = i / h4;
    const int col = i - uu * h4;
    wt[((col >> 2) * lo.hc + uu) * 4 + (col & 3)] =
        j0 + uu < hidden ? __ldg(wh + static_cast<size_t>(j0 + uu) * h4 + col) : 0.f;
  }
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const float4* wt4 = reinterpret_cast<const float4*>(wt);

  const int u = threadIdx.x % lo.hc;
  const int grp = threadIdx.x / lo.hc;
  const int j = j0 + u;
  const bool live = j < hidden;
  const int tile0 = (blockIdx.x / cluster) * tile;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  h_seq += lane * (steps + 1) * bh;
  c_seq += lane * (steps + 1) * bh;
  dgates += lane * static_cast<size_t>(steps) * batch * h4;
  int rowl[kRows], rowg[kRows];
  bool valid[kRows];
  tile_rows(grp, a.groups, tile0, batch, rowl, rowg, valid);
  float dh[kRows], dc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
    dh[r] = live && valid[r] ? __ldg(dh_last + o) : 0.f;
    dc[r] = live && valid[r] ? __ldg(dc_last + o) : 0.f;
  }
  // the step's h_t and x_t tiles come by cp.async, each issued a step ahead
  // (after the barrier past which no thread of the block reads them)
  zero_tile_tail(hbuf, tile0, tile, batch, hidden, lo.hs);
  zero_tile_tail(xs, tile0, tile, batch, f, f);
  stage_tile_async(hbuf, h_seq + (steps - 1) * bh, tile0, tile, batch, hidden, lo.hs);
  stage_tile_async(xs, x + static_cast<size_t>(steps - 1) * batch * f, tile0, tile, batch, f, f);
  __pipeline_commit();
  // the block has started, and (the first step's wait) every block has
  // before any writes into its dgates tile
  if (!dg_out) cluster_arrive();

  // the step's c_t and c_{t+1}, loaded a step ahead too
  float c_prev[kRows], c_new[kRows];
  load_c(c_prev, c_new, c_seq, steps - 1, bh, rowg, valid, live, j, hidden);

  for (int t = steps - 1; t >= 0; --t) {
    __pipeline_wait_prior(0);
    __syncthreads();
    float pre[kRows][4];
    {
      float ax[kRows][4], ah[kRows][4];
      gates_x_tile(xs, w4, f, lo.hc, u, rowl, ax);
      gates_h(w4, hbuf, lo.hs, f, hidden, lo.hc, u, rowl, ah);
      const float4 bu = reinterpret_cast<const float4*>(bs)[u];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pre[r][0] = ax[r][0] + ah[r][0] + bu.x;
        pre[r][1] = ax[r][1] + ah[r][1] + bu.y;
        pre[r][2] = ax[r][2] + ah[r][2] + bu.z;
        pre[r][3] = ax[r][3] + ah[r][3] + bu.w;
      }
    }
    float* dgt = dgates + static_cast<size_t>(t) * batch * h4;
    float d[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      cell_backward(pre[r], c_prev[r], c_new[r], dh[r], dc[r], d[r]);
    if (t > 0) load_c(c_prev, c_new, c_seq, t - 1, bh, rowg, valid, live, j, hidden);
    const float* dgs = smem + lo.dg_off;
    if (dg_out) {
      // rows past the batch are not in the output: only valid rows are read
      dgs = dgt + static_cast<size_t>(tile0) * h4;
      store_dgates(dgt, d, rowg, valid, live, j, hidden);
    } else {
      cluster_wait();
      if (live) {
        for (int rank = 0; rank < cluster; ++rank) {
          float* dst = cl.map_shared_rank(smem + lo.dg_off, rank);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float* drow = dst + rowl[r] * h4 + j;
            drow[0] = d[r][0];
            drow[hidden] = d[r][1];
            drow[2 * hidden] = d[r][2];
            drow[3 * hidden] = d[r][3];
          }
        }
      }
    }
    cluster_arrive();
    // the output's copy goes after the arrive, whose release then waits for
    // the remote writes alone
    if (!dg_out) store_dgates(dgt, d, rowg, valid, live, j, hidden);
    cluster_wait();
    // every thread of the block is past its reads of this step's h and x
    // tiles: the next step's copies go in flight during the reduction
    if (t > 0) {
      stage_tile_async(hbuf, h_seq + (t - 1) * bh, tile0, tile, batch, hidden, lo.hs);
      stage_tile_async(xs, x + static_cast<size_t>(t - 1) * batch * f, tile0, tile, batch, f, f);
      __pipeline_commit();
    }
    // dh_t[b, j] = sum over the 4H gate columns of dgates_t[b, col] wh[j, col],
    // in the shared-memory layout's order
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int col = 0; col < h4; col += 4) {
      const float4 w = wt4[(col >> 2) * lo.hc + u];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 dv = !dg_out || valid[r]
            ? *reinterpret_cast<const float4*>(dgs + rowl[r] * h4 + col)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[r] = fmaf(dv.x, w.x, acc[r]);
        acc[r] = fmaf(dv.y, w.y, acc[r]);
        acc[r] = fmaf(dv.z, w.z, acc[r]);
        acc[r] = fmaf(dv.w, w.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) dh[r] = acc[r];
    // this block has read its dgates tile: the next step's writes into it
    // wait for this arrive
    if (!dg_out) cluster_arrive();
  }
  if (!dg_out) cluster_wait();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!(live && valid[r])) continue;
    const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
    dh0[o] = dh[r];
    dc0[o] = dc[r];
  }
}

// ---------------------------------------------------------------------------
// A lane's weights across the whole card
// ---------------------------------------------------------------------------

// Offsets (floats) of a grid block's dynamic shared memory, each 16-byte
// aligned: its units' gate columns and bias as in the cluster layout (under
// kStreamCols only rows [0, rho) of the columns); the tile's h over all H
// units (row stride hs: H rounded up to 4, plus 4, so that the 8 rows a warp
// reads at one k fall in 8 different bank groups) or, under kStreamH, the
// ring's kRing stages of kappa of its columns (row stride kappa + 4, for the
// same reason); the x_t tile(s) (two in the forward); in the backward rows
// J_q of wh (as the cluster's; not under kStreamWh) and the two halves of
// the stage of the step's dgates (tile rows of kDgCols columns at row stride
// kDgCols + 4, then, under kStreamWh, Hc rows of wh's same columns); under
// kStreamCols the ring's stages of kappa streamed rows of the columns (Hc
// float4s a row) and their kRing mbarriers.
struct GridLayout {
  int hc;        // units a block owns, ceil(H / K)
  int hs;        // row stride of the h tile, or of a ring stage
  int xs;        // row stride of the forward's exchange buffer, H rounded up to 4, plus 4
  int rho;       // rows of [wx; wh] the block holds: F + H unless kStreamCols
  int b_off, h_off, x_off, wt_off, dg_off, wr_off, bar_off, total;
};

__host__ __device__ inline GridLayout grid_layout(int f, int hidden, int blocks, int tile,
                                                  bool backward, int mode = 0, int kappa = 0,
                                                  int rho = 0) {
  GridLayout l;
  const bool sh = mode & kStreamH;
  const bool cols = mode & kStreamCols;
  const bool whs = backward && (mode & kStreamWh);
  l.hc = (hidden + blocks - 1) / blocks;
  l.xs = round4(hidden) + 4;
  l.hs = sh ? kappa + 4 : l.xs;
  l.rho = cols ? rho : f + hidden;
  l.b_off = l.rho * 4 * l.hc;
  l.h_off = l.b_off + 4 * l.hc;
  l.x_off = l.h_off + (sh ? kRing : 1) * tile * l.hs;
  l.wt_off = l.x_off + (backward ? 1 : 2) * round4(tile * f);
  l.dg_off = l.wt_off + (backward && !whs ? l.hc * 4 * hidden : 0);
  l.wr_off = l.dg_off + (backward ? 2 * (tile + (whs ? l.hc : 0)) * (kDgCols + 4) : 0);
  l.bar_off = l.wr_off + (cols ? kRing * kappa * 4 * l.hc : 0);
  l.total = l.bar_off + (cols ? round4(2 * kRing) : 0);
  return l;
}

// A mode the grid kernels take: 0, or kStreamH alone or with kStreamWh (the
// backward's) and kStreamCols; under kStreamH kappa a positive multiple of
// 4; under kStreamCols F <= rho < F + H and rho - F a multiple of kappa, so
// that a chunk's rows are all held or all streamed.
__host__ inline bool grid_mode_ok(int f, int hidden, int mode, int kappa, int rho,
                                  bool backward) {
  if (mode & ~(kStreamH | kStreamWh | kStreamCols)) return false;
  if (!(mode & kStreamH)) return mode == 0;
  if (((mode & kStreamWh) && !backward) || kappa < 4 || (kappa & 3)) return false;
  return !(mode & kStreamCols) || (rho >= f && rho < f + hidden && (rho - f) % kappa == 0);
}

// The barrier of a lane's K blocks (one batch tile's), on an arrival
// counter in global memory that starts at 0 and grows by K a step.  The
// caller's __syncthreads() precedes grid_arrive, so the fence of thread 0
// then releases every write the block made before it (the pattern of
// cooperative_groups' grid sync); grid_wait returns to every thread of the
// block once the counter reaches target.  Only a cooperative launch, whose
// blocks are all resident at once, may spin on it.
__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(counter), "r"(1u)
                 : "memory");
  }
}

__device__ __forceinline__ void grid_wait(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

// stage_tile_async by 16-byte copies where the rows allow it (width and ds
// multiples of 4, src 16-byte aligned: a uniform branch), else by 4-byte
// ones: the grid layout's h tiles, a (tile, H) block of an input.
__device__ __forceinline__ void stage_tile_async_wide(float* dst, const float* __restrict__ src,
                                                      int tile0, int tile, int batch, int width,
                                                      int ds) {
  if ((width & 3) || (ds & 3) || (reinterpret_cast<uintptr_t>(src) & 15)) {
    stage_tile_async(dst, src, tile0, tile, batch, width, ds);
    return;
  }
  const int rows = min(tile, batch - tile0);
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < rows * w4; i += blockDim.x) {
    const int bl = i / w4;
    const int k = 4 * (i - bl * w4);
    __pipeline_memcpy_async(dst + bl * ds + k,
                            src + static_cast<size_t>(tile0 + bl) * width + k, 16);
  }
}

// 16 bytes from global to shared memory by cp.async.cg, which reads at L2
// and never through L1: the reads of what other blocks of the launch wrote
// (never __ldg or any other load that L1 may have kept from before).  The
// caller commits the group.
__device__ __forceinline__ void copy_cg16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Calls f(r, c) for i = threadIdx.x, threadIdx.x + blockDim.x, ... below
// rows x w, with r = i / w and c = i % w, dividing once: the copies of a
// ring's or a stage's chunk, issued every chunk, spend no division each.
template <typename F>
__device__ __forceinline__ void for_tile(int rows, int w, F f) {
  const int dr = blockDim.x / w;
  const int dc = blockDim.x - dr * w;
  int r = threadIdx.x / w;
  int c = threadIdx.x - r * w;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The ring's mbarriers: one arrival (the thread that issues a stage's bulk
// copy, with the copy's bytes) completes a phase.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// One TMA bulk copy of bytes (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on bar.  It reads in the async
// proxy, at L2: what the launch wrote there must be fenced first
// (fence_proxy_async by each writer, then the __syncthreads before the
// issue).
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A step's h-part through the ring (kStreamH): chunk c is columns [c kappa,
// c kappa + n) of the tile's h, its valid rows copied by cp.async.cg into
// stage c % kRing, and, under kStreamCols where rows F + c kappa on of
// [wx; wh] are past rho, those rows of the block's columns, one bulk copy
// of its packed copy on the stage's mbarrier.  Chunks go in ascending k,
// so each gate's h-part is the same fmaf chain as with the whole tile.
struct Ring {
  float* h;                  // stage 0 of the h chunks, tile x hs floats a stage
  float* w;                  // stage 0 of the streamed rows, kappa x Hc float4s a stage
  unsigned long long* bar;   // the stages' mbarriers
  float* packed;             // the block's packed copy (row rho first), or nullptr
  int tile, hs, kappa, rho, f, hidden, hc, chunks;
  bool cols;
};

__device__ __forceinline__ Ring make_ring(float* smem, const GridLayout& lo, int mode, int tile,
                                          int f, int hidden, int kappa, float* packed) {
  Ring g;
  g.h = smem + lo.h_off;
  g.w = smem + lo.wr_off;
  g.bar = reinterpret_cast<unsigned long long*>(smem + lo.bar_off);
  g.cols = mode & kStreamCols;
  // one region a block of the launch
  g.packed = g.cols ? packed + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                                   (f + hidden - lo.rho) * 4 * lo.hc
                    : nullptr;
  g.tile = tile;
  g.hs = lo.hs;
  g.kappa = kappa;
  g.rho = lo.rho;
  g.f = f;
  g.hidden = hidden;
  g.hc = lo.hc;
  g.chunks = (mode & kStreamH) ? (hidden + kappa - 1) / kappa : 0;
  return g;
}

// Issues chunk c from src (the tile's row 0 of h at column 0, row stride
// ss; rows past `rows` are never copied).  16-byte copies where the rows
// allow (always for the exchange buffer, whose row stride is a multiple of
// 4 with pad columns past H), else 4-byte ones (h0 or h_seq at H % 4 != 0,
// which the launch only reads).  The caller commits.
__device__ __forceinline__ void ring_issue(const Ring& g, const float* src, int ss, int rows,
                                           int c) {
  const int slot = c % kRing;
  const int k0 = c * g.kappa;
  const int n = min(g.kappa, g.hidden - k0);
  float* dst = g.h + slot * g.tile * g.hs;
  src += k0;
  if (!(ss & 3) && !(reinterpret_cast<uintptr_t>(src) & 15)) {
    for_tile(rows, (n + 3) >> 2, [&](int r, int k4) {
      copy_cg16(dst + r * g.hs + 4 * k4, src + static_cast<size_t>(r) * ss + 4 * k4);
    });
  } else {
    for_tile(rows, n, [&](int r, int k) {
      __pipeline_memcpy_async(dst + r * g.hs + k, src + static_cast<size_t>(r) * ss + k, 4);
    });
  }
  if (g.cols && threadIdx.x == 0 && g.f + k0 >= g.rho)
    bulk_load(g.w + slot * g.kappa * 4 * g.hc,
              g.packed + static_cast<size_t>(g.f + k0 - g.rho) * 4 * g.hc,
              static_cast<unsigned>(n * g.hc * 16), g.bar + slot);
}

// The ring's first kRing - 1 chunks, a commit group each (copies the
// caller issued before join the first).
__device__ __forceinline__ void ring_start(const Ring& g, const float* src, int ss, int rows) {
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < g.chunks) ring_issue(g, src, ss, rows, c);
    __pipeline_commit();
  }
}

// Sums the step's h-part into ah chunk by chunk, after ring_start from the
// same src: at chunk c, once it has landed and every thread is past chunk c
// - 1 (one __syncthreads), chunk c + kRing - 1 goes in flight into c - 1's
// stage.  parity holds a bit a stage: the phase of its mbarrier this thread
// waits on next.  On return the last chunk's stage is still being read: the
// caller passes a __syncthreads before the next ring_start.
template <int R>
__device__ __forceinline__ void ring_sum(const Ring& g, const float* src, int ss, int rows,
                                         const float4* w4, int u, const int (&rowl)[R],
                                         float (&ah)[R][4], unsigned& parity) {
  for (int c = 0; c < g.chunks; ++c) {
    __pipeline_wait_prior(kRing - 2);
    __syncthreads();
    if (c + kRing - 1 < g.chunks) ring_issue(g, src, ss, rows, c + kRing - 1);
    __pipeline_commit();
    const int slot = c % kRing;
    const int k0 = c * g.kappa;
    const float4* wr = w4 + (g.f + k0) * g.hc + u;
    if (g.cols && g.f + k0 >= g.rho) {
      mbar_wait(g.bar + slot, (parity >> slot) & 1u);
      parity ^= 1u << slot;
      wr = reinterpret_cast<const float4*>(g.w + slot * g.kappa * 4 * g.hc) + u;
    }
    gates_h_rows(wr, g.h + slot * g.tile * g.hs, g.hs, min(g.kappa, g.hidden - k0), g.hc, rowl,
                 ah);
  }
}

// After stage_columns: under kStreamCols each thread fences the packed rows
// it wrote (they are read by bulk copies, in the async proxy), and thread 0
// initialises the ring's mbarriers; a __syncthreads follows before the
// first issue.
__device__ __forceinline__ void ring_init(const Ring& g) {
  if (!g.cols) return;
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(g.bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Zeroes the rows past the batch in every stage of the ring (never copied).
__device__ __forceinline__ void ring_zero_tails(const Ring& g, int tile0, int batch) {
  for (int s = 0; s < kRing; ++s)
    zero_tile_tail(g.h + s * g.tile * g.hs, tile0, g.tile, batch, g.kappa, g.hs);
}

// The forward across the card.  Blocks (q, tile) = (blockIdx.x % K,
// blockIdx.x / K) of lane blockIdx.y; block q owns units q Hc + u as in the
// cluster layout, thread (u, grp) of its Hc x G keeps their c in
// registers.  Each step it writes its h_{t+1} (zero in rows past the
// batch) into the lane's exchange buffer, two (tile, xs) halves a tile,
// passes the barrier of the tile's K blocks (the next x-part summed
// between arrive and wait), and copies the whole h_{t+1} tile back by
// cp.async.cg, or under kStreamH starts the ring on it.  Both grid kernels
// are bounded to one block an SM, as the plan lays them out: left to its
// default the compiler held the R = 2 forward to 64 registers, spilling,
// and it ran 1.25x slower at H = 1,100 (kernel_bench.py --lstm, same bits).
template <int R>
__global__ void __launch_bounds__(kL2Threads, 1)
    lstm_seq_fwd_grid_kernel(SeqArgs a, const float* __restrict__ h0,
                             const float* __restrict__ c0, int h0_ls, int c0_ls,
                             float* __restrict__ h_out, float* __restrict__ c_out, int save,
                             int blocks, float* xchg, unsigned* sync, int mode, int kappa,
                             int rho, float* packed) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x % blocks;
  const int tix = blockIdx.x / blocks;
  const int tiles = gridDim.x / blocks;
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int tile = a.groups * R;
  const GridLayout lo = grid_layout(f, hidden, blocks, tile, false, mode, kappa, rho);
  const bool sh = mode & kStreamH;
  float* ws = smem;
  float* bs = smem + lo.b_off;
  float* hbuf = smem + lo.h_off;
  float* xbuf = smem + lo.x_off;
  const int xt_size = round4(tile * f);
  const int part = tile * lo.xs;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  h0 += static_cast<size_t>(lane) * h0_ls;
  c0 += static_cast<size_t>(lane) * c0_ls;
  float* xg = xchg + (static_cast<size_t>(lane) * tiles + tix) * 2 * part;
  unsigned* counter = sync + lane * tiles + tix;
  const Ring ring = make_ring(smem, lo, mode, tile, f, hidden, kappa, packed);
  stage_columns(ws, bs, a.wx + static_cast<size_t>(lane) * a.wx_ls,
                a.wh + static_cast<size_t>(lane) * a.wh_ls,
                a.b + static_cast<size_t>(lane) * a.b_ls, f, hidden, q * lo.hc, lo.hc, lo.rho,
                ring.packed);
  ring_init(ring);

  const int u = threadIdx.x % lo.hc;
  const int grp = threadIdx.x / lo.hc;
  const int j = q * lo.hc + u;
  const bool live = j < hidden;
  const int tile0 = tix * tile;
  const int rows = min(tile, batch - tile0);
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t out_lane = save ? (steps + 1) * bh : bh;
  h_out += lane * out_lane;
  c_out += lane * out_lane;
  int rowl[R], rowg[R];
  bool valid[R];
  tile_rows(grp, a.groups, tile0, batch, rowl, rowg, valid);
  if (sh)
    ring_zero_tails(ring, tile0, batch);
  else
    zero_tile_tail(hbuf, tile0, tile, batch, hidden, lo.hs);
  zero_tile_tail(xbuf, tile0, tile, batch, f, f);
  zero_tile_tail(xbuf + xt_size, tile0, tile, batch, f, f);
  if (!sh) stage_tile_async_wide(hbuf, h0, tile0, tile, batch, hidden, lo.hs);
  stage_tile_async(xbuf, x, tile0, tile, batch, f, f);
  __pipeline_commit();
  float c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t o = static_cast<size_t>(rowg[r]) * hidden + j;
    c[r] = live && valid[r] ? __ldg(c0 + o) : 0.f;
    if (save && live && valid[r]) {
      h_out[o] = __ldg(h0 + o);
      c_out[o] = c[r];
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  float ax[R][4];
  gates_x_tile(xbuf, w4, f, lo.hc, u, rowl, ax);
  unsigned parity = 0;
  const float* h0t = h0 + static_cast<size_t>(tile0) * hidden;
  if (sh) ring_start(ring, h0t, hidden, rows);

  for (int t = 0; t < steps; ++t) {
    float* xn = xbuf + ((t + 1) & 1) * xt_size;
    float* hx = xg + ((t + 1) & 1) * part;
    if (t + 1 < steps) {
      // the half every thread of the block last read two steps ago
      stage_tile_async(xn, x + static_cast<size_t>(t + 1) * batch * f, tile0, tile, batch, f, f);
      __pipeline_commit();
    }
    float ah[R][4];
    if (sh) {
      zero_sums(ah);
      if (t == 0)
        ring_sum(ring, h0t, hidden, rows, w4, u, rowl, ah, parity);
      else
        ring_sum(ring, xg + (t & 1) * part, lo.xs, rows, w4, u, rowl, ah, parity);
    } else {
      gates_h(w4, hbuf, lo.hs, f, hidden, lo.hc, u, rowl, ah);
    }
    const float4 bu = reinterpret_cast<const float4*>(bs)[u];
    float hv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pre[4] = {ax[r][0] + ah[r][0] + bu.x, ax[r][1] + ah[r][1] + bu.y,
                            ax[r][2] + ah[r][2] + bu.z, ax[r][3] + ah[r][3] + bu.w};
      hv[r] = cell_forward(pre, c[r]);
    }
    if (t + 1 < steps && live) {
#pragma unroll
      for (int r = 0; r < R; ++r) hx[rowl[r] * lo.xs + j] = valid[r] ? hv[r] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (live && valid[r] && (save || t == steps - 1)) {
        const size_t o = (save ? (t + 1) * bh : 0) + static_cast<size_t>(rowg[r]) * hidden + j;
        h_out[o] = hv[r];
        c_out[o] = c[r];
      }
    }
    if (t + 1 == steps) break;
    // every thread is past its reads of the h tile (or the ring) and has
    // written its h_{t+1}; the half of the exchange written here is next
    // written two steps on, after every block has passed the next barrier
    // and so copied this one
    __pipeline_wait_prior(0);
    __syncthreads();
    grid_arrive(counter);
    gates_x_tile(xn, w4, f, lo.hc, u, rowl, ax);
    grid_wait(counter, static_cast<unsigned>(blocks) * (t + 1));
    if (sh) {
      ring_start(ring, hx, lo.xs, rows);
    } else {
      for (int i = 4 * threadIdx.x; i < part; i += 4 * blockDim.x) copy_cg16(hbuf + i, hx + i);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  }
}

// The backward across the card; blocks and threads as in the forward.  A
// block recomputes its units' gates from the h_t and x_t tiles (copied a
// step ahead; under kStreamH h_t through the ring, its first chunks issued
// a step ahead), forms their dgates and writes them to the dgates output,
// passes the tile's barrier, and forms dh for its own units from rows J_q
// of wh and the step's whole dgates tile, streamed from L2 by cp.async.cg
// through a double-buffered stage of kDgCols columns (under kStreamWh with
// rows J_q's same columns beside them).  Each step has its own slice of
// dgates, so one barrier a step is enough.
template <int R>
__global__ void __launch_bounds__(kL2Threads, 1)
    lstm_seq_bwd_grid_kernel(SeqArgs a, const float* __restrict__ h_seq,
                             const float* __restrict__ c_seq,
                             const float* __restrict__ dh_last,
                             const float* __restrict__ dc_last, float* dgates,
                             float* __restrict__ dh0, float* __restrict__ dc0, int blocks,
                             unsigned* sync, int mode, int kappa, int rho, float* packed) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x % blocks;
  const int tix = blockIdx.x / blocks;
  const int tiles = gridDim.x / blocks;
  const int lane = blockIdx.y;
  const int f = a.f, hidden = a.hidden, batch = a.batch, steps = a.steps;
  const int h4 = 4 * hidden;
  const int tile = a.groups * R;
  const GridLayout lo = grid_layout(f, hidden, blocks, tile, true, mode, kappa, rho);
  const bool sh = mode & kStreamH;
  const bool whs = mode & kStreamWh;
  constexpr int ds = kDgCols + 4;
  float* ws = smem;
  float* bs = smem + lo.b_off;
  float* hbuf = smem + lo.h_off;
  float* xs = smem + lo.x_off;
  float* wt = smem + lo.wt_off;
  float* stg = smem + lo.dg_off;
  const int half = (tile + (whs ? lo.hc : 0)) * ds;
  const float* x = a.x + static_cast<size_t>(lane) * a.x_ls;
  const float* wh = a.wh + static_cast<size_t>(lane) * a.wh_ls;
  unsigned* counter = sync + lane * tiles + tix;
  const int j0 = q * lo.hc;
  const int units = min(lo.hc, hidden - j0);
  const Ring ring = make_ring(smem, lo, mode, tile, f, hidden, kappa, packed);
  stage_columns(ws, bs, a.wx + static_cast<size_t>(lane) * a.wx_ls, wh,
                a.b + static_cast<size_t>(lane) * a.b_ls, f, hidden, j0, lo.hc, lo.rho,
                ring.packed);
  if (!whs) {
    for (int i = threadIdx.x; i < lo.hc * h4; i += blockDim.x) {
      const int uu = i / h4;
      const int col = i - uu * h4;
      wt[((col >> 2) * lo.hc + uu) * 4 + (col & 3)] =
          j0 + uu < hidden ? __ldg(wh + static_cast<size_t>(j0 + uu) * h4 + col) : 0.f;
    }
  }
  ring_init(ring);
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const float4* wt4 = reinterpret_cast<const float4*>(wt);

  const int u = threadIdx.x % lo.hc;
  const int grp = threadIdx.x / lo.hc;
  const int j = j0 + u;
  const bool live = j < hidden;
  const int tile0 = tix * tile;
  const int rows = min(tile, batch - tile0);
  const size_t bh = static_cast<size_t>(batch) * hidden;
  h_seq += lane * (steps + 1) * bh;
  c_seq += lane * (steps + 1) * bh;
  dgates += lane * static_cast<size_t>(steps) * batch * h4;
  int rowl[R], rowg[R];
  bool valid[R];
  tile_rows(grp, a.groups, tile0, batch, rowl, rowg, valid);
  float dh[R], dc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
    dh[r] = live && valid[r] ? __ldg(dh_last + o) : 0.f;
    dc[r] = live && valid[r] ? __ldg(dc_last + o) : 0.f;
  }
  // rows past the batch, and under kStreamWh wh's rows of units past H:
  // zero in both halves of the stage, never copied
  zero_tile_tail(stg, tile0, tile, batch, kDgCols, ds);
  zero_tile_tail(stg + half, tile0, tile, batch, kDgCols, ds);
  if (whs) {
    for (int i = threadIdx.x; i < (lo.hc - units) * kDgCols; i += blockDim.x) {
      const int o = (tile + units + i / kDgCols) * ds + i % kDgCols;
      stg[o] = 0.f;
      stg[half + o] = 0.f;
    }
  }
  if (sh)
    ring_zero_tails(ring, tile0, batch);
  else
    zero_tile_tail(hbuf, tile0, tile, batch, hidden, lo.hs);
  zero_tile_tail(xs, tile0, tile, batch, f, f);
  if (!sh)
    stage_tile_async_wide(hbuf, h_seq + (steps - 1) * bh, tile0, tile, batch, hidden, lo.hs);
  stage_tile_async(xs, x + static_cast<size_t>(steps - 1) * batch * f, tile0, tile, batch, f, f);
  if (sh) {
    // the mbarriers and the packed rows before the first bulk copy; the x
    // tile's copies join the ring's first group
    __syncthreads();
    ring_start(ring, h_seq + (steps - 1) * bh + static_cast<size_t>(tile0) * hidden, hidden,
               rows);
  } else {
    __pipeline_commit();
  }
  float c_prev[R], c_new[R];
  load_c(c_prev, c_new, c_seq, steps - 1, bh, rowg, valid, live, j, hidden);
  const int chunks = (h4 + kDgCols - 1) / kDgCols;
  const int n4 = kDgCols / 4;
  const bool wh16 = !(reinterpret_cast<uintptr_t>(wh) & 15);
  unsigned parity = 0;

  for (int t = steps - 1; t >= 0; --t) {
    float pre[R][4];
    {
      float ax[R][4], ah[R][4];
      if (sh) {
        zero_sums(ah);
        ring_sum(ring, h_seq + t * bh + static_cast<size_t>(tile0) * hidden, hidden, rows, w4,
                 u, rowl, ah, parity);
        gates_x_tile(xs, w4, f, lo.hc, u, rowl, ax);
      } else {
        __pipeline_wait_prior(0);
        __syncthreads();
        gates_x_tile(xs, w4, f, lo.hc, u, rowl, ax);
        gates_h(w4, hbuf, lo.hs, f, hidden, lo.hc, u, rowl, ah);
      }
      const float4 bu = reinterpret_cast<const float4*>(bs)[u];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pre[r][0] = ax[r][0] + ah[r][0] + bu.x;
        pre[r][1] = ax[r][1] + ah[r][1] + bu.y;
        pre[r][2] = ax[r][2] + ah[r][2] + bu.z;
        pre[r][3] = ax[r][3] + ah[r][3] + bu.w;
      }
    }
    float* dgt = dgates + static_cast<size_t>(t) * batch * h4;
    float d[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
      cell_backward(pre[r], c_prev[r], c_new[r], dh[r], dc[r], d[r]);
    if (t > 0) load_c(c_prev, c_new, c_seq, t - 1, bh, rowg, valid, live, j, hidden);
    store_dgates(dgt, d, rowg, valid, live, j, hidden);
    // every thread has stored its dgates and read the h and x tiles (or the
    // ring): the next step's copies go in flight while the block waits and
    // reduces
    __syncthreads();
    grid_arrive(counter);
    if (t > 0) {
      if (sh) {
        stage_tile_async(xs, x + static_cast<size_t>(t - 1) * batch * f, tile0, tile, batch, f,
                         f);
        ring_start(ring, h_seq + (t - 1) * bh + static_cast<size_t>(tile0) * hidden, hidden,
                   rows);
      } else {
        stage_tile_async_wide(hbuf, h_seq + (t - 1) * bh, tile0, tile, batch, hidden, lo.hs);
        stage_tile_async(xs, x + static_cast<size_t>(t - 1) * batch * f, tile0, tile, batch, f,
                         f);
        __pipeline_commit();
      }
    }
    grid_wait(counter, static_cast<unsigned>(blocks) * (steps - t));
    // dh_t[b, j] = sum over the 4H gate columns of dgates_t[b, col] wh[j, col],
    // in the shared-memory layout's order, kDgCols columns a stage
    const float* src = dgt + static_cast<size_t>(tile0) * h4;
    auto stage = [&](int ch) {
      float* dst = stg + (ch & 1) * half;
      const int col0 = ch * kDgCols;
      const int m4 = min(n4, (h4 - col0) / 4);
      for_tile(rows, m4, [&](int r, int k4) {
        copy_cg16(dst + r * ds + 4 * k4, src + static_cast<size_t>(r) * h4 + col0 + 4 * k4);
      });
      if (whs) {
        // rows J_q of wh at the same columns, which the launch only reads
        const float* wsrc = wh + static_cast<size_t>(j0) * h4 + col0;
        float* wdst = dst + tile * ds;
        if (wh16) {
          for_tile(units, m4, [&](int uu, int k4) {
            __pipeline_memcpy_async(wdst + uu * ds + 4 * k4,
                                    wsrc + static_cast<size_t>(uu) * h4 + 4 * k4, 16);
          });
        } else {
          for_tile(units, 4 * m4, [&](int uu, int k) {
            __pipeline_memcpy_async(wdst + uu * ds + k, wsrc + static_cast<size_t>(uu) * h4 + k,
                                    4);
          });
        }
      }
      __pipeline_commit();
    };
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    stage(0);
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks)
        stage(ch + 1);
      else
        __pipeline_commit();
      __pipeline_wait_prior(1);
      __syncthreads();
      const float* dv0 = stg + (ch & 1) * half;
      const int col0 = ch * kDgCols;
      const int n = min(kDgCols, h4 - col0);
      // unit u's weights at this chunk's columns, a float4 a group of four
      const float4* wb = whs ? reinterpret_cast<const float4*>(dv0 + (tile + u) * ds)
                             : wt4 + (col0 >> 2) * lo.hc + u;
      const int wstep = whs ? 1 : lo.hc;
      auto sum4 = [&](int kk) {
        const float4 w = wb[(kk >> 2) * wstep];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 dv = *reinterpret_cast<const float4*>(dv0 + rowl[r] * ds + kk);
          acc[r] = fmaf(dv.x, w.x, acc[r]);
          acc[r] = fmaf(dv.y, w.y, acc[r]);
          acc[r] = fmaf(dv.z, w.z, acc[r]);
          acc[r] = fmaf(dv.w, w.w, acc[r]);
        }
      };
      // a full chunk's trip count is a constant, which lets the compiler
      // issue several groups' loads ahead (7 % at H = 512)
      if (n == kDgCols) {
#pragma unroll 8
        for (int kk = 0; kk < kDgCols; kk += 4) sum4(kk);
      } else {
        for (int kk = 0; kk < n; kk += 4) sum4(kk);
      }
      // the chunk after next lands in this half only after every thread
      // has summed it
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = acc[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!(live && valid[r])) continue;
    const size_t o = lane * bh + static_cast<size_t>(rowg[r]) * hidden + j;
    dh0[o] = dh[r];
    dc0[o] = dc[r];
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
// threads, its state in shared memory (its own layout) or in the scratch
// buffer, and in the backward the stage of wh in shared memory after it.
template <typename Kernel>
int prepare_l2(Kernel kernel, int hidden, int groups, int span, int mode, int smem,
               const void* work, bool backward) {
  if (span < 1 || groups < 1 || span * groups > kL2Threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const StateLayout lo = state_layout(hidden, groups * kRows, backward, mode);
  const bool global = mode & kStateGlobal;
  const int want = 4 * ((global ? 0 : round4(lo.total)) + (backward ? l2_stage_floats(span) : 0));
  if (smem != want || smem > kMaxShared || global != (work != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// What the cluster launches of this process have set up, on each device:
// per kernel, the largest dynamic shared memory its attribute allows and
// whether it allows clusters above 8; the configurations (kernel, cluster,
// threads, shared memory) of which the card holds at least one cluster at
// once.  A later launch of a known configuration makes none of those calls.
struct ClusterKernelState {
  const void* kernel;
  int device, smem, non_portable;
};
struct ClusterConfig {
  const void* kernel;
  int device, cluster, threads, smem;
};
std::mutex cluster_mutex;
std::vector<ClusterKernelState> cluster_kernels;
std::vector<ClusterConfig> cluster_configs;

// The same for the cluster layout (C blocks of Hc x groups threads), and the
// launch configuration of its first launch: the cluster's size as a launch
// attribute (above 8 once the kernel allows it).  Refuses a configuration
// of which the card can hold no cluster at once
// (cudaOccupancyMaxActiveClusters 0).
template <typename Kernel>
int prepare_cluster(Kernel kernel, int f, int hidden, int groups, int cluster, int mode,
                    int smem, bool backward, cudaLaunchConfig_t& cfg,
                    cudaLaunchAttribute& attr) {
  if (cluster < 2 || cluster > kMaxCluster || (cluster & (cluster - 1)) || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ClusterLayout lo = cluster_layout(f, hidden, cluster, groups * kRows, backward, mode);
  if (lo.hc * groups > kL2Threads || smem != 4 * lo.total || smem > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  cfg.blockDim = dim3(lo.hc * groups);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err != 0) return err;
  const ClusterConfig want{fn, device, cluster, lo.hc * groups, smem};
  std::lock_guard<std::mutex> lock(cluster_mutex);
  for (const ClusterConfig& c : cluster_configs)
    if (c.kernel == fn && c.device == device && c.cluster == cluster &&
        c.threads == want.threads && c.smem == smem)
      return 0;
  ClusterKernelState* state = nullptr;
  for (ClusterKernelState& k : cluster_kernels)
    if (k.kernel == fn && k.device == device) state = &k;
  if (state == nullptr) {
    cluster_kernels.push_back({fn, device, 0, 0});
    state = &cluster_kernels.back();
  }
  // the attribute only grows: a smaller one would refuse a known
  // configuration's launch
  if (smem > state->smem) {
    err = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
    state->smem = smem;
  }
  if (cluster > 8 && !state->non_portable) {
    err = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (err != 0) return err;
    state->non_portable = 1;
  }
  int clusters = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg));
  if (err != 0) return err;
  if (clusters <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cluster_configs.push_back(want);
  return 0;
}

// What the grid launches of this process have set up, on each device: the
// capacity (resident blocks an SM x SMs) of each configuration (kernel,
// threads, shared memory), so that a later launch of a known
// configuration makes no attribute or occupancy call.
struct GridConfig {
  const void* kernel;
  int device, threads, smem, capacity;
};
std::vector<GridConfig> grid_configs;

// The same for the grid layout (K blocks of Hc x groups threads a batch
// tile, in one of grid_mode_ok's modes; kStreamCols needs the packed copy):
// a cooperative launch (cudaLaunchAttributeCooperative: the driver keeps
// every block resident at once or refuses the launch), of per_launch lanes
// x tiles x K blocks, which must not pass the card's capacity for the
// configuration (cudaOccupancyMaxActiveBlocksPerMultiprocessor x its SMs);
// a capacity of 0 is refused too.
template <typename Kernel>
int prepare_grid(Kernel kernel, int f, int hidden, int groups, int rows, int blocks,
                 int per_launch, int tiles, int mode, int kappa, int rho, const void* packed,
                 int smem, bool backward, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (blocks < 1 || groups < 1 || per_launch < 1 ||
      !grid_mode_ok(f, hidden, mode, kappa, rho, backward) ||
      ((mode & kStreamCols) && packed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const GridLayout lo = grid_layout(f, hidden, blocks, groups * rows, backward, mode, kappa, rho);
  if (lo.hc * groups > kL2Threads || smem != 4 * lo.total || smem > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = lo.hc * groups;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err != 0) return err;
  std::lock_guard<std::mutex> lock(cluster_mutex);
  int capacity = -1;
  for (const GridConfig& c : grid_configs)
    if (c.kernel == fn && c.device == device && c.threads == threads && c.smem == smem)
      capacity = c.capacity;
  if (capacity < 0) {
    ClusterKernelState* state = nullptr;
    for (ClusterKernelState& k : cluster_kernels)
      if (k.kernel == fn && k.device == device) state = &k;
    if (state == nullptr) {
      cluster_kernels.push_back({fn, device, 0, 0});
      state = &cluster_kernels.back();
    }
    if (smem > state->smem) {
      err = static_cast<int>(
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
      if (err != 0) return err;
      state->smem = smem;
    }
    int per_sm = 0, sms = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                         threads, smem));
    if (err != 0) return err;
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    if (err != 0) return err;
    capacity = per_sm * sms;
    grid_configs.push_back({fn, device, threads, smem, capacity});
  }
  if (capacity <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (static_cast<long long>(per_launch) * tiles * blocks > capacity)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

const float* at(const void* p, int l0, size_t lane_stride) {
  return static_cast<const float*>(p) + static_cast<size_t>(l0) * lane_stride;
}

float* at(void* p, int l0, size_t lane_stride) {
  return static_cast<float*>(p) + static_cast<size_t>(l0) * lane_stride;
}

}  // namespace

// The layouts (the launchers' layout argument)
constexpr int kLayoutSmem = 0, kLayoutL2 = 1, kLayoutCluster = 2, kLayoutGrid = 3;

// The grid kernels' instantiation for `rows` batch rows a thread (4, 2 or
// 1), or nullptr.
template <typename Fn>
Fn grid_instance(int rows, Fn four, Fn two, Fn one) {
  return rows == 4 ? four : rows == 2 ? two : rows == 1 ? one : nullptr;
}

// The packed copy of a grid launch under kStreamCols: in work past the
// forward's exchange (two (tile, H + 4 rounded) halves a tile of the
// launch's lanes), the whole of work in the backward; else nullptr.
static float* grid_packed(void* work, int layout, int mode, bool backward, int lanes, int per_launch,
                   int tiles, int tile, int hidden) {
  if (layout != kLayoutGrid || !(mode & kStreamCols) || work == nullptr) return nullptr;
  const size_t exchange = backward ? 0
      : static_cast<size_t>(lanes < per_launch ? lanes : per_launch) * tiles * 2 * tile *
            (round4(hidden) + 4);
  return static_cast<float*>(work) + exchange;
}

// Forward.  x (L, T, B, F), h0, c0 (L, B, H), wx, wh, b: fp32 on the current
// device, each dense within a lane, lane l at pointer + l * <its lane
// stride> (elements).  h_out, c_out contiguous: (L, T+1, B, H) if save,
// else (L, B, H).  groups, layout, span, cluster, blocks, per_launch,
// rows, mode, kappa, rho and smem come from the wrapper's plan: the
// shared-memory layout (a block of hidden * groups threads, a batch tile of
// groups * 4 rows), weights through L2 (span * groups threads; mode's
// kStateGlobal puts each block's state in work, one region a block of the
// first 65,535 lanes), across a
// cluster of cluster blocks (each of ceil(hidden / cluster) * groups
// threads) or across the card (blocks blocks a batch tile of groups *
// rows rows, rows = 4, 2 or 1 a thread, each of ceil(hidden / blocks) *
// groups threads, in cooperative launches of per_launch lanes; work holds
// each tile's two exchange halves for per_launch lanes, then under
// kStreamCols the packed copy, (F + H - rho) x Hc float4s for each block of
// a launch; sync, zeroed, one arrival counter a tile of every lane; mode's
// kStreamH streams the h tile through a ring of kappa-column chunks,
// kStreamCols also the rows of the columns from rho on).  smem must equal the
// kernel's own layout.  Returns a CUDA error code (0 on success).
extern "C" int lstm_seq_fwd_launch(const void* x, const void* h0, const void* c0,
                                   const void* wx, const void* wh, const void* b,
                                   void* h_out, void* c_out, void* work, void* sync, int lanes,
                                   int steps, int batch, int f, int hidden, int groups, int save,
                                   int x_ls, int h0_ls, int c0_ls, int wx_ls, int wh_ls, int b_ls,
                                   int layout, int span, int cluster, int blocks, int per_launch,
                                   int rows, int mode, int kappa, int rho, int smem,
                                   void* stream) {
  if (lanes <= 0 || batch <= 0 || steps <= 0) return 0;
  const int tile = groups * (layout == kLayoutGrid ? rows : kRows);
  const int tiles = (batch + tile - 1) / tile;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  cfg.gridDim = dim3(tiles * cluster, lanes < kMaxGridY ? lanes : kMaxGridY);
  const auto grid_fn = grid_instance(rows, lstm_seq_fwd_grid_kernel<4>,
                                     lstm_seq_fwd_grid_kernel<2>, lstm_seq_fwd_grid_kernel<1>);
  float* packed = grid_packed(work, layout, mode, false, lanes, per_launch, tiles, tile, hidden);
  const int err =
      layout == kLayoutGrid
          ? (work == nullptr || sync == nullptr || grid_fn == nullptr
                 ? static_cast<int>(cudaErrorInvalidValue)
                 : prepare_grid(grid_fn, f, hidden, groups, rows, blocks, per_launch, tiles,
                                mode, kappa, rho, packed, smem, false, cfg, attr))
      : layout == kLayoutCluster
          ? prepare_cluster(lstm_seq_fwd_cluster_kernel, f, hidden, groups, cluster, 0, smem,
                            false, cfg, attr)
      : layout == kLayoutL2
          ? prepare_l2(lstm_seq_fwd_l2_kernel, hidden, groups, span, mode, smem, work, false)
      : layout == kLayoutSmem ? prepare(lstm_seq_fwd_kernel, f, hidden, groups, smem, false)
                              : static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t out_lane = save ? (steps + 1) * bh : bh;
  const auto st = static_cast<cudaStream_t>(stream);
  cfg.stream = st;
  int refused = 0;
  const int per = layout == kLayoutGrid ? per_launch : kMaxGridY;
  const int last = over_lanes(lanes, per, [&](int l0, int n) {
    const dim3 grid(tiles, n);
    const SeqArgs a{at(x, l0, x_ls), at(wx, l0, wx_ls), at(wh, l0, wh_ls), at(b, l0, b_ls),
                    x_ls, wx_ls, wh_ls, b_ls, steps, batch, f, hidden, groups};
    if (layout == kLayoutGrid) {
      cfg.gridDim = dim3(tiles * blocks, n);
      const int e = static_cast<int>(cudaLaunchKernelEx(
          &cfg, grid_fn, a, at(h0, l0, h0_ls), at(c0, l0, c0_ls), h0_ls, c0_ls,
          at(h_out, l0, out_lane), at(c_out, l0, out_lane), save, blocks,
          static_cast<float*>(work),
          static_cast<unsigned*>(sync) + static_cast<size_t>(l0) * tiles, mode, kappa, rho,
          packed));
      if (refused == 0) refused = e;
    } else if (layout == kLayoutCluster) {
      cfg.gridDim = dim3(tiles * cluster, n);
      const int e = static_cast<int>(cudaLaunchKernelEx(
          &cfg, lstm_seq_fwd_cluster_kernel, a, at(h0, l0, h0_ls), at(c0, l0, c0_ls), h0_ls,
          c0_ls, at(h_out, l0, out_lane), at(c_out, l0, out_lane), save, cluster));
      if (refused == 0) refused = e;
    } else if (layout == kLayoutL2) {
      lstm_seq_fwd_l2_kernel<<<grid, span * groups, smem, st>>>(
          a, at(h0, l0, h0_ls), at(c0, l0, c0_ls), h0_ls, c0_ls, at(h_out, l0, out_lane),
          at(c_out, l0, out_lane), save, span, mode, static_cast<float*>(work));
    } else {
      lstm_seq_fwd_kernel<<<grid, hidden * groups, smem, st>>>(
          a, at(h0, l0, h0_ls), at(c0, l0, c0_ls), h0_ls, c0_ls, at(h_out, l0, out_lane),
          at(c_out, l0, out_lane), save);
    }
  });
  return refused != 0 ? refused : last;
}

// Backward.  x, wx, wh, b as for the forward; h_seq, c_seq (L, T+1, B, H)
// and dh_last, dc_last (L, B, H) contiguous; writes dgates (L, T, B, 4H),
// dh0 and dc0 (L, B, H), contiguous.  groups, layout, span, cluster,
// blocks, per_launch, rows, mode (kStateGlobal, kDgatesOut; the grid's
// kStreamH, kStreamWh, kStreamCols), kappa, rho, smem, work and sync as for
// the forward (the grid backward exchanges its dgates through the output,
// and its work is only the packed copy under kStreamCols).  Returns a CUDA
// error code.
extern "C" int lstm_seq_bwd_launch(const void* x, const void* h_seq, const void* c_seq,
                                   const void* wx, const void* wh, const void* b,
                                   const void* dh_last, const void* dc_last, void* dgates,
                                   void* dh0, void* dc0, void* work, void* sync, int lanes,
                                   int steps, int batch, int f, int hidden, int groups, int x_ls,
                                   int wx_ls, int wh_ls, int b_ls, int layout, int span,
                                   int cluster, int blocks, int per_launch, int rows, int mode,
                                   int kappa, int rho, int smem, void* stream) {
  if (lanes <= 0 || batch <= 0 || steps <= 0) return 0;
  const int tile = groups * (layout == kLayoutGrid ? rows : kRows);
  const int tiles = (batch + tile - 1) / tile;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  cfg.gridDim = dim3(tiles * cluster, lanes < kMaxGridY ? lanes : kMaxGridY);
  const auto grid_fn = grid_instance(rows, lstm_seq_bwd_grid_kernel<4>,
                                     lstm_seq_bwd_grid_kernel<2>, lstm_seq_bwd_grid_kernel<1>);
  float* packed = grid_packed(work, layout, mode, true, lanes, per_launch, tiles, tile, hidden);
  const int err =
      layout == kLayoutGrid
          ? (sync == nullptr || grid_fn == nullptr
                 ? static_cast<int>(cudaErrorInvalidValue)
                 : prepare_grid(grid_fn, f, hidden, groups, rows, blocks, per_launch, tiles,
                                mode, kappa, rho, packed, smem, true, cfg, attr))
      : layout == kLayoutCluster
          ? prepare_cluster(lstm_seq_bwd_cluster_kernel, f, hidden, groups, cluster, mode, smem,
                            true, cfg, attr)
      : layout == kLayoutL2
          ? prepare_l2(lstm_seq_bwd_l2_kernel, hidden, groups, span, mode, smem, work, true)
      : layout == kLayoutSmem ? prepare(lstm_seq_bwd_kernel, f, hidden, groups, smem, true)
                              : static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const size_t bh = static_cast<size_t>(batch) * hidden;
  const size_t seq_lane = (steps + 1) * bh;
  const size_t dg_lane = static_cast<size_t>(steps) * batch * 4 * hidden;
  const auto st = static_cast<cudaStream_t>(stream);
  cfg.stream = st;
  int refused = 0;
  const int per = layout == kLayoutGrid ? per_launch : kMaxGridY;
  const int last = over_lanes(lanes, per, [&](int l0, int n) {
    const dim3 grid(tiles, n);
    const SeqArgs a{at(x, l0, x_ls), at(wx, l0, wx_ls), at(wh, l0, wh_ls), at(b, l0, b_ls),
                    x_ls, wx_ls, wh_ls, b_ls, steps, batch, f, hidden, groups};
    if (layout == kLayoutGrid) {
      cfg.gridDim = dim3(tiles * blocks, n);
      const int e = static_cast<int>(cudaLaunchKernelEx(
          &cfg, grid_fn, a, at(h_seq, l0, seq_lane), at(c_seq, l0, seq_lane),
          at(dh_last, l0, bh), at(dc_last, l0, bh), at(dgates, l0, dg_lane), at(dh0, l0, bh),
          at(dc0, l0, bh), blocks,
          static_cast<unsigned*>(sync) + static_cast<size_t>(l0) * tiles, mode, kappa, rho,
          packed));
      if (refused == 0) refused = e;
    } else if (layout == kLayoutCluster) {
      cfg.gridDim = dim3(tiles * cluster, n);
      const int e = static_cast<int>(cudaLaunchKernelEx(
          &cfg, lstm_seq_bwd_cluster_kernel, a, at(h_seq, l0, seq_lane),
          at(c_seq, l0, seq_lane), at(dh_last, l0, bh), at(dc_last, l0, bh),
          at(dgates, l0, dg_lane), at(dh0, l0, bh), at(dc0, l0, bh), cluster, mode));
      if (refused == 0) refused = e;
    } else if (layout == kLayoutL2) {
      lstm_seq_bwd_l2_kernel<<<grid, span * groups, smem, st>>>(
          a, at(h_seq, l0, seq_lane), at(c_seq, l0, seq_lane), at(dh_last, l0, bh),
          at(dc_last, l0, bh), at(dgates, l0, dg_lane), at(dh0, l0, bh), at(dc0, l0, bh), span,
          mode, static_cast<float*>(work));
    } else {
      lstm_seq_bwd_kernel<<<grid, hidden * groups, smem, st>>>(
          a, at(h_seq, l0, seq_lane), at(c_seq, l0, seq_lane), at(dh_last, l0, bh),
          at(dc_last, l0, bh), at(dgates, l0, dg_lane), at(dh0, l0, bh), at(dc0, l0, bh));
    }
  });
  return refused != 0 ? refused : last;
}
