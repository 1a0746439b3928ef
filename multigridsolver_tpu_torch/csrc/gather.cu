// Gather kernels of the AGMG main path, for Hopper (sm_90a).
//
// They replace the windowed-gather Pallas kernels of
// multigridsolver_tpu/ops/gather_pallas.py:
//
//   K1  hyb_spmv     y[i] = DIA[i] + REM[i], one launch per SpMV of a
//                    DIA + ELL hybrid operator (D = 0: the plain ELL SpMV
//                    y[i] = sum_k vals[k, i] * x[cols[k, i]] of
//                    gather_spmv, prolongation and restriction)
//       replaces windowed_gather_spmv (_spmv_kernel + _window_gather,
//       gather_pallas.py:255) together with the XLA-fused DIA pass
//       around it (multigridsolver_tpu/sparse/hybrid.py:223-242)
//   K2  take         out[j] = x[clamp(idx[j])]   over a flat index array
//       replaces windowed_take (_take_kernel)
//   K3  take_rows    out_m[s, i] = xs_m[s, clamp(idx[i])] for up to four
//                    sources m in one launch
//       replaces windowed_take_rows (_take_rows_kernel)
//   K4  take_sharded out[k, i] = [lo | x_local | hi][clamp(idx - shift)]
//       replaces windowed_take_sharded (the shard_map halo exchange
//       followed by windowed_take on each shard's halo-extended source);
//       halo_fill is the body of its exchange (the two ppermutes)
//   K1 on a row mesh: hyb_spmv_sharded, a whole sharded-level SpMV
//       (HaloOp / ExchangeELL of parallel/) in one launch for all shards
//       replaces the XLA body of the JAX package's sharded SpMV
//       (multigridsolver_tpu/parallel/halo.py:135, no Pallas there)
//
// The TPU kernels stage a window of the source vector in VMEM because the
// TPU has no vector gather from HBM.  A GPU thread loads from any global
// address, so these kernels gather directly and carry no window plan.
//
// What bounds them: all of them are pure data movement.  K2/K3 read 4
// bytes of index and one word of source per output word and write that
// word.  Their design keeps every index and output access coalesced
// (slot-major layout: consecutive threads take consecutive rows) and
// sends the data-dependent source loads through the read-only path
// (__ldg); the gathered x of a banded matrix stays in L2.  Indices are
// clamped to [0, nsrc - 1] so a -1 sentinel never reads out of bounds;
// callers mask such entries, as on the TPU.
//
// K1 (hyb_spmv).  The operator is D DIA lanes (dvals (D, npad), offsets
// o_d) and an ELL remainder (cols, vals (K, npad)):
//
//   DIA[i] = fold over d in offsets order, skipping lanes with i + o_d
//            outside [0, npad):  acc = acc + dvals[d, i] * x[i + o_d]
//   REM[i] = fold over k = 0..K-1:  acc = acc + vals[k, i] * x[clamp(cols)]
//   y[i]   = DIA[i] + REM[i]
//
// Both folds start at +0; every product and sum is one IEEE rounding
// (__fmul_rn / __fadd_rn, never contracted to an FMA).  That is the order
// and rounding of the route it replaces on the card (one multiply and one
// add kernel per lane, then the ELL SpMV, then one add), so the bits do
// not change.  An accumulator that starts at +0 is never -0, so y = REM
// exactly when D = 0.
//
// What bounds K1: bytes.  It must read D * npad * w of dvals, K * npad *
// (4 + w) of (cols, vals), the x words it touches, and write npad * w
// (w = 4 or 8).  It does about 2 (D + K) flops per row, 2 flops per 8-12
// bytes: far below the card's balance point, so tensor cores do not
// apply.  On the card the route it replaces paid two kernels per lane
// (99 launches per coarse-level SpMV with 48 lanes) and re-read y for
// each; K1 is one launch that writes y once.  Its design:
//
//   * rows per thread and 16-byte loads: npad is a multiple of 1024 on
//     the main path, so an f32 thread takes 4 consecutive rows (int4 of
//     cols, float4 of vals and of each dval lane) and an f64 thread 2
//     (int2, double2).  All of a row group's slot indices and values are
//     loaded before its gathers (the slot loop is unrolled at compile time
//     for K <= 16); each row's fold stays in ascending order.
//   * the x window: a block of B rows starting at i0 reads its DIA lanes
//     only from x[i0 + omin, i0 + B + omax).  The block stages that window
//     in shared memory with cp.async (16-byte chunks; the start aligned
//     down to 16 bytes, zero past [0, npad)) while its threads gather the
//     remainder, so each x word comes from device memory once per block
//     and the D lanes read it from shared memory.  The remainder's
//     columns are irregular: its gathers stay __ldg.  Where the window
//     does not fit the budget the wrapper gives, or x is not 16-byte
//     aligned, the lanes read x through __ldg instead (a choice by shape).
//   * a scalar instance (one row per thread, no window) takes what the
//     16-byte loads cannot: npad not a multiple of the row group, or a
//     pointer off 16-byte alignment.
//   * the offsets come by value, in a __grid_constant__ struct of at most
//     64 lanes: no host-to-device copy per call.
//
// K2 and K3 move words without reading them (1-, 4- or 8-byte words: a
// bool field is gathered as its bytes), so every route gives its plain
// version's bits.  The bound is bytes.  Their design:
//
//   * K2 (vector route): a thread takes 16 bytes of consecutive output
//     words (4 words of 4 bytes, 2 of 8; 4 of 1 byte): one 16- or 8-byte
//     load of idx, the gathers in flight together, one store.  The grid
//     covers the array in one pass, with 32-bit index math; the launcher
//     cuts an array of 2^31 words or more into chunks of 2^30.  The last
//     thread takes the n % V words past the last group one by one.  An idx
//     off 16-byte alignment (an idx view at an odd offset) takes the scalar
//     route: one word per thread.  (4 words of 8 bytes a thread would need
//     two 16-byte stores, each leaving 16-byte gaps across the warp; they
//     read slower than one store on uniformly random indices.)
//   * K3: one launch for up to four sources of their own row count and
//     word size (4 or 8 bytes), by value in a __grid_constant__ struct, so
//     the Galerkin member fetch (relabelled columns, values, row lengths)
//     is one launch.  blockIdx.y takes one row of one source, so the
//     word-size branch is the same for a whole block, and a thread moves
//     16 bytes of that row as K2 does (4 or 2 positions from one int4 or
//     int2 of idx; one position on the scalar route, for n % 4 != 0 or an
//     unaligned idx).  Spreading the rows over the grid keeps as many
//     gathers in flight as the old one-word-per-thread kernel did; a
//     thread that walked all rows of its positions read slower than that
//     kernel on uniformly random indices.  idx is read once per row, from
//     L2 after the first.  No division, 32-bit index math.
//
// K4 on a row mesh: rows are split into ndev shards of npr rows, and shard
// s may read its own rows plus h rows on either side.  The TPU kernel
// concatenates [lo | x_local | hi] (lo, hi: the neighbours' boundary slabs
// of h words, exchanged by a non-cyclic ppermute, zero at the mesh ends)
// and rebases the global indices by shift = s * npr - h.  K4 reads the
// three pieces in place instead: the exchanged halo buffer (ndev, 2, h)
// and the shard's block of the source, so nothing is concatenated.  It is
// bound by bytes like K2, and takes K2's design: a thread moves 16 bytes
// of consecutive output words (4 of 4 bytes, 2 of 8, 4 of 1 byte) from
// one 16- or 8-byte index load, with 32-bit index math.  The grid is 3-D
// (x along a shard's rows, y the shard, z the slot row), so the shard of
// a word comes from its block and no element divides; npr is a multiple
// of 4 on the vector route, so a word group never straddles two shards.
// An idx off 16-byte alignment, or npr % 4 != 0, takes the scalar route
// (one word a thread, the same grid).  halo_fill writes the halo buffer
// from x in one launch (zero at the mesh ends).  On a mesh over ranks x
// is the rank's local block of shards: the transport (NCCL or gloo)
// brings the neighbour ranks' edge slabs, halo_fill takes them as the
// outer edges of its first and last shard, and K4 rebases the global
// indices by the rank's first row (base).
//
// hyb_spmv_sharded: K1 for a row-sharded operator, all shards in one
// launch (blockIdx.y the shard, blockIdx.x its row blocks).  Shard s owns
// rows [s * npr, (s + 1) * npr) of the DIA lanes dvals (D, npad) and its
// ELL remainder as a block (K, npr) of cols/vals (ndev, K, npr):
//
//   INT[i]  = K1's DIA fold over the shard's own block of x, skipping
//             every term whose column leaves it (the zero extension of
//             the torch route: an accumulator from +0 never holds -0, so
//             a skipped term and an added +-0 give the same bits)
//   REM[i]  = the fold of the remainder's slots; a column c < npr reads
//             the shard's own x[c], a larger one recv[s][c - npr] (the
//             index-list exchange buffer, read in place, no concatenation),
//             or, on the all-gather route, the global x[c]
//   HEAD[i] = for rows i < w: the fold, from +0 in offsets order, of the
//             lanes with i + o < 0, reading the left halo halo[s][0]
//   TAIL[i] = for rows i >= npr - w: the lanes with i + o >= npr, reading
//             the right halo halo[s][1]
//   y[i]    = ((INT[i] + REM[i]) + HEAD[i]) + TAIL[i]
//
// with __fmul_rn / __fadd_rn throughout: the order and rounding of the
// torch route it replaces (one multiply and one add kernel per lane, K1
// per shard, the corrections lane by lane), bit for bit.  The interior
// stages its x window in shared memory exactly as K1 does, clipped to the
// shard's block; the rows per thread and the routes are K1's, with npr in
// the place of npad (every sharded level pads npr to a multiple of 8).
// HEAD and TAIL ride the same lane loop: a term that leaves the block goes
// to its own accumulator, with the lane's dvals already in registers, and
// the window holds the halo past the block's ends, so those terms read
// shared memory too.  (Read from the halo in device memory, they put a
// chain of dependent loads on the boundary blocks, which then ran long
// after the rest and set the kernel's time.)  It is bound by bytes as K1
// is.
//
// Plain C interface for ctypes: every entry returns cudaGetLastError()
// after its launch and launches on the stream it is given.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxLanes = 64;

// The DIA offsets of one hybrid operator, packed once on the host (the
// layout of ops/gather.py's HybLanes).  Outside the anonymous namespace:
// the extern "C" entries take it, and must keep external linkage.
struct HybLanes {
  int d;       // number of lanes, 0..kMaxLanes
  int omin;    // smallest and largest offset (0 when d == 0)
  int omax;
  int off[kMaxLanes];
};

constexpr int kMaxSources = 4;

// K3's sources (the layout of ops/gather.py's RowSources): source m is
// (rows[m], nsrc) of wbytes[m]-byte words at src[m], its output (rows[m],
// n) at dst[m].
struct RowSources {
  int count;   // 1..kMaxSources
  int rows[kMaxSources];
  int wbytes[kMaxSources];   // 4 or 8
  const void* src[kMaxSources];
  void* dst[kMaxSources];
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_index(int c, int nsrc) {
  return c < 0 ? 0 : (c >= nsrc ? nsrc - 1 : c);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// ------------------------------------------------------------------ K1

// rows per thread on the 16-byte path: one 16-byte load of each slot
template <typename T> struct RowGroup;
template <> struct RowGroup<float> { static constexpr int R = 4; };
template <> struct RowGroup<double> { static constexpr int R = 2; };

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load(const int* p, int (&v)[4]) {
  const int4 t = *reinterpret_cast<const int4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const int* p, int (&v)[2]) {
  const int2 t = *reinterpret_cast<const int2*>(p);
  v[0] = t.x; v[1] = t.y;
}
template <typename U>
__device__ __forceinline__ void load(const U* p, U (&v)[1]) { v[0] = *p; }

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
template <typename U>
__device__ __forceinline__ void store(U* p, const U (&v)[1]) { *p = v[0]; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

// the remainder's sources: x[clamp(c)] of nsrc words, from one vector
// (K1) or read as [lo | hi], lo's first nlo words then hi's (the sharded
// kernel: [x_local | recv[s]] on the exchange route)
template <typename T>
struct VecSource {
  const T* x;
  int nsrc;
  __device__ __forceinline__ T operator()(int c) const {
    return __ldg(x + clamp_index(c, nsrc));
  }
};

template <typename T>
struct SplitSource {
  const T* lo;
  const T* hi;
  int nlo;
  int nsrc;
  __device__ __forceinline__ T operator()(int c) const {
    c = clamp_index(c, nsrc);
    return c < nlo ? __ldg(lo + c) : __ldg(hi + (c - nlo));
  }
};

// REM of R consecutive rows from i0 (slot k of row i at k * ld + i): KU >=
// 0 slots known at compile time (every index and value loaded before the
// gathers), KU < 0 a run-time K.
template <typename T, int R, int KU, typename Src>
__device__ __forceinline__ void remainder_fold(const int* __restrict__ cols,
                                               const T* __restrict__ vals,
                                               const Src& x,
                                               int K, int ld, int i0,
                                               T (&rem)[R]) {
  if constexpr (KU > 0) {
    int c[KU][R];
    T v[KU][R];
#pragma unroll
    for (int k = 0; k < KU; ++k) {
      load(cols + static_cast<int64_t>(k) * ld + i0, c[k]);
      load(vals + static_cast<int64_t>(k) * ld + i0, v[k]);
    }
#pragma unroll
    for (int k = 0; k < KU; ++k) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rem[r] = add_rn(rem[r], mul_rn(v[k][r], x(c[k][r])));
      }
    }
  } else if constexpr (KU < 0) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      int c[R];
      T v[R];
      load(cols + static_cast<int64_t>(k) * ld + i0, c);
      load(vals + static_cast<int64_t>(k) * ld + i0, v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rem[r] = add_rn(rem[r], mul_rn(v[r], x(c[r])));
      }
    }
  }
}

// the halo of a sharded DIA fold: a column j < 0 reads left[w + j], one
// j >= n reads right[j - n] (|j| and j - n within w)
template <typename T>
struct Halo {
  const T* left;
  const T* right;
  int w;
};

// DIA of R consecutive rows from i0 over x[0, n), lane by lane in offsets
// order (lane d of row i at d * ld + i), x[j] from the shared window
// (xw[j - ws]) or through __ldg.  A term whose column leaves [0, n) is
// skipped (kHalo false) or folded into head (j < 0) or tail (j >= n)
// (kHalo true), each in offsets order like acc: its x from the window,
// which holds the halo there, or else from the halo through __ldg.
template <typename T, int R, bool kWindow, bool kHalo>
__device__ __forceinline__ void dia_fold(const T* __restrict__ dvals,
                                         const int* s_off, int D,
                                         const T* __restrict__ x,
                                         const T* xw, int ws, int n, int ld,
                                         int i0, T (&acc)[R],
                                         const Halo<T>& halo, T (&head)[R],
                                         T (&tail)[R]) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const int o = s_off[d];
    T dv[R];
    load(dvals + static_cast<int64_t>(d) * ld + i0, dv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = i0 + r + o;
      if (static_cast<unsigned>(j) < static_cast<unsigned>(n)) {
        const T xv = kWindow ? xw[j - ws] : __ldg(x + j);
        acc[r] = add_rn(acc[r], mul_rn(dv[r], xv));
      } else if constexpr (kHalo) {
        const T xv = kWindow ? xw[j - ws]
            : (j < 0 ? __ldg(halo.left + (halo.w + j))
                     : __ldg(halo.right + (j - n)));
        if (j < 0) {
          head[r] = add_rn(head[r], mul_rn(dv[r], xv));
        } else {
          tail[r] = add_rn(tail[r], mul_rn(dv[r], xv));
        }
      }
    }
  }
}

// Issue the copy of the x window of the block whose rows start at
// block_row: x[ws, block_row + kThreads * R + omax) in 16-byte chunks, ws
// the window's start aligned down to a chunk; chunks that leave [0, n)
// are filled word by word, from the halo where it reaches (kHalo) and
// with 0 beyond.  Returns ws; the caller waits (cp.async.wait_all) and
// syncs before reading xw.
template <typename T, int R, bool kHalo>
__device__ __forceinline__ int stage_window(T* xw, const T* __restrict__ x,
                                            int n, int block_row,
                                            const HybLanes& lanes,
                                            const Halo<T>& halo) {
  constexpr int V = 16 / sizeof(T);
  const int lo = block_row + lanes.omin;
  const int ws = (lo >= 0 ? lo / V : -((V - 1 - lo) / V)) * V;
  const int words = block_row + kThreads * R + lanes.omax - ws;
  for (int c = threadIdx.x * V; c < words; c += kThreads * V) {
    const int g = ws + c;
    if (g >= 0 && g + V <= n) {
      cp_async16(xw + c, x + g);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int gj = g + j;
        T v = T(0);
        if (gj >= 0 && gj < n) {
          v = x[gj];
        } else if (kHalo && gj < 0 && gj >= -halo.w) {
          v = halo.left[halo.w + gj];
        } else if (kHalo && gj >= n && gj < n + halo.w) {
          v = halo.right[gj - n];
        }
        xw[c + j] = v;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return ws;
}

// K1: a block of kThreads * R rows, R rows per thread.  window != 0 only
// for R > 1, D > 0 and a 16-byte-aligned x (the launcher decides).
template <typename T, int R, int KU>
__global__ void __launch_bounds__(kThreads)
hyb_spmv_kernel(const T* __restrict__ dvals,
                const __grid_constant__ HybLanes lanes,
                const int* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y,
                int K, int npad, int nsrc, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xw = reinterpret_cast<T*>(smem);
  __shared__ int s_off[kMaxLanes];
  const int D = lanes.d;
  const int block_row = blockIdx.x * (kThreads * R);
  const int i0 = block_row + threadIdx.x * R;
  if (threadIdx.x < D) s_off[threadIdx.x] = lanes.off[threadIdx.x];
  const Halo<T> none{nullptr, nullptr, 0};
  const int ws = window
      ? stage_window<T, R, false>(xw, x, npad, block_row, lanes, none) : 0;
  // rows past npad only help fill the window: npad is a multiple of R,
  // so a row group lies wholly inside or wholly outside
  const bool active = i0 < npad;
  T rem[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rem[r] = T(0);
  // the remainder does not read the window: it runs while the copy lands
  if (active) {
    remainder_fold<T, R, KU>(cols, vals, VecSource<T>{x, nsrc}, K, npad,
                             i0, rem);
  }
  if (window) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!active) return;
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  if (window) {
    dia_fold<T, R, true, false>(dvals, s_off, D, x, xw, ws, npad, npad, i0,
                                acc, none, acc, acc);
  } else {
    dia_fold<T, R, false, false>(dvals, s_off, D, x, xw, ws, npad, npad, i0,
                                 acc, none, acc, acc);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = add_rn(acc[r], rem[r]);
  store(y + i0, acc);
}

// K1 on a row mesh (hyb_spmv_sharded): blockIdx.y is the shard s, whose
// rows are [s * npr, (s + 1) * npr) of dvals (D, npad) and y, and whose
// remainder is the block s of cols/vals (ndev, K, npr).  The remainder
// reads [x_local | recv[s]] (exchange: nrecv words a shard) or, with
// global != 0, the whole x.  halo (ndev, 2, w) holds each shard's left
// and right neighbour slabs (w = 0: no corrections).  window as K1's.
template <typename T, int R, int KU>
__global__ void __launch_bounds__(kThreads)
hyb_spmv_sharded_kernel(const T* __restrict__ dvals,
                        const __grid_constant__ HybLanes lanes,
                        const int* __restrict__ cols,
                        const T* __restrict__ vals,
                        const T* __restrict__ x, const T* __restrict__ recv,
                        const T* __restrict__ halo, T* __restrict__ y,
                        int K, int npr, int npad, int nrecv, int global,
                        int w, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xw = reinterpret_cast<T*>(smem);
  __shared__ int s_off[kMaxLanes];
  const int D = lanes.d;
  const int s = blockIdx.y;
  const int base = s * npr;
  const T* xs = x + base;
  const int block_row = blockIdx.x * (kThreads * R);
  const int i0 = block_row + threadIdx.x * R;
  if (threadIdx.x < D) s_off[threadIdx.x] = lanes.off[threadIdx.x];
  const T* left = halo + static_cast<int64_t>(2 * s) * w;
  const Halo<T> hl{left, left + w, w};
  const int ws = window
      ? stage_window<T, R, true>(xw, xs, npr, block_row, lanes, hl) : 0;
  const bool active = i0 < npr;
  T rem[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rem[r] = T(0);
  if (active && K > 0) {
    const int64_t blk = static_cast<int64_t>(s) * K * npr;
    // the whole x is [x | x] split past its end
    const SplitSource<T> src = global
        ? SplitSource<T>{x, x, npad, npad}
        : SplitSource<T>{xs, recv + static_cast<int64_t>(s) * nrecv, npr,
                         npr + nrecv};
    remainder_fold<T, R, KU>(cols + blk, vals + blk, src, K, npr, i0, rem);
  }
  if (window) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!active) return;
  const T* dv = dvals + base;
  T acc[R], head[R], tail[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = head[r] = tail[r] = T(0);
  if (window) {
    dia_fold<T, R, true, true>(dv, s_off, D, xs, xw, ws, npr, npad, i0, acc,
                               hl, head, tail);
  } else {
    dia_fold<T, R, false, true>(dv, s_off, D, xs, xw, ws, npr, npad, i0, acc,
                                hl, head, tail);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    acc[r] = add_rn(acc[r], rem[r]);
    if (i < w) acc[r] = add_rn(acc[r], head[r]);
    if (i >= npr - w) acc[r] = add_rn(acc[r], tail[r]);
  }
  store(y + base + i0, acc);
}

// ------------------------------------------------------------- K2, K3

// words a thread moves on the vector routes of K2 and K3: 16 bytes of
// output (one 16-byte store) for 4- and 8-byte words, 4 words (one 4-byte
// store) for 1-byte words
template <typename W> struct VecWords { static constexpr int V = 16 / sizeof(W); };
template <> struct VecWords<unsigned char> { static constexpr int V = 4; };
// K3's block on the vector route
constexpr int kRowThreads = 128;

// V indices from p (one 16- or 8-byte load for V = 4 or 2), each clamped
// to [0, nsrc)
template <int V>
__device__ __forceinline__ void load_indices(const int* __restrict__ p,
                                             int nsrc, int (&c)[V]) {
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    c[0] = t.x; c[1] = t.y; c[2] = t.z; c[3] = t.w;
  } else if constexpr (V == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    c[0] = t.x; c[1] = t.y;
  } else {
    c[0] = __ldg(p);
  }
#pragma unroll
  for (int r = 0; r < V; ++r) c[r] = clamp_index(c[r], nsrc);
}

// V words to p in one store (p aligned to V words)
__device__ __forceinline__ void store_words(unsigned char* p,
                                            const unsigned char (&v)[4]) {
  *reinterpret_cast<uint32_t*>(p) = v[0] | (v[1] << 8) | (v[2] << 16)
                                    | (static_cast<uint32_t>(v[3]) << 24);
}
__device__ __forceinline__ void store_words(uint32_t* p,
                                            const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_words(unsigned long long* p,
                                            const unsigned long long (&v)[2]) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0], v[1]);
}
template <typename W>
__device__ __forceinline__ void store_words(W* p, const W (&v)[1]) {
  *p = v[0];
}

// out[i0, i0 + V) = x[idx[i0, i0 + V)]: the V gathers are in flight
// together, then one store
template <typename W, int V>
__device__ __forceinline__ void gather_words(const int* __restrict__ idx,
                                             const W* __restrict__ x,
                                             W* __restrict__ out, int nsrc,
                                             int i0) {
  int c[V];
  load_indices<V>(idx + i0, nsrc, c);
  W v[V];
#pragma unroll
  for (int r = 0; r < V; ++r) v[r] = __ldg(x + c[r]);
  store_words(out + i0, v);
}

// K2, vector route: thread t takes words [Vt, Vt + V); the thread whose
// group passes n takes what is left of it one word at a time.  W is the
// word type (1, 4 or 8 bytes).
template <typename W>
__global__ void __launch_bounds__(kThreads)
take_vec_kernel(const int* __restrict__ idx, const W* __restrict__ x,
                W* __restrict__ out, int n, int nsrc) {
  constexpr int V = VecWords<W>::V;
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (j0 + V <= n) {
    gather_words<W, V>(idx, x, out, nsrc, j0);
  } else {
    for (int j = j0; j < n; ++j) out[j] = __ldg(x + clamp_index(idx[j], nsrc));
  }
}

// K2, scalar route: one word per thread
template <typename W>
__global__ void __launch_bounds__(kThreads)
take_scalar_kernel(const int* __restrict__ idx, const W* __restrict__ x,
                   W* __restrict__ out, int n, int nsrc) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < n) out[j] = __ldg(x + clamp_index(idx[j], nsrc));
}

// K3: blockIdx.y is one row of one source (the sources' rows in order),
// blockIdx.x * blockDim.x + threadIdx.x the thread's place along it.  On
// the vector route (kVec: n % 4 == 0, idx 16-byte aligned) a thread moves
// 16 bytes of the row, VecWords<W>::V positions, else one position.  The
// grid is sized for the narrowest word; threads past n return.
template <bool kVec>
__global__ void __launch_bounds__(kVec ? kRowThreads : kThreads)
take_rows_kernel(const int* __restrict__ idx,
                 const __grid_constant__ RowSources srcs, int n, int nsrc) {
  int m = 0;
  int s = blockIdx.y;
  while (s >= srcs.rows[m]) s -= srcs.rows[m++];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (srcs.wbytes[m] == 4) {
    constexpr int V = kVec ? VecWords<uint32_t>::V : 1;
    if (t * V >= n) return;
    gather_words<uint32_t, V>(
        idx, static_cast<const uint32_t*>(srcs.src[m]) + s * nsrc,
        static_cast<uint32_t*>(srcs.dst[m]) + s * n, nsrc, t * V);
  } else {
    constexpr int V = kVec ? VecWords<unsigned long long>::V : 1;
    if (t * V >= n) return;
    gather_words<unsigned long long, V>(
        idx, static_cast<const unsigned long long*>(srcs.src[m]) + s * nsrc,
        static_cast<unsigned long long*>(srcs.dst[m]) + s * n, nsrc, t * V);
  }
}

// an empty kernel: the floor of a launch as time_ms reads it
__global__ void empty_kernel() {}

// K4's source word at c, the index rebased to the shard's covered range
// [lo | x_local | hi] and clamped into it: idx - shift in 32 bits,
// unsigned past the clamp at 0 so that no index overflows
template <typename W>
__device__ __forceinline__ W sharded_word(int c, int shift, int h, int npr,
                                          const W* __restrict__ xs,
                                          const W* __restrict__ lo,
                                          const W* __restrict__ hi) {
  const unsigned last = static_cast<unsigned>(npr + 2 * h - 1);
  unsigned u = c < shift ? 0u
      : static_cast<unsigned>(c) - static_cast<unsigned>(shift);
  u = u > last ? last : u;
  const int r = static_cast<int>(u);
  if (r < h) return __ldg(lo + r);
  if (r < h + npr) return __ldg(xs + (r - h));
  return __ldg(hi + (r - h - npr));
}

// K4: blockIdx.z is the slot row k (0 for a 1-D idx), blockIdx.y the shard
// s, blockIdx.x * kThreads + threadIdx.x the thread's word group along the
// shard's npr rows.  Slot (k, s * npr + t) lies at k * npad + s * npr + t
// of idx and out.  The indices are global: base is the global index of
// the launch's first row (0 on one process; on a mesh over ranks, the
// rank's first row, x its local block).  halo is (ndev, 2, h): [s][0] the
// left neighbour's last h words, [s][1] the right neighbour's first h
// words.  On the vector route (kVec: npr % 4 == 0, idx and out 16-byte
// aligned) a thread moves VecWords<W>::V words, else one.
template <typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
take_sharded_kernel(const int* __restrict__ idx, const W* __restrict__ x,
                    const W* __restrict__ halo, W* __restrict__ out,
                    int npad, int npr, int h, int base) {
  constexpr int V = kVec ? VecWords<W>::V : 1;
  const int t = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (t >= npr) return;
  const int s = blockIdx.y;
  const int j0 = blockIdx.z * npad + s * npr + t;
  const int shift = base + s * npr - h;
  const W* xs = x + s * npr;
  const W* lo = halo + 2 * s * h;
  const W* hi = lo + h;
  int c[V];
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx + j0));
    c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
  } else if constexpr (V == 2) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(idx + j0));
    c[0] = q.x; c[1] = q.y;
  } else {
    c[0] = __ldg(idx + j0);
  }
  W v[V];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    v[r] = sharded_word(c[r], shift, h, npr, xs, lo, hi);
  }
  store_words(out + j0, v);
}

// halo_fill: halo[s][0] = x[s * npr - h, s * npr) and halo[s][1] =
// x[(s + 1) * npr, (s + 1) * npr + h), one word a thread; blockIdx.y =
// 2 s + side.  The outer edges (halo[0][0], halo[ndev - 1][1]) come from
// lo and hi, the slabs received from the neighbour ranks on a mesh over
// ranks, or are 0 where those are null (the mesh ends).
template <typename W>
__global__ void __launch_bounds__(kThreads)
halo_fill_kernel(const W* __restrict__ x, W* __restrict__ halo, int ndev,
                 int npr, int h, const W* __restrict__ lo,
                 const W* __restrict__ hi) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= h) return;
  const int s = blockIdx.y >> 1;
  const bool right = blockIdx.y & 1;
  W v = W(0);
  if (!right) {
    if (s > 0) v = x[s * npr - h + j];
    else if (lo != nullptr) v = lo[j];
  } else {
    if (s + 1 < ndev) v = x[(s + 1) * npr + j];
    else if (hi != nullptr) v = hi[j];
  }
  halo[blockIdx.y * h + j] = v;
}

// K1's routes: which instance a call takes
enum HybRoute { kScalarRoute = 0, kVectorRoute = 1, kWindowRoute = 2 };

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// shared-memory words of the widest x window any block of the 16-byte
// route needs (0 without lanes)
template <typename T>
int64_t hyb_window_words(const HybLanes& lanes) {
  if (lanes.d == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const int64_t span = static_cast<int64_t>(kThreads) * RowGroup<T>::R
                       + lanes.omax - lanes.omin + V - 1;
  return (span + V - 1) / V * V;
}

template <typename T>
int hyb_route(const void* dvals, const HybLanes& lanes, const void* cols,
              const void* vals, const void* x, const void* y, int K,
              int npad, int window_bytes) {
  const bool vec = npad % RowGroup<T>::R == 0
                   && (lanes.d == 0 || aligned16(dvals))
                   && (K == 0 || (aligned16(cols) && aligned16(vals)))
                   && aligned16(y);
  if (!vec) return kScalarRoute;
  if (lanes.d > 0 && aligned16(x)
      && hyb_window_words<T>(lanes) * static_cast<int64_t>(sizeof(T))
             <= window_bytes) {
    return kWindowRoute;
  }
  return kVectorRoute;
}

template <typename T>
using HybKernel = void (*)(const T*, const HybLanes, const int*, const T*,
                           const T*, T*, int, int, int, int);

template <typename T, int R>
HybKernel<T> hyb_kernel_for(int K) {
#define MGS_HYB_SLOTS(KK) \
  case KK:                \
    return hyb_spmv_kernel<T, R, KK>;
  switch (K) {
    MGS_HYB_SLOTS(0) MGS_HYB_SLOTS(1) MGS_HYB_SLOTS(2) MGS_HYB_SLOTS(3)
    MGS_HYB_SLOTS(4) MGS_HYB_SLOTS(5) MGS_HYB_SLOTS(6) MGS_HYB_SLOTS(7)
    MGS_HYB_SLOTS(8) MGS_HYB_SLOTS(9) MGS_HYB_SLOTS(10) MGS_HYB_SLOTS(11)
    MGS_HYB_SLOTS(12) MGS_HYB_SLOTS(13) MGS_HYB_SLOTS(14) MGS_HYB_SLOTS(15)
    MGS_HYB_SLOTS(16)
    default:
      return hyb_spmv_kernel<T, R, -1>;
  }
#undef MGS_HYB_SLOTS
}

template <typename T>
int launch_hyb(const void* dvals, const HybLanes* lanes, const void* cols,
               const void* vals, const void* x, void* y, int K, int npad,
               int nsrc, int window_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* dv = static_cast<const T*>(dvals);
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  const int route = hyb_route<T>(dvals, *lanes, cols, vals, x, y, K, npad,
                                 window_bytes);
  if (route == kScalarRoute) {
    const int blocks = (npad + kThreads - 1) / kThreads;
    hyb_spmv_kernel<T, 1, -1><<<blocks, kThreads, 0, s>>>(
        dv, *lanes, c, v, xs, ys, K, npad, nsrc, 0);
  } else {
    constexpr int R = RowGroup<T>::R;
    const int blocks = (npad / R + kThreads - 1) / kThreads;
    const size_t smem = route == kWindowRoute
        ? static_cast<size_t>(hyb_window_words<T>(*lanes)) * sizeof(T) : 0;
    const HybKernel<T> kernel = hyb_kernel_for<T, R>(K);
    kernel<<<blocks, kThreads, smem, s>>>(dv, *lanes, c, v, xs, ys, K, npad,
                                          nsrc, route == kWindowRoute);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2's and K3's routes: which instance a call takes
enum TakeRoute { kTakeScalar = 0, kTakeVector = 1 };

// out may be null (the wrapper allocates it 16-byte aligned)
int take_route(const void* idx, const void* out) {
  return aligned16(idx) && aligned16(out) ? kTakeVector : kTakeScalar;
}

int take_rows_route(const void* idx, const RowSources* srcs, int n) {
  bool vec = n % 4 == 0 && aligned16(idx);
  for (int m = 0; srcs != nullptr && m < srcs->count; ++m) {
    vec = vec && aligned16(srcs->dst[m]);
  }
  return vec ? kTakeVector : kTakeScalar;
}

// K2 launches at most this many words at a time (a multiple of 16, so
// every chunk keeps the first one's alignment): its index math is 32-bit
constexpr int64_t kTakeChunk = int64_t(1) << 30;

template <typename W>
int launch_take(const void* idx, const void* x, void* out, int64_t n,
                int nsrc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = take_route(idx, out) == kTakeVector;
  for (int64_t base = 0; base < n; base += kTakeChunk) {
    const int m = static_cast<int>(n - base < kTakeChunk ? n - base
                                                         : kTakeChunk);
    const int* ib = static_cast<const int*>(idx) + base;
    W* ob = static_cast<W*>(out) + base;
    if (vec) {
      constexpr int V = VecWords<W>::V;
      const int blocks = ((m + V - 1) / V + kThreads - 1) / kThreads;
      take_vec_kernel<W><<<blocks, kThreads, 0, s>>>(
          ib, static_cast<const W*>(x), ob, m, nsrc);
    } else {
      const int blocks = (m + kThreads - 1) / kThreads;
      take_scalar_kernel<W><<<blocks, kThreads, 0, s>>>(
          ib, static_cast<const W*>(x), ob, m, nsrc);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int launch_take_rows(const void* idx, const RowSources* srcs, int n,
                     int nsrc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  int rows = 0;
  int vmin = VecWords<uint32_t>::V;
  for (int m = 0; m < srcs->count; ++m) {
    rows += srcs->rows[m];
    if (srcs->wbytes[m] == 8) vmin = VecWords<unsigned long long>::V;
  }
  if (take_rows_route(idx, srcs, n) == kTakeVector) {
    const dim3 grid((n / vmin + kRowThreads - 1) / kRowThreads, rows);
    take_rows_kernel<true><<<grid, kRowThreads, 0, s>>>(ip, *srcs, n, nsrc);
  } else {
    const dim3 grid((n + kThreads - 1) / kThreads, rows);
    take_rows_kernel<false><<<grid, kThreads, 0, s>>>(ip, *srcs, n, nsrc);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's routes (TakeRoute); out as the wrapper allocates it when null
int take_sharded_route(const void* idx, const void* out, int npr) {
  return npr % 4 == 0 && aligned16(idx) && aligned16(out) ? kTakeVector
                                                          : kTakeScalar;
}

template <typename W>
int launch_take_sharded(const void* idx, const void* x, const void* halo,
                        void* out, int K, int ndev, int npr, int h, int base,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const W* xp = static_cast<const W*>(x);
  const W* hp = static_cast<const W*>(halo);
  W* op = static_cast<W*>(out);
  if (take_sharded_route(idx, out, npr) == kTakeVector) {
    constexpr int V = VecWords<W>::V;
    const dim3 grid((npr / V + kThreads - 1) / kThreads, ndev, K);
    take_sharded_kernel<W, true><<<grid, kThreads, 0, s>>>(
        ip, xp, hp, op, ndev * npr, npr, h, base);
  } else {
    const dim3 grid((npr + kThreads - 1) / kThreads, ndev, K);
    take_sharded_kernel<W, false><<<grid, kThreads, 0, s>>>(
        ip, xp, hp, op, ndev * npr, npr, h, base);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_halo_fill(const void* x, void* halo, int ndev, int npr, int h,
                     const void* lo, const void* hi, void* stream) {
  const dim3 grid((h + kThreads - 1) / kThreads, 2 * ndev);
  halo_fill_kernel<W><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(x), static_cast<W*>(halo), ndev, npr, h,
      static_cast<const W*>(lo), static_cast<const W*>(hi));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
using HybShardedKernel = void (*)(const T*, const HybLanes, const int*,
                                  const T*, const T*, const T*, const T*, T*,
                                  int, int, int, int, int, int, int);

template <typename T, int R>
HybShardedKernel<T> hyb_sharded_kernel_for(int K) {
#define MGS_HYB_SLOTS(KK) \
  case KK:                \
    return hyb_spmv_sharded_kernel<T, R, KK>;
  switch (K) {
    MGS_HYB_SLOTS(0) MGS_HYB_SLOTS(1) MGS_HYB_SLOTS(2) MGS_HYB_SLOTS(3)
    MGS_HYB_SLOTS(4) MGS_HYB_SLOTS(5) MGS_HYB_SLOTS(6) MGS_HYB_SLOTS(7)
    MGS_HYB_SLOTS(8) MGS_HYB_SLOTS(9) MGS_HYB_SLOTS(10) MGS_HYB_SLOTS(11)
    MGS_HYB_SLOTS(12) MGS_HYB_SLOTS(13) MGS_HYB_SLOTS(14) MGS_HYB_SLOTS(15)
    MGS_HYB_SLOTS(16)
    default:
      return hyb_spmv_sharded_kernel<T, R, -1>;
  }
#undef MGS_HYB_SLOTS
}

// the sharded SpMV takes K1's routes, decided per shard (npr rows)
template <typename T>
int launch_hyb_sharded(const void* dvals, const HybLanes* lanes,
                       const void* cols, const void* vals, const void* x,
                       const void* recv, const void* halo, void* y, int K,
                       int ndev, int npr, int nrecv, int global, int w,
                       int window_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* dv = static_cast<const T*>(dvals);
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xs = static_cast<const T*>(x);
  const T* rv = static_cast<const T*>(recv);
  const T* hp = static_cast<const T*>(halo);
  T* ys = static_cast<T*>(y);
  const int npad = ndev * npr;
  const int route = hyb_route<T>(dvals, *lanes, cols, vals, x, y, K, npr,
                                 window_bytes);
  if (route == kScalarRoute) {
    const dim3 grid((npr + kThreads - 1) / kThreads, ndev);
    hyb_spmv_sharded_kernel<T, 1, -1><<<grid, kThreads, 0, s>>>(
        dv, *lanes, c, v, xs, rv, hp, ys, K, npr, npad, nrecv, global, w, 0);
  } else {
    constexpr int R = RowGroup<T>::R;
    const dim3 grid((npr / R + kThreads - 1) / kThreads, ndev);
    const size_t smem = route == kWindowRoute
        ? static_cast<size_t>(hyb_window_words<T>(*lanes)) * sizeof(T) : 0;
    const HybShardedKernel<T> kernel = hyb_sharded_kernel_for<T, R>(K);
    kernel<<<grid, kThreads, smem, s>>>(dv, *lanes, c, v, xs, rv, hp, ys, K,
                                        npr, npad, nrecv, global, w,
                                        route == kWindowRoute);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mgs_hyb_spmv_f32(const void* dvals, const HybLanes* lanes,
                     const void* cols, const void* vals, const void* x,
                     void* y, int K, int npad, int nsrc, int window_bytes,
                     void* stream) {
  return launch_hyb<float>(dvals, lanes, cols, vals, x, y, K, npad, nsrc,
                           window_bytes, stream);
}

int mgs_hyb_spmv_f64(const void* dvals, const HybLanes* lanes,
                     const void* cols, const void* vals, const void* x,
                     void* y, int K, int npad, int nsrc, int window_bytes,
                     void* stream) {
  return launch_hyb<double>(dvals, lanes, cols, vals, x, y, K, npad, nsrc,
                            window_bytes, stream);
}

// the route a call with these arguments takes (HybRoute); y as the
// wrapper allocates it, 16-byte aligned
int mgs_hyb_route_f32(const void* dvals, const HybLanes* lanes,
                      const void* cols, const void* vals, const void* x,
                      int K, int npad, int window_bytes) {
  return hyb_route<float>(dvals, *lanes, cols, vals, x, nullptr, K, npad,
                          window_bytes);
}

int mgs_hyb_route_f64(const void* dvals, const HybLanes* lanes,
                      const void* cols, const void* vals, const void* x,
                      int K, int npad, int window_bytes) {
  return hyb_route<double>(dvals, *lanes, cols, vals, x, nullptr, K, npad,
                           window_bytes);
}

int mgs_take_w1(const void* idx, const void* x, void* out, long long n,
                int nsrc, void* stream) {
  return launch_take<unsigned char>(idx, x, out, n, nsrc, stream);
}

int mgs_take_w4(const void* idx, const void* x, void* out, long long n,
                int nsrc, void* stream) {
  return launch_take<uint32_t>(idx, x, out, n, nsrc, stream);
}

int mgs_take_w8(const void* idx, const void* x, void* out, long long n,
                int nsrc, void* stream) {
  return launch_take<unsigned long long>(idx, x, out, n, nsrc, stream);
}

// the route a K2 call with this idx takes (TakeRoute); out as the
// wrapper allocates it, 16-byte aligned
int mgs_take_route(const void* idx) { return take_route(idx, nullptr); }

int mgs_take_rows(const void* idx, const RowSources* srcs, int n, int nsrc,
                  void* stream) {
  return launch_take_rows(idx, srcs, n, nsrc, stream);
}

// the route a K3 call with this idx of n positions takes (TakeRoute)
int mgs_take_rows_route(const void* idx, int n) {
  return take_rows_route(idx, nullptr, n);
}

int mgs_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int mgs_take_sharded_w1(const void* idx, const void* x, const void* halo,
                        void* out, int K, int ndev, int npr, int h, int base,
                        void* stream) {
  return launch_take_sharded<unsigned char>(idx, x, halo, out, K, ndev, npr,
                                            h, base, stream);
}

int mgs_take_sharded_w4(const void* idx, const void* x, const void* halo,
                        void* out, int K, int ndev, int npr, int h, int base,
                        void* stream) {
  return launch_take_sharded<uint32_t>(idx, x, halo, out, K, ndev, npr, h,
                                       base, stream);
}

int mgs_take_sharded_w8(const void* idx, const void* x, const void* halo,
                        void* out, int K, int ndev, int npr, int h, int base,
                        void* stream) {
  return launch_take_sharded<unsigned long long>(idx, x, halo, out, K, ndev,
                                                 npr, h, base, stream);
}

// the route a K4 call with this idx takes (TakeRoute); out as the wrapper
// allocates it, 16-byte aligned
int mgs_take_sharded_route(const void* idx, int npr) {
  return take_sharded_route(idx, nullptr, npr);
}

int mgs_halo_fill_w1(const void* x, void* halo, int ndev, int npr, int h,
                     const void* lo, const void* hi, void* stream) {
  return launch_halo_fill<unsigned char>(x, halo, ndev, npr, h, lo, hi,
                                         stream);
}

int mgs_halo_fill_w4(const void* x, void* halo, int ndev, int npr, int h,
                     const void* lo, const void* hi, void* stream) {
  return launch_halo_fill<uint32_t>(x, halo, ndev, npr, h, lo, hi, stream);
}

int mgs_halo_fill_w8(const void* x, void* halo, int ndev, int npr, int h,
                     const void* lo, const void* hi, void* stream) {
  return launch_halo_fill<unsigned long long>(x, halo, ndev, npr, h, lo, hi,
                                              stream);
}

int mgs_hyb_spmv_sharded_f32(const void* dvals, const HybLanes* lanes,
                             const void* cols, const void* vals,
                             const void* x, const void* recv,
                             const void* halo, void* y, int K, int ndev,
                             int npr, int nrecv, int global, int w,
                             int window_bytes, void* stream) {
  return launch_hyb_sharded<float>(dvals, lanes, cols, vals, x, recv, halo,
                                   y, K, ndev, npr, nrecv, global, w,
                                   window_bytes, stream);
}

int mgs_hyb_spmv_sharded_f64(const void* dvals, const HybLanes* lanes,
                             const void* cols, const void* vals,
                             const void* x, const void* recv,
                             const void* halo, void* y, int K, int ndev,
                             int npr, int nrecv, int global, int w,
                             int window_bytes, void* stream) {
  return launch_hyb_sharded<double>(dvals, lanes, cols, vals, x, recv, halo,
                                    y, K, ndev, npr, nrecv, global, w,
                                    window_bytes, stream);
}

}  // extern "C"
