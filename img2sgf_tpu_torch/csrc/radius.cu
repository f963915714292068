// K3: cv2 radius histogram and run scan per wanted candidate centre.
//
// Replaces the Pallas kernel img2sgf_tpu/hough/radius_pallas.py:119
// (radius_words_pallas, body _build_kernel.kern) and fuses the run scan
// (_hist10_scan in img2sgf_tpu/hough/circles.py) that the JAX package runs
// after it. For each wanted (plane, slot) the edge pixels of the
// (2*max_r+1)^2 window that lie in the annulus are counted into OpenCV's
// 10-bins-per-dr radius histogram, and the histogram is scanned into
// (r_best, support); slots not wanted get zeros.
//
// Bound: the bytes of emask and of the per-slot inputs and outputs, or an
// edge test at every in-plane annulus pixel of a wanted window plus a bin
// lookup and a count at every edge pixel, whichever is larger. The kernel
// stays far above both: a candidate is a chain of a few thousand dependent
// warp instructions (window loads, edge counts, a 27-step scan at r in
// [1, 30]), so what the design controls is the instructions and the length
// of the chain per candidate, and that no warp waits on an unwanted slot.
//
// Design:
//   * A persistent grid. Every warp takes the slots of rank w, w + Wg,
//     w + 2 Wg, ... (Wg the warps of the grid) in the column-major order
//     rank = i * P + p of slot (p, i), so that each plane's live prefix
//     (what the main path passes) spreads over all warps. A warp ballots
//     32 of its slots' want bytes at a time and runs the wanted ones in
//     turn: no warp works on an unwanted slot and none waits for another.
//     A coalesced grid-stride pass writes the unwanted slots' zeros first.
//     want may be any mask, and any P runs.
//   * The annulus is a table of up to two column spans per window row,
//     derived on the host from the per-offset bin map. The window is walked
//     as (row, 16-byte chunk) items, one item per lane: a lane clips its
//     row's spans to the plane, reads the aligned 16 mask bytes, gathers
//     their 0/1 bytes into 16 edge bits with one multiply a word, and ANDs
//     them with the spans' bits; it issues the loads of kBatch items before
//     it counts any. Only at an edge pixel does a lane read the bin (binmap,
//     L1/L2-resident) and add one to the warp's own shared-memory
//     histogram.
//   * The run scan is warp-parallel where it can be: in one pass each lane
//     forms, over its ceil(nbins/32) contiguous bins, the integer prefix of
//     the histogram (with a shuffle scan of the lanes' sums; the counts are
//     integers below 2^24, so its float32 values equal a float32 running
//     sum) and the prefix maximum of the nonempty bins above 0 (with a
//     shuffle max-scan), both in place in shared memory. The scan's own
//     chain is then one shared-memory read an iteration: the anchor, the
//     highest nonempty bin in [1, j], is that table at j. The compare and
//     update are those of _hist10_scan, in its order; the run radius is one
//     fused multiply-add by 0.05f, as XLA:CPU rounds it. Build with
//     --fmad=false: no other product may be contracted into a fused
//     multiply-add.
//   * ys and xs are read in the caller's dtype (int32 or int64) and want as
//     bytes, so a call is one kernel launch and no host read. Each warp
//     keeps 2 * nbins int32 in shared memory; the block takes as many warps
//     (at most kMaxWarps) as fit the card's shared memory per block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kPerDr = 10;
constexpr int kBatch = 4;  // window items a lane loads before counting them

// Returned when one warp's tables exceed the card's shared memory per block.
constexpr int kTooManyBins = -1;

// Shared memory of a warp: hist[nbins], then top[nbins] int32.
size_t warp_bytes(int nbins) { return 2 * (size_t)nbins * sizeof(int); }

// Bits lo..hi of 16 (clipped to 0..15), 0 when the range is empty.
__device__ __forceinline__ unsigned range16(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 15);
  return lo <= hi ? (2u << hi) - (1u << lo) : 0u;
}

// Bit 0 of each of the 4 bytes of w (a bool byte is 0 or 1) as 4 bits:
// byte k's bit moves to bit 21 + k, and the multiply's other partial
// products land on other bits, without carries.
__device__ __forceinline__ unsigned gather4(unsigned w) {
  return ((w & 0x01010101u) * 0x00204081u) >> 21 & 0xFu;
}

// One candidate: the window's histogram into hist, then the run scan.
// Returns (r_best, support) in every lane.
__device__ __forceinline__ float2 candidate(
    const unsigned char* __restrict__ plane, int cy, int cx, int H, int W,
    const int* __restrict__ binmap, const int4* __restrict__ spans,
    int min_r, int max_r, int nbins, int* hist, int* top, int lane) {
  for (int b = lane; b < nbins; b += 32) hist[b] = 0;
  __syncwarp();

  // (row u, 16-byte chunk c) items, c < nch, one per lane
  const int win = 2 * max_r + 1;
  const int nch = (win + 14) / 16 + 1;  // chunks a row's bytes can touch
  const int items = win * nch;
  int u = lane / nch, c = lane % nch;
  const int du = 32 / nch, dc = 32 % nch;
  for (int it0 = lane; it0 < items; it0 += 32 * kBatch) {
    unsigned e[kBatch];  // edge pixels of the item's 16 bytes
    int at0[kBatch];     // binmap index of the item's byte 0
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      e[k] = 0u;
      at0[k] = 0;
      const int yy = cy - max_r + u;
      if (it0 + 32 * k < items && yy >= 0 && yy < H) {
        const int4 sp = __ldg(spans + u);
        const int a0 = max(cx + sp.x, 0), b0 = min(cx + sp.y, W - 1);
        const int a1 = max(cx + sp.z, 0), b1 = min(cx + sp.w, W - 1);
        const bool e0 = a0 <= b0, e1 = a1 <= b1;
        const int lo = e0 ? a0 : a1;
        const int hi = e1 ? b1 : b0;
        // an aligned chunk that holds a byte of the row cannot fault, and
        // its bytes outside the spans are masked
        const uintptr_t at = (uintptr_t)(plane + (size_t)yy * W + lo);
        const uintptr_t chunk = (at & ~(uintptr_t)15) + 16 * (uintptr_t)c;
        if ((e0 || e1) && chunk <= at + (hi - lo)) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(chunk));
          const int x0 = lo + (int)(chunk - at);  // plane column of byte 0
          e[k] = (gather4(q.x) | gather4(q.y) << 4 | gather4(q.z) << 8 |
                  gather4(q.w) << 12) &
                 (range16(a0 - x0, b0 - x0) | range16(a1 - x0, b1 - x0));
          at0[k] = u * win + max_r - cx + x0;
        }
      }
      u += du;
      c += dc;
      if (c >= nch) {
        c -= nch;
        ++u;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      while (e[k]) {
        const int b = __ffs(e[k]) - 1;
        e[k] &= e[k] - 1;
        atomicAdd(&hist[__ldg(binmap + at0[k] + b)], 1);
      }
    }
  }
  __syncwarp();

  // in place: hist[b] = counts of bins 0..b, top[b] = the highest nonempty
  // bin in [1, b] or -1; lane l owns bins [l * per, (l + 1) * per)
  const int per = (nbins + 31) >> 5;
  const int b0 = min(lane * per, nbins);
  const int b1 = min(b0 + per, nbins);
  int own = 0, own_top = -1;
  for (int b = b0; b < b1; ++b) {
    const int h = hist[b];
    own += h;
    if (h > 0 && b >= 1) own_top = b;
  }
  int sum = own, high = own_top;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int s = __shfl_up_sync(kFull, sum, d);
    const int t = __shfl_up_sync(kFull, high, d);
    if (lane >= d) {
      sum += s;
      high = max(high, t);
    }
  }
  int run = sum - own;
  int above = __shfl_up_sync(kFull, high, 1);  // lanes below this one
  if (lane == 0) above = -1;
  for (int b = b0; b < b1; ++b) {
    const int h = hist[b];
    run += h;
    hist[b] = run;
    if (h > 0 && b >= 1) above = b;
    top[b] = above;
  }
  __syncwarp();

  // _hist10_scan: runs of 10 bins anchored at nonempty bins, from the top
  // down; every lane computes the same values
  const int n_iter = (nbins - 2) / (kPerDr + 1) + 1;
  int j = nbins - 1;
  float r_best = 0.f;
  float max_count = 0.f;
  for (int i = 0; i < n_iter; ++i) {
    const int anchor = j >= 1 ? top[j] : -1;
    if (anchor < 0) break;  // no later iteration finds one either
    const int j_after = anchor - kPerDr > -1 ? anchor - kPerDr : -1;
    const float hi = (float)hist[anchor];
    const float lo = (float)hist[j_after > 0 ? j_after : 0];
    const float cnt = hi - (j_after >= 0 ? lo : 0.f);
    // (anchor + j_after) / 2 / 10 * dr + min_r at dr = 1, rounded as the
    // JAX reference rounds it: one float32 fused multiply-add by 0.05f
    const float r_cur =
        __fmaf_rn((float)(anchor + j_after), 0.05f, (float)min_r);
    const float lhs = cnt * r_best;
    const float rhs = max_count * r_cur;
    if ((lhs >= rhs) || ((r_best < 1.19e-7f) && (cnt >= max_count))) {
      r_best = r_cur;
      max_count = cnt;
    }
    j = anchor - (kPerDr + 1);
  }
  __syncwarp();  // every lane has read hist before the next candidate
  return make_float2(r_best, max_count);
}

template <typename Idx>
__global__ void __launch_bounds__(kMaxWarps * 32)
radius_kernel(const unsigned char* __restrict__ emask,
              const Idx* __restrict__ ys, const Idx* __restrict__ xs,
              const unsigned char* __restrict__ want,
              const int* __restrict__ binmap, const int4* __restrict__ spans,
              float* __restrict__ r_out, float* __restrict__ s_out, int P,
              int H, int W, int K, int min_r, int max_r, int nbins) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* hist = smem + warp * 2 * nbins;
  int* top = hist + nbins;
  const long long S = (long long)P * K;

  // zeros of the unwanted slots, coalesced
  const long long gstride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += gstride) {
    if (!want[s]) {
      r_out[s] = 0.f;
      s_out[s] = 0.f;
    }
  }

  // this warp's slots: ranks w + k * Wg in the order rank = i * P + p
  const long long Wg = gstride >> 5;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  for (long long r0 = w; r0 < S; r0 += 32 * Wg) {
    const long long rank = r0 + lane * Wg;
    long long slot = 0;
    bool wanted = false;
    if (rank < S) {
      slot = (rank % P) * K + rank / P;
      wanted = want[slot];
    }
    unsigned bal = __ballot_sync(kFull, wanted);
    while (bal) {
      const int l = __ffs(bal) - 1;
      bal &= bal - 1;
      const long long at = __shfl_sync(kFull, slot, l);
      const int p = (int)(at / K);
      const float2 rs = candidate(emask + (size_t)p * H * W, (int)ys[at],
                                  (int)xs[at], H, W, binmap, spans, min_r,
                                  max_r, nbins, hist, top, lane);
      if (lane == 0) {
        r_out[at] = rs.x;
        s_out[at] = rs.y;
      }
    }
  }
}

template <typename Idx>
int launch(const unsigned char* emask, const void* ys, const void* xs,
           const unsigned char* want, const int* binmap, const int* spans,
           float* r_out, float* s_out, int P, int H, int W, int K, int min_r,
           int max_r, int nbins, cudaStream_t s) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t fit = optin / warp_bytes(nbins);
  if (fit < 1) return kTooManyBins;
  const int warps = fit < (size_t)kMaxWarps ? (int)fit : kMaxWarps;
  const size_t smem = warps * warp_bytes(nbins);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(radius_kernel<Idx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int threads = 32 * warps;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, radius_kernel<Idx>, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // no more blocks than give every slot a warp of its own
  const long long S = (long long)P * K;
  const long long need = (S + warps - 1) / warps;
  const int blocks = (int)(need < (long long)per_sm * sms
                               ? need : (long long)per_sm * sms);
  radius_kernel<Idx><<<blocks, threads, smem, s>>>(
      emask, static_cast<const Idx*>(ys), static_cast<const Idx*>(xs), want,
      binmap, reinterpret_cast<const int4*>(spans), r_out, s_out, P, H, W, K,
      min_r, max_r, nbins);
  return cudaGetLastError();
}

}  // namespace

// emask: [P, H, W] bool (bytes 0 or 1); ys, xs: [P, K] int32 (idx64 = 0)
// or int64 (idx64 = 1); want: [P, K] bool; binmap: [(2*max_r+1)^2] int32
// bin of each window offset; spans: [2*max_r+1, 4] int32 (dx0, dx1, dx2,
// dx3): the annulus columns dx0..dx1 and dx2..dx3 of each window row, an
// empty span with its start above its end; r_out, s_out: [P, K] f32.
// Returns a cudaError_t, or kTooManyBins (-1) and launches nothing when
// one warp's 2 * nbins int32 exceed the card's shared memory per block.
extern "C" int img2sgf_radius(const unsigned char* emask, const void* ys,
                              const void* xs, const unsigned char* want,
                              const int* binmap, const int* spans,
                              float* r_out, float* s_out, int P, int H, int W,
                              int K, int min_r, int max_r, int nbins,
                              int idx64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64) {
    return launch<long long>(emask, ys, xs, want, binmap, spans, r_out, s_out,
                             P, H, W, K, min_r, max_r, nbins, s);
  }
  return launch<int>(emask, ys, xs, want, binmap, spans, r_out, s_out, P, H,
                     W, K, min_r, max_r, nbins, s);
}
