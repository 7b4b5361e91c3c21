// K1 and K2: the candidate depth loop of the match finder.
//
// Replaces the Pallas kernel orz_tpu/ops/match_pallas.py match_depth_pallas:
// K1 is _make_kernel(masked=False) (FRONT, called at :258), K2 is
// _make_kernel(masked=True) (:63; the OTZ2 iterations and conform
// analyses).  The TPU kernel runs `depth` shift-compare-select rounds over
// (ROWS, 128) VMEM tiles with lane rotations and a row halo.
//
// Input: every position of B segments sorted by (match key, position), so the
// j-th previous same-key candidate of slot i sits at slot i-j and each key's
// slots are contiguous.  For each slot i and j = 1..depth (inclusive),
// candidate i-j is valid when its key equals slot i's and ro = rank_s[i]-1-
// rank_s[i-j] < ro_cap; its LCP is the count of equal leading bytes over the
// 16 payload dwords (64 bytes), capped by the fence room and the segment
// end, and it must reach min_match_len_for_ro(ro).  Score lcp*1024 +
// (1023-j); a strictly greater score wins, so ties keep the more recent
// candidate.  K2 (masked) adds, from match_pallas.py:144-175: a candidate
// must carry mask 1 (it was an item start of the previous parse, and rank_s
// holds masked prefix counts); for j > near_depth (when near_depth > 0) the
// query itself must carry mask 1; and with a two-tier cap (ro_cap_near <
// ro_cap) a candidate at ro >= ro_cap_near scores lcp alone, below every near
// one.  K1 has no mask, no near gating and one tier.
//
// Bound on the H100: device-memory bytes plus the walked pairs.  Each slot
// reads its key, rank, position (and mask byte) and writes 3 words; each
// compared pair reads the dwords up to the first that differs.  The work is
// the (query, candidate) pairs walked.  Walking every shift with one thread
// per slot, a long same-key group makes each K2 lane load ~depth keys and
// mask bytes, nine in ten of them at mask-0 slots that K2 may not take, and
// the warp waits for its longest lane.
//
// K1 (depth 8 or 32, every slot a candidate): one thread per query slot,
// walking j = 1..depth in order, fed from shared memory.  One CTA per tile
// of kK1Tile consecutive sorted slots of one row (one thread a slot, a warp
// on 32 consecutive slots):
//  1. Stage: the window [t0 - depth, t0 + kK1Tile) goes into shared memory
//     as one 80-byte record a slot, 5 groups of 16 bytes: key, rank and
//     dwords 0-1, then dwords 4g-2 .. 4g+1 (8 bytes of padding at the
//     end).  A warp copies one group of 32 slots at a time: 4 coalesced
//     rows of device memory, one 16-byte store a lane.  Every slot is a
//     candidate of up to depth queries, so each word is read once from
//     device memory and up to depth times from shared memory.
//  2. Walk: a pair reads its candidate's key, rank and dwords 0-1 with one
//     16-byte load, stops at the first other key (keys are sorted), skips
//     a pair whose cap is below its length gate, and compares 4 more
//     dwords of both records a step only while they are equal (dword 1
//     differs in most same-key pairs: `chip_smoke.py` prints the
//     histogram).  The 80-byte stride keeps a quarter warp's 16-byte loads
//     on 32 distinct banks.  The query's position (its cap) is read once,
//     the winner's at the end; the walk stops exactly once a best's LCP
//     equals min(64, cap): every later candidate has a larger j and no
//     larger LCP (one tier).
// The walk waits on shared-memory latency (lanes of a warp stop at
// different j, and a lane with a long match keeps the warp comparing), so
// the kernel is built for 8 CTAs an SM, all its 64 warps: the query's
// deeper dwords are read from its record, not kept in registers.
// Staging the window copies 72 bytes a slot, as the per-slot loop it
// replaces read them; at depth 8 that copy is most of the time.
// Tiles of 512 slots measured slower.

// K2: one CTA per tile of kTile = 1024 consecutive sorted slots of one row
// (256 threads, 4 slots each, a warp on 32 consecutive slots).
//  1. The CTA stages the window [t0 - depth, t0 + kTile) of keys, ranks and
//     mask bytes into shared memory with cp.async (the depth-slot halo
//     costs 38% more of those reads at depth 384).  Slots before 0 and past
//     the row end are never candidates, the TPU kernel's key -1 fill.
//  2. Warp ballots, __popc and a block prefix over the 8 warps' counts
//     compact the window's mask-1 slots into a list of (window index, key,
//     rank) in slot order, and give each slot the count of them before it.
//  3. Each query walks that list newest first while the candidate lies
//     within its jmax shifts, and stops at the first candidate with another
//     key: keys are sorted, so every earlier one differs too.  ro < ro_cap
//     stays a per-candidate test (no monotonicity of rank_s is assumed).
//  4. The walk stops once nothing can win: a near-tier best whose LCP equals
//     min(64, cap) beats every later candidate (larger j, no larger LCP;
//     a far-tier score is the LCP alone, under 1024).  A far candidate is
//     skipped unseen once the best score reaches min(64, cap), and a query
//     whose cap is below every length gate walks nothing.
//  5. A pair's dwords are read, first dword first, through the read-only
//     path only after it passes the key, mask, offset and length gates, and
//     only up to ceil(min(64, cap) / 4) of them; the winner's position is
//     read once at the end.  These loads set the pace, but staging the
//     window's leading dword rows in shared memory measured slower: it
//     reads every window slot's rows, while a slot compares few pairs.
// The inclusive j <= depth bound matters at depth 384, a multiple of 128,
// where the TPU kernel once dropped the last shift (match_pallas.py:196-199).

#include <cuda_runtime.h>

namespace {

constexpr int kNDw = 16;       // payload dwords per slot (LCP0 / 4)
constexpr int kTile = 1024;    // query slots per CTA
constexpr int kThreads = 256;  // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kK1Tile = 256;  // K1: query slots a CTA
constexpr int kK1Groups = 5;  // K1: 16-byte groups of a slot's record
static_assert(kK1Tile % kThreads == 0, "K1 tile");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Bytes of mask staging for a window of w slots: whole 4-byte words from the
// aligned-down start, one spare.
__host__ __device__ constexpr int mask_words(int w) { return (w + 7) / 4 + 1; }

__host__ __device__ constexpr size_t smem_bytes(int w) {
  return 4 * static_cast<size_t>(4 * w + mask_words(w) + kWarps) +
         2 * static_cast<size_t>(2 * w);
}

// Equal leading bytes of slots i and c over their dwords, capped at maxlcp
// (<= 64): only the first ceil(maxlcp / 4) dwords can matter.
__device__ __forceinline__ int pair_lcp(const int* __restrict__ dw_r, int n,
                                        int i, int c, int maxlcp) {
  const int ndw = (maxlcp + 3) >> 2;
  for (int t = 0; t < ndw; ++t) {
    const size_t o = static_cast<size_t>(t) * n;
    const unsigned x = static_cast<unsigned>(__ldg(dw_r + o + i)) ^
                       static_cast<unsigned>(__ldg(dw_r + o + c));
    if (x != 0u)
      return min(4 * t + ((__ffs(static_cast<int>(x)) - 1) >> 3), maxlcp);
  }
  return maxlcp;
}

// K1's shared memory for a window of w slots: the records.
__host__ __device__ constexpr size_t k1_smem_bytes(int w) {
  return static_cast<size_t>(w) * 16 * kK1Groups;
}

__device__ __forceinline__ int first_byte(unsigned x) {  // x != 0
  return (__ffs(static_cast<int>(x)) - 1) >> 3;
}

// K1: the per-slot walk over a staged window (see the note above).
__global__ void __launch_bounds__(kThreads, 8) match_depth_kernel(
    const int* __restrict__ msk, const int* __restrict__ msp,
    const int* __restrict__ rank_s, const int* __restrict__ dw_s,
    const int* __restrict__ end, int* __restrict__ best_q,
    int* __restrict__ best_ro, int* __restrict__ best_len, int n, int depth,
    int ro_cap, int fence, int pad_front, int min_len, int gate, int far1,
    int far2) {
  extern __shared__ uint4 recs[];  // [window][group]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kK1Tile;
  const int w0 = t0 - depth;  // slot of window index 0
  const int lo = max(w0, 0), hi = min(t0 + kK1Tile, n);
  const size_t row = static_cast<size_t>(b) * n;
  const int* dw_r = dw_s + static_cast<size_t>(b) * kNDw * n;

  // 1. stage the window: a warp's task is one group of the records of
  // 32 slots, 4 coalesced rows of device memory, then one 16-byte store a
  // lane (a quarter warp's stores at an 80-byte stride meet no bank
  // twice).  Slots before 0 and past n are never read.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tasks = ((hi - lo + 31) >> 5) * kK1Groups;
#pragma unroll 2
  for (int task = warp; task < tasks; task += kThreads / 32) {
    const int g = task % kK1Groups;
    const int c = lo + 32 * (task / kK1Groups) + lane;
    if (c >= hi) continue;
    const int* dw = dw_r + c;  // dword row t of slot c at dw[t * n]
    auto dword = [&](int t) {
      return static_cast<unsigned>(__ldg(dw + static_cast<size_t>(t) * n));
    };
    const bool full = 4 * g + 1 < kNDw;  // not the padded last group
    recs[(c - w0) * kK1Groups + g] =
        g == 0 ? make_uint4(static_cast<unsigned>(__ldg(msk + row + c)),
                            static_cast<unsigned>(__ldg(rank_s + row + c)),
                            dword(0), dword(1))
               : make_uint4(dword(4 * g - 2), dword(4 * g - 1),
                            full ? dword(4 * g) : 0u,
                            full ? dword(4 * g + 1) : 0u);
  }
  __syncthreads();

  // 2. each thread's queries walk their candidates newest first
  const int e = end[b];
  const int need_min = min(min_len, min(min_len + gate, min_len + 2 * gate));
  for (int k = 0; k < kK1Tile / kThreads; ++k) {
    const int i = t0 + k * kThreads + static_cast<int>(threadIdx.x);
    if (i >= n) break;
    const int q = i - w0;  // the query's window index
    const uint4* qrec = recs + q * kK1Groups;
    const uint4 q0 = qrec[0];
    const int key = static_cast<int>(q0.x), rank = static_cast<int>(q0.y);
    const int p = msp[row + i];
    const int cap = min(fence - ((p - pad_front) & (fence - 1)), e - p);
    const int maxlcp = min(4 * kNDw, cap);
    int bs = 0, bc = -1, bro = 0, blen = 0;
    const int jmax = maxlcp >= need_min ? min(depth, i) : 0;
    for (int j = 1; j <= jmax; ++j) {
      const int cw = q - j;
      const uint4* rec = recs + cw * kK1Groups;
      const uint4 a = rec[0];  // key, rank, dwords 0-1
      if (static_cast<int>(a.x) != key) break;  // sorted: the rest differ
      const int ro = rank - 1 - static_cast<int>(a.y);
      if (ro >= ro_cap) continue;
      const int need = min_len + gate * (ro >= far1) + gate * (ro >= far2);
      if (maxlcp < need) continue;
      int lcp = maxlcp;
      unsigned x = q0.z ^ a.z;
      if (x != 0u) {
        lcp = first_byte(x);
      } else if ((x = q0.w ^ a.w) != 0u) {
        lcp = 4 + first_byte(x);
      } else {
#pragma unroll
        for (int g = 1; g < kK1Groups; ++g) {  // dwords 4g-2 .. 4g+1
          const int t = 4 * g - 2;
          if (4 * t >= maxlcp) break;  // equal through the cap
          const uint4 v = rec[g], qv = qrec[g];
          if ((x = qv.x ^ v.x) != 0u) {
            lcp = 4 * t + first_byte(x);
            break;
          }
          if ((x = qv.y ^ v.y) != 0u) {
            lcp = 4 * (t + 1) + first_byte(x);
            break;
          }
          if (t + 2 >= kNDw) break;  // the last group's padding
          if ((x = qv.z ^ v.z) != 0u) {
            lcp = 4 * (t + 2) + first_byte(x);
            break;
          }
          if ((x = qv.w ^ v.w) != 0u) {
            lcp = 4 * (t + 3) + first_byte(x);
            break;
          }
        }
      }
      lcp = min(lcp, maxlcp);
      if (lcp < need) continue;
      const int score = lcp * 1024 + (1023 - j);
      if (score > bs) {
        bs = score;
        bc = cw;
        bro = ro;
        blen = lcp;
        if (lcp == maxlcp) break;  // every later score is lower
      }
    }
    best_q[row + i] = bc >= 0 ? msp[row + w0 + bc] : -1;
    best_ro[row + i] = bro;
    best_len[row + i] = blen;
  }
}

// K2: the tiled walk over the compacted mask-1 list (see the note above).
__global__ void __launch_bounds__(kThreads) match_depth_masked_kernel(
    const int* __restrict__ msk, const int* __restrict__ msp,
    const int* __restrict__ rank_s, const int* __restrict__ dw_s,
    const unsigned char* __restrict__ mask_s, const int* __restrict__ end,
    int* __restrict__ best_q, int* __restrict__ best_ro,
    int* __restrict__ best_len, int n, int depth, int ro_cap, int near_depth,
    int ro_cap_near, int fence, int pad_front, int min_len, int gate,
    int far1, int far2) {
  extern __shared__ int smem[];
  const int w_len = kTile + depth;
  int* s_key = smem;               // window keys
  int* s_rank = s_key + w_len;     // window ranks
  int* l_key = s_rank + w_len;     // candidate list: keys
  int* l_rank = l_key + w_len;     //                 ranks
  unsigned char* s_maskb = reinterpret_cast<unsigned char*>(l_rank + w_len);
  int* s_tot = l_rank + w_len + mask_words(w_len);  // per-warp counts
  short* l_idx = reinterpret_cast<short*>(s_tot + kWarps);  // window index
  short* s_pref = l_idx + w_len;  // candidates before each window slot

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int w0 = t0 - depth;  // slot of window index 0
  const int lo = max(w0, 0), hi = min(t0 + kTile, n);
  const size_t row = static_cast<size_t>(b) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. stage the window
  for (int c = lo + static_cast<int>(threadIdx.x); c < hi; c += kThreads) {
    cp_async4(s_key + (c - w0), msk + row + c, 4);
    cp_async4(s_rank + (c - w0), rank_s + row + c, 4);
  }
  // the mask bytes as whole words from the aligned-down start
  const size_t m0 = (row + lo) & ~static_cast<size_t>(3);  // s_maskb[0]
  const size_t m_end = row + hi;
  for (size_t g = m0 + 4 * threadIdx.x; g < m_end; g += 4 * kThreads) {
    const int left = static_cast<int>(m_end - g);  // zero-fill past hi
    cp_async4(s_maskb + (g - m0), mask_s + g, left < 4 ? left : 4);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. compact the mask-1 slots: one contiguous run of the window a warp
  const int per_warp = (w_len + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const int wb = warp * per_warp;
  auto is_cand = [&](int w) -> bool {
    const int c = w0 + w;
    return w < w_len && c >= lo && c < hi && s_maskb[row + c - m0] != 0;
  };
  int count = 0;
  for (int w = wb + lane; w < wb + per_warp; w += 32)
    count += __popc(__ballot_sync(kFull, is_cand(w)));
  if (lane == 0) s_tot[warp] = count;
  __syncthreads();
  int pos = 0;
  for (int k = 0; k < warp; ++k) pos += s_tot[k];
  for (int w = wb + lane; w < wb + per_warp; w += 32) {
    const bool f = is_cand(w);
    const unsigned bal = __ballot_sync(kFull, f);
    const int at = pos + __popc(bal & ((1u << lane) - 1u));
    if (w < w_len) s_pref[w] = static_cast<short>(at);
    if (f) {
      l_idx[at] = static_cast<short>(w);
      l_key[at] = s_key[w];
      l_rank[at] = s_rank[w];
    }
    pos += __popc(bal);
  }
  __syncthreads();

  // 3-5. each thread's queries walk the list newest first
  const int* dw_r = dw_s + static_cast<size_t>(b) * kNDw * n;
  const int e = end[b];
  const int need_min = min(min_len, min(min_len + gate, min_len + 2 * gate));
  for (int k = 0; k < kTile / kThreads; ++k) {
    const int i = t0 + k * kThreads + static_cast<int>(threadIdx.x);
    if (i >= n) break;
    const int q = i - w0;  // the query's window index
    const int key = s_key[q], rank = s_rank[q];
    const int p = msp[row + i];
    const int maxlcp =
        min(4 * kNDw, min(fence - ((p - pad_front) & (fence - 1)), e - p));
    int jmax = min(depth, i);
    if (near_depth > 0 && s_maskb[row + i - m0] == 0)
      jmax = min(jmax, near_depth);
    const int w_min = q - jmax;
    int bs = 0, bc = -1, bro = 0, blen = 0;
    if (maxlcp >= need_min) {
      for (int a = s_pref[q] - 1; a >= 0; --a) {
        const int cw = l_idx[a];
        if (cw < w_min || l_key[a] != key) break;
        const int ro = rank - 1 - l_rank[a];
        if (ro >= ro_cap) continue;
        const bool far = ro >= ro_cap_near;
        if (far && bs >= maxlcp) continue;  // no far score can beat bs
        const int need = min_len + gate * (ro >= far1) + gate * (ro >= far2);
        if (maxlcp < need) continue;
        const int lcp = pair_lcp(dw_r, n, i, w0 + cw, maxlcp);
        if (lcp < need) continue;
        const int score = far ? lcp : lcp * 1024 + (1023 - (q - cw));
        if (score > bs) {
          bs = score;
          bc = w0 + cw;
          bro = ro;
          blen = lcp;
          if (!far && lcp == maxlcp) break;  // every later score is lower
        }
      }
    }
    best_q[row + i] = bc >= 0 ? msp[row + bc] : -1;
    best_ro[row + i] = bro;
    best_len[row + i] = blen;
  }
}

}  // namespace

// depth < 1024 keeps the recency term below one LCP step and K2's window
// (at most 2047 slots, 43 KB of shared memory) inside int16 indices.
extern "C" int otz_match_depth(const int* msk, const int* msp,
                               const int* rank_s, const int* dw_s,
                               const int* end, int* best_q, int* best_ro,
                               int* best_len, int B, int n, int depth,
                               int ro_cap, int fence, int pad_front,
                               int min_len, int gate, int far1, int far2,
                               int n_dw, void* stream) {
  if (n_dw != kNDw || depth < 1 || depth > 1023 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = k1_smem_bytes(kK1Tile + depth);
  if (bytes > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        match_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  match_depth_kernel<<<dim3((n + kK1Tile - 1) / kK1Tile, B), kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      msk, msp, rank_s, dw_s, end, best_q, best_ro, best_len, n, depth,
      ro_cap, fence, pad_front, min_len, gate, far1, far2);
  return static_cast<int>(cudaGetLastError());
}

// mask_s must be 4-byte aligned: the window's mask bytes are staged in
// 4-byte words (the wrapper checks).
extern "C" int otz_match_depth_masked(
    const int* msk, const int* msp, const int* rank_s, const int* dw_s,
    const unsigned char* mask_s, const int* end, int* best_q, int* best_ro,
    int* best_len, int B, int n, int depth, int ro_cap, int near_depth,
    int ro_cap_near, int fence, int pad_front, int min_len, int gate,
    int far1, int far2, int n_dw, void* stream) {
  if (n_dw != kNDw || depth < 1 || depth > 1023 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w_len = kTile + depth;
  match_depth_masked_kernel<<<dim3((n + kTile - 1) / kTile, B), kThreads,
                              smem_bytes(w_len),
                              static_cast<cudaStream_t>(stream)>>>(
      msk, msp, rank_s, dw_s, mask_s, end, best_q, best_ro, best_len, n,
      depth, ro_cap, near_depth, ro_cap_near, fence, pad_front, min_len,
      gate, far1, far2);
  return static_cast<int>(cudaGetLastError());
}
