// K5: the symbol-ranking transform.
//
// Replaces the Pallas kernel orz_tpu/ops/symrank_pallas.py _phase_call
// (_make_kernel / _round_tier), which the TPU runs as lockstep rounds over
// all 512 contexts: round r applies every context's r-th item, with
// staircase lane compaction and 32/128/432-row tiers to cut idle lanes, and
// an f32 exact division because the TPU has no integer divide.
//
// Semantics (golden/symrank.py, reference src/symrank.rs): each context keeps
// a permutation of the 431 symbols, initialised to the census order, cnt = 0
// and isum = 1000000.  An item codes TOP when its symbol is the context's
// "unlikely" symbol, else rank - (rank > rank_of_unlikely).  Then cnt/isum
// decay by 9/10 once cnt > 431, step = (i>>4) + ((isum>>4)/cnt & 0xFFFF),
// next = max(i-step, 0, i>>1), and the symbol moves toward the front by the
// reference's three writes (later writes win).
//
// Bound on the H100: the serial chain inside each context.  A context's
// items depend on each other through its table; contexts are independent.
// Design: one warp per (segment, context), with that context's table as 432
// int16 in shared memory (864 bytes a warp).  The warp walks the context's
// items in item order, grouped beforehand by a stable (context, item) sort.
// Per item, each lane compares its 14 table entries against the symbol and
// the unlikely symbol, and two warp min-reductions give both ranks.  Lane 0
// then applies the three writes.  Items arrive 32 at a time, one per lane,
// as coalesced loads broadcast by shuffles, and each lane stores its own
// item's code.  Nothing is bounded by a round count, so the TPU's R_CAP_MAX
// skew fallback has no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;        // warps (contexts) per block
constexpr int kTableMax = 448;   // table slots per warp: >= 432, 32 | 448
constexpr unsigned kFull = 0xffffffffu;

__global__ void symrank_kernel(const int* __restrict__ packed,
                               const int* __restrict__ item_of,
                               const int* __restrict__ grp_off,
                               const int* __restrict__ grp_cnt,
                               const int* __restrict__ init_perm,
                               int* __restrict__ coded, int B, int m,
                               int n_ctx, int n_sym) {
  __shared__ short tables[kWarps][kTableMax];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= B * n_ctx) return;  // whole warps only
  const int b = g / n_ctx;
  short* va = tables[warp];
  const int* perm = init_perm + static_cast<size_t>(b) * n_sym;
  for (int r = lane; r < kTableMax; r += 32)
    va[r] = static_cast<short>(r < n_sym ? perm[r] : -1);
  __syncwarp();

  const int off = grp_off[g];
  const int cnt = grp_cnt[g];
  const int* pk = packed + static_cast<size_t>(b) * m + off;
  const int* ix = item_of + static_cast<size_t>(b) * m + off;
  int* out = coded + static_cast<size_t>(b) * m;
  const int top = n_sym - 1;
  int c_cnt = 0, isum = 1000000;

  for (int base = 0; base < cnt; base += 32) {
    const int k = base + lane;
    const int my_pk = k < cnt ? pk[k] : 0;
    const int my_ix = k < cnt ? ix[k] : 0;
    int my_code = 0;
    const int nk = min(32, cnt - base);
    for (int t = 0; t < nk; ++t) {
      const int v = __shfl_sync(kFull, my_pk, t);
      const int sym = v & 0x1FF;
      const int unl = (v >> 9) & 0xFF;
      int fi = 0x7FFF, fu = 0x7FFF;
#pragma unroll
      for (int q = 0; q < kTableMax / 32; ++q) {
        const int r = q * 32 + lane;
        const int e = va[r];
        if (e == sym) fi = r;
        if (e == unl) fu = r;
      }
      const int i = static_cast<int>(__reduce_min_sync(kFull, fi));
      const int iu = static_cast<int>(__reduce_min_sync(kFull, fu));
      if (i >= n_sym) __trap();  // symbol outside the table: bad input
      if (lane == t) my_code = (sym == unl) ? top : i - (i > iu ? 1 : 0);

      if (c_cnt > n_sym) {
        c_cnt = c_cnt * 9 / 10;
        isum = isum * 9 / 10;
      }
      c_cnt += 1;
      isum += i;
      const int step = (i >> 4) + (((isum >> 4) / c_cnt) & 0xFFFF);
      const int next_i = max(max(i - step, 0), i >> 1);
      const int d = i - next_i;
      if (d > 0) {
        const int ni1 = (d == 1) ? i : next_i + (d >> 1);
        const short nv2 = va[next_i];
        const short nv1 = (d == 1) ? nv2 : va[ni1];
        __syncwarp();
        if (lane == 0) {
          va[i] = nv1;
          va[ni1] = nv2;
          va[next_i] = static_cast<short>(sym);
        }
        __syncwarp();
      }
    }
    if (k < cnt) out[my_ix] = my_code;
  }
}

}  // namespace

extern "C" int otz_symrank(const int* packed, const int* item_of,
                           const int* grp_off, const int* grp_cnt,
                           const int* init_perm, int* coded, int B, int m,
                           int n_ctx, int n_sym, int table_rows,
                           void* stream) {
  if (table_rows > kTableMax || n_sym > table_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = B * n_ctx;
  symrank_kernel<<<(groups + kWarps - 1) / kWarps, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      packed, item_of, grp_off, grp_cnt, init_perm, coded, B, m, n_ctx,
      n_sym);
  return static_cast<int>(cudaGetLastError());
}
