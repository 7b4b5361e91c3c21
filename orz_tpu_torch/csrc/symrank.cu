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
// Bound on the H100: the serial chain of the busiest (segment, context).  A
// context's items depend on each other through its table; contexts are
// independent, so the kernel takes at least the longest context's item count
// times the latency of one item's dependent steps (the bytes, 12 per item,
// take far less).
//
// Design: one warp per (segment, context), four to a block.  The context's
// value table va (rank -> symbol, 432 int16) and its inverse ia (symbol ->
// rank, 512 int16: every 9-bit symbol) live in shared memory.  Lane 0 alone
// runs the chain, so the tables see one access at a time and no bank
// conflicts; the other lanes load the next 32 packed items (coalesced, one
// batch ahead) into a shared buffer, check their symbols, and store the
// codes that lane 0 leaves there.  Per item the chain is register
// arithmetic only: rank i -> isum -> step -> next_i -> ni1 -> the next
// item's rank.  Everything else is taken off it:
//  - ranks are O(1) lookups, ia[sym], instead of a scan of the table;
//  - the next item's ia[sym'] (and this item's ia[unlikely]) are loaded
//    at the top of the item and fixed up in registers: sym' moved iff it
//    is this item's symbol or its old rank is next_i (it is va[next_i]) or
//    ni1 (va[ni1]), so no load waits for this item's writes;
//  - an item's three writes (later writes win, as in the reference) are
//    issued one item late, after the next item's arithmetic, so that the
//    in-order issue does not stall on the va loads that feed them; the
//    loads of the late item's ia are fixed up for those writes too;
//  - (isum>>4)/cnt = isum/(16 cnt) is a fixed-point product, (isum * m) >>
//    34 with m = 2^30/cnt + 1, exact for isum < 2.48e6 (isum stays under
//    1.19e6: it starts at 10^6, adds at most 430 an item and decays by 9/10
//    every ~44 items); m comes from a per-block table, since cnt's sequence
//    does not depend on the data.  It replaces the TPU kernel's f32
//    quotient with its +-1 correction (symrank_pallas.py _exact_div), whose
//    conversions and corrections would lengthen the chain.
// Nothing is bounded by a round count, so the TPU's R_CAP_MAX skew fallback
// has no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;       // warps (contexts) per block
constexpr int kVa = 432;        // rank -> symbol slots, >= n_sym
constexpr int kIa = 512;        // symbol -> rank slots, every 9-bit symbol
constexpr short kNoRank = 0x7FFF;

// step's quotient (isum >> 4) / cnt = isum / (16 cnt) is (isum * m) >> 34
// with m = 2^30 / cnt + 1 (rounded down, then up by one): the product
// exceeds isum / (16 cnt) by less than isum / 2^34, under 1 / (16 cnt) for
// isum < 2^34 / (16 * 432) = 2.48e6, so the floor is exact.
__device__ __forceinline__ unsigned step_magic(int cnt) {
  return (1u << 30) / static_cast<unsigned>(cnt) + 1u;
}

__device__ __forceinline__ int step_quotient(int isum, unsigned m) {
  return static_cast<int>(
      (static_cast<unsigned long long>(static_cast<unsigned>(isum)) * m) >>
      34);
}

__global__ void __launch_bounds__(kWarps * 32) symrank_kernel(
    const int* __restrict__ packed, const int* __restrict__ item_of,
    const int* __restrict__ grp_off, const int* __restrict__ grp_cnt,
    const int* __restrict__ init_perm, int* __restrict__ coded, int B, int m,
    int n_ctx, int n_sym) {
  __shared__ short s_va[kWarps][kVa];
  __shared__ short s_ia[kWarps][kIa];
  __shared__ int s_pk[kWarps][32];
  __shared__ int s_code[kWarps][32];
  __shared__ unsigned s_magic[kVa + 2];  // step_magic(cnt), cnt <= n_sym + 1
  for (int c = threadIdx.x; c < kVa + 2; c += blockDim.x)
    s_magic[c] = c > 0 ? step_magic(c) : 0u;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= B * n_ctx) return;  // whole warps only
  const int b = g / n_ctx;
  short* va = s_va[warp];
  short* ia = s_ia[warp];
  int* buf = s_pk[warp];
  int* codes = s_code[warp];
  const int* perm = init_perm + static_cast<size_t>(b) * n_sym;
  for (int r = lane; r < kIa; r += 32) ia[r] = kNoRank;
  __syncwarp();
  for (int r = lane; r < kVa; r += 32) {
    const int v = r < n_sym ? perm[r] : -1;
    va[r] = static_cast<short>(v);
    if (v >= 0 && v < kIa) ia[v] = static_cast<short>(r);
  }
  __syncwarp();
  for (int v = lane; v < n_sym; v += 32)  // the census order: a permutation
    if (ia[v] >= n_sym) __trap();

  const int off = grp_off[g];
  const int cnt = grp_cnt[g];
  const int* pk = packed + static_cast<size_t>(b) * m + off;
  const int* ix = item_of + static_cast<size_t>(b) * m + off;
  int* out = coded + static_cast<size_t>(b) * m;
  const int top = n_sym - 1;
  // lane 0's state, for the next item: its count, the decayed sum and the
  // count's reciprocal
  int c_cnt = 1, isum = 1000000;
  unsigned magic = s_magic[1];

  int next_pk = lane < cnt ? pk[lane] : 0;
  int next_ix = lane < cnt ? ix[lane] : 0;
  for (int base = 0; base < cnt; base += 32) {
    const int k = base + lane;
    const int my_ix = next_ix;
    if (k < cnt && (next_pk & 0x1FF) >= n_sym) __trap();  // not a symbol
    buf[lane] = next_pk;
    if (k + 32 < cnt) {  // the next batch, in flight while lane 0 works
      next_pk = pk[k + 32];
      next_ix = ix[k + 32];
    }
    __syncwarp();
    if (lane == 0) {
      const int nk = min(32, cnt - base);
      int pk0 = buf[0];
      int pk1 = nk > 1 ? buf[1] : 0;
      int i = ia[pk0 & 0x1FF];
      // the previous item's three writes, issued one item late (first a
      // no-op rewrite of this item's symbol at its own rank)
      int pv = pk0 & 0x1FF, pnv1 = pv, pnv2 = pv, pi = i, pni1 = i, pnx = i;
      for (int t = 0; t < nk; ++t) {
        const int v = pk0 & 0x1FF;
        const int u = (pk0 >> 9) & 0xFF;
        const int vn = pk1 & 0x1FF;
        const int pk2 = t + 2 < nk ? buf[t + 2] : 0;
        // loaded before the previous item's writes land; fixed up below
        int x_next = ia[vn];
        int x_u = ia[u];
        // the chain
        isum += i;
        const int q = step_quotient(isum, magic);
        const int next_i = max(max(i - (i >> 4) - (q & 0xFFFF), 0), i >> 1);
        const int d = i - next_i;
        const int ni1 = (d == 1) ? i : next_i + (d >> 1);  // i when d == 0
        // the previous item's writes, then this item's reads of va
        va[pi] = static_cast<short>(pnv1);
        ia[pnv1] = static_cast<short>(pi);
        va[pni1] = static_cast<short>(pnv2);
        ia[pnv2] = static_cast<short>(pni1);
        va[pnx] = static_cast<short>(pv);
        ia[pv] = static_cast<short>(pnx);
        const int nv2 = va[next_i];
        const int nv1 = (d == 1) ? nv2 : va[ni1];
        // ia[vn] and ia[u] after the previous item's writes (latest first)
        x_next = vn == pv ? pnx : vn == pnv2 ? pni1 : vn == pnv1 ? pi : x_next;
        x_u = u == pv ? pnx : u == pnv2 ? pni1 : u == pnv1 ? pi : x_u;
        codes[t] = (v == u) ? top : i - (i > x_u ? 1 : 0);
        // and after this item's: vn moved iff it is v, or its rank was
        // next_i (it is nv2) or ni1 (nv1)
        const int i_next = vn == v ? next_i
                           : x_next == next_i ? ni1
                           : x_next == ni1    ? i
                                              : x_next;
        pv = v;
        pnv1 = nv1;
        pnv2 = nv2;
        pi = i;
        pni1 = ni1;
        pnx = next_i;
        if (c_cnt > n_sym) {  // the next item's count and sum
          c_cnt = c_cnt * 9 / 10;
          isum = isum * 9 / 10;
        }
        c_cnt += 1;
        magic = s_magic[c_cnt];
        i = i_next;
        pk0 = pk1;
        pk1 = pk2;
      }
      va[pi] = static_cast<short>(pnv1);  // the last item's writes
      ia[pnv1] = static_cast<short>(pi);
      va[pni1] = static_cast<short>(pnv2);
      ia[pnv2] = static_cast<short>(pni1);
      va[pnx] = static_cast<short>(pv);
      ia[pv] = static_cast<short>(pnx);
    }
    __syncwarp();
    if (k < cnt) out[my_ix] = codes[lane];
  }
}

}  // namespace

extern "C" int otz_symrank(const int* packed, const int* item_of,
                           const int* grp_off, const int* grp_cnt,
                           const int* init_perm, int* coded, int B, int m,
                           int n_ctx, int n_sym, int table_rows,
                           void* stream) {
  if (table_rows > kVa || n_sym > table_rows || n_sym > kIa)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = B * n_ctx;
  symrank_kernel<<<(groups + kWarps - 1) / kWarps, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      packed, item_of, grp_off, grp_cnt, init_perm, coded, B, m, n_ctx,
      n_sym);
  return static_cast<int>(cudaGetLastError());
}
