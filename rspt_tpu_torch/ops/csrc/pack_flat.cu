// pack_flat: Huffman code lookup + block-local exclusive bit scan +
// placement of every token's bits into the flat payload words; in its
// lanes mode also the decoder's segment entry lanes (decode hints).
//
// Replaces K4, rspt_tpu/ops/pallas_kernels.py:
// token_group_windows_rows_pallas (_windows_core, :393-504, :818-867),
// the cumsum glue of rspt_tpu/hzr/jax_coder.py:648-670, and K5,
// super_place_flat_pallas (_super_place_body, :599-778). The lanes mode
// (pack_flat_lanes_kernel) also replaces K10,
// token_group_windows_grouped_off_pallas (:381-390, :870-904), and K11,
// sidecar_entries_pallas (:1440-1591).
//
// Block b's tokens are tokc[tok_base[b] .. + ntok[b]) (compacted, in
// stream order; ntok[b] = 0 for FILL/COPY/dead blocks). With
// e = lut[b][sym] = code | cbits << 24 (code < 2^cbits, cbits <= 23):
//   nbits = cbits + ebits (0 for an invalid word)
//   value = code | extra << cbits                (<= 37 bits)
//   bit   = bit0[b] + sum of nbits of the block's earlier tokens
// and value lands LSB-first at absolute bit `bit` of `out`, which is
// zeroed by the caller. bit0[b] = 8 * payload offset + description bits,
// so the host OR-merges the tree descriptions afterwards. Tokens at or
// past tokc's end read as invalid.
//
// Entry lanes: with meta[b] = (W, lane_base, dbits), W = segw * 32 the
// decoder's segment width in bits, a token whose span [x, x + nbits)
// (x = bit - bit0[b], body-relative) crosses a segment boundary,
// floor(x / W) < s = floor((x + nbits) / W), and that is not the block's
// last token writes dbits + x + nbits, the start of the first token at
// or after the boundary s * W, to entries[lane_base + s]. nbits <= 37 < W,
// so each segment gets at most one store: no races. Lanes without a
// store keep what the caller put there; lane_base < 0 skips a block. The
// TPU splits this into K10 (per-token offsets out of the windows kernel)
// and K11 (an MXU placement of the flagged starts) because of its
// windows and one-hot placement; here every token already has its bit.
//
// Design. The work unit is a tile of kTile = 2,048 tokens of one block
// (256 threads), never two blocks: a CTA takes a ticket from an atomic
// counter and maps it to (block, tile in block) by a scan of the blocks'
// tile counts that it computes itself (one pass over nb, once a CTA).
// The main path's 14 HUFF blocks give 320 working CTAs over the 132
// SMs, where one 1,024-thread CTA a block used 14 and walked ~6 tiles in
// series. The grid is ceil(ntokc / kTile) + nb CTAs, a bound the host
// knows without reading ntok; the rest exit at once, and a CTA draws
// tickets until one is past the last tile (blocks whose token ranges
// overlap can need more tiles than the grid). Warp w reads tokens
// [256 w, 256 w + 256) of its tile in 8 rounds of 32 consecutive words
// (coalesced 128-byte loads, all 8 in flight); a warp scan a round and
// a scan of the warp totals give each token its tile-relative bit.
// The block's carry crosses its tiles by a single-pass decoupled
// look-back on 64-bit status words (flag | bits): a tile publishes its
// own bit count as soon as warp 0 has it, then walks back over its
// block's earlier tiles, 32 at a time, to the nearest one that has
// published its inclusive prefix, and publishes its own. Tickets are
// drawn in order, so a tile waits only on tiles held by running CTAs
// (no deadlock), and the result does not depend on the ticket order.
// The look-back and the word stores are common.cuh's, shared with
// pack_blocks.cu.
// Tickets past the status words (only overlapping blocks reach them)
// sum their block's earlier tokens directly. The tile's bits are one
// contiguous range of at most kTile * 37 bits, so its words are
// assembled in shared memory with shared atomicOr; then the CTA stores
// the interior words with plain coalesced stores and only the first and
// last word, which a neighbouring tile, block or description may share,
// with a global atomicOr. Nothing is written at or past nwords. The
// wrapper zeroes the output (COPY, FILL and description bits stay 0 for
// the host's OR), the tickets and the status words in one memset.
// A tile's words fit the shared buffer for every LUT and token within
// the contract (cbits <= 23, ebits <= 14); a tile past it stops the
// launch (__trap) rather than write outside the buffer.
// kernel_ab.py on the H100, both modes: tiles of 4,096 tokens (512
// threads) 1.09-1.10x slower, of 8,192 (1,024 threads) 1.09-1.15x; a
// first launch of tile sums 1.37-1.49x; a global atomicOr a field
// instead of the shared words 1.25-1.42x.
// Bound: bytes - the compacted tokens read once, the payload written once
// (the lanes mode adds the per-block meta read and one int32 per entry
// lane written).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinCtas = 2;                  // resident CTAs an SM
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kWarpSpan = 32 * kRounds;      // tokens a warp owns
constexpr int kTile = kWarps * kWarpSpan;    // 2,048 tokens
constexpr int kNSym = 261;
constexpr int kMaxBits = 37;                 // cbits <= 23, ebits <= 14
constexpr int kWords = kTile * kMaxBits / 32 + 2;  // a tile's words

struct Args {
  const int32_t* tokc;
  const int32_t* tok_base;
  const int32_t* ntok;
  const int64_t* bit0;
  const int32_t* lut;
  uint32_t* out;
  const int32_t* meta;
  int32_t* entries;
  int* ticket;                    // the tile ticket counter
  unsigned long long* status;     // nstatus words, one a tile (ticket)
  int nb, ntokc, nwords, nlanes, nstatus;
};

struct Smem {
  uint32_t words[kWords];
  int32_t lut[kNSym];
  int warp[kWarps];               // warp bit totals, then their offsets
  int scan[32];
  long long red[kWarps];
  long long prefix;               // the block's bits before the tile
  int total;                      // the tile's bits
  int ntiles, ticket, blk, tile;
};

// Tokens of block b that can be read: ntok[b] cut at tokc's end.
__device__ __forceinline__ int packable(const Args& a, int b) {
  const int base = a.tok_base[b];
  const int avail = base < 0 ? 0 : a.ntokc - base;
  return max(0, min(a.ntok[b], avail));
}

__device__ __forceinline__ int tiles_of(const Args& a, int b) {
  const int m = packable(a, b);
  return m > 0 ? (m - 1) / kTile + 1 : 0;
}

__device__ __forceinline__ int token_bits(const Smem& s, int32_t w) {
  const int sym = w & 511;
  if (!((w >> 27) & 1) || sym >= kNSym) return 0;
  return (int)((uint32_t)s.lut[sym] >> 24) + ((w >> 9) & 15);
}

__device__ __forceinline__ uint64_t token_value(const Smem& s, int32_t w) {
  const uint32_t e = (uint32_t)s.lut[w & 511];
  return (uint64_t)(e & 0xFFFFFFu) |
         ((uint64_t)((w >> 13) & 16383) << (e >> 24));
}

template <bool kLanes>
__device__ __forceinline__ void pack_tiles(const Args& a, Smem& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this thread's blocks [b_lo, b_hi) and the ticket of their first tile
  const int per = (a.nb + kThreads - 1) / kThreads;
  const int b_lo = min(tid * per, a.nb);
  const int b_hi = min(b_lo + per, a.nb);
  int mine = 0;
  for (int b = b_lo; b < b_hi; ++b) mine += tiles_of(a, b);
  // the first ticket by a thread that holds no block when nb < kThreads,
  // in flight during the scan (whose barriers publish it)
  if (tid == kThreads - 1) s.ticket = atomicAdd(a.ticket, 1);
  const int first = rspt::block_scan_excl(mine, 0, rspt::OpSum(), false,
                                          s.scan, &s.ntiles);
  const int ntiles = s.ntiles;
  for (bool next = false;; next = true) {
    if (next) {
      __syncthreads();  // the previous tile's shared words and fields read
      if (tid == 0) s.ticket = atomicAdd(a.ticket, 1);
      __syncthreads();
    }
    const int g = s.ticket;
    if (g >= ntiles) return;  // the same in every thread
    if (first <= g && g < first + mine) {
      int k = g - first, b = b_lo;
      for (int nt; k >= (nt = tiles_of(a, b)); ++b) k -= nt;
      s.blk = b;
      s.tile = k;
    }
    __syncthreads();
    const int b = s.blk, t = s.tile;
    const int n = a.ntok[b];
    const int rem = packable(a, b) - t * kTile;  // >= 1 tokens from here
    const int32_t* toks = a.tokc + a.tok_base[b] + (int64_t)t * kTile;
    const int i0 = warp * kWarpSpan + lane;      // tile-relative index
    int32_t w[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int i = i0 + r * 32;
      w[r] = i < rem ? toks[i] : 0;
    }
    for (int k = tid; k < kNSym; k += kThreads)
      s.lut[k] = a.lut[(int64_t)b * kNSym + k];
    for (int k = tid; k < kWords; k += kThreads) s.words[k] = 0;
    __syncthreads();
    int off[kRounds];   // each token's bit in its warp's span
    int run = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int nb = token_bits(s, w[r]);
      const int incl = rspt::warp_scan_incl(nb, rspt::OpSum(), false);
      off[r] = run + incl - nb;
      run += __shfl_sync(rspt::kFull, incl, 31);
    }
    if (lane == 0) s.warp[warp] = run;
    __syncthreads();
    const bool direct = g >= a.nstatus;
    if (warp == 0) {
      const int v = lane < kWarps ? s.warp[lane] : 0;
      const int incl = rspt::warp_scan_incl(v, rspt::OpSum(), false);
      const int total = __shfl_sync(rspt::kFull, incl, 31);
      if (lane < kWarps) s.warp[lane] = incl - v;
      long long prefix = 0;
      if (!direct) {
        if (lane == 0) rspt::publish(a.status, g, t, total);
        prefix = rspt::look_back(a.status, g, t, total);
      }
      if (lane == 0) {
        s.prefix = prefix;
        s.total = total;
      }
    }
    __syncthreads();
    if (direct) {
      // the bits of the block's tokens before this tile, summed here
      const int32_t* head = a.tokc + a.tok_base[b];
      long long sum = 0;
      for (int64_t i = tid; i < (int64_t)t * kTile; i += kThreads)
        sum += token_bits(s, head[i]);
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(rspt::kFull, sum, o);
      if (lane == 0) s.red[warp] = sum;
      __syncthreads();
      if (tid == 0) {
        long long p = 0;
        for (int k = 0; k < kWarps; ++k) p += s.red[k];
        s.prefix = p;
      }
      __syncthreads();
    }
    const long long prefix = s.prefix;
    const int64_t tile_bit = a.bit0[b] + prefix;
    const int s0 = (int)(tile_bit & 31);
    const int64_t w0 = tile_bit >> 5;
    const int nw = (int)(((long long)s0 + s.total + 31) >> 5);
    if (nw > kWords) __trap();  // a LUT or token outside the contract
    const int wbase = s.warp[warp];
    int W = 1, lane_base = -1, dbits = 0;
    if (kLanes) {
      W = a.meta[3 * b];
      lane_base = a.meta[3 * b + 1];
      dbits = a.meta[3 * b + 2];
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      // the bit count again (a shared LUT read) rather than 8 registers
      // kept live across the look-back
      const int nb = token_bits(s, w[r]);
      if (!nb) continue;
      const uint64_t val = token_value(s, w[r]);
      const int x = wbase + off[r];            // tile-relative bit
      const int lb = s0 + x;
      const int sh = lb & 31;
      const int wi = lb >> 5;
      const uint64_t lo = val << sh;
      if ((uint32_t)lo) atomicOr(s.words + wi, (uint32_t)lo);
      if ((uint32_t)(lo >> 32) && wi + 1 < nw)
        atomicOr(s.words + wi + 1, (uint32_t)(lo >> 32));
      if (sh && (uint32_t)(val >> (64 - sh)) && wi + 2 < nw)
        atomicOr(s.words + wi + 2, (uint32_t)(val >> (64 - sh)));
      if (kLanes && lane_base >= 0) {
        // body-relative start and end, < 2^19: a payload is < 64 KiB
        const int xb = (int)prefix + x;
        const int end = xb + nb;
        const int seg = (int)((unsigned)end / (unsigned)W);
        const int i = i0 + r * 32;
        const int64_t ln = (int64_t)lane_base + seg;
        // a crossing token that is not the block's last one
        if (seg * W > xb && t * kTile + i + 1 < n && ln < a.nlanes)
          a.entries[ln] = dbits + end;
      }
    }
    __syncthreads();
    rspt::store_tile(s.words, nw, a.out, w0, a.nwords);
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
pack_flat_kernel(Args a) {
  __shared__ Smem s;
  pack_tiles<false>(a, s);
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
pack_flat_lanes_kernel(Args a) {
  __shared__ Smem s;
  pack_tiles<true>(a, s);
}

// Status words: one a tile when blocks do not overlap in tokc.
int status_words(int nb, int ntokc) {
  return (int)(((int64_t)ntokc + kTile - 1) / kTile) + nb;
}

template <bool kLanes>
int launch(Args a, cudaStream_t stream) {
  a.nstatus = status_words(a.nb, a.ntokc);
  if (kLanes) {
    pack_flat_lanes_kernel<<<a.nstatus, kThreads, 0, stream>>>(a);
  } else {
    pack_flat_kernel<<<a.nstatus, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

Args make_args(const void* tokc, const void* tok_base, const void* ntok,
               const void* bit0, const void* lut, void* out, void* state,
               int nb, int ntokc, int nwords) {
  Args a{};
  a.tokc = (const int32_t*)tokc;
  a.tok_base = (const int32_t*)tok_base;
  a.ntok = (const int32_t*)ntok;
  a.bit0 = (const int64_t*)bit0;
  a.lut = (const int32_t*)lut;
  a.out = (uint32_t*)out;
  a.ticket = (int*)state;
  a.status = (unsigned long long*)state + 1;
  a.nb = nb;
  a.ntokc = ntokc;
  a.nwords = nwords;
  return a;
}

}  // namespace

// int32 words of the state buffer rspt_pack_flat takes: one 64-bit word
// for the tile ticket, then one 64-bit status word a tile.
extern "C" int rspt_pack_flat_state(int nb, int ntokc) {
  return 2 * (1 + status_words(nb, ntokc));
}

// Tokens a tile (a CTA's work unit).
extern "C" int rspt_pack_flat_tile() { return kTile; }

// tokc: ntokc compacted token words; tok_base, ntok: nb int32; bit0: nb
// int64; lut: (nb, 261) int32; out: nwords payload words, zeroed by the
// caller (a zero contribution is never written, and nothing at or past
// nwords); state: rspt_pack_flat_state(nb, ntokc) int32, 8-byte
// aligned, zeroed by the caller. Returns cudaGetLastError().
extern "C" int rspt_pack_flat(const void* tokc, const void* tok_base,
                              const void* ntok, const void* bit0,
                              const void* lut, void* out, void* state,
                              int nb, int ntokc, int nwords, void* stream) {
  return launch<false>(make_args(tokc, tok_base, ntok, bit0, lut, out, state,
                                 nb, ntokc, nwords),
                       (cudaStream_t)stream);
}

// rspt_pack_flat's arguments plus meta: (nb, 3) int32 (W, lane_base,
// dbits) and entries: nlanes int32 the caller filled with its init plane
// (nothing is written at or past nlanes). Returns cudaGetLastError().
extern "C" int rspt_pack_flat_lanes(const void* tokc, const void* tok_base,
                                    const void* ntok, const void* bit0,
                                    const void* lut, void* out,
                                    const void* meta, void* entries,
                                    void* state, int nb, int ntokc,
                                    int nwords, int nlanes, void* stream) {
  Args a = make_args(tokc, tok_base, ntok, bit0, lut, out, state, nb, ntokc,
                     nwords);
  a.meta = (const int32_t*)meta;
  a.entries = (int32_t*)entries;
  a.nlanes = nlanes;
  return launch<true>(a, (cudaStream_t)stream);
}
