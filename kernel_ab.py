"""Design A/B of the port's CUDA kernels on one card.

    python3 kernel_ab.py [--rounds 3] [--only hzr_decode.cu,tokenize.cu]
                         [--baseline DIR] [--variants NAME,NAME]

Builds variants of ops/csrc/xdelta.cu, hzr_decode.cu, tokenize.cu,
compact.cu, place_literals.cu, pack_flat.cu, fwht.cu, pack_blocks.cu,
dct.cu, peaks.cu, iir.cu, fir.cu and windows.cu (--variants keeps the
named ones),
each the committed source with some of its constants (or a line)
replaced, into one shared library apiece (nvcc, sm_90a, all at once),
and times each variant at the main path's shapes (the chip_smoke inputs:
BASELINE config 2's signal for xdelta_swizzle, as its '<i4' words with 3
planes and as 16-bit native bytes with 1 plane (the flag on; a source
without the byte form runs native_to_i32 first, as the packer did before),
its device decode batch for hzr_decode, its xdelta signal for
tokenize_planes, its pass 1 for compact_tokens and, compacted, for both
modes of pack_flat, its device decode's emissions for place_literals,
config 3's centred rows for fwht, the main payload as one stream for
pack_blocks, the main pass 1 for pack_blocks_tokw and BASELINE config
4's centred rows and their coefficients for dct_forward and
dct_inverse, chip_smoke phase 16's full-width detect_batch gate for
peak_gate and its 12 x 2^20 signal through the offline threshold's
low-pass, float32 and float64, for iir_scan; that signal through
detect_batch's band-pass from its warm-up state, float32 and float64, and
its threshold low-pass for iir_assoc at tiles of 512, and through phase
16's 61-tap FIR for fir_apply, its pass 1's 83 windows groups for
group_windows, place_windows_aligned and windows_place_flat) beside the
library call that computes the
same function where there is one (for the DCT pair an f64 torch.matmul and
for the FIR cuDNN's conv1d, neither exact), in
turns, by torch.profiler device time of the whole call (every kernel
and memset of it; mean of 30 calls a round, medians over the rounds
printed).
--baseline DIR adds the varied kernels' sources found in DIR (the csrc
of an earlier checkout) as variant "baseline", and BASELINE_TABLES'
variants of it (diagnostic cuts of the K14 of a windows.cu that takes
one CTA a group) as "baseline_<name>". windows.cu's variants that
compute the function, and the baseline, are also held against the plain
versions on tests/test_torch_cuda.py's windows edge cases, K14's own
cases and 160 groups (the baseline's disagreements are printed, not
raised). pack_flat's
two_launches and global_atomics variants put back designs that lost
this A/B (a first launch of tile sums; a global atomicOr a token
field). Variants marked "diag" drop work (their output is not the
function's) to show what the rest costs; every other variant is first
checked bit for bit against the plain version (peak_gate and iir_scan:
against the committed kernel, which chip_smoke holds against the plain
version at the same shapes; iir_assoc and fir_apply against their plain
versions on the card). Prints the card's name
and power limit and one JSON line of the medians. Needs a CUDA card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "rspt_tpu_torch" / "ops" / "csrc"

COMPACT = {   # name: (replacements, diag)
    "tile4096_t512": ({}, False),
    "tile4096_t256": ({"kThreads = 512;": "kThreads = 256;",
                       "kRounds = 8;": "kRounds = 16;"}, False),
    "tile2048_t256": ({"kThreads = 512;": "kThreads = 256;"}, False),
    "tile4096_t1024": ({"kThreads = 512;": "kThreads = 1024;",
                        "kRounds = 8;": "kRounds = 4;"}, False),
    "tile8192_t512": ({"kRounds = 8;": "kRounds = 16;"}, False),
}
# a lane's kSub threads on neighbouring threads of a warp instead of in
# kSub different warps
_ADJ = {"  const int lane = threadIdx.x % kLanes;\n"
        "  const int r0 = threadIdx.x / kLanes * kRows;":
        "  const int lane = threadIdx.x / kSub;\n"
        "  const int r0 = threadIdx.x % kSub * kRows;"}
PLACE = {
    "chunk16_sub2_split16": ({}, False),
    "chunk16_sub1_split16": ({"kSub = 2;": "kSub = 1;"}, False),
    "chunk8_sub1_split32": ({"kChunk = 16;": "kChunk = 8;",
                             "kSplit = 16;": "kSplit = 32;",
                             "kSub = 2;": "kSub = 1;"}, False),
    "chunk8_sub2_split32": ({"kChunk = 16;": "kChunk = 8;",
                             "kSplit = 16;": "kSplit = 32;"}, False),
    "chunk16_sub2_split8": ({"kSplit = 16;": "kSplit = 8;"}, False),
    "chunk32_sub2_split8": ({"kChunk = 16;": "kChunk = 32;",
                             "kSplit = 16;": "kSplit = 8;"}, False),
    "chunk32_sub4_split8": ({"kChunk = 16;": "kChunk = 32;",
                             "kSplit = 16;": "kSplit = 8;",
                             "kSub = 2;": "kSub = 4;"}, False),
    "chunk16_sub2_split16_lanes64": ({"kLanes = 128;": "kLanes = 64;"},
                                     False),
    "diag_no_walk": ({"    if (live) {": "    if (live && n < 0) {"}, True),
    "diag_no_stores": ({
        "    atomicOr(words + w, bits);":
        "    if (bits == 0x5a5a5a5au) atomicOr(words + w, bits);",
        "        if (flush && !first) words[cur] = bits;":
        "        if (flush && !first && bits == 0x5a5a5a5au) words[cur] = bits;"},
        True),
}


DECODE = {
    "cluster8_smem_skip": ({}, False),
    "cluster4": ({"kRowsPerCta = 1;": "kRowsPerCta = 2;"}, False),
    "cluster8_levels_l1": ({"kLevelsShared = true;":
                            "kLevelsShared = false;"}, False),
    # every lane decodes every sweep, changed entry or not
    "cluster8_decode_all": ({"kSkipSame = true;": "kSkipSame = false;"},
                            False),
    # pad short lanes after every sweep instead of once after the last
    "cluster8_pad_each_sweep": ({
        "    tot = tile_totals(cluster, rank, nch, o, s_warp, s_part, par);\n":
        "    tot = tile_totals(cluster, rank, nch, o, s_warp, s_part, par);\n"
        "    for (int s = o.steps; s < tot.y; ++s)\n"
        "      emit(erow, s, (int32_t)((uint32_t)o.outc << 9));\n"}, False),
    "diag_no_stores": ({"  erow[(int64_t)s * kTileLanes] = v;":
                        "  if (v == -7) erow[(int64_t)s * kTileLanes] = v;"},
                       True),
    # one sweep of every lane from its given entry (the trusted path)
    "diag_one_sweep": ({"  const bool trust = p.ntc[t * 5 + 4] != 0;":
                        "  const bool trust = true;"}, True),
    # launch, table staging and the first cluster barrier only
    "diag_staging_only": ({
        "  int entry = entry0, nentry = nentry0, done = entry0;":
        "  if (entry0 != -7) return;\n"
        "  int entry = entry0, nentry = nentry0, done = entry0;"}, True),
}
TOKENIZE = {
    "tile2048_summary": ({}, False),
    "tile4096_summary": ({"kTile = 2048;": "kTile = 4096;"}, False),
    "tile8192_summary": ({"kTile = 2048;": "kTile = 8192;",
                          "kPer = 4;": "kPer = 8;"}, False),
    "tile2048_scan": ({"kSummary = true;": "kSummary = false;"}, False),
    "tile4096_scan": ({"kTile = 2048;": "kTile = 4096;",
                       "kSummary = true;": "kSummary = false;"}, False),
    "tile2048_per8": ({"kPer = 4;": "kPer = 8;"}, False),
    "tile4096_per8": ({"kTile = 2048;": "kTile = 4096;",
                       "kPer = 4;": "kPer = 8;"}, False),
    "diag_no_hist": ({
        "          if (hcnt) atomicAdd(&h[p][hsym], hcnt);":
        "          if (hcnt == -7) atomicAdd(&h[p][hsym], hcnt);",
        "    if (hcnt) atomicAdd(&h[p][hsym], hcnt);":
        "    if (hcnt == -7) atomicAdd(&h[p][hsym], hcnt);"}, True),
}
# per-tile bit counts in a first launch (each tile publishes its own
# count and stops), then the placement launch on the second int32 of the
# ticket word, its look-backs over the first launch's counts
_TWO_LAUNCHES = {
    "  int nb, ntokc, nwords, nlanes, nstatus;":
    "  int nb, ntokc, nwords, nlanes, nstatus, sums;",
    "        prefix = rspt::look_back(a.status, g, t, total);":
    "        if (!a.sums) prefix = rspt::look_back(a.status, g, t, total);",
    "    __syncthreads();\n    if (direct) {":
    "    __syncthreads();\n    if (a.sums) continue;\n    if (direct) {",
    "  a.nstatus = status_words(a.nb, a.ntokc);\n":
    "  a.nstatus = status_words(a.nb, a.ntokc);\n"
    "  Args sums = a;\n"
    "  sums.sums = 1;\n"
    "  pack_flat_kernel<<<a.nstatus, kThreads, 0, stream>>>(sums);\n"
    "  a.ticket += 1;\n"}
# a global atomicOr a token field into the output (the one-CTA-a-block
# kernel's store) instead of the words built in shared memory
_GLOBAL_ATOMICS = {
    "    for (int k = tid; k < kWords; k += kThreads) s.words[k] = 0;\n": "",
    "      const int lb = s0 + x;\n"
    "      const int sh = lb & 31;\n"
    "      const int wi = lb >> 5;\n"
    "      const uint64_t lo = val << sh;\n"
    "      if ((uint32_t)lo) atomicOr(s.words + wi, (uint32_t)lo);\n"
    "      if ((uint32_t)(lo >> 32) && wi + 1 < nw)\n"
    "        atomicOr(s.words + wi + 1, (uint32_t)(lo >> 32));\n"
    "      if (sh && (uint32_t)(val >> (64 - sh)) && wi + 2 < nw)\n"
    "        atomicOr(s.words + wi + 2, (uint32_t)(val >> (64 - sh)));\n":
    "      const int64_t bit = tile_bit + x;\n"
    "      const int sh = (int)(bit & 31);\n"
    "      const int64_t wi = bit >> 5;\n"
    "      const uint64_t lo = val << sh;\n"
    "      const uint32_t f[3] = {(uint32_t)lo, (uint32_t)(lo >> 32),\n"
    "                             sh ? (uint32_t)(val >> (64 - sh)) : 0u};\n"
    "      for (int k = 0; k < 3; ++k)\n"
    "        if (f[k] && wi + k < a.nwords) atomicOr(a.out + wi + k, f[k]);\n",
    "    rspt::store_tile(s.words, nw, a.out, w0, a.nwords);\n": ""}
PACK = {
    "tile2048_t256": ({}, False),
    "tile4096_t512": ({"kThreads = 256;": "kThreads = 512;"}, False),
    "tile2048_t512": ({"kTileWords = 4096;": "kTileWords = 2048;",
                       "kThreads = 256;": "kThreads = 512;"}, False),
    "tile4096_t1024": ({"kThreads = 256;": "kThreads = 1024;"}, False),
    "tile8192_t1024": ({"kThreads = 256;": "kThreads = 1024;",
                        "kMinCtas = 2;": "kMinCtas = 1;"}, False),
    "two_launches": (_TWO_LAUNCHES, False),
    "global_atomics": (_GLOBAL_ATOMICS, False),
    # every tile starts its block at bit 0: no look-back wait
    "diag_no_lookback": ({
        "        prefix = rspt::look_back(a.status, g, t, total);": ""},
        True),
    # no token's fields ORed into the words (nor lanes stored)
    "diag_no_token_or": ({"      if (!nb) continue;":
                          "      if (nb >= 0) continue;"}, True),
    # no word stores from shared memory to the output
    "diag_no_word_stores": ({
        "    rspt::store_tile(s.words, nw, a.out, w0, a.nwords);\n": ""},
        True),
}
# fwht at 2^14: a cluster of 2^14 / 2^kCtaLog CTAs a row, 2^kItemsLog
# words a thread
FWHT = {
    "cluster8_items8": ({}, False),
    "cluster16_items8": ({"kCtaLog = 11;": "kCtaLog = 10;"}, False),
    "cluster8_items16": ({"kItemsLog = 3;": "kItemsLog = 4;"}, False),
    "cluster16_items16": ({"kCtaLog = 11;": "kCtaLog = 10;",
                           "kItemsLog = 3;": "kItemsLog = 4;"}, False),
    "cluster4_items16": ({"kCtaLog = 11;": "kCtaLog = 12;",
                          "kItemsLog = 3;": "kItemsLog = 4;"}, False),
    # the cluster stage reads the CTA's own words instead of its peers'
    "diag_no_dsmem": ({
        "c[q] = *cluster.map_shared_rank(s + j, q);": "c[q] = s[j];"},
        True),
}
BLOCKS = {
    "tile2048_t256": ({}, False),
    "tile4096_t512": ({"kThreads = 256;": "kThreads = 512;",
                       "kMinCtasFields = 8;": "kMinCtasFields = 4;"}, False),
    "tile4096_t256": ({"kRounds = 8;": "kRounds = 16;"}, False),
    # registers for other counts of resident CTAs an SM (K13a 8, K13b 2)
    "minctas2_8": ({"kMinCtasFields = 8;": "kMinCtasFields = 2;",
                    "kMinCtasTokw = 2;": "kMinCtasTokw = 8;"}, False),
    "minctas4_4": ({"kMinCtasFields = 8;": "kMinCtasFields = 4;",
                    "kMinCtasTokw = 2;": "kMinCtasTokw = 4;"}, False),
    # one ticket counter for every tile instead of one a block:
    # (block, tile) = divmod(ticket, tiles)
    "one_ticket": ({
        "  const int b = blockIdx.x / a.tiles;\n"
        "  if (tid == 0) s.ticket = atomicAdd(a.ticket + 2 * b, 1);":
        "  if (tid == 0) s.ticket = atomicAdd(a.ticket, 1);",
        "  const int t = s.ticket;":
        "  const int b = s.ticket / a.tiles;\n"
        "  const int t = s.ticket - b * a.tiles;"}, False),
    # a thread's first and last words by atomicOr, the words between by
    # plain stores
    "stores_between": ({
        "      atomicOr(words + wi++, t0);\n      t0 = t1;\n      t1 = t2;":
        "      if (first) atomicOr(words + wi++, t0); else words[wi++] = t0;\n"
        "      first = false;\n      t0 = t1;\n      t1 = t2;",
        "        atomicOr(words + wi++, t0);\n        t0 = t1;\n      }":
        "        words[wi++] = t0;\n        t0 = t1;\n      }",
        "  uint32_t cur = 0;       // those bits":
        "  uint32_t cur = 0;       // those bits\n  bool first = true;"}, False),
    # the tile of blockIdx.x, no ticket: what the ticket's round trip costs
    "diag_no_ticket": ({
        "  if (tid == 0) s.ticket = atomicAdd(a.ticket + 2 * b, 1);":
        "  if (tid == 0) s.ticket = blockIdx.x - b * a.tiles;"}, True),
    # no word stores from shared memory to the rows
    "diag_no_word_stores": ({
        "  rspt::store_tile(": "  if (s0 < 0) rspt::store_tile("}, True),
    # no token's bits ORed into the shared words
    "diag_no_token_or": ({"    if (!nb) continue;":
                          "    if (nb >= 0) continue;"}, True),
    # every tile starts its block at bit desc_bits: no look-back wait
    "diag_no_lookback": ({
        "    const long long prefix = rspt::look_back(a.status, g, t, s.total);":
        "    const long long prefix = 0;"}, True),
}
# xdelta_swizzle: tiles of kTileWords samples (S = 128, 256, 512 at the
# main path's 12 channels), with 16-byte loads or one word (byte) a load
# xdelta_swizzle: tiles sized to fill 1 or 2 CTAs an SM (S = 272 or 144
# samples at the main path's 12 channels), 6 (the default), 2, 4 or 12
# channels a thread (544, 864, 816 or 288 threads; at 2, S drops to 144),
# with 16-byte loads or one sample a load
XDELTA = {
    "waves1_chunk6": ({}, False),
    "waves2_chunk6": ({"kMinWaves = 1;": "kMinWaves = 2;"}, False),
    "waves1_chunk6_scalar": ({"kVector = true;": "kVector = false;"}, False),
    "waves2_chunk6_scalar": ({"kMinWaves = 1;": "kMinWaves = 2;",
                              "kVector = true;": "kVector = false;"}, False),
    "waves1_chunk2": ({"kChunk = 6;": "kChunk = 2;"}, False),
    "waves1_chunk4": ({"kChunk = 6;": "kChunk = 4;"}, False),
    "waves1_chunk12": ({"kChunk = 6;": "kChunk = 12;"}, False),
    # no flag and no ticket: what the flag's atomic costs
    "diag_no_ticket": ({"  a.check = nr_planes < bps;": "  a.check = 0;"},
                       True),
    # the launch alone: every CTA returns at once
    "diag_empty": ({"  const int tid = threadIdx.x;":
                    "  if (a.ns > 0) return;\n  const int tid = threadIdx.x;"},
                   True),
    # stage A alone (the tile's loads, the halo)
    "diag_a_only": ({"  __syncthreads();\n\n  // stage B":
                     "  __syncthreads();\n  if (a.ns > 0) return;\n\n"
                     "  // stage B"}, True),
    "diag_no_halo": ({"    for (int u = tid; u < 2 * cb; u += nthreads) {":
                      "    for (int u = tid; u < 2 * cb && a.ns < 0; "
                      "u += nthreads) {"}, True),
    # no output stores
    "diag_no_stores": ({"      if (cg + q < cb) out[q * a.ns]":
                        "      if (cg + q < cb && x[q] == 7u) out[q * a.ns]"},
                       True),
}
# dct_forward / dct_inverse at BASELINE config 4 (12 x 4,096): chunks
# of 128 x (the default) or 64, 8 warps (channels) a CTA, and the f32 ->
# f64 widening by integer bit operations in place of F2F (exact here: no
# product is subnormal, and a zero keeps its sign)
DCT = {
    "x128": ({}, False),
    "x64": ({"kX = 128;": "kX = 64;"}, False),
    "w8_x128": ({"kWarps = 4;": "kWarps = 8;"}, False),
    "x128_bits": ({"  return (double)p;\n":
                   "  const uint32_t u = __float_as_uint(p);\n"
                   "  const uint32_t m = u & 0x7fffffffu;\n"
                   "  const uint32_t hi = m ? ((m >> 3) + 0x38000000u) | "
                   "(u & 0x80000000u) : u;\n"
                   "  return __hiloint2double((int)hi, (int)(u << 29));\n"},
                  False),
    # no widening: the products' conversions dropped, the f64 adds kept
    "diag_no_widen": ({"  return (double)p;": "  return 1.0;"}, True),
    # no copies after the first chunk: every chunk sums the first's words
    "diag_no_copies": ({"    if (more) fetch((ck + 1) * kX, b ^ 1);":
                        "    if (more && n < 0) fetch((ck + 1) * kX, b ^ 1);"},
                       True),
}
# peak_gate (S4) on detect_batch's full-width gate: chunks of 1,024 from a
# 512-sample warm-up (the default), other chunks and warm-ups, fewer
# stages in flight
PEAKS = {
    "chunk1024_warm512": ({}, False),
    "chunk2048_warm512": ({"kChunk = 1024;": "kChunk = 2048;"}, False),
    "chunk512_warm512": ({"kChunk = 1024;": "kChunk = 512;"}, False),
    "chunk1024_warm1024": ({"kWarm = 512;": "kWarm = 1024;"}, False),
    "chunk1024_warm256": ({"kWarm = 512;": "kWarm = 256;"}, False),
    "stages2": ({"kStages = 4;": "kStages = 2;"}, False),
    # no state machine: each step passes the sample on
    "diag_no_step": ({
        "      const float y = step(nx, in[0][lane][c], in[1][lane][c], a.g);":
        "      const float y = in[0][lane][c] + in[1][lane][c];"}, True),
    # no copies after the first stages: every step reads stale strips
    "diag_no_copies": ({
        "    if (sl + kStages - 1 < nslab) fetch(sl + kStages - 1);":
        "    if (sl < 0) fetch(sl + kStages - 1);"}, True),
}
# the head of S2's chunk_steps
_STEPS = "                                            const Coefs<T>& c) {\n"
# iir_scan (S1) on the offline threshold's low-pass (p = 3) at full width,
# float32 and float64: slabs of 512 (the default) or 256, u read in blocks
# of 16 (default) or 8 values, x copied 4 slabs ahead (default) or 2 or 6;
# iir_assoc (S2) at tiles of 512 on detect_batch's band-pass (p = 5, from
# its warm-up state; float32 and float64) and threshold low-pass (p = 3):
# 3 chunks a warp in shared memory
# (default) or 2 or 4, 4 warps a tile CTA (default) or 1 or 2, carry slabs
# of 128 tiles (default) or 256, chunks of 128 bytes of a tile (default) or
# 256
IIR = {
    "slab512_unroll16_ring6": ({}, False),
    "slab256": ({"kSlab = 512;": "kSlab = 256;"}, False),
    "unroll8": ({"kUnroll = 16;": "kUnroll = 8;"}, False),
    "ring4": ({"kRing = 6;": "kRing = 4;"}, False),
    "ring8": ({"kRing = 6;": "kRing = 8;"}, False),
    # no feedback: y = u (the chain lane's loop without its chain)
    "diag_no_chain": ({
        "for (int k = 0; k < M; ++k) v = sub_rn(v, mul_rn(c.n[k + 1], s[k]));":
        "for (int k = 0; k < 0; ++k) v = s[k];"}, True),
    "assoc_buf2": ({"kBuf = 3;": "kBuf = 2;"}, False),
    "assoc_buf4": ({"kBuf = 3;": "kBuf = 4;"}, False),
    "assoc_warps1": ({"kTileWarps = 4;": "kTileWarps = 1;"}, False),
    "assoc_warps2": ({"kTileWarps = 4;": "kTileWarps = 2;"}, False),
    "assoc_carry_slab256": ({"kCarrySlab = 128;": "kCarrySlab = 256;"},
                            False),
    # chunks of 256 bytes of a tile (64 floats, 32 doubles)
    "assoc_chunk256": ({"128 / (int)sizeof(T)": "256 / (int)sizeof(T)"},
                       False),
    # the carry's chain lane walks no step (starts stay yz): what the
    # tile passes and the carry's copies cost without the chain
    "diag_assoc_no_chain": ({
        "          carry_slab<T, M, false>(A, s, e, o, kCarrySlab);":
        "          carry_slab<T, M, true>(A, s, e, o, 0);"}, True),
    # no fix-up in pass 3: y = y_loc (what the correction costs)
    "diag_assoc_no_fix": ({"          g[v] = add_rn(y, f);":
                           "          g[v] = y;"}, True),
    # no steps in passes 1 and 3: their copies alone
    "diag_assoc_no_steps": ({_STEPS: _STEPS + "  if (m >= 0) return;\n"},
                            True),
}
# fir_apply (S3) with detect-path shapes: phase 16's 61-tap low-pass at
# 12 x 2^20 float32, fresh: 16 outputs a thread (the default), 4 or 8; CTAs
# of 128 threads (default) or 256
FIR = {
    "r16": ({}, False),
    "r4": ({"kR = 16;": "kR = 4;"}, False),
    "r8": ({"kR = 16;": "kR = 8;"}, False),
    "t256": ({"kThreads = 128;": "kThreads = 256;"}, False),
    # no sums: the staging and the stores alone
    "diag_no_taps": ({"    for (; i0 + kR <= ks; i0 += kR) {":
                      "    for (i0 = ks; i0 + kR <= ks; i0 += kR) {"}, True),
    # the sums alone: no copies after each CTA's first tile, no stores
    "diag_no_copies": ({
        "    if (rn < rows) fetch(": "    if (rn < 0) fetch(",
        "    T* yr = y + r * n + t0;\n":
        "    T* yr = y + r * n + t0;\n"
        "    if (t0 >= 0) {\n      r = rn;\n      c = cn;\n      continue;\n    }\n"},
                       True),
}
# windows.cu at chip_smoke phase 4's shapes (the main pass 1's 83 groups):
# group_windows (K14), place_windows_aligned (X1) on its windows' glue and
# windows_place_flat (K15)
# K14: its windows' write-out cut (both sources store them so)
_K14_NO_WRITEOUT = {
    "    *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>("
    "swin)[q];":
    "    const uint4 v = reinterpret_cast<const uint4*>(swin)[q];\n"
    "    if (v.x == 0x5a5a5a5au) *reinterpret_cast<uint4*>(dst) = v;"}
# K14's cluster parts: its launch (cluster dims, rank, the barrier's
# init and first arrive) and its signals (the wait, the pushes of the
# tile's bits, the wait for the lower tiles', the prefix)
_K14_NO_CLUSTER = {
    "__global__ void __cluster_dims__(kGwTiles, 1, 1) "
    "__launch_bounds__(kGwThreads)":
    "__global__ void __launch_bounds__(kGwThreads)",
    "  cg::cluster_group cluster = cg::this_cluster();\n": "",
    "  const int g = blockIdx.x / kGwTiles, j = (int)cluster.block_rank();":
    "  const int g = blockIdx.x / kGwTiles, j = blockIdx.x % kGwTiles;"}
_K14_INIT = ("  if (tid == 0) init_arrivals(&pushed, max(j, 1));\n"
             "  cluster_arrive_relaxed();\n")
_K14_SIGNALS = (
    "  cluster_wait();\n"
    "  if (tid > j && tid < kGwTiles) push_bits(&lower[j], &pushed, tid, "
    "total);\n"
    "  if (j > 0) wait_arrivals(&pushed);\n"
    "  int prefix = 0;\n"
    "  for (int r = 0; r < j; ++r) prefix += lower[r];\n")
WINDOWS = {
    "k15_super_tiles_x1_gather": ({}, False),
    # K14: tiles of 1,024 and 4,096 tokens (clusters of 8 and 2 CTAs of
    # 128 and 512 threads; committed: 4 of 256 threads, 2,048 tokens)
    "k14_tile1024": ({"kGwThreads = 256;": "kGwThreads = 128;"}, False),
    "k14_tile4096": ({"kGwThreads = 256;": "kGwThreads = 512;"}, False),
    # K14 with one cluster barrier: each tile leaves its bits in its own
    # shared memory, the barrier publishes them, each tile reads its lower
    # ranks' (distributed shared memory), and a second barrier, split
    # around the rest, keeps every CTA until the reads are done
    "k14_cluster_sync": ({
        "  __shared__ __align__(8) uint64_t pushed;  // their pushes\n": "",
        _K14_INIT: "",
        _K14_SIGNALS:
        "  if (tid == 0) lower[0] = total;\n"
        "  cluster.sync();\n"
        "  int prefix = 0;\n"
        "  for (int r = 0; r < j; ++r) prefix += *cluster.map_shared_rank("
        "&lower[0], r);\n"
        '  asm volatile("barrier.cluster.arrive.release.aligned;" ::: '
        '"memory");\n',
        "    *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>("
        "swin)[q];\n  }\n}":
        "    *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>("
        "swin)[q];\n  }\n"
        '  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: '
        '"memory");\n}'}, False),
    # K14 without the cluster: each tile sums the bits of its group's
    # earlier tokens itself (read again from L2, 2 quads a thread a tile)
    "k14_recompute_prefix": ({
        **_K14_NO_CLUSTER,
        _K14_INIT: "",
        " + 2 * tid;\n  const int4 a = __ldg(p), c = __ldg(p + 1);\n":
        " + 2 * tid;\n  const int4 a = __ldg(p), c = __ldg(p + 1);\n"
        "  const int4* grp = reinterpret_cast<const int4*>(\n"
        "      tokc + (int64_t)g * kGroupTok);\n"
        "  int4 pre[2 * (kGwTiles - 1)];\n"
        "#pragma unroll\n"
        "  for (int q = 0; q < 2 * (kGwTiles - 1); ++q)\n"
        "    pre[q] = q < 2 * j ? __ldg(grp + q * kGwThreads + tid)\n"
        "                       : make_int4(0, 0, 0, 0);\n",
        "  __syncthreads();\n  const int32_t w[kItems]":
        "  if (tid == 0) lower[0] = 0;\n  __syncthreads();\n"
        "  const int32_t w[kItems]",
        _K14_SIGNALS:
        "  int psum = 0;\n"
        "#pragma unroll\n"
        "  for (int q = 0; q < 2 * (kGwTiles - 1); ++q) {\n"
        "    const int32_t v[4] = {pre[q].x, pre[q].y, pre[q].z, pre[q].w};\n"
        "#pragma unroll\n"
        "    for (int k = 0; k < 4; ++k) psum += token_bits(v[k], "
        "lut_word(lut, v[k]));\n"
        "  }\n"
        "  for (int o = 16; o; o >>= 1) psum += __shfl_xor_sync(rspt::kFull, "
        "psum, o);\n"
        "  if (lane == 0) atomicAdd(&lower[0], psum);\n"
        "  __syncthreads();\n"
        "  const int prefix = lower[0];\n"}, False),
    # K14: a thread's words summed in registers, 4 words from its first
    # valid token's (selects; a word past them added at once), then one
    # shared atomic a nonzero word
    "k14_register_words": ({
        "#pragma unroll\n"
        "  for (int k = 0; k < kItems; ++k) {\n"
        "    if (!is_valid(w[k])) continue;\n"
        "    add_token(win, w[k], e[k], bit, base);\n"
        "    bit += token_bits(w[k], e[k]);\n"
        "  }\n":
        "  int b0 = -1;\n"
        "  uint32_t acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;\n"
        "#pragma unroll\n"
        "  for (int k = 0; k < kItems; ++k) {\n"
        "    if (!is_valid(w[k])) continue;\n"
        "    const uint32_t cb = e[k] >> 24;\n"
        "    const uint64_t val = (uint64_t)(e[k] & 0xFFFFFFu) |\n"
        "                         ((uint64_t)((w[k] >> 13) & 16383) << cb);\n"
        "    const int s = bit & 31;\n"
        "    const int loc = min((bit >> 5) - base, kWin - 2);\n"
        "    const uint64_t lo = val << s;\n"
        "    const uint32_t c0 = (uint32_t)lo, c1 = (uint32_t)(lo >> 32);\n"
        "    const uint32_t c2 = s ? (uint32_t)(val >> (64 - s)) : 0u;\n"
        "    if (b0 < 0) b0 = loc;\n"
        "    const int d = loc - b0;\n"
        "    acc0 += d == 0 ? c0 : 0u;\n"
        "    acc1 += d == 0 ? c1 : d == 1 ? c0 : 0u;\n"
        "    acc2 += d == 0 ? c2 : d == 1 ? c1 : d == 2 ? c0 : 0u;\n"
        "    acc3 += d == 1 ? c2 : d == 2 ? c1 : d == 3 ? c0 : 0u;\n"
        "    if (d >= 2) {\n"
        "      if (d >= 4 && c0) atomicAdd(win + loc, c0);\n"
        "      if (d >= 3 && c1) atomicAdd(win + loc + 1, c1);\n"
        "      if (c2 && loc + 2 < kWin) atomicAdd(win + loc + 2, c2);\n"
        "    }\n"
        "    bit += token_bits(w[k], e[k]);\n"
        "  }\n"
        "  if (b0 >= 0) {\n"
        "    if (acc0) atomicAdd(win + b0, acc0);\n"
        "    if (acc1) atomicAdd(win + b0 + 1, acc1);\n"
        "    if (acc2 && b0 + 2 < kWin) atomicAdd(win + b0 + 2, acc2);\n"
        "    if (acc3 && b0 + 3 < kWin) atomicAdd(win + b0 + 3, acc3);\n"
        "  }\n"}, False),
    # K14: no shared atomics (the windows stay zero)
    "diag_k14_no_atomics": ({"    add_token(win, w[k], e[k], bit, base);":
                             "    if (bit < 0) add_token(win, w[k], e[k], "
                             "bit, base);"}, True),
    # K14: no window stores (cbase, clive and gtot still written)
    "diag_k14_no_writeout": (_K14_NO_WRITEOUT, True),
    # K14: the cluster launch alone (no barrier, push or prefix)
    "diag_k14_cluster_launch": ({_K14_INIT: "",
                                 _K14_SIGNALS: "  const int prefix = 0;\n"},
                                True),
    # K14: no cluster at all (every tile from bit 0)
    "diag_k14_no_cluster": ({**_K14_NO_CLUSTER, _K14_INIT: "",
                             _K14_SIGNALS: "  const int prefix = 0;\n"},
                            True),
    # K15: the slow path inlined into the kernel
    "slow_inline": ({"__device__ __noinline__ void place_slow(":
                     "__device__ __forceinline__ void place_slow("}, False),
    # X1: a block reduction finds the span's first and last nonzero
    # words, only those two added, the other nonzero words stored
    "x1_span_stores": ({
        "  uint32_t u[kX1Per];  // every shifted word read before the first "
        "add\n": "  uint32_t u[kX1Per];\n  int lo = kX1Words, hi = -1;\n",
        "    u[j] = sb ? (a << sb) | (p >> (32 - sb)) : a;\n  }\n":
        "    u[j] = sb ? (a << sb) | (p >> (32 - sb)) : a;\n"
        "    const int r = k + off >= kX1Words ? k + off - kX1Words : k + off;\n"
        "    if (u[j]) { lo = min(lo, r); hi = max(hi, r); }\n"
        "  }\n"
        "  __shared__ int red[2][kX1Threads / 32];\n"
        "  for (int o = 16; o; o >>= 1) {\n"
        "    lo = min(lo, __shfl_xor_sync(rspt::kFull, lo, o));\n"
        "    hi = max(hi, __shfl_xor_sync(rspt::kFull, hi, o));\n"
        "  }\n"
        "  if ((tid & 31) == 0) { red[0][tid >> 5] = lo; red[1][tid >> 5] = hi; }\n"
        "  __syncthreads();\n"
        "  for (int w = 0; w < kX1Threads / 32; ++w) {\n"
        "    lo = min(lo, red[0][w]);\n"
        "    hi = max(hi, red[1][w]);\n"
        "  }\n",
        "    if (gw >= 0 && gw < limit) atomicAdd(out + gw, u[j]);":
        "    if (gw < 0 || gw >= limit) continue;\n"
        "    if (gw - base == lo || gw - base == hi) atomicAdd(out + gw, u[j]);\n"
        "    else out[gw] = u[j];"}, False),
    # K15: the field check with a branch a token (&&, ||)
    "field_check_branches": ({
        "    // without branches: a branch a token costs more than the test\n"
        "    bad |= is_valid(w) &\n"
        "           ((cb > 23) | (((e & 0xFFFFFFu) >> min(cb, 24)) != 0) |\n"
        "            ((((w >> 13) & 16383) >> eb) != 0));\n":
        "    bad |= is_valid(w) && (cb > 23 || ((e & 0xFFFFFFu) >> min(cb, 24))\n"
        "                           != 0 || (((w >> 13) & 16383) >> eb) != 0);\n"},
        False),
    # K15: the field check in the coding loop, before the scan and the
    # publish (not beside the look-back)
    "check_before_scan": ({
        "    // without branches: a branch a token costs more than the test\n"
        "    bad |= is_valid(w) &\n"
        "           ((cb > 23) | (((e & 0xFFFFFFu) >> min(cb, 24)) != 0) |\n"
        "            ((((w >> 13) & 16383) >> eb) != 0));\n": "",
        "    sum += live ? (int)(t.e[k] >> 24) + ((w >> 9) & 15) : 0;\n":
        "    sum += live ? (int)(t.e[k] >> 24) + ((w >> 9) & 15) : 0;\n"
        "    bad |= live & (((t.e[k] >> 24) > 23) |\n"
        "                   (((t.e[k] & 0xFFFFFFu) >> min(t.e[k] >> 24, 24u)) != 0) |\n"
        "                   ((((w >> 13) & 16383) >> ((w >> 9) & 15)) != 0));\n",
        "  // code the tokens\n  int sum = 0;\n":
        "  // code the tokens\n  int sum = 0;\n  bool bad = false;\n",
        "  bool bad = false;\n  int x = bit;\n": "  int x = bit;\n"}, False),
    # K15: no field or base check (every live super on the direct path)
    "diag_no_slow_check": ({
        "    // without branches: a branch a token costs more than the test\n"
        "    bad |= is_valid(w) &\n"
        "           ((cb > 23) | (((e & 0xFFFFFFu) >> min(cb, 24)) != 0) |\n"
        "            ((((w >> 13) & 16383) >> eb) != 0));\n": "",
        "  if (!in_field || b < 0 || b > (nrows - kAccRows) * 128) {":
        "  if (false) {"}, True),
    # K15: no field check (only the base clamp sends a super to the slow
    # path)
    "diag_no_field_check": ({
        "    // without branches: a branch a token costs more than the test\n"
        "    bad |= is_valid(w) &\n"
        "           ((cb > 23) | (((e & 0xFFFFFFu) >> min(cb, 24)) != 0) |\n"
        "            ((((w >> 13) & 16383) >> eb) != 0));\n": ""},
        True),
    # K15: the checks kept, the slow path's code gone (a trap instead)
    "diag_slow_trap": ({
        "    place_slow(t, sbase, gb, b, smem, out, nrows, sh);":
        "    __trap();"}, True),
    # K15: as diag_slow_trap, launched with the direct path's shared
    # memory only (19.5 KiB, not 56 KiB)
    "diag_trap_small_smem": ({
        "    place_slow(t, sbase, gb, b, smem, out, nrows, sh);":
        "    __trap();",
        "  windows_place_flat_kernel<<<kTilesPerGroup * ng, kFlatThreads, "
        "kFlatSmem,":
        "  windows_place_flat_kernel<<<kTilesPerGroup * ng, kFlatThreads, "
        "sizeof(uint32_t) * kTileWords,"}, True),
    # K15: no wait on earlier tiles (every super's carry and group bit 0)
    "diag_no_lookback": ({"    for (int k = k0 + tid; k < i; k += 32) {":
                          "    for (int k = i + tid; k < i; k += 32) {"},
                         True),
    # K15: no word stores of the direct path
    "diag_no_stores": ({
        "    if (k == 0 || k == nw - 1) {\n"
        "      if (v) atomicAdd(out + w0 + k, v);\n"
        "    } else {\n"
        "      out[w0 + k] = v;\n"
        "    }\n": "    if (v == 0x5a5a5a5au) out[w0 + k] = v;\n"}, True),
    # X1: no word stores
    "diag_x1_no_stores": ({
        "    if (gw >= 0 && gw < limit) atomicAdd(out + gw, u[j]);":
        "    if (u[j] == 0x5a5a5a5au && gw >= 0) atomicAdd(out + gw, u[j]);"},
        True),
}
# the windows.cu whose K14 takes one 1,024-thread CTA a group (its 64
# windows in 64 KiB of shared memory), varied this way when --baseline
# names it
WINDOWS_GROUP_K14 = {
    # K14 (and K15's slow path): no shared atomics into the windows
    "diag_k14_no_atomics": ({
        "    if (c0) atomicAdd(win + loc, c0);":
        "    if (c0 && bit < 0) atomicAdd(win + loc, c0);",
        "    if (c1) atomicAdd(win + loc + 1, c1);":
        "    if (c1 && bit < 0) atomicAdd(win + loc + 1, c1);",
        "    if (c2 && loc + 2 < kWin) atomicAdd(win + loc + 2, c2);":
        "    if (c2 && loc + 2 < kWin && bit < 0) atomicAdd(win + loc + 2, "
        "c2);"}, True),
    # K14: no window stores
    "diag_k14_no_writeout": (_K14_NO_WRITEOUT, True),
}
TABLES = {"xdelta.cu": XDELTA, "hzr_decode.cu": DECODE, "tokenize.cu": TOKENIZE,
          "compact.cu": COMPACT, "place_literals.cu": PLACE,
          "pack_flat.cu": PACK, "fwht.cu": FWHT, "pack_blocks.cu": BLOCKS,
          "dct.cu": DCT, "peaks.cu": PEAKS, "iir.cu": IIR, "fir.cu": FIR,
          "windows.cu": WINDOWS}
# variants of the --baseline source, built as "baseline_<name>"
BASELINE_TABLES = {"windows.cu": WINDOWS_GROUP_K14}
# device_ms's calls a measurement, where 30 would take seconds
REPS = {"peak_gate": 10, "iir_scan": 3, "iir_scan_f64": 3}


def variant_source(src: str, repl: dict) -> str:
    for old, new in repl.items():
        if src.count(old) != 1:
            raise ValueError(f"variant text not found once: {old!r}")
        src = src.replace(old, new)
    return src


def is_diag(cu: str, name: str) -> bool:
    """Whether variant `name` of `cu` drops work (its output is not the
    function's)."""
    if name == "baseline":
        return False
    if name.startswith("baseline_"):
        return BASELINE_TABLES[cu][name[len("baseline_"):]][1]
    return TABLES[cu][name][1]


def build_variants(kernels, out_dir: Path, baseline=None):
    """{(kernel, variant): ctypes library}, every variant compiled by its
    own nvcc, all started together; with baseline (a csrc directory),
    its copy of each kernel's source as variant "baseline" too, and
    BASELINE_TABLES' variants of it as "baseline_<name>"."""
    from rspt_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    procs = {}
    for cu, variants in kernels.items():
        src = (CSRC / cu).read_text()
        todo = [(name, variant_source(src, repl), CSRC)
                for name, (repl, _) in variants.items()]
        if baseline is not None and (baseline / cu).exists():
            # with the headers of its own checkout
            base = (baseline / cu).read_text()
            todo.append(("baseline", base, baseline))
            todo += [(f"baseline_{name}", variant_source(base, repl),
                      baseline)
                     for name, (repl, _) in BASELINE_TABLES.get(cu,
                                                                {}).items()]
        for name, text, include in todo:
            path = out_dir / f"{Path(cu).stem}_{name}.cu"
            path.write_text(text)
            lib = path.with_suffix(".so")
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(include), "-shared",
                   "-o", str(lib), str(path)]
            procs[(cu, name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _bind(cu, lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"xdelta.cu": {"rspt_xdelta_tile": [I, I],
                          "rspt_xdelta_swizzle": [P] * 4 + [I] * 6 + [P]},
            "compact.cu": {"rspt_compact_tiles": [I],
                           "rspt_compact_tokens": [P] * 4 + [I] * 4 + [P]},
            "place_literals.cu": {
                "rspt_place_literals": [P] * 6 + [I] * 3 + [P]},
            "hzr_decode.cu": {"rspt_hzr_decode": [P] * 17 + [I] * 7 + [P]},
            "tokenize.cu": {"rspt_tokenize_planes": [P] * 5 + [I] * 3 + [P],
                            "rspt_tokenize_tiles": []},
            "pack_flat.cu": {"rspt_pack_flat_state": [I, I],
                             "rspt_pack_flat": [P] * 7 + [I] * 3 + [P],
                             "rspt_pack_flat_lanes": [P] * 9 + [I] * 4
                             + [P]},
            "fwht.cu": {"rspt_fwht_cluster": [I],
                        "rspt_fwht": [P, P, I, I, P]},
            "pack_blocks.cu": {
                "rspt_pack_blocks_state": [I, I],
                "rspt_pack_blocks": [P] * 9 + [I] * 3 + [P],
                "rspt_pack_blocks_tokw": [P] * 6 + [I] * 3 + [P]},
            "dct.cu": {
                "rspt_dct_forward": [P] * 4 + [I] * 2 + [P],
                "rspt_dct_inverse": [P] * 4 + [ctypes.c_double] + [I] * 2
                + [P]},
            "peaks.cu": {
                "rspt_peak_gate_schedule": [P],
                "rspt_peak_gate": [P] * 5 + [I, ctypes.c_long, I, I, I,
                                             ctypes.c_float, ctypes.c_float,
                                             P]},
            "iir.cu": {"rspt_iir_scan": [P] * 6 + [I, I, ctypes.c_long, I,
                                                   P],
                       "rspt_iir_assoc": [P] * 10
                       + [I, I, ctypes.c_long, I, I, P]},
            "fir.cu": {"rspt_fir_apply": [P] * 4 + [I, ctypes.c_long, I, I,
                                                    I, P]},
            "windows.cu": {
                "rspt_group_windows": [P] * 7 + [I] + [P],
                "rspt_place_windows_aligned": [P] * 8 + [I] * 2 + [P],
                "rspt_windows_place_flat_state": [I],
                "rspt_windows_place_flat": [P] * 7 + [I] * 2 + [P]}}[cu]
    if cu == "windows.cu" and not hasattr(lib,
                                          "rspt_windows_place_flat_state"):
        # a source with one CTA a group: its state is the caller's
        del sigs["rspt_windows_place_flat_state"]
    if cu == "peaks.cu" and not hasattr(lib, "rspt_peak_gate_schedule"):
        # a source with one thread a row: no schedule, no scratch
        sigs = {"rspt_peak_gate": [P] * 3 + [I, ctypes.c_long, I,
                                             ctypes.c_float, ctypes.c_float,
                                             P]}
    if cu == "xdelta.cu" and not hasattr(lib, "rspt_xdelta_tile"):
        # a source with one thread a word and ok set by the caller
        sigs = {"rspt_xdelta_swizzle": [P, P, P] + [I] * 6 + [P]}
    if cu == "tokenize.cu" and not hasattr(lib, "rspt_tokenize_tiles"):
        # a source without the summary pass: no scratch argument
        sigs = {"rspt_tokenize_planes": [P] * 4 + [I] * 3 + [P]}
    if cu == "pack_flat.cu" and not hasattr(lib, "rspt_pack_flat_state"):
        # a source with one CTA a block: no state argument
        sigs = {"rspt_pack_flat": [P] * 6 + [I] * 3 + [P],
                "rspt_pack_flat_lanes": [P] * 8 + [I] * 4 + [P]}
    if cu == "fwht.cu" and not hasattr(lib, "rspt_fwht_cluster"):
        # a source that transforms in place: one CTA a row
        sigs = {"rspt_fwht": [P, I, I, P]}
    if cu == "pack_blocks.cu" and not hasattr(lib, "rspt_pack_blocks_state"):
        # a source with one CTA a block: no state argument
        sigs = {"rspt_pack_blocks": [P] * 8 + [I] * 3 + [P],
                "rspt_pack_blocks_tokw": [P] * 5 + [I] * 3 + [P]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default=",".join(TABLES),
                    help="comma-separated kernel sources to vary")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="csrc directory of an earlier checkout")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variant names to build (default "
                    "all; the baseline is added with --baseline)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from rspt_tpu_torch import packers
    from rspt_tpu_torch.hzr import gpu_decoder as gd
    from rspt_tpu_torch.hzr import torch_coder as tc
    from rspt_tpu_torch.ops import cuda_kernels as ck
    from rspt_tpu_torch.ops import torch_ops as tops

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    stream = torch.cuda.current_stream().cuda_stream
    ch, ns = 12, 34199
    sig, native = cs.make_ecg(ch, ns)
    words = torch.from_numpy(np.frombuffer(native, "<i4").copy()).to(dev)
    u8_2 = torch.from_numpy(np.frombuffer(cs.to_native(sig >> 16, 2),
                                          np.uint8).copy()).to(dev)
    x = cs.kernel_inputs(ck, tc, words, ns, ch, 3)
    enc = x["enc"]
    tokw, bases, T = x["tokw"], x["bases"], x["plan"].T
    nb = tokw.shape[0]
    huff = torch.from_numpy(x["plan"].ntok > 0).to(dev)
    tok_huff = tokw[huff]
    valid_huff = ((tok_huff >> 27) & 1) != 0
    valid = ((tokw >> 27) & 1) != 0
    sym_idx = (torch.where(valid, tokw & 511, 261).to(torch.int64)
               + 262 * torch.arange(nb, device=dev)[:, None]).reshape(-1)
    p = packers.new_xdelta_hzr(4, ch, ns, 3)
    comp = p.compress(native)
    _, streams, _ = p._streams(comp, p.nr_planes, 0)
    la, dargs, total, _ = cs.decode_inputs(gd, streams, dev)
    emis, counts, _, stats = ck.hzr_decode(*dargs)
    steps, base, limit, live = cs.place_inputs(gd, la, counts, stats, dev)
    nt, S = emis.shape[:2]
    # the library yardstick: one index_put_ of the pre-masked literals
    em = emis.reshape(nt, -1, 1024)
    s_ix = torch.arange(em.shape[1], device=dev)[None, :, None]
    e_pos = base.reshape(nt, 1, 1024).long() + (em >> 9)
    lit = ((s_ix < steps.reshape(-1, 1, 1)) & ((em & 0x1FF) != 0)
           & live.reshape(nt, 1, 1024) & (e_pos < limit.reshape(nt, 1, 1024)))
    lit_pos, lit_val = e_pos[lit], (em[lit] & 0xFF).to(torch.uint8)
    lib_out = torch.zeros(total, dtype=torch.uint8, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def xdelta(lib, x, planes, bps):
        """xdelta_swizzle through lib as its wrapper calls it; a source
        without tickets as the packer called it: ok set to 1 first
        and, for the native bytes, native_to_i32 before the kernel."""
        enc = torch.empty(ns * ch, **i32)
        u8 = x.dtype == torch.uint8
        if hasattr(lib, "rspt_xdelta_tile"):
            ok = torch.empty(1, **i32)
            err = lib.rspt_xdelta_swizzle(
                x.data_ptr(), enc.data_ptr(), ok.data_ptr(),
                ck._xdelta_ticket(dev).data_ptr(), ns, ch, int(u8),
                int(ck._aligned16(x)), planes, bps, stream)
        else:
            if u8:
                x = tops.native_to_i32(x, ns, ch, bps).reshape(-1)
            ok = torch.ones(1, **i32)
            err = lib.rspt_xdelta_swizzle(
                x.data_ptr(), enc.data_ptr(), ok.data_ptr(), ns * ch, ns,
                ch, int(not u8), planes, bps, stream)
        assert err == 0, err
        return enc, ok

    def compact(lib):
        nstate = 1 + tokw.shape[0] * lib.rspt_compact_tiles(tokw.shape[1])
        buf = torch.zeros(T + nstate, **i32)
        err = lib.rspt_compact_tokens(
            tokw.data_ptr(), bases.data_ptr(), buf.data_ptr(),
            buf[T:].data_ptr(), tokw.shape[0], tokw.shape[1], T, 0, stream)
        assert err == 0, err
        return buf[:T]

    def place(lib):
        out = torch.zeros(total, dtype=torch.uint8, device=dev)
        err = lib.rspt_place_literals(
            emis.data_ptr(), steps.data_ptr(), base.data_ptr(),
            limit.data_ptr(), live.data_ptr(), out.data_ptr(), nt, S,
            total, stream)
        assert err == 0, err
        return out

    def decode(lib):
        outs = (torch.empty((nt, ck.MAX_STEPS, 8, 128), **i32),
                torch.empty((nt * 8, 128), **i32),
                torch.empty((nt * 8, 128), **i32), torch.empty((nt, 5), **i32))
        err = lib.rspt_hzr_decode(
            *[a.data_ptr() for a in dargs], *[o.data_ptr() for o in outs],
            nt, dargs[1].shape[0], *[a.shape[0] for a in dargs[4:8]],
            ck.MAX_STEPS, stream)
        assert err == 0, err
        return outs

    def tokenize(lib):
        nb_per = -(-enc.numel() // 65536)
        outs = (torch.empty((nb, 65536), **i32),
                torch.empty((nb, 16384), **i32), torch.empty((nb, 261), **i32))
        ptrs = [o.data_ptr() for o in outs]
        if hasattr(lib, "rspt_tokenize_tiles"):
            summary = torch.empty(nb_per * lib.rspt_tokenize_tiles() * 8,
                                  **i32)
            ptrs.insert(0, summary.data_ptr())
        err = lib.rspt_tokenize_planes(enc.data_ptr(), *ptrs, enc.numel(), 3,
                                       nb_per, stream)
        assert err == 0, err
        return outs

    pk_args = (x["tokc"], bases, x["ntok"], x["bit0"], x["lut"],
               x["plan"].nwords)
    meta, init = x["lanes"]

    def pack(lib, lanes):
        """pack_flat (lanes=False) or pack_flat_lanes through lib, as the
        wrappers call them (the output's and state's memset included)."""
        tokc, nwords = x["tokc"], x["plan"].nwords
        ptrs = [a.data_ptr() for a in pk_args[:5]]
        if hasattr(lib, "rspt_pack_flat_state"):
            out, state = ck._pack_buffers(nwords, nb, tokc, lib)
            state = [state.data_ptr()]
        else:
            out, state = torch.zeros(nwords, **i32), []
        if not lanes:
            err = lib.rspt_pack_flat(*ptrs, out.data_ptr(), *state, nb,
                                     tokc.numel(), nwords, stream)
            assert err == 0, err
            return out
        entries = init.clone()
        err = lib.rspt_pack_flat_lanes(
            *ptrs, out.data_ptr(), meta.data_ptr(), entries.data_ptr(),
            *state, nb, tokc.numel(), nwords, entries.numel(), stream)
        assert err == 0, err
        return out, entries

    cen3 = cs.hadamard_input(native, ch, dev)
    rows3, log3 = cen3.shape[0], cen3.shape[1].bit_length() - 1

    def fwht(lib):
        """fwht through lib as its wrapper calls it: out of place, or a
        clone transformed in place (a source without clusters)."""
        if not hasattr(lib, "rspt_fwht_cluster"):
            out = cen3.clone()
            err = lib.rspt_fwht(out.data_ptr(), rows3, log3, stream)
        else:
            out = torch.empty_like(cen3)
            err = lib.rspt_fwht(cen3.data_ptr(), out.data_ptr(), rows3, log3,
                                stream)
        assert err == 0, err
        return out

    k13a_args = cs.stream_blocks_args(tc, native, dev)[0]
    k13b_args = cs.pass1_blocks_args(tc, x, dev)

    def blocks(lib, tokw_form):
        """pack_blocks (K13a form on the main payload as one stream) or
        pack_blocks_tokw (K13b on the main pass 1) through lib, as the
        wrappers call them (the memset of the rows and state included)."""
        *toks, lut, dbits = k13b_args if tokw_form else k13a_args
        nb_b, n = toks[0].shape
        if hasattr(lib, "rspt_pack_blocks_state"):
            words, state = ck._blocks_buffers(nb_b, n, dev, lib)
            state = [state.data_ptr()]
        else:
            words = torch.empty((nb_b, ck.blocks_nwords(n)), **i32)
            state = []
        total = torch.empty(nb_b, **i32)
        fn = lib.rspt_pack_blocks_tokw if tokw_form else lib.rspt_pack_blocks
        err = fn(*[t.data_ptr() for t in toks], lut.data_ptr(),
                 dbits.data_ptr(), words.data_ptr(), total.data_ptr(),
                 *state, nb_b, n, words.shape[1], stream)
        assert err == 0, err
        return words, total

    # the DCT pair at config 4: the centred signal of the main signal's
    # first 4,096 samples and its coefficients
    pd4 = packers.new_dct(4, ch, 4096)
    cen4 = pd4._centred(native[:4096 * ch * 4])[0]
    coef4 = ck.dct_forward(cen4, pd4._cos, pd4._fwd_scale)
    cen4_64, cos4_64 = cen4.double(), pd4._cos.double()
    q4_64, cos4t_64 = (pd4._cs * coef4.float()).double(), pd4._cos_t.double()

    def dct(lib, inverse):
        """dct_forward or dct_inverse through lib, as the wrappers call
        them."""
        out = torch.empty_like(cen4)
        if inverse:
            err = lib.rspt_dct_inverse(
                coef4.data_ptr(), out.data_ptr(), pd4._cos_t.data_ptr(),
                pd4._cs.data_ptr(), pd4._inv_scale, ch, 4096, stream)
        else:
            err = lib.rspt_dct_forward(
                cen4.data_ptr(), out.data_ptr(), pd4._cos.data_ptr(),
                pd4._fwd_scale.data_ptr(), ch, 4096, stream)
        assert err == 0, err
        return out

    # S4 on detect_batch's gate and S1 on the offline threshold's
    # low-pass (p = 3), at phase 16's full width (12 x 2^20 float32)
    from rspt_tpu_torch.analysis import torch_peaks
    sx, _ = cs.make_ecg(12, cs.SIG_NS)
    xs = torch.from_numpy(sx.astype(np.float32)).to(dev)
    _, sg, th = torch_peaks.detect_batch(xs, cs.SIG_SR)
    gate = (sg, th, int(100.0 * cs.SIG_SR / 1000.0),
            1.0 / (1.0 + 25.0 / cs.SIG_SR), 1.0)
    th_b, th_a = torch_peaks._coeffs(cs.SIG_SR)[2]
    z32 = xs.new_zeros((12, len(th_a) - 1))
    xs64, z64 = xs.double(), z32.double()

    def peak_gate(lib):
        """peak_gate through lib as its wrapper calls it (its default
        schedule; a source without one: one thread a row)."""
        sig, thr, nr, atten, marker = gate
        out = torch.empty_like(sig)
        rows, n = sig.shape
        if hasattr(lib, "rspt_peak_gate_schedule"):
            sched = (ctypes.c_int * 3)()
            lib.rspt_peak_gate_schedule(sched)
            chunk, warm, ckpt = sched
            nk = -(-n // chunk)
            state = torch.empty((rows * nk * (2 + (chunk - 1) // ckpt), 4),
                                **i32)
            reruns = torch.empty((rows, 2), dtype=torch.int64, device=dev)
            err = lib.rspt_peak_gate(
                sig.data_ptr(), thr.data_ptr(), out.data_ptr(),
                state.data_ptr(), reruns.data_ptr(), rows, n, chunk, warm,
                nr, atten, marker, stream)
        else:
            err = lib.rspt_peak_gate(sig.data_ptr(), thr.data_ptr(),
                                     out.data_ptr(), rows, n, nr, atten,
                                     marker, stream)
        assert err == 0, err
        return out

    def bits(t):
        return t.view(torch.int64 if t.dtype == torch.float64
                      else torch.int32)

    def iir_scan(lib, x, z):
        """iir_scan through lib as its wrapper calls it."""
        y = torch.empty_like(x)
        keep, (nh, dh) = ck._coef_args(th_a, th_b, x.dtype)
        err = lib.rspt_iir_scan(x.data_ptr(), z.data_ptr(), z.data_ptr(),
                                y.data_ptr(), nh, dh, len(th_a), x.shape[0],
                                x.shape[1], int(x.dtype == torch.float64),
                                stream)
        assert err == 0, err
        return y

    # S2 at tiles of 512 on detect_batch's band-pass (p = 5) from its
    # warm-up state, float32 and float64, and on its threshold low-pass
    # (p = 3) from zeros; S3 with phase 16's 61 taps, fresh
    from rspt_tpu_torch.filters import torch_filters as tf
    (bp_b, bp_a), _, fir_taps = cs.signal_designs()
    bz = tf.iir_warmup_state(xs[:, 0], bp_a, bp_b, 4 * int(cs.SIG_SR),
                             device=dev)
    assoc = {"iir_assoc": (xs, bp_a, bp_b, bz[0], bz[1].contiguous()),
             "iir_assoc_f64": (xs64, bp_a, bp_b, bz[0].double(),
                               bz[1].double().contiguous()),
             "iir_assoc_m2": (xs, th_a, th_b, z32, z32)}
    fir_args = (xs, torch.from_numpy(fir_taps.astype(np.float32)).to(dev))
    ks = fir_args[1].numel()
    w_conv = fir_args[1].flip(0).reshape(1, 1, ks)
    xpad = torch.nn.functional.pad(xs, (ks - 1, 0)).reshape(12, 1, -1)

    def iir_assoc(lib, kind):
        """iir_assoc through lib as its wrapper calls it."""
        x, a_, b_, xz, yz = assoc[kind]
        rows, T = x.shape
        m = len(a_) - 1
        L = tf.IIR_TILE
        nt = -(-T // L)
        al, pw = ck.iir_tables(a_, L, x.dtype, x.device)
        y = torch.empty_like(x)
        scratch = torch.empty((2, rows, nt, m), dtype=x.dtype, device=dev)
        keep, (nh, dh) = ck._coef_args(a_, b_, x.dtype)
        err = lib.rspt_iir_assoc(
            x.data_ptr(), xz.data_ptr(), yz.data_ptr(), y.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(), al.data_ptr(),
            pw.data_ptr(), nh, dh, m + 1, rows, T, L,
            int(x.dtype == torch.float64), stream)
        assert err == 0, err
        return y

    def fir(lib):
        """fir_apply through lib as its wrapper calls it (fresh)."""
        x, taps = fir_args
        y = torch.empty_like(x)
        w = torch.zeros((x.shape[0], ks), dtype=x.dtype, device=dev)
        err = lib.rspt_fir_apply(x.data_ptr(), w.data_ptr(), taps.data_ptr(),
                                 y.data_ptr(), x.shape[0], x.shape[1], ks, 1,
                                 0, stream)
        assert err == 0, err
        return y

    # the windows kernels on the main pass 1's 83 groups (chip_smoke
    # phase 4): K14 on its compacted tokens, X1 on their windows' glue
    # (56-row accumulator), K15 on the tokens
    gl = tc.group_layout(x["plan"], dev)
    flat = x["tokc"].reshape(1, -1)
    glue = ck.windows_glue(*ck.group_windows_plain(flat, gl.lut3), gl.dbg,
                           gl.wog, gl.gfirst, gl.nrows_windows, ck.AR2)
    k15 = (x["tokc"].reshape(-1, 128), gl.lut3, gl.dbg, gl.wog, gl.gfirst)

    def group_windows(lib, tokc=flat, lut3=gl.lut3):
        """K14 through lib as its wrapper calls it."""
        ng = lut3.shape[0]
        nc = ng * ck.R_TV
        outs = (torch.empty((1, nc, 128), **i32),
                torch.empty((1, nc, 128), **i32), torch.empty((1, nc), **i32),
                torch.empty((1, nc), **i32), torch.empty((1, ng), **i32))
        err = lib.rspt_group_windows(tokc.data_ptr(), lut3.data_ptr(),
                                     *[o.data_ptr() for o in outs], ng,
                                     stream)
        assert err == 0, err
        return outs

    def place_aligned(lib, args=glue, nrows=gl.nrows_windows):
        """X1 through lib as its wrapper calls it (the output's memset
        included)."""
        out = torch.zeros((nrows, 128), **i32)
        err = lib.rspt_place_windows_aligned(
            *[t.data_ptr() for t in args], out.data_ptr(), args[4].shape[1],
            nrows, stream)
        assert err == 0, err
        return out

    def place_flat(lib, args=k15, ng=gl.ng, nrows=gl.nrows_fused):
        """K15 through lib as its wrapper calls it (the memsets of the
        output and the state included)."""
        if hasattr(lib, "rspt_windows_place_flat_state"):
            out, state = ck._flat_buffers(nrows, ng, dev, lib)
        else:   # a source with one CTA a group: two buffers
            out = torch.zeros((nrows, 128), **i32)
            state = torch.zeros(ng + 1, **i32)
        err = lib.rspt_windows_place_flat(
            *[t.data_ptr() for t in args], out.data_ptr(), state.data_ptr(),
            ng, nrows, stream)
        assert err == 0, err
        return out

    # the card tests' windows edge cases (tests/test_torch_cuda.py):
    # [(name, call, plain result)]
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_cuda as edges
    win_edges = []
    for case in edges.WINDOWS_EDGE_CASES:
        a = tuple(v.to(dev) if torch.is_tensor(v) else v
                  for v in edges.windows_edge_batch(
                      np.random.default_rng(140), case))
        *x1a, x1n = edges.x1_inputs(a)
        ga = edges.group_windows_args(a)
        win_edges += [
            (f"group_windows {case}",
             lambda lib, ga=ga: group_windows(lib, *ga),
             ck.group_windows_plain(*ga)),
            (f"windows_place_flat {case}",
             lambda lib, a=a: place_flat(lib, a[:5], a[5], a[6]),
             ck.windows_place_flat_plain(*a)),
            (f"place_windows_aligned {case}",
             lambda lib, x1a=x1a, x1n=x1n: place_aligned(lib, x1a, x1n),
             ck.place_windows_aligned_plain(*x1a, x1n))]
    for case in edges.X1_EDGE_CASES:
        *x1a, x1n = edges.x1_edge_batch(np.random.default_rng(150), case)
        x1a = [v.to(dev) for v in x1a]
        win_edges.append((f"place_windows_aligned x1/{case}",
                          lambda lib, x1a=x1a, x1n=x1n: place_aligned(
                              lib, x1a, x1n),
                          ck.place_windows_aligned_plain(*x1a, x1n)))

    for case in edges.K14_EDGE_CASES:
        ga = [v.to(dev) for v in edges.k14_edge_batch(
            np.random.default_rng(160), case)]
        win_edges.append((f"group_windows k14/{case}",
                          lambda lib, ga=ga: group_windows(lib, *ga),
                          ck.group_windows_plain(*ga)))
    ga = edges.group_windows_args(edges.windows_many_groups(
        np.random.default_rng(1234), dev)[0])
    win_edges.append(("group_windows 160 groups",
                      lambda lib, ga=ga: group_windows(lib, *ga),
                      ck.group_windows_plain(*ga)))

    def decode_view(out):   # what placement reads, and the lane results
        return (gd.valid_emissions(out[0], out[3][:, 0]), *out[1:])

    only = args.only.split(",")
    kinds = {   # source: [(name, call, plain result, compare form)]
        "xdelta.cu": [
            ("xdelta_swizzle", lambda lib: xdelta(lib, words, 3, 4),
             ck.xdelta_swizzle_plain(words, ns, ch, 3, 4, True), None),
            ("xdelta_swizzle_u8", lambda lib: xdelta(lib, u8_2, 1, 2),
             ck.xdelta_swizzle_plain(u8_2, ns, ch, 1, 2, True), None)],
        "hzr_decode.cu": [("hzr_decode", decode,
                           decode_view(ck.hzr_decode_plain(*dargs)),
                           decode_view)],
        "tokenize.cu": [("tokenize_planes", tokenize,
                         ck.tokenize_planes_plain(enc, 3), None)],
        "compact.cu": [("compact_tokens", compact,
                        ck.compact_tokens_plain(tokw, bases, T), None)],
        "place_literals.cu": [("place_literals", place,
                               ck.place_literals_plain(
                                   emis, steps, base, limit, live,
                                   torch.zeros(total, dtype=torch.uint8,
                                               device=dev)), None)],
        "pack_flat.cu": [
            ("pack_flat", lambda lib: pack(lib, False),
             ck.pack_flat_plain(*pk_args), None),
            ("pack_flat_lanes", lambda lib: pack(lib, True),
             ck.pack_flat_lanes_plain(*pk_args, meta, init), None)],
        "fwht.cu": [("fwht", fwht, ck.fwht_plain(cen3), None)],
        "pack_blocks.cu": [
            ("pack_blocks", lambda lib: blocks(lib, False),
             ck.pack_blocks_plain(*k13a_args), None),
            ("pack_blocks_tokw", lambda lib: blocks(lib, True),
             ck.pack_blocks_tokw_plain(*k13b_args), None)],
        "dct.cu": [
            ("dct_forward", lambda lib: dct(lib, False),
             ck.dct_forward_plain(cen4, pd4._cos, pd4._fwd_scale), None),
            ("dct_inverse", lambda lib: dct(lib, True),
             ck.dct_inverse_plain(coef4, pd4._cos_t, pd4._cs,
                                  pd4._inv_scale), None)],
        # against the committed kernels, which chip_smoke phase 16 holds
        # against the plain versions at these shapes (their plain versions
        # take minutes here)
        # (float outputs compared by their bits)
        "peaks.cu": [("peak_gate", peak_gate, bits(ck.peak_gate(*gate)),
                      bits)],
        "iir.cu": [
            ("iir_scan", lambda lib: iir_scan(lib, xs, z32),
             bits(ck.iir_scan(xs, th_a, th_b, z32, z32)), bits),
            ("iir_scan_f64", lambda lib: iir_scan(lib, xs64, z64),
             bits(ck.iir_scan(xs64, th_a, th_b, z64, z64)), bits)] + [
            # S2 against its plain version on the card
            (kind, lambda lib, kind=kind: iir_assoc(lib, kind),
             bits(ck.iir_assoc_plain(*assoc[kind], tf.IIR_TILE)), bits)
            for kind in assoc],
        "fir.cu": [("fir_apply", fir,
                    bits(ck.fir_apply_plain(*fir_args)), bits)],
        "windows.cu": [
            ("group_windows", group_windows,
             ck.group_windows_plain(flat, gl.lut3), None),
            ("place_windows_aligned", place_aligned,
             ck.place_windows_aligned_plain(*glue, gl.nrows_windows), None),
            ("windows_place_flat", place_flat,
             ck.windows_place_flat_plain(*k15, gl.ng, gl.nrows_fused),
             None)]}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        keep = args.variants and args.variants.split(",")
        libs = build_variants(
            {cu: {k: v for k, v in TABLES[cu].items()
                  if not keep or k in keep} for cu in only},
            Path(tmp), args.baseline)
        runs = {}   # name: call
        kernel_of = {}  # name: the kernel's name (a substring of it)
        for (cu, name), lib in libs.items():
            _bind(cu, lib)
            for kind, fn, want, view in kinds[cu]:
                run = (lambda fn=fn, lib=lib: fn(lib))
                kernel_of[f"{kind}/{name}"] = (
                    "xdelta_swizzle_kernel" if kind.startswith("xdelta")
                    else "iir_scan_kernel" if kind.startswith("iir_scan")
                    else "fir_kernel" if kind == "fir_apply"
                    else "iir_carry_kernel" if kind.startswith("iir_assoc")
                    else "gate_speculate" if hasattr(
                        lib, "rspt_peak_gate_schedule")
                    else kind + "_kernel")
                if not is_diag(cu, name):
                    got = run()
                    cs.equal(f"{kind}/{name}", view(got) if view else got,
                             want)
                runs[f"{kind}/{name}"] = run
            if cu == "windows.cu" and not is_diag(cu, name):
                # the edge cases: a variant must hold; the baseline's
                # disagreements are reported
                differ = []
                for what, call, want in win_edges:
                    try:
                        cs.equal(f"{what}/{name}", call(lib), want)
                    except AssertionError as err:
                        if name != "baseline":
                            raise
                        differ.append(str(err))
                print(f"windows.cu edges, {name}: {len(win_edges)} calls, "
                      f"{len(differ)} differ from the plain versions "
                      f"{differ}", flush=True)
        if "tokenize.cu" in only:
            runs["tokenize_planes/library bincount (histogram only)"] = (
                lambda: torch.bincount(sym_idx, minlength=nb * 262))
        if "compact.cu" in only:
            runs["compact_tokens/library masked_select"] = (
                lambda: torch.masked_select(tok_huff, valid_huff))
        if "place_literals.cu" in only:
            runs["place_literals/library index_put_"] = (
                lambda: lib_out.index_put_((lit_pos,), lit_val))
        if "fir.cu" in only:   # not exact: another order of sums
            def conv():
                prev = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                try:
                    return torch.nn.functional.conv1d(xpad, w_conv)
                finally:
                    torch.backends.cudnn.allow_tf32 = prev
            runs["fir_apply/library conv1d (TF32 off)"] = conv
        if "dct.cu" in only:   # not exact: another summation order
            runs["dct_forward/library f64 matmul"] = (
                lambda: torch.matmul(cen4_64, cos4_64))
            runs["dct_inverse/library f64 matmul"] = (
                lambda: torch.matmul(q4_64, cos4t_64))
        torch.cuda.synchronize()
        times = {name: [] for name in runs}
        reps = {name: REPS.get(name.split("/")[0], cs.REPS) for name in runs}
        for _ in range(args.rounds):
            for name, fn in runs.items():
                times[name].append(cs.device_ms(fn, reps[name])
                                   or cs.cuda_ms(fn, reps[name]))
        # the named kernel of a call alone (median of its launches),
        # without the call's memsets, copies and other kernels
        alone = {name: cs.device_ms(fn, reps[name], kernel=kernel_of[name])
                 for name, fn in runs.items() if name in kernel_of}
    med = {name: statistics.median(ts) for name, ts in times.items()}
    for name, ts in times.items():
        print(f"{name}: median {med[name]:.6f} ms (the kernel alone "
              f"{alone.get(name)}), rounds {[round(t, 6) for t in ts]}",
              flush=True)
    print(smi)
    print(json.dumps({"kernel_ab_ms": med, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
