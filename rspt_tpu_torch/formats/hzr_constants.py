"""hzr bitstream format constants.

The hzr format (the bit-exactness contract of this framework) is a
RLE + canonical-preorder-Huffman block format:

* Master header: 4 bytes — decoded size as little-endian uint32
  (reference: lib_rspt/lib_hzr/hzr_internal.h:84-98).
* Blocks, each decoding to at most 65536 bytes, with a 7-byte header:
  ``u16le encoded_size-1 | u32le crc32c(payload) | u8 mode``
  (hzr_internal.h:88-101).
* Modes: 0 = plain copy, 1 = Huffman+RLE, 2 = fill
  (hzr_internal.h:103-106).
* Alphabet: 261 symbols — bytes 0..255 plus 5 zero-run symbols
  (hzr_internal.h:111-121).

All bit I/O is least-significant-bit-first within bytes
(hzr_encode.c:94-113 WriteBits / hzr_decode.c:136-155 ReadBits).
"""

HEADER_SIZE = 4
BLOCK_HEADER_SIZE = 7

ENCODING_COPY = 0
ENCODING_HUFF_RLE = 1
ENCODING_FILL = 2

MAX_BLOCK_SIZE = 65536

SYMBOL_SIZE = 9  # bits used to store a symbol in the tree description
NUM_SYMBOLS = 261
MAX_TREE_NODES = NUM_SYMBOLS * 2 - 1  # 521

# Zero-run RLE symbols (hzr_internal.h:117-121):
#   symbol  run length   extra bits (stores run_length - base)
SYM_TWO_ZEROS = 256       # exactly 2 zeros,   0 extra bits
SYM_UPTO6_ZEROS = 257     # 3..6 zeros,        2 extra bits (len-3)
SYM_UPTO22_ZEROS = 258    # 7..22 zeros,       4 extra bits (len-7)
SYM_UPTO278_ZEROS = 259   # 23..278 zeros,     8 extra bits (len-23)
SYM_UPTO16662_ZEROS = 260  # 279..16662 zeros, 14 extra bits (len-279)

MAX_ZERO_RUN = 16662

# (base_run_length, extra_bits) for RLE symbols 256..260.
RLE_BASES = (2, 3, 7, 23, 279)
RLE_EXTRA_BITS = (0, 2, 4, 8, 14)


def max_compressed_size(uncompressed_size: int) -> int:
    """Worst-case encoded size (reference: hzr_encode.c:489-497)."""
    data_size = 0
    if uncompressed_size > 0:
        num_blocks = (uncompressed_size + MAX_BLOCK_SIZE - 1) // MAX_BLOCK_SIZE
        data_size = num_blocks * BLOCK_HEADER_SIZE + uncompressed_size
    return HEADER_SIZE + data_size
