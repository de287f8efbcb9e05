"""hzr format constants, CRC32C and the LZ4 block spec codec (own copies
of rspt_tpu/formats)."""
