"""hzr format constants and CRC32C (own copies of rspt_tpu/formats)."""
