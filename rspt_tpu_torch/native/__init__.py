"""The port's host runtime: its own C++ (CRC32C, Huffman tables, the
block-parallel hzr decoder, the device decoder's LUTs), built with g++
at first use and bound with ctypes (``bindings``)."""
