"""Kernels of the modern-codec decode: descriptor tables, unpack, checksum."""
