"""The benchmark's plain reference: a path tracer of the same semantics as
the program under test, written with plain PyTorch and NumPy operations.

It imports nothing of the program. It builds each scene, its camera and
its rays again from the inputs the benchmark hands to both sides (scene
name, seed, sizes), traces them, and decodes the PNG files the program
wrote with its own zlib reader.
"""
