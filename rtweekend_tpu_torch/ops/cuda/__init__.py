"""The hand-written CUDA bounce kernel: build, wrapper, plain version, driver."""
