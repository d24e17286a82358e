"""RNG, vector math, Perlin tables and image I/O."""
