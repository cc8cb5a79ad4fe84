"""The yardstick of the port's benchmark: frozen copies of the sound
measurement pieces (peaks, roofline bounds, conv launch counts, the MAC
count, the busy-union arithmetic, the weights reader, the synthetic data
makers) and the drivers that run one cell. Nothing here imports jax or
the JAX package; the drivers import the port (dram_tpu_torch) as the
system under test."""
