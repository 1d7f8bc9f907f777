"""The benchmark harness of multilevel_gnn_tpu_torch: one cell of
BENCHMARK.json run once.  It imports the port (the system under test) and
nothing of the JAX package."""
