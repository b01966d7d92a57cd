"""The benchmark of libpoporon_tpu_torch on NVIDIA H100 cards: one cell a
run (`python3 fecbench/run.py --workload <name> ...`), cells in
BENCHMARK.json at the checkout's root.  Nothing here imports JAX or the
JAX package; the plain references in `reference/` import nothing of the
program under test."""
