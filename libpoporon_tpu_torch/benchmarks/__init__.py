"""The port's measurement scripts (counterparts of benchmarks/ in the
repository root): `probe_dma`, the row-gather and contiguous-copy probes,
and `waterfall`, the LDPC BER sweep.  Each runs as
`python -m libpoporon_tpu_torch.benchmarks.<name>`."""
