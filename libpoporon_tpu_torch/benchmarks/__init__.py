"""The port's measurement scripts (counterparts of benchmarks/ in the
repository root): `probe_dma`, the row-gather and contiguous-copy probes,
`waterfall`, the LDPC BER sweep, and `bp_kernel`, the BP kernel's time
on the LDPC main paths' inputs and its split by pass.  Each runs as
`python -m libpoporon_tpu_torch.benchmarks.<name>`."""
