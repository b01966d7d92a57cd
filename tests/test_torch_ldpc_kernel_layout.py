"""The BP kernel's graph layout and launch form, on the CPU.

`kernel_layout` (models/ldpc_cuda.py) relabels a code's checks and edges
for the card: checks sorted by degree into runs, edge slot k of the j-th
check of a run of n checks at `first edge + k * n + j`, and a var-side
list of each variable's edges.  The kernel's outputs are bit-exact only if
that is the same bipartite graph: these tests hold it to the structure's
CSR and column views, edge for edge (parallel edges kept), check the packed
blob the kernel reads, and check which form (`launch_form`: the layout in
shared or global memory, codeword groups a block) each config gets.
"""

import numpy as np
import pytest

from libpoporon_tpu_torch.config import (LdpcConfig, LdpcMatrixType, LdpcRate,
                                         ldpc_config_burst_resistant, ldpc_config_default)
from libpoporon_tpu_torch.models.ldpc import LDPCCodec, get_structure
from libpoporon_tpu_torch.models.ldpc_cuda import (
    BLOCK_THREADS, GAP, NO_EDGE, SMEM_LIMIT, BPCudaKernel, graph_bytes, kernel_layout,
    launch_form, state_bytes)

R12 = LdpcRate.RATE_1_2

# chip_smoke.py phase 6's configs, the gate's largest codes, and a code the
# smaller soft state brought inside the gate; each with its expected form
CASES = {
    "128B-r12": (LdpcConfig(128, R12), "shared", 8),
    "default": (ldpc_config_default(128, R12), "shared", 8),
    "burst-cw7": (ldpc_config_burst_resistant(128, R12), "shared", 4),
    "128B-qc": (LdpcConfig(128, R12, matrix_type=LdpcMatrixType.QC_RANDOM), "shared", 8),
    "64B-r13": (LdpcConfig(64, LdpcRate.RATE_1_3), "shared", 8),
    "128B-r34": (LdpcConfig(128, LdpcRate.RATE_3_4, use_inner_interleave=True,
                            use_outer_interleave=True), "shared", 8),
    "512B-r12": (LdpcConfig(512, R12), "shared", 1),
    "1024B-r12": (LdpcConfig(1024, R12), "global", 1),
    "1024B-r12-cw4": (LdpcConfig(1024, R12, column_weight=4), "global", 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_layout_is_the_same_graph(name):
    cfg, form, groups = CASES[name]
    s = get_structure(cfg)
    P, V, E = s.num_checks, s.num_bits, s.num_edges_used
    lay = kernel_layout(s)
    runs, order, ev, vslot = lay["runs"], lay["check_order"], lay["ev"], lay["vslot"]
    row_counts, col_counts = np.diff(s.row_ptr), np.diff(s.col_ptr)

    # runs: ascending degrees, covering the sorted checks and the edges back to back
    first, deg, n, edge0 = runs.T.astype(np.int64)
    assert (np.diff(deg) > 0).all() and (n > 0).all()
    assert np.array_equal(first, np.concatenate([[0], np.cumsum(n)[:-1]]))
    assert np.array_equal(edge0, np.concatenate([[0], np.cumsum(deg * n)[:-1]]))
    assert n.sum() == P and (deg * n).sum() == E
    assert np.array_equal(np.sort(order), np.arange(P))
    assert np.array_equal(row_counts[order], np.repeat(deg, n))

    # check side: slot k of each check holds its k-th CSR variable, so each
    # check keeps its multiset of variables, parallel edges included
    for f, d, m, e0 in zip(first, deg, n, edge0):
        orig = order[f:f + m]
        got = ev[e0 + np.arange(d)[:, None] * m + np.arange(m)[None, :]]
        want = s.col_idx[s.row_ptr[orig][None, :] + np.arange(d)[:, None]]
        assert np.array_equal(got, want)
    new_edge = lay["new_edge"]
    assert np.array_equal(np.sort(new_edge), np.arange(E))
    assert np.array_equal(ev[new_edge], s.col_idx)

    # var side: each variable's edges in column order, then NO_EDGE; the
    # inverse of the check side (every kernel edge once, at its variable)
    dv = lay["dv"]
    assert vslot.shape == (dv, V) and dv == col_counts.max()
    real = vslot != NO_EDGE
    assert np.array_equal(real.sum(0), col_counts)
    assert not (~real[:-1] & real[1:]).any()            # padding only at the end
    slots = vslot[real].astype(np.int64)
    assert np.array_equal(np.sort(slots), np.arange(E))
    assert np.array_equal(ev[vslot.astype(np.int64)[real]], np.nonzero(real)[1])
    for v in (0, s.info_bits, V - 1):                    # column order kept
        cols = s.cv_edge_idx[s.col_ptr[v]:s.col_ptr[v + 1]]
        assert np.array_equal(vslot[: len(cols), v], new_edge[cols])

    # the inner deinterleaver's gather, gaps as GAP
    src, g = lay["src"], s.inner_deinterleave_gather
    assert (src is None) == (g is None)
    if g is not None:
        assert np.array_equal(src, np.where(g < 0, GAP, g))
        assert (g >= 0).all() or name == "128B-r34"      # its gaps: F2

    # the blob the kernel reads: runs, vslot, src, 16-byte aligned
    blob = lay["blob"]
    R = len(runs)
    assert len(blob) == graph_bytes(R, dv, V, src is not None) and len(blob) % 16 == 0
    assert np.array_equal(blob[: 16 * R].view(np.int32).reshape(R, 4), runs)
    off = 16 * R
    assert np.array_equal(blob[off: off + 2 * dv * V].view(np.uint16).reshape(dv, V), vslot)
    off = (off + 2 * dv * V + 15) & ~15
    if src is not None:
        assert np.array_equal(blob[off: off + 2 * V].view(np.uint16), src)

    # the wrapper's size dispatch
    assert BPCudaKernel.supports(s)
    f = launch_form(s, lay)
    assert (f["form"], f["groups"]) == (form, groups)
    assert f["threads"] % 32 == 0 and f["threads"] >= 128
    assert f["groups"] * f["threads"] <= BLOCK_THREADS
    staged = len(blob) if form == "shared" else 16 * R
    assert staged + groups * state_bytes(s) <= SMEM_LIMIT
    if form == "global":
        assert len(blob) + state_bytes(s) > SMEM_LIMIT
    elif groups < 8:
        assert len(blob) + (groups + 1) * state_bytes(s) > SMEM_LIMIT
    codec = LDPCCodec(cfg, "cpu")          # no launcher on the CPU; its form from the structure
    assert codec.kernel is None
    assert launch_form(codec.structure, kernel_layout(codec.structure)) == f


def test_kernel_gate_keeps_every_code_it_had():
    """Codes whose old soft state (v2c, c2v, llr and channel per codeword)
    fit stay on the kernel; 1024 B rate 1/3 stays off it."""
    for bs, rate in ((64, LdpcRate.RATE_1_3), (128, LdpcRate.RATE_3_4),
                     (1024, R12), (1024, LdpcRate.RATE_2_3)):
        s = get_structure(LdpcConfig(bs, rate))
        assert 2 * (2 * s.num_edges_used + 2 * s.num_bits) <= SMEM_LIMIT
        assert BPCudaKernel.supports(s)
    assert not BPCudaKernel.supports(get_structure(LdpcConfig(1024, LdpcRate.RATE_1_3)))
