"""Launcher of the hand-written CUDA LDPC BP kernel (csrc/ldpc_bp.cu).

Counterpart of libpoporon_tpu/models/ldpc_pallas.py: one kernel serves
the packed hard entry, the int8 soft entry and the expanded-LLR `bp`
entry.  `BPCudaKernel` launches it on CUDA tensors through
utils/build.py `launch`, and raises if the launch fails; it knows
nothing of the codec.  models/ldpc.py `LDPCCodec` builds one for a codec
on a card whose structure the kernel supports (`BPCudaKernel.supports`);
every other codec runs the plain PyTorch version there.

The kernel's blocks are persistent: each holds `groups` codeword groups,
and a group takes codewords from a device counter until the batch is
done, so any batch size runs with no host padding.  The launcher builds
the graph's layout for the card once (`kernel_layout`), chooses from the
sizes whether the blocks keep that layout in shared memory or read it
from global memory (`launch_form`), and launches as many blocks as the
card holds resident.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import build
from ..utils.profiling import span
from ..utils.tensors import checked

MODE_HARD_PACKED, MODE_SOFT_LLR8, MODE_HARD_LLR, MODE_SOFT_LLR = 0, 1, 2, 3
# Dynamic shared memory one block may use on sm_90 (227 KB), the only
# target the library is built for.
SMEM_LIMIT = 232448
MAX_INDEX = 65535     # the layout's edge and variable indices are uint16
NO_EDGE = 0xFFFF      # vslot past a variable's degree
GAP = 0xFFFF          # src of a deinterleave gap
BLOCK_THREADS = 1024  # a block: groups x threads a group
MAX_GROUPS = 8        # codeword groups a block, at least 128 threads each


def _align16(x: int) -> int:
    return (x + 15) & ~15


def state_bytes(structure) -> int:
    """Shared memory of one codeword group's state, hard or soft: the next
    codeword index, the hard-decision bitmap, v2c and c2v per edge (int16)
    and the llr or channel per variable (int16), each 16-byte aligned (as
    csrc/ldpc_bp.cu `state_bytes`)."""
    E, V = structure.num_edges_used, structure.num_bits
    return 16 + _align16(4 * ((V + 31) // 32)) + 2 * _align16(2 * E) + _align16(2 * V)


def graph_bytes(runs: int, dv: int, V: int, has_src: bool) -> int:
    """Bytes of the packed layout (as csrc/ldpc_bp.cu `graph_bytes`)."""
    return _align16(16 * runs + 2 * dv * V) + (_align16(2 * V) if has_src else 0)


def kernel_layout(structure) -> dict:
    """The graph in the kernel's layout, as NumPy arrays.

    Checks are sorted by degree (stably) into runs of equal degree; edge
    slot k of the j-th check of a run of n checks starting at edge s is
    edge s + k * n + j.  Slots follow each check's CSR order.

    Returns runs [R, 4] int32 {first sorted check, degree, checks, first
    edge}; check_order [P] (sorted check -> original check); new_edge [E]
    (CSR edge -> kernel edge); ev [E] (kernel edge -> variable); vslot
    [dv, V] uint16 (variable -> its kernel edges in column order, NO_EDGE
    past its degree); src [V] uint16, the inner deinterleaver's gather (GAP
    for a gap), or None without an inner interleaver; and blob, what the
    kernel reads: runs, vslot and src back to back, each 16-byte aligned
    (graph_bytes bytes).  The check side needs no list: the kernel finds a
    check's edges by position, and the variables only through vslot.
    """
    s = structure
    P, V, E = s.num_checks, s.num_bits, s.num_edges_used
    row_counts = np.diff(s.row_ptr)
    col_counts = np.diff(s.col_ptr)
    dv = max(int(col_counts.max()), 1)
    check_order = np.argsort(row_counts, kind="stable")
    sorted_deg = row_counts[check_order]
    degs, first, counts = np.unique(sorted_deg, return_index=True, return_counts=True)
    run_edge = np.concatenate([[0], np.cumsum(degs * counts)[:-1]])
    runs = np.stack([first, degs, counts, run_edge], axis=1).astype(np.int32)

    # kernel edge of each CSR edge: its check's run, slot and rank in the run
    rank = np.empty(P, dtype=np.int64)
    rank[check_order] = np.arange(P)
    run_of = np.searchsorted(first, rank, side="right") - 1       # per original check
    c = s.erow                                                    # check of each CSR edge
    slot = np.arange(E, dtype=np.int64) - s.row_ptr[c]
    r = run_of[c]
    new_edge = run_edge[r] + slot * counts[r] + (rank[c] - first[r])
    ev = np.empty(E, dtype=np.int64)
    ev[new_edge] = s.col_idx

    # var side: column-view order (cv_edge_idx) mapped to kernel edges
    vslot = np.full((dv, V), NO_EDGE, dtype=np.int64)
    v_of = s.col_idx[s.cv_edge_idx]
    t = np.arange(E, dtype=np.int64) - s.col_ptr[v_of]
    vslot[t, v_of] = new_edge[s.cv_edge_idx]

    src = None
    if s.inner_deinterleave_gather is not None:
        g = s.inner_deinterleave_gather
        src = np.where(g < 0, GAP, g).astype(np.uint16)

    vslot = vslot.astype(np.uint16)
    parts = [runs, vslot] + ([src] if src is not None else [])
    blob = np.zeros(graph_bytes(len(runs), dv, V, src is not None), dtype=np.uint8)
    off = 0
    for a in parts:
        raw = a.view(np.uint8).reshape(-1)
        blob[off: off + raw.size] = raw
        off = _align16(off + raw.size)
    return dict(runs=runs, check_order=check_order, new_edge=new_edge,
                ev=ev, vslot=vslot, src=src, dv=dv, blob=blob)


def launch_form(structure, layout: dict) -> dict:
    """How the kernel runs this code: `shared` (the layout staged in shared
    memory, shared by the block's groups) when the layout and at least one
    codeword state fit one block's shared memory, else `global` (the
    layout read from global memory).  `groups` codeword groups a block, as
    many states as fit up to MAX_GROUPS, of `threads` threads each (a
    multiple of 32, groups x threads <= BLOCK_THREADS)."""
    st = state_bytes(structure)
    runs = len(layout["runs"])
    shared = (SMEM_LIMIT - len(layout["blob"])) // st
    groups = shared if shared >= 1 else (SMEM_LIMIT - 16 * runs) // st
    groups = min(MAX_GROUPS, groups)
    return dict(form="shared" if shared >= 1 else "global", groups=groups,
                threads=BLOCK_THREADS // groups // 32 * 32)


class BPCudaKernel:
    """Min-sum BP decode (hard packed, soft int8, expanded LLRs) as one
    CUDA kernel.

    `launches` counts kernel launches, so that a run can show that its
    decodes went through the kernel.  Every entry takes CUDA tensors on
    the launcher's card, and raises ValueError for any other.
    """

    @staticmethod
    def supports(structure) -> bool:
        """Gate: one codeword group's state and the layout's degree runs fit
        one block's shared memory, and the indices fit uint16."""
        runs = len(np.unique(np.diff(structure.row_ptr)))
        return (16 * runs + state_bytes(structure) <= SMEM_LIMIT
                and structure.num_edges_used <= MAX_INDEX
                and structure.num_bits <= MAX_INDEX)

    def __init__(self, structure, device):
        """structure: models.ldpc.LdpcStructure; device: the card the
        kernel runs on."""
        s = structure
        if not self.supports(s):
            raise ValueError("LDPC structure outside the kernel's gate")
        self.launches = 0
        self.V, self.P, self.E = s.num_bits, s.num_checks, s.num_edges_used
        lay = kernel_layout(s)
        self.runs, self.dv = len(lay["runs"]), lay["dv"]
        self.has_src = int(lay["src"] is not None)
        self.form = launch_form(s, lay)
        self.graph = torch.from_numpy(lay["blob"]).to(device)
        self._blocks_per_sm = {}

    def bp_packed_hard(self, codeword_bytes, mi: int):
        """Hard decode from packed bytes [B, ceil(V/8)] u8, the inner
        deinterleaver folded in.  Returns (ok [B] bool, packed output
        [B, ceil(V/8)] u8, iters [B] int32)."""
        nbytes = (self.V + 7) // 8
        x = checked(codeword_bytes, torch.uint8,
                    (codeword_bytes.shape[0], nbytes), codeword_bytes.device)
        return self._launch(MODE_HARD_PACKED, x, None, nbytes, torch.uint8, mi)

    def bp_llr8_soft(self, llr8, mi: int):
        """Soft decode from channel LLRs [B, V] int8 (x256 inside), the
        inner deinterleaver folded in.  Returns as bp_packed_hard."""
        x = checked(llr8, torch.int8, (llr8.shape[0], self.V), llr8.device)
        return self._launch(MODE_SOFT_LLR8, x, None, (self.V + 7) // 8, torch.uint8, mi)

    def bp(self, llr_init_p, channel_soft_p, mi: int):
        """The BP loop on var-major LLR tensors (LDPCCodec._bp_plain's
        contract: the initial bits and the pre-converged mask derived from
        the signs of llr_init_p in hard mode).

        llr_init_p: [V+1, B] int16 in +-32000, fake row V at +32000;
        channel_soft_p: None (hard) or [V+1, B] int16.  Returns (ok [B]
        bool, out_bits [V+1, B] int8 with the fake row 0, iters [B] int32).
        """
        dev, V = llr_init_p.device, self.V
        B = llr_init_p.shape[1]
        llr = checked(llr_init_p, torch.int16, (V + 1, B), dev)[:V].T.contiguous()
        chan = None
        mode = MODE_HARD_LLR
        if channel_soft_p is not None:
            chan = checked(channel_soft_p, torch.int16, (V + 1, B), dev)[:V].T.contiguous()
            mode = MODE_SOFT_LLR
        ok, bits, iters = self._launch(mode, llr, chan, V, torch.int8, mi)
        out = torch.cat([bits.T, torch.zeros(1, B, dtype=torch.int8, device=dev)])
        return ok, out, iters

    def blocks_per_sm(self, mode: int, device) -> int:
        """Blocks of this code's form that one SM of `device` holds at
        once (the CUDA occupancy calculator), cached per mode and card."""
        dev = torch.device(device)
        key = (mode, dev.index or 0)
        if key not in self._blocks_per_sm:
            f = self.form
            n = build.occupancy(
                "pp_ldpc_bp_blocks_per_sm", dev, mode, self.V, self.P, self.E, self.runs,
                self.dv, self.has_src, int(f["form"] == "shared"), f["groups"], f["threads"],
                dev.index or 0)
            if n == 0:
                raise RuntimeError("ldpc_bp kernel: no block fits an SM")
            self._blocks_per_sm[key] = n
        return self._blocks_per_sm[key]

    def _launch(self, mode, x, chan, out_width, out_dtype, mi):
        with span("poporon.launch.ldpc_bp"):
            dev = x.device
            if dev.type != "cuda" or dev != self.graph.device:
                raise ValueError(f"the LDPC kernel takes CUDA tensors on {self.graph.device}, "
                                 f"got {dev}")
            if mi < 1:
                raise ValueError(f"max_iterations must be >= 1, got {mi}")
            B = x.shape[0]
            out = torch.empty(B, out_width, dtype=out_dtype, device=dev)
            ok = torch.empty(B, dtype=torch.bool, device=dev)
            iters = torch.empty(B, dtype=torch.int32, device=dev)
            if B == 0:
                return ok, out, iters
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            f = self.form
            grid = min(build.sm_count(dev.index or 0) * self.blocks_per_sm(mode, dev),
                       -(-B // f["groups"]))
            build.launch("pp_ldpc_bp", dev, mode, x, chan, self.graph, out, ok, iters, counter,
                         B, self.V, self.P, self.E, self.runs, self.dv, self.has_src, int(mi),
                         int(f["form"] == "shared"), f["groups"], f["threads"], grid)
            self.launches += 1
            return ok, out, iters
