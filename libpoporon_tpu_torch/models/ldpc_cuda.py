"""Wrapper of the hand-written CUDA LDPC BP kernel (csrc/ldpc_bp.cu).

Counterpart of libpoporon_tpu/models/ldpc_pallas.py: one kernel serves
the packed hard entry, the int8 soft entry and the expanded-LLR `bp`
entry.  For a CUDA tensor the wrapper launches the kernel (and raises if
the launch fails); for a CPU tensor it runs the kernel's plain PyTorch
version (models/ldpc.py).  The kernel decodes one codeword per block and
takes any batch size, so the host pads nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import build
from ..utils.tensors import checked

MODE_HARD_PACKED, MODE_SOFT_LLR8, MODE_HARD_LLR, MODE_SOFT_LLR = 0, 1, 2, 3
# Dynamic shared memory one block may use on sm_90 (227 KB), the only
# target the library is built for.
SMEM_LIMIT = 232448
MAX_INDEX = 65535    # the graph's index lists are uint16


def state_bytes(structure, soft: bool) -> int:
    """Shared memory of one codeword's int16 state: v2c and c2v per edge,
    llr (and the soft channel) per variable."""
    E, V = structure.num_edges_used, structure.num_bits
    return 2 * (2 * E + (2 if soft else 1) * V)


class BPCudaKernel:
    """Min-sum BP decode (hard packed, soft int8, expanded LLRs) as one
    CUDA kernel.

    `launches` counts kernel launches, so that a run can show that its
    decodes went through the kernel.
    """

    @staticmethod
    def supports(structure) -> bool:
        """Gate: the soft state fits in one block's shared memory and the
        indices fit uint16."""
        return (state_bytes(structure, soft=True) <= SMEM_LIMIT
                and structure.num_edges_used <= MAX_INDEX)

    def __init__(self, codec):
        """codec: models.ldpc.LDPCCodec (supplies the structure and the
        plain version)."""
        s = codec.structure
        if not self.supports(s):
            raise ValueError("LDPC structure outside the kernel's gate")
        self.codec = codec
        self.launches = 0
        self.V, self.P, self.E = s.num_bits, s.num_checks, s.num_edges_used
        # row_ptr, col_idx, col_ptr and the CSR edge of each CSC entry,
        # back to back as uint16 (kept in an int16 tensor of the same bits)
        graph = np.concatenate([s.row_ptr, s.col_idx, s.col_ptr, s.cv_edge_idx])
        self.graph = torch.from_numpy(
            graph.astype(np.uint16).view(np.int16)).to(codec.device)
        self.src = None
        if s.inner_deinterleave_gather is not None:
            self.src = torch.from_numpy(
                s.inner_deinterleave_gather.astype(np.int32)).to(codec.device)

    def bp_packed_hard(self, codeword_bytes, mi: int):
        """Hard decode from packed bytes [B, ceil(V/8)] u8, the inner
        deinterleaver folded in.  Returns (ok [B] bool, packed output
        [B, ceil(V/8)] u8, iters [B] int32)."""
        if codeword_bytes.device.type == "cpu":
            return self.codec._plain("hard", codeword_bytes, mi)
        nbytes = (self.V + 7) // 8
        x = checked(codeword_bytes, torch.uint8,
                    (codeword_bytes.shape[0], nbytes), codeword_bytes.device)
        return self._launch(MODE_HARD_PACKED, x, None, self.src, nbytes, torch.uint8, mi)

    def bp_llr8_soft(self, llr8, mi: int):
        """Soft decode from channel LLRs [B, V] int8 (x256 inside), the
        inner deinterleaver folded in.  Returns as bp_packed_hard."""
        if llr8.device.type == "cpu":
            return self.codec._plain("soft", llr8, mi)
        x = checked(llr8, torch.int8, (llr8.shape[0], self.V), llr8.device)
        return self._launch(MODE_SOFT_LLR8, x, None, self.src, (self.V + 7) // 8,
                            torch.uint8, mi)

    def bp(self, llr_init_p, channel_soft_p, mi: int):
        """The BP loop on var-major LLR tensors (LDPCCodec._bp_loop's
        contract, with the initial bits and the pre-converged mask derived
        from the signs of llr_init_p in hard mode).

        llr_init_p: [V+1, B] int16 in +-32000, fake row V at +32000;
        channel_soft_p: None (hard) or [V+1, B] int16.  Returns (ok [B]
        bool, out_bits [V+1, B] int8 with the fake row 0, iters [B] int32).
        """
        if llr_init_p.device.type == "cpu":
            return self.codec._bp_plain(llr_init_p, channel_soft_p, mi)
        dev, V = llr_init_p.device, self.V
        B = llr_init_p.shape[1]
        llr = checked(llr_init_p, torch.int16, (V + 1, B), dev)[:V].T.contiguous()
        chan = None
        mode = MODE_HARD_LLR
        if channel_soft_p is not None:
            chan = checked(channel_soft_p, torch.int16, (V + 1, B), dev)[:V].T.contiguous()
            mode = MODE_SOFT_LLR
        ok, bits, iters = self._launch(mode, llr, chan, None, V, torch.int8, mi)
        out = torch.cat([bits.T, torch.zeros(1, B, dtype=torch.int8, device=dev)])
        return ok, out, iters

    def _launch(self, mode, x, chan, src, out_width, out_dtype, mi):
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"the LDPC kernel takes CUDA tensors, got {dev}")
        if mi < 1:
            raise ValueError(f"max_iterations must be >= 1, got {mi}")
        B = x.shape[0]
        out = torch.empty(B, out_width, dtype=out_dtype, device=dev)
        ok = torch.empty(B, dtype=torch.bool, device=dev)
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return ok, out, iters
        graph = self.graph.to(dev)
        src = None if src is None else src.to(dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        lib = build.load_library()
        rc = lib.pp_ldpc_bp(
            mode, ptr(x), ptr(chan), ptr(graph), ptr(src), ptr(out), ptr(ok),
            ptr(iters), B, self.V, self.P, self.E, int(mi), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ldpc_bp kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return ok, out, iters
