"""LDPC codec in PyTorch.

Counterpart of libpoporon_tpu/models/ldpc.py, and bit-identical to its
XLA path on every input: ok, output bytes and iteration counts.

* The host structure (`LdpcStructure`: the parity-check matrix, its
  column view, the inner and outer interleavers and the decoder layout)
  is a value-identical NumPy copy, built from the reference's seeded
  xoshiro stream (utils/rng.py).  `LdpcStructure.from_arrays` builds one
  from a JAX structure's arrays.
* Encode is the row info sums (an fp32 matmul against H[:, :I], exact
  for 0/1 operands and sums up to 2^24) followed by the staircase prefix
  XOR.
* The min-sum BP loop keeps the JAX package's var-major layout: bits and
  LLRs are [V+1, B] with one fake variable (row V) pinned at +LLR_MAX,
  check-side messages live in degree-bucketed planes, and both updates
  are row gathers with constant indices.  Messages are stored as int16
  and the arithmetic runs in int32.

The decode bodies here are the plain version of the CUDA kernel
(models/ldpc_cuda.py).  A codec decides once, when it is built, which of
the two it runs: a codec on a card whose structure the kernel supports
(`BPCudaKernel.supports`) builds its launcher (`kernel`) and sends every
decode through it, an adaptive one as one full-budget launch; every
other codec, and every codec on the CPU, has `kernel` None and runs
these functions, an adaptive decode through the cascade.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..config import LdpcConfig, LdpcMatrixType, LdpcRate
from ..utils import bits as bitutils
from ..utils.cache import LruCache
from ..utils.profiling import span
from ..utils.rng import Xoshiro128pp
from ..utils.tensors import as_tensor
from .ldpc_cuda import BPCudaKernel

MIN_BLOCK_SIZE = 32
MAX_BLOCK_SIZE = 8192
MIN_COL_WEIGHT = 3
MAX_COL_WEIGHT = 8
DEFAULT_MAX_ITERATIONS = 50
LLR_MAX = 32000
LLR_MIN = -32000
LLR_INFINITY = 30000
LLR_SCALE = 256

# The arrays a structure is built from, by the JAX structure's attribute
# names; the interleaver arrays are None where the config has none.
ARRAY_NAMES = ("row_ptr", "col_idx", "col_ptr", "cv_row_idx", "cv_edge_idx",
               "erow", "inner_forward", "inner_inverse",
               "inner_interleave_gather", "inner_deinterleave_gather",
               "outer_forward", "outer_inverse")


class LdpcError(ValueError):
    pass


def _degree_buckets(row_counts: np.ndarray, max_buckets: int = 5):
    """Partition checks into <= max_buckets degree classes minimizing the
    total padded plane size sum(dc_b * P_b), by exhaustive search over the
    split degrees (the degree alphabet is tiny)."""
    degs = [int(d) for d in np.unique(row_counts)]
    hist = {d: int((row_counts == d).sum()) for d in degs}

    def cost_of(splits):
        lo, total = 0, 0
        for hi in splits:
            total += hi * sum(v for d, v in hist.items() if lo < d <= hi)
            lo = hi
        return total

    best, best_cost = None, None
    for k in range(1, min(max_buckets, len(degs)) + 1):
        for mids in itertools.combinations(degs[:-1], k - 1):
            splits = list(mids) + [degs[-1]]
            c = cost_of(splits)
            if best_cost is None or c < best_cost:
                best, best_cost = splits, c

    out, lo = [], 0
    for hi in best:
        sel = np.flatnonzero((row_counts > lo) & (row_counts <= hi))
        if len(sel):
            out.append(dict(checks=sel, dc=int(hi)))
        lo = hi
    return out


# =====================================================================
# Host-side structure construction (bit-exact with ldpc.c)
# =====================================================================


class LdpcStructure:
    def __init__(self, cfg: LdpcConfig):
        self._set_dims(cfg)
        if cfg.matrix_type == LdpcMatrixType.QC_RANDOM:
            self._build_qc(self.col_weight)
        else:
            self._build_random(self.col_weight)
        self._build_column_view()
        self._build_interleaver()
        self._build_outer_interleaver()

    @classmethod
    def from_arrays(cls, cfg: LdpcConfig, arrays: dict) -> "LdpcStructure":
        """A structure from given arrays (ARRAY_NAMES, None for an absent
        interleaver), e.g. a JAX structure's, taken with np.asarray."""
        s = cls.__new__(cls)
        s._set_dims(cfg)
        for name in ARRAY_NAMES:
            a = arrays.get(name)
            setattr(s, name, None if a is None else np.asarray(a, dtype=np.int64))
        s.num_checks = len(s.row_ptr) - 1
        s.num_bits = len(s.col_ptr) - 1
        s.num_edges_used = int(s.row_ptr[-1])
        return s

    def _set_dims(self, cfg: LdpcConfig):
        if (cfg.block_size < MIN_BLOCK_SIZE or cfg.block_size > MAX_BLOCK_SIZE
                or cfg.block_size % 4 != 0):
            raise LdpcError(f"invalid block_size {cfg.block_size} (ldpc.c:821)")
        try:
            rate = LdpcRate(cfg.rate)
        except ValueError as e:
            raise LdpcError("invalid rate (ldpc.c:825)") from e
        self.cfg = cfg
        info_num, parity_num = rate.ratio
        self.info_bits = cfg.block_size * 8
        self.parity_bits = (self.info_bits * parity_num) // info_num
        self.codeword_bits = self.info_bits + self.parity_bits
        self.info_bytes = cfg.block_size
        self.parity_bytes = (self.parity_bits + 7) // 8
        self.codeword_bytes = self.info_bytes + self.parity_bytes
        self.col_weight = min(max(cfg.column_weight, MIN_COL_WEIGHT), MAX_COL_WEIGHT)
        self.num_edges_alloc = self.info_bits * self.col_weight + 2 * self.parity_bits - 1

    # --------------------------------------------- matrix construction

    def _place_info_edges(self, targets: np.ndarray, info_cols: np.ndarray):
        """Shared CSR fill: info edges in draw order, then the staircase
        parity columns (ldpc.c:326-368)."""
        P = self.parity_bits
        info_counts = np.bincount(targets, minlength=P).astype(np.int64)
        row_counts = info_counts + np.where(np.arange(P) == 0, 1, 2)
        row_ptr = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(row_counts, out=row_ptr[1:])
        col_idx = np.zeros(int(row_ptr[-1]), dtype=np.int64)

        # info edges: within each row, in draw order (stable sort)
        order = np.argsort(targets, kind="stable")
        st = targets[order]
        info_start = np.zeros(P, dtype=np.int64)
        np.cumsum(info_counts[:-1], out=info_start[1:])
        ranks = np.arange(len(targets), dtype=np.int64) - info_start[st]
        col_idx[row_ptr[st] + ranks] = info_cols[order]

        # staircase parity part
        rows = np.arange(P, dtype=np.int64)
        base = row_ptr[rows] + info_counts
        col_idx[base[0]] = self.info_bits  # row 0: only its own parity col
        col_idx[base[1:]] = self.info_bits + rows[1:] - 1
        col_idx[base[1:] + 1] = self.info_bits + rows[1:]

        self.row_ptr = row_ptr
        self.col_idx = col_idx
        self.num_checks = P
        self.num_bits = self.codeword_bits
        self.num_edges_used = int(row_ptr[-1])

    def _build_random(self, cw: int):
        """ldpc.c:283-411.  Pass 1 (counts) and pass 2 (fill) draw
        identical streams from freshly seeded RNGs, so one draw serves
        both."""
        draws = Xoshiro128pp(self.cfg.seed & 0xFFFFFFFF).draw_u32(self.info_bits * cw)
        targets = (draws % np.uint32(self.parity_bits)).astype(np.int64)
        info_cols = np.repeat(np.arange(self.info_bits, dtype=np.int64), cw)
        self._place_info_edges(targets, info_cols)

    def _build_qc(self, cw: int):
        """ldpc.c:413-582: quasi-cyclic lifting; out-of-range rows are
        dropped (ldpc.c:480-483)."""
        lifting = self.cfg.lifting_factor
        if lifting == 0:
            lifting = min(max(self.parity_bits // 8, 4), 256)
            while lifting & (lifting - 1):
                lifting &= lifting - 1
        self.lifting_factor = lifting
        base_rows = (self.parity_bits + lifting - 1) // lifting
        rng = Xoshiro128pp(self.cfg.seed & 0xFFFFFFFF)
        draws = rng.draw_u32(self.info_bits * cw * 2).astype(np.int64)
        block_row = draws[0::2] % base_rows
        shift = draws[1::2] % lifting
        i_idx = np.repeat(np.arange(self.info_bits, dtype=np.int64), cw)
        row_in_block = (i_idx % lifting + shift) % lifting
        targets = block_row * lifting + row_in_block
        valid = targets < self.parity_bits
        self._place_info_edges(targets[valid], i_idx[valid])

    def _build_column_view(self):
        """CSC view in row-scan order (ldpc.c:373-408)."""
        row_counts = np.diff(self.row_ptr)
        erow = np.repeat(np.arange(self.num_checks, dtype=np.int64), row_counts)
        order = np.argsort(self.col_idx, kind="stable")
        col_counts = np.bincount(self.col_idx, minlength=self.num_bits)
        col_ptr = np.zeros(self.num_bits + 1, dtype=np.int64)
        np.cumsum(col_counts, out=col_ptr[1:])
        self.col_ptr = col_ptr
        self.cv_row_idx = erow[order]
        self.cv_edge_idx = order.astype(np.int64)
        self.erow = erow

    # ------------------------------------------------------ interleavers

    def _build_interleaver(self):
        """ldpc.c:150-234."""
        cfg = self.cfg
        if not cfg.use_inner_interleave:
            self.inner_forward = self.inner_inverse = None
            self.inner_interleave_gather = self.inner_deinterleave_gather = None
            return
        bits_n = self.codeword_bits
        depth = cfg.interleave_depth or min(max(bits_n // 4, 8), 256)
        width = (bits_n + depth - 1) // depth
        col_perm = np.arange(width, dtype=np.int64)
        rng = Xoshiro128pp((cfg.seed ^ bits_n) & 0xFFFFFFFF)
        for i in range(width - 1, 0, -1):
            j = rng.next_u32() % (i + 1)
            col_perm[i], col_perm[j] = col_perm[j], col_perm[i]

        i_arr = np.arange(bits_n, dtype=np.int64)
        row, col = i_arr // width, i_arr % width
        pos = col_perm[col] * depth + row
        fwd = np.where((row < depth) & (pos < bits_n), pos, i_arr)
        inv = np.zeros(bits_n, dtype=np.int64)
        inv[fwd] = i_arr              # ascending i, so the last write wins
        self.inner_forward = fwd
        self.inner_inverse = inv
        # Gather forms of the reference's scatter loops (interleave_bits /
        # deinterleave_bits, ldpc.c:88-120): out is zeroed first and writes
        # happen in ascending i (last wins), so out[j] = in[g[j]] with g the
        # last preimage, -1 -> 0.
        inter_g = np.full(bits_n, -1, dtype=np.int64)
        inter_g[fwd] = i_arr
        deinter_g = np.full(bits_n, -1, dtype=np.int64)
        deinter_g[inv] = i_arr
        self.inner_interleave_gather = inter_g
        self.inner_deinterleave_gather = deinter_g

    def _build_outer_interleaver(self):
        """ldpc.c:236-281: byte-level Fisher-Yates over the info bytes."""
        cfg = self.cfg
        if not cfg.use_outer_interleave:
            self.outer_forward = self.outer_inverse = None
            return
        n = self.info_bytes
        fwd = np.arange(n, dtype=np.int64)
        rng = Xoshiro128pp((cfg.seed ^ (self.info_bits ^ 0xDEADBEEF)) & 0xFFFFFFFF)
        for i in range(n - 1, 0, -1):
            j = rng.next_u32() % (i + 1)
            fwd[i], fwd[j] = fwd[j], fwd[i]
        inv = np.zeros(n, dtype=np.int64)
        inv[fwd] = np.arange(n, dtype=np.int64)
        self.outer_forward = fwd
        self.outer_inverse = inv

    # ---------------------------------------------- decoder layout prep

    def decoder_layout(self):
        """Padded dual layouts and gather index maps for the BP loop.

        Messages live slot-major: check-side planes [dc_b, P_b, B] per
        degree bucket, flattened back to back ([slot * P_b + c] within a
        bucket), and var-side tensors [dv, V+1, B].  Padding slots point
        at the fake variable V (check side) or at index c2v_size (var
        side).  H is the dense parity-check matrix with edge multiplicity
        folded mod 2, for codes with P * V <= 2^24."""
        P, V = self.num_checks, self.num_bits
        E = self.num_edges_used
        row_counts = np.diff(self.row_ptr)
        col_counts = np.diff(self.col_ptr)
        dc = int(row_counts.max())
        dv = int(col_counts.max())

        # edge -> (check, slot) in CSR order; edge -> (var, slot) in
        # column-view order
        e_c = self.erow
        e_s = np.arange(E, dtype=np.int64) - self.row_ptr[e_c]
        e_v = np.zeros(E, dtype=np.int64)
        e_t = np.zeros(E, dtype=np.int64)
        cv_pos = np.arange(E, dtype=np.int64)
        e_v[self.cv_edge_idx] = self.col_idx[self.cv_edge_idx]
        e_t[self.cv_edge_idx] = cv_pos - self.col_ptr[self.col_idx[self.cv_edge_idx]]

        buckets = _degree_buckets(row_counts)
        pos_in_bucket = np.zeros(P, dtype=np.int64)
        bucket_of = np.zeros(P, dtype=np.int64)
        offsets = np.zeros(len(buckets), dtype=np.int64)
        sizes = np.zeros(len(buckets), dtype=np.int64)
        off = 0
        for bi, b in enumerate(buckets):
            chk = b["checks"]
            pos_in_bucket[chk] = np.arange(len(chk), dtype=np.int64)
            bucket_of[chk] = bi
            offsets[bi] = off
            sizes[bi] = len(chk)
            off += b["dc"] * len(chk)
        c2v_size = off
        eb = bucket_of[e_c]
        e_flat = offsets[eb] + e_s * sizes[eb] + pos_in_bucket[e_c]

        check_gather = np.full(c2v_size, V, dtype=np.int64)  # slot 0 of the fake var
        check_gather[e_flat] = e_t * (V + 1) + e_v
        var_gather = np.full((dv, V + 1), c2v_size, dtype=np.int64)
        var_gather[e_t, e_v] = e_flat
        row2col = np.full(c2v_size, V, dtype=np.int64)
        row2col[e_flat] = self.col_idx

        # info-only row slots for the staircase encoder (CSR order puts a
        # row's info entries first)
        info_mask = self.col_idx < self.info_bits
        ic = self.erow[info_mask]
        icol = self.col_idx[info_mask]
        irank = np.arange(E, dtype=np.int64)[info_mask] - self.row_ptr[ic]
        dci = int(np.bincount(ic, minlength=P).max()) if len(ic) else 1
        row_info = np.full((dci, P), self.info_bits, dtype=np.int64)
        row_info[irank, ic] = icol

        H = None
        if P * V <= (1 << 24):
            # the reference XORs per edge, so parallel edges cancel
            Hcnt = np.zeros((P, V), dtype=np.int64)
            np.add.at(Hcnt, (e_c, self.col_idx), 1)
            H = (Hcnt & 1).astype(np.uint8)

        return dict(
            dc=dc, dv=dv, dci=dci,
            check_gather=check_gather, var_gather=var_gather,
            row2col=row2col, row_info=row_info, H=H,
            buckets=[dict(offset=int(offsets[bi]), P=int(sizes[bi]), dc=int(b["dc"]))
                     for bi, b in enumerate(buckets)],
            c2v_size=int(c2v_size),
        )


_STRUCT_CACHE = LruCache(capacity=16)


def get_structure(cfg: LdpcConfig) -> LdpcStructure:
    key = (cfg.block_size, int(cfg.rate), int(cfg.matrix_type), cfg.column_weight,
           cfg.use_inner_interleave, cfg.use_outer_interleave,
           cfg.interleave_depth, cfg.lifting_factor, cfg.seed)
    return _STRUCT_CACHE.get_or_build(key, lambda: LdpcStructure(cfg))


# =====================================================================
# Batched codec on one torch device
# =====================================================================

class LDPCCodec:
    """Batched LDPC encode and min-sum BP decode (hard and soft) on one
    torch device, the card by default."""

    # Adaptive cascade defaults, the JAX package's (tuned on a TPU).
    STAGE1_ITERS = 3
    STRAGGLER_SLOTS = 256
    # Codewords per plain-version BP loop.
    DECODE_CHUNK = 1024

    def __init__(self, cfg: LdpcConfig, device: str | torch.device = "cuda",
                 structure: LdpcStructure | None = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
        s = structure if structure is not None else get_structure(cfg)
        self.cfg = cfg
        self.device = device
        self.structure = s
        self.info_bits = s.info_bits
        self.parity_bits = s.parity_bits
        self.codeword_bits = s.codeword_bits
        self.info_bytes = s.info_bytes
        self.parity_bytes = s.parity_bytes
        self.codeword_bytes = s.codeword_bytes
        self.max_iterations = cfg.max_iterations or DEFAULT_MAX_ITERATIONS

        lay = s.decoder_layout()
        self.dv, self.dci = lay["dv"], lay["dci"]
        self.buckets = lay["buckets"]
        self.c2v_size = lay["c2v_size"]

        def idx(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, dtype=np.int64), device=device)

        self.check_gather_idx = idx(lay["check_gather"])
        vg = lay["var_gather"].reshape(-1)
        self.var_gather_idx = idx(np.minimum(vg, self.c2v_size - 1))
        self.var_gather_pad = torch.as_tensor((vg == self.c2v_size)[:, None], device=device)
        self.row2col_idx = idx(lay["row2col"])
        self.row_info = idx(lay["row_info"])
        self.H_info = None
        if lay["H"] is not None:
            self.H_info = torch.as_tensor(
                lay["H"][:, : self.info_bits].astype(np.float32), device=device)
        self.inter_g = idx(s.inner_interleave_gather)
        self.deinter_g = idx(s.inner_deinterleave_gather)
        self.outer_fwd = idx(s.outer_forward)
        self.outer_inv = idx(s.outer_inverse)

        if cfg.decode_chunk:
            self.DECODE_CHUNK = max(1, int(cfg.decode_chunk))
        if cfg.adaptive_stage1_iters:
            self.STAGE1_ITERS = int(cfg.adaptive_stage1_iters)
        if cfg.adaptive_straggler_slots:
            self.STRAGGLER_SLOTS = int(cfg.adaptive_straggler_slots)

        # The kernel's launcher: on a card, for structures the kernel supports.
        self.kernel = None
        if device.type == "cuda" and BPCudaKernel.supports(s):
            self.kernel = BPCudaKernel(s, device)

    @classmethod
    def from_arrays(cls, cfg: LdpcConfig, arrays: dict,
                    device: str | torch.device = "cuda") -> "LDPCCodec":
        """A codec whose structure is built from given arrays (ARRAY_NAMES),
        e.g. a JAX structure's, taken with np.asarray."""
        return cls(cfg, device, LdpcStructure.from_arrays(cfg, arrays))

    # ------------------------------------------------------- bit plumbing
    #
    # Bits and LLRs inside the BP loop are [V, B] (or [V+1, B]): the batch
    # on the trailing axis, so that every graph gather is a row gather.

    def _unpack_cw_T(self, codeword_bytes):
        """uint8 [B, bytes] -> bits [V, B] int8."""
        return bitutils.unpack(codeword_bytes, self.codeword_bits).T

    @staticmethod
    def _pack_cw_T(bits_T):
        """bits [V, B] -> uint8 [B, bytes]."""
        return bitutils.pack(bits_T.T)

    @staticmethod
    def _gather_rows(x_T, g):
        """out[j] = x_T[g[j]], and 0 where g[j] == -1."""
        out = x_T[g.clamp(min=0)]
        return torch.where((g >= 0)[:, None], out, torch.zeros_like(out))

    def interleave_bits_T(self, bits_T):
        """out[fwd[i]] = in[i] (ldpc.c:88-103), last write wins."""
        return bits_T if self.inter_g is None else self._gather_rows(bits_T, self.inter_g)

    def deinterleave_bits_T(self, bits_T):
        """out[inv[i]] = in[i] (ldpc.c:105-120); never-written entries are
        0, for bits and for LLRs alike (ROADMAP F2)."""
        return bits_T if self.deinter_g is None else self._gather_rows(bits_T, self.deinter_g)

    # ----------------------------------------------------------- encode

    def encode(self, info):
        """Raw LDPC encode (no interleaving; the facade layers that):
        info uint8 [B, info_bytes] (or 1-D) -> parity uint8 [B, parity_bytes]."""
        info = as_tensor(info, torch.uint8, self.device)
        squeeze = info.ndim == 1
        if squeeze:
            info = info[None]
        bits_T = bitutils.unpack(info, self.info_bits).T             # [I, B]
        B = bits_T.shape[1]
        if self.H_info is not None:
            s = (self.H_info @ bits_T.to(torch.float32)).to(torch.int32) & 1
        else:
            padded = torch.cat([bits_T.to(torch.int32),
                                torch.zeros(1, B, dtype=torch.int32, device=info.device)])
            g = padded[self.row_info.reshape(-1)].reshape(self.dci, self.parity_bits, B)
            s = g.sum(dim=0, dtype=torch.int32) & 1                   # [P, B] info sums
        parity = torch.cumsum(s, dim=0, dtype=torch.int32) & 1       # staircase prefix XOR
        out = self._pack_cw_T(parity)
        return out[0] if squeeze else out

    def check(self, codeword):
        """poporon_ldpc_check (ldpc.c:962-969): [B] all checks satisfied."""
        codeword = as_tensor(codeword, torch.uint8, self.device)
        squeeze = codeword.ndim == 1
        if squeeze:
            codeword = codeword[None]
        ok = self._syndrome_ok_p(self._with_fake_row(self._unpack_cw_T(codeword), 0))
        return ok[0] if squeeze else ok

    def interleave(self, codeword_bytes):
        cb = as_tensor(codeword_bytes, torch.uint8, self.device)
        return self._pack_cw_T(self.interleave_bits_T(self._unpack_cw_T(cb)))

    def deinterleave(self, codeword_bytes):
        cb = as_tensor(codeword_bytes, torch.uint8, self.device)
        return self._pack_cw_T(self.deinterleave_bits_T(self._unpack_cw_T(cb)))

    # ------------------------------------------------------ BP internals
    #
    # In-loop tensors carry one trailing fake variable (row V) whose
    # channel, total and v2c stay at +LLR_MAX and whose bit stays 0;
    # gather padding slots point at it, so the check-side planes need no
    # mask pass.

    @staticmethod
    def _with_fake_row(x_T, value):
        fake = torch.full((1, x_T.shape[1]), value, dtype=x_T.dtype, device=x_T.device)
        return torch.cat([x_T, fake])

    def _bucket_planes(self, flat, B):
        """Per degree bucket: (dc, flat[offset:...] as a [dc, P_b, B] view)."""
        for bk in self.buckets:
            dc, P = bk["dc"], bk["P"]
            yield dc, flat[bk["offset"]: bk["offset"] + dc * P].reshape(dc, P, B)

    def _syndrome_ok_p(self, bits_p8):
        """bits int8 [V+1, B] (fake row 0) -> [B] all checks satisfied
        (ldpc.c:635-653).  Every edge counts, so parallel edges cancel."""
        B = bits_p8.shape[1]
        g = bits_p8[self.row2col_idx]
        bad = torch.zeros(B, dtype=torch.bool, device=bits_p8.device)
        for _, gb in self._bucket_planes(g, B):
            bad |= (gb.sum(dim=0, dtype=torch.int16) & 1).any(dim=0)
        return ~bad

    def _check_update(self, v2c):
        """Normalized two-minimum min-sum (ldpc.c:693-738).

        v2c [dv * (V+1), B] int16 var-major (fake rows +LLR_MAX) ->
        c2v [c2v_size, B] int16 in bucketed check order.  The fold is a
        tournament over the slot planes, m2' = min(m2, max(m1, |v|)),
        m1' = min(m1, |v|): a repeated minimum drives m2 to m1, the
        reference's tie rule.  alpha = 15/16 is (m * 15) >> 4."""
        B = v2c.shape[1]
        outs = []
        for dc, gb in self._bucket_planes(v2c[self.check_gather_idx], B):
            gb = gb.to(torch.int32)
            a = gb.abs()
            neg = gb < 0
            m1 = a[0]
            m2 = torch.full_like(m1, LLR_MAX)
            par = neg[0]
            for s in range(1, dc):
                m2 = torch.minimum(m2, torch.maximum(m1, a[s]))
                m1 = torch.minimum(m1, a[s])
                par = par ^ neg[s]
            a1 = (m1 * 15) >> 4
            a2 = (m2 * 15) >> 4
            mag = torch.where(a == m1, a2, a1)
            out = torch.where(par ^ neg, -mag, mag)
            outs.append(out.reshape(-1, B).to(torch.int16))
        return torch.cat(outs)

    def _var_update(self, c2v_flat, channel):
        """ldpc.c:740-766.  c2v_flat [c2v_size, B] int16, channel [V+1, B]
        -> (llr [V+1, B] int16, v2c [dv * (V+1), B] int16).  The sums run
        in int32 and only the stored values saturate (ldpc.c:753-764)."""
        B = c2v_flat.shape[1]
        Vp = self.codeword_bits + 1
        h = c2v_flat[self.var_gather_idx].masked_fill(self.var_gather_pad, 0)
        h = h.reshape(self.dv, Vp, B).to(torch.int32)
        total = channel.to(torch.int32) + h.sum(dim=0, dtype=torch.int32)
        llr = total.clamp(LLR_MIN, LLR_MAX).to(torch.int16)
        v2c = (total[None] - h).clamp(LLR_MIN, LLR_MAX).to(torch.int16)
        return llr, v2c.reshape(self.dv * Vp, B)

    def _bp_loop(self, llr_init_p, channel_soft_p, bits_init_p, conv0, max_iterations):
        """The shared BP loop (var-major layout, V+1 rows).

        llr_init_p [V+1, B] int16: initial llr (fake row +LLR_MAX).
        channel_soft_p: None (hard: the channel is the previous llr,
        ldpc.c:746-751) or [V+1, B] int16 (soft: a constant channel).
        bits_init_p [V+1, B] int8: the output of pre-converged rows.
        conv0 [B] bool: pre-converged rows (the hard path's early exit).
        Returns (ok [B] bool, bits [V+1, B] int8, iters [B] int32).
        """
        Vp, B = llr_init_p.shape
        llr = llr_init_p.to(torch.int16)
        v2c = llr[None].expand(self.dv, Vp, B).reshape(self.dv * Vp, B)
        out_bits = last_bits = bits_init_p
        converged = conv0.clone()
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        it = 0
        while it < max_iterations and not bool(converged.all()):
            c2v = self._check_update(v2c)
            llr, v2c = self._var_update(c2v, llr if channel_soft_p is None else channel_soft_p)
            bits = (llr < 0).to(torch.int8)
            sat = self._syndrome_ok_p(bits)
            newly = sat & ~converged
            it += 1
            out_bits = torch.where(newly[None], bits, out_bits)
            last_bits = bits
            converged |= sat
            iters = torch.where(newly, it, iters)
        out = torch.where(converged[None], out_bits, last_bits)
        iters = torch.where(converged, iters, max_iterations)
        iters = torch.where(conv0, 0, iters).to(torch.int32)
        return converged, out, iters

    def _bp_plain(self, llr_init_p, channel_soft_p, max_iterations):
        """`_bp_loop` with the initial bits and the pre-converged mask
        derived as the kernel's `bp` entry derives them: in hard mode from
        the signs of llr_init_p, in soft mode none."""
        llr = llr_init_p.to(torch.int16)
        B = llr.shape[1]
        if channel_soft_p is None:
            bits0 = (llr < 0).to(torch.int8)
            conv0 = self._syndrome_ok_p(bits0)
        else:
            bits0 = torch.zeros_like(llr, dtype=torch.int8)
            conv0 = torch.zeros(B, dtype=torch.bool, device=llr.device)
            channel_soft_p = channel_soft_p.to(torch.int16)
        return self._bp_loop(llr, channel_soft_p, bits0, conv0, max_iterations)

    # ------------------------------------------------------------ decode

    def _decode_hard_body(self, codeword_bytes, max_iterations):
        """codeword uint8 [B, bytes] -> (ok, packed output, iters)."""
        work = self.deinterleave_bits_T(self._unpack_cw_T(codeword_bytes))   # [V, B]
        bits_p8 = self._with_fake_row(work, 0)
        conv0 = self._syndrome_ok_p(bits_p8)
        llr0 = torch.where(work == 1, -LLR_INFINITY, LLR_INFINITY).to(torch.int16)
        # the fake row sits at exactly LLR_MAX: it pads the check update's
        # min folds, where any real |v2c| can reach LLR_MAX
        llr0_p = self._with_fake_row(llr0, LLR_MAX)
        ok, out, iters = self._bp_loop(llr0_p, None, bits_p8, conv0, max_iterations)
        return ok, self._pack_cw_T(out[: self.codeword_bits]), iters

    def _decode_soft_body(self, llr8, max_iterations):
        """llr8 int8 [B, V] channel LLRs -> (ok, packed output, iters).
        The deinterleave zero-fills the positions it never writes, where
        the C leaves garbage (ROADMAP F2)."""
        work = self.deinterleave_bits_T(llr8.to(torch.int32).T)             # [V, B]
        work_p = self._with_fake_row(work, 125)       # 125 * LLR_SCALE == LLR_MAX
        channel = (work_p * LLR_SCALE).to(torch.int16)                     # |x| <= 32768
        llr0 = (work_p * LLR_SCALE).clamp(LLR_MIN, LLR_MAX).to(torch.int16)
        bits0 = torch.zeros_like(work_p, dtype=torch.int8)
        conv0 = torch.zeros(work.shape[1], dtype=torch.bool, device=work.device)
        ok, out, iters = self._bp_loop(llr0, channel, bits0, conv0, max_iterations)
        return ok, self._pack_cw_T(out[: self.codeword_bits]), iters

    def _plain(self, kind, inputs, max_iterations):
        """The plain version of a full-budget decode: the decode body over
        DECODE_CHUNK-wide slices, so that each slice's loop stops at its
        own last converging row and the working set stays bounded."""
        body = self._decode_hard_body if kind == "hard" else self._decode_soft_body
        if inputs.shape[0] <= self.DECODE_CHUNK:
            return body(inputs, max_iterations)
        parts = [body(x, max_iterations) for x in inputs.split(self.DECODE_CHUNK)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def _decode(self, kind, inputs, max_iterations):
        """Full-budget decode of every row: through the kernel where the
        codec has one, else the plain version."""
        if self.kernel is None:
            return self._plain(kind, inputs, max_iterations)
        if kind == "hard":
            return self.kernel.bp_packed_hard(inputs, max_iterations)
        return self.kernel.bp_llr8_soft(inputs, max_iterations)

    # ------------------------------------------------ adaptive cascade
    #
    # BP trajectories are per-row deterministic and independent of the
    # rest of the batch, so a batch decode can run a short first stage
    # (where most codewords converge) and re-decode only the stragglers
    # with the full budget.  Results (outputs and iterations) are
    # bit-identical to one full-budget call.

    def cascade(self, body, inputs, max_iterations):
        """Stage 1 at STAGE1_ITERS, then full-budget passes over up to
        STRAGGLER_SLOTS not-yet-done rows each (the lowest indices first,
        as lax.top_k over the not-done mask picks them) until every row is
        done.  body(inputs, max_iterations) -> (ok, packed, iters) is a
        full-budget decode: the plain version or the kernel."""
        s1 = min(self.STAGE1_ITERS, max_iterations)
        ok, cw, it = body(inputs, s1)
        if s1 >= max_iterations:
            return ok, cw, it
        done = ok.clone()
        while not bool(done.all()):
            sel = torch.nonzero(~done).squeeze(1)[: self.STRAGGLER_SLOTS]
            ok2, cw2, it2 = body(inputs[sel], max_iterations)
            ok[sel], cw[sel], it[sel] = ok2, cw2, it2
            done[sel] = True
        return ok, cw, it

    def _decode_adaptive(self, kind, inputs, max_iterations):
        """With the kernel, one full-budget launch: the kernel stops each
        codeword at its own convergence, so the cascade would only add
        stage-1 trips and host syncs.  Otherwise the cascade over the
        plain version."""
        if self.kernel is not None:
            return self._decode(kind, inputs, max_iterations)
        return self.cascade(lambda x, mi: self._decode(kind, x, mi), inputs, max_iterations)

    def _batched(self, fn, kind, x, dtype, max_iterations):
        with span("poporon.codec.decode"):
            x = as_tensor(x, dtype, self.device)
            squeeze = x.ndim == 1
            if squeeze:
                x = x[None]
            ok, cw, iters = fn(kind, x, max_iterations or self.max_iterations)
            return (ok[0], cw[0], iters[0]) if squeeze else (ok, cw, iters)

    def decode_hard(self, codeword, max_iterations: int = 0):
        """codeword uint8 [B, codeword_bytes] (or 1-D) -> (ok, codeword_out,
        iters), as poporon_ldpc_decode_hard (ldpc.c:971-1025): the returned
        codeword is the deinterleaved working word, best effort when ok is
        False."""
        return self._batched(self._decode, "hard", codeword, torch.uint8, max_iterations)

    def decode_soft(self, llr, max_iterations: int = 0):
        """llr int8 [B, codeword_bits] (or 1-D) -> (ok, codeword_out, iters)."""
        return self._batched(self._decode, "soft", llr, torch.int8, max_iterations)

    def decode_hard_adaptive(self, codeword, max_iterations: int = 0):
        """decode_hard through the adaptive cascade (bit-identical)."""
        return self._batched(self._decode_adaptive, "hard", codeword, torch.uint8,
                             max_iterations)

    def decode_soft_adaptive(self, llr, max_iterations: int = 0):
        """decode_soft through the adaptive cascade (bit-identical)."""
        return self._batched(self._decode_adaptive, "soft", llr, torch.int8,
                             max_iterations)
