"""Plain LDPC encode and min-sum decode, soft and hard, the benchmark's
yardstick for the LDPC cells.

Everything is worked out here from the configuration, as the C library
does it: the Xoshiro128++ stream seeded through SplitMix32 (rng.c:27-132),
the random parity-check matrix with a staircase parity part
(ldpc.c:283-411), the inner bit interleaver (ldpc.c:150-234) and the
outer byte interleaver (ldpc.c:236-281), the staircase encode, and the
normalised two-minimum min-sum of ldpc.c:693-766 with int16 messages
(alpha = 15/16, sums in int32 saturating when stored, LLRs scaled by 256,
the channel deinterleave zero-filling the positions it never writes).
The decode is written edge by edge and stops each codeword at its own
convergence, dropping converged codewords from the working set; a
codeword's trajectory does not depend on the rest of its batch, so its
verdict, output and iteration count are those of the port's plain loop.

`max_iterations` below the configuration's budget is the control that
breaks the configuration's guarantee: `control` cuts it to
STAGE1_ITERATIONS = 3, the first stage of the port's adaptive cascade,
with its stragglers never decoded again (at about 1e-2 channel BER a
few frames in ten thousand need more).
"""

from __future__ import annotations

import numpy as np
import torch

LLR_MAX = 32000
LLR_INFINITY = 30000
LLR_SCALE = 256
STAGE1_ITERATIONS = 3
RATES = {"RATE_1_3": (1, 2), "RATE_1_2": (1, 1), "RATE_2_3": (2, 1),
         "RATE_3_4": (3, 1), "RATE_4_5": (4, 1), "RATE_5_6": (5, 1)}
_M32 = 0xFFFFFFFF


def _splitmix32(z: int) -> int:
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return (z ^ (z >> 16)) & _M32


class Xoshiro128pp:
    def __init__(self, seed: int):
        s0 = _splitmix32((seed + 0x6C078965) & _M32)
        s1 = _splitmix32((s0 + 0x9D2C5680) & _M32)
        s2 = _splitmix32((s1 + 0xEFC60000) & _M32)
        s3 = _splitmix32((s2 + 0x12345678) & _M32)
        self.s = [s0, s1, s2, s3]

    def next_u32(self) -> int:
        s0, s1, s2, s3 = self.s
        x = (s0 + s3) & _M32
        result = ((((x << 7) | (x >> 25)) & _M32) + s0) & _M32
        t = (s1 << 9) & _M32
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        self.s = [s0, s1, s2, ((s3 << 11) | (s3 >> 21)) & _M32]
        return result


def _fisher_yates(n: int, rng: Xoshiro128pp) -> np.ndarray:
    perm = np.arange(n, dtype=np.int64)
    for i in range(n - 1, 0, -1):
        j = rng.next_u32() % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


def pack(bits: torch.Tensor) -> torch.Tensor:
    """0/1 [B, nbits] -> uint8 [B, nbits / 8], MSB first."""
    b = bits.reshape(bits.shape[0], -1, 8).to(torch.int32)
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * w).sum(dim=-1).to(torch.uint8)


def unpack(data: torch.Tensor) -> torch.Tensor:
    """uint8 [B, n] -> int32 bits [B, 8n], MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=data.device)
    return ((data.to(torch.int32)[..., None] >> shifts) & 1).reshape(data.shape[0], -1)


class LdpcReference:
    """Plain LDPC of one configuration on one torch device.  cfg: the
    configuration file's keys."""

    def __init__(self, cfg: dict, device="cpu", max_iterations: int | None = None):
        self.device = dev = torch.device(device)
        info_num, parity_num = RATES[cfg["rate"]]
        if cfg["matrix_type"] != "RANDOM":
            raise ValueError("the reference builds the RANDOM matrix only")
        I = self.info_bits = int(cfg["block_size"]) * 8
        P = self.parity_bits = I * parity_num // info_num
        V = self.codeword_bits = I + P
        if P % 8:
            raise ValueError("the reference needs whole parity bytes")
        self.info_bytes, self.parity_bytes = I // 8, P // 8
        self.max_iterations = max_iterations or int(cfg["max_iterations"]) or 50
        self.soft = bool(cfg["use_soft_decode"])
        seed = int(cfg["seed"])
        cw = min(max(int(cfg["column_weight"]), 3), 8)

        # H: column weight cw on the info bits, drawn in one stream, then the
        # staircase; CSR with each row's info edges in draw order.
        rng = Xoshiro128pp(seed & _M32)
        targets = np.array([rng.next_u32() % P for _ in range(I * cw)], dtype=np.int64)
        info_cols = np.repeat(np.arange(I, dtype=np.int64), cw)
        order = np.argsort(targets, kind="stable")
        rows = [list(info_cols[order][targets[order] == r]) for r in range(P)]
        for r in range(P):
            rows[r] += [I] if r == 0 else [I + r - 1, I + r]
        self.E = sum(len(r) for r in rows)
        dc = max(len(r) for r in rows)
        # check r's slots as edge ids (E = padding) and the edges' variables
        slots = np.full((P, dc), self.E, dtype=np.int64)
        e_var = np.zeros(self.E, dtype=np.int64)
        e = 0
        for r, cols in enumerate(rows):
            slots[r, : len(cols)] = np.arange(e, e + len(cols))
            e_var[e: e + len(cols)] = cols
            e += len(cols)
        h = np.zeros((P, I), dtype=np.int64)
        for r, cols in enumerate(rows):
            for c in cols:
                if c < I:
                    h[r, c] ^= 1                      # parallel edges cancel
        self.slots = torch.tensor(slots, device=dev)
        self.e_var = torch.tensor(e_var, device=dev)
        self.slot_var = torch.tensor(np.append(e_var, V)[slots], device=dev)
        self.H_info = torch.tensor(h, dtype=torch.float32, device=dev)

        self.inter_g = self.deinter_g = None
        if cfg["use_inner_interleave"]:
            depth = int(cfg["interleave_depth"]) or min(max(V // 4, 8), 256)
            width = -(-V // depth)
            col_perm = _fisher_yates(width, Xoshiro128pp((seed ^ V) & _M32))
            i = np.arange(V, dtype=np.int64)
            row, col = i // width, i % width
            pos = col_perm[col] * depth + row
            fwd = np.where((row < depth) & (pos < V), pos, i)
            inv = np.zeros(V, dtype=np.int64)
            inv[fwd] = i
            inter_g = np.full(V, -1, dtype=np.int64)
            inter_g[fwd] = i
            deinter_g = np.full(V, -1, dtype=np.int64)
            deinter_g[inv] = i
            self.inter_g = torch.tensor(inter_g, device=dev)
            self.deinter_g = torch.tensor(deinter_g, device=dev)
        self.outer_fwd = self.outer_inv = None
        if cfg["use_outer_interleave"]:
            n = self.info_bytes
            fwd = _fisher_yates(n, Xoshiro128pp((seed ^ (I ^ 0xDEADBEEF)) & _M32))
            inv = np.zeros(n, dtype=np.int64)
            inv[fwd] = np.arange(n)
            self.outer_fwd = torch.tensor(fwd, device=dev)
            self.outer_inv = torch.tensor(inv, device=dev)

    @staticmethod
    def _gather(x, g):
        """out[:, j] = x[:, g[j]], 0 where g[j] == -1 (the C's scatter
        into a zeroed buffer, last write winning)."""
        return torch.where(g >= 0, x[:, g.clamp(min=0)], torch.zeros_like(x[:, :1]))

    # ------------------------------------------------------------ encode

    def encode(self, info: torch.Tensor):
        """The facade's encode of uint8 [B, info_bytes]: outer interleave,
        staircase parity, inner interleave.  Returns (data, parity), the
        transmitted words."""
        data = info if self.outer_inv is None else info[:, self.outer_inv]
        s = (unpack(data).float() @ self.H_info.T).to(torch.int32) & 1
        parity = pack(torch.cumsum(s, dim=1) & 1)
        if self.inter_g is None:
            return data, parity
        cw = pack(self._gather(unpack(torch.cat([data, parity], dim=1)), self.inter_g))
        return cw[:, : self.info_bytes], cw[:, self.info_bytes:]

    # ------------------------------------------------------------ decode

    def _syndrome_ok(self, bits):
        """bits [n, V] -> [n] every check even (every edge counts)."""
        padded = torch.cat([bits, torch.zeros_like(bits[:, :1])], dim=1)
        return ~(padded[:, self.slot_var].sum(dim=2) & 1).bool().any(dim=1)

    def _bp(self, channel, llr0, hard: bool):
        """Min-sum over rows channel [B, V] (int32, the channel term) and
        llr0 (its saturated copy): (ok, bits [B, V], iters).  Soft, the
        channel stays the scaled LLRs; hard, it is the previous iteration's
        saturated LLRs (ldpc.c:746-751), and rows whose hard bits already
        meet every check are done before the first iteration, with 0
        iterations and their bits as they came."""
        B, V = channel.shape
        dev = channel.device
        ok = torch.zeros(B, dtype=torch.bool, device=dev)
        iters = torch.full((B,), self.max_iterations, dtype=torch.int32, device=dev)
        out = torch.zeros(B, V, dtype=torch.int32, device=dev)
        live = torch.arange(B, device=dev)
        if hard:
            bits0 = (llr0 < 0).to(torch.int32)
            sat0 = self._syndrome_ok(bits0)
            ok[sat0], out[sat0], iters[sat0] = True, bits0[sat0], 0
            live, channel, llr0 = live[~sat0], channel[~sat0], llr0[~sat0]
        v2c = llr0[:, self.e_var]
        pad = torch.full((B, 1), LLR_MAX, dtype=torch.int32, device=dev)
        for it in range(1, self.max_iterations + 1):
            if len(live) == 0:
                break
            g = torch.cat([v2c, pad[: len(live)]], dim=1)[:, self.slots]    # [n, P, dc]
            a = g.abs()
            neg = g < 0
            two = a.topk(2, dim=2, largest=False).values
            m1, m2 = two[..., :1], two[..., 1:]
            mag = torch.where(a == m1, (m2 * 15) >> 4, (m1 * 15) >> 4)
            sign = neg ^ (neg.sum(dim=2, keepdim=True) & 1).bool()
            c2v_slots = torch.where(sign, -mag, mag)
            c2v = torch.zeros(len(live), self.E + 1, dtype=torch.int32, device=dev)
            c2v.scatter_(1, self.slots.reshape(1, -1).expand(len(live), -1),
                         c2v_slots.reshape(len(live), -1))
            c2v = c2v[:, : self.E]
            total = channel.index_add(1, self.e_var, c2v)
            llr = total.clamp(-LLR_MAX, LLR_MAX)
            bits = (llr < 0).to(torch.int32)
            v2c = (total[:, self.e_var] - c2v).clamp(-LLR_MAX, LLR_MAX)
            sat = self._syndrome_ok(bits)
            done = sat | (it == self.max_iterations)
            rows = live[done]
            out[rows] = bits[done]
            ok[rows] = sat[done]
            iters[live[sat]] = it
            live, v2c = live[~done], v2c[~done]
            channel = (llr if hard else channel)[~done]
        return ok, out, iters

    def decode(self, data, parity, soft_llr=None):
        """The facade's decode: (ok, data, parity, iterations) of uint8
        data [B, info_bytes] and parity [B, parity_bytes], soft from int8
        LLRs [B, V] (negative = 1) where the configuration decodes soft and
        they are given, else hard from data and parity (the C's fallback,
        decode.c:509-514)."""
        if self.soft and soft_llr is not None:
            work = soft_llr.to(torch.int32)
            if self.deinter_g is not None:
                work = self._gather(work, self.deinter_g)
            channel = work * LLR_SCALE
            llr0 = channel.clamp(-LLR_MAX, LLR_MAX)
        else:
            work = unpack(torch.cat([data, parity], dim=1))
            if self.deinter_g is not None:
                work = self._gather(work, self.deinter_g)
            channel = llr0 = torch.where(work == 1, -LLR_INFINITY, LLR_INFINITY).to(torch.int32)
        ok, bits, iters = self._bp(channel, llr0, hard=soft_llr is None or not self.soft)
        info = pack(bits)[:, : self.info_bytes]
        if self.outer_fwd is not None:
            info = info[:, self.outer_fwd]
        return ok, torch.where(ok[:, None], info, data), parity, iters


Reference = LdpcReference


def control(cfg: dict, device="cpu") -> LdpcReference:
    """The reference with the iteration budget cut to STAGE1_ITERATIONS."""
    return LdpcReference(cfg, device, max_iterations=STAGE1_ITERATIONS)
