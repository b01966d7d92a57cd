"""The RS decode kernel's Berlekamp-Massey against the JAX package.

`decode_row` in libpoporon_tpu_torch/csrc/rs_decode.cu bounds BM by the
tracked degrees of the locator and of the b polynomial: the discrepancy
runs over j <= min(deg el, it - 1), a zero discrepancy skips the update,
the update covers only the slots the b polynomial reaches, and b is kept
unshifted with a shift count.  Here a NumPy emulation of the kernel's
steps 1 to 3, written step for step as the kernel does them (its GF
tables, its erasure-locator product, its 8-bit wraps of pd, it + ec and
the erasure count), must give the JAX package's fixed-trip locator,
`RSCodec._bm_planes` fed as `_correct` feeds it (bit planes from
`gfbit.pack_planes`, erasure starts from `_erasure_locator`), slot for
slot, and so must the port's plain version (`_berlekamp_massey`).  Inside
the emulation every slot above the tracked degrees is asserted zero on
every trip.

Inputs, from a numpy seed, about 256 rows a case, over the five configs
chip_smoke.py holds the kernel to on the card: rows with 0..t symbol
errors, with t+1..t+3, random rows, erasure counts 1, 7 (with 3 extra
errors, the F1 input), nr/2 and nr with extra errors around the
capacity, and counts of 256 and more, where the 8-bit erasure count
wraps (the JAX entry takes them: its count planes keep the low 8 bits,
and its locator multiplies in every given position).  The kernel skips
BM for rows whose syndromes are all zero; the emulation runs it on every
row, where it leaves the start locator as it is.  Tolerance: exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402
from libpoporon_tpu.ops import gfbit  # noqa: E402

from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import RSCodec  # noqa: E402
from libpoporon_tpu_torch.models.rs_cuda import gf_tables  # noqa: E402

torch.set_num_threads(2)

ROWS = 256
FS = 255
CONFIGS = {
    "default": {},
    "fcr0": {"first_consecutive_root": 0},
    "prim2": {"primitive_element": 2},
    "nr16": {"num_roots": 16},
    "nr64": {"num_roots": 64},
}
KINDS = ("within", "beyond", "random", "erasure", "wrap")
_CODECS = {}


def _codecs(name):
    """(port, JAX) codecs per config, built once per module."""
    if name not in _CODECS:
        kw = CONFIGS[name]
        _CODECS[name] = (RSCodec(RSConfig(**kw), "cpu"),
                         JaxRSCodec(JaxRSConfig(use_pallas="off", **kw)))
    return _CODECS[name]


class KernelGF:
    """galois::Tables<8> on the kernel's [4, 256] tables (log, antilog, sec, inv)."""

    def __init__(self, tables: np.ndarray):
        self.log, self.antilog, _, self.inv = (list(map(int, t)) for t in tables)

    def mul(self, a, b):
        if a == 0 or b == 0:
            return 0
        s = self.log[a] + self.log[b]
        if s >= FS:
            s -= FS
        return self.antilog[s]


def emulate_start(gf, nr, pad, prim, pos, cnt):
    """Step 2 for one row given nr positions: the start locator (1, or the
    erasure-locator product of the first min(cnt, nr)) and ec = cnt & 0xFF."""
    el = [1] + [0] * nr
    if pos is None:
        return el, 0

    def term(q):
        raw = (prim * ((FS - 1 - pad) - q)) & 0xFFFFFFFF
        return gf.antilog[(raw & 0xFFFF) % FS]

    if cnt > 0:
        el[1] = term(int(pos[0]))
    for i in range(1, min(nr, cnt)):
        t = term(int(pos[i]))
        for j in range(min(i + 1, nr), 0, -1):
            el[j] ^= gf.mul(t, el[j - 1])
    return el, cnt & 0xFF


def emulate_bm(gf, nr, S, el, ec, erasure):
    """Step 3 for one row, as the kernel runs it: the locator [nr + 1]."""
    el = list(el)
    bp = [0] * (nr + 1)   # the kernel's array holds stale slots above dbp

    def check():
        assert not any(el[del_ + 1:]), "el nonzero above its tracked degree"
        assert not any(bp[dbp + 1:]), "bp nonzero above its tracked degree"

    del_ = 0
    for j in range(1, nr + 1):
        if el[j]:
            del_ = j
    for j in range(del_ + 1):
        bp[j] = el[j]
    dbp, s, pd = del_, 0, ec
    check()
    for it in range(1, nr + 1):
        if erasure and it <= ec:
            continue
        disc = 0
        for j in range(min(del_, it - 1) + 1):
            disc ^= gf.mul(el[j], S[it - 1 - j])
        if disc == 0:
            s += 1
            check()
            continue
        it_ec = (it + ec) & 0xFF
        grow = ((2 * pd) & 0xFF) <= ((it_ec - 1) & 0xFF)
        top = min(s + dbp + 1, nr)
        hi = top
        if grow:
            hi = max(del_, top)
            dinv = gf.inv[disc]
            for j in range(hi, -1, -1):
                e = el[j]
                if s < j <= top:
                    el[j] = e ^ gf.mul(disc, bp[j - 1 - s])
                bp[j] = gf.mul(e, dinv)
            dbp, s = del_, 0
            pd = (it_ec - pd) & 0xFF
        else:
            for j in range(top, s, -1):
                el[j] ^= gf.mul(disc, bp[j - 1 - s])
            s += 1
        del_ = max(del_, hi)
        while del_ > 0 and el[del_] == 0:
            del_ -= 1
        check()
    return el


def _flip(rng, word, nerr):
    """word with nerr[i] distinct symbols of row i XORed with nonzero
    values."""
    word = word.copy()
    for i in range(word.shape[0]):
        q = rng.choice(word.shape[1], int(nerr[i]), replace=False)
        word[i, q] ^= rng.integers(1, 256, len(q)).astype(np.uint8)
    return word


def _case(name, kind):
    """(data, parity, eras_pos or None, eras_count or None) of a case."""
    rs, _ = _codecs(name)
    nr, t = rs.num_roots, rs.num_roots // 2
    rng = np.random.default_rng([KINDS.index(kind), list(CONFIGS).index(name)])
    size = rs.k if kind in ("within", "beyond", "random") else rs.k - 5
    data = rng.integers(0, 256, (ROWS, size), dtype=np.uint8)
    word = np.concatenate([data, rs.encode(data).numpy()], axis=1)
    pos = cnt = None
    if kind == "within":
        word = _flip(rng, word, rng.integers(0, t + 1, ROWS))
    elif kind == "beyond":
        word = _flip(rng, word, rng.integers(t + 1, t + 4, ROWS))
    elif kind == "random":
        word = rng.integers(0, 256, word.shape, dtype=np.uint8)
    else:
        if kind == "erasure":
            # (count, extra errors): 1, the F1 input, nr/2 and nr, each
            # with extra errors at, below and past what the code corrects
            plan = [(1, (nr - 1) // 2), (1, (nr - 1) // 2 + 1), (7, 3),
                    (nr // 2, nr // 4 - 1), (nr // 2, nr // 4), (nr // 2, nr // 4 + 1),
                    (nr, 0), (nr, 1)]
        else:
            # counts past 255: every position multiplies in, ec wraps
            plan = [(256, 0), (256, 2), (257, 0), (257, 3), (256 + nr // 2, 0),
                    (256 + nr // 2, nr // 4 + 1), (256 + nr - 1, 0), (511, 1)]
        cnt = np.array([c for c, _ in plan] * (ROWS // len(plan)), np.int32)
        extra = np.array([x for _, x in plan] * (ROWS // len(plan)))
        pos = np.zeros((ROWS, nr), np.int32)
        for i in range(ROWS):
            q = rng.choice(size, min(int(cnt[i]), nr) + int(extra[i]), replace=False)
            pos[i, : min(int(cnt[i]), nr)] = q[: min(int(cnt[i]), nr)]
            word[i, q] ^= rng.integers(1, 256, len(q)).astype(np.uint8)
    return word[:, :size], word[:, size:], pos, cnt


def jax_locator(jax_rs, s_norm, eras_pos, eras_count, pad):
    """The JAX package's BM locator [B, nr + 1], fed as `_correct` feeds it."""
    nr, m = jax_rs.num_roots, jax_rs.m
    B = s_norm.shape[0]
    s_cm = gfbit.pack_planes(jnp.asarray(s_norm).T, m)
    if eras_pos is None:
        W = s_cm.shape[-1]
        el0_cm = (jnp.broadcast_to(s_cm[:1] & gfbit.U32(0), (nr + 1, m, W))
                  .at[0, 0].set(gfbit.U32(0xFFFFFFFF)))
        eras_count = jnp.zeros(B, jnp.int32)
    else:
        el0 = jax_rs._erasure_locator(jnp.asarray(eras_pos), jnp.asarray(eras_count), pad)
        el0_cm = gfbit.pack_planes(el0.T, m)
        eras_count = jnp.asarray(eras_count)
    el_cm = jax_rs._bm_planes(s_cm, el0_cm, eras_count, eras_pos is None)
    el0 = None if eras_pos is None else np.asarray(el0)
    return np.asarray(gfbit.unpack_planes(el_cm, B).T), el0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_emulated_kernel_bm_matches_jax_locator(name, kind):
    rs, jax_rs = _codecs(name)
    data, parity, pos, cnt = _case(name, kind)
    nr, size = rs.num_roots, data.shape[1]
    pad = FS - nr - size
    s_norm = np.array(jax_rs._syndrome(data, parity))
    want, want_start = jax_locator(jax_rs, s_norm, pos, cnt, pad)
    assert want.shape == (ROWS, nr + 1)

    gf = KernelGF(gf_tables(rs))
    # step 1: the kernel reads log-form syndromes (fs = zero)
    s_log = rs.exp2log[torch.as_tensor(s_norm).long()].numpy()
    got = np.zeros_like(want)
    for i in range(ROWS):
        S = [gf.antilog[v] if 0 <= v <= FS else 0 for v in map(int, s_log[i])]
        el, ec = emulate_start(gf, nr, pad, rs.prim, None if pos is None else pos[i],
                               0 if cnt is None else int(cnt[i]))
        if want_start is not None:
            assert el == list(want_start[i]), f"row {i}: start locator != JAX"
        got[i] = emulate_bm(gf, nr, S, el, ec, pos is not None)
    assert np.array_equal(got, want)

    # the port's plain version of the fixed loop gives the same locator
    s_t = torch.as_tensor(s_norm.astype(np.int32))
    if pos is None:
        el0 = torch.zeros(ROWS, nr + 1, dtype=torch.int32)
        el0[:, 0] = 1
        plain = rs._berlekamp_massey(s_t, el0, None)
    else:
        cnt_t = torch.as_tensor(cnt)
        plain = rs._berlekamp_massey(s_t, rs._erasure_locator(torch.as_tensor(pos), cnt_t, pad),
                                     cnt_t)
    assert np.array_equal(plain.numpy(), want)
    if kind in ("beyond", "random", "wrap"):
        # rows that ran BM long: locators of degree t or more
        deg = np.where(want != 0, np.arange(nr + 1), 0).max(axis=1)
        assert (deg >= nr // 2).any()
