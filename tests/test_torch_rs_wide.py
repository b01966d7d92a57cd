"""RS codes whose symbols are wider than a byte: RS(544,514) over GF(2^10),
the KP4 FEC of 100G-per-lane Ethernet, and a shorter code of that field.

The port's encode and decode (device cpu, the plain version) hold 16-bit
symbols and equal the benchmark's plain reference for such codes
(fecbench/reference/rs_wide.py: Horner syndromes, BM, Chien, Forney and
the verify on log tables, independent of the port's bit matrices) in ok,
data, parity and corrected, on rows with 0 to t + 3 errors.  At m = 8 the
reference equals the RS cells' reference (fecbench/reference/rs.py) row
for row, and the port's plain decode given 16-bit symbols equals its byte
path and the JAX package's XLA path.  No symbol is ever cut to a byte:
out-of-range inputs, the erasure and external-syndrome decodes,
`reconstruct`, the C-shaped shim and streaming refuse m > 8 with
ValueError.  The m = 10 kernels' host data and loops are emulated in
NumPy here: the syndrome kernel's ten-bit division by the factors of g(x)
(remainders packed at ten bits a coefficient, T_f[top] as the XOR of two
half tables' entries, read from one lane's copies as a block lays them
out) with its tail on log tables, from `wide_syndrome_tables`, against
the plain syndromes at every F from 1 to 4; the half tables against
top (h_f - x^16); the lane copies' loads against the shared memory's
banks; and the decode kernel's sweep over the shortened word's
locations, chunk by chunk, against the plain Chien over every point.  The
card holds the kernels to the plain version (chip_smoke.py phase 16).

JAX is imported only by the test that compares with it.
"""

import re

import numpy as np
import pytest
import torch

import libpoporon_tpu_torch as pt
from fecbench.reference import rs as rs_ref
from fecbench.reference import rs_wide
from libpoporon_tpu_torch.compat import _CompatConfig, _Handle, poporon_create, \
    poporon_rs_config_create
from libpoporon_tpu_torch.models.rs_cuda import FACTOR_ROOTS, RSCudaDecoder, gf_tables, \
    wide_syndrome_tables
from libpoporon_tpu_torch.ops.gf import GF
from libpoporon_tpu_torch.utils import build
from libpoporon_tpu_torch.stream import StreamCodec
from libpoporon_tpu_torch.utils.tensors import symbol_dtype

torch.set_num_threads(2)

KP4 = pt.RSConfig(10, 0x409, 0, 1, 30)


def ref_config(cfg: pt.RSConfig, size: int) -> dict:
    return {"symbol_size": cfg.symbol_size, "generator_polynomial": cfg.generator_polynomial,
            "first_consecutive_root": cfg.first_consecutive_root,
            "primitive_element": cfg.primitive_element, "num_roots": cfg.num_roots,
            "data_symbols": size}


def hurt(word: torch.Tensor, nerr: np.ndarray, fs: int, seed: int) -> torch.Tensor:
    """word with nerr[r] symbol errors in row r, at distinct positions,
    each a random nonzero XOR."""
    rng = np.random.default_rng(seed)
    out = word.clone()
    for r in range(word.shape[0]):
        pos = rng.choice(word.shape[1], int(nerr[r]), replace=False)
        out[r, pos] ^= torch.from_numpy(rng.integers(1, fs + 1, len(pos))).to(word.dtype)
    return out


@pytest.mark.parametrize("cfg,size", [(KP4, 514), (KP4, 200), (pt.RSConfig(10, 0x409, 1, 7, 16), 400)],
                         ids=["kp4", "kp4_shorter", "fcr1_prim7_nr16"])
def test_port_equals_reference_at_m10(cfg, size):
    codec = pt.create(cfg, device="cpu")
    ref = rs_wide.Reference(ref_config(cfg, size))
    t = cfg.num_roots // 2
    rng = np.random.default_rng(size)
    info = torch.from_numpy(rng.integers(0, 1024, (4 * (t + 4), size))).to(torch.int16)
    enc = codec.encode(info)
    assert codec.symbol_dtype == enc.parity.dtype == torch.int16
    assert torch.equal(enc.parity, ref.encode(info)[1])
    nerr = np.arange(info.shape[0]) % (t + 4)                  # 0 .. t + 3 errors a row
    word = hurt(torch.cat([info, enc.parity], dim=1), nerr, 1023, size + 1)
    d, p = word[:, :size], word[:, size:]
    want = ref.decode(d, p)
    got = codec.decode(d, p)
    for g, w, name in zip(got, want, ("ok", "data", "parity", "corrected")):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    ok = want[0].numpy()
    assert ok[nerr <= t].all() and not ok[nerr > t].any()
    assert torch.equal(want[1][nerr <= t], info[nerr <= t])


@pytest.mark.parametrize("size", [223, 100])
def test_wide_dtype_path_at_m8_equals_byte_path_and_jax(size):
    """At m = 8 the plain decode given 16-bit symbols equals the byte path,
    which equals the JAX package's XLA path; the facade keeps bytes."""
    pytest.importorskip("jax")
    from libpoporon_tpu.config import RSConfig as JaxRSConfig
    from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec

    codec = pt.create(pt.RSConfig(), device="cpu")
    assert codec.symbol_dtype == torch.uint8
    rng = np.random.default_rng(size)
    info = rng.integers(0, 256, (96, size), dtype=np.uint8)
    parity = codec.encode(info.astype(np.int64)).parity        # wider ints, values in range
    assert parity.dtype == torch.uint8
    word = hurt(torch.cat([torch.from_numpy(info), parity], dim=1),
                np.arange(96) % 20, 255, size)
    d, p = word[:, :size], word[:, size:]
    byte = codec.decode(d, p)
    wide = codec._rs._decode_plain(d.to(torch.int16), p.to(torch.int16))
    jax = JaxRSCodec(JaxRSConfig(use_pallas="off"))._decode_plain(d.numpy(), p.numpy())
    for b, w, j in zip(byte, wide, jax):
        assert torch.equal(b, w) and np.array_equal(b.numpy(), np.asarray(j))
    assert byte.data.dtype == torch.uint8


@pytest.mark.parametrize("fcr,prim,nr,size", [(1, 1, 32, 223), (0, 1, 16, 150), (112, 11, 8, 247)])
def test_reference_at_m8_equals_rs_reference(fcr, prim, nr, size):
    cfg = {"symbol_size": 8, "generator_polynomial": 0x11D if prim != 11 else 0x187,
           "first_consecutive_root": fcr, "primitive_element": prim, "num_roots": nr}
    a, b = rs_ref.Reference(cfg), rs_wide.Reference(cfg)
    rng = np.random.default_rng(nr)
    info = torch.from_numpy(rng.integers(0, 256, (300, size), dtype=np.uint8))
    (da, pa), (db, pb) = a.encode(info), b.encode(info)
    assert torch.equal(pa, pb)
    word = hurt(torch.cat([da, pa], dim=1), np.arange(300) % (nr // 2 + 6), 255, size)
    want, got = a.decode(word[:, :size], word[:, size:]), b.decode(word[:, :size], word[:, size:])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert not bool(want[0].all())


def test_0x409_is_primitive():
    gf = GF(10, 0x409)                                 # x^10 + x^3 + 1
    assert gf.primitive and gf.field_size == 1023
    assert sorted(gf.log2exp[:1023].tolist()) == list(range(1, 1024))


@pytest.mark.parametrize("m,dtype", [(4, torch.uint8), (8, torch.uint8), (9, torch.int16),
                                     (10, torch.int16)])
def test_symbol_dtype_follows_m(m, dtype):
    poly = {4: 0x13, 8: 0x11D, 9: 0x211, 10: 0x409}[m]
    assert pt.create(pt.RSConfig(m, poly, 0, 1, 4), device="cpu").symbol_dtype == dtype
    assert symbol_dtype(m) == dtype and symbol_dtype(16) == torch.int16


def test_other_codes_keep_bytes():
    assert pt.create(pt.bch_config_default(), device="cpu").symbol_dtype == torch.uint8
    ldpc = pt.create(pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2), device="cpu")
    assert ldpc.symbol_dtype == torch.uint8


@pytest.mark.parametrize("bad", [np.full((2, 514), 1024, dtype=np.int32),
                                 np.full((2, 514), -1, dtype=np.int64),
                                 np.full((2, 514), 3.0)],
                         ids=["past_m_bits", "negative", "float"])
def test_wide_symbols_out_of_range_raise(bad):
    codec = pt.create(KP4, device="cpu")
    with pytest.raises(ValueError, match="symbols of 10 bits"):
        codec.encode(bad)
    with pytest.raises(ValueError, match="symbols of 10 bits"):
        codec.decode(torch.from_numpy(bad), np.zeros((2, 30), np.int16))


def test_wide_symbols_in_range_from_other_dtypes():
    codec = pt.create(KP4, device="cpu")
    info = np.random.default_rng(0).integers(0, 1024, (3, 514))
    want = codec.encode(torch.from_numpy(info).to(torch.int16)).parity
    assert torch.equal(codec.encode(info).parity, want)                     # int64 array
    assert torch.equal(codec.encode(torch.from_numpy(info).int()).parity, want)
    small = info % 256
    assert torch.equal(codec.encode(small.astype(np.uint8)).parity,
                       codec.encode(torch.from_numpy(small).to(torch.int16)).parity)


@pytest.mark.parametrize("call,what", [
    (lambda c, d, p: c.decode(d, p, erasures=[1, 2]), "an erasure decode"),
    (lambda c, d, p: c.decode(d, p, ext_syndrome=np.full(30, 1023, np.int32)),
     "an external-syndrome decode"),
    (lambda c, d, p: c.reconstruct(torch.cat([d, p], dim=1).t(), [0]), "reconstruct"),
], ids=["erasures", "ext_syndrome", "reconstruct"])
def test_wide_refuses_what_takes_bytes(call, what):
    codec = pt.create(KP4, device="cpu")
    d = torch.zeros(2, 514, dtype=torch.int16)
    p = codec.encode(d).parity
    with pytest.raises(ValueError, match=f"{what} takes symbols of at most 8 bits"):
        call(codec, d, p)


def test_shim_and_stream_refuse_wide_symbols():
    cfg = poporon_rs_config_create(10, 0x409, 0, 1, 30)
    assert poporon_create(cfg, device="cpu") is None
    with pytest.raises(ValueError, match="symbol_size 10"):
        _Handle(_CompatConfig(KP4), "cpu")
    with pytest.raises(ValueError, match="StreamCodec frames bytes"):
        StreamCodec(pt.create(KP4, device="cpu"))
    assert poporon_create(poporon_rs_config_create(8, 0x11D, 1, 1, 32), device="cpu") is not None


@pytest.mark.parametrize("m,poly,admitted", [(8, 0x11D, True), (10, 0x409, True),
                                             (9, 0x211, False), (12, 0x1053, False)])
def test_kernel_gate_admits_m8_and_m10(m, poly, admitted):
    rs = pt.create(pt.RSConfig(m, poly, 0, 1, 30 if admitted else 4), device="cpu")._rs
    assert RSCudaDecoder.supports(rs) == admitted
    assert gf_tables(rs).shape == (4, 1 << m)


# ------------------------------------------- the m = 10 kernels, emulated

M10 = 10
WORDS = 5                                    # words of a packed remainder or table entry


def kernel_load_words() -> int:
    """rs_decode.cu's `kWideLoadWords`: the words of a lane's table load."""
    src = (build.CSRC_DIR / "rs_decode.cu").read_text()
    found = re.findall(r"^constexpr int kWideLoadWords = (\d+);", src, flags=re.M)
    assert len(found) == 1, found
    return int(found[0])


def lane_copies(halves: np.ndarray, load_words: int) -> np.ndarray:
    """The half tables [F, 2, 32, 5] expanded into lane copies as a block of
    rs_syndrome_wide_kernel expands them in shared memory: word i of the
    copies, i over [F, 2][loads][32 entries][32 / load_words copies]
    [load_words], entries padded to whole loads with zeros."""
    loads = -(-WORDS // load_words)
    half_words = loads * 1024
    i = np.arange(halves.shape[0] * 2 * half_words)
    h, r = i // half_words, i % half_words
    e = r % 1024 // 32
    w = r // 1024 * load_words + r % load_words
    flat = halves.reshape(-1, 32, WORDS)
    return np.where(w < WORDS, flat[h, e, np.minimum(w, WORDS - 1)], 0).astype(np.uint32)


def entry_reads(half: int, entry: int, lane: int, load_words: int) -> list[int]:
    """The word addresses lane `lane` reads for entry `entry` of half table
    `half` (2 f for A_f, 2 f + 1 for B_f), load by load."""
    loads = -(-WORDS // load_words)
    base = half * loads * 1024 + entry * 32 + lane % (32 // load_words) * load_words
    return [base + 1024 * l + k for l in range(loads) for k in range(load_words)]


def packed_coefficient(words, c: int) -> int:
    """Coefficient c of a packed remainder or table entry: bits 10 c .. 10 c + 9."""
    return (sum(int(x) << (32 * q) for q, x in enumerate(words)) >> (M10 * c)) & 1023


def emulate_wide_syndromes(blob: np.ndarray, nr: int, word: np.ndarray, lane: int) -> list[int]:
    """rs_syndrome_wide_kernel's division and tail for one row of symbols, as
    lane `lane` runs them: remainders packed at ten bits in five words, the
    lane's copies of the half tables as the block expands them."""
    factors = -(-nr // FACTOR_ROOTS)
    load_words = kernel_load_words()
    halves = blob[: factors * 2 * 32 * WORDS * 4].view(np.uint32).reshape(factors, 2, 32, WORDS)
    s_t = lane_copies(halves, load_words)
    u16 = blob[halves.nbytes:].view(np.uint16)
    alog3, log16 = u16[:3072], u16[3072:4096]
    expo = u16[4096:4096 + nr * 16].reshape(nr, 16)
    R = [[0] * WORDS for _ in range(factors)]
    for v in word:
        v = int(v) & 1023
        for f in range(factors):
            top = R[f][4] >> 22                                      # bits 150..159
            R[f] = [((R[f][q] << M10) | (R[f][q - 1] >> (32 - M10) if q else v)) & 0xFFFFFFFF
                    for q in range(WORDS)]                           # funnel shifts up ten bits
            a = s_t[entry_reads(2 * f, top >> 5, lane, load_words)]
            b = s_t[entry_reads(2 * f + 1, top & 31, lane, load_words)]
            R[f] = [r ^ int(x) ^ int(y) for r, x, y in zip(R[f], a, b)]
    out = []
    for f in range(factors):
        lr = [int(log16[packed_coefficient(R[f], b)]) for b in range(16)]
        for j in range(min(16, nr - 16 * f)):
            acc = 0
            for b in range(16):
                acc ^= int(alog3[lr[b] + int(expo[16 * f + j, b])])
            out.append(int(log16[acc]) if acc else 1023)
    return out


@pytest.mark.parametrize("cfg,size", [(KP4, 514), (pt.RSConfig(10, 0x409, 3, 7, 64), 300),
                                      (pt.RSConfig(10, 0x409, 1, 1, 17), 100),
                                      (pt.RSConfig(10, 0x409, 0, 1, 14), 514),
                                      (pt.RSConfig(10, 0x409, 0, 2, 33), 900)],
                         ids=["kp4", "nr64_prim7", "nr17", "nr14_kr4", "nr33_prim2"])
def test_wide_syndrome_division_equals_plain(cfg, size):
    codec = pt.create(cfg, device="cpu")
    rs = codec._rs
    tables = gf_tables(rs)
    blob = wide_syndrome_tables(tables[0], tables[1], rs.num_roots, rs.fcr, rs.prim)
    factors = -(-rs.num_roots // 16)
    assert blob.nbytes == factors * 2 * 32 * WORDS * 4 + 4 * 1024 * 2 + rs.num_roots * 16 * 2
    rng = np.random.default_rng(rs.num_roots)
    info = torch.from_numpy(rng.integers(0, 1024, (6, size))).to(torch.int16)
    word = hurt(torch.cat([info, codec.encode(info).parity], dim=1),
                np.array([0, 1, 3, 15, 16, 40]), 1023, 7)
    word[5, 0] |= -32768                          # a bit past m, which the kernel drops
    want = rs.exp2log[rs._syndrome(word[:, :size], word[:, size:]).long()]
    for r in range(word.shape[0]):
        lane = (13 * r + 5) % 32
        assert emulate_wide_syndromes(blob, rs.num_roots, word[r].numpy(), lane) == want[r].tolist()


@pytest.mark.parametrize("cfg", [KP4, pt.RSConfig(10, 0x409, 3, 7, 64)], ids=["kp4", "nr64_prim7"])
def test_wide_half_tables_sum_to_t(cfg):
    """A_f[top >> 5] ^ B_f[top & 31] = top (h_f - x^16) for every top and
    factor, h_f built here from the roots with the field's own product."""
    rs = pt.create(cfg, device="cpu")._rs
    gf, nr = rs.gf, rs.num_roots
    tables = gf_tables(rs)
    blob = wide_syndrome_tables(tables[0], tables[1], nr, rs.fcr, rs.prim)
    factors = -(-nr // 16)
    halves = blob[: factors * 2 * 32 * WORDS * 4].view(np.uint32).reshape(factors, 2, 32, WORDS)
    for f in range(factors):
        roots = [int(rs.log2exp[((rs.fcr + i) * rs.prim) % rs.fs]) for i in range(16 * f, min(nr, 16 * f + 16))]
        h = [0] * (16 - len(roots)) + [1]                    # x^(16 - r_f), ascending powers
        for b in roots:                                      # h *= x + b
            h = [x ^ gf.mul(b, y) for x, y in zip([0] + h, h + [0])]
        assert len(h) == 17 and h[16] == 1
        for top in range(1024):
            got = [int(x) ^ int(y) for x, y in zip(halves[f, 0, top >> 5], halves[f, 1, top & 31])]
            assert [packed_coefficient(got, c) for c in range(16)] == [gf.mul(top, c) for c in h[:16]]


@pytest.mark.parametrize("load_words", [1, 2])
def test_wide_lane_copies_free_of_bank_conflicts(load_words):
    """Whatever the 32 lanes' entries, each of a warp's table loads is served
    in as few wavefronts as its bytes need: one for 32-bit loads, each lane
    in its own bank; two for 64-bit loads, a half-warp's 16 lanes over all
    32 banks.  And each lane's reads give the entry's five words."""
    rng = np.random.default_rng(load_words)
    halves = rng.integers(0, 1 << 32, (2, 2, 32, WORDS), dtype=np.uint64).astype(np.uint32)
    s_t = lane_copies(halves, load_words)
    for trial in range(64):
        half = trial % 4
        entries = rng.integers(0, 32, 32)
        reads = np.array([entry_reads(half, int(e), lane, load_words)
                          for lane, e in enumerate(entries)])           # [lane, word]
        for lane, e in enumerate(entries):
            assert s_t[reads[lane]][:WORDS].tolist() == halves.reshape(-1, 32, WORDS)[half, e].tolist()
        for load in range(reads.shape[1] // load_words):
            first = reads[:, load * load_words]
            for group in np.split(np.arange(32), 32 // (32 // load_words)):
                banks = np.concatenate([(first[group] + k) % 32 for k in range(load_words)])
                assert len(set(banks.tolist())) == len(banks)


def sweep_schedule(steps: int) -> list[tuple[int, int]]:
    """(chunk steps, first step) as the wide chien_sweep takes them."""
    out, s0 = [], 0
    while s0 + 8 <= steps:
        out.append((8, s0))
        s0 += 8
    for c in (4, 2, 1):
        if (steps - s0) & c:
            out.append((c, s0))
            s0 += c
    return out


def mod_fs(x: int, fs: int = 1023) -> int:
    while x > 2 * fs:
        x = (x >> 10) + (x & fs)
    return x - fs if x >= fs else x


def emulate_wide_sweep(log, alog, el, deg, n, prim, fs=1023):
    """The wide chien_sweep and finish_row's step 5 for one locator: the
    roots (point, location) in the order the owner records them."""
    pad = fs - n
    roots = []
    for c, s0 in sweep_schedule((n + 31) >> 5):
        k0 = pad + 32 * s0
        ev = np.zeros((32, c), dtype=np.int64)
        for lane in range(32):
            i0 = mod_fs((k0 + lane + 1) * prim)
            for j in range(1, deg + 1):
                if el[j] == 0:
                    continue
                step, e = mod_fs(32 * prim * j), mod_fs(int(log[el[j]]) + j * i0)
                for s in range(c):
                    ev[lane, s] ^= alog[e]
                    e += step
                    e -= fs if e >= fs else 0
        for s in range(c):
            for lane in range(32):
                k = k0 + lane + 32 * s
                if ev[lane, s] == 1 and k < fs:
                    i = mod_fs((k + 1) * prim)
                    roots.append((fs if i == 0 else i, k))
    return roots


@pytest.mark.parametrize("prim,n", [(1, 544), (1, 1023), (7, 300), (2, 33)],
                         ids=["kp4", "unshortened", "prim7", "n33"])
def test_wide_sweep_equals_plain_chien(prim, n):
    """Locators with roots inside the word, in the pad, and with fewer roots
    than their degree: where the plain Chien finds all deg roots and none in
    the pad, the sweep finds the same (point, location) set; elsewhere it
    finds fewer than deg, so the row fails as it does there."""
    nr = 16
    cfg = pt.RSConfig(10, 0x409, 0, prim, nr)
    rs = pt.create(cfg, device="cpu")._rs
    fs, pad = rs.fs, rs.fs - n
    log, alog = rs.exp2log.numpy().astype(np.int64), rs.log2exp.numpy().astype(np.int64)
    rng = np.random.default_rng(prim * 1000 + n)
    locators = []
    for trial in range(24):
        deg = 1 + trial % 8
        if trial % 3 == 2:                       # random: roots anywhere, or fewer than deg
            el = [1] + rng.integers(0, 1024, deg).tolist()
            el[deg] = el[deg] or 1
        else:                                    # deg roots at chosen locations
            lo = 0 if trial % 3 == 1 else pad    # some in the pad where trial % 3 == 1
            locs = rng.choice(np.arange(lo, fs), deg, replace=False)
            el = [1]
            for k in locs:                        # el *= (1 + X x), X = alpha^-(i), i the point of k
                i = ((int(k) + 1) * prim) % fs
                x = int(alog[(fs - i) % fs])
                el = [a ^ (rs.gf.mul(x, b) if b else 0) for a, b in zip(el + [0], [0] + el)]
        locators.append(el + [0] * (nr + 1 - len(el)))
    el = torch.tensor(locators, dtype=torch.int32)
    lane = torch.arange(nr + 1)
    deg = torch.where(el != 0, lane, 0).amax(dim=1)
    terms = rs._eval_at_all_points(el[:, 1:], rs.M_chien)
    i_vals = np.arange(1, fs + 1)
    k_vals = (i_vals * rs.prim_inv - 1) % fs
    for r in range(len(locators)):
        mask = terms[r].numpy() == 1
        sel = i_vals[mask][: int(deg[r])]
        plain_ok = len(sel) == deg[r] and not (k_vals[sel - 1] < pad).any()
        got = emulate_wide_sweep(log, alog, locators[r], int(deg[r]), n, prim)
        if plain_ok:
            assert sorted(got) == sorted((int(i), int(k_vals[i - 1])) for i in sel)
        else:
            assert len(got) != deg[r]
