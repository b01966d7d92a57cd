"""Shortened BCH: NAND flash's software BCH-8 on 512-byte sectors, Linux's
`nand-ecc-algo "bch"` with step 512 and strength 8 (lib/bch.c: m = 13,
p(x) = 0x201b, t = 8, 104 parity bits), BCH(8191, 8087) shortened to
4,200 bits, and a small shortened code of GF(2^7).

The port's plain version (device cpu) equals the benchmark's plain
reference (fecbench/reference/bch.py: LFSR encode, syndromes summed over
set bits, Berlekamp's binary algorithm, Chien over the word's positions,
on log tables alone) in ok, data, parity and corrected on rows with 0 to
t + 1 bit errors, errors in the parity alone, a locator root in the
shortened code's pad (the row fails), and batches of 1 and 33 rows.
`data_length` 0 is the full length, as before.  The facade reads 512 and
13 bytes.  The CUDA kernel's host data (`bch_tables`) and its steps are
emulated in NumPy here, lane by lane where lanes matter: the division a
byte a step, the nibble tables' odd syndromes, Berlekamp-Massey on the
kernel form's lanes (the odd trips, whose discrepancy is zero, only
shifting), the roots of a locator of degree 1, 2 or 3 solved directly
(the quadratic and the cubic through their tables), the warp's Chien
sweep with its early stop past that, the verify and the flips, against
the plain version at every kernel form (t = 4, 8, 16).  The card holds
the kernel to the plain version (chip_smoke.py phase 17)."""

import numpy as np
import pytest
import torch

import chip_smoke
import libpoporon_tpu_torch as pt
from fecbench.reference import bch as bch_ref
from libpoporon_tpu_torch.models.bch import BCHCodec, _remainders, host_arrays
from libpoporon_tpu_torch.models.bch_cuda import NO_ROOT, BCHCudaDecoder, bch_tables, \
    kernel_lanes, kernel_words
from libpoporon_tpu_torch.ops.gf import GFError

torch.set_num_threads(2)

NAND = (13, 0x201B, 8, 4096)            # m, p(x), t, data bits
SMALL = (7, 0x89, 3, 64)                # BCH(127, 106) shortened to 85 bits


def ref_cfg(params) -> dict:
    m, poly, t, k = params
    return {"symbol_size": m, "generator_polynomial": poly, "correction_capability": t,
            "data_length": k}


@pytest.fixture(scope="module")
def codes():
    """(facade codec, reference) by code, built once."""
    out = {}
    for name, params in (("nand", NAND), ("small", SMALL)):
        m, poly, t, k = params
        out[name] = (pt.create(pt.BchConfig(m, poly, t, data_length=k), device="cpu"),
                     bch_ref.BCHReference(ref_cfg(params), "cpu"))
    return out


def flip_bits(c: BCHCodec, data, parity, positions):
    """data and parity uint8 with the word's bits `positions[r]` flipped in
    row r (bit p < parity_bits the parity's bit p, else data bit p -
    parity_bits)."""
    data, parity = data.clone(), parity.clone()
    for r, ps in enumerate(positions):
        for p in ps:
            if p < c.parity_bits:
                parity[r, c.parity_bytes - 1 - p // 8] ^= 1 << (p % 8)
            else:
                q = p - c.parity_bits
                data[r, c.data_bytes - 1 - q // 8] ^= 1 << (q % 8)
    return data, parity


def codewords(codec, ref, B, seed):
    g = torch.Generator().manual_seed(seed)
    info = torch.randint(0, 256, (B, ref.info_bytes), generator=g, dtype=torch.uint8)
    data, parity = ref.encode(info)
    assert torch.equal(codec.encode(info).parity, parity)
    return data, parity


def assert_same(got, want):
    for a, b, name in zip(got, want, ("ok", "data", "parity", "corrected")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:4].tolist())


CASES = ("0_to_t", "t_plus_1", "parity_only", "pad_root", "one_row", "33_rows")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("code", ["nand", "small"])
def test_plain_version_equals_reference(codes, code, case):
    codec, ref = codes[code]
    c = codec._bch
    B = {"one_row": 1, "33_rows": 33}.get(case, 48)
    data, parity = codewords(codec, ref, B, seed=len(case) * 7 + c.m)
    rng = np.random.default_rng(B + c.t)
    if case == "pad_root":
        data, parity = chip_smoke.bch_pad_rows(c, data, parity, seed=c.m)
    else:
        counts = np.full(B, c.t + 1) if case == "t_plus_1" else np.arange(B) % (c.t + 1)
        span = c.parity_bits if case == "parity_only" else c.n
        data, parity = flip_bits(c, data, parity,
                                 [rng.choice(span, int(k), replace=False) for k in counts])
    got = codec.decode(data, parity)
    want = ref.decode(data, parity)
    assert_same(got, want)
    if case in ("0_to_t", "parity_only", "one_row", "33_rows"):
        assert bool(got.ok.all())
    if case == "pad_root":
        assert not bool(got.ok.any())
    if case == "t_plus_1":
        assert not bool(got.ok.all())
    lne = codec.last_num_errors
    assert torch.equal(lne, torch.where(got.ok, got.corrected, -1)) and lne.dtype == torch.int32


def test_sizes_of_the_sector_code(codes):
    codec, ref = codes["nand"]
    c = codec._bch
    assert (codec.info_size, codec.parity_size) == (512, 13)
    assert (c.n, c.parity_bits, c.data_length, c.gen_poly) == (
        4200, 104, 4096, 0x115F914E07B0C138741C5C4FB23)
    assert ref.gen == c.gen_poly and (ref.info_bytes, ref.parity_bytes) == (512, 13)


def test_full_length_is_the_default():
    """data_length 0 and the full length given explicitly build the same
    codec as before: sizes, every host array and the decodes."""
    m, poly, t = 6, 0x43, 2
    zero = BCHCodec(pt.BchConfig(m, poly, t), "cpu")
    full = BCHCodec(pt.BchConfig(m, poly, t, data_length=zero.data_length), "cpu")
    assert (zero.n, zero.data_length, zero.data_bytes) == (63, 51, 7)
    a, b = host_arrays(pt.BchConfig(m, poly, t)), host_arrays(
        pt.BchConfig(m, poly, t, data_length=51))
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    rng = np.random.default_rng(6)
    rx = rng.integers(0, 2, (40, 63)).astype(np.int32)
    for x, y in zip(zero.decode_bits(rx), full.decode_bits(rx)):
        assert torch.equal(x, y)


def test_shortened_arrays_are_the_full_ones_cut():
    m, poly, t, k = SMALL
    full = host_arrays(pt.BchConfig(m, poly, t))
    short = host_arrays(pt.BchConfig(m, poly, t, data_length=k))
    n = short["G_syn"].shape[0]
    assert np.array_equal(short["R_enc"], full["R_enc"][:k])
    assert np.array_equal(short["G_syn"], full["G_syn"][:n])
    assert np.array_equal(short["M_chien"], full["M_chien"][:, : n * m])


def _poly_mod(a: int, g: int) -> int:
    dg = g.bit_length() - 1
    while a.bit_length() - 1 >= dg:
        a ^= g << (a.bit_length() - 1 - dg)
    return a


def test_remainders_equal_long_division():
    """Each row of R_enc equals the scalar long division of its basis word
    (the encoder's remainder, bch.c:352-380)."""
    gen = 0x115F914E07B0C138741C5C4FB23
    deg = gen.bit_length() - 1
    R = _remainders(gen, 300)
    for i in (0, 1, 7, 8, 103, 104, 299):
        rem = _poly_mod(1 << (deg + i), gen)
        assert [int(b) for b in R[i]] == [(rem >> j) & 1 for j in range(deg)]


def test_config_checks():
    with pytest.raises(GFError, match="exceeds the full length"):
        BCHCodec(pt.BchConfig(13, 0x201B, 8, data_length=8088), "cpu")
    with pytest.raises(GFError, match="data_length"):
        BCHCodec(pt.BchConfig(13, 0x201B, 8, data_length=-8), "cpu")
    codec = pt.create(pt.BchConfig(13, 0x201B, 8, data_length=4096), device="cpu")
    with pytest.raises(ValueError, match="too short"):
        codec.decode(np.zeros((2, 511), np.uint8), np.zeros((2, 13), np.uint8))
    fresh = pt.create(pt.BchConfig(13, 0x201B, 8, data_length=4096), device="cpu")
    with pytest.raises(AttributeError):
        fresh.last_num_errors


@pytest.mark.parametrize("params,admitted", [
    ((13, 0x201B, 8, 4096), True), ((13, 0x201B, 4, 4096), True),
    ((13, 0x201B, 16, 4096), True), ((14, 0x402B, 16, 8192), True),
    ((7, 0x89, 3, 64), True), ((4, 0x13, 3, 0), False), ((13, 0x201B, 8, 0), False),
    ((13, 0x201B, 8, 4092), False), ((15, 0x8003, 8, 4096), False), ((4, 0x13, 1, 8), False)])
def test_kernel_gate(params, admitted):
    m, poly, t, k = params
    assert BCHCudaDecoder.supports(BCHCodec(pt.BchConfig(m, poly, t, data_length=k), "cpu")) \
        == admitted


class RecordingLauncher:
    """Stands in for a codec's kernel launcher on the CPU: keeps what it
    is handed and returns the rows as clean."""

    def __init__(self):
        self.calls = []

    def decode(self, data, parity):
        self.calls.append((data, parity))
        B = data.shape[0]
        return torch.ones(B, dtype=torch.bool), data, torch.zeros(B, dtype=torch.int32)


def test_kernel_codec_never_runs_the_plain_version(codes):
    """A codec that holds the kernel hands it rows of data_bytes and the
    first parity_bytes of a wider parity, the bytes the plain version
    reads, and raises ValueError on any other width: it never runs the
    plain version."""
    plain = codes["nand"][0]._bch
    g = torch.Generator().manual_seed(25)
    data = torch.randint(0, 256, (3, 512), generator=g, dtype=torch.uint8)
    parity = torch.randint(0, 256, (3, 15), generator=g, dtype=torch.uint8)
    for a, b in zip(plain.decode_bytes(data, parity), plain.decode_bytes(data, parity[:, :13])):
        assert torch.equal(a, b)

    c = BCHCodec(pt.BchConfig(*NAND[:3], data_length=NAND[3]), "cpu")
    c.kernel = RecordingLauncher()

    def no_plain(*args):
        raise AssertionError("the plain version ran on a codec with the kernel")

    c.decode_bytes_plain = no_plain
    c.decode_bytes(data, parity[:, :13])
    c.decode_bytes(data, parity)
    assert len(c.kernel.calls) == 2
    for d, p in c.kernel.calls:
        assert torch.equal(d, data) and torch.equal(p, parity[:, :13])
    wider = torch.zeros(3, 513, dtype=torch.uint8)
    for d, p in ((data[:, :511], parity), (wider, parity), (data, parity[:, :12])):
        with pytest.raises(ValueError, match="on the kernel"):
            c.decode_bytes(d, p)
    assert len(c.kernel.calls) == 2


# ------------------------------------------------- the kernel, emulated

def _pad16(x: int) -> int:
    return (x + 15) & ~15


def chien_sweep(alog: np.ndarray, lc: list, n: int, fs: int) -> list:
    """A warp's sweep of the locator whose coefficients 1..D have the logs
    lc (fs for zero): lane l at positions l, l + 32, .., each step's roots
    in lane order, stopped once D are found."""
    lanes = np.arange(32)
    e = [np.full(32, fs) if x == fs else (x - ((j + 1) * lanes) % fs) % fs
         for j, x in enumerate(lc)]
    step = [0 if x == fs else (32 * (j + 1)) % fs for j, x in enumerate(lc)]
    roots = []
    for base in range(0, n, 32):
        val = np.zeros(32, np.int64)
        for ej in e:
            val ^= alog[ej]
        hit = (val == 1) & (base + lanes < n)
        roots += [base + int(lane) for lane in np.nonzero(hit)[0]][: len(lc) - len(roots)]
        if len(roots) >= len(lc):
            break
        e = [(ej - sj) % fs for ej, sj in zip(e, step)]
    return roots


def emulate_kernel(image: np.ndarray, c: BCHCodec, data: np.ndarray, parity: np.ndarray):
    """csrc/bch_decode.cu's steps on the table image, row by row: (ok,
    data, corrected) as NumPy arrays."""
    m, t, pb, nb = c.m, c.t, c.parity_bits, c.data_bytes
    fs, n = (1 << m) - 1, pb + 8 * nb
    W, TMAX = kernel_words(t), kernel_lanes(t)
    sh = 32 * W - pb
    q0 = sh // 4
    nq = 8 * W - q0
    nib_at = 256 * W * 4
    log_at = nib_at + _pad16(t * nq * 32)
    alog_at = log_at + (1 << m) * 2
    quad_at = alog_at + _pad16((1 << m) * 2)
    cubic_at = quad_at + _pad16((1 << m) * 2)
    assert image.size == cubic_at + (1 << m) * 8
    quad = image[quad_at: quad_at + (1 << m) * 2].view(np.uint16).astype(np.int64)
    cubic = image[cubic_at:].view(np.uint16).reshape(1 << m, 4).astype(np.int64)
    div = image[:nib_at].view(np.uint32).reshape(256, W)
    nib = image[nib_at: nib_at + t * nq * 32].view(np.uint16).reshape(t, nq, 16)
    log = image[log_at: alog_at].view(np.uint16).astype(np.int64)
    alog = image[alog_at: alog_at + (1 << m) * 2].view(np.uint16).astype(np.int64)
    T = [sum(int(div[u, k]) << (32 * k) for k in range(W)) for u in range(256)]
    mask = (1 << (32 * W)) - 1
    B = data.shape[0]
    ok = np.zeros(B, bool)
    out = data.copy()
    corrected = np.zeros(B, np.int32)

    def mod(x):
        return x % fs

    def mul(x, y):
        return 0 if x == 0 or y == 0 else int(alog[mod(int(log[x]) + int(log[y]))])

    for r in range(B):
        R = 0
        for v in data[r]:
            top = (R >> (32 * W - 8)) ^ int(v)
            R = ((R << 8) & mask) ^ T[top]
        P = int.from_bytes(bytes(parity[r]), "big") & ((1 << pb) - 1)
        R ^= P << sh
        if R == 0:
            ok[r] = True
            continue
        syn = [0] * t
        ls = [fs] * (2 * TMAX)
        for i in range(t):
            acc = 0
            for q in range(q0, 8 * W):
                acc ^= int(nib[i, q - q0, (R >> (4 * q)) & 15])
            syn[i] = acc
            ls[2 * i] = int(log[acc])
        for k in range(1, 2 * TMAX, 2):
            h = ls[(k - 1) // 2]
            ls[k] = fs if h == fs else mod(2 * h)
        cc = [1] + [0] * TMAX
        bl = [fs, 0] + [fs] * (TMAX - 1)
        length, pd_log, fail = 0, 0, False
        for it in range(2 * t):
            if it % 2:                      # a zero discrepancy: b shifts
                bl = [fs] + bl[:TMAX]
                continue
            lc = [0] + [int(log[cc[j]]) if j <= length else fs for j in range(1, TMAX + 1)]
            disc = 0 if ls[it] == fs else int(alog[ls[it]])
            for j in range(1, min(it, TMAX) + 1):
                if lc[j] != fs and ls[it - j] != fs:
                    disc ^= int(alog[mod(lc[j] + ls[it - j])])
            if disc:
                dl = int(log[disc])
                mult = mod(dl - pd_log)
                grow = 2 * length <= it
                if grow and it + 1 - length > t:
                    fail = True
                    break
                for j in range(1, TMAX + 1):
                    if bl[j] != fs:
                        cc[j] ^= int(alog[mod(bl[j] + mult)])
                if grow:
                    length, pd_log = it + 1 - length, dl
                    bl = [fs] + lc[:TMAX]
                    continue
            bl = [fs] + bl[:TMAX]
        lcs = [int(log[cc[j]]) for j in range(1, TMAX + 1)]
        deg = max([j + 1 for j in range(TMAX) if lcs[j] != fs], default=0)
        if fail or deg != length:
            continue
        a = mul(cc[1], cc[1]) ^ cc[2] if length == 3 else 0
        if length <= 2 or (length == 3 and a):          # solved by the thread
            roots, l1 = [], lcs[0]
            if length == 1 and l1 < n:
                roots = [l1]
            elif length == 2 and l1 != fs:
                y = int(quad[alog[mod(lcs[1] - 2 * l1)]])
                if y != NO_ROOT:
                    roots = [p for p in (mod(l1 + int(log[y ^ k])) for k in (0, 1)) if p < n]
            elif length == 3:
                b = mul(cc[1], cc[2]) ^ cc[3]
                half = int(log[a]) * ((fs + 1) // 2) % fs
                ys = cubic[alog[mod(int(log[b]) - 3 * half)]] if b else [NO_ROOT]
                if ys[0] != NO_ROOT:
                    xs = [int(alog[mod(half + int(log[y]))]) ^ cc[1] for y in ys[:3]]
                    roots = [int(log[x]) for x in xs if log[x] < n]
        else:                               # a warp's sweep, stopped at deg roots
            roots = chien_sweep(alog, lcs[:deg], n, fs)
        if len(roots) != length:
            continue
        if any(syn[i] ^ np.bitwise_xor.reduce([int(alog[((2 * i + 1) * p) % fs]) for p in roots])
               for i in range(t)):
            continue
        ok[r], corrected[r] = True, len(roots)
        for p in roots:
            if p >= pb:
                q = p - pb
                out[r, nb - 1 - q // 8] ^= 1 << (q % 8)
    return ok, out, corrected


@pytest.mark.parametrize("params", [NAND, (13, 0x201B, 4, 4096), (13, 0x201B, 16, 4096), SMALL],
                         ids=["t8", "t4", "t16", "small"])
def test_kernel_steps_equal_plain_version(params):
    m, poly, t, k = params
    codec = pt.create(pt.BchConfig(m, poly, t, data_length=k), device="cpu")
    c = codec._bch
    ref = bch_ref.BCHReference(ref_cfg(params), "cpu")
    B = 2 * (t + 3)
    data, parity = codewords(codec, ref, B, seed=t)
    rng = np.random.default_rng(m * t)
    counts = np.arange(B) % (t + 3)
    data, parity = flip_bits(c, data, parity, [rng.choice(c.n, int(x), replace=False)
                                               for x in counts])
    pdata, pparity = chip_smoke.bch_pad_rows(c, *codewords(codec, ref, 2 * t, seed=t + 1), seed=t)
    data, parity = torch.cat([data, pdata]), torch.cat([parity, pparity])
    image = bch_tables(c.log2exp.numpy(), c.exp2log.numpy(), c.gen_poly, t)
    assert image.dtype == np.uint8 and image.size % 16 == 0
    ok, out, corrected = emulate_kernel(image, c, data.numpy(), parity.numpy())
    want = c.decode_bytes(data, parity)
    assert np.array_equal(ok, want[0].numpy())
    assert np.array_equal(out, want[1].numpy())
    assert np.array_equal(corrected, want[2].numpy())
    assert ok[: t + 1].all() and not ok[-2 * t:].any()
