"""The RS decode kernel's Chien sweep against the JAX package.

`chien_sweep` and the owner's part of step 5 in `finish_row`
(libpoporon_tpu_torch/csrc/rs_decode.cu) evaluate the locators a warp at
a time.  Here a NumPy emulation of those steps, written as the kernel runs
them, must give the JAX package's Chien (`RSCodec._correct`: the dense
evaluation through `M_chien`, the first deg roots in scan order, their
locations, `found` and `fail_pad`) root for root and location for
location.  The emulation: warps of 32 rows in batch order, lanes past the
batch's end with degree 0; the rows of degree >= 1 in the order of one
ballot's bits; each coefficient broadcast from the owner lane, zero ones
skipped; lane l's 8 points i = l + 1 + 32 s, each term's log stepped from
(log el_j + j (l + 1)) mod fs by 32 j; one ballot a step, i = 256 masked;
the owner reads its roots from its 8 ballot words in order of s, then l;
loc = (i prim_inv + fs - 1) mod fs and fail_pad = loc < pad.  The order
is also held to a popc prefix over the ballots, and every row's roots to
at most its degree (el_0 = 1), which is why sweeping all fs points gives
the scan's first deg roots.

Locators, from a numpy seed, over the five configs of
tests/test_torch_rs_bm.py, most with a pad (shortened rows):
- degrees: products of deg distinct factors (1 + X x), deg 0..nr in turn;
- zero_inner: 1 + c x^d (roots where x^d = 1 / c: gcd(d, fs) of them, or
  none) and products with random inner coefficients zeroed;
- past_capacity: random locators of degree t + 1..nr, and products of
  deg - 2 factors with a quadratic that has no root: fewer roots than
  their degree, the rows a decode fails past its capacity;
- pad: every root, or half of them, at a location in the pad region;
- ragged: batches of 1, 31, 33 and 97 rows, a ragged last warp, with
  clean rows (degree 0) among them.
Tolerance: exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402
from libpoporon_tpu.ops.gfint import onehot_select  # noqa: E402

from libpoporon_tpu_torch.benchmarks import rs_kernel  # noqa: E402
from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import RSCodec  # noqa: E402
from libpoporon_tpu_torch.utils import build  # noqa: E402

FS = 255
LANES, STEPS = 32, 8      # the kernel's warp and kSweepSteps
ROWS = 250                # eight warps, the last ragged
CONFIGS = {
    "default": {},
    "fcr0": {"first_consecutive_root": 0},
    "prim2": {"primitive_element": 2},
    "nr16": {"num_roots": 16},
    "nr64": {"num_roots": 64},
}
PAD = {"default": 0, "fcr0": 11, "prim2": 40, "nr16": 5, "nr64": 23}   # fs - n
KINDS = ("degrees", "zero_inner", "past_capacity", "pad", "ragged")
_CODECS = {}


def _codecs(name):
    """(port, JAX) codecs per config, built once per module."""
    if name not in _CODECS:
        kw = CONFIGS[name]
        _CODECS[name] = (RSCodec(RSConfig(**kw), "cpu"),
                         JaxRSCodec(JaxRSConfig(use_pallas="off", **kw)))
    return _CODECS[name]


def ballot(pred) -> int:
    """__ballot_sync over the 32 lanes: bit l set where pred[l]."""
    return int(np.sum(np.asarray(pred, np.int64) << np.arange(LANES)))


def ffs(x: int) -> int:
    """__ffs: 1 + the index of the lowest set bit."""
    return (x & -x).bit_length()


def degree(el) -> int:
    """Step 4: the highest nonzero slot of el[1..nr], 0 for none."""
    nz = np.nonzero(el[1:])[0]
    return int(nz[-1]) + 1 if len(nz) else 0


def emulate_sweep(log, antilog, el, deg):
    """chien_sweep for one warp: el [32, nr + 1] and deg [32] of its lanes'
    rows (degree 0 past the batch) -> the ballot words each owner keeps,
    [32, STEPS] (zero for rows not swept)."""
    lane = np.arange(LANES)
    hits = np.zeros((LANES, STEPS), np.int64)
    todo = ballot(deg > 0)
    while todo:
        owner = ffs(todo) - 1
        todo &= todo - 1
        ev = np.zeros((LANES, STEPS), np.int64)
        for j in range(1, int(deg[owner]) + 1):
            c = int(el[owner, j])        # __shfl_sync from the owner
            if c == 0:
                continue
            step = (32 * j) % FS
            e = (log[c] + j * (lane + 1)) % FS
            for s in range(STEPS):
                ev[:, s] ^= antilog[e]
                e = e + step
                e = np.where(e >= FS, e - FS, e)
        for s in range(STEPS):
            hits[owner, s] = ballot((ev[:, s] == 1) & (lane + 1 + 32 * s <= FS))
    return hits


def emulate_roots(hits, prim_inv, pad):
    """The owner's part of step 5: (roots, locations, fail_pad) from its
    ballot words, in order of s, then lane.  Asserts that a popc prefix
    over the words gives each root the same place."""
    root, loc, fail_pad = [], [], False
    for s in range(STEPS):
        b = int(hits[s])
        while b:
            i = ffs(b) + 32 * s
            lane = ffs(b) - 1
            prefix = sum(bin(int(h)).count("1") for h in hits[:s])
            assert prefix + bin(int(hits[s]) & ((1 << lane) - 1)).count("1") == len(root)
            k = (i * prim_inv + FS - 1) % FS
            root.append(i)
            loc.append(k)
            fail_pad |= k < pad
            b &= b - 1
    return root, loc, fail_pad


def emulate_chien(rs, el, pad):
    """The kernel's Chien over a batch of locators el [B, nr + 1]: per row
    (deg, roots, locations, fail_pad)."""
    log, antilog = rs.exp2log.numpy().astype(np.int64), rs.log2exp.numpy().astype(np.int64)
    B, width = el.shape
    deg = np.array([degree(r) for r in el])
    warps = -(-B // LANES)
    el_w = np.zeros((warps * LANES, width), np.int64)
    el_w[:B] = el
    deg_w = np.zeros(warps * LANES, np.int64)
    deg_w[:B] = deg
    out = []
    for w in range(warps):
        rows = slice(w * LANES, (w + 1) * LANES)
        hits = emulate_sweep(log, antilog, el_w[rows], deg_w[rows])
        assert not hits[deg_w[rows] == 0].any(), "a row of degree 0 was swept"
        out += [(int(d), *emulate_roots(h, rs.prim_inv, pad))
                for d, h in zip(deg_w[rows], hits)]
    return out[:B]


def jax_chien(jax_rs, el, pad):
    """The JAX package's Chien on el [B, nr + 1], as `_correct` runs it
    (libpoporon_tpu/models/rs.py, the lines under "Chien"): deg, found,
    fail_pad, roots and locations [B, nr], and every point's root mask
    [B, fs]."""
    fs, nr = jax_rs.fs, jax_rs.num_roots
    el = jnp.asarray(el, jnp.int32)
    B = el.shape[0]
    lane = jnp.arange(nr + 1, dtype=jnp.int32)[None, :]
    deg = jnp.max(jnp.where(el != 0, lane, 0), axis=1)
    terms = jax_rs._eval_at_all_points(el[:, 1:], jax_rs.M_chien)
    root_mask = terms == 1
    i_vals = jnp.arange(1, fs + 1, dtype=jnp.int32)[None, :]
    cum = jnp.cumsum(root_mask.astype(jnp.int32), axis=1)
    selected = root_mask & (cum <= deg[:, None])
    found = jnp.sum(selected.astype(jnp.int32), axis=1)
    k_vals = (i_vals * jax_rs.prim_inv - 1) % fs
    fail_pad = jnp.any(selected & (k_vals < pad), axis=1)
    jvalid = jnp.arange(nr, dtype=jnp.int32)[None, :] < deg[:, None]
    iv = jnp.broadcast_to(i_vals, (B, fs))
    roots = onehot_select(jnp.where(selected, iv, 0), selected, nr).astype(jnp.int32)
    roots = jnp.where(jvalid, roots, 0)
    locs = jnp.where(jvalid, (roots * jax_rs.prim_inv - 1) % fs, 0)
    return tuple(np.asarray(a) for a in (deg, found, fail_pad, roots, locs, root_mask))


class Poly:
    """Locators over the port's GF tables, el_0 = 1."""

    def __init__(self, rs, rng):
        self.log = rs.exp2log.numpy().astype(np.int64)
        self.antilog = rs.log2exp.numpy().astype(np.int64)
        self.prim, self.nr, self.rng = rs.prim, rs.num_roots, rng

    def mul(self, a, b):
        return 0 if a == 0 or b == 0 else int(self.antilog[(self.log[a] + self.log[b]) % FS])

    def times(self, el, factor):
        """el * factor, coefficients low first."""
        out = [0] * (len(el) + len(factor) - 1)
        for i, a in enumerate(el):
            for j, b in enumerate(factor):
                out[i + j] ^= self.mul(a, b)
        return out

    def point(self, k):
        """The Chien point i (1..fs) of location k: i prim_inv = k + 1."""
        return (k + 1) * self.prim % FS or FS

    def from_locations(self, locs):
        """prod (1 + alpha^-i x) over the points of `locs`."""
        el = [1]
        for k in locs:
            el = self.times(el, [1, int(self.antilog[(FS - self.point(k)) % FS])])
        return el

    def random_locations(self, d, low=0):
        return self.rng.choice(np.arange(low, FS), d, replace=False)

    def rootless(self, d):
        """A polynomial of degree d with el_0 = 1 and no root among the fs
        points."""
        while True:
            el = [1] + list(self.rng.integers(0, 256, d - 1)) + [int(self.rng.integers(1, 256))]
            if not any(self.eval(el, i) == 0 for i in range(1, FS + 1)):
                return el

    def eval(self, el, i):
        v = 0
        for j, c in enumerate(el):
            if c:
                v ^= int(self.antilog[(self.log[c] + j * i) % FS])
        return v

    def rows(self, polys):
        """[B, nr + 1] int64, each zero above its degree."""
        out = np.zeros((len(polys), self.nr + 1), np.int64)
        for r, el in enumerate(polys):
            out[r, : len(el)] = el
        return out


def _case(name, kind, rng):
    """(locators [B, nr + 1], pad) of a case."""
    rs, _ = _codecs(name)
    gf = Poly(rs, rng)
    nr, t = rs.num_roots, rs.num_roots // 2
    pad = PAD[name]
    polys = []
    if kind == "degrees":
        for r in range(ROWS):
            polys.append(gf.from_locations(gf.random_locations(r % (nr + 1))))
    elif kind == "zero_inner":
        divisors = [x for x in (3, 5, 15, 17, 51) if x <= nr]
        for r in range(ROWS):
            d = 1 + r % nr
            if r % 4 == 1:
                # 1 + c x^d, d dividing fs, with a root: d roots
                d = divisors[r // 4 % len(divisors)]
                c = int(gf.antilog[(-d * gf.point(int(rng.integers(FS)))) % FS])
                polys.append([1] + [0] * (d - 1) + [c])
            elif r % 4 == 3:
                # 1 + c x^d, c at random: gcd(d, fs) roots or none
                polys.append([1] + [0] * (d - 1) + [int(rng.integers(1, 256))])
            else:
                el = gf.from_locations(gf.random_locations(d))
                for j in rng.choice(np.arange(1, d), min(d - 1, int(rng.integers(1, 4))),
                                    replace=False) if d > 1 else []:
                    el[j] = 0
                polys.append(el)
    elif kind == "past_capacity":
        for r in range(ROWS):
            d = int(rng.integers(t + 1, nr + 1))
            if r % 2:
                polys.append([1] + list(rng.integers(0, 256, d - 1)) + [int(rng.integers(1, 256))])
            else:
                polys.append(gf.times(gf.from_locations(gf.random_locations(d - 2)),
                                      gf.rootless(2)))
    elif kind == "pad":
        pad = 48
        for r in range(ROWS):
            d = 1 + r % min(nr, pad)
            locs = rng.choice(pad, d, replace=False)
            if r % 2:   # half of them in the pad region, the rest past it
                locs[: d // 2] = gf.random_locations(d // 2, pad)[: d // 2]
            polys.append(gf.from_locations(locs))
    else:
        batches = (1, 31, 33, 97)
        for B in batches:
            for r in range(B):
                d = int(rng.integers(0, t + 1)) if r % 3 else 0
                polys.append(gf.from_locations(gf.random_locations(d)))
    return gf.rows(polys), pad


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_emulated_kernel_chien_matches_jax(name, kind):
    rs, jax_rs = _codecs(name)
    rng = np.random.default_rng([KINDS.index(kind), list(CONFIGS).index(name)])
    el, pad = _case(name, kind, rng)
    assert (el[:, 0] == 1).all()
    if kind == "ragged":
        # one batch after another, each with its own last warp
        starts = np.cumsum((0, 1, 31, 33))
        got = [row for a, B in zip(starts, (1, 31, 33, 97))
               for row in emulate_chien(rs, el[a:a + B], pad)]
    else:
        got = emulate_chien(rs, el, pad)
    deg, found, fail_pad, roots, locs, root_mask = jax_chien(jax_rs, el, pad)

    for r, (d, root, loc, fp) in enumerate(got):
        assert d == deg[r], f"row {r}: degree"
        n_roots = int(root_mask[r].sum())
        assert n_roots <= d, f"row {r}: more roots than the degree"
        if d == 0:
            assert found[r] == 0 and not root, f"row {r}: a degree-0 row has roots"
            continue
        assert len(root) == n_roots == found[r], f"row {r}: found"
        assert root == list(roots[r, : found[r]]), f"row {r}: roots != JAX"
        assert loc == list(locs[r, : found[r]]), f"row {r}: locations != JAX"
        assert fp == bool(fail_pad[r]), f"row {r}: fail_pad != JAX"

    # the case reaches what it is for
    n = np.array([len(g[1]) for g in got])
    if kind == "degrees":
        assert set(deg) == set(range(rs.num_roots + 1)) and (n == deg).all()
    elif kind == "zero_inner":
        inner = [(el[r, 1:deg[r]] == 0).any() for r in range(len(el))]
        assert any(inner) and (n[inner] < deg[inner]).any() and (n[inner] == deg[inner]).any()
    elif kind == "past_capacity":
        assert (deg > rs.num_roots // 2).all() and (n < deg).all()
    elif kind == "pad":
        assert fail_pad.all() and (n == deg).all()
    else:
        assert (deg == 0).any() and (deg > 0).any()


def test_breakdown_stamps_land_in_the_kernel():
    """`rs_kernel.py --breakdown` places its stamps by text anchors, each of
    which must match the decode kernel's source once: a moved anchor
    raises there, on the card, and here."""
    src = (build.CSRC_DIR / "rs_decode.cu").read_text()
    stamped = rs_kernel.instrument(src)
    for k in range(1, len(rs_kernel.LABELS)):
        assert f"pp.stage({k});" in stamped, f"no stamp for stage {rs_kernel.LABELS[k]}"
    assert stamped.count("PPStamps& pp") == 2 and "pp.flush();" in stamped
