"""The ``group`` kernel's algorithm (csrc/group.cu), emulated in NumPy on the
CPU, against its twin (ops/detect.py group_plain) bit for bit; and the
twin against the reference package's ``group_candidates`` on the longest
component and on 256 singletons.

The emulation follows the kernel's work: k (the last valid slot + 1) picks
warp 0 alone (k <= 32: the slots past 32 written empty, the pick over
warp 0's lanes) or the whole CTA; neighbour rows from the pair test; labels
from each row's lowest bit; rounds of pointer jumping and hooking by
atomicMin, the threads in a random order (each step either sees the others'
writes of the pass or a snapshot from its start: both are interleavings the
CTA may run, and warp 0's shuffles run the snapshot); member sums in the
kernel's fixed point, added in a shuffled order; the containment test and
the pick by warp maxima of the scores' ordered keys.  The slot sets are
tools/torch_group_cases.py's (the card tests and chip_smoke.py use them
too)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.models import detector as jd
from headtrackr_tpu_torch.cascade import frontalface
from headtrackr_tpu_torch.kernels.group import group
from headtrackr_tpu_torch.models import detector as td

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_cases():
    spec = importlib.util.spec_from_file_location(
        "torch_group_cases", ROOT / "tools" / "torch_group_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gc = _load_cases()
F = np.float32
NONE = 256  # the kernel's label of an invalid slot


def _binade(v):
    b = int((np.float32(v).view(np.uint32) >> 23) & 255)
    return 255 if v == 0 else max(b, 1)


def _fixed(v, e):
    """csrc/group.cu fixed(): v in units of 2^(e - 150), an exact int."""
    u = int(np.float32(v).view(np.uint32))
    b = (u >> 23) & 255
    m = (u & 0x7FFFFF) | (0x800000 if b else 0)
    q = m << min(max(max(b, 1) - e, 0), 39)
    return -q if u >> 31 else q


def _unfixed(s, e):
    """A fixed-point sum rounded once to f32 (via the exact f64)."""
    assert -2 ** 63 <= s < 2 ** 63  # the int64 holds it
    return np.float32(np.float64(s) * 2.0 ** (e - 150))


def _pairs(x, y, w, v, k):
    """(k, k) neighbour rows: the kernel's pair test, itself included."""
    d = np.floor(w * F(0.25) + F(0.5))
    wide = np.floor(w * F(1.5) + F(0.5))
    lo_x, hi_x, lo_y, hi_y = x - d, x + d, y - d, y + d
    c = lambda a: a[:k, None]  # noqa: E731  (row i)
    r = lambda a: a[None, :k]  # noqa: E731  (lane j)
    size = (r(w) <= c(wide)) & (c(w) <= r(wide))
    a = (r(x) >= c(lo_x)) & (r(x) <= c(hi_x)) & (r(y) >= c(lo_y)) & \
        (r(y) <= c(hi_y))
    b = (c(x) >= r(lo_x)) & (c(x) <= r(hi_x)) & (c(y) >= r(lo_y)) & \
        (c(y) <= r(hi_y))
    return c(v) & r(v) & (np.eye(k, dtype=bool) | (size & (a | b)))


def _labels(adj, v, rng):
    """The kernel's rounds: returns (labels, rounds)."""
    k = len(v)
    lab = np.where(v, np.argmax(adj, axis=1), NONE)
    rounds = 0
    while True:
        while True:  # pointer jumping
            moved = False
            snap = lab.copy() if rng.random() < 0.5 else lab
            for t in rng.permutation(k):
                if v[t]:
                    l = snap[t]
                    ll = snap[l]
                    if ll != l:
                        lab[t] = ll
                        moved = True
            if not moved:
                break
        hooked = False
        snap = lab.copy() if rng.random() < 0.5 else lab
        for t in rng.permutation(k):
            if v[t]:
                l = snap[t]
                m = min(l, int(snap[adj[t]].min()))
                if m < l:
                    lab[l] = min(lab[l], m)  # atomicMin
                    hooked = True
        rounds += 1
        if not hooked:
            return lab, rounds


def _stream(x, y, w, h, c, v, mn, rng):
    """One stream's slots through the kernel's algorithm: (o (6, K), keep,
    the slots its warps cover, rounds)."""
    K = len(x)
    if mn <= 0:
        return np.stack([x, y, w, h, v.astype(F), c]), v.copy(), 256, 0
    k = int(np.nonzero(v)[0].max()) + 1 if v.any() else 0
    threads = 32 if k <= 32 else 256
    o = np.zeros((6, K), F)
    o[5] = -np.inf
    keep = np.zeros(K, bool)
    if k == 0:
        return o, keep, threads, 0
    vk = v[:k]
    lab, rounds = _labels(_pairs(x, y, w, v, k), vk, rng)
    planes = (x, y, w, h)
    e = [min([_binade(p[t]) for t in range(k) if vk[t]] + [255])
         for p in planes]
    sums = np.zeros((4, k), object)
    cnt = np.zeros(k, np.int64)
    cmax = np.full(k, -np.inf, F)
    for t in rng.permutation(k):
        if vk[t]:
            r = lab[t]
            for f, p in enumerate(planes):
                sums[f, r] += _fixed(p[t], e[f])
            cnt[r] += 1
            cmax[r] = max(cmax[r], c[t])
    on = cnt.astype(F)
    two_n = F(2) * np.maximum(on, F(1))
    for f in range(4):
        s = np.array([_unfixed(sums[f, t], e[f]) for t in range(k)], F)
        o[f, :k] = (s * F(2) + on) / two_n
    o[4, :k] = on
    o[5, :k] = cmax
    rep = (cnt > 0) & (on >= F(mn))
    gd = np.floor(o[2, :k] * F(0.25) + F(0.5))
    for t in np.nonzero(rep)[0]:
        xr, yb = o[0, t] + o[2, t], o[1, t] + o[3, t]
        inside = False
        for j in np.nonzero(rep)[0]:
            if j != t and not inside:
                inside = (o[0, t] >= o[0, j] - gd[j] and
                          o[1, t] >= o[1, j] - gd[j] and
                          xr <= o[0, j] + o[2, j] + gd[j] and
                          yb <= o[1, j] + o[3, j] + gd[j] and
                          (on[j] > max(on[t], F(3)) or on[t] < F(3)))
        keep[t] = not inside
    return o, keep, threads, rounds


def _ukey(f):
    """csrc/group.cu ukey(): an f32's order as an unsigned int, above 0."""
    u = int(np.float32(f).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u >> 31 else u | 0x80000000


def _pick(score, threads):
    """The kernel's argmax: each warp's largest key (__reduce_max_sync) at
    its first lane (a ballot), then the first warp holding the largest."""
    K = len(score)
    keys = [_ukey(score[t]) if t < K else 0 for t in range(threads)]
    warps = []
    for q in range(0, threads, 32):
        top = max(keys[q:q + 32])
        warps.append((top, q + keys[q:q + 32].index(top)))
    top = max(k for k, _ in warps)
    return next(i for k, i in warps if k == top)


def emulate(x, y, w, h, c, valid, mn, rng):
    """group's outputs, as the kernel computes them, and each stream's
    rounds and thread count."""
    N, K = x.shape
    o = np.zeros((6, N, K), F)
    kept = np.zeros((N, K), bool)
    best = np.zeros((5, N), F)
    found = np.zeros(N, bool)
    rounds, threads = [], []
    for n in range(N):
        o[:, n], kept[n], nt, r = _stream(x[n], y[n], w[n], h[n], c[n],
                                          valid[n], mn, rng)
        i = _pick(np.where(kept[n], o[5, n], -np.inf), nt)
        best[:, n] = o[[0, 1, 2, 3, 5], n, i]
        found[n] = kept[n].any()
        rounds.append(r)
        threads.append(nt)
    return o, kept, best, found, rounds, threads


def _same_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert a.shape == b.shape and np.array_equal(a, b), what


CASES = gc.cases(np.random.default_rng(15))


@pytest.mark.parametrize("mn", [0, 1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_group_emulation_equals_twin(name, mn):
    """The kernel's algorithm, its threads in a random order, equals the
    twin bit for bit on every slot set."""
    arrays = CASES[name]
    rng = np.random.default_rng(len(name) + mn)
    o, kept, best, found, rounds, threads = emulate(*arrays, mn, rng)
    slots, pick = group(*(torch.as_tensor(a) for a in arrays), mn)
    for f, key in enumerate(("x", "y", "width", "height", "neighbors",
                             "confidence")):
        _same_bits(o[f], slots[key].numpy(), (name, mn, key))
    _same_bits(kept, slots["kept"].numpy(), (name, mn, "kept"))
    _same_bits(found, pick[0].numpy(), (name, mn, "found"))
    for f in range(5):
        _same_bits(best[f], pick[f + 1].numpy(), (name, mn, "best", f))
    if name == "k = 1, 32, 33, 256" and mn > 0:
        assert threads == [32, 32, 256, 256]  # warp 0 alone up to k = 32
    if name == "chain" and mn > 0:
        # labels start at the lower neighbour: jumping settles the chain,
        # one hooking pass finds nothing
        assert rounds == [1]


def test_group_emulation_rounds_stay_few_on_a_shuffled_chain():
    """The longest component with its boxes shuffled over the slots: the
    rounds of hooking stay near the log of its 256 slots, not its length,
    whatever the threads' order."""
    arrays = CASES["chain shuffled"]
    for seed in range(4):
        *_, rounds, _ = emulate(*arrays, 1, np.random.default_rng(seed))
        assert rounds[0] <= 12, rounds


def test_group_fixed_point_is_exact_on_the_detectors_boxes():
    """Every coordinate the detector emits (240x320 and 480x640 tables) is 0
    or in [2, 2^12): E >= 128, so 256 of the largest sum to under 2^42 units
    of 2^(E - 150), exact in an int64 and in f64; and the fixed-point sum of
    random members, in any order, equals the f64 sum rounded to f32."""
    rng = np.random.default_rng(0)
    for W, H in ((320, 240), (640, 480)):
        t = td.detector_tables(W, H, frontalface(), 5, "cpu")
        for p in (t.out_x, t.out_y, t.out_w, t.out_h):
            a = p.numpy()
            nz = a[a != 0]
            assert nz.min() >= 2 and nz.max() < 2 ** 12
            e = min(_binade(v) for v in nz)
            assert e >= 128
            assert 256 * _fixed(np.float32(nz.max()), e) < 2 ** 42
            members = rng.choice(nz, 256)
            want = np.float32(members.astype(np.float64).sum())
            for _ in range(3):
                s = sum(_fixed(v, e) for v in rng.permutation(members))
                assert _unfixed(s, e).view(np.uint32) == want.view(np.uint32)


def test_group_twin_equals_reference_on_chain_and_singletons():
    """The twin against the reference package's group_candidates (one jit at
    K = 256) on the longest component and on 256 singletons: kept,
    neighbors and confidence exact, the boxes within rtol 1e-6."""
    rng = np.random.default_rng(7)
    arrays = [np.concatenate(a) for a in zip(gc.chain(rng),
                                             gc.singletons(rng))]
    want = jax.jit(jax.vmap(jd.group_candidates))(
        *(jnp.asarray(a) for a in arrays))
    slots, best = group(*(torch.as_tensor(a) for a in arrays), 1)
    kept = np.asarray(want["kept"])
    np.testing.assert_array_equal(slots["kept"].numpy(), kept)
    assert kept.sum(1).tolist() == [1, 256]
    for k in ("neighbors", "confidence"):
        np.testing.assert_array_equal(slots[k].numpy()[kept],
                                      np.asarray(want[k])[kept], err_msg=k)
    for k in ("x", "y", "width", "height"):
        np.testing.assert_allclose(slots[k].numpy()[kept],
                                   np.asarray(want[k])[kept], rtol=1e-6,
                                   err_msg=k)
    assert slots["neighbors"].numpy()[0, 0] == 256
    np.testing.assert_array_equal(best[0].numpy(), [True, True])
