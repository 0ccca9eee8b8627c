"""The port's public surface against the reference's, name by name.

One case a module of ``headtrackr_tpu`` (the package and every module under
it): each public name (``__all__``) has its counterpart in the same module
of ``headtrackr_tpu_torch``; a plain value (an int, a string, a tuple, a
table) is equal; a callable, a class's constructor and each public method
accept every reference parameter by name, and the reference's positional
parameters keep their order after the port's leading batched ones.  What
the port leaves out on purpose is in ``EXEMPT``, each with its reason; an
exemption that no longer finds a mismatch fails the case, so the list
stays honest.

Then one value test a repaired call shape, each on the CPU against the JAX
package on the same seeded inputs: ``make_step``'s positional ``with_pdf``,
the camshift functions' reference parameters, ``shard_streams``'
``axis_name``, the detector functions on a model, ``mean_shift``'s three
outputs, ``handoff_band_audit`` on bins, ``init_state``'s order and the
``None`` device; and the reference-named kernel entry points
``hist_pallas``/``pdf_pallas`` against the reference's Pallas kernels in
interpret mode.
"""

import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import headtrackr_tpu
from headtrackr_tpu.cascade import toy_cascade as j_toy
from headtrackr_tpu.config import TrackerConfig as JConfig
from headtrackr_tpu.kernels import histpdf as jk
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.models import detector as jd
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu.ops import histogram as jhg
from headtrackr_tpu.oracle.camshift import CamshiftTracker
from headtrackr_tpu.parallel import mesh as jmesh
from headtrackr_tpu_torch import TrackerConfig, convert, toy_cascade
from headtrackr_tpu_torch import kernels as tk
from headtrackr_tpu_torch.cascade import cascade_to_torch
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.models import detector as td
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.ops import histogram as thg
from headtrackr_tpu_torch.parallel import mesh as tmesh

from test_torch_camshift import _check

REF, PORT = "headtrackr_tpu", "headtrackr_tpu_torch"
MODULES = [REF] + sorted(m.name for m in pkgutil.walk_packages(
    headtrackr_tpu.__path__, REF + "."))

_LEAD = ("the port's states are batched over a leading stream axis n "
         "(ROADMAP.md Decisions); the reference builds one stream's state "
         "and its callers vmap it")
_SPARSE = ("sparseHist is value-identical in the port (accepted and "
           "ignored), so its camshift state carries no sparse descriptor")
_NOT_TO_PORT = "ROADMAP.md 'Not to port': "
_BINS_TPU = _NOT_TO_PORT + ("a one-hot MXU formulation of the TPU; the "
                            "port's backproject and histpdf_band compute "
                            "its function")

# {qualified name: reason}.  A name is ``module.qualname`` relative to
# headtrackr_tpu where the reference defines it; ``name(param)`` is one
# parameter: a reference parameter the port lacks, or a leading port
# parameter the reference has not.
EXEMPT = {
    "models.facetracker.init_state(n)": _LEAD,
    "models.camshift.init_state(n)": _LEAD,
    "models.camshift.CamshiftState(model_bins)": _SPARSE,
    "models.camshift.CamshiftState(model_counts)": _SPARSE,
    "models.camshift.CamshiftState(model_overflow)": _SPARSE,
    "models.detector.DetectorTables": (
        "its fields are the port's kernels' tables (the pyramid's chains, "
        "the cascade's codes and footprints), not the reference's TPU "
        "tiles; detector_tables builds either from the same arguments"),
    "ops.histogram.split_bf16_3": _NOT_TO_PORT + (
        "the three-way bf16 weight split exists for the TPU's MXU; the "
        "port's lookups are f32"),
    "kernels.histpdf.DEFAULT_BLOCK": _NOT_TO_PORT + (
        "the TPU's VMEM scan block; hist_pallas and pdf_pallas accept "
        "block and ignore it"),
    "models.detector.compact_indices": _NOT_TO_PORT + (
        "XLA:TPU tile compaction; the cascade kernel compacts its "
        "survivors itself"),
    "ops.histogram.pdf_scan": _BINS_TPU,
    "ops.histogram.backprojection_pdf": _BINS_TPU,
    "ops.histogram.histogram_and_pdf": _BINS_TPU,
    "ops.histogram.sparse_model_topk": _NOT_TO_PORT + _SPARSE,
    "ops.histogram.sparse_hist_counts": _NOT_TO_PORT + _SPARSE,
    "ops.histogram.sparse_pdf_scan": _NOT_TO_PORT + _SPARSE,
    "utils.profiling.enable_compilation_cache": _NOT_TO_PORT + (
        "JAX's persistent compilation cache; the port compiles its kernels "
        "once a checkout (kernels/build.py)"),
}

_P = inspect.Parameter
_POSITIONAL = (_P.POSITIONAL_ONLY, _P.POSITIONAL_OR_KEYWORD)
_VALUES = (bool, int, float, str, tuple, list, dict)


def _key(modname, name, obj):
    """The qualified name of ``obj``, found as ``name`` in ``modname``."""
    owner = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    if (isinstance(owner, str) and owner.startswith(REF + ".")
            and isinstance(qual, str) and "<" not in qual):
        return f"{owner[len(REF) + 1:]}.{qual}"
    return f"{modname[len(REF) + 1:]}.{name}".lstrip(".")


def _signature(obj):
    if inspect.isclass(obj) and obj.__init__ is not object.__init__:
        sig = inspect.signature(obj.__init__)
        return sig.replace(parameters=list(sig.parameters.values())[1:])
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _check_callable(key, ref, port, problems, seen):
    rs, ps = _signature(ref), _signature(port)
    if rs is None or ps is None:
        if (rs is None) != (ps is None):
            problems[key] = f"signature on one side only: {rs} vs {ps}"
        return
    rp, pp = rs.parameters, ps.parameters
    missing = set()
    for name, p in rp.items():
        k = f"{key}({name})"
        seen.add(k)
        if p.kind in (_P.VAR_POSITIONAL, _P.VAR_KEYWORD):
            if not any(q.kind == p.kind for q in pp.values()):
                problems[k] = f"no {p.kind.description} parameter"
        elif name not in pp or pp[name].kind == _P.POSITIONAL_ONLY:
            problems[k] = f"{name!r} not accepted by name: {ps}"
            missing.add(name)
    ref_pos = [n for n, p in rp.items()
               if p.kind in _POSITIONAL and not (n in missing and
                                                 f"{key}({n})" in EXEMPT)]
    port_pos = [n for n, p in pp.items() if p.kind in _POSITIONAL]
    for name in port_pos:
        seen.add(f"{key}({name})")
    while (port_pos and port_pos[0] not in rp
           and f"{key}({port_pos[0]})" in EXEMPT):
        problems[f"{key}({port_pos.pop(0)})"] = "leading port parameter"
    if port_pos[:len(ref_pos)] != ref_pos:
        problems[key] = (f"positional order {port_pos} against the "
                         f"reference's {ref_pos}")


def _check_name(modname, name, ref, port, problems, seen):
    key = _key(modname, name, ref)
    seen.add(key)
    if port is None:
        problems[key] = "missing"
        return
    found = {}
    if inspect.ismodule(ref):
        if not inspect.ismodule(port):
            found[key] = f"not a module: {port!r}"
    elif isinstance(ref, _VALUES) and not callable(ref):
        if not (type(port) is type(ref) and port == ref):
            found[key] = f"value {port!r} against {ref!r}"
    elif callable(ref):
        _check_callable(key, ref, port, found, seen)
    if inspect.isclass(ref) and key not in EXEMPT:
        fields = getattr(ref, "_fields", ())
        for attr, v in vars(ref).items():
            if attr.startswith("_") or attr in fields:
                continue
            akey = f"{key}.{attr}"
            seen.add(akey)
            if not hasattr(port, attr):
                found[akey] = "missing"
            elif inspect.isfunction(v) or isinstance(
                    v, (staticmethod, classmethod)):
                _check_callable(akey, getattr(ref, attr),
                                getattr(port, attr), found, seen)
    if key in EXEMPT and found:
        found = {key: "; ".join(f"{k}: {m}" for k, m in found.items())}
    problems.update(found)


def _surface(modname):
    """(problems {key: message}, the keys an exemption could name) for the
    reference module ``modname`` against its counterpart."""
    ref = importlib.import_module(modname)
    port = importlib.import_module(PORT + modname[len(REF):])
    problems, seen = {}, set()
    for name in ref.__all__:
        _check_name(modname, name, getattr(ref, name),
                    getattr(port, name, None), problems, seen)
    return problems, seen


@pytest.mark.parametrize("modname", MODULES)
def test_public_surface_matches_reference(modname):
    problems, seen = _surface(modname)
    open_ = {k: m for k, m in problems.items() if k not in EXEMPT}
    assert not open_, "\n".join(f"{k}: {m}" for k, m in open_.items())
    stale = [k for k in EXEMPT if k in seen and k not in problems]
    assert not stale, f"exemptions that now match: {stale}"


def test_every_exemption_names_the_reference_surface():
    seen = set()
    for modname in MODULES:
        seen |= _surface(modname)[1]
    assert not set(EXEMPT) - seen, sorted(set(EXEMPT) - seen)
    assert len(MODULES) == 40


# -- value tests: the repaired call shapes against the JAX package -----------

H, W = 48, 64


def _blob_frames(n, rng):
    """n frames of noise with a 24 px reddish square at a seeded place."""
    f = rng.integers(20, 60, (n, H, W, 3), np.uint8)
    for i in range(n):
        y, x = rng.integers(6, H - 30), rng.integers(6, W - 30)
        f[i, y:y + 24, x:x + 24] = (230, 80, 60)
    return f


def _stack(trees):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *trees)


def _assert_tree(port_leaves, jax_leaves):
    assert len(port_leaves) == len(jax_leaves)
    for a, b in zip(port_leaves, jax_leaves):
        b = np.asarray(b)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _cs_states(frames, rects):
    js = _stack([jcs.init_tracker(jnp.asarray(f), jnp.asarray(r))
                 for f, r in zip(frames, rects)])
    ts = tcs.init_tracker(torch.as_tensor(frames), torch.as_tensor(rects))
    return js, ts


def _cs_leaves(state):
    return [v.numpy() for v in state if v is not None]


def test_make_step_takes_with_pdf_fifth():
    """make_step(cascade, config, shape, "full", True): the fifth
    positional is with_pdf, as in the reference.  One "full" step over a WB,
    a VJ and two CS streams equals jax.vmap of the reference's step with the
    same arguments, the pdf included."""
    rng = np.random.default_rng(24)
    f = _blob_frames(4, rng)
    rect = np.asarray([[20, 12, 24, 24]] * 2, np.int32)
    js1 = jft.init_state()
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (4,) + x.shape).copy(), js1)
    hand, _ = _cs_states(f[2:], rect)
    cs = jax.tree_util.tree_map(lambda b, x: b.at[2:].set(x), jstate.cs,
                                hand)
    jstate = jstate._replace(cs=cs, mode=jnp.asarray([0, 1, 2, 2], jnp.int32))
    jstep = jax.jit(jax.vmap(jft.make_step(
        j_toy(), JConfig(histKernel="pallas"), (H, W), "full", True)))
    tstep = tft.make_step(toy_cascade(), TrackerConfig(histKernel="pallas"),
                          (H, W), "full", True, device="cpu")
    tstate = convert.state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)],
        device="cpu")
    jstate, jout, jpdf = jstep(jstate, jnp.asarray(f))
    tstate, tout, tpdf = tstep(tstate, torch.as_tensor(f))
    assert tpdf.shape == (4, H, W) and float(tpdf[2:].sum()) > 0
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    for name, a, b in zip(tft.StepOutput._fields, jout, tout):
        if name != "escaped":  # the serving tick's field, filled there
            _assert_tree([b.numpy()], [a])
    _assert_tree(convert.state_to_numpy(tstate),
                 jax.tree_util.tree_leaves(jstate))


def test_camshift_takes_the_reference_parameters():
    """track(s, f, True, False) and track_band(s, f, True, False, band) by
    position (exact fourth, band fifth), and the other reference keywords,
    equal jax.vmap of the reference's functions: windows and sizes exact,
    angles by F11's rule against the oracle."""
    rng = np.random.default_rng(25)
    f0 = _blob_frames(3, rng)
    f1 = np.roll(f0, (2, 3), axis=(1, 2))
    rects = np.asarray([[10, 8, 30, 28], [20, 12, 24, 24], [4, 4, 40, 36]],
                       np.int32)
    js, ts = _cs_states(f0, rects)
    oracles = [CamshiftTracker() for _ in rects]
    for o, f, r in zip(oracles, f0, rects):
        o.init_tracker(f, tuple(int(v) for v in r))
    angles = [o.track(f)["angle"] for o, f in zip(oracles, f1)]
    band = (40, 56)

    def rows(tree, keep):
        return [jax.tree_util.tree_map(lambda x: x[i], tree) for i in keep]

    jnew, jpdf = jax.vmap(lambda s, f: jcs.track(s, f, True, False))(
        js, jnp.asarray(f1))
    tnew, tpdf = tcs.track(ts, torch.as_tensor(f1), True, False, None, None)
    _check(rows(jnew, range(3)), tnew, angles)
    np.testing.assert_array_equal(tpdf.numpy(), np.asarray(jpdf))
    jb, jesc = jax.vmap(lambda s, f: jcs.track_band(
        s, f, True, False, band, None, "pallas", False))(js, jnp.asarray(f1))
    tb, tesc = tcs.track_band(ts, torch.as_tensor(f1), True, False, band,
                              None, "pallas", False)
    assert tesc.tolist() == np.asarray(jesc).tolist()
    keep = np.nonzero(~tesc.numpy())[0]
    assert keep.size
    _check(rows(jb, keep), tft.tree_index(tb, torch.as_tensor(keep)),
           [angles[i] for i in keep])
    step = tcs.camshift_step(ts, frame_rgb=torch.as_tensor(f1), exact=True)
    _check(rows(jnew, range(3)), step, angles)
    again = tcs.init_tracker(torch.as_tensor(f0), torch.as_tensor(rects), 0,
                             None)
    _assert_tree(_cs_leaves(again), _cs_leaves(ts))


def test_shard_streams_takes_axis_name():
    """shard_streams(tree, mesh, axis_name) places the same slices as the
    reference's on its 8 virtual CPU devices; an axis the mesh lacks raises
    on both sides."""
    x = np.random.default_rng(26).integers(0, 100, (16, 3)).astype(np.int32)
    jm = jmesh.stream_mesh(jax.devices()[:8], axis_name="s")
    want = sorted((s.index[0].start, np.asarray(s.data)) for s in
                  jmesh.shard_streams(jnp.asarray(x), jm,
                                      "s").addressable_shards)
    tm = tmesh.stream_mesh(["cpu"] * 8, axis_name="s")
    got = tmesh.shard_streams(torch.as_tensor(x), tm, "s")
    assert len(got) == len(want) == 8
    for g, (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        jmesh.shard_streams(jnp.asarray(x), jm, axis_name="streams")
    with pytest.raises(ValueError, match="axis"):
        tmesh.shard_streams(torch.as_tensor(x), tm, axis_name="streams")


def _gray_square():
    g = np.full((H, W), 40, np.uint8)
    g[12:36, 20:44] = 220
    return g


def test_detector_takes_a_cascade():
    """detect_best(gray, toy_cascade()) and the reference's keywords
    (interval, k_cand, k1, k2) equal the reference's detect_best on a
    bright square; a DetectorTables of another interval raises."""
    g = _gray_square()
    want = jax.jit(lambda x: jd.detect_best(x, j_toy()))(jnp.asarray(g))
    tg = torch.as_tensor(g)[None]
    got = td.detect_best(tg, toy_cascade())
    assert bool(want[0]) and got[0].tolist() == [True]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), [np.asarray(b)], rtol=1e-6)
    again = td.detect_best(tg, toy_cascade(), interval=5, min_neighbors=1,
                           k_cand=256, k1=4096, k2=512)
    tables = td.detector_tables(W, H, toy_cascade(), 5, "cpu")
    for a, b, c in zip(got, again, td.detect_best(tg, tables, 5, 1)):
        assert torch.equal(a, b) and torch.equal(a, c)
    cand = td.detect_candidates(tg, toy_cascade(), 5, k_cand=4)
    assert cand["valid"].shape == (1, 4)
    with pytest.raises(ValueError, match="interval"):
        td.detect_objects_padded(tg, tables, 3)


def test_mean_shift_returns_the_reference_three():
    """models.camshift.mean_shift(pdf, window, exact) over full-frame pdfs:
    windows and zero-mass bit-equal to jax.vmap of the reference's, the
    moments within 1e-5; a pdf with no mass in its window is zero-mass."""
    rng = np.random.default_rng(28)
    pdf = rng.random((2, 24, 32)).astype(np.float32)
    pdf[1, :12] = 0.0
    win = np.asarray([[4, 3, 12, 10], [9, 0, 10, 6]], np.int32)
    jwin, jm, jzero = jax.vmap(lambda p, w: jcs.mean_shift(p, w, False))(
        jnp.asarray(pdf), jnp.asarray(win))
    twin, tm, tzero = tcs.mean_shift(torch.as_tensor(pdf),
                                     torch.as_tensor(win), False)
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(tzero.numpy(), np.asarray(jzero))
    assert tzero.tolist() == [False, True]
    for k in ("m00", "m10", "m01", "m11", "m20", "m02"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, err_msg=k)


def test_handoff_band_audit_takes_bins():
    """handoff_band_audit(bins, model_hist, rect, band) on (N, H, W) i32
    bins equals jax.vmap of the reference's, and the frames route of
    init_tracker gives the same flags."""
    rng = np.random.default_rng(29)
    f = rng.integers(20, 60, (4, H, W, 3), np.uint8)
    f[:, 12:36, 20:44] = (230, 80, 60)
    f[1, 2:5, 60:63] = (230, 80, 60)    # the model's color far from the box
    # inside the square; the same; the square with the noise around it
    rects = np.asarray([[22, 14, 20, 20]] * 2 + [[16, 8, 32, 32]] * 2,
                       np.int32)
    tf, tr = torch.as_tensor(f), torch.as_tensor(rects)
    model = thg.histogram_rects(tf, tr)
    band = (32, 40)
    bins = thg.rgb_bins(tf)
    got = tcs.handoff_band_audit(bins, model, tr, band)
    want = jax.vmap(lambda b, m, r: jcs.handoff_band_audit(b, m, r, band))(
        jhg.rgb_bins(jnp.asarray(f)), jnp.asarray(model.numpy()),
        jnp.asarray(rects))
    assert got.tolist() == np.asarray(want).tolist() == [False, True, True,
                                                         True]
    st = tcs.init_tracker(tf, tr, audit_band=band)
    assert st.band_dirty.tolist() == got.tolist()


def test_init_state_order_and_device(monkeypatch):
    """init_state(n, whitebalancing, sparse_k, band_audit, device=...) and
    camshift.init_state(n, sparse_k, band_audit, device=...) equal the
    reference's states stacked n times; a device in whitebalancing's place
    raises TypeError; with no card a None device raises, cascade_to_torch's
    too."""
    want = jft.init_state(False, 0, True)
    got = tft.init_state(3, False, 0, True, device="cpu")
    _assert_tree(convert.state_to_numpy(got),
                 [np.broadcast_to(np.asarray(x), (3,) + np.shape(x))
                  for x in jax.tree_util.tree_leaves(want)])
    cs = tcs.init_state(3, 0, True, device="cpu")
    _assert_tree(_cs_leaves(cs), [np.broadcast_to(np.asarray(x), (3,) +
                                                  np.shape(x))
                                  for x in jcs.init_state(0, True)
                                  if x is not None])
    with pytest.raises(TypeError, match="whitebalancing"):
        tft.init_state(2, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tcs.init_state(2), lambda: tft.init_state(2),
                 lambda: cascade_to_torch(toy_cascade())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("lead", [(), (3,)])
def test_hist_pallas_pdf_pallas_equal_reference(lead):
    """kernels.hist_pallas/pdf_pallas on 24x32 bins, ids below 0 and from
    4096 up among them, equal the reference's Pallas kernels (interpret mode
    on the CPU) frame by frame, bit for bit: such an id counts nowhere and
    looks up 0."""
    rng = np.random.default_rng(30)
    n = lead[0] if lead else 1
    bins = rng.integers(0, 4096, (n, 24, 32)).astype(np.int32)
    bins[:, 0, :5] = [-1, -64, 4096, 4200, 1 << 20]
    weights = rng.random((n, 4096)).astype(np.float32)
    want_h = np.stack([np.asarray(jk.hist_pallas(jnp.asarray(b)))
                       for b in bins])
    want_p = np.stack([np.asarray(jk.pdf_pallas(jnp.asarray(b),
                                                jnp.asarray(w)))
                       for b, w in zip(bins, weights)])
    tb, tw = torch.as_tensor(bins), torch.as_tensor(weights)
    if not lead:
        tb, tw, want_h, want_p = tb[0], tw[0], want_h[0], want_p[0]
    h = tk.hist_pallas(tb, block=128)
    p = tk.pdf_pallas(tb, tw, 128)
    assert h.dtype == p.dtype == torch.float32
    np.testing.assert_array_equal(h.numpy(), want_h)
    np.testing.assert_array_equal(p.numpy(), want_p)
    assert (p.numpy()[..., 0, :5] == 0).all()
    assert h.numpy().sum() == n * (24 * 32 - 5)
