"""repro_torch's certified quantiles against repro's: twins of every test
in tests/test_quantile.py, on reference plans carried across with
``plan_from_numpy`` (and the reference index carried into the port's
``DynamicEngine`` with ``index_from_numpy``).

Port answers agree with the reference's (answer, lo, hi) at
rtol = atol = 1e-9, and every certificate brackets the exact quantile
computed with numpy: COUNT against every ``numpy.quantile`` interpolation
method, SUM against the weighted convention x* = min{k : F(k) >= q *
total}.  The plain version of kernel K4 (``quantile_invert_plain``) is held
to ``quantile_invert_pallas`` in interpret mode for deg 1-5, and a torch
transcription of K4's gather kernel (three lanes a target, one inversion a
lane, the snap by the strict descent of the key grid's search tree) to the
plain version bit for bit; the kernel itself is held to the plain version
on the card by tests/test_torch_cuda.py.
"""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d  # noqa: E402
from repro.core.quantile import boundary_array as r_boundary  # noqa: E402
from repro.engine import DynamicEngine as RDynamicEngine  # noqa: E402
from repro.engine import build_plan, execute_quantile as r_quantile  # noqa: E402
from repro.kernels.quantile_invert import quantile_invert_pallas  # noqa: E402
from repro_torch.core import (boundary_array, index_from_numpy,  # noqa: E402
                              rank_slack)
from repro_torch.engine import (DynamicEngine, Engine,  # noqa: E402
                                execute_quantile)
from repro_torch.engine.plan import (ARRAY_FIELDS, META_FIELDS,  # noqa: E402
                                     big_sentinel, pad_to_multiple,
                                     plan_from_numpy)
from repro_torch.core.poly import horner  # noqa: E402
from repro_torch.core.quantile import _extreme_root, _unscale  # noqa: E402
from repro_torch.kernels.locate import (bsearch_count, search_tree,  # noqa: E402
                                        tree_count_left)
from repro_torch.kernels.quantile_invert import (  # noqa: E402
    quantile_invert, quantile_invert_plain)

QS = np.array([0.01, 0.25, 0.5, 0.75, 0.99])
METHODS = ("linear", "lower", "higher", "nearest", "midpoint")
TOL = dict(rtol=1e-9, atol=1e-9)
TWIN = {"torch": "xla", "ref": "ref"}   # port backend -> reference twin


def _dataset(name, n=2048, seed=5):
    rng = np.random.default_rng(seed)
    if name == "uniform":
        keys = rng.uniform(-50.0, 50.0, n)
    elif name == "skew":
        keys = rng.lognormal(mean=1.0, sigma=1.2, size=n)
    else:   # 'dups': heavy duplicate mass + a few unique outliers
        keys = np.concatenate([
            np.repeat(rng.uniform(0, 10, 8), n // 10),
            rng.uniform(-5, 15, n - 8 * (n // 10))])
    keys = np.sort(keys)
    vals = np.abs(rng.normal(2.0, 1.0, n)) + 0.1
    return keys, vals


def _carry(idx):
    """A reference index carried into the port (its fields as numpy)."""
    arr = lambda a: None if a is None else np.asarray(a)
    fields = {f: arr(getattr(idx, f)) for f in
              ("seg_lo", "seg_hi", "coeffs", "seg_start", "seg_agg", "st",
               "seg_err")}
    es, em = idx.exact_sum, idx.exact_max
    fields.update(agg=idx.agg, deg=idx.deg, delta=idx.delta, n=idx.n,
                  exact_sum=None if es is None else (arr(es.keys),
                                                     arr(es.cf)),
                  exact_max=None if em is None else (
                      arr(em.keys), arr(em.measures), arr(em.st)))
    return index_from_numpy(fields, "cpu")


def _port_plan(rplan):
    fields = {f: (None if getattr(rplan, f) is None
                  else np.asarray(getattr(rplan, f))) for f in ARRAY_FIELDS}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS})
    return plan_from_numpy(fields, "cpu")


@functools.lru_cache(maxsize=None)
def _plans(dist, agg, deg=2, delta=24.0):
    """(reference plan, port plan carried from it), built once per run."""
    keys, vals = _dataset(dist)
    idx = build_index_1d(keys, np.ones_like(keys) if agg == "count"
                         else vals, agg=agg, delta=delta, deg=deg,
                         keep_exact=True)
    rplan = build_plan(idx)
    return rplan, _port_plan(rplan)


def _assert_same(got, want):
    for name, g, w in zip(("answer", "lo", "hi"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def _check_count_brackets(keys, lo, hi, qs=QS):
    for m in METHODS:
        truth = np.quantile(keys, qs, method=m)
        assert np.all(np.asarray(lo) <= truth + 1e-12), (m, lo, truth)
        assert np.all(truth <= np.asarray(hi) + 1e-12), (m, truth, hi)


def _weighted_truth(keys, w, q):
    cf = np.cumsum(w)
    i = np.minimum(np.searchsorted(cf, q * cf[-1], side="left"),
                   len(keys) - 1)
    return keys[i]


def _check_inside(res):
    assert np.all(res.lo.numpy() <= res.answer.numpy())
    assert np.all(res.answer.numpy() <= res.hi.numpy())


# ---------------------------------------------------------------------------
# twins of tests/test_quantile.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["uniform", "skew", "dups"])
def test_count_certificate_brackets_every_numpy_method(dist):
    keys, _ = _dataset(dist)
    rplan, plan = _plans(dist, "count")
    res = execute_quantile(plan, QS)
    _assert_same(res, r_quantile(rplan, QS))
    _check_count_brackets(keys, res.lo, res.hi)
    _check_inside(res)


@pytest.mark.parametrize("dist", ["uniform", "skew", "dups"])
def test_sum_certificate_brackets_weighted_convention(dist):
    keys, vals = _dataset(dist)
    rplan, plan = _plans(dist, "sum")
    res = execute_quantile(plan, QS)
    _assert_same(res, r_quantile(rplan, QS))
    truth = _weighted_truth(keys, vals, QS)
    assert np.all(res.lo.numpy() <= truth + 1e-12)
    assert np.all(truth <= res.hi.numpy() + 1e-12)


@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_backends_bracket_and_agree(backend):
    keys, _ = _dataset("uniform")
    rplan, plan = _plans("uniform", "count")
    res = execute_quantile(plan, QS, backend=backend)
    _check_count_brackets(keys, res.lo, res.hi)
    _assert_same(res, r_quantile(rplan, QS, backend=TWIN[backend]))
    # the locate->solve arithmetic is identical on every backend, and the
    # Engine shim routes through the same executor
    base = execute_quantile(plan, QS, backend="torch")
    shim = Engine(backend=backend).quantile(plan, QS)
    for a, b, c in zip(res, base, shim):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(c, a, rtol=0, atol=0)


@pytest.mark.parametrize("deg", [1, 3, 5])
def test_higher_degree_certificates(deg):
    keys, _ = _dataset("skew")
    rplan, plan = _plans("skew", "count", deg=deg)
    res = execute_quantile(plan, QS)
    _assert_same(res, r_quantile(rplan, QS))
    _check_count_brackets(keys, res.lo, res.hi)


@functools.lru_cache(maxsize=None)
def _dyn_index(agg):
    keys, vals = _dataset("uniform", seed=9)
    return keys, vals, build_index_1d(
        keys, np.ones_like(keys) if agg == "count" else vals, agg=agg,
        delta=24.0, deg=2, keep_exact=True)


def _dyn_pair(agg):
    """(keys, vals, reference engine, port engine) over one index; every
    pair shares the buffer shape, so the reference compiles once."""
    keys, vals, idx = _dyn_index(agg)
    kw = dict(capacity=512, auto_refit=False, background=False)
    return keys, vals, RDynamicEngine(idx, **kw), DynamicEngine(_carry(idx),
                                                                **kw)


@pytest.mark.parametrize("agg", ["count", "sum"])
def test_dynamic_post_insert_delete(agg):
    keys, vals, ref, eng = _dyn_pair(agg)
    rng = np.random.default_rng(3)
    # inserts straddle the fitted domain on both sides (the certificate
    # must stay sound past the base plan's key range)
    ins_k = np.concatenate([rng.uniform(-90, -60, 40),
                            rng.uniform(-40, 40, 120),
                            rng.uniform(70, 120, 40)])
    ins_v = np.abs(rng.normal(2.0, 1.0, ins_k.shape[0])) + 0.1
    drop = rng.choice(len(keys), size=150, replace=False)
    for e in (ref, eng):
        if agg == "count":
            e.insert(ins_k)
        else:
            e.insert(ins_k, ins_v)
        e.delete(keys[drop])

    res = eng.quantile(QS)
    _assert_same(res, ref.quantile(QS))
    live_mask = np.ones(len(keys), bool)
    live_mask[drop] = False
    lk = np.concatenate([keys[live_mask], ins_k])
    if agg == "count":
        _check_count_brackets(lk, res.lo, res.hi)
    else:
        lv = np.concatenate([vals[live_mask], ins_v])
        order = np.argsort(lk, kind="stable")
        truth = _weighted_truth(lk[order], lv[order], QS)
        assert np.all(res.lo.numpy() <= truth + 1e-12)
        assert np.all(truth <= res.hi.numpy() + 1e-12)
    _check_inside(res)


def test_extreme_ranks_clip_to_domain():
    keys, _ = _dataset("uniform")
    rplan, plan = _plans("uniform", "count")
    qs = np.array([0.0, 1.0])
    res = execute_quantile(plan, qs)
    _assert_same(res, r_quantile(rplan, qs))
    assert res.lo[0] <= keys[0] <= res.hi[0]
    assert res.lo[1] <= keys[-1] <= res.hi[1]


def test_rejects_extremal_and_deg0_plans():
    keys, vals = _dataset("uniform", n=512)
    idx = build_index_1d(keys, vals, agg="max", delta=24.0, deg=3,
                         keep_exact=True)
    with pytest.raises(ValueError, match="sum/count"):
        execute_quantile(_port_plan(build_plan(idx)), QS)
    with pytest.raises(ValueError, match="does not answer"):
        DynamicEngine(_carry(idx), capacity=64).quantile(QS)


# ---------------------------------------------------------------------------
# the plain version of K4 against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

# the reference tests' fractions, the rank ends, and a 65-point grid
FRACTIONS = np.concatenate([QS, [0.0, 1.0], np.linspace(0.0, 1.0, 65)])


def _kernel_args(rplan, agg, fractions):
    """The reference executor's K4 inputs, from the reference plan (as
    numpy): targets, slack-shifted targets, B, padded key grid."""
    dt = np.float64
    M = float(rplan.n) if agg == "count" else float(rplan.ref_cf[-1])
    slack = float(rank_slack(agg, torch.tensor(M)))
    t = np.clip(fractions, 0.0, 1.0) * M
    B = np.array(r_boundary(rplan.coeffs))
    keys = pad_to_multiple(torch.as_tensor(np.array(rplan.ref_keys)), 128,
                           big_sentinel(torch.float64)).numpy()
    err = np.array(rplan.seg_err)
    tabs = [np.array(a, dt) for a in (rplan.seg_lo, rplan.seg_hi,
                                      rplan.coeffs)]
    return (t, t - slack, t + slack, B, *tabs, err, keys)


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_quantile_invert_plain_matches_pallas(agg, deg):
    rplan, plan = _plans("skew", agg, deg=deg)
    args = _kernel_args(rplan, agg, FRACTIONS)
    Q = len(FRACTIONS)
    pad = (-Q) % 128          # the Pallas kernel takes whole 128-row blocks
    padded = [np.concatenate([a, np.full(pad, a[-1])]) for a in args[:3]]
    kw = dict(h=rplan.h, n=rplan.n, delta=float(rplan.delta))
    want = quantile_invert_pallas(*(jnp.asarray(a) for a in padded),
                                  *(jnp.asarray(a) for a in args[3:]),
                                  bq=128, interpret=True, **kw)
    targs = [torch.as_tensor(a) for a in args]
    # the boundary array the port computes is the reference's
    torch.testing.assert_close(boundary_array(plan.coeffs), targs[3],
                               rtol=0, atol=0)
    got = quantile_invert_plain(*targs, **kw)
    _assert_same(got, [np.asarray(w)[:Q] for w in want])
    # the wrapper runs the plain version on CPU tensors, counting nothing
    before = quantile_invert.launches
    for a, b in zip(quantile_invert(*targs, **kw), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert quantile_invert.launches == before


@pytest.mark.parametrize("deg", [3, 5])
def test_many_fractions_keep_certificates_and_parity(deg):
    """20,000 random fractions on the duplicate-heavy COUNT plan: answer,
    lo and hi agree with the reference at 1e-9 (a closed-form and a Newton
    degree: the Newton steps round as the reference's fused multiply-adds
    do), and every certificate brackets numpy's quantiles."""
    keys, _ = _dataset("dups")
    rplan, plan = _plans("dups", "count", deg=deg)
    qs = np.random.default_rng(1).uniform(0.0, 1.0, 20_000)
    res = execute_quantile(plan, qs)
    want = r_quantile(rplan, qs)
    for name, g, w in zip(("answer", "lo", "hi"), res, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    _check_count_brackets(keys, res.lo, res.hi, qs)
    # lo is an unsnapped root and hi a snapped key: where both land on the
    # same key, lo may sit ulps above hi (the reference's too: 2 of these
    # lanes at deg 3, by 2.2e-16), and the answer is then hi
    assert np.all(res.answer.numpy() <= res.hi.numpy())
    assert np.all(res.lo.numpy() <= res.answer.numpy() + 1e-12)


def _k4_lanes(t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs, seg_err,
              ref_keys, tree, *, h, n, delta):
    """torch transcription of K4's gather kernel as csrc/quantile.cu runs
    it: lane e of each group of three in a warp (ten groups, two spare
    lanes) runs side e (0 hi, 1 lo, 2 mid) of target 10 warp + group,
    lanes past Q and the spare ones redoing the last target.  Each lane
    counts its key over B by the binary search with the side picked per
    lane, inverts its segment (invert_side: the largest or the smallest
    root by the sign picked per lane, Newton for mid above deg 3, the
    segment's end or the one below for hi and lo above deg 3); the hi lane
    snaps to the key grid by the strict descent of ``tree`` over the n live
    keys; the mid lane takes the hi and lo lanes' ends (the shuffles) and
    clips.  Returns the triple and the hi lanes' points before the snap."""
    Q, deg = t_mid.shape[0], coeffs.shape[1] - 1
    lanes = -(-Q // 10) * 32
    lane = torch.arange(lanes) % 32
    g, side = lane // 3, lane % 3
    tgt = torch.arange(lanes) // 32 * 10 + g
    i = torch.clamp(tgt, max=Q - 1)
    t = torch.where(side == 0, t_hi[i], torch.where(side == 1, t_lo[i],
                                                    t_mid[i]))
    key = torch.where(side == 0, t + delta,
                      torch.where(side == 1, t - delta, t))
    cnt = torch.where(side == 1, bsearch_count(B, key, side="right"),
                      bsearch_count(B, key, side="left"))
    s = torch.clamp(cnt, max=h - 1).long()
    lo, hi = seg_lo[s], seg_hi[s]
    below = torch.where(s > 0, seg_hi[torch.clamp(s - 1, min=0)], seg_lo[0])
    c = coeffs[s]
    T = torch.where(side == 2, t, torch.where(side == 0, t + seg_err[s],
                                              t - seg_err[s]))
    r_max, f_max = _extreme_root(c, T, "max")
    r_min, f_min = _extreme_root(c, T, "min")
    root = torch.where(side == 1, r_min, r_max)
    found = torch.where(side == 1, f_min, f_max)
    x = _unscale(torch.where(found, root, torch.where(side == 1, 1.0, -1.0)),
                 lo, hi)
    tiny = 1e-9 * (torch.abs(T) + 1.0)
    start_ok = horner(c, torch.full_like(t, -1.0)) <= T + tiny
    x = torch.where((side == 1) & ~start_ok, below, x)
    if deg > 3:
        x = torch.where(side == 0, hi, torch.where(side == 1, below, x))
    point = x
    b_top, dom_hi = B[h - 1], seg_hi[h - 1]
    k = torch.clamp(tree_count_left(ref_keys[:n], tree, x), max=n - 1).long()
    snapped = torch.where(t + delta <= b_top, ref_keys[k], dom_hi)
    x = torch.where(side == 0, snapped, x)
    first = torch.arange(lanes) - side
    x_hi, x_lo = x[first], x[first + 1]
    mid = torch.clamp(torch.where(t <= b_top, x, dom_hi), x_lo, x_hi)
    out = torch.full((3, Q), torch.nan, dtype=t_mid.dtype)
    for e, v in ((2, mid), (1, x), (0, x)):
        w = (side == e) & (tgt < Q) & (g < 10)
        out[{2: 0, 1: 1, 0: 2}[e], i[w]] = v[w]
    return out, point[side == 0]


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_k4_lane_form_matches_plain(agg, deg):
    """K4's lane form (_k4_lanes) equals the plain K4 bit for bit (NaN as
    NaN) on the COUNT and SUM plans at deg 1-5, at the fractions 0 and 1, a
    fine grid and the module's, and at targets past the mass and below 0,
    at a count that leaves the last warp part empty.  Its snap counts the
    n live keys by the strict descent of their tree: for every hi lane's
    point (a root or a segment's end, below the sentinel) that count equals
    the binary search's over the 128-padded grid, so after the clamp to
    n - 1 the same key is read."""
    rplan, plan = _plans("skew", agg, deg=deg)
    fr = np.concatenate([FRACTIONS, np.linspace(0.0, 1.0, 1025)])
    args = [torch.as_tensor(a) for a in _kernel_args(rplan, agg, fr)]
    M = float(rplan.n) if agg == "count" else float(rplan.ref_cf[-1])
    slack = float(args[2][0] - args[0][0])
    extra = torch.tensor([M * 1.01, M + 3.0, M * 3.0, -3.0, M - 0.5])
    for j, shift in enumerate((0.0, -slack, slack)):
        args[j] = torch.cat([args[j], extra + shift])
    keys = args[8]
    n = int(rplan.n)
    tree = search_tree(keys[:n].clone())
    kw = dict(h=int(rplan.h), n=n, delta=float(rplan.delta))
    got, points = _k4_lanes(*args, tree, **kw)
    want = quantile_invert_plain(*args, tree, **kw)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g[~torch.isnan(g)].view(torch.int64),
                           w[~torch.isnan(w)].view(torch.int64))
    # the snap's count on these points, NaN and -inf too, over the live
    # keys of this grid and of a grid whose live keys leave a padded tail
    big = big_sentinel(torch.float64)
    assert bool((points < big).all())
    pts = torch.cat([points, torch.tensor([np.nan, -np.inf])])
    for m in (n, n - 37):
        grid = pad_to_multiple(keys[:m].clone(), 128, big)
        live = tree_count_left(keys[:m], search_tree(keys[:m].clone()), pts)
        assert torch.equal(live, bsearch_count(grid, pts, side="left"))
        assert grid.shape[0] == (n if m == n else -(-m // 128) * 128)


# ---------------------------------------------------------------------------
# the dynamic quantile against the reference engine, op for op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["count", "sum"])
def test_dynamic_quantile_op_for_op(agg):
    """The same seeded sequence of inserts, deletes, quantile reads and a
    flush to both engines: every read agrees at 1e-9, before and after the
    merge."""
    keys, vals, ref, eng = _dyn_pair(agg)
    rng = np.random.default_rng(21)
    qs = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, 61)])
    alive = np.ones(len(keys), bool)

    def step(n_ins, n_del):
        ins_k = rng.uniform(-70, 70, n_ins)
        ins_v = rng.uniform(0.5, 3.0, n_ins)
        drop = rng.choice(np.flatnonzero(alive), n_del, replace=False)
        alive[drop] = False
        for e in (ref, eng):
            if agg == "count":
                e.insert(ins_k)
            else:
                e.insert(ins_k, ins_v)
            e.delete(keys[drop])

    _assert_same(eng.quantile(qs), ref.quantile(qs))
    for n_ins, n_del in ((40, 10), (1, 0), (0, 30)):
        step(n_ins, n_del)
        res = eng.quantile(qs)
        _assert_same(res, ref.quantile(qs))
        _check_inside(res)
    ref.flush()
    eng.flush()
    assert eng.refit_count == ref.refit_count == 1
    _assert_same(eng.quantile(qs), ref.quantile(qs))
    step(25, 5)
    _assert_same(eng.quantile(qs), ref.quantile(qs))


# ---------------------------------------------------------------------------
# the Newton branch rounds as the reference's fused multiply-adds do
# ---------------------------------------------------------------------------

def test_horner_fma_matches_jitted_reference_horner():
    """XLA on the CPU contracts the reference's Horner steps into fused
    multiply-adds; the port's ``horner_fma`` emulates them with plain
    float64 ops and equals the jitted reference bit for bit on random
    degree-5 inputs."""
    from repro.core.poly import horner as r_horner
    from repro_torch.core.poly import horner_fma

    rng = np.random.default_rng(3)
    c = rng.normal(0.0, 1.0, (50_000, 6)) * 10.0 ** rng.uniform(-3, 3,
                                                              (50_000, 1))
    u = rng.uniform(-1.0, 1.0, 50_000)
    want = np.asarray(jax.jit(r_horner)(jnp.asarray(c), jnp.asarray(u)))
    got = horner_fma(torch.as_tensor(c), torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dist", ["uniform", "dups"])
@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("deg", [4, 5])
def test_newton_degrees_match_reference_in_every_lane(dist, agg, deg):
    """The inputs that showed the fault (n 2,048, seed 5, delta 24, 20,000
    fractions from default_rng(1)): at the Newton degrees the answer, lo
    and hi agree with the reference at 1e-9 in every lane."""
    rplan, plan = _plans(dist, agg, deg=deg)
    qs = np.random.default_rng(1).uniform(0.0, 1.0, 20_000)
    res = execute_quantile(plan, qs)
    want = r_quantile(rplan, qs)
    for name, g, w in zip(("answer", "lo", "hi"), res, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_port_imports_neither_jax_nor_the_reference():
    """Every repro_torch module imports in a fresh interpreter with neither
    ``jax`` nor ``repro`` loaded."""
    import os
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 20, names\n"
        "print(len(names))\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
