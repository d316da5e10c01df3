"""The two-key whole-log scans of the ``cuda_scan`` backend (K18-K20) and
the leaf-table scan K13 on the CPU, where their wrappers run the plain
versions.

* The plain K18 (``delta_count2d``), K19 (``delta_sum2d``) and K20
  (``delta_dommax2d``) against ``delta_count2d_pallas``,
  ``delta_sum2d_pallas`` and ``delta_dommax2d_pallas`` in interpret mode at
  log fills {0, 1, 2, cap}, inverted rectangles kept: K18 and K20 exactly,
  K19 within 1e-12 x the log's sum of |measure| (the Pallas tiles add
  their one-hot products in another order than K19's slot order).  The
  same against the dense oracles of ``kernels/ref.py`` (the same bars) and
  against the merge-sort-tree twins K9-K11 on the same log: counts and
  maxima exactly, sums at rtol = atol = 1e-9 (K10 differences prefix
  sums), on rectangles that are not inverted (K9's and K10's inclusion-
  exclusion is signed there).  K20 keeps a NaN measure as ``jnp.max``
  does, and on a negative-measure log gives the padding's 0 to corners at
  and above the sentinel, as the Pallas kernel does; a torch transcription
  of K20's walk (it stops at the sentinel tail and folds that 0 back in)
  equals the plain K20 on such logs.  A torch transcription of K19's walk
  (each rectangle's x range ranked to slots [a, b) of the x-sorted log, cut
  at the sentinel tail, the block's rectangles bucketed by a, each warp
  walking the union of its ranges) equals the plain K19, which tests every
  slot's x, bit for bit on insert and delete logs of 0 to 4,096 points and
  on the edge lanes of the ranks; K18's (the same walk, each warp's union
  in two parts, the tail's sentinel slots counted without a walk) equals
  the plain K18 on the same logs and lanes.
* A torch transcription of K13's walk (the leaf table in chunks of tiles
  that stop at its sentinel tail, any hit kept, the lowest leaf over the
  chunks, then the row) equals the plain K13 bit for bit on the port's
  static, depth-16 and refit leaf tables.
* ``DynamicEngine2D`` on ``cuda_scan`` against the reference's
  ``DynamicEngine2D(backend="pallas_scan")`` op for op (inserts, deletes,
  shadowed victims on MIN, a flush, more updates; COUNT, SUM and MIN
  tables; Q_abs and Q_rel): answers and raw answers at rtol = atol = 1e-9
  with equal refined flags; against the port's own ``cuda`` route (K9-K11
  through their plain versions) bit for bit on COUNT and MIN, at 1e-9 on
  SUM.  The card backends refuse CPU plans, so ``card_route`` lifts that
  check (as in tests/test_torch_scan.py) and every wrapper runs its plain
  version.  The ``cuda_scan`` buffer builds no merge-sort-tree levels.
* A session's dynamic two-key table on ``cuda_scan`` builds and answers
  as the reference session on ``pallas_scan`` does (1e-9, refined flags
  equal).

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

import repro.api as rapi  # noqa: E402
from repro.core import build_index_2d as r_build  # noqa: E402
from repro.engine import DynamicEngine2D as RDyn  # noqa: E402
from repro.kernels.delta_scan import (delta_count2d_pallas,  # noqa: E402
                                      delta_dommax2d_pallas,
                                      delta_sum2d_pallas)
import repro_torch.api as tapi  # noqa: E402
from repro_torch.api import session as ses_mod  # noqa: E402
from repro_torch.core import build_index_2d as t_build_2d  # noqa: E402
from repro_torch.core import index2d_from_numpy  # noqa: E402
from repro_torch.core.index2d import bivariate_horner  # noqa: E402
from repro_torch.data import osm_points  # noqa: E402
from repro_torch.engine import DeltaBuffer2D, DynamicEngine2D  # noqa: E402
from repro_torch.engine import build_plan_2d as t_build_plan_2d  # noqa: E402
from repro_torch.engine import dynamic as dyn_mod  # noqa: E402
from repro_torch.engine import engine as eng  # noqa: E402
from repro_torch.engine import lsm as lsm_mod  # noqa: E402
from repro_torch.engine import window as win_mod  # noqa: E402
from repro_torch.engine.dynamic import _append_2d  # noqa: E402
from repro_torch.engine.plan import big_sentinel  # noqa: E402
from repro_torch.kernels import delta_scan as kd  # noqa: E402
from repro_torch.kernels import leaf_eval2d as k2d  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)
CAP = 128
BQ = 128


@pytest.fixture
def card_route(monkeypatch):
    """Let the card backends run CPU plans (engines and sessions): every
    kernel wrapper then takes its plain version, as it does on CPU
    tensors, and the dispatch under test is the card's."""
    lift = lambda backend, device: ("torch" if backend is None else backend)
    for mod in (eng, dyn_mod, lsm_mod, win_mod, ses_mod):
        monkeypatch.setattr(mod, "resolve_backend", lift)


# ---------------------------------------------------------------------------
# the plain kernels against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _log(fill, seed):
    """A weighted, x-sorted CAP-slot point log of ``fill`` points (ties on
    both axes) built by the port's append, with its merge-sort-tree levels
    (for K9-K11), and the points."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 20, fill), 1)
    y = np.round(rng.uniform(0, 20, fill), 1)
    w = rng.normal(50, 10, fill)
    e = DeltaBuffer2D.empty(CAP, weighted=True)
    log = _append_2d(e.ins_x, e.ins_y, e.ins_w, torch.as_tensor(x),
                     torch.as_tensor(y), torch.as_tensor(w), cap=CAP,
                     levels=True, weighted=True)
    return log, (x, y)


def _rects(pts, seed):
    """256 rectangles: 48 with corners on the points' own coordinates, 48
    around one point each, random ones, one around the whole log, one left
    of it, and eight inverted ones."""
    x, y = pts
    rng = np.random.default_rng(seed + 1)
    a, b, c, d = rng.uniform(-2, 22, (4, 256))
    if len(x):
        k = rng.integers(0, len(x), 48)
        a[:48], c[:48] = x[k], y[k]
        b[:48], d[:48] = x[k[::-1]], y[k[::-1]]
        k = rng.integers(0, len(x), 48)
        a[48:96], b[48:96] = x[k] - rng.uniform(0.01, 3, (2, 48))
        c[48:96], d[48:96] = y[k] - rng.uniform(0.01, 3, (2, 48))
        b[48:96] += 2 * (x[k] - b[48:96])
        d[48:96] += 2 * (y[k] - d[48:96])
    lx, ux = np.minimum(a, b), np.maximum(a, b)
    ly, uy = np.minimum(c, d), np.maximum(c, d)
    lx[-10:-8], ux[-10:-8] = [-1e300, -5.0], [1e300, -1.0]
    ly[-10:-8], uy[-10:-8] = [-1e300, -1e300], [1e300, 1e300]
    lx[-8:], ux[-8:] = ux[-8:], lx[-8:]          # inverted
    return lx, ux, ly, uy


@pytest.mark.parametrize("fill", [0, 1, 2, CAP])
def test_delta_2d_scan_plain_matches_pallas(fill):
    (gx, gy, gw, ylv, wcum, wpmax), pts = _log(fill, seed=fill)
    lx, ux, ly, uy = _rects(pts, seed=fill)
    tq = [torch.as_tensor(q) for q in (lx, ux, ly, uy)]
    jq = [jnp.asarray(q) for q in (lx, ux, ly, uy)]
    jx, jy, jw = (jnp.asarray(t.numpy()) for t in (gx, gy, gw))
    launches = lambda: (kd.delta_count2d.launches, kd.delta_sum2d.launches,
                        kd.delta_dommax2d.launches)
    before = launches()
    k18 = kd.delta_count2d(*tq, gx, gy)
    k19 = kd.delta_sum2d(*tq, gx, gy, gw)
    k20 = kd.delta_dommax2d(tq[1], tq[3], gx, gy, gw)
    assert launches() == before               # plain versions on the CPU
    torch.testing.assert_close(k18, kd.delta_count2d_plain(*tq, gx, gy),
                               rtol=0, atol=0)
    torch.testing.assert_close(k19, kd.delta_sum2d_plain(*tq, gx, gy, gw),
                               rtol=0, atol=0)
    torch.testing.assert_close(k20, kd.delta_dommax2d_plain(
        tq[1], tq[3], gx, gy, gw), rtol=0, atol=0)
    scale = 1e-12 * float(gw.abs().sum())
    want18 = delta_count2d_pallas(*jq, jx, jy, bq=BQ, interpret=True)
    want19 = delta_sum2d_pallas(*jq, jx, jy, jw, bq=BQ, interpret=True)
    want20 = delta_dommax2d_pallas(jq[1], jq[3], jx, jy, jw, bq=BQ,
                                   interpret=True)
    np.testing.assert_array_equal(k18.numpy(), np.asarray(want18))
    assert np.all(np.abs(k19.numpy() - np.asarray(want19)) <= scale)
    np.testing.assert_array_equal(k20.numpy(), np.asarray(want20))
    # the dense oracles the 'torch' and 'ref' backends run
    np.testing.assert_array_equal(
        k18.numpy(), tref.delta_count2d_ref(*tq, gx, gy).numpy())
    assert np.all(np.abs(k19.numpy() - tref.delta_sum2d_ref(
        *tq, gx, gy, gw).numpy()) <= scale)
    np.testing.assert_array_equal(
        k20.numpy(), tref.delta_dommax2d_ref(tq[1], tq[3], gx, gy,
                                             gw).numpy())
    # the merge-sort-tree twins K9-K11 on the same log
    ok = (lx <= ux) & (ly <= uy)
    np.testing.assert_array_equal(
        k18.numpy()[ok],
        kd.delta_count2d_gather_plain(*tq, gx, ylv).numpy()[ok])
    np.testing.assert_allclose(
        k19.numpy()[ok],
        kd.delta_sum2d_gather_plain(*tq, gx, ylv, wcum).numpy()[ok], **TOL)
    np.testing.assert_array_equal(
        k20.numpy(), kd.delta_dommax2d_gather_plain(tq[1], tq[3], gx, ylv,
                                                    wpmax).numpy())
    assert not k18.numpy()[~ok].any() and not k19.numpy()[~ok].any()
    if fill == 0:
        assert torch.isneginf(k20).all()
    else:
        assert float(k18[-10]) == fill   # the rectangle around every point
        assert k18[48:96].min() > 0 and torch.isfinite(k20).any()


def test_delta_dommax2d_plain_keeps_nan_as_pallas():
    """A NaN measure wins every corner that dominates it, as in jnp.max."""
    (gx, gy, gw, _, _, _), pts = _log(40, seed=7)
    gw = gw.clone()
    gw[11] = float("nan")
    _, ux, _, uy = _rects(pts, seed=7)
    got = kd.delta_dommax2d_plain(torch.as_tensor(ux), torch.as_tensor(uy),
                                  gx, gy, gw).numpy()
    want = np.asarray(delta_dommax2d_pallas(
        jnp.asarray(ux), jnp.asarray(uy), *(jnp.asarray(t.numpy())
                                            for t in (gx, gy, gw)),
        bq=BQ, interpret=True))
    np.testing.assert_array_equal(got, want)
    hit = (float(gx[11]) <= ux) & (float(gy[11]) <= uy)
    assert hit.any() and np.isnan(got[hit]).all()
    assert not np.isnan(got[~hit]).any()


def _min_log(fill, cap, seed):
    """An x-sorted ``cap``-slot point log of ``fill`` points with negative
    measures (a MIN table's, which runs negated), built by the port's
    append."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 20, fill), 1)
    y = np.round(rng.uniform(0, 20, fill), 1)
    w = -rng.uniform(1, 100, fill)
    e = DeltaBuffer2D.empty(cap, weighted=True)
    gx, gy, gw, *_ = _append_2d(e.ins_x, e.ins_y, e.ins_w, torch.as_tensor(x),
                                torch.as_tensor(y), torch.as_tensor(w),
                                cap=cap, levels=False, weighted=True)
    return gx, gy, gw


def _tail_corners(seed, n=120):
    """Corners over the log, and those at and above the sentinel (which
    dominate the log's padding), +-inf and NaN ones."""
    rng = np.random.default_rng(seed)
    big = big_sentinel(torch.float64)
    inf, nan = np.inf, np.nan
    u = np.concatenate([rng.uniform(-2, 22, n),
                        [inf, big, big, 2 * big, inf, 5.0, nan, inf, -inf,
                         big, 1e308, nan]])
    v = np.concatenate([rng.uniform(-2, 22, n),
                        [inf, big, inf, big, 5.0, inf, 5.0, nan, inf,
                         np.nextafter(big, 0), 1e308, nan]])
    return u, v


@pytest.mark.parametrize("fill", [0, 1, 37, CAP])
def test_delta_dommax2d_plain_matches_pallas_on_the_sentinel_tail(fill):
    """On a negative-measure log the padding's measure 0 is the max of
    every corner that dominates the sentinel: the plain K20 equals
    ``delta_dommax2d_pallas`` there and on the other corners, and gives 0
    at and above the sentinel wherever the log has padding."""
    gx, gy, gw = _min_log(fill, CAP, seed=fill + 3)
    u, v = _tail_corners(seed=fill)
    got = kd.delta_dommax2d_plain(torch.as_tensor(u), torch.as_tensor(v),
                                  gx, gy, gw).numpy()
    want = np.asarray(delta_dommax2d_pallas(
        jnp.asarray(u), jnp.asarray(v),
        *(jnp.asarray(t.numpy()) for t in (gx, gy, gw)), bq=len(u),
        interpret=True))
    np.testing.assert_array_equal(got, want)
    tail = got[-12:-8]
    assert (tail == 0).all() if fill < CAP else (tail < 0).all()
    assert np.isneginf(got[[-6, -5, -4, -1]]).all()


# K20's walk (csrc/scan2d.cu delta_dommax2d_kernel): kDomTile slots a tile,
# the log in up to kDomChunks interleaved chunks
K20_TILE, K20_CHUNKS = 1024, 4


def _k20_walk(u, v, kx, ky, w):
    """K20's formulation in torch: each chunk walks its tiles in slot order
    and stops at its first tile that starts on the sentinel; a tile with a
    NaN measure runs the NaN-propagating max, any other the compare-only
    step (w > acc, which never replaces a NaN acc); a chunk that skipped
    tiles gives a corner that dominates the sentinel the tail's 0; the
    chunks' maxima are taken in chunk order."""
    big = big_sentinel(torch.float64)
    D = kx.shape[0]
    tiles = -(-D // K20_TILE)
    S = max(1, min(K20_CHUNKS, tiles))
    out = None
    for c in range(S):
        acc = torch.full_like(u, -torch.inf)
        skipped = False
        for t in range(c, tiles, S):
            sl = slice(t * K20_TILE, (t + 1) * K20_TILE)
            x, y, m = kx[sl], ky[sl], w[sl]
            if x[0] == big:
                skipped = True
                break
            member = (x <= u[:, None]) & (y <= v[:, None])
            if torch.isnan(m).any():
                acc = torch.maximum(
                    acc, torch.where(member, m, -torch.inf).amax(dim=1))
            else:
                for j in range(x.shape[0]):
                    acc = torch.where(member[:, j] & (m[j] > acc), m[j], acc)
        if skipped:
            holds = (big <= u) & (big <= v)
            acc = torch.where(holds, torch.maximum(acc, torch.zeros_like(acc)),
                              acc)
        out = acc if out is None else torch.maximum(out, acc)
    return out


@pytest.mark.parametrize("fill,cap,with_nan", [(0, 4096, False),
                                               (1, 4096, True),
                                               (1023, 4096, False),
                                               (1025, 4096, True),
                                               (3000, 4096, False),
                                               (4096, 4096, True),
                                               (9000, 16384, False),
                                               (9000, 16384, True)])
def test_delta_dommax2d_tail_fold_matches_plain(fill, cap, with_nan):
    """K20's walk, which stops at the log's sentinel tail and folds the
    skipped slots' 0 back in, equals the plain dominance max in value (NaN
    equal) on all-negative measures, NaN measures in some tiles, logs of
    one to several tiles a chunk, and the corners that reach the tail:
    at and above the sentinel, +-inf, NaN."""
    gx, gy, gw = _min_log(fill, cap, seed=fill + 11 * with_nan)
    if with_nan and fill:
        gw = gw.clone()
        gw[:fill:900] = float("nan")
    u, v = (torch.as_tensor(a) for a in _tail_corners(seed=fill + 1, n=60))
    torch.testing.assert_close(_k20_walk(u, v, gx, gy, gw),
                               kd.delta_dommax2d_plain(u, v, gx, gy, gw),
                               rtol=0, atol=0, equal_nan=True)


# K18's and K19's walk (csrc/scan2d.cu rank_rects, delta_count2d_kernel,
# delta_sum2d_kernel): blocks of 256 rectangles bucketed into kRankBuckets
# by their first slot; K18 splits each warp's union between 2 warps
K19_BLOCK, K19_BUCKETS, WARP = 256, 128, 32
K18_SPLIT = 2


def _log_tail(kx):
    """The slot where the log's sentinel tail starts: the first slot whose
    x is the sentinel, when there is one, else the log's size."""
    big = big_sentinel(torch.float64)
    D = kx.shape[0]
    tail = int((kx < big).sum())
    return tail if tail < D and kx[tail] == big else D


def _rank_walk(lx, ux, kx, c1, split=1, block=K19_BLOCK):
    """The rank prologue and the walk of K18 and K19 in torch: each
    rectangle's x range ranked to slots [a, b) (a = #(x <= lx), none for a
    NaN lx; b = #(x <= ux)) and cut at slot c1; each block of ``block``
    rectangles bucketed by a, each warp of 32 consecutive ones walking the
    union of their ranges in ``split`` consecutive parts.  Each part's
    (Q, D) mask of the slots a rectangle walks there and finds in its own
    range, and the ranges' widths."""
    D, Q = kx.shape[0], lx.shape[0]
    a = (kx[None, :] <= lx[:, None]).sum(dim=1)
    a = torch.where(torch.isnan(lx), D, a)
    b = torch.clamp((kx[None, :] <= ux[:, None]).sum(dim=1), max=c1)
    empty = a >= b
    shift = max(0, max(c1, 1).bit_length() - 7)
    key = torch.where(empty, K19_BUCKETS - 1,
                      torch.clamp(a >> shift, max=K19_BUCKETS - 2))
    lo = torch.where(empty, D, a)
    hi = torch.where(empty, 0, b)
    parts = torch.zeros((split, Q, D), dtype=torch.bool)
    j = torch.arange(D)
    for b0 in range(0, Q, block):
        order = b0 + torch.argsort(key[b0:b0 + block], stable=True)
        for w0 in range(0, order.shape[0], WARP):
            g = order[w0:w0 + WARP]
            w_lo, w_hi = int(lo[g].min()), int(hi[g].max())
            n = max(w_hi - w_lo, 0)
            for h in range(split):
                parts[h, g] = ((j >= w_lo + n * h // split)
                               & (j < w_lo + n * (h + 1) // split))
    in_range = (j >= a[:, None]) & (j < b[:, None])
    return [p & in_range for p in parts], (b - a).clamp(min=0)


def _in_y(ly, uy, ky):
    return (ly[:, None] < ky[None, :]) & (ky[None, :] <= uy[:, None])


def _k19_walk(lx, ux, ly, uy, kx, ky, w):
    """K19's formulation in torch: the rank walk over the live log [0,
    tail), a member (a <= j < b and ly < y <= uy) adding its measure in
    slot order."""
    (walked,), width = _rank_walk(lx, ux, kx, _log_tail(kx))
    member = walked & _in_y(ly, uy, ky)
    acc = torch.zeros(lx.shape[0], dtype=w.dtype)
    for k in range(kx.shape[0]):
        acc = torch.where(member[:, k], acc + w[k], acc)
    return acc, width


def _k18_walk(lx, ux, ly, uy, kx, ky):
    """K18's formulation in torch: the rank walk over the live log [0,
    tail), each warp's union in K18_SPLIT parts whose members (a <= j < b
    and ly < y <= uy) are counted and the counts added; the tail's slots
    with x the sentinel (whose y is the sentinel) added to each rectangle
    that holds the point (sentinel, sentinel)."""
    big = big_sentinel(torch.float64)
    D, tail = kx.shape[0], _log_tail(kx)
    parts, width = _rank_walk(lx, ux, kx, tail, split=K18_SPLIT)
    cnt = sum((p & _in_y(ly, uy, ky)).sum(dim=1) for p in parts)
    n_tail = int((kx <= big).sum()) - tail if tail < D else 0
    holds = (lx < big) & (big <= ux) & (ly < big) & (big <= uy)
    cnt += torch.where(holds, n_tail, 0)
    return cnt.to(torch.float64), width


def _k19_log(fill, seed, kind):
    """A 4,096-slot x-sorted SUM log of ``fill`` points built by the port's
    append: an insert log in one append, a delete log in two (ties with the
    points already logged); measures with -0.0, NaN and +-inf among them.
    ``kind`` 'nan_tail' puts a NaN x after the sentinel tail, 'full_nan' and
    'full_inf' end a full log on a NaN or an infinite x."""
    rng = np.random.default_rng(seed)
    cap = 4096
    x = np.round(rng.uniform(0, 20, fill), 1)
    y = np.round(rng.uniform(0, 20, fill), 1)
    w = rng.normal(50, 10, fill)
    if fill > 40:
        w[[3, 17, 29, 31]] = (-0.0, np.nan, np.inf, -np.inf)
        w[5:40:7] = -w[5:40:7]
    e = DeltaBuffer2D.empty(cap, weighted=True)
    bx, by, bw = e.ins_x, e.ins_y, e.ins_w
    cuts = [0, fill // 2, fill] if kind == "delete" else [0, fill]
    for c0, c1 in zip(cuts, cuts[1:]):
        bx, by, bw, *_ = _append_2d(
            bx, by, bw, torch.as_tensor(x[c0:c1]), torch.as_tensor(y[c0:c1]),
            torch.as_tensor(w[c0:c1]), cap=cap, levels=False, weighted=True)
    if kind in ("nan_tail", "full_nan", "full_inf"):
        bx, by, bw = bx.clone(), by.clone(), bw.clone()
        bx[-1] = {"full_inf": np.inf}.get(kind, np.nan)
        by[-1], bw[-1] = 5.0, 7.0
    return bx, by, bw


def _k19_rects(kx, seed, n=300):
    """Rectangles over the log, their x bounds on logged x values (ties at
    either end), and the edge lanes: NaN bounds, inverted, +-inf, -0.0, and
    bounds at and above the sentinel."""
    rng = np.random.default_rng(seed)
    big = big_sentinel(torch.float64)
    xs = kx[kx < big].numpy()
    a, b, c, d = rng.uniform(-2, 22, (4, n))
    if len(xs):
        a[:n // 3] = rng.choice(xs, n // 3)
        b[n // 6:n // 2] = rng.choice(xs, n // 2 - n // 6)
    lx, ux = np.minimum(a, b), np.maximum(a, b)
    ly, uy = np.minimum(c, d), np.maximum(c, d)
    inf, nan = np.inf, np.nan
    extra = np.array([  # lx, ux, ly, uy
        [nan, 10.0, 0.0, 10.0], [0.0, nan, 0.0, 10.0],
        [0.0, 10.0, nan, 10.0], [0.0, 10.0, 0.0, nan], [nan, nan, nan, nan],
        [12.0, 3.0, 0.0, 20.0], [5.0, 5.0, 0.0, 20.0],
        [-inf, inf, -inf, inf], [-inf, 10.0, -inf, 10.0],
        [10.0, inf, 10.0, inf], [inf, inf, -inf, inf],
        [-0.0, 0.0, -0.0, 20.0], [0.0, 20.0, -0.0, 0.0],
        [-1.0, big, -1.0, big], [0.0, 2 * big, 0.0, 2 * big],
        [big, inf, big, inf], [np.nextafter(big, 0), big, 0.0, big],
        [-1e300, 1e300, -1e300, 1e300]])
    return [torch.as_tensor(np.concatenate([q, extra[:, j]]))
            for j, q in enumerate((lx, ux, ly, uy))]


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("fill,kind", [(0, "insert"), (1, "insert"),
                                       (1023, "insert"), (1024, "delete"),
                                       (1025, "insert"), (3072, "delete"),
                                       (3072, "nan_tail"), (4096, "insert"),
                                       (4096, "delete"), (4096, "full_nan"),
                                       (4096, "full_inf")])
def test_delta_sum2d_rank_walk_matches_plain(fill, kind, agg):
    """K19's walk (ranks, the sentinel tail cut, buckets and warp unions)
    equals the plain K19, which tests every slot's x, bit for bit, and
    K18's (the same walk, each warp's union in two parts whose counts are
    added, the tail's slots counted without a walk) equals the plain K18
    exactly, on
    insert and delete logs of 0 to 4,096 points, logs with a NaN x after
    the tail or at the end of a full log, a full log that ends on +inf,
    rectangles with ties at either x end, NaN, inverted, infinite,
    signed-zero and sentinel bounds, and -0.0, NaN and +-inf measures."""
    kx, ky, w = _k19_log(fill, seed=fill + 3, kind=kind)
    q = _k19_rects(kx, seed=fill)
    if agg == "sum":
        got, width = _k19_walk(*q, kx, ky, w)
        want = kd.delta_sum2d_plain(*q, kx, ky, w)
    else:
        got, width = _k18_walk(*q, kx, ky)
        want = kd.delta_count2d_plain(*q, kx, ky)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert (width > 0).any() if fill > 1 else True
    # (-inf, inf] takes a full log's infinite x in, never its NaN x
    if kind in ("full_nan", "full_inf"):
        assert int(width[-11]) == (4096 if kind == "full_inf" else 4095)
    if agg == "count" and fill < 4096:
        # (-inf, inf]^2 and (-1, sentinel]^2 count the padding too
        assert float(want[-11]) == 4096 - (kind == "nan_tail")
        assert float(want[-5]) == float(want[-11])


def test_delta_2d_scan_wrappers_check_shapes():
    q = torch.zeros(8, dtype=torch.float64)
    s = torch.full((CAP,), big_sentinel(torch.float64), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        kd._scan2d_args("delta_count2d", (q, q, q, q), (s, s))
    out = kd.delta_count2d(q, q, q, q, s, s)
    assert out.shape == (8,) and not out.any()
    assert torch.isneginf(kd.delta_dommax2d(q, q, s, s, s * 0)).all()


# ---------------------------------------------------------------------------
# DynamicEngine2D on cuda_scan against the reference's pallas_scan
# ---------------------------------------------------------------------------

def _carry(ridx):
    """A reference index carried into the port (its fields as numpy)."""
    arr = lambda a: None if a is None else np.asarray(a)
    ex = ridx.exact
    fields = {f: arr(getattr(ridx, f)) for f in
              ("children", "leaf_of", "bounds", "coeffs", "leaf_nodes",
               "leaf_agg", "leaf_err", "measures_sorted")}
    fields.update(deg=ridx.deg, delta=ridx.delta, max_depth=ridx.max_depth,
                  root_bounds=ridx.root_bounds, n=ridx.n, agg=ridx.agg,
                  extremal_floor=ridx.extremal_floor,
                  exact=tuple(arr(a) for a in (ex.xs, ex.ys_levels,
                                               ex.wcum_levels,
                                               ex.wpmax_levels, ex.ws)))
    return index2d_from_numpy(fields, "cpu")


@pytest.fixture(scope="module")
def setup2d():
    """2,000 points over [0, 100]^2 with the reference tests' measure
    surface, one reference index per aggregate, the update batches and
    128 rectangles and corners."""
    rng = np.random.default_rng(0x5CA2)
    n = 2000
    px, py = rng.uniform(0, 100, (2, n))
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    delta = {"count2d": 25.0, "sum2d": 400.0, "min2d": 6.0}
    idx = {agg: r_build(px, py, measures=None if agg == "count2d" else w,
                        agg=agg, deg=2, delta=delta[agg], max_depth=6)
           for agg in delta}
    ins = [(rng.uniform(5, 95, 24), rng.uniform(5, 95, 24),
            rng.uniform(40, 60, 24)) for _ in range(2)]
    gone = rng.choice(n, 16, replace=False)
    a = rng.uniform(0, 80, 128)
    c = rng.uniform(0, 80, 128)
    rect = (a, a + rng.uniform(2, 30, 128), c, c + rng.uniform(2, 30, 128))
    ci = rng.integers(0, n, 128)
    return px, py, idx, ins, gone, rect, (px[ci], py[ci])


@pytest.mark.parametrize("agg", ["count2d", "sum2d", "min2d"])
def test_dynamic2d_scan_matches_reference(setup2d, card_route, agg):
    px, py, idx, ins, gone, rect, corners = setup2d
    kw = dict(capacity=CAP, auto_refit=False)
    ref = RDyn(idx[agg], backend="pallas_scan", **kw)
    scan = DynamicEngine2D(_carry(idx[agg]), backend="cuda_scan", **kw)
    cuda = DynamicEngine2D(_carry(idx[agg]), backend="cuda", **kw)
    assert scan.backend == "cuda_scan" and cuda.backend == "cuda"
    ranges = corners if agg == "min2d" else rect
    run = (lambda e, r: e.extremum2d(*ranges, eps_rel=r)) if agg == "min2d" \
        else (lambda e, r: (e.count2d if agg == "count2d" else e.sum2d)(
            *ranges, eps_rel=r))

    def update(step):
        x, y, w = ins[step]
        out = gone[8 * step:8 * (step + 1)]
        for e in (ref, scan, cuda):
            e.insert(*((x, y) if agg == "count2d" else (x, y, w)))
            e.delete(px[out], py[out])

    def compare():
        _, buf = scan.snapshot()
        big = big_sentinel(torch.float64)
        assert bool((buf.ins_ylv == big).all())     # no levels on cuda_scan
        if agg == "min2d" and scan.n_pending:
            assert buf.vic_x is not None            # shadowed victims
        for eps_rel in (None, 0.05):
            got = run(scan, eps_rel)
            want = run(ref, eps_rel)
            for f in ("answer", "approx"):
                np.testing.assert_allclose(getattr(got, f).numpy(),
                                           np.asarray(getattr(want, f)),
                                           **TOL)
            np.testing.assert_array_equal(got.refined.numpy(),
                                          np.asarray(want.refined))
            twin = run(cuda, eps_rel)
            if agg == "sum2d":
                np.testing.assert_allclose(got.answer.numpy(),
                                           twin.answer.numpy(), **TOL)
            else:
                np.testing.assert_array_equal(got.answer.numpy(),
                                              twin.answer.numpy())
            np.testing.assert_array_equal(got.refined.numpy(),
                                          twin.refined.numpy())

    update(0)
    compare()
    for e in (ref, scan, cuda):
        e.flush()
    assert scan.refit_count == ref.refit_count == 1
    assert scan.last_refit_stats == ref.last_refit_stats
    compare()
    update(1)
    compare()


def _leaf_plan(source, setup2d):
    """The port's flat leaf table ``source`` names: a COUNT plan over 1,500
    OSM-like points (Morton depth 8), a depth-16 plan past the int32 Morton
    range (the scan table alone), and a dynamic COUNT plan after a flush's
    selective refit."""
    if source == "osm":
        px, py = osm_points(1500, seed=5)
        return t_build_plan_2d(t_build_2d(px, py, deg=2, delta=25.0,
                                          max_depth=8, device="cpu"))
    if source == "deep":
        rng = np.random.default_rng(41)
        px, py = rng.uniform(0, 120, (2, 1000))
        plan = t_build_plan_2d(t_build_2d(px, py, deg=2, delta=4.0,
                                          max_depth=16, device="cpu"))
        assert plan.leaf_z is None
        return plan
    px, py, idx, ins, gone, _, _ = setup2d
    dyn = DynamicEngine2D(_carry(idx["count2d"]), backend="cuda_scan",
                          capacity=CAP, auto_refit=False)
    dyn.insert(*ins[0][:2])
    dyn.delete(px[gone[:8]], py[gone[:8]])
    dyn.flush()
    assert dyn.refit_count == 1 and dyn.n_pending == 0
    return dyn.snapshot()[0]


@pytest.mark.parametrize("source", ["osm", "deep", "dyn2d_refit"])
def test_port_leaf_tables_partition_the_root(setup2d, card_route, source):
    """The flat leaf table K12 scans keeps the layout it relies on: the
    padded leaves (membership bounds all the sentinel) sit at the tail
    only, and the real leaves' boxes [mx0, mx1) x [my0, my1) partition the
    root, so every corner clamped into it lies in exactly one leaf: corners
    on every split line, on the root's edges and corners, and at random."""
    plan = _leaf_plan(source, setup2d)
    m = [t.numpy() for t in (plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0,
                             plan.leaf_my1)]
    big, n = big_sentinel(torch.float64), plan.n_leaves
    assert all(np.all(a[n:] == big) for a in m)
    assert np.all(m[0][:n] < big) and np.all(m[2][:n] < big)
    x0, x1, y0, y1 = plan.root
    xs = np.unique(np.concatenate([m[0][:n], m[1][m[1] < big], [x0, x1]]))
    ys = np.unique(np.concatenate([m[2][:n], m[3][m[3] < big], [y0, y1]]))
    rng = np.random.default_rng(79)
    qx = np.concatenate([xs, rng.choice(xs, len(ys)), [x0, x0, x1, x1],
                         rng.uniform(x0 - 5, x1 + 5, 500)])
    qy = np.concatenate([rng.choice(ys, len(xs)), ys, [y0, y1, y0, y1],
                         rng.uniform(y0 - 5, y1 + 5, 500)])
    qx, qy = np.clip(qx, x0, x1)[:, None], np.clip(qy, y0, y1)[:, None]
    holds = ((m[0] <= qx) & (qx < m[1]) & (m[2] <= qy) & (qy < m[3]))
    assert np.all(holds.sum(axis=1) == 1)


# K13's walk (csrc/leaf_eval2d.cu corner_eval2d_scan_kernel): kEvalTile
# leaves a tile, the table in up to kEvalChunks chunks of interleaved tiles
K13_TILE, K13_CHUNKS = 128, 4


def _k13_walk(u, v, mx0, mx1, my0, my1, bounds, coeffs, deg, tile):
    """K13's formulation in torch: each chunk walks its tiles in order and
    stops at its first tile that starts on the sentinel; a corner takes
    every leaf whose box holds it (the last, no first-hit test); the finish
    takes the lowest leaf over the chunks (-1, none, as the largest
    unsigned value) and evaluates its row, the zero row where none holds
    the corner."""
    big = big_sentinel(torch.float64)
    L = mx0.shape[0]
    tiles = -(-L // tile)
    S = max(1, min(K13_CHUNKS, tiles))
    none = 1 << 32
    leaf = torch.full(u.shape, none, dtype=torch.int64)
    for c in range(S):
        hit = torch.full(u.shape, -1, dtype=torch.int64)
        for t in range(c, tiles, S):
            sl = slice(t * tile, (t + 1) * tile)
            if mx0[t * tile] == big:
                break
            member = ((mx0[sl] <= u[:, None]) & (u[:, None] < mx1[sl])
                      & (my0[sl] <= v[:, None]) & (v[:, None] < my1[sl]))
            j = torch.arange(t * tile, t * tile + member.shape[1])
            last = torch.where(member, j, -1).amax(dim=1)
            hit = torch.where(last >= 0, last, hit)
        leaf = torch.minimum(leaf, torch.where(hit >= 0, hit, none))
    held = leaf < none
    row = torch.where(held, leaf, 0)
    c = torch.where(held[:, None], coeffs[row], 0.0)
    b = torch.where(held[:, None], bounds[row], 0.0)
    return bivariate_horner(u, v, c, b, deg), torch.where(held, leaf, -1)


@pytest.mark.parametrize("tile", [K13_TILE, 8])
@pytest.mark.parametrize("source", ["osm", "deep", "dyn2d_refit"])
def test_corner_eval2d_chunked_walk_matches_plain(setup2d, card_route,
                                                  source, tile):
    """K13's walk (chunks of interleaved tiles stopping at the sentinel
    tail, any hit kept, the lowest over the chunks, then the row) equals the
    plain K13 bit for bit on the port's static, depth-16 and refit leaf
    tables, at the kernel's tile and at 8-leaf tiles (up to 4 chunks of
    several tiles each): corners on every split line, on the root's edges
    and corners, at random, NaN and +-inf.  Every clamped corner finds its
    leaf; no other does."""
    plan = _leaf_plan(source, setup2d)
    table = (plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0, plan.leaf_my1,
             plan.leaf_bounds, plan.leaf_coeffs)
    big, n = big_sentinel(torch.float64), plan.n_leaves
    x0, x1, y0, y1 = plan.root
    m = [t.numpy() for t in table[:4]]
    xs = np.unique(np.concatenate([m[0][:n], m[1][m[1] < big], [x0, x1]]))
    ys = np.unique(np.concatenate([m[2][:n], m[3][m[3] < big], [y0, y1]]))
    rng = np.random.default_rng(83)
    inf, nan = np.inf, np.nan
    qx = np.concatenate([xs, rng.choice(xs, len(ys)), [x0, x0, x1, x1],
                         rng.uniform(x0, x1, 300)])
    qy = np.concatenate([rng.choice(ys, len(xs)), ys, [y0, y1, y0, y1],
                         rng.uniform(y0, y1, 300)])
    qx, qy = np.clip(qx, x0, x1), np.clip(qy, y0, y1)
    clamped = len(qx)
    qx = np.concatenate([qx, [nan, x0, nan, inf, -inf, x1, inf]])
    qy = np.concatenate([qy, [y0, nan, nan, y0, y1, -inf, inf]])
    u, v = torch.as_tensor(qx), torch.as_tensor(qy)
    got, leaf = _k13_walk(u, v, *table, plan.deg, tile)
    want = k2d.corner_eval2d_plain(u, v, *table, plan.deg)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert (leaf[:clamped] >= 0).all() and (leaf[clamped:] < 0).all()
    if tile == 8:
        assert -(-plan.leaf_mx0.shape[0] // 8) >= 4


def test_session_dynamic2d_table_on_scan_backend(setup2d, card_route):
    """PolyFit.fit(backend='cuda_scan') with a dynamic two-key SUM table
    (it raised before K18-K20) builds, takes an insert and a delete, and
    answers Q_abs and Q_rel rectangles as the reference session on
    'pallas_scan' does."""
    px, py, _, ins, gone, rect, _ = setup2d
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    spec = lambda api: {"pts": api.TableSpec(
        "sum2d", api.ErrorBudget(abs=1600.0, rel=0.05), deg=2, dynamic=True,
        capacity=CAP, background=False)}
    data = {"pts": (px, py, w)}
    ref = rapi.PolyFit.fit(data, spec(rapi), backend="pallas_scan")
    port = tapi.PolyFit.fit(data, spec(tapi), backend="cuda_scan",
                            device="cpu")
    assert port.backend == "cuda_scan"
    for s in (ref, port):
        s.insert("pts", *ins[0])
        s.delete("pts", px[gone[:8]], py[gone[:8]])
    for rel in (None, 0.05):
        got = port.query(tapi.QuerySpec.rect("pts", *rect, rel=rel))
        want = ref.query(rapi.QuerySpec.rect("pts", *rect, rel=rel))
        np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                                   **TOL)
        np.testing.assert_array_equal(got.refined.numpy(),
                                      np.asarray(want.refined))
        assert got.staleness == want.staleness == 32
