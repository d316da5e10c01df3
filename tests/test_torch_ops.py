"""repro_torch.kernels.ops against repro.kernels.ops: the twin of
tests/test_kernels.py, its sweeps as parametrised cases at n = 3,000.

The same indexes (built once by the reference from a numpy seed, carried
into the port with ``index_from_numpy``) go through both packages'
``from_index`` at float32 and float64.  The port's ``poly_eval``,
``range_sum`` and ``range_max`` on ``'cuda'`` and ``'cuda_scan'`` (their
kernels K21, K2, K3, K14 and K15 through the plain versions the wrappers
run on CPU tensors; ``card_route`` lifts the card-only check) and on
``'ref'`` are held to the reference's ``'pallas'`` (interpret mode) and
``'ref'``: float64 at rtol = atol = 1e-9 (ROADMAP rule 4), float32 at the
reference's own bars (``poly_eval`` 1e-6, ``range_sum`` 1e-5, ``range_max``
rtol 1e-4 with atol 1e-3).  The reference's XLA contracts each float32
Horner step into a fused multiply-add on the CPU, the port rounds the
multiply and the add apart (as its kernels do), so where a float32 range
SUM cancels (two endpoint values near 1,200 whose difference is 9.49) the
two land an ulp of an endpoint value apart: the ``range_sum`` bar adds
deg x eps32 x (|P(uq)| + |P(lq)|) to the reference's, on at most 1% of
the lanes (one lane of 700 here; ROADMAP Queue 3).  Twins of the
reference's core-path,
float32-guarantee (|err| <= 2 delta + cf_scale x eps32 x 8) and clamp
tests follow; ``'cuda'`` and ``'cuda_scan'`` agree bit for bit at both
types, and the float32 wrappers pick the float32 launchers while every
other kernel keeps asking for float64.  The kernels themselves are held to
these plain versions on the card by tests/test_torch_cuda.py.
"""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d as r_build  # noqa: E402
from repro.core import query_max as r_query_max  # noqa: E402
from repro.core import query_sum as r_query_sum  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.poly_eval import poly_eval_pallas  # noqa: E402
from repro_torch.core import index_from_numpy, query_max, query_sum  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as kd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import poly_eval as kp  # noqa: E402
from repro_torch.kernels import range_max as kmax  # noqa: E402
from repro_torch.kernels import range_sum as ksum  # noqa: E402

N = 3000
F64 = dict(rtol=1e-9, atol=1e-9)
PORT = ("cuda", "cuda_scan", "ref")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}


@pytest.fixture
def card_route(monkeypatch):
    """Let ``'cuda'`` and ``'cuda_scan'`` take CPU tables: their wrappers
    then run the plain versions, as they do on CPU tensors."""
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device:
                        backend)


def _fields(idx):
    """A reference index's fields as numpy (``index_from_numpy``'s input)."""
    arr = lambda a: None if a is None else np.asarray(a)
    out = {f: arr(getattr(idx, f)) for f in
           ("seg_lo", "seg_hi", "coeffs", "seg_start", "seg_agg", "st",
            "seg_err")}
    out.update(agg=idx.agg, deg=idx.deg, delta=idx.delta, n=idx.n)
    es, em = idx.exact_sum, idx.exact_max
    out["exact_sum"] = None if es is None else (arr(es.keys), arr(es.cf))
    out["exact_max"] = None if em is None else (
        arr(em.keys), arr(em.measures), arr(em.st))
    return out


@pytest.fixture(scope="module")
def indexes():
    """(agg, deg) -> (reference index, its port twin, keys), built once:
    tests/test_kernels.py's data at n = 3,000."""
    cache = {}

    def get(agg, deg, n=N):
        if (agg, deg, n) not in cache:
            rng = np.random.default_rng(0)
            keys = np.sort(rng.uniform(0, 1000, n))
            if agg == "sum":
                meas, delta = rng.uniform(0, 10, n), 30.0
            else:
                meas = np.abs(np.cumsum(rng.normal(0, 5, n))) + 10
                delta = 15.0
            ridx = r_build(keys, meas, agg, deg=deg, delta=delta)
            cache[agg, deg, n] = (ridx, index_from_numpy(_fields(ridx), "cpu"),
                                  keys)
        return cache[agg, deg, n]
    return get


def _queries(keys, nq, seed=1):
    rng = np.random.default_rng(seed)
    a = keys[rng.integers(0, len(keys), nq)]
    b = keys[rng.integers(0, len(keys), nq)]
    return np.minimum(a, b), np.maximum(a, b)


def _hold(port, want, dtype, tol32):
    """Each port backend's answers against a reference answer: (n,), the
    table's type, at the dtype's bar."""
    for b, got in port.items():
        assert got.shape == want.shape and got.dtype == DTYPES[dtype][0], b
        tol = F64 if dtype == "float64" else tol32
        np.testing.assert_allclose(got.numpy(), want, **tol, err_msg=b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("deg", [1, 2, 3, 4])
@pytest.mark.parametrize("nq", [17, 256, 1000])
def test_poly_eval_matches_reference(indexes, card_route, dtype, deg, nq):
    ridx, idx, keys = indexes("sum", deg)
    tdt, jdt = DTYPES[dtype]
    q = keys[np.random.default_rng(2).integers(0, len(keys), nq)]
    rtab, tab = rops.from_index(ridx, dtype=jdt), ops.from_index(idx, tdt)
    port = {b: ops.poly_eval(tab, q, backend=b) for b in PORT}
    for rb in ("pallas", "ref"):
        _hold(port, np.asarray(rops.poly_eval(rtab, q, backend=rb)), dtype,
              dict(rtol=1e-6, atol=1e-6))
    torch.testing.assert_close(port["cuda"], port["cuda_scan"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("deg", [1, 2, 3])
@pytest.mark.parametrize("bq,bh", [(128, 256), (256, 512)])
def test_range_sum_matches_reference(indexes, card_route, dtype, deg, bq,
                                     bh):
    ridx, idx, keys = indexes("sum", deg)
    tdt, jdt = DTYPES[dtype]
    lq, uq = _queries(keys, 700)
    rtab = rops.from_index(ridx, dtype=jdt, bh=bh)
    tab = ops.from_index(idx, tdt, bh=bh)
    port = {b: ops.range_sum(tab, lq, uq, backend=b) for b in PORT}
    for rb in ("pallas", "pallas_scan", "ref"):
        want = np.asarray(rops.range_sum(rtab, lq, uq, backend=rb, bq=bq,
                                         bh=bh))
        if dtype == "float64":
            _hold(port, want, dtype, None)
            continue
        # the reference's bar, plus an ulp of each endpoint value a Horner
        # step where the difference cancels (fused against split rounding)
        t64 = ops.from_index(idx, torch.float64)
        ends = sum(ops.poly_eval(t64, q, backend="ref").abs().numpy()
                   for q in (lq, uq))
        bar = 1e-5 + 1e-5 * np.abs(want)
        for b, got in port.items():
            assert got.dtype == torch.float32 and got.shape == want.shape
            err = np.abs(got.numpy().astype(np.float64) - want)
            assert np.all(err <= bar + deg * np.finfo(np.float32).eps * ends)
            assert np.sum(err > bar) <= len(want) // 100, b
    torch.testing.assert_close(port["cuda"], port["cuda_scan"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("deg", [2, 3])
def test_range_max_matches_reference(indexes, card_route, dtype, deg):
    ridx, idx, keys = indexes("max", deg)
    tdt, jdt = DTYPES[dtype]
    lq, uq = _queries(keys, 700)
    rtab, tab = rops.from_index(ridx, dtype=jdt), ops.from_index(idx, tdt)
    port = {b: ops.range_max(tab, lq, uq, backend=b) for b in PORT}
    for rb in ("pallas", "pallas_scan", "ref"):
        want = np.asarray(rops.range_max(rtab, lq, uq, backend=rb))
        _hold(port, want, dtype, dict(rtol=1e-4, atol=1e-3))
    torch.testing.assert_close(port["cuda"], port["cuda_scan"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_poly_eval_plain_matches_pallas(indexes, dtype):
    """The plain K21 against ``poly_eval_pallas`` on one padded batch, at
    the dtype's bar; its wrapper runs it on CPU tensors, counting no
    launch."""
    ridx, idx, keys = indexes("sum", 3)
    tdt, jdt = DTYPES[dtype]
    rtab, tab = rops.from_index(ridx, dtype=jdt), ops.from_index(idx, tdt)
    q = np.concatenate([keys[::5][:504], np.asarray(rtab.seg_lo[:8])])
    q = np.maximum(q, keys[0])
    want = np.asarray(poly_eval_pallas(
        jnp.asarray(q, jdt), rtab.seg_lo, rtab.seg_next, rtab.seg_hi,
        rtab.coeffs, interpret=True))
    args = (torch.as_tensor(q, dtype=tdt), tab.seg_lo, tab.seg_next,
            tab.seg_hi, tab.coeffs)
    got = kp.poly_eval_plain(*args)
    tol = F64 if dtype == "float64" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    before = kp.poly_eval.launches
    torch.testing.assert_close(kp.poly_eval(*args), got, rtol=0, atol=0)
    assert kp.poly_eval.launches == before


@pytest.mark.parametrize("backend", ["cuda", "cuda_scan"])
def test_kernel_f64_matches_core_sum(indexes, card_route, backend):
    """At float64 the kernel path reproduces the core query path (the
    port's and the reference's)."""
    ridx, idx, keys = indexes("sum", 2)
    lq, uq = _queries(keys, 500)
    out = ops.range_sum(ops.from_index(idx, torch.float64), lq, uq,
                        backend=backend).numpy()
    np.testing.assert_allclose(out, query_sum(idx, lq, uq).answer.numpy(),
                               **F64)
    np.testing.assert_allclose(out, np.asarray(r_query_sum(ridx, lq, uq)
                                               .answer), **F64)


@pytest.mark.parametrize("backend", ["cuda", "cuda_scan"])
def test_kernel_f64_matches_core_max(indexes, card_route, backend):
    ridx, idx, keys = indexes("max", 3)
    lq, uq = _queries(keys, 500)
    out = ops.range_max(ops.from_index(idx, torch.float64), lq, uq,
                        backend=backend).numpy()
    np.testing.assert_allclose(out, query_max(idx, lq, uq).answer.numpy(),
                               **F64)
    np.testing.assert_allclose(out, np.asarray(r_query_max(ridx, lq, uq)
                                               .answer), **F64)


@pytest.mark.parametrize("backend", ["cuda", "cuda_scan"])
def test_kernel_f32_guarantee_holds(indexes, card_route, backend):
    """The float32 kernel answer still satisfies the paper's bound with an
    FP slack proportional to the CF magnitude."""
    ridx, idx, keys = indexes("sum", 2, n=8000)
    lq, uq = _queries(keys, 800)
    out = ops.range_sum(ops.from_index(idx), lq, uq, backend=backend)
    assert out.dtype == torch.float32
    ex = idx.exact_sum
    truth = (ex.cf_at(torch.as_tensor(uq)) - ex.cf_at(torch.as_tensor(lq))
             ).numpy()
    fp_slack = float(ex.cf.max()) * np.finfo(np.float32).eps * 8
    err = np.abs(out.numpy().astype(np.float64) - truth)
    assert err.max() <= 2 * idx.delta + fp_slack


def test_out_of_domain_queries_clamp(indexes, card_route):
    ridx, idx, keys = indexes("sum", 2)
    lq = np.array([-1e9, keys[0], keys[-1]])
    uq = np.array([keys[5], 1e9, 1e9])
    rtab = rops.from_index(ridx, dtype=jnp.float64)
    tab = ops.from_index(idx, torch.float64)
    want = np.asarray(rops.range_sum(rtab, lq, uq, backend="pallas"))
    for b in PORT:
        out = ops.range_sum(tab, lq, uq, backend=b).numpy()
        np.testing.assert_allclose(out, want, rtol=1e-9, err_msg=b)
        assert np.isfinite(out).all()
    assert np.isfinite(ops.poly_eval(tab, [-1e9, 1e9]).numpy()).all()


def test_ops_backends_and_default_type(indexes):
    """``from_index`` defaults to float32 and keeps the refinement arrays
    out; the card backends refuse a CPU table; unknown backends raise."""
    _, idx, keys = indexes("sum", 2)
    tab = ops.from_index(idx)
    assert tab.dtype == torch.float32 and tab.ref_keys is None
    assert ops.SegTable is type(tab)
    for b in ("cuda", "cuda_scan"):
        with pytest.raises(ValueError, match="CUDA device"):
            ops.range_sum(tab, keys[:4], keys[1:5], backend=b)
    with pytest.raises(ValueError, match="backend must be one of"):
        ops.poly_eval(tab, keys[:4], backend="pallas")


def test_float32_launchers_picked_by_type(monkeypatch):
    """On the card path, K2, K3, K14, K15 and K21 ask ``require_cuda`` for
    the table's type and launch their ``*_f32`` instantiation on float32;
    every other kernel still asks for float64, so ``require_cuda`` rejects
    a float32 argument.  Meta tensors stand in for card tensors here (the
    launch itself is recorded, not run)."""
    calls, asked = [], []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append(name) or 0

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t,
                        dtype=torch.float64: asked.append((name, dtype)))
    for dt, sfx in ((torch.float32, "_f32"), (torch.float64, "")):
        v = torch.empty(16, dtype=dt, device="meta")
        c = torch.empty(16, 3, dtype=dt, device="meta")
        st = torch.empty(5, 16, dtype=torch.float64, device="meta")
        calls.clear()
        asked.clear()
        kp.poly_eval(v, v, v, v, c)
        ksum.range_sum_gather(v, v, v, v, c)
        ksum.range_sum(v, v, v, v, v, c)
        kmax.range_max_gather(v, v, v, v, c, st)
        kmax.range_max(v, v, v, v, v, c, v)
        # K15 asks for its chunk count (the scratch's rows) first
        assert calls == [f"polyfit_{k}{sfx}" for k in (
            "poly_eval", "range_sum_gather", "range_sum",
            "range_max_gather")] + ["polyfit_range_max_chunks",
                                    f"polyfit_range_max{sfx}"]
        assert [d for _, d in asked] == [dt] * 5
    v32 = torch.empty(16, dtype=torch.float32, device="meta")
    asked.clear()
    kd.delta_sum(v32, v32, v32, v32)
    kd.delta_count2d(v32, v32, v32, v32, v32, v32)
    kd.delta_dommax2d(v32, v32, v32, v32, v32)
    assert [d for _, d in asked] == [torch.float64] * 3
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        _build.float_dtype("k", torch.empty(2, dtype=torch.float16))
