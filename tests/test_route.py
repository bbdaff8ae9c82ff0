"""The route module (ops/route.py), the kernel's Python side
(ops/cuda_sweep.py), float32 precision pins, the compile-cache helper, the
peak table, and api.solve's single timed run.

The CUDA kernel itself has no interpret mode: the ``gpu``-marked test at the
end runs it on the card and skips elsewhere."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.ops import cuda_sweep, route
from convex_optimization_tpu.ops.bcd_sweep import batch_sweep, batch_sweep_ref
from convex_optimization_tpu.ops.matvec import to_tblock_major


# ------------------------------------------------------------------ route

@pytest.mark.parametrize("platform,dtype,expect", [
    ("gpu", jnp.float32, route.CUDA),
    ("gpu", jnp.float64, route.XLA),
    ("cpu", jnp.float32, route.XLA),
    ("cpu", jnp.float64, route.XLA),
])
def test_sweep_route_by_platform_and_dtype(platform, dtype, expect):
    got = route.sweep_route(dtype, platform)
    assert got == expect
    assert got in route.ROUTES          # no interpret mode anywhere


def test_check_route_rejects_unknown_and_cuda_off_gpu():
    assert route.check_route(None, jnp.float32) == route.XLA   # CPU here
    assert route.check_route(route.XLA) == route.XLA
    with pytest.raises(ValueError, match="unknown sweep route"):
        route.check_route("interpret")
    with pytest.raises(ValueError, match="GPU backend"):
        route.check_route(route.CUDA)


def _sweep_inputs(L=2, dtype=jnp.float32):
    inst = make_lasso_instance(jax.random.PRNGKey(0), 32, 128, dtype=dtype)
    p = inst.problem
    A_t = to_tblock_major(p.A, 4)
    X = jnp.zeros((4, L, 32), dtype)
    R = jnp.broadcast_to(-p.b, (L, 32)).astype(dtype)
    steps = jnp.full((4,), 0.5, dtype)
    lam1s = jnp.full((L,), 0.1, dtype)
    return A_t, X, R, steps, lam1s


@pytest.mark.parametrize("platform,dtype,kernel", [
    ("gpu", jnp.float32, True),
    ("gpu", jnp.float64, False),
    ("cpu", jnp.float32, False),
    ("cpu", jnp.float64, False),
])
def test_batch_sweep_dispatch(monkeypatch, platform, dtype, kernel):
    """batch_sweep(route=None) calls the kernel exactly where the route
    module says, and the plain sweep everywhere else."""
    calls = []

    def fake_cuda(*args, **kw):
        calls.append(kw["kind"])
        return batch_sweep_ref(*args, **kw)

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(cuda_sweep, "batch_sweep_cuda", fake_cuda)
    X, R = batch_sweep(*_sweep_inputs(dtype=dtype), 0.0, kind="l1")
    assert calls == (["l1"] if kernel else [])
    assert X.shape == (4, 2, 32) and R.shape == (2, 32)


@pytest.mark.parametrize("m,n,B,L,dtype,gsize,ok", [
    (10_000, 100_000, 80, 1, jnp.float32, 1, True),
    (10_000, 100_000, 80, 16, jnp.float32, 1, True),
    (10_000, 100_000, 80, 17, jnp.float32, 1, False),     # L > MAX_BATCH
    (10_000, 100_000, 80, 1, jnp.float64, 1, False),      # dtype
    (10_000, 100_000, 84, 1, jnp.float32, 1, False),      # B % 8
    (10_002, 100_000, 80, 1, jnp.float32, 1, False),      # m % 8
    (20_000, 200_000, 200, 1, jnp.float32, 200, True),    # config 4 group
    (20_000, 200_000, 200, 1, jnp.float32, 400, False),   # partial group
])
def test_sweep_gate(m, n, B, L, dtype, gsize, ok):
    assert (route.sweep_gate(m, n, B, L, dtype, gsize) is None) == ok


def test_pick_block_size_prefers_pad_free():
    assert route.pick_block_size(10_000, 100_000) == (80, 0)
    assert route.pick_block_size(20_000, 200_000, 128, 200) == (200, 0)
    b, pad = route.pick_block_size(64, 1001)
    assert b % 8 == 0 and (1001 + pad) % b == 0 and pad > 0
    assert route.pick_block_size(64, 256, dtype=jnp.float64) is None


def test_device_memory_budget(monkeypatch):
    budget = route.device_memory_budget()            # CPU: host RAM
    assert budget > 0
    assert route.fits_device_memory(64, 256)
    assert not route.fits_device_memory(10 ** 6, 10 ** 6, copies=2)

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    got = route.device_memory_budget(Dev({"bytes_limit": 60 * 2 ** 30}))
    assert got == int(60 * 2 ** 30 * (1 - route.MEMORY_HEADROOM))
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        route.device_memory_budget(Dev(None))


# ------------------------------------------------- the kernel's Python side

def test_plan_mirrors_kernel_constants():
    src = cuda_sweep.SOURCE.read_text()
    for name, value in [("kThreads", cuda_sweep.THREADS),
                        ("kMaxStages", cuda_sweep.MAX_STAGES),
                        ("kMaxBatch", cuda_sweep.MAX_BATCH),
                        ("kCounterWords", cuda_sweep.COUNTER_WORDS)]:
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    for kind, code in cuda_sweep.KINDS.items():
        assert re.search(rf"k\w+ = {code}", src), kind


@pytest.mark.parametrize("m,B,L,stages_min", [
    (10_000, 80, 1, 8),         # the headline: a deep prefetch ring
    (10_000, 80, 16, 2),
    (20_000, 200, 1, 1),        # config 4 group blocks: one stage
    (50_000, 64, 1, 2),         # config 5 slabs
])
def test_plan_shapes(m, B, L, stages_min):
    pl = cuda_sweep.plan(m, B, L)
    assert pl is not None and pl["stages"] >= stages_min
    assert pl["grid"] <= cuda_sweep.H100_SMS
    assert pl["grid"] * pl["ms"] >= m and pl["ms"] % 8 == 0
    assert pl["smem_bytes"] <= cuda_sweep.SMEM_LIMIT


@pytest.mark.parametrize("kind,L,masked,rowmasked", [
    ("l1", 1, False, False),
    ("l1", 16, True, True),
    ("nonneg_l1", 3, True, False),
    ("group_l2", 2, False, True),
])
def test_kernel_operands(kind, L, masked, rowmasked):
    """Shapes, dtypes, dummies and attributes the FFI handler expects."""
    nb, B, m, gsize = 4, 32, 48, 8
    A_t = jnp.zeros((nb, B, m), jnp.float32)
    X = jnp.zeros((nb, L, B), jnp.float32)
    R = jnp.zeros((L, m), jnp.float32)
    w = jnp.ones((nb * B // gsize,), jnp.float32)
    keep = jnp.ones((nb * B,), bool) if masked else None
    rm = jnp.ones((m,), jnp.float32) if rowmasked else None
    ops, attrs, results = cuda_sweep.operands(
        A_t, X, R, jnp.ones(nb), jnp.ones(L), 0.5, kind=kind, gsize=gsize,
        weights=w if kind == "group_l2" else None, mask=keep, row_mask=rm)
    shapes = [o.shape for o in ops]
    assert shapes[:6] == [(nb, B, m), (nb, L, B), (L, m), (nb,), (L,), (1,)]
    assert shapes[6] == ((nb, B // gsize) if kind == "group_l2" else (1,))
    assert shapes[7] == (nb, B)
    assert shapes[8] == ((m,) if rowmasked else (1,))
    assert all(o.dtype == jnp.float32 for o in ops)
    assert int(attrs["kind"]) == cuda_sweep.KINDS[kind]
    assert int(attrs["gsize"]) == (gsize if kind == "group_l2" else 1)
    assert int(attrs["masked"]) == int(rowmasked)
    assert [r.shape for r in results] == [
        (nb, L, B), (L, m), (cuda_sweep.COUNTER_WORDS + 3 * L * B,)]


# ------------------------------------------------------ precision pins

def _dots_all_highest(fn, *args) -> bool:
    text = jax.jit(fn).lower(*args).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    return bool(dots) and all("HIGHEST" in ln for ln in dots)


def _precision_cases():
    from convex_optimization_tpu.core.objective import dual_witness
    from convex_optimization_tpu.ops import matvec
    from convex_optimization_tpu.ops.power_iter import spectral_norm_sq

    inst = make_lasso_instance(jax.random.PRNGKey(1), 16, 64)
    p = inst.problem
    A_t = to_tblock_major(p.A, 4)
    x = jnp.ones((64,), jnp.float32)
    X = jnp.ones((4, 3, 16), jnp.float32)
    R = jnp.ones((3, 16), jnp.float32)
    return {
        "residual": (lambda A_t, x: matvec.ax_minus_b_t(A_t, x, p.b),
                     (A_t, x)),
        "witness": (lambda A_t, x: matvec.neg_at_r_t(A_t, p.b, x, 0.1),
                    (A_t, x)),
        "batched_refresh": (lambda A_t, X: matvec.ax_minus_b_batch_t(
            A_t, X, p.b), (A_t, X)),
        "batched_witness": (lambda A_t, R, X: matvec.neg_at_r_batch_t(
            A_t, R, X, 0.1), (A_t, R, X)),
        "block_power": (lambda A_t: matvec.block_power_t(A_t, iters=2),
                        (A_t,)),
        "power_iteration": (lambda A: spectral_norm_sq(A, iters=2), (p.A,)),
        "problem_residual": (lambda p, x: p.residual(x), (p, x)),
        "dual_witness": (lambda p, x: dual_witness(p, x, p.b), (p, x)),
    }


@pytest.mark.parametrize("name", list(_precision_cases()))
def test_float32_dots_pin_highest(name):
    """Every f32 product feeding a residual, witness, gap or step size
    lowers with Precision.HIGHEST (TF32 would keep ~3 digits on the GPU)."""
    fn, args = _precision_cases()[name]
    assert _dots_all_highest(fn, *args)


# ---------------------------------------------- compile cache and peaks

def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from convex_optimization_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    from convex_optimization_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(compile_cache.REPO_CACHE)
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peak_table_known_and_unknown():
    from convex_optimization_tpu.utils import metrics

    assert metrics.hbm_peak_bytes_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        metrics.hbm_peak_bytes_s("TPU v9")
    with pytest.raises(KeyError):
        metrics.effective_bandwidth(10, 10, 1, 1.0, device_kind="cpu")


# ------------------------------------------------- one timed solve run

@pytest.mark.parametrize("method", ["fista", "bcd_pallas"])
def test_solve_runs_the_solver_once(monkeypatch, method):
    """api.solve compiles once and executes once: wall_time_s is that
    execution, compile_time_s the compile, and the iteration counts agree."""
    from convex_optimization_tpu import api

    mod = api.fista_mod if method == "fista" else api.bcd_mod
    real = mod.fista if method == "fista" else mod.bcd
    lowered = []

    class Counting:
        def lower(self, *a, **kw):
            lowered.append(1)
            return real.lower(*a, **kw)

    monkeypatch.setattr(mod, method.split("_")[0], Counting())
    inst = make_lasso_instance(jax.random.PRNGKey(3), 64, 256)
    res = api.solve(inst.problem, method, tol=1e-5, max_iters=2000)
    assert lowered == [1]
    assert res.converged and res.method == method
    assert res.iterations > 0
    assert res.wall_time_s > 0 and res.compile_time_s > 0


# -------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 16])
def test_cuda_sweep_matches_plain_route(gpu_device, L):
    """The kernel against the plain sweep on the card (chip_smoke.py runs
    the full-width version of this check)."""
    A_t, X, R, steps, lam1s = _sweep_inputs(L=L)
    Xk, Rk = batch_sweep(A_t, X, R, steps, lam1s, 0.0, kind="l1",
                         route=route.CUDA)
    Xr, Rr = batch_sweep(A_t, X, R, steps, lam1s, 0.0, kind="l1",
                         route=route.XLA)
    # the CTAs' partial sums meet in run-dependent atomic order
    np.testing.assert_allclose(np.asarray(Xk), np.asarray(Xr), atol=1e-5)
    np.testing.assert_allclose(np.asarray(Rk), np.asarray(Rr), atol=1e-5)
