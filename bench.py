"""
Staged GPU benchmark harness.

Runs a sequence of benchmark stages — each in its OWN subprocess with its
own timeout, so a hang in any one stage (compilation, kernel bug) cannot
destroy the run's numbers. The parent stays off JAX, so only one process
holds the card at a time. Stage results are printed incrementally as JSON
lines with a "stage" key, each naming the device it ran on (platform,
device_kind, device count, and the card's name and power limit from
nvidia-smi); the FINAL line printed is the headline metric:

  {"metric": "...", "value": N, "unit": "nnz/s", "vs_baseline": N}

The headline is the Pauli-SpMV throughput (matrix nonzeros per second per
chip) of the matrix-free matvec on the largest MBL-Heisenberg full-space
config that completed — the hot kernel under every evolve()/eigsolve().

vs_baseline is the ratio against 1e10 nnz/s — a speed-of-light estimate for
the reference implementation on one CPU node (the reference is
memory-bandwidth-bound, docs/FAQ.rst:33-47: ~200 GB/s node bandwidth /
~16 bytes per nonzero touched ~= 1.25e10; rounded down to 1e10 since the
reference publishes no measured numbers — BASELINE.md).

Failure behaviour:
* a stage that finds no GPU fails; nothing falls back to the CPU;
* every stage subprocess has a hard timeout (its failure -> a JSON line
  with ok=false, and the harness moves on);
* full-space stages run smallest-L first, so a headline number exists
  early;
* SIGTERM/SIGINT to the orchestrator (e.g. an outer `timeout`) prints the
  headline from whatever stages already completed;
* the orchestrator exits non-zero when no stage completed.

Stages share JAX's persistent compilation cache
(dynamite_tpu/utils/compile_cache.py).

Measurement protocol (per stage): `reps` applications are chained inside
ONE jitted lax.fori_loop and the timed region ends with a host fetch of a
checksum depending on every application — so neither per-dispatch latency
nor async-dispatch undercounting pollutes the number. Reference analog of
the harness: benchmarking/benchmark.py:244-313.
"""

import json
import os
import signal
import subprocess
import sys
import time

# (name, argv-params, timeout seconds)
STAGES = [
    ('full_L20', {'kind': 'full', 'L': 20, 'reps': 200}, 420),
    ('full_L24', {'kind': 'full', 'L': 24, 'reps': 50}, 420),
    ('spinconserve_L24', {'kind': 'spinconserve', 'L': 24, 'reps': 50}, 480),
    # SYK at representative scale: N=32 Majoranas (35,960 terms), the
    # XOR-dense channel engine with tables resident
    ('syk_N32', {'kind': 'syk', 'L': 16, 'reps': 10}, 420),
    ('evolve_L20', {'kind': 'evolve', 'L': 20}, 300),
    # the BASELINE north-star solver metrics at L=24: Lanczos ground state
    # in the half-filling sector + half-chain entanglement entropy of the
    # ground state (reference harness: benchmarking/benchmark.py:244-313)
    ('eigsolve_L24', {'kind': 'eigsolve_sc', 'L': 24}, 600),
    # expmv wall time at L=24 (full space, the GPU XOR kernel inside the
    # fused Lanczos substep)
    ('evolve_L24', {'kind': 'evolve', 'L': 24}, 600),
    # double precision on hardware: Lanczos ground state + device residual
    ('double_L16', {'kind': 'double_eig', 'L': 16}, 420),
    # double precision at production scale: the sector engine in f64
    # (SpinConserve half filling, dim 705,432)
    ('double_L22', {'kind': 'double_eig_sc', 'L': 22}, 600),
]

# selectable by name only (e.g. `python bench.py full_L8` in CI)
EXTRA_STAGES = [
    ('full_L8', {'kind': 'full', 'L': 8, 'reps': 2}, 120),
    ('syk_N40', {'kind': 'syk', 'L': 20, 'reps': 5,
                 'budget': 11 << 30}, 600),
    ('longrange_L24', {'kind': 'longrange_sc', 'L': 24, 'reps': 20}, 600),
    ('syk_N36', {'kind': 'syk', 'L': 18, 'reps': 3}, 600),
    # scaling points for the sector engine: L=26 (dim 1.04e7) and L=28
    # (dim 4.0e7)
    ('spinconserve_L26', {'kind': 'spinconserve', 'L': 26, 'reps': 20},
     600),
    ('spinconserve_L28', {'kind': 'spinconserve', 'L': 28, 'reps': 10},
     600),
]

BASELINE = 1e10  # see module docstring


def _emit(obj):
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------
# stage implementations (run inside the per-stage subprocess)
# --------------------------------------------------------------------------

def _timed_loop(fn, x, reps):
    """Chain `reps` applications of fn inside one jitted loop; time the
    second call (the first compiles + warms up). Also splits the one-time
    cost into trace time (jaxpr construction, a pure-Python cost) vs the
    rest (XLA compile), so the compile-latency budget is attributable."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from dynamite_tpu.utils.hoist import hjit

    def body(v):
        v = lax.fori_loop(0, reps, lambda i, w: fn(w), v)
        return jnp.sum(v * v)

    t0 = time.perf_counter()
    jax.make_jaxpr(body)(x)
    trace_s = time.perf_counter() - t0

    # hjit, not jit: ELL-engine kernels capture large device tables that
    # must be hoisted to runtime args, not inlined as MLIR constants
    loop = hjit(body)

    t0 = time.perf_counter()
    chk = float(loop(x))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chk = float(loop(x))
    elapsed = time.perf_counter() - t0
    assert chk == chk  # finite, not NaN
    return elapsed, compile_s, trace_s


def _random_state(dim, dtype):
    import jax
    import jax.numpy as jnp
    x = jax.random.normal(jax.random.PRNGKey(0), (2, dim), dtype)
    x = x / jnp.linalg.norm(x)
    x.block_until_ready()
    return x


def _normalized(H):
    import numpy as np
    H.scale(1.0 / float(np.sum(np.abs(H.msc['coeffs']))))
    return H


def stage_full(L, reps):
    """Full-space MBL matvec: the GPU XOR kernel (ops/xor_triton.py)."""
    import jax.numpy as jnp
    from dynamite_tpu import config
    from dynamite_tpu.models import localized
    from dynamite_tpu.subspaces import Full

    config.L = L

    H = _normalized(localized(L))
    sub = Full(L=L)
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)

    dim = 1 << L
    x = _random_state(dim, jnp.float32)
    elapsed, compile_s, trace_s = _timed_loop(fn, x, reps)

    nnz = dim * H.nnz
    per_apply = elapsed / reps
    result = {
        'nnz_per_sec': nnz * reps / elapsed,
        'ms_per_apply': per_apply * 1e3,
        'compile_s': compile_s,
        'trace_s': trace_s,
        'nnz_per_row': H.nnz,
        'dim': dim,
        'engine': kernel.engine,
    }
    return result


def stage_spinconserve(L, reps):
    """SpinConserve (half filling) matvec: the sector-blocked engine
    (dense per-sector matmuls; ops/sector_apply.py)."""
    import jax.numpy as jnp
    from dynamite_tpu import config
    from dynamite_tpu.models import heisenberg
    from dynamite_tpu.subspaces import SpinConserve

    config.L = L

    H = _normalized(heisenberg(L))
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)

    dim = sub.get_dimension()
    x = _random_state(dim, jnp.float32)
    elapsed, compile_s, trace_s = _timed_loop(fn, x, reps)
    nnz = dim * H.nnz
    result = {
        'nnz_per_sec': nnz * reps / elapsed,
        'ms_per_apply': elapsed / reps * 1e3,
        'compile_s': compile_s,
        'trace_s': trace_s,
        'dim': dim,
    }
    sp = kernel.sector_plan
    if sp is not None:
        result['engine'] = 'sector'
        result['sector_channels'] = sp.n_channels
        result['sector_table_mb'] = round(sp.table_bytes / 1e6, 2)
    return result


def stage_syk(L, reps, budget=None):
    """SYK with 2L Majorana modes: many mask groups -> the XOR-blocked
    dense channel engine (ops/xor_dense.py)."""
    import jax.numpy as jnp
    from dynamite_tpu import config
    from dynamite_tpu.models import syk
    from dynamite_tpu.subspaces import Parity

    config.L = L
    if budget:
        config.ell_budget = int(budget)

    H = _normalized(syk(L))
    sub = Parity('even', L=L)
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)

    dim = sub.get_dimension()
    x = _random_state(dim, jnp.float32)
    elapsed, compile_s, trace_s = _timed_loop(fn, x, reps)
    nnz = dim * H.nnz
    result = {
        'nnz_per_sec': nnz * reps / elapsed,
        'ms_per_apply': elapsed / reps * 1e3,
        'compile_s': compile_s,
        'trace_s': trace_s,
        'dim': dim,
        'nterms': len(H.msc),
    }
    if kernel.xor_dense_info is not None:
        result['engine'] = 'xor_dense'
        result.update({f'xd_{k}': v
                       for k, v in kernel.xor_dense_info.items()})
    return result


def stage_double_eig(L):
    """Double precision on hardware: ground state of the MBL chain at L
    via thick-restart Lanczos, with the device-computed residual
    ||Hv - lambda v|| as the accuracy certificate (the reference's default
    build is complex double throughout, petsc_config/complex-opt.py)."""
    import jax.numpy as jnp
    from dynamite_tpu import config
    from dynamite_tpu.models import localized
    from dynamite_tpu.subspaces import Full
    from dynamite_tpu.computations import eigsolve

    config.L = L

    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)

    t0 = time.perf_counter()
    evals, evecs = eigsolve(H, nev=1, getvecs=True, tol=1e-12)
    wall_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals, evecs = eigsolve(H, nev=1, getvecs=True, tol=1e-12)
    wall = time.perf_counter() - t0

    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)
    v = evecs[0].data[:, :1 << L]
    hv = fn(v)
    lam = float(evals[0])
    res = hv - lam * v
    resid = float(jnp.linalg.norm(res)) / max(abs(lam), 1e-300)
    return {
        'eigsolve_s': wall,
        'eigsolve_cold_s': wall_cold,
        'eval0': lam,
        'relative_residual': resid,
        'dim': 1 << L,
        'precision': 'double',
    }


def stage_eigsolve_sc(L):
    """BASELINE north-star solver metrics at L=24: MBL-Heisenberg ground
    state in the half-filling SpinConserve sector (sector engine inside
    thick-restart Lanczos), plus the half-chain entanglement entropy of the
    ground state (RDM phase; reference benchmark.py's eigsolve+RDM
    phases)."""
    import numpy as np
    import jax.numpy as jnp
    from dynamite_tpu import config
    from dynamite_tpu.models import localized
    from dynamite_tpu.subspaces import SpinConserve
    from dynamite_tpu.computations import (eigsolve, entanglement_entropy,
                                           last_solve_stats)

    config.L = L

    H = localized(L)
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)

    t0 = time.perf_counter()
    evals, evecs = eigsolve(H, nev=1, getvecs=True)
    wall_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals, evecs = eigsolve(H, nev=1, getvecs=True)
    wall = time.perf_counter() - t0
    from dynamite_tpu import computations
    stats = computations.last_solve_stats

    # device-side residual certificate
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)
    dim = sub.get_dimension()
    v = evecs[0].data[:, :dim]
    hv = fn(v)
    lam = float(evals[0])
    resid = float(jnp.linalg.norm(hv - lam * v)) / max(abs(lam), 1e-300)

    t0 = time.perf_counter()
    S = float(entanglement_entropy(evecs[0], keep=range(L // 2)))
    entropy_s = time.perf_counter() - t0

    return {
        'eigsolve_s': wall,
        'eigsolve_cold_s': wall_cold,
        'matvecs': stats.get('matvecs'),
        'restarts': stats.get('restarts'),
        'eval0': lam,
        'relative_residual': resid,
        'entropy_half_chain': S,
        'entropy_s': entropy_s,
        'dim': dim,
    }


def stage_double_eig_sc(L):
    """Double precision at production scale: MBL ground state in the
    half-filling sector through the sector engine in f64, with the
    device residual as the 1e-10-class certificate (the reference's
    default build is complex128 throughout, petsc_config/complex-opt.py)."""
    import jax.numpy as jnp
    from dynamite_tpu import config
    from dynamite_tpu.models import localized
    from dynamite_tpu.subspaces import SpinConserve
    from dynamite_tpu.computations import eigsolve

    config.L = L

    H = localized(L)
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)

    t0 = time.perf_counter()
    evals, evecs = eigsolve(H, nev=1, getvecs=True, tol=1e-12)
    wall_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals, evecs = eigsolve(H, nev=1, getvecs=True, tol=1e-12)
    wall = time.perf_counter() - t0

    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)
    dim = sub.get_dimension()
    v = evecs[0].data[:, :dim]
    hv = fn(v)
    lam = float(evals[0])
    resid = float(jnp.linalg.norm(hv - lam * v)) / max(abs(lam), 1e-300)
    return {
        'eigsolve_s': wall,
        'eigsolve_cold_s': wall_cold,
        'eval0': lam,
        'relative_residual': resid,
        'dim': dim,
        'precision': 'double',
    }


def stage_longrange_sc(L, reps):
    """Long-range XXZ in the half-filling sector: O(L^2) mask groups —
    the >512-group sector-engine regime (SECTOR_GROUP_LIMIT)."""
    import jax.numpy as jnp
    from dynamite_tpu import config
    from dynamite_tpu.models import long_range
    from dynamite_tpu.subspaces import SpinConserve

    config.L = L

    H = _normalized(long_range(L))
    H.allow_projection = True
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)

    dim = sub.get_dimension()
    x = _random_state(dim, jnp.float32)
    elapsed, compile_s, trace_s = _timed_loop(fn, x, reps)
    nnz = dim * H.nnz
    result = {
        'nnz_per_sec': nnz * reps / elapsed,
        'ms_per_apply': elapsed / reps * 1e3,
        'compile_s': compile_s,
        'trace_s': trace_s,
        'dim': dim,
        'groups': len(kernel.plan.groups),
        'engine': 'sector' if kernel.sector_plan is not None else 'other',
    }
    if kernel.sector_plan is not None:
        result['sector_channels'] = kernel.sector_plan.n_channels
        result['sector_table_mb'] = round(
            kernel.sector_plan.table_bytes / 1e6, 2)
    return result


def stage_evolve(L):
    """End-to-end evolve() wall time (Expokit-style stepping, Lanczos inner
    loop) on the MBL chain at t=1.0."""
    from dynamite_tpu import config
    from dynamite_tpu.models import localized
    from dynamite_tpu.states import State
    from dynamite_tpu.subspaces import Full
    from dynamite_tpu.computations import evolve

    config.L = L

    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    psi = State(state='random', subspace=sub, seed=42)

    t0 = time.perf_counter()
    r1 = evolve(H, psi, 0.1)  # compile + warmup (same program as below)
    r1.data.block_until_ready()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    r = evolve(H, psi, 1.0)
    r.data.block_until_ready()
    elapsed = time.perf_counter() - t0
    nrm = r.norm()
    assert abs(nrm - 1.0) < 1e-3, nrm
    return {
        'evolve_s': elapsed,
        'compile_s': compile_s,
        'dim': 1 << L,
    }


KINDS = {
    'full': lambda p: stage_full(p['L'], p['reps']),
    'spinconserve': lambda p: stage_spinconserve(p['L'], p['reps']),
    'syk': lambda p: stage_syk(p['L'], p['reps'], p.get('budget')),
    'evolve': lambda p: stage_evolve(p['L']),
    'double_eig': lambda p: stage_double_eig(p['L']),
    'eigsolve_sc': lambda p: stage_eigsolve_sc(p['L']),
    'double_eig_sc': lambda p: stage_double_eig_sc(p['L']),
    'longrange_sc': lambda p: stage_longrange_sc(p['L'], p['reps']),
}


DOUBLE_KINDS = ('double_eig', 'double_eig_sc')


def run_stage_child(params_json):
    """One stage, in its own process: on the GPU or not at all."""
    import jax
    from dynamite_tpu import config
    from dynamite_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    params = json.loads(params_json)
    precision = 'double' if params['kind'] in DOUBLE_KINDS else 'single'
    config.initialize(precision=precision, gpu=True)
    devices = jax.devices()
    result = KINDS[params['kind']](params)
    result.update(platform=devices[0].platform,
                  device_kind=devices[0].device_kind,
                  device_count=len(devices))
    _emit(result)


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

def _headline(results):
    """Build the headline metric line from whatever completed."""
    best = None
    for name, res in results.items():
        if name.startswith('full_') and res.get('ok'):
            L = res['params']['L']
            if best is None or L > best[0]:
                best = (L, res)
    if best is None:
        return {'metric': 'pauli_spmv_mbl_nnz_per_sec_per_chip',
                'value': 0.0, 'unit': 'nnz/s', 'vs_baseline': 0.0,
                'error': 'no full-space stage completed'}
    L, res = best
    v = res['nnz_per_sec']
    return {'metric': f'pauli_spmv_L{L}_mbl_nnz_per_sec_per_chip',
            'value': v, 'unit': 'nnz/s', 'vs_baseline': v / BASELINE}


def _card():
    """The card's name and power limit, read by a child that stays off
    JAX (a card below its 700 W maximum runs slower under load)."""
    try:
        proc = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f'unavailable: {e!r}'
    return proc.stdout.strip()


def main():
    results = {}
    card = _card()

    def emit_headline(*_args):
        _emit(_headline(results))
        sys.exit(0 if any(r['ok'] for r in results.values()) else 1)

    signal.signal(signal.SIGTERM, emit_headline)
    signal.signal(signal.SIGINT, emit_headline)

    total_budget = float(os.environ.get('BENCH_BUDGET', 1800))
    t_start = time.perf_counter()

    only = sys.argv[1:] if len(sys.argv) > 1 else None

    def run_one(name, params, stage_timeout):
        remaining = total_budget - (time.perf_counter() - t_start)
        if remaining < 30:
            _emit({'stage': name, 'ok': False, 'skipped': 'out of budget'})
            return
        budget = min(stage_timeout, remaining)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--stage',
                 json.dumps(params)],
                capture_output=True, text=True, timeout=budget,
                cwd=os.path.dirname(os.path.abspath(__file__)) or '.')
            wall = time.perf_counter() - t0
            line = None
            for ln in reversed(proc.stdout.strip().splitlines()):
                try:
                    line = json.loads(ln)
                    break
                except json.JSONDecodeError:
                    continue
            if proc.returncode == 0 and line is not None:
                rec = {'stage': name, 'ok': True, 'wall_s': round(wall, 2),
                       'card': card,
                       **{k: (float(f'{v:.4g}') if isinstance(v, float)
                              else v)
                          for k, v in line.items()}}
                results[name] = {'ok': True, 'params': params, **line}
                _emit(rec)
                return
            tail = (proc.stderr or proc.stdout or '').strip(
                ).splitlines()[-3:]
            rec = {'stage': name, 'ok': False, 'rc': proc.returncode,
                   'card': card, 'tail': ' | '.join(tail)[-300:]}
        except subprocess.TimeoutExpired:
            rec = {'stage': name, 'ok': False, 'timeout_s': budget,
                   'card': card}
        results[name] = {'ok': False, 'params': params}
        _emit(rec)

    stages = STAGES + (EXTRA_STAGES if only else [])
    stages = [s for s in stages if not only or s[0] in only]
    for name, params, stage_timeout in stages:
        run_one(name, params, stage_timeout)

    emit_headline()


if __name__ == '__main__':
    if len(sys.argv) >= 3 and sys.argv[1] == '--stage':
        run_stage_child(sys.argv[2])
    else:
        main()
