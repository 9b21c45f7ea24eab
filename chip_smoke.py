#!/usr/bin/env python3
"""
Smoke test of the solver path on the GPU.

Drives Operator -> get_mat -> engine -> computations.evolve / eigsolve /
entanglement_entropy through the public API, at the sizes bench.py uses,
and checks every phase against a plain reference:

    python chip_smoke.py            # one GPU: phases a-e
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases (one GPU):
  a. matvec    localized(24), Full, f32, dim 2^24 (the GPU XOR kernel)
  b. evolve    the same operator, evolve(psi, t=1) from a random state
  c. eigsolve  localized(24), SpinConserve(24, 12), f32 (sector engine),
               then the half-chain entanglement entropy, its reduced
               density matrix checked against the host's
  d. syk       syk(16) (N=32 Majoranas), Parity('even') (XOR-dense engine)
  e. double    localized(22), SpinConserve(22, 11), precision='double'
  f. kernel    the XOR kernel of phase a against the plain XLA sweep and
               the host apply at the same width; then the tests marked
               ``gpu`` (pytest -m gpu) on the card

The parent process stays off JAX. Phases a-d and f's comparison run in one
child process, phase e in a second and the gpu tests in a third, each after
the one before has exited: x64 is process-global, and a JAX process
reserves most of the card's memory, so only one process holds the card at
a time. Each phase prints its engine, its compile time,
its wall time after warm-up, the device's peak_bytes_in_use so far, and its
error beside its tolerance. Any failure exits non-zero; the last line,
printed only when every phase passed, is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 1234
RESULT_TAG = 'CHIP_SMOKE_RESULT '

# Tolerances, with their reasons.
# f32 rounding (2^-24) over at most a few hundred terms per row stays below
# 1e-6 relative; an f32 matmul taken in TF32 (10-bit mantissa) gives ~1e-3.
MATVEC_TOL = 1e-5
# Expokit is run at its default tol 1e-7 per unit time; in f32 each unitary
# substep still drifts the norm by ~1e-7 * sqrt(substeps).
EVOLVE_NORM_TOL = 1e-4
# evolve(evolve(psi, 1), -1) == psi: two f32 evolutions at dim 2^24, each
# holding its state to ~1e-5 in the 2-norm.
EVOLVE_ROUNDTRIP_TOL = 1e-3
# <H> is conserved by the exact propagator; relative to ||H||_inf, the f32
# Krylov projection keeps it to well under 1e-4.
EVOLVE_ENERGY_TOL = 1e-4
# device relative residual ||Hv - lambda v|| / |lambda| of the f32 ground
# state (eigsolve's default tol); TF32 matmuls stall it near 1e-3
EIG_RESID_TOL = 1e-4
# the device RDM of the ground state against the host one: f32 rounding over
# the 2^(L/2)-term sums stays near 1e-6 of the largest entry; TF32 products
# give ~1e-3
RDM_TOL = 1e-5
# the BASELINE.md north star for double precision
DOUBLE_RESID_TOL = 1e-10

SIZES = {
    'full_L': 24,     # phases a, b (and the --multi XOR path)
    'sc_L': 24,       # phase c (and the --multi ring sector engine)
    'syk_L': 16,      # phase d: 2L = 32 Majoranas
    'double_L': 22,   # phase e
}


# --------------------------------------------------------------------------
# the plain reference: a host numpy apply, independent of every JAX engine
# --------------------------------------------------------------------------

def _parity(v):
    """popcount(v) & 1 of a non-negative integer array."""
    count = getattr(np, 'bitwise_count', None)  # numpy >= 2.0
    if count is not None:
        return (count(v) & 1).astype(np.int64)
    v = v.copy()
    shift = 1
    while shift < 8 * v.itemsize:
        v ^= v >> shift
        shift *= 2
    return v & 1


def host_apply(msc, left, right, x):
    """y = H x in complex128 on the host, from the operator's MSC terms.

    y[row] = sum_t c_t (-1)^parity(bra & s_t) x[col(bra)] with
    bra = state(row) ^ m_t, dropping bras outside the right subspace.
    ``x`` is a complex vector of the right subspace's dimension."""
    x = np.asarray(x, dtype=np.complex128)
    dim_left = left.get_dimension()
    states = np.asarray(left.idx_to_state(np.arange(dim_left)), np.int64)
    y = np.zeros(dim_left, np.complex128)
    masks = msc['masks'].astype(np.int64)
    for m in np.unique(masks):
        sel = masks == m
        bra = states ^ m
        cols = np.asarray(right.state_to_idx(bra), np.int64)
        coeff = np.zeros(dim_left, np.complex128)
        for s, c in zip(msc['signs'][sel].astype(np.int64),
                        msc['coeffs'][sel]):
            coeff += c * (1 - 2 * _parity(bra & s))
        ok = cols >= 0
        y[ok] += coeff[ok] * x[cols[ok]]
    return y


def _rel_err(got, want):
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) / scale


# --------------------------------------------------------------------------
# phases (run in a child process)
# --------------------------------------------------------------------------

def _peak_bytes(device=None):
    import jax
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get('peak_bytes_in_use')


def _report(phase, engine, compile_s, wall_s, checks, **extra):
    """Print one phase's lines; returns whether every check passed.
    ``checks`` maps a name to (value, tolerance, passed)."""
    print(f'[{phase}] engine: {engine}', flush=True)
    print(f'[{phase}] compile_s={compile_s:.6g} wall_s={wall_s:.6g} '
          f'peak_bytes_in_use={_peak_bytes()}', flush=True)
    ok = True
    for name, (value, tol, passed) in checks.items():
        print(f'[{phase}] {name}={value:.6g} tol={tol:g} '
              f'{"ok" if passed else "FAIL"}', flush=True)
        ok = ok and passed
    for k, v in extra.items():
        print(f'[{phase}] {k}={v}', flush=True)
    return ok


def _random_host_state(dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, dim)).astype(np.float32)
    return x / np.linalg.norm(x)


def _time_apply(fn, x, reps):
    """(compile_s, seconds per apply after warm-up, y)."""
    t0 = time.perf_counter()
    y = fn(x)
    y.block_until_ready()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(x)
    y.block_until_ready()
    return compile_s, (time.perf_counter() - t0) / reps, y


def _matvec_check(phase, H, sub, reps):
    """(passed, kernel, device input, host reference result)."""
    import jax.numpy as jnp
    kernel = H.get_mat(subspaces=(sub, sub))
    dim = sub.get_dimension()
    xh = _random_host_state(dim, SEED)
    x = jnp.asarray(xh)
    compile_s, wall_s, y = _time_apply(kernel.apply, x, reps)
    y = np.asarray(y)
    want = host_apply(H.msc, sub, sub, xh[0] + 1j * xh[1])
    err = _rel_err(y[0] + 1j * y[1], want)
    ok = _report(phase, kernel.engine, compile_s, wall_s,
                 {'max_rel_err': (err, MATVEC_TOL, err <= MATVEC_TOL)},
                 dim=dim, nterms=len(H.msc))
    return ok, kernel, x, want


def phase_matvec(L):
    """Phase a, and phase f's comparison of the hand-written kernel with
    the plain XLA sweep at the same width."""
    from dynamite_tpu.models import localized
    from dynamite_tpu.subspaces import Full
    from dynamite_tpu.utils.hoist import hjit
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    ok, kernel, x, want = _matvec_check('a.matvec', H, sub, reps=20)
    if kernel.engine != 'xor_triton':
        print('[f.kernel] FAIL: the XOR kernel did not serve phase a',
              flush=True)
        return False
    name, sweep = kernel.sweep_callable()
    compile_s, wall_s, ys = _time_apply(hjit(sweep), x, 20)
    ys = np.asarray(ys)
    y = np.asarray(kernel.apply(x))
    err_host = _rel_err(ys[0] + 1j * ys[1], want)
    err_kernel = _rel_err(y[0] + 1j * y[1], ys[0] + 1j * ys[1])
    return _report('f.kernel', f'{name} (plain XLA) beside xor_triton',
                   compile_s, wall_s, {
                       'sweep_rel_err_vs_host': (err_host, MATVEC_TOL,
                                                 err_host <= MATVEC_TOL),
                       'kernel_rel_err_vs_sweep': (err_kernel, MATVEC_TOL,
                                                   err_kernel <= MATVEC_TOL),
                   }) and ok


def phase_evolve(L):
    from dynamite_tpu.computations import evolve
    from dynamite_tpu.models import localized
    from dynamite_tpu.states import State
    from dynamite_tpu.subspaces import Full
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    psi = State(state='random', subspace=sub, seed=SEED)

    t0 = time.perf_counter()
    evolve(H, psi, 1.0).data.block_until_ready()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = evolve(H, psi, 1.0)
    out.data.block_until_ready()
    wall_s = time.perf_counter() - t0

    back = evolve(H, out, -1.0)
    norm_err = abs(out.norm() - 1.0)
    roundtrip = (back - psi).norm()
    e0 = psi.dot(H.dot(psi)).real
    e1 = out.dot(H.dot(out)).real
    scale = H.infinity_norm(subspaces=(sub, sub))
    drift = abs(e1 - e0) / scale
    kernel = H.get_mat(subspaces=(sub, sub))
    return _report('b.evolve', kernel.engine, compile_s, wall_s, {
        'norm_err': (norm_err, EVOLVE_NORM_TOL, norm_err <= EVOLVE_NORM_TOL),
        'roundtrip_err': (roundtrip, EVOLVE_ROUNDTRIP_TOL,
                          roundtrip <= EVOLVE_ROUNDTRIP_TOL),
        'energy_drift': (drift, EVOLVE_ENERGY_TOL,
                         drift <= EVOLVE_ENERGY_TOL),
    }, dim=len(psi))


def _ground_state_residual(H, sub, tol, resid_tol, phase):
    import jax.numpy as jnp
    from dynamite_tpu import computations
    from dynamite_tpu.computations import eigsolve
    t0 = time.perf_counter()
    eigsolve(H, nev=1, getvecs=True, tol=tol)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals, evecs = eigsolve(H, nev=1, getvecs=True, tol=tol)
    wall_s = time.perf_counter() - t0
    stats = dict(computations.last_solve_stats)

    kernel = H.get_mat(subspaces=(sub, sub))
    dim = sub.get_dimension()
    v = evecs[0].data[:, :dim]
    lam = float(evals[0])
    resid = float(jnp.linalg.norm(kernel.apply(v) - lam * v)) / abs(lam)
    ok = _report(phase, kernel.engine, compile_s, wall_s,
                 {'rel_residual': (resid, resid_tol, resid <= resid_tol)},
                 dim=dim, eval0=repr(lam), matvecs=stats.get('matvecs'))
    return ok, evecs[0]


def host_rdm_low(v, sub, k):
    """rho over spins 0..k-1 (the low k bits) of the subspace vector v, in
    complex128 on the host: rho[r, r'] = sum_t psi(t, r) psi*(t, r')."""
    full = np.zeros(1 << sub.L, np.complex128)
    full[np.asarray(sub.idx_to_state(np.arange(len(v))), np.int64)] = v
    M = full.reshape(-1, 1 << k)   # [traced bits, kept bits]
    return M.T @ M.conj()


def phase_eigsolve(L):
    from dynamite_tpu.computations import (entanglement_entropy,
                                           reduced_density_matrix)
    from dynamite_tpu.models import localized
    from dynamite_tpu.subspaces import SpinConserve
    H = localized(L)
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)
    ok, gs = _ground_state_residual(H, sub, None, EIG_RESID_TOL,
                                    'c.eigsolve')
    keep = range(L // 2)
    t0 = time.perf_counter()
    entanglement_entropy(gs, keep)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    S = float(entanglement_entropy(gs, keep))
    wall_s = time.perf_counter() - t0
    want = host_rdm_low(gs.to_numpy(), sub, L // 2)
    err = _rel_err(reduced_density_matrix(gs, keep), want)
    w = np.linalg.eigvalsh(want)
    w = w[w > 0]
    S_host = float(-np.sum(w * np.log(w)))
    ok_s = _report('c.entropy', 'weight-block RDM', compile_s, wall_s,
                   {'rdm_max_rel_err': (err, RDM_TOL, err <= RDM_TOL)},
                   entropy=S, entropy_host=S_host)
    return ok and ok_s


def phase_syk(L):
    from dynamite_tpu.models import syk
    from dynamite_tpu.subspaces import Parity
    H = syk(L)
    sub = Parity('even', L=L)
    H.add_subspace(sub)
    return _matvec_check('d.syk', H, sub, reps=10)[0]


def phase_double(L):
    from dynamite_tpu.models import localized
    from dynamite_tpu.subspaces import SpinConserve
    H = localized(L)
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)
    ok, _ = _ground_state_residual(H, sub, 1e-12, DOUBLE_RESID_TOL,
                                   'e.double')
    return ok


def phase_multi(full_L, sc_L):
    """The sharded paths on every device of the mesh, each compared with
    the one-device result computed in this process on device 0 and with
    the host apply."""
    import jax
    from dynamite_tpu import config
    from dynamite_tpu.computations import evolve
    from dynamite_tpu.models import localized
    from dynamite_tpu.parallel.mesh import make_mesh
    from dynamite_tpu.states import State
    from dynamite_tpu.subspaces import Full, SpinConserve

    dev0 = jax.devices()[0]
    ok = True
    for phase, sub in (('m.xor', Full(L=full_L)),
                       ('m.sector_ring', SpinConserve(sc_L, sc_L // 2))):
        H = localized(sub.L)
        H.add_subspace(sub)
        kernel = H.get_mat(subspaces=(sub, sub))
        psi = State(state='random', subspace=sub, seed=SEED)
        dim = len(psi)
        compile_s, wall_s, y = _time_apply(kernel.apply, psi.data, reps=10)
        y = np.asarray(y)[:, :dim]
        x = psi.to_numpy()
        one = np.asarray(kernel.apply(jax.device_put(
            psi.data[:, :dim], dev0)))
        want = host_apply(H.msc, sub, sub, x)
        err_host = _rel_err(y[0] + 1j * y[1], want)
        err_one = _rel_err(y[0] + 1j * y[1], one[0] + 1j * one[1])
        ok &= _report(phase, f'{kernel.sharded_engine} (one device: '
                      f'{kernel.engine})', compile_s, wall_s, {
                          'rel_err_vs_host': (err_host, MATVEC_TOL,
                                              err_host <= MATVEC_TOL),
                          'rel_err_vs_one_device': (err_one, MATVEC_TOL,
                                                    err_one <= MATVEC_TOL),
                      }, dim=dim, devices=config.mesh.devices.size)

    # one evolve substep of the sharded Krylov loop against the same
    # evolution on a one-device mesh
    from dynamite_tpu import computations
    sub = Full(L=full_L)
    H = localized(full_L)
    H.add_subspace(sub)
    psi = State(state='random', subspace=sub, seed=SEED)
    t = 0.05
    t0 = time.perf_counter()
    evolve(H, psi, t).data.block_until_ready()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = evolve(H, psi, t)
    out.data.block_until_ready()
    wall_s = time.perf_counter() - t0
    substeps = computations.last_solve_stats.get('substeps')
    got = out.to_numpy()

    mesh = config.mesh
    try:
        config.mesh = make_mesh(devices=[dev0])
        H1 = localized(full_L)
        H1.add_subspace(sub)
        psi1 = State(subspace=sub)
        psi1.set_all_numpy(psi.to_numpy())
        want = evolve(H1, psi1, t).to_numpy()
    finally:
        config.mesh = mesh
    err = float(np.linalg.norm(got - want))
    engine = H.get_mat(subspaces=(sub, sub)).sharded_engine
    ok &= _report('m.evolve_substep', f'sharded Krylov ({engine})',
                  compile_s, wall_s, {
                      'err_vs_one_device': (err, EVOLVE_ROUNDTRIP_TOL,
                                            err <= EVOLVE_ROUNDTRIP_TOL)},
                  substeps=substeps, t=t)
    for d in jax.devices():
        print(f'[multi] {d} peak_bytes_in_use={_peak_bytes(d)}', flush=True)
    return ok


def _device_info():
    import jax
    d = jax.devices()
    return {'platform': d[0].platform, 'kind': d[0].device_kind,
            'count': len(d)}


def run_child(which):
    """Run one child's phases on the GPU; returns (all passed, device
    info)."""
    from dynamite_tpu import config
    from dynamite_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    precision = 'double' if which == 'double' else 'single'
    config.initialize(precision=precision, gpu=True)
    import jax
    print(f'jax.devices(): {jax.devices()}', flush=True)
    info = _device_info()
    print(f'device_kind: {info["kind"]}', flush=True)
    if info['platform'] != 'gpu':
        raise RuntimeError(f'no GPU: JAX reports {info["platform"]}')

    if which == 'single':
        phases = [lambda: phase_matvec(SIZES['full_L']),
                  lambda: phase_evolve(SIZES['full_L']),
                  lambda: phase_eigsolve(SIZES['sc_L']),
                  lambda: phase_syk(SIZES['syk_L'])]
    elif which == 'double':
        phases = [lambda: phase_double(SIZES['double_L'])]
    elif which == 'multi':
        if info['count'] != 4:
            raise RuntimeError(f'--multi needs 4 GPUs, found '
                               f'{info["count"]}')
        phases = [lambda: phase_multi(SIZES['full_L'], SIZES['sc_L'])]
    else:
        raise ValueError(which)
    ok = True
    for phase in phases:
        ok = phase() and ok
    return ok, info


# --------------------------------------------------------------------------
# parent: stays off JAX
# --------------------------------------------------------------------------

def _nvidia_smi():
    """The card's name and power limit; exits when there is no NVIDIA
    driver."""
    try:
        proc = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise SystemExit(f'chip_smoke: nvidia-smi failed, no NVIDIA GPU: {e}')
    return proc.stdout.strip()


def _run_child_process(which):
    """Run one child, echoing its output; returns its result dict."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--child', which],
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    result = None
    for line in proc.stdout:
        if line.startswith(RESULT_TAG):
            result = json.loads(line[len(RESULT_TAG):])
        else:
            print(line, end='', flush=True)
    rc = proc.wait()
    if rc != 0 or result is None:
        raise SystemExit(f'chip_smoke: the {which!r} child failed (rc={rc})')
    return result


def _run_gpu_tests():
    """Phase f's second half: the tests marked ``gpu``, on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DYNAMITE_TEST_PLATFORM='gpu')
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', '-m', 'gpu', '-q', '-rs',
         '-p', 'no:cacheprovider', 'tests/'],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    summary = proc.stdout.strip().splitlines()[-1:] or ['']
    print(f'[f.gpu_tests] {summary[0]}', flush=True)
    ok = (proc.returncode == 0 and ' passed' in summary[0]
          and 'skipped' not in summary[0])
    if not ok:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
    print(f'[f.gpu_tests] {"ok" if ok else "FAIL"}', flush=True)
    return ok


def main(argv):
    if len(argv) == 2 and argv[0] == '--child':
        ok, info = run_child(argv[1])
        print(RESULT_TAG + json.dumps({'ok': ok, 'device': info}),
              flush=True)
        return 0
    if argv not in ([], ['--multi']):
        raise SystemExit('usage: chip_smoke.py [--multi]')

    print(f'nvidia-smi: {_nvidia_smi()}', flush=True)
    children = ['multi'] if argv else ['single', 'double']
    results = [_run_child_process(which) for which in children]
    tests_ok = argv or _run_gpu_tests()
    if not (tests_ok and all(r['ok'] for r in results)):
        print('chip_smoke: a phase failed its check', flush=True)
        return 1
    device = results[0]['device']
    if device['platform'] != 'gpu':
        return 1
    print(json.dumps({'ok': True, 'device': device}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
