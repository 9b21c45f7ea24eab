"""
Distributed SpinConserve at scale: matvec + Lanczos through the
memory-scaling ring sector engine (ops/sector_shard.py) on a device mesh.

This is the configuration the reference's multi-node story is built around
(L=30 half filling, dim C(30,15) = 155,117,520 — the BASELINE multi-chip
flagship; reference bar: the curated L=30 test set that takes ~4.5 h on a
CPU node, tests/integration/test_sets/L30.tests:2-3). On real hardware the
mesh spans the host's GPUs; with --virtual the same program runs on virtual
CPU devices to validate the sharding (how the test suite exercises
multi-device paths without GPUs).

Example (virtual 8-device mesh, one Lanczos step at L=30):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python run_sharded.py -L 30 --ndev 8 --virtual -m 2
"""

import argparse
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument('-L', type=int, default=30)
    p.add_argument('-k', type=int, default=None, help='default L//2')
    p.add_argument('--ndev', type=int, default=8)
    p.add_argument('-m', type=int, default=2, help='Lanczos steps')
    p.add_argument('--virtual', action='store_true',
                   help='force the CPU backend (virtual mesh)')
    p.add_argument('--precision', choices=('single', 'double'),
                   default='single')
    args = p.parse_args()

    import os
    if args.virtual:
        flags = os.environ.get('XLA_FLAGS', '')
        if '--xla_force_host_platform_device_count' not in flags:
            os.environ['XLA_FLAGS'] = (
                flags + f' --xla_force_host_platform_device_count='
                f'{args.ndev}').strip()
    import jax
    if args.virtual:
        jax.config.update('jax_platforms', 'cpu')

    from dynamite_tpu import config
    from dynamite_tpu.models import heisenberg
    from dynamite_tpu.subspaces import SpinConserve
    from dynamite_tpu.parallel.mesh import make_mesh, storage_dim
    from dynamite_tpu.solvers.eigs import random_start
    from dynamite_tpu.computations import _state_sharding

    L = args.L
    k = args.k if args.k is not None else L // 2
    config.precision = args.precision
    config.L = L
    # the sector tables at L=30 need ~4 GB in f32 (sharded over the mesh
    # for the col family); lift the default build budget accordingly
    config.ell_budget = 16 << 30
    config._initialize()
    config.mesh = make_mesh(mesh_shape=(args.ndev,))

    from math import comb
    dim = comb(L, k)
    print(f'L={L} k={k} dim={dim:,} ndev={args.ndev} '
          f'precision={args.precision}', flush=True)

    t0 = time.perf_counter()
    H = heisenberg(L)
    sub = SpinConserve(L, k)
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=True)
    print(f'plan+tables: {time.perf_counter() - t0:.1f} s', flush=True)
    sp = kernel.sector_plan
    if sp is not None:
        print(f'sector engine: {sp.n_channels} channels, '
              f'{sp.table_bytes / 1e9:.2f} GB tables', flush=True)

    sharding = _state_sharding(dim, True)
    sdim = storage_dim(dim, config.mesh)
    v0 = random_start(dim, config.real_dtype, seed=1, sharding=sharding,
                      storage_dim=sdim)
    v0.block_until_ready()

    t0 = time.perf_counter()
    y = kernel.sharded_fn(v0)
    y.block_until_ready()
    print(f'matvec (incl. compile): {time.perf_counter() - t0:.1f} s',
          flush=True)
    t0 = time.perf_counter()
    y = kernel.sharded_fn(v0)
    y.block_until_ready()
    dt = time.perf_counter() - t0
    nnz = dim * H.nnz
    print(f'matvec warm: {dt:.2f} s  ({nnz / dt:.3e} nnz/s)', flush=True)

    kops = kernel.krylov_ops(args.m, sharded=True)
    t0 = time.perf_counter()
    V, alpha, beta = kops.lanczos(v0)
    jax.block_until_ready((V, alpha, beta))
    print(f'{args.m}-step Lanczos (incl. compile): '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    print('alpha', np.asarray(alpha))
    print('beta', np.asarray(beta))
    a = np.asarray(alpha, dtype=np.float64)
    b = np.asarray(beta, dtype=np.float64)
    T = np.diag(a)
    for j in range(args.m - 1):
        T[j, j + 1] = T[j + 1, j] = b[j]
    ritz = np.linalg.eigvalsh(T)
    print(f'Ritz values after {args.m} steps: {ritz}')
    print('OK', flush=True)


if __name__ == '__main__':
    main()
