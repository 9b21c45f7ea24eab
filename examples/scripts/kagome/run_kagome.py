"""
Kagome-lattice Heisenberg antiferromagnet on a torus: ground-state energy,
spin gap, and nearest-neighbor spin correlations in the half-filling
magnetization sector, with an optional XParity (Z2 spin-flip) layer — the
spin-liquid workhorse computation (physics as in the reference study,
examples/scripts/kagome/run_kagome.py; implementation reworked for this
framework: sector-engine solve, correlation measurements, solver
statistics, memory estimate).

Usage:
    python run_kagome.py            # the 12-site cluster
    python run_kagome.py 27 --nev 4 --correlations
"""

import sys
import time
from argparse import ArgumentParser

from dynamite_tpu import config
from dynamite_tpu.operators import sigmax, sigmay, sigmaz, op_sum
from dynamite_tpu.subspaces import SpinConserve, XParity
from dynamite_tpu import computations
from dynamite_tpu.computations import eigsolve
from dynamite_tpu.tools import mpi_print

from lattice_library import kagome_clusters, basis_to_graph


def exchange(i, j, scale=0.25):
    """S_i . S_j written in Pauli operators (scale 1/4 converts sigma to
    spin-1/2 operators)."""
    return scale * op_sum(s(i) * s(j) for s in (sigmax, sigmay, sigmaz))


def cluster_model(name, relabel=True):
    """(H, edges, labels): nearest-neighbor J=1 Heisenberg on the chosen
    torus cluster. With ``relabel`` (default), sites are renamed by
    tools.spectral_site_order so bonds cluster within bit halves — the
    sector engine then merges most bonds into shared matrices (27-site
    torus: 28 -> 12 half-crossing bonds). ``edges`` is in the relabeled
    site names; ``labels[new] = old`` recovers the lattice-library names
    for reporting."""
    _, edges = basis_to_graph(kagome_clusters[name])
    n = 1 + max(max(i, j) for i, j in edges)
    if relabel:
        from dynamite_tpu.tools import spectral_site_order
        to_new = spectral_site_order(n, edges)
        edges = [(int(to_new[i]), int(to_new[j])) for i, j in edges]
        labels = {int(to_new[o]): o for o in range(n)}
    else:
        labels = {i: i for i in range(n)}
    return op_sum(exchange(i, j) for i, j in edges), edges, labels


def ground_state_sector(n_sites, use_z2):
    """The symmetry sector expected to contain the ground state: total
    magnetization zero, and — when the Z2 layer applies — the XParity
    sector fixed by n_sites mod 4."""
    sub = SpinConserve(n_sites, n_sites // 2)
    if not use_z2 or n_sites % 2:
        return sub, None
    sector = +1 if n_sites % 4 == 0 else -1
    return XParity(sub, sector=sector), sector


def main(argv=None):
    args = parse_args(argv)

    if args.precision is not None:
        config.precision = args.precision

    H, edges, labels = cluster_model(
        args.cluster, relabel=not args.no_relabel)
    n = H.get_length()
    sub, sector = ground_state_sector(n, not args.no_z2)

    mpi_print(f'kagome cluster {args.cluster!r}: {n} sites, '
              f'{len(edges)} bonds')
    mpi_print(f'sector: {sub!r}' + (
        '' if sector is None else f'  (Z2 sector {sector:+d})'))
    H.subspace = sub
    mpi_print(f'sector dimension: {sub.get_dimension()}, estimated device '
              f'memory: {H.estimate_memory(ncv=40):.3f} GB')

    t0 = time.perf_counter()
    want_vecs = args.correlations
    result = eigsolve(H, nev=args.nev, getvecs=want_vecs, ncv=args.ncv,
                      tol=args.tol)
    evals = result[0] if want_vecs else result
    wall = time.perf_counter() - t0

    e0 = float(evals[0])
    mpi_print(f'E0 = {e0:.12f}   (E0/N = {e0 / n:.12f})')
    if len(evals) > 1:
        gap = float(evals[1]) - e0
        mpi_print(f'gap = {gap:.12f}   (gap/N = {gap / n:.12f})')
    stats = computations.last_solve_stats or {}
    mpi_print(f'solve: {wall:.2f} s, {stats.get("matvecs", "?")} matvecs, '
              f'{stats.get("restarts", "?")} restarts, '
              f'{stats.get("verify_cycles", "?")} verification cycles')

    if args.correlations:
        # nearest-neighbor spin correlations <S_i . S_j> in the ground
        # state: uniform values signal a liquid, strong bond alternation a
        # valence-bond solid
        gs = result[1][0]
        mpi_print()
        mpi_print('bond correlations <S_i . S_j>:')
        for (i, j) in edges:
            op = exchange(i, j)
            op.subspace = sub
            val = op.expectation(gs)
            oi, oj = labels[i], labels[j]
            mpi_print(f'  ({oi:2d},{oj:2d}): {val:+.6f}')

    return e0


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument('cluster', default='12', nargs='?',
                   help='Kagome cluster name (see lattice_library.py)')
    p.add_argument('--nev', type=int, default=2,
                   help='number of eigenpairs (default 2: energy + gap)')
    p.add_argument('--no-z2', action='store_true',
                   help='skip the XParity (Z2) symmetry layer')
    p.add_argument('--no-relabel', action='store_true',
                   help='keep the lattice-library site order instead of '
                        'the sector-friendly spectral reordering')
    p.add_argument('--correlations', action='store_true',
                   help='also measure nearest-neighbor spin correlations '
                        'in the ground state')
    p.add_argument('--precision', choices=('single', 'double'),
                   default=None,
                   help="override config.precision ('single' is the fast "
                        'path; see docs/performance.md)')
    p.add_argument('--tol', type=float, default=None,
                   help='residual tolerance (default: precision-dependent)')
    p.add_argument('--ncv', type=int, default=None,
                   help='Krylov space dimension (smaller fits bigger '
                        'clusters in device memory)')
    return p.parse_args(argv)


if __name__ == '__main__':
    main(sys.argv[1:])
