"""
Many-body localization phase diagram: disorder-averaged entanglement entropy
and adjacent-gap ratio of mid-spectrum eigenstates of the random-field
Heisenberg chain, in the half-filling SpinConserve sector.

JAX port of the reference study (reference:
examples/scripts/MBL/run_mbl.py). Interior eigenpairs come from the
spectral-fold + Rayleigh-Ritz 'target' mode instead of MUMPS shift-invert.

Usage: python run_mbl.py -L 12 --iters 2
"""

import sys
from argparse import ArgumentParser

import numpy as np

from dynamite_tpu import config
from dynamite_tpu.operators import sigmax, sigmay, sigmaz, index_sum
from dynamite_tpu.subspaces import SpinConserve
from dynamite_tpu.tools import mpi_print


def build_hamiltonian(h, rng):
    """Nearest-neighbor Heisenberg + random Z fields of strength h.
    Factors of 0.25/0.5 convert Paulis to spin-1/2 operators."""
    heis = 0.25 * sum(s(0) * s(1) for s in (sigmax, sigmay, sigmaz))
    H = index_sum(heis)
    H += sum(0.5 * rng.uniform(-h, h) * sigmaz(i) for i in range(config.L))
    return H


def eig_stats(evals, evecs):
    """Mean half-chain entanglement entropy and adjacent-gap ratio."""
    entropy = np.mean([v.entanglement_entropy(keep=range(config.L // 2))
                       for v in evecs])
    evals = np.sort(evals)
    gaps = np.diff(evals)
    ratios = np.minimum(gaps[:-1], gaps[1:]) / np.maximum(gaps[:-1],
                                                          gaps[1:])
    return entropy, float(np.mean(ratios)) if len(ratios) else float('nan')


def main():
    args = parse_args()

    mpi_print('== Run parameters: ==', file=sys.stderr)
    for key, value in vars(args).items():
        mpi_print(f'  {key}, {value}', file=sys.stderr)

    seed = args.seed if args.seed is not None else \
        int.from_bytes(__import__('os').urandom(4), 'big')
    mpi_print(f'  seed, {seed}', file=sys.stderr)
    rng = np.random.RandomState(seed % 2**32)

    config.L = args.L
    config.subspace = SpinConserve(args.L, args.L // 2)

    mpi_print('h,energy_point,entropy,ratio')

    for _ in range(args.iters):
        for h in np.linspace(args.h_min, args.h_max, args.h_points):
            H = build_hamiltonian(h, rng)

            evals, evecs = H.eigsolve(nev=args.nev, getvecs=True)
            entropy, ratio = eig_stats(evals, evecs)
            mpi_print(f'{h}, 0, {entropy}, {ratio}')
            min_eval = evals[0]

            evals, evecs = H.eigsolve(nev=args.nev, which='highest',
                                      getvecs=True)
            entropy, ratio = eig_stats(evals, evecs)
            mpi_print(f'{h}, 1, {entropy}, {ratio}')
            max_eval = evals[0]

            for ept in np.linspace(0, 1, args.energy_points)[1:-1]:
                tgt = min_eval + ept * (max_eval - min_eval)
                evals, evecs = H.eigsolve(nev=args.nev, target=tgt,
                                          getvecs=True)
                entropy, ratio = eig_stats(evals, evecs)
                mpi_print(f'{h}, {ept}, {entropy}, {ratio}')


def parse_args():
    parser = ArgumentParser()
    parser.add_argument('-L', type=int, required=True)
    parser.add_argument('--seed', type=lambda x: int(x, 0))
    parser.add_argument('--iters', type=int, default=16,
                        help='number of disorder realizations')
    parser.add_argument('--energy-points', type=int, default=3)
    parser.add_argument('--h-points', type=int, default=5)
    parser.add_argument('--h-min', type=float, default=1)
    parser.add_argument('--h-max', type=float, default=5)
    parser.add_argument('--nev', type=int, default=8,
                        help='eigenpairs per spectrum point')
    return parser.parse_args()


if __name__ == '__main__':
    main()
