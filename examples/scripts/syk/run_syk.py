"""
SYK out-of-time-order correlators: imaginary-time Krylov evolution to
prepare thermal states, then real-time evolutions sandwiching Majorana
operators to compute C(t) = 2 Re<psi| W(t) V W(t) V |psi> + 1/2.

JAX port of the reference study (reference:
examples/scripts/SYK/run_syk.py), exercising cross-sector subspace pairs
(the Majoranas map between the even and odd Parity sectors).

Usage: python run_syk.py -N 12 -b 0.5 -t 0.5
"""

import sys
from argparse import ArgumentParser
from itertools import combinations

import numpy as np

from dynamite_tpu import config
from dynamite_tpu.operators import op_sum, op_product
from dynamite_tpu.extras import majorana
from dynamite_tpu.subspaces import Parity
from dynamite_tpu.states import State
from dynamite_tpu.tools import mpi_print


def build_hamiltonian(N, rng):
    """All-to-all 4-Majorana interactions with Gaussian couplings."""
    majoranas = [majorana(i) for i in range(N)]

    def products():
        for idxs in combinations(range(N), 4):
            p = op_product(majoranas[i] for i in idxs)
            p.scale(rng.normal())
            yield p

    H = op_sum(products())
    H.scale(np.sqrt(6 / N ** 3))
    return H


def compute_otoc(psi0, psi1, t, H, W, V):
    """C = 2*Re(<psi1| W(t) V W(t) V |psi0>) + 0.5, W(t) = e^{iHt} W e^{-iHt}.
    psi0 is used as scratch; psi1 is untouched."""
    tmp_odd_0 = V * psi0
    tmp_odd_1 = H.evolve(tmp_odd_0, t=t)
    W.dot(tmp_odd_1, result=psi0)
    tmp_even = H.evolve(psi0, t=-t)
    V.dot(tmp_even, result=tmp_odd_0)
    H.evolve(tmp_odd_0, t=t, result=tmp_odd_1)
    W.dot(tmp_odd_1, result=psi0)
    H.evolve(psi0, t=-t, result=tmp_even)
    return 2 * psi1.dot(tmp_even).real + 0.5


def main():
    args = parse_args()

    mpi_print('== Run parameters: ==', file=sys.stderr)
    for key, value in vars(args).items():
        mpi_print(f'  {key}, {value}', file=sys.stderr)
    seed = args.seed if args.seed is not None else \
        int.from_bytes(__import__('os').urandom(4), 'big')
    mpi_print(f'  seed, {seed}', file=sys.stderr)
    rng = np.random.RandomState(seed % 2**32)
    mpi_print(file=sys.stderr)

    config.L = (args.N + 1) // 2

    # the Hamiltonian conserves Z-basis spin parity; the Majoranas map
    # between the sectors
    even_space = Parity('even')
    odd_space = Parity('odd')

    W = majorana(0)
    V = majorana(1)
    for op in (W, V):
        op.add_subspace(even_space, odd_space)
        op.add_subspace(odd_space, even_space)

    sorted_beta = sorted(args.b)
    mpi_print('beta,t,C')

    for _ in range(args.H_iters):
        H = build_hamiltonian(args.N, rng)
        H.add_subspace(even_space)
        H.add_subspace(odd_space)

        for _ in range(args.state_iters):
            psi0 = State(state='random', subspace=even_space)
            psi1 = psi0.copy()

            for i, b in enumerate(sorted_beta):
                delta_b = b if i == 0 else b - sorted_beta[i - 1]

                # imaginary-time evolution e^{-delta_b/2 H}, re-using the
                # previous beta's state
                H.evolve(psi0, t=-1j * delta_b, result=psi1)
                psi1.normalize()
                psi1.copy(result=psi0)

                for t in args.t:
                    result = compute_otoc(psi0, psi1, t, H, W, V)
                    mpi_print(f'{b},{t},{result}')
                    psi1.copy(result=psi0)


def parse_args():
    parser = ArgumentParser(description='Compute OTOCs for the SYK model.')
    parser.add_argument('-N', default=30, type=int,
                        help='number of majoranas')
    parser.add_argument('-b', default=[0.5],
                        type=lambda s: [float(x) for x in s.split(',')])
    parser.add_argument('-t', default=[0.5],
                        type=lambda s: [float(x) for x in s.split(',')])
    parser.add_argument('--H-iters', default=1, type=int)
    parser.add_argument('--state-iters', default=1, type=int)
    parser.add_argument('-s', '--seed', type=lambda x: int(x, 0))
    return parser.parse_args()


if __name__ == '__main__':
    main()
