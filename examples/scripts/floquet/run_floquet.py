"""
Floquet heating: repeatedly evolve under a long-range Hamiltonian for period
T and apply a global pi-pulse X, tracking the effective energy, half-chain
entanglement entropy, and per-site <Sz> — with checkpoint/resume.

JAX port of the reference study (reference:
examples/scripts/floquet/run_floquet.py), including its
checkpoint-every-N-cycles + resume-by-glob pattern.

Usage: python run_floquet.py -L 10 --n-cycles 20 --checkpoint-every 10
"""

import sys
from argparse import ArgumentParser
from glob import glob
from os import remove
from os.path import join

from dynamite_tpu import config
from dynamite_tpu.operators import (sigmax, sigmay, sigmaz, index_sum,
                                    index_product, op_sum)
from dynamite_tpu.states import State
from dynamite_tpu.computations import entanglement_entropy
from dynamite_tpu.tools import mpi_print


def build_hamiltonian(alpha, Jz, Jx, h):
    long_range_ZZ = op_sum(
        1 / r ** alpha * index_sum(0.25 * sigmaz(0) * sigmaz(r))
        for r in range(1, config.L))
    nearest_neighbor_XX = index_sum(0.25 * sigmax(0) * sigmax(1))
    magnetic_field = index_sum(
        op_sum(hi * 0.5 * s()
               for hi, s in zip(h, (sigmax, sigmay, sigmaz))))
    return Jz * long_range_ZZ + Jx * nearest_neighbor_XX + magnetic_field


def domain_wall_state_str(dwalls, L):
    """A string like 'UUUUDDDDUUUU' with the given number of domain walls."""
    if dwalls >= L:
        raise ValueError('cannot have more domain walls than the number of '
                         'spins - 1')
    c = 'U'
    rtn = ''
    for domain_idx in range(dwalls + 1):
        rtn += c * ((L - len(rtn)) // (dwalls - domain_idx + 1))
        c = 'D' if c == 'U' else 'U'
    return rtn


def print_stats(state, t, tmp, Deff, Sz_ops):
    if t == 0:
        mpi_print('t,Deff_energy,entropy,'
                  + ','.join(f'Sz{i}' for i in range(config.L)))
    Deff_energy = Deff.expectation(state, tmp_state=tmp)
    entropy = entanglement_entropy(state, keep=range(config.L // 2))
    Sz_vals = [op.expectation(state, tmp_state=tmp) for op in Sz_ops]
    mpi_print(t, Deff_energy, entropy, *Sz_vals, sep=',')


def load_checkpoint(path):
    """Resume from the newest floquet_cycle_* checkpoint under path."""
    fnames = glob('floquet_cycle_*.vec', root_dir=path)
    if not fnames:
        return 0, None
    if len(fnames) > 1:
        raise RuntimeError('multiple checkpoint files found')
    fname = fnames[0]
    cycle = int(fname[len('floquet_cycle_'):-len('.vec')])
    state = State.from_file(join(path, fname[:-len('.vec')]))
    return cycle, state  # cycle = last completed; the loop resumes at +1


def main():
    args = parse_args()

    mpi_print('== Run parameters: ==', file=sys.stderr)
    for key, value in vars(args).items():
        mpi_print(f'  {key}, {value}', file=sys.stderr)
    mpi_print(file=sys.stderr)

    config.L = args.L

    if args.checkpoint_every != 0:
        cycle_start, state = load_checkpoint(args.checkpoint_path)
    else:
        cycle_start, state = 0, None

    if state is None:
        state = State(
            state=domain_wall_state_str(args.initial_state_dwalls, args.L))

    H = build_hamiltonian(args.alpha, 1, args.Jx, args.h_vec)
    X = index_product(sigmax())        # the pi pulse
    Deff = (H + X * H * X) / 2         # effective averaged Hamiltonian
    Sz_ops = [0.5 * sigmaz(i) for i in range(args.L)]

    tmp = state.copy()
    if cycle_start == 0:
        print_stats(state, 0, tmp, Deff, Sz_ops)

    for cycle in range(cycle_start + 1, args.n_cycles + 1):
        H.evolve(state, result=tmp, t=args.T)
        X.dot(tmp, result=state)
        print_stats(state, cycle * args.T, tmp, Deff, Sz_ops)

        if args.checkpoint_every != 0 and \
                cycle % args.checkpoint_every == 0:
            state.save(join(args.checkpoint_path,
                            f'floquet_cycle_{cycle}'))
            prev = cycle - args.checkpoint_every
            if prev > 0:
                for fname in glob(join(args.checkpoint_path,
                                       f'floquet_cycle_{prev}*')):
                    remove(fname)


def parse_args():
    parser = ArgumentParser(description='Evolve under a Floquet Hamiltonian')
    parser.add_argument('-L', type=int, default=14)
    parser.add_argument('--Jx', type=float, default=0.19)
    parser.add_argument('--h-vec',
                        type=lambda s: [float(x) for x in s.split(',')],
                        default=[0.21, 0.17, 0.13])
    parser.add_argument('--alpha', type=float, default=1.25)
    parser.add_argument('-T', type=float, default=0.12,
                        help='Floquet period')
    parser.add_argument('--initial-state-dwalls', type=int, default=1)
    parser.add_argument('--n-cycles', type=int, default=int(1e4))
    parser.add_argument('--checkpoint-path', default='./')
    parser.add_argument('--checkpoint-every', default=0, type=int)
    args = parser.parse_args()
    if len(args.h_vec) != 3:
        raise ValueError('--h-vec must be exactly three comma-separated '
                         'numbers')
    return args


if __name__ == '__main__':
    main()
