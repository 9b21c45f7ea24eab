"""
Generates the tutorial notebooks. Each notebook is defined as a list of
(kind, source) cells; run this script to (re)write the .ipynb files.
Execute-tested with `jupyter nbconvert --execute` on the CPU backend.
"""
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))

SETUP = """\
# tutorial setup: run on the CPU backend with a small virtual device mesh
import os
os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ.setdefault('XLA_FLAGS', '--xla_force_host_platform_device_count=4')
import sys
sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), '..', '..')))
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np"""


def nb(cells):
    out = {
        'cells': [],
        'metadata': {'kernelspec': {'display_name': 'Python 3',
                                    'language': 'python',
                                    'name': 'python3'},
                     'language_info': {'name': 'python'}},
        'nbformat': 4, 'nbformat_minor': 5,
    }
    for kind, src in cells:
        cell = {'cell_type': kind, 'metadata': {},
                'source': src.splitlines(keepends=True)}
        if kind == 'code':
            cell['outputs'] = []
            cell['execution_count'] = None
        out['cells'].append(cell)
    return out


NOTEBOOKS = {}

NOTEBOOKS['0-Welcome.ipynb'] = [
('markdown', """\
# Welcome to the dynamite_tpu tutorial

`dynamite_tpu` computes the dynamics and eigenstates of quantum many-body
spin-1/2 systems at large scale, on NVIDIA GPUs (and anywhere JAX runs): symbolic
Pauli-string Hamiltonians, Krylov time evolution `exp(-iHt)|psi>`, Lanczos
eigensolving, symmetry subspaces, and state vectors sharded across a device
mesh.

The notebooks in this directory:

1. **Operators** — building Hamiltonians from Pauli strings
2. **States** — state vectors, initialization, measurement
3. **Eigensolving** — ground states and interior eigenvalues
4. **TimeEvolution** — real and imaginary time
5. **Subspaces** — symmetry sectors that shrink the Hilbert space
6. **MatrixFree** — memory, the compute engines, and the device mesh

Every notebook runs as-is on CPUs (they force the CPU backend with a small
virtual device mesh, so the distributed code paths are exercised without
hardware). On a GPU, remove the `JAX_PLATFORMS` override and set
`config.precision = 'single'` for the fast path.
"""),
]

NOTEBOOKS['1-Operators.ipynb'] = [
('markdown', """\
# Building operators

Hamiltonians are sums of Pauli strings. `dynamite_tpu` stores them
symbolically (as mask/sign/coefficient integer triples), so an operator
costs kilobytes no matter how large the Hilbert space is — the matrix
itself is never stored.
"""),
('code', SETUP),
('markdown', """\
### The Pauli matrices

`sigmax(i)`, `sigmay(i)`, `sigmaz(i)` are the Pauli operators on spin `i`
(default `i=0`).
"""),
('code', """\
from dynamite_tpu.operators import sigmax, sigmay, sigmaz
sigmaz(0)"""),
('code', """\
# operators print as their symbolic form
print(sigmax(1))
print(sigmay(2))"""),
('markdown', """\
### Combining operators

`+` and `*` work as expected (`*` is the operator product, or scalar
multiplication). `op_sum` and `op_product` combine iterables of operators.
"""),
('code', """\
from dynamite_tpu.operators import op_sum, op_product
ZZ = sigmaz(0) * sigmaz(1)
H_two = ZZ + 0.5 * (sigmax(0) + sigmax(1))
print(H_two)"""),
('markdown', """\
### Specifying the spin chain length

Operators are symbolic, so the chain length `L` only needs to be fixed when
a matrix-sized object is needed. Set it per-operator with `.L`, or globally
with `config.L`.
"""),
('code', """\
from dynamite_tpu import config
config.L = 8   # global default for everything created below
ZZ.get_length()  # minimum L implied by the operator's support"""),
('markdown', """\
### Translating operators along the chain

`index_sum` sums translated copies of an operator along the chain
(open boundaries by default; `boundary='closed'` wraps). `index_product`
is the multiplicative analog.
"""),
('code', """\
from dynamite_tpu.operators import index_sum

# transverse-field Ising chain on L=8 spins
H = index_sum(sigmaz(0) * sigmaz(1)) + 0.5 * index_sum(sigmax(0))
H"""),
('code', """\
# closed (periodic) boundary conditions
ring = index_sum(sigmaz(0) * sigmaz(1), boundary='closed')
print(ring.nterms, 'terms on the ring vs', index_sum(sigmaz(0)*sigmaz(1)).nterms, 'on the open chain')"""),
('markdown', """\
### Working with explicit matrices

For small systems you can materialize the matrix to check against numpy or
scipy — `to_numpy()` returns a scipy sparse matrix. (Internally no matrix
is ever built; this is a debugging path.)
"""),
('code', """\
H_sp = H.to_numpy()
H_sp"""),
('code', """\
# Hermiticity, numerically
dense = np.asarray(H_sp.todense())
assert np.allclose(dense, dense.conj().T)
dense.shape"""),
('markdown', """\
### Saving and loading

`H.save(path)` writes the compact symbolic form; `Operator.load(path)`
restores it bit-exactly.
"""),
('code', """\
from dynamite_tpu.operators import Operator
import tempfile
with tempfile.TemporaryDirectory() as d:
    H.save(d + '/ising.dnm')
    H2 = Operator.load(d + '/ising.dnm')
assert H2 == H
print('round-tripped:', H2.nterms, 'terms')"""),
]

NOTEBOOKS['2-States.ipynb'] = [
('markdown', """\
## States

A `State` is a vector in the 2^L-dimensional Hilbert space (or a symmetry
subspace of it — see notebook 5). On a multi-device mesh the amplitudes are
sharded across devices; on CPU here, across the virtual mesh.
"""),
('code', SETUP),
('code', """\
from dynamite_tpu import config
from dynamite_tpu.states import State
config.L = 8"""),
('markdown', """\
Product states are specified with a string (`U`p/`D`own, or `0`/`1`), or an
integer bitstring. `'random'` gives a normalized random vector, `'uniform'`
the equal superposition.
"""),
('code', """\
psi = State(state='UUUUDDDD')
print(psi)"""),
('code', """\
rand = State(state='random', seed=42)
print(rand.norm())   # normalized"""),
('markdown', """\
Vector algebra works directly on states, and `dot` takes inner products.
"""),
('code', """\
phi = State(state='uniform')
combo = 0.5 * psi + 0.5 * phi
print(abs(combo.dot(psi))**2)   # overlap probability"""),
('markdown', """\
`project(i, v)` projectively measures spin `i` onto value `v` (renormalizing),
and `entanglement_entropy` measures bipartite entanglement.
"""),
('code', """\
rand.project(0, 0)
print(rand.entanglement_entropy(keep=range(4)))"""),
('markdown', """\
`to_numpy()` gathers the amplitudes to a host array (for small systems /
debugging); `set_all_by_function` initializes amplitudes from a function of
the basis state.
"""),
('code', """\
import numpy as np
v = psi.to_numpy()
print('nonzeros:', np.flatnonzero(v))"""),
('markdown', """\
States stream to and from disk in bounded-memory chunks — checkpointing
works at any size.
"""),
('code', """\
import tempfile
with tempfile.TemporaryDirectory() as d:
    rand.save(d + '/ckpt')
    back = State.from_file(d + '/ckpt')
print(np.max(np.abs(back.to_numpy() - rand.to_numpy())))"""),
]

NOTEBOOKS['3-Eigensolving.ipynb'] = [
('markdown', """\
## Eigensolving

`H.eigsolve()` computes a few eigenpairs of a Hamiltonian with a
thick-restart Lanczos iteration that runs entirely on the device mesh
(the analog of the reference dynamite's SLEPc eigensolvers).
"""),
('code', SETUP),
('markdown', """\
### Ground state of the transverse-field Ising model
"""),
('code', """\
from dynamite_tpu import config
from dynamite_tpu.operators import sigmax, sigmaz, index_sum
config.L = 10

H = index_sum(sigmaz(0) * sigmaz(1)) + 0.5 * index_sum(sigmax(0))
E0 = H.eigsolve()          # lowest eigenvalue by default
print('ground state energy:', E0[0])"""),
('code', """\
# check against dense numpy at this small size
w = np.linalg.eigvalsh(np.asarray(H.to_numpy().todense()))
print('dense oracle:   ', w[0])"""),
('code', """\
# eigenvectors come back as States
evals, evecs = H.eigsolve(nev=2, getvecs=True)
gs = evecs[0]
print('residual:', (H.dot(gs) - evals[0] * gs).norm())"""),
('markdown', """\
`which='highest'` / `'exterior'` select other ends of the spectrum.
"""),
('code', """\
print('highest:', H.eigsolve(which='highest')[0], 'vs dense', w[-1])"""),
('markdown', """\
### Interior eigenvalues

`target=` finds the eigenvalues closest to a given value — the hard case
for iterative methods. The reference dynamite needs a parallel direct
solver (MUMPS) and refuses matrix-free mode; here the shift-invert inverse
is applied iteratively (an inner MINRES solve fused into the outer
Lanczos), so it works matrix-free.
"""),
('code', """\
# use a disordered (MBL) chain: its spectrum has no exact degeneracies,
# which makes "the k closest eigenvalues" well-defined
from dynamite_tpu.models import localized
H_mbl = localized(10)
w_mbl = np.linalg.eigvalsh(np.asarray(H_mbl.to_numpy().todense()))
target = 0.5 * (w_mbl[len(w_mbl)//2] + w_mbl[len(w_mbl)//2 + 1])
evals = H_mbl.eigsolve(nev=2, target=target)
closest = w_mbl[np.argsort(np.abs(w_mbl - target))[:2]]
print('computed:', np.sort(evals))
print('oracle:  ', np.sort(closest))
assert np.allclose(np.sort(evals), np.sort(closest), atol=1e-8)"""),
('markdown', """\
Solver diagnostics for the last solve (iteration counts, phase wall times —
the analog of PETSc's `-log_view`) are collected automatically.
"""),
('code', """\
from dynamite_tpu import computations
computations.last_solve_stats"""),
]

NOTEBOOKS['4-TimeEvolution.ipynb'] = [
('markdown', """\
## Time evolution

`H.evolve(state, t)` computes `exp(-iHt)|psi>` with an adaptive Krylov
(Expokit-style) integrator: substeps of adaptively chosen length, each one
a Lanczos factorization fused into a single device program.
"""),
('code', SETUP),
('code', """\
from dynamite_tpu import config
from dynamite_tpu.models import heisenberg
from dynamite_tpu.states import State
config.L = 8

H = heisenberg(8)          # isotropic Heisenberg chain from the model zoo
psi0 = State(state='UDUDUDUD')
psi_t = H.evolve(psi0, t=2.0)
print('norm after evolution:', psi_t.norm())"""),
('code', """\
# compare against scipy's expm_multiply at this small size
from scipy.sparse.linalg import expm_multiply
oracle = expm_multiply(-2.0j * H.to_numpy(), psi0.to_numpy())
print('max deviation:', np.max(np.abs(psi_t.to_numpy() - oracle)))"""),
('markdown', """\
Observables along a quench: evolve in steps and measure.
"""),
('code', """\
from dynamite_tpu.operators import sigmaz
Sz0 = 0.5 * sigmaz(0)
Sz0.L = 8
state = psi0
for step in range(3):
    state = H.evolve(state, t=0.5)
    print(f't={0.5*(step+1):3.1f}  <Sz_0> = {Sz0.expectation(state):+.4f}')"""),
('markdown', """\
Imaginary time (`t = -1j * beta`) projects toward the ground state —
renormalize after each step.
"""),
('code', """\
beta_state = H.evolve(psi0, t=-2j)
beta_state.normalize()
print('energy after imaginary-time evolution:', H.expectation(beta_state))
print('ground state energy:                  ', H.eigsolve()[0])"""),
('markdown', """\
The integrator's substep count, matvecs, and host round-trips for the last
evolve are in `computations.last_solve_stats`; `config.profile_dir` writes
full `jax.profiler` traces.
"""),
('code', """\
from dynamite_tpu import computations
computations.last_solve_stats"""),
]

NOTEBOOKS['5-Subspaces.ipynb'] = [
('markdown', """\
# Using subspaces

When the Hamiltonian has a symmetry, the state vector only needs the
dimensions of one symmetry sector. Subspaces implement index<->state
bijections that are fused directly into the matvec kernels, so the full
space never materializes. They compose with sharding: the reduced vector is
what gets distributed over the device mesh.
"""),
('code', SETUP),
('markdown', """\
## SpinConserve

For Hamiltonians that conserve total magnetization (Heisenberg, XXZ, ...),
`SpinConserve(L, k)` keeps the states with exactly `k` down spins:
dimension C(L, k) instead of 2^L.
"""),
('code', """\
from dynamite_tpu import config
from dynamite_tpu.models import heisenberg
from dynamite_tpu.subspaces import SpinConserve
from dynamite_tpu.states import State

L = 10
H = heisenberg(L)
sub = SpinConserve(L, L // 2)
H.add_subspace(sub)
print('full dim:', 2**L, ' subspace dim:', sub.get_dimension())"""),
('code', """\
E0 = H.eigsolve(subspace=sub)
print('half-filling ground state energy:', E0[0])"""),
('markdown', """\
### XParity

On top of `SpinConserve(L, L/2)` (or Parity/Full), the global spin-flip
symmetry `XParity` halves the dimension again. It is not a product-state
basis; operators are rewritten onto it automatically.
"""),
('code', """\
from dynamite_tpu.subspaces import XParity
xp = XParity(SpinConserve(L, L // 2), sector='+')
H.add_subspace(xp)
print('dim with XParity:', xp.get_dimension())
print('ground state (+ sector):', H.eigsolve(subspace=xp)[0])"""),
('markdown', """\
## Parity

`Parity('even')` / `Parity('odd')` keep states with an even/odd number of
down spins — conserved e.g. by transverse-field Ising.
"""),
('code', """\
from dynamite_tpu.operators import sigmax, sigmaz, index_sum
from dynamite_tpu.subspaces import Parity
config.L = 10
H_tfim = index_sum(sigmax(0) * sigmax(1)) + 0.5 * index_sum(sigmaz(0))
even = Parity('even')
H_tfim.add_subspace(even)
print(H_tfim.eigsolve(subspace=even)[0])"""),
('markdown', """\
## Explicit

`Explicit(states)` takes an arbitrary list of product states — useful for
custom sectors or Krylov-subspace tricks.
"""),
('code', """\
from dynamite_tpu.subspaces import Explicit
keep = [s for s in range(2**10) if bin(s).count('1') in (4, 5, 6)]
ex = Explicit(keep, L=10)
print('explicit dim:', ex.get_dimension())"""),
('markdown', """\
## Auto

`Auto` discovers the symmetry sector connected to a seed state by a
breadth-first search over the Hamiltonian's term graph.
"""),
('code', """\
from dynamite_tpu.subspaces import Auto
H2 = heisenberg(10)
auto = Auto(H2, 'UUUUUDDDDD')
print('auto-discovered dim:', auto.get_dimension(),
      '== C(10,5) =', __import__('math').comb(10, 5))"""),
('markdown', """\
The conservation check runs on device before any matrix is built; using a
non-conserved subspace raises unless `allow_projection=True` is set
explicitly.
"""),
('code', """\
H_bad = heisenberg(10) + 0.3 * sigmax(0)   # breaks magnetization conservation
H_bad.add_subspace(SpinConserve(10, 5))
try:
    H_bad.build_mat()
except ValueError as e:
    print('refused, as expected:', str(e)[:60], '...')"""),
]

NOTEBOOKS['6-MatrixFree.ipynb'] = [
('markdown', """\
# Matrix-free computation, memory, and the device mesh

In the reference dynamite, "shell" (matrix-free) mode is an option; here it
is the only mode — no sparse matrix is ever stored. An operator's memory is
its symbolic term list, so the budget is set by the *state vectors*:
`2 * dim * 4` bytes each in single precision.
"""),
('code', SETUP),
('code', """\
from dynamite_tpu import config
from dynamite_tpu.models import syk
config.L = 8

H = syk(8)   # all-to-all SYK on 16 Majorana modes: many, many terms
print('terms:', H.nterms)
print('operator memory estimate (GB):', H.estimate_memory())
print('with ncv=30 Krylov workspace (GB):', H.estimate_memory(ncv=30))"""),
('markdown', """\
Under the hood, the compute engines serve the matrix-free matvec, chosen
automatically: a hand-written GPU kernel for XOR-structured
subspace pairs, dense-matmul engines for SpinConserve and SYK, a
precomputed gather ("ELL") engine for general subspaces
and many-term operators like SYK, and an XLA term-sweep fallback. See
`docs/performance.md` for how each engine works.
"""),
('code', """\
from dynamite_tpu.subspaces import Parity
sub = Parity('even', L=8)
H.add_subspace(sub)
kernel = H.get_mat(subspaces=(sub, sub))
print(type(kernel).__name__, '- sharded by default:', kernel.sharded_default())"""),
('markdown', """\
### The device mesh

State vectors shard over a 1-D mesh of all visible devices: index high bits
select the device, and each Pauli mask whose support touches those bits
becomes a pairwise device permutation over the interconnect. Dimensions
that don't divide the device count are padded transparently.
"""),
('code', """\
import jax
from dynamite_tpu.states import State
print('devices:', jax.device_count())
psi = State(state='random', subspace=sub, seed=0)
print('storage shape:', psi.data.shape, ' sharding:', psi.data.sharding.spec)"""),
('code', """\
# everything downstream — evolve, eigsolve, entropies — runs sharded
out = H.evolve(psi, t=0.5)
print('evolved norm:', out.norm())"""),
('markdown', """\
On real hardware: run one process per host; all chips of a slice join the
mesh automatically. `config.precision = 'single'` selects the fast float32
path (the default `'double'` matches the reference's tolerances).
"""),
]

NOTEBOOKS['7-Conclusion.ipynb'] = [
('markdown', """\
# Where to go next

* `examples/scripts/` — research-grade examples: MBL level statistics,
  Floquet evolution with checkpoint/resume, SYK correlators, the kagome
  Heisenberg ground state.
* `benchmarks/benchmark.py` — the performance harness (phase timings,
  memory, solver counters).
* `docs/` — performance guide, parallelism model, solver internals, FAQ.

The API mirrors the reference `dynamite` package closely; if you have
existing dynamite scripts, they mostly run after changing the import.
"""),
]


if __name__ == '__main__':
    for name, cells in NOTEBOOKS.items():
        path = os.path.join(HERE, name)
        with open(path, 'w') as f:
            json.dump(nb(cells), f, indent=1)
        print('wrote', name)
