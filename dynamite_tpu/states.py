"""
Distributed state vectors.

A State's data lives on the device mesh as a real array of shape (2, dim) —
row 0 the real part, row 1 the imaginary part — sharded along the state axis.
The engines all work on real planes, so explicit re/im arithmetic is the
native representation; see :mod:`dynamite_tpu.ops.cvec` for the arithmetic
kernels.

Reference semantics: src/dynamite/states.py (PETSc.Vec wrapper).
"""

import pickle
from functools import partial
from os import urandom

import numpy as np
import jax

from . import config, subspaces
from .utils import validate
from .ops import cvec
from .parallel import mesh as mesh_mod


class UninitializedError(RuntimeError):
    pass


class State:
    """
    A quantum state vector.

    Parameters
    ----------
    state : int or str, optional
        Initial product state (integer bitstring or 'UDDU...'/'0110...'
        string), or 'random' / 'uniform'.

    subspace : Subspace, optional
        The subspace the state lives on (default: config.subspace or Full).

    L : int, optional
        Spin chain length (defaults to config.L / the subspace's L).

    seed : int, optional
        RNG seed when ``state='random'``.
    """

    def __init__(self, state=None, subspace=None, L=None, seed=None):
        if subspace is None:
            subspace = config.subspace if config.subspace is not None \
                else subspaces.Full()
        self._subspace = validate.subspace(subspace)

        if L is not None:
            self.L = L

        self._data = None
        self._initialized = False
        self.repr_binary = True

        if state is not None:
            if state == 'random':
                self.set_random(seed=seed)
            elif state == 'uniform':
                self.set_uniform()
            else:
                self.set_product(state)

    # -- basic properties ----------------------------------------------------

    @property
    def L(self):
        return self.subspace.L

    @L.setter
    def L(self, value):
        if self.L is not None and self.L != value:
            raise ValueError('L is already set to a different value '
                             '(possibly by subspace)')
        self.subspace.L = value

    @property
    def subspace(self):
        return self._subspace

    def __len__(self):
        return self.subspace.get_dimension()

    @property
    def initialized(self):
        return self._initialized

    def set_initialized(self):
        self._initialized = True

    def assert_initialized(self):
        if not self.initialized:
            raise UninitializedError('State vector data has not been set yet')

    @property
    def storage_dim(self):
        """Physical length of the state axis: the subspace dimension padded
        up to a multiple of the device count (see
        :func:`dynamite_tpu.parallel.mesh.storage_dim`). The tail beyond
        ``len(self)`` is an invariant zero."""
        config._initialize()
        return mesh_mod.storage_dim(len(self), config.mesh)

    @property
    def data(self):
        """The (2, storage_dim) re/im device array. Lazily allocated as
        zeros."""
        if self._data is None:
            if self.L is None:
                raise ValueError('must set L first')
            config._initialize()
            dim = len(self)
            self._data = jax.device_put(
                np.zeros((2, mesh_mod.storage_dim(dim, config.mesh)),
                         dtype=config.real_dtype),
                mesh_mod.shard_spec(config.mesh, dim))
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    @property
    def vec(self):
        """Alias of :attr:`data` for rough API parity with the reference's
        ``State.vec`` (there: a petsc4py Vec)."""
        return self.data

    # -- initialization -------------------------------------------------------

    @classmethod
    def str_to_state(cls, s, L):
        """Convert 'UDU...'/'010...' (leftmost char = spin 0) or an integer
        to the product-state integer."""
        if isinstance(s, str):
            if len(s) != L:
                raise ValueError(f'got a {len(s)}-character state string for '
                                 f'a chain of L={L} spins')
            bad = set(s) - set('UD01')
            if bad:
                raise ValueError(f'state string may contain only U/D/0/1; '
                                 f'found {sorted(bad)}')
            state = 0
            for i, c in enumerate(s):
                if c in ('D', '1'):
                    state |= 1 << i
        else:
            state = int(s)
            if state >> L != 0:
                raise ValueError(f'integer {state} (0b{state:b}) needs more '
                                 f'than L={L} bits, so it is not a product '
                                 'state of this chain')
        return state

    def set_product(self, s):
        """Set to the product state ``s`` (integer or string; see
        :meth:`str_to_state`)."""
        if self.L is None and isinstance(s, str):
            self.L = len(s)

        idx = int(self.subspace.state_to_idx(self.str_to_state(s, self.L)))
        if idx == -1:
            raise ValueError('Provided initial state not in requested '
                             'subspace.')

        vec = np.zeros(len(self), dtype=np.complex128)
        vec[idx] = 1
        self.set_all_numpy(vec)

        self.repr_binary = isinstance(s, str) and any(c in '01' for c in s)

    def set_uniform(self):
        """Uniform superposition over the subspace's basis states."""
        dim = len(self)
        vec = np.full(dim, 1 / np.sqrt(dim), dtype=np.complex128)
        self.set_all_numpy(vec)

    def set_random(self, seed=None, normalize=True):
        """Normalized complex Gaussian random state.

        Generated directly on the device mesh (sharded, no host round-trip),
        deterministically from ``seed`` regardless of device count. When no
        seed is given, one is drawn on process 0 and broadcast so that every
        host agrees on the state (same semantics as the reference's
        time-seed broadcast, states.py:253-270).
        """
        if seed is None:
            from .parallel import multihost
            seed = int(multihost.broadcast_from_host0(np.asarray(
                [int.from_bytes(urandom(4), 'big', signed=False)],
                dtype=np.int64))[0])
        config._initialize()
        dim = len(self)
        sdim = mesh_mod.storage_dim(dim, config.mesh)
        sharding = mesh_mod.shard_spec(config.mesh, dim)

        @partial(jax.jit, static_argnums=(1, 2), out_shardings=sharding)
        def _gen(key, n, n_storage):
            # draw exactly (2, n) values so the state is identical for any
            # device count (the storage pad depends on the mesh size and
            # must not shape the draw), then zero-pad the storage tail
            w = jax.random.normal(key, (2, n), dtype=config.real_dtype)
            if n_storage != n:
                w = jax.numpy.pad(w, ((0, 0), (0, n_storage - n)))
            return w

        data = _gen(jax.random.PRNGKey(seed % 2**32), dim, sdim)
        if normalize:
            data = cvec.scale_real(data, 1.0 / float(cvec.norm(data)))
        self._data = data
        self.set_initialized()

    def set_all_by_function(self, val_fn, vectorize=False):
        """Set each element to ``val_fn(state_int)`` evaluated along the
        subspace's basis."""
        dim = len(self)
        vec = np.empty(dim, dtype=np.complex128)
        block = 65536
        for start in range(0, dim, block):
            stop = min(dim, start + block)
            states = self.subspace.idx_to_state(np.arange(start, stop))
            if vectorize:
                vec[start:stop] = val_fn(states)
            else:
                for i, st in zip(range(start, stop), states):
                    vec[i] = val_fn(int(st))
        self.set_all_numpy(vec)

    def set_all_numpy(self, vec):
        """Set the full vector from a host complex array."""
        vec = np.asarray(vec)
        if vec.shape != (len(self),):
            raise ValueError('array shape does not match subspace dimension')
        config._initialize()
        stacked = np.stack([vec.real, vec.imag]).astype(config.real_dtype)
        self._data = mesh_mod.device_put_state(stacked, config.mesh,
                                               len(self))
        self.set_initialized()

    # -- conversions -----------------------------------------------------------

    def to_numpy(self, to_all=True):
        """Return the state as a host complex128 numpy array.

        ``to_all`` is accepted for reference API parity; under jax every host
        process can fetch the full array (multi-host sharded arrays are
        gathered across hosts first).
        """
        self.assert_initialized()
        data = self.data
        if not getattr(data, 'is_fully_addressable', True):
            from jax.experimental import multihost_utils
            data = multihost_utils.process_allgather(data, tiled=True)
        arr = np.asarray(jax.device_get(data), dtype=np.float64)
        arr = arr[:, :len(self)]  # drop the storage pad
        return arr[0] + 1j * arr[1]

    # -- measurement/projection -------------------------------------------------

    def project(self, index, value):
        """Projective measurement: zero all amplitudes where spin ``index``
        is not ``value``, then renormalize. In place."""
        self.assert_initialized()
        if index < 0 or index >= self.L:
            raise ValueError('spin index out of range')
        if value not in (0, 1):
            raise ValueError('value must be 0 or 1')

        dim = len(self)
        states = self.subspace.idx_to_state(np.arange(dim, dtype=np.int64))
        keep = np.zeros(self.storage_dim, dtype=config.real_dtype)
        keep[:dim] = ((states >> index) & 1) == value
        keep = jax.device_put(keep, mesh_mod.row_shard_spec(config.mesh, dim))
        data = cvec.mask_rows(self.data, keep)
        self.data = cvec.scale_real(data, 1.0 / float(cvec.norm(data)))

    def entanglement_entropy(self, keep):
        """Bipartite entanglement entropy, keeping the spins in ``keep``."""
        from .computations import entanglement_entropy
        return entanglement_entropy(self, keep)

    # -- vector algebra ----------------------------------------------------------

    def copy(self, result=None):
        if result is None:
            result = State(L=self.L, subspace=self.subspace.copy())
        if self.subspace != result.subspace:
            raise ValueError('subspace of state and result must match')
        if self.initialized:
            result.data = self.data  # jax arrays are immutable: safe to share
            result.set_initialized()
        elif result.initialized:
            raise UninitializedError('Cannot copy from uninitialized state '
                                     'to one that has been initialized')
        return result

    def dot(self, x):
        """Inner product <self|x> (conjugate-linear in self)."""
        self.assert_initialized()
        x.assert_initialized()
        if not self.subspace == x.subspace:
            raise ValueError('subspaces of the states do not match')
        re, im = cvec.vdot(self.data, x.data)
        return complex(re) + 1j * complex(im)

    def norm(self):
        self.assert_initialized()
        return float(cvec.norm(self.data))

    def normalize(self):
        self.assert_initialized()
        self.data = cvec.scale_real(self.data, 1.0 / self.norm())

    def scale(self, c):
        self.assert_initialized()
        c = complex(c)
        if c.imag == 0:
            self.data = cvec.scale_real(self.data, c.real)
        else:
            self.data = cvec.scale_complex(self.data, c.real, c.imag)

    def axpy(self, alpha, x):
        """self += alpha * x"""
        self.scale_and_sum(alpha, 1, x)

    def scale_and_sum(self, alpha, beta, x):
        """self = alpha*x + beta*self (axpby)."""
        self.assert_initialized()
        x.assert_initialized()
        if not self.subspace == x.subspace:
            raise ValueError('subspaces do not match')
        if self.data is x.data:
            raise ValueError('x and y cannot be the same State object')
        alpha, beta = complex(alpha), complex(beta)
        self.data = cvec.axpby(alpha.real, alpha.imag, x.data,
                               beta.real, beta.imag, self.data)

    def __imul__(self, c):
        self.scale(c)
        return self

    def __mul__(self, c):
        rtn = self.copy()
        rtn *= c
        return rtn

    def __rmul__(self, c):
        return self * c

    def __itruediv__(self, c):
        self.scale(1 / c)
        return self

    def __iadd__(self, x):
        if isinstance(x, State):
            self.axpy(1.0, x)
        else:
            self.assert_initialized()
            self.data = cvec.shift_n(self.data, complex(x).real,
                                     complex(x).imag, len(self))
        return self

    def __add__(self, x):
        rtn = self.copy()
        rtn += x
        return rtn

    def __radd__(self, x):
        return self + x

    def __isub__(self, x):
        if isinstance(x, State):
            self.axpy(-1.0, x)
        else:
            self += -x
        return self

    def __sub__(self, x):
        rtn = self.copy()
        rtn -= x
        return rtn

    def __rsub__(self, x):
        rtn = self.copy()
        rtn *= -1
        return rtn + x

    # -- save / load --------------------------------------------------------------

    # elements fetched to the host per streamed save/load step: bounds the
    # host memory of a checkpoint to ~2 * 16 bytes * this, independent of
    # the state size (the reference streams through the PETSc binary
    # viewer, states.py:627-701)
    SAVE_CHUNK = 1 << 24

    def save(self, fname):
        """Save as ``<fname>.vec`` (raw binary re/im float64 array) plus
        ``<fname>.metadata`` (pickled subspace).

        The vector is streamed to disk in SAVE_CHUNK-element pieces (each
        chunk fetched to the host with one jitted slice), so host memory
        stays bounded at any state size."""
        self.assert_initialized()
        dim = len(self)
        data = self.data
        chunk = min(self.SAVE_CHUNK, dim)

        from .parallel import multihost

        @partial(jax.jit, static_argnums=2,
                 out_shardings=mesh_mod.replicated(config.mesh))
        def fetch(d, start, n):
            return jax.lax.dynamic_slice(d, (0, start), (2, n))

        f = None
        if jax.process_index() == 0:
            with open(fname + '.metadata', 'wb') as fm:
                pickle.dump(self.subspace, fm)
            f = open(fname + '.vec', 'wb')
            f.truncate(2 * dim * 8)
        for start in range(0, dim, chunk):
            n = min(chunk, dim - start)
            # dynamic_slice clamps the start so the window fits the padded
            # storage; compensate on the host side
            cs = min(start, data.shape[-1] - chunk) if chunk <= \
                data.shape[-1] else 0
            piece = np.asarray(jax.device_get(fetch(data, cs, chunk)),
                               dtype=np.float64)
            piece = piece[:, start - cs:start - cs + n]
            if f is not None:
                f.seek(start * 8)
                f.write(piece[0].tobytes())
                f.seek((dim + start) * 8)
                f.write(piece[1].tobytes())
        if f is not None:
            f.close()
        # other processes must not read the file before it is written
        multihost.barrier('state_save')

    @classmethod
    def from_file(cls, fname):
        """Load a state saved with :meth:`save` (streamed in SAVE_CHUNK
        pieces; host memory stays bounded)."""
        with open(fname + '.metadata', 'rb') as f:
            subspace = pickle.load(f)
        dim = subspace.get_dimension()
        import os
        if os.path.getsize(fname + '.vec') != 2 * dim * 8:
            raise RuntimeError('corrupt data encountered when loading state '
                               'from file')

        rtn = cls(subspace=subspace)
        config._initialize()
        sdim = mesh_mod.storage_dim(dim, config.mesh)
        spec = mesh_mod.shard_spec(config.mesh, dim)
        dtype = config.real_dtype
        chunk = min(cls.SAVE_CHUNK, dim)

        @partial(jax.jit, donate_argnums=0, out_shardings=spec)
        def scatter(d, piece, start):
            return jax.lax.dynamic_update_slice(d, piece, (0, start))

        data = jax.device_put(np.zeros((2, sdim), dtype=dtype), spec)
        mm = np.memmap(fname + '.vec', dtype=np.float64, mode='r',
                       shape=(2, dim))
        for start in range(0, dim, chunk):
            n = min(chunk, dim - start)
            piece = np.ascontiguousarray(mm[:, start:start + n],
                                         dtype=dtype)
            data = scatter(data, jax.device_put(piece), start)
        del mm
        rtn.data = data
        rtn.set_initialized()
        return rtn

    # -- pretty printing ------------------------------------------------------------

    def _idx_to_str(self, idx):
        state = int(self.subspace.idx_to_state(int(idx)))
        alphabet = '01' if self.repr_binary else 'UD'
        return ''.join(alphabet[(state >> i) & 1] for i in range(self.L))

    def _nonzero_elements(self):
        vec = self.to_numpy()
        nz = np.flatnonzero(vec)
        if len(nz) > 10:
            take = list(nz[:3]) + [None] + [nz[-1]]
        else:
            take = list(nz)
        return [(i, vec[i] if i is not None else 0) for i in take]

    @staticmethod
    def _coeff_strs(nonzeros):
        if all(v in (0, 1) for _, v in nonzeros):
            return [''] * len(nonzeros)
        if all(complex(v).imag == 0 for _, v in nonzeros):
            fmt = lambda v: f'{v.real:0.3f}'
        else:
            fmt = lambda v: f'({v.real:0.3f}+{v.imag:0.3f}j)'
        return ['' if v == 0 else fmt(complex(v)) for _, v in nonzeros]

    def __str__(self):
        if not self.initialized:
            return repr(self)
        nonzeros = self._nonzero_elements()
        if not nonzeros:
            return repr(self)
        coeffs = self._coeff_strs(nonzeros)
        parts = []
        for (idx, v), c in zip(nonzeros, coeffs):
            if idx is None:
                parts.append('...')
            else:
                parts.append(c + '|' + self._idx_to_str(idx) + '>')
        return ' + '.join(parts)

    def __repr__(self):
        if not self.initialized:
            desc = 'with uninitialized contents'
        elif not self._nonzero_elements():
            desc = 'of norm zero'
        else:
            desc = str(self)
        return f'<State {desc} on subspace {self.subspace!r}>'
