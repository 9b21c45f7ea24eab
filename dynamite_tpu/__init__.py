"""
dynamite_tpu — a JAX framework for large-scale quantum many-body spin
dynamics on GPUs, with the capabilities of GregDMeyer/dynamite (symbolic
Pauli-string Hamiltonians, Krylov time evolution, Lanczos eigensolving,
symmetry subspaces, distributed state vectors) built from scratch on
JAX/XLA.

The public API mirrors the reference package layout:

* :mod:`dynamite_tpu.operators` — Operator, sigmax/y/z, op_sum, index_sum, ...
* :mod:`dynamite_tpu.states` — State
* :mod:`dynamite_tpu.subspaces` — Full, Parity, SpinConserve, Explicit, Auto, XParity
* :mod:`dynamite_tpu.computations` — evolve, eigsolve, entropies, RDM
* ``dynamite_tpu.config`` — global defaults (L, subspace, precision, mesh)

Everything is matrix-free: operators compile to fused Pauli-term-sweep
kernels; there is no stored sparse matrix (the reference's "shell" mode is
the only mode; reference: docs/FAQ.rst:53-59).
"""

__version__ = '0.1.0'

from .utils import validate


class _Config:
    """Package-wide configuration (reference analog: __init__.py:12-227)."""

    def __init__(self):
        self.initialized = False
        self._L = None
        self._shell = True
        self._subspace = None
        self._precision = None
        self._mesh = None
        self._requested_platform = None
        # the precomputed-table ELL engine for general subspace pairs
        # (ops/ell.py); within this device-memory budget it replaces the
        # on-the-fly term sweep, which recomputes subspace rankings every
        # apply
        self.use_ell = True
        self.ell_budget = 4 << 30  # bytes
        # when set to a directory path, evolve()/eigsolve() are wrapped in
        # jax.profiler traces written there (TensorBoard-loadable); the
        # -log_view analog's counters are always collected in
        # computations.last_solve_stats
        self.profile_dir = None

    # -- one-shot initialization ------------------------------------------

    def initialize(self, precision=None, platform=None, mesh_shape=None,
                   slepc_args=None, version_check=None, gpu=None):
        """Initialize the JAX backend configuration.

        Only the first call has any effect; it is called automatically (with
        defaults) the first time device computation is needed.

        Parameters
        ----------
        precision : str, optional
            'single' (float32 pairs, the fast path) or 'double' (float64
            pairs, matching the reference's tolerances). Defaults to
            'double'.

        platform : str, optional
            Force a JAX platform ('gpu', 'cpu'). Defaults to JAX's choice.

        mesh_shape : tuple, optional
            Shape of the device mesh used for state sharding. Defaults to a
            1-D mesh over all addressable devices.

        gpu : bool, optional
            Select the GPU platform (as ``platform='gpu'``); raises
            RuntimeError when JAX finds no GPU.

        slepc_args, version_check :
            Accepted for call-compatibility with the reference; ignored
            (there is no PETSc/SLEPc here).
        """
        if self.initialized:
            raise RuntimeError('config.initialize() can only be called once.')
        if gpu:
            if platform not in (None, 'gpu'):
                raise ValueError(f'gpu=True conflicts with platform='
                                 f'{platform!r}')
            platform = 'gpu'
        self._initialize(precision=precision, platform=platform,
                         mesh_shape=mesh_shape)

    def _initialize(self, precision=None, platform=None, mesh_shape=None):
        if self.initialized:
            return

        import jax

        if platform is not None:
            # JAX expands 'gpu' to every GPU platform and fails when any
            # one of them is missing; the supported GPUs are CUDA cards
            platform = {'gpu': 'cuda'}.get(platform, platform)
            jax.config.update('jax_platforms', platform)
            try:
                jax.devices(platform)
            # JAX asserts instead of raising when no backend is left at all
            except (RuntimeError, AssertionError) as e:
                raise RuntimeError(
                    f'JAX finds no {platform!r} device: {e}') from e

        if precision is None:
            precision = self._precision or 'double'
        if precision not in ('single', 'double'):
            raise ValueError("precision must be 'single' or 'double'")
        self._precision = precision

        # 64-bit device types are needed for the double-precision path and
        # for int64 state indices when L > 31. x64 is process-global and
        # widens every default dtype, so single precision (L <= 31) leaves
        # it off; giving the index width its own switch is an open item.
        jax.config.update('jax_enable_x64', precision == 'double')

        from .parallel.mesh import make_mesh
        self._mesh = make_mesh(mesh_shape)

        self.initialized = True

    # -- global defaults ---------------------------------------------------

    @property
    def L(self):
        """Global default spin chain length (not retroactive)."""
        return self._L

    @L.setter
    def L(self, value):
        self._L = validate.L(value)

    @property
    def shell(self):
        """Kept for API parity with the reference. Every operator is
        matrix-free ('shell'); setting this to False only enables a cached
        scipy CSR debugging path for small problems."""
        return self._shell

    @shell.setter
    def shell(self, value):
        self._shell = validate.shell(value)

    @property
    def subspace(self):
        """Global default subspace applied to new operators and states."""
        return self._subspace

    @subspace.setter
    def subspace(self, value):
        self._subspace = None if value is None else validate.subspace(value)

    @property
    def precision(self):
        """Floating point precision: 'single' or 'double'."""
        if self._precision is None:
            return 'double'
        return self._precision

    @precision.setter
    def precision(self, value):
        if self.initialized and value != self._precision:
            raise RuntimeError('cannot change precision after initialization')
        if value not in ('single', 'double'):
            raise ValueError("precision must be 'single' or 'double'")
        self._precision = value

    @property
    def mesh(self):
        """The jax.sharding.Mesh over which state vectors are sharded."""
        self._initialize()
        return self._mesh

    @mesh.setter
    def mesh(self, value):
        self._mesh = value

    @property
    def gpu(self):
        """Whether JAX's default backend is the GPU."""
        import jax
        return jax.default_backend() == 'gpu'

    # dtype policy ---------------------------------------------------------

    @property
    def real_dtype(self):
        import numpy as np
        return np.float64 if self.precision == 'double' else np.float32

    @property
    def int_dtype(self):
        """Device index dtype policy: int32 for L<=31 else int64 (reference
        analog: bbuild.pyx:28-33)."""
        import numpy as np
        if self._L is not None and self._L > 31:
            return np.int64
        return np.int32


config = _Config()
