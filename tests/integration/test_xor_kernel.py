"""
The GPU XOR kernel (ops/xor_triton.py): in the Pallas interpreter on the
CPU against the numpy oracle, and, in the tests marked ``gpu``, compiled
for the card against the XLA sweep and the host reference apply.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dynamite_tpu import config
from dynamite_tpu import models
from dynamite_tpu.operators import index_sum, sigmax, sigmay
from dynamite_tpu.subspaces import Full, Parity
from dynamite_tpu.ops import xor_triton
from dynamite_tpu.ops.xor_triton import (XorKernelPlan, build_xor_kernel,
                                         build_xor_kernel_sharded)

from dynamite_tpu.utils.hoist import hjit

from chip_smoke import host_apply


@pytest.fixture(autouse=True)
def reset_config():
    config._L = None
    config._subspace = None
    yield
    config._L = None
    config._subspace = None


def _complex_hopping(L):
    # Y-containing terms: imaginary coefficients and sign masks
    return (index_sum(sigmay(0) * sigmax(1), size=L)
            + 0.3 * index_sum(sigmay(), size=L))


CASES = {
    'full_localized': lambda L: (models.localized(L), Full(L=L)),
    'parity_even_heisenberg': lambda L: (models.heisenberg(L + 1),
                                         Parity('even', L=L + 1)),
    'parity_odd_ising': lambda L: (models.ising(L), Parity('odd', L=L)),
    'full_complex': lambda L: (_complex_hopping(L), Full(L=L)),
}


def _setup(case, L):
    H, sub = CASES[case](L)
    H.allow_projection = True
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    dim = sub.get_dimension()
    x = np.random.default_rng(0).standard_normal((2, dim)).astype(np.float32)
    want = host_apply(H.msc, sub, sub, x[0] + 1j * x[1])
    return kernel, sub, x, want


def _err(y, want):
    y = np.asarray(y)
    return np.max(np.abs(y[0] + 1j * y[1] - want)) / np.max(np.abs(want))


@pytest.mark.parametrize('case', sorted(CASES))
def test_kernel_interpret_vs_oracle(case):
    kernel, sub, x, want = _setup(case, 10)
    fn = build_xor_kernel(kernel.plan, sub, sub, interpret=True)
    assert _err(fn(jnp.asarray(x)), want) < 1e-5


@pytest.mark.parametrize('case', sorted(CASES))
def test_sharded_kernel_interpret_vs_oracle(case):
    """The kernel on each device's block of the 8-device CPU mesh, with the
    device mask bits exchanged by ppermute and the device sign bits
    entering as run-time factors."""
    kernel, sub, x, want = _setup(case, 10)
    mesh = config.mesh
    kp = XorKernelPlan(kernel.plan, sub, sub,
                       device_bits=mesh.devices.size.bit_length() - 1)
    if case != 'parity_odd_ising':
        # the decomposition must exercise the distributed pieces
        assert any(hi != 0 for hi in kp.hi_list) and kp.dev_masks
    fn = build_xor_kernel_sharded(kernel.plan, sub, sub, mesh,
                                  interpret=True)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, 'd')))
    assert _err(jax.jit(fn)(xs), want) < 1e-5


def test_kernel_plan_decomposition():
    """Every non-identity term lands in exactly one source group, and the
    identity terms in the diagonal stream."""
    kernel, sub, _x, _want = _setup('full_localized', 10)
    plan = kernel.plan
    kp = XorKernelPlan(plan, sub, sub, device_bits=2)
    n_diag = sum(len(g[2]) for g in plan.groups if g[1] == 0)
    n_rest = sum(len(terms) for _hi, groups in kp.sources
                 for _pm, terms in groups)
    assert len(kp.diag_terms) == n_diag
    assert n_diag + n_rest == plan.nterms
    assert kp.local_dim == 1 << 8 and kp.hi_list[0] == 0


def test_dispatch_picks_kernel_on_gpu(monkeypatch):
    """f32 XOR pairs take the kernel on the GPU, and the XLA sweep on any
    other backend or in double precision."""
    from dynamite_tpu.ops import apply as apply_mod
    kernel, _sub, _x, _want = _setup('full_localized', 10)
    monkeypatch.setattr(config, '_precision', 'single')
    assert not apply_mod._xor_kernel_wanted(kernel.plan)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    assert apply_mod._xor_kernel_wanted(kernel.plan)
    assert apply_mod._xor_kernel_wanted(kernel.plan, device_bits=3)
    # below one minimum tile per device: the sweep
    assert not apply_mod._xor_kernel_wanted(kernel.plan, device_bits=4)
    monkeypatch.setattr(config, '_precision', 'double')
    assert not apply_mod._xor_kernel_wanted(kernel.plan)


@pytest.mark.gpu
@pytest.mark.parametrize('case,L', [('full_localized', 20),
                                    ('parity_even_heisenberg', 19),
                                    ('full_complex', 18)])
def test_kernel_on_gpu_vs_sweep_and_host(gpu_device, case, L):
    """The compiled kernel against the plain XLA sweep and the host
    apply."""
    kernel, sub, x, want = _setup(case, L)
    xd = jax.device_put(jnp.asarray(x), gpu_device)
    got = hjit(build_xor_kernel(kernel.plan, sub, sub))(xd)
    _name, sweep = kernel.sweep_callable()
    ref = jax.jit(sweep)(xd)
    assert _err(got, want) < 1e-5
    scale = np.max(np.abs(np.asarray(ref)))
    assert np.max(np.abs(np.asarray(got) - np.asarray(ref))) / scale < 1e-5


@pytest.mark.gpu
def test_sharded_kernel_on_one_gpu(gpu_device):
    """The shard_map form of the kernel on a one-device mesh."""
    from dynamite_tpu.parallel.mesh import make_mesh
    kernel, sub, x, want = _setup('parity_even_heisenberg', 17)
    mesh = make_mesh(devices=[gpu_device])
    fn = build_xor_kernel_sharded(kernel.plan, sub, sub, mesh)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, 'd')))
    assert _err(jax.jit(fn)(xs), want) < 1e-5


def test_tile_constants():
    assert xor_triton.MIN_TILE_BITS <= xor_triton.TILE_BITS
    assert xor_triton.NUM_WARPS & (xor_triton.NUM_WARPS - 1) == 0
