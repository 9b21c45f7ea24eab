"""
Test configuration: tests run on a virtual 8-device CPU mesh, so the
multi-device sharding paths are exercised without a GPU (chip_smoke.py and
bench.py run on the GPU).

Tests marked ``gpu`` need the card and skip on the CPU; on a GPU machine,
``DYNAMITE_TEST_PLATFORM=gpu python -m pytest -m gpu tests/`` runs them on
the GPU backend instead.
"""

import os
import sys

import pytest

# JAX platform name; 'gpu' selects the CUDA backend
_PLATFORM = {'gpu': 'cuda'}.get(
    os.environ.get('DYNAMITE_TEST_PLATFORM', 'cpu'), 'cpu')

# must be set before the jax backend initializes (the environment may
# pre-set JAX_PLATFORMS to an accelerator, so force via jax.config too)
os.environ['JAX_PLATFORMS'] = _PLATFORM
_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402
jax.config.update('jax_platforms', _PLATFORM)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# persistent compilation cache (inherited by the subprocess tests) makes
# repeated test runs much faster; it lives in the checkout
from dynamite_tpu.utils.compile_cache import cache_dir  # noqa: E402
os.environ.setdefault('JAX_COMPILATION_CACHE_DIR', cache_dir())
os.environ.setdefault('JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES', '-1')
os.environ.setdefault('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS', '0.5')


@pytest.fixture
def gpu_device():
    """The GPU for tests marked ``gpu``; skips where JAX finds none."""
    device = jax.devices()[0]
    if device.platform != 'gpu':
        pytest.skip('needs an NVIDIA GPU (DYNAMITE_TEST_PLATFORM=gpu on a '
                    'GPU machine)')
    return device
