"""
Multi-host support.

One Python process per host, all local GPUs via the global mesh — the
replacement for the reference's one-MPI-rank-per-GPU model
(bcuda_template_2.cu:64-67). The state axis spans all devices of all
hosts; XLA picks the transport for the pairwise mask permutations from the
mesh layout.

Typical use, one process per host:

    from dynamite_tpu.parallel import multihost
    multihost.initialize(coordinator_address='host0:1234',
                         num_processes=2, process_id=0)
    ... build operators/states as usual; arrays shard over all devices ...
"""

import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed. On GPU hosts nothing announces the
    cluster, so pass the coordinator address, the process count and this
    process's id."""
    import jax
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs['coordinator_address'] = coordinator_address
    if num_processes is not None:
        kwargs['num_processes'] = num_processes
    if process_id is not None:
        kwargs['process_id'] = process_id
    jax.distributed.initialize(**kwargs)

    # rebuild the global mesh over all (now-visible) devices
    from .. import config
    from .mesh import make_mesh
    if config.initialized:
        config.mesh = make_mesh()


def broadcast_from_host0(value_array):
    """Agree on a host-side value across processes (e.g. an RNG seed) —
    the analog of the reference's seed broadcast (states.py:253-270)."""
    import jax
    if jax.process_count() == 1:
        return value_array
    from jax.experimental import multihost_utils
    return multihost_utils.broadcast_one_to_all(np.asarray(value_array))


def allgather_host_values(value_array):
    """Gather a small host-side array from every process (used by the
    cross-process operator consistency check)."""
    import jax
    if jax.process_count() == 1:
        return np.asarray(value_array)[None]
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(np.asarray(value_array))


def barrier(name='dynamite_tpu_barrier'):
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
