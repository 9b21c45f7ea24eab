"""
Device mesh construction and sharding helpers.

State vectors are row-partitioned over a 1-D mesh axis named 'd': the high
bits of the state index select the device, exactly the bit-slicing trick the
reference uses to map state indices to MPI ranks
(reference: bpetsc_template_2.c:781-783). Each Pauli mask whose support
touches those high bits induces a pairwise device permutation
(dst = me ^ mask_high), implemented with lax.ppermute.
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = 'd'


def make_mesh(mesh_shape=None, devices=None):
    """Build the 1-D state-sharding mesh over all devices (or a given list)."""
    if devices is None:
        devices = jax.devices()
    if mesh_shape is not None:
        n = int(np.prod(mesh_shape))
        devices = devices[:n]
    return Mesh(np.array(devices), (AXIS,))


def n_devices(mesh=None):
    if mesh is None:
        from .. import config
        mesh = config.mesh
    return mesh.devices.size


def storage_dim(dim, mesh=None):
    """Physical storage length for a logical state dimension.

    Dimensions that do not divide the device count are zero-padded up to
    the next multiple, so every state vector shards evenly over the mesh —
    the analog of the reference's uneven row partition
    (PetscSplitOwnership, bpetsc_template_2.c:232-235), realized as padding
    because XLA wants static, evenly-split shapes. The padded tail is an
    invariant zero everywhere (enforced by the state setters and by the
    matvec kernels masking pad rows).
    """
    if mesh is None:
        from .. import config
        mesh = config.mesh
    nd = mesh.devices.size
    if nd <= 1:
        return dim
    return -(-dim // nd) * nd


def shard_spec(mesh, dim):
    """Sharding for a state vector stored as a (2, storage_dim) re/im stack.

    Always shards the state axis on a multi-device mesh: storage is padded
    to a multiple of the device count (see :func:`storage_dim`), so any
    subspace dimension — C(20,10) included — splits evenly.
    """
    nd = mesh.devices.size
    if nd > 1:
        return NamedSharding(mesh, P(None, AXIS))
    return NamedSharding(mesh, P(None, None))


def row_shard_spec(mesh, dim):
    """Sharding for a 1-D array of length ``storage_dim`` along the state
    axis."""
    nd = mesh.devices.size
    if nd > 1:
        return NamedSharding(mesh, P(AXIS))
    return NamedSharding(mesh, P(None))


def replicated(mesh):
    return NamedSharding(mesh, P())


def pad_state(data, mesh, dim):
    """Zero-pad a host (2, dim) array to (2, storage_dim)."""
    sdim = storage_dim(dim, mesh)
    if sdim == data.shape[-1]:
        return data
    out = np.zeros(data.shape[:-1] + (sdim,), dtype=data.dtype)
    out[..., :dim] = data
    return out


def device_put_state(data, mesh, dim):
    """Place a (2, dim) host array on the mesh with the canonical sharding,
    padding the storage as needed."""
    return jax.device_put(pad_state(np.asarray(data), mesh, dim),
                          shard_spec(mesh, dim))
