"""Worker for the 2-process multi-host integration test.

Launched by test_multiprocess.py as two separate Python processes, each
owning 4 virtual CPU devices, joined through jax.distributed — the CPU
stand-in for a 2-host GPU cluster (reference analog: the
mpirun -n {1,3,4} test matrix, reference tests/integration/run_all_tests.py).

Exercises the cross-host contracts:
  * kernel-build CRC consistency guard across processes
  * State.set_random(seed=None) host-0 seed broadcast
  * sharded evolve on the global (2 process x 4 device) mesh vs scipy
  * to_numpy() on a non-fully-addressable array (process_allgather path)
  * State.save from process 0 + barrier + from_file on every process
"""

import os
import sys

os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (
    '--xla_force_host_platform_device_count=4 '
    + os.environ.get('XLA_FLAGS', ''))

import numpy as np


def main():
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = sys.argv[3]
    workdir = sys.argv[4]

    import jax
    # the environment may select an accelerator by default; force the CPU
    # backend the same way tests/conftest.py does
    jax.config.update('jax_platforms', 'cpu')
    jax.distributed.initialize(coordinator_address=f'localhost:{port}',
                               num_processes=num_processes,
                               process_id=process_id)
    assert jax.process_count() == num_processes
    assert len(jax.devices()) == 4 * num_processes

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from dynamite_tpu import config
    from dynamite_tpu.models import heisenberg
    from dynamite_tpu.states import State
    from dynamite_tpu.subspaces import Full
    from dynamite_tpu.parallel import multihost

    L = 10
    config.L = L
    config._initialize()
    assert config.mesh.devices.size == 4 * num_processes

    # --- seed broadcast: an unseeded random state must agree across hosts
    s = State(state='random')
    v = s.to_numpy()                      # gathers across processes
    crc = np.frombuffer(v.tobytes(), dtype=np.uint8).sum()
    crcs = multihost.allgather_host_values(np.asarray([crc]))
    assert np.all(crcs == crcs[0]), f'divergent random states: {crcs}'

    # --- sharded evolve on the global mesh vs scipy oracle
    H = heisenberg(L)
    s0 = State(state='U' * (L // 2) + 'D' * (L - L // 2))
    t = 0.3
    out = H.evolve(s0, t)
    got = out.to_numpy()

    import scipy.sparse.linalg
    H_np = H.to_numpy()
    expected = scipy.sparse.linalg.expm_multiply(-1j * t * H_np,
                                                 s0.to_numpy())
    err = float(np.abs(got - expected).max())
    assert err < 1e-8, f'evolve mismatch: {err}'

    # --- save from a distributed state, reload everywhere
    fname = os.path.join(workdir, 'state.dnm')
    out.save(fname)
    loaded = State.from_file(fname)
    assert np.allclose(loaded.to_numpy(), got, atol=1e-12)

    multihost.barrier('done')
    print(f'OK process {process_id}', flush=True)


if __name__ == '__main__':
    main()
