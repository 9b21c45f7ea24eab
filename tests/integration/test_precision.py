"""Production (single-precision f32) and extreme (L > 31, int64) configs.

Single precision runs f32 with a looser tolerance ladder; the
reference's 64-bit build policy (reference validate.py:6-18, bbuild.pyx)
maps here to precision='double' + int64 index maps for L > 31. These run
in subprocesses because jax_enable_x64 is a process-global switch that the
rest of the suite (running at the default double precision) must not see
flipped.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_snippet(body, timeout=600):
    """Run a test body in a fresh CPU-backend process with an 8-device mesh."""
    prog = textwrap.dedent("""
        import os, sys
        os.environ['JAX_PLATFORMS'] = 'cpu'
        os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
        import jax
        jax.config.update('jax_platforms', 'cpu')
        sys.path.insert(0, %r)
        import numpy as np
    """ % REPO) + textwrap.dedent(body)
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)
    env.pop('JAX_PLATFORMS', None)
    proc = subprocess.run([sys.executable, '-c', prog],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


class TestSinglePrecision:
    """The f32 tolerance ladder: same oracles as the double-precision
    suite, tolerances scaled to f32 conditioning."""

    def test_evolve_f32(self):
        run_snippet("""
            from dynamite_tpu import config
            from dynamite_tpu.models import heisenberg
            from dynamite_tpu.states import State
            config.precision = 'single'
            L = 8
            config.L = L
            config._initialize()
            assert config.real_dtype == np.float32

            import scipy.sparse.linalg
            H = heisenberg(L)
            s0 = State(state='UD' * (L // 2))
            out = H.evolve(s0, 0.7)
            assert out.data.dtype == np.float32
            expected = scipy.sparse.linalg.expm_multiply(
                -1j * 0.7 * H.to_numpy(), s0.to_numpy())
            err = np.abs(out.to_numpy() - expected).max()
            assert err < 2e-5, err
            # norm preserved to f32 accuracy
            assert abs(out.norm() - 1) < 1e-5
        """)

    def test_eigsolve_f32(self):
        # disordered model: nondegenerate spectrum (Lanczos multiplicity
        # resolution is a separate concern from f32 accuracy)
        run_snippet("""
            from dynamite_tpu import config
            from dynamite_tpu.models import localized
            config.precision = 'single'
            L = 8
            config.L = L
            config._initialize()

            H = localized(L)
            got = np.sort(H.eigsolve(nev=4, tol=1e-5))
            dense = np.asarray(H.to_numpy().todense())
            expected = np.sort(np.linalg.eigvalsh(dense))[:4]
            scale = np.abs(dense).sum(axis=1).max()
            err = np.abs(got - expected).max() / scale
            assert err < 1e-4, (got, expected)
        """)

    def test_entropy_f32(self):
        run_snippet("""
            from dynamite_tpu import config
            from dynamite_tpu.models import localized
            from dynamite_tpu.states import State
            from dynamite_tpu.computations import entanglement_entropy
            config.precision = 'single'
            L = 10
            config.L = L
            config._initialize()

            H = localized(L)
            s0 = State(state='UD' * (L // 2))
            out = H.evolve(s0, 1.0)
            ee = entanglement_entropy(out, range(L // 2))

            import scipy.sparse.linalg
            v = scipy.sparse.linalg.expm_multiply(
                -1j * H.to_numpy(), s0.to_numpy())
            V = v.reshape(1 << (L // 2), -1)
            w = np.linalg.eigvalsh(V @ V.conj().T)
            w = w[w > 1e-10]
            expected = float(-(w * np.log(w)).sum())
            assert abs(ee - expected) < 1e-3, (ee, expected)
        """)


@pytest.mark.slow
class TestLargeL:
    """L > 31: int64 state indices on the double/x64 path."""

    def test_L34_explicit_subspace(self):
        # a small Explicit subspace of an L=34 chain: states need 34 bits,
        # indices stay small — exercises the int64 maps end to end
        run_snippet("""
            from dynamite_tpu import config
            from dynamite_tpu.operators import sigmax, sigmaz, op_sum
            from dynamite_tpu.subspaces import Explicit
            from dynamite_tpu.states import State
            config.precision = 'double'
            L = 34
            config.L = L
            config._initialize()

            # spin flips between the two ends of the long chain
            H = (sigmax(0) * sigmax(L - 1) + 0.5 * sigmaz(0)
                 + 0.25 * sigmaz(L - 1))
            # the 4-state orbit of |0...0> under the end flips
            top = 1 << (L - 1)
            states = [0, 1, top, top | 1]
            sub = Explicit(states, L=L)
            H.add_subspace(sub)
            assert int(sub.idx_to_state(np.array([2]))[0]) == top

            s = State(state='random', subspace=sub, seed=3)
            out = H.dot(s)

            H_np = H.to_numpy(subspaces=(sub, sub)).todense()
            expected = np.asarray(H_np) @ s.to_numpy()
            assert np.allclose(out.to_numpy(), expected, atol=1e-12)

            ev = H.evolve(s, 0.5)
            import scipy.linalg
            exp_ev = scipy.linalg.expm(-0.5j * np.asarray(H_np)) @ s.to_numpy()
            assert np.allclose(ev.to_numpy(), exp_ev, atol=1e-8)
        """)

    def test_L33_parity_matvec(self):
        # Parity at L=33: dimension 2^32 is too large, so use an Auto
        # subspace around a seed state instead — still 33-bit states
        run_snippet("""
            from dynamite_tpu import config
            from dynamite_tpu.operators import sigmax, sigmay, sigmaz, \
                op_sum, op_product, index_sum
            from dynamite_tpu.subspaces import Auto
            from dynamite_tpu.states import State
            config.precision = 'double'
            L = 33
            config.L = L
            config._initialize()

            # XX+YY hopping on the top three sites of a 33-spin chain:
            # the rest of the chain is frozen, but every state integer
            # carries 33 bits
            top = [L - 3, L - 2, L - 1]
            terms = []
            for a, b in [(top[0], top[1]), (top[1], top[2])]:
                terms.append(op_product([sigmax(a), sigmax(b)]))
                terms.append(op_product([sigmay(a), sigmay(b)]))
            H = op_sum(terms)
            H.L = L

            seed = 1 << (L - 1)
            sub = Auto(H, seed)
            assert sub.get_dimension() == 3
            H.add_subspace(sub)

            s = State(state='random', subspace=sub, seed=11)
            out = H.dot(s)
            H_np = np.asarray(H.to_numpy(subspaces=(sub, sub)).todense())
            assert np.allclose(out.to_numpy(), H_np @ s.to_numpy(),
                               atol=1e-12)

            evals = np.sort(H.eigsolve(nev=1))
            expected = np.sort(np.linalg.eigvalsh(H_np))
            assert np.allclose(evals[0], expected[0], atol=1e-8)
        """)

    def test_serialization_L40(self):
        run_snippet("""
            from dynamite_tpu import config
            from dynamite_tpu.operators import Operator, sigmaz, sigmax
            config.precision = 'double'

            op = sigmax(39) * sigmax(0) + 2 * sigmaz(39)
            blob = op.serialize()
            loaded = Operator.from_bytes(blob)
            assert loaded == op
            assert loaded.max_spin_idx == 39
        """)
