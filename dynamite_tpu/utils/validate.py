"""
Input validation helpers (reference analog: src/dynamite/validate.py).

This package always uses 64-bit masks host-side, so the only hard limit is
L <= 63. Device index dtype (int32 vs int64) is chosen per-operator at trace
time.
"""

MAX_L = 63


def _nonneg_int(x):
    try:
        if int(x) != x or x < 0:
            raise ValueError()
    except (TypeError, ValueError):
        raise ValueError(
            f'Value must be a nonnegative integer (got "{x!r}")') from None
    return int(x)


def L(value):
    value = _nonneg_int(value)
    if value > MAX_L:
        raise ValueError(f'Spin chain lengths greater than {MAX_L} '
                         'not supported.')
    if value > 31:
        from .. import config
        if config.precision == 'single':
            raise ValueError('Spin chain lengths greater than 31 need '
                             'int64 state indices; set config.precision = '
                             "'double' (which enables 64-bit device types).")
    return value


def spin_index(value):
    value = _nonneg_int(value)
    if value > MAX_L - 1:
        raise ValueError(f'Spin indices greater than {MAX_L - 1} '
                         'not supported.')
    return value


def subspace(s):
    from ..subspaces import Subspace
    if not isinstance(s, Subspace):
        raise ValueError('subspace can only be set to objects of Subspace type')
    return s


def msc(value):
    from ..ops.msc import as_msc
    return as_msc(value)


def shell(value):
    if not isinstance(value, bool):
        raise ValueError('shell must be a bool (note: all operators '
                         'are matrix-free, so this flag only controls the '
                         'debugging CSR cache)')
    return value
