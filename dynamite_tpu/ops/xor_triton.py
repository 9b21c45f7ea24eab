"""
Hand-written GPU kernel (Pallas, Triton route) for the XOR-mode matvec of
Full/Parity subspace pairs in float32: the hot path under full-space and
Parity evolve/eigsolve on the GPU.

One program per output tile of T = 2**TILE_BITS rows, both re/im planes:

* for each mask group m it loads x[k ^ m] for its tile: the XOR permutes
  only the tile's low bits, so the load covers one aligned source tile and
  stays coalesced;
* it forms the group coefficient f_m(k) = sum_t c_t (-1)^parity(k & s_t)
  from popcounts in registers;
* it accumulates y in registers and stores it once.

The mask-0 (diagonal) group is precomputed into one stream at build time.
XLA's own lowering of the same sweep (ops/apply.py) materializes a permuted
copy of x per mask group; PERF.md has both timings.

Distributed form (inside shard_map): each device holds a contiguous block
of 2**local_bits rows. A mask's device bits name a partner block that
lax.ppermute brings in, one exchange per distinct device mask, outside the
kernel; a sign mask's device bits give a per-term +-1 that depends on the
device index and enters the kernel as a small vector.

Parity subspaces fold into the same form through their effective
index-space sign masks (index_maps.effective_sign_mask).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .index_maps import effective_sign_mask, parity_j

# tile and warp count measured on an H100 at L=24 (PERF.md); one stage, as
# the kernel has no inner loop for Triton to pipeline
TILE_BITS = 10
NUM_WARPS = 8
NUM_STAGES = 1
# local blocks smaller than one such tile take the XLA sweep
MIN_TILE_BITS = 7


def supported(plan, device_bits=0):
    """Whether the kernel serves this plan (f32 is the caller's check)."""
    local_bits = plan.dim_right.bit_length() - 1 - device_bits
    return (plan.xor_mode and plan.dim_left == plan.dim_right
            and bool(plan.groups) and not plan.use_scan
            and plan.int_dtype == np.int32
            and local_bits >= MIN_TILE_BITS)


class XorKernelPlan:
    """Host-side decomposition of an apply plan into kernel structure.

    * ``diag_terms``: (s_eff, c) of the terms whose index permutation is the
      identity, summed into the precomputed diagonal stream;
    * ``sources``: per distinct device mask (0 first), the groups read from
      that source block: (low permutation mask, [(low sign mask, c,
      device-sign index or None)]);
    * ``dev_masks``: the distinct device parts of the sign masks, whose
      +-1 factors are computed at run time from the device index.
    """

    def __init__(self, plan, left, right, device_bits=0):
        nbits = plan.dim_right.bit_length() - 1
        self.dim = plan.dim_right
        self.device_bits = device_bits
        self.local_bits = nbits - device_bits
        self.local_dim = 1 << self.local_bits
        self.tile = 1 << min(TILE_BITS, self.local_bits)
        low = self.local_dim - 1

        self.diag_terms = []
        self.dev_masks = []
        dev_index = {}
        by_hi = {0: []}
        for m, pm, signs, coeffs in plan.groups:
            terms = []
            for s, c in zip(signs, coeffs):
                s_eff, sign = effective_sign_mask(int(s), int(m), left,
                                                  right)
                c = complex(c) * sign
                if pm == 0:
                    self.diag_terms.append((s_eff, c))
                    continue
                s_dev = s_eff >> self.local_bits
                wd = None
                if s_dev:
                    if s_dev not in dev_index:
                        dev_index[s_dev] = len(self.dev_masks)
                        self.dev_masks.append(s_dev)
                    wd = dev_index[s_dev]
                terms.append((s_eff & low, c, wd))
            if terms:
                by_hi.setdefault(pm >> self.local_bits, []).append(
                    (pm & low, terms))
        self.sources = sorted(by_hi.items())

    @property
    def hi_list(self):
        return [hi for hi, _ in self.sources]


def _build_call(kp, interpret):
    """pallas_call(*sources, [x tile, diag tile], [wd]) -> (2, local_dim)."""
    T = kp.tile
    n_src = len(kp.sources)
    has_diag = bool(kp.diag_terms)
    has_wd = bool(kp.dev_masks)

    def kernel(*refs):
        src_refs = refs[:n_src]
        pos = n_src
        if has_diag:
            xt_ref, d_ref = refs[pos], refs[pos + 1]
            pos += 2
        if has_wd:
            wd_ref = refs[pos]
            pos += 1
        y_ref = refs[pos]

        k = pl.program_id(0) * T + lax.broadcasted_iota(jnp.int32, (T,), 0)
        if has_diag:
            dr, di = d_ref[0, :], d_ref[1, :]
            xr, xi = xt_ref[0, :], xt_ref[1, :]
            acc_r = dr * xr - di * xi
            acc_i = dr * xi + di * xr
        else:
            acc_r = jnp.zeros((T,), jnp.float32)
            acc_i = jnp.zeros((T,), jnp.float32)

        for src_ref, (_hi, groups) in zip(src_refs, kp.sources):
            for pm, terms in groups:
                idx = k ^ pm
                xr = pltriton.load(src_ref.at[0, idx])
                xi = pltriton.load(src_ref.at[1, idx])
                fr = None
                fi = None
                for s, c, wd in terms:
                    odd = (lax.population_count(k & s) & 1) == 1
                    w = 1.0 if wd is None else wd_ref[wd]
                    for part, is_real in ((c.real, True), (c.imag, False)):
                        if not part:
                            continue
                        v = jnp.where(odd, np.float32(-part),
                                      np.float32(part)) * w
                        if is_real:
                            fr = v if fr is None else fr + v
                        else:
                            fi = v if fi is None else fi + v
                if fr is not None:
                    acc_r = acc_r + fr * xr
                    acc_i = acc_i + fr * xi
                if fi is not None:
                    acc_r = acc_r - fi * xi
                    acc_i = acc_i + fi * xr
        y_ref[0, :] = acc_r
        y_ref[1, :] = acc_i

    tile = pl.BlockSpec((2, T), lambda i: (0, i))
    in_specs = [pl.no_block_spec] * n_src
    if has_diag:
        in_specs += [tile, tile]
    if has_wd:
        in_specs.append(pl.no_block_spec)
    call = pl.pallas_call(
        kernel, grid=(kp.local_dim // T,), in_specs=in_specs,
        out_specs=tile,
        out_shape=jax.ShapeDtypeStruct((2, kp.local_dim), jnp.float32),
        backend='triton', interpret=interpret, name='xor_matvec',
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES))

    def call_fn(srcs, x_local, diag, wd):
        args = list(srcs)
        if has_diag:
            args += [x_local, diag]
        if has_wd:
            args.append(wd)
        return call(*args)

    return call_fn


def _diagonal(diag_terms, dim, sharding=None):
    """(2, dim) f32 stream d[k] = sum_t c_t (-1)^parity(k & s_t)."""
    @jax.jit
    def build():
        k = lax.broadcasted_iota(jnp.int32, (dim,), 0)
        dr = jnp.zeros(dim, jnp.float32)
        di = jnp.zeros(dim, jnp.float32)
        for s, c in diag_terms:
            w = (1 - 2 * parity_j(k & np.int32(s))).astype(jnp.float32)
            dr = dr + np.float32(c.real) * w
            di = di + np.float32(c.imag) * w
        return jnp.stack([dr, di])
    d = build()
    return d if sharding is None else jax.device_put(d, sharding)


def build_xor_kernel(plan, left, right, interpret=False):
    """Traceable (2, dim) -> (2, dim) f32 apply on one device."""
    kp = XorKernelPlan(plan, left, right)
    call_fn = _build_call(kp, interpret)
    diag = _diagonal(kp.diag_terms, kp.dim) if kp.diag_terms else None

    def apply_fn(x):
        return call_fn([x], x, diag, None)

    apply_fn.kernel_plan = kp
    return apply_fn


def build_xor_kernel_sharded(plan, left, right, mesh, interpret=False):
    """Traceable apply on (2, dim) f32 states sharded over the 1-D mesh
    (a power-of-two device count): the kernel runs on each device's block
    inside shard_map, with the device bits of the masks exchanged by
    lax.ppermute."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    nd = mesh.devices.size
    axis = mesh.axis_names[0]
    kp = XorKernelPlan(plan, left, right, device_bits=nd.bit_length() - 1)
    call_fn = _build_call(kp, interpret)
    diag = (_diagonal(kp.diag_terms, kp.dim,
                      NamedSharding(mesh, P(None, axis)))
            if kp.diag_terms else None)

    def local_fn(x_local, *diag_local):
        srcs = [x_local if hi == 0 else lax.ppermute(
                    x_local, axis, [(i, i ^ hi) for i in range(nd)])
                for hi in kp.hi_list]
        wd = None
        if kp.dev_masks:
            me = lax.axis_index(axis).astype(jnp.int32)
            wd = jnp.stack([(1 - 2 * parity_j(me & np.int32(m))
                             ).astype(jnp.float32) for m in kp.dev_masks])
        d = diag_local[0] if diag_local else None
        return call_fn(srcs, x_local, d, wd)

    spec = P(None, axis)
    # pallas_call states no varying mesh axes for its output; the specs
    # below pin the sharding
    if diag is None:
        mapped = jax.shard_map(local_fn, mesh=mesh, in_specs=spec,
                               out_specs=spec, check_vma=False)
        apply_fn = mapped
    else:
        mapped = jax.shard_map(local_fn, mesh=mesh, in_specs=(spec, spec),
                               out_specs=spec, check_vma=False)

        def apply_fn(x):
            return mapped(x, diag)

    return apply_fn
