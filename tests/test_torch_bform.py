"""K1's analytic B of Coulomb and SimpleCornell, from one rsqrt and one
reciprocal (``wafer_torch/csrc/sweep_common.cuh``: ``radial_v``, ``k1_b``),
held against the reference's ``pallas_stencil._analytic_b`` on the CPU.

The kernel runs only on the card, so a numpy model here spells out its
expressions and roundings: the rsqrt (MUFU, within 2 ulp by CUDA's
documentation) is the f32-rounded exact value nudged by −2…+2 ulp; each
fused multiply-add is modelled as its f64 value rounded once to f32. The
model is not used by the port. Periodic's x factor, which K1 takes once a
plane, is held to the per-point expression bit for bit.
"""

import numpy as np
import pytest

from wafer_tpu.ops import pallas_stencil

f32 = np.float32
TWO_PI = 2.0 * 3.14159265358979323846

# (kind, dn, dt, mass, sig, vshift) of the examples that run these kinds:
# coulomb_states.yaml (128^3), multislice_512.yaml / sharded_512.yaml
# (512^3), cornell.yaml (vshift: the least V over its grid, as the solver
# shifts the gauge)
COULOMB = ("Coulomb", 0.125, 0.005, 1.0, 1.0, 0.0)
COULOMB_512 = ("Coulomb", 0.03, 2.8e-4, 1.0, 1.0, 0.0)
CORNELL = ("SimpleCornell", 0.35, 0.04, 4.65, 0.223, None)

# (name, global interior extents, [(block shape, block origin)]): whole
# grids, and x-slabs of 512^3 around the centre, at both faces and at the
# shard origins of an (8, 1, 1) mesh and of a 2 x (2, 2, 1) multi-slice
# mesh (x blocks of 128 planes, y halves), the plane before each origin
# included
GRIDS = [
    ("coulomb_states 128^3", (128, 128, 128), [((128, 128, 128), (0, 0, 0))]),
    ("cornell 64x64x128", (64, 64, 128), [((64, 64, 128), (0, 0, 0))]),
    ("odd 37x45x29", (37, 45, 29), [((37, 45, 29), (0, 0, 0))]),
    ("512^3 centre", (512,) * 3, [((4, 512, 512), (254, 0, 0))]),
    ("512^3 faces", (512,) * 3, [((3, 512, 512), (0, 0, 0)), ((3, 512, 512), (509, 0, 0))]),
    ("512^3 (8, 1, 1) origins", (512,) * 3,
     [((2, 512, 512), (64 * k - 1, 0, 0)) for k in range(1, 8)]),
    ("512^3 2 x (2, 2, 1) origins", (512,) * 3,
     [((2, 256, 512), (128 * k - 1, 256 * j, 0)) for k in range(1, 4) for j in (0, 1)]),
]
EXT = 1  # ThreePoint: interior point 0 is padded index 1


def fma(a, b, c):
    """f32 a*b + c rounded once (the f32 product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def nudged(y, k):
    """``y`` moved ``k`` ulp (k < 0: down)."""
    for _ in range(abs(k)):
        y = np.nextafter(y, f32(np.inf if k > 0 else -np.inf)).astype(f32)
    return y


def analytic(params, n, vshift=None):
    kind, dn, dt, mass, sig, shift = params
    v = shift if shift is not None else vshift
    return (kind, dn, dt, mass, *n, sig, v)


def coordinates(an, shape, origin):
    """r2 = dx*dx + (dy*dy + dz*dz) over a block at the global padded
    index of its interior origin, as K1 forms it (exact in f32)."""
    axes = []
    for ax, (m, o, g) in enumerate(zip(shape, origin, an[4:7])):
        i = np.arange(m, dtype=f32) + f32(o + EXT)
        d = (i - f32((g + 1.0) / 2.0)).astype(f32)
        axes.append(d.reshape([-1 if a == ax else 1 for a in range(3)]))
    dx, dy, dz = axes
    col = fma(dy, dy, (dz * dz).astype(f32))
    return fma(dx, dx, col)


def model_b(an, r2, k=0):
    """The kernel's B at r2 with its rsqrt nudged ``k`` ulp (radial_v, k1_b)."""
    kind, dn, dt, mass, _gx, _gy, _gz, sig, vshift = an
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        y = nudged((1.0 / np.sqrt(r2.astype(np.float64))).astype(f32), k)
        if kind == "Coulomb":
            neg_inv_dn = f32(-1.0 / dn)
            v = np.where(r2 < 1.0, neg_inv_dn, (neg_inv_dn * y).astype(f32))
        else:
            four_mass = f32(4.0 * mass)
            r0 = (r2 * y).astype(f32)
            s = fma((f32(0.5) * y).astype(f32), fma(-r0, r0, r2), r0)  # one Newton step
            near = (f32(-0.5 * (4.0 / 3.0) / dn) * y).astype(f32)
            far = fma(f32(sig), (f32(dn) * s).astype(f32), near)
            v = np.where(r2 < 1.0, four_mass, (far + four_mass).astype(f32))
    d = fma(f32(0.5 * dt), (v - f32(vshift)).astype(f32), f32(1.0))
    return (1.0 / d.astype(np.float64)).astype(f32)


def reference_b(an, shape, origin, raw=False):
    x0, y0, z0 = (o + EXT for o in origin)
    return np.asarray(pallas_stencil._analytic_b(an, shape, x0, y0, z0, _raw_v=raw))


def ulps(a, b):
    """|a − b| in ulp of f32 values of one sign."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def cornell_vshift():
    an = analytic(CORNELL, (64, 64, 128), 0.0)
    return float(reference_b(an, (64, 64, 128), (0, 0, 0), raw=True).min())


@pytest.mark.parametrize("kind", ["Coulomb", "SimpleCornell"])
@pytest.mark.parametrize("name,n,blocks", GRIDS, ids=[g[0] for g in GRIDS])
def test_rsqrt_b_within_two_ulp_of_reference(kind, name, n, blocks):
    import jax.numpy as jnp

    params = CORNELL if kind == "SimpleCornell" else COULOMB_512 if n[0] == 512 else COULOMB
    an = analytic(params, n, cornell_vshift() if kind == "SimpleCornell" else None)
    worst = 0
    for shape, origin in blocks:
        r2 = coordinates(an, shape, origin)
        # the core: the reference's r < dn is r2 < 1 at every point
        dn = an[1]
        core_ref = np.asarray(dn * jnp.sqrt(jnp.asarray(r2)) < dn)
        np.testing.assert_array_equal(core_ref, r2 < 1.0)
        want = reference_b(an, shape, origin)
        assert want.shape == r2.shape and np.all(want > 0)
        for k in range(-2, 3):
            got = model_b(an, r2, k)
            np.testing.assert_array_equal(got[r2 < 1.0], want[r2 < 1.0])
            worst = max(worst, int(ulps(got, want).max()))
    assert worst <= 2, f"{name} {kind}: {worst} ulp"


PERIODIC_GRIDS = [(37, 45, 29), (64, 64, 128), (128, 128, 128)]


@pytest.mark.parametrize("n", PERIODIC_GRIDS, ids=["x".join(map(str, n)) for n in PERIODIC_GRIDS])
def test_periodic_plane_factor_is_the_point_expression(n):
    """K1's Periodic V from its x factor sx*sx taken once a plane equals,
    bit for bit, the expression taken at every point (analytic_v_ieee's
    1 - (sx*sx)*col); and stays within 1e-6 of the reference's V."""
    two_pi, gx1 = f32(TWO_PI), f32(n[0] - 1.0)

    def sin2(i, g1):
        s = np.sin(((two_pi * (i - f32(1.0))).astype(f32) / g1).astype(f32)).astype(f32)
        return (s * s).astype(f32)

    i = np.arange(EXT, n[0] + EXT, dtype=f32)
    j = np.arange(EXT, n[1] + EXT, dtype=f32)[None, :, None]
    k = np.arange(EXT, n[2] + EXT, dtype=f32)[None, None, :]
    col = (sin2(j, f32(n[1] - 1.0)) * sin2(k, f32(n[2] - 1.0))).astype(f32)
    plane = sin2(i, gx1)[:, None, None]  # once a plane
    point = sin2(np.broadcast_to(i[:, None, None], (n[0], n[1], n[2])), gx1)  # at every point
    v_plane = fma(-plane, col, f32(1.0))
    v_point = fma(-point, col, f32(1.0))
    np.testing.assert_array_equal(v_plane, v_point)
    an = ("Periodic", 0.2, 0.004, 1.0, *n, 1.0, 0.0)
    ref = reference_b(an, n, (0, 0, 0), raw=True)
    np.testing.assert_allclose(v_plane, ref, rtol=0, atol=1e-6)
