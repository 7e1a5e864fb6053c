"""The port's plain torch ops against the JAX package on the same inputs.

Inputs come from ``np.random.default_rng(seed)`` and reach both packages
as numpy (through ``wafer_torch.convert`` on the port's side).
Tolerances, relative to the reference field's largest magnitude: f64
1e-12 (the same arithmetic up to summation order), f32 1e-5 (f32
rounding in a different operation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import base_config
from wafer_torch import convert, geometry as tgeo
from wafer_torch.models import initial as tinit, potentials as tpot
from wafer_torch.ops import gram_schmidt as tgs, observables as tobs, stencil as tst
from wafer_torch.utils.host import DTYPES, to_numpy
from wafer_tpu import geometry as jgeo
from wafer_tpu.models import initial as jinit, potentials as jpot
from wafer_tpu.ops import gram_schmidt as jgs, observables as jobs, stencil as jst

ORDERS = ["ThreePoint", "FivePoint", "SevenPoint"]
RTOL = {"f32": 1e-5, "f64": 1e-12}
NP = {"f32": np.float32, "f64": np.float64}
REAL_FAMILIES = [
    "NoPotential", "Cube", "QuadWell", "Periodic", "Coulomb", "ElipticalCoulomb",
    "SimpleCornell", "FullCornell", "Harmonic", "Dodecahedron",
]


def close(port, ref, precision):
    port = to_numpy(port) if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(port.astype(np.float64) - ref.astype(np.float64)).max()) / scale
    assert err <= RTOL[precision], err


def _cfg(order="ThreePoint", precision="f64", n=(12, 10, 14), **kw):
    grid = {"size": {"x": n[0], "y": n[1], "z": n[2]}, "dn": 0.25, "dt": 0.01}
    return base_config(central_difference=order, precision=precision, grid=grid, **kw)


def _field(cfg, rng, unit=False):
    w = np.pad(rng.normal(size=cfg.work_size()), cfg.central_difference.ext)
    if unit:
        w /= np.sqrt(np.sum(w * w))
    return w.astype(NP[cfg.precision])


@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1", "S2"])
@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("order", ORDERS)
def test_evolve_chunk_matches_jax(tmp_run, order, precision, mode):
    cfg = _cfg(order, precision)
    rng = np.random.default_rng(1)
    phi = _field(cfg, rng)
    n_lower = {"S1": 1, "S2": 2}.get(mode, 0)
    store = np.stack([_field(cfg, rng, unit=True) for _ in range(n_lower)]) if n_lower else None
    pots = jpot.load_arrays(cfg)
    g = cfg.grid
    args = (order, g.dt, g.dn, cfg.mass, 6, n_lower)
    psn = mode == "per_step_norm"
    ref = jst.evolve_chunk(
        jnp.asarray(phi), pots.a, pots.b, None if store is None else jnp.asarray(store),
        *args, per_step_norm=psn,
    )
    tp = convert.potentials(pots)
    out = tst.evolve_chunk(
        convert.tensor(phi), tp.a, tp.b, None if store is None else convert.tensor(store),
        *args, per_step_norm=psn,
    )
    assert out.dtype == DTYPES[precision]
    close(out, ref, precision)


@pytest.mark.parametrize("potential", ["Harmonic", "SimpleCornell", "FullCornell"])
@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("order", ORDERS)
def test_observables_match_jax(tmp_run, order, precision, potential):
    """energy, norm², V∞ (none / scalar / FullCornell array) and ⟨r²⟩,
    with f32 fields accumulated by hybrid_sum into f64."""
    cfg = _cfg(order, precision, potential=potential, mass=1.5, sig=0.4)
    phi = _field(cfg, np.random.default_rng(2))
    pots = jpot.load_arrays(cfg)
    shape = (cfg.work_size(), cfg.grid.size.as_tuple())
    ref = jobs.compute_observables_device(
        jnp.asarray(phi), pots.v, jgeo.r2_index_grid(*shape, dtype=cfg.real_dtype),
        pots.pot_sub_array, pots.pot_sub_scalar, order, cfg.grid.dn, cfg.mass,
    )
    tp = convert.potentials(pots)
    out = tobs.compute_observables_device(
        convert.tensor(phi), tp.v, tgeo.r2_index_grid(*shape, dtype=DTYPES[precision]),
        tp.pot_sub_array, tp.pot_sub_scalar, order, cfg.grid.dn, cfg.mass,
    )
    for o, r in zip(out, ref):
        assert o.dtype == torch.float64
        assert abs(float(o) - float(r)) <= RTOL[precision] * max(abs(float(r)), 1e-300)


def test_hybrid_sum_matches_jax():
    """f32 rows summed in f32, combined in f64: near-f64 totals."""
    x = np.random.default_rng(3).normal(3.0, 1.0, size=(40, 30, 257)).astype(np.float32)
    exact = float(np.sum(x.astype(np.float64)))
    out = tobs.hybrid_sum(torch.from_numpy(x))
    ref = float(jobs.hybrid_sum(jnp.asarray(x)))
    assert out.dtype == torch.float64
    assert abs(float(out) - ref) <= 1e-6 * abs(exact)
    assert abs(float(out) - exact) <= 1e-6 * abs(exact)
    x64 = torch.from_numpy(x.astype(np.float64))
    assert float(tobs.hybrid_sum(x64)) == float(torch.sum(x64))


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("family", REAL_FAMILIES)
def test_potential_generate_matches_jax(family, precision):
    cfg = _cfg("FivePoint", precision, potential=family, mass=1.5, sig=0.4)
    out = tpot.generate(cfg)
    assert out.dtype == DTYPES[precision]
    close(out, jpot.generate(cfg), precision)
    if family == "FullCornell":
        close(tpot.potential_sub_array(cfg), jpot.potential_sub_array(cfg), precision)
    else:
        assert tpot.potential_sub_scalar(cfg) == jpot.potential_sub_scalar(cfg)


@pytest.mark.parametrize("family", ["Harmonic", "SimpleCornell", "FullCornell", "Coulomb"])
def test_load_arrays_matches_jax(tmp_run, family):
    """V, A, B, the gauge shift and pot_sub (f32, the slice's precision)."""
    cfg = _cfg("ThreePoint", "f32", potential=family, mass=4.65, sig=0.223)
    ref = jpot.load_arrays(cfg)
    out = tpot.load_arrays(cfg)
    for name in ("v", "a", "b"):
        close(getattr(out, name), getattr(ref, name), "f32")
    assert out.v_min == pytest.approx(ref.v_min, rel=1e-6)
    assert out.v_shift == pytest.approx(ref.v_shift, rel=1e-6)
    assert out.pot_sub_scalar == ref.pot_sub_scalar
    if ref.pot_sub_array is None:
        assert out.pot_sub_array is None
    else:
        close(out.pot_sub_array, ref.pot_sub_array, "f32")
    assert tpot.scan_v_min(cfg) == pytest.approx(jpot.scan_v_min(cfg), rel=1e-6)
    # convert carries the reference's bundle across unchanged
    conv = convert.potentials(ref)
    assert conv.v_shift == ref.v_shift and torch.equal(conv.b, convert.tensor(ref.b))


def test_build_ab_matches_jax():
    v = np.random.default_rng(4).normal(size=(6, 7, 8)) * 10.0
    ja, jb = jpot.build_ab(jnp.asarray(v), 0.01, v_shift=2.5)
    ta, tb = tpot.build_ab(torch.from_numpy(v), 0.01, v_shift=2.5)
    close(ta, ja, "f64")
    close(tb, jb, "f64")


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("family", ["ComplexHarmonic", "ComplexCoulomb", "ComplexFullCornell"])
def test_complex_potential_generate_matches_jax(family, precision):
    """The complex families as complex tensors, (1 + i·absorb)·V, and the
    single-point evaluation."""
    cfg = _cfg("FivePoint", precision, potential=family, absorb=0.3, mass=1.5, sig=0.4)
    out, ref = tpot.generate(cfg), np.asarray(jpot.generate(cfg))
    assert out.dtype == {"f32": torch.complex64, "f64": torch.complex128}[precision]
    close(out.real, ref.real, precision)
    close(out.imag, ref.imag, precision)
    for idx in ((0, 0, 0), (5, 4, 6), (15, 13, 17)):
        assert tpot.potential_scalar(cfg, idx) == pytest.approx(
            jpot.potential_scalar(cfg, idx), rel=RTOL[precision])


@pytest.mark.parametrize("sym", ["NotConstrained", "AboutY", "AntisymAboutZ"])
@pytest.mark.parametrize("ic", ["Constant", "Boolean", "Coulomb"])
def test_initial_conditions_match_jax(ic, sym):
    """Deterministic generators, the Dirichlet shell and the mid-plane
    (anti)symmetrisation."""
    for order in ("ThreePoint", "SevenPoint"):
        cfg = _cfg(order, "f64", init_condition=ic, init_symmetry=sym)
        close(tinit.set_initial_conditions(cfg), jinit.set_initial_conditions(cfg), "f64")


def test_symmetrise_matches_jax_on_noise():
    rng = np.random.default_rng(5)
    for sym in ("AboutZ", "AntisymAboutY"):
        cfg = _cfg("FivePoint", "f64", init_symmetry=sym)
        w = _field(cfg, rng)
        close(
            tinit.symmetrise_wavefunction(cfg, torch.from_numpy(w)),
            jinit.symmetrise_wavefunction(cfg, jnp.asarray(w)), "f64",
        )


def test_seeded_initial_conditions():
    """Seeded noise cannot reproduce jax.random (a documented divergence):
    check determinism, the Dirichlet shell and the amplitudes instead."""
    cfg = _cfg("FivePoint", "f32", n=(16, 16, 16), init_condition="Gaussian", sig=0.5)
    a = tinit.set_initial_conditions(cfg, seed=3)
    assert torch.equal(a, tinit.set_initial_conditions(cfg, seed=3))
    assert not torch.equal(a, tinit.set_initial_conditions(cfg, seed=4))
    assert torch.equal(a, tgeo.zero_boundary(a, 2))
    assert 0.45 < float(tgeo.work_area(a, 2).std()) < 0.55
    p = tinit.perturb_clone(cfg, a, 1, seed=3)
    assert torch.equal(p, tinit.perturb_clone(cfg, a, 1, seed=3))
    assert not torch.equal(p, tinit.perturb_clone(cfg, a, 2, seed=3))
    assert torch.equal(p, tgeo.zero_boundary(p, 2))
    noise, base = tgeo.work_area(p - a, 2), tgeo.work_area(a, 2)
    rel = float(torch.sqrt(torch.mean(noise ** 2) / torch.mean(base ** 2)))
    assert 0.9e-3 < rel < 1.1e-3  # scale 1e-3 of the state's rms


def test_geometry_matches_jax():
    rng = np.random.default_rng(6)
    for ext in (1, 2, 3):
        w = rng.normal(size=(10 + 2 * ext, 9 + 2 * ext, 8 + 2 * ext))
        tw = torch.from_numpy(w)
        close(tgeo.zero_boundary(tw, ext), jgeo.zero_boundary(jnp.asarray(w), ext), "f64")
        close(tgeo.work_area(tw, ext), jgeo.work_area(jnp.asarray(w), ext), "f64")
        inner = rng.normal(size=(10, 9, 8))
        close(
            tgeo.set_work_area(tw, ext, torch.from_numpy(inner)),
            jgeo.set_work_area(jnp.asarray(w), ext, jnp.asarray(inner)), "f64",
        )
        assert np.array_equal(to_numpy(tw), w)  # set_work_area copies
    close(tgeo.r2_index_grid((10, 9, 8), (10, 9, 8)), jgeo.r2_index_grid((10, 9, 8), (10, 9, 8)), "f64")
    for order in ORDERS:
        assert tgeo.stencil_coefficients(order) == jgeo.stencil_coefficients(order)
        assert tgeo.EXT[order] == base_config(central_difference=order).central_difference.ext


def test_gram_schmidt_matches_jax():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(8, 9, 10))
    store = rng.normal(size=(2, 8, 9, 10))
    store /= np.sqrt(np.sum(store ** 2, axis=(1, 2, 3), keepdims=True))
    n2 = float(tgs.get_norm_squared(torch.from_numpy(w)))
    assert n2 == pytest.approx(float(jgs.get_norm_squared(jnp.asarray(w))), rel=1e-12)
    close(
        tgs.normalise_wavefunction(torch.from_numpy(w), n2),
        jgs.normalise_wavefunction(jnp.asarray(w), n2), "f64",
    )
    close(
        tgs.orthogonalise_wavefunction(torch.from_numpy(w), torch.from_numpy(store), 2),
        jgs.orthogonalise_wavefunction(jnp.asarray(w), jnp.asarray(store), 2), "f64",
    )
