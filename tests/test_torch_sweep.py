"""The CUDA sweep's module (``wafer_torch/ops/hopper_stencil.py``) against
the reference's Pallas kernels, run as tests/test_pallas_stencil.py runs
them on the CPU (interpret mode).

On CPU tensors the wrappers take their plain torch versions, so these
tests hold the plain versions — the oracle chip_smoke.py and
tests/test_torch_gpu.py compare the kernels with on the card — against
Pallas.

Tolerance: 1e-5 of the reference field's largest magnitude (f32; the
port corrects every tap where the resident TPU kernel corrects the swept
images, and sums in f64 where the TPU sums in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import base_config
from wafer_torch import convert
from wafer_torch.ops import hopper_stencil as hs
from wafer_tpu import geometry as jgeo
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import pallas_stencil as pk

ORDERS = ["ThreePoint", "FivePoint", "SevenPoint"]
KINDS = ["NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic"]
RTOL = 1e-5


def close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port.astype(np.float64) - ref.astype(np.float64)).max()
    assert err <= rtol * np.abs(ref).max(), err / np.abs(ref).max()


def _setup(order, potential="Harmonic", n=(16, 16, 16), seed=0, **kw):
    cfg = base_config(
        central_difference=order, precision="f32", potential=potential,
        grid={"size": {"x": n[0], "y": n[1], "z": n[2]}, "dn": 0.2, "dt": 0.004}, **kw,
    )
    ext = cfg.central_difference.ext
    g = cfg.grid
    phi = np.pad(np.random.default_rng(seed).normal(size=n), ext).astype(np.float32)
    v = jpot.generate(cfg).astype(jnp.float32)
    _a, b = jpot.build_ab(v, g.dt)
    b_int = np.asarray(jgeo.work_area(b, ext))
    analytic = (potential, g.dn, g.dt, cfg.mass, *n, cfg.sig)
    _o, _c, _cc, k = jgeo.stencil_coefficients(order)
    scale = g.dt / (k * g.dn ** 2 * cfg.mass)
    return cfg, ext, phi, b_int, analytic, scale


def _lowers(cfg, n_lower, seed):
    rng = np.random.default_rng(seed)
    ext = cfg.central_difference.ext
    out = []
    for _ in range(n_lower):
        w = np.pad(rng.normal(size=cfg.work_size()), ext)
        out.append((w / np.sqrt(np.sum(w * w))).astype(np.float32))
    return np.stack(out)


def _xpad(a, ext):
    """Fully padded → the reference's x-padded layout (leading axes kept)."""
    return jnp.asarray(a[..., ext:-ext, ext:-ext])


@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1"])
@pytest.mark.parametrize("b_mode", ["analytic", "streamed"])
@pytest.mark.parametrize("order", ORDERS)
def test_step_matches_pallas(order, b_mode, mode):
    """One sweep with a non-identity carried coefficient vs
    ``pallas_stencil.evolve_step_fused`` (B2): ψ' and its reductions."""
    cfg, ext, phi, b_int, analytic, scale = _setup(order)
    n_lower = 1 if mode == "S1" else 0
    with_norm = mode != "ground"
    store = _lowers(cfg, n_lower, 1) if n_lower else None
    coef = np.array([[0.8], [0.3]], np.float32)[: 1 + n_lower] if with_norm else None
    an = analytic if b_mode == "analytic" else None
    out_j, n2_j, ov_j = pk.evolve_step_fused(
        _xpad(phi, ext), None if an else jnp.asarray(b_int),
        None if store is None else _xpad(store, ext), order, scale, n_lower, with_norm,
        interpret=True, coef=None if coef is None else jnp.asarray(coef), analytic=an,
    )
    psi = convert.tensor(phi)
    out_t = torch.empty_like(psi)
    coef_t = convert.tensor(coef).reshape(-1) if with_norm else torch.ones(1)
    part = torch.empty(1, 1 + n_lower, dtype=torch.float64) if with_norm else None
    hs.sweep_step(
        psi, out_t, coef_t, part, order=order, scale=scale, analytic=an,
        b_int=None if an else convert.tensor(b_int),
        store=None if store is None else convert.tensor(store), apply_coef=with_norm,
    )
    close(out_t, pk.from_xpad(out_j, ext))
    if with_norm:
        red = torch.empty(1 + n_lower, dtype=torch.float64)
        hs.finish_coef(part, red, torch.empty_like(coef_t))
        n2 = float(n2_j)
        assert abs(float(red[0]) - n2) <= RTOL * n2
        if n_lower:
            assert abs(float(red[1]) - float(ov_j[0])) <= RTOL * np.sqrt(n2)


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_b_matches_pallas(kind):
    """B from coordinates (with a gauge shift) vs ``_analytic_b``, and vs
    the array B the reference builds from the generated V."""
    n, ext, vshift = (12, 10, 14), 2, 1.7
    cfg = base_config(
        central_difference="FivePoint", precision="f32", potential=kind, mass=4.65, sig=0.223,
        grid={"size": {"x": n[0], "y": n[1], "z": n[2]}, "dn": 0.35, "dt": 0.004},
    )
    analytic = (kind, 0.35, 0.004, 4.65, *n, 0.223, vshift)
    out = hs.analytic_b(analytic, cfg.padded_size(), ext)
    assert out.dtype == torch.float32 and tuple(out.shape) == n
    close(out, pk._analytic_b(analytic, n, float(ext), ext, ext), 1e-6)
    _a, b = jpot.build_ab(jpot.generate(cfg), 0.004, v_shift=vshift)
    close(out, jgeo.work_area(b, ext), 2e-5)


CHUNK_CASES = [
    ("ThreePoint", "ground", "analytic"),
    ("FivePoint", "ground", "analytic"),
    ("SevenPoint", "ground", "analytic"),
    ("ThreePoint", "per_step_norm", "analytic"),
    ("ThreePoint", "S1", "analytic"),
    ("ThreePoint", "S2", "analytic"),
    ("SevenPoint", "S1", "analytic"),
    ("ThreePoint", "ground", "streamed"),
    ("ThreePoint", "per_step_norm", "streamed"),
    ("FivePoint", "S1", "streamed"),
]


@pytest.mark.parametrize("order, mode, b_mode", CHUNK_CASES)
def test_chunk_matches_pallas_resident(order, mode, b_mode):
    """A 5-step chunk vs ``evolve_chunk_resident`` (B1 ground and
    per-step-norm, B3 excited with the l/S(l) streams)."""
    cfg, ext, phi, b_int, analytic, scale = _setup(order, seed=2)
    g = cfg.grid
    n_lower = {"S1": 1, "S2": 2}.get(mode, 0)
    psn = mode == "per_step_norm"
    an = analytic if b_mode == "analytic" else None
    bj = None if an else jnp.asarray(b_int)
    kw = {}
    store = None
    if n_lower:
        store = _lowers(cfg, n_lower, 3)
        sls = [
            pk.evolve_step_fused(_xpad(w, ext), bj, None, order, scale, 0, False,
                                 interpret=True, analytic=an)[0]
            for w in store
        ]
        kw = dict(store_xpad=_xpad(store, ext), sstore_xpad=jnp.stack(sls))
    ref = pk.evolve_chunk_resident(
        _xpad(phi, ext), order, g.dt, g.dn, cfg.mass, 5, an, interpret=True,
        per_step_norm=psn, b_int=bj, **kw,
    )
    out = hs.evolve_chunk(
        convert.tensor(phi), order, g.dt, g.dn, cfg.mass, 5, an, per_step_norm=psn,
        store=None if store is None else convert.tensor(store),
        b_int=None if an else convert.tensor(b_int),
    )
    close(out, pk.from_xpad(ref, ext))


@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1", "S2"])
def test_chunk_matches_pallas_fused(mode):
    """The same chunk function vs ``evolve_chunk_fused`` (B2's chunk: the
    correction applied to the input taps, as the CUDA kernel does)."""
    order = "FivePoint"
    cfg, ext, phi, b_int, analytic, scale = _setup(order, seed=4)
    g = cfg.grid
    n_lower = {"S1": 1, "S2": 2}.get(mode, 0)
    psn = mode == "per_step_norm"
    store = _lowers(cfg, n_lower, 5) if n_lower else None
    ref = pk.evolve_chunk_fused(
        _xpad(phi, ext), jnp.asarray(b_int), None if store is None else _xpad(store, ext),
        order, g.dt, g.dn, cfg.mass, 4, n_lower, interpret=True, per_step_norm=psn,
    )
    out = hs.evolve_chunk(
        convert.tensor(phi), order, g.dt, g.dn, cfg.mass, 4, per_step_norm=psn,
        store=None if store is None else convert.tensor(store), b_int=convert.tensor(b_int),
    )
    close(out, pk.from_xpad(ref, ext))


def test_wrappers_take_plain_version_on_cpu():
    """CPU tensors run the plain versions and launch (count) nothing."""
    cfg, ext, phi, _b, analytic, scale = _setup("ThreePoint", seed=6)
    psi = convert.tensor(phi)
    store = convert.tensor(_lowers(cfg, 2, 7))
    coef = torch.tensor([0.9, 0.2, -0.1])
    before = dict(hs.LAUNCHES)
    assert hs.num_partials(psi, "ThreePoint") == 1
    kw = dict(order="ThreePoint", scale=scale, analytic=analytic, store=store, apply_coef=True)
    out, ref = torch.empty_like(psi), torch.empty_like(psi)
    part, part_ref = torch.empty(1, 3, dtype=torch.float64), torch.empty(1, 3, dtype=torch.float64)
    hs.sweep_step(psi, out, coef, part, **kw)
    hs.sweep_step_plain(psi, ref, coef, part_ref, **kw)
    assert torch.equal(out, ref) and torch.equal(part, part_ref)
    red, c = torch.empty(3, dtype=torch.float64), torch.empty(3)
    hs.finish_coef(part, red, c)
    assert float(c[0]) == pytest.approx(float(red[0]) ** -0.5, rel=1e-6)
    assert float(c[2]) == pytest.approx(float(red[2]) * float(c[0]), rel=1e-6)
    assert hs.LAUNCHES == before
    # the shell is written zero, the input is untouched
    assert float(out[0].abs().max()) == 0.0 and torch.equal(psi, convert.tensor(phi))


def test_wrappers_reject_other_devices():
    psi = torch.empty(6, 6, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hs.sweep_step(psi, torch.empty_like(psi), torch.ones(1, device="meta"), None,
                      order="ThreePoint", scale=0.1, analytic=("Harmonic", 0.2, 0.004, 1.0, 4, 4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        hs.finish_coef(torch.empty(1, 1, device="meta"), torch.empty(1, device="meta"),
                       torch.empty(1, device="meta"))


def test_chunk_requires_a_b_source():
    with pytest.raises(ValueError, match="analytic or b_int"):
        hs.evolve_chunk(torch.zeros(6, 6, 6), "ThreePoint", 0.004, 0.2, 1.0, 2)
