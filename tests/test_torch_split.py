"""The port's split-complex modules against the reference's on the same
inputs: ``wafer_torch/ops/split_complex.py`` (plain pair ops) against
``wafer_tpu.ops.split_complex``, and ``wafer_torch/ops/hopper_split.py``
(the CUDA pair sweep's module; on CPU tensors its wrappers run their plain
versions, the oracle the kernel is held against on the card) against the
five Pallas split kernels, run in interpret mode as
tests/test_pallas_split.py runs them, at the shapes that suite uses.

Tolerances: the Pallas tests' own (rtol 2e-5 / atol 2e-6 for ground
chunks, 5e-5 / 5e-6 for per-step-norm, excited and multi-step variants);
single sweeps within 1e-5 of the field's largest magnitude (f32 in another
operation order: the port eliminates A = 2B − 1 and corrects every tap);
the plain ops within 1e-5 (f32) and 1e-12 (f64) of the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import base_config
from wafer_torch import convert, geometry as tgeo
from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs, split_complex as tsc
from wafer_tpu import geometry as jgeo
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import pallas_split as ps, split_complex as jsc

ORDERS = ["ThreePoint", "FivePoint", "SevenPoint"]
RTOL = {"f32": 1e-5, "f64": 1e-12}
NP = {"f32": np.float32, "f64": np.float64}


def close(port, ref, rtol):
    """max |port − ref| ≤ rtol·max|ref|."""
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref.astype(np.float64)).max()
    assert err <= rtol * np.abs(ref).max(), err / np.abs(ref).max()


def allclose(port, ref, rtol, atol):
    np.testing.assert_allclose(
        port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port),
        np.asarray(ref), rtol=rtol, atol=atol,
    )


def _pair_field(rng, cfg, dtype=np.float32, unit=False):
    ext = cfg.central_difference.ext
    re, im = (np.pad(rng.normal(size=cfg.work_size()), ext) for _ in range(2))
    if unit:
        n = np.sqrt(np.sum(re * re + im * im))
        re, im = re / n, im / n
    return re.astype(dtype), im.astype(dtype)


def _setup(order, n=(8, 8, 128), seed=41, precision="f32", potential="ComplexHarmonic"):
    """The Pallas tests' configuration: ComplexHarmonic, absorb 0.2."""
    cfg = base_config(
        precision=precision, potential=potential, absorb=0.2, central_difference=order,
        mass=1.0 if potential == "ComplexHarmonic" else 4.65,
        sig=1.0 if potential == "ComplexHarmonic" else 0.223,
        grid={"size": {"x": n[0], "y": n[1], "z": n[2]}, "dn": 0.2, "dt": 0.004},
    )
    ext = cfg.central_difference.ext
    rng = np.random.default_rng(seed)
    pr, pi = _pair_field(rng, cfg, NP[precision])
    vr, vi = jpot.generate_split(cfg)
    vr, vi = vr.astype(NP[precision]), vi.astype(NP[precision])
    ar, ai, br, bi = (np.asarray(x) for x in jpot.build_ab_split(vr, vi, cfg.grid.dt))
    g = cfg.grid
    analytic = ("Harmonic", g.dn, g.dt, cfg.mass, *n, cfg.sig, 0.0, cfg.absorb)
    k = jgeo.stencil_coefficients(order)[3]
    scale = g.dt / (k * g.dn ** 2 * cfg.mass)
    return cfg, ext, pr, pi, (ar, ai, br, bi), analytic, scale


def _stores(cfg, n_lower, seed):
    rng = np.random.default_rng(seed)
    pairs = [_pair_field(rng, cfg, unit=True) for _ in range(n_lower)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _b2_jax(br, bi, ext):
    """The reference's stacked interior (Br, Bi): (2·NX, NY, NZ)."""
    return jnp.concatenate([jgeo.work_area(br, ext), jgeo.work_area(bi, ext)], axis=0)


def _b2_port(br, bi, ext):
    return convert.pair(np.asarray(jgeo.work_area(br, ext)), np.asarray(jgeo.work_area(bi, ext)))


def _from_xpad(out2, ext):
    return convert.pair(*(np.asarray(x) for x in ps.from_xpad_sc(out2, ext)))


# --------------------------------------------------------------------------- #
# ops/split_complex.py against wafer_tpu.ops.split_complex
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["step", "ground", "per_step_norm", "S1"])
@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("order", ORDERS)
def test_plain_split_chunk_matches_jax(order, precision, mode):
    cfg, ext, pr, pi, (ar, ai, br, bi), _an, _s = _setup(order, (12, 10, 14), 1, precision)
    g = cfg.grid
    fields = (ar, ai, br, bi)
    if mode == "step":
        ref = jsc.evolve_step_sc(jnp.asarray(pr), jnp.asarray(pi), *map(jnp.asarray, fields),
                                 order, g.dt, g.dn, cfg.mass)
        out = tsc.evolve_step_sc(convert.tensor(pr), convert.tensor(pi),
                                 *map(convert.tensor, fields), order, g.dt, g.dn, cfg.mass)
    else:
        n_lower = 1 if mode == "S1" else 0
        lr = li = None
        if n_lower:
            lr, li = (x.astype(NP[precision]) for x in _stores(cfg, 1, 2))
        args = (order, g.dt, g.dn, cfg.mass, 6, n_lower)
        psn = mode == "per_step_norm"
        ref = jsc.evolve_chunk_sc(
            jnp.asarray(pr), jnp.asarray(pi), *map(jnp.asarray, fields),
            None if lr is None else jnp.asarray(lr), None if li is None else jnp.asarray(li),
            *args, per_step_norm=psn,
        )
        out = tsc.evolve_chunk_sc(
            convert.tensor(pr), convert.tensor(pi), *map(convert.tensor, fields),
            None if lr is None else convert.tensor(lr), None if li is None else convert.tensor(li),
            *args, per_step_norm=psn,
        )
    for o, r in zip(out, ref):
        assert o.dtype == {"f32": torch.float32, "f64": torch.float64}[precision]
        close(o, r, RTOL[precision])


@pytest.mark.parametrize("potential", ["ComplexHarmonic", "ComplexFullCornell"])
@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("order", ORDERS)
def test_plain_split_measure_matches_jax(order, precision, potential):
    """The five hybrid sums (with FullCornell's V(∞) array), then normalise
    and project against one stored pair."""
    cfg, ext, pr, pi, _f, _an, _s = _setup(order, (12, 10, 14), 3, precision, potential)
    vr, vi = (np.asarray(x).astype(NP[precision]) for x in jpot.generate_split(cfg))
    r2 = np.asarray(jgeo.r2_index_grid(cfg.work_size(), cfg.grid.size.as_tuple(),
                                       dtype=NP[precision]))
    psa = None
    if potential == "ComplexFullCornell":
        psa = np.asarray(jpot.potential_sub_array(cfg)).astype(NP[precision])
    lr, li = (x.astype(NP[precision]) for x in _stores(cfg, 1, 4))
    tail = (order, cfg.grid.dn, cfg.mass, 1)
    ref_s, ref_p = jsc.measure_and_prepare_sc(
        *map(jnp.asarray, (pr, pi, vr, vi, r2)), None if psa is None else jnp.asarray(psa),
        None, jnp.asarray(lr), jnp.asarray(li), *tail,
    )
    out_s, out_p = tsc.measure_and_prepare_sc(
        *map(convert.tensor, (pr, pi, vr, vi, r2)),
        None if psa is None else convert.tensor(psa), None,
        convert.tensor(lr), convert.tensor(li), *tail,
    )
    scale = max(abs(float(x)) for x in ref_s)
    for o, r in zip(out_s, ref_s):
        assert o.dtype == torch.float64
        assert abs(float(o) - float(r)) <= RTOL[precision] * scale, (float(o), float(r))
    for o, r in zip(out_p, ref_p):
        close(o, r, RTOL[precision])


# --------------------------------------------------------------------------- #
# ops/hopper_split.py against the Pallas split kernels (interpret mode)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1", "S2", "S3", "S5"])
@pytest.mark.parametrize("b_mode", ["analytic", "streamed"])
@pytest.mark.parametrize("order", ORDERS)
def test_step_matches_pallas(order, b_mode, mode):
    """One pair sweep with a non-identity carried coefficient vs
    ``pallas_split.evolve_step_fused_sc`` (B8): ψ', ‖ψ'‖² and the 2S
    conjugated overlaps."""
    cfg, ext, pr, pi, (_ar, _ai, br, bi), analytic, scale = _setup(order)
    n_lower = {"S1": 1, "S2": 2, "S3": 3, "S5": 5}.get(mode, 0)
    with_norm = mode != "ground"
    store = _stores(cfg, n_lower, 1) if n_lower else None
    coef = np.array([0.8, 0.3, -0.2, 0.1, 0.05, -0.07, 0.04, 0.12, -0.03, 0.06, -0.09],
                    np.float32)[: 1 + 2 * n_lower]
    an = analytic if b_mode == "analytic" else None
    store2 = None
    if n_lower:
        store2 = jnp.stack([ps.to_xpad_sc(jnp.asarray(store[0][s]), jnp.asarray(store[1][s]), ext)
                            for s in range(n_lower)])
    out_j, n2_j, ov_j = ps.evolve_step_fused_sc(
        ps.to_xpad_sc(jnp.asarray(pr), jnp.asarray(pi), ext),
        None if an else _b2_jax(br, bi, ext), store2, order, scale, n_lower, with_norm,
        interpret=True, coef=jnp.asarray(coef).reshape(-1, 1) if with_norm else None,
        analytic=an,
    )
    psi = convert.pair(pr, pi)
    out = torch.empty_like(psi)
    coef_t = convert.tensor(coef) if with_norm else torch.ones(1)
    part = torch.empty(1, 1 + 2 * n_lower, dtype=torch.float64) if with_norm else None
    hsp.sweep_step_sc(
        psi, out, coef_t, part, order=order, scale=scale, analytic=an,
        b2=None if an else _b2_port(br, bi, ext),
        store=None if store is None else convert.pair(*store), apply_coef=with_norm,
    )
    close(out, _from_xpad(out_j, ext), RTOL["f32"])
    if with_norm:
        red = torch.empty(1 + 2 * n_lower, dtype=torch.float64)
        hs.finish_coef(part, red, torch.empty(1 + 2 * n_lower))
        n2 = float(n2_j)
        assert abs(float(red[0]) - n2) <= RTOL["f32"] * n2
        for q in range(2 * n_lower):
            assert abs(float(red[1 + q]) - float(ov_j[q])) <= RTOL["f32"] * np.sqrt(n2)


@pytest.mark.parametrize("kind", ["Harmonic", "Coulomb"])
def test_analytic_b_sc_matches_pallas(kind):
    """Complex B from coordinates (with a gauge shift) vs ``_analytic_b_sc``,
    and vs the arrays the reference builds from the generated split V."""
    n, ext, vshift = (12, 10, 14), 2, 0.7
    cfg = base_config(
        central_difference="FivePoint", precision="f32", potential=f"Complex{kind}",
        absorb=0.2, grid={"size": {"x": n[0], "y": n[1], "z": n[2]}, "dn": 0.35, "dt": 0.004},
    )
    analytic = (kind, 0.35, 0.004, 1.0, *n, 1.0, vshift, 0.2)
    br, bi = hsp.analytic_b_sc(analytic, cfg.padded_size(), ext)
    assert br.dtype == torch.float32 and tuple(br.shape) == n
    jbr, jbi = ps._analytic_b_sc(analytic, n, float(ext), ext, ext)
    close(br, jbr, 1e-6)
    close(bi, jbi, 1e-6)
    _ar, _ai, abr, abi = jpot.build_ab_split(*jpot.generate_split(cfg), 0.004, v_shift=vshift)
    close(br, jgeo.work_area(abr, ext), 2e-5)
    close(bi, jgeo.work_area(abi, ext), 2e-5)


@pytest.mark.parametrize("mode", ["ground", "per_step_norm"])
@pytest.mark.parametrize("b_mode", ["analytic", "streamed"])
@pytest.mark.parametrize("order", ORDERS)
def test_chunk_matches_pallas_resident_mixed(order, b_mode, mode):
    """``evolve_chunk_resident_mixed_sc`` (B7, the default 256³ complex
    ground chunk): re resident, im streamed, analytic or streamed (Br, Bi);
    5 steps, the odd ping-pong parity."""
    cfg, ext, pr, pi, (_ar, _ai, br, bi), analytic, _s = _setup(order)
    g = cfg.grid
    psn = mode == "per_step_norm"
    an = analytic if b_mode == "analytic" else None
    ref = ps.evolve_chunk_resident_mixed_sc(
        ps.to_xpad_sc(jnp.asarray(pr), jnp.asarray(pi), ext), order, g.dt, g.dn, cfg.mass, 5,
        an, interpret=True, b2=None if an else _b2_jax(br, bi, ext), per_step_norm=psn,
    )
    out = hsp.evolve_chunk_sc(
        convert.pair(pr, pi), order, g.dt, g.dn, cfg.mass, 5, an, per_step_norm=psn,
        b2=None if an else _b2_port(br, bi, ext),
    )
    tol = (5e-5, 5e-6) if psn else (2e-5, 2e-6)
    allclose(out, _from_xpad(ref, ext), *tol)


@pytest.mark.parametrize("mode", ["ground", "per_step_norm"])
@pytest.mark.parametrize("b_mode", ["analytic", "streamed"])
@pytest.mark.parametrize("order", ORDERS)
def test_chunk_matches_pallas_resident(order, b_mode, mode):
    """``evolve_chunk_resident_sc`` (B9, the pair resident), 4 steps."""
    cfg, ext, pr, pi, (_ar, _ai, br, bi), analytic, _s = _setup(order, seed=42)
    g = cfg.grid
    psn = mode == "per_step_norm"
    an = analytic if b_mode == "analytic" else None
    ref = ps.evolve_chunk_resident_sc(
        ps.to_xpad_sc(jnp.asarray(pr), jnp.asarray(pi), ext), order, g.dt, g.dn, cfg.mass, 4,
        an, interpret=True, per_step_norm=psn, b2=None if an else _b2_jax(br, bi, ext),
    )
    out = hsp.evolve_chunk_sc(
        convert.pair(pr, pi), order, g.dt, g.dn, cfg.mass, 4, an, per_step_norm=psn,
        b2=None if an else _b2_port(br, bi, ext),
    )
    tol = (5e-5, 5e-6) if psn else (2e-5, 2e-6)
    allclose(out, _from_xpad(ref, ext), *tol)


@pytest.mark.parametrize("n_lower", [0, 1, 2, 3])
@pytest.mark.parametrize("order", ORDERS)
def test_chunk_matches_pallas_fused(order, n_lower):
    """``evolve_chunk_fused_sc`` (B8 looped: the only excited split chunk),
    streamed B, with the pending correction materialised at the end."""
    cfg, ext, pr, pi, (_ar, _ai, br, bi), _an, _s = _setup(order, seed=43)
    g = cfg.grid
    store = _stores(cfg, n_lower, 44) if n_lower else None
    store2 = None
    if n_lower:
        store2 = jnp.stack([ps.to_xpad_sc(jnp.asarray(store[0][s]), jnp.asarray(store[1][s]), ext)
                            for s in range(n_lower)])
    ref = ps.evolve_chunk_fused_sc(
        ps.to_xpad_sc(jnp.asarray(pr), jnp.asarray(pi), ext), _b2_jax(br, bi, ext), store2,
        order, g.dt, g.dn, cfg.mass, 3, n_lower, interpret=True,
    )
    out = hsp.evolve_chunk_sc(
        convert.pair(pr, pi), order, g.dt, g.dn, cfg.mass, 3,
        store=None if store is None else convert.pair(*store), b2=_b2_port(br, bi, ext),
    )
    tol = (5e-5, 5e-6) if n_lower else (2e-5, 2e-6)
    allclose(out, _from_xpad(ref, ext), *tol)
    if n_lower:  # orthogonal to every stored pair (complex overlap)
        lr, li = convert.pair(*store)[:, 0], convert.pair(*store)[:, 1]
        o_re = torch.sum(lr * out[0] + li * out[1], dim=(1, 2, 3))
        o_im = torch.sum(lr * out[1] - li * out[0], dim=(1, 2, 3))
        assert float(torch.max(torch.hypot(o_re, o_im))) < 1e-4


@pytest.mark.parametrize("order", ORDERS)
def test_chunk_matches_pallas_resident_blocked(order):
    """``evolve_chunk_resident_blocked_sc`` (B10: R blind deep-halo steps
    per x-block, analytic B) on its 32×8×128 shape; 5 steps = 2 passes of
    R = 2 plus a remainder step."""
    cfg, ext, pr, pi, _f, analytic, _s = _setup(order, n=(32, 8, 128), seed=47)
    g = cfg.grid
    ref = ps.evolve_chunk_resident_blocked_sc(
        ps.to_xpad_k_sc(jnp.asarray(pr), jnp.asarray(pi), ext, 2), order, g.dt, g.dn, cfg.mass,
        5, analytic, bx=8, r_steps=2, interpret=True, tx=4,
    )
    out = hsp.evolve_chunk_sc(convert.pair(pr, pi), order, g.dt, g.dn, cfg.mass, 5, analytic)
    ref_pair = convert.pair(*(np.asarray(x) for x in ps.from_xpad_k_sc(ref, ext, 2)))
    allclose(out, ref_pair, 5e-5, 5e-6)


@pytest.mark.parametrize("b_mode", ["analytic", "streamed"])
@pytest.mark.parametrize("order", ORDERS)
def test_chunk_matches_pallas_fused_k(order, b_mode):
    """``evolve_chunk_fused_k_sc`` (B11: K = 2 steps per pass), 5 steps =
    2 passes plus a remainder step."""
    cfg, ext, pr, pi, (_ar, _ai, br, bi), analytic, _s = _setup(order, seed=48)
    g = cfg.grid
    an = analytic if b_mode == "analytic" else None
    b2k = None
    if an is None:  # streamed B in the K layout: each component padded by (K−1)·ext
        pad = ((ext, ext), (0, 0), (0, 0))
        b2k = jnp.concatenate([jnp.pad(jgeo.work_area(br, ext), pad),
                               jnp.pad(jgeo.work_area(bi, ext), pad)], axis=0)
    ref = ps.evolve_chunk_fused_k_sc(
        ps.to_xpad_k_sc(jnp.asarray(pr), jnp.asarray(pi), ext, 2), b2k, order, g.dt, g.dn,
        cfg.mass, 5, 2, analytic=an, interpret=True,
    )
    out = hsp.evolve_chunk_sc(
        convert.pair(pr, pi), order, g.dt, g.dn, cfg.mass, 5, an,
        b2=None if an else _b2_port(br, bi, ext),
    )
    ref_pair = convert.pair(*(np.asarray(x) for x in ps.from_xpad_k_sc(ref, ext, 2)))
    allclose(out, ref_pair, 5e-5, 5e-6)


# --------------------------------------------------------------------------- #
# the wrappers' contract on the CPU
# --------------------------------------------------------------------------- #


def test_wrapper_takes_plain_version_on_cpu():
    """CPU tensors run the plain version and launch (count) nothing; the
    shell is written zero and the input is untouched."""
    cfg, ext, pr, pi, _f, analytic, scale = _setup("ThreePoint", n=(8, 8, 16), seed=6)
    psi = convert.pair(pr, pi)
    store = convert.pair(*_stores(cfg, 2, 7))
    coef = torch.tensor([0.9, 0.2, -0.1, 0.05, 0.02])
    before = dict(hs.LAUNCHES)
    assert hsp.num_partials(psi, "ThreePoint") == 1
    kw = dict(order="ThreePoint", scale=scale, analytic=analytic, store=store, apply_coef=True)
    out, ref = torch.empty_like(psi), torch.empty_like(psi)
    part, part_ref = (torch.empty(1, 5, dtype=torch.float64) for _ in range(2))
    hsp.sweep_step_sc(psi, out, coef, part, **kw)
    hsp.sweep_step_sc_plain(psi, ref, coef, part_ref, **kw)
    assert torch.equal(out, ref) and torch.equal(part, part_ref)
    assert hs.LAUNCHES == before
    assert float(out[:, 0].abs().max()) == 0.0 and float(out[:, :, :, -1].abs().max()) == 0.0
    assert torch.equal(psi, convert.pair(pr, pi))


def test_wrapper_rejects_other_devices_and_chunk_needs_b():
    psi = torch.empty(2, 6, 6, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hsp.sweep_step_sc(psi, torch.empty_like(psi), torch.ones(1, device="meta"), None,
                          order="ThreePoint", scale=0.1,
                          analytic=("Harmonic", 0.2, 0.004, 1.0, 4, 4, 4, 1.0, 0.0, 0.2))
    with pytest.raises(ValueError, match="analytic or b2"):
        hsp.evolve_chunk_sc(torch.zeros(2, 6, 6, 6), "ThreePoint", 0.004, 0.2, 1.0, 2)


def test_pair_conversion_layouts():
    """``convert.pair`` stacks fields to (2, …) and stacks of fields to
    (S, 2, …), the layouts of hopper_split."""
    rng = np.random.default_rng(9)
    re, im = rng.normal(size=(2, 3, 4, 5)), rng.normal(size=(2, 3, 4, 5))
    p = convert.pair(re, im)
    assert tuple(p.shape) == (2, 2, 3, 4, 5) and p.is_contiguous()
    assert np.array_equal(p[1, 0].numpy(), re[1]) and np.array_equal(p[1, 1].numpy(), im[1])
    z = re[0] + 1j * im[0]
    q = convert.pair(z.real, z.imag, dtype=torch.float32)
    assert tuple(q.shape) == (2, 3, 4, 5) and q.dtype == torch.float32
    assert torch.equal(tgeo.work_area(q, 1)[1], q[1, 1:-1, 1:-1, 1:-1])
