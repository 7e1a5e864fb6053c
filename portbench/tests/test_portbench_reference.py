"""The plain reference against closed forms, its potentials against the
port's and against digests of their earlier bytes, the bytes model against
PERF.md's bounds, and the trace reduction on synthetic events."""

import hashlib
import math

import numpy as np
import pytest
import torch

from portbench import bytes as bytes_model
from portbench import spec, trace
from portbench.reference import hamiltonian, potentials, spectrum

CPU = torch.device("cpu")


def harmonic(n=12, dn=0.3, mass=1.0):
    return {"grid": {"size": {"x": n, "y": n, "z": n}, "dn": dn, "dt": 0.01}, "mass": mass,
            "sig": 1.0, "potential": "Harmonic"}


def test_discrete_levels_approach_the_oscillator():
    levels = spectrum.harmonic_levels(harmonic(n=96, dn=0.12), 7)
    assert levels[0] == pytest.approx(1.5, abs=5e-3)
    assert levels[1:4] == pytest.approx([2.5] * 3, abs=5e-3)
    assert levels[4:7] == pytest.approx([3.5] * 3, abs=1e-2)
    assert spectrum.harmonic_levels({**harmonic(), "potential": "Coulomb"}, 3) is None


def test_a_product_of_axis_eigenvectors_is_an_eigenstate_of_the_reference_h():
    raw = harmonic(n=10, dn=0.4)
    n, dn = 10, 0.4
    x = dn * (np.arange(n) + 1.0 - (n + 1.0) / 2.0)
    off = -1.0 / (2.0 * dn * dn)
    h = np.diag(-2.0 * off + x * x / 2.0) + np.diag(np.full(n - 1, off), 1) + np.diag(np.full(n - 1, off), -1)
    e, u = np.linalg.eigh(h)
    psi = torch.tensor(np.einsum("i,j,k->ijk", u[:, 0], u[:, 0], u[:, 1]))
    v = potentials.potential(raw, CPU)
    out = hamiltonian.judge_state(psi, v, 0.0, potentials.r2_index((n,) * 3, CPU), dn, 1.0)
    assert out["energy"] == pytest.approx(2 * e[0] + e[1], rel=1e-12)
    assert out["residual"] < 1e-10
    levels = spectrum.harmonic_levels(raw, 4)
    assert levels[0] == pytest.approx(3 * e[0]) and levels[1] == pytest.approx(2 * e[0] + e[1])
    other = torch.tensor(np.einsum("i,j,k->ijk", u[:, 0], u[:, 1], u[:, 0]))
    assert hamiltonian.largest_overlap([psi, other]) < 1e-12
    assert hamiltonian.largest_overlap([psi, 2.0 * psi]) == pytest.approx(1.0)


def test_complex_energy_of_an_eigenstate_scales_with_the_absorption():
    raw = {**harmonic(n=10, dn=0.4), "potential": "ComplexHarmonic", "absorb": 0.2}
    v = potentials.potential(raw, CPU)
    assert v.dtype == torch.complex128
    assert torch.allclose(v.imag, 0.2 * v.real)


def small_raw(kind, size=(9, 10, 12), dn=0.1, cornell=None):
    """The complex Cornell configuration at a small size, with potential
    ``kind``."""
    raw = spec.run_raw(spec.configuration("complex_cornell_256"), {"wavemax": 0})
    raw["grid"] = {"size": dict(zip("xyz", size)), "dn": dn, "dt": 0.003}
    raw["potential"] = kind
    if cornell is not None:
        raw["cornell"] = cornell
    return raw


@pytest.mark.parametrize("kind", ["Harmonic", "FullCornell", "ComplexFullCornell", "Coulomb",
                                  "ComplexCoulomb"])
def test_reference_potentials_match_the_ports_at_a_small_size(kind, tmp_path):
    from wafer_torch.models import potentials as port_potentials

    cornell = {"t": 1.3, "xi": 0.4, "nf": 2.0, "tc": 0.2} if kind == "FullCornell" else None
    raw = small_raw(kind, cornell=cornell)
    config = spec.port_config(raw, tmp_path)
    ours = potentials.potential(raw, CPU)
    theirs = port_potentials.generate(config)[1:-1, 1:-1, 1:-1]
    theirs = theirs.to(torch.complex128 if theirs.is_complex() else torch.float64)
    torch.testing.assert_close(ours, theirs, rtol=2e-6, atol=1e-6)
    if kind.endswith("FullCornell"):
        real = port_potentials.real_counterpart(config) if kind.startswith("Complex") else config
        sub = port_potentials.potential_sub_array(real)
        torch.testing.assert_close(potentials.potential_sub(raw, CPU), sub.to(torch.float64),
                                   rtol=2e-6, atol=1e-6)
    else:
        assert potentials.potential_sub(raw, CPU) == port_potentials.potential_sub_scalar(config) == 0.0
    from wafer_torch import geometry

    torch.testing.assert_close(potentials.r2_index((9, 10, 12), CPU),
                               geometry.r2_index_grid((9, 10, 12), (9, 10, 12)))


def test_a_kind_with_no_file_is_refused_by_name():
    raw = small_raw("Dodecahedron")
    for fn in (potentials.potential, potentials.potential_sub):
        with pytest.raises(ValueError, match=r"'Dodecahedron'.*Dodecahedron\.py in .*kinds"):
            fn(raw, CPU)
    with pytest.raises(ValueError, match=r"'\.\./spec'"):
        potentials.potential(small_raw("../spec"), CPU)


def digest(x) -> str:
    t = x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)
    return hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode() + t.contiguous().numpy().tobytes()).hexdigest()


# SHA-256 of (dtype, shape, bytes) of V and V(∞) as the reference gave them
# before its kinds moved into files of their own: every operation stays in
# its order, so every cell's checks read as before.
GRIDS = {"odd": ((9, 10, 12), 0.1, {"t": 1.3, "xi": 0.4, "nf": 2.0, "tc": 0.2}),
         "even": ((8, 8, 6), 0.25, None)}
DIGESTS = {
    ("odd", "Harmonic"): ("b8b4d637c4bda4118c354b6dadf2d3c09c51196b08dc0a59ac8fcf6bfa92ae14",
                          "644376052eb72140017f1dcd2292d6945368905ecf08c856768ddcf0efd4112d"),
    ("odd", "FullCornell"): ("be64f263edb7d6b5bb10da69d5c8dbe083d49ab041e56b087ab155f3e526e978",
                             "923c628c03a4eb3db82d9e243fdf60305a133029726ae8a1a3d01a05a8d97661"),
    ("odd", "ComplexFullCornell"): ("d73fce7bf192370b0d22a6e094c0392d858624bbb45bc5d968dff5d3d0675d7b",
                                    "923c628c03a4eb3db82d9e243fdf60305a133029726ae8a1a3d01a05a8d97661"),
    ("even", "Harmonic"): ("48f630f80f479a7602b402efc19bd258bb22a937b07d86d8703cc697f7f9d439",
                           "644376052eb72140017f1dcd2292d6945368905ecf08c856768ddcf0efd4112d"),
    ("even", "FullCornell"): ("0d3fca0f7c1d7df3518605528330ba79fb8588d772900b7a7fbe3b8d8a77bcea",
                              "eff95cc30b7916124e9d7014d779e9fcda8ca1ac08d0aecf3452216da5ed5e2c"),
    ("even", "ComplexFullCornell"): ("8e90366afef1f0c7b299e2ca4275b5f809d4a5b16bc707f502fb1679150d3dc8",
                                     "eff95cc30b7916124e9d7014d779e9fcda8ca1ac08d0aecf3452216da5ed5e2c"),
}


@pytest.mark.parametrize("grid, kind", sorted(DIGESTS))
def test_the_cells_potentials_keep_their_bytes(grid, kind):
    size, dn, cornell = GRIDS[grid]
    raw = small_raw(kind, size, dn, cornell)
    assert (digest(potentials.potential(raw, CPU)),
            digest(potentials.potential_sub(raw, CPU))) == DIGESTS[grid, kind]


@pytest.mark.parametrize("args, ms", [
    (dict(n_store=0), 0.0410), (dict(n_store=1), 0.0615), (dict(n_store=1, stream_bytes=2), 0.0513),
    (dict(n_store=3, stream_bytes=2), 0.0718), (dict(n_store=5, stream_bytes=2), 0.0923),
    (dict(n_store=5), 0.1435), (dict(streamed=True, pair=True), 0.1221), (dict(pair=True), 0.0820),
])
def test_bytes_model_gives_perf_md_bounds_at_256(args, ms):
    assert bytes_model.step_bound_ms((256,) * 3, **args) == pytest.approx(ms, abs=6e-5)


def test_bytes_model_gives_perf_md_bounds_at_512():
    assert bytes_model.step_bound_ms((512,) * 3) == pytest.approx(0.3243, abs=1e-4)
    assert bytes_model.step_bound_ms((512,) * 3, streamed=True) == pytest.approx(0.4846, abs=1e-4)


@pytest.mark.parametrize("name, state, want", [
    ("void (anonymous namespace)::sweep_step_kernel<1, 0, false, 1>(SweepArgs)", 3, (1, 0, 4, False)),
    ("void (anonymous namespace)::sweep_step_bf16_kernel<1, 2, false>(SweepArgs)", 2, (1, 2, 2, False)),
    ("void (anonymous namespace)::sweep_step_bf16_many_costly_kernel<1, 4, true>(SweepArgs)", 4, (1, 4, 2, False)),
    ("void (anonymous namespace)::sweep_step_bf16_wide_kernel<1, false, false>(SweepArgs, int)", 5, (1, 5, 2, False)),
    ("void (anonymous namespace)::sweep_step_sc_kernel<1, 1, false>(SweepArgs)", 1, (1, 1, 4, True)),
    ("void (anonymous namespace)::sweep_step_sc_wide_kernel<1, false, true>(SweepArgs, int)", 3, (1, 3, 4, True)),
])
def test_launch_names_give_stored_states_and_store_type(name, state, want):
    assert bytes_model.sweep_launch(name, state)[1:] == want


def test_other_kernels_have_no_sweep_bound():
    assert bytes_model.sweep_launch("void finish_coef_kernel<256>(double const*)", 0) is None
    assert bytes_model.sweep_launch("Memcpy DtoH (Device -> Pinned)", 0) is None


def test_flops_never_bind_the_cells_launches():
    for n_store in range(6):
        for streamed, pair in ((False, False), (True, True), (False, True)):
            work = bytes_model.sweep_work((256,) * 3, 1, n_store, streamed, True, pair, 2)
            assert bytes_model.bound(work)[1] == "bytes"


def test_trace_reduction_attributes_states_and_labels_idle_gaps():
    ms = 1_000_000
    events = [
        ("span", "portbench.state.0", 0, 10 * ms), ("span", "wafer.measure", 4 * ms, 2 * ms),
        ("span", "portbench.state.1", 10 * ms, 10 * ms),
        ("device", "void sweep_step_wide_kernel<1, false, false>(SweepArgs, int)", 1 * ms, 3 * ms),
        ("device", "void sweep_step_wide_kernel<1, false, false>(SweepArgs, int)", 12 * ms, 2 * ms),
        ("device", "Memcpy DtoH (Device -> Pageable)", 13 * ms, 3 * ms),
    ]
    t = trace.reduce(events, window_s=0.02)
    assert [op[3] for op in t.device_ops] == [0, 1, 1]
    assert trace.busy_seconds(t) == pytest.approx(0.003 + 0.004)
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "sweep_step_wide_kernel<1, false, false>"
    assert b["device_ops"][0][1] == pytest.approx(0.005)
    assert b["idle_gaps"] == [["portbench.state", pytest.approx(0.008)]]
    assert trace.reduce([], 1.0).device_ops == []
    assert math.isclose(t.window_s, 0.02)
