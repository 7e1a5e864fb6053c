"""The multi-slice mesh of the port (``wafer_torch/parallel/multislice.py``)
against ``wafer_tpu``'s, case by case as tests/test_multislice.py holds the
reference to its flat mesh.

The port runs 2 slices × (2, 2, 1) (and 2 × (1, 2, 2), 2 × (2, 1, 1) for
pairs) on ``devices=[cpu]*8``, its windowed chunk through the sweeps'
plain versions; the reference runs on the eight virtual CPU devices of
tests/conftest.py. f64 chunks agree with the reference's ``MultiSliceOps``
within 1e-10 of the largest value, and every chunk on the plain path is
the port's own flat mesh bit for bit (the blind window is exact, and a
window's partials are the flat block's). The split flat ring is held to
the reference's pinned pair-resident route (interpret mode) within that
test's own rtol 2e-5, atol 2e-6. Solves: energies within 2e-4 of the
reference's, and the port's multi-slice run is its flat run exactly. Also
the plain sweeps' reduction window and planes outside the grid, and the
multi-process entry (A10c)."""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_hostlayer import configs
from wafer_torch import errors as terrors, geometry as tgeo, solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
from wafer_torch.parallel import distributed as tdist, multislice as tms, solver_sharded
from wafer_torch.parallel.mesh import make_mesh as tmesh
from wafer_torch.parallel.sharded import ShardedOps as TOps
from wafer_torch.parallel.sharded_split import ShardedSplitOps as TSOps
from wafer_tpu import geometry as jgeo, solver as jsolver
from wafer_tpu.io import run_dir
from wafer_tpu.models import potentials as jpot
from wafer_tpu.parallel import make_mesh as jmesh
from wafer_tpu.parallel.multislice import MultiSliceOps as JMS, make_multislice_mesh as jms_mesh
from wafer_tpu.parallel.sharded_split import ShardedSplitOps as JSOps
from wafer_tpu.parallel.solver_sharded import run_sharded as j_run_sharded

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpus(shape, slices=1):
    return [CPU] * (slices * int(np.prod(shape)))


def _setup(order="ThreePoint", n=32, su=7, slice_update=2, shape=(2, 2, 1), **kw):
    """tests/test_multislice.py's ``_setup`` for both packages: f64, an
    n × 16 × 16 grid, ψ from a numpy seed, the reference's interior A, B."""
    jcfg, tcfg = configs(
        central_difference=order, grid={"size": {"x": n, "y": 16, "z": 16}, "dn": 0.2, "dt": 0.01},
        output={"screen_update": su},
        mesh={"x": shape[0], "y": shape[1], "z": shape[2], "slices": 2,
              "slice_update": slice_update},
        **kw,
    )
    ext = jcfg.central_difference.ext
    phi = np.random.default_rng(71).normal(size=jcfg.work_size())
    v = jpot.generate(jcfg)
    a, b = jpot.build_ab(v, jcfg.grid.dt)
    return jcfg, tcfg, phi, np.asarray(jgeo.work_area(a, ext)), np.asarray(jgeo.work_area(b, ext))


def _lower(jcfg, n_lower, seed=72):
    """``n_lower`` orthonormal stored states, as the solver keeps them (the
    port projects with every overlap of one sweep's output, the reference
    one state after another: the same for orthogonal states)."""
    if not n_lower:
        return None
    st = np.random.default_rng(seed).normal(size=(n_lower, int(np.prod(jcfg.work_size()))))
    q, _r = np.linalg.qr(st.T)
    return np.ascontiguousarray(q.T.reshape(n_lower, *jcfg.work_size()))


def _ref_chunk(jcfg, shape, phi, a, b, store=None, psn=False):
    ops = JMS(jcfg, jms_mesh(shape, 2), 0 if store is None else store.shape[0])
    fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk
    out = fn(ops.put(phi), ops.put(a), ops.put(b),
             ops.put_store(None if store is None else np.asarray(store)))
    return ops, np.asarray(ops.get(out))


def _port_chunk(tcfg, shape, phi, b, store=None, psn=False, flat=False):
    n_lower = 0 if store is None else store.shape[0]
    if flat:
        ops = TOps(tcfg, tmesh((2 * shape[0], *shape[1:]), _cpus(shape, 2)), n_lower)
    else:
        ops = tms.MultiSliceOps(tcfg, tms.make_multislice_mesh(shape, 2, _cpus(shape, 2)),
                                n_lower)
    fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk
    out = fn(ops.put(torch.tensor(phi)), None, ops.put(torch.tensor(b), halo=False),
             ops.put_store(None if store is None else torch.tensor(store)))
    return ops, ops.get(out).numpy()


def _close(out, ref, rel=1e-10):
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


# --------------------------------------------------------------------------- #
# the chunk against the reference's MultiSliceOps and the port's flat mesh
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("order", ["ThreePoint", "FivePoint", "SevenPoint"])
def test_evolve_matches_reference_and_flat_mesh(order):
    """2 × (2, 2, 1) with 2-step windows (pads 2·ext deep) at every order:
    within 1e-10 of the reference, the port's (4, 2, 1) chunk bit for bit."""
    jcfg, tcfg, phi, a, b = _setup(order=order, n=48 if order != "ThreePoint" else 32)
    jops, ref = _ref_chunk(jcfg, (2, 2, 1), phi, a, b)
    ops, out = _port_chunk(tcfg, (2, 2, 1), phi, b)
    assert ops.slice_steps == jops.slice_steps == 2 and ops.depth == 2 * ops.ext
    assert not ops.use_pallas  # f64: the plain sweep, B streamed deep
    _close(out, ref)
    assert np.array_equal(out, _port_chunk(tcfg, (2, 2, 1), phi, b, flat=True)[1])


@pytest.mark.parametrize("su, slice_update, steps", [(7, 3, 3), (9, 4, 4), (5, 16, 5)])
def test_remainder_and_deeper_window(su, slice_update, steps):
    """Windows of 3 with a remainder of 1, of 4 with a remainder of 1, and
    a slice_update past the block (8 planes) and the chunk, cut to the
    chunk's 5 steps: the reference's slice_steps, and exact."""
    jcfg, tcfg, phi, a, b = _setup(su=su, slice_update=slice_update)
    jops, ref = _ref_chunk(jcfg, (2, 2, 1), phi, a, b)
    ops, out = _port_chunk(tcfg, (2, 2, 1), phi, b)
    assert ops.slice_steps == jops.slice_steps == steps
    _close(out, ref)
    assert np.array_equal(out, _port_chunk(tcfg, (2, 2, 1), phi, b, flat=True)[1])


def test_measure_matches_reference():
    """The measure is the flat mesh's on the combined x ring: observables
    within 1e-12 relative of the reference's ``measure_local``, ψ too."""
    jcfg, tcfg, phi, a, b = _setup()
    ext = jcfg.central_difference.ext
    v = np.asarray(jgeo.work_area(jpot.generate(jcfg), ext))
    r2 = np.asarray(jgeo.r2_index_grid(jcfg.work_size(), jcfg.grid.size.as_tuple()))
    jops = JMS(jcfg, jms_mesh((2, 2, 1), 2), 0, pot_sub_scalar=2.5)
    ref, ref_phi = jops.measure(jops.put(phi), jops.put(v), jops.put(r2), jops.dummy_pot_sub(),
                                jops.put_store(None))
    ops = tms.MultiSliceOps(tcfg, tms.make_multislice_mesh((2, 2, 1), 2, _cpus((2, 2, 1), 2)), 0,
                            pot_sub_scalar=2.5)
    t = torch.tensor
    out, out_phi = ops.measure(ops.put(t(phi)), ops.put(t(v), halo=False),
                               ops.put(t(r2), halo=False), ops.dummy_pot_sub(),
                               ops.put_store(None))
    for o, r in zip(out, ref):
        assert abs(float(o) - float(r)) <= 1e-12 * max(1.0, abs(float(r)))
    _close(ops.get(out_phi).numpy(), np.asarray(jops.get(ref_phi)), 1e-12)


@pytest.mark.parametrize("n_lower, psn", [(0, True), (1, False), (2, False)],
                         ids=["per_step_norm", "S1", "S2"])
def test_reducing_chunk_matches_reference(n_lower, psn):
    """Per-step normalisation and Gram-Schmidt inside the blind windows:
    global coefficients from the true interiors' partials (the reduction
    window), the correction applied to the pads too. Within 1e-10 of the
    reference, the port's flat chunk bit for bit, and the result
    orthogonal to the stored states."""
    jcfg, tcfg, phi, a, b = _setup(su=4, slice_update=2)
    store = _lower(jcfg, n_lower)
    _j, ref = _ref_chunk(jcfg, (2, 2, 1), phi, a, b, store, psn)
    _o, out = _port_chunk(tcfg, (2, 2, 1), phi, b, store, psn)
    _close(out, ref)
    assert np.array_equal(out, _port_chunk(tcfg, (2, 2, 1), phi, b, store, psn, flat=True)[1])
    for s in range(n_lower):
        assert abs(float(np.sum(store[s] * out))) < 1e-9 * float(np.sqrt(np.sum(out * out)))


def test_yz_slice_factor():
    """2 × (1, 2, 2): x sharded by the slices alone, y and z by the mesh;
    against the reference and the port's (2, 2, 2) chunk."""
    jcfg, tcfg, phi, a, b = _setup(shape=(1, 2, 2))
    _j, ref = _ref_chunk(jcfg, (1, 2, 2), phi, a, b)
    _o, out = _port_chunk(tcfg, (1, 2, 2), phi, b)
    _close(out, ref)
    assert np.array_equal(out, _port_chunk(tcfg, (1, 2, 2), phi, b, flat=True)[1])


@pytest.mark.parametrize("potential", ["Harmonic", "Coulomb", "Periodic"])
def test_kernel_path_ground_chunk_is_the_flat_chunk(potential):
    """f32 with the kernel wrappers (plain versions on the CPU): B from
    coordinates at each deep block's origin, negative at the global low
    face, and the planes outside the grid written zero; a ground chunk with
    two windows and a remainder is the flat mesh's bit for bit."""
    _j, tcfg, phi, _a, b = _setup(su=5, slice_update=2, precision="f32", potential=potential)
    phi, b = phi.astype(np.float32), b.astype(np.float32)
    ops, out = _port_chunk(tcfg, (2, 2, 1), phi, b)
    assert ops.use_pallas and ops.analytic is not None
    assert np.array_equal(out, _port_chunk(tcfg, (2, 2, 1), phi, b, flat=True)[1])


def test_errors_match_reference():
    """Too few devices, an indivisible axis and a block narrower than the
    stencil halo raise the reference's messages."""
    with pytest.raises(ValueError) as ref:
        jms_mesh((2, 2, 1), 2, devices=[jmesh((1, 1, 1)).devices.flat[0]] * 3)
    with pytest.raises(ValueError) as out:
        tms.make_multislice_mesh((2, 2, 1), 2, [CPU] * 3)
    assert (str(out.value) == str(ref.value)
            == "multi-slice mesh 2x(2, 2, 1) needs 8 devices, have 3")
    mesh = tms.make_multislice_mesh((2, 2, 1), 2, _cpus((2, 2, 1), 2))
    assert mesh.shape == (4, 2, 1) and mesh.slices == 2 and "slices=2" in repr(mesh)
    for over, text in (
        (dict(grid={"size": {"x": 30, "y": 16, "z": 16}, "dn": 0.2, "dt": 0.01}),
         "grid axis x=30 not divisible by its mesh factor 4"),
        (dict(grid={"size": {"x": 8, "y": 16, "z": 16}, "dn": 0.2, "dt": 0.01},
              central_difference="SevenPoint"),
         "block of 2 cells along x is narrower than the stencil halo (3); use a coarser "
         "mesh or a bigger grid"),
    ):
        jcfg, tcfg = configs(**over)
        with pytest.raises(ValueError) as ref:
            JMS(jcfg, jms_mesh((2, 2, 1), 2), 0)
        with pytest.raises(ValueError) as out:
            tms.MultiSliceOps(tcfg, mesh, 0)
        assert str(out.value) == str(ref.value) == text


# --------------------------------------------------------------------------- #
# pairs: the split flat ring
# --------------------------------------------------------------------------- #


def _split_inputs():
    """The reference's test_multislice_split_flat_ring_pinned_window setup."""
    jcfg, tcfg = configs(
        precision="f32", potential="ComplexHarmonic", absorb=0.2,
        grid={"size": {"x": 32, "y": 8, "z": 128}, "dn": 0.2, "dt": 0.004},
        output={"screen_update": 9}, mesh={"x": 2, "y": 1, "z": 1, "slices": 2, "slice_update": 4},
    )
    ext = jcfg.central_difference.ext
    rng = np.random.default_rng(73)
    pr, pi = (rng.normal(size=jcfg.work_size()).astype(np.float32) for _ in range(2))
    vr, vi = jpot.generate_split(jcfg)
    ab = [np.asarray(jgeo.work_area(x, ext)) for x in jpot.build_ab_split(
        vr.astype(np.float32), vi.astype(np.float32), jcfg.grid.dt)]
    return jcfg, tcfg, pr, pi, ab


def test_split_flat_ring_matches_pinned_window():
    """2 × (2, 1, 1) pairs: the port's windowed K3 chunk (R = 4, two
    windows and a remainder of 1) against the reference's flat x ring with
    its pair-resident window pinned to slice_update (interpret mode), and
    bit for bit against the port's (4, 1, 1) pair chunk."""
    jcfg, tcfg, pr, pi, ab = _split_inputs()
    hier = jms_mesh((2, 1, 1), 2)
    jops = JSOps(jcfg, jmesh((4, 1, 1), devices=list(hier.devices.flatten())), 0,
                 use_pallas=True, pallas_interpret=True, res_steps=4)
    assert jops.sc_res_steps == 4
    rr, ri = jops.evolve_chunk(jops.put(pr), jops.put(pi), *(jops.put(x) for x in ab),
                               jops.put_store(None), jops.put_store(None))
    ref = np.stack([np.asarray(jops.get(rr)), np.asarray(jops.get(ri))])
    pair = torch.from_numpy(np.stack([pr, pi]))
    outs = []
    for ops in (tms.MultiSliceSplitOps(tcfg, tms.make_multislice_mesh((2, 1, 1), 2, [CPU] * 4),
                                       0),
                TSOps(tcfg, tmesh((4, 1, 1), [CPU] * 4), 0)):
        assert ops.use_pallas and ops.analytic is not None
        outs.append(ops.get(ops.evolve_chunk(ops.put(pair), None, None, None)).numpy())
    assert tms.MultiSliceSplitOps(tcfg, tms.make_multislice_mesh((2, 1, 1), 2, [CPU] * 4),
                                  0).slice_steps == 4
    np.testing.assert_allclose(outs[0], ref, rtol=2e-5, atol=2e-6)
    assert np.array_equal(outs[0], outs[1])


def test_split_streamed_excited_is_the_flat_chunk():
    """Pairs with a streamed (Br, Bi) padded deep and one stored pair
    (conjugated overlaps, complex coefficients on the pads): the port's
    (4, 1, 1) pair chunk bit for bit."""
    _j, tcfg, pr, pi, ab = _split_inputs()
    rng = np.random.default_rng(74)
    low = rng.normal(size=(1, 2, *tcfg.work_size())).astype(np.float32)
    low /= np.sqrt((low.astype(np.float64) ** 2).sum())
    b2 = torch.from_numpy(np.stack(ab[2:]))
    pair = torch.from_numpy(np.stack([pr, pi]))
    outs = []
    for ops in (tms.MultiSliceSplitOps(tcfg, tms.make_multislice_mesh((2, 1, 1), 2, [CPU] * 4),
                                       1),
                TSOps(tcfg, tmesh((4, 1, 1), [CPU] * 4), 1)):
        ops.analytic = None
        outs.append(ops.get(ops.evolve_chunk(ops.put(pair), None, ops.put(b2, halo=False),
                                             ops.put_store(torch.from_numpy(low)))).numpy())
    assert np.array_equal(outs[0], outs[1])
    ov_re = float(np.sum(low[0, 0] * outs[0][0] + low[0, 1] * outs[0][1]))
    assert abs(ov_re) < 1e-5


# --------------------------------------------------------------------------- #
# the solve
# --------------------------------------------------------------------------- #


def _solve_cfg(**over):
    return dict(grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
                tolerance=1e-6, init_condition="Constant",
                output={"screen_update": 100, "file_type": "Json"}, max_steps=100000, **over)


def _energy(r):
    return r.observables.energy / r.observables.norm2


def test_run_sharded_end_to_end(tmp_run):
    """The reference's test_multislice_driver_end_to_end: 16³ Harmonic on
    2 × (2, 2, 1) through run_sharded, against its run, the oracle, and the
    port's own flat (4, 2, 1) run, which it equals exactly."""
    jcfg, tcfg = configs(**_solve_cfg(mesh={"x": 2, "y": 2, "z": 1, "slices": 2}))
    run_dir.check_output_dir(jcfg.project_name)
    (ref,) = j_run_sharded(jcfg)
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    (out,) = solver_sharded.run_sharded(
        tcfg, LOG, mesh=tms.make_multislice_mesh((2, 2, 1), 2, _cpus((2, 2, 1), 2)))
    (flat,) = solver_sharded.run_sharded(tcfg, LOG, mesh=tmesh((4, 2, 1), _cpus((2, 2, 1), 2)))
    assert abs(_energy(out) - 1.5) < 0.02 and abs(_energy(out) - _energy(ref)) < 2e-4
    assert abs(out.steps - ref.steps) <= 100
    assert (_energy(out), out.steps) == (_energy(flat), flat.steps)
    assert torch.equal(out.phi, flat.phi)


def test_split_driver_end_to_end(tmp_run, monkeypatch):
    """The reference's test_multislice_split_driver_end_to_end: 16³
    ComplexHarmonic on 2 × (2, 1, 1), against its split driver (routed
    there as on a complex-free backend) and the complex oracle; a y/z
    sharded slice factorisation is the reference's ConfigParseError."""
    from wafer_tpu import errors as jerrors
    from wafer_tpu.ops import split_complex as jsc
    from wafer_tpu.parallel.sharded_split import run_sharded_split

    monkeypatch.setattr(jsc, "backend_supports_complex", lambda: False)
    over = dict(potential="ComplexHarmonic", absorb=0.2)
    jcfg, tcfg = configs(**_solve_cfg(mesh={"x": 2, "y": 1, "z": 1, "slices": 2,
                                            "slice_update": 4}, **over))
    run_dir.check_output_dir("test")
    (ref,) = run_sharded_split(jcfg)
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    (out,) = solver_sharded.run_sharded(
        tcfg, LOG, mesh=tms.make_multislice_mesh((2, 1, 1), 2, [CPU] * 4))
    assert abs(_energy(out) - 1.5 * (1 + 0.2j) ** 0.5) < 0.05
    assert abs(_energy(out) - _energy(ref)) < 2e-4
    jbad, tbad = configs(**_solve_cfg(mesh={"x": 1, "y": 2, "z": 1, "slices": 2}, **over))
    with pytest.raises(jerrors.ConfigParseError) as jexc:
        run_sharded_split(jbad)
    with pytest.raises(terrors.ConfigParseError) as texc:
        solver_sharded.run_sharded(tbad, LOG,
                                   mesh=tms.make_multislice_mesh((1, 2, 1), 2, [CPU] * 4))
    assert str(texc.value) == str(jexc.value)


def test_multigrid_final_level_on_a_multislice_mesh(tmp_run, monkeypatch):
    """Multigrid [2]: the coarse level on one device, the final level
    through run_sharded on 2 × (2, 1, 1); energies within 2e-4 of the
    reference's multigrid run on its multi-slice mesh."""
    calls = []
    orig = solver_sharded.run_sharded
    monkeypatch.setattr(solver_sharded, "run_sharded",
                        lambda cfg, *a, **k: calls.append(k["mesh"].slices) or orig(cfg, *a, **k))
    jcfg, tcfg = configs(**_solve_cfg(precision="f32", multigrid=[2],
                                      mesh={"x": 2, "y": 1, "z": 1, "slices": 2}))
    run_dir.check_output_dir(jcfg.project_name)
    (ref,) = jsolver.run(jcfg)
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    (out,) = tsolver.run(tcfg, mesh=tms.make_multislice_mesh((2, 1, 1), 2, [CPU] * 4))
    assert calls == [2]
    assert abs(_energy(out) - _energy(ref)) < 2e-4 and abs(_energy(out) - 1.5) < 0.02


def test_default_mesh_needs_a_device_per_shard(tmp_run):
    """Without a mesh, ``solver.run`` builds the multi-slice mesh over the
    devices it has: on the CPU (one device) the reference's error."""
    tcfg = configs(**_solve_cfg(mesh={"x": 2, "y": 1, "z": 1, "slices": 2}))[1]
    with pytest.raises(ValueError,
                       match=r"multi-slice mesh 2x\(2, 1, 1\) needs 4 devices, have 1"):
        tsolver.run(tcfg, device=CPU)


# --------------------------------------------------------------------------- #
# the plain sweeps' window and planes outside the grid
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("where", ["below", "past"])
@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("order", ["ThreePoint", "FivePoint", "SevenPoint"])
def test_plain_sweep_window_matches_the_cropped_sweep(order, pair, where):
    """A deep block of 14 planes reaching 3 planes below (or past) a
    12-plane grid: its planes inside the grid are the whole grid's sweep
    there bit for bit, the planes outside are zero, and its partials over
    the window (3, 11) are the whole grid's sums over those planes."""
    ext = tgeo.EXT[order]
    n, nd = (12, 9, 10), 14
    ox = -3 if where == "below" else n[0] - nd + 3
    rng = np.random.default_rng(81)
    lead = (2,) if pair else ()
    glob = torch.from_numpy(rng.normal(size=(*lead, *n)))
    low = torch.from_numpy(rng.normal(size=(1, *lead, *n)))
    big = F.pad(glob, (ext, ext, ext, ext, ext + 8, ext + 8))  # zeros far past the x faces
    big_low = F.pad(low, (ext, ext, ext, ext, ext + 8, ext + 8))
    win = slice(8 + ox, 8 + ox + nd + 2 * ext)
    block, block_low = big[..., win, :, :].contiguous(), big_low[..., win, :, :].contiguous()
    whole, whole_low = F.pad(glob, (ext,) * 6), F.pad(low, (ext,) * 6)
    n_red = 1 + (2 if pair else 1)
    coef = torch.tensor([0.9, 0.05, -0.02][:n_red], dtype=torch.float64)
    if pair:
        analytic = ("Coulomb", 0.2, 0.004, 1.0, *n, 1.0, 0.0, 0.2)
        sweep = hsp.sweep_step_sc_plain
    else:
        analytic = ("Coulomb", 0.2, 0.004, 1.0, *n, 1.0, 0.0)
        sweep = hs.sweep_step_plain
    kw = dict(order=order, scale=0.05, analytic=analytic, apply_coef=True)
    out, ref = torch.empty_like(block), torch.empty_like(whole)
    part, part_ref = (torch.empty(1, n_red, dtype=torch.float64) for _ in range(2))
    red = (3, 11)
    sweep(block, out, coef, part, store=block_low, origin=(ox, 0, 0), grid=n, red=red, **kw)
    sweep(whole, ref, coef, part_ref, store=whole_low, **kw)
    g0, g1 = max(0, -ox), min(nd, n[0] - ox)
    inside = tgeo.work_area(out, ext).narrow(-3, g0, g1 - g0)
    assert torch.equal(inside, tgeo.work_area(ref, ext).narrow(-3, g0 + ox, g1 - g0))
    interior = tgeo.work_area(out, ext)
    assert float(interior.narrow(-3, 0, g0).abs().sum()) == 0.0
    assert float(interior.narrow(-3, g1, nd - g1).abs().sum()) == 0.0
    r0, r1 = max(red[0], g0), min(red[1], g1)
    planes = tgeo.work_area(ref, ext).narrow(-3, r0 + ox, r1 - r0)
    lows = tgeo.work_area(whole_low[0], ext).narrow(-3, r0 + ox, r1 - r0)
    want = [float((planes * planes).sum())]
    if pair:
        want += [float((lows[0] * planes[0] + lows[1] * planes[1]).sum()),
                 float((lows[0] * planes[1] - lows[1] * planes[0]).sum())]
    else:
        want += [float((lows * planes).sum())]
    np.testing.assert_allclose(part[0].numpy(), want, rtol=1e-12, atol=1e-12)


def test_plain_sweep_default_window_is_unchanged():
    """Without a window and grid the plain sweep sums every plane and
    zeroes none; the y/z extent must lie inside the grid."""
    rng = np.random.default_rng(83)
    psi = F.pad(torch.from_numpy(rng.normal(size=(6, 7, 8))), (1,) * 6)
    an = ("Harmonic", 0.2, 0.004, 1.0, 6, 7, 8)
    coef = torch.ones(1, dtype=torch.float64)
    out, part = torch.empty_like(psi), torch.empty(1, 1, dtype=torch.float64)
    hs.sweep_step_plain(psi, out, coef, part, order="ThreePoint", scale=0.05, analytic=an)
    out2, part2 = torch.empty_like(psi), torch.empty(1, 1, dtype=torch.float64)
    hs.sweep_step_plain(psi, out2, coef, part2, order="ThreePoint", scale=0.05, analytic=an,
                        grid=(6, 7, 8), red=(0, 6))
    assert torch.equal(out, out2) and torch.equal(part, part2)
    assert float(part[0, 0]) == pytest.approx(float((tgeo.work_area(out, 1) ** 2).sum()))
    with pytest.raises(ValueError, match="along y and z"):
        hs.check_origin((6, 7, 8), (6, 7, 8), (0, 1, 0))
    with pytest.raises(ValueError, match="reduction window"):
        hs.check_origin((6, 7, 8), (6, 7, 8), (-2, 0, 0), red=(4, 7))
    with pytest.raises(ValueError, match="is not the analytic grid size"):
        hs.sweep_step_plain(psi, out2, coef, None, order="ThreePoint", scale=0.05, analytic=an,
                            grid=(7, 7, 8))


# --------------------------------------------------------------------------- #
# the multi-process entry (A10c)
# --------------------------------------------------------------------------- #


def test_distributed_is_a_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("WAFER_COORDINATOR", raising=False)
    assert tdist.maybe_initialize_distributed() is False


def test_slice_a_process_crosses_only_in_x(monkeypatch):
    """2 × (2, 2, 1) over two processes (the start patched; process 1):
    process 1 holds slice 1, the ranks 4 to 7; its window's x plan sends
    and receives the faces of the slice seam only, and its per-step y/z
    plan stays local copies."""
    from tests.test_torch_distributed import fake_start

    fake_start(monkeypatch)
    tdist.maybe_initialize_distributed()
    tcfg = configs(**_solve_cfg(precision="f32",
                                mesh={"x": 2, "y": 2, "z": 1, "slices": 2}))[1]
    mesh = tms.make_multislice_mesh((2, 2, 1), 2, _cpus((2, 2, 1), 2))
    assert list(mesh.local) == [4, 5, 6, 7] and mesh.owner(3) == 0
    ops = tms.MultiSliceOps(tcfg, mesh, 0)
    shape = (4 + 2 * ops.depth + 2, 10, 18)
    deep = [torch.zeros(shape) for _ in mesh.local]
    x_plan, yz_plan = ops._x_copies(deep), ops._exchange_yz(deep, False)
    (x,) = x_plan.stages
    # the seam: ranks 4, 5 (x index 2) take their low pads from ranks 2, 3
    # (x index 1) and give them their low faces
    assert [p for p, *_ in x.sends] == [0, 0] and [p for p, *_ in x.recvs] == [0, 0]
    assert len(x.copies) == 4 and x_plan.crosses and not yz_plan.crosses


def test_launch_geometry_checks_once_per_geometry():
    """The C arguments of a K1/K3 launch: a deep block's global extents,
    origin and window, the analytic tuple parsed; checked on the first
    launch of a geometry and looked up after it."""
    an = ("Coulomb", 0.2, 0.004, 1.0, 12, 9, 10, 1.5, 0.25)
    hs.launch_geometry.cache_clear()
    args = hs.launch_geometry(an, (12, 9, 10), (14, 9, 10), (-3, 0, 0), (3, 11))
    assert args == (hs.KINDS["Coulomb"], 0.2, 0.004, 1.0, 1.5, 0.25, 0.0, 12, 9, 10, -3, 0, 0,
                    3, 11)
    assert hs.launch_geometry(an, (12, 9, 10), (14, 9, 10), (-3, 0, 0), (3, 11)) == args
    assert hs.launch_geometry.cache_info().hits == 1
    streamed = hs.launch_geometry(None, None, (4, 9, 10), (4, 0, 0), None)
    assert streamed == (-1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 8, 9, 10, 4, 0, 0, 0, 4)
    pair = hs.launch_geometry(an[:7] + (1.0, 0.0, 0.2), None, (12, 9, 10), (0, 0, 0), None,
                              hsp.KINDS, "complex analytic potential")
    assert pair[6] == 0.2
    for bad, match in (((an, None, (12, 9, 10), (0, 1, 0), None), "along y and z"),
                       ((an, None, (12, 9, 10), (0, 0, 0), (5, 13)), "reduction window"),
                       ((("Periodic",) + an[1:], None, (12, 9, 10), (0, 0, 0), None, hsp.KINDS,
                         "complex analytic potential"), "unsupported complex analytic")):
        with pytest.raises(ValueError, match=match):
            hs.launch_geometry(*bad)
