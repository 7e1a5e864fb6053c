"""The sharded solve of the port for complex ψ as (re, im) pairs
(``wafer_torch/parallel/sharded_split.py``) against ``wafer_tpu``'s
``ShardedSplitOps``.

As tests/test_torch_sharded.py: the port's meshes on ``devices=[cpu]*P``
with K3 and K2 through their plain versions; the reference on the eight
virtual CPU devices with its Pallas split kernels in interpret mode, on its
tests' own shapes (tests/test_sharding.py). Kernel level: the x-mesh pair
chunk (B8/B9 with x_origin, B12) at all three orders, ground and excited,
and the y/z-padded pair kernel (B15) in its ground, per-step-norm,
excited and streamed-B modes; rtol 3e-5, atol 3e-6, and the reference
tests' own rtol 5e-4, atol 2e-5 for excited chunks. Solve level: the
reference's sharded split driver (routed there as on a complex-free
backend) against the port's run_sharded, energies within 2e-4 in Re and
Im."""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_hostlayer import configs
from tests.test_torch_sharded import port_mesh
from wafer_torch import geometry as tgeo
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
from wafer_torch.parallel.sharded_split import ShardedSplitOps as TOps
from wafer_torch.parallel.solver_sharded import run_sharded as t_run_sharded
from wafer_tpu import geometry as jgeo
from wafer_tpu.io import run_dir
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import pallas_split as ps_mod, split_complex as jsc
from wafer_tpu.parallel import make_mesh as jmesh
from wafer_tpu.parallel.sharded_split import ShardedSplitOps as JOps
from wafer_tpu.parallel.solver_sharded import run_sharded as j_run_sharded

LOG = logging.getLogger("wafer")
TOL = dict(rtol=3e-5, atol=3e-6)
EXCITED = dict(rtol=5e-4, atol=2e-5)
_SPLIT_N = {"ThreePoint": 8, "FivePoint": 16, "SevenPoint": 24}  # x blocks ≥ ext on 4 shards


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side runs small blocks: one torch thread keeps the test
    workers, which share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(order, size, seed, su=3, n_lower=0, potential="ComplexHarmonic", **over):
    """Both configs (the reference tests' _split_setup), a unit-scale f32
    interior pair, the reference's interior (Ar, Ai, Br, Bi) and
    ``n_lower`` unit stored pairs."""
    jcfg, tcfg = configs(
        precision="f32", potential=potential, absorb=0.2, central_difference=order,
        grid={"size": size, "dn": 0.2, "dt": 0.004}, output={"screen_update": su}, **over,
    )
    rng = np.random.default_rng(seed)
    pair = rng.normal(size=(2, *jcfg.work_size())).astype(np.float32)
    store = None
    if n_lower:
        store = rng.normal(size=(n_lower, 2, *jcfg.work_size())).astype(np.float32)
        store /= np.sqrt((store.astype(np.float64) ** 2).sum(axis=(1, 2, 3, 4), keepdims=True))
        store = store.astype(np.float32)
    vr, vi = jpot.generate_split(jcfg)
    ab = jpot.build_ab_split(vr.astype(np.float32), vi.astype(np.float32), jcfg.grid.dt)
    ext = jcfg.central_difference.ext
    return jcfg, tcfg, pair, [np.asarray(jgeo.work_area(x, ext)) for x in ab], store


def _ref_chunk(ops, pair, ab, store=None, psn=False):
    fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk
    sr = si = None
    if store is not None:
        sr, si = store[:, 0], store[:, 1]
    out = fn(ops.put(pair[0]), ops.put(pair[1]), *(ops.put(x) for x in ab),
             ops.put_store(sr), ops.put_store(si))
    return np.stack([np.asarray(ops.get(o)) for o in out])


def _port_chunk(tcfg, mesh_shape, pair, ab, store=None, psn=False, streamed=False):
    ops = TOps(tcfg, port_mesh(mesh_shape), 0 if store is None else store.shape[0])
    if streamed:
        ops.analytic = None
    else:
        assert ops.analytic is not None and ops.analytic[0] in hsp.KINDS
    b2 = ops.put(torch.tensor(np.stack(ab[2:])), halo=False)
    fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk
    out = fn(ops.put(torch.from_numpy(pair)), None, b2,
             ops.put_store(None if store is None else torch.from_numpy(store)))
    return ops.get(out).numpy()


@pytest.mark.parametrize("order", ["ThreePoint", "FivePoint", "SevenPoint"])
@pytest.mark.parametrize("n_lower", [0, 1, 3])
def test_chunk_matches_x_mesh_pair_kernels(n_lower, order):
    """B12 (pair): the x-mesh split chunk on (4, 1, 1) — the resident pair
    windows for the ground state, the 1-step pair sweep with x_origin and
    the psum'd complex coefficients for S = 1 (the reference's
    test_sharded_split_pallas_matches_xla)."""
    jcfg, tcfg, pair, ab, store = _inputs(order, {"x": _SPLIT_N[order], "y": 8, "z": 128}, 51,
                                          n_lower=n_lower)
    ops = JOps(jcfg, jmesh((4, 1, 1)), n_lower, use_pallas=True, pallas_interpret=True)
    assert ops.pallas_mode == "x" and ops.sc_analytic is not None
    np.testing.assert_allclose(_port_chunk(tcfg, (4, 1, 1), pair, ab, store),
                               _ref_chunk(ops, pair, ab, store), **(EXCITED if n_lower else TOL))


@pytest.mark.parametrize("mesh_shape, order", [
    ((2, 2, 2), "ThreePoint"), ((4, 2, 1), "ThreePoint"), ((1, 2, 2), "ThreePoint"),
    ((2, 2, 2), "FivePoint"), ((2, 2, 2), "SevenPoint"),
])
def test_chunk_matches_yzp_pair_kernel(mesh_shape, order):
    """B15: the y/z-padded pair kernel with its (x, y, z) origin on
    multi-axis meshes, analytic complex B, ground."""
    jcfg, tcfg, pair, ab, _s = _inputs(order, {"x": 8, "y": 16, "z": 256}, 57)
    ops = JOps(jcfg, jmesh(mesh_shape), 0, use_pallas=True, pallas_interpret=True)
    assert ops.pallas_mode == "yzp" and ops.sc_analytic is not None
    np.testing.assert_allclose(_port_chunk(tcfg, mesh_shape, pair, ab),
                               _ref_chunk(ops, pair, ab), **TOL)


def test_chunk_matches_yzp_pair_excited_psn_and_streamed(monkeypatch):
    """B15's other modes on a (2, 2, 2) mesh: excited (stored pairs with
    exchanged halos, conjugated overlaps), per-step-norm ground, streamed
    (Br, Bi)."""
    jcfg, tcfg, pair, ab, store = _inputs("ThreePoint", {"x": 8, "y": 16, "z": 256}, 59,
                                          su=2, n_lower=1)
    mesh = jmesh((2, 2, 2))
    ops1 = JOps(jcfg, mesh, 1, use_pallas=True, pallas_interpret=True)
    assert ops1.pallas_mode == "yzp"
    np.testing.assert_allclose(_port_chunk(tcfg, (2, 2, 2), pair, ab, store),
                               _ref_chunk(ops1, pair, ab, store), **EXCITED)
    ops0 = JOps(jcfg, mesh, 0, use_pallas=True, pallas_interpret=True)
    np.testing.assert_allclose(_port_chunk(tcfg, (2, 2, 2), pair, ab, psn=True),
                               _ref_chunk(ops0, pair, ab, psn=True), **TOL)
    orig = ps_mod._pick_tx_sc_yzp

    def no_analytic(bx, byp, bzp, by, bz, ext_, itemsize, n_lower, analytic_b=False):
        if analytic_b:
            return None
        return orig(bx, byp, bzp, by, bz, ext_, itemsize, n_lower, analytic_b)

    monkeypatch.setattr(ps_mod, "_pick_tx_sc_yzp", no_analytic)
    ops_s = JOps(jcfg, mesh, 0, use_pallas=True, pallas_interpret=True)
    assert ops_s.pallas_mode == "yzp" and ops_s.sc_analytic is None
    np.testing.assert_allclose(_port_chunk(tcfg, (2, 2, 2), pair, ab, streamed=True),
                               _ref_chunk(ops_s, pair, ab), **TOL)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (8, 1, 1)])
def test_ground_pair_chunk_is_the_single_device_chunk_bitwise(mesh_shape):
    """A ground pair chunk on a mesh is the single-device K3 chunk bit for
    bit (ComplexCoulomb: the pole on the seam)."""
    jcfg, tcfg, pair, _ab, _s = _inputs("ThreePoint", {"x": 16, "y": 8, "z": 12}, 3, su=4,
                                        potential="ComplexCoulomb")
    an = hs.analytic_params(tcfg, 0.0)
    single = hsp.evolve_chunk_sc(F.pad(torch.from_numpy(pair), (1,) * 6), "ThreePoint", 0.004,
                                 0.2, 1.0, 4, an)
    zeros = [np.zeros(pair.shape[1:], np.float32)] * 4
    out = _port_chunk(tcfg, mesh_shape, pair, zeros)
    assert np.array_equal(out, tgeo.work_area(single, 1).numpy())


@pytest.mark.parametrize("n_lower, sub", [(0, "array"), (2, None)])
def test_measure_matches_reference(n_lower, sub):
    """The split measure (complex energy, conjugated Gram-Schmidt) on a
    (2, 2, 2) mesh against the reference's ``ShardedSplitOps.measure``."""
    potential = "ComplexFullCornell" if sub else "ComplexHarmonic"
    jcfg, tcfg, pair, _ab, store = _inputs("FivePoint", {"x": 8, "y": 12, "z": 16}, 23,
                                           n_lower=n_lower, potential=potential,
                                           mass=4.65, sig=0.223)
    ext = 2
    vr, vi = (jgeo.work_area(x, ext) for x in jpot.generate_split(jcfg))
    r2 = jgeo.r2_index_grid(jcfg.work_size(), jcfg.grid.size.as_tuple(), dtype=np.float32)
    psa = jpot.potential_sub_array(jcfg) if sub else None
    jops = JOps(jcfg, jmesh((2, 2, 2)), n_lower, has_pot_sub_array=bool(sub))
    tops = TOps(tcfg, port_mesh((2, 2, 2)), n_lower)
    sr = si = None
    if store is not None:
        sr, si = store[:, 0], store[:, 1]
    ref, (rr, ri) = jops.measure(jops.put(pair[0]), jops.put(pair[1]), jops.put(vr),
                                 jops.put(vi), jops.put(r2),
                                 jops.put(psa) if sub else jops.dummy_pot_sub(),
                                 jops.put_store(sr), jops.put_store(si))
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    out, out_pair = tops.measure(
        tops.put(t(pair)), tops.put(torch.stack([t(vr), t(vi)]), halo=False),
        tops.put(t(r2), halo=False), tops.put(t(psa), halo=False) if sub else None,
        tops.put_store(None if store is None else t(store)))
    for o, r in zip(out, ref):
        assert abs(float(o) - float(r)) <= 1e-6 * max(1.0, abs(float(r)))
    got = tops.get(out_pair).numpy()
    np.testing.assert_allclose(got[0], np.asarray(jops.get(rr)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], np.asarray(jops.get(ri)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("potential, mesh_shape", [
    ("ComplexHarmonic", (2, 2, 2)), ("ComplexFullCornell", (2, 2, 1)),
])
def test_solve_matches_reference_split_driver(tmp_run, monkeypatch, potential, mesh_shape):
    """Two states of ComplexHarmonic (Constant IC) and the ground state of
    ComplexFullCornell (streamed (Br, Bi), the per-cell V(∞) array in the
    measure), through the reference's sharded split driver and the port's
    run_sharded on the same mesh shape."""
    monkeypatch.setattr(jsc, "backend_supports_complex", lambda: False)
    over = dict(potential="ComplexHarmonic", init_condition="Constant", wavemax=1,
                grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02})
    if potential == "ComplexFullCornell":
        over = dict(potential=potential, mass=4.65, sig=0.223, init_condition="Constant",
                    grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.5, "dt": 0.05})
    jcfg, tcfg = configs(precision="f32", absorb=0.2, tolerance=1e-6, max_steps=100000,
                         output={"screen_update": 100, "file_type": "Json"},
                         mesh=dict(zip("xyz", mesh_shape)), **over)
    run_dir.check_output_dir(jcfg.project_name)
    ref = j_run_sharded(jcfg, LOG, mesh=jmesh(mesh_shape))
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    out = t_run_sharded(tcfg, LOG, mesh=port_mesh(mesh_shape))
    assert [o.wnum for o in out] == [r.wnum for r in ref]
    for r, o in zip(ref, out):
        e_r = r.observables.energy / r.observables.norm2
        e_o = o.observables.energy / o.observables.norm2
        assert abs(e_r - e_o) < 2e-4, (r.wnum, e_r, e_o)
        assert abs(r.steps - o.steps) <= 100
        assert o.phi.shape == (2, 18, 18, 18)
    if potential == "ComplexFullCornell":
        assert out[0].observables.v_infinity != 0.0
        assert abs(out[0].observables.v_infinity - ref[0].observables.v_infinity) < (
            1e-5 * abs(ref[0].observables.v_infinity))
