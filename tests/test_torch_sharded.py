"""The sharded solve of the port (``wafer_torch/parallel``) against
``wafer_tpu``'s, for real ψ.

The port runs each mesh on ``devices=[cpu]*P``: every shard a block on the
CPU, K1 and K2 through their plain versions. The reference runs on the
eight virtual CPU devices of tests/conftest.py, its Pallas kernels in
interpret mode. Kernel level: the port's chunk against ``ShardedOps(
use_pallas=True, pallas_interpret=True)`` in each TPU mode it reaches, on
the reference tests' own shapes (tests/test_sharding.py) — the resident
x-mesh chunk and its in-kernel ICI variant (B12), the K-fused x-mesh
ground (B5 with x_origin), the 1-step x-mesh sweep with stored states (B2
with x_origin), the y/z-padded 1-step kernel (B13) and its resident and
x-blocked R-step windows (B14) — within rtol 3e-5, atol 3e-6; the
excited x-mesh chunk within the reference test's own rtol 5e-4, atol
2e-5. Solve level: ``run_sharded`` against the reference's on the same
initial state, energies within 2e-4, steps within one chunk."""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_hostlayer import configs
from wafer_torch import geometry as tgeo, solver as tsolver
from wafer_torch.errors import ConfigParseError
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.models import potentials as tpot
from wafer_torch.ops import hopper_stencil as hs
from wafer_torch.parallel import halo as thalo
from wafer_torch.parallel.mesh import make_mesh as tmesh
from wafer_torch.parallel.sharded import ShardedOps as TOps
from wafer_torch.parallel.solver_sharded import run_sharded as t_run_sharded
from wafer_tpu import geometry as jgeo, solver as jsolver
from wafer_tpu.io import formats, run_dir
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import pallas_stencil as pk
from wafer_tpu.parallel import make_mesh as jmesh
from wafer_tpu.parallel.sharded import ShardedOps as JOps
from wafer_tpu.parallel.solver_sharded import run_sharded as j_run_sharded

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")
TOL = dict(rtol=3e-5, atol=3e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side runs small blocks: one torch thread keeps the test
    workers, which share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_mesh(shape):
    return tmesh(shape, [CPU] * int(np.prod(shape)))


def _inputs(order, size, seed, dt=0.01, su=3, n_lower=0, precision="f32", **over):
    """Both packages' configs, a unit-scale f32 interior ψ, the reference's
    interior A and B, and ``n_lower`` unit stored states."""
    jcfg, tcfg = configs(
        precision=precision, central_difference=order,
        grid={"size": size, "dn": 0.2, "dt": dt}, output={"screen_update": su}, **over,
    )
    rng = np.random.default_rng(seed)
    phi = rng.normal(size=jcfg.work_size()).astype(np.float32)
    ext = jcfg.central_difference.ext
    a, b = jpot.build_ab(jpot.generate(jcfg), dt)
    store = None
    if n_lower:
        store = rng.normal(size=(n_lower, *jcfg.work_size())).astype(np.float32)
        store /= np.sqrt((store.astype(np.float64) ** 2).sum(axis=(1, 2, 3), keepdims=True))
        store = store.astype(np.float32)
    return jcfg, tcfg, phi, np.asarray(jgeo.work_area(a, ext)), np.asarray(jgeo.work_area(b, ext)), store


def _ref_chunk(ops, phi, a, b, store=None, psn=False):
    fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk
    out = fn(ops.put(phi), ops.put(a), ops.put(b),
             ops.put_store(None if store is None else np.asarray(store)))
    return np.asarray(ops.get(out))


def _port_chunk(tcfg, mesh_shape, phi, b, store=None, psn=False, streamed=False, **kw):
    n_lower = 0 if store is None else store.shape[0]
    ops = TOps(tcfg, port_mesh(mesh_shape), n_lower, **kw)
    if streamed:
        ops.analytic = None
    else:
        assert ops.analytic is not None  # B from coordinates at each shard's origin
    fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk
    out = fn(ops.put(torch.from_numpy(phi)), None,
             ops.put(torch.tensor(b, dtype=torch.float32), halo=False),
             ops.put_store(None if store is None else torch.from_numpy(store)))
    return ops.get(out).numpy()


# --------------------------------------------------------------------------- #
# halo exchange and placement
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh_shape, ext", [((2, 2, 2), 1), ((4, 2, 1), 2), ((1, 2, 2), 3)])
def test_halo_exchange_matches_zero_padding(mesh_shape, ext):
    """Exchanged blocks are the windows of the zero-padded global array,
    edges and corners included (tests/test_sharding.py's check), and a
    stack of fields is carried along its leading axes."""
    rng = np.random.default_rng(0)
    glob = torch.from_numpy(rng.normal(size=(2, 12, 12, 12)))
    mesh = port_mesh(mesh_shape)
    ops_like = [(shape, origin) for shape, origin in mesh.blocks((12, 12, 12))]
    blocks = []
    for shape, origin in ops_like:
        blk = torch.full((2, *(n + 2 * ext for n in shape)), 7.0, dtype=glob.dtype)
        # the interior, and garbage in the halo that the exchange must overwrite
        tgeo.work_area(blk, ext).copy_(
            glob[(...,) + tuple(slice(o, o + n) for o, n in zip(origin, shape))])
        blocks.append(blk)
    thalo.exchange_halos(blocks, ext, mesh)
    padded = F.pad(glob, (ext,) * 6)
    for blk, (shape, origin) in zip(blocks, ops_like):
        want = padded[(...,) + tuple(slice(o, o + n + 2 * ext) for o, n in zip(origin, shape))]
        assert torch.equal(blk, want)


def test_halo_narrower_than_ext_raises():
    mesh = port_mesh((4, 1, 1))
    blocks = [torch.zeros(2 + 6, 10, 10) for _ in range(4)]  # 2 cells, ext 3
    with pytest.raises(ValueError, match=r"narrower than the stencil halo \(3\)"):
        thalo.exchange_halos(blocks, 3, mesh)
    _j, tcfg = configs(central_difference="SevenPoint",
                       grid={"size": {"x": 8, "y": 8, "z": 8}, "dn": 0.2, "dt": 0.01})
    with pytest.raises(ValueError, match="narrower than the stencil halo"):
        TOps(tcfg, port_mesh((4, 1, 1)), 0)
    with pytest.raises(ValueError, match="does not divide evenly"):
        TOps(tcfg, port_mesh((3, 1, 1)), 0)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (1, 4, 2)])
def test_put_blocks_matches_reference(mesh_shape):
    """Per-shard blocks — V from ``generate(shape, offset)``, B, r² with
    an offset, FullCornell's potential_sub with shape/offset — gather to the
    reference's assembled arrays on a non-cubic grid (the reference's
    test_put_blocks_matches_put; V within rtol 1e-15, the rest bit for
    bit), V's blocks to the port's own global V bit for bit, and put/get
    round-trips."""
    over = dict(potential="FullCornell", mass=4.65, sig=0.223,
                grid={"size": {"x": 8, "y": 16, "z": 8}, "dn": 0.35, "dt": 0.02})
    jcfg, tcfg = configs(**over)
    ext = 1
    jops = JOps(jcfg, jmesh(mesh_shape), 0, has_pot_sub_array=True)
    tops = TOps(tcfg, port_mesh(mesh_shape), 0)

    def both(jbuild, tbuild, rtol=0.0):
        ref = np.asarray(jops.get(jops.put_blocks(jbuild, dtype=jcfg.real_dtype)))
        out = tops.get(tops.put_blocks(tbuild)).numpy()
        if rtol:
            np.testing.assert_allclose(out, ref, rtol=rtol, atol=0.0)
        else:
            np.testing.assert_array_equal(out, ref)
        return out

    # FullCornell's V goes through f64 exp(-md·r), whose last bit torch and
    # XLA can round one ulp apart depending on the host CPU (AVX-512 hosts
    # do): across the packages V holds to rtol 1e-15 (about 4.5 ulp); the
    # port's blocks hold to its own global V bit for bit below
    v = both(lambda s, o: jpot.generate(jcfg, s, tuple(x + ext for x in o)),
             lambda s, o: tpot.generate(tcfg, s, tuple(x + ext for x in o)), rtol=1e-15)
    np.testing.assert_array_equal(v, tgeo.work_area(tpot.generate(tcfg), ext).numpy())
    both(lambda s, o: jgeo.r2_index_grid(s, jcfg.grid.size.as_tuple(), offset=o),
         lambda s, o: tgeo.r2_index_grid(s, tcfg.grid.size.as_tuple(), offset=o))
    both(lambda s, o: jpot.potential_sub_array(jcfg, s, o),
         lambda s, o: tpot.potential_sub_array(tcfg, s, o))
    b_blocks = [tpot.build_ab(blk, 0.02, 1.25)[1] for blk in tops.put(torch.from_numpy(v), halo=False)]
    _a, b_glob = tpot.build_ab(torch.from_numpy(v), 0.02, 1.25)
    assert torch.equal(tops.get(b_blocks), b_glob)
    glob = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 8, 16, 8)))
    assert torch.equal(tops.get(tops.put(glob)), glob)
    assert torch.equal(tops.get(tops.put(glob, halo=False)), glob)


def test_load_arrays_meta_matches_reference(tmp_run):
    """The scalar side channel without the global arrays: v_min, v_shift
    and potential_sub as the reference's ``load_arrays_meta``."""
    for over in (dict(potential="SimpleCornell", mass=4.65, sig=0.223),
                 dict(potential="FullCornell", mass=4.65, sig=0.223),
                 dict(potential="Harmonic")):
        jcfg, tcfg = configs(grid={"size": {"x": 8, "y": 12, "z": 10}, "dn": 0.35, "dt": 0.02},
                             **over)
        ref, out = jpot.load_arrays_meta(jcfg, LOG), tpot.load_arrays_meta(tcfg, LOG)
        assert out.v is None and out.a is None and out.b is None
        assert out.pot_sub_array is None and ref.pot_sub_array is None
        assert (out.v_min, out.v_shift, out.pot_sub_scalar) == pytest.approx(
            (ref.v_min, ref.v_shift, ref.pot_sub_scalar), rel=1e-12)


def test_perturb_clone_interior_draws_the_padded_field():
    """``perturb_clone(padded=False)`` on an interior array adds the padded
    form's interior noise: the sharded driver seeds an excited state as the
    single-device one does."""
    _j, tcfg = configs(grid={"size": {"x": 6, "y": 8, "z": 10}, "dn": 0.2, "dt": 0.01})
    from wafer_torch.models import initial

    w = F.pad(torch.from_numpy(np.random.default_rng(2).normal(size=(6, 8, 10))), (1,) * 6)
    padded = initial.perturb_clone(tcfg, w, 1, seed=4)
    inner = initial.perturb_clone(tcfg, tgeo.work_area(w, 1), 1, seed=4, padded=False)
    assert torch.equal(tgeo.work_area(padded, 1), inner)


# --------------------------------------------------------------------------- #
# the chunk against each sharded TPU mode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (4, 1, 1)])
def test_chunk_matches_resident_x_mesh(mesh_shape, monkeypatch):
    """B12: VMEM-resident chunks with R·ext-deep ghost zones exchanged once
    per R steps, x_origin and edge flags (R = 2, screen_update 5: two
    resident calls and a 1-step remainder)."""
    monkeypatch.setenv("WAFER_SHARDED_ICI", "0")
    jcfg, tcfg, phi, a, b, _s = _inputs("ThreePoint", {"x": 40, "y": 8, "z": 128}, 13, su=5)
    ops = JOps(jcfg, jmesh(mesh_shape), 0, use_pallas=True, pallas_interpret=True, res_steps=2)
    assert ops.res_steps == 2 and not ops.ici_res and ops.analytic is not None
    ref = _ref_chunk(ops, phi, a, b)
    np.testing.assert_allclose(_port_chunk(tcfg, mesh_shape, phi, b), ref, **TOL)


def test_chunk_matches_ici_resident_x_mesh():
    """B12, ICI mode: ψ resident for the whole chunk, the deep halo strips
    exchanged by in-kernel remote DMAs at each window boundary."""
    jcfg, tcfg, phi, a, b, _s = _inputs("ThreePoint", {"x": 40, "y": 8, "z": 128}, 13, su=5)
    ops = JOps(jcfg, jmesh((2, 1, 1)), 0, use_pallas=True, pallas_interpret=True, res_steps=2)
    assert ops.ici_res
    np.testing.assert_allclose(_port_chunk(tcfg, (2, 1, 1), phi, b), _ref_chunk(ops, phi, a, b),
                               **TOL)


@pytest.mark.parametrize("mesh_shape", [(4, 1, 1), (8, 1, 1)])
def test_chunk_matches_k_fused_x_mesh(mesh_shape):
    """B5 sharded: K = 2 ground steps per fused call on K·ext-wide x halos,
    with x_origin and edge flags."""
    jcfg, tcfg, phi, a, b, _s = _inputs("ThreePoint", {"x": 16, "y": 8, "z": 128}, 11, su=4)
    ops = JOps(jcfg, jmesh(mesh_shape), 0, use_pallas=True, pallas_interpret=True, k_fuse=2)
    assert ops.k_fuse == 2 and ops.res_steps == 0
    np.testing.assert_allclose(_port_chunk(tcfg, mesh_shape, phi, b), _ref_chunk(ops, phi, a, b),
                               **TOL)


@pytest.mark.parametrize("psn, stream", [(False, "f32"), (True, "f32"), (False, "bf16")],
                         ids=["excited", "per_step_norm", "excited_bf16"])
def test_chunk_matches_fused_step_x_mesh(monkeypatch, psn, stream):
    """B2 sharded: the 1-step fused sweep with x_origin and the psum'd
    coefficient recursion — excited (S = 1) with f32 stored-state streams
    (``WAFER_EXC_STREAM=f32``) and with the default bf16 ones (y = 16, the
    reference's gate; both sides stream the same bf16 values), and
    per-step-norm ground, on a (4, 1, 1) mesh."""
    monkeypatch.setenv("WAFER_EXC_STREAM", stream)
    jcfg, tcfg, phi, a, b, store = _inputs(
        "ThreePoint", {"x": 8, "y": 8 if stream == "f32" else 16, "z": 128}, 8, su=2,
        n_lower=0 if psn else 1)
    ops = JOps(jcfg, jmesh((4, 1, 1)), 0 if psn else 1, use_pallas=True, pallas_interpret=True)
    assert ops.pallas_mode == "x" and not ops.ici_exc_r and not ops.use_res_exc
    assert TOps(tcfg, port_mesh((4, 1, 1)), 1).stream_dtype == (
        torch.bfloat16 if stream == "bf16" else torch.float32)
    ref = _ref_chunk(ops, phi, a, b, store, psn=psn)
    out = _port_chunk(tcfg, (4, 1, 1), phi, b, store, psn=psn)
    np.testing.assert_allclose(out, ref, **(TOL if psn else dict(rtol=5e-4, atol=2e-5)))


@pytest.mark.parametrize("mesh_shape, order", [
    ((2, 2, 2), "ThreePoint"), ((4, 2, 1), "ThreePoint"), ((1, 2, 2), "ThreePoint"),
    ((2, 2, 2), "FivePoint"), ((2, 2, 2), "SevenPoint"),
])
def test_chunk_matches_yzp_step(mesh_shape, order):
    """B13: the y/z-padded 1-step kernel with its (x, y, z) origin on
    multi-axis meshes (the reference's test_sharded_yzp_kernel_matches_sharded_xla)."""
    jcfg, tcfg, phi, a, b, _s = _inputs(order, {"x": 8, "y": 16, "z": 256}, 61)
    ops = JOps(jcfg, jmesh(mesh_shape), 0, use_pallas=True, pallas_interpret=True)
    assert ops.pallas_mode == "yzp" and ops.res_yzp is None and ops.resb_yzp is None
    np.testing.assert_allclose(_port_chunk(tcfg, mesh_shape, phi, b), _ref_chunk(ops, phi, a, b),
                               **TOL)


@pytest.mark.parametrize("mesh_shape, size, order, su", [
    ((4, 2, 1), {"x": 16, "y": 32, "z": 256}, "ThreePoint", 8),
    ((2, 2, 2), {"x": 16, "y": 16, "z": 256}, "ThreePoint", 16),
    ((2, 2, 1), {"x": 32, "y": 32, "z": 256}, "FivePoint", 4),
    ((2, 2, 1), {"x": 32, "y": 32, "z": 256}, "SevenPoint", 4),
])
def test_chunk_matches_yzp_resident_windows(mesh_shape, size, order, su):
    """B14, whole-block windows: R = 2 blind sweeps per pass on R·ext-deep
    halos on every axis, exchanged once per window."""
    jcfg, tcfg, phi, a, b, _s = _inputs(order, size, 64, dt=0.002, su=su)
    ops = JOps(jcfg, jmesh(mesh_shape), 0, use_pallas=True, pallas_interpret=True)
    assert ops.pallas_mode == "yzp" and ops.res_yzp is not None and ops.res_yzp[0] == 2
    np.testing.assert_allclose(_port_chunk(tcfg, mesh_shape, phi, b), _ref_chunk(ops, phi, a, b),
                               **TOL)


@pytest.mark.parametrize("mesh_shape, size", [
    ((4, 2, 1), {"x": 128, "y": 32, "z": 256}), ((2, 2, 2), {"x": 64, "y": 16, "z": 256}),
])
def test_chunk_matches_yzp_blocked_windows(monkeypatch, mesh_shape, size):
    """B14, x-blocked windows: the resident budget pinched, as the
    reference's test does, so the >VMEM out-of-place window kernel runs."""
    monkeypatch.setattr(pk, "_RES_BUDGET", 1_100_000)
    jcfg, tcfg, phi, a, b, _s = _inputs("ThreePoint", size, 66, dt=0.002, su=8)
    ops = JOps(jcfg, jmesh(mesh_shape), 0, use_pallas=True, pallas_interpret=True)
    assert ops.res_yzp is None and ops.resb_yzp is not None and ops.resb_yzp[1] >= 2
    np.testing.assert_allclose(_port_chunk(tcfg, mesh_shape, phi, b), _ref_chunk(ops, phi, a, b),
                               **TOL)


def test_chunk_matches_yzp_excited_psn_and_streamed(monkeypatch):
    """B13's other modes on a (2, 2, 2) mesh: excited (S = 1, stored-state
    halos exchanged), per-step-norm ground, and streamed B."""
    jcfg, tcfg, phi, a, b, store = _inputs("ThreePoint", {"x": 8, "y": 16, "z": 256}, 62,
                                           su=2, n_lower=1)
    ops = JOps(jcfg, jmesh((2, 2, 2)), 1, use_pallas=True, pallas_interpret=True)
    assert ops.pallas_mode == "yzp"
    np.testing.assert_allclose(_port_chunk(tcfg, (2, 2, 2), phi, b, store),
                               _ref_chunk(ops, phi, a, b, store), rtol=5e-4, atol=2e-5)
    ops0 = JOps(jcfg, jmesh((2, 2, 2)), 0, use_pallas=True, pallas_interpret=True)
    np.testing.assert_allclose(_port_chunk(tcfg, (2, 2, 2), phi, b, psn=True),
                               _ref_chunk(ops0, phi, a, b, psn=True), **TOL)
    orig = pk._pick_tx_yzp

    def no_analytic(bx, byp, bzp, by, bz, ext_, itemsize, n_lower, analytic_b=False):
        if analytic_b:
            return None
        return orig(bx, byp, bzp, by, bz, ext_, itemsize, n_lower, analytic_b)

    monkeypatch.setattr(pk, "_pick_tx_yzp", no_analytic)
    ops_s = JOps(jcfg, jmesh((2, 2, 2)), 0, use_pallas=True, pallas_interpret=True)
    assert ops_s.pallas_mode == "yzp" and ops_s.analytic is None
    np.testing.assert_allclose(_port_chunk(tcfg, (2, 2, 2), phi, b, streamed=True),
                               _ref_chunk(ops_s, phi, a, b), **TOL)


# --------------------------------------------------------------------------- #
# the chunk against the single-device chunk
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (8, 1, 1), (1, 2, 4)])
@pytest.mark.parametrize("potential", ["Harmonic", "Coulomb", "Periodic"])
def test_ground_chunk_is_the_single_device_chunk_bitwise(mesh_shape, potential):
    """A ground chunk on a mesh is the single-device K1 chunk bit for bit:
    the exchange copies exact faces and B is read at global coordinates
    (the Coulomb pole sits on the seam of an even mesh)."""
    jcfg, tcfg, phi, _a, _b, _s = _inputs("ThreePoint", {"x": 16, "y": 8, "z": 12}, 3,
                                           su=4, potential=potential)
    an = hs.analytic_params(tcfg, 0.0)
    single = hs.evolve_chunk(F.pad(torch.from_numpy(phi), (1,) * 6), "ThreePoint", 0.01, 0.2,
                             1.0, 4, an)
    out = _port_chunk(tcfg, mesh_shape, phi, np.zeros_like(phi))
    assert np.array_equal(out, tgeo.work_area(single, 1).numpy())


@pytest.mark.parametrize("n_lower", [0, 1, 2, 3, 4])
def test_reducing_chunk_matches_single_device(n_lower):
    """Per-step-norm (S = 0) and excited chunks on a (2, 2, 2) mesh against
    the single-device chunk: the rank-major sum order differs, so they agree
    to rounding. With the stored states' halos zeroed instead of exchanged
    the chunk goes wrong at the shard seams, which this test would see."""
    jcfg, tcfg, phi, _a, b, store = _inputs("ThreePoint", {"x": 8, "y": 8, "z": 8}, 5,
                                            su=6, n_lower=n_lower)
    phi = np.abs(phi)
    an = hs.analytic_params(tcfg, 0.0)
    pad = lambda x: F.pad(torch.from_numpy(x), (1,) * 6)  # noqa: E731
    single = hs.evolve_chunk(pad(phi), "ThreePoint", 0.01, 0.2, 1.0, 6, an, per_step_norm=True,
                             store=None if store is None else pad(store))
    ops = TOps(tcfg, port_mesh((2, 2, 2)), n_lower)
    stored = ops.put_store(None if store is None else torch.from_numpy(store))
    out = ops.get(ops.evolve_chunk_psn(ops.put(torch.from_numpy(phi)), None, None, stored))
    np.testing.assert_allclose(out.numpy(), tgeo.work_area(single, 1).numpy(), rtol=1e-5,
                               atol=1e-6)
    if n_lower:
        bare = [F.pad(tgeo.work_area(s, 1), (1,) * 6) for s in stored]
        wrong = ops.get(ops.evolve_chunk_psn(ops.put(torch.from_numpy(phi)), None, None, bare))
        assert float((wrong - out).abs().max()) > 1e-3 * float(out.abs().max())


# --------------------------------------------------------------------------- #
# the measure and the solve
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_lower, sub", [(0, "scalar"), (1, "array"), (2, None)])
def test_measure_matches_reference(n_lower, sub):
    """Observables, normalisation and Gram-Schmidt on a (2, 2, 2) mesh
    against the reference's ``ShardedOps.measure``."""
    potential = {"scalar": "SimpleCornell", "array": "FullCornell", None: "Harmonic"}[sub]
    jcfg, tcfg, phi, _a, _b, store = _inputs(
        "FivePoint", {"x": 8, "y": 12, "z": 16}, 21, n_lower=n_lower, potential=potential,
        precision="f64", mass=4.65, sig=0.223)
    phi, store = phi.astype(np.float64), None if store is None else store.astype(np.float64)
    ext = 2
    v = jgeo.work_area(jpot.generate(jcfg), ext)
    r2 = jgeo.r2_index_grid(jcfg.work_size(), jcfg.grid.size.as_tuple())
    scalar = 2.5 if sub == "scalar" else None
    jops = JOps(jcfg, jmesh((2, 2, 2)), n_lower, has_pot_sub_array=sub == "array",
                pot_sub_scalar=scalar)
    tops = TOps(tcfg, port_mesh((2, 2, 2)), n_lower, pot_sub_scalar=scalar)
    psa = jpot.potential_sub_array(jcfg) if sub == "array" else None
    ref, ref_phi = jops.measure(jops.put(phi), jops.put(v), jops.put(r2),
                                jops.put(psa) if psa is not None else jops.dummy_pot_sub(),
                                jops.put_store(store))
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    out, out_phi = tops.measure(
        tops.put(t(phi)), tops.put(t(v), halo=False), tops.put(t(r2), halo=False),
        tops.put(t(psa), halo=False) if psa is not None else tops.dummy_pot_sub(),
        tops.put_store(None if store is None else t(store)))
    for o, r in zip(out, ref):
        assert abs(float(o) - float(r)) <= 1e-12 * max(1.0, abs(float(r)))
    np.testing.assert_allclose(tops.get(out_phi).numpy(), np.asarray(jops.get(ref_phi)),
                               rtol=1e-12, atol=1e-14)


def _solve_both(jcfg, tcfg, mesh_shape):
    """The reference's run_sharded and the port's on the same mesh shape,
    each in its own run directory."""
    run_dir.reset_proj_date()
    run_dir.check_output_dir(jcfg.project_name)
    ref = j_run_sharded(jcfg, LOG, mesh=jmesh(mesh_shape))
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    out = t_run_sharded(tcfg, LOG, mesh=port_mesh(mesh_shape))
    su = tcfg.output.screen_update
    for r, o in zip(ref, out):
        e_r = r.observables.energy / r.observables.norm2
        e_o = o.observables.energy / o.observables.norm2
        assert abs(e_r - e_o) < 2e-4, (r.wnum, e_r, e_o)
        assert abs(r.steps - o.steps) <= su, (r.steps, o.steps)
    assert [o.wnum for o in out] == [r.wnum for r in ref]
    return ref, out


def test_solve_harmonic_2x2x2(tmp_run):
    """The reference's test_sharded_solver_end_to_end: 16³ Harmonic on a
    2 × 2 × 2 mesh, Constant IC, against the oracle and the reference."""
    jcfg, tcfg = configs(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02}, tolerance=1e-6,
        precision="f32", output={"screen_update": 100, "file_type": "Json"}, max_steps=100000,
        mesh={"x": 2, "y": 2, "z": 2})
    _ref, out = _solve_both(jcfg, tcfg, (2, 2, 2))
    assert abs(out[0].observables.energy / out[0].observables.norm2 - 1.5) < 0.02
    assert out[0].phi.shape == (18, 18, 18)


def test_solve_coulomb_4x1x1(tmp_run):
    """Coulomb (the pole on the seam of the x mesh) from the reference's
    Coulomb IC on 4 × 1 × 1, f64 with the plain sweep."""
    jcfg, tcfg = configs(
        potential="Coulomb", init_condition="Coulomb", precision="f64",
        grid={"size": {"x": 16, "y": 12, "z": 12}, "dn": 0.5, "dt": 0.05}, tolerance=1e-6,
        output={"screen_update": 50, "file_type": "Json"}, max_steps=100000,
        mesh={"x": 4, "y": 1, "z": 1})
    _ref, out = _solve_both(jcfg, tcfg, (4, 1, 1))
    assert out[0].observables.energy < 0.0


def test_solve_excited_matches_reference_and_single_device(tmp_run):
    """Ground and first excited state on a (2, 1, 2) mesh from the same
    state-1 start on disk, against the reference's run_sharded and the
    port's own single-device run."""
    kw = dict(grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
              tolerance=1e-5, precision="f32", wavemax=1,
              output={"screen_update": 50, "file_type": "Json"}, max_steps=20000)
    jcfg, tcfg = configs(**kw, mesh={"x": 2, "y": 1, "z": 2})
    with open("input/wavefunction_1_partial.json", "w") as fh:
        # a zero shell: the single-device drivers keep a file's shell as the
        # boundary, the sharded ones read only its interior
        fh.write(formats.array_to_json(np.pad(np.random.default_rng(11).normal(size=(16,) * 3), 1)))
    _ref, out = _solve_both(jcfg, tcfg, (2, 1, 2))
    single = tsolver.run(configs(**kw)[1], device=CPU)
    for o, s in zip(out, single):
        assert abs(o.observables.energy / o.observables.norm2
                   - s.observables.energy / s.observables.norm2) < 2e-4
    assert abs(out[1].observables.energy / out[1].observables.norm2 - 2.5) < 0.1


def test_multigrid_final_level_sharded(tmp_run, monkeypatch):
    """Multigrid with a mesh: the coarse level on one device, the final
    level through run_sharded from the upsampled state, as the reference's
    _run_multigrid does; energies within 2e-4 of the reference's run."""
    from wafer_torch.parallel import solver_sharded

    calls = []
    orig = solver_sharded.run_sharded
    monkeypatch.setattr(solver_sharded, "run_sharded",
                        lambda cfg, *a, **k: calls.append(cfg.grid.size.x) or orig(cfg, *a, **k))
    jcfg, tcfg = configs(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02}, tolerance=1e-6,
        precision="f32", multigrid=[2], output={"screen_update": 100, "file_type": "Json"},
        max_steps=100000, mesh={"x": 2, "y": 1, "z": 1})
    run_dir.check_output_dir(jcfg.project_name)
    ref = jsolver.run(jcfg)
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    out = tsolver.run(tcfg, mesh=port_mesh((2, 1, 1)))
    assert calls == [16]
    e_r = ref[0].observables.energy / ref[0].observables.norm2
    e_o = out[0].observables.energy / out[0].observables.norm2
    assert abs(e_r - e_o) < 2e-4 and abs(e_o - 1.5) < 0.02


def test_default_mesh_needs_a_device_per_shard(tmp_run):
    """Without a mesh, ``solver.run`` takes one shard per device: on the CPU
    (one device) a two-shard config fails with the reference's error."""
    _j, tcfg = configs(grid={"size": {"x": 8, "y": 8, "z": 8}, "dn": 0.3, "dt": 0.02},
                       mesh={"x": 2})
    with pytest.raises(ValueError, match=r"mesh \(2, 1, 1\) needs 2 devices, have 1"):
        tsolver.run(tcfg, device=CPU)


def test_backend_key_on_a_mesh(tmp_run):
    """The kernel sweep is the f32 default and needs f32; backend pallas
    demands f32 on CUDA devices, as on one device."""
    kw = dict(grid={"size": {"x": 8, "y": 8, "z": 8}, "dn": 0.3, "dt": 0.02}, mesh={"x": 2})
    mesh = port_mesh((2, 1, 1))
    assert TOps(configs(precision="f32", **kw)[1], mesh, 0).use_pallas
    f64 = configs(precision="f64", **kw)[1]
    assert not TOps(f64, mesh, 0).use_pallas
    with pytest.raises(ValueError, match="requires precision f32"):
        TOps(f64, mesh, 0, use_pallas=True)
    with pytest.raises(ConfigParseError, match="backend: pallas requires"):
        t_run_sharded(configs(precision="f32", backend="pallas", **kw)[1], LOG, mesh=mesh)
