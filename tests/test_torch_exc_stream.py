"""bf16 stored-state streams (``WAFER_EXC_STREAM``, default ``bf16``) in the
port against the reference's default excited route, on the CPU.

The port's K1 wrappers run their plain versions on CPU tensors, which
upcast the bf16 store as the kernel does. The reference runs its Pallas
kernels in interpret mode. Inputs come from numpy seeds. Tolerances:

- (a) the single-device chunk against ``evolve_chunk_resident`` with bf16
  ``store_xpad`` and ``sstore_xpad``: rtol 3e-2, atol 2e-3, the reference
  test's own (tests/test_pallas_stencil.py::test_resident_exc_bf16_streams),
  since the reference also quantises its swept images S(l); and the chunk
  orthogonal to the f32 store within 1e-3 of ‖ψ‖;
- (b) the (4, 1, 1) mesh chunk against the reference's windowed excited
  path: max|Δψ| ≤ 3e-2·max|ψ|, the reference test's own
  (tests/test_sharding.py::test_sharded_windowed_excited_bf16_streams);
- (c) the rule's route table, exact, against the reference's stated
  conditions where it has them;
- (d) a whole E₀ → E₁ run: E₁ within 1e-5 of the reference's XLA run and
  of the port's own f32-stream run, at the same steps.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_hostlayer import configs
from wafer_torch import solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.ops import hopper_stencil as hs
from wafer_torch.parallel.mesh import make_mesh as tmesh
from wafer_torch.parallel.multislice import MultiSliceOps, make_multislice_mesh
from wafer_torch.parallel.sharded import ShardedOps as TOps
from wafer_tpu import geometry as jgeo, solver as jsolver
from wafer_tpu.io import formats, run_dir
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import pallas_stencil as pk
from wafer_tpu.parallel import make_mesh as jmesh
from wafer_tpu.parallel.sharded import ShardedOps as JOps

CPU = torch.device("cpu")
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _default_stream(monkeypatch):
    """Every test starts from the reference's default: the variable unset."""
    monkeypatch.delenv("WAFER_EXC_STREAM", raising=False)


# --------------------------------------------------------------------------- #
# (a) the single-device chunk
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("order", ["ThreePoint", "FivePoint", "SevenPoint"])
def test_chunk_matches_resident_bf16_streams(order):
    """The port's K1 chunk with a bf16 store against the reference's
    resident excited chunk with bf16 l and S(l) windows (16³, 5 steps)."""
    jcfg, tcfg = configs(precision="f32", central_difference=order,
                         grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.2, "dt": 0.004})
    g, ext = jcfg.grid, jcfg.central_difference.ext
    scale = g.dt / (jgeo.stencil_coefficients(order)[3] * g.dn ** 2 * jcfg.mass)
    analytic = ("Harmonic", g.dn, g.dt, jcfg.mass, g.size.x, g.size.y, g.size.z)
    rng = np.random.default_rng(23)

    def padded_noise():
        x = np.zeros(jcfg.padded_size(), np.float32)
        x[(slice(ext, -ext),) * 3] = rng.normal(size=jcfg.work_size())
        return x

    phi, w = padded_noise(), padded_noise()
    w /= np.float32(np.sqrt(np.sum(w.astype(np.float64) ** 2)))
    sl, _n2, _ov = pk.evolve_step_fused(pk.to_xpad(jnp.asarray(w), ext), None, None, order,
                                        scale, 0, False, interpret=True, analytic=analytic)
    ref = pk.evolve_chunk_resident(
        pk.to_xpad(jnp.asarray(phi), ext), order, g.dt, g.dn, jcfg.mass, 5, analytic,
        interpret=True, store_xpad=jnp.stack([pk.to_xpad(jnp.asarray(w), ext)]).astype(
            jnp.bfloat16), sstore_xpad=jnp.stack([sl]).astype(jnp.bfloat16))
    ref = np.asarray(pk.from_xpad(ref, ext))

    assert hs.exc_stream_dtype(tcfg, 1, kernel=True) == BF16
    out = hs.evolve_chunk(torch.from_numpy(phi), order, g.dt, g.dn, tcfg.mass, 5, analytic,
                          store=torch.from_numpy(w)[None].to(BF16)).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-2, atol=2e-3)
    ov = float(np.sum(out.astype(np.float64) * w))
    assert abs(ov) < 1e-3 * np.sqrt(np.sum(out.astype(np.float64) ** 2)), ov


# --------------------------------------------------------------------------- #
# (b) the one-axis mesh
# --------------------------------------------------------------------------- #


def test_x_mesh_chunk_matches_windowed_bf16_streams():
    """The port's (4, 1, 1) chunk, whose ``put_store`` gives bf16 blocks,
    against the reference's default windowed excited path on the same
    inputs (32 × 16 × 128, three steps, the reference test's set-up)."""
    jcfg, tcfg = configs(precision="f32",
                         grid={"size": {"x": 32, "y": 16, "z": 128}, "dn": 0.2, "dt": 0.01},
                         output={"screen_update": 3})
    ext = 1
    rng = np.random.default_rng(91)
    phi = rng.normal(size=jcfg.work_size()).astype(np.float32)
    lower = rng.normal(size=jcfg.work_size()).astype(np.float32)
    lower /= np.sqrt(np.sum(lower.astype(np.float64) ** 2)).astype(np.float32)
    a, b = jpot.build_ab(jpot.generate(jcfg), jcfg.grid.dt)
    a_int, b_int = jgeo.work_area(a, ext), jgeo.work_area(b, ext)

    jops = JOps(jcfg, jmesh((4, 1, 1)), 1, use_pallas=True, pallas_interpret=True)
    assert jops.pallas_mode == "x" and not jops.use_res_exc and not jops.ici_exc_r
    ref = np.asarray(jops.get(jops.evolve_chunk(
        jops.put(phi), jops.put(a_int), jops.put(b_int), jops.put_store(jnp.asarray(lower)[None]))))

    tops = TOps(tcfg, tmesh((4, 1, 1), [CPU] * 4), 1)
    stored = tops.put_store(torch.from_numpy(lower)[None])
    assert tops.stream_dtype == BF16 and all(s.dtype == BF16 for s in stored)
    out = tops.get(tops.evolve_chunk(tops.put(torch.from_numpy(phi)), None,
                                     tops.put(torch.tensor(np.asarray(b_int)), halo=False),
                                     stored)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 3e-2
    ov = float(np.sum(lower.astype(np.float64) * out.astype(np.float64)))
    assert abs(ov) < 1e-3 * np.sqrt(np.sum(out.astype(np.float64) ** 2)), ov


# --------------------------------------------------------------------------- #
# (c) the route table
# --------------------------------------------------------------------------- #


SIZE = {"x": 32, "y": 16, "z": 128}


def _reference_single(jcfg, n_lower, monkeypatch) -> bool:
    """The reference's single-device choice: its backend rule on an
    accelerator (``_resolve_backend``), then ``exc_bf16``
    (wafer_tpu/solver.py:528-531) for a state with stored states. Its
    VMEM gate ``resident_exc_supported`` is left out on purpose."""
    phi = jnp.zeros(jcfg.padded_size(), jcfg.real_dtype)
    if jcfg.potential.is_complex:
        phi = phi.astype(jnp.complex64)
    with monkeypatch.context() as m:
        m.setattr(jsolver.jax, "default_backend", lambda: "tpu")
        backend = jsolver._resolve_backend(jcfg, phi)
    return (backend == "pallas" and n_lower > 0
            and os.environ.get("WAFER_EXC_STREAM", "bf16") == "bf16"
            and jcfg.grid.size.y % 16 == 0)


def _reference_mesh(jcfg, shape, n_lower) -> bool:
    """The reference's mesh choice, ``exc_stream_bf16`` of
    wafer_tpu/parallel/sharded.py:359-369: the single-axis kernel mode
    ("x") with stored states, the variable, and y of its layout (the
    sharded axis moved first) a multiple of 16."""
    try:
        ops = JOps(jcfg, jmesh(shape), n_lower, use_pallas=True, pallas_interpret=True)
    except ValueError:  # no kernel mode: the XLA route
        return False
    ny = jcfg.work_size()[ops.perm[1]]
    return (ops.pallas_mode == "x" and n_lower > 0
            and os.environ.get("WAFER_EXC_STREAM", "bf16") == "bf16" and ny % 16 == 0)


ROUTES = [
    # (id, config overrides, mesh shape or None, slices, port's dtype)
    ("one_device", {}, None, 1, BF16),
    ("mesh_4x1x1", {}, (4, 1, 1), 1, BF16),
    ("mesh_1x4x1", {}, (1, 4, 1), 1, BF16),
    ("mesh_4x2x1", {}, (4, 2, 1), 1, torch.float32),
    ("slices_2x2x1x1", {}, (2, 1, 1), 2, BF16),
    ("slices_2x2x2x1", {}, (2, 2, 1), 2, torch.float32),
    ("complex", {"potential": "ComplexHarmonic", "absorb": 0.2}, None, 1, torch.float32),
    ("f64", {"precision": "f64"}, None, 1, torch.float64),
    ("ny_24", {"grid": {"size": {"x": 32, "y": 24, "z": 128}, "dn": 0.2, "dt": 0.01}}, None, 1,
     torch.float32),
    ("plain_route", {"backend": "xla"}, None, 1, torch.float32),
    ("opt_out", {}, None, 1, torch.float32),
]


@pytest.mark.parametrize("over, shape, slices, want", [r[1:] for r in ROUTES],
                         ids=[r[0] for r in ROUTES])
def test_route_table(monkeypatch, over, shape, slices, want, request):
    """``exc_stream_dtype`` on one device (the kernel route as
    ``solver._resolve_backend`` takes it on a CUDA device), and
    ``stream_dtype`` of the mesh ops, against the reference's conditions
    on the same sizes."""
    if request.node.callspec.id == "opt_out":
        monkeypatch.setenv("WAFER_EXC_STREAM", "f32")
    raw = dict(precision="f32", grid={"size": SIZE, "dn": 0.2, "dt": 0.01})
    raw.update(over)
    jcfg, tcfg = configs(**raw)
    if shape is None:
        kernel = tcfg.backend != "xla" and tcfg.real_dtype == torch.float32
        got = hs.exc_stream_dtype(tcfg, 1, kernel)
        assert hs.exc_stream_dtype(tcfg, 0, kernel) == tcfg.real_dtype  # no stored states
        ref = _reference_single(jcfg, 1, monkeypatch)
    elif slices > 1:
        mesh = make_multislice_mesh(shape, slices, [CPU] * (slices * int(np.prod(shape))))
        got = MultiSliceOps(tcfg, mesh, 1).stream_dtype
        ref = _reference_mesh(jcfg, mesh.shape, 1)  # the reference's flat ring
    else:
        got = TOps(tcfg, tmesh(shape, [CPU] * int(np.prod(shape))), 1).stream_dtype
        ref = _reference_mesh(jcfg, shape, 1)
    assert got == want
    assert (got == BF16) == ref


# --------------------------------------------------------------------------- #
# (d) the whole slice
# --------------------------------------------------------------------------- #


def test_solve_e1_matches_reference_and_f32_streams(tmp_run, monkeypatch):
    """A 16³ harmonic E₀ → E₁ run through ``solver.run`` → ``solve`` with
    the kernel route forced on the CPU (K1's plain versions, so E₁'s
    chunks take the bf16 store), every excited chunk projecting
    (``delayed_gram: false``): E₁ against the reference's XLA run and
    against the port's own run with ``WAFER_EXC_STREAM=f32``. Tolerance
    2e-6: a chunk cuts E₁'s error by e (su·dt = 1, gap 1), so a run that
    stops a chunk earlier or later than another is still within ~3e-6 of
    it; the steps agree within one chunk."""
    jcfg, tcfg = configs(
        precision="f32", delayed_gram=False, init_condition="Constant",
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=2e-6, max_steps=40000, wavemax=1,
        output={"screen_update": 50, "file_type": "Json"},
    )
    rng = np.random.default_rng(11)
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(rng.normal(size=jcfg.work_size())))
    run_dir.check_output_dir(jcfg.project_name)
    ref = jsolver.run(jcfg)

    monkeypatch.setattr(tsolver, "_resolve_backend", lambda config, phi: "kernel")
    streams = []
    orig = hs.evolve_chunk

    def spy(phi, *args, store=None, **kw):
        streams.append(None if store is None else store.dtype)
        return orig(phi, *args, store=store, **kw)

    monkeypatch.setattr(hs, "evolve_chunk", spy)
    runs = {}
    for value in ("bf16", "f32"):
        monkeypatch.setenv("WAFER_EXC_STREAM", value)
        streams.clear()
        trun_dir.reset_proj_date()
        trun_dir.check_output_dir(tcfg.project_name)
        runs[value] = tsolver.run(tcfg, device=CPU)
        want = BF16 if value == "bf16" else torch.float32
        assert None in streams and set(streams) == {None, want}
    e_ref = [r.observables.energy / r.observables.norm2 for r in ref]
    e = {k: [r.observables.energy / r.observables.norm2 for r in v] for k, v in runs.items()}
    assert runs["bf16"][0].steps == runs["f32"][0].steps
    assert e["bf16"][0] == e["f32"][0]  # E₀ streams nothing
    for other in (runs["f32"], ref):
        assert abs(runs["bf16"][1].steps - other[1].steps) <= 50
    assert abs(e["bf16"][1] - e_ref[1]) < 1e-5, (e, e_ref)
    assert abs(e["bf16"][1] - e["f32"][1]) < 1e-5, e
    assert abs(e["bf16"][1] - 2.5) < 0.1


def test_batch_graph_key_names_the_stream():
    """A graph captured over an f32 store is never replayed over a bf16
    one: the stream dtype is part of ``BatchRunner``'s key."""
    from wafer_torch.batch import BatchRunner

    keys = []
    for dtype in (torch.float32, BF16):
        runner = BatchRunner(None, None, 1e-5, pair=False, n_lower=1, graphs=False,
                             stream_dtype=dtype)
        runner._iterations = lambda rows, key, psn, timer: keys.append(key)
        runner._read = lambda rows, k: None
        runner.run(torch.zeros(4, 4, 4), 1.0, 1, False)
    assert keys[0][2] == torch.float32 and keys[1][2] == BF16 and keys[0] != keys[1]


def test_bf16_faces_cross_ranks_as_bytes():
    """A bf16 face travels as its bytes (an int16 view, the same bits)."""
    from wafer_torch.parallel import transport

    x = torch.randn(3, 5, 7).to(BF16)
    face = transport._wire(x.narrow(1, 1, 2))
    assert face.dtype == torch.int16
    back = torch.zeros_like(x)
    transport._wire(back.narrow(1, 1, 2)).copy_(face)
    assert torch.equal(back.narrow(1, 1, 2), x.narrow(1, 1, 2))
    assert transport._wire(x.float()).dtype == torch.float32
