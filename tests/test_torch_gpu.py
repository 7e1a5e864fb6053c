"""The hand-written CUDA kernels against their plain torch versions on a
CUDA device. Every test here needs the card and skips without one.

The file imports no jax, so it also runs where only the port is
installed (tests/conftest.py imports jax):

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances (f32 in another summation and contraction order): ψ' within
1e-6 of its largest magnitude, reductions within 1e-5 of ‖ψ'‖²; chunks
within 1e-5 after 20 steps."""

import dataclasses
import logging

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from wafer_torch import geometry, solver
from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
from wafer_torch.config import Config, Index3

ORDERS = ["ThreePoint", "FivePoint", "SevenPoint"]
KINDS = ["NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic", "streamed"]
SC_KINDS = ["Harmonic", "Coulomb", "streamed"]  # the pair sweep's B sources
N = (24, 20, 40)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(order, n_lower, seed, dev):
    ext = geometry.EXT[order]
    gen = torch.Generator().manual_seed(seed)
    psi = F.pad(torch.randn(N, generator=gen), (ext,) * 6)
    store = None
    if n_lower:
        store = torch.stack([F.pad(torch.randn(N, generator=gen), (ext,) * 6)
                             for _ in range(n_lower)])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3), keepdim=True))
        store = store.to(dev)
    b_int = (1.0 / (1.0 + 0.002 * torch.rand(N, generator=gen))).to(dev)
    return psi.to(dev), store, b_int


def _close(out, ref, rtol):
    err = float((out.cpu().double() - ref.cpu().double()).abs().max())
    assert err <= rtol * float(ref.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", ORDERS)
def test_sweep_step_matches_plain(cuda, order, kind):
    """K1 in every mode (ground; carried correction with 0, 1, 2 stored
    states) and K2 on its partials, against the plain versions."""
    k = geometry.stencil_coefficients(order)[3]
    scale = 0.004 / (k * 0.2 * 0.2)
    for n_lower, apply in ((0, False), (0, True), (1, True), (2, True)):
        psi, store, b_int = _inputs(order, n_lower, 1 + n_lower, cuda)
        analytic = None if kind == "streamed" else (kind, 0.2, 0.004, 1.0, *N, 0.3, 0.1)
        coef = torch.tensor([0.9] + [0.1] * n_lower, device=cuda)
        kw = dict(order=order, scale=scale, analytic=analytic,
                  b_int=None if analytic else b_int, store=store, apply_coef=apply)
        out, ref = torch.empty_like(psi), torch.empty_like(psi)
        part = part_ref = None
        if apply:
            part = torch.empty(hs.num_partials(psi, order), 1 + n_lower,
                               dtype=torch.float64, device=cuda)
            part_ref = torch.empty(1, 1 + n_lower, dtype=torch.float64, device=cuda)
        hs.sweep_step(psi, out, coef, part, **kw)
        hs.sweep_step_plain(psi, ref, coef, part_ref, **kw)
        _close(out, ref, 1e-6)
        if apply:
            red, red_ref = (torch.empty(1 + n_lower, dtype=torch.float64, device=cuda)
                            for _ in range(2))
            c, c_ref = torch.empty_like(coef), torch.empty_like(coef)
            hs.finish_coef(part, red, c)
            hs.finish_coef_plain(part_ref, red_ref, c_ref)
            assert float((red - red_ref).abs().max()) <= 1e-5 * float(red_ref[0])
            _close(c, c_ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1", "S2"])
@pytest.mark.parametrize("order", ORDERS)
def test_chunk_matches_plain(cuda, order, mode):
    """A 20-step chunk on the device (no host synchronisation inside)
    against the same function on CPU tensors, which runs the plain
    versions; the launch counters see every kernel launch."""
    n_lower = {"S1": 1, "S2": 2}.get(mode, 0)
    psi, store, b_int = _inputs(order, n_lower, 7, cuda)
    psi = F.pad(geometry.work_area(psi, geometry.EXT[order]).abs(), (geometry.EXT[order],) * 6)
    analytic = ("Harmonic", 0.2, 0.004, 1.0, *N)
    psn = mode == "per_step_norm"
    hs.reset_launches()
    out = hs.evolve_chunk(psi, order, 0.004, 0.2, 1.0, 20, analytic, per_step_norm=psn,
                          store=store)
    reduced = psn or n_lower > 0
    assert hs.LAUNCHES == {"sweep_step": 20, "finish_coef": 20 if reduced else 0,
                           "sweep_step_sc": 0}
    ref = hs.evolve_chunk(psi.cpu(), order, 0.004, 0.2, 1.0, 20, analytic, per_step_norm=psn,
                          store=None if store is None else store.cpu())
    _close(out, ref, 1e-5)
    assert hs.LAUNCHES["sweep_step"] == 20  # the CPU run launched nothing
    streamed = hs.evolve_chunk(psi, order, 0.004, 0.2, 1.0, 3, b_int=b_int, store=store)
    _close(streamed, hs.evolve_chunk(psi.cpu(), order, 0.004, 0.2, 1.0, 3, b_int=b_int.cpu(),
                                     store=None if store is None else store.cpu()), 1e-5)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    psi, store, _b = _inputs("ThreePoint", 1, 3, cuda)
    an = ("Harmonic", 0.2, 0.004, 1.0, *N)
    coef = torch.ones(2, device=cuda)
    kw = dict(order="ThreePoint", scale=0.05, analytic=an, store=store, apply_coef=True)
    with pytest.raises(ValueError, match="in place"):
        hs.sweep_step(psi, psi, coef, None, **kw)
    with pytest.raises(ValueError, match="psi"):
        hs.sweep_step(psi.double(), torch.empty_like(psi).double(), coef, None, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        t = psi.transpose(0, 2)
        hs.sweep_step(t, torch.empty_like(psi).transpose(0, 2), coef, None, **kw)
    with pytest.raises(ValueError, match="coef"):
        hs.sweep_step(psi, torch.empty_like(psi), coef[:1], None, **kw)
    with pytest.raises(ValueError, match="partials"):
        hs.sweep_step(psi, torch.empty_like(psi), coef,
                      torch.empty(3, 2, dtype=torch.float64, device=cuda), **kw)
    with pytest.raises(ValueError, match="analytic grid size"):
        hs.sweep_step(psi, torch.empty_like(psi), coef, None,
                      **{**kw, "analytic": ("Harmonic", 0.2, 0.004, 1.0, 8, 8, 8)})


def _pair_inputs(order, n_lower, seed, dev):
    """An (re, im) pair, S unit stored pairs and a streamed (Br, Bi)."""
    ext = geometry.EXT[order]
    gen = torch.Generator().manual_seed(seed)

    def pair():
        return torch.stack([F.pad(torch.randn(N, generator=gen), (ext,) * 6) for _ in range(2)])

    store = None
    if n_lower:
        store = torch.stack([pair() for _ in range(n_lower)])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3, 4), keepdim=True))
        store = store.to(dev)
    d = 1.0 + 0.002 * torch.rand(N, generator=gen) + 0.0004j * torch.rand(N, generator=gen)
    b2 = torch.stack([(1 / d).real, (1 / d).imag]).float().contiguous().to(dev)
    return pair().to(dev), store, b2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SC_KINDS)
@pytest.mark.parametrize("order", ORDERS)
def test_sweep_step_sc_matches_plain(cuda, order, kind):
    """K3 in every mode (ground; carried correction with 0, 1, 2 stored
    pairs) and K2 on its 1 + 2S partials, against the plain versions."""
    k = geometry.stencil_coefficients(order)[3]
    scale = 0.004 / (k * 0.2 * 0.2)
    for n_lower, apply in ((0, False), (0, True), (1, True), (2, True)):
        psi, store, b2 = _pair_inputs(order, n_lower, 11 + n_lower, cuda)
        analytic = None if kind == "streamed" else (kind, 0.2, 0.004, 1.0, *N, 1.0, 0.3, 0.2)
        coef = torch.tensor([0.9] + [0.1, -0.05] * n_lower, device=cuda)
        kw = dict(order=order, scale=scale, analytic=analytic,
                  b2=None if analytic else b2, store=store, apply_coef=apply)
        out, ref = torch.empty_like(psi), torch.empty_like(psi)
        part = part_ref = None
        n_red = 1 + 2 * n_lower
        if apply:
            part = torch.empty(hsp.num_partials(psi, order), n_red, dtype=torch.float64,
                               device=cuda)
            part_ref = torch.empty(1, n_red, dtype=torch.float64, device=cuda)
        hsp.sweep_step_sc(psi, out, coef, part, **kw)
        hsp.sweep_step_sc_plain(psi, ref, coef, part_ref, **kw)
        _close(out, ref, 1e-6)
        if apply:
            red, red_ref = (torch.empty(n_red, dtype=torch.float64, device=cuda)
                            for _ in range(2))
            c, c_ref = torch.empty_like(coef), torch.empty_like(coef)
            hs.finish_coef(part, red, c)
            hs.finish_coef_plain(part_ref, red_ref, c_ref)
            assert float((red - red_ref).abs().max()) <= 1e-5 * float(red_ref[0])
            _close(c, c_ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1", "S2"])
@pytest.mark.parametrize("order", ORDERS)
def test_chunk_sc_matches_plain(cuda, order, mode):
    """A 20-step pair chunk (K3 + K2, no host synchronisation inside)
    against the same function on CPU tensors."""
    n_lower = {"S1": 1, "S2": 2}.get(mode, 0)
    psi, store, b2 = _pair_inputs(order, n_lower, 17, cuda)
    ext = geometry.EXT[order]
    psi = torch.stack([F.pad(geometry.work_area(psi[0], ext).abs(), (ext,) * 6),
                       0.1 * psi[1]])
    analytic = ("Harmonic", 0.2, 0.004, 1.0, *N, 1.0, 0.0, 0.2)
    psn = mode == "per_step_norm"
    hs.reset_launches()
    out = hsp.evolve_chunk_sc(psi, order, 0.004, 0.2, 1.0, 20, analytic, per_step_norm=psn,
                              store=store)
    reduced = psn or n_lower > 0
    assert hs.LAUNCHES == {"sweep_step": 0, "finish_coef": 20 if reduced else 0,
                           "sweep_step_sc": 20}
    cpu = None if store is None else store.cpu()
    ref = hsp.evolve_chunk_sc(psi.cpu(), order, 0.004, 0.2, 1.0, 20, analytic,
                              per_step_norm=psn, store=cpu)
    _close(out, ref, 1e-5)
    streamed = hsp.evolve_chunk_sc(psi, order, 0.004, 0.2, 1.0, 3, b2=b2, store=store)
    _close(streamed, hsp.evolve_chunk_sc(psi.cpu(), order, 0.004, 0.2, 1.0, 3, b2=b2.cpu(),
                                         store=cpu), 1e-5)


@pytest.mark.gpu
def test_sweep_step_sc_rejects_what_the_kernel_does_not_take(cuda):
    psi, store, b2 = _pair_inputs("ThreePoint", 1, 3, cuda)
    an = ("Harmonic", 0.2, 0.004, 1.0, *N, 1.0, 0.0, 0.2)
    coef = torch.ones(3, device=cuda)
    kw = dict(order="ThreePoint", scale=0.05, analytic=an, store=store, apply_coef=True)
    with pytest.raises(ValueError, match="in place"):
        hsp.sweep_step_sc(psi, psi, coef, None, **kw)
    with pytest.raises(ValueError, match="pair"):
        hsp.sweep_step_sc(psi[0], torch.empty_like(psi[0]), coef, None, **kw)
    with pytest.raises(ValueError, match="coef"):
        hsp.sweep_step_sc(psi, torch.empty_like(psi), coef[:1], None, **kw)
    with pytest.raises(ValueError, match="unsupported complex analytic"):
        hsp.sweep_step_sc(psi, torch.empty_like(psi), coef, None,
                          **{**kw, "analytic": ("Periodic", *an[1:])})
    with pytest.raises(ValueError, match="b2"):
        hsp.sweep_step_sc(psi, torch.empty_like(psi), coef, None,
                          **{**kw, "analytic": None, "b2": b2[0]})


# --------------------------------------------------------------------------- #
# the x-marching tiled sweeps (chip_smoke phases 2, 2b, 2d): grids that do not
# fill their tiles, repeat launches, blocks thinner than a segment
# --------------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("n", chip_smoke.RAGGED, ids=["odd", "below_a_tile", "short_x"])
@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("order", ORDERS)
def test_ragged_grids_match_plain(cuda, order, pair, n):
    """K1 (K3) on a grid with odd extents, one smaller than a 16 x 32 tile
    and one with fewer x-planes than a segment: every B source, S = 0..3
    (3: the run-time count), with and without a block origin, against the
    plain version (1e-6 of max|ψ'|, 1e-5 on the reductions)."""
    gen = torch.Generator(device=cuda).manual_seed(61)
    for kind in SC_KINDS if pair else KINDS:
        for n_store, apply in chip_smoke.RAGGED_MODES:
            for with_origin in (False, True):
                psi_err, red_err = chip_smoke.ragged_vs_plain(order, kind, n_store, apply, pair,
                                                              n, with_origin, gen, cuda)
                assert psi_err <= 1e-6 and red_err <= 1e-5, (kind, n_store, with_origin)


@pytest.mark.gpu
@pytest.mark.parametrize("n_store", [0, 1, 2, 3])
@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
def test_two_launches_are_bit_identical(cuda, pair, n_store):
    """No atomics: the same input gives the same ψ' and partial rows."""
    gen = torch.Generator(device=cuda).manual_seed(67)
    for n in ((37, 45, 29), (64, 64, 64)):
        assert chip_smoke.repeat_is_identical(pair, n_store, n, gen, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
def test_shard_blocks_thinner_than_a_segment(cuda, pair):
    """An (8, 1, 1) mesh of 64 x 40 x 48: 8-plane blocks, fewer than a
    segment's 16. K1 (K3) with each block's origin, S = 1 with the
    coefficients, against its plain version and bit for bit against the
    whole grid's sweep."""
    n = (64, 40, 48)
    mesh = _cuda_mesh((8, 1, 1), cuda)
    gen = torch.Generator().manual_seed(71)
    lead = (2,) if pair else ()
    psi = torch.randn((*lead, *n), generator=gen).to(cuda)
    low = torch.randn((1, *lead, *n), generator=gen).to(cuda)
    low = low / torch.sqrt((low * low).sum())
    analytic = ("Coulomb", 0.2, 0.004, 1.0, *n, 1.0, 0.0) + ((0.2,) if pair else ())
    kernel, plain, rows = ((hsp.sweep_step_sc, hsp.sweep_step_sc_plain, hsp.num_partials) if pair
                           else (hs.sweep_step, hs.sweep_step_plain, hs.num_partials))
    coef = torch.tensor([0.9, 0.05, -0.03][:3 if pair else 2], device=cuda)
    kw = dict(order="ThreePoint", scale=0.05, analytic=analytic, apply_coef=True)
    whole, store = F.pad(psi, (1,) * 6), F.pad(low, (1,) * 6)
    out_s = torch.empty_like(whole)
    kernel(whole, out_s, coef, torch.empty(rows(whole, "ThreePoint"), len(coef),
                                           dtype=torch.float64, device=cuda), store=store, **kw)
    blocks, stores = _blocks(psi, mesh, 1), _blocks(low, mesh, 1)
    for blk, st, (shape, origin) in zip(blocks, stores, mesh.blocks(n)):
        assert shape[0] < 16
        out, ref = torch.empty_like(blk), torch.empty_like(blk)
        part = torch.empty(rows(blk, "ThreePoint"), len(coef), dtype=torch.float64, device=cuda)
        part_ref = torch.empty(1, len(coef), dtype=torch.float64, device=cuda)
        kernel(blk, out, coef, part, store=st, origin=origin, **kw)
        plain(blk, ref, coef, part_ref, store=st, origin=origin, **kw)
        _close(out, ref, 1e-6)
        assert abs(float(part.sum(0)[0] - part_ref[0, 0])) <= 1e-5 * float(part_ref[0, 0])
        inner = (...,) + tuple(slice(1, -1) for _ in range(3))
        want = out_s[(...,) + tuple(slice(o + 1, o + 1 + m) for o, m in zip(origin, shape))]
        assert torch.equal(out[inner], want)


@pytest.mark.gpu
def test_partial_rows_at_512_are_few(cuda):
    """One partial row per 16 x 32 x 16 block: 16,384 at 512³ for K1 and
    K3, where the one-thread-per-point sweeps wrote 567,970."""
    one = torch.empty(1, device=cuda)
    assert hs.num_partials(one.expand(514, 514, 514), "ThreePoint") == 16384
    assert hsp.num_partials(one.expand(2, 514, 514, 514), "ThreePoint") == 16384
    assert hs.num_partials(one.expand(518, 518, 518), "SevenPoint") < 20000


@pytest.mark.gpu
@pytest.mark.parametrize("rows", chip_smoke.FINISH_ROWS)
def test_finish_coef_matches_plain(cuda, rows):
    """K2 (one block, or groups with a ticket) against its plain version at
    every column count of chip_smoke phase 2e, 32,768 rows included:
    reductions within 1e-5 of Σ|x| and coefficients within 1e-5 of their
    scale; two launches on the same partials bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(73)
    for n_red in chip_smoke.FINISH_NRED:
        red_err, coef_err, same = chip_smoke.finish_vs_plain(rows, n_red, gen, cuda)
        assert red_err <= 1e-5 and coef_err <= 1e-5 and same, (n_red, red_err, coef_err, same)


@pytest.mark.gpu
@pytest.mark.parametrize("rows, n_red", [(2048, 2), (16384, 2), (32768, 1), (32768, 3),
                                         (100003, 7)])
def test_finish_coef_ticket_resets(cuda, rows, n_red):
    """1,000 launches in a row, alternating two launchers, end bit for bit
    where a fresh launch does, with both tickets zero."""
    gen = torch.Generator(device=cuda).manual_seed(79)
    assert chip_smoke.finish_ticket_resets(rows, n_red, 1000, gen, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("n_red", [1, 2, 3])
def test_finish_launcher_owns_its_scratch(cuda, n_red):
    """A launcher built with nothing else holding its scratch (as a chunk
    builds it) still launches right after the allocator has handed memory
    out again: the launcher keeps its scratch, so small tensors filled with
    non-zero values land elsewhere and the ticket stays zero."""
    import gc

    gen = torch.Generator(device=cuda).manual_seed(83)
    rows = 32768 if n_red == 1 else 16384  # G > 1: the ticket is read
    part = chip_smoke.finish_inputs(rows, n_red, gen, cuda)
    red, coef = torch.empty(n_red, dtype=torch.float64, device=cuda), torch.empty(n_red, device=cuda)
    launch = hs.finish_launcher(part, red, coef)
    gc.collect()
    fills = [torch.full((k,), -7.0, dtype=torch.float64, device=cuda) for k in (1, 9, 33, 257, 4097)]
    red_p, coef_p = torch.empty_like(red), torch.empty_like(coef)
    hs.finish_coef_plain(part, red_p, coef_p)
    for _ in range(3):
        red.fill_(float("nan"))
        launch()
        torch.cuda.synchronize()
        assert bool(((red - red_p).abs() <= 1e-5 * part.abs().sum(dim=0)).all()), (red, red_p)
    assert all(bool((f == -7.0).all()) for f in fills)
    assert launch.scratch[:1].view(torch.int32)[0].item() == 0


def _config(backend, potential="Harmonic", **extra):
    return Config.from_dict({**extra,
        "project_name": "gpu test",
        "grid": {"size": {"x": 32, "y": 32, "z": 32}, "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-6, "central_difference": "ThreePoint", "max_steps": 100000,
        "wavenum": 0, "wavemax": 1,
        "output": {"screen_update": 100, "snap_update": None, "file_type": "Json",
                   "save_wavefns": False, "save_potential": False},
        "potential": potential, "absorb": 0.2, "mass": 1.0, "init_condition": "Constant",
        "sig": 1.0, "init_symmetry": "NotConstrained", "precision": "f32", "seed": 5,
        "backend": backend,
    })


@pytest.mark.gpu
@pytest.mark.parametrize("potential", ["Harmonic", "ComplexHarmonic"])
def test_solver_kernel_backend_matches_plain(cuda, tmp_path, monkeypatch, potential):
    """Ground and first excited state through solver.run with the CUDA
    sweep (the pair sweep for a complex potential) and with the plain ops,
    both on the card: energies within 2e-4, in Re and in Im."""
    monkeypatch.chdir(tmp_path)
    log = logging.getLogger("wafer")
    from wafer_torch.io import run_dir

    counter = "sweep_step_sc" if potential.startswith("Complex") else "sweep_step"
    energies = {}
    for backend in ("pallas", "xla"):
        cfg = _config(backend, potential)
        run_dir.check_output_dir(cfg.project_name)
        hs.reset_launches()
        res = solver.run(cfg, log, device=cuda)
        energies[backend] = [r.observables.energy / r.observables.norm2 for r in res]
        assert (hs.LAUNCHES[counter] > 0) == (backend == "pallas")
    for e_k, e_p in zip(energies["pallas"], energies["xla"]):
        assert abs(complex(e_k) - complex(e_p)) < 2e-4, energies


# --------------------------------------------------------------------------- #
# the large-grid slice: multigrid up to 512³ (chip_smoke phases 2c, 3c, 4c at
# a smaller size)
# --------------------------------------------------------------------------- #

N_LARGE = (128, 128, 128)


def _harmonic_state(n, dn, dev, axis=None, seed=0):
    """The oscillator ground (or its partner odd along ``axis``) plus 1 %
    noise, unit norm, ThreePoint shell."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.arange(n, dtype=torch.float32) - (n - 1) / 2.0) * dn
    r2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
    w = torch.exp(-r2 / 2.0)
    if axis is not None:
        w = w * x.reshape([-1 if a == axis else 1 for a in range(3)])
    w = F.pad(w + 0.01 * torch.randn(w.shape, generator=gen), (1,) * 6)
    return (w / torch.sqrt((w * w).sum())).contiguous().to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_lower, apply", [(0, False), (0, True), (1, True), (2, True)],
                         ids=["ground", "S0_coef", "S1", "S2"])
@pytest.mark.parametrize("kind", ["Harmonic", "streamed"])
def test_large_grid_sweep_matches_plain(cuda, kind, n_lower, apply):
    """Phase 2c at 128³: K1 at ThreePoint with analytic Harmonic or streamed
    B and K2 over its 11,050 block partials, against the plain versions."""
    gen = torch.Generator().manual_seed(40 + n_lower)
    psi = F.pad(torch.randn(N_LARGE, generator=gen), (1,) * 6).to(cuda)
    store = None
    if n_lower:
        store = torch.stack([F.pad(torch.randn(N_LARGE, generator=gen), (1,) * 6)
                             for _ in range(n_lower)]).to(cuda)
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3), keepdim=True))
    b_int = (1.0 / (1.0 + 0.002 * torch.rand(N_LARGE, generator=gen))).to(cuda)
    analytic = None if kind == "streamed" else ("Harmonic", 0.06, 1.12e-3, 1.0, *N_LARGE, 1.0, 0.0)
    coef = torch.tensor([0.9] + [0.05] * n_lower, device=cuda)
    kw = dict(order="ThreePoint", scale=1.12e-3 / (2 * 0.06 ** 2), analytic=analytic,
              b_int=None if analytic else b_int, store=store, apply_coef=apply)
    out, ref = torch.empty_like(psi), torch.empty_like(psi)
    part = part_ref = None
    if apply:
        part = torch.empty(hs.num_partials(psi, "ThreePoint"), 1 + n_lower, dtype=torch.float64,
                           device=cuda)
        part_ref = torch.empty(1, 1 + n_lower, dtype=torch.float64, device=cuda)
    hs.sweep_step(psi, out, coef, part, **kw)
    hs.sweep_step_plain(psi, ref, coef, part_ref, **kw)
    _close(out, ref, 1e-6)
    if apply:
        # 32-wide z-tiles × 16-row y-tiles × x-segments, which a grid of 32
        # tiles cuts to 4 planes so that its 1,024 blocks fill the card
        assert part.shape[0] == 4 * 8 * 32
        red, red_ref = (torch.empty(1 + n_lower, dtype=torch.float64, device=cuda)
                        for _ in range(2))
        c, c_ref = torch.empty_like(coef), torch.empty_like(coef)
        hs.finish_coef(part, red, c)
        hs.finish_coef_plain(part_ref, red_ref, c_ref)
        scale = torch.tensor([float(red_ref[0])] + [float(red_ref[0]) ** 0.5] * n_lower,
                             dtype=torch.float64, device=cuda)
        assert float(((red - red_ref).abs() / scale).max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ground_analytic_B6", "ground_streamed_B5", "psn_B4",
                                  "S1_B4", "S2_B4"])
def test_large_grid_chunk_matches_plain_ops(cuda, mode):
    """Phase 3c at 128³: a 40-step chunk of each dispatch the reference
    sends to B4–B6, through K1 (+ K2) and through the plain torch ops on the
    card: ψ and ‖ψ‖² within 1e-4."""
    from wafer_torch.models import potentials
    from wafer_torch.ops import stencil

    dn, dt, steps = 0.06, 1.12e-3, 40
    an = ("Harmonic", dn, dt, 1.0, *N_LARGE, 1.0, 0.0)
    v = 0.5 * dn * dn * geometry.r2_index_grid((130,) * 3, N_LARGE, torch.float32, cuda)
    a, b = potentials.build_ab(v, dt)
    b_int = geometry.work_area(b, 1).contiguous()
    ground = _harmonic_state(128, dn, cuda, seed=1)
    odd_x = _harmonic_state(128, dn, cuda, axis=0, seed=2)
    phi, store, psn = {
        "ground_analytic_B6": (ground, None, False), "ground_streamed_B5": (ground, None, False),
        "psn_B4": (ground, None, True), "S1_B4": (odd_x, ground[None], False),
        "S2_B4": (_harmonic_state(128, dn, cuda, axis=1, seed=3),
                  torch.stack([ground, odd_x]), False),
    }[mode]
    streamed = mode == "ground_streamed_B5"
    hs.reset_launches()
    out = hs.evolve_chunk(phi, "ThreePoint", dt, dn, 1.0, steps, None if streamed else an,
                          per_step_norm=psn, store=store, b_int=b_int if streamed else None)
    reduced = psn or store is not None
    assert hs.LAUNCHES["sweep_step"] == steps
    assert hs.LAUNCHES["finish_coef"] == (steps if reduced else 0)
    ref = stencil.evolve_chunk(phi, a, b, store, "ThreePoint", dt, dn, 1.0, steps,
                               0 if store is None else store.shape[0], per_step_norm=psn)
    _close(out, ref, 1e-4)
    n_out, n_ref = float((out.double() ** 2).sum()), float((ref.double() ** 2).sum())
    assert abs(n_out - n_ref) <= 1e-4 * n_ref


@pytest.mark.gpu
@pytest.mark.parametrize("multigrid", [[2], [4, 2]], ids=["2", "4_2"])
def test_multigrid_launches_kernels_at_every_level(cuda, tmp_path, monkeypatch, multigrid):
    """Phase 4c at 32³: the multigrid ladder through solver.run with the CUDA
    sweep launches K1 at every level and state, and gives the plain
    backend's energies within 2e-4."""
    monkeypatch.chdir(tmp_path)
    log = logging.getLogger("wafer")
    from wafer_torch.io import run_dir

    per_solve = []
    orig = solver.solve

    def spy(config, *a, **k):
        before = hs.LAUNCHES["sweep_step"]
        res = orig(config, *a, **k)
        per_solve.append((config.grid.size.x, res.wnum, hs.LAUNCHES["sweep_step"] - before))
        return res

    monkeypatch.setattr(solver, "solve", spy)
    energies = {}
    for backend in ("pallas", "xla"):
        cfg = _config(backend, multigrid=multigrid)
        per_solve.clear()
        run_dir.check_output_dir(cfg.project_name)
        res = solver.run(cfg, log, device=cuda)
        energies[backend] = [r.observables.energy / r.observables.norm2 for r in res]
        sizes = [32 // d for d in multigrid] + [32]
        assert [(n, w) for n, w, _l in per_solve] == [(n, w) for n in sizes for w in (0, 1)]
        assert all((launched > 0) == (backend == "pallas") for _n, _w, launched in per_solve)
    for e_k, e_p in zip(energies["pallas"], energies["xla"]):
        assert abs(e_k - e_p) < 2e-4, energies


# --------------------------------------------------------------------------- #
# the sharded slice: a single-process mesh with every shard on the card
# (chip_smoke phases 2d, 3d, 4d at a smaller size)
# --------------------------------------------------------------------------- #


def _cuda_mesh(shape, dev):
    from wafer_torch.parallel import make_mesh

    return make_mesh(shape, [dev] * (shape[0] * shape[1] * shape[2]))


def _blocks(glob, mesh, ext):
    """Each shard's padded block of the interior ``glob``, halos exchanged."""
    from wafer_torch.parallel import exchange_halos

    blocks = [F.pad(glob[(...,) + tuple(slice(o, o + n) for o, n in zip(origin, shape))],
                    (ext,) * 6).contiguous()
              for shape, origin in mesh.blocks(tuple(glob.shape[-3:]))]
    exchange_halos(blocks, ext, mesh)
    return blocks


@pytest.mark.gpu
@pytest.mark.parametrize("pair, kind", [(False, k) for k in KINDS] + [(True, k) for k in SC_KINDS])
@pytest.mark.parametrize("order", ORDERS)
def test_sweep_with_origin_matches_plain_on_shard_blocks(cuda, order, pair, kind):
    """Phase 2d: K1 (K3) on each block of a (4, 2, 1) mesh with the block's
    global origin against its plain version, S = 0 and 1 with coefficients."""
    ext = geometry.EXT[order]
    mesh = _cuda_mesh((4, 2, 1), cuda)
    gen = torch.Generator().manual_seed(23)
    lead = (2,) if pair else ()
    psi = torch.randn((*lead, *N), generator=gen).to(cuda)
    low = torch.randn((1, *lead, *N), generator=gen).to(cuda)
    low = low / torch.sqrt((low * low).sum())
    d = (1.0 + 0.002 * torch.rand(N, generator=gen)).to(cuda)
    b = torch.stack([1.0 / d, -0.0004 / d]) if pair else 1.0 / d
    analytic = None
    if kind != "streamed":
        analytic = (kind, 0.2, 0.004, 1.0, *N, 1.0, 0.3) + ((0.2,) if pair else ())
    kernel, plain = ((hsp.sweep_step_sc, hsp.sweep_step_sc_plain) if pair
                     else (hs.sweep_step, hs.sweep_step_plain))
    scale = 0.004 / (geometry.stencil_coefficients(order)[3] * 0.2 * 0.2)
    for n_store in (0, 1):
        n_red = 1 + (2 if pair else 1) * n_store
        coef = torch.tensor([0.9, 0.1, -0.05][:n_red], device=cuda)
        stores = _blocks(low, mesh, ext) if n_store else [None] * mesh.size
        for blk, st, (shape, origin) in zip(_blocks(psi, mesh, ext), stores, mesh.blocks(N)):
            b_blk = None if analytic else b[(...,) + tuple(
                slice(o, o + n) for o, n in zip(origin, shape))].contiguous()
            kw = dict(order=order, scale=scale, analytic=analytic, store=st, apply_coef=True,
                      origin=origin, **{"b2" if pair else "b_int": b_blk})
            out, ref = torch.empty_like(blk), torch.empty_like(blk)
            part = torch.empty(hs.num_partials(blk[0] if pair else blk, order), n_red,
                               dtype=torch.float64, device=cuda)
            part_ref = torch.empty(1, n_red, dtype=torch.float64, device=cuda)
            kernel(blk, out, coef, part, **kw)
            plain(blk, ref, coef, part_ref, **kw)
            _close(out, ref, 1e-6)
            assert abs(float(part.sum(0)[0] - part_ref[0, 0])) <= 1e-5 * float(part_ref[0, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(4, 2, 1), (8, 1, 1)])
def test_sharded_step_is_the_single_device_step(cuda, mesh_shape):
    """Phase 2d's step at 64³: exchange, K1 with S = 1 on each block into
    its rows of one partials buffer, one K2 — ψ' bit for bit against the
    single-device step (Coulomb, its pole on a seam), reductions within
    1e-12 relative."""
    from wafer_torch.parallel import exchange_halos

    n = (64, 64, 64)
    mesh = _cuda_mesh(mesh_shape, cuda)
    gen = torch.Generator().manual_seed(31)
    psi = torch.randn(n, generator=gen).to(cuda)
    low = torch.randn((1, *n), generator=gen).to(cuda)
    low = low / torch.sqrt((low * low).sum())
    coef = torch.tensor([0.9, 0.05], device=cuda)
    kw = dict(order="ThreePoint", scale=0.05, analytic=("Coulomb", 0.2, 0.004, 1.0, *n),
              apply_coef=True)
    psi_pad, low_pad = F.pad(psi, (1,) * 6), F.pad(low, (1,) * 6)
    out_s = torch.empty_like(psi_pad)
    part_s = torch.empty(hs.num_partials(psi_pad, "ThreePoint"), 2, dtype=torch.float64,
                         device=cuda)
    red_s, red_m = (torch.empty(2, dtype=torch.float64, device=cuda) for _ in range(2))
    hs.sweep_step(psi_pad, out_s, coef, part_s, store=low_pad, **kw)
    hs.finish_coef(part_s, red_s, torch.empty_like(coef))
    blocks, stores = _blocks(psi, mesh, 1), _blocks(low, mesh, 1)
    exchange_halos(blocks, 1, mesh, zero_edges=False)
    counts = [hs.num_partials(blk, "ThreePoint") for blk in blocks]
    part_m = torch.empty(sum(counts), 2, dtype=torch.float64, device=cuda)
    hs.reset_launches()
    for r, (blk, st, (shape, origin)) in enumerate(zip(blocks, stores, mesh.blocks(n))):
        out = torch.empty_like(blk)
        hs.sweep_step(blk, out, coef, part_m[sum(counts[:r]):sum(counts[:r + 1])], store=st,
                      origin=origin, **kw)
        want = out_s[tuple(slice(o + 1, o + 1 + m) for o, m in zip(origin, shape))]
        assert torch.equal(geometry.work_area(out, 1), want)
    hs.finish_coef(part_m, red_m, torch.empty_like(coef))
    assert hs.LAUNCHES["sweep_step"] == mesh.size and hs.LAUNCHES["finish_coef"] == 1
    n2 = float(red_s[0])
    assert abs(float(red_m[0]) - n2) <= 1e-12 * n2
    assert abs(float(red_m[1] - red_s[1])) <= 1e-12 * n2 ** 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ground", "streamed", "psn", "S1", "complex"])
def test_sharded_chunk_matches_single_device(cuda, mode):
    """Phase 3d at 64³ on a (4, 2, 1) mesh: ground chunks (analytic,
    streamed, complex) bit for bit against the single-device chunk,
    per-step-norm and S = 1 within 1e-5."""
    from wafer_torch.parallel.sharded import ShardedOps
    from wafer_torch.parallel.sharded_split import ShardedSplitOps

    n, dn, dt = (64, 64, 64), 0.15, 0.006
    pair = mode == "complex"
    cfg = _config("auto", "ComplexHarmonic" if pair else "Harmonic")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, size=Index3(*n), dn=dn, dt=dt),
        output=dataclasses.replace(cfg.output, screen_update=20))
    an = ("Harmonic", dn, dt, 1.0, *n, 1.0, 0.0) + ((0.2,) if pair else ())
    ground = _harmonic_state(64, dn, cuda, seed=5)
    phi = torch.stack([ground, 0.1 * ground]) if pair else ground
    store = ground[None] if mode == "S1" else None
    if mode == "S1":
        phi = _harmonic_state(64, dn, cuda, axis=0, seed=6)
    b_int = (1.0 / (1.0 + 0.002 * torch.rand(n, generator=torch.Generator().manual_seed(7)))).to(cuda)
    ops = (ShardedSplitOps if pair else ShardedOps)(cfg, _cuda_mesh((4, 2, 1), cuda),
                                                  0 if store is None else 1)
    assert ops.use_pallas and ops.analytic is not None
    if mode == "streamed":
        ops.analytic = None
    chunk = ops.evolve_chunk_psn if mode == "psn" else ops.evolve_chunk
    hs.reset_launches()
    out = ops.get(chunk(ops.put(geometry.work_area(phi, 1)), None,
                        ops.put(b_int, halo=False) if mode == "streamed" else None,
                        None if store is None else ops.put_store(geometry.work_area(store, 1))))
    assert hs.LAUNCHES["sweep_step_sc" if pair else "sweep_step"] == 20 * 8
    assert hs.LAUNCHES["finish_coef"] == (20 if mode in ("psn", "S1") else 0)
    if pair:
        ref = hsp.evolve_chunk_sc(phi, "ThreePoint", dt, dn, 1.0, 20, an)
    else:
        ref = hs.evolve_chunk(phi, "ThreePoint", dt, dn, 1.0, 20,
                              None if mode == "streamed" else an, per_step_norm=mode == "psn",
                              store=store, b_int=b_int if mode == "streamed" else None)
    ref = geometry.work_area(ref, 1)
    if mode in ("psn", "S1"):
        _close(out, ref, 1e-5)
    else:
        assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("potential", ["Harmonic", "ComplexHarmonic"])
def test_sharded_solve_launches_kernels(cuda, tmp_path, monkeypatch, potential):
    """Phase 4d at 32³: two states through solver.run on a (4, 2, 1) mesh
    of shards on the card launch K1 (K3) and K2 and give the single-device
    energies within 2e-4."""
    monkeypatch.chdir(tmp_path)
    log = logging.getLogger("wafer")
    from wafer_torch.io import run_dir

    counter = "sweep_step_sc" if potential.startswith("Complex") else "sweep_step"
    energies = {}
    for mesh in (None, _cuda_mesh((4, 2, 1), cuda)):
        cfg = _config("auto", potential, mesh={"x": 4, "y": 2, "z": 1} if mesh else {})
        run_dir.check_output_dir(cfg.project_name)
        hs.reset_launches()
        res = solver.run(cfg, log, device=cuda, mesh=mesh)
        energies[mesh is None] = [r.observables.energy / r.observables.norm2 for r in res]
        assert hs.LAUNCHES[counter] > 0 and hs.LAUNCHES["finish_coef"] > 0
        assert res[0].phi.device.type == "cuda"
    for e_m, e_s in zip(energies[False], energies[True]):
        assert abs(complex(e_m) - complex(e_s)) < 2e-4, energies
