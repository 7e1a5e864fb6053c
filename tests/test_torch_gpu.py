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
                           "sweep_step_sc": 0, "sweep_step_bf16": 0, "sweep_step_many": 0,
                           "sweep_step_bf16_many": 0, "sweep_step_wide": 0,
                           "sweep_step_bf16_wide": 0, "sweep_step_sc_wide": 0}
    ref = hs.evolve_chunk(psi.cpu(), order, 0.004, 0.2, 1.0, 20, analytic, per_step_norm=psn,
                          store=None if store is None else store.cpu())
    _close(out, ref, 1e-5)
    assert hs.LAUNCHES["sweep_step"] == 20  # the CPU run launched nothing
    streamed = hs.evolve_chunk(psi, order, 0.004, 0.2, 1.0, 3, b_int=b_int, store=store)
    _close(streamed, hs.evolve_chunk(psi.cpu(), order, 0.004, 0.2, 1.0, 3, b_int=b_int.cpu(),
                                     store=None if store is None else store.cpu()), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_lower", [3, 4, 5, 6])
@pytest.mark.parametrize("order", ORDERS)
def test_many_state_chunk_matches_plain(cuda, order, n_lower, stream):
    """A 20-step chunk with three to six stored states (K1's many-state
    kernels at 3 and 4, its wide route at 5 and 6; f32 and bf16 stores)
    against the same function on CPU tensors; the launches count on each
    route's counter exactly."""
    psi, store, _b = _inputs(order, n_lower, 9, cuda)
    psi = F.pad(geometry.work_area(psi, geometry.EXT[order]).abs(), (geometry.EXT[order],) * 6)
    store = store.to(stream)
    analytic = ("Harmonic", 0.2, 0.004, 1.0, *N)
    hs.reset_launches()
    out = hs.evolve_chunk(psi, order, 0.004, 0.2, 1.0, 20, analytic, store=store)
    name = "sweep_step_bf16" if stream == torch.bfloat16 else "sweep_step"
    if n_lower in hs.many_states():
        name += "_many"
    elif n_lower >= hs.wide_min():
        name += "_wide"
    assert hs.LAUNCHES[name] == 20 and hs.LAUNCHES["finish_coef"] == 20
    assert sum(hs.LAUNCHES.values()) == 40
    ref = hs.evolve_chunk(psi.cpu(), order, 0.004, 0.2, 1.0, 20, analytic, store=store.cpu())
    _close(out, ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["Harmonic", "Coulomb"])
@pytest.mark.parametrize("n_store", [3, 4, 5])
def test_many_state_sweep_matches_plain_at_the_main_paths_shape(cuda, n_store, kind, stream):
    """K1's many-state kernels and its wide route at the 256³ ThreePoint
    grid of the main path (chip_smoke phase 4k's fourth, fifth and sixth
    states) against the plain
    version with the coefficients: ψ' within 1e-6 of max|ψ'|, reductions
    within 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(97)
    errs = chip_smoke.kernel_vs_plain("ThreePoint", kind, n_store, False, (256, 256, 256), gen,
                                      cuda, stream=stream)
    assert errs[1] <= 1e-6 and errs[2] <= 1e-5, errs


@pytest.mark.gpu
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_many_state_sweep_on_shard_and_deep_blocks(cuda, stream):
    """K1 with three stored states on the blocks a mesh launches: each shard
    block of a (4, 2, 1) mesh of 64×64×128 with its origin (f32), and a
    multi-slice deep block of 512³ (136×256×512 at x origins −4 and 124,
    reduction window (4, 132)) with its planes outside the grid zero and two
    launches bit for bit; against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(101)
    if stream == torch.float32:
        for kind in ("Harmonic", "Coulomb", "streamed"):
            errs = chip_smoke.shard_kernel_vs_plain("ThreePoint", kind, 3, True, False, gen, cuda)
            assert errs[1] <= 1e-6 and errs[2] <= 1e-5, (kind, errs)
    for ox in (-4, 124):
        errs = chip_smoke.window_vs_plain("ThreePoint", "Harmonic", 3, True, False,
                                          (136, 256, 512), ox, 512, (4, 132), gen, cuda,
                                          repeat=True, stream=stream)
        assert errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2] and errs[3], (ox, errs)


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
                           "sweep_step_sc": 20, "sweep_step_bf16": 0, "sweep_step_many": 0,
                           "sweep_step_bf16_many": 0, "sweep_step_wide": 0,
                           "sweep_step_bf16_wide": 0, "sweep_step_sc_wide": 0}
    cpu = None if store is None else store.cpu()
    ref = hsp.evolve_chunk_sc(psi.cpu(), order, 0.004, 0.2, 1.0, 20, analytic,
                              per_step_norm=psn, store=cpu)
    _close(out, ref, 1e-5)
    streamed = hsp.evolve_chunk_sc(psi, order, 0.004, 0.2, 1.0, 3, b2=b2, store=store)
    _close(streamed, hsp.evolve_chunk_sc(psi.cpu(), order, 0.004, 0.2, 1.0, 3, b2=b2.cpu(),
                                         store=cpu), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_lower", [3, 4, 5])
@pytest.mark.parametrize("order", ORDERS)
def test_wide_pair_chunk_matches_plain(cuda, order, n_lower):
    """A 20-step pair chunk with three to five stored pairs (K3's wide
    route) against the same function on CPU tensors, the launches on the
    wide route's counter exactly; and K3's wide route at the complex main
    path's 256³ against the plain version (chip_smoke phase 4l's fourth
    state)."""
    psi, store, _b2 = _pair_inputs(order, n_lower, 19, cuda)
    ext = geometry.EXT[order]
    psi = torch.stack([F.pad(geometry.work_area(psi[0], ext).abs(), (ext,) * 6),
                       0.1 * psi[1]])
    analytic = ("Harmonic", 0.2, 0.004, 1.0, *N, 1.0, 0.0, 0.2)
    hs.reset_launches()
    out = hsp.evolve_chunk_sc(psi, order, 0.004, 0.2, 1.0, 20, analytic, store=store)
    assert hs.LAUNCHES["sweep_step_sc_wide"] == 20 and hs.LAUNCHES["finish_coef"] == 20
    assert sum(hs.LAUNCHES.values()) == 40
    ref = hsp.evolve_chunk_sc(psi.cpu(), order, 0.004, 0.2, 1.0, 20, analytic, store=store.cpu())
    _close(out, ref, 1e-5)
    if order == "ThreePoint":
        gen = torch.Generator(device=cuda).manual_seed(103)
        errs = chip_smoke.pair_kernel_vs_plain("ThreePoint", "Harmonic", n_lower, False,
                                               (256, 256, 256), gen, cuda)
        assert errs[1] <= 1e-6 and errs[2] <= 1e-5, errs


@pytest.mark.gpu
@pytest.mark.parametrize("past", [0, 1, chip_smoke.WIDE_FAR], ids=["cap", "one_past", "far_past"])
@pytest.mark.parametrize("kind", ["Harmonic", "streamed"])
@pytest.mark.parametrize("route", list(chip_smoke.WIDE_ROUTES))
@pytest.mark.parametrize("order", ORDERS)
def test_wide_route_at_and_past_its_rings(cuda, order, route, kind, past):
    """The wide route (K1 f32 and bf16, K3) with as many stored states as
    its rings hold at the order and the source of B, and past them (the
    rest read where they are used), against the plain version on 40×24×72
    with the coefficients: ψ' within 1e-6 of max|ψ'|, reductions within
    1e-5, the launch on the route's counter."""
    pair, bf16 = chip_smoke.WIDE_ROUTES[route]
    ext, streamed = geometry.EXT[order], kind == "streamed"
    cap = chip_smoke.wide_cap(pair, bf16, ext, streamed)
    n_store = cap + past
    ring = chip_smoke.wide_occupancy(pair, bf16, ext, n_store, streamed)[2]
    assert ring == n_store if past == 0 else ring < n_store
    gen = torch.Generator(device=cuda).manual_seed(107)
    hs.reset_launches()
    if pair:
        errs = chip_smoke.pair_kernel_vs_plain(order, kind, n_store, False, (40, 24, 72), gen,
                                               cuda)
    else:
        errs = chip_smoke.kernel_vs_plain(order, kind, n_store, False, (40, 24, 72), gen, cuda,
                                          stream=torch.bfloat16 if bf16 else None)
    name = "sweep_step_sc_wide" if pair else "sweep_step_bf16_wide" if bf16 else "sweep_step_wide"
    assert hs.LAUNCHES[name] == 1
    assert errs[1] <= 1e-6 and errs[2] <= 1e-5, errs


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
@pytest.mark.parametrize("block", chip_smoke.COSTLY_B_BLOCKS,
                         ids=[b[0] for b in chip_smoke.COSTLY_B_BLOCKS])
@pytest.mark.parametrize("kind", ["Coulomb", "SimpleCornell"])
def test_costly_b_matches_plain(cuda, kind, block):
    """K1 with Coulomb or SimpleCornell B, whose kernel takes one rsqrt and
    one reciprocal where the plain version takes the reference's IEEE sqrt
    and divides (chip_smoke phase 2): the examples' physics, the core in a
    block of even, odd or mixed extents or at a shard origin, every order,
    S = 0..2 with f32 and bf16 stored states, within 1e-6 of max|ψ'| and
    1e-5 on the reductions."""
    gen = torch.Generator(device=cuda).manual_seed(83)
    name, glob, shape, origin = block
    for order in ORDERS:
        for n_store, apply, stream in chip_smoke.COSTLY_B_MODES:
            errs = chip_smoke.costly_b_vs_plain(order, kind, n_store, apply, glob, shape, origin,
                                                gen, cuda, stream)
            assert errs[0] <= 1e-6 and errs[1] <= 1e-5, (order, n_store, stream, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.COSTLY_B_MAIN,
                         ids=[c[0] for c in chip_smoke.COSTLY_B_MAIN])
def test_costly_b_matches_plain_at_the_main_paths_shapes(cuda, case):
    """The same at the blocks the main paths launch K1's costly-B kernels
    on (chip_smoke phase 2): coulomb_states.yaml's and cornell.yaml's
    grids with S = 0..2 on f32 and bf16 stores, a sharded_512.yaml shard,
    and multislice_512.yaml's windowed deep blocks with S = 0 and 1, each
    with its example's physics."""
    gen = torch.Generator(device=cuda).manual_seed(89)
    _name, kind, physics, glob, shape, origin, red, modes = case
    for n_store, apply, stream in modes:
        errs = chip_smoke.costly_b_vs_plain("ThreePoint", kind, n_store, apply, glob, shape,
                                            origin, gen, cuda, stream, physics=physics, red=red)
        assert errs[0] <= 1e-6 and errs[1] <= 1e-5, (n_store, apply, stream, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("n", chip_smoke.RAGGED, ids=["odd", "below_a_tile", "short_x"])
@pytest.mark.parametrize("order", ORDERS)
def test_bf16_stream_matches_plain(cuda, order, n):
    """K1 with a bf16 store (chip_smoke phase 2i) on the ragged grids: every
    B source, S = 1..3, with and without a block origin, against the plain
    version on the same bf16 values (1e-6 of max|ψ'|, 1e-5 on the
    reductions); and, with an origin and a reduction window or without,
    bit for bit the f32 launch on the same values."""
    gen = torch.Generator(device=cuda).manual_seed(73)
    for kind in KINDS:
        for n_store, apply in chip_smoke.RAGGED_MODES:
            if n_store == 0:
                continue
            for with_origin in (False, True):
                psi_err, red_err = chip_smoke.ragged_vs_plain(
                    order, kind, n_store, apply, False, n, with_origin, gen, cuda,
                    stream=torch.bfloat16)
                assert psi_err <= 1e-6 and red_err <= 1e-5, (kind, n_store, with_origin)
    for n_store in (1, 2, 3):
        assert chip_smoke.bf16_is_f32_on_its_values(order, n_store, n, gen, cuda)
        assert chip_smoke.bf16_is_f32_on_its_values(order, n_store, n, gen, cuda, (3, 5, 3))
        assert chip_smoke.bf16_is_f32_on_its_values(order, n_store, n, gen, cuda, (3, 5, 2),
                                                    (n[0] // 4, n[0] - n[0] // 4))


@pytest.mark.gpu
@pytest.mark.parametrize("n_store", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("order", ORDERS)
def test_bf16_sweep_is_the_f32_launch_on_its_values(cuda, order, n_store):
    """K1's bf16 sweep (csrc/stencil_sweep_bf16.cu) at a size of whole tiles
    (chip_smoke phase 2i): ψ' and the partial rows bit for bit the f32
    launch on the same values, without an origin, with one whose oz is odd,
    and with one and a reduction window; and (ThreePoint, the done flag's
    cases) the done flag: clear, the default launch bit for bit; set,
    nothing written."""
    gen = torch.Generator(device=cuda).manual_seed(79)
    n = (64, 64, 128)
    for origin, red in (((0, 0, 0), None), ((3, 5, 3), None), ((3, 5, 2), (16, 48))):
        assert chip_smoke.bf16_is_f32_on_its_values(order, n_store, n, gen, cuda, origin, red)
    for shape in chip_smoke.RAGGED + (n,) if order == "ThreePoint" else ():
        for kind in ("Coulomb", "streamed"):
            equal, untouched = chip_smoke.done_flag_cases(False, n_store, shape, gen, cuda, kind,
                                                          stream=torch.bfloat16)
            assert equal and untouched, (shape, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("width", list(chip_smoke.ROW_COPY_SHAPES))
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", ["Coulomb", "SimpleCornell"])
def test_bf16_costly_sweep_is_the_f32_launch_at_each_row_copy_width(cuda, kind, order, width):
    """The costly kinds' bf16 sweep, which copies each plane's haloed tile
    in 8-byte (a 256^3 slab's even rows) or 4-byte (odd rows) psi copies
    (chip_smoke.ROW_COPY_SHAPES), at every order and S = 1, 2: ψ' and the
    partial rows bit for bit the f32 launch on the same values, and the
    launch counted in ROW_COPIES of its width alone."""
    gen = torch.Generator(device=cuda).manual_seed(97)
    for n_store in (1, 2):
        equal, counted = chip_smoke.row_copy_case(order, n_store, width, gen, cuda, kind)
        assert equal and counted, (n_store, equal, counted)


@pytest.mark.gpu
@pytest.mark.parametrize("n_store", [0, 1, 2, 3, 4, 5])
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


def _parent_key(pair, n_store, bf16):
    """The LAUNCHES key of a launch by the rule the bindings kept before the
    library gave its route: the many-state counts and the wide route's
    first count from the library's own exports."""
    if pair:
        return "sweep_step_sc_wide" if n_store >= hs.wide_min(pair=True) else "sweep_step_sc"
    return ("sweep_step_bf16" if bf16 and n_store else "sweep_step") + (
        "_many" if n_store in hs.many_states() else "_wide" if n_store >= hs.wide_min() else "")


@pytest.mark.gpu
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k1_launches_count_under_the_key_of_the_rule_before_the_route(cuda, stream):
    """Every K1 launch with 0 to 9 stored states on an f32 or a bf16 store
    runs and counts once, under the key the bindings named it by before
    the library's route rule (wafer_sweep_route) named it."""
    for n_store in range(10):
        psi, store, _b = _inputs("ThreePoint", n_store, 40 + n_store, cuda)
        store = None if store is None else store.to(stream)
        coef = torch.full((1 + n_store,), 0.1, device=cuda)
        part = torch.empty(hs.num_partials(psi, "ThreePoint"), 1 + n_store,
                           dtype=torch.float64, device=cuda)
        hs.reset_launches()
        hs.sweep_step(psi, torch.empty_like(psi), coef, part, order="ThreePoint", scale=0.05,
                      analytic=("Harmonic", 0.2, 0.004, 1.0, *N), store=store, apply_coef=True)
        name = _parent_key(False, n_store, stream == torch.bfloat16)
        assert hs.LAUNCHES[name] == 1 and sum(hs.LAUNCHES.values()) == 1, (n_store, name)


@pytest.mark.gpu
def test_k3_launches_count_under_the_key_of_the_rule_before_the_route(cuda):
    """The same for K3 with 0 to 5 stored pairs."""
    for n_store in range(6):
        pair, store, _b2 = _pair_inputs("ThreePoint", n_store, 50 + n_store, cuda)
        coef = torch.full((1 + 2 * n_store,), 0.1, device=cuda)
        part = torch.empty(hsp.num_partials(pair, "ThreePoint"), 1 + 2 * n_store,
                           dtype=torch.float64, device=cuda)
        hs.reset_launches()
        hsp.sweep_step_sc(pair, torch.empty_like(pair), coef, part, order="ThreePoint",
                          scale=0.05, analytic=("Harmonic", 0.2, 0.004, 1.0, *N, 1.0, 0.3, 0.2),
                          store=store, apply_coef=True)
        name = _parent_key(True, n_store, False)
        assert hs.LAUNCHES[name] == 1 and sum(hs.LAUNCHES.values()) == 1, (n_store, name)


@pytest.mark.gpu
def test_library_exports_what_the_bindings_list(cuda):
    """The built library exports every name of _build._SIGNATURES and no
    other wafer_ name (by nm's dynamic symbols where nm exists): not the
    entries the one launch front replaced, nor K2's replaced design and the
    empty launch, nor the routes' launchers, which stay inside it."""
    import ctypes
    import shutil
    import subprocess

    from wafer_torch.ops import _build

    path = _build.build()
    lib = ctypes.CDLL(str(path))
    gone = ["wafer_sweep_step_bf16", "wafer_sweep_step_many", "wafer_sweep_step_wide",
            "wafer_sweep_step_sc_wide", "wafer_sweep_sc_num_blocks", "wafer_finish_coef_columns",
            "wafer_noop", "launch_k1_f32", "launch_k3", "launch_k3_wide"]
    assert [name for name in _build._SIGNATURES if not hasattr(lib, name)] == []
    assert [name for name in gone if hasattr(lib, name)] == []
    if shutil.which("nm"):
        out = subprocess.run(["nm", "-D", "--defined-only", str(path)], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        names = {line.split()[-1] for line in out.splitlines() if line.strip()}
        assert {n for n in names if n.startswith(("wafer_", "launch_k"))} == set(_build._SIGNATURES)


@pytest.mark.gpu
def test_main_path_sweeps_fit_their_launch_bounds(cuda):
    """chip_smoke phase 1's register check on this build's log: the main
    paths' sweep instantiations (MAIN_SWEEPS, with and without the plane
    checks) spill nothing and fit by their registers the blocks an SM
    their launch bounds ask for."""
    from wafer_torch.ops import _build

    rows, failed = chip_smoke.register_check(_build.build().with_suffix(".log").read_text())
    assert len(rows) >= 2 * len(chip_smoke.MAIN_SWEEPS)
    assert not failed, failed


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

    def k1():  # K1 with f32 and with bf16 stored-state streams
        return hs.LAUNCHES["sweep_step"] + hs.LAUNCHES["sweep_step_bf16"]

    def spy(config, *a, **k):
        before = k1()
        res = orig(config, *a, **k)
        per_solve.append((config.grid.size.x, res.wnum, k1() - before))
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


# --------------------------------------------------------------------------- #
# the multi-slice mesh: K1/K3 on deep blocks with a reduction window and
# planes outside the grid (chip_smoke phases 2f, 3e at a smaller size)
# --------------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("where", sorted(chip_smoke.WINDOW_ORIGINS))
@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("order", ORDERS)
def test_window_and_planes_outside_the_grid_match_plain(cuda, order, pair, where):
    """Phase 2f: on the ragged grids, a deep block whose x origin puts
    planes below the grid, none outside it, or planes past its end, with
    the partials summed over the middle half of its planes: Coulomb and
    streamed B, S = 0..2 with and without the coefficients, against the
    plain version (1e-6, 1e-5); the planes outside the grid are zero."""
    gen = torch.Generator(device=cuda).manual_seed(71)
    ox = chip_smoke.WINDOW_ORIGINS[where]
    for kind in ("Coulomb", "streamed"):
        for n_store, apply in ((0, False), (0, True), (1, True), (2, True)):
            for n in chip_smoke.RAGGED:
                psi_err, red_err, zero, _same = chip_smoke.window_vs_plain(
                    order, kind, n_store, apply, pair, n, ox(n[0]), n[0] + 2,
                    (n[0] // 4, n[0] - n[0] // 4), gen, cuda)
                assert psi_err <= 1e-6 and red_err <= 1e-5 and zero, (kind, n_store, n)


@pytest.mark.gpu
@pytest.mark.parametrize("n_store", [0, 1, 2, 3])
@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
def test_full_window_is_the_default_launch(cuda, pair, n_store):
    """The window (0, nx) with the grid given launches what a launch
    without them does, bit for bit; a deep launch repeats bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(73)
    for n in chip_smoke.RAGGED + ((64, 64, 64),):
        assert chip_smoke.full_window_is_default(pair, n_store, n, gen, cuda)
    *_errs, same = chip_smoke.window_vs_plain("SevenPoint", "Coulomb", n_store, True, pair,
                                              (37, 45, 29), -5, 35, (3, 34), gen, cuda,
                                              repeat=True)
    assert same


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ground", "psn", "S1", "complex"])
def test_multislice_chunk_matches_single_device(cuda, mode):
    """Phase 3e at 64³: a 2 × (2, 2, 1) multi-slice chunk (2 × (2, 1, 1)
    for pairs) with 2-step windows and a remainder launches K1 (K3) once a
    shard a step and is the single-device chunk bit for bit for a ground
    chunk, within 1e-5 otherwise."""
    from wafer_torch.parallel.multislice import (
        MultiSliceOps, MultiSliceSplitOps, make_multislice_mesh)

    n, dn, dt = (64, 64, 64), 0.15, 0.006
    pair = mode == "complex"
    shape = (2, 1, 1) if pair else (2, 2, 1)
    cfg = _config("auto", "ComplexHarmonic" if pair else "Coulomb",
                  mesh={"x": shape[0], "y": shape[1], "z": shape[2], "slices": 2,
                        "slice_update": 2})
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, size=Index3(*n), dn=dn, dt=dt),
        output=dataclasses.replace(cfg.output, screen_update=21))
    an = ("Harmonic" if pair else "Coulomb", dn, dt, 1.0, *n, 1.0, 0.0) + ((0.2,) if pair else ())
    ground = _harmonic_state(64, dn, cuda, seed=5)
    phi = torch.stack([ground, 0.1 * ground]) if pair else ground
    store = ground[None] if mode == "S1" else None
    if mode == "S1":
        phi = _harmonic_state(64, dn, cuda, axis=0, seed=6)
    mesh = make_multislice_mesh(shape, 2, [cuda] * (2 * shape[0] * shape[1] * shape[2]))
    ops = (MultiSliceSplitOps if pair else MultiSliceOps)(cfg, mesh, 0 if store is None else 1)
    assert ops.use_pallas and ops.slice_steps == 2
    chunk = ops.evolve_chunk_psn if mode == "psn" else ops.evolve_chunk
    hs.reset_launches()
    out = ops.get(chunk(ops.put(geometry.work_area(phi, 1)), None, None,
                        None if store is None else ops.put_store(geometry.work_area(store, 1))))
    assert hs.LAUNCHES["sweep_step_sc" if pair else "sweep_step"] == 21 * mesh.size
    assert hs.LAUNCHES["finish_coef"] == (21 if mode in ("psn", "S1") else 0)
    if pair:
        ref = hsp.evolve_chunk_sc(phi, "ThreePoint", dt, dn, 1.0, 21, an)
    else:
        ref = hs.evolve_chunk(phi, "ThreePoint", dt, dn, 1.0, 21, an,
                              per_step_norm=mode == "psn", store=store)
    ref = geometry.work_area(ref, 1)
    if mode in ("psn", "S1"):
        _close(out, ref, 1e-5)
    else:
        assert torch.equal(out, ref)


# --------------------------------------------------------------------------- #
# sync_update batching: the kernels' done flag, CUDA graphs of a chunk
# iteration (chip_smoke phases 2g, 4g at a smaller size)
# --------------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("n_store", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["Coulomb", "streamed"])
@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
def test_done_flag_clear_is_the_default_launch_and_set_writes_nothing(cuda, pair, kind, n_store):
    """Phase 2g: with a batch's flag clear K1 (K3) is the launch without it
    bit for bit, ψ' and partial rows; with it set ψ' and the rows keep a
    sentinel. On the ragged grids."""
    gen = torch.Generator(device=cuda).manual_seed(81 + n_store)
    for n in chip_smoke.RAGGED:
        equal, untouched = chip_smoke.done_flag_cases(pair, n_store, n, gen, cuda, kind)
        assert equal and untouched, (n, equal, untouched)


@pytest.mark.gpu
@pytest.mark.parametrize("rows, n_red", [(7, 2), (2048, 1), (32768, 2), (100003, 3)])
def test_done_flag_keeps_finish_coef_and_its_ticket(cuda, rows, n_red):
    """Phase 2g: a flagged K2 writes nothing and takes no ticket, so the
    next live launch of the same launcher is right (1e-5) and leaves the
    ticket zero; with the flag clear it is the default launch bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    equal, untouched, err, ticket = chip_smoke.finish_done_flag(rows, n_red, gen, cuda)
    assert equal and untouched and err <= 1e-5 and ticket == 0, (equal, untouched, err, ticket)


def _eager_batches(monkeypatch):
    """Make every batch runner iterate eagerly (no CUDA graph)."""
    orig = solver.batch_runner

    def eager(*args, **kwargs):
        runner = orig(*args, **kwargs)
        if runner is not None:
            runner.graphs = False
        return runner

    monkeypatch.setattr(solver, "batch_runner", eager)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("mesh_shape", [None, (2, 2, 1)])
@pytest.mark.parametrize("potential", ["Harmonic", "ComplexHarmonic"])
def test_batched_graph_replay_equals_eager_and_per_chunk(cuda, tmp_path, monkeypatch, potential,
                                                         mesh_shape, precision):
    """Phase 4g at 32³, two states with sync_update 4: CUDA-graph replays,
    the same batches run eagerly and the per-chunk loop reach the same
    steps, energies and ψ bit for bit; the graph runs captured once a key
    and (f32, the kernels) count each replay's launches, so K1 (K3)
    launched su times a chunk, idle chunks (run after the device's verdict)
    included. f64 captures the plain ops."""
    monkeypatch.chdir(tmp_path)
    log = logging.getLogger("wafer")
    from wafer_torch.io import run_dir

    counter = "sweep_step_sc" if potential.startswith("Complex") else "sweep_step"
    mesh = None if mesh_shape is None else _cuda_mesh(mesh_shape, cuda)
    extra = {} if mesh_shape is None else {"mesh": dict(zip("xyz", mesh_shape))}
    runs = {}
    for name, sync in (("per chunk", 1), ("graphs", 4), ("eager", 4)):
        if name == "eager":
            _eager_batches(monkeypatch)
        cfg = dataclasses.replace(
            _config("auto", potential, delayed_gram=False, sync_update=sync, **extra),
            precision=precision)
        run_dir.check_output_dir(cfg.project_name)
        hs.reset_launches()
        res = solver.run(cfg, log, device=cuda, mesh=mesh)
        runs[name] = (res, dict(hs.LAUNCHES))
    per_chunk, graphs, eager = (runs[k][0] for k in ("per chunk", "graphs", "eager"))
    for a, b, c in zip(per_chunk, graphs, eager):
        what = [(r.wnum, r.steps, r.observables, r.batch) for r in (a, b, c)]
        assert a.steps == b.steps == c.steps, what
        assert a.observables == b.observables == c.observables, what
        assert torch.equal(a.phi, b.phi) and torch.equal(a.phi, c.phi), what
        assert b.batch["captures"] >= 1 and c.batch["captures"] == 0, what
        assert b.batch["idle_chunks"] == c.batch["idle_chunks"], what
    if precision == "f64":
        assert sum(runs["graphs"][1].values()) == 0
        return
    shards = 1 if mesh is None else mesh.size
    idle = sum(r.batch["idle_chunks"] for r in graphs)

    def sweeps(name):  # K3's launches, or K1's with f32 and bf16 stored-state streams
        launches = runs[name][1]
        return launches[counter] + (0 if counter == "sweep_step_sc" else launches["sweep_step_bf16"])

    launched = sweeps("graphs")
    assert launched == sweeps("eager") == sweeps("per chunk") + 100 * idle * shards, (
        {k: v[1] for k, v in runs.items()}, idle)


@pytest.mark.gpu
def test_batch_iterations_make_no_host_sync(cuda, tmp_path, monkeypatch):
    """Between a batch's first chunk and its read nothing synchronises the
    host with the card (``torch.cuda.set_sync_debug_mode("error")`` around
    the iterations; the one capture a key waits for the device on
    purpose)."""
    from wafer_torch import batch as batch_mod
    from wafer_torch.io import run_dir

    monkeypatch.chdir(tmp_path)
    orig_iter, orig_capture = batch_mod.BatchRunner._iterations, batch_mod.BatchRunner._capture
    checked = [0]

    def strict(self, *args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            orig_iter(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked[0] += 1

    def capture(self, *args, **kwargs):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            orig_capture(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(batch_mod.BatchRunner, "_iterations", strict)
    monkeypatch.setattr(batch_mod.BatchRunner, "_capture", capture)
    cfg = _config("auto", "Harmonic", sync_update=4)
    run_dir.check_output_dir(cfg.project_name)
    res = solver.run(cfg, logging.getLogger("wafer"), device=cuda)
    assert checked[0] > 0 and all(r.converged for r in res)


# --------------------------------------------------------------------------- #
# multi-process runs: two ranks on one card (gloo, CUDA tensors staged)
# --------------------------------------------------------------------------- #


@pytest.mark.gpu
def test_staged_exchange_of_a_256_face_over_two_ranks(cuda, tmp_path):
    """Two ranks on cuda:0 (gloo, staged through pinned host buffers)
    exchange the x faces of a 256³ grid on a (2, 1, 1) mesh, one 258 × 258
    face each way: every block equals the single-process exchange's bit
    for bit."""
    case = {"raw": chip_smoke.smoke_raw((256,) * 3, "Harmonic", 0.0375, 4e-4, 2,
                                        mesh={"x": 2, "y": 1, "z": 1}),
            "mesh": [2, 1, 1], "seed": 3, "exchange_only": True}
    ranks, _wall = chip_smoke.start_ranks({"mode": "chunk", "cases": [case]}, 2, str(tmp_path),
                                          300, env={"WAFER_DEVICE": "cuda:0"})
    one = chip_smoke.chunk_case(case, torch.device("cuda", 0))
    for rk in ranks:
        assert rk["backend"] == "gloo" and rk["staged"]
        (got,) = rk["cases"]
        (rank,) = got["ranks"]
        assert torch.equal(got["blocks"][0], one["blocks"][rank])


@pytest.mark.gpu
def test_multiprocess_mesh_never_captures_a_graph(cuda, tmp_path):
    """``sync_update: 8`` on a (2, 1, 1) mesh over two ranks that share
    cuda:0: the batches run eagerly (no capture on either rank; the route is
    logged) and converge to the oscillator's E₀."""
    cfg = chip_smoke.trace_128_text().replace("128", "64") + "sync_update: 8\n"
    cfg += "mesh: {x: 2, y: 1, z: 1}\n"
    ranks, _wall = chip_smoke.start_ranks({"mode": "cli", "config": cfg}, 2, str(tmp_path),
                                          300, env={"WAFER_DEVICE": "cuda:0"})
    for rk in ranks:
        (st,) = rk["states"]
        assert rk["rc"] == 0 and st["batch"]["batches"] > 0 and st["batch"]["captures"] == 0
        assert abs(st["energy"] / st["norm2"] - 1.5) < 5e-2 and st["launches"]["sweep_step"] > 0
    (log,) = (tmp_path / "rank0" / "output").glob("*/simulation.log")
    assert "run eagerly (ψ spans 2 processes)" in log.read_text()
    assert "Evolve chunks run eagerly through launchers bound once a key (ψ spans 2 " \
           "processes)" in log.read_text()


# --------------------------------------------------------------------------- #
# the per-chunk path as one device program (chunk_graph.py; chip_smoke 4j)
# --------------------------------------------------------------------------- #

GRAPH_CASES = ["ground", "psn", "S1", "S1_bf16", "S2", "complex_ground", "complex_S1",
               "mesh_4_2_1", "mesh_4_2_1_S1", "slices_2x2_1_1", "slices_2x2_1_1_S1"]


def _graph_chunk_case(case, n_steps, dev):
    """(run(graphs) -> the chunk's result as one tensor) for a chunk case
    at 32³, its state made from a seed."""
    from wafer_torch.parallel import make_mesh
    from wafer_torch.parallel.multislice import MultiSliceOps, make_multislice_mesh
    from wafer_torch.parallel.sharded import ShardedOps

    n, dn, dt = 32, 0.3, 0.02
    an = ("Harmonic", dn, dt, 1.0, n, n, n, 1.0, 0.0)
    ground = _harmonic_state(n, dn, dev, seed=21)
    odd = _harmonic_state(n, dn, dev, axis=0, seed=22)
    if case.startswith(("mesh", "slices")):
        slices = case.startswith("slices")
        extra = {"mesh": {"x": 2, "y": 1, "z": 1, "slices": 2, "slice_update": 2}} if slices else {}
        cfg = _config("auto", "Harmonic", **extra)
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(cfg.output,
                                                                  screen_update=n_steps))
        s1 = case.endswith("S1")
        mesh = (make_multislice_mesh((2, 1, 1), 2, [dev] * 4) if slices
                else make_mesh((4, 2, 1), [dev] * 8))
        ops = (MultiSliceOps if slices else ShardedOps)(cfg, mesh, int(s1))
        phi = ops.put(geometry.work_area(odd if s1 else ground, 1))
        store = ops.put_store(geometry.work_area(ground[None], 1)) if s1 else None

        def run(graphs):
            ops.graphs = graphs
            return ops.get(ops.evolve_chunk(phi, None, None, store))
        return run
    pair = case.startswith("complex")
    n_store = {"S1": 1, "S1_bf16": 1, "S2": 2, "complex_S1": 1}.get(case, 0)
    states = [ground, _harmonic_state(n, dn, dev, axis=1, seed=23)][:n_store]
    if pair:
        states = [torch.stack([w, 0.1 * w]) for w in states]
        phi = torch.stack([odd, 0.2 * odd]) if n_store else torch.stack([ground, 0.1 * ground])
    else:
        phi = odd if n_store else ground
    store = torch.stack(states) if n_store else None
    if case == "S1_bf16":
        store = store.to(torch.bfloat16)

    def run(graphs):
        if pair:
            return hsp.evolve_chunk_sc(phi, "ThreePoint", dt, dn, 1.0, n_steps, an + (0.2,),
                                       store=store, graphs=graphs)
        return hs.evolve_chunk(phi, "ThreePoint", dt, dn, 1.0, n_steps, an,
                               per_step_norm=case == "psn", store=store, graphs=graphs)
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [135, 134, 3], ids=["odd", "even", "below_a_segment"])
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_chunk_graph_is_the_eager_chunk(cuda, case, n_steps):
    """A chunk run through a kept key on the graph route (step 0 eager, a
    captured segment replayed, the rest eager) is the eager chunk bit for
    bit, in its eager chunks, with its capture and when replayed, and
    counts the same launches: one device (ground, per-step norm, S = 1 with
    f32 and bf16 stores, S = 2, complex ground and S = 1) and meshes on the
    card ((4, 2, 1), 2 × (2, 1, 1) with x faces every two steps)."""
    from wafer_torch import chunk_graph

    run = _graph_chunk_case(case, n_steps, cuda)
    hs.reset_launches()
    want = run(None)
    eager = dict(hs.LAUNCHES)
    graphs = chunk_graph.ChunkGraphs("graph")
    uses = chunk_graph.EAGER_CHUNKS + 2  # eager ones, the capture's, a replay's
    for _ in range(uses):
        hs.reset_launches()
        got = run(graphs)
        assert torch.equal(got, want)
        assert hs.LAUNCHES == eager
    period = 2 if case.startswith("slices") else 1
    g = chunk_graph.graph_steps(n_steps, period)
    segments = (n_steps - 2) // g if g else 0  # a chunk's; the capture's first is eager
    stats = graphs.take_stats()
    assert (stats["captures"], stats["replays"]) == ((1, 2 * segments - 1) if g else (0, 0))
    graphs.close()


@pytest.mark.gpu
def test_chunk_graph_replays_without_a_host_sync(cuda):
    """A chunk on the graph route reads nothing back to the host, its
    capture included (``set_sync_debug_mode("error")``)."""
    from wafer_torch import chunk_graph

    run = _graph_chunk_case("S1", 135, cuda)
    graphs = chunk_graph.ChunkGraphs("graph")
    want = run(None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [run(graphs) for _ in range(chunk_graph.EAGER_CHUNKS + 2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("potential", ["Harmonic", "ComplexHarmonic"])
def test_solve_takes_the_graph_route(cuda, tmp_path, monkeypatch, potential):
    """``solver.run`` on one card logs the graph route, replays the
    segments and reaches the per-chunk run's steps and energies bit for
    bit (the same run with every chunk binding its own launchers)."""
    from wafer_torch import chunk_graph

    from wafer_torch.io import run_dir

    monkeypatch.chdir(tmp_path)
    cfg = _config("auto", potential)
    run_dir.check_output_dir(cfg.project_name)
    res = solver.run(cfg, logging.getLogger("wafer"), device=cuda)
    assert all(r.graphs["route"] == "graph" and r.graphs["replays"] > 0 for r in res)
    monkeypatch.setattr(solver, "chunk_graphs", lambda *a, **k: None)
    run_dir.reset_proj_date()
    run_dir.check_output_dir(cfg.project_name)
    eager = solver.run(cfg, logging.getLogger("wafer"), device=cuda)
    assert [r.graphs["route"] for r in eager] == ["eager", "eager"]
    for g, e in zip(res, eager):
        assert g.steps == e.steps and g.observables == e.observables
        assert torch.equal(g.phi, e.phi)
    assert chunk_graph.route([cuda]) == "graph"
