"""The hand-written CUDA kernels against their plain torch versions on a
CUDA device. Every test here needs the card and skips without one.

The file imports no jax, so it also runs where only the port is
installed (tests/conftest.py imports jax):

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances (f32 in another summation and contraction order): ψ' within
1e-6 of its largest magnitude, reductions within 1e-5 of ‖ψ'‖²; chunks
within 1e-5 after 20 steps."""

import logging

import pytest
import torch
import torch.nn.functional as F

from wafer_torch import geometry, solver
from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
from wafer_tpu.config import Config

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


def _config(backend, potential="Harmonic"):
    return Config.from_dict({
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
    from wafer_tpu.io import run_dir

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
